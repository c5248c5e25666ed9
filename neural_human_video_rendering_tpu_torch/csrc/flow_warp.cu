// Whole-image bilinear flow warp for the temporal loss, for sm_90a (H100).
//
// Replaces the Pallas TPU kernel of the JAX package's
// ops/pallas_flow_warp.py:
//   flow_warp_fwd  <- _fwd_kernel (:51), called by _fwd_call (:121)
//
// Spec (ops/grid_sample.py:flow_warp, pallas_flow_warp.py:78-107):
//   out[b, c, p] = bilinear img[b, c] at (col + flow[b, 0, p],
//                                         row + flow[b, 1, p]),
// channel 0 of the flow is dx, channel 1 is dy, in pixels; the four integer
// taps are clamped to the image, and the whole sample is 0 where the point
// lies outside [0, W-1] x [0, H-1].
//
// Layout. img (B, C, H, W) and flow (B, 2, H, W) are read in place through
// their batch, channel and row strides (each row contiguous), so the
// temporal loss's 5-channel input (the t-1 frame and flow_inv) is warped
// without a copy of its own; out is a fresh contiguous (B, C, H, W).
//
// Bound (H100 SXM, 3.35 TB/s; train step B=2, C=5, 512^2): flow read once
// (4.2 MB), the image once (10.5 MB) and out written once (10.5 MB):
// ~25 MB -> ~7.5 us. A few flops per byte: bytes bind.
// What the design does about it: one thread per (b, pixel) loads the flow
// once, computes the taps and the validity once, and loops over the C
// channels; consecutive threads take consecutive pixels of a row, so the
// flow loads and the output stores coalesce, and the taps of a smooth flow
// land on neighbouring addresses (L1/L2 hits). The TPU's 128x128 tiles,
// transposed tiles and per-tile hit test were devices of Mosaic's
// lane-gather and are not carried over: any H and W work.
//
// Forward only. The JAX package has no backward kernel for it
// (pallas_flow_warp.py:177-181 recomputes the reference VJP), and neither
// does the port: ops/flow_warp_kernel.FlowWarp recomputes the plain
// version's VJP. In the flagship train step that backward never runs (the
// t-1 frame and the flow are data, or a detached render); only the
// symmetric temporal mode, which the port refuses, would need it.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
flow_warp_fwd_kernel(const float* __restrict__ img, long long img_bstride,
                     long long img_cstride, long long img_rstride,
                     const float* __restrict__ flow, long long flow_bstride,
                     long long flow_cstride, long long flow_rstride,
                     float* __restrict__ out, int C, int H, int W) {
  const long long N = (long long)H * W;
  const long long n = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const int b = blockIdx.y;
  const int row = (int)(n / W);
  const int col = (int)(n - (long long)row * W);
  const float* fp = flow + b * flow_bstride + row * flow_rstride + col;
  const float x = (float)col + __ldg(fp);
  const float y = (float)row + __ldg(fp + flow_cstride);
  float* ob = out + (long long)b * C * N + n;
  const bool inside = (x >= 0.0f) && (x <= (float)(W - 1)) &&
                      (y >= 0.0f) && (y <= (float)(H - 1));
  if (!inside) {
    for (int c = 0; c < C; ++c) ob[c * N] = 0.0f;
    return;
  }
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx = x - x0f;
  const float wy = y - y0f;
  const int xi = (int)x0f;
  const int yi = (int)y0f;
  const int x0 = min(max(xi, 0), W - 1);
  const int x1 = min(max(xi + 1, 0), W - 1);
  const long long r0 = (long long)min(max(yi, 0), H - 1) * img_rstride;
  const long long r1 = (long long)min(max(yi + 1, 0), H - 1) * img_rstride;
  const float* ib = img + b * img_bstride;
  for (int c = 0; c < C; ++c) {
    const float* ic = ib + c * img_cstride;
    const float v00 = __ldg(ic + r0 + x0);
    const float v01 = __ldg(ic + r0 + x1);
    const float v10 = __ldg(ic + r1 + x0);
    const float v11 = __ldg(ic + r1 + x1);
    const float top = v00 * (1.0f - wx) + v01 * wx;
    const float bot = v10 * (1.0f - wx) + v11 * wx;
    ob[c * N] = top * (1.0f - wy) + bot * wy;
  }
}

}  // namespace

// C entry point (bound with ctypes): launches on `stream`, does not
// synchronise, and returns cudaGetLastError() so a refused launch is seen.
extern "C" int nhvr_flow_warp_fwd(const float* img, long long img_bstride,
                                  long long img_cstride, long long img_rstride,
                                  const float* flow, long long flow_bstride,
                                  long long flow_cstride,
                                  long long flow_rstride, float* out, int B,
                                  int C, int H, int W, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long N = (long long)H * W;
  const dim3 grid((unsigned)((N + kThreads - 1) / kThreads), B);
  flow_warp_fwd_kernel<<<grid, kThreads, 0, s>>>(
      img, img_bstride, img_cstride, img_rstride, flow, flow_bstride,
      flow_cstride, flow_rstride, out, C, H, W);
  return (int)cudaGetLastError();
}
