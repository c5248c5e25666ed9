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
// ~25 MB -> ~7.5 us. A few flops per byte: bytes bind. The whole working
// set fits the 50 MB L2, and the train step has just written the image
// (torch.cat in losses/temporal.py), so it is read warm.
// What held the first version back (one thread per pixel):
// the channel loop was a runtime loop, so each channel's four taps were
// loaded only after the previous channel's store (4 loads in flight), and
// one CTA per 256 pixels. The design now:
//   * C is a template argument (1-8), fully unrolled: all 4*C taps of a
//     pixel are loaded before any is used (20 loads in flight on the main
//     path);
//   * one pixel per thread, consecutive threads on consecutive pixels of a
//     row: the flow loads and the output stores coalesce, and the taps of
//     a smooth flow (the train step's: a rigid shift in its synthetic
//     data, optical flow in real video) share cache lines across the warp;
//   * a grid-stride loop over one wave of resident CTAs (132 SMs times the
//     CTAs an SM holds) instead of one CTA per 256 pixels;
//   * the validity test once per pixel; an outside sample reads in-range
//     taps and stores 0, so no lane branches away from the loads.
// Measured and dropped (PERF.md): four pixels per thread with float4
// flow loads and output stores (each tap instruction of a warp then spans
// four times the cache lines), and one 16-byte load per tap pair of a row.
// With a flow that jumps from pixel to pixel (i.i.d. noise of 8 px) every
// version, grid_sample's too, is bound by the L2's sector rate for the
// scattered taps (~10 sectors of 32 B a pixel), not by device memory.
// The TPU's 128x128 tiles, transposed tiles and per-tile hit test were
// devices of Mosaic's lane-gather and are not carried over.
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

// One pixel per thread, consecutive threads on consecutive pixels of a
// row (coalesced flow loads and output stores, neighbouring taps), in a
// grid-stride loop over b * H * W.
template <int C>
__global__ void __launch_bounds__(kThreads)
flow_warp_fwd_kernel(const float* __restrict__ img, long long img_bstride,
                     long long img_cstride, long long img_rstride,
                     const float* __restrict__ flow, long long flow_bstride,
                     long long flow_cstride, long long flow_rstride,
                     float* __restrict__ out, int H, int W, int items) {
  const int hw = H * W;
  for (int it = blockIdx.x * kThreads + threadIdx.x; it < items;
       it += gridDim.x * kThreads) {
    const int b = it / hw;
    const int n = it - b * hw;
    const int row = n / W;
    const int col = n - row * W;
    const float* fp = flow + b * flow_bstride + row * flow_rstride + col;
    float x = (float)col + __ldg(fp);
    float y = (float)row + __ldg(fp + flow_cstride);
    const bool inside = (x >= 0.0f) && (x <= (float)(W - 1)) &&
                        (y >= 0.0f) && (y <= (float)(H - 1));
    if (!inside) { x = 0.0f; y = 0.0f; }     // in-range taps, result 0
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    const float wx = x - x0f;
    const float wy = y - y0f;
    const int xi = (int)x0f;
    const int yi = (int)y0f;
    const int x0 = min(xi, W - 1);
    const int x1 = min(xi + 1, W - 1);
    const long long r0 = (long long)min(yi, H - 1) * img_rstride;
    const long long r1 = (long long)min(yi + 1, H - 1) * img_rstride;
    const float* ib = img + b * img_bstride;
    float t00[C], t01[C], t10[C], t11[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float* ic = ib + c * img_cstride;
      t00[c] = __ldg(ic + r0 + x0);
      t01[c] = __ldg(ic + r0 + x1);
      t10[c] = __ldg(ic + r1 + x0);
      t11[c] = __ldg(ic + r1 + x1);
    }
    float* ob = out + (long long)b * C * hw + n;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float top = t00[c] * (1.0f - wx) + t01[c] * wx;
      const float bot = t10[c] * (1.0f - wx) + t11[c] * wx;
      ob[(long long)c * hw] = inside ? top * (1.0f - wy) + bot * wy : 0.0f;
    }
  }
}

template <int C>
cudaError_t launch(const float* img, long long img_bstride,
                   long long img_cstride, long long img_rstride,
                   const float* flow, long long flow_bstride,
                   long long flow_cstride, long long flow_rstride, float* out,
                   int B, int H, int W, cudaStream_t stream) {
  static int resident = 0;                    // CTAs the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, flow_warp_fwd_kernel<C>, kThreads, 0);
    if (err != cudaSuccess) return err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int items = B * H * W;
  int grid = (items + kThreads - 1) / kThreads;
  if (grid > resident) grid = resident;
  flow_warp_fwd_kernel<C><<<grid, kThreads, 0, stream>>>(
      img, img_bstride, img_cstride, img_rstride, flow, flow_bstride,
      flow_cstride, flow_rstride, out, H, W, items);
  return cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes): launches on `stream`, does not
// synchronise, and returns cudaGetLastError() so a refused launch is seen.
// B * H * W < 2^31.
extern "C" int nhvr_flow_warp_fwd(const float* img, long long img_bstride,
                                  long long img_cstride, long long img_rstride,
                                  const float* flow, long long flow_bstride,
                                  long long flow_cstride,
                                  long long flow_rstride, float* out, int B,
                                  int C, int H, int W, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NHVR_FLOW(CC)                                                     \
  launch<CC>(img, img_bstride, img_cstride, img_rstride, flow,           \
             flow_bstride, flow_cstride, flow_rstride, out, B, H, W, s)
  switch (C) {
    case 1: return (int)NHVR_FLOW(1);
    case 2: return (int)NHVR_FLOW(2);
    case 3: return (int)NHVR_FLOW(3);
    case 4: return (int)NHVR_FLOW(4);
    case 5: return (int)NHVR_FLOW(5);
    case 6: return (int)NHVR_FLOW(6);
    case 7: return (int)NHVR_FLOW(7);
    case 8: return (int)NHVR_FLOW(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef NHVR_FLOW
}
