// Per-part texture warp for the serving path: top-k part selection and the
// blended bilinear forward, for sm_90a (H100).
//
// Replaces the two Pallas TPU kernels of the JAX package's
// ops/pallas_warp2.py that the inference forward runs:
//   topk_select       <- _topk_kernel (:118), called by _topk_call (:154)
//   texture_warp_fwd  <- _fwd_kernel  (:310), called by _fwd_call  (:464)
//
// Layout. Everything is NCHW "plane" layout, which is what the TPU kernels
// called planes: fg / u / v / w are (B, P, N) with N = H*W pixels on the
// fastest axis, the texture is (B, P, C, T, T) and the output (B, C, N).
// fg is the strided view probs[:, 1:] and u / v the strided views
// uv[:, :, 0] / uv[:, :, 1] of the renderer's tensors: each kernel takes a
// batch stride (and u / v a part stride) and reads them in place, so the
// layout shuffles of the TPU path (_to_planes) are gone.
//
// Bound (H100 SXM, 3.35 TB/s; flagship serving point B=8, P=24, N=512^2,
// T=64, C=3, k=4). Both kernels do a few flops per byte, far below the
// card's ~20 flop/byte f32 ridge, so both are bound by device-memory bytes:
//   topk_select: fg read once + w written once, 2 * 201.3 MB -> 0.12 ms.
//   texture_warp_fwd: w read (201.3 MB) + u and v of the <= k selected parts
//     of each pixel (<= 67.1 MB) + the atlas (9.4 MB) + out (25.2 MB)
//     -> <= 0.09 ms.
// What the design does about it:
//   * one thread per pixel, loops over parts: consecutive threads read
//     consecutive pixels of one part plane, so every load and store of the
//     (B, P, N) planes is a fully coalesced 128-byte line per warp;
//   * the P values of a pixel stay in registers (P is bounded by the
//     template PM), so fg is read once and w written once;
//   * the forward skips a part whose weight is 0 before it touches u, v or
//     the texture, so it reads u and v only for the selected parts;
//   * texture taps go through the read-only path into L2: one sample's
//     atlas is 24 * 64 * 64 * 3 * 4 B = 1.2 MB and all eight fit in L2.
// Left for later: fusing the selection into the forward (serving never
// needs w in memory, which would save 2 * 201 MB), vectorized loads, and
// staging the atlas tile in shared memory.
//
// Semantics are those of the JAX package's _topk_dense_weights and
// texture_warp_topk: the selection keeps fg[p] >= the k-th largest value
// (ties widen the set, never exact-k argmax), then drops w < eps; the
// optional block cap keeps, per (batch, 1024-pixel block), the parts whose
// summed w is among the block_parts largest. The forward samples with the
// align_corners mapping x = u * (T - 1), taps clamped to [0, T - 1].

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCapBlock = 1024;                      // pixels per cap block
constexpr int kPixPerThread = kCapBlock / kThreads;  // 4
constexpr int kMaxC = 4;

// x[0..P) holds one pixel's fg values on entry and its weights on exit.
template <int PM>
__device__ __forceinline__ void select_parts(float (&x)[PM], int P, int k,
                                             float eps) {
  if (k < P) {
    float rem[PM];
#pragma unroll
    for (int p = 0; p < PM; ++p) rem[p] = (p < P) ? x[p] : -INFINITY;
    for (int it = 0; it < k - 1; ++it) {
      float m = -INFINITY;
#pragma unroll
      for (int p = 0; p < PM; ++p) m = fmaxf(m, rem[p]);
#pragma unroll
      for (int p = 0; p < PM; ++p) rem[p] = (rem[p] >= m) ? -INFINITY : rem[p];
    }
    float thr = -INFINITY;
#pragma unroll
    for (int p = 0; p < PM; ++p) thr = fmaxf(thr, rem[p]);
#pragma unroll
    for (int p = 0; p < PM; ++p) x[p] = (x[p] >= thr) ? x[p] : 0.0f;
  }
  if (eps > 0.0f) {
#pragma unroll
    for (int p = 0; p < PM; ++p) x[p] = (x[p] >= eps) ? x[p] : 0.0f;
  }
}

// One thread per pixel.
template <int PM>
__global__ void __launch_bounds__(kThreads)
topk_pixel_kernel(const float* __restrict__ fg, long long fg_bstride,
                  float* __restrict__ w, int P, int N, int k, float eps) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const int b = blockIdx.y;
  const float* src = fg + b * fg_bstride + n;
  float* dst = w + (long long)b * P * N + n;
  float x[PM];
#pragma unroll
  for (int p = 0; p < PM; ++p) x[p] = (p < P) ? __ldg(src + (long long)p * N) : 0.0f;
  select_parts<PM>(x, P, k, eps);
#pragma unroll
  for (int p = 0; p < PM; ++p) {
    if (p < P) dst[(long long)p * N] = x[p];
  }
}

// One CTA per (1024-pixel block, batch): each thread selects 4 pixels,
// the CTA sums each part's weight over the block in shared memory, runs
// the same max/mask loop over the P block masses and zeroes the parts
// below the block_parts-th largest mass.
template <int PM>
__global__ void __launch_bounds__(kThreads)
topk_block_cap_kernel(const float* __restrict__ fg, long long fg_bstride,
                      float* __restrict__ w, int P, int N, int k, float eps,
                      int block_parts) {
  __shared__ float warp_mass[kThreads / 32][PM];
  __shared__ float mass[PM];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const long long n0 = (long long)blockIdx.x * kCapBlock + tid;
  const float* src = fg + b * fg_bstride + n0;
  float* dst = w + (long long)b * P * N + n0;

  float x[kPixPerThread][PM];
  float part[PM];
#pragma unroll
  for (int p = 0; p < PM; ++p) part[p] = 0.0f;
#pragma unroll
  for (int i = 0; i < kPixPerThread; ++i) {
#pragma unroll
    for (int p = 0; p < PM; ++p)
      x[i][p] = (p < P) ? __ldg(src + i * kThreads + (long long)p * N) : 0.0f;
    select_parts<PM>(x[i], P, k, eps);
#pragma unroll
    for (int p = 0; p < PM; ++p) part[p] += x[i][p];
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int p = 0; p < PM; ++p) {
    float s = part[p];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) warp_mass[warp][p] = s;
  }
  __syncthreads();
  if (tid < PM) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) s += warp_mass[i][tid];
    mass[tid] = (tid < P) ? s : -INFINITY;
  }
  __syncthreads();

  float rem[PM];
#pragma unroll
  for (int p = 0; p < PM; ++p) rem[p] = mass[p];
  for (int it = 0; it < block_parts - 1; ++it) {
    float m = -INFINITY;
#pragma unroll
    for (int p = 0; p < PM; ++p) m = fmaxf(m, rem[p]);
#pragma unroll
    for (int p = 0; p < PM; ++p) rem[p] = (rem[p] >= m) ? -INFINITY : rem[p];
  }
  float thr = -INFINITY;
#pragma unroll
  for (int p = 0; p < PM; ++p) thr = fmaxf(thr, rem[p]);

#pragma unroll
  for (int p = 0; p < PM; ++p) {
    if (p < P) {
      const bool keep = mass[p] >= thr;
#pragma unroll
      for (int i = 0; i < kPixPerThread; ++i)
        dst[i * kThreads + (long long)p * N] = keep ? x[i][p] : 0.0f;
    }
  }
}

template <int PM>
cudaError_t launch_topk(const float* fg, long long fg_bstride, float* w,
                        int B, int P, int N, int k, float eps,
                        int block_parts, cudaStream_t stream) {
  if (block_parts > 0 && block_parts < P) {
    const dim3 grid(N / kCapBlock, B);
    topk_block_cap_kernel<PM><<<grid, kThreads, 0, stream>>>(
        fg, fg_bstride, w, P, N, k, eps, block_parts);
  } else {
    const dim3 grid((N + kThreads - 1) / kThreads, B);
    topk_pixel_kernel<PM><<<grid, kThreads, 0, stream>>>(
        fg, fg_bstride, w, P, N, k, eps);
  }
  return cudaGetLastError();
}

// One thread per pixel; parts in ascending order, as the TPU grid's
// innermost part axis accumulated them.
__global__ void __launch_bounds__(kThreads)
texture_warp_fwd_kernel(const float* __restrict__ tex, long long tex_bstride,
                        const float* __restrict__ u,
                        const float* __restrict__ v, long long uv_bstride,
                        long long uv_pstride, const float* __restrict__ w,
                        float* __restrict__ out, int P, int C, int T, int N) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const int b = blockIdx.y;
  const float* wb = w + (long long)b * P * N + n;
  const float* ub = u + b * uv_bstride + n;
  const float* vb = v + b * uv_bstride + n;
  const float* tb = tex + b * tex_bstride;
  const long long tt = (long long)T * T;
  const float ext1 = (float)(T - 1);

  float acc[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) acc[c] = 0.0f;

  for (int p = 0; p < P; ++p) {
    const float wt = __ldg(wb + (long long)p * N);
    if (wt == 0.0f) continue;
    const float x = __ldg(ub + p * uv_pstride) * ext1;
    const float y = __ldg(vb + p * uv_pstride) * ext1;
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    const float wx = x - x0f;
    const float wy = y - y0f;
    const int xi = (int)x0f;
    const int yi = (int)y0f;
    const int x0 = min(max(xi, 0), T - 1);
    const int x1 = min(max(xi + 1, 0), T - 1);
    const int y0 = min(max(yi, 0), T - 1);
    const int y1 = min(max(yi + 1, 0), T - 1);
    const int o00 = y0 * T + x0;
    const int o01 = y0 * T + x1;
    const int o10 = y1 * T + x0;
    const int o11 = y1 * T + x1;
    const float* tp = tb + (long long)p * C * tt;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c < C) {
        const float* tc = tp + c * tt;
        const float v00 = __ldg(tc + o00);
        const float v01 = __ldg(tc + o01);
        const float v10 = __ldg(tc + o10);
        const float v11 = __ldg(tc + o11);
        const float top = v00 * (1.0f - wx) + v01 * wx;
        const float bot = v10 * (1.0f - wx) + v11 * wx;
        const float samp = top * (1.0f - wy) + bot * wy;
        acc[c] += samp * wt;
      }
    }
  }
  float* ob = out + (long long)b * C * N + n;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) ob[(long long)c * N] = acc[c];
  }
}

}  // namespace

// C entry points (bound with ctypes). Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() so a refused launch is seen.

extern "C" int nhvr_topk_select(const float* fg, long long fg_bstride,
                                float* w, int B, int P, int N, int k,
                                float eps, int block_parts, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 8) return (int)launch_topk<8>(fg, fg_bstride, w, B, P, N, k, eps, block_parts, s);
  if (P <= 16) return (int)launch_topk<16>(fg, fg_bstride, w, B, P, N, k, eps, block_parts, s);
  if (P <= 24) return (int)launch_topk<24>(fg, fg_bstride, w, B, P, N, k, eps, block_parts, s);
  if (P <= 32) return (int)launch_topk<32>(fg, fg_bstride, w, B, P, N, k, eps, block_parts, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int nhvr_texture_warp_fwd(const float* tex, long long tex_bstride,
                                     const float* u, const float* v,
                                     long long uv_bstride, long long uv_pstride,
                                     const float* w, float* out, int B, int P,
                                     int C, int T, int N, void* stream) {
  if (C > kMaxC) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  texture_warp_fwd_kernel<<<grid, kThreads, 0, s>>>(
      tex, tex_bstride, u, v, uv_bstride, uv_pstride, w, out, P, C, T, N);
  return (int)cudaGetLastError();
}
