// Per-part texture warp: top-k part selection, the blended bilinear
// forward and its backward, for sm_90a (H100).
//
// Replaces the three Pallas TPU kernels of the JAX package's
// ops/pallas_warp2.py:
//   topk_select       <- _topk_kernel (:118), called by _topk_call (:154)
//   texture_warp_fwd  <- _fwd_kernel  (:310), called by _fwd_call  (:464)
//   texture_warp_bwd  <- _bwd_kernel  (:358), called by _bwd_call  (:495)
//                        and wrapped by _texture_warp_bwd (:584)
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
// texture_warp_bwd (train step: B=2, P=24, N=512^2, T=64, C=3, k=4). Also
// bound by bytes: w read densely (50.3 MB), u / v / the texture taps only
// for the selected (pixel, part) pairs (~2.1 M pairs, ~17 MB of u, v), g
// (6.3 MB), du / dv / dw written densely (151 MB), dtex (2.4 MB)
// -> ~0.07 ms at 3.35 TB/s. The TPU built dtex from one-hot matrix
// products because Mosaic has no scatter; here it is a scatter-add:
//   * one CTA per (pixel chunk, part, batch); it accumulates that part's
//     C x T x T dtex tile in shared memory with shared atomicAdd (48 KB at
//     T=64, C=3; 192 KB at T=128, opted in with cudaFuncSetAttribute) and
//     flushes the tile's nonzero texels to dtex with one global atomicAdd
//     each. A tile that does not fit (C=4 at T=128) accumulates straight
//     into dtex with global atomics;
//   * the chunk count makes B * P * chunks about 4 CTAs per SM;
//   * threads read w coalesced and skip w = 0, so u, v, g and the texels
//     are read only for selected pairs;
//   * every du / dv / dw element is written, zeros included, so no memset
//     precedes the launch; dtex is zeroed by the wrapper (one tile per
//     part) because many CTAs add into it;
//   * a batch-1 texture (dtex_bstride 0) accumulates every b into one tile.
// Float atomics add in an order that changes from run to run, so dtex
// varies in its last bits between runs.
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

// One CTA per (pixel chunk, part, batch); see the header note. Per pixel,
// with x = u*(T-1), y = v*(T-1) and gw = g*w (the formulas of the TPU
// kernel, pallas_warp2.py:414-436):
//   du = sum_c gw * ((v01-v00)(1-wy) + (v11-v10)wy) * (T-1)
//   dv = sum_c gw * (bot-top) * (T-1)
//   dw = sum_c g * samp, kept only where w > 0
//   dtex[c] += gw * bilinear weight, at each of the four clamped taps.
// du / dv / dw are 0 where w = 0.
__global__ void __launch_bounds__(kThreads)
texture_warp_bwd_kernel(const float* __restrict__ tex, long long tex_bstride,
                        const float* __restrict__ u,
                        const float* __restrict__ v, long long uv_bstride,
                        long long uv_pstride, const float* __restrict__ w,
                        const float* __restrict__ g,
                        float* __restrict__ du, float* __restrict__ dv,
                        long long duv_bstride, long long duv_pstride,
                        float* __restrict__ dw, long long dw_bstride,
                        float* __restrict__ dtex, long long dtex_bstride,
                        int P, int C, int T, int N, int chunk, int use_smem) {
  extern __shared__ float tile[];
  const int p = blockIdx.y;
  const int b = blockIdx.z;
  const long long tt = (long long)T * T;
  const int tile_len = C * T * T;
  float* dtex_bp = dtex + b * dtex_bstride + (long long)p * C * tt;
  float* acc = use_smem ? tile : dtex_bp;
  if (use_smem) {
    for (int i = threadIdx.x; i < tile_len; i += kThreads) tile[i] = 0.0f;
    __syncthreads();
  }

  const float* wb = w + ((long long)b * P + p) * N;
  const float* ub = u + b * uv_bstride + p * uv_pstride;
  const float* vb = v + b * uv_bstride + p * uv_pstride;
  const float* tp = tex + b * tex_bstride + (long long)p * C * tt;
  const float* gb = g + (long long)b * C * N;
  float* dub = du + b * duv_bstride + p * duv_pstride;
  float* dvb = dv + b * duv_bstride + p * duv_pstride;
  float* dwb = dw + b * dw_bstride + (long long)p * N;
  const float ext1 = (float)(T - 1);
  const int n0 = blockIdx.x * chunk;
  const int n1 = min(n0 + chunk, N);

  for (int n = n0 + threadIdx.x; n < n1; n += kThreads) {
    const float wt = __ldg(wb + n);
    float gu = 0.0f, gv = 0.0f, gwt = 0.0f;
    if (wt != 0.0f) {
      const float x = __ldg(ub + n) * ext1;
      const float y = __ldg(vb + n) * ext1;
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
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        if (c < C) {
          const float gc = __ldg(gb + (long long)c * N + n);
          const float* tc = tp + c * tt;
          const float v00 = __ldg(tc + o00);
          const float v01 = __ldg(tc + o01);
          const float v10 = __ldg(tc + o10);
          const float v11 = __ldg(tc + o11);
          const float top = v00 * (1.0f - wx) + v01 * wx;
          const float bot = v10 * (1.0f - wx) + v11 * wx;
          const float samp = top * (1.0f - wy) + bot * wy;
          const float gw = gc * wt;
          gu += gw * ((v01 - v00) * (1.0f - wy) + (v11 - v10) * wy) * ext1;
          gv += gw * (bot - top) * ext1;
          gwt += gc * samp;
          float* a = acc + c * tt;
          atomicAdd(a + o00, gw * (1.0f - wx) * (1.0f - wy));
          atomicAdd(a + o01, gw * wx * (1.0f - wy));
          atomicAdd(a + o10, gw * (1.0f - wx) * wy);
          atomicAdd(a + o11, gw * wx * wy);
        }
      }
      if (!(wt > 0.0f)) gwt = 0.0f;
    }
    dub[n] = gu;
    dvb[n] = gv;
    dwb[n] = gwt;
  }

  if (use_smem) {
    __syncthreads();
    for (int i = threadIdx.x; i < tile_len; i += kThreads) {
      const float s = tile[i];
      if (s != 0.0f) atomicAdd(dtex_bp + i, s);
    }
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

// dtex must be zero on entry (CTAs add into it); du / dv / dw need not be.
extern "C" int nhvr_texture_warp_bwd(const float* tex, long long tex_bstride,
                                     const float* u, const float* v,
                                     long long uv_bstride, long long uv_pstride,
                                     const float* w, const float* g,
                                     float* du, float* dv,
                                     long long duv_bstride,
                                     long long duv_pstride, float* dw,
                                     long long dw_bstride, float* dtex,
                                     long long dtex_bstride, int B, int P,
                                     int C, int T, int N, void* stream) {
  if (C > kMaxC) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0, smem_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t tile_bytes = (size_t)C * T * T * sizeof(float);
  const int use_smem = tile_bytes <= (size_t)smem_optin;
  const size_t smem = use_smem ? tile_bytes : 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(texture_warp_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // about 4 CTAs per SM over the (part, batch) pairs; whole warps per chunk
  const long long pairs = (long long)B * P;
  long long chunks = (4LL * sms + pairs - 1) / pairs;
  if (chunks < 1) chunks = 1;
  long long chunk = ((long long)N + chunks - 1) / chunks;
  chunk = ((chunk + kThreads - 1) / kThreads) * kThreads;
  const dim3 grid((unsigned)(((long long)N + chunk - 1) / chunk), P, B);
  texture_warp_bwd_kernel<<<grid, kThreads, smem, s>>>(
      tex, tex_bstride, u, v, uv_bstride, uv_pstride, w, g, du, dv,
      duv_bstride, duv_pstride, dw, dw_bstride, dtex, dtex_bstride, P, C, T,
      N, (int)chunk, use_smem);
  return (int)cudaGetLastError();
}
