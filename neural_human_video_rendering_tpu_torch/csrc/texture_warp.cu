// Per-part texture warp: top-k part selection, the blended bilinear
// forward (with w given, or with the selection fused in) and its backward,
// for sm_90a (H100).
//
// Replaces the three Pallas TPU kernels of the JAX package's
// ops/pallas_warp2.py:
//   topk_select       <- _topk_kernel (:118), called by _topk_call (:154)
//   texture_warp_fwd  <- _fwd_kernel  (:310), called by _fwd_call  (:464)
//   texture_warp_topk_fwd <- _topk_kernel (:118) and then _fwd_kernel (:310)
//                        in one launch
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
// T=64, C=3, k=4). The kernels do a few flops per byte, far below the
// card's ~20 flop/byte f32 ridge, so all are bound by device-memory bytes:
//   topk_select: fg read once + w written once, 2 * 201.3 MB -> 0.12 ms.
//   the forward: fg (or w) read (201.3 MB) + u and v of the <= k selected
//     parts of each pixel (<= 67.1 MB) + the atlas (9.4 MB) + out
//     (25.2 MB) -> <= 0.09 ms; the train step's mode also writes w.
// One forward kernel, three modes (template MODE): w given (the lossy
// block_parts route, whose cap stays in topk_block_cap_kernel); the
// selection fused in (serving: w never leaves registers, which saves the
// 2 * 201 MB of topk_select's w); the selection fused in with w kept for
// the backward (the train step: one launch instead of two). The design:
//   * one thread per pixel: consecutive threads read consecutive pixels of
//     one part plane, so every load and store of the (B, P, N) planes is a
//     coalesced 128-byte line per warp; all P loads of a pixel's fg or w
//     go out before any is used (unrolled over the part bound PM), and the
//     selection runs in registers (select_parts, as topk_select: ties
//     widen the set, so the kept w is bit-identical to topk_select's);
//   * compaction before the gathers: the selection becomes a bit mask, and
//     each thread walks its own set bits in ascending part order, two
//     parts at a time (kFwdChunk): their weights, u and v, then their 8
//     taps, then the arithmetic. At k=4 every lane does two useful rounds;
//     before, a warp ran the texel loads for nearly every one of the 24
//     parts with a few lanes active. The rest of the mask (ties, k = P)
//     goes the same way;
//   * the texture is read texel-major: the wrapper's launch first writes a
//     (T*T) float4 copy of each part's C channels (texel_major_kernel, one
//     copy for a texture shared by every batch; 12.6 MB at B=8, in L2), so
//     a tap is one 16-byte load instead of C scattered 4-byte ones;
//   * each thread sums its parts in ascending order: the output is the
//     same bit for bit from run to run.
// Design choices measured on the card and dropped (exploratory builds, not
// kept in the repo): planar texel loads; a part-major walk (every part the
// warp's lanes selected, in turn); loading u / v part by part or densely
// and picking the selected ones out of registers; picking the weights out
// of registers instead of reloading them (an L1 hit); four parts a round
// instead of two (more registers, fewer warps); streaming cache hints on
// fg and u / v (they evict the fg lines that the weight reloads hit); a
// warp-wide queue of the selected (part, pixel) pairs sorted by part, with
// the sums in shared memory (a few percent faster on incoherent
// selections, slower on coherent ones and on smooth uv).
// What bounds it (PERF.md, kernel_ab.py): the fg stream runs near the
// card's read rate; the selected pairs' u / v come in 32-byte sectors, and
// where neighbouring pixels select different parts (random inputs, and a
// random-init renderer's) about 77% of the u / v sectors hold a selected
// pixel at k=4 of 24, and a warp's loads of them touch a line a lane; the
// texel taps are L2 sectors on top, one a tap on random uv. Coherent part
// maps and smooth uv (a trained renderer's) read fewer sectors.
//
// texture_warp_bwd (train step: B=2, P=24, N=512^2, T=64, C=3, k=4). Also
// bound by bytes: w read densely (50.3 MB), u / v / the texture taps only
// for the selected (pixel, part) pairs (~2.1 M pairs, ~17 MB of u, v), g
// (6.3 MB), du / dv / dw written densely (151 MB), dtex (2.4 MB)
// -> ~0.07 ms at 3.35 TB/s. The TPU built dtex from one-hot matrix
// products because Mosaic has no scatter; here it is a scatter-add. Only
// ~17% of the (pixel, part) pairs are selected at k=4, and neighbouring
// pixels of the renderer's smooth uv hit the same texels. The first kernel
// (one thread per pixel and part, a CTA-wide tile flushed with global
// atomics) ran its gathers and shared atomics at ~5 lanes of 32, paid ~11
// global atomics per dtex element, and serialised the shared atomics of
// lanes on one texel. The design now:
//   * a thread block cluster per (part, batch) (per part for a batch-1
//     texture, whose CTAs then walk every batch): its CTAs split the
//     pixels, and each accumulates the part's C x T x T dtex tile in its
//     own shared memory (48 KB at T=64, C=3; 192 KB at T=128). After
//     cluster.sync() each rank sums its 1/cluster slice of the tile over
//     every rank's shared memory (distributed shared memory) and writes
//     dtex with plain float4 stores: no global atomics, no memset, and no
//     flush order to vary. The launch plan (chunk, cluster size, shared
//     bytes) comes from ops/texture_warp_kernel.bwd_launch_plan;
//   * each warp streams windows of 128 pixels on its own, with no CTA-wide
//     barrier until the end: the kernel is bound by the latency of the
//     chain w -> u, v -> texels, so warps must not wait on each other. It
//     loads the next window's w, u and v (one float4 each a lane, u and v
//     densely: ~23 MB more than the selected pixels' sectors, and off the
//     chain) before it works the current one;
//   * compaction before the gathers: the lanes append their selected
//     pixels to the warp's queue (a __shfl_up_sync prefix sum), and the
//     gathers of g and the texels, the gradient arithmetic and the scatter
//     run over the queue with full warps;
//   * the texture is read texel-major: each cluster first writes its part's
//     texture into a scratch buffer as (T*T) float4 of the C channels (a
//     slice per rank, published by the cluster barrier), so a tap is one
//     16-byte load instead of C scattered 4-byte ones;
//   * warp-aggregated shared atomics: one __match_any_sync a pixel, on a
//     key for its four taps, groups the lanes that hit the same texels;
//     they sum their 4 * C values in a shuffle tree and one lane adds them
//     (a shared float atomicAdd is a compare-and-swap loop on sm_90,
//     ATOMS.CAST.SPIN, so each one saved counts);
//   * du / dv / dw of the window, zeros included, are staged in shared
//     memory and go out with coalesced float4 stores, and the CTAs of part
//     0 write dprobs' zero background channel, so the kernel writes every
//     element of its outputs: one launch per call, no memset beside it.
// Shared atomics still add in an order that changes from run to run, so
// dtex varies in its last bits between runs. What bounds it as measured
// (PERF.md): the SM's shared atomics serve about one lane address a
// clock, so the 4 * C adds of each selected pair (25 M at the train step)
// take ~0.08 ms; streaming w, u, v in and du, dv, dw out (~300 MB) the
// rest; and on the renderer's selections the part with the most selected
// pixels sets the end.
//
// Semantics are those of the JAX package's _topk_dense_weights and
// texture_warp_topk: the selection keeps fg[p] >= the k-th largest value
// (ties widen the set, never exact-k argmax), then drops w < eps; the
// optional block cap keeps, per (batch, 1024-pixel block), the parts whose
// summed w is among the block_parts largest. The forward samples with the
// align_corners mapping x = u * (T - 1), taps clamped to [0, T - 1].

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBwdThreads = 512;                    // backward: 16 warps a CTA
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kWarpWindow = 128;                    // backward: pixels a warp takes
constexpr int kMaxCluster = 8;                      // the portable size
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

__device__ __forceinline__ float channel(float4 q, int c) {
  return c == 0 ? q.x : c == 1 ? q.y : c == 2 ? q.z : q.w;
}

// The forward's three modes: w given (the block_parts route), the
// selection fused in (serving), the selection fused in and w kept for the
// backward (the train step).
enum { kFwdGivenW = 0, kFwdSelect = 1, kFwdSelectKeep = 2 };
constexpr int kFwdChunk = 2;   // selected parts whose loads go out together

// tex (G, P, C, T*T) -> tex4 (G, P, T*T) float4 of the C channels (0 past
// C). Grid (ceil(tt / kThreads), P, G).
__global__ void __launch_bounds__(kThreads)
texel_major_kernel(const float* __restrict__ tex, long long tex_bstride,
                   float4* __restrict__ tex4, int P, int C, int tt) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= tt) return;
  const int p = blockIdx.y;
  const int g = blockIdx.z;
  const float* ts = tex + g * tex_bstride + (long long)p * C * tt + i;
  float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  q.x = __ldg(ts);
  if (C > 1) q.y = __ldg(ts + tt);
  if (C > 2) q.z = __ldg(ts + 2 * tt);
  if (C > 3) q.w = __ldg(ts + 3 * tt);
  tex4[((long long)g * P + p) * tt + i] = q;
}

// The four clamped taps and the fractions of the align_corners sample
// x = u * (T - 1), y = v * (T - 1) of a T x T tile.
struct Bilerp {
  int o00, o01, o10, o11;
  float wx, wy;
};

__device__ __forceinline__ Bilerp bilerp(float u, float v, int T, float ext1) {
  const float x = u * ext1;
  const float y = v * ext1;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const int xi = (int)x0f;
  const int yi = (int)y0f;
  const int x0 = min(max(xi, 0), T - 1);
  const int x1 = min(max(xi + 1, 0), T - 1);
  const int y0 = min(max(yi, 0), T - 1);
  const int y1 = min(max(yi + 1, 0), T - 1);
  Bilerp r;
  r.o00 = y0 * T + x0;
  r.o01 = y0 * T + x1;
  r.o10 = y1 * T + x0;
  r.o11 = y1 * T + x1;
  r.wx = x - x0f;
  r.wy = y - y0f;
  return r;
}

__device__ __forceinline__ void blend(float (&acc)[kMaxC], int C, float wt,
                                      const Bilerp& s, float4 q00, float4 q01,
                                      float4 q10, float4 q11) {
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) {
      const float top = channel(q00, c) * (1.0f - s.wx) + channel(q01, c) * s.wx;
      const float bot = channel(q10, c) * (1.0f - s.wx) + channel(q11, c) * s.wx;
      acc[c] += (top * (1.0f - s.wy) + bot * s.wy) * wt;
    }
  }
}

// One thread per pixel, grid (ceil(N / kThreads), B); see the header note.
// src is w (kFwdGivenW) or fg: (B, P, N), batch stride src_bstride, parts
// N apart. tex4 is the texel-major copy of the texture, batch stride
// tex4_bstride (0: one texture for every batch). Parts are summed in
// ascending order, as the TPU grid's innermost part axis summed them.
template <int PM, int MODE>
__global__ void __launch_bounds__(kThreads)
texture_warp_fwd_kernel(const float4* __restrict__ tex4,
                        long long tex4_bstride, const float* __restrict__ u,
                        const float* __restrict__ v, long long uv_bstride,
                        long long uv_pstride, const float* __restrict__ src,
                        long long src_bstride, float* __restrict__ w_out,
                        float* __restrict__ out, int P, int C, int T, int N,
                        int k, float eps) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const int b = blockIdx.y;
  const float* sb = src + b * src_bstride + n;

  // 1. the pixel's P weights (or fg values), all loads in flight at once;
  //    the selection in registers; w out where it is kept; the selected
  //    parts as a bit mask
  float x[PM];
#pragma unroll
  for (int p = 0; p < PM; ++p) x[p] = (p < P) ? __ldg(sb + (long long)p * N) : 0.0f;
  if (MODE != kFwdGivenW) select_parts<PM>(x, P, k, eps);
  if (MODE == kFwdSelectKeep) {
    float* wb = w_out + (long long)b * P * N + n;
#pragma unroll
    for (int p = 0; p < PM; ++p) {
      if (p < P) wb[(long long)p * N] = x[p];
    }
  }
  unsigned mask = 0u;
#pragma unroll
  for (int p = 0; p < PM; ++p) mask |= (x[p] != 0.0f) ? (1u << p) : 0u;

  // 2. the selected parts in ascending order, kFwdChunk at a time: their
  //    weights (reloaded: an L1 hit, where picking x[p] out of registers
  //    by a runtime p costs more), u and v; then their four taps each;
  //    then the arithmetic
  const float* ub = u + b * uv_bstride + n;
  const float* vb = v + b * uv_bstride + n;
  const float4* t4 = tex4 + b * tex4_bstride;
  const int tt = T * T;
  const float ext1 = (float)(T - 1);
  float acc[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) acc[c] = 0.0f;
  while (mask) {
    int pp[kFwdChunk];
#pragma unroll
    for (int j = 0; j < kFwdChunk; ++j) {
      pp[j] = __ffs(mask) - 1;              // -1 once the mask is empty
      mask &= mask - 1u;
    }
    float wt[kFwdChunk], us[kFwdChunk], vs[kFwdChunk];
#pragma unroll
    for (int j = 0; j < kFwdChunk; ++j) {
      if (pp[j] >= 0) {
        wt[j] = __ldg(sb + (long long)pp[j] * N);     // == x[pp[j]]
        us[j] = __ldg(ub + pp[j] * uv_pstride);
        vs[j] = __ldg(vb + pp[j] * uv_pstride);
      }
    }
    Bilerp s[kFwdChunk];
    float4 q[kFwdChunk][4];
#pragma unroll
    for (int j = 0; j < kFwdChunk; ++j) {
      if (pp[j] >= 0) {
        s[j] = bilerp(us[j], vs[j], T, ext1);
        const float4* tp = t4 + (long long)pp[j] * tt;
        q[j][0] = __ldg(tp + s[j].o00);
        q[j][1] = __ldg(tp + s[j].o01);
        q[j][2] = __ldg(tp + s[j].o10);
        q[j][3] = __ldg(tp + s[j].o11);
      }
    }
#pragma unroll
    for (int j = 0; j < kFwdChunk; ++j) {
      if (pp[j] >= 0) blend(acc, C, wt[j], s[j], q[j][0], q[j][1], q[j][2], q[j][3]);
    }
  }
  float* ob = out + (long long)b * C * N + n;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) ob[(long long)c * N] = acc[c];
  }
}

// Refuses what the kernel does not take, writes the texel-major copy (one
// copy for a texture shared by every batch, tex_bstride 0), then launches
// the forward on the smallest part bound PM that holds P.
template <int MODE>
cudaError_t launch_fwd(const float* tex, long long tex_bstride, float* tex4,
                       const float* u, const float* v, long long uv_bstride,
                       long long uv_pstride, const float* src,
                       long long src_bstride, float* w_out, float* out, int B,
                       int P, int C, int T, int N, int k, float eps,
                       cudaStream_t s) {
  if (B < 1 || B > 65535 || N < 1 || P < 1 || P > 32 || C < 1 ||
      C > kMaxC || T < 2 || (long long)T * T > (1LL << 30))
    return cudaErrorInvalidValue;
  if (MODE != kFwdGivenW && (k < 1 || k > P)) return cudaErrorInvalidValue;
  if (MODE == kFwdSelectKeep && w_out == nullptr) return cudaErrorInvalidValue;
  const int tt = T * T;
  float4* t4 = reinterpret_cast<float4*>(tex4);
  texel_major_kernel<<<dim3((tt + kThreads - 1) / kThreads, P,
                            tex_bstride ? B : 1), kThreads, 0, s>>>(
      tex, tex_bstride, t4, P, C, tt);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long t4_bstride = tex_bstride ? (long long)P * tt : 0;
  const dim3 grid((N + kThreads - 1) / kThreads, B);
#define NHVR_FWD(PM)                                                        \
  texture_warp_fwd_kernel<PM, MODE><<<grid, kThreads, 0, s>>>(              \
      t4, t4_bstride, u, v, uv_bstride, uv_pstride, src, src_bstride, w_out, \
      out, P, C, T, N, k, eps)
  if (P <= 8) NHVR_FWD(8);
  else if (P <= 16) NHVR_FWD(16);
  else if (P <= 24) NHVR_FWD(24);
  else NHVR_FWD(32);
#undef NHVR_FWD
  return cudaGetLastError();
}

// Adds the four taps' values a[k][c] at tile[c * tt + o_k] (o_0 = o00,
// o_1 = o00 + dx, o_2 = o00 + dy * T, o_3 = o00 + dy * T + dx) once per
// distinct tap quad of the warp. Lanes whose four taps are the same (one
// __match_any_sync on a key that encodes o00, dx and dy) sum their 4 * C
// values in a shuffle tree over their peers, and the lowest of them issues
// the 4 * C shared atomics. An invalid lane adds nothing. Every lane of the
// warp calls it.
template <int C>
__device__ __forceinline__ void scatter_taps(float* tile, int tt, int T,
                                             bool valid, int o00, int dx,
                                             int dy, float (&a)[4][C]) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int key = valid ? o00 * 4 + dx * 2 + dy : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const bool leader = (peers & below) == 0u;
  unsigned rank = __popc(peers & below);          // my place among my peers
  unsigned above = peers & ~(below | (1u << lane));
  // each round: every lane adds the next remaining peer's partial sum,
  // then the lanes at odd places are done (their sums were taken)
  while (__any_sync(0xffffffffu, above != 0u)) {
    const int next = __ffs(above) - 1;
    const int src = next < 0 ? (int)lane : next;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float t = __shfl_sync(0xffffffffu, a[k][c], src);
        if (next >= 0) a[k][c] += t;
      }
    }
    above &= ~__ballot_sync(0xffffffffu, rank & 1u);
    rank >>= 1;
  }
  if (leader && valid) {
    const int o[4] = {o00, o00 + dx, o00 + dy * T, o00 + dy * T + dx};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int c = 0; c < C; ++c) atomicAdd(tile + c * tt + o[k], a[k][c]);
    }
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Values of pixels nt..nt+3 of one plane, 0 past n_end: one 16-byte load
// where vec (N % 4 == 0, the planes 16-byte aligned).
__device__ __forceinline__ float4 load4(const float* src, int nt, int n_end,
                                        int vec) {
  if (vec && nt + 3 < n_end)
    return __ldg(reinterpret_cast<const float4*>(src + nt));
  float4 r;
  r.x = nt < n_end ? __ldg(src + nt) : 0.0f;
  r.y = nt + 1 < n_end ? __ldg(src + nt + 1) : 0.0f;
  r.z = nt + 2 < n_end ? __ldg(src + nt + 2) : 0.0f;
  r.w = nt + 3 < n_end ? __ldg(src + nt + 3) : 0.0f;
  return r;
}

__device__ __forceinline__ float4 keep4(float4 x, float4 w) {
  return make_float4(w.x != 0.0f ? x.x : 0.0f, w.y != 0.0f ? x.y : 0.0f,
                     w.z != 0.0f ? x.z : 0.0f, w.w != 0.0f ? x.w : 0.0f);
}

// One cluster per (part, batch), or per part for a batch-1 texture
// (batches = B: each CTA walks its pixel chunk in every batch); see the
// header note. blockIdx.x is the rank in the cluster, blockIdx.y the part,
// blockIdx.z the batch. Each warp streams windows of 128 pixels of the
// CTA's chunk on its own (no CTA-wide barrier until the end), and loads
// the next window's w, u and v (one float4 each a lane) before it works
// the current one. Per selected pixel, with x = u*(T-1), y = v*(T-1) and
// gw = g*w (the formulas of the TPU kernel, pallas_warp2.py:414-436):
//   du = sum_c gw * ((v01-v00)(1-wy) + (v11-v10)wy) * (T-1)
//   dv = sum_c gw * (bot-top) * (T-1)
//   dw = sum_c g * samp, kept only where w > 0
//   dtex[c] += gw * bilinear weight, at each of the four clamped taps.
// du / dv / dw are 0 where w = 0. Shared memory: the dtex tile (tile4
// floats, C*T*T rounded up to 4), then per warp three planes of its window
// (w, u, v of the selected pixels on entry; dw, du, dv on exit) and the
// window's queue.
template <int C>
__global__ void __launch_bounds__(kBwdThreads, 2)
texture_warp_bwd_kernel(const float* __restrict__ tex, long long tex_bstride,
                        const float* __restrict__ u,
                        const float* __restrict__ v, long long uv_bstride,
                        long long uv_pstride, const float* __restrict__ w,
                        const float* __restrict__ g,
                        float* __restrict__ du, float* __restrict__ dv,
                        long long duv_bstride, long long duv_pstride,
                        float* __restrict__ dw, long long dw_bstride,
                        float* __restrict__ dbg,
                        float* __restrict__ dtex, long long dtex_bstride,
                        float4* tex4, int P, int T, int N, int batches,
                        int chunk, int vec) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tt = T * T;
  const int tile_len = C * tt;
  const int tile4 = (tile_len + 3) & ~3;
  float* tile = reinterpret_cast<float*>(smem4);
  float* st_w = tile + tile4 + warp * 4 * kWarpWindow;   // w in, dw out
  float* st_u = st_w + kWarpWindow;                      // u in, du out
  float* st_v = st_u + kWarpWindow;                      // v in, dv out
  int* q_n = reinterpret_cast<int*>(st_v + kWarpWindow);

  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = tid; i < tile4 / 4; i += kBwdThreads) smem4[i] = zero4;

  // 0. the cluster writes its texture texel-major, (T*T) float4 of the C
  //    channels, each rank a slice: a tap is then one 16-byte load. The
  //    cluster barrier publishes the copy (and the zeroed tiles).
  const int p = blockIdx.y;
  const int ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  float4* t4 = tex4 + ((long long)blockIdx.z * P + p) * tt;
  {
    const float* ts = tex + blockIdx.z * tex_bstride + (long long)p * tile_len;
    const int per = (tt + ranks - 1) / ranks;
    const int i1 = min((rank + 1) * per, tt);
    for (int i = rank * per + tid; i < i1; i += kBwdThreads) {
      float4 q = zero4;
      q.x = __ldg(ts + i);
      if (C > 1) q.y = __ldg(ts + tt + i);
      if (C > 2) q.z = __ldg(ts + 2 * tt + i);
      if (C > 3) q.w = __ldg(ts + 3 * tt + i);
      t4[i] = q;
    }
  }
  cluster.sync();

  const float ext1 = (float)(T - 1);
  const int n_begin = (int)cluster.block_rank() * chunk;
  const int n_end = min(n_begin + chunk, N);
  constexpr int kStride = kBwdWarps * kWarpWindow;   // the CTA's step

  for (int bi = 0; bi < batches; ++bi) {
    const int b = blockIdx.z + bi;
    const float* wb = w + ((long long)b * P + p) * N;
    const float* ub = u + b * uv_bstride + p * uv_pstride;
    const float* vb = v + b * uv_bstride + p * uv_pstride;
    const float* gb = g + (long long)b * C * N;
    float* dub = du + b * duv_bstride + p * duv_pstride;
    float* dvb = dv + b * duv_bstride + p * duv_pstride;
    float* dwb = dw + b * dw_bstride + (long long)p * N;
    float* dbgb = p == 0 ? dbg + b * dw_bstride : nullptr;

    int n0 = n_begin + warp * kWarpWindow;
    float4 w_next = load4(wb, n0 + 4 * lane, n_end, vec);
    float4 u_next = load4(ub, n0 + 4 * lane, n_end, vec);
    float4 v_next = load4(vb, n0 + 4 * lane, n_end, vec);
    for (; n0 < n_end; n0 += kStride) {
      // 1. stage the window (w, and u / v where w != 0, so that the
      //    unselected pixels leave with du = dv = dw = 0), load the next
      //    window's, and queue the selected pixels
      const int nt = n0 + 4 * lane;
      const float4 wv = w_next;
      reinterpret_cast<float4*>(st_w)[lane] = wv;
      reinterpret_cast<float4*>(st_u)[lane] = keep4(u_next, wv);
      reinterpret_cast<float4*>(st_v)[lane] = keep4(v_next, wv);
      if (n0 + kStride < n_end) {
        w_next = load4(wb, nt + kStride, n_end, vec);
        u_next = load4(ub, nt + kStride, n_end, vec);
        v_next = load4(vb, nt + kStride, n_end, vec);
      }
      const bool s0 = wv.x != 0.0f, s1 = wv.y != 0.0f;
      const bool s2 = wv.z != 0.0f, s3 = wv.w != 0.0f;
      const int cnt = (int)s0 + (int)s1 + (int)s2 + (int)s3;
      int incl = cnt;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      const int total = __shfl_sync(0xffffffffu, incl, 31);
      int pos = incl - cnt;
      if (s0) q_n[pos++] = 4 * lane;
      if (s1) q_n[pos++] = 4 * lane + 1;
      if (s2) q_n[pos++] = 4 * lane + 2;
      if (s3) q_n[pos] = 4 * lane + 3;
      __syncwarp();

      // 2. full warps over the queue: gathers, gradients, the dtex scatter
      for (int q0 = 0; q0 < total; q0 += 32) {
        const int q = q0 + lane;
        const bool valid = q < total;
        int o00 = 0, dx = 0, dy = 0;
        float a[4][C];
#pragma unroll
        for (int c = 0; c < C; ++c) a[0][c] = a[1][c] = a[2][c] = a[3][c] = 0.0f;
        if (valid) {
          const int nl = q_n[q];
          const float wt = st_w[nl];
          const int n = n0 + nl;
          const float x = st_u[nl] * ext1;
          const float y = st_v[nl] * ext1;
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
          o00 = y0 * T + x0;
          dx = x1 - x0;
          dy = y1 - y0;
          const int o01 = o00 + dx, o10 = o00 + dy * T, o11 = o10 + dx;
          // the copy was written in this launch: coherent loads, not __ldg
          const float4 q00 = __ldca(t4 + o00), q01 = __ldca(t4 + o01);
          const float4 q10 = __ldca(t4 + o10), q11 = __ldca(t4 + o11);
          float gc[C], t00[C], t01[C], t10[C], t11[C];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            gc[c] = __ldg(gb + (long long)c * N + n);
            t00[c] = channel(q00, c);
            t01[c] = channel(q01, c);
            t10[c] = channel(q10, c);
            t11[c] = channel(q11, c);
          }
          float gu = 0.0f, gv = 0.0f, gwt = 0.0f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float top = t00[c] * (1.0f - wx) + t01[c] * wx;
            const float bot = t10[c] * (1.0f - wx) + t11[c] * wx;
            const float samp = top * (1.0f - wy) + bot * wy;
            const float gw = gc[c] * wt;
            gu += gw * ((t01[c] - t00[c]) * (1.0f - wy) +
                        (t11[c] - t10[c]) * wy) * ext1;
            gv += gw * (bot - top) * ext1;
            gwt += gc[c] * samp;
            a[0][c] = gw * (1.0f - wx) * (1.0f - wy);
            a[1][c] = gw * wx * (1.0f - wy);
            a[2][c] = gw * (1.0f - wx) * wy;
            a[3][c] = gw * wx * wy;
          }
          st_u[nl] = gu;
          st_v[nl] = gv;
          st_w[nl] = wt > 0.0f ? gwt : 0.0f;
        }
        scatter_taps<C>(tile, tt, T, valid, o00, dx, dy, a);
      }
      __syncwarp();

      // 3. the window's du / dv / dw (and part 0's zero background
      //    channel) out with coalesced stores
      if (vec && nt + 3 < n_end) {
        *reinterpret_cast<float4*>(dub + nt) = reinterpret_cast<float4*>(st_u)[lane];
        *reinterpret_cast<float4*>(dvb + nt) = reinterpret_cast<float4*>(st_v)[lane];
        *reinterpret_cast<float4*>(dwb + nt) = reinterpret_cast<float4*>(st_w)[lane];
        if (dbgb) *reinterpret_cast<float4*>(dbgb + nt) = zero4;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (nt + j < n_end) {
            dub[nt + j] = st_u[4 * lane + j];
            dvb[nt + j] = st_v[4 * lane + j];
            dwb[nt + j] = st_w[4 * lane + j];
            if (dbgb) dbgb[nt + j] = 0.0f;
          }
        }
      }
      __syncwarp();            // the staging is the next window's
    }
  }

  // 4. every rank's tile is complete: rank r sums slice r of the tile over
  //    the cluster's shared memory and writes it to dtex
  cluster.sync();
  float* dst = dtex + blockIdx.z * dtex_bstride + (long long)p * tile_len;
  if ((tile_len & 3) == 0) {
    const int len4 = tile_len / 4;
    const int slice = (len4 + ranks - 1) / ranks;
    const int i1 = min((rank + 1) * slice, len4);
    for (int i = rank * slice + tid; i < i1; i += kBwdThreads) {
      float4 s = zero4;
      for (int r = 0; r < ranks; ++r)
        s = add4(s, cluster.map_shared_rank(smem4, r)[i]);
      reinterpret_cast<float4*>(dst)[i] = s;
    }
  } else {
    const int slice = (tile_len + ranks - 1) / ranks;
    const int i1 = min((rank + 1) * slice, tile_len);
    for (int i = rank * slice + tid; i < i1; i += kBwdThreads) {
      float s = 0.0f;
      for (int r = 0; r < ranks; ++r) s += cluster.map_shared_rank(tile, r)[i];
      dst[i] = s;
    }
  }
  cluster.sync();              // no CTA leaves while its tile is being read
}

template <int C>
cudaError_t launch_bwd(const float* tex, long long tex_bstride,
                       const float* u, const float* v, long long uv_bstride,
                       long long uv_pstride, const float* w, const float* g,
                       float* du, float* dv, long long duv_bstride,
                       long long duv_pstride, float* dw, long long dw_bstride,
                       float* dbg, float* dtex, long long dtex_bstride,
                       float4* tex4, int B, int P, int T, int N, int cluster,
                       int chunk, int smem, int per_sample, int vec,
                       cudaStream_t stream) {
  // the plan comes from Python: refuse one whose shared bytes do not hold
  // the tile and the warps' windows, whose chunk breaks the float4 windows
  // or whose ranks leave pixels out
  const long long tile4 = ((long long)C * T * T + 3) & ~3LL;
  if (cluster < 1 || cluster > kMaxCluster || chunk < 4 || chunk % 4 != 0 ||
      (long long)cluster * chunk < N ||
      smem < 4 * (tile4 + kBwdWarps * 4 * kWarpWindow))
    return cudaErrorInvalidValue;
  static int smem_set = 48 * 1024;   // the opt-in, raised once per size
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        texture_warp_bwd_kernel<C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, P, per_sample ? B : 1);
  cfg.blockDim = dim3(kBwdThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, texture_warp_bwd_kernel<C>, tex, tex_bstride, u, v, uv_bstride,
      uv_pstride, w, g, du, dv, duv_bstride, duv_pstride, dw, dw_bstride, dbg,
      dtex, dtex_bstride, tex4, P, T, N, per_sample ? 1 : B, chunk, vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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

// The forward with w given (contiguous (B, P, N)). tex4 is scratch for the
// texel-major copy: (B, P, T*T, 4) floats, (1, P, T*T, 4) for a texture
// shared by every batch (tex_bstride 0), 16-byte aligned.
extern "C" int nhvr_texture_warp_fwd(const float* tex, long long tex_bstride,
                                     const float* u, const float* v,
                                     long long uv_bstride, long long uv_pstride,
                                     const float* w, float* out, float* tex4,
                                     int B, int P, int C, int T, int N,
                                     void* stream) {
  return (int)launch_fwd<kFwdGivenW>(
      tex, tex_bstride, tex4, u, v, uv_bstride, uv_pstride, w,
      (long long)P * N, nullptr, out, B, P, C, T, N, 0, 0.0f,
      static_cast<cudaStream_t>(stream));
}

// The forward with the selection fused in: fg is the strided (B, P, N)
// view probs[:, 1:] (parts N apart). w = nullptr selects in registers and
// writes no w; otherwise w (contiguous (B, P, N)) gets the selection,
// bit-identical to nhvr_topk_select's with block_parts 0. tex4 as above.
extern "C" int nhvr_texture_warp_topk_fwd(const float* tex,
                                          long long tex_bstride,
                                          const float* u, const float* v,
                                          long long uv_bstride,
                                          long long uv_pstride,
                                          const float* fg, long long fg_bstride,
                                          float* w, float* out, float* tex4,
                                          int B, int P, int C, int T, int N,
                                          int k, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w == nullptr)
    return (int)launch_fwd<kFwdSelect>(
        tex, tex_bstride, tex4, u, v, uv_bstride, uv_pstride, fg, fg_bstride,
        nullptr, out, B, P, C, T, N, k, eps, s);
  return (int)launch_fwd<kFwdSelectKeep>(
      tex, tex_bstride, tex4, u, v, uv_bstride, uv_pstride, fg, fg_bstride, w,
      out, B, P, C, T, N, k, eps, s);
}

// Writes every element of du / dv (duv), dw and dbg (dprobs' parts and its
// background channel) and dtex: nothing needs zeroing first. cluster,
// chunk and smem come from ops/texture_warp_kernel.bwd_launch_plan; tex4
// is scratch for the texel-major copy of the texture, (groups, T*T, 4)
// floats, 16-byte aligned;
// per_sample = 0 sums every batch into a batch-1 dtex (dtex_bstride 0);
// vec = 1 (N % 4 == 0; w, u, v 16-byte aligned with u / v strides that
// are multiples of 4) takes the float4 accesses.
extern "C" int nhvr_texture_warp_bwd(const float* tex, long long tex_bstride,
                                     const float* u, const float* v,
                                     long long uv_bstride, long long uv_pstride,
                                     const float* w, const float* g,
                                     float* du, float* dv,
                                     long long duv_bstride,
                                     long long duv_pstride, float* dw,
                                     long long dw_bstride, float* dbg,
                                     float* dtex, long long dtex_bstride,
                                     float* tex4, int B, int P, int C, int T,
                                     int N,
                                     int cluster, int chunk, int smem,
                                     int per_sample, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NHVR_BWD(CC)                                                        \
  launch_bwd<CC>(tex, tex_bstride, u, v, uv_bstride, uv_pstride, w, g, du,  \
                 dv, duv_bstride, duv_pstride, dw, dw_bstride, dbg, dtex,   \
                 dtex_bstride, reinterpret_cast<float4*>(tex4), B, P, T, N, \
                 cluster, chunk, smem, per_sample, vec, s)
  switch (C) {
    case 1: return (int)NHVR_BWD(1);
    case 2: return (int)NHVR_BWD(2);
    case 3: return (int)NHVR_BWD(3);
    case 4: return (int)NHVR_BWD(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef NHVR_BWD
}
