// One optimizer's Adam update in one pass, with the EMA of the parameters
// folded in where it is given, for sm_90a (H100).
//
// Replaces no Pallas kernel: on the TPU the JAX package's update (optax's
// adam, then the EMA of train/state.py) is plain jnp that XLA fuses into
// the compiled step. The port ran torch's capturable foreach Adam instead:
// eight passes over full-size tensors (80 bytes an element) and about ten
// small launches for the bias corrections, then the EMA as three foreach
// passes (28 bytes an element).
//
// Spec (torch/optim/adam.py _multi_tensor_adam, capturable, without weight
// decay, amsgrad or maximize; then train/state.py blend_ema's card form),
// for every element of tensor i, with t its step count (advanced by the
// wrapper before the launch) and lr and d read from the device:
//   m = lerp(m, g, 1 - beta1)                   (ATen's lerp)
//   v = v * beta2 + (1 - beta2) * g * g
//   step_size = 1 / ((beta1^t - 1) / lr)        (negative)
//   bc2 = sqrt(-(beta2^t - 1))
//   p = p + m / ((sqrt(v) / bc2 + eps) / step_size)
//   e = e * d + p * (1 - d)                      (with an EMA)
//
// Bound (H100 SXM, 3.35 TB/s): p, g, m and v read, p, m and v written, 28
// bytes an element; with the EMA e read and written too, 36 bytes. A few
// dozen operations an element: bytes bind. The flagship's step: G's 193.03 M
// elements with the EMA and D's 5.64 M without, 7.11 GB -> 2.12 ms.
//
// Design:
//   * one launch for all of an optimizer's tensors (up to kMaxTensors): the
//     pointer table and the sizes travel in the kernel's parameters
//     (__grid_constant__; CUDA 12.1+ takes up to 32 KB of them), so a CUDA
//     graph captures the gradients' addresses as they are inside the
//     capture and no device buffer is filled from the host;
//   * each tensor cut into chunks of kChunk elements, one block a chunk; a
//     block finds its tensor by a binary search over the tensors' first
//     blocks (the same for the whole block);
//   * 16-byte loads and stores (the wrapper checks that every pointer is
//     16-byte aligned and that p, g, m, v and e share their strides), kIlp
//     of each array in flight a thread before any is used, and a scalar
//     tail for a tensor whose size is not a multiple of 4;
//   * torch's operations in torch's order and precision (float32), so each
//     rounds where the foreach passes round, up to the multiply-adds nvcc
//     contracts into one FMA where torch's passes round twice;
//   * the EMA from the new p in registers, its products and sum written
//     with __fmul_rn / __fadd_rn (never contracted): the bits of the card's
//     three foreach passes given the same p;
//   * no atomics and no shared memory: deterministic, so the data-parallel
//     ranks stay bit-equal.
// The step counts are advanced before the launch (the wrapper's one foreach
// add, as torch advances them): a block cannot know whether the other
// blocks of its tensor have read the count yet.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxTensors = 224;
constexpr int kThreads = 256;
constexpr int kIlp = 4;
// elements a block: two rounds of kIlp float4s a thread
constexpr long long kChunk = 2LL * kThreads * kIlp * 4;

struct Table {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  float* e[kMaxTensors];
  const float* step[kMaxTensors];
  long long n[kMaxTensors];
  int first_block[kMaxTensors + 1];
  int count;
};

struct Hyper {
  const float* lr;
  const float* decay;   // the EMA's decay (null without an EMA)
  float beta1, beta2;
  float lerp_w;         // 1 - beta1, rounded to float32 as torch's scalar
  float sq_w;           // 1 - beta2
  float eps;
};

struct Coef {
  float step_size, bc2, d, omd;
};

__device__ __forceinline__ float lerp_aten(float self, float end, float w) {
  return fabsf(w) < 0.5f ? self + w * (end - self)
                         : end - (end - self) * (1.0f - w);
}

template <bool kEma>
__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       float& e, const Hyper& h,
                                       const Coef& c) {
  m = lerp_aten(m, g, h.lerp_w);
  v = v * h.beta2;
  v = v + h.sq_w * g * g;
  float denom = sqrtf(v);
  denom = denom / c.bc2;
  denom = denom + h.eps;
  denom = denom / c.step_size;
  p = p + m / denom;
  if (kEma) e = __fadd_rn(__fmul_rn(e, c.d), __fmul_rn(p, c.omd));
}

template <bool kEma>
__device__ __forceinline__ void update4(float4& p, const float4& g, float4& m,
                                        float4& v, float4& e, const Hyper& h,
                                        const Coef& c) {
  update<kEma>(p.x, g.x, m.x, v.x, e.x, h, c);
  update<kEma>(p.y, g.y, m.y, v.y, e.y, h, c);
  update<kEma>(p.z, g.z, m.z, v.z, e.z, h, c);
  update<kEma>(p.w, g.w, m.w, v.w, e.w, h, c);
}

template <bool kEma>
__global__ void __launch_bounds__(kThreads)
    adam_ema_kernel(const __grid_constant__ Table t,
                    const __grid_constant__ Hyper h) {
  // this block's tensor: the last whose first block is at or before it
  const int b = blockIdx.x;
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first_block[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const int i = lo;
  const long long start = (long long)(b - t.first_block[i]) * kChunk;
  const long long len = min(kChunk, t.n[i] - start);

  // the bias corrections as torch's foreach passes compute them
  Coef c;
  const float step = *t.step[i];
  float bc1 = powf(h.beta1, step) - 1.0f;
  bc1 = bc1 / *h.lr;
  c.step_size = 1.0f / bc1;
  c.bc2 = sqrtf(-(powf(h.beta2, step) - 1.0f));
  c.d = kEma ? *h.decay : 0.0f;
  c.omd = 1.0f - c.d;

  float* __restrict__ p = t.p[i] + start;
  const float* __restrict__ g = t.g[i] + start;
  float* __restrict__ m = t.m[i] + start;
  float* __restrict__ v = t.v[i] + start;
  float* __restrict__ e = kEma ? t.e[i] + start : nullptr;

  const long long nvec = len >> 2;
  float4* __restrict__ p4 = reinterpret_cast<float4*>(p);
  const float4* __restrict__ g4 = reinterpret_cast<const float4*>(g);
  float4* __restrict__ m4 = reinterpret_cast<float4*>(m);
  float4* __restrict__ v4 = reinterpret_cast<float4*>(v);
  float4* __restrict__ e4 = reinterpret_cast<float4*>(e);
  for (long long base = threadIdx.x; base < nvec;
       base += (long long)kThreads * kIlp) {
    float4 rp[kIlp], rg[kIlp], rm[kIlp], rv[kIlp], re[kIlp];
#pragma unroll
    for (int k = 0; k < kIlp; ++k) {
      const long long j = base + (long long)k * kThreads;
      if (j < nvec) {
        rp[k] = p4[j];
        rg[k] = g4[j];
        rm[k] = m4[j];
        rv[k] = v4[j];
        if (kEma) re[k] = e4[j];
      }
    }
#pragma unroll
    for (int k = 0; k < kIlp; ++k) {
      const long long j = base + (long long)k * kThreads;
      if (j < nvec) {
        update4<kEma>(rp[k], rg[k], rm[k], rv[k], re[k], h, c);
        p4[j] = rp[k];
        m4[j] = rm[k];
        v4[j] = rv[k];
        if (kEma) e4[j] = re[k];
      }
    }
  }
  for (long long j = (nvec << 2) + threadIdx.x; j < len; j += kThreads) {
    float sp = p[j], sm = m[j], sv = v[j], se = kEma ? e[j] : 0.0f;
    update<kEma>(sp, g[j], sm, sv, se, h, c);
    p[j] = sp;
    m[j] = sm;
    v[j] = sv;
    if (kEma) e[j] = se;
  }
}

}  // namespace

// count tensors (1..kMaxTensors) of sizes n, each array of count device
// pointers; e null for an update without the EMA (decay is then ignored).
// lr and decay point at float32 scalars on the device. Returns the launch's
// CUDA error (0 on success).
extern "C" int nhvr_adam_ema(int count, void* const* p, void* const* g,
                             void* const* m, void* const* v, void* const* e,
                             void* const* step, const long long* n,
                             const void* lr, const void* decay, float beta1,
                             float beta2, float lerp_w, float sq_w, float eps,
                             void* stream) {
  if (count < 1 || count > kMaxTensors) return (int)cudaErrorInvalidValue;
  Table t;
  t.count = count;
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    t.p[i] = static_cast<float*>(p[i]);
    t.g[i] = static_cast<const float*>(g[i]);
    t.m[i] = static_cast<float*>(m[i]);
    t.v[i] = static_cast<float*>(v[i]);
    t.e[i] = e != nullptr ? static_cast<float*>(e[i]) : nullptr;
    t.step[i] = static_cast<const float*>(step[i]);
    t.n[i] = n[i];
    t.first_block[i] = (int)blocks;
    blocks += (n[i] + kChunk - 1) / kChunk;
  }
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  t.first_block[count] = (int)blocks;
  if (blocks == 0) return (int)cudaSuccess;
  const Hyper h{static_cast<const float*>(lr),
                static_cast<const float*>(decay), beta1, beta2, lerp_w, sq_w,
                eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (e != nullptr)
    adam_ema_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(t, h);
  else
    adam_ema_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(t, h);
  return (int)cudaGetLastError();
}
