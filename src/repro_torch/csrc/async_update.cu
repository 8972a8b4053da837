// Fused AsGrad server-update kernels for Hopper (sm_90a): the paper's eq. 2
// x_{t+1} = x_t - gamma * g(x_{pi_t}) as one elementwise pass per leaf.
//
// Replaces the six TPU kernels of src/repro/kernels/async_update.py:
//   async_update_kernel           <- async_update_pallas         (_async_update_kernel)
//   sgd_step_kernel               <- sgd_step_pallas             (_sgd_step_kernel)
//   momentum_kernel<DELAYED = 0>  <- sgd_momentum_step_pallas    (_sgd_momentum_kernel)
//   momentum_kernel<DELAYED = 1>  <- sgd_momentum_delayed_pallas (_sgd_momentum_delayed_kernel)
//   adam_kernel<DELAYED = 0>      <- fused_adam_pallas           (_fused_adam_kernel)
//   adam_kernel<DELAYED = 1>      <- fused_adam_delayed_pallas   (_fused_adam_delayed_kernel)
// Each computes what the Pallas body computes, element by element, in f32,
// and writes back in the operand's dtype:
//   async_update:         p' = p - eff * gbuf;                 gbuf' = g
//   sgd_step:             p' = p - eff * g
//   sgd_momentum_step:    m' = mu m + clip * g;   p' = p - lr_eff * m'
//   sgd_momentum_delayed: sgd_momentum_step on gbuf;           gbuf' = g
//   fused_adam:           s = clip * g;    m' = b1 m + (1 - b1) s;
//                         v' = b2 v + (1 - b2) s s;
//                         p' = p - lr ((m'/bc1) / (sqrt(v'/bc2) + eps) + wd p)
//   fused_adam_delayed:   fused_adam on s = clip * gbuf;        gbuf' = g
//
// Bound on an H100 SXM (3.35 TB/s): about 20 f32 operations per element
// against 6 to 26 bytes moved, so memory bounds every kernel.  Per element
// read + written (bf16 p / gbuf / g, f32 m / v), and for one round over the
// 494,032,768 elements of qwen2-0.5b's 14 leaves:
//   fused_adam_delayed    14 + 12 = 26 B   12.85 GB   3.83 ms
//   fused_adam            12 + 10 = 22 B   10.87 GB   3.24 ms
//   sgd_momentum_delayed  10 +  8 = 18 B    8.89 GB   2.65 ms
//   sgd_momentum_step      8 +  6 = 14 B    6.92 GB   2.06 ms
//   async_update           6 +  4 = 10 B    4.94 GB   1.47 ms
//   sgd_step               4 +  2 =  6 B    2.96 GB   0.88 ms
//
// Design, for that bound:
// * one pass over the flat leaf, a grid-stride loop of 256-thread blocks;
//   each thread takes 8 consecutive elements per step with 16-byte vector
//   loads and stores (one for bf16, two for f32) when every pointer is
//   16-byte aligned, and a scalar tail masks the ragged end -- nothing is
//   padded, where the TPU wrapper pads every operand to whole tiles;
// * in place: p, m, v and gbuf are updated where they lie (the JAX step
//   donates them).  A thread reads its stale gbuf values into registers
//   before it writes g over them; gbuf' = g is a copy of the bits;
// * the scalars [lr, bc1, bc2, clip, wd, run] (Adam), [lr_eff, clip, run]
//   (heavy ball) or [eff, run] (SGD) are read by
//   pointer from a small f32 device tensor, as the TPU kernels read them
//   from an SMEM block: the clip scale, the bias corrections and the gate
//   are device values, and nothing here makes the host wait for them;
// * run is the guard rails' skip gate, 1 or 0, written on the device from
//   the round's finite check.  Every block reads it first and, at 0,
//   returns before any load or store, so p, m, v and gbuf keep their bits
//   even when g is NaN (the stale gbuf is not overwritten with g either,
//   as the JAX step's skip branch keeps it).  Without guards it is 1 and
//   the kernels compute what they computed without it;
// * the kernel allocates nothing and launches on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;                  // elements per thread per step
constexpr int MAX_BLOCKS = 132 * 16;    // 16 blocks on each of 132 SMs
// where each scalar block keeps its run flag
constexpr int SGD_RUN = 1, MOMENTUM_RUN = 2, ADAM_RUN = 5;

// the skip gate: false when the round's update must write nothing
__device__ __forceinline__ bool runs(const float* scal, int at) { return scal[at] != 0.0f; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VEC values at a 16-byte-aligned address, widened to f32
__device__ __forceinline__ void load_vec(const float* src, float (&x)[VEC]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* src, float (&x)[VEC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < VEC / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* dst, const float (&x)[VEC]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* dst, const float (&x)[VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < VEC / 2; ++k) h[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

// gbuf' = g for VEC elements: the bits, 16 bytes at a time
template <typename G>
__device__ __forceinline__ void copy_vec(G* dst, const G* src) {
  constexpr int WORDS = VEC * sizeof(G) / 16;
#pragma unroll
  for (int w = 0; w < WORDS; ++w)
    reinterpret_cast<uint4*>(dst)[w] = reinterpret_cast<const uint4*>(src)[w];
}

struct AdamCoefs { float b1, omb1, b2, omb2, eps; };   // omb = 1 - b, rounded once

struct AdamScalars {
  float lr, bc1, bc2, clip, wd;
  __device__ __forceinline__ explicit AdamScalars(const float* s)
      : lr(s[0]), bc1(s[1]), bc2(s[2]), clip(s[3]), wd(s[4]) {}
};

// the Pallas body's arithmetic, in its order
__device__ __forceinline__ void adam_elem(float& p, float& m, float& v, float graw,
                                          const AdamScalars& s, const AdamCoefs& c) {
  const float g = s.clip * graw;
  m = c.b1 * m + c.omb1 * g;
  v = c.b2 * v + c.omb2 * g * g;
  float step = (m / s.bc1) / (sqrtf(v / s.bc2) + c.eps);
  step = step + s.wd * p;
  p = p - s.lr * step;
}

__device__ __forceinline__ long long thread_id() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ long long n_threads() {
  return (long long)gridDim.x * blockDim.x;
}

template <typename P, typename G, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
async_update_kernel(P* __restrict__ p, G* __restrict__ gbuf, const G* __restrict__ g,
                    const float* __restrict__ scal, long long n) {
  if (!runs(scal, SGD_RUN)) return;
  const float eff = scal[0];
  const long long nvec = ALIGNED ? n / VEC : 0;
  for (long long j = thread_id(); j < nvec; j += n_threads()) {
    const long long i = j * VEC;
    float pv[VEC], stale[VEC];
    load_vec(p + i, pv);
    load_vec(gbuf + i, stale);
    copy_vec(gbuf + i, g + i);
#pragma unroll
    for (int k = 0; k < VEC; ++k) pv[k] = pv[k] - eff * stale[k];
    store_vec(p + i, pv);
  }
  for (long long i = nvec * VEC + thread_id(); i < n; i += n_threads()) {
    const float stale = to_f32(gbuf[i]);
    gbuf[i] = g[i];
    p[i] = from_f32<P>(to_f32(p[i]) - eff * stale);
  }
}

template <typename P, typename G, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
sgd_step_kernel(P* __restrict__ p, const G* __restrict__ g,
                const float* __restrict__ scal, long long n) {
  if (!runs(scal, SGD_RUN)) return;
  const float eff = scal[0];
  const long long nvec = ALIGNED ? n / VEC : 0;
  for (long long j = thread_id(); j < nvec; j += n_threads()) {
    const long long i = j * VEC;
    float pv[VEC], gv[VEC];
    load_vec(p + i, pv);
    load_vec(g + i, gv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) pv[k] = pv[k] - eff * gv[k];
    store_vec(p + i, pv);
  }
  for (long long i = nvec * VEC + thread_id(); i < n; i += n_threads())
    p[i] = from_f32<P>(to_f32(p[i]) - eff * to_f32(g[i]));
}

// DELAYED: the step consumes the stale gbuf and g is written over it;
// otherwise the step consumes g and gbuf is unused (may be null).
// scal = [lr_eff, clip, run] with lr_eff = lr * delay_scale; mu is the momentum.
template <typename P, typename G, bool ALIGNED, bool DELAYED>
__global__ void __launch_bounds__(THREADS)
momentum_kernel(P* __restrict__ p, float* __restrict__ m, G* __restrict__ gbuf,
                const G* __restrict__ g, const float* __restrict__ scal, long long n,
                float mu) {
  if (!runs(scal, MOMENTUM_RUN)) return;
  const float lr_eff = scal[0], clip = scal[1];
  const long long nvec = ALIGNED ? n / VEC : 0;
  for (long long j = thread_id(); j < nvec; j += n_threads()) {
    const long long i = j * VEC;
    float pv[VEC], mv[VEC], gv[VEC];
    load_vec(p + i, pv);
    load_vec(m + i, mv);
    if constexpr (DELAYED) {
      load_vec(gbuf + i, gv);
      copy_vec(gbuf + i, g + i);
    } else {
      load_vec(g + i, gv);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      mv[k] = mu * mv[k] + clip * gv[k];
      pv[k] = pv[k] - lr_eff * mv[k];
    }
    store_vec(p + i, pv);
    store_vec(m + i, mv);
  }
  for (long long i = nvec * VEC + thread_id(); i < n; i += n_threads()) {
    float graw;
    if constexpr (DELAYED) {
      graw = to_f32(gbuf[i]);
      gbuf[i] = g[i];
    } else {
      graw = to_f32(g[i]);
    }
    const float mi = mu * m[i] + clip * graw;
    m[i] = mi;
    p[i] = from_f32<P>(to_f32(p[i]) - lr_eff * mi);
  }
}

// DELAYED: the step consumes the stale gbuf and g is written over it;
// otherwise the step consumes g and gbuf is unused (may be null)
template <typename P, typename G, bool ALIGNED, bool DELAYED>
__global__ void __launch_bounds__(THREADS)
adam_kernel(P* __restrict__ p, float* __restrict__ m, float* __restrict__ v,
            G* __restrict__ gbuf, const G* __restrict__ g,
            const float* __restrict__ scal, long long n, AdamCoefs c) {
  if (!runs(scal, ADAM_RUN)) return;
  const AdamScalars s(scal);
  const long long nvec = ALIGNED ? n / VEC : 0;
  for (long long j = thread_id(); j < nvec; j += n_threads()) {
    const long long i = j * VEC;
    float pv[VEC], mv[VEC], vv[VEC], gv[VEC];
    load_vec(p + i, pv);
    load_vec(m + i, mv);
    load_vec(v + i, vv);
    if constexpr (DELAYED) {
      load_vec(gbuf + i, gv);
      copy_vec(gbuf + i, g + i);
    } else {
      load_vec(g + i, gv);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) adam_elem(pv[k], mv[k], vv[k], gv[k], s, c);
    store_vec(p + i, pv);
    store_vec(m + i, mv);
    store_vec(v + i, vv);
  }
  for (long long i = nvec * VEC + thread_id(); i < n; i += n_threads()) {
    float graw;
    if constexpr (DELAYED) {
      graw = to_f32(gbuf[i]);
      gbuf[i] = g[i];
    } else {
      graw = to_f32(g[i]);
    }
    float pi = to_f32(p[i]), mi = m[i], vi = v[i];
    adam_elem(pi, mi, vi, graw, s, c);
    p[i] = from_f32<P>(pi);
    m[i] = mi;
    v[i] = vi;
  }
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* q : ptrs)
    if (q != nullptr && reinterpret_cast<uintptr_t>(q) % 16 != 0) return false;
  return true;
}

int n_blocks(long long n, bool aligned) {
  const long long work = aligned ? n / VEC + n % VEC : n;   // items of the longer loop
  long long b = (work + THREADS - 1) / THREADS;
  if (b > MAX_BLOCKS) b = MAX_BLOCKS;
  return b < 1 ? 1 : (int)b;
}

// Calls f(P(), G()) with the element types named by the dtype codes
// (0 = float32, 1 = bfloat16); an unknown code is cudaErrorInvalidValue.
template <typename F>
cudaError_t by_dtype(int p_dtype, int g_dtype, F f) {
  if (p_dtype == 0 && g_dtype == 0) return f(float(), float());
  if (p_dtype == 0 && g_dtype == 1) return f(float(), __nv_bfloat16());
  if (p_dtype == 1 && g_dtype == 0) return f(__nv_bfloat16(), float());
  if (p_dtype == 1 && g_dtype == 1) return f(__nv_bfloat16(), __nv_bfloat16());
  return cudaErrorInvalidValue;
}

template <bool DELAYED>
int adam_launch(void* p, float* m, float* v, void* gbuf, const void* g,
                const float* scal, long long n, int p_dtype, int g_dtype, float b1,
                float omb1, float b2, float omb2, float eps, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const AdamCoefs c{b1, omb1, b2, omb2, eps};
  const bool al = aligned16({p, m, v, gbuf, g});
  const int blocks = n_blocks(n, al);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)by_dtype(p_dtype, g_dtype, [&](auto P0, auto G0) {
    using P = decltype(P0);
    using G = decltype(G0);
    if (al)
      adam_kernel<P, G, true, DELAYED><<<blocks, THREADS, 0, st>>>(
          (P*)p, m, v, (G*)gbuf, (const G*)g, scal, n, c);
    else
      adam_kernel<P, G, false, DELAYED><<<blocks, THREADS, 0, st>>>(
          (P*)p, m, v, (G*)gbuf, (const G*)g, scal, n, c);
    return cudaGetLastError();
  });
}

template <bool DELAYED>
int momentum_launch(void* p, float* m, void* gbuf, const void* g, const float* scal,
                    long long n, int p_dtype, int g_dtype, float mu, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const bool al = aligned16({p, m, gbuf, g});
  const int blocks = n_blocks(n, al);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)by_dtype(p_dtype, g_dtype, [&](auto P0, auto G0) {
    using P = decltype(P0);
    using G = decltype(G0);
    if (al)
      momentum_kernel<P, G, true, DELAYED><<<blocks, THREADS, 0, st>>>(
          (P*)p, m, (G*)gbuf, (const G*)g, scal, n, mu);
    else
      momentum_kernel<P, G, false, DELAYED><<<blocks, THREADS, 0, st>>>(
          (P*)p, m, (G*)gbuf, (const G*)g, scal, n, mu);
    return cudaGetLastError();
  });
}

}  // namespace

// Every entry point updates its operands in place over n > 0 contiguous
// elements and returns the launch's cudaError_t (0 = launched).
// p_dtype / g_dtype: 0 = float32, 1 = bfloat16 (gbuf has g's dtype; m, v
// are float32).  scal: device float32, [eff, run] for the SGD kernels,
// [lr_eff, clip, run] for the heavy-ball kernels and
// [lr, bc1, bc2, clip, wd, run] for the Adam kernels, run = 0 making the
// launch write nothing.  stream: a cudaStream_t.

extern "C" int async_update(void* p, void* gbuf, const void* g, const float* scal,
                            long long n, int p_dtype, int g_dtype, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const bool al = aligned16({p, gbuf, g});
  const int blocks = n_blocks(n, al);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)by_dtype(p_dtype, g_dtype, [&](auto P0, auto G0) {
    using P = decltype(P0);
    using G = decltype(G0);
    if (al)
      async_update_kernel<P, G, true><<<blocks, THREADS, 0, st>>>(
          (P*)p, (G*)gbuf, (const G*)g, scal, n);
    else
      async_update_kernel<P, G, false><<<blocks, THREADS, 0, st>>>(
          (P*)p, (G*)gbuf, (const G*)g, scal, n);
    return cudaGetLastError();
  });
}

extern "C" int sgd_step(void* p, const void* g, const float* scal, long long n,
                        int p_dtype, int g_dtype, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const bool al = aligned16({p, g});
  const int blocks = n_blocks(n, al);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)by_dtype(p_dtype, g_dtype, [&](auto P0, auto G0) {
    using P = decltype(P0);
    using G = decltype(G0);
    if (al)
      sgd_step_kernel<P, G, true><<<blocks, THREADS, 0, st>>>((P*)p, (const G*)g, scal, n);
    else
      sgd_step_kernel<P, G, false><<<blocks, THREADS, 0, st>>>((P*)p, (const G*)g, scal, n);
    return cudaGetLastError();
  });
}

extern "C" int sgd_momentum_step(void* p, float* m, const void* g, const float* scal,
                                 long long n, int p_dtype, int g_dtype, float mu,
                                 void* stream) {
  return momentum_launch<false>(p, m, nullptr, g, scal, n, p_dtype, g_dtype, mu, stream);
}

extern "C" int sgd_momentum_delayed(void* p, float* m, void* gbuf, const void* g,
                                    const float* scal, long long n, int p_dtype,
                                    int g_dtype, float mu, void* stream) {
  return momentum_launch<true>(p, m, gbuf, g, scal, n, p_dtype, g_dtype, mu, stream);
}

extern "C" int fused_adam(void* p, float* m, float* v, const void* g, const float* scal,
                          long long n, int p_dtype, int g_dtype, float b1, float omb1,
                          float b2, float omb2, float eps, void* stream) {
  return adam_launch<false>(p, m, v, nullptr, g, scal, n, p_dtype, g_dtype, b1, omb1, b2,
                            omb2, eps, stream);
}

extern "C" int fused_adam_delayed(void* p, float* m, float* v, void* gbuf, const void* g,
                                  const float* scal, long long n, int p_dtype,
                                  int g_dtype, float b1, float omb1, float b2, float omb2,
                                  float eps, void* stream) {
  return adam_launch<true>(p, m, v, gbuf, g, scal, n, p_dtype, g_dtype, b1, omb1, b2,
                           omb2, eps, stream);
}
