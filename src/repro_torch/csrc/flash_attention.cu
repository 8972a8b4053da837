// Flash attention forward for Hopper (sm_90a): causal + sliding window, GQA.
//
// Replaces the TPU kernel `flash_attention_pallas` / `_attn_kernel` in
// src/repro/kernels/flash_attention.py.  Same function: blockwise online
// softmax, head h reads kv head h / (H / KV), scores scaled by 1/sqrt(D),
// masks by absolute position from 0 for both q and k (causal: kp <= qp;
// window: kp > qp - window), running m / l / acc in f32, a row with no
// visible key writes 0, output in the input dtype.
//
// Bound on an H100 SXM: at the serving path's prefill shape (B=4, S=1024,
// H=14, KV=2, D=64, bf16, causal) the work is ~7.5 GFLOP against ~16.8 MB
// moved, so the tensor-core rate bounds it (~7.6 us at 989 TFLOP/s against
// ~5.0 us at 3.35 TB/s).  This first version is the simple kernel that is
// right: scores and the P.V product are f32 FMAs on the CUDA cores, fed
// from shared memory, so it runs far from that bound.  wgmma, TMA and warp
// specialisation are later work.
//
// Design:
// * one block of 128 threads per (64-row q tile, head, batch); two threads
//   per query row, each owning every other key column of a tile and every
//   other output feature;
// * a loop inside the block over 64-row k/v tiles staged in shared memory
//   (rows padded by one float so neighbouring rows fall in other banks);
//   the loop starts at the window's first tile and stops at the causal
//   frontier -- the TPU kernel's `pl.when(relevant)` block skip;
// * q / k / v / o are read and written through the (b, s, h, d) strides
//   given, so the caller keeps the BSHD layout; the ragged edge is masked,
//   nothing is padded or copied;
// * the kernel allocates nothing and launches on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 2 * BQ;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides { long long b, s, h, d; };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq, sk, sv, so;
  int B, Sq, Sk, H, KV;
  int causal, has_window, window;
  float scale;
};

template <int D>
constexpr int smem_bytes() {
  return (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1)) * (int)sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;
  float* sQ = smem;              // BQ x DP, pre-scaled q
  float* sK = sQ + BQ * DP;      // BK x DP
  float* sV = sK + BK * DP;      // BK x DP
  float* sP = sV + BK * DP;      // BQ x PP, probabilities of the current tile

  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x;
  const int r = tid >> 1;        // query row within the tile
  const int half = tid & 1;      // key columns 2*jj + half, features 2*c + half
  const int qp = q_start + r;

  const T* Q = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* K = static_cast<const T*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const T* V = static_cast<const T*>(p.v) + b * p.sv.b + kvh * p.sv.h;
  T* O = static_cast<T*>(p.o) + b * p.so.b + h * p.so.h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int row = i / D, col = i % D;
    const int qs = q_start + row;
    float x = 0.f;
    if (qs < p.Sq) x = to_f32(Q[qs * p.sq.s + col * p.sq.d]) * p.scale;
    sQ[row * DP + col] = x;
  }

  const int nk = (p.Sk + BK - 1) / BK;
  int k_hi = nk - 1;
  if (p.causal) k_hi = min(k_hi, (q_start + BQ - 1) / BK);
  int k_lo = 0;
  if (p.has_window) {
    const int first = q_start - p.window + 1;  // least key visible from the tile
    if (first > 0) k_lo = first / BK;
  }

  float m = NEG_INF, l = 0.f;
  float acc[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) acc[c] = 0.f;

  for (int kt = k_lo; kt <= k_hi; ++kt) {
    const int k_start = kt * BK;
    __syncthreads();  // sQ written; the previous tile's sK / sV / sP consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int row = i / D, col = i % D;
      const int ks = k_start + row;
      float kx = 0.f, vx = 0.f;
      if (ks < p.Sk) {
        kx = to_f32(K[ks * p.sk.s + col * p.sk.d]);
        vx = to_f32(V[ks * p.sv.s + col * p.sv.d]);
      }
      sK[row * DP + col] = kx;
      sV[row * DP + col] = vx;
    }
    __syncthreads();

    float s[BK / 2];
#pragma unroll
    for (int jj = 0; jj < BK / 2; ++jj) s[jj] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = sQ[r * DP + d];
#pragma unroll
      for (int jj = 0; jj < BK / 2; ++jj)
        s[jj] = fmaf(qv, sK[(2 * jj + half) * DP + d], s[jj]);
    }

    unsigned ok_bits = 0u;
    float mx = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < BK / 2; ++jj) {
      const int kp = k_start + 2 * jj + half;
      bool ok = (qp < p.Sq) && (kp < p.Sk);
      if (p.causal) ok = ok && (kp <= qp);
      if (p.has_window) ok = ok && (kp > qp - p.window);
      if (ok) ok_bits |= 1u << jj;
      s[jj] = ok ? s[jj] : NEG_INF;
      mx = fmaxf(mx, s[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float rs = 0.f;
#pragma unroll
    for (int jj = 0; jj < BK / 2; ++jj) {
      const float pj = ((ok_bits >> jj) & 1u) ? expf(s[jj] - m_new) : 0.f;
      rs += pj;
      sP[r * PP + 2 * jj + half] = pj;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    l = l * alpha + rs;
    m = m_new;
    __syncwarp();  // a row's two threads share one warp

#pragma unroll
    for (int c = 0; c < D / 2; ++c) acc[c] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float pj = sP[r * PP + j];
#pragma unroll
      for (int c = 0; c < D / 2; ++c)
        acc[c] = fmaf(pj, sV[j * DP + 2 * c + half], acc[c]);
    }
  }

  if (qp < p.Sq) {
#pragma unroll
    for (int c = 0; c < D / 2; ++c)
      O[qp * p.so.s + (2 * c + half) * p.so.d] =
          from_f32<T>(l == 0.f ? 0.f : acc[c] / l);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 16 int64, (b, s, h, d) for q, k, v, o in that order, in elements.
// dtype: 0 = float32, 1 = bfloat16.  window is read only when has_window.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   const long long* strides, int dtype, int B, int Sq,
                                   int Sk, int H, int KV, int D, int causal,
                                   int has_window, int window, float scale,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.sq = {strides[0], strides[1], strides[2], strides[3]};
  p.sk = {strides[4], strides[5], strides[6], strides[7]};
  p.sv = {strides[8], strides[9], strides[10], strides[11]};
  p.so = {strides[12], strides[13], strides[14], strides[15]};
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.KV = KV;
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(p, D, s);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(p, D, s);
  return (int)cudaErrorInvalidValue;
}
