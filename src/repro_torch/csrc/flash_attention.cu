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
// ~5.0 us at 3.35 TB/s).
//
// Two routes, chosen by dtype:
//
// * bfloat16 (every main path): the products run on the tensor cores,
//   mma.sync.m16n8k16 with bf16 operands and f32 accumulators.
//   - One block of 4 warps per (64-row q tile, head, batch); each warp owns
//     16 query rows; 4 blocks per SM up to D = 64 (128 registers, 46 KB of
//     shared memory at D = 64).  Q is staged once and held in registers as
//     A fragments; S = Q K^T is one MMA chain per 64-key tile, from K read
//     with ldmatrix.  (Two m-tiles per warp, which halves the ldmatrix
//     traffic per MMA, timed no faster on an H100 at the serving shape, so
//     the simpler layout stayed.)
//   - The 1/sqrt(D) scale multiplies the f32 scores (folded into exp2's
//     argument), not bf16 q: scaling q in bf16 is exact only for D = 64.
//   - Online softmax in the accumulators' fragment layout: a thread holds
//     two rows, reduced across its quad with shfl_xor 1 and 2.  Masks set
//     the f32 scores to -inf before the max; the exp2 offset is 0 while a
//     row has seen no key, so no -inf - -inf is taken.
//   - P is rounded to bf16 (as FlashAttention-2/3 do) and reused from the
//     score registers as the A operand of P V; V is read with
//     ldmatrix.trans.  l sums the f32 probabilities.
//   - K/V tiles go through a 2-stage cp.async ring: tile j+1 loads while
//     tile j computes.
//   - q tiles launch heaviest first (the q-tile index is the slowest grid
//     dimension, reversed), so a causal grid's last wave holds the short
//     tiles.
//   - Rows of shared memory are padded by 16 bytes, so ldmatrix and the
//     fragment stores are free of bank conflicts.
//   This is mma.sync, the sm_80 instruction that Hopper runs at part of its
//   tensor-core rate; wgmma with TMA and warp specialisation is queued
//   (ROADMAP.md, queue 2).  mma.sync came first because its fragment
//   layouts are fixed by the instruction and the whole kernel is one
//   ~200-line source that builds in seconds.
// * float32: the first version's kernel on the CUDA cores (f32 FMAs, one
//   thread pair per query row).  TF32 or bf16 operands would break the f32
//   tolerance of 2e-4; no main path sends f32 here.
//
// q / k / v / o are read and written through the (b, s, h, d) strides
// given, so the caller keeps the BSHD layout; the bf16 route needs d
// contiguous and 16-byte aligned rows (the wrapper copies a view that is
// not).  The ragged edge is masked; nothing is padded in device memory.
// The kernels allocate nothing and launch on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;

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

// The key tiles [lo, hi] a q tile starting at q_start must visit: from the
// window's first tile to the causal frontier (the TPU kernel's
// `pl.when(relevant)` block skip).  Empty when lo > hi.
__device__ __forceinline__ void key_range(const Params& p, int q_start, int& lo, int& hi) {
  hi = (p.Sk + BK - 1) / BK - 1;
  if (p.causal) hi = min(hi, (q_start + BQ - 1) / BK);
  lo = 0;
  if (p.has_window) {
    const int first = q_start - p.window + 1;  // least key visible from the tile
    if (first > 0) lo = first / BK;
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 2 * BQ;
constexpr float NEG_INF = -1e30f;

template <int D>
constexpr int f32_smem_bytes() {
  return (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1)) * (int)sizeof(float);
}

// Two threads per query row, each owning every other key column of a tile
// and every other output feature; k/v tiles staged in shared memory, rows
// padded by one float.
template <int D>
__global__ void __launch_bounds__(F32_THREADS) flash_fwd_f32(Params p) {
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

  const float* Q = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
  const float* K = static_cast<const float*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const float* V = static_cast<const float*>(p.v) + b * p.sv.b + kvh * p.sv.h;
  float* O = static_cast<float*>(p.o) + b * p.so.b + h * p.so.h;

  for (int i = tid; i < BQ * D; i += F32_THREADS) {
    const int row = i / D, col = i % D;
    const int qs = q_start + row;
    sQ[row * DP + col] = qs < p.Sq ? Q[qs * p.sq.s + col * p.sq.d] * p.scale : 0.f;
  }

  int k_lo, k_hi;
  key_range(p, q_start, k_lo, k_hi);

  float m = NEG_INF, l = 0.f;
  float acc[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) acc[c] = 0.f;

  for (int kt = k_lo; kt <= k_hi; ++kt) {
    const int k_start = kt * BK;
    __syncthreads();  // sQ written; the previous tile's sK / sV / sP consumed
    for (int i = tid; i < BK * D; i += F32_THREADS) {
      const int row = i / D, col = i % D;
      const int ks = k_start + row;
      float kx = 0.f, vx = 0.f;
      if (ks < p.Sk) {
        kx = K[ks * p.sk.s + col * p.sk.d];
        vx = V[ks * p.sv.s + col * p.sv.d];
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
      O[qp * p.so.s + (2 * c + half) * p.so.d] = l == 0.f ? 0.f : acc[c] / l;
  }
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  constexpr int smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_f32<D><<<grid, F32_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;  // 4 warps x 16 query rows
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct TcSmem {
  static constexpr int LD = D + 8;            // bf16 row stride: 16 bytes of padding
  static constexpr int TILE = BQ * LD;        // one 64-row tile (BQ == BK)
  static constexpr int BYTES = 5 * TILE * 2;  // Q, K[2], V[2]
};

// rows [row0, row0 + 64) of a (rows, D) bf16 operand into a padded tile;
// rows at or past `rows` are zero-filled.  d is contiguous; rows are
// 16-byte aligned (the wrapper's condition).
template <int D>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long row_stride, int row0, int rows, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < BQ * CH; i += TC_THREADS) {
    const int r = i / CH, ch = i % CH;
    const bool ok = row0 + r < rows;
    const __nv_bfloat16* g = ok ? src + (long long)(row0 + r) * row_stride + ch * 8 : src;
    tc::cp_async16(dst + r * TcSmem<D>::LD + ch * 8, g, ok ? 16 : 0);
  }
}

// 4 blocks per SM up to D = 64 (at most 128 registers), 2 at D = 128
template <int D>
__global__ void __launch_bounds__(TC_THREADS, D <= 64 ? 4 : 2) flash_fwd_bf16(Params p) {
  using S = TcSmem<D>;
  constexpr int LD = S::LD;
  constexpr int KD = D / 16;       // k-steps of Q K^T
  constexpr int ND = D / 8;        // n-tiles of the output
  constexpr int NK = BK / 8;       // n-tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + S::TILE;       // 2 stages
  __nv_bfloat16* sV = sK + 2 * S::TILE;   // 2 stages

  const int h = blockIdx.x, b = blockIdx.y;
  const int q_start = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest first
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const __nv_bfloat16* Q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.sq.b + h * p.sq.h;
  const __nv_bfloat16* K =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const __nv_bfloat16* V =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.sv.b + kvh * p.sv.h;
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) + b * p.so.b + h * p.so.h;

  int k_lo, k_hi;
  key_range(p, q_start, k_lo, k_hi);
  const int n_tiles = max(0, k_hi - k_lo + 1);

  // A tile that visits no key tile stages nothing: its rows write 0 below
  // (o and l stay 0), and no copy is left in flight to land in sQ while the
  // warps write their output rows there.
  if (n_tiles > 0) {
    stage_tile<D>(sQ, Q, p.sq.s, q_start, p.Sq, tid);
    stage_tile<D>(sK, K, p.sk.s, k_lo * BK, p.Sk, tid);
    stage_tile<D>(sV, V, p.sv.s, k_lo * BK, p.Sk, tid);
    tc::cp_async_commit();
  }

  const float sl = p.scale * LOG2E;       // exp(x * scale) = exp2(x * sl)
  const int qw = q_start + warp * 16;     // this warp's first query row
  uint32_t qf[KD][4];
  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int k_start = (k_lo + it) * BK;
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      // the other stage was released by the barrier that ended tile it - 1
      stage_tile<D>(sK + (stage ^ 1) * S::TILE, K, p.sk.s, k_start + BK, p.Sk, tid);
      stage_tile<D>(sV + (stage ^ 1) * S::TILE, V, p.sv.s, k_start + BK, p.Sk, tid);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        tc::ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
    }

    // S = Q K^T (f32)
    const __nv_bfloat16* Ks = sK + stage * S::TILE;
    float s[NK][4];
#pragma unroll
    for (int i = 0; i < NK; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t kb[4];
        tc::ldmatrix_x4(kb, Ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                                ((lane >> 3) & 1) * 8);
        tc::mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
        tc::mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // masks, only on tiles that cross an edge of this warp's rows
    const bool edge = (k_start + BK > p.Sk) || (p.causal && k_start + BK - 1 > qw) ||
                      (p.has_window && k_start + p.window <= qw + 15);
    if (edge) {
#pragma unroll
      for (int nt = 0; nt < NK; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k_start + nt * 8 + 2 * t4 + (e & 1);
          const int qp = qw + g + (e >> 1) * 8;
          bool ok = kp < p.Sk;
          if (p.causal) ok = ok && kp <= qp;
          if (p.has_window) ok = ok && kp > qp - p.window;
          if (!ok) s[nt][e] = -INFINITY;
        }
    }

    // online softmax; row r of this thread is g + 8 r, elements 2r, 2r+1
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int nt = 0; nt < NK; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float off = mx == -INFINITY ? 0.f : mx * sl;  // no key seen yet: exp2(-inf) = 0
      const float alpha = exp2f(m[r] * sl - off);
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < NK; ++nt) {
        s[nt][2 * r] = exp2f(s[nt][2 * r] * sl - off);
        s[nt][2 * r + 1] = exp2f(s[nt][2 * r + 1] * sl - off);
        rs += s[nt][2 * r] + s[nt][2 * r + 1];
      }
      l[r] = l[r] * alpha + rs;  // this thread's columns; the quad is summed at the end
      m[r] = mx;
#pragma unroll
      for (int nt = 0; nt < ND; ++nt) {
        o[nt][2 * r] *= alpha;
        o[nt][2 * r + 1] *= alpha;
      }
    }

    // O += bf16(P) V
    const __nv_bfloat16* Vs = sV + stage * S::TILE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        tc::ldmatrix_x4_trans(vb, Vs + (kk * 16 + (lane & 15)) * LD + dp * 16 + (lane >> 4) * 8);
        tc::mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        tc::mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is consumed before the next prefetch refills it
  }

  // O / l as bf16 into this warp's rows of sQ, then 16-byte stores
  __nv_bfloat16* sO = sQ + warp * 16 * LD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv = lr == 0.f ? 0.f : 1.f / lr;
#pragma unroll
    for (int nt = 0; nt < ND; ++nt)
      *reinterpret_cast<uint32_t*>(sO + (g + 8 * r) * LD + nt * 8 + 2 * t4) =
          tc::pack_bf16(o[nt][2 * r] * inv, o[nt][2 * r + 1] * inv);
  }
  __syncwarp();
  constexpr int CH = D / 8;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, ch = i % CH, qp = qw + r;
    if (qp < p.Sq)
      *reinterpret_cast<uint4*>(O + (long long)qp * p.so.s + ch * 8) =
          *reinterpret_cast<const uint4*>(sO + r * LD + ch * 8);
  }
}

template <int D>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  constexpr int smem = TcSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B, (p.Sq + BQ - 1) / BQ);
  flash_fwd_bf16<D><<<grid, TC_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t dispatch_d(const Params& p, int D, cudaStream_t stream) {
  // every multiple of 16 up to 128: the bf16 route's mma.sync k-steps are
  // 16 wide (KD = D / 16) and its n-tiles are read in pairs (D / 16 pairs)
  switch (D) {
#define FLASH_D(d) \
  case d: return BF16 ? launch_bf16<d>(p, stream) : launch_f32<d>(p, stream);
    FLASH_D(16) FLASH_D(32) FLASH_D(48) FLASH_D(64)
    FLASH_D(80) FLASH_D(96) FLASH_D(112) FLASH_D(128)
#undef FLASH_D
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* ptr, const Strides& st) {
  return reinterpret_cast<unsigned long long>(ptr) % 16 == 0 && st.d == 1 && st.b % 8 == 0 &&
         st.s % 8 == 0 && st.h % 8 == 0;
}

}  // namespace

// strides: 16 int64, (b, s, h, d) for q, k, v, o in that order, in elements.
// dtype: 0 = float32, 1 = bfloat16 (then every operand has d contiguous and
// 16-byte aligned rows: pointers at 16 bytes, other strides multiples of 8).
// window is read only when has_window.  Returns the launch's cudaError_t
// (0 = launched).
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
  if (dtype == 0) return (int)dispatch_d<false>(p, D, s);
  if (dtype == 1) {
    if (!(aligned16(q, p.sq) && aligned16(k, p.sk) && aligned16(v, p.sv) && aligned16(o, p.so)))
      return (int)cudaErrorInvalidValue;
    return (int)dispatch_d<true>(p, D, s);
  }
  return (int)cudaErrorInvalidValue;
}
