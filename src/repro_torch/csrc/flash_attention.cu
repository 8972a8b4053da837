// Flash attention forward for Hopper (sm_90a): causal + sliding window, GQA.
//
// Replaces the TPU kernel `flash_attention_pallas` / `_attn_kernel` in
// src/repro/kernels/flash_attention.py (the pallas_call at line 110).
// Same function: blockwise online softmax, head h reads kv head
// h / (H / KV), scores scaled by 1/sqrt(D), masks by absolute position
// (causal: kp <= qp; window: kp > qp - window), running m / l / acc in
// f32, a row with no visible key writes 0, output in the input dtype.  Key
// positions count from 0; query row r sits at qp = q_offset + r, so a
// block of query rows (a rank's rows under sequence parallelism) masks as
// those rows of the whole sequence do; q_offset 0 is the TPU kernel's
// function.
//
// Bound on an H100 SXM: at the serving path's prefill shape (B=4, S=1024,
// H=14, KV=2, D=64, bf16, causal) the work is ~7.5 GFLOP against ~16.8 MB
// moved, so the tensor-core rate bounds it (~7.6 us at 989 TFLOP/s against
// ~5.0 us at 3.35 TB/s); at D = 64 the softmax's exponentials (16 per
// clock per SM on the MUFU) take as long as the products, so the two must
// overlap to get near it.
//
// Two routes, chosen by dtype:
//
// * bfloat16 (every main path): Hopper's own instructions (hopper.cuh).
//   - Loads by TMA.  The entry point encodes one 4-D tensor map per
//     operand over its BSHD strides, (d, s, h, b) innermost first, with a
//     64-column box and the 128-byte swizzle (cuTensorMapEncodeTiled,
//     taken through the runtime's entry-point query: no -lcuda).  Rows past
//     Sq or Sk and columns past D arrive as zeros.  The encodes are host
//     work on every call and do not synchronise.
//   - Warp specialisation.  Warpgroup 0 is the producer: one thread starts
//     every load, Q once per work tile and K/V through a ring of 3-4
//     stages (2 with one consumer warpgroup), "full" mbarriers carrying the
//     bytes and "empty" ones the consumers' releases; setmaxnreg gives its
//     registers to the consumers (24 against 240 or 232).
//   - The products on wgmma.  Each consumer warpgroup owns 64 query rows:
//     S = Q K^T is m64n128k16 from shared memory (K-major descriptors on
//     the swizzle the TMA wrote), D / 16 k-steps; O += P V is m64nDk16 with
//     P from registers (the f32 score fragment is, element for element,
//     the A fragment) and V MN-major (the transpose bit).
//   - Overlap.  Key tile j starts its S beside tile j - 1's P V and runs
//     its softmax while that P V does; the two consumer warpgroups take
//     turns to start them (named barriers), so one's softmax runs beside the
//     other's products.  The accumulators see the same operations in the
//     same order as a loop that finishes each tile first.
//   - Tiles.  Work tiles of 128 query rows (two consumer warpgroups) and
//     key tiles of 128, or 64 query rows (one consumer warpgroup, two
//     blocks an SM at D <= 64) where 128-row tiles would be fewer than the
//     SMs (batch-1 admissions).  D < 64 and 80 ... 112 pad the 64-column
//     shared-memory panels (the TMA zero-fills; Q K^T skips the empty
//     k-steps, P V runs n = D).
//   - Scheduling.  A persistent block per SM walks the work tiles,
//     heaviest first, in rounds taken forwards and backwards in turn; the
//     producer runs ahead across work tiles, so the next tile's Q and K/V
//     load while the consumers finish.  Where all heads' K/V exceed 40 MB,
//     the heads go in equal groups that fit L2, so a K/V tile reread by
//     the q tiles of its head comes from L2.
//   - Semantics and rounding as the TPU kernel's: masks from the absolute
//     positions, only on key tiles that cross an edge of the work tile;
//     scores in f32 with 1/sqrt(D) folded into exp2's argument; P rounded
//     to bf16 before P V, l summing the f32 P; an empty row writes 0.
//   - ptxas must keep the wgmma asynchronous: control flow around them is
//     warp-uniform (barrier waits loop inside one asm block), and fences
//     keep register writes out of a product's pipeline stage.  A lost
//     barrier arrival traps after 4 s instead of hanging the card.
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

#include <chrono>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

using namespace hp;

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
  int q_offset;
  int causal, has_window, window;
  float scale;
  int group;  // (head, batch row) pairs per group of work tiles (bf16)
};

// The key tiles [lo, hi] a q tile starting at row q_start must visit: from
// the window's first tile to the causal frontier of its absolute positions
// q_offset + q_start ... (the TPU kernel's `pl.when(relevant)` block skip).
// Empty when lo > hi.
__device__ __forceinline__ void key_range(const Params& p, int q_start, int& lo, int& hi) {
  const int q_pos = p.q_offset + q_start;
  hi = (p.Sk + BK - 1) / BK - 1;
  if (p.causal) hi = min(hi, (q_pos + BQ - 1) / BK);
  lo = 0;
  if (p.has_window) {
    const int first = q_pos - p.window + 1;  // least key visible from the tile
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
  const int qr = q_start + r;    // the row of q / o
  const int qp = p.q_offset + qr;  // its absolute position

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
      bool ok = (qr < p.Sq) && (kp < p.Sk);
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

  if (qr < p.Sq) {
#pragma unroll
    for (int c = 0; c < D / 2; ++c)
      O[qr * p.so.s + (2 * c + half) * p.so.d] = l == 0.f ? 0.f : acc[c] / l;
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
// bfloat16 on Hopper: TMA, an mbarrier ring, a producer warp, wgmma
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;
constexpr int WG = 128;          // threads of a warpgroup
constexpr int HBK = 128;         // keys of a tile
constexpr uint32_t SBO = 1024;   // bytes between 8-row atoms of a swizzled tile
constexpr long long L2_BUDGET = 40LL << 20;  // of the H100's 50 MB L2

// The register split between the producer warpgroup and the consumers.
// setmaxnreg moves registers within the block, so it balances only when
// the entry count (the launch bound's: 65536 / threads / blocks per SM,
// rounded down to 8) covers them: 24 + 2 x 240 = 3 x 168 with two
// consumer warpgroups, 24 + 232 = 2 x 128 with one.
template <int NWG> struct Regs;
template <> struct Regs<1> { static constexpr int ENTRY = 128, PRODUCER = 24, CONSUMER = 232; };
template <> struct Regs<2> { static constexpr int ENTRY = 168, PRODUCER = 24, CONSUMER = 240; };

// D < 64 pads the 64-column panel and D 80 ... 112 the second one: the
// tensor maps' inner extent is D, so the TMA writes zeros past it.  Q K^T
// runs only the D / 16 k-steps that hold data and P V runs n = D.
template <int D, int NWG>
struct Hop {
  static constexpr int BQ = 64 * NWG;             // query rows of a work tile
  static constexpr int DP = D <= 64 ? 64 : 128;   // the padded width
  static constexpr int NP = DP / 64;              // 64-column panels
  // K/V tiles in flight: as many as shared memory holds beside Q (one
  // consumer warpgroup keeps two, so that two blocks fit an SM at D <= 64)
  static constexpr int STAGES = NWG == 1 ? 2 : (DP == 64 ? 4 : 3);
  static constexpr int Q_PANEL = BQ * 128;        // bytes
  static constexpr int KV_PANEL = HBK * 128;
  static constexpr int Q_BYTES = NP * Q_PANEL;
  static constexpr int KV_BYTES = NP * KV_PANEL;  // one K (or V) tile
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES;  // + alignment
  static constexpr int THREADS = WG * (NWG + 1);
};

// A work tile: BQ query rows of one head of one batch row, and the key
// tiles [k_lo, k_lo + n_tiles) its rows see (the TPU kernel's
// `pl.when(relevant)` block skip), the causal frontier that of its last
// row in q.  Work tiles come in groups of `p.group` (head, batch row)
// pairs, whose K/V fit in L2 together (launch_hopper); within a group
// they are numbered heaviest first: the q tile from the last to the
// first, then the head, then the batch row.
struct Work {
  int q_start, h, b, k_lo, n_tiles;
};

__device__ __forceinline__ Work work_tile(const Params& p, int w, int bq) {
  const int n_qt = (p.Sq + bq - 1) / bq;
  const int first_pair = w / (n_qt * p.group) * p.group;
  const int pairs = min(p.group, p.H * p.B - first_pair);  // the last group may be short
  const int i = w - first_pair * n_qt;
  const int hb = first_pair + i % pairs;
  Work t;
  t.q_start = (n_qt - 1 - i / pairs) * bq;
  t.h = hb % p.H;
  t.b = hb / p.H;
  const int first = p.q_offset + t.q_start;
  const int last = p.q_offset + min(t.q_start + bq, p.Sq) - 1;
  int hi = (p.Sk + HBK - 1) / HBK - 1;
  if (p.causal) hi = min(hi, last / HBK);
  t.k_lo = 0;
  if (p.has_window && first - p.window + 1 > 0) t.k_lo = (first - p.window + 1) / HBK;
  t.n_tiles = max(0, hi - t.k_lo + 1);
  return t;
}

// The k-th work tile of this block: rounds of gridDim.x tiles, taken
// forwards in even rounds and backwards in odd ones, so that the block
// with the heaviest tile of one round has the lightest of the next.
__device__ __forceinline__ int work_index(int k) {
  return k * gridDim.x + ((k & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// Barriers, 8 bytes each: q_full, q_empty, then full_k, full_v, empty, one
// of each per stage.
template <int STAGES>
struct Bars {
  uint32_t base;
  __device__ uint32_t q_full() const { return base; }
  __device__ uint32_t q_empty() const { return base + 8; }
  __device__ uint32_t full_k(int st) const { return base + 16 + 8 * st; }
  __device__ uint32_t full_v(int st) const { return base + 16 + 8 * (STAGES + st); }
  __device__ uint32_t empty(int st) const { return base + 16 + 8 * (2 * STAGES + st); }
};

// The producer: one thread starts every TMA load of the block's work
// tiles, Q once per tile and K/V through the ring, running ahead of the
// consumers across work tiles.
template <int D, int NWG>
__device__ __forceinline__ void hop_producer(const CUtensorMap* tq, const CUtensorMap* tk,
                                             const CUtensorMap* tv, const Params& p,
                                             uint32_t sQ, uint32_t sK, uint32_t sV,
                                             Bars<Hop<D, NWG>::STAGES> bar, int n_work) {
  using T = Hop<D, NWG>;
  prefetch_tensormap(tq);
  prefetch_tensormap(tk);
  prefetch_tensormap(tv);
  int q_it = 0, kv_it = 0;
  for (int k = 0, w = blockIdx.x; w < n_work; w = work_index(++k)) {
    const Work t = work_tile(p, w, T::BQ);
    if (t.n_tiles == 0) continue;  // its rows see no key: nothing to load
    const int kvh = t.h / (p.H / p.KV);
    if (q_it > 0) mbar_wait(bar.q_empty(), (q_it - 1) & 1);
    mbar_arrive_expect_tx(bar.q_full(), T::Q_BYTES);
#pragma unroll
    for (int pn = 0; pn < T::NP; ++pn)
      tma_load_4d(sQ + pn * T::Q_PANEL, tq, bar.q_full(), pn * 64, t.q_start, t.h, t.b);
    ++q_it;
    for (int j = 0; j < t.n_tiles; ++j, ++kv_it) {
      const int st = kv_it % T::STAGES;
      if (kv_it >= T::STAGES) mbar_wait(bar.empty(st), (kv_it / T::STAGES - 1) & 1);
      const int k_row = (t.k_lo + j) * HBK;
      mbar_arrive_expect_tx(bar.full_k(st), T::KV_BYTES);
#pragma unroll
      for (int pn = 0; pn < T::NP; ++pn)
        tma_load_4d(sK + st * T::KV_BYTES + pn * T::KV_PANEL, tk, bar.full_k(st), pn * 64,
                    k_row, kvh, t.b);
      mbar_arrive_expect_tx(bar.full_v(st), T::KV_BYTES);
#pragma unroll
      for (int pn = 0; pn < T::NP; ++pn)
        tma_load_4d(sV + st * T::KV_BYTES + pn * T::KV_PANEL, tv, bar.full_v(st), pn * 64,
                    k_row, kvh, t.b);
    }
  }
}

// A consumer warpgroup: 64 query rows of each work tile.  Per key tile:
// S = Q K^T on wgmma (f32), masks, the online softmax, P rounded to bf16
// in registers, O += P V on wgmma; then O / l.
template <int D, int NWG>
__device__ __forceinline__ void hop_consumer(const Params& p, uint32_t sQ, uint32_t sK,
                                             uint32_t sV, Bars<Hop<D, NWG>::STAGES> bar,
                                             int n_work) {
  using T = Hop<D, NWG>;
  constexpr int KD = D / 16;      // k-steps of Q K^T
  constexpr int NS = HBK / 2;     // score accumulators per thread
  constexpr int NO = D / 2;       // output accumulators per thread
  constexpr int KP = HBK / 16;    // k-steps of P V
  // the warpgroup, as a value ptxas knows to be uniform across the warp
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG, 0) - 1;
  const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const float sl = p.scale * LOG2E;  // exp(x * scale) = exp2(x * sl)

  float s[NS], o[NO];
  uint32_t pa[KP][4];
  float m[2], l[2];
  // two consumer warpgroups take turns to start their products (named
  // barriers 1 and 2), so that one's softmax runs beside the other's
  // products; warpgroup 0 goes first
  constexpr bool pingpong = NWG == 2;
  if (pingpong && wg == 1) named_arrive(1, 2 * WG);
  auto take_turn = [&] { if (pingpong) named_sync(1 + wg, 2 * WG); };
  auto pass_turn = [&] { if (pingpong) named_arrive(2 - wg, 2 * WG); };

  int q_it = 0, kv_it = 0;
  for (int k = 0, w = blockIdx.x; w < n_work; w = work_index(++k)) {
    const Work t = work_tile(p, w, T::BQ);
    const int qw = t.q_start + wg * 64 + warp * 16;  // this warp's first query row
    const int qwp = p.q_offset + qw;                 // and its absolute position
    // a key tile crosses an edge of the work tile's rows: the masks apply
    // (decided for the whole block, so the branch is uniform)
    const int first_qp = p.q_offset + t.q_start, last_qp = first_qp + T::BQ - 1;
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;

    // S = Q K^T (f32): this warpgroup's 64 rows against the tile's 128 keys
    auto mma_qk = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // 16 columns = 32 bytes along the row
        wgmma_ss_n128(s,
                      desc_sw128(sQ + (kk / 4) * T::Q_PANEL + wg * 64 * 128 + col, 16, SBO),
                      desc_sw128(sK + st * T::KV_BYTES + (kk / 4) * T::KV_PANEL + col, 16, SBO),
                      kk > 0);
      }
    };
    // O += bf16(P) V: P from registers, V read MN-major
    auto mma_pv = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)
        wgmma_rs<D>(o, pa[kk],
                    desc_sw128(sV + st * T::KV_BYTES + kk * 16 * 128, T::KV_PANEL, SBO));
    };
    // masks, the online softmax of S in place, l and m; returns alpha, the
    // rescale of what o holds so far
    auto softmax = [&](int k_start, float (&alpha)[2]) {
      const bool edge = (k_start + HBK > p.Sk) || (p.causal && k_start + HBK - 1 > first_qp) ||
                        (p.has_window && k_start + p.window <= last_qp);
      if (edge) {
#pragma unroll
        for (int i = 0; i < NS / 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k_start + 8 * i + 2 * t4 + (e & 1);
            const int qp = qwp + g + 8 * (e >> 1);
            bool ok = kp < p.Sk;
            if (p.causal) ok = ok && kp <= qp;
            if (p.has_window) ok = ok && kp > qp - p.window;
            if (!ok) s[4 * i + e] = -INFINITY;
          }
      }
      // this thread's row r is g + 8 r: elements 4i + 2r, 4i + 2r + 1
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int i = 0; i < NS / 4; ++i)
          mx = fmaxf(mx, fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float off = mx == -INFINITY ? 0.f : mx * sl;  // no key seen yet: exp2(-inf) = 0
        alpha[r] = ex2_ftz(m[r] * sl - off);
        float rs = 0.f;
#pragma unroll
        for (int i = 0; i < NS / 4; ++i) {
          s[4 * i + 2 * r] = ex2_ftz(s[4 * i + 2 * r] * sl - off);
          s[4 * i + 2 * r + 1] = ex2_ftz(s[4 * i + 2 * r + 1] * sl - off);
          rs += s[4 * i + 2 * r] + s[4 * i + 2 * r + 1];
        }
        l[r] = l[r] * alpha[r] + rs;  // this thread's columns; the quad is summed at the end
        m[r] = mx;
      }
    };
    // o *= alpha, then P = bf16(S) as the A operand of P V
    auto rescale_pack = [&](const float (&alpha)[2]) {
#pragma unroll
      for (int i = 0; i < NO / 4; ++i) {
        o[4 * i] *= alpha[0];
        o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1];
        o[4 * i + 3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) {
        pa[kk][0] = tc::pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = tc::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = tc::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = tc::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    // one arrival per warp (after a warp-synchronous wgmma wait)
    auto release = [&](uint32_t b) { mbar_arrive_if(b, lane == 0); };

    if (t.n_tiles > 0) {
      mbar_wait(bar.q_full(), q_it & 1);
      // Key tile j starts its S beside tile j - 1's P V, and its softmax
      // runs while that P V does.  o sees the same operations in the same
      // order as in a loop that finishes each tile before the next.
      {
        const int st = kv_it % T::STAGES;
        mbar_wait(bar.full_k(st), (kv_it / T::STAGES) & 1);
        take_turn();
        wgmma_fence();
        mma_qk(st);
        wgmma_commit();
        pass_turn();
        wgmma_wait<0>();
        fence_regs(s);
        if (t.n_tiles == 1) release(bar.q_empty());
        float alpha[2];
        softmax(t.k_lo * HBK, alpha);
        rescale_pack(alpha);
      }
      for (int j = 1; j < t.n_tiles; ++j) {
        const int pst = kv_it % T::STAGES;
        const uint32_t ppar = (kv_it / T::STAGES) & 1;
        ++kv_it;
        const int st = kv_it % T::STAGES;
        mbar_wait(bar.full_k(st), (kv_it / T::STAGES) & 1);
        mbar_wait(bar.full_v(pst), ppar);
        take_turn();
        fence_regs(o);  // the rescale and P stay above the fence
        fence_regs(pa);
        wgmma_fence();
        mma_qk(st);
        wgmma_commit();
        // a fence of its own: each product is a pipeline stage of its own
        // for ptxas, so the softmax below may rewrite S while P V runs
        wgmma_fence();
        mma_pv(pst);
        wgmma_commit();
        pass_turn();
        wgmma_wait<1>();
        fence_regs(s);
        if (j == t.n_tiles - 1) release(bar.q_empty());
        float alpha[2];
        softmax((t.k_lo + j) * HBK, alpha);
        wgmma_wait<0>();  // tile j - 1's P V is in o, and its P is read
        fence_regs(o);
        fence_regs(pa);
        release(bar.empty(pst));
        rescale_pack(alpha);
      }
      // the last tile's P V
      const int st = kv_it % T::STAGES;
      mbar_wait(bar.full_v(st), (kv_it / T::STAGES) & 1);
      take_turn();
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
      mma_pv(st);
      wgmma_commit();
      pass_turn();
      wgmma_wait<0>();
      fence_regs(o);
      release(bar.empty(st));
      ++kv_it;
    }
    if (t.n_tiles > 0) ++q_it;

    // O / l in the input dtype, through o's strides; a row with no
    // visible key (l = 0) writes 0
    __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) + t.b * p.so.b + t.h * p.so.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float inv = lr == 0.f ? 0.f : 1.f / lr;
      const int row = qw + g + 8 * r;
      if (row < p.Sq) {
        __nv_bfloat16* dst = O + (long long)row * p.so.s + 2 * t4;
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          *reinterpret_cast<uint32_t*>(dst + 8 * i) =
              tc::pack_bf16(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
      }
    }
  }
  if (pingpong && wg == 0) named_sync(1, 2 * WG);  // takes warpgroup 1's last turn
}

// A persistent block per SM (or per block slot, at one consumer
// warpgroup) walks its work tiles (work_index):
// warpgroup 0 is the producer, warpgroups 1 ... NWG the consumers.
template <int D, int NWG>
__global__ void __launch_bounds__(Hop<D, NWG>::THREADS, NWG == 1 ? 2 : 1)
    flash_fwd_hopper(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const Params p) {
  using T = Hop<D, NWG>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_mem[2 + 3 * T::STAGES];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's alignment
  const uint32_t sK = sQ + T::Q_BYTES, sV = sK + T::STAGES * T::KV_BYTES;
  const Bars<T::STAGES> bar{smem_u32(bar_mem)};
  const int n_work = (p.Sq + T::BQ - 1) / T::BQ * p.H * p.B;

  if (threadIdx.x == 0) {
    mbar_init(bar.q_full(), 1);
    mbar_init(bar.q_empty(), 4 * NWG);  // one arrival per consumer warp
    for (int st = 0; st < T::STAGES; ++st) {
      mbar_init(bar.full_k(st), 1);       // the producer's arrival and the tile's bytes
      mbar_init(bar.full_v(st), 1);
      mbar_init(bar.empty(st), 4 * NWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (__shfl_sync(0xffffffffu, threadIdx.x / WG, 0) == 0) {
    setmaxnreg_dec<Regs<NWG>::PRODUCER>();
    if (threadIdx.x == 0) hop_producer<D, NWG>(&tq, &tk, &tv, p, sQ, sK, sV, bar, n_work);
  } else {
    setmaxnreg_inc<Regs<NWG>::CONSUMER>();
    hop_consumer<D, NWG>(p, sQ, sK, sV, bar, n_work);
  }
}

// A (d, s, h, b) tensor map of a BSHD bf16 operand with a 64 x `rows` box;
// a dim of size 1 (stride 0 from the wrapper) gets its packed stride.
bool encode_bshd(CUtensorMap* map, const void* ptr, const Strides& st, int D, int S, int heads,
                 int B, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const long long packed[3] = {D, (long long)D * S, (long long)D * S * heads};
  const long long given[3] = {st.s, st.h, st.b};
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)(given[i] ? given[i] : packed[i]) * 2;
  cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int NWG>
cudaError_t launch_hopper(const Params& p, int sms, cudaStream_t stream) {
  using T = Hop<D, NWG>;
  // a block whose consumers could not get their registers would wait for
  // them for ever: refuse to launch unless the entry count covers the split
  static const bool regs_ok = [] {
    cudaFuncAttributes a;
    return cudaFuncGetAttributes(&a, flash_fwd_hopper<D, NWG>) == cudaSuccess &&
           a.numRegs >= Regs<NWG>::ENTRY;
  }();
  if (!regs_ok) return cudaErrorInvalidDeviceFunction;
  CUtensorMap tq, tk, tv;
  if (!encode_bshd(&tq, p.q, p.sq, D, p.Sq, p.H, p.B, T::BQ) ||
      !encode_bshd(&tk, p.k, p.sk, D, p.Sk, p.KV, p.B, HBK) ||
      !encode_bshd(&tv, p.v, p.sv, D, p.Sk, p.KV, p.B, HBK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_hopper<D, NWG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  // blocks an SM holds at once (two of one consumer warpgroup at D <= 64)
  static const int per_sm = [] {
    int n = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_fwd_hopper<D, NWG>,
                                                         T::THREADS, T::SMEM) == cudaSuccess
               ? max(n, 1)
               : 1;
  }();
  const long long n_work = (long long)((p.Sq + T::BQ - 1) / T::BQ) * p.H * p.B;
  const int grid = (int)min(n_work, (long long)sms * per_sm);
  // where the K/V of all heads exceed L2_BUDGET, the fewest groups of
  // (head, batch row) pairs, of equal size, whose K/V stay within it: the
  // q tiles that reread a K/V tile then run close together, and it comes
  // from L2 rather than device memory
  Params pg = p;
  const long long pairs = (long long)p.H * p.B;
  const long long kv_bytes = 4LL * p.Sk * D * p.KV * p.B;  // all of K and V, bf16
  const long long groups = (kv_bytes + L2_BUDGET - 1) / L2_BUDGET;
  pg.group = (int)((pairs + groups - 1) / groups);
  flash_fwd_hopper<D, NWG><<<grid, T::THREADS, T::SMEM, stream>>>(tq, tk, tv, pg);
  return cudaGetLastError();
}

// 128-row blocks (two consumer warpgroups) unless they are fewer than the
// card's SMs: then 64-row blocks (one consumer warpgroup), twice as many.
template <int D>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((p.Sq + 127) / 128) * p.H * p.B;
  return tiles < sms ? launch_hopper<D, 1>(p, sms, stream) : launch_hopper<D, 2>(p, sms, stream);
}

template <bool BF16>
cudaError_t dispatch_d(const Params& p, int D, cudaStream_t stream) {
  // every multiple of 16 up to 128: Q K^T runs D / 16 k-steps of 16, and
  // P V's n = D is a multiple of 8 (wgmma's n-step)
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
// window is read only when has_window; q_offset (>= 0) is the absolute
// position of q's first row.  Returns the launch's cudaError_t (0 =
// launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   const long long* strides, int dtype, int B, int Sq,
                                   int Sk, int H, int KV, int D, int q_offset, int causal,
                                   int has_window, int window, float scale,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || q_offset < 0)
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
  p.q_offset = q_offset;
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  p.scale = scale;
  p.group = H * B;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<false>(p, D, s);
  if (dtype == 1) {
    if (!(aligned16(q, p.sq) && aligned16(k, p.sk) && aligned16(v, p.sv) && aligned16(o, p.so)))
      return (int)cudaErrorInvalidValue;
    return (int)dispatch_d<true>(p, D, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Host nanoseconds that `iters` rounds of the bf16 route's three
// tensor-map encodes take for these operands: the host work each launch
// does before it is queued (no device work).  -1 when an encode fails.
extern "C" long long flash_attention_encode_ns(const void* q, const void* k, const void* v,
                                               const long long* strides, int B, int Sq, int Sk,
                                               int H, int KV, int D, int iters) {
  const Strides sq = {strides[0], strides[1], strides[2], strides[3]};
  const Strides sk = {strides[4], strides[5], strides[6], strides[7]};
  const Strides sv = {strides[8], strides[9], strides[10], strides[11]};
  CUtensorMap tq, tk, tv;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    if (!encode_bshd(&tq, q, sq, D, Sq, H, B, 128) || !encode_bshd(&tk, k, sk, D, Sk, KV, B, HBK) ||
        !encode_bshd(&tv, v, sv, D, Sk, KV, B, HBK))
      return -1;
  return std::chrono::duration_cast<std::chrono::nanoseconds>(std::chrono::steady_clock::now() - t0)
      .count();
}
