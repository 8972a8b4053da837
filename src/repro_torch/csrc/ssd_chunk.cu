// Mamba2 SSD intra-chunk kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk.py: ssd_chunk_pallas
// (_ssd_chunk_kernel).  Per (batch * chunk, head) cell, with c the chunk
// length, P the head dim and N the state size (n_groups = 1: B and C are
// shared by every head of a chunk):
//   cum    = cumsum(dt * A)                                   (c,)
//   L[i,j] = exp(cum[i] - cum[j]) for j <= i, else 0          (c, c)
//   y      = ((C B^T) o L) (x dt)        written in x's dtype  (c, P)
//   state  = (B o exp(cum[c-1] - cum))^T (x dt), in float32   (N, P)
// The inter-chunk scan stays in PyTorch (models/layers.py: ssd_chunked).
//
// Operands, each row (b, chunk, i) at a uniform row stride so that the
// model's column slices of the conv output are read in place:
//   x  (G, c, H, P)  float32 or bfloat16, head and P contiguous in a row
//   dt (G, c, H)     float32, contiguous
//   A  (H,)          float32
//   B, C (G, c, N)   float32 or bfloat16, N contiguous in a row
//   y  (G, c, H, P)  x's dtype, contiguous;  st (G, H, N, P) float32, contiguous
// with G = batch * n_chunks.
//
// Bound on an H100 SXM at the serving shape (G 32, c 128, H 32, P 64,
// N 128, bf16 x / B / C): each input read once and each output written once
// is 69.7 MB, 20.8 us at 3.35 TB/s; the three products are 8.6 GFLOP,
// 8.7 us at the bf16 tensor-core peak.  So bytes bound it.
//
// Two routes, chosen by dtype:
//
// * bf16 x, B and C (the model's main path): tensor cores, mma.sync.m16n8k16
//   with bf16 operands and f32 accumulators.
//   - One 256-thread block per (cell, group of HG = 4 heads): grid
//     (G, ceil(H / 4)), 256 blocks at the serving shape, two per SM (112 KB
//     of shared memory each), so one wave on 132 SMs.  A group smaller than
//     4 takes the last heads when 4 does not divide H.
//   - C B^T (c x c, N deep) is computed once per block, from the bf16
//     inputs (exact products, f32 sums), for the lower-triangular 16 x 16
//     blocks only, and kept in shared memory as f32; the block walks its
//     heads over it.  Each warp owns one 16-row tile of the chunk; warps w
//     and w + 4 share an SM sub-partition and take row tiles w and 7 - w, so
//     the triangle's work is even across the four sub-partitions.
//   - The per-head products take dt into the factor that is not x, so the
//     bf16 input x enters the MMA exactly:
//       y     = (C B^T o L o dt_j) x        over j <= i
//       state = (B o exp(cum[c-1] - cum) o dt)^T x
//     Only the f32 factor is rounded, to bf16 hi + lo (two MMAs, about 16
//     bits of mantissa): rounded once, the 48-layer mamba2-370m logits
//     drifted 0.14 from the plain version's on an H100, outside the 3e-2
//     gate (PERF.md).  The score factor is made in the accumulators'
//     fragment layout and used as the A operand directly; x is read with
//     ldmatrix.trans, C with ldmatrix, B with ldmatrix (C B^T) and
//     ldmatrix.trans (the state).
//   - The decay is computed only where j <= i: above the diagonal the
//     exponent is -inf (cum decreases, so exp(cum[i] - cum[j]) could be inf
//     there, and inf * 0 is NaN).
//   - B, C and the first head's x arrive by cp.async (C into the C B^T
//     triangle's space, which it leaves before the triangle is written);
//     the next head's x tile is staged while the current head computes (2
//     stages).  The cumsum is a warp scan, one warp per head of the group.
//     Shared-memory rows are padded by 16 bytes against bank conflicts; a
//     ragged c, P or N is zero-filled to multiples of 16 in shared memory,
//     never in device memory.
// * any other dtype mix (f32 x, or f32 B / C): the first version, f32
//   arithmetic on the CUDA cores, one block per (cell, head), C B^T
//   recomputed by each head's block (design below).
//
// The kernels allocate nothing and launch on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32 route: CUDA cores
// * one 256-thread block per cell, grid (G, H); a loop over rows replaces
//   the TPU's (c, c) VMEM tiles;
// * x * dt (c x P) and the masked, decayed scores (c x c) live in shared
//   memory as float32; C and B are staged through shared memory in slices
//   of 32 columns of N for C B^T, and B * decay in slices of 32 rows for
//   the state;
// * the three products are register-tiled: each thread owns 4 x 4 outputs
//   per tile (rows contiguous, columns strided by the tile count, which
//   keeps the shared-memory reads free of bank conflicts), at most 4 tiles.
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;
constexpr int TILE = 4;        // a thread tile is TILE x TILE outputs
constexpr int MAX_TILES = 4;   // tiles per thread: an output has <= 1024 tiles
constexpr int KC = 32;         // reduction slice staged per step
constexpr int MAX_SMEM = 232448;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Offsets (in floats) of the shared-memory arrays.  Sizes are padded to
// whole tiles with zeros; row strides get one extra float against bank
// conflicts.
struct Layout {
  int cp, pp, np;              // c, P, N rounded up to TILE
  int ldx, lds, ldk, ldb;      // row strides of xs, S, the C/B slices, the B slice
  int wend, cum, xs, S, buf, total;
  __host__ __device__ Layout(int c, int P, int N) {
    cp = round_up(c, TILE);
    pp = round_up(P, TILE);
    np = round_up(N, TILE);
    ldx = pp + 1;
    lds = cp + 1;
    ldk = KC + 1;
    ldb = np + 1;
    wend = 0;                  // exp(cum[c-1] - cum[j])        [cp]
    cum = cp;                  // cumsum(dt * A), then dt first [cp]
    xs = 2 * cp;               // x * dt                        [cp][ldx]
    S = xs + cp * ldx;         // (C B^T) o L                   [cp][lds]
    buf = S + cp * lds;        // C and B slices, or a B slice
    total = buf + imax(2 * cp * ldk, KC * ldb);
  }
};

template <typename X, typename BC>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const X* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const BC* __restrict__ Bm,
                 const BC* __restrict__ Cm, X* __restrict__ y, float* __restrict__ st,
                 int c, int H, int P, int N, long long x_rs, long long b_rs,
                 long long c_rs) {
  extern __shared__ float sm[];
  const Layout L(c, P, N);
  float* wend = sm + L.wend;
  float* cum = sm + L.cum;
  float* xs = sm + L.xs;
  float* S = sm + L.S;
  float* buf = sm + L.buf;
  const int h = blockIdx.y, tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * c;   // this cell's first row

  // 1. dt into cum[], then x * dt into xs (zero outside c x P)
  for (int i = tid; i < c; i += THREADS) cum[i] = dt[(row0 + i) * H + h];
  __syncthreads();
  for (int e = tid; e < L.cp * L.pp; e += THREADS) {
    const int i = e / L.pp, p = e % L.pp;
    xs[i * L.ldx + p] =
        (i < c && p < P) ? to_f32(x[(row0 + i) * x_rs + (long long)h * P + p]) * cum[i] : 0.f;
  }
  __syncthreads();

  // 2. cum = cumsum(dt * A) by warp 0: each lane a run of rows, then a scan
  //    of the runs' totals across the warp
  if (tid < 32) {
    const float a = A[h];
    const int per = (c + 31) / 32, lo = tid * per, hi = min(c, lo + per);
    float run = 0.f;
    for (int i = lo; i < hi; ++i) {
      run += cum[i] * a;
      cum[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += v;
    }
    const float before = incl - run;
    for (int i = lo; i < hi; ++i) cum[i] += before;
  }
  __syncthreads();
  for (int j = tid; j < c; j += THREADS) wend[j] = expf(cum[c - 1] - cum[j]);

  // 3. S = C B^T, over slices of KC columns of N; thread tile rows i0..i0+3,
  //    columns j0 + s * ct
  const int ct = L.cp / TILE;
  const int s_tiles = ct * ct;
  float acc[MAX_TILES][TILE][TILE];
#pragma unroll
  for (int q = 0; q < MAX_TILES; ++q)
#pragma unroll
    for (int r = 0; r < TILE; ++r)
#pragma unroll
      for (int s = 0; s < TILE; ++s) acc[q][r][s] = 0.f;
  float* Cs = buf;
  float* Bs = buf + L.cp * L.ldk;
  for (int n0 = 0; n0 < N; n0 += KC) {
    for (int e = tid; e < L.cp * KC; e += THREADS) {
      const int i = e / KC, k = e % KC, n = n0 + k;
      const bool ok = i < c && n < N;
      Cs[i * L.ldk + k] = ok ? to_f32(Cm[(row0 + i) * c_rs + n]) : 0.f;
      Bs[i * L.ldk + k] = ok ? to_f32(Bm[(row0 + i) * b_rs + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < MAX_TILES; ++q) {
      const int t = tid + q * THREADS;
      if (t < s_tiles) {
        const int i0 = (t / ct) * TILE, j0 = t % ct;
        for (int k = 0; k < KC; ++k) {
          float a[TILE], b[TILE];
#pragma unroll
          for (int r = 0; r < TILE; ++r) a[r] = Cs[(i0 + r) * L.ldk + k];
#pragma unroll
          for (int s = 0; s < TILE; ++s) b[s] = Bs[(j0 + s * ct) * L.ldk + k];
#pragma unroll
          for (int r = 0; r < TILE; ++r)
#pragma unroll
            for (int s = 0; s < TILE; ++s) acc[q][r][s] += a[r] * b[s];
        }
      }
    }
    __syncthreads();
  }

  // 4. the decay where j <= i, selected (never inf * 0), into S
#pragma unroll
  for (int q = 0; q < MAX_TILES; ++q) {
    const int t = tid + q * THREADS;
    if (t < s_tiles) {
      const int i0 = (t / ct) * TILE, j0 = t % ct;
#pragma unroll
      for (int r = 0; r < TILE; ++r)
#pragma unroll
        for (int s = 0; s < TILE; ++s) {
          const int i = i0 + r, j = j0 + s * ct;
          S[i * L.lds + j] = (j <= i && i < c) ? acc[q][r][s] * expf(cum[i] - cum[j]) : 0.f;
        }
    }
  }
  __syncthreads();

  // 5. y = S xs; thread tile rows i0..i0+3, columns p0 + s * pt; the sum
  //    over j stops after the tile's last row (S is 0 above the diagonal)
  const int pt = L.pp / TILE;
  const int y_tiles = ct * pt;
#pragma unroll
  for (int q = 0; q < MAX_TILES; ++q) {
    const int t = tid + q * THREADS;
    if (t < y_tiles) {
      const int i0 = (t / pt) * TILE, p0 = t % pt;
      float o[TILE][TILE] = {};
      const int jend = min(i0 + TILE, c);
      for (int j = 0; j < jend; ++j) {
        float a[TILE], b[TILE];
#pragma unroll
        for (int r = 0; r < TILE; ++r) a[r] = S[(i0 + r) * L.lds + j];
#pragma unroll
        for (int s = 0; s < TILE; ++s) b[s] = xs[j * L.ldx + p0 + s * pt];
#pragma unroll
        for (int r = 0; r < TILE; ++r)
#pragma unroll
          for (int s = 0; s < TILE; ++s) o[r][s] += a[r] * b[s];
      }
#pragma unroll
      for (int r = 0; r < TILE; ++r)
#pragma unroll
        for (int s = 0; s < TILE; ++s) {
          const int i = i0 + r, p = p0 + s * pt;
          if (i < c && p < P) y[((row0 + i) * H + h) * P + p] = from_f32<X>(o[r][s]);
        }
    }
  }

  // 6. state[n][p] = sum_j B[j][n] wend[j] xs[j][p], over slices of KC rows;
  //    thread tile rows n0..n0+3, columns p0 + s * pt
  const int s2_tiles = (L.np / TILE) * pt;
#pragma unroll
  for (int q = 0; q < MAX_TILES; ++q)
#pragma unroll
    for (int r = 0; r < TILE; ++r)
#pragma unroll
      for (int s = 0; s < TILE; ++s) acc[q][r][s] = 0.f;
  for (int j0 = 0; j0 < c; j0 += KC) {
    __syncthreads();           // the previous slice (or S's readers) is done with buf
    const int jn = min(KC, c - j0);
    for (int e = tid; e < jn * L.np; e += THREADS) {
      const int jj = e / L.np, n = e % L.np, j = j0 + jj;
      buf[jj * L.ldb + n] = n < N ? to_f32(Bm[(row0 + j) * b_rs + n]) * wend[j] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < MAX_TILES; ++q) {
      const int t = tid + q * THREADS;
      if (t < s2_tiles) {
        const int nn0 = (t / pt) * TILE, p0 = t % pt;
        for (int jj = 0; jj < jn; ++jj) {
          float a[TILE], b[TILE];
#pragma unroll
          for (int r = 0; r < TILE; ++r) a[r] = buf[jj * L.ldb + nn0 + r];
#pragma unroll
          for (int s = 0; s < TILE; ++s) b[s] = xs[(j0 + jj) * L.ldx + p0 + s * pt];
#pragma unroll
          for (int r = 0; r < TILE; ++r)
#pragma unroll
            for (int s = 0; s < TILE; ++s) acc[q][r][s] += a[r] * b[s];
        }
      }
    }
  }
  const long long st0 = ((long long)blockIdx.x * H + h) * N;
#pragma unroll
  for (int q = 0; q < MAX_TILES; ++q) {
    const int t = tid + q * THREADS;
    if (t < s2_tiles) {
      const int nn0 = (t / pt) * TILE, p0 = t % pt;
#pragma unroll
      for (int r = 0; r < TILE; ++r)
#pragma unroll
        for (int s = 0; s < TILE; ++s) {
          const int n = nn0 + r, p = p0 + s * pt;
          if (n < N && p < P) st[(st0 + n) * P + p] = acc[q][r][s];
        }
    }
  }
}

template <typename X, typename BC>
cudaError_t launch_f32(const void* x, const float* dt, const float* A, const void* B,
                       const void* C, void* y, float* st, int G, int c, int H, int P, int N,
                       long long x_rs, long long b_rs, long long c_rs, cudaStream_t stream) {
  const Layout L(c, P, N);
  const int limit = MAX_TILES * THREADS * TILE * TILE;
  if (L.cp * L.cp > limit || L.cp * L.pp > limit || L.np * L.pp > limit)
    return cudaErrorInvalidValue;
  const int smem = L.total * (int)sizeof(float);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  auto kern = ssd_chunk_kernel<X, BC>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(G, H), THREADS, smem, stream>>>(
      (const X*)x, dt, A, (const BC*)B, (const BC*)C, (X*)y, st, c, H, P, N, x_rs, b_rs,
      c_rs);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 256;  // 8 warps, one 16-row tile of the chunk each
constexpr int HG = 4;            // heads per block
constexpr int TC_MAX = 128;      // c and N at most 128 (8 tiles of 16), P at most 128
constexpr float LOG2E = 1.4426950408889634f;

// Byte offsets of the shared-memory arrays: the B tile, two x stages, the
// C B^T triangle (one 1 KB slot per 16 x 16 block; the C tile, laid out as
// the B tile, is staged there first), and per head of the group
// cd[j] = (cum_j log2 e, dt_j) and wd[j] = exp(cum[c-1] - cum_j) dt_j.
struct TcLayout {
  int cp, np, pp;  // c, N, P rounded up to 16
  int ldb, ldx;    // bf16 row strides of the B tile and the x tiles
  int nrt;         // 16-row tiles of the chunk
  int bs, xs, cb, aux, total;
  __host__ __device__ TcLayout(int c, int P, int N) {
    cp = round_up(c, 16);
    np = round_up(N, 16);
    pp = round_up(P, 16);
    ldb = np + 8;
    ldx = pp + 8;
    nrt = cp / 16;
    bs = 0;
    xs = bs + cp * ldb * 2;
    cb = xs + 2 * cp * ldx * 2;
    aux = cb + imax(nrt * (nrt + 1) / 2 * 1024, cp * ldb * 2);
    total = aux + HG * cp * 12;
  }
};

// rows [0, rows) x cols [0, cols) of a bf16 operand (row stride rs, columns
// contiguous) into a rows_p x cols_p tile of row stride ld, the rest zero.
// vec (16-byte aligned rows, cols % 8 == 0): cp.async; else plain loads.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int ld,
                                           const __nv_bfloat16* src, long long rs, int rows,
                                           int cols, int rows_p, int cols_p, bool vec,
                                           int tid) {
  const int cpr = cols_p / 8;
  for (int i = tid; i < rows_p * cpr; i += TC_THREADS) {
    const int r = i / cpr, c0 = (i % cpr) * 8;
    __nv_bfloat16* d = dst + r * ld + c0;
    if (r < rows && c0 < cols) {
      const __nv_bfloat16* s = src + r * rs + c0;
      if (vec) {
        tc::cp_async16(d, s, 16);
      } else {
        for (int k = 0; k < 8; ++k) d[k] = c0 + k < cols ? s[k] : __float2bfloat16(0.f);
      }
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// the four A-fragment registers of a 16 x 16 factor tile given as two
// C-layout n-tiles f[0], f[1], as bf16 hi + lo
__device__ __forceinline__ void factor_frags(const float (&f)[2][4], uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    tc::split_bf16(f[q >> 1][(q & 1) * 2], f[q >> 1][(q & 1) * 2 + 1], hi[q], lo[q]);
}

// acc[0..PT) += (hi + lo) (16 x 16) . x rows [k0, k0 + 16) of the staged tile
template <int PT>
__device__ __forceinline__ void mma_x(float (&acc)[PT][4], const uint32_t (&hi)[4],
                                      const uint32_t (&lo)[4], const __nv_bfloat16* xs,
                                      int ldx, int pp, int k0, int lane) {
#pragma unroll
  for (int np = 0; np < PT / 2; ++np) {
    if (np * 16 < pp) {
      uint32_t xb[4];
      tc::ldmatrix_x4_trans(xb, xs + (k0 + (lane & 15)) * ldx + np * 16 + (lane >> 4) * 8);
      tc::mma_bf16(acc[2 * np], hi, xb[0], xb[1]);
      tc::mma_bf16(acc[2 * np + 1], hi, xb[2], xb[3]);
      tc::mma_bf16(acc[2 * np], lo, xb[0], xb[1]);
      tc::mma_bf16(acc[2 * np + 1], lo, xb[2], xb[3]);
    }
  }
}

template <int PT>
__global__ void __launch_bounds__(TC_THREADS, PT <= 8 ? 2 : 1)
ssd_chunk_tc(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
             const __nv_bfloat16* __restrict__ Cm, __nv_bfloat16* __restrict__ y,
             float* __restrict__ st, int c, int H, int P, int N, long long x_rs,
             long long b_rs, long long c_rs, int vec_x, int vec_b, int vec_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TcLayout L(c, P, N);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + L.bs);
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem + L.xs);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h0 = blockIdx.y * HG, ne = min(HG, H - h0);
  const long long row0 = (long long)blockIdx.x * c;  // this cell's first row
  const int xtile = L.cp * L.ldx;                     // elements of one x stage

  // 1. B, C (in the triangle's space) and the first head's x, asynchronously
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem + L.cb);
  stage_rows(Bs, L.ldb, Bm + row0 * b_rs, b_rs, c, N, L.cp, L.np, vec_b, tid);
  stage_rows(Cs, L.ldb, Cm + row0 * c_rs, c_rs, c, N, L.cp, L.np, vec_c, tid);
  stage_rows(Xs, L.ldx, x + row0 * x_rs + (long long)h0 * P, x_rs, c, P, L.cp, L.pp, vec_x,
             tid);
  tc::cp_async_commit();

  // 2. per head of the group (warp e): cum = cumsum(dt A) by a warp scan
  if (warp < ne) {
    const int h = h0 + warp;
    const float a = A[h];
    float2* cd = reinterpret_cast<float2*>(smem + L.aux + warp * L.cp * 12);
    float* wd = reinterpret_cast<float*>(cd + L.cp);
    const int per = (c + 31) / 32, lo = lane * per, hi = min(c, lo + per);
    float run = 0.f;
    for (int i = lo; i < hi; ++i) {
      const float d = dt[(row0 + i) * H + h];
      run += d * a;
      cd[i] = make_float2(run, d);
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    const float before = incl - run;
    for (int i = lo; i < hi; ++i) cd[i].x += before;
    __syncwarp();
    const float last = cd[c - 1].x;
    __syncwarp();
    for (int i = lo; i < hi; ++i) {
      wd[i] = expf(last - cd[i].x) * cd[i].y;
      cd[i].x *= LOG2E;
    }
    for (int i = c + lane; i < L.cp; i += 32) {  // padding rows: no decay, dt 0
      cd[i] = make_float2(last * LOG2E, 0.f);
      wd[i] = 0.f;
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // 3. this warp's 16-row tile of C as A fragments; every warp has read
  //    its tile before the triangle overwrites C
  const int rt = warp < 4 ? warp : 11 - warp;
  uint32_t cf[TC_MAX / 16][4];
  if (rt < L.nrt) {
#pragma unroll
    for (int kk = 0; kk < TC_MAX / 16; ++kk)
      if (kk * 16 < L.np)
        tc::ldmatrix_x4(cf[kk], Cs + (rt * 16 + (lane & 15)) * L.ldb + kk * 16 + (lane >> 4) * 8);
  }
  __syncthreads();

  // 4. C B^T on the blocks (rt, kb <= rt) of the lower triangle, f32, into
  //    this warp's slots (lane-major: each lane reads back what it wrote)
  float* cbw = reinterpret_cast<float*>(smem + L.cb) + rt * (rt + 1) / 2 * 256;
  if (rt < L.nrt) {
    for (int kb = 0; kb <= rt; ++kb) {
      float acc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < TC_MAX / 16; ++kk) {
        if (kk * 16 < L.np) {
          uint32_t bb[4];
          tc::ldmatrix_x4(bb, Bs + (kb * 16 + (lane & 7) + ((lane >> 4) << 3)) * L.ldb +
                                  kk * 16 + ((lane >> 3) & 1) * 8);
          tc::mma_bf16(acc[0], cf[kk], bb[0], bb[1]);
          tc::mma_bf16(acc[1], cf[kk], bb[2], bb[3]);
        }
      }
      float4* slot = reinterpret_cast<float4*>(cbw + (kb * 32 + lane) * 8);
      slot[0] = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
      slot[1] = make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
    }
  }

  for (int e = 0; e < ne; ++e) {
    const int h = h0 + e;
    const __nv_bfloat16* xs = Xs + (e & 1) * xtile;
    if (e + 1 < ne) {
      // the other stage was released by the barrier that ended head e - 1
      stage_rows(Xs + ((e + 1) & 1) * xtile, L.ldx, x + row0 * x_rs + (long long)(h + 1) * P,
                 x_rs, c, P, L.cp, L.pp, vec_x, tid);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const float2* cd = reinterpret_cast<const float2*>(smem + L.aux + e * L.cp * 12);
    const float* wd = reinterpret_cast<const float*>(cd + L.cp);

    // 5. y, rows of tile rt: (C B^T o L o dt_j) x over j <= i
    if (rt < L.nrt) {
      float ya[PT][4];
#pragma unroll
      for (int i = 0; i < PT; ++i) ya[i][0] = ya[i][1] = ya[i][2] = ya[i][3] = 0.f;
      const int i0 = rt * 16 + g;
      const float cl[2] = {cd[i0].x, cd[i0 + 8].x};
      for (int kb = 0; kb <= rt; ++kb) {
        const float4* slot = reinterpret_cast<const float4*>(cbw + (kb * 32 + lane) * 8);
        const float4 s[2] = {slot[0], slot[1]};
        float f[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          // columns j = kb*16 + nt*8 + 2 t4 + {0, 1}: (cl_j, dt_j, cl_j+1, dt_j+1)
          const float4 cj = *reinterpret_cast<const float4*>(cd + kb * 16 + nt * 8 + 2 * t4);
          const float sv[4] = {s[nt].x, s[nt].y, s[nt].z, s[nt].w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int il = g + (q >> 1) * 8, jl = nt * 8 + 2 * t4 + (q & 1);
            const float clj = (q & 1) ? cj.z : cj.x, dtj = (q & 1) ? cj.w : cj.y;
            const float ex = (kb == rt && jl > il) ? -INFINITY : cl[q >> 1] - clj;
            f[nt][q] = sv[q] * exp2f(ex) * dtj;
          }
        }
        uint32_t ah[4], al[4];
        factor_frags(f, ah, al);
        mma_x<PT>(ya, ah, al, xs, L.ldx, L.pp, kb * 16, lane);
      }
#pragma unroll
      for (int nt = 0; nt < PT; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = i0 + 8 * r, p = nt * 8 + 2 * t4;
          if (i >= c || p >= P) continue;
          __nv_bfloat16* dst = y + ((row0 + i) * H + h) * P + p;
          if (P % 2 == 0) {
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(ya[nt][2 * r], ya[nt][2 * r + 1]);
          } else {
            dst[0] = __float2bfloat16(ya[nt][2 * r]);
            if (p + 1 < P) dst[1] = __float2bfloat16(ya[nt][2 * r + 1]);
          }
        }
    }

    // 6. state, rows n0 .. n0 + 15: (B o wd)^T x over every j
    const int n0 = warp * 16;
    if (n0 < L.np) {
      float sa[PT][4];
#pragma unroll
      for (int i = 0; i < PT; ++i) sa[i][0] = sa[i][1] = sa[i][2] = sa[i][3] = 0.f;
      for (int kb = 0; kb < L.nrt; ++kb) {
        uint32_t bb[4];
        tc::ldmatrix_x4_trans(bb, Bs + (kb * 16 + (lane & 7) + ((lane >> 4) << 3)) * L.ldb +
                                      n0 + ((lane >> 3) & 1) * 8);
        // registers 0, 1 hold rows j = kb*16 + 2 t4 + {0, 1}; 2, 3 the same + 8
        const float2 w[2] = {*reinterpret_cast<const float2*>(wd + kb * 16 + 2 * t4),
                             *reinterpret_cast<const float2*>(wd + kb * 16 + 8 + 2 * t4)};
        float f[2][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 b = tc::unpack_bf16(bb[q]);
          f[q >> 1][(q & 1) * 2] = b.x * w[q >> 1].x;
          f[q >> 1][(q & 1) * 2 + 1] = b.y * w[q >> 1].y;
        }
        uint32_t ah[4], al[4];
        factor_frags(f, ah, al);
        mma_x<PT>(sa, ah, al, xs, L.ldx, L.pp, kb * 16, lane);
      }
      const long long st0 = ((long long)blockIdx.x * H + h) * N;
#pragma unroll
      for (int nt = 0; nt < PT; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n = n0 + g + 8 * r, p = nt * 8 + 2 * t4;
          if (n >= N || p >= P) continue;
          float* dst = st + (st0 + n) * P + p;
          if (P % 2 == 0) {
            *reinterpret_cast<float2*>(dst) = make_float2(sa[nt][2 * r], sa[nt][2 * r + 1]);
          } else {
            dst[0] = sa[nt][2 * r];
            if (p + 1 < P) dst[1] = sa[nt][2 * r + 1];
          }
        }
    }
    __syncthreads();  // this x stage is consumed before the prefetch after next
  }
}

template <int PT>
cudaError_t launch_tc(const void* x, const float* dt, const float* A, const void* B,
                      const void* C, void* y, float* st, int G, int c, int H, int P, int N,
                      long long x_rs, long long b_rs, long long c_rs, int smem,
                      cudaStream_t stream) {
  auto kern = ssd_chunk_tc<PT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const auto aligned = [](const void* p) { return (unsigned long long)p % 16 == 0; };
  const int vec_x = aligned(x) && x_rs % 8 == 0 && P % 8 == 0;
  const int vec_b = aligned(B) && b_rs % 8 == 0 && N % 8 == 0;
  const int vec_c = aligned(C) && c_rs % 8 == 0 && N % 8 == 0;
  kern<<<dim3(G, (H + HG - 1) / HG), TC_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)x, dt, A, (const __nv_bfloat16*)B, (const __nv_bfloat16*)C,
      (__nv_bfloat16*)y, st, c, H, P, N, x_rs, b_rs, c_rs, vec_x, vec_b, vec_c);
  return cudaGetLastError();
}

}  // namespace

// Launches a kernel on `stream` and returns its cudaError_t (0 = launched).
// x_dtype / bc_dtype: 0 = float32, 1 = bfloat16; both 1 take the tensor-core
// route.
// x_rs, b_rs, c_rs: elements between consecutive rows of x, B and C.
// Refuses (cudaErrorInvalidValue) shapes a route was not built for: the
// tensor-core route takes c, N <= 128 and P <= 128; the f32 route c <= 128,
// c * P and N * P at most 16384 once padded to multiples of 4; both at most
// 227 KB of shared memory.
extern "C" int ssd_chunk(const void* x, const float* dt, const float* A, const void* B,
                         const void* C, void* y, float* st, int G, int c, int H, int P,
                         int N, long long x_rs, long long b_rs, long long c_rs,
                         int x_dtype, int bc_dtype, void* stream) {
  if (G <= 0 || c <= 0 || H <= 0 || P <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && bc_dtype == 1) {
    if (c > TC_MAX || N > TC_MAX || P > TC_MAX) return (int)cudaErrorInvalidValue;
    const int smem = TcLayout(c, P, N).total;
    if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
    return (int)(P > 64 ? launch_tc<16> : launch_tc<8>)(x, dt, A, B, C, y, st, G, c, H, P, N,
                                                        x_rs, b_rs, c_rs, smem, s);
  }
  if (x_dtype == 0 && bc_dtype == 0)
    return (int)launch_f32<float, float>(x, dt, A, B, C, y, st, G, c, H, P, N, x_rs, b_rs,
                                         c_rs, s);
  if (x_dtype == 0 && bc_dtype == 1)
    return (int)launch_f32<float, __nv_bfloat16>(x, dt, A, B, C, y, st, G, c, H, P, N, x_rs,
                                                 b_rs, c_rs, s);
  if (x_dtype == 1 && bc_dtype == 0)
    return (int)launch_f32<__nv_bfloat16, float>(x, dt, A, B, C, y, st, G, c, H, P, N, x_rs,
                                                 b_rs, c_rs, s);
  return (int)cudaErrorInvalidValue;
}
