// Mamba2 SSD intra-chunk kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk.py:56
// ssd_chunk_pallas (its pallas_call at line 74, body _ssd_chunk_kernel).
// Per (batch * chunk, head) cell, with c the chunk
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
// is 69.7 MB, 20.8 us at 3.35 TB/s (the f32 state is 48 % of it); the
// three products are 8.6 GFLOP, 8.7 us at the bf16 tensor-core peak, and
// twice that with the factors split into bf16 hi + lo.  So bytes bound it,
// with the products close behind: loads, products and stores must overlap.
//
// Three kernels; the caller picks one (kernels/ssd_chunk.py: `route` by
// dtype, `design` by layout):
//
// * bf16 x, B and C that tensor maps describe (every model path): the
//   Hopper design, namespace hop below, entry ssd_chunk_hopper.
//   - Work tiles.  A tile is a cell and a group of hg heads; a block runs
//     it with two consumer warpgroups, one a role: role r owns y's rows
//     64r ... 64r + 63 (role 1's y runs 8 k-steps over the keys j <= i,
//     role 0's 4: key tiles above the diagonal are skipped at m64) and the
//     state's rows 64r ... 64r + 63, so that no fragment is built twice
//     (Cfg).  The caller sizes hg so that the tiles about
//     fill the SMs, and where even one head a tile is too few (G H < SMs:
//     a batch-1 admission) it splits each (cell, head) into its two roles,
//     each a tile of a block with one consumer warpgroup, two blocks an
//     SM; each role then computes the cumsum and its rows of C B^T itself
//     (2 MFLOP).  c <= 64 has one role.  Blocks are persistent: the grid
//     is min(tiles, SMs x blocks an SM), block b walking tiles b, b + grid,
//     ... (kernels/ssd_chunk.py: `schedule`, `tile_walk`).
//   - The producer warp.  Lane 0 starts every TMA load: B and C once a
//     tile (64-column panels, the 128-byte swizzle, K-major), each head's x
//     tile into a ring of 3 stages (2 with one consumer warpgroup) guarded
//     by full / empty mbarriers; it runs ahead across heads.  Its 32 lanes
//     compute the head's cumsum (a warp scan) and write cd = (cum log2 e,
//     dt) and wd = exp(cum[c-1] - cum) dt beside the stage's x, a second
//     arrival on its full barrier.  The tensor maps describe the conv
//     output's column slices in place, at their row strides, encoded on the
//     host per call; their dims end at c within a cell and at P and N, so a
//     ragged chunk or width arrives zero-filled in shared memory, never in
//     device memory.  setmaxnreg gives its registers to the consumers.
//   - The consumers on wgmma.  C B^T (f32, from the bf16 inputs) is one SS
//     product a tile, m64 by n = 64 (role 0) or 128 (role 1) keys over N;
//     its accumulator stays in registers across the tile's heads.  Per head
//     the score factor C B^T o L o dt_j is made in the accumulator's own
//     fragment layout, split to bf16 hi + lo, and used as the register A
//     operand against x in shared memory (MN-major B), FlashAttention-3's P
//     reuse.  The state is (B o wd)^T x: B read with ldmatrix.trans from
//     the swizzled tile, scaled by wd, split hi + lo, the same RS product
//     (m64 over each of N's 64-row blocks).  Products run in groups
//     of 2 k-steps, the next group's fragments built while the last one's
//     products run (one group in flight, two fragment buffers).
//   - Outputs that stream.  y (bf16, a role's 64 rows) and the state (f32,
//     boxes of 64 rows x 32 columns) are written to shared memory in the
//     128-byte swizzle and leave by TMA stores (bulk groups) of whole
//     128-byte lines: y's as soon as y is done, while the state's products
//     run, the state's while the next head's do (two staging buffers); a
//     store writes nothing outside the tensor.
//   - Numerics are the mma.sync kernel's, below: the same factors rounded
//     at the same points, only the products' summation order differs.
//     Every output element is written by one block, without atomics, so a
//     call is bitwise repeatable and a column slice gives a contiguous
//     copy's bits.
// * bf16 in a layout no tensor map describes (a P or row stride that is
//   not a multiple of 8 elements, a pointer not 16-byte aligned) or with
//   P > 64: the first tensor-core design, mma.sync.m16n8k16 with bf16
//   operands and f32 accumulators, entry ssd_chunk.
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
//   recomputed by each head's block (design below), entry ssd_chunk.
//
// The kernels allocate nothing and launch on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"
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

// ---------------------------------------------------------------------------
// bf16 on Hopper: TMA, an mbarrier ring, a producer warp, wgmma
// ---------------------------------------------------------------------------

namespace hop {

using namespace hp;

constexpr int WG = 128;          // threads of a warpgroup
constexpr uint32_t SBO = 1024;   // bytes between 8-row atoms of a 128-byte-swizzled tile
constexpr int BOX = 64 * 128;    // bytes of a state store box: 64 rows x 32 f32

// The register split between the producer warpgroup and the consumers.
// setmaxnreg moves registers within the block, so it balances only when
// the entry count (the launch bound's: 65536 / threads / blocks per SM,
// rounded down to 8) covers them: 56 + 2 x 224 = 3 x 168 with two
// consumer warpgroups, 56 + 200 = 2 x 128 with one (two blocks an SM).
// The producer's warp runs the decay scan besides the loads, hence 56.
template <int NWG> struct Regs;
template <> struct Regs<1> { static constexpr int ENTRY = 128, PRODUCER = 56, CONSUMER = 200; };
template <> struct Regs<2> { static constexpr int ENTRY = 168, PRODUCER = 56, CONSUMER = 224; };

// A kernel's shape: c padded to CP (64 or 128), N to NP (64 or 128), P to
// PP (32 or 64), and NWG consumer warpgroups.
//
// Roles.  The chunk's rows of y come in ROLES = CP / 64 blocks of 64, one
// a role, and so do the state's NB = NP / 64 row blocks: role r writes y's
// rows 64r ... 64r + 63 and the state's rows 64r ... 64r + 63.  Each role
// builds the fragments of its own products only (role 1: 8 k-steps for y,
// over the keys j <= i, and 8 for its state block at N 128; role 0: 4 and
// 8), so no fragment is built twice: the two roles' warps share the SM's
// sub-partitions, and their fragments, more than the tensor cores, set a
// head's time.  One role (c <= 64) takes every block.
template <int CP_, int NP_, int PP_, int NWG_>
struct Cfg {
  static constexpr int CP = CP_, NP = NP_, PP = PP_, NWG = NWG_;
  static constexpr int NB = NP / 64;
  static constexpr int ROLES = CP / 64;
  static constexpr int KS = CP / 16;               // k-steps over the keys
  // state blocks role 0 and role 1 write
  static constexpr int SB0 = ROLES == 1 ? NB : 1;
  static constexpr int SB1 = ROLES == 1 ? NB : NB - 1;
  // rows of C a tile loads: all of them when the block runs both roles,
  // else the role's 64
  static constexpr int CROWS = NWG == 2 ? CP : 64;
  static constexpr int STAGES = NWG == 2 ? 3 : 2;  // x tiles in flight
  // output staging buffers: two where a block runs many heads, so that a
  // head's stores drain while the next head computes
  static constexpr int SBUF = NWG == 2 ? 2 : 1;
  static constexpr int THREADS = WG * (NWG + 1);
  static constexpr int B_PANEL = CP * 128;         // 64 state columns of B
  static constexpr int C_PANEL = CROWS * 128;
  static constexpr int X_BYTES = CP * 128;         // one head's x (PP <= 64 columns)
  static constexpr int B_BYTES = NB * B_PANEL;
  static constexpr int C_BYTES = NB * C_PANEL;
  static constexpr int Y_STAGE = 64 * 128;         // a role's 64 rows of y
  static constexpr int AUX = CP * 12;              // per row: (cum log2 e, dt) and the end decay
  // state store boxes (64 rows x 32 columns: whole 128-byte lines) of one
  // state block; a staging buffer holds both roles' blocks (two
  // warpgroups) or a role's
  static constexpr int BLOCK_BOXES = PP / 32;
  static constexpr int ST_BOXES = (NWG == 2 ? SB0 + SB1 : (SB0 > SB1 ? SB0 : SB1)) * BLOCK_BOXES;
  // byte offsets from the 1024-aligned base
  static constexpr int OFF_B = 0;
  static constexpr int OFF_C = OFF_B + B_BYTES;
  static constexpr int OFF_X = OFF_C + C_BYTES;
  static constexpr int OFF_Y = OFF_X + STAGES * X_BYTES;
  static constexpr int OFF_ST = OFF_Y + SBUF * NWG * Y_STAGE;
  static constexpr int OFF_AUX = OFF_ST + SBUF * ST_BOXES * BOX;
  static constexpr int SMEM = 1024 + OFF_AUX + STAGES * AUX;  // + the base's alignment
};

struct Params {
  const float* dt;
  const float* A;
  int c, H;
  int n_tiles;   // work tiles
  int hg, n_hg;  // heads a tile and tiles a cell (whole tiles)
  int split;     // tiles are (cell, head, role): one consumer warpgroup, c > 64
};

// A work tile: heads [h0, h0 + ne) of one cell, and the role its (one)
// consumer warpgroup takes when tiles are split.  kernels/ssd_chunk.py's
// `schedule` and `tile_walk` are this walk in Python.
struct Tile {
  int cell, h0, ne, role;
};

__device__ __forceinline__ Tile tile_of(const Params& p, int w) {
  Tile t;
  if (p.split) {
    const int pair = w >> 1;
    t.role = w & 1;
    t.cell = pair / p.H;
    t.h0 = pair % p.H;
    t.ne = 1;
  } else {
    t.role = 0;
    t.cell = w / p.n_hg;
    t.h0 = (w % p.n_hg) * p.hg;
    t.ne = min(p.hg, p.H - t.h0);
  }
  return t;
}

// Barriers, 8 bytes each: bc_full, bc_empty (the tile's B and C), then
// full and empty of each x stage.
template <int STAGES>
struct Bars {
  uint32_t base;
  __device__ uint32_t bc_full() const { return base; }
  __device__ uint32_t bc_empty() const { return base + 8; }
  __device__ uint32_t full(int s) const { return base + 16 + 8 * s; }
  __device__ uint32_t empty(int s) const { return base + 16 + 8 * (STAGES + s); }
};

// Head h's decay terms of one cell, by the 32 lanes of the producer warp
// (the CUDA-core route's scan): cum = cumsum(dt A) over the chunk, then
// cd[i] = (cum_i log2 e, dt_i) and wd[i] = exp(cum[c-1] - cum_i) dt_i;
// rows c ... CP - 1 get no decay and dt 0.  A lane holds a run of up to
// CP / 32 rows, its dt loaded together.
template <int CP>
__device__ __forceinline__ void decay_scan(const Params& p, int cell, int h, float2* cd,
                                           float* wd, int lane) {
  constexpr int PER = CP / 32;
  const int c = p.c;
  const int per = (c + 31) / 32, lo = lane * per;
  const float a = p.A[h];
  const float* src = p.dt + ((long long)cell * c + lo) * p.H + h;
  float d[PER], cum[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) d[q] = q < per && lo + q < c ? src[(long long)q * p.H] : 0.f;
  float run = 0.f;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    run += d[q] * a;
    cum[q] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const float before = incl - run;
  float mine = 0.f;  // cum[c - 1], from the lane that holds row c - 1
#pragma unroll
  for (int q = 0; q < PER; ++q)
    if (lo + q == c - 1) mine = cum[q] + before;
  const float last = __shfl_sync(0xffffffffu, mine, (c - 1) / per);
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    if (q < per && lo + q < c) {
      const float cq = cum[q] + before;
      wd[lo + q] = expf(last - cq) * d[q];
      cd[lo + q] = make_float2(cq * LOG2E, d[q]);
    }
  }
#pragma unroll 1
  for (int i = c + lane; i < CP; i += 32) {
    cd[i] = make_float2(last * LOG2E, 0.f);
    wd[i] = 0.f;
  }
}

// The producer warp: lane 0 starts every TMA load of the block's tiles, B
// and C once a tile and each head's x through the ring; the 32 lanes write
// each head's decay terms beside its x.  It runs ahead of the consumers
// across heads and tiles, as far as the ring lets it.
template <class T>
__device__ __forceinline__ void producer(const CUtensorMap* tx, const CUtensorMap* tb,
                                         const CUtensorMap* tcm, const Params& p, uint32_t base,
                                         unsigned char* gbase, Bars<T::STAGES> bar) {
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    prefetch_tensormap(tx);
    prefetch_tensormap(tb);
    prefetch_tensormap(tcm);
  }
  int it = 0;
  for (int k = 0, w = blockIdx.x; w < p.n_tiles; ++k, w += gridDim.x) {
    const Tile t = tile_of(p, w);
    if (k > 0) mbar_wait(bar.bc_empty(), (k - 1) & 1);
    if (lane == 0) {
      mbar_arrive_expect_tx(bar.bc_full(), T::B_BYTES + T::C_BYTES);
      const int crow = T::NWG == 1 && T::ROLES == 2 ? 64 * t.role : 0;
#pragma unroll
      for (int pn = 0; pn < T::NB; ++pn) {
        tma_load_3d(base + T::OFF_B + pn * T::B_PANEL, tb, bar.bc_full(), 64 * pn, 0, t.cell);
        tma_load_3d(base + T::OFF_C + pn * T::C_PANEL, tcm, bar.bc_full(), 64 * pn, crow, t.cell);
      }
    }
    for (int e = 0; e < t.ne; ++e, ++it) {
      const int s = it % T::STAGES;
      if (it >= T::STAGES) mbar_wait(bar.empty(s), (it / T::STAGES - 1) & 1);
      const int h = t.h0 + e;
      if (lane == 0) {
        mbar_arrive_expect_tx(bar.full(s), T::X_BYTES);
        tma_load_4d(base + T::OFF_X + s * T::X_BYTES, tx, bar.full(s), 0, h, 0, t.cell);
      }
      float2* cd = reinterpret_cast<float2*>(gbase + T::OFF_AUX + s * T::AUX);
      decay_scan<T::CP>(p, t.cell, h, cd, reinterpret_cast<float*>(cd + T::CP), lane);
      __syncwarp();
      mbar_arrive_if(bar.full(s), lane == 0);  // the second arrival: the decay terms
    }
  }
}

// A-operand fragments of the score factor C B^T o L o dt_j, k-step kk (keys
// 16 kk ... 16 kk + 15), rows i0 and i0 + 8, from the C B^T accumulator,
// as bf16 hi + lo.  k-step `diag` holds the warp's diagonal, where the
// exponent is -inf above it; later k-steps are all above it (zeros),
// earlier ones all below.
template <int NC>
__device__ __forceinline__ void score_frags(const float (&cb)[NC], const float2* cd, int kk,
                                            int diag, int i0, float cl0, float cl1, int t4,
                                            uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  if (kk > diag) {
#pragma unroll
    for (int q = 0; q < 4; ++q) hi[q] = lo[q] = 0u;
    return;
  }
  float f[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int j0 = 16 * kk + 8 * nt + 2 * t4;
    // (cl_j, dt_j, cl_j+1, dt_j+1)
    const float4 cj = *reinterpret_cast<const float4*>(cd + j0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = i0 + 8 * (q >> 1), j = j0 + (q & 1);
      const float clj = (q & 1) ? cj.z : cj.x, dtj = (q & 1) ? cj.w : cj.y;
      float ex = ((q >> 1) ? cl1 : cl0) - clj;
      if (kk == diag && j > row) ex = -INFINITY;
      f[nt][q] = cb[4 * (2 * kk + nt) + q] * ex2_ftz(ex) * dtj;
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    tc::split_bf16(f[q >> 1][(q & 1) * 2], f[q >> 1][(q & 1) * 2 + 1], hi[q], lo[q]);
}

// A-operand fragments of the decay factor (B o wd)^T, state rows
// 64 mb + 16 warp ... + 15, k-step kk, as bf16 hi + lo: B read with
// ldmatrix.trans from the swizzled tile.
__device__ __forceinline__ void decay_frags(const unsigned char* bpanel, const float* wd, int kk,
                                            int warp, int lane, int t4, uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
  const int j = 16 * kk + (lane & 7) + ((lane >> 4) << 3);
  const int chunk = (2 * warp + ((lane >> 3) & 1)) ^ (lane & 7);
  uint32_t bb[4];
  tc::ldmatrix_x4_trans(bb, bpanel + j * 128 + chunk * 16);
  // registers 0, 1 hold keys 16 kk + 2 t4 + {0, 1}; 2, 3 the same + 8
  const float2 w[2] = {*reinterpret_cast<const float2*>(wd + 16 * kk + 2 * t4),
                       *reinterpret_cast<const float2*>(wd + 16 * kk + 8 + 2 * t4)};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 b = tc::unpack_bf16(bb[q]);
    tc::split_bf16(b.x * w[q >> 1].x, b.y * w[q >> 1].y, hi[q], lo[q]);
  }
}

// acc += sum over k-steps K0 <= kk < K1 of (hi + lo)(kk) x(kk), x MN-major
// from `x`, in groups of 2 k-steps:
// frag(kk, hi, lo) builds a k-step's fragments into one of two buffers
// while the previous group's products run (one group kept in flight).
template <int N, int K0, int K1, class Frag>
__device__ __forceinline__ void mma_x(float (&acc)[N / 2], uint32_t x, int x_bytes,
                                      const Frag& frag) {
  constexpr int KB = 2;
  uint32_t hi[2][KB][4], lo[2][KB][4];
#pragma unroll
  for (int b = 0; b < (K1 - K0) / KB; ++b) {
#pragma unroll
    for (int q = 0; q < KB; ++q) frag(K0 + KB * b + q, hi[b & 1][q], lo[b & 1][q]);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < KB; ++q) {
      const uint64_t d = desc_sw128(x + (K0 + KB * b + q) * 2048, x_bytes, SBO);
      wgmma_rs<N>(acc, hi[b & 1][q], d);
      wgmma_rs<N>(acc, lo[b & 1][q], d);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the group before is done: its buffer is free
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

// State block mb (rows 64 mb ... + 63, every column) over the keys of
// k-steps [K0, K1), into its store boxes from `boxes` (128-byte swizzle).
template <class T, int K0, int K1>
__device__ __forceinline__ void state_block(int mb, uint32_t sx, const unsigned char* gbase,
                                            const float* wd, unsigned char* boxes, int warp,
                                            int lane) {
  const int g = lane / 4, t4 = lane % 4;
  const unsigned char* bpanel = gbase + T::OFF_B + mb * T::B_PANEL;
  float acc[T::PP / 2];
#pragma unroll
  for (int i = 0; i < T::PP / 2; ++i) acc[i] = 0.f;
  mma_x<T::PP, K0, K1>(acc, sx, T::X_BYTES,
                       [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
                         decay_frags(bpanel, wd, kk, warp, lane, t4, hi, lo);
                       });
#pragma unroll
  for (int i = 0; i < T::PP / 8; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + g + 8 * r;
      const int chunk = (2 * (i & 3) + (t4 >> 1)) ^ (row & 7);
      *reinterpret_cast<float2*>(boxes + (i >> 2) * BOX + row * 128 + chunk * 16 + (t4 & 1) * 8) =
          make_float2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
    }
}

// Role R of one tile, for every head of it: C B^T once, then per head y's
// rows 64R ... 64R + 63 and the role's state blocks, each product through
// registers as bf16 hi + lo against x in shared memory, and the outputs
// streamed out by TMA stores.
template <class T, int R>
__device__ __forceinline__ void run_tile(const CUtensorMap* ty, const CUtensorMap* ts,
                                         const Tile& t, uint32_t base, unsigned char* gbase,
                                         Bars<T::STAGES> bar, int cw, int it) {
  constexpr int NJ = 64 * (R + 1);  // keys the role's rows see
  constexpr int KN = T::NP / 16;    // k-steps over the state
  const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bar_id = 1 + cw;        // named barrier of this warpgroup

  // C B^T, f32 from the bf16 inputs, for this role's 64 rows; it stays in
  // registers across the tile's heads
  float cb[NJ / 2];
  {
    const uint32_t a0 = base + T::OFF_C + (T::NWG == 2 ? R * 64 * 128 : 0);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      const uint64_t da = desc_sw128(a0 + (kk / 4) * T::C_PANEL + (kk % 4) * 32, 16, SBO);
      const uint64_t db = desc_sw128(base + T::OFF_B + (kk / 4) * T::B_PANEL + (kk % 4) * 32, 16, SBO);
      if constexpr (NJ == 64) wgmma_ss_n64(cb, da, db, kk > 0);
      else wgmma_ss_n128(cb, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(cb);
  }

  const int i0 = 64 * R + 16 * warp + g;  // this thread's first row of y
  // the role's state blocks: [MB0, MB0 + NSB)
  constexpr int MB0 = T::ROLES == 1 ? 0 : R;
  constexpr int NSB = R == 0 ? T::SB0 : T::SB1;
  constexpr int SLOT0 = T::NWG == 2 && R == 1 ? T::SB0 * T::BLOCK_BOXES : 0;
  // bulk groups this thread commits a head: y's, and the state's where the
  // role has state blocks (role 1 at N <= 64 has none).  A thread's heads
  // all take one role (its warpgroup's, or in split tiles one the consumer
  // waits out when it changes), so the group that last read a staging
  // buffer is GROUPS * SBUF - 1 groups back.
  constexpr int GROUPS = NSB > 0 ? 2 : 1;
  for (int e = 0; e < t.ne; ++e) {
    const int h = t.h0 + e, s = (it + e) % T::STAGES;
    // this head's staging buffers
    const int yoff = T::OFF_Y + ((it + e) % T::SBUF * T::NWG + (T::NWG == 2 ? cw : 0)) * T::Y_STAGE;
    const int soff = T::OFF_ST + ((it + e) % T::SBUF * T::ST_BOXES + SLOT0) * BOX;
    unsigned char* ys = gbase + yoff;
    unsigned char* boxes = gbase + soff;
    mbar_wait(bar.full(s), ((it + e) / T::STAGES) & 1);
    const uint32_t sx = base + T::OFF_X + s * T::X_BYTES;
    const float2* cd = reinterpret_cast<const float2*>(gbase + T::OFF_AUX + s * T::AUX);
    const float* wd = reinterpret_cast<const float*>(cd + T::CP);

    // y = (C B^T o L o dt_j) x over the keys j < 64 (R + 1)
    float ya[T::PP / 2];
#pragma unroll
    for (int i = 0; i < T::PP / 2; ++i) ya[i] = 0.f;
    const float cl0 = cd[i0].x, cl1 = cd[i0 + 8].x;
    mma_x<T::PP, 0, NJ / 16>(ya, sx, T::X_BYTES,
                             [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
                               score_frags(cb, cd, kk, 4 * R + warp, i0, cl0, cl1, t4, hi, lo);
                             });
    // y out first, so that the state's products run while it is stored: its
    // staging is free once the y store of the head that last used it has
    // read it (GROUPS bulk groups a head, y's then the state's if any)
    if (tid == 0) bulk_wait_read<GROUPS * T::SBUF - 1>();
    named_sync(bar_id, WG);
#pragma unroll
    for (int i = 0; i < T::PP / 8; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + g + 8 * r;
        *reinterpret_cast<uint32_t*>(ys + row * 128 + ((i ^ (row & 7)) * 16) + 4 * t4) =
            tc::pack_bf16(ya[4 * i + 2 * r], ya[4 * i + 2 * r + 1]);
      }
    fence_proxy_async();
    named_sync(bar_id, WG);
    if (tid == 0) {
      tma_store_4d(ty, base + yoff, 0, h, 64 * R, t.cell);
      bulk_commit();
    }

    // the state, (B o wd)^T x over every key: this role's blocks, stored
    // once the state store of the head that last used the boxes has read
    // them
    if constexpr (NSB > 0) {
      if (tid == 0) bulk_wait_read<GROUPS * T::SBUF - 1>();
      named_sync(bar_id, WG);
#pragma unroll
      for (int k = 0; k < NSB; ++k)
        state_block<T, 0, T::KS>(MB0 + k, sx, gbase, wd, boxes + k * T::BLOCK_BOXES * BOX, warp,
                                 lane);
    }
    mbar_arrive_if(bar.empty(s), lane == 0);  // x and the decay terms are read
    if constexpr (NSB > 0) {
      fence_proxy_async();
      named_sync(bar_id, WG);
      if (tid == 0) {
        for (int k = 0; k < NSB; ++k)
          for (int b = 0; b < T::BLOCK_BOXES; ++b)
            tma_store_4d(ts, base + soff + (k * T::BLOCK_BOXES + b) * BOX, 32 * b,
                         64 * (MB0 + k), h, t.cell);
        bulk_commit();
      }
    }
  }
  mbar_arrive_if(bar.bc_empty(), lane == 0);  // B and C are read
}

// A consumer warpgroup: its role of every tile of the block.
template <class T>
__device__ __forceinline__ void consumer(const CUtensorMap* ty, const CUtensorMap* ts,
                                         const Params& p, uint32_t base, unsigned char* gbase,
                                         Bars<T::STAGES> bar, int cw) {
  int it = 0, role = -1;
  for (int k = 0, w = blockIdx.x; w < p.n_tiles; ++k, w += gridDim.x) {
    const Tile t = tile_of(p, w);
    // split tiles: with an odd grid a block's role changes from tile to
    // tile, and with it the bulk groups a head (run_tile's GROUPS), so the
    // last role's stores finish reading the staging first
    if (T::NWG == 1 && T::ROLES == 2) {
      if (role >= 0 && t.role != role && threadIdx.x % WG == 0) bulk_wait_read<0>();
      role = t.role;
    }
    mbar_wait(bar.bc_full(), k & 1);
    if constexpr (T::ROLES == 1) {
      run_tile<T, 0>(ty, ts, t, base, gbase, bar, cw, it);
    } else {
      if ((T::NWG == 2 ? cw : t.role) == 0) run_tile<T, 0>(ty, ts, t, base, gbase, bar, cw, it);
      else run_tile<T, 1>(ty, ts, t, base, gbase, bar, cw, it);
    }
    it += t.ne;
  }
  if (threadIdx.x % WG == 0) bulk_wait_read<0>();  // the last stores have read shared memory
}

// A persistent block walks its tiles (w = blockIdx.x, + gridDim.x, ...):
// warpgroup 0 is the producer (its first warp works), warpgroups 1 ... NWG
// the consumers.
template <class T>
__global__ void __launch_bounds__(T::THREADS, T::NWG == 1 ? 2 : 1)
    ssd_hopper(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
               const __grid_constant__ CUtensorMap tcm, const __grid_constant__ CUtensorMap ty,
               const __grid_constant__ CUtensorMap ts, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_mem[2 + 2 * T::STAGES];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzles' alignment
  unsigned char* gbase = smem_raw + (base - raw);
  const Bars<T::STAGES> bar{smem_u32(bar_mem)};

  if (threadIdx.x == 0) {
    mbar_init(bar.bc_full(), 1);             // the producer's arrival and the bytes
    mbar_init(bar.bc_empty(), 4 * T::NWG);   // one arrival per consumer warp
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(bar.full(s), 2);             // the bytes' arrival, the decay terms'
      mbar_init(bar.empty(s), 4 * T::NWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup, as a value ptxas knows to be uniform across the warp
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG, 0);
  if (wg == 0) {
    setmaxnreg_dec<Regs<T::NWG>::PRODUCER>();
    if (threadIdx.x < 32) producer<T>(&tx, &tb, &tcm, p, base, gbase, bar);
  } else {
    setmaxnreg_inc<Regs<T::NWG>::CONSUMER>();
    consumer<T>(&ty, &ts, p, base, gbase, bar, wg - 1);
  }
}

// A tensor map of `rank` dims (innermost first) with byte strides for
// dims 1 ...; out-of-range elements load as zeros and are not stored.
bool encode(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* ptr,
            const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
            CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class T>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* B, const void* C,
                   void* y, float* st, int G, int c, int H, int P, int N, long long x_rs,
                   long long b_rs, long long c_rs, int hg, int split, int grid,
                   cudaStream_t stream) {
  // a block whose consumers could not get their registers would wait for
  // them for ever: refuse to launch unless the entry count covers the split
  static const bool regs_ok = [] {
    cudaFuncAttributes a;
    return cudaFuncGetAttributes(&a, ssd_hopper<T>) == cudaSuccess &&
           a.numRegs >= Regs<T::NWG>::ENTRY;
  }();
  if (!regs_ok) return cudaErrorInvalidDeviceFunction;
  const auto BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t gc = (cuuint64_t)G, cc = (cuuint64_t)c, hh = (cuuint64_t)H;
  const cuuint64_t pp = (cuuint64_t)P, nn = (cuuint64_t)N;
  CUtensorMap tx, tb, tcm, ty, ts;
  // x (G, c, H, P) at row stride x_rs: dims (P, H, c, G)
  const cuuint64_t x_dims[4] = {pp, hh, cc, gc};
  const cuuint64_t x_str[3] = {pp * 2, (cuuint64_t)x_rs * 2, cc * x_rs * 2};
  const cuuint32_t x_box[4] = {64, 1, (cuuint32_t)T::CP, 1};
  // B, C (G, c, N) at their row strides: dims (N, c, G)
  const cuuint64_t bc_dims[3] = {nn, cc, gc};
  const cuuint64_t b_str[2] = {(cuuint64_t)b_rs * 2, cc * b_rs * 2};
  const cuuint64_t c_str[2] = {(cuuint64_t)c_rs * 2, cc * c_rs * 2};
  const cuuint32_t b_box[3] = {64, (cuuint32_t)T::CP, 1};
  const cuuint32_t c_box[3] = {64, (cuuint32_t)T::CROWS, 1};
  // y (G, c, H, P) contiguous; the state (G, H, N, P) f32: dims (P, N, H, G)
  const cuuint64_t y_str[3] = {pp * 2, hh * pp * 2, cc * hh * pp * 2};
  const cuuint32_t y_box[4] = {64, 1, 64, 1};
  const cuuint64_t s_dims[4] = {pp, nn, hh, gc};
  const cuuint64_t s_str[3] = {pp * 4, nn * pp * 4, hh * nn * pp * 4};
  const cuuint32_t s_box[4] = {32, 64, 1, 1};
  if (!encode(&tx, BF16, 4, x, x_dims, x_str, x_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&tb, BF16, 3, B, bc_dims, b_str, b_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&tcm, BF16, 3, C, bc_dims, c_str, c_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&ty, BF16, 4, y, x_dims, y_str, y_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, st, s_dims, s_str, s_box,
              CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ssd_hopper<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err == cudaSuccess)  // two blocks of one consumer warpgroup share an SM
    err = cudaFuncSetAttribute(ssd_hopper<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  Params p;
  p.dt = dt;
  p.A = A;
  p.c = c;
  p.H = H;
  p.hg = hg;
  p.n_hg = (H + hg - 1) / hg;
  p.split = split;
  p.n_tiles = split ? 2 * G * H : G * p.n_hg;
  ssd_hopper<T><<<grid, T::THREADS, T::SMEM, stream>>>(tx, tb, tcm, ty, ts, p);
  return cudaGetLastError();
}

}  // namespace hop

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

// The Hopper design of the bf16 route (kernels/ssd_chunk.py: `design`
// "hopper"): x, B, C bf16 with c <= 128, N <= 128, P <= 64 a multiple of 8,
// row strides multiples of 8 elements and every pointer 16-byte aligned
// (what a tensor map can describe).  The schedule comes from the caller
// (kernels/ssd_chunk.py: `schedule`): nwg consumer warpgroups (2: a tile
// is a cell's group of hg heads, both roles; 1: c <= 64, or split tiles of
// one (cell, head, role) where c > 64), and grid persistent blocks.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int ssd_chunk_hopper(const void* x, const float* dt, const float* A, const void* B,
                                const void* C, void* y, float* st, int G, int c, int H, int P,
                                int N, long long x_rs, long long b_rs, long long c_rs, int nwg,
                                int hg, int split, int grid, void* stream) {
  const auto aligned = [](const void* ptr) { return (unsigned long long)ptr % 16 == 0; };
  if (G <= 0 || c <= 0 || c > 128 || H <= 0 || P <= 0 || P > 64 || P % 8 != 0 || N <= 0 ||
      N > 128 || x_rs % 8 != 0 || b_rs % 8 != 0 || c_rs % 8 != 0 || !aligned(x) || !aligned(B) ||
      !aligned(C) || !aligned(y) || !aligned(st) || hg < 1 || grid < 1 ||
      (nwg != 1 && nwg != 2) || (nwg == 2 && split) || (c > 64) != (nwg == 2 || split))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cp = c > 64 ? 128 : 64, np = N > 64 ? 128 : 64, pp = P > 32 ? 64 : 32;
#define SSD_HOPPER(CP, NP, PP, NWG)                                                            \
  if (cp == CP && np == NP && pp == PP && nwg == NWG)                                          \
    return (int)hop::launch<hop::Cfg<CP, NP, PP, NWG>>(x, dt, A, B, C, y, st, G, c, H, P, N,  \
                                                       x_rs, b_rs, c_rs, hg, split, grid, s);
  SSD_HOPPER(128, 128, 64, 2) SSD_HOPPER(128, 64, 64, 2)
  SSD_HOPPER(128, 128, 32, 2) SSD_HOPPER(128, 64, 32, 2)
  SSD_HOPPER(128, 128, 64, 1) SSD_HOPPER(128, 64, 64, 1)
  SSD_HOPPER(128, 128, 32, 1) SSD_HOPPER(128, 64, 32, 1)
  SSD_HOPPER(64, 128, 64, 1) SSD_HOPPER(64, 64, 64, 1)
  SSD_HOPPER(64, 128, 32, 1) SSD_HOPPER(64, 64, 32, 1)
#undef SSD_HOPPER
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory (bytes) ssd_chunk_hopper's kernel for (c, P,
// N) with nwg consumer warpgroups asks for: Cfg's layout, which
// kernels/ssd_chunk.py's `hopper_layout` mirrors.  -1 where no kernel is
// built for it.
extern "C" int ssd_chunk_hopper_smem(int c, int P, int N, int nwg) {
  const int cp = c > 64 ? 128 : 64, np = N > 64 ? 128 : 64, pp = P > 32 ? 64 : 32;
#define SSD_HOPPER(CP, NP, PP, NWG) \
  if (cp == CP && np == NP && pp == PP && nwg == NWG) return hop::Cfg<CP, NP, PP, NWG>::SMEM;
  SSD_HOPPER(128, 128, 64, 2) SSD_HOPPER(128, 64, 64, 2)
  SSD_HOPPER(128, 128, 32, 2) SSD_HOPPER(128, 64, 32, 2)
  SSD_HOPPER(128, 128, 64, 1) SSD_HOPPER(128, 64, 64, 1)
  SSD_HOPPER(128, 128, 32, 1) SSD_HOPPER(128, 64, 32, 1)
  SSD_HOPPER(64, 128, 64, 1) SSD_HOPPER(64, 64, 64, 1)
  SSD_HOPPER(64, 128, 32, 1) SSD_HOPPER(64, 64, 32, 1)
#undef SSD_HOPPER
  return -1;
}
