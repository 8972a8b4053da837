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
// Design of this first version (CUDA cores, float32 arithmetic):
// * one 256-thread block per cell, grid (G, H); a loop over rows replaces
//   the TPU's (c, c) VMEM tiles;
// * x * dt (c x P) and the masked, decayed scores (c x c) live in shared
//   memory as float32; C and B are staged through shared memory in slices
//   of 32 columns of N for C B^T, and B * decay in slices of 32 rows for the
//   state.  At the serving shape that is 131 KB, so one block fits on an
//   SM: shared memory, not registers, bounds the occupancy;
// * the three products are register-tiled: each thread owns 4 x 4 outputs
//   per tile (rows contiguous, columns strided by the tile count, which
//   keeps the shared-memory reads free of bank conflicts), at most 4 tiles;
// * the decay is computed only where j <= i and selected, never multiplied
//   by a mask: cum decreases, so exp(cum[i] - cum[j]) for j > i can be inf,
//   and inf * 0 is NaN.  y's sum over j stops at the tile's last row;
// * C B^T is the same for every head of a chunk; each head's block
//   recomputes it, as the TPU kernel does;
// * the kernel allocates nothing and launches on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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
cudaError_t launch(const void* x, const float* dt, const float* A, const void* B,
                   const void* C, void* y, float* st, int G, int c, int H, int P, int N,
                   long long x_rs, long long b_rs, long long c_rs, int smem,
                   cudaStream_t stream) {
  auto kern = ssd_chunk_kernel<X, BC>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(G, H), THREADS, smem, stream>>>(
      (const X*)x, dt, A, (const BC*)B, (const BC*)C, (X*)y, st, c, H, P, N, x_rs, b_rs,
      c_rs);
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` and returns its cudaError_t (0 = launched).
// x_dtype / bc_dtype: 0 = float32, 1 = bfloat16.  x_rs, b_rs, c_rs: elements
// between consecutive rows of x, B and C.  Refuses (cudaErrorInvalidValue)
// shapes whose tiles or shared memory exceed what the kernel was built for:
// c <= 128, c * P and N * P at most 16384 once padded to multiples of 4, and
// at most 227 KB of shared memory.
extern "C" int ssd_chunk(const void* x, const float* dt, const float* A, const void* B,
                         const void* C, void* y, float* st, int G, int c, int H, int P,
                         int N, long long x_rs, long long b_rs, long long c_rs,
                         int x_dtype, int bc_dtype, void* stream) {
  if (G <= 0 || c <= 0 || H <= 0 || P <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const Layout L(c, P, N);
  const int limit = MAX_TILES * THREADS * TILE * TILE;
  if (L.cp * L.cp > limit || L.cp * L.pp > limit || L.np * L.pp > limit)
    return (int)cudaErrorInvalidValue;
  const int smem = L.total * (int)sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && bc_dtype == 0)
    return (int)launch<float, float>(x, dt, A, B, C, y, st, G, c, H, P, N, x_rs, b_rs, c_rs,
                                     smem, s);
  if (x_dtype == 0 && bc_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(x, dt, A, B, C, y, st, G, c, H, P, N, x_rs, b_rs,
                                             c_rs, smem, s);
  if (x_dtype == 1 && bc_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(x, dt, A, B, C, y, st, G, c, H, P, N, x_rs, b_rs,
                                             c_rs, smem, s);
  if (x_dtype == 1 && bc_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, dt, A, B, C, y, st, G, c, H, P, N,
                                                     x_rs, b_rs, c_rs, smem, s);
  return (int)cudaErrorInvalidValue;
}
