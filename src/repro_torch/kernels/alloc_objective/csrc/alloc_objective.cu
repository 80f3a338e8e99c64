// alloc_objective: the fused eq. (1) value and analytic gradient for sm_90a.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/alloc_objective/
// kernel.py: alloc_objective_fleet_pallas (body _fleet_kernel ->
// _objective_math), and alloc_objective_pallas (body _kernel), which is this
// kernel with B = 1. The value-only instantiation (kGrad = false) also takes
// the place of the reference's jnp ladder evaluation
// alloc_objective_fleet_value (ref.py), so every eq. (1) evaluation of the
// fleet solver on the card runs here.
//
// Per problem b and candidate row x = X[b, t, :]:
//   Kx = K_b x (m), Ex = E_b x (p), s = max(d_b - Kx, 0)
//   f  = c.x + alpha (p_cnt - sum e^{-b1 Ex}) - gamma sum log1p(b2 Ex)
//        + b3 sum s^2
//   g  = c + E^T (alpha b1 e^{-b1 Ex} - gamma b2 / (1 + b2 Ex)) - 2 b3 K^T s
// scalars[b] = [alpha, beta1, beta2, beta3, gamma, p_cnt, 0, 0]; p_cnt is the
// PADDED provider count, so zero E rows (exp(0) = 1) cancel against it.
//
// What bounds it: bytes. Each row reads x and the m + p + 1 rows of K_b,
// E_b, c_b (n floats each) and writes g; about 2 (m + p + 1) flops per
// element and pass, far below the card's 67 TFLOP/s float32 rate at
// 3.35 TB/s. With m = 4 and p = 2 the products are too narrow for tensor
// cores, so they are register reductions. The design:
//   * a block of 8 warps holds up to 16 rows of ONE problem (grid =
//     (blocks, B)); the launch plan (ops.launch_plan) picks the rows per
//     block from (B, T);
//   * the block stages the problem's c_b, K_b, E_b rows in shared memory
//     once, with cp.async from all 256 threads, and every row of the block
//     reads them there, so K_b, E_b, c_b leave device memory (or L2) once
//     per block, not once per row. Where the stage does not fit in 227 KB
//     (large n at m = p = 8) the columns go in tiles of n_tile, a multiple
//     of 512;
//   * pass 1: one warp per row; a block of more than 8 rows gives each warp
//     two rows at once, so that every shared-memory read serves both. x
//     comes straight from device memory in 16-byte loads where n % 4 == 0,
//     in 4-byte loads otherwise, 8 loads in flight per lane (4 a row at two
//     rows a warp); the first group is loaded before the stage is waited
//     for. Each lane sums its products as a float tree over each 4 of
//     its vectors and adds the trees in order in double;
//   * m and p are template parameters (2, 4, 8, and a runtime-bounded
//     instantiation for any other m, p <= 8), so the inner loops carry no
//     per-element branches and only the 1 + m + p live sums are reduced;
//   * the reduction is a warp butterfly (__shfl_xor_sync) in double,
//     rounded once to float: no shared memory, no __syncthreads per row,
//     no atomics;
//   * pass 2 (kGrad only): each row's m + p weights go to shared memory,
//     one __syncthreads, then all 256 threads write g for the block's rows
//     from the staged c, E, K; x is not read again;
//   * the ragged tail of n is masked by the loop bounds; nothing is padded.
// The order of arithmetic for a row depends on n alone: lane l of the warp
// visits its columns (4-wide vectors l, l + 32, ... where n % 4 == 0, else
// single columns l, l + 32, ...) in increasing order, in sub-groups of 4
// that tiles (at multiples of 512 columns) never split, the butterfly is
// fixed, and the epilogue uses explicitly rounded operations. So a row's f
// and g are bit-identical whatever B, T or plan it is launched with, and
// the value-only f equals the f of the value + gradient form.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxM = 8;          // resources (bucketed m is 2, 4 or 8)
constexpr int kMaxP = 8;          // providers (bucketed p is 2, 4 or 8)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRows = 2 * kWarps;        // rows a block holds
constexpr int kSub = 4;           // vectors a lane sums as a tree
constexpr int kTileCols = 512;    // tiles start at multiples of this: whole
                                  // sub-groups (32 lanes x 4 x 4 columns)
constexpr int kWeightFloats = kMaxRows * (kMaxM + kMaxP);
constexpr int kSmemLimit = 232448;   // 227 KB of dynamic shared memory

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

// Start copying row q of [c_b; K_b; E_b], columns [col0, col0 + cols), into
// shared row q (stride nt floats), with every thread of the block;
// stage_wait() completes it. kVec copies 16 bytes at a time (n % 4 == 0:
// every row and tile start is 16-byte aligned), else 4.
template <bool kVec>
__device__ void stage_start(float* sm, int nt, const float* cb,
                            const float* Kb, const float* Eb, int n, int m,
                            int p, int col0, int cols) {
  for (int q = 0; q < 1 + m + p; ++q) {
    const float* src = (q == 0 ? cb
                        : q <= m ? Kb + static_cast<long long>(q - 1) * n
                                 : Eb + static_cast<long long>(q - 1 - m) * n)
                       + col0;
    float* dst = sm + q * nt;
    if (kVec) {
      for (int k = threadIdx.x; k < (cols >> 2); k += kThreads)
        cp_async16(dst + 4 * k, src + 4 * k);
    } else {
      for (int k = threadIdx.x; k < cols; k += kThreads)
        cp_async4(dst + k, src + k);
    }
  }
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// One group of x loads: kU (16-byte or single-float) columns per row and
// lane, starting at element k0, zero past `cols`.
template <typename V, int kU, int kRW>
__device__ __forceinline__ void load_x(V (&xv)[kU][kRW],
                                       const V* const (&xr)[kRW], int k0,
                                       int cols) {
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int k = k0 + 32 * u;
#pragma unroll
    for (int r = 0; r < kRW; ++r) xv[u][r] = k < cols ? __ldcs(xr[r] + k) : V{};
  }
}

// The product a.x as a sum begun at zero: one product, or a 4-wide vector's
// four in a chain.
__device__ __forceinline__ float prod(float a, float x) {
  return __fmul_rn(a, x);
}

__device__ __forceinline__ float prod(float4 a, float4 x) {
  return fmaf(a.w, x.w, fmaf(a.z, x.z, fmaf(a.y, x.y, __fmul_rn(a.x, x.x))));
}

// Pass 1 over one staged tile: acc[r] += (c.x, K x, E x) of the warp's rows
// over this lane's columns of the tile. V is float4 (n % 4 == 0; columns
// counted in 4-wide vectors) or float. The lane's vectors go in sub-groups
// of kSub consecutive ones (k, k + 32, k + 64, k + 96): each sub-group's
// products are summed as a tree, ((p0 + p1) + (p2 + p3)), in float, and the
// sub-group sums are added to acc in order, in double. Rounding in Kx
// matters: the gradient's shortage term multiplies it by 2 beta3 K (about
// 1700 on the fleet's data, PERF.md), so Kx, Ex and c.x leave the kernel
// rounded once from double, at one conversion and one double add per 16
// columns (4 at n % 4 != 0) and sum.
// `xv` holds the group at k0 = lane, loaded before the stage was waited
// for. At one row a warp (small T: latency-bound) the next group is loaded
// before the current one is used; at two rows a warp the registers that
// would take are worth more as resident warps (measured on the card), so
// it is loaded after.
template <typename V, int kU, int NM, int NP, int kRW>
__device__ __forceinline__ void accumulate(const V* s, int nt, V (&xv)[kU][kRW],
                                           const V* const (&xr)[kRW], int cols,
                                           int m, int p, int lane,
                                           double (&acc)[kRW][1 + NM + NP]) {
  static_assert(kU % kSub == 0, "a load group holds whole sub-groups");
  constexpr bool kAhead = kRW == 1;
  for (int k0 = lane; k0 < cols; k0 += 32 * kU) {
    V cur[kU][kRW];
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int r = 0; r < kRW; ++r) cur[u][r] = xv[u][r];
    const bool more = k0 + 32 * kU < cols;
    if (kAhead && more) load_x<V, kU, kRW>(xv, xr, k0 + 32 * kU, cols);
#pragma unroll
    for (int u0 = 0; u0 < kU; u0 += kSub) {
      if (k0 + 32 * u0 >= cols) break;
#pragma unroll
      for (int q = 0; q < 1 + NM + NP; ++q) {
        // staged row of sum q: c, then K rows, then E rows
        const int srow = q == 0 ? 0 : q <= NM ? q : q - NM + m;
        if ((q > m && q <= NM) || q > NM + p) continue;
        float t[kSub][kRW];
#pragma unroll
        for (int u = 0; u < kSub; ++u) {
          const int k = k0 + 32 * (u0 + u);
          const V a = k < cols ? s[srow * nt + k] : V{};
#pragma unroll
          for (int r = 0; r < kRW; ++r) t[u][r] = prod(a, cur[u0 + u][r]);
        }
#pragma unroll
        for (int r = 0; r < kRW; ++r)
          acc[r][q] = __dadd_rn(acc[r][q], static_cast<double>(
              __fadd_rn(__fadd_rn(t[0][r], t[1][r]),
                        __fadd_rn(t[2][r], t[3][r]))));
      }
    }
    if (!kAhead && more) load_x<V, kU, kRW>(xv, xr, k0 + 32 * kU, cols);
  }
}

// Pass 1 over every tile (the stage restaged per tile), in V-wide columns.
template <typename V, int NM, int NP, int kRW>
__device__ __forceinline__ void pass1(float* sm, int n_tile, const float* cb,
                                      const float* Kb, const float* Eb,
                                      const float* X,
                                      const long long (&row)[kRW],
                                      bool active, int n, int m, int p,
                                      int lane,
                                      double (&acc)[kRW][1 + NM + NP]) {
  constexpr bool kVec = sizeof(V) == 16;
  constexpr int kW = kVec ? 4 : 1;               // floats per V
  constexpr int kU = 8 / kRW;                     // x loads in flight per lane
  for (int col0 = 0; col0 < n; col0 += n_tile) {
    const int cols = min(n_tile, n - col0);
    if (col0 > 0) __syncthreads();        // every warp is done with the tile
    stage_start<kVec>(sm, n_tile, cb, Kb, Eb, n, m, p, col0, cols);
    const V* xr[kRW];
#pragma unroll
    for (int r = 0; r < kRW; ++r)
      xr[r] = reinterpret_cast<const V*>(X + row[r] * n + col0);
    V xv[kU][kRW];
    if (active) load_x<V, kU, kRW>(xv, xr, lane, cols / kW);
    stage_wait();
    if (active)
      accumulate<V, kU, NM, NP, kRW>(reinterpret_cast<const V*>(sm),
                                     n_tile / kW, xv, xr, cols / kW, m, p,
                                     lane, acc);
  }
}

__device__ __forceinline__ float axpy(float w, float a, float y) {
  return fmaf(w, a, y);
}

__device__ __forceinline__ float4 axpy(float w, float4 a, float4 y) {
  return make_float4(fmaf(w, a.x, y.x), fmaf(w, a.y, y.y),
                     fmaf(w, a.z, y.z), fmaf(w, a.w, y.w));
}

// Pass 2 over one staged tile, all threads of the block: g = c + E^T wE +
// K^T wK for the block's `rows` live rows (weights w[r * 16 + q] for K row
// q, w[r * 16 + 8 + j] for E row j), from shared memory only; V-wide
// columns as in accumulate().
template <typename V, int NM, int NP>
__device__ __forceinline__ void gradient(const V* s, int nt, const float* w,
                                         V* g0, long long row_stride,
                                         int rows, int cols, int m, int p) {
  for (int r = 0; r < rows; ++r) {
    float wK[NM], wE[NP];
#pragma unroll
    for (int q = 0; q < NM; ++q) wK[q] = w[r * (kMaxM + kMaxP) + q];
#pragma unroll
    for (int j = 0; j < NP; ++j) wE[j] = w[r * (kMaxM + kMaxP) + kMaxM + j];
    V* gr = g0 + r * row_stride;
    for (int k = threadIdx.x; k < cols; k += kThreads) {
      V gv = s[k];
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        if (j >= p) break;
        gv = axpy(wE[j], s[(1 + m + j) * nt + k], gv);
      }
#pragma unroll
      for (int q = 0; q < NM; ++q) {
        if (q >= m) break;
        gv = axpy(wK[q], s[(1 + q) * nt + k], gv);
      }
      gr[k] = gv;
    }
  }
}

// kM, kP: 0 = the runtime-bounded instantiation (any m, p <= 8). kRW: rows
// per warp in pass 1 (2 where the block holds more than 8 rows).
template <int kM, int kP, int kRW, bool kGrad>
__global__ void __launch_bounds__(kThreads)
alloc_objective_kernel(const float* __restrict__ X,
                       const float* __restrict__ K,
                       const float* __restrict__ E,
                       const float* __restrict__ c,
                       const float* __restrict__ d,
                       const float* __restrict__ scal,
                       float* __restrict__ f,
                       float* __restrict__ g,
                       int T, int n, int m_arg, int p_arg, int rows_per_block,
                       int n_tile) {
  constexpr int NM = kM ? kM : kMaxM;
  constexpr int NP = kP ? kP : kMaxP;
  const int m = kM ? kM : m_arg;
  const int p = kP ? kP : p_arg;
  // shared memory: the rows' gradient weights, then the stage
  extern __shared__ float4 smem4[];
  float* wsm = reinterpret_cast<float*>(smem4);
  float* sm = wsm + kWeightFloats;

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int block_t0 = blockIdx.x * rows_per_block;
  const int block_rows = min(rows_per_block, T - block_t0);
  const int w0 = (threadIdx.x >> 5) * kRW;     // the warp's first row in block
  const int live = min(kRW, block_rows - w0);  // its rows (<= 0: none)
  const bool vec = (n & 3) == 0;
  const float* cb = c + static_cast<long long>(b) * n;
  const float* Kb = K + static_cast<long long>(b) * m * n;
  const float* Eb = E + static_cast<long long>(b) * p * n;
  // a row past the block's reads the warp's first row again, unwritten
  long long row[kRW];
#pragma unroll
  for (int r = 0; r < kRW; ++r)
    row[r] = static_cast<long long>(b) * T + block_t0 + (r < live ? w0 + r
                                                                  : w0);

  // ---- pass 1: c.x, Kx, Ex over the tiles --------------------------------
  double acc[kRW][1 + NM + NP];
#pragma unroll
  for (int r = 0; r < kRW; ++r)
#pragma unroll
    for (int q = 0; q < 1 + NM + NP; ++q) acc[r][q] = 0.0;
  if (vec)
    pass1<float4, NM, NP, kRW>(sm, n_tile, cb, Kb, Eb, X, row, live > 0, n, m,
                               p, lane, acc);
  else
    pass1<float, NM, NP, kRW>(sm, n_tile, cb, Kb, Eb, X, row, live > 0, n, m,
                              p, lane, acc);

  // fixed butterfly over the warp, in double: every lane ends with the
  // same totals, rounded once to float
  float tot[kRW][1 + NM + NP];
#pragma unroll
  for (int r = 0; r < kRW; ++r)
#pragma unroll
    for (int q = 0; q < 1 + NM + NP; ++q) {
      tot[r][q] = 0.0f;
      if ((q >= 1 + m && q < 1 + NM) || q >= 1 + NM + p) continue;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r][q] = __dadd_rn(acc[r][q],
                              __shfl_xor_sync(0xffffffffu, acc[r][q], off));
      tot[r][q] = __double2float_rn(acc[r][q]);
    }

  // ---- each row's value and gradient weights -----------------------------
  const float* sc = scal + static_cast<long long>(b) * 8;
  const float alpha = sc[0], beta1 = sc[1], beta2 = sc[2], beta3 = sc[3];
  const float gamma = sc[4], p_cnt = sc[5];
#pragma unroll
  for (int r = 0; r < kRW; ++r) {
    if (r >= live) break;
    float* w = wsm + (w0 + r) * (kMaxM + kMaxP);
    float short_sq = 0.0f, exp_sum = 0.0f, log_sum = 0.0f;
#pragma unroll
    for (int q = 0; q < NM; ++q) {
      if (q >= m) break;
      const float s = fmaxf(__fsub_rn(d[static_cast<long long>(b) * m + q],
                                      tot[r][1 + q]), 0.0f);
      short_sq = fmaf(s, s, short_sq);
      if (kGrad && lane == 0) w[q] = __fmul_rn(__fmul_rn(-2.0f, beta3), s);
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (j >= p) break;
      const float ex = tot[r][1 + NM + j];
      const float e = expf(__fmul_rn(-beta1, ex));
      const float bx = __fmul_rn(beta2, ex);
      exp_sum = __fadd_rn(exp_sum, e);
      log_sum = __fadd_rn(log_sum, log1pf(bx));
      if (kGrad && lane == 0)
        w[kMaxM + j] = __fsub_rn(__fmul_rn(__fmul_rn(alpha, beta1), e),
                                 __fdiv_rn(__fmul_rn(gamma, beta2),
                                           __fadd_rn(1.0f, bx)));
    }
    if (lane == 0) {
      float fv = __fadd_rn(tot[r][0],
                           __fmul_rn(alpha, __fsub_rn(p_cnt, exp_sum)));
      fv = __fsub_rn(fv, __fmul_rn(gamma, log_sum));
      f[row[r]] = __fadd_rn(fv, __fmul_rn(beta3, short_sq));
    }
  }
  if (!kGrad) return;

  // ---- pass 2: g = c + E^T wE + K^T wK, all threads, from the stage ------
  const bool tiled = n_tile < n;   // else the one tile is still staged
  __syncthreads();                 // the weights are in shared memory
  float* g0 = g + (static_cast<long long>(b) * T + block_t0) * n;
  for (int col0 = 0; col0 < n; col0 += n_tile) {
    const int cols = min(n_tile, n - col0);
    if (tiled) {
      if (col0 > 0) __syncthreads();
      if (vec) stage_start<true>(sm, n_tile, cb, Kb, Eb, n, m, p, col0, cols);
      else stage_start<false>(sm, n_tile, cb, Kb, Eb, n, m, p, col0, cols);
      stage_wait();
    }
    if (vec)
      gradient<float4, NM, NP>(reinterpret_cast<const float4*>(sm),
                               n_tile / 4, wsm,
                               reinterpret_cast<float4*>(g0 + col0), n / 4,
                               block_rows, cols / 4, m, p);
    else
      gradient<float, NM, NP>(sm, n_tile, wsm, g0 + col0, n, block_rows, cols,
                              m, p);
  }
}

struct Args {
  const float *X, *K, *E, *c, *d, *scal;
  float *f, *g;
  int T, n, m, p, rows_per_block, n_tile;
};

template <int kM, int kP, int kRW, bool kGrad>
int launch_one(const Args& a, dim3 grid, int smem, cudaStream_t s) {
  auto kern = alloc_objective_kernel<kM, kP, kRW, kGrad>;
  // the limit is per device: set it on every launch
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<grid, kThreads, smem, s>>>(a.X, a.K, a.E, a.c, a.d, a.scal, a.f, a.g,
                                    a.T, a.n, a.m, a.p, a.rows_per_block,
                                    a.n_tile);
  return static_cast<int>(cudaGetLastError());
}

template <int kM, int kP>
int launch_mp(const Args& a, bool grad, dim3 grid, int smem, cudaStream_t s) {
  if (a.rows_per_block <= kWarps)
    return grad ? launch_one<kM, kP, 1, true>(a, grid, smem, s)
                : launch_one<kM, kP, 1, false>(a, grid, smem, s);
  return grad ? launch_one<kM, kP, 2, true>(a, grid, smem, s)
              : launch_one<kM, kP, 2, false>(a, grid, smem, s);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<unsigned long long>(ptr) & 15ull) == 0;
}

}  // namespace

// Plain C entry point, bound with ctypes. Every pointer is a contiguous
// float32 device tensor: X (B, T, n), K (B, m, n), E (B, p, n), c (B, n),
// d (B, m), scal (B, 8) -> f (B, T) and, with with_grad, g (B, T, n).
// The launch plan (ops.launch_plan): `blocks` blocks per problem, each of
// `rows_per_block` (1 to 16) consecutive rows; the stage holds n_tile
// columns (n itself, or a multiple of 512 below it; 0 when n = 0) of the
// m + p + 1 rows of c, K, E, after the rows' weights, in smem_bytes =
// 4 ((m + p + 1) n_tile + 256) bytes of shared memory.
// Launches on `stream` and returns a CUDA error code (0 on success).
extern "C" int alloc_objective_launch(const float* X, const float* K,
                                      const float* E, const float* c,
                                      const float* d, const float* scal,
                                      float* f, float* g, int B, int T, int n,
                                      int m, int p, int with_grad, int blocks,
                                      int rows_per_block, int n_tile,
                                      int smem_bytes, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || n < 0 || m < 1 || m > kMaxM ||
      p < 1 || p > kMaxP || rows_per_block < 1 ||
      rows_per_block > kMaxRows || blocks < 1 ||
      static_cast<long long>(blocks - 1) * rows_per_block >= T ||
      static_cast<long long>(blocks) * rows_per_block < T ||
      (n > 0 ? n_tile < 1 || n_tile > n ||
                   (n_tile < n && n_tile % kTileCols != 0)
             : n_tile != 0) ||
      smem_bytes != 4 * ((1 + m + p) * n_tile + kWeightFloats) ||
      smem_bytes > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n % 4 == 0 && !(aligned16(X) && aligned16(K) && aligned16(E) &&
                      aligned16(c) && (!with_grad || aligned16(g))))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a{X, K, E, c, d, scal, f, with_grad ? g : nullptr, T, n, m, p,
               rows_per_block, n_tile};
  const dim3 grid(blocks, B);
  const bool grad = with_grad != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ALLOC_MP(M, P) \
  if (m == M && p == P) return launch_mp<M, P>(a, grad, grid, smem_bytes, s);
  ALLOC_MP(2, 2) ALLOC_MP(2, 4) ALLOC_MP(2, 8)
  ALLOC_MP(4, 2) ALLOC_MP(4, 4) ALLOC_MP(4, 8)
  ALLOC_MP(8, 2) ALLOC_MP(8, 4) ALLOC_MP(8, 8)
#undef ALLOC_MP
  return launch_mp<0, 0>(a, grad, grid, smem_bytes, s);
}
