// alloc_objective: the fused eq. (1) value and analytic gradient for sm_90a.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/alloc_objective/
// kernel.py: alloc_objective_fleet_pallas (body _fleet_kernel ->
// _objective_math), and alloc_objective_pallas (body _kernel), which is this
// kernel with B = 1. The value-only instantiation (kWithGrad = false) also
// takes the place of the reference's jnp ladder evaluation
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
// What bounds it: bytes. A row reads x and the m + p + 1 rows of K_b, E_b,
// c_b once (n floats each) and writes g once; it does about 2 (m + p + 1)
// flops per element and pass, far below the card's 67 TFLOP/s float32 rate
// at 3.35 TB/s. With m = 4 and p = 2 the Pallas dot_generals are too
// narrow for tensor cores, so they become register reductions:
//   * one thread block per (b, row): blockIdx = (t, b), 256 threads;
//   * pass 1 strides over n with coalesced loads (neighbouring threads read
//     neighbouring columns) and keeps Kx, Ex and c.x in registers, then one
//     fixed-order block reduction (warp shuffles, then one warp over the
//     warp partials) -- no atomics, so a batched call is bit-identical to
//     a per-lane one and reruns are deterministic;
//   * pass 2 (kWithGrad only) writes g with the m + p per-row weights; the
//     second read of K_b, E_b, c_b and x hits L2 (a row is at most a few
//     tens of KB);
//   * the ragged tail of n is masked by the loop bound; nothing is padded.
// Rows of one problem re-read K_b, E_b, c_b from L2; blocks that hold
// several rows, vector loads and TMA are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxM = 8;   // resources (bucketed m is a power of two >= 2)
constexpr int kMaxP = 8;   // providers (bucketed p is a power of two >= 2)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 1 + kMaxM + kMaxP;   // c.x, Kx[0..m), Ex[0..p)

template <bool kWithGrad>
__global__ void __launch_bounds__(kThreads)
alloc_objective_kernel(const float* __restrict__ X,
                       const float* __restrict__ K,
                       const float* __restrict__ E,
                       const float* __restrict__ c,
                       const float* __restrict__ d,
                       const float* __restrict__ scal,
                       float* __restrict__ f,
                       float* __restrict__ g,
                       int T, int n, int m, int p) {
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const long long row = static_cast<long long>(b) * T + t;
  const float* x = X + row * n;
  const float* Kb = K + static_cast<long long>(b) * m * n;
  const float* Eb = E + static_cast<long long>(b) * p * n;
  const float* cb = c + static_cast<long long>(b) * n;

  // ---- pass 1: c.x, Kx, Ex -------------------------------------------
  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float xi = x[i];
    acc[0] = fmaf(cb[i], xi, acc[0]);
#pragma unroll
    for (int r = 0; r < kMaxM; ++r)
      if (r < m) acc[1 + r] = fmaf(Kb[static_cast<long long>(r) * n + i], xi,
                                   acc[1 + r]);
#pragma unroll
    for (int j = 0; j < kMaxP; ++j)
      if (j < p) acc[1 + kMaxM + j] = fmaf(
          Eb[static_cast<long long>(j) * n + i], xi, acc[1 + kMaxM + j]);
  }

  // fixed-order block reduction: shuffle within each warp, then warp 0
  // sums the kWarps partials in warp order
  __shared__ float part[kWarps][kAcc];
  __shared__ float tot[kAcc];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp][k] = v;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
      float v = lane < kWarps ? part[lane][k] : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) tot[k] = v;
    }
  }
  __syncthreads();

  // ---- the row's value and gradient weights ----------------------------
  const float* sc = scal + static_cast<long long>(b) * 8;
  const float alpha = sc[0], beta1 = sc[1], beta2 = sc[2], beta3 = sc[3];
  const float gamma = sc[4], p_cnt = sc[5];
  float wK[kMaxM];
  float wE[kMaxP];
  float exp_sum = 0.0f, log_sum = 0.0f, short_sq = 0.0f;
#pragma unroll
  for (int r = 0; r < kMaxM; ++r) {
    wK[r] = 0.0f;
    if (r < m) {
      const float s = fmaxf(d[static_cast<long long>(b) * m + r] - tot[1 + r],
                            0.0f);
      short_sq += s * s;
      wK[r] = -2.0f * beta3 * s;
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxP; ++j) {
    wE[j] = 0.0f;
    if (j < p) {
      const float ex = tot[1 + kMaxM + j];
      const float e = expf(-beta1 * ex);
      exp_sum += e;
      log_sum += log1pf(beta2 * ex);
      wE[j] = alpha * beta1 * e - gamma * beta2 * (1.0f / (1.0f + beta2 * ex));
    }
  }
  if (threadIdx.x == 0) {
    f[row] = tot[0] + alpha * (p_cnt - exp_sum) + (-gamma * log_sum)
             + beta3 * short_sq;
  }
  if (!kWithGrad) return;

  // ---- pass 2: g = c + E^T wE + K^T wK -----------------------------------
  float* gr = g + row * n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float gi = cb[i];
#pragma unroll
    for (int j = 0; j < kMaxP; ++j)
      if (j < p) gi = fmaf(wE[j], Eb[static_cast<long long>(j) * n + i], gi);
#pragma unroll
    for (int r = 0; r < kMaxM; ++r)
      if (r < m) gi = fmaf(wK[r], Kb[static_cast<long long>(r) * n + i], gi);
    gr[i] = gi;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Every pointer is a contiguous
// float32 device tensor: X (B, T, n), K (B, m, n), E (B, p, n), c (B, n),
// d (B, m), scal (B, 8) -> f (B, T) and, with with_grad, g (B, T, n).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int alloc_objective_launch(const float* X, const float* K,
                                      const float* E, const float* c,
                                      const float* d, const float* scal,
                                      float* f, float* g, int B, int T, int n,
                                      int m, int p, int with_grad,
                                      void* stream) {
  if (B <= 0 || T <= 0 || n < 0 || m < 1 || m > kMaxM || p < 1 || p > kMaxP ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(T, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_grad)
    alloc_objective_kernel<true><<<grid, kThreads, 0, s>>>(
        X, K, E, c, d, scal, f, g, T, n, m, p);
  else
    alloc_objective_kernel<false><<<grid, kThreads, 0, s>>>(
        X, K, E, c, d, scal, f, nullptr, T, n, m, p);
  return static_cast<int>(cudaGetLastError());
}
