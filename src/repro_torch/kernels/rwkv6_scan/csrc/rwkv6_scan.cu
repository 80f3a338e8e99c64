// rwkv6_scan: the RWKV6 WKV chunked scan, for sm_90a.
//
// Replaces the Pallas TPU kernel rwkv6_scan_pallas of
// src/repro/kernels/rwkv6_scan/kernel.py (body _kernel), and computes what
// the reference model's jnp path _wkv_chunked (src/repro/models/rwkv.py)
// computes. Per (batch row b, head h), with an (hs, hs) state S:
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,  y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
// evaluated chunk by chunk in the closed form, W_t being the product of w
// from the chunk's start up to and including t:
//   y_t = (r_t W_{t-1}) S_0 + sum_{i<t} ((r_t W_{t-1}) . (k_i / W_i)) v_i
//         + (r_t . u . k_t) v_t
//   S'  = diag(W_c) S_0 + sum_i (k_i W_c / W_i) v_i^T
// with log W from a running sum of log w, and k / W_i clamped at e^60
// (exp(-clip(log W_i, -60, 0))), as in the reference. A ragged last chunk
// is padded in shared memory with identity positions (r = k = v = 0,
// w = 1), as the reference pads it; their outputs are not stored, so any S
// is taken (the TPU kernel asserts S % chunk == 0).
//
// What bounds it: bytes. At the rwkv6-7b prefill shape (B 8, S 1024, H 64,
// hs 64, chunk 64, float32) r, k, v, w and y are 134 MB each and s0 and
// s_final 8.4 MB each: 688 MB, 0.21 ms at 3.35 TB/s; the products, counting
// the strict lower half of each (chunk x chunk) matrix, are 12.8 GFLOP,
// 0.19 ms at the 67 TFLOP/s float32 rate. A decode step (S 1, chunk 1)
// reads and writes the 8.4 MB state and little else: about 5 us, and
// latency-bound in practice (one small block per head).
//   * The TPU grid (B, H, n_chunks) carries the state across its sequential
//     chunk axis in VMEM scratch. Here nothing carries across blocks: one
//     block of 256 threads per (b, h) loops over the chunks in order and
//     keeps the state in shared memory, reading s0 once and writing
//     s_final once. 512 blocks at the serving shapes.
//   * Per chunk: the (chunk, hs) tiles of r, k, v and w are loaded into
//     shared memory as float32 (bf16 widened on the way in; each row of hs
//     values is contiguous, rows H hs apart); log w elementwise; a running
//     sum down each channel (one thread a channel, adds only in the chain),
//     which also scales r by W_{t-1}; then k and w are overwritten in place
//     by k / W_i (clamped) and k W_c / W_i. The three products -- the
//     strictly lower (chunk, chunk) matrix, y = att v + (r W) S_0 + bonus v,
//     and the state update -- run as float32 FMAs from shared memory, each
//     thread holding a 4 x 4 block of outputs (rows ty + 16 i, columns
//     tx + 16 j) in registers.
//   * Tile rows are padded to an odd stride (hs + 1), so 32 threads that
//     read down a column hit 32 banks; the state's stride is hs + 16, so
//     the two row groups of a warp's 4 x 4 blocks fall in different banks.
//   * At chunk = hs = 64 the block takes 102 KB of dynamic shared memory,
//     above the default 48 KB: the launch raises the limit on every call
//     (the attribute is per device). Two blocks fit on an SM.
// The full (chunk x chunk) products are computed and the upper half
// masked, a third more FMAs than the work needs; mma.sync / wgmma tiles
// and cp.async staging are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: a thread owns a 4 x 4 block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 64;
constexpr float kClamp = 60.f;

template <int HS>
struct Smem {
  static constexpr int kLdT = HS + 1;       // r, k, v, w tiles (chunk rows)
  static constexpr int kLdS = HS + 16;      // the state (hs rows)
  static __host__ __device__ int lda(int C) { return C + 1; }  // att
  // floats: four tiles, att, state, bonus (C), cum at the chunk's end and u
  static __host__ __device__ int floats(int C) {
    return 4 * C * kLdT + C * lda(C) + HS * kLdS + C + 2 * HS;
  }
};

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// acc[i][j] += sum_{q < K} A(m_i, q) B(n_j, q) with m_i = ty + 16 i and
// n_j = tx + 16 j; A(m, q) = A[m sAm + q sAk], B(n, q) = B[n sBn + q sBk];
// rows m >= M and columns n >= N read nothing.
__device__ __forceinline__ void mma4x4(float (&acc)[4][4], const float* A,
                                       int sAm, int sAk, const float* B,
                                       int sBn, int sBk, int M, int N, int K,
                                       int ty, int tx) {
  for (int q = 0; q < K; ++q) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty + 16 * i, n = tx + 16 * i;
      a[i] = m < M ? A[m * sAm + q * sAk] : 0.f;
      b[i] = n < N ? B[n * sBn + q * sBk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

template <typename T, int HS>
__global__ void __launch_bounds__(kThreads, 2)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  T* __restrict__ y, float* __restrict__ sf, int S, int H,
                  int C) {
  using L = Smem<HS>;
  constexpr int kLdT = L::kLdT, kLdS = L::kLdS;
  extern __shared__ float smem[];
  const int ldA = L::lda(C);
  float* rt = smem;                  // r, then r_t W_{t-1}
  float* kt = rt + C * kLdT;         // k, then k_i / W_i (clamped)
  float* vt = kt + C * kLdT;
  float* wt = vt + C * kLdT;         // w, log w, log W_t, then k_i W_c / W_i
  float* att = wt + C * kLdT;        // (C, C), strictly lower
  float* st = att + C * ldA;         // the state (HS, HS)
  float* bonus = st + HS * kLdS;     // (C,)
  float* cend = bonus + C;           // log W_c (HS,)
  float* us = cend + HS;             // u (HS,)

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const long long row_stride = static_cast<long long>(H) * HS;  // t -> t+1
  const long long base = (static_cast<long long>(b) * S * H + h) * HS;
  const long long sbase = (static_cast<long long>(b) * H + h) * HS * HS;

  for (int q = tid; q < HS * HS / 4; q += kThreads) {
    const int c = q / (HS / 4), d = 4 * (q % (HS / 4));
    float x[4];
    load4(s0 + sbase + c * HS + d, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) st[c * kLdS + d + e] = x[e];
  }
  for (int j = tid; j < HS; j += kThreads) us[j] = u[h * HS + j];

  for (int t0 = 0; t0 < S; t0 += C) {
    // ---- the chunk's tiles; rows past S are identity positions ----------
    for (int q = tid; q < C * HS / 4; q += kThreads) {
      const int t = q / (HS / 4), j = 4 * (q % (HS / 4));
      float xr[4] = {0.f, 0.f, 0.f, 0.f}, xk[4] = {0.f, 0.f, 0.f, 0.f},
            xv[4] = {0.f, 0.f, 0.f, 0.f}, xw[4] = {1.f, 1.f, 1.f, 1.f};
      if (t0 + t < S) {
        const long long off = base + (t0 + t) * row_stride + j;
        load4(r + off, xr);
        load4(k + off, xk);
        load4(v + off, xv);
        load4(w + off, xw);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        rt[t * kLdT + j + e] = xr[e];
        kt[t * kLdT + j + e] = xk[e];
        vt[t * kLdT + j + e] = xv[e];
        wt[t * kLdT + j + e] = xw[e];
      }
    }
    __syncthreads();

    // ---- bonus_t = sum_j r u k (a warp a row); log w --------------------
    for (int t = warp; t < C; t += kWarps) {
      float s = 0.f;
      for (int j = lane; j < HS; j += 32)
        s = fmaf(rt[t * kLdT + j] * us[j], kt[t * kLdT + j], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) bonus[t] = s;
    }
    for (int e = tid; e < C * HS; e += kThreads) {
      float* p = wt + (e / HS) * kLdT + e % HS;
      *p = logf(*p);
    }
    __syncthreads();

    // ---- log W_t: a running sum down each channel (adds only in the
    // chain), and r W_{t-1} on the way -----------------------------------
    if (tid < HS) {
      float cum = 0.f;
      for (int t = 0; t < C; ++t) {
        rt[t * kLdT + tid] *= expf(cum);
        cum += wt[t * kLdT + tid];
        wt[t * kLdT + tid] = cum;
      }
      cend[tid] = cum;
    }
    __syncthreads();

    // ---- k / W_i (clamped) and k W_c / W_i, in place ----------------------
    for (int e = tid; e < C * HS; e += kThreads) {
      const int t = e / HS, j = e % HS;
      const float cm = wt[t * kLdT + j], kk = kt[t * kLdT + j];
      kt[t * kLdT + j] = kk * expf(-fminf(fmaxf(cm, -kClamp), 0.f));
      wt[t * kLdT + j] = kk * expf(cend[j] - cm);
    }
    __syncthreads();

    // ---- att = strict_lower((r W) (k / W)^T) -----------------------------
    float acc[4][4];
    zero(acc);
    mma4x4(acc, rt, kLdT, 1, kt, kLdT, 1, C, C, HS, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = ty + 16 * i, c = tx + 16 * j;
        if (t < C && c < C) att[t * ldA + c] = c < t ? acc[i][j] : 0.f;
      }
    __syncthreads();

    // ---- y = att v + (r W) S_0 + bonus v ----------------------------------
    zero(acc);
    mma4x4(acc, att, ldA, 1, vt, 1, kLdT, C, HS, C, ty, tx);
    mma4x4(acc, rt, kLdT, 1, st, 1, kLdS, C, HS, HS, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty + 16 * i;
      if (t >= C || t0 + t >= S) continue;
      T* yrow = y + base + (t0 + t) * row_stride;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = tx + 16 * j;
        if (d < HS)
          store1(yrow + d, fmaf(bonus[t], vt[t * kLdT + d], acc[i][j]));
      }
    }
    __syncthreads();   // S_0 is read by every thread before it is updated

    // ---- S' = diag(W_c) S_0 + (k W_c / W)^T v ------------------------------
    zero(acc);
    mma4x4(acc, wt, 1, kLdT, vt, 1, kLdT, HS, HS, C, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = ty + 16 * i;
      if (c >= HS) continue;
      const float wc = expf(cend[c]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = tx + 16 * j;
        if (d < HS) st[c * kLdS + d] = fmaf(wc, st[c * kLdS + d], acc[i][j]);
      }
    }
    __syncthreads();   // the tiles are reloaded by the next chunk
  }

  for (int q = tid; q < HS * HS / 4; q += kThreads) {
    const int c = q / (HS / 4), d = 4 * (q % (HS / 4));
    *reinterpret_cast<float4*>(sf + sbase + c * HS + d) =
        make_float4(st[c * kLdS + d], st[c * kLdS + d + 1],
                    st[c * kLdS + d + 2], st[c * kLdS + d + 3]);
  }
}

template <typename T, int HS>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const float* u, const float* s0, void* y, float* sf, int B,
                   int S, int H, int C, cudaStream_t stream) {
  const int bytes = Smem<HS>::floats(C) * static_cast<int>(sizeof(float));
  // set on every launch: the attribute is per device, and cheap to set
  const cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_kernel<T, HS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  rwkv6_scan_kernel<T, HS><<<dim3(H, B), kThreads, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, s0,
      static_cast<T*>(y), sf, S, H, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v,
                     const void* w, const float* u, const float* s0, void* y,
                     float* sf, int B, int S, int H, int hs, int C,
                     cudaStream_t st) {
  switch (hs) {
    case 8: return launch<T, 8>(r, k, v, w, u, s0, y, sf, B, S, H, C, st);
    case 16: return launch<T, 16>(r, k, v, w, u, s0, y, sf, B, S, H, C, st);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, y, sf, B, S, H, C, st);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, y, sf, B, S, H, C, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, w, y (B, S, H, hs) of one type: dtype 0 = float32, 1 = bfloat16;
// u (H, hs), s0 and sf (B, H, hs, hs) float32; all contiguous and 16-byte
// aligned. hs in {8, 16, 32, 64}, 1 <= chunk <= 64, chunk <= S. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, const void* s0,
                                 void* y, void* sf, int B, int S, int H,
                                 int hs, int chunk, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || chunk < 1 || chunk > kMaxChunk ||
      chunk > S)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* sff = static_cast<float*>(sf);
  if (dtype == 0)
    return dispatch<float>(r, k, v, w, uf, s0f, y, sff, B, S, H, hs, chunk,
                           st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(r, k, v, w, uf, s0f, y, sff, B, S, H, hs,
                                   chunk, st);
  return cudaErrorInvalidValue;
}
