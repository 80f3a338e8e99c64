// decode_attention: one query token per sequence against a KV cache under a
// validity vector, for sm_90a.
//
// Replaces the Pallas TPU kernel decode_attention_pallas of
// src/repro/kernels/decode_attention/kernel.py (body _kernel):
// out[b, 0, h] = softmax_s(q[b, 0, h] . k[b, h // R, s] / sqrt(dh)) .
// v[b, h // R, s] over the cache positions s, where positions with
// valid[s] == 0 score -1e30 (as in the reference, so a cache with no valid
// position averages v, like the reference's softmax of a constant row), and
// the denominator is floored at 1e-30. valid is int32 (S,) and shared by the
// batch, as in the reference.
//
// What bounds it: bytes. Each cache element is read once and used for two
// multiply-adds, so the cache stream (B G S dh elements of k and of v) is
// the whole cost: 173 MB per call at the serving shape (B = 8, G = 20,
// S = 1056, dh = 128, float32), 52 us at 3.35 TB/s.
//   * one block of 8 warps per (head, batch row); warp w takes positions
//     4 (w + 8 i) .. 4 (w + 8 i) + 3, so the 32 positions of one step are
//     read by the 8 warps together;
//   * a warp reads a cache row with every lane on its own dh / 32 slice
//     (16 contiguous bytes a lane in float32 at dh = 128: one coalesced
//     512-byte row), issues the loads of its 4 positions' k and v rows
//     before it uses any, and reduces the 4 dot products over the lanes
//     with shuffles;
//   * each warp keeps its own online softmax (running max, sum and a dh
//     slice of the output per lane, in float32); the 8 partial states are
//     combined through shared memory at the end;
//   * S need not be a multiple of anything: positions past S are left out
//     (they weigh exactly 0; a position with valid == 0 weighs like the
//     reference's -1e30).
// At B H = 160 blocks on 132 SMs the grid is one wave with most SMs holding
// one block: the kernel is latency-bound, not byte-bound. Splitting the
// cache over more blocks (split-KV with a combine pass) and one block per
// KV head for grouped queries are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;          // positions a warp holds in flight
constexpr float kNegInf = -1e30f;

template <int N>
__device__ __forceinline__ void loadv(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void loadv(const __nv_bfloat16* p, float* out) {
  if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  } else if constexpr (N == 2) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = a.x; out[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __bfloat162float(p[i]);
  }
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc,
                        const int* __restrict__ valid, T* __restrict__ o,
                        int S, int H, int G, float scale) {
  constexpr int kEPL = DH >= 32 ? DH / 32 : 1;   // elements per lane
  constexpr int kLanes = DH / kEPL;              // lanes holding a slice
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][DH];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool holds = lane < kLanes;
  const int d0 = lane * kEPL;

  float qv[kEPL];
#pragma unroll
  for (int e = 0; e < kEPL; ++e) qv[e] = 0.f;
  if (holds) loadv<kEPL>(q + (static_cast<long long>(b) * H + h) * DH + d0, qv);
  const long long slab = (static_cast<long long>(b) * G + g) * S * DH;
  const T* kb = kc + slab + d0;
  const T* vb = vc + slab + d0;

  float m = kNegInf, l = 0.f, acc[kEPL];
#pragma unroll
  for (int e = 0; e < kEPL; ++e) acc[e] = 0.f;

  for (int base = warp * kUnroll; base < S; base += kWarps * kUnroll) {
    float kk[kUnroll][kEPL], vv[kUnroll][kEPL], s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = base + u;
#pragma unroll
      for (int e = 0; e < kEPL; ++e) kk[u][e] = vv[u][e] = 0.f;
      if (holds && pos < S) {
        loadv<kEPL>(kb + static_cast<long long>(pos) * DH, kk[u]);
        loadv<kEPL>(vb + static_cast<long long>(pos) * DH, vv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float t = 0.f;
#pragma unroll
      for (int e = 0; e < kEPL; ++e) t = fmaf(qv[e], kk[u][e], t);
      s[u] = t;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
    float mx = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = base + u;
      s[u] = pos >= S ? -INFINITY : (valid[pos] ? s[u] * scale : kNegInf);
      mx = fmaxf(mx, s[u]);
    }
    const float corr = expf(m - mx);
    l *= corr;
#pragma unroll
    for (int e = 0; e < kEPL; ++e) acc[e] *= corr;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = expf(s[u] - mx);
      l += p;
#pragma unroll
      for (int e = 0; e < kEPL; ++e) acc[e] = fmaf(p, vv[u][e], acc[e]);
    }
    m = mx;
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  if (holds) {
#pragma unroll
    for (int e = 0; e < kEPL; ++e) sm_acc[warp][d0 + e] = acc[e];
  }
  __syncthreads();
  if (threadIdx.x < DH) {
    const int d = threadIdx.x;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w]);
    float L = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w] - M);
      L = fmaf(sm_l[w], f, L);
      num = fmaf(sm_acc[w][d], f, num);
    }
    store1(o + (static_cast<long long>(b) * H + h) * DH + d,
           num / fmaxf(L, 1e-30f));
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* valid, void* o, int B, int S, int H, int G,
                   cudaStream_t stream) {
  const dim3 grid(H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  decode_attention_kernel<T, DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, static_cast<T*>(o), S, H, G, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* valid, void* o, int B, int S, int H, int G,
                     int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, valid, o, B, S, H, G, stream);
    case 32: return launch<T, 32>(q, k, v, valid, o, B, S, H, G, stream);
    case 64: return launch<T, 64>(q, k, v, valid, o, B, S, H, G, stream);
    case 128: return launch<T, 128>(q, k, v, valid, o, B, S, H, G, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o (B, 1, H, dh); k, v caches (B, G, S, dh); valid int32 (S,); all
// contiguous, q / caches / o of one type: dtype 0 = float32, 1 = bfloat16.
// dh in {16, 32, 64, 128}; H % G == 0. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* valid,
                                       void* o, int B, int S, int H, int G,
                                       int dh, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || G <= 0 || H % G != 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* vp = static_cast<const int*>(valid);
  if (dtype == 0)
    return dispatch<float>(q, k, v, vp, o, B, S, H, G, dh, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, vp, o, B, S, H, G, dh, st);
  return cudaErrorInvalidValue;
}
