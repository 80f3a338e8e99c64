// flash_attention: causal grouped-query attention with an optional sliding
// window, for sm_90a.
//
// Replaces the Pallas TPU kernel flash_attention_pallas of
// src/repro/kernels/flash_attention/kernel.py (body _kernel): the same
// function, out[b, s, h] = softmax_t(q[b, s, h] . k[b, t, h // R] / sqrt(dh)
// over the live keys t) . v[b, t, h // R], with R = H / G, live meaning
// t <= s and, when window > 0, t > s - window. Masked scores are -1e30 and
// the denominator is floored at 1e-30, as in the reference.
//
// What bounds it: operations. Per live (query, key) pair it does 4 dh
// float32 operations (q.k and p.v) and reads nothing new, so at the
// serving shape (B = 8, S = 1024, H = 20, dh = 128) the causal half of the
// score matrix is 43 GFLOP against 336 MB of q, k, v and o. In float32 the
// tensor cores are out (TF32 keeps ten mantissa bits, outside the
// reference's 2e-4), so the products run on the FP32 pipes:
//   * one block of 256 threads per (64-query tile, head, batch row),
//     launched heaviest tile first (the last query tiles see the most keys);
//   * the loop visits only the live key tiles: up to the causal diagonal,
//     and from q0 - window + 1 when window > 0. Tiles the TPU grid visits
//     and skips are never visited here;
//   * q, k and v tiles are staged in shared memory as float32 (bf16 inputs
//     are widened on the way in), rows padded by 4 floats so the 16-byte
//     reads of 16 different rows hit different banks; the probabilities
//     reuse the k tile's space once the scores are in registers;
//   * each thread holds a 4 x 4 block of scores (rows ty*4 + i, columns
//     tx + 16 j) and a 4-row block of the output in registers; row max and
//     row sum are reduced over the 16 lanes that share the rows with
//     shuffles; the online softmax keeps running max, sum and output in
//     float32;
//   * the ragged tail of S is masked: rows of a tile past S are loaded as
//     zeros and never stored, so S need not be a multiple of 64.
// A tile of k and one of v at dh = 128 in float32 is 64 KB, above the
// default 48 KB of dynamic shared memory: the launch raises the limit with
// cudaFuncSetAttribute (101 KB a block, two blocks an SM). wgmma on bf16
// tiles, TMA and split-KV are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 x 16: ty owns 4 rows, tx 4 columns
constexpr int kPLD = kBK + 4;  // row stride of the probability tile
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned int*>(&a);
  raw.y = *reinterpret_cast<unsigned int*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Stage rows [0, kRows) of a (rows, DH) slab whose consecutive rows are
// row_stride elements apart into shared memory as float32 (row stride
// DH + 4); rows at or past n_valid are zero-filled.
template <typename T, int DH, int kRows>
__device__ __forceinline__ void load_tile(float* sm, const T* g,
                                          long long row_stride, int n_valid) {
  constexpr int kLD = DH + 4;
  constexpr int kGroups = DH / 4;   // 4-element groups per row
  for (int idx = threadIdx.x; idx < kRows * kGroups; idx += kThreads) {
    const int r = idx / kGroups;
    const int c = (idx % kGroups) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < n_valid) load4(g + r * row_stride + c, v);
    store4(sm + r * kLD + c, v);
  }
}

template <int DH>
constexpr int smem_floats() {
  // q tile, k tile (later the probabilities), v tile
  return kBQ * (DH + 4)
         + (kBK * (DH + 4) > kBQ * kPLD ? kBK * (DH + 4) : kBQ * kPLD)
         + kBK * (DH + 4);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int H, int G, int window, float scale) {
  constexpr int kLD = DH + 4;
  constexpr int kEG = (DH + 63) / 64;   // 4-column output groups a thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * kLD;
  float* Ps = Ks;                       // aliases Ks after the scores
  float* Vs = Ks + (kBK * kLD > kBQ * kPLD ? kBK * kLD : kBQ * kPLD);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const long long q_row = static_cast<long long>(H) * DH;
  const long long kv_row = static_cast<long long>(G) * DH;
  const T* qb = q + (static_cast<long long>(b) * S * H + h) * DH;
  const T* kb = k + (static_cast<long long>(b) * S * G + g) * DH;
  const T* vb = v + (static_cast<long long>(b) * S * G + g) * DH;
  T* ob = o + (static_cast<long long>(b) * S * H + h) * DH;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile<T, DH, kBQ>(Qs, qb + q0 * q_row, q_row, S - q0);

  float m[4], l[4], acc[4][kEG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kEG; ++e)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][e][c] = 0.f;
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int kt_end = q_last / kBK;
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's p and v are consumed
    load_tile<T, DH, kBK>(Ks, kb + k0 * kv_row, kv_row, S - k0);
    load_tile<T, DH, kBK>(Vs, vb + k0 * kv_row, kv_row, S - k0);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * kLD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * kLD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(qv[i].x, kv[j].x, t);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          t = fmaf(qv[i].w, kv[j].w, t);
          s[i][j] = t;
        }
    }

    // mask, then the online softmax of each of the thread's four rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos <= qpos && (window <= 0 || kpos > qpos - window);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float corr = expf(m[i] - mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mx);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = mx;
#pragma unroll
      for (int e = 0; e < kEG; ++e)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][e][c] *= corr;
    }

    __syncthreads();   // every thread is done reading the k tile
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * kPLD + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * kPLD + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int e = 0; e < kEG; ++e) {
          const int col = 4 * (tx + 16 * e);
          if (col < DH) {
            const float4 vv =
                *reinterpret_cast<const float4*>(Vs + (c + cc) * kLD + col);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y
                              : cc == 2 ? pv[i].z : pv[i].w;
              acc[i][e][0] = fmaf(p, vv.x, acc[i][e][0]);
              acc[i][e][1] = fmaf(p, vv.y, acc[i][e][1]);
              acc[i][e][2] = fmaf(p, vv.z, acc[i][e][2]);
              acc[i][e][3] = fmaf(p, vv.w, acc[i][e][3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < kEG; ++e) {
      const int col = 4 * (tx + 16 * e);
      if (col < DH) {
        float out[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) out[c] = acc[i][e][c] / denom;
        store4(ob + row * q_row + col, out);
      }
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int G, int window,
                   cudaStream_t stream) {
  constexpr int kBytes = smem_floats<DH>() * static_cast<int>(sizeof(float));
  // set on every launch: the attribute is per device, and cheap to set
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  flash_attention_kernel<T, DH><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, G, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int H, int G, int dh, int window,
                     cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, G, window, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, G, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, G, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, G, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o (B, S, H, dh); k, v (B, S, G, dh); all contiguous, of one type:
// dtype 0 = float32, 1 = bfloat16. dh in {16, 32, 64, 128}; H % G == 0.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int G, int dh, int window,
                                      int dtype, void* stream) {
  if (B <= 0 || S <= 0 || G <= 0 || H % G != 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, S, H, G, dh, window, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, G, dh, window, st);
  return cudaErrorInvalidValue;
}
