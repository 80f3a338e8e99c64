// rwkv6_scan: the RWKV6 WKV chunked scan, for sm_90a, its chunk products on
// the tensor cores through mma.sync.
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
// with log W from a running sum of log w, r_dec = r exp(log W - log w),
// k_dec = k exp(-clip(log W, -60, 0)) (k / W clamped at e^60, per chunk, as
// in the reference) and k_tail = k exp(log W_c - log W). A ragged chunk is
// padded inside the tile with identity positions (r = k = v = 0, w = 1),
// whose outputs are not stored, so any S is taken (the TPU kernel asserts
// S % chunk == 0); the chunk boundaries stay where the reference puts them.
//
// Two forms behind one entry.
//
// Prefill (S > 1). What bounds it: bytes. At the rwkv6-7b prefill shape
// (B 8, S 1024, H 64, hs 64, chunk 64, float32) r, k, v, w and y are 134 MB
// each and s0 and s_final 8.4 MB each: 688 MB, 0.205 ms at 3.35 TB/s. The
// products over the lower half of each chunk matrix are 12.8 GFLOP; as
// 3xTF32, 38 GFLOP of TF32 products: 0.078 ms at the 495 TFLOP/s TF32 rate,
// 0.12 ms at the 318 TFLOP/s that mma.sync alone reaches (mma_probe.py).
// On an H100 the kernel takes about 3.8 times the byte bound, held by its
// products (without them, the loads and the elementwise work reach the
// bound; PERF.md). The design:
//   * one team of warps per (b, h) loops over the chunks in order and
//     carries the state in registers. hs 64: a block is one team of 8
//     warps; hs 32: teams of 4 warps, two to a block; hs 16 and 8: one warp
//     a team, up to 8 to a block (fewer where a block's shared memory
//     would pass 227 KB).
//   * the four products run on mma.sync.m16n8k8 TF32 as 3xTF32: each
//     operand x split once into big = rna(x) and small = rna(x - big), rna
//     being cvt.rna.tf32.f32's rounding done as an integer add and mask
//     (mma_probe.py checks the two agree on every finite float32), and each
//     product as small.big + big.small + big.big, a chain of three
//     mma.sync from zero added to its sum (att, y or the state) with a
//     float32 add: mma.sync's own sums truncate, and with the chains over
//     all of hs and every key group in the accumulators the clamp case's
//     y lay 2.25 times plain float32's rms error from float64 (PERF.md).
//     Plain 1xTF32 sits at the edge of the 1e-3 tolerance; 3xTF32 leaves
//     about 2^-21 of each product (tests/test_torch_rwkv_tf32.py).
//   * a warp owns query rows [16 q, 16 q + 16) (hs 64: q = its slot; fewer
//     slots than tiles: the tiles q with q mod 2T in {s, 2T - 1 - s}) and
//     a group of value columns. It forms att = r_dec k_dec^T only for key
//     tiles <= q, masks the diagonal tile strictly (key < row) and puts the
//     bonus r.u.k on the diagonal, so att v adds the bonus term; att is the
//     A operand of att v straight from its accumulator fragments (its C
//     layout, keys 2 t4 and 2 t4 + 1 fed to k slots t4 and t4 + 4, v's rows
//     read in the same order). y = att v + r_dec S_0 is accumulated in
//     registers and stored as whole vectors.
//   * the lower half makes the warps' shares unequal (query tile q costs
//     q + 1 key tiles). hs 64: the 8 warps are (slot s, column half n);
//     warp w = 4 n + (n ? 3 - s : s), so the SM sub-partition w % 4 runs
//     slots s and 3 - s, one of each half, and every sub-partition gets the
//     same number of products. hs 32: slots pair tiles {0, 3} and {1, 2}.
//   * the state: slot s also owns channel rows [16 s, 16 s + 16) of S for
//     its column group, as an mma accumulator in registers: each chunk it
//     is decayed by W_c and takes k_tail^T v (in the same loop as the
//     warp's att v, sharing v's fragments), and once a chunk it is
//     written, split, to shared memory for the next chunk's r_dec S_0. s0
//     is read once, s_final written once.
//   * loads: the next chunk's r, k, v and w tiles are staged by 16-byte
//     cp.async.cg into the other slot of a two-slot ring, issued at the
//     top of each chunk, so they land while this chunk runs. bfloat16 stays
//     bfloat16 in the ring and is widened on use.
//   * the elementwise work runs in parallel: a thread takes 4 channels of
//     a segment of positions (16 segments at hs 64), computes log w and
//     its running sum within the segment; the segments are combined by a
//     shuffle scan within each warp and one row of sums per warp in shared
//     memory (log W_c summed exactly as the last position's log W is);
//     r_dec, k_dec, k_tail and v are split and written, float32's big
//     halves in place over the raw tile (the small halves and, in
//     bfloat16, the big ones to their own tiles). The bonus is summed over
//     the 4-channel lanes of a row by shuffles. log and exp are the
//     accurate logf and expf: the hardware approximation's error grows
//     with its argument's size, and where strong decays drive log W toward
//     the clamp at -60 (the smoke's clamp case) it put y 2.16 times plain
//     float32's rms error from float64 (PERF.md); the kernel's rms
//     distance from the chunked form in float64 stays under twice the
//     plain version's (the smoke's rwkv phase and the card tests).
//   * three barriers a chunk (staged tiles visible; segment totals;
//     processed tiles), team-wide: __syncthreads at hs 64, a named barrier
//     for a 4-warp team, __syncwarp for a 1-warp team.
//   * shared-memory tiles have rows of hs floats (8 padded to 16) whose
//     16-byte chunks are XOR-permuted per row, one permutation per kind of
//     fragment read (r_dec and k_dec: rows g, g + 1 apart; v and k_tail:
//     rows 2 t4 apart; the state: rows 4 t4 apart), so the fragment reads
//     of hs 32 and 64 are free of bank conflicts without padding. At hs 64
//     and chunk 64 a team takes 226.75 KB: the ring (128 KB), the small
//     halves (64 KB), the state's halves (32 KB) and 2.75 KB of sums, the
//     bonus and log W_c; one block of 8 warps an SM. The launch raises the
//     dynamic shared-memory limit on every call (the attribute is per
//     device).
//
// Decode (S == 1, which the wrapper cuts to chunk 1). At chunk 1 the closed
// form reduces to
//   y_d = sum_c r_c S_0[c, d] + (sum_c r_c u_c k_c) v_d
//   S'[c, d] = exp(log w_c) S_0[c, d] + k_c v_d
// (the plain version's arithmetic at chunk 1). What bounds it: bytes, the
// state read and written once (8.4 MB each at B 8, H 64, hs 64): 5.0 us.
// No shared-memory copy of the state and no products: each thread streams
// four rows of one 4-column group of S_0 from device memory by 16-byte
// loads, all issued before any is used, writes S' straight to s_final and
// its part of y to shared memory, where y_d is summed over the threads
// that share column d. hs 64: a block of 256 threads a head, 512 blocks at
// the serving shape, all resident at once, so the whole state is in flight
// together. s0 is never written.
//
// ptxas -v (sm_90a, CUDA 12.8), float32 hs 64: the prefill kernel 255
// registers and 12 spill stores (the chains' temporaries; 218 and none
// before them), 492 HMMA in its code; the decode kernel 50 registers, no
// spills. chip_smoke.py's rwkv_build line reports
// every instantiation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kMaxChunk = 64;
constexpr float kClamp = 60.f;
constexpr int kBlockWarps = 8;        // the largest block
constexpr int kSmemMax = 232448;      // dynamic shared memory a block may use

// ---- the team of warps that carries one (b, h) -------------------------

template <typename T, int HS>
struct Team {
  static constexpr int kP = HS < 16 ? 16 : HS;   // channels in shared memory
  static constexpr int kTQ = kP / 16;            // slots: query / channel tiles
  static constexpr int kTN = HS >= 32 ? 2 : 1;   // value-column groups
  static constexpr int kWarps = kTQ * kTN;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kCols = kP / kTN;         // value columns a warp
  static constexpr int kNT = kCols / 8;          // its n tiles (also W below)
  static constexpr int kCG = kP / 4;             // 4-channel groups
  static constexpr int kSeg = kThreads / kCG;    // scan segments
  static constexpr int kMaxLen = kMaxChunk / kSeg;
  static constexpr int kMaxTeams = kBlockWarps / kWarps;
  static constexpr int kSegWarp = 32 / kCG;      // segments a warp
  // floats of one team's shared memory for tiles of Cp rows: the ring (two
  // slots of r, k, v, w in T), the big halves (bfloat16 only; float32 keeps
  // them in the ring), the small halves, the state's halves, the warps'
  // segment sums, the bonus, log W_c
  static __host__ __device__ int floats(int Cp) {
    const int tile = Cp * kP;
    return 8 * tile * static_cast<int>(sizeof(T)) / 4 +
           (sizeof(T) == 4 ? 0 : 4 * tile) + 4 * tile + 2 * kP * kP +
           (kWarps == 1 ? 0 : (kWarps + 1) * kP) + Cp + kP;
  }
};

// ---- shared-memory layout -------------------------------------------------

// word offset of (row, col) in a float32 tile of P columns whose 16-byte
// chunks are XOR-permuted by `sw` in each row
template <int P>
__device__ __forceinline__ int at(int row, int col, int sw) {
  return row * P + (((col >> 2) ^ sw) << 2) + (col & 3);
}
// r_dec and k_dec: fragment reads of rows g and g + 1
template <int P>
__device__ __forceinline__ int sw_rk(int row) {
  return ((row & 1) << 2) & (P / 4 - 1);
}
// v and k_tail: rows 2 t4 (+ 1)
template <int P>
__device__ __forceinline__ int sw_vt(int row) {
  return (((row >> 1) & 3) << 1) & (P / 4 - 1);
}
// the state: rows 4 t4 (+ e)
template <int P>
__device__ __forceinline__ int sw_s(int row) {
  return (((row >> 2) & 3) << 1) & (P / 4 - 1);
}

// ---- PTX ----------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// cvt.rna.tf32.f32's rounding of a finite x in two integer operations:
// half a TF32 ulp added to the bits, the 13 low bits cleared
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, each a TF32 value
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b in 3xTF32, the small terms first. mma.sync cuts its float32
// sums toward zero (mma_probe.py, fact 4), so a long chain of products in
// one accumulator drifts: the three products form a chain of their own,
// from zero, and are added to d with a float32 add, which rounds to nearest
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           uint32_t b0_big, uint32_t b1_big,
                                           uint32_t b0_small,
                                           uint32_t b1_small) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, a_small, b0_big, b1_big);
  mma_tf32(t, a_big, b0_small, b1_small);
  mma_tf32(t, a_big, b0_big, b1_big);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// ---- loads and stores ---------------------------------------------------

template <int N>
__device__ __forceinline__ void lds(const float* p, uint32_t (&out)[N]) {
  static_assert(N == 2 || N == 4, "vector of 2 or 4 floats");
  if constexpr (N == 4) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    out[0] = x.x; out[1] = x.y;
  }
}

// 4 consecutive elements of a raw tile row, widened
__device__ __forceinline__ void load4(const float* p, float (&out)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&out)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const bf16* p) {
  return __bfloat162float(*p);
}

// n (4 or 8) consecutive floats to device memory in T
template <int N>
__device__ __forceinline__ void store_run(float* p, const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
}
template <int N>
__device__ __forceinline__ void store_run(bf16* p, const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(x[i], x[i + 1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(x[i + 2], x[i + 3]);
    uint2 raw;
    raw.x = *reinterpret_cast<const uint32_t*>(&a);
    raw.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p + i) = raw;
  }
}

// big and small halves of 4 floats, as one 16-byte store each
__device__ __forceinline__ void put4(float* big, float* small, int off,
                                     const float (&x)[4]) {
  uint32_t b[4], s[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) split(x[e], b[e], s[e]);
  *reinterpret_cast<uint4*>(big + off) = make_uint4(b[0], b[1], b[2], b[3]);
  *reinterpret_cast<uint4*>(small + off) = make_uint4(s[0], s[1], s[2], s[3]);
}

template <int kWarps>
__device__ __forceinline__ void team_sync(int team) {
  if constexpr (kWarps == kBlockWarps) {
    __syncthreads();
  } else if constexpr (kWarps == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(team + 1), "r"(32 * kWarps)
                 : "memory");
  }
}

// ---- prefill: the chunks of one (b, h) per team ---------------------------

template <typename T, int HS>
__global__ void __launch_bounds__(32 * kBlockWarps)
rwkv6_chunks_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ w,
                    const float* __restrict__ u, const float* __restrict__ s0,
                    T* __restrict__ y, float* __restrict__ sf, int S, int H,
                    int C, int n_heads, int teams) {
  using Tm = Team<T, HS>;
  constexpr int P = Tm::kP;
  constexpr int W = Tm::kNT;
  constexpr bool kF32 = sizeof(T) == 4;
  const int Cp = (C + 15) & ~15;
  const int NQ = Cp / 16;
  const int tile = Cp * P;

  const int team = threadIdx.x / Tm::kThreads;
  const int head = blockIdx.x * teams + team;
  if (head >= n_heads) return;   // barriers are team-wide: no team waits
  const int tt = threadIdx.x % Tm::kThreads;
  const int b = head / H, h = head % H;

  extern __shared__ float4 smem4[];
  float* tsm = reinterpret_cast<float*>(smem4) + team * Tm::floats(Cp);
  T* ring = reinterpret_cast<T*>(tsm);
  float* p = tsm + 8 * tile * static_cast<int>(sizeof(T)) / 4;
  float* bigs = p;               // bfloat16: the processed big halves
  if constexpr (!kF32) p += 4 * tile;
  float* smalls = p;  p += 4 * tile;   // r_dec, k_dec, v, k_tail
  float* s_big = p;   p += P * P;
  float* s_small = p; p += P * P;
  float* tot = p;     p += Tm::kWarps == 1 ? 0 : (Tm::kWarps + 1) * P;
  float* bonus = p;   p += Cp;
  float* endv = p;

  const long long row_stride = static_cast<long long>(H) * HS;
  const long long gbase = (static_cast<long long>(b) * S * H + h) * HS;
  const long long sbase = static_cast<long long>(head) * HS * HS;

  // chunk t0's raw tiles into ring slot `slot`; rows past the chunk or S
  // are not loaded (the elementwise pass treats them as identity)
  auto issue = [&](int t0, int slot) {
    constexpr int kVec = 16 / static_cast<int>(sizeof(T));
    constexpr int kCh = HS / kVec;   // 16-byte chunks of a row
    const int all = min(C, S - t0) * kCh;
    T* dst0 = ring + slot * 4 * tile;
    const long long src0 = gbase + static_cast<long long>(t0) * row_stride;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const T* src = (x == 0 ? r : x == 1 ? k : x == 2 ? v : w) + src0;
      T* dst = dst0 + x * tile;
      for (int i = tt; i < all; i += Tm::kThreads) {
        const int row = i / kCh, ch = i % kCh;
        int off;
        if constexpr (kF32)
          off = row * P +
                ((ch ^ (x < 2 ? sw_rk<P>(row) : sw_vt<P>(row))) << 2);
        else
          off = row * P + ch * kVec;
        cp_async16(dst + off, src + row * row_stride + ch * kVec);
      }
    }
    cp_async_commit();
  };
  // element offset of (row, 4-channel group cg) in a raw tile
  auto raw_at = [&](int row, int cg, int sw) {
    if constexpr (kF32) return at<P>(row, 4 * cg, sw);
    else return row * P + 4 * cg;
  };

  const int warp = tt / 32, lane = tt % 32, g = lane >> 2, t4 = lane & 3;
  const int n = warp / Tm::kTQ;
  const int s = n == 0 ? warp % Tm::kTQ : Tm::kTQ - 1 - warp % Tm::kTQ;
  const int n0 = n * Tm::kCols;

  // the state's rows 16 s + g (+ 8), columns n0 + 2 W t4 .. + 2 W - 1 of
  // the warp's group, as the accumulator layout holds them
  float sacc[W][4];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int c = 16 * s + g + 8 * hr;
    const int d = n0 + 2 * W * t4;
    float x[2 * W];
#pragma unroll
    for (int e = 0; e < 2 * W; ++e)
      x[e] = (c < HS && d + e < HS) ? s0[sbase + c * HS + d + e] : 0.f;
#pragma unroll
    for (int q = 0; q < W; ++q) {
      sacc[q][2 * hr] = x[q];
      sacc[q][2 * hr + 1] = x[W + q];
    }
  }

  // elementwise mapping: 4 channels (group cg) of a segment of positions
  const int ecg = tt % Tm::kCG, seg = tt / Tm::kCG;
  const int L = Cp / Tm::kSeg;
  const bool c_ok = HS == P || 4 * ecg < HS;
  float uu[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) uu[e] = c_ok ? u[h * HS + 4 * ecg + e] : 0.f;

  const int n_chunks = (S + C - 1) / C;
  issue(0, 0);
  for (int ic = 0; ic < n_chunks; ++ic) {
    const int t0 = ic * C;
    const int slot = ic & 1;
    const int nrows = min(C, S - t0);
    cp_async_wait_all();
    team_sync<Tm::kWarps>(team);   // (1) chunk ic landed; chunk ic - 1 done

    // the state after chunk ic - 1, split, for this chunk's r_dec S_0
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int c = 16 * s + g + 8 * hr;
#pragma unroll
      for (int i0 = 0; i0 < 2 * W; i0 += 4) {
        // run index i: tile i % W, column 2 t4 + i / W
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[e] = sacc[(i0 + e) % W][2 * hr + (i0 + e) / W];
        put4(s_big, s_small, at<P>(c, n0 + 2 * W * t4 + i0, sw_s<P>(c)), x);
      }
    }
    if (ic + 1 < n_chunks) issue(t0 + C, slot ^ 1);

    const T* rt = ring + slot * 4 * tile;
    const T* kt = rt + tile;
    const T* vt = rt + 2 * tile;
    const T* wt = rt + 3 * tile;

    // ---- log w and its running sum within the segment; the bonus ------
    float lw[Tm::kMaxLen][4], run[Tm::kMaxLen][4];
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < Tm::kMaxLen; ++q) {
      if (q < L) {
        const int t = seg * L + q;
        const bool ok = c_ok && t < nrows;
        float x[4] = {1.f, 1.f, 1.f, 1.f};
        float pb = 0.f;
        if (ok) {
          float rr[4], kk[4];
          load4(wt + raw_at(t, ecg, sw_vt<P>(t)), x);
          load4(rt + raw_at(t, ecg, sw_rk<P>(t)), rr);
          load4(kt + raw_at(t, ecg, sw_rk<P>(t)), kk);
#pragma unroll
          for (int e = 0; e < 4; ++e) pb = fmaf(rr[e] * uu[e], kk[e], pb);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          lw[q][e] = ok ? logf(x[e]) : 0.f;
          acc[e] += lw[q][e];
          run[q][e] = acc[e];
        }
        // the bonus of row t: the kCG lanes that share it (a power of 2,
        // aligned) sum their 4-channel parts
#pragma unroll
        for (int o = 1; o < Tm::kCG; o <<= 1)
          pb += __shfl_xor_sync(0xffffffffu, pb, o);
        if (ecg == 0) bonus[t] = pb;
      }
    }
    // the segments before this one within the warp (a scan by shuffles
    // over the warp's segments); per warp one row of sums, and for the last
    // warp its last segment's two parts, so that log W_c below is the same
    // sum as the last position's log W
    const int wseg = lane / Tm::kCG;
    float incl[4], excl[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      incl[e] = acc[e];
#pragma unroll
      for (int o = 1; o < Tm::kSegWarp; o <<= 1) {
        const float x = __shfl_up_sync(0xffffffffu, incl[e], o * Tm::kCG);
        if (wseg >= o) incl[e] += x;
      }
      const float x = __shfl_up_sync(0xffffffffu, incl[e], Tm::kCG);
      excl[e] = wseg > 0 ? x : 0.f;
    }
    if (Tm::kWarps > 1 && wseg == Tm::kSegWarp - 1) {
      float* row = tot + warp * P + 4 * ecg;
      if (warp < Tm::kWarps - 1) {
        *reinterpret_cast<float4*>(row) =
            make_float4(incl[0], incl[1], incl[2], incl[3]);
      } else {
        *reinterpret_cast<float4*>(row) =
            make_float4(excl[0], excl[1], excl[2], excl[3]);
        *reinterpret_cast<float4*>(row + P) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      }
    }
    team_sync<Tm::kWarps>(team);   // (2) segment sums

    // ---- r_dec, k_dec, k_tail, v: split and written ------------------------
    {
      // off: log W before the segment; end: log W_c, summed as the last
      // segment's last position sums it
      float off[4] = {0.f, 0.f, 0.f, 0.f}, end[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (Tm::kWarps == 1) {
        // one warp: the last segment's lanes hold log W_c
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          off[e] = excl[e];
          end[e] = __shfl_sync(0xffffffffu, excl[e] + acc[e],
                               (Tm::kSegWarp - 1) * Tm::kCG + ecg);
        }
      } else {
        for (int w2 = 0; w2 < Tm::kWarps - 1; ++w2) {
          float tv[4];
          load4(tot + w2 * P + 4 * ecg, tv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (w2 < warp) off[e] += tv[e];
            end[e] += tv[e];
          }
        }
        float xl[4], tl[4];
        load4(tot + (Tm::kWarps - 1) * P + 4 * ecg, xl);
        load4(tot + Tm::kWarps * P + 4 * ecg, tl);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          off[e] += excl[e];
          end[e] = (end[e] + xl[e]) + tl[e];
        }
      }
      if (seg == Tm::kSeg - 1)
        *reinterpret_cast<float4*>(endv + 4 * ecg) =
            make_float4(end[0], end[1], end[2], end[3]);
      float* big0 = kF32 ? reinterpret_cast<float*>(ring) + slot * 4 * tile
                         : bigs;
#pragma unroll
      for (int q = 0; q < Tm::kMaxLen; ++q) {
        if (q < L) {
          const int t = seg * L + q;
          float rr[4] = {0.f, 0.f, 0.f, 0.f}, kk[4] = {0.f, 0.f, 0.f, 0.f},
                vv[4] = {0.f, 0.f, 0.f, 0.f};
          const int o_rk = at<P>(t, 4 * ecg, sw_rk<P>(t));
          const int o_vt = at<P>(t, 4 * ecg, sw_vt<P>(t));
          if (c_ok && t < nrows) {
            load4(rt + raw_at(t, ecg, sw_rk<P>(t)), rr);
            load4(kt + raw_at(t, ecg, sw_rk<P>(t)), kk);
            load4(vt + raw_at(t, ecg, sw_vt<P>(t)), vv);
          }
          float rd[4], kd[4], kl[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float cum = off[e] + run[q][e];
            rd[e] = rr[e] * expf(cum - lw[q][e]);
            kd[e] = kk[e] * expf(-fminf(fmaxf(cum, -kClamp), 0.f));
            kl[e] = kk[e] * expf(end[e] - cum);
          }
          put4(big0, smalls, o_rk, rd);
          put4(big0 + tile, smalls + tile, o_rk, kd);
          put4(big0 + 2 * tile, smalls + 2 * tile, o_vt, vv);
          put4(big0 + 3 * tile, smalls + 3 * tile, o_vt, kl);
        }
      }
    }
    team_sync<Tm::kWarps>(team);   // (3) the processed tiles

    const float* Rb = kF32 ? reinterpret_cast<const float*>(ring) +
                                 slot * 4 * tile
                           : bigs;
    const float* Kb = Rb + tile;
    const float* Vb = Rb + 2 * tile;
    const float* Tb = Rb + 3 * tile;
    const float* Rs = smalls;
    const float* Ks = smalls + tile;
    const float* Vs = smalls + 2 * tile;
    const float* Ts = smalls + 3 * tile;

    // v's fragments of key group j (rows 8 j + 2 t4 and + 1, columns
    // n0 + W g + tile), big and small
    auto v_frags = [&](int j, uint32_t (&b0)[W], uint32_t (&s0v)[W],
                       uint32_t (&b1)[W], uint32_t (&s1v)[W]) {
      const int r0 = 8 * j + 2 * t4, r1 = r0 + 1;
      lds(Vb + at<P>(r0, n0 + W * g, sw_vt<P>(r0)), b0);
      lds(Vs + at<P>(r0, n0 + W * g, sw_vt<P>(r0)), s0v);
      lds(Vb + at<P>(r1, n0 + W * g, sw_vt<P>(r1)), b1);
      lds(Vs + at<P>(r1, n0 + W * g, sw_vt<P>(r1)), s1v);
    };
    // S' += k_tail^T v over key group j, for channel rows 16 s + g (+ 8):
    // k slots t4, t4 + 4 take positions 8 j + 2 t4 and + 1, as in att v
    auto state_step = [&](int j, const uint32_t (&b0)[W],
                          const uint32_t (&s0v)[W], const uint32_t (&b1)[W],
                          const uint32_t (&s1v)[W]) {
      const int r0 = 8 * j + 2 * t4, r1 = r0 + 1;
      const int c0 = 16 * s + g, c1 = c0 + 8;
      const int o00 = at<P>(r0, c0, sw_vt<P>(r0));
      const int o01 = at<P>(r0, c1, sw_vt<P>(r0));
      const int o10 = at<P>(r1, c0, sw_vt<P>(r1));
      const int o11 = at<P>(r1, c1, sw_vt<P>(r1));
      const uint32_t a_b[4] = {
          __float_as_uint(Tb[o00]), __float_as_uint(Tb[o01]),
          __float_as_uint(Tb[o10]), __float_as_uint(Tb[o11])};
      const uint32_t a_s[4] = {
          __float_as_uint(Ts[o00]), __float_as_uint(Ts[o01]),
          __float_as_uint(Ts[o10]), __float_as_uint(Ts[o11])};
#pragma unroll
      for (int jj = 0; jj < W; ++jj)
        mma_3xtf32(sacc[jj], a_b, a_s, b0[jj], b1[jj], s0v[jj], s1v[jj]);
    };

    // S' = diag(W_c) S_0 + k_tail^T v: the decay now, the product with the
    // warp's first query tile's att v (sharing v's fragments)
    {
      const float dec0 = expf(endv[16 * s + g]);
      const float dec1 = expf(endv[16 * s + g + 8]);
#pragma unroll
      for (int jj = 0; jj < W; ++jj) {
        sacc[jj][0] *= dec0;
        sacc[jj][1] *= dec0;
        sacc[jj][2] *= dec1;
        sacc[jj][3] *= dec1;
      }
    }
    bool state_left = true;

    // ---- y for the warp's query tiles ---------------------------------------
    for (int q = 0; q < NQ; ++q) {
      const int m = q % (2 * Tm::kTQ);
      if (m != s && m != 2 * Tm::kTQ - 1 - s) continue;
      const int nkt = 2 * q + 2;   // key tiles of 8 up to the diagonal
      float att[8][4];
      float yacc[W][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) att[j][e] = 0.f;
#pragma unroll
      for (int j = 0; j < W; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;

      // att = r_dec k_dec^T and y = r_dec S_0, 16 channels at a time: lane
      // t4 feeds k slots t4, t4 + 4 of step st with channels 4 t4 + 2 st
      // and + 1, so its r_dec, k_dec and state reads are whole vectors
#pragma unroll
      for (int cg = 0; cg < P / 16; ++cg) {
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = 16 * q + g + 8 * hr;
          const int o = at<P>(row, 16 * cg + 4 * t4, sw_rk<P>(row));
          lds(Rb + o, ab[hr]);
          lds(Rs + o, as[hr]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < nkt) {
            const int row = 8 * j + g;
            const int o = at<P>(row, 16 * cg + 4 * t4, sw_rk<P>(row));
            uint32_t kb[4], ks[4];
            lds(Kb + o, kb);
            lds(Ks + o, ks);
#pragma unroll
            for (int st = 0; st < 2; ++st) {
              const uint32_t a_b[4] = {ab[0][2 * st], ab[1][2 * st],
                                       ab[0][2 * st + 1], ab[1][2 * st + 1]};
              const uint32_t a_s[4] = {as[0][2 * st], as[1][2 * st],
                                       as[0][2 * st + 1], as[1][2 * st + 1]};
              mma_3xtf32(att[j], a_b, a_s, kb[2 * st], kb[2 * st + 1],
                         ks[2 * st], ks[2 * st + 1]);
            }
          }
        }
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          const uint32_t a_b[4] = {ab[0][2 * st], ab[1][2 * st],
                                   ab[0][2 * st + 1], ab[1][2 * st + 1]};
          const uint32_t a_s[4] = {as[0][2 * st], as[1][2 * st],
                                   as[0][2 * st + 1], as[1][2 * st + 1]};
          const int c0 = 16 * cg + 4 * t4 + 2 * st, c1 = c0 + 1;
          uint32_t b0[W], s0v[W], b1[W], s1v[W];
          lds(s_big + at<P>(c0, n0 + W * g, sw_s<P>(c0)), b0);
          lds(s_small + at<P>(c0, n0 + W * g, sw_s<P>(c0)), s0v);
          lds(s_big + at<P>(c1, n0 + W * g, sw_s<P>(c1)), b1);
          lds(s_small + at<P>(c1, n0 + W * g, sw_s<P>(c1)), s1v);
#pragma unroll
          for (int j = 0; j < W; ++j)
            mma_3xtf32(yacc[j], a_b, a_s, b0[j], b1[j], s0v[j], s1v[j]);
        }
      }

      // the diagonal tile: strictly lower, the bonus on the diagonal
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= nkt - 2 && j < nkt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = 16 * q + g + 8 * (e >> 1);
            const int key = 8 * j + 2 * t4 + (e & 1);
            att[j][e] = key < row ? att[j][e]
                                  : (key == row ? bonus[row] : 0.f);
          }
        }
      }

      // y += att v: att's accumulator is the A operand as it stands; v's
      // rows read in its key order. The first query tile also takes S'
      // over every key group.
      const int nj = state_left ? Cp / 8 : nkt;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nj) {
          uint32_t b0[W], s0v[W], b1[W], s1v[W];
          v_frags(j, b0, s0v, b1, s1v);
          if (j < nkt) {
            const float a[4] = {att[j][0], att[j][2], att[j][1], att[j][3]};
            uint32_t pb[4], ps[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) split(a[e], pb[e], ps[e]);
#pragma unroll
            for (int jj = 0; jj < W; ++jj)
              mma_3xtf32(yacc[jj], pb, ps, b0[jj], b1[jj], s0v[jj], s1v[jj]);
          }
          if (state_left) state_step(j, b0, s0v, b1, s1v);
        }
      }
      state_left = false;

      // tile jj's columns 2 t4, 2 t4 + 1 are d = n0 + W (2 t4) + jj and
      // W further: a run of 2 W columns from n0 + 2 W t4
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = 16 * q + g + 8 * hr;
        const int d = n0 + 2 * W * t4;
        if (row < nrows && d < HS) {
          float out[2 * W];
#pragma unroll
          for (int jj = 0; jj < W; ++jj) {
            out[jj] = yacc[jj][2 * hr];
            out[W + jj] = yacc[jj][2 * hr + 1];
          }
          store_run<2 * W>(y + gbase + (t0 + row) * row_stride + d, out);
        }
      }
    }

    // ---- S' for a warp without a query tile in this chunk ----------------------
    if (state_left) {
      for (int j = 0; j < Cp / 8; ++j) {
        uint32_t b0[W], s0v[W], b1[W], s1v[W];
        v_frags(j, b0, s0v, b1, s1v);
        state_step(j, b0, s0v, b1, s1v);
      }
    }
  }

  // s_final, from the registers
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int c = 16 * s + g + 8 * hr;
    const int d = n0 + 2 * W * t4;
    if (c < HS && d < HS) {
      float x[2 * W];
#pragma unroll
      for (int jj = 0; jj < W; ++jj) {
        x[jj] = sacc[jj][2 * hr];
        x[W + jj] = sacc[jj][2 * hr + 1];
      }
      store_run<2 * W>(sf + sbase + c * HS + d, x);
    }
  }
}

// ---- decode: one step, the state streamed through registers ----------------

template <int HS>
struct Step {
  static constexpr int kGroups = HS / 4;              // 4-column groups
  static constexpr int kRowSets = HS / 4;             // a thread: 4 rows
  static constexpr int kPerHead = kGroups * kRowSets;
  static constexpr int kThreads = 256;
  static constexpr int kHeads = kThreads / kPerHead;
};

template <typename T, int HS>
__global__ void __launch_bounds__(256)
rwkv6_step_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  T* __restrict__ y, float* __restrict__ sf, int n_heads,
                  int H) {
  using St = Step<HS>;
  __shared__ float4 part[St::kThreads];   // y_d parts by (row set, group)
  __shared__ float bpart[St::kThreads];   // bonus parts

  const int hl = threadIdx.x / St::kPerHead;
  const int i = threadIdx.x % St::kPerHead;
  const int head = blockIdx.x * St::kHeads + hl;
  const int grp = i % St::kGroups, rs = i / St::kGroups;
  const bool live = head < n_heads;
  float yp[4] = {0.f, 0.f, 0.f, 0.f};
  float bp = 0.f;
  if (live) {
    const int h = head % H;
    const long long xb = static_cast<long long>(head) * HS;
    const long long sb = xb * HS;
    float4 st[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {   // every load in flight before use
      const int c = rs + St::kRowSets * jj;
      st[jj] = *reinterpret_cast<const float4*>(s0 + sb + c * HS + 4 * grp);
    }
    float vv[4];
    load4(v + xb + 4 * grp, vv);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = rs + St::kRowSets * jj;
      const float rc = load1(r + xb + c), kc = load1(k + xb + c);
      const float dec = expf(logf(load1(w + xb + c)));
      const float x[4] = {st[jj].x, st[jj].y, st[jj].z, st[jj].w};
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        yp[e] = fmaf(rc, x[e], yp[e]);
        o[e] = fmaf(dec, x[e], kc * vv[e]);
      }
      *reinterpret_cast<float4*>(sf + sb + c * HS + 4 * grp) =
          make_float4(o[0], o[1], o[2], o[3]);
      if (grp == 0) bp = fmaf(rc * u[h * HS + c], kc, bp);
    }
  }
  part[threadIdx.x] = make_float4(yp[0], yp[1], yp[2], yp[3]);
  bpart[threadIdx.x] = bp;
  __syncthreads();
  if (!live) return;
  const int base = hl * St::kPerHead;
  float bsum = 0.f;
  for (int r2 = 0; r2 < St::kRowSets; ++r2)
    bsum += bpart[base + r2 * St::kGroups];
  const long long xb = static_cast<long long>(head) * HS;
  for (int d = i; d < HS; d += St::kPerHead) {
    float acc = 0.f;
    for (int r2 = 0; r2 < St::kRowSets; ++r2) {
      const float4 x = part[base + r2 * St::kGroups + d / 4];
      acc += (d & 3) == 0 ? x.x : (d & 3) == 1 ? x.y : (d & 3) == 2 ? x.z : x.w;
    }
    const float out = fmaf(bsum, load1(v + xb + d), acc);
    if constexpr (sizeof(T) == 4) y[xb + d] = out;
    else y[xb + d] = __float2bfloat16_rn(out);
  }
}

// ---- launch -------------------------------------------------------------

template <typename T, int HS>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const float* u, const float* s0, void* y, float* sf, int B,
                   int S, int H, int C, cudaStream_t stream) {
  const long long n_heads = static_cast<long long>(B) * H;
  if (n_heads > (1ll << 30)) return cudaErrorInvalidValue;
  const T* rr = static_cast<const T*>(r);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* ww = static_cast<const T*>(w);
  T* yy = static_cast<T*>(y);
  if (S == 1) {
    using St = Step<HS>;
    const int grid = static_cast<int>((n_heads + St::kHeads - 1) / St::kHeads);
    rwkv6_step_kernel<T, HS><<<grid, St::kThreads, 0, stream>>>(
        rr, kk, vv, ww, u, s0, yy, sf, static_cast<int>(n_heads), H);
    return cudaGetLastError();
  }
  using Tm = Team<T, HS>;
  const int Cp = (C + 15) & ~15;
  const int team_bytes = Tm::floats(Cp) * 4;
  int teams = kSmemMax / team_bytes;
  if (teams < 1) return cudaErrorInvalidValue;
  if (teams > Tm::kMaxTeams) teams = Tm::kMaxTeams;
  const int bytes = teams * team_bytes;
  // set on every launch: the attribute is per device, and cheap to set
  const cudaError_t err = cudaFuncSetAttribute(
      rwkv6_chunks_kernel<T, HS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>((n_heads + teams - 1) / teams);
  rwkv6_chunks_kernel<T, HS><<<grid, teams * Tm::kThreads, bytes, stream>>>(
      rr, kk, vv, ww, u, s0, yy, sf, S, H, C, static_cast<int>(n_heads),
      teams);
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
// aligned. hs in {8, 16, 32, 64}, 1 <= chunk <= 64, chunk <= S; S == 1 runs
// the decode form. Launches on `stream` and returns cudaGetLastError() (0
// on success).
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
    return dispatch<bf16>(r, k, v, w, uf, s0f, y, sff, B, S, H, hs, chunk,
                          st);
  return cudaErrorInvalidValue;
}
