// flash_attention: causal grouped-query attention with an optional sliding
// window, for sm_90a, on the tensor cores through mma.sync.
//
// Replaces the Pallas TPU kernel flash_attention_pallas of
// src/repro/kernels/flash_attention/kernel.py (body _kernel): the same
// function, out[b, s, h] = softmax_t(q[b, s, h] . k[b, t, h // R] / sqrt(dh)
// over the live keys t) . v[b, t, h // R], with R = H / G, live meaning
// t <= s and, when window > 0, t > s - window. Masked scores are -1e30 and
// the denominator is floored at 1e-30, as in the reference; in bfloat16 the
// probabilities are rounded to v's type before p.v (the reference's
// p.astype(v.dtype)), with float32 sums throughout.
//
// What bounds it: operations. Per live (query, key) pair it does 4 dh
// operations (q.k and p.v) and reads nothing new, so at the serving shape
// (B = 8, S = 1024, H = 20, dh = 128) the causal half of the score matrix
// is 43 GFLOP against 336 MB of q, k, v and o.
//   * float32 runs as 3xTF32, the route of PyTorch's own float32 attention
//     (CUTLASS's OpMultiplyAddFastF32): each operand x is split into
//     big = rna(x) and small = rna(x - big), rna being cvt.rna.tf32.f32's
//     rounding (to 10 mantissa bits, nearest, ties away from zero), and each
//     product is three mma.sync.m16n8k8 TF32 products into the float32
//     accumulator: small.big, big.small, then big.big. The dropped
//     small.small term and the rounding of small leave about 2^-21 of each
//     product, far inside the reference's 2e-4 (tests/
//     test_torch_flash_tf32.py). Bound: 3 x 4 dh operations a pair at the
//     495 TFLOP/s TF32 rate, 0.261 ms at the serving shape; mma.sync alone
//     reaches about 320 TFLOP/s in TF32 on an H100 (mma_probe.py).
//   * bfloat16 runs on mma.sync.m16n8k16 (bf16 in, float32 sums), its K
//     and V fragments read by ldmatrix (.trans for V) and P packed to bf16
//     straight from the score fragments, whose layout is that of the next
//     product's A operand. Bound: bytes, 0.050 ms at that shape.
// The design (FlashAttention-2's, on mma.sync; no wgmma, TMA or warp
// specialisation):
//   * one block of kWarps warps per (head, batch row, query tile of
//     16 kWarps rows); each warp owns 16 query rows and works alone on
//     them. The query tile is the grid's slowest axis and runs backwards,
//     so every block of the heaviest tiles (the last, which see the most
//     keys) starts before any lighter one;
//   * the key loop visits only the live key tiles: up to the causal
//     diagonal, and from q0 - window + 1 when window > 0; a warp skips a
//     tile that is wholly dead for its 16 rows, and masks only the tiles
//     that are partly dead for them (the diagonal, the window's edge, the
//     ragged end of S), so interior tiles carry no mask;
//   * K and V tiles arrive by 16-byte cp.async.cg in a ring of two stages:
//     tile t + 1's copies are issued before tile t's products, one
//     wait_group and one barrier a tile. Rows at or past S are zero-filled,
//     so S need not be a multiple of the tile;
//   * k and v are split once: each thread splits the k and v chunks it
//     copied, as soon as its own copies land (before the tile's barrier),
//     big in place and small into a second ring. q stays as loaded and is
//     split at every tile, as P is (P once a tile, into registers): q's
//     big halves held in registers for the whole loop left too few for
//     the sums below, and the kernel spilled. rna is done in two integer
//     operations (half a TF32 ulp added to the bits, the 13 low bits
//     cleared): the instruction's rounding for every finite x
//     (mma_probe.py compares the two over all 2^32 bit patterns), and
//     cheaper than it;
//   * shared-memory rows are padded so that every fragment read is free of
//     bank conflicts (below, per layout);
//   * float32 sums are kept out of the tensor cores' accumulators, which
//     truncate (mma_3xtf32): each q.k chain of 32 columns of dh and each
//     p.v chain of a key tile's 32 keys (12 products) starts from zero and
//     is added to its score or output with a float32 add. Kept in the
//     accumulators over all dh and every key, the sums drifted to 8-10x
//     float32's error against float64 on mixtral-8x22b's layer inputs
//     (attention_witness.py); chip_smoke.py's attention phase holds the
//     kernel to F64_RATIO times plain float32's;
//   * scores, the running max and sum and the output stay in registers in
//     the mma's accumulator layout; a row's max is reduced over the 4
//     lanes that share it; the sum is kept per lane and reduced once at
//     the end. Exponentials are exp2 of scores prescaled by log2(e).
// Layouts in float32. The k order of a TF32 mma is free, since a dot
// product does not depend on the order of its terms, and the kernel uses
// that twice:
//   * q.k: within each 16 columns of dh, lane t4 (= lane % 4) feeds k
//     slots t4 and t4 + 4 of one step with columns 4 t4 and 4 t4 + 1, and
//     of the next step with 4 t4 + 2 and 4 t4 + 3, so q and k fragments
//     are single 16-byte reads;
//   * p.v: the score fragment holds keys 2 t4 and 2 t4 + 1 of each 8, and
//     is used as it stands as the A operand, its two keys fed to k slots
//     t4 and t4 + 4; v's rows are read in the same order (keys 2 t4,
//     2 t4 + 1), so P never moves between lanes;
//   * v's columns are permuted the same way in n: output tile j's column
//     n maps to dh column (j / W) 8 W + n W + j % W (W = min(4, dh / 8)),
//     so a lane's v fragments for W tiles are one vector read, and a
//     lane's outputs are runs of 2 W columns, stored as whole vectors.
// The block shape (8 warps and 32 keys a tile in float32, 4 warps and 32
// keys in bfloat16) was the fastest of those timed at the serving shape.
// The float32 stage at dh = 128 (q, two k/v stages and their small halves)
// is 210 KB; the launch raises the dynamic shared-memory limit with
// cudaFuncSetAttribute on every launch (the attribute is per device).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNegInf = -1e30f;

// ---- shapes -------------------------------------------------------------

template <typename T, int DH>
struct Tile;

template <int DH>
struct Tile<float, DH> {
  static constexpr int kWarps = 8;
  static constexpr int kBK = 32;
  // q and k fragments are 16-byte reads of rows g and g + 1 by lanes 0-7
  // (and so on): a row stride of 16 mod 32 words keeps them apart
  static constexpr int kLDQ = DH % 32 == 0 ? DH + 16 : DH;
  static constexpr int kLDK = kLDQ;
  // v fragments are vector reads of rows 2 t4 at columns 4 g: 4 mod 32
  // words apart
  static constexpr int kLDV = DH + 4;
  // the small halves of the ring's two stages
  static constexpr int kSmallWords = 2 * kBK * (kLDK + kLDV);
};

template <int DH>
struct Tile<bf16, DH> {
  static constexpr int kWarps = 4;
  static constexpr int kBK = 32;
  // ldmatrix reads 8 rows of 16 bytes: rows 16 mod 128 bytes apart
  static constexpr int kLDQ = DH + 8;
  static constexpr int kLDK = DH + 8;
  static constexpr int kLDV = DH + 8;
  static constexpr int kSmallWords = 0;
};

template <typename T, int DH>
constexpr int smem_bytes() {
  using Tr = Tile<T, DH>;
  return static_cast<int>(sizeof(T)) *
             (16 * Tr::kWarps * Tr::kLDQ + 2 * Tr::kBK * (Tr::kLDK + Tr::kLDV)) +
         4 * Tr::kSmallWords;
}

// ---- PTX ----------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes if !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// cvt.rna.tf32.f32's rounding of a finite x in two integer operations:
// half a TF32 ulp added to the bits, the 13 low bits cleared (NaNs may
// come out otherwise; mma_probe.py)
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

// d += a.b in 3xTF32, the small terms first. The float32 sum inside
// mma.sync is not rounded to nearest: the products are aligned to the
// largest term (d's or a product's) with two bits below its last place,
// each cut toward zero, and the sum cut toward zero again (mma_probe.py,
// fact 4). A long sum kept in the accumulator therefore drifts toward
// zero by up to an ulp of itself at every step. So the callers start each
// short chain from zero (mma_3xtf32_zero: 32 columns of dh in q.k, a key
// tile's 32 keys in p.v) and add it to their running float32 sums with an
// ordinary add, rounded to nearest: the error is then about that of
// float32's own sums.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(d, a_small, b_big[0], b_big[1]);
  mma_tf32(d, a_big, b_small[0], b_small[1]);
  mma_tf32(d, a_big, b_big[0], b_big[1]);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[N]) {
  static_assert(N == 2 || N == 4, "vector of 2 or 4 floats");
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  }
}

// ---- tiles --------------------------------------------------------------

// Copy rows [0, kRows) of a (rows, DH) slab whose consecutive rows are
// `stride` elements apart into shared memory rows kLD elements apart, 16
// bytes per cp.async; rows at or past n_valid are zero-filled.
template <typename T, int DH, int kRows, int kLD, int kThreads>
__device__ __forceinline__ void copy_tile(T* sm, const T* g, long long stride,
                                          int n_valid) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kChunks = DH / kVec;   // 16-byte chunks a row
  constexpr int kAll = kRows * kChunks;
#pragma unroll
  for (int it = 0; it < (kAll + kThreads - 1) / kThreads; ++it) {
    const int i = it * kThreads + static_cast<int>(threadIdx.x);
    if (kAll % kThreads != 0 && i >= kAll) break;
    const int r = i / kChunks;
    const int c = (i % kChunks) * kVec;
    const bool ok = r < n_valid;
    cp_async16(sm + r * kLD + c, g + (ok ? r : 0) * stride + c, ok);
  }
}

// Split the chunks copy_tile had this thread copy into big (in place) and
// small (at the same offset in `small`).
template <int DH, int kRows, int kLD, int kThreads>
__device__ __forceinline__ void split_tile(float* sm, float* small) {
  constexpr int kChunks = DH / 4;
  constexpr int kAll = kRows * kChunks;
#pragma unroll
  for (int it = 0; it < (kAll + kThreads - 1) / kThreads; ++it) {
    const int i = it * kThreads + static_cast<int>(threadIdx.x);
    if (kAll % kThreads != 0 && i >= kAll) break;
    const int off = (i / kChunks) * kLD + (i % kChunks) * 4;
    float x[4], b[4], r[4];
    load_vec(sm + off, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t bb, ss;
      split(x[e], bb, ss);
      b[e] = __uint_as_float(bb);
      r[e] = __uint_as_float(ss);
    }
    *reinterpret_cast<float4*>(sm + off) = make_float4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<float4*>(small + off) =
        make_float4(r[0], r[1], r[2], r[3]);
  }
}

// One tile's online softmax for the lane's two rows (row0, row0 + 8): mask
// (when asked), scale to log2 units, new running max, the probabilities in
// place of the scores, the lane's part of the running sum, and the factor
// the output rows are rescaled by.
template <int kNT>
__device__ __forceinline__ void softmax_tile(float (&s)[kNT][4], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             bool need_mask, int row0,
                                             int key0, int window,
                                             float scale_log2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * scale_log2;
      if (need_mask) {
        const int row = row0 + 8 * (e >> 1);
        const int key = key0 + 8 * j + (e & 1);
        if (key > row || (window > 0 && key <= row - window)) x = kNegInf;
      }
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = exp2f(m[r] - mx[r]);
    m[r] = mx[r];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2f(s[j][e] - m[e >> 1]);
      rs[e >> 1] += s[j][e];
    }
  l[0] = l[0] * corr[0] + rs[0];
  l[1] = l[1] * corr[1] + rs[1];
}

// d = a.b in 3xTF32 from zero (the first product's C operand is 0: no
// register to clear)
__device__ __forceinline__ void mma_3xtf32_zero(float (&d)[4],
                                                const uint32_t (&a_big)[4],
                                                const uint32_t (&a_small)[4],
                                                const uint32_t (&b_big)[2],
                                                const uint32_t (&b_small)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a_small[0]), "r"(a_small[1]), "r"(a_small[2]), "r"(a_small[3]),
        "r"(b_big[0]), "r"(b_big[1]), "f"(0.f));
  mma_tf32(d, a_big, b_small[0], b_small[1]);
  mma_tf32(d, a_big, b_big[0], b_big[1]);
}

// ---- the products, float32 (3xTF32) --------------------------------------

// N operand values at `off` as big and small halves, from the big and
// small rings.
template <int N>
__device__ __forceinline__ void tf32_frag(const float* big, const float* small,
                                          int off, uint32_t (&b)[N],
                                          uint32_t (&r)[N]) {
  float x[N], y[N];
  load_vec(big + off, x);
  load_vec(small + off, y);
#pragma unroll
  for (int u = 0; u < N; ++u) {
    b[u] = __float_as_uint(x[u]);
    r[u] = __float_as_uint(y[u]);
  }
}

// s (16 rows x kBK keys) = q . k^T. Qw is the warp's 16 rows of q, split
// here as they are read. A lane reads rows g, g + 8 at columns
// 16 c + 4 t4 .. + 3 of every 16.
template <int DH, int kNT, int kLDQ, int kLDK>
__device__ __forceinline__ void scores_f32(
    float (&s)[kNT][4], const float* Qw,
    const float* Ks, const float* Ksm, int g, int t4) {
  // each chain: kP steps of 16 columns (see mma_3xtf32)
  constexpr int kP = DH / 16 < 2 ? DH / 16 : 2;
  float parts[kNT][4];
#pragma unroll
  for (int c = 0; c < DH / 16; ++c) {
    uint32_t qb[2][4], qs[2][4];   // rows g, g + 8: columns 4 t4 .. + 3
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float y[4];
      load_vec(Qw + (g + 8 * r) * kLDQ + 16 * c + 4 * t4, y);
#pragma unroll
      for (int e = 0; e < 4; ++e) split(y[e], qb[r][e], qs[r][e]);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      uint32_t kb[4], ks[4];
      tf32_frag(Ks, Ksm, (8 * j + g) * kLDK + 16 * c + 4 * t4, kb, ks);
      float (&part)[4] = parts[j];
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        // k slots t4, t4 + 4 take columns 4 t4 + 2 st and + 1
        const uint32_t ab[4] = {qb[0][2 * st], qb[1][2 * st],
                                qb[0][2 * st + 1], qb[1][2 * st + 1]};
        const uint32_t as[4] = {qs[0][2 * st], qs[1][2 * st],
                                qs[0][2 * st + 1], qs[1][2 * st + 1]};
        const uint32_t bb[2] = {kb[2 * st], kb[2 * st + 1]};
        const uint32_t bs[2] = {ks[2 * st], ks[2 * st + 1]};
        if (st == 0 && c % kP == 0) mma_3xtf32_zero(part, ab, as, bb, bs);
        else mma_3xtf32(part, ab, as, bb, bs);
      }
      if (c % kP == kP - 1)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += part[e];
    }
  }
}

// acc (16 rows x DH, columns permuted as in the note) += p . v
template <int DH, int kNT, int kLDV>
__device__ __forceinline__ void pv_f32(float (&acc)[DH / 8][4],
                                       const float (&p)[kNT][4],
                                       const float* Vs, const float* Vsm,
                                       int g, int t4) {
  constexpr int kW = DH / 8 < 4 ? DH / 8 : 4;
  uint32_t pbig[kNT][4], psmall[kNT][4];
#pragma unroll
  for (int st = 0; st < kNT; ++st) {
    // A operand values: rows g, g + 8 at k slots t4, t4 + 4, which hold
    // keys 2 t4, 2 t4 + 1: the score layout
    const float a[4] = {p[st][0], p[st][2], p[st][1], p[st][3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) split(a[e], pbig[st][e], psmall[st][e]);
  }
#pragma unroll
  for (int i = 0; i < DH / (8 * kW); ++i) {
    // these 8 kW columns' part of the tile's p . v, from zero
    float part[kW][4];
#pragma unroll
    for (int st = 0; st < kNT; ++st) {
      const int vrow0 = 8 * st + 2 * t4, vrow1 = vrow0 + 1;
      const uint32_t (&pb)[4] = pbig[st];
      const uint32_t (&ps)[4] = psmall[st];
      uint32_t b0[kW], s0[kW], b1[kW], s1[kW];
      tf32_frag(Vs, Vsm, vrow0 * kLDV + 8 * kW * i + kW * g, b0, s0);
      tf32_frag(Vs, Vsm, vrow1 * kLDV + 8 * kW * i + kW * g, b1, s1);
#pragma unroll
      for (int u = 0; u < kW; ++u) {
        const uint32_t bb[2] = {b0[u], b1[u]};
        const uint32_t bs[2] = {s0[u], s1[u]};
        if (st == 0) mma_3xtf32_zero(part[u], pb, ps, bb, bs);
        else mma_3xtf32(part[u], pb, ps, bb, bs);
      }
    }
#pragma unroll
    for (int u = 0; u < kW; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[kW * i + u][e] += part[u][e];
  }
}

// ---- the products, bfloat16 ----------------------------------------------

template <int DH, int kNT, int kLDK>
__device__ __forceinline__ void scores_bf16(float (&s)[kNT][4],
                                            const uint32_t (&qa)[DH / 16][4],
                                            const bf16* Ks, int lane) {
  // x4 matrices: keys +0..7 / cols +0..7, keys +0..7 / cols +8..15, then
  // keys +8..15 likewise: b0, b1 of two score tiles
  const int row = (lane & 7) + 8 * (lane >> 4);
  const int col = 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int c = 0; c < DH / 16; ++c)
#pragma unroll
    for (int jp = 0; jp < kNT / 2; ++jp) {
      uint32_t b[4];
      ldmatrix_x4(b, Ks + (16 * jp + row) * kLDK + 16 * c + col);
      mma_bf16(s[2 * jp], qa[c], b[0], b[1]);
      mma_bf16(s[2 * jp + 1], qa[c], b[2], b[3]);
    }
}

template <int DH, int kNT, int kLDV>
__device__ __forceinline__ void pv_bf16(float (&acc)[DH / 8][4],
                                        const float (&p)[kNT][4],
                                        const bf16* Vs, int lane) {
  // x4.trans matrices: keys +0..7 / cols +0..7, keys +8..15 / cols +0..7,
  // then cols +8..15 likewise: b0, b1 of two output tiles
  const int row = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int col = 8 * (lane >> 4);
#pragma unroll
  for (int ks = 0; ks < kNT / 2; ++ks) {
    // the score tiles 2 ks, 2 ks + 1 are this step's A operand as they stand
    const uint32_t a[4] = {pack_bf16(p[2 * ks][0], p[2 * ks][1]),
                           pack_bf16(p[2 * ks][2], p[2 * ks][3]),
                           pack_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1]),
                           pack_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3])};
#pragma unroll
    for (int jp = 0; jp < DH / 16; ++jp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, Vs + (16 * ks + row) * kLDV + 16 * jp + col);
      mma_bf16(acc[2 * jp], a, b[0], b[1]);
      mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// ---- the kernel ---------------------------------------------------------

template <typename T, int DH>
__global__ void __launch_bounds__(32 * Tile<T, DH>::kWarps)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int H, int G, int window, float scale_log2) {
  using Tr = Tile<T, DH>;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kThreads = 32 * Tr::kWarps;
  constexpr int kBQ = 16 * Tr::kWarps;
  constexpr int kBK = Tr::kBK;
  constexpr int kNT = kBK / 8;   // score tiles of 8 keys
  constexpr int kOT = DH / 8;    // output tiles of 8 columns
  constexpr int kStage = kBK * (Tr::kLDK + Tr::kLDV);
  static_assert(kBK % 16 == 0, "key tiles of whole 16s");

  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);
  T* ring = Qs + kBQ * Tr::kLDQ;
  float* small = reinterpret_cast<float*>(ring + 2 * kStage);   // float32

  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;   // heaviest first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (H / G);
  const long long q_row = static_cast<long long>(H) * DH;
  const long long kv_row = static_cast<long long>(G) * DH;
  const T* qb = q + (static_cast<long long>(b) * S * H + h) * DH;
  const T* kb = k + (static_cast<long long>(b) * S * G + kvh) * DH;
  const T* vb = v + (static_cast<long long>(b) * S * G + kvh) * DH;
  T* ob = o + (static_cast<long long>(b) * S * H + h) * DH;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;    // the lane's rows g, g + 8 of the warp's 16
  const int t4 = lane & 3;
  const int r0 = q0 + 16 * warp;

  const int q_last = min(q0 + kBQ, S) - 1;
  const int kt_end = q_last / kBK;
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  auto issue = [&](int kt) {
    T* Ks = ring + ((kt - kt_begin) & 1) * kStage;
    const int k0 = kt * kBK;
    copy_tile<T, DH, kBK, Tr::kLDK, kThreads>(Ks, kb + k0 * kv_row, kv_row,
                                              S - k0);
    copy_tile<T, DH, kBK, Tr::kLDV, kThreads>(Ks + kBK * Tr::kLDK,
                                              vb + k0 * kv_row, kv_row,
                                              S - k0);
    cp_async_commit();
  };
  // after the wait for tile kt: its big and small halves (float32), from
  // the chunks this thread copied
  auto split_own = [&](int kt) {
    if constexpr (kF32) {
      const int at = ((kt - kt_begin) & 1) * kStage;
      split_tile<DH, kBK, Tr::kLDK, kThreads>(ring + at, small + at);
      split_tile<DH, kBK, Tr::kLDV, kThreads>(ring + at + kBK * Tr::kLDK,
                                              small + at + kBK * Tr::kLDK);
    }
  };
  copy_tile<T, DH, kBQ, Tr::kLDQ, kThreads>(Qs, qb + q0 * q_row, q_row,
                                            S - q0);
  issue(kt_begin);
  cp_async_wait_all();
  split_own(kt_begin);
  __syncthreads();

  // bf16: the warp's q fragments, held in registers for the whole loop
  // (float32 reads its q from shared memory at every tile: registers)
  uint32_t qa[kF32 ? 1 : DH / 16][4];
  if constexpr (!kF32) {
    // x4 matrices: rows +0..7 / cols +0..7, rows +8..15 / cols +0..7, then
    // cols +8..15 likewise: a0..a3
    const int row = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
    const int col = 8 * (lane >> 4);
#pragma unroll
    for (int c = 0; c < DH / 16; ++c)
      ldmatrix_x4(qa[c], Qs + row * Tr::kLDQ + 16 * c + col);
  }

  float acc[kOT][4];
#pragma unroll
  for (int j = 0; j < kOT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    if (kt > kt_begin) {
      cp_async_wait_all();   // this lane's copies of tile kt have landed
      split_own(kt);
      __syncthreads();       // everyone's have, and tile kt - 1 is read
    }
    if (kt < kt_end) issue(kt + 1);   // into the stage tile kt - 1 left

    const int k0 = kt * kBK;
    // a tile wholly dead for the warp's 16 rows is skipped; one partly
    // dead is masked
    if (r0 >= S || k0 > r0 + 15 ||
        (window > 0 && k0 + kBK - 1 <= r0 - window))
      continue;
    const bool need_mask = k0 + kBK - 1 > r0 ||
                           (window > 0 && k0 <= r0 + 15 - window);
    const int at = ((kt - kt_begin) & 1) * kStage;
    const T* Ks = ring + at;
    const T* Vs = Ks + kBK * Tr::kLDK;

    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (kF32)
      scores_f32<DH, kNT, Tr::kLDQ, Tr::kLDK>(s, Qs + 16 * warp * Tr::kLDQ,
                                              Ks, small + at, g, t4);
    else
      scores_bf16<DH, kNT, Tr::kLDK>(s, qa, Ks, lane);

    float corr[2];
    softmax_tile<kNT>(s, m, l, corr, need_mask, r0 + g, k0 + 2 * t4, window,
                      scale_log2);
#pragma unroll
    for (int j = 0; j < kOT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];

    if constexpr (kF32)
      pv_f32<DH, kNT, Tr::kLDV>(acc, s, Vs, small + at + kBK * Tr::kLDK, g,
                                t4);
    else
      pv_bf16<DH, kNT, Tr::kLDV>(acc, s, Vs, lane);
  }

  // the row sums over the 4 lanes that share each row, then the output
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = ob + row * q_row;
    if constexpr (kF32) {
      // tile j's columns 2 t4, 2 t4 + 1 are dh columns (j / W) 8 W +
      // 2 t4 W + j % W and W further: runs of 2 W
      constexpr int kW = DH / 8 < 4 ? DH / 8 : 4;
#pragma unroll
      for (int i = 0; i < DH / (8 * kW); ++i) {
        float out[2 * kW];
#pragma unroll
        for (int u = 0; u < kW; ++u) {
          out[u] = acc[kW * i + u][2 * r] / denom;
          out[kW + u] = acc[kW * i + u][2 * r + 1] / denom;
        }
#pragma unroll
        for (int w = 0; w < 2 * kW; w += 4)
          *reinterpret_cast<float4*>(orow + 8 * kW * i + 2 * kW * t4 + w) =
              make_float4(out[w], out[w + 1], out[w + 2], out[w + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kOT; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t4) =
            __floats2bfloat162_rn(acc[j][2 * r] / denom,
                                  acc[j][2 * r + 1] / denom);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int G, int window,
                   cudaStream_t stream) {
  using Tr = Tile<T, DH>;
  constexpr int kBytes = smem_bytes<T, DH>();
  constexpr int kBQ = 16 * Tr::kWarps;
  const int n_q = (S + kBQ - 1) / kBQ;
  if (B > 65535 || n_q > 65535) return cudaErrorInvalidValue;
  // set on every launch: the attribute is per device, and cheap to set
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, n_q);
  const float scale_log2 =
      1.4426950408889634f / sqrtf(static_cast<float>(DH));
  flash_attention_kernel<T, DH><<<grid, 32 * Tr::kWarps, kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, G, window,
      scale_log2);
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
    return dispatch<bf16>(q, k, v, o, B, S, H, G, dh, window, st);
  return cudaErrorInvalidValue;
}
