#!/usr/bin/env python3
"""Four facts about the tensor-core instructions flash_attention.cu and
rwkv6_scan.cu are built on, measured on one NVIDIA GPU.

    python3 mma_probe.py [--out build/mma_probe.jsonl]

1. The rate of ``mma.sync`` alone: warps that issue nothing but independent
   m16n8k8 TF32 or m16n8k16 bf16 products into 8 accumulators each, from
   registers, 4 blocks of 8 warps on each SM, timed between CUDA events.
   It is the ceiling of any kernel built on these instructions.
2. The kernel's TF32 rounding: flash_attention.cu rounds a float32 x to
   TF32 as (bits + 0x1000) & 0xffffe000 instead of cvt.rna.tf32.f32. Both
   are run on every one of the 2^32 bit patterns and their results
   compared, counted by class of x (normal, zero or subnormal, inf or
   NaN), with the smallest pattern that differs. The run fails if any
   finite x rounds differently.
3. What mma.sync TF32 does with a subnormal operand (rwkv6_scan's r_dec
   falls below float32's normal range where the decay is strong): one
   m16n8k8 product whose only nonzero A value is the subnormal 2^-130 and
   whose B values are 2^100, against the exact 2^-30; reported, not held
   to a limit (such terms are below 1e-9 of the scan's outputs).
4. How mma.sync TF32 rounds its float32 sum: one m16n8k8 product per
   case, d = c + sum of 8 products a_k . 1 with c = 1 and products of a
   fraction of c's ulp (2^-23), the result in units of that ulp beside
   the exact sum and its rounding to nearest. Reported, not held to a
   limit: flash_attention.cu starts each chain of products from zero
   because of what it shows.

One JSON object per line, also written to --out; the last line names the
card and its power limit. Without a CUDA device it exits 2.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int KIND>
__global__ void __launch_bounds__(256) mma_peak(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int e = 0; e < 4; ++e) a[e] = 0x3f800000u + threadIdx.x + e;
  b[0] = 0x3f800000u + threadIdx.x; b[1] = b[0] + 7;
  float d[8][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (KIND == 0)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  float t = 0.f;
  for (int j = 0; j < 8; ++j) t += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}

// per class of x (0 normal, 1 zero or subnormal, 2 inf or NaN): how many
// bit patterns round differently, and the smallest of them
__global__ void tf32_round_check(unsigned long long* count, uint32_t* first) {
  unsigned long long n[3] = {0, 0, 0};
  uint32_t lo[3] = {0xffffffffu, 0xffffffffu, 0xffffffffu};
  const uint64_t step = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = blockIdx.x * blockDim.x + threadIdx.x; i < (1ull << 32);
       i += step) {
    const uint32_t u = static_cast<uint32_t>(i);
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(__uint_as_float(u)));
    if (r != ((u + 0x1000u) & 0xffffe000u)) {
      const uint32_t e = (u >> 23) & 0xffu;
      const int c = e == 0xffu ? 2 : e == 0u ? 1 : 0;
      ++n[c];
      lo[c] = min(lo[c], u);
    }
  }
  for (int c = 0; c < 3; ++c)
    if (n[c]) {
      atomicAdd(count + c, n[c]);
      atomicMin(first + c, lo[c]);
    }
}

// one m16n8k8 TF32 product: A zero but a[0] of lane 0 (row 0, k 0) = a,
// B all = b; d[0] of lane 0 (row 0, column 0) = a b if a is kept
__global__ void tf32_subnormal(float a, float b, float* out) {
  const uint32_t av = threadIdx.x == 0 ? __float_as_uint(a) : 0u;
  const uint32_t bv = __float_as_uint(b);
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(av), "r"(0u), "r"(0u), "r"(0u), "r"(bv), "r"(bv));
  if (threadIdx.x == 0) out[0] = d[0];
}

// case i: d[0] of lane 0 (row 0, column 0) = c[i] + sum_k a[8 i + k] . 1
// through one m16n8k8 TF32 product (lanes 0-3 hold row 0's k values)
__global__ void tf32_accumulate(const float* a, const float* c, float* out) {
  const int i = blockIdx.x, lane = threadIdx.x, t4 = lane & 3;
  uint32_t av[4] = {0u, 0u, 0u, 0u};
  if (lane < 4) {
    av[0] = __float_as_uint(a[8 * i + t4]);
    av[2] = __float_as_uint(a[8 * i + t4 + 4]);
  }
  const uint32_t one = __float_as_uint(1.0f);
  float d[4] = {lane == 0 ? c[i] : 0.f, 0.f, 0.f, 0.f};
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(av[0]), "r"(av[1]), "r"(av[2]), "r"(av[3]), "r"(one), "r"(one));
  if (lane == 0) out[i] = d[0];
}

extern "C" int tf32_accumulate_launch(int n, const float* a, const float* c,
                                      float* out, void* stream) {
  tf32_accumulate<<<n, 32, 0, static_cast<cudaStream_t>(stream)>>>(a, c, out);
  return cudaGetLastError();
}

extern "C" int tf32_subnormal_launch(float a, float b, float* out,
                                     void* stream) {
  tf32_subnormal<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(a, b, out);
  return cudaGetLastError();
}

extern "C" int mma_peak_launch(int kind, int blocks, int iters, float* out,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) mma_peak<0><<<blocks, 256, 0, st>>>(out, iters);
  else mma_peak<1><<<blocks, 256, 0, st>>>(out, iters);
  return cudaGetLastError();
}

extern "C" int tf32_round_check_launch(int blocks, unsigned long long* count,
                                       uint32_t* first, void* stream) {
  tf32_round_check<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      count, first);
  return cudaGetLastError();
}
"""

CLASSES = ("normal", "zero_or_subnormal", "inf_or_nan")


def mma_peak_tflops(lib, torch) -> dict:
    """TFLOP/s of mma.sync alone: TF32 m16n8k8 and bf16 m16n8k16."""
    fn = lib.mma_peak_launch
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    blocks = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(blocks * 256, device="cuda")
    iters = 4096
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for kind, name, flop in ((0, "tf32_m16n8k8", 2 * 16 * 8 * 8),
                             (1, "bf16_m16n8k16", 2 * 16 * 8 * 16)):
        for _ in range(2):
            if fn(kind, blocks, iters, out.data_ptr(), stream):
                raise RuntimeError("mma_peak: launch failed")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            fn(kind, blocks, iters, out.data_ptr(), stream)
        end.record()
        torch.cuda.synchronize()
        sec = start.elapsed_time(end) / 5 / 1e3
        rates[name] = blocks * 8 * iters * 8 * flop / sec / 1e12
    return rates


def tf32_round_check(lib, torch) -> dict:
    """The integer rounding against cvt.rna.tf32.f32 over all 2^32 bit
    patterns: per class of x, the patterns that differ and the first."""
    fn = lib.tf32_round_check_launch
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    count = torch.zeros(3, dtype=torch.int64, device="cuda")
    first = torch.full((3,), -1, dtype=torch.int32, device="cuda")
    blocks = 8 * torch.cuda.get_device_properties(0).multi_processor_count
    if fn(blocks, count.data_ptr(), first.data_ptr(),
          torch.cuda.current_stream().cuda_stream):
        raise RuntimeError("tf32_round_check: launch failed")
    torch.cuda.synchronize()
    return {c: {"differ": int(n),
                "first": None if n == 0 else f"0x{int(f) & 0xffffffff:08x}"}
            for c, n, f in zip(CLASSES, count.tolist(), first.tolist())}


def tf32_subnormal(lib, torch) -> dict:
    """One mma.sync TF32 product of the subnormal 2^-130 and 2^100."""
    fn = lib.tf32_subnormal_launch
    fn.argtypes = [ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros(1, device="cuda")
    a, b = 2.0 ** -130, 2.0 ** 100
    if fn(a, b, out.data_ptr(), torch.cuda.current_stream().cuda_stream):
        raise RuntimeError("tf32_subnormal: launch failed")
    got = out.item()
    return {"a": a, "b": b, "exact": a * b, "got": got,
            "subnormal_kept": got == a * b, "flushed": got == 0.0}


# (name, c, the 8 products in units of c's ulp 2^-23); every value is a
# TF32 value, so each product a . 1 is exact
ACCUMULATE_CASES = (
    ("one product of 0.75 ulp", 1.0, (0.75,)),
    ("one product of 1.5 ulp", 1.0, (1.5,)),
    ("one product of -0.1875 ulp", 1.0, (-0.1875,)),
    ("eight products of 0.25 ulp", 1.0, (0.25,) * 8),
    ("eight products of 0.125 ulp", 1.0, (0.125,) * 8),
)


def tf32_accumulate(lib, torch) -> dict:
    """mma.sync TF32's float32 sum on ACCUMULATE_CASES: each result, the
    exact sum and its rounding to nearest, less c, in units of c's ulp."""
    fn = lib.tf32_accumulate_launch
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    ulp = 2.0 ** -23
    a = torch.tensor([[x * ulp for x in prods] + [0.0] * (8 - len(prods))
                      for _, _, prods in ACCUMULATE_CASES],
                     dtype=torch.float32, device="cuda")
    c = torch.tensor([cc for _, cc, _ in ACCUMULATE_CASES],
                     dtype=torch.float32, device="cuda")
    out = torch.zeros(len(ACCUMULATE_CASES), device="cuda")
    if fn(len(ACCUMULATE_CASES), a.data_ptr(), c.data_ptr(), out.data_ptr(),
          torch.cuda.current_stream().cuda_stream):
        raise RuntimeError("tf32_accumulate: launch failed")
    cases = []
    for (name, cc, prods), got in zip(ACCUMULATE_CASES, out.tolist()):
        exact = cc + sum(prods) * ulp           # exact in float64
        nearest = float(torch.tensor(exact, dtype=torch.float64).float())
        cases.append({"case": name, "got": (got - cc) / ulp,
                      "exact": (exact - cc) / ulp,
                      "nearest": (nearest - cc) / ulp})
    return {"cases": cases,
            "rounds_to_nearest": all(x["got"] == x["nearest"] for x in cases)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/mma_probe.jsonl")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mma_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.build import BUILD_DIR, build_libraries

    out_path = ROOT / args.out
    out_path.parent.mkdir(parents=True, exist_ok=True)
    sink = out_path.open("w")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        sink.write(line + "\n")

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / "mma_probe.cu"
    src.write_text(SRC)
    lib = ctypes.CDLL(str(build_libraries([src])[src]))
    emit({"phase": "mma_peak", "tflops": mma_peak_tflops(lib, torch)})
    rounding = tf32_round_check(lib, torch)
    emit({"phase": "tf32_rounding", "classes": rounding})
    emit({"phase": "tf32_subnormal", **tf32_subnormal(lib, torch)})
    emit({"phase": "tf32_accumulate", **tf32_accumulate(lib, torch)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    emit({"nvidia_smi": smi.stdout.strip().splitlines()[0],
          "device": torch.cuda.get_device_name(0)})
    sink.close()
    finite = rounding["normal"]["differ"] + rounding["zero_or_subnormal"]["differ"]
    return 1 if finite else 0


if __name__ == "__main__":
    sys.exit(main())
