"""The build helpers: how a library is named, and the readers of nvcc's and
cuobjdump's output, on samples of that output (the tools themselves exist
only where the card is)."""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

F32 = "_ZN75_GLOBAL__N__a1b2_22flash_attention_kernelIfLi128EEEvPKT_S3_S3_PS1_iiiif"
BF16 = ("_ZN75_GLOBAL__N__a1b2_22flash_attention_kernelI13__nv_bfloat16Li16EEEv"
        "PKT_S4_S4_PS2_iiiif")

PTXAS_LOG = f"""\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{F32}' for 'sm_90a'
ptxas info    : Function properties for {F32}
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 416 bytes cmem[0]
ptxas info    : Compiling entry function '{BF16}' for 'sm_90a'
ptxas info    : Function properties for {BF16}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 416 bytes cmem[0]
"""

SASS = f"""\

Fatbin elf code:
================
arch = sm_90a
code version = [1,8]
host = linux
compile_size = 64bit

\tcode for sm_90a
\t\tFunction : {F32}
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;            /* 0x00000a00ff017b82 */
        /*0090*/                   HMMA.1688.F32.TF32 R24, R4, R12, R24 ;  /* 0x0000000c0418723c */
        /*00a0*/               @P0 HMMA.1688.F32.TF32 R28, R4, R14, R28 ;  /* 0x0000000e041c023c */
        /*00b0*/                   FMUL R2, R2, 1.4426950216293334961 ; /* 0x3fb8aa3b02027820 */
\t\t..........

\t\tFunction : {BF16}
        /*0000*/                   HMMA.16816.F32.BF16 R8, R16, R20, R8 ;  /* 0x000000141008723c */
        /*0010*/                   EXIT ;                           /* 0x000000000000794d */
"""


def test_parse_ptxas_reads_registers_and_spills_per_kernel():
    got = build.parse_ptxas(PTXAS_LOG)
    assert got == {
        F32: {"stack_frame": 8, "spill_stores": 4, "spill_loads": 12,
              "registers": 255},
        BF16: {"stack_frame": 0, "spill_stores": 0, "spill_loads": 0,
               "registers": 96}}


def test_parse_sass_counts_one_opcode_per_function():
    assert build.parse_sass_counts(SASS, "HMMA") == {F32: 2, BF16: 1}
    assert build.parse_sass_counts(SASS, "EXIT") == {F32: 0, BF16: 1}
    assert build.parse_sass_counts(SASS, "HMMA.16816") == {F32: 0, BF16: 1}


def test_library_is_named_by_its_source(tmp_path):
    src = tmp_path / "flash_attention.cu"
    src.write_text("// one\n")
    first = build.library_path(src)
    assert first.parent == build.BUILD_DIR
    assert first.name.startswith("flash_attention_") and first.suffix == ".so"
    assert build.library_path(src) == first
    src.write_text("// two\n")
    assert build.library_path(src) != first
