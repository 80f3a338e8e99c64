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


def _rwkv_name(form, dtype, hs):
    t = "f" if dtype == "float32" else "13__nv_bfloat16"
    return (f"_ZN75_GLOBAL__N__a1b2_19rwkv6_{form}_kernelI{t}Li{hs}EEEvPKT_"
            f"S3_S3_S3_PKfS5_PS1_Pfiiiii")


def _rwkv_logs(no_hmma=()):
    """A build log and a SASS listing of the 16 rwkv6_scan instantiations;
    the prefill (chunks) ones hold HMMA except those in ``no_hmma``."""
    log, sass = [], ["\tcode for sm_90a"]
    for form in ("chunks", "step"):
        for dtype in ("float32", "bfloat16"):
            for hs in (8, 16, 32, 64):
                fn = _rwkv_name(form, dtype, hs)
                log += [f"ptxas info    : Compiling entry function '{fn}' "
                        f"for 'sm_90a'",
                        f"ptxas info    : Function properties for {fn}",
                        "    0 bytes stack frame, 0 bytes spill stores, "
                        "0 bytes spill loads",
                        f"ptxas info    : Used {hs + 40} registers"]
                sass.append(f"\t\tFunction : {fn}")
                if form == "chunks" and (dtype, hs) not in no_hmma:
                    sass.append("        /*0090*/                   HMMA.1688"
                                ".F32.TF32 R24, R4, R12, R24 ;")
                sass.append("        /*00a0*/                   EXIT ;")
    return "\n".join(log), "\n".join(sass)


def test_instantiation_report_names_each_instantiation():
    import re
    log, sass = _rwkv_logs()
    got = build.instantiation_report(
        build.parse_ptxas(log), build.parse_sass_counts(sass, "HMMA"),
        re.compile(r"rwkv6_(chunks|step)_kernelI(f|13__nv_bfloat16)Li(\d+)E"),
        lambda m: f"{m.group(1)}/{m.group(2)}/{m.group(3)}")
    assert len(got) == 16 and list(got) == sorted(got)
    assert got["chunks/f/64"] == {"stack_frame": 0, "spill_stores": 0,
                                  "spill_loads": 0, "registers": 104,
                                  "hmma": 1}
    assert got["step/13__nv_bfloat16/8"]["hmma"] == 0
    unread = build.instantiation_report(build.parse_ptxas(log), None,
                                        re.compile(r"step_kernelIfLi8E"),
                                        lambda m: m.group(0))
    assert unread == {"step_kernelIfLi8E": {
        "stack_frame": 0, "spill_stores": 0, "spill_loads": 0,
        "registers": 48, "hmma": None}}


@pytest.fixture
def chip_smoke(monkeypatch):
    import sys
    from pathlib import Path
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke as module
    yield module
    sys.modules.pop("chip_smoke", None)


def test_rwkv_build_report_gates_prefill_on_tensor_cores(chip_smoke,
                                                          monkeypatch,
                                                          tmp_path):
    lib = tmp_path / "rwkv6_scan_0123.so"

    def report(no_hmma=()):
        log, sass = _rwkv_logs(no_hmma)
        lib.with_suffix(".log").write_text(log)
        monkeypatch.setattr(build, "sass_counts",
                            lambda library, opcode:
                            build.parse_sass_counts(sass, opcode))
        return chip_smoke.build_report("rwkv6_scan", lib)

    got = report()
    assert got["sass_read"] and len(got["instantiations"]) == 16
    assert got["instantiations"]["prefill/float32/hs64"]["hmma"] == 1
    assert got["instantiations"]["decode/bfloat16/hs16"]["hmma"] == 0
    with pytest.raises(AssertionError, match="prefill/float32/hs16"):
        report(no_hmma={("float32", 16)})
    lib.with_suffix(".log").write_text(_rwkv_logs()[0].split(
        "ptxas info    : Compiling entry function")[0])
    with pytest.raises(AssertionError, match="expected 16"):
        chip_smoke.build_report("rwkv6_scan", lib)
