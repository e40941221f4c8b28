"""The port's kernel build module (``tpu_dist_torch.ops._build``): where a source
builds to, and what makes it build again. No ``nvcc`` is needed: only the
content hash in the library's name is computed."""

import functools
import pathlib

import pytest
import torch_ranks  # noqa: F401  (one torch thread in this process)

import chip_smoke
from tpu_dist_torch.ops import _build

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _csrc(tmp_path, monkeypatch, files):
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


def test_an_edited_header_changes_the_library_path(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch, {
        "a.cu": '#include "common.cuh"\n', "common.cuh": "constexpr int X = 1;\n",
    })
    first = _build.library_path("a")
    assert first == _build.library_path("a")  # stable while nothing changes
    assert first.name.startswith("liba-") and first.suffix == ".so"
    (csrc / "common.cuh").write_text("constexpr int X = 2;\n")
    second = _build.library_path("a")
    assert second != first
    (csrc / "a.cu").write_text('#include "common.cuh"\n// edited\n')
    assert _build.library_path("a") not in (first, second)


def test_a_new_header_changes_the_library_path(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch, {"a.cu": "int f();\n"})
    before = _build.library_path("a")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path("a") != before


def test_the_smoke_run_reads_registers_and_spills_per_kernel():
    log = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_111dkdv_kernelIffLi64EEEvPKT_S3_S3_S3_PKfS5_S5_PT0_S7_iifi' "
        "for 'sm_90a'\n"
        "    24 bytes stack frame, 28 bytes spill stores, 36 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z16fused_sgd_kernelPKxiPKfff' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 31 registers, used 0 barriers\n"
    )
    (dkdv, regs, spill), (sgd, regs2, spill2) = chip_smoke._ptxas_entries(log)
    assert "dkdv_kernel" in dkdv and (regs, spill) == (128, 28)
    assert "fused_sgd_kernel" in sgd and (regs2, spill2) == (31, 0)


def test_the_smoke_run_knows_every_kernel_source():
    """``chip_smoke.phase_build`` refuses a source it has no entry for."""
    stems = sorted(p.stem for p in (ROOT / "tpu_dist_torch" / "csrc").glob("*.cu"))
    assert sorted(chip_smoke.KERNELS) == stems
    for name, entry in chip_smoke.KERNELS.items():
        assert entry["source"] == f"tpu_dist_torch/csrc/{name}.cu"
        assert (ROOT / entry["source"]).exists()
        path, line = entry["replaces"].split(":")
        assert "pallas_call" in (ROOT / path).read_text().splitlines()[int(line) - 1]


SASS = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,8]
host = linux
compile_size = 64bit

\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_120flash_fwd_mma_kernelIfLi64EEEvPK13__nv_bfloat16S3_S3_PT_PfS7_ifi
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0350*/                   HMMA.16816.F32.BF16 R24, R4, R20, R24 ;
        /*0360*/                   HMMA.16816.F32.BF16 R28, R4, R22, R28 ;
        /*0370*/                   LDSM.16.MT88.4 R8, [R3] ;
        /*0380*/                   HMMA.16816.F32.BF16 R32, R8, R20, R32 ;
\t\t..........

\t\tFunction : _ZN12_GLOBAL__N_116flash_fwd_kernelIffLi64EEEvPKT_S3_S3_PT0_PfS6_ifi
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   FFMA R2, R4, R5, R2 ;
\t\t..........

\t\tFunction : _Z11gemm_kernelv
        /*0100*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24 ;
        /*0110*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24, gsb0 ;
        /*0120*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
"""


def test_the_smoke_run_counts_tensor_core_instructions_per_kernel():
    counts = chip_smoke._sass_tensor_core_counts(SASS)
    assert len(counts) == 3
    by_kernel = {next(k for k in ("flash_fwd_mma_kernel", "flash_fwd_kernel", "gemm_kernel")
                      if k in name): ops for name, ops in counts.items()}
    assert by_kernel["flash_fwd_mma_kernel"] == {"HMMA": 3, "HGMMA": 0}
    assert by_kernel["flash_fwd_kernel"] == {"HMMA": 0, "HGMMA": 0}
    assert by_kernel["gemm_kernel"] == {"HMMA": 0, "HGMMA": 2}


def _instances(f32, hmma_of_f32, mma, hmma_of_mma):
    """A library's kernel instances: 8 of the f32 route's kernel ``f32`` and
    8 of the bf16 tensor-core kernel ``mma``, with the given HMMA counts."""
    counts = {f"{f32}<float, {d}>": {"HMMA": n, "HGMMA": 0} for d, n in enumerate(hmma_of_f32)}
    counts.update({f"{mma}<float, {d}>": {"HMMA": n, "HGMMA": 0}
                   for d, n in enumerate(hmma_of_mma)})
    return counts


def test_the_smoke_run_fails_a_tensor_core_instance_without_tensor_core_code():
    """Every instance of the bf16 routes' kernels needs tensor-core code, and
    so does every instance of the forward's f32 (3xTF32) kernel; the f32
    backward kernels run on the CUDA cores and need none."""
    fwd = functools.partial(_instances, "flash_fwd_kernel", mma="flash_fwd_mma_kernel")
    check = chip_smoke._check_tensor_core_instances
    check("flash_attention_fwd", fwd([96] * 8, hmma_of_mma=[64] * 8))
    with pytest.raises(chip_smoke.SmokeError, match="no tensor-core instruction"):
        check("flash_attention_fwd", fwd([96] * 8, hmma_of_mma=[64] * 7 + [0]))
    with pytest.raises(chip_smoke.SmokeError, match="no tensor-core instruction"):
        check("flash_attention_fwd", fwd([96] * 7 + [0], hmma_of_mma=[64] * 8))
    with pytest.raises(chip_smoke.SmokeError, match="tensor-core instances"):
        check("flash_attention_fwd", fwd([96] * 8, hmma_of_mma=[64] * 7))
    dq = functools.partial(_instances, "dq_kernel", [0] * 8, "dq_mma_kernel")
    check("flash_attention_bwd_dq", dq([96] * 8))
    with pytest.raises(chip_smoke.SmokeError, match="no tensor-core instruction"):
        check("flash_attention_bwd_dq", dq([96] * 7 + [0]))


def test_the_shared_mma_header_is_hashed_into_both_libraries(tmp_path, monkeypatch):
    """Editing ``flash_attention_mma.cuh`` rebuilds the forward, the dK/dV
    and the dQ libraries (and, as every header does, the others)."""
    real = ROOT / "tpu_dist_torch" / "csrc"
    csrc = _csrc(tmp_path, monkeypatch, {
        p.name: p.read_text() for p in (*real.glob("*.cu"), *real.glob("*.cuh"))})
    users = [p.stem for p in real.glob("*.cu")
             if '#include "flash_attention_mma.cuh"' in p.read_text()]
    assert sorted(users) == ["flash_attention_bwd_dkdv", "flash_attention_bwd_dq",
                             "flash_attention_fwd"]
    before = {name: _build.library_path(name) for name in users}
    header = csrc / "flash_attention_mma.cuh"
    header.write_text(header.read_text() + "// edited\n")
    for name in users:
        assert _build.library_path(name) != before[name]
