"""The port's kernel build module (``tpu_dist_torch.ops._build``): where a source
builds to, and what makes it build again. No ``nvcc`` is needed: only the
content hash in the library's name is computed."""

import pathlib

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
