"""The port's longitudinal archive (``obs/archive.py``: ``obs archive
ingest``, ``obs trend``, ``compare --against-archive``, ``hub --archive``)
against the JAX package's on the same synthetic artifacts
(``tests/obs_artifacts.py``, the shapes of ``tests/test_archive.py``): the
archive files byte for byte, the ingest, trend, blame, probe and gate
reports and their exit codes; ingest idempotent by fingerprint with the
stale re-emission flagged; the band's arithmetic; a dead detector exits 2.
"""

import json
import time

import pytest
import torch_ranks  # noqa: F401  (one torch thread)
from obs_artifacts import run_both, write_archive_inputs, write_hosts, write_jsonl

from tpu_dist.obs import archive as jax_archive
from tpu_dist_torch.obs import archive
from tpu_dist_torch.obs.export import MetricsExporter


@pytest.fixture
def inputs(tmp_path):
    return write_archive_inputs(tmp_path)


def _ingest_all(inputs, tmp_path, capsys):
    """Every input through both CLIs into ``<pkg>/archive.jsonl``, twice:
    the second pass appends nothing."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    arts = [inputs["bench"], inputs["wrap_ok"], inputs["wrap_empty"], inputs["mc_ok"],
            inputs["mc_skip"], inputs["report"], *inputs["histories"]]
    results = []
    for _ in range(2):
        results.append(run_both(capsys, lambda pkg: [
            "archive", "ingest", *arts, "--archive", str(tmp_path / pkg / "archive.jsonl")]))
    return results, {pkg: str(tmp_path / pkg / "archive.jsonl") for pkg in ("jax", "port")}


def _same(jax, port, paths):
    """Equal once each archive's path is the other's."""
    fix = lambda s: s.replace(paths["port"], paths["jax"])  # noqa: E731
    return jax == (port[0], fix(port[1]), fix(port[2]))


def test_ingest_is_jax_s_byte_for_byte_and_idempotent(inputs, tmp_path, capsys):
    (first, second), paths = _ingest_all(inputs, tmp_path, capsys)
    assert _same(*first, paths) and _same(*second, paths)
    assert first[1][0] == second[1][0] == 0
    with open(paths["jax"]) as a, open(paths["port"]) as b:
        assert a.read() == b.read()
    records, counts = archive.load_archive(paths["port"])
    assert "0 appended" in second[1][1] and "already archived (deduped)" in second[1][1]
    stale = [r for r in records if r["stale"]]
    # the self-declared stale record, the empty wrapper and the skipped
    # multichip probe; the byte-identical re-emission dedupes, not stale
    assert len(stale) == 3 and counts == {"bad_lines": 0, "skipped_schema": 0,
                                          "newer_schema": 0}
    assert {r["source"] for r in records} == {"bench", "driver_bench", "multichip", "report",
                                             "history"}
    assert [r["seq"] for r in records] == list(range(1, len(records) + 1))


@pytest.mark.parametrize("argv", [
    ["--blame"], ["--metric", "value"], ["--window", "4", "--format", "json"],
    ["--inject-regression"], ["--inject-regression", "--format", "json"]])
def test_trend_blame_and_probe_are_jax_s(inputs, tmp_path, capsys, argv):
    _, paths = _ingest_all(inputs, tmp_path, capsys)
    jax, port = run_both(capsys, lambda pkg: ["trend", paths[pkg], *argv])
    assert _same(jax, port, paths) and port[0] == 0
    if argv == ["--blame"]:
        # the step down at the sixth capture, blamed on its record
        assert "changepoint [regressed] at point 5: mean 1001.2 -> 900.5" in port[1]
        assert "fingerprint capture:testhost:run05:5.0" in port[1]


@pytest.mark.parametrize("cand,rc", [("worse", 1), ("same", 0)])
def test_a_history_gates_against_the_band_as_in_jax(inputs, tmp_path, capsys, cand, rc):
    _, paths = _ingest_all(inputs, tmp_path, capsys)
    for fmt in ("text", "json"):
        jax, port = run_both(capsys, lambda pkg: [
            "compare", inputs[cand], "--against-archive", paths[pkg], "--format", fmt])
        assert _same(jax, port, paths) and port[0] == rc


@pytest.mark.parametrize("cand,extra,rc", [
    ("cand_bench", [], 1), ("cand_good", [], 0), ("cand_stale", [], 2),
    ("cand_bench", ["--band-k", "300", "--band-window", "3"], 0)])
def test_a_bench_candidate_gates_as_in_jax(inputs, tmp_path, capsys, cand, extra, rc):
    _, paths = _ingest_all(inputs, tmp_path, capsys)
    jax, port = run_both(capsys, lambda pkg: [
        "compare", inputs[cand], "--against-archive", paths[pkg], "--bench", *extra])
    assert _same(jax, port, paths) and port[0] == rc


def test_the_gate_s_bad_invocations_exit_2_as_in_jax(inputs, tmp_path, capsys):
    _, paths = _ingest_all(inputs, tmp_path, capsys)
    empty = write_jsonl(tmp_path / "empty_archive.jsonl", [])
    for argv in (
            lambda pkg: ["compare", inputs["same"], inputs["same"], "--against-archive",
                         paths[pkg]],
            lambda pkg: ["compare", inputs["same"], "--against-archive", paths[pkg],
                         "--goodput"],
            lambda pkg: ["compare", inputs["same"], inputs["worse"], "--band-k", "2"],
            lambda pkg: ["compare", inputs["same"], "--against-archive", empty],
            lambda pkg: ["archive", "ingest", empty, "--archive", paths[pkg]],
            lambda pkg: ["archive", "ingest", str(tmp_path / "nope.json"),
                         "--archive", paths[pkg]],
            lambda pkg: ["trend", empty]):
        jax, port = run_both(capsys, argv)
        assert _same(jax, port, paths) and port[0] in (1, 2)


def test_the_band_math_and_the_changepoint_are_jax_s():
    recs = [archive._record("x", {"value": v}, f"f{i}", source="t", source_path="p")
            for i, v in enumerate([10.0, 11.0, 9.0, 10.5, 10.0])]
    band = archive.band_for(recs, "x", "value")
    assert band == jax_archive.band_for(recs, "x", "value")
    assert band == {"n": 5, "median": 10.0, "mad": 0.5}
    row = archive._gate_row("value", "x", "value", 8.0, recs, k=3.0, window=20,
                            rel_floor=0.05)
    assert row == jax_archive._gate_row("value", "x", "value", 8.0, recs, k=3.0, window=20,
                                        rel_floor=0.05)
    assert row["allowed"] == 1.5 and row["verdict"] == "REGRESSED"
    series = [100.0] * 6 + [80.0] * 6
    assert archive.detect_changepoint(series) == jax_archive.detect_changepoint(series)
    assert archive.detect_changepoint(series)["index"] == 6
    assert archive.detect_changepoint([5.0] * 12) is None


def test_a_dead_detector_exits_2(inputs, tmp_path, capsys, monkeypatch):
    _, paths = _ingest_all(inputs, tmp_path, capsys)
    monkeypatch.setattr(archive, "detect_changepoint", lambda *a, **k: None)
    monkeypatch.setattr(jax_archive, "detect_changepoint", lambda *a, **k: None)
    jax, port = run_both(capsys, lambda pkg: ["trend", paths[pkg], "--inject-regression"])
    assert _same(jax, port, paths) and port[0] == 2 and "changepoint dead" in port[1]


def test_hub_archive_appends_a_pod_record_a_pass(tmp_path, capsys, monkeypatch):
    """``obs hub --once --archive``: one ``pod`` record of the rollups a
    pass, the same record JAX's hub appends; the archive then gates and
    trends like any other."""
    monkeypatch.setattr(time, "time", lambda: 5000.0)
    files = write_hosts(tmp_path)
    prom = tmp_path / "tr.prom"
    MetricsExporter(textfile=str(prom)).update({"goodput.goodput_frac": 0.8}, force=True)

    def argv(pkg):
        return ["hub", "--once", "--run", f"tr={prom},hb={files['hb']}", "--out",
                str(tmp_path / f"{pkg}.prom"), "--archive", str(tmp_path / f"{pkg}.jsonl")]

    for _ in range(2):
        jax, port = run_both(capsys, argv)
        assert jax[0] == port[0] == 0
    recs = {pkg: archive.load_archive(str(tmp_path / f"{pkg}.jsonl"))[0]
            for pkg in ("jax", "port")}
    assert len(recs["port"]) == 2 and [r["seq"] for r in recs["port"]] == [1, 2]
    for a, b in zip(recs["jax"], recs["port"]):
        drop = lambda r: {k: v for k, v in r.items() if k != "source_path"}  # noqa: E731
        assert drop(a) == drop(b) and b["label"] == "pod" and b["source"] == "hub"
    snap = {"scrapes": 3, "drops": 1, "rollup": {
        "runs_aggregated": 2, "runs_dead": 1, "breach_count": 2, "total_chips": 8,
        "worst_stall_frac": 0.25, "goodput_by_kind": {"train": 0.9, "serve": 0.97}}}
    a = archive.append_hub_snapshot(str(tmp_path / "p2.jsonl"), dict(snap), now=123.0)
    b = jax_archive.append_hub_snapshot(str(tmp_path / "j2.jsonl"), dict(snap), now=123.0)
    assert {**a, "source_path": None} == {**b, "source_path": None}
    with open(tmp_path / "p2.jsonl") as f:
        assert json.loads(f.readline())["metrics"]["pod_goodput_frac_serve"] == 0.97
