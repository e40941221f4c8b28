"""``python -m tpu_dist_torch.obs pod`` (``obs/aggregate.py``) against the JAX
package's ``obs pod`` on the same synthetic per-host histories, the
scheduler's log and heartbeat files (``tests/obs_artifacts.py``): the same
text and JSON reports (per-host goodput ledgers, elastic segments, fleet
moves and decision chains, the crash bundle, peak memory, captures,
serving, the epoch skew with its attribution, heartbeat liveness, the pod
goodput), the same merged Perfetto trace with the chip-ownership track,
and the same exit codes.
"""

import json
import time

import pytest
import torch_ranks  # noqa: F401  (one torch thread)
from obs_artifacts import host_records, run_both, scheduler_records, write_hosts, write_jsonl

from tpu_dist.obs import aggregate as jax_aggregate
from tpu_dist_torch.obs import aggregate


@pytest.fixture
def files(tmp_path):
    return write_hosts(tmp_path)


@pytest.mark.parametrize("fmt", ["text", "json"])
def test_the_pod_report_is_jax_s(files, capsys, monkeypatch, tmp_path, fmt):
    monkeypatch.setattr(time, "time", lambda: 5000.0)

    def argv(pkg):
        return ["pod", files["a"], files["b"], files["sched"], "--heartbeat", files["hb"],
                "--heartbeat", files["hb_gone"], "--trace-out", str(tmp_path / f"{pkg}.json"),
                "--format", fmt]

    jax, port = run_both(capsys, argv)
    assert port[0] == 0
    assert jax == (port[0], port[1].replace(str(tmp_path / "port.json"),
                                            str(tmp_path / "jax.json")), port[2])
    with open(tmp_path / "jax.json") as a, open(tmp_path / "port.json") as b:
        assert json.load(a) == json.load(b)
    if fmt == "text":
        out = port[1]
        assert "pod report — 3 host(s)" in out
        assert "<-- STRAGGLER" in out and "attribution: data_stall" in out
        assert "decision #1 [serve_breach]: tick 3 donate" in out
        assert "decision #2 [serve_release]" in out and "chain INCOMPLETE" in out
        assert f"POSTMORTEM on {files['b']}" in out
        assert f"heartbeat {files['hb']}: beat 42 at epoch 2 step 7 phase step, 10.0s old" in out
        assert f"heartbeat {files['hb_gone']}: absent" in out


def test_the_trace_has_a_track_a_host_and_the_chip_ownership_gantt(files):
    hosts = [(p, [json.loads(line) for line in open(files[p])]) for p in ("a", "b", "sched")]
    trace = aggregate.pod_trace(hosts)
    assert trace == jax_aggregate.pod_trace(hosts)
    names = [e["args"]["name"] for e in trace["traceEvents"]
             if e.get("name") == "process_name"]
    assert names == ["a", "b", "sched", "chip ownership (tenancy)"]
    gantt = [e for e in trace["traceEvents"] if e.get("cat") == "tenancy"]
    assert {"tr", "sv", "free", "pending"} <= {e["name"] for e in gantt}
    assert any(e["args"].get("decision_id") == 1 for e in gantt)
    # host b started 0.5 s after host a: its bars sit 0.5 s to the right
    a0 = min(e["ts"] for e in trace["traceEvents"] if e.get("pid") == 0 and e.get("ph") == "X")
    b0 = min(e["ts"] for e in trace["traceEvents"] if e.get("pid") == 1 and e.get("ph") == "X")
    assert b0 - a0 == pytest.approx(0.5e6, abs=1.0)


def test_pod_report_and_chains_as_objects():
    hosts = [("a", host_records("a", epoch_time=10.0, stall=0.05, frac=0.9)),
             ("b", host_records("b", epoch_time=35.0, stall=0.4, frac=0.6, crashed=True,
                                     peak=3 << 30)),
             ("sched", scheduler_records())]
    rep = aggregate.pod_report(hosts)
    assert rep == jax_aggregate.pod_report(hosts)
    assert [c["decision_id"] for c in rep["decision_chains"]] == [1, 2]
    assert [c["complete"] for c in rep["decision_chains"]] == [True, False]
    assert rep["pod"]["worst_goodput_host"] == rep["pod"]["worst_hbm_host"] == "b"
    assert aggregate.format_text(rep) == jax_aggregate.format_text(rep)


def test_unreadable_or_empty_logs_exit_like_jax(files, tmp_path, capsys):
    empty = write_jsonl(tmp_path / "empty.jsonl", [])
    for argv in (["pod", files["a"], str(tmp_path / "missing.jsonl")],
                 ["pod", files["a"], empty]):
        jax, port = run_both(capsys, lambda pkg: argv)
        assert jax == port and port[0] in (1, 2)
