"""``python -m tpu_dist_torch.obs tail`` (``obs/tail.py``) against the JAX
package's ``obs tail`` on the same synthetic histories
(``tests/obs_artifacts.py``): the same frames (the epoch table, every event
line, the heartbeat row and its age, the run's end) and the same exit
codes, through the CLI and through ``TailState`` at a fixed clock; the
follower's torn-tail and rotation handling.
"""

import time

import pytest
import torch_ranks  # noqa: F401  (one torch thread)
from obs_artifacts import host_records, run_both, write_hosts, write_jsonl

from tpu_dist.obs import heartbeat as jax_heartbeat
from tpu_dist.obs import tail as jax_tail
from tpu_dist_torch.obs import heartbeat, tail


@pytest.fixture
def files(tmp_path):
    return write_hosts(tmp_path)


@pytest.mark.parametrize("host", ["a", "b", "sched"])
def test_the_once_frame_and_exit_code_are_jax_s(files, capsys, monkeypatch, host):
    monkeypatch.setattr(time, "time", lambda: 5000.0)
    jax, port = run_both(capsys, lambda pkg: ["tail", files[host], "--once",
                                              "--heartbeat", files["hb"]])
    assert jax == port
    assert port[0] == 0 and "heartbeat: #42 epoch 2 step 7 phase 'step', age 10.0s" in port[1]


def test_the_frames_name_every_event(files, capsys, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 5100.0)  # a stale beat
    _, port = run_both(capsys, lambda pkg: ["tail", files["a"], "--once", "--rows", "2",
                                            "--heartbeat", files["hb"]])
    out = port[1]
    assert "STALE" in out and "run: clean exit" in out
    assert "GROWN from dp=4 (elastic), restart #1 [decision #1]" in out
    # 8 event lines kept on screen; 2 epochs in the rolling table
    events = [ln for ln in out.splitlines() if ln.startswith("  ") and ln[2] != " "]
    assert len(events) == tail.DEFAULT_EVENTS
    assert [ln.split()[0] for ln in out.splitlines()[2:4]] == ["1", "2"]
    _, crashed = run_both(capsys, lambda pkg: ["tail", files["b"], "--once"])
    assert "run: CRASHED — postmortem bundle left behind (/crash/b/postmortem.json)" in crashed[1]
    _, sched = run_both(capsys, lambda pkg: ["tail", files["sched"], "--once"])
    assert "tenancy VIOLATION: tick 5 accounts 10 of 11 chip(s)" in sched[1]


def test_an_empty_or_missing_log_exits_1(tmp_path, capsys):
    empty = write_jsonl(tmp_path / "empty.jsonl", [])
    for path in (empty, str(tmp_path / "missing.jsonl")):
        jax, port = run_both(capsys, lambda pkg: ["tail", path, "--once"])
        assert jax == port and port[0] == 1


def test_the_live_loop_returns_when_the_run_ends(tmp_path, capsys):
    path = write_jsonl(tmp_path / "run.jsonl", host_records("a", epoch_time=1.0, stall=0.0,
                                                            frac=0.5))
    jax, port = run_both(capsys, lambda pkg: ["tail", path, "--interval", "0.01"])
    assert jax == port and port[0] == 0


def test_tail_state_renders_as_jax_s_at_a_fixed_clock(files):
    records = host_records("a", epoch_time=10.0, stall=0.05, frac=0.9)
    frames = []
    for mod, hb in ((jax_tail, jax_heartbeat), (tail, heartbeat)):
        st = mod.TailState(rows=3, events=5)
        for i in range(0, len(records), 4):  # as polls would fold them
            st.add(records[i:i + 4])
        frames.append(st.render(hb.read(files["hb"]), now_wall=5061.5, bad_lines=2))
    assert frames[0] == frames[1]
    assert "2 torn line(s) skipped" in frames[1] and "age 71.5s — STALE" in frames[1]


def test_the_follower_reads_complete_lines_only_and_restarts_on_rotation(tmp_path):
    path = tmp_path / "live.jsonl"
    path.write_text('{"kind": "train_epoch", "epoch": 0}\n{"kind": "ev')
    for mod in (jax_tail, tail):
        f = mod.LogFollower(str(path))
        assert [r["epoch"] for r in f.poll()] == [0]
        assert f.poll() == []
    with open(path, "a") as fh:
        fh.write('al", "epoch": 0, "top1": 5.0}\nnot json\n')
    got = []
    for mod in (jax_tail, tail):
        f = mod.LogFollower(str(path))
        got.append((f.poll(), f.bad_lines))
    assert got[0] == got[1] and got[1][1] == 1 and got[1][0][1]["top1"] == 5.0
    f = tail.LogFollower(str(path))
    f.poll()
    path.write_text('{"kind": "eval", "epoch": 3}\n')  # a fresh run reusing the path
    assert [r["epoch"] for r in f.poll()] == [3]
