"""The port launcher's watchdog (``tpu_dist_torch/cli/launch.py``) held
against the JAX launcher's (``tpu_dist/cli/launch.py``), the counterparts of
``tests/test_goodput.py:518,561`` and ``tests/test_flight.py:726``.

Each case runs the same stub child (a ``python -c`` script that beats
through the port's ``Heartbeat`` and then stops, or never beats) under
both launchers, with the same flags, and holds both to the contract:

* a worker whose beat stops is reported with its position and killed,
  and a worker that never beats counts as wedged;
* the watchdog stands down once a preemption shutdown has begun (exit 75);
* a wedge exits non-zero and never 75, even when the child answers the
  SIGTERM with a graceful 75;
* with ``--crash_dir`` the SIGUSR1 dump names the stuck frame, then the
  kill, then the postmortem bundle (``no-clean-exit``, the ring's last
  step) and its ``postmortem`` history record;
* the forensic flags reach every child, the files of ranks outside the
  world are swept at spawn, and ``--watchdog_timeout`` without
  ``--heartbeat_dir`` is a parser error.

One deliberate difference is held too: a beat left on disk by another
process never passes for the child's own (the port reads the beat's
``pid``; the JAX launcher reads the counter alone).
"""

import json
import os
import sys
import textwrap
import time

import pytest
import torch_ranks  # noqa: F401  (one torch thread in this process)

from tpu_dist.cli import launch as jax_launch
from tpu_dist_torch.cli import launch
from tpu_dist_torch.obs import flight

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAINS = {"port": launch.main, "jax": jax_launch.main}


def _stub(body: str) -> list:
    """``python -c`` of a child that reads the injected flags, with the
    port's heartbeat and flight ring at hand (they import no torch)."""
    head = textwrap.dedent(f"""
        import json, os, signal, sys, time
        sys.path.insert(0, {ROOT!r})
        from tpu_dist_torch.obs import flight
        from tpu_dist_torch.obs.heartbeat import Heartbeat, per_rank_path
        argv = sys.argv
        def flag(name):
            return argv[argv.index(name) + 1] if name in argv else None
        rank = int(flag('--process_id'))
        hb = Heartbeat(per_rank_path(flag('--heartbeat_file'), rank)) \\
            if flag('--heartbeat_file') else None
    """)
    return [sys.executable, "-c", head + textwrap.dedent(body)]


def _run(which, capsys, flags, body):
    t0 = time.monotonic()
    rc = MAINS[which](flags + ["--", *_stub(body)])
    return rc, time.monotonic() - t0, capsys.readouterr().err


WEDGE = """
    hb.beat(epoch=2, step=7, phase='train', force=True)
    time.sleep(60)
"""


@pytest.mark.parametrize("which", list(MAINS))
def test_a_wedged_worker_is_reported_and_killed(tmp_path, capsys, which):
    rc, took, err = _run(which, capsys, [
        "--nproc", "1", "--heartbeat_dir", str(tmp_path), "--watchdog_timeout", "1",
        "--watchdog_grace", "0.5"], WEDGE)
    assert rc not in (0, 75)  # a wedge is a failure, never requeue-me
    assert took < 30  # detected and killed, not waited out
    assert "WATCHDOG: worker 0 wedged" in err
    assert "epoch 2 step 7" in err and "'train'" in err and "goodput loss" in err
    if which == "port":
        assert "WATCHDOG: worker 0 exited -15" in err  # the stub dies on the SIGTERM


@pytest.mark.parametrize("which", list(MAINS))
def test_a_child_that_never_beats_is_wedged(tmp_path, capsys, which):
    rc, _, err = _run(which, capsys, [
        "--nproc", "1", "--heartbeat_dir", str(tmp_path), "--watchdog_timeout", "1",
        "--watchdog_grace", "0.5"], "time.sleep(60)")
    assert rc not in (0, 75)
    assert "WATCHDOG: worker 0 wedged" in err and "before its first beat" in err


@pytest.mark.parametrize("which", list(MAINS))
def test_a_wedge_is_never_75_even_after_a_graceful_exit(tmp_path, capsys, which):
    rc, _, err = _run(which, capsys, [
        "--nproc", "1", "--heartbeat_dir", str(tmp_path), "--watchdog_timeout", "1",
        "--watchdog_grace", "5"], """
        signal.signal(signal.SIGTERM, lambda s, f: sys.exit(75))
        hb.beat(epoch=0, step=1, force=True)
        time.sleep(60)
    """)
    assert rc == 1, err  # the wedge's failure outranks the child's requeue-75
    assert "WATCHDOG: worker 0 wedged" in err


@pytest.mark.parametrize("which", list(MAINS))
def test_the_watchdog_stands_down_during_preemption(tmp_path, capsys, which):
    # rank 0 exits 75 (the preemption, and the fail-fast SIGTERM to rank 1);
    # rank 1 beats 'preempted' and stays silent well past the timeout in its
    # emergency save before its own 75
    rc, _, err = _run(which, capsys, [
        "--nproc", "2", "--heartbeat_dir", str(tmp_path), "--watchdog_timeout", "1",
        "--watchdog_grace", "0.5"], """
        if rank == 0:
            sys.exit(75)
        def on_term(s, f):
            hb.beat(epoch=0, step=3, phase='preempted', force=True)
            time.sleep(3)
            sys.exit(75)
        signal.signal(signal.SIGTERM, on_term)
        hb.beat(epoch=0, step=3, force=True)
        time.sleep(60)
    """)
    assert rc == 75  # requeue-me, not a crash
    assert "WATCHDOG" not in err


DUMP = """
    crash = flag('--crash_dir')
    with open(os.path.join(crash, 'run.jsonl'), 'a') as f:
        f.write(json.dumps({'kind': 'train_epoch', 'epoch': 0, 'schema_version': 15}) + '\\n')
    rec = flight.FlightRecorder(os.path.join(crash, flight.RING_NAME))
    rec.record('open', world=1)
    rec.step(1, 7)
    flight.arm_faulthandler(os.path.join(crash, flight.STACKS_NAME))
    hb.beat(epoch=1, step=7, phase='train', force=True)
    def stuck_in_collective():
        while True:
            time.sleep(0.2)
    stuck_in_collective()
"""


@pytest.mark.parametrize("which", list(MAINS))
def test_the_sigusr1_dump_names_the_stuck_frame_then_the_kill_and_the_bundle(
        tmp_path, capsys, which):
    work = str(tmp_path)
    rc, took, err = _run(which, capsys, [
        "--nproc", "1", "--heartbeat_dir", work, "--crash_dir", work,
        "--watchdog_timeout", "1", "--watchdog_dump_grace", "6", "--watchdog_grace", "0.5"],
        DUMP)
    assert rc not in (0, 75) and took < 60
    assert "WATCHDOG: worker 0 wedged" in err
    assert "requesting all-threads stack dump" in err
    assert "stack dump: stuck in" in err and "stuck_in_collective" in err
    assert err.index("stack dump: stuck in") > err.index("requesting all-threads")
    assert "postmortem bundle written to" in err
    with open(os.path.join(work, "postmortem.json")) as f:
        rank0 = json.load(f)["ranks"][0]
    assert rank0["verdict"] == "no-clean-exit"
    assert "stuck_in_collective" in rank0["stack"]["stuck_frame"]
    assert rank0["flight"]["last_step"]["step"] == 7
    with open(os.path.join(work, "run.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    pm = [r for r in recs if r["kind"] == "postmortem"]
    assert len(pm) == 1 and pm[0]["verdicts"] == {"0": "no-clean-exit"}
    assert "stuck_in_collective" in pm[0]["stuck_frames"]["0"]
    assert pm[0]["last_steps"] == {"0": {"epoch": 1, "step": 7}}


@pytest.mark.parametrize("which", list(MAINS))
def test_the_forensic_flags_reach_every_child_and_stale_ranks_are_swept(
        tmp_path, capsys, which):
    dirs = {k: tmp_path / k for k in ("hb", "metrics", "crash")}
    for d in dirs.values():
        d.mkdir()
    stale = [dirs["hb"] / "hb.json.h3", dirs["hb"] / "hb.json.h5.tmp",
             dirs["metrics"] / "metrics.prom.h2", dirs["crash"] / (flight.RING_NAME + ".h4")]
    kept = [dirs["hb"] / "hb.json.h1", dirs["crash"] / (flight.STACKS_NAME + ".h1")]
    for path in stale + kept:
        path.write_text("{}")
    out = tmp_path / "argv"
    rc, _, err = _run(which, capsys, [
        "--nproc", "2", "--heartbeat_dir", str(dirs["hb"]), "--metrics_dir",
        str(dirs["metrics"]), "--crash_dir", str(dirs["crash"])], f"""
        with open({str(out)!r} + str(rank), 'w') as f:
            json.dump(argv[1:], f)
    """)
    assert rc == 0
    assert "swept 4 stale per-rank file(s)" in err
    assert not any(p.exists() for p in stale) and all(p.exists() for p in kept)
    for rank in range(2):
        with open(f"{out}{rank}") as f:
            argv = json.load(f)
        got = {k: argv[argv.index(k) + 1] for k in
               ("--heartbeat_file", "--metrics_file", "--crash_dir", "--process_id")}
        assert got == {"--heartbeat_file": str(dirs["hb"] / "hb.json"),
                       "--metrics_file": str(dirs["metrics"] / "metrics.prom"),
                       "--crash_dir": str(dirs["crash"]), "--process_id": str(rank)}


@pytest.mark.parametrize("which", list(MAINS))
def test_watchdog_timeout_needs_heartbeat_dir(capsys, which):
    with pytest.raises(SystemExit) as info:
        MAINS[which](["--nproc", "1", "--watchdog_timeout", "5", "--", "true"])
    assert info.value.code == 2
    assert "--watchdog_timeout needs --heartbeat_dir" in capsys.readouterr().err


LATE_BEATS = """
    time.sleep(1.5)
    hb.beat(epoch=0, step=0, force=True)
    time.sleep(2.3)
    hb.beat(epoch=0, step=1, force=True)
"""


@pytest.mark.parametrize("child", ["beats_late", "never_beats"])
@pytest.mark.parametrize("which", list(MAINS))
def test_a_beat_left_by_another_process_is_not_the_childs(tmp_path, capsys, which, child):
    # a dead process's beat (counter 1, epoch 0 step 9) is on disk. One child's
    # own first beat is counter 1 too, 1.5 s in, and its second comes 2.3 s
    # later; the other child never beats
    with open(tmp_path / "hb.json", "w") as f:
        json.dump({"counter": 1, "epoch": 0, "step": 9, "phase": "train", "pid": 1}, f)
    rc, _, err = _run(which, capsys, [
        "--nproc", "1", "--heartbeat_dir", str(tmp_path), "--watchdog_timeout", "3",
        "--watchdog_grace", "0.5"], LATE_BEATS if child == "beats_late" else "time.sleep(60)")
    if child == "never_beats":
        assert rc not in (0, 75) and "WATCHDOG: worker 0 wedged" in err
        if which == "port":  # the dead process's position is not the child's
            assert "before its first beat" in err and "step 9" not in err
        else:  # the JAX launcher reports the dead process's beat as the child's
            assert "epoch 0 step 9" in err
    elif which == "port":
        assert rc == 0 and "WATCHDOG" not in err  # the child's own beat is an advance
    else:
        # the JAX launcher sees counter 1 then 1: no advance for 3 s
        assert rc == 1 and "WATCHDOG: worker 0 wedged" in err
