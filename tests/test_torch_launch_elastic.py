"""The port launcher's elastic half (``tpu_dist_torch/cli/launch.py``:
``--elastic_*``, the supervisor, the capacity probe) held against the JAX
launcher's (``tpu_dist/cli/launch.py``), the counterparts of
``tests/test_elastic.py:582-622`` and ``tests/test_fleet.py:510-570``.

Each case runs the same stub children (``python -c`` scripts that import
nothing of either package, or only the port's stdlib heartbeat) under both
launchers, in process, with the same flags, and holds both to the same
world sizes, ``--resume`` flags, ``TPU_DIST_ELASTIC_RESTARTS``, decision
environment and exit codes:

* a round that loses a rank to SIGKILL relaunches at the largest divisor
  the survivors staff, with ``--resume`` and the restart index;
* without ``--elastic_min_procs`` a preemption exits 75 after one round;
* a census below ``--nproc`` starts round 0 at the granted size, and the
  probe grows it when the allocation file grows, charging no budget;
* a census below the floor refuses to start;
* the allocation file's decision tokens reach every child of every round,
  and a stale id in the launcher's own environment reaches none;
* a SIGTERM to the launcher stands the policy down: 75 after one round;
* a lost rank with no survivor gives up with the child's own code;
* the watchdog stands down while the probe's resize SIGTERM is being
  answered (a rank silent in its emergency save is no wedge);
* ``--elastic_min_procs`` above ``--nproc`` is a parser error;
* without the supervisor both launchers stamp the round index, 0, over a
  ``TPU_DIST_ELASTIC_RESTARTS`` in their own environment.
"""

import os
import sys
import textwrap

import pytest

from tpu_dist.cli import launch as jax_launch
from tpu_dist_torch.cli import launch
from tpu_dist_torch.fleet import capacity

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAINS = {"port": launch.main, "jax": jax_launch.main}

# the head of every stub: the injected placement, and a line a spawn
HEAD = """
import os, signal, sys, time
argv = sys.argv
n = int(argv[argv.index('--num_processes') + 1])
rank = int(argv[argv.index('--process_id') + 1])
resume = '--resume' in argv
def note(marker):
    env = os.environ
    with open(marker, 'a') as f:
        f.write(f"{n} {rank} {int(resume)} {env.get('TPU_DIST_ELASTIC_RESTARTS')} "
                f"{env.get('TPU_DIST_FLEET_DECISION_ID')} "
                f"{env.get('TPU_DIST_FLEET_DECISION_CAUSE')}\\n")
def wait_lines(marker, k):
    # every rank of the round has noted itself (so no fail-fast SIGTERM
    # can end a rank before its line is written)
    deadline = time.time() + 30
    while time.time() < deadline:
        with open(marker) as f:
            if sum(1 for _ in f) >= k:
                return
        time.sleep(0.02)
"""


def _stub(body: str) -> list:
    return [sys.executable, "-c", HEAD + textwrap.dedent(body)]


def _lines(marker: str) -> list:
    with open(marker) as f:
        return sorted(tuple(line.split()) for line in f if line.strip())


@pytest.mark.parametrize("which", list(MAINS))
def test_a_lost_rank_relaunches_the_survivors_smaller(tmp_path, which):
    marker = str(tmp_path / "worlds.txt")
    rc = MAINS[which](["--nproc", "4", "--elastic_min_procs", "1", "--elastic_max_restarts",
                       "2", "--elastic_backoff", "0.01", "--", *_stub(f"""
        signal.signal(signal.SIGTERM, lambda *a: sys.exit(75))
        note({marker!r})
        if resume:
            sys.exit(0)
        wait_lines({marker!r}, n)
        if rank == 2:
            os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(30)
    """)])
    assert rc == 0
    # round 0 at 4 (no --resume, index 0); rank 2 lost, 3 survivors: the
    # largest divisor of 4 they staff is 2, with --resume and index 1
    assert _lines(marker) == sorted(
        [("4", str(r), "0", "0", "None", "None") for r in range(4)]
        + [("2", str(r), "1", "1", "None", "None") for r in range(2)])


@pytest.mark.parametrize("which", list(MAINS))
def test_without_the_supervisor_a_preemption_ends_the_launch(tmp_path, which):
    marker = str(tmp_path / "worlds.txt")
    rc = MAINS[which](["--nproc", "2", "--", *_stub(f"""
        note({marker!r})
        wait_lines({marker!r}, n)
        sys.exit(75)
    """)])
    assert rc == 75
    assert len(_lines(marker)) == 2  # one round, no relaunch


@pytest.mark.parametrize("which", list(MAINS))
def test_the_census_starts_at_the_grant_and_the_probe_grows_it(tmp_path, which, capsys):
    marker = str(tmp_path / "worlds.txt")
    cap = str(tmp_path / "allocation")
    capacity.write_allocation(cap, 2)
    rc = MAINS[which](["--nproc", "4", "--elastic_min_procs", "1",
                       "--elastic_max_restarts", "0",  # a resize needs no failure budget
                       "--elastic_backoff", "0.01", "--elastic_probe_interval", "0.2",
                       "--elastic_capacity_file", cap, "--", *_stub(f"""
        if rank == 0:
            note({marker!r})
        signal.signal(signal.SIGTERM, lambda *a: sys.exit(75))
        if resume and n == 4:
            sys.exit(0)
        if n == 2 and rank == 0:
            time.sleep(0.1)
            with open({cap!r} + '.t', 'w') as f:
                f.write('4')
            os.replace({cap!r} + '.t', {cap!r})
        time.sleep(60)
    """)])
    assert rc == 0
    assert _lines(marker) == [("2", "0", "0", "0", "None", "None"),
                              ("4", "0", "1", "1", "None", "None")]
    err = capsys.readouterr().err
    assert "capacity census grants 2 of 4 proc(s) at launch" in err
    assert "growing from world size 2 to 4" in err


@pytest.mark.parametrize("which", list(MAINS))
def test_a_census_below_the_floor_refuses_to_start(tmp_path, which):
    marker = str(tmp_path / "worlds.txt")
    cap = str(tmp_path / "allocation")
    capacity.write_allocation(cap, 1)
    rc = MAINS[which](["--nproc", "4", "--elastic_min_procs", "2",
                       "--elastic_probe_interval", "0.2", "--elastic_capacity_file", cap,
                       "--", *_stub(f"note({marker!r})")])
    assert rc == 1
    assert not os.path.exists(marker)  # nothing spawned


@pytest.mark.parametrize("which", list(MAINS))
@pytest.mark.parametrize("tokens", ["with", "without"])
def test_the_decision_tokens_reach_every_child_of_every_round(tmp_path, which, tokens,
                                                               monkeypatch):
    marker = str(tmp_path / "worlds.txt")
    cap = str(tmp_path / "allocation")
    if tokens == "with":
        capacity.write_allocation(cap, 2, decision_id=7, cause="goodput")
    else:
        capacity.write_allocation(cap, 2)
        # a stale id in the launcher's own environment reaches no child
        monkeypatch.setenv("TPU_DIST_FLEET_DECISION_ID", "99")
        monkeypatch.setenv("TPU_DIST_FLEET_DECISION_CAUSE", "serve_breach")
    rc = MAINS[which](["--nproc", "2", "--elastic_min_procs", "1", "--elastic_backoff",
                       "0.01", "--elastic_probe_interval", "30", "--elastic_capacity_file",
                       cap, "--", *_stub(f"""
        note({marker!r})
        if not resume:
            wait_lines({marker!r}, n)
        sys.exit(0 if resume else 75)
    """)])
    assert rc == 0
    did, cause = ("7", "goodput") if tokens == "with" else ("None", "None")
    assert _lines(marker) == sorted(
        [("2", str(r), str(i), str(i), did, cause) for r in range(2) for i in range(2)])


@pytest.mark.parametrize("which", list(MAINS))
def test_the_launchers_own_sigterm_stands_the_policy_down(tmp_path, which):
    marker = str(tmp_path / "worlds.txt")
    # the child asks its launcher (this process) to stop, then answers the
    # forwarded SIGTERM as a trainer does: exit 75
    rc = MAINS[which](["--nproc", "1", "--elastic_min_procs", "1", "--elastic_backoff",
                       "0.01", "--", *_stub(f"""
        note({marker!r})
        signal.signal(signal.SIGTERM, lambda *a: sys.exit(75))
        os.kill(os.getppid(), signal.SIGTERM)
        time.sleep(30)
    """)])
    assert rc == 75
    assert len(_lines(marker)) == 1  # one round spawned, no relaunch


@pytest.mark.parametrize("which", list(MAINS))
def test_a_lost_rank_with_no_survivor_gives_up_with_its_own_code(tmp_path, which):
    marker = str(tmp_path / "worlds.txt")
    rc = MAINS[which](["--nproc", "1", "--elastic_min_procs", "1", "--elastic_backoff",
                       "0.01", "--", *_stub(f"""
        note({marker!r})
        os.kill(os.getpid(), signal.SIGKILL)
    """)])
    assert rc == -9  # the child's own code, not 75
    assert len(_lines(marker)) == 1


@pytest.mark.parametrize("which", list(MAINS))
def test_the_watchdog_stands_down_during_a_resize(tmp_path, which, capsys):
    """The probe's SIGTERM is a preemption to the child: it beats no more
    while it saves (here 2 s, past the 1 s watchdog timeout) and exits 75;
    the round must relaunch at the new size, not report a wedge."""
    marker = str(tmp_path / "worlds.txt")
    cap = str(tmp_path / "allocation")
    capacity.write_allocation(cap, 2)
    body = f"""
        sys.path.insert(0, {ROOT!r})
        from tpu_dist_torch.obs.heartbeat import Heartbeat, per_rank_path
        hb = Heartbeat(per_rank_path(argv[argv.index('--heartbeat_file') + 1], rank))
        stop = []
        signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
        note({marker!r})
        if resume:
            sys.exit(0)
        if rank == 0:
            wait_lines({marker!r}, n)
            capacity = {cap!r}
            with open(capacity + '.t', 'w') as f:
                f.write('1')
            os.replace(capacity + '.t', capacity)
        while not stop:
            hb.beat(epoch=0, step=1, force=True)
            time.sleep(0.1)
        time.sleep(2.0)  # the emergency save: silent by design
        sys.exit(75)
    """
    rc = MAINS[which](["--nproc", "2", "--elastic_min_procs", "1", "--elastic_max_restarts",
                       "0", "--elastic_probe_interval", "0.3", "--elastic_capacity_file", cap,
                       "--heartbeat_dir", str(tmp_path / "hb"), "--watchdog_timeout", "1",
                       "--watchdog_grace", "0.5", "--", *_stub(body)])
    err = capsys.readouterr().err
    assert rc == 0, err
    assert "wedged" not in err
    assert [line[:3] for line in _lines(marker)] == [("1", "0", "1"), ("2", "0", "0"),
                                                     ("2", "1", "0")]


@pytest.mark.parametrize("which", list(MAINS))
def test_a_floor_above_nproc_is_a_parser_error(which):
    with pytest.raises(SystemExit) as info:
        MAINS[which](["--nproc", "2", "--elastic_min_procs", "3", "--", "true"])
    assert info.value.code == 2


@pytest.mark.parametrize("which", list(MAINS))
def test_a_one_round_launch_stamps_restart_zero_over_a_stale_count(tmp_path, which,
                                                                   monkeypatch):
    """Without the supervisor the launcher still stamps its round index,
    0, so no child inherits a stale ``TPU_DIST_ELASTIC_RESTARTS`` from the
    launcher's own environment (``tpu_dist/cli/launch.py:447-450``)."""
    marker = str(tmp_path / "worlds.txt")
    monkeypatch.setenv("TPU_DIST_ELASTIC_RESTARTS", "3")
    assert MAINS[which](["--nproc", "1", "--", *_stub(f"note({marker!r})")]) == 0
    [line] = _lines(marker)
    assert line[3] == "0"
