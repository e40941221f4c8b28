"""The port's replica supervisor (``tpu_dist_torch/serve/supervisor.py``) and
replica (``tpu_dist_torch/serve/replica.py``) held against the JAX
package's.

* The same scripts drive both supervisors with the same fake processes,
  fake clock and heartbeat files (each beat written with the live fake
  process's pid, as a replica writes it): the poll results, the event
  lists (bundle paths normalised), the ``serve.replica_*`` counters and
  ``run``'s return value are equal, through a crash, a wedge that exits on
  SIGTERM and one that needs SIGKILL, a garbage beat, the warmup grace, a
  beat seen then swept, an exhausted restart budget and ``run``.
* Where the port differs on purpose: a SIGKILLed incarnation's beat left
  behind does not wedge its successor in the port (the JAX supervisor
  reads it as the new process's and, once it is ``stale_after_s`` old,
  kills a replica still starting up).
* With a ``capacity_file`` every spawn event carries the file's
  ``decision_id``/``decision_cause``, in both packages.
* ``weights_digest`` of the port's ``load_serving_state`` on a checkpoint
  written by ``tpu_dist.serve.drill.write_training_ckpt`` equals the JAX
  digest of the same file, and the port's own drill checkpoint loads with
  one digest in both packages.
* One real replica subprocess on ``--device cpu`` under the port's
  supervisor: SIGKILL, ``crash``, a ``postmortem`` bundle reading
  ``no-clean-exit``, a relaunch with the same digest, SIGTERM, ``drained``,
  ``exit``.
"""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
from torch_ranks import child_env

from tpu_dist.obs import counters as jax_counters
from tpu_dist.serve import drill as jax_drill
from tpu_dist.serve import engine as jax_engine
from tpu_dist.serve import replica as jax_replica
from tpu_dist.serve import supervisor as jax_sup
from tpu_dist_torch.obs import counters
from tpu_dist_torch.serve import drill, replica, supervisor
from tpu_dist_torch.serve.engine import load_serving_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"port": (supervisor, counters), "jax": (jax_sup, jax_counters)}


@pytest.fixture(autouse=True)
def _fresh_registries():
    counters.reset()
    jax_counters.reset()
    yield
    counters.reset()
    jax_counters.reset()


class FakeProc:
    """A replica process the script controls: ``rc`` is its exit status
    (None while alive); SIGTERM ends it with ``term_rc`` unless
    ``ignores_term``; SIGKILL ends it with -9."""

    def __init__(self, pid):
        self.pid, self.rc, self.term_rc, self.ignores_term = pid, None, 0, False
        self.signals = []

    def poll(self):
        return self.rc

    def terminate(self):
        self.signals.append("TERM")
        if not self.ignores_term:
            self.rc = self.term_rc

    def kill(self):
        self.signals.append("KILL")
        self.rc = -9


class World:
    """Fake clock, fake processes and the heartbeat file of one run."""

    def __init__(self, d):
        self.t = 1000.0
        self.procs = []
        self.hb = os.path.join(d, "hb.json")
        self.evidence = os.path.join(d, "evidence")
        os.makedirs(self.evidence, exist_ok=True)

    def now(self):
        return self.t

    def sleep(self, dt):
        self.t += dt

    def spawn(self, incarnation):
        self.procs.append(FakeProc(4000 + incarnation))
        return self.procs[-1]

    def beat(self, age=0.0, ts=None, pid=None):
        with open(self.hb, "w") as f:
            json.dump({"counter": 1, "ts": self.t - age if ts is None else ts,
                       "pid": self.procs[-1].pid if pid is None else pid, "phase": "serve"}, f)

    def sweep(self):
        if os.path.exists(self.hb):
            os.remove(self.hb)


def _crash_then_exit(w, sup):
    out = [sup.poll_once()]  # alive, no beat yet, inside the warmup grace
    w.beat()
    out.append(sup.poll_once())
    w.procs[-1].rc = -9
    out.append(sup.poll_once())  # crash -> bundle -> backoff -> relaunch
    w.sweep()
    w.beat()
    out.append(sup.poll_once())
    w.sleep(3.0)
    w.beat()
    out.append(sup.poll_once())
    w.sweep()
    w.procs[-1].rc = 0
    out += [sup.poll_once(), sup.poll_once(), sup.done, sup.last_rc]
    return out


def _wedge_exits_on_term(w, sup):
    sup.start()
    w.beat()
    out = [sup.poll_once()]
    w.sleep(61.0)  # no new beat: stale past the default 60 s
    out.append(sup.poll_once())
    out.append(w.procs[0].signals)
    w.beat()
    out.append(sup.poll_once())
    return out + [sup.incarnation, sup.restarts]


def _wedge_needs_kill(w, sup):
    sup.start()
    w.procs[0].ignores_term = True
    w.beat(age=100.0)
    out = [sup.poll_once(), w.procs[0].signals, sup.last_rc, sup.incarnation]
    return out


def _garbage_beat(w, sup):
    sup.start()
    w.beat(ts="yesterday")
    return [sup.poll_once(), sup.last_rc]


def _warmup_grace(w, sup):
    sup.start()
    out = []
    for _ in range(3):
        w.sleep(50.0)  # 50, 100, 150 s without a beat; the grace is 120
        out.append(sup.poll_once())
    return out + [sup.incarnation]


def _beat_seen_then_swept(w, sup):
    sup.start()
    w.beat()
    out = [sup.poll_once()]
    w.sweep()  # a clean exit's sweep in progress: never a wedge
    w.sleep(500.0)
    out.append(sup.poll_once())
    w.procs[-1].rc = 0
    return out + [sup.poll_once()]


def _budget(w, sup):
    sup.start()
    out = []
    for _ in range(3):
        w.procs[-1].rc = 3
        out.append(sup.poll_once())
    return out + [sup.gave_up, sup.poll_once(), sup.last_rc, sup.restarts]


def _run_loop(w, sup):
    def spawn_and_schedule(incarnation):
        p = w.spawn(incarnation)
        p.rc = 7 if incarnation == 1 else 0
        return p

    sup._spawn = spawn_and_schedule
    return [sup.run(poll_interval_s=0.5, max_polls=10), sup.incarnation, sup.done]


SCRIPTS = {
    "crash": (_crash_then_exit, {}),
    "wedge-term": (_wedge_exits_on_term, {}),
    "wedge-kill": (_wedge_needs_kill, {"term_grace_s": 2.0}),
    "garbage-beat": (_garbage_beat, {}),
    "warmup-grace": (_warmup_grace, {}),
    "swept": (_beat_seen_then_swept, {}),
    "budget": (_budget, {"max_restarts": 2, "backoff_base_s": 0.5}),
    "run": (_run_loop, {"max_restarts": 1}),
}


def _drive(tmp_path, pkg, name):
    lib, cnt = PACKAGES[pkg]
    script, policy = SCRIPTS[name]
    d = str(tmp_path / pkg)
    w = World(d)
    with open(os.path.join(w.evidence, "hb.json"), "w") as f:  # evidence to bundle
        json.dump({"counter": 3, "ts": 1.0}, f)
    sup = lib.ReplicaSupervisor(
        w.spawn, heartbeat_file=w.hb, policy=lib.ReplicaPolicy(**policy),
        postmortem_dirs=[w.evidence], now=w.now, sleep=w.sleep)
    results = script(w, sup)
    events = json.loads(json.dumps(sup.events).replace(d, "<dir>"))
    snap = {k: v for k, v in cnt.snapshot().items() if k.startswith("serve.replica_")}
    return results, events, snap, w.t


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_the_supervisors_agree(tmp_path, name):
    ours, theirs = _drive(tmp_path, "port", name), _drive(tmp_path, "jax", name)
    assert ours == theirs
    results, events, snap, _ = ours
    kinds = [e["event"] for e in events]
    if name == "crash":
        assert results[:3] == [None, None, "crash"] and results[-2:] == [True, 0]
        assert kinds == ["spawn", "crash", "postmortem", "relaunch", "spawn", "exit"]
        assert snap == {"serve.replica_spawns": 2, "serve.replica_crashes": 1,
                        "serve.replica_postmortems": 1, "serve.replica_restarts": 1}
    if name == "wedge-kill":
        assert results[:3] == ["wedge", ["TERM", "KILL"], -9]
    if name == "garbage-beat":
        assert results[0] == "wedge"
    if name == "warmup-grace":
        assert results == [None, None, "wedge", 2]
    if name == "swept":
        assert results == [None, None, "exit"]
    if name == "budget":
        assert results[:3] == ["crash", "crash", "gave_up"] and results[3:] == [True, None, 3, 2]
    if name == "run":
        assert results == [0, 2, True]


def test_a_killed_incarnations_beat_does_not_wedge_its_successor(tmp_path):
    """The JAX supervisor reads the beat a SIGKILLed replica left behind
    as its successor's, and kills the successor while it is still starting
    up once that beat is ``stale_after_s`` old; the port waits for the
    successor's own beat (its pid), inside the warmup grace."""
    got = {}
    for pkg in PACKAGES:
        lib, _ = PACKAGES[pkg]
        w = World(str(tmp_path / pkg))
        sup = lib.ReplicaSupervisor(w.spawn, heartbeat_file=w.hb, now=w.now, sleep=w.sleep,
                                    policy=lib.ReplicaPolicy(stale_after_s=5.0))
        sup.start()
        w.beat()
        first = sup.poll_once()
        w.procs[-1].rc = -9  # SIGKILL: the beat stays behind
        crash = sup.poll_once()
        w.sleep(8.0)  # the successor loads weights and warms up
        got[pkg] = [first, crash, sup.poll_once()]
        w.beat()  # its own first beat
        got[pkg].append(sup.poll_once())
    assert got["port"] == [None, "crash", None, None]
    assert got["jax"] == [None, "crash", "wedge", None]


@pytest.mark.parametrize("content", [None, "2\n", "2 decision=7 cause=serve_breach\n",
                                     "2 decision=7\n", "torn decision="])
def test_spawn_event_names_the_capacity_files_decision_as_jax_does(tmp_path, content):
    """``capacity_file``: every spawn reads the allocation file's decision
    tokens into its event, in both packages; a crash relaunch reads the
    file again (the grant may have changed it)."""
    cap = str(tmp_path / "allocation")
    if content is not None:
        with open(cap, "w") as f:
            f.write(content)
    events = {}
    for name, (mod, _) in PACKAGES.items():
        w = World(str(tmp_path / name))
        sup = mod.ReplicaSupervisor(w.spawn, heartbeat_file=w.hb, capacity_file=cap,
                                    now=w.now, sleep=w.sleep)
        sup.start()
        w.procs[-1].rc = -9
        sup.poll_once()  # crash -> relaunch -> a second spawn
        events[name] = [e for e in sup.events if e["event"] == "spawn"]
    assert events["port"] == events["jax"]
    assert len(events["port"]) == 2
    if content and "decision=7" in content:
        assert events["port"][0]["decision_id"] == 7
    else:
        assert "decision_id" not in events["port"][0]


def test_policy_validation_equals_jax():
    for kw in ({"max_restarts": -1}, {"stale_after_s": -1.0}, {"term_grace_s": -0.5}):
        with pytest.raises(ValueError):
            supervisor.ReplicaPolicy(**kw)
        with pytest.raises(ValueError):
            jax_sup.ReplicaPolicy(**kw)
    assert supervisor.ReplicaPolicy() == supervisor.ReplicaPolicy(**vars(jax_sup.ReplicaPolicy()))


# -- the digest and the real replica -------------------------------------------


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpts")
    jax_dir, port_dir = str(d / "jax"), str(d / "port")
    jax_drill.write_training_ckpt(jax_dir, jax_drill._drill_model())
    drill.write_training_ckpt(port_dir, drill._drill_model("cpu"))
    return {"jax": jax_dir, "port": port_dir}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_weights_digest_equals_jax_on_one_checkpoint(ckpts, writer):
    ours = load_serving_state(ckpts[writer], drill._drill_model("cpu"))
    theirs = jax_engine.load_serving_state(ckpts[writer], jax_drill._drill_model())
    theirs = jax.tree_util.tree_map(np.asarray, (theirs["params"], theirs["bn_state"]))
    digest = replica.weights_digest(ours["params"], ours["bn_state"])
    assert digest == jax_replica.weights_digest(*theirs)
    assert digest != replica.weights_digest(ours["params"], {})


def _lines(path, event):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [r for r in map(json.loads, f) if r.get("event") == event]


def test_a_real_replica_is_killed_bundled_relaunched_and_drained(tmp_path, ckpts):
    work = str(tmp_path / "replica")
    status = os.path.join(work, "status.jsonl")

    def spawn(incarnation):
        return subprocess.Popen(
            [sys.executable, "-m", "tpu_dist_torch.serve", "replica", "--ckpt", ckpts["jax"],
             "--workdir", work, "--status_file", status, "--device", "cpu", "--pace_s", "0.01"],
            cwd=ROOT, env=child_env())

    sup = supervisor.ReplicaSupervisor(
        spawn, heartbeat_file=os.path.join(work, "hb.json"),
        policy=supervisor.ReplicaPolicy(max_restarts=2, backoff_base_s=0.01),
        postmortem_dirs=[work])

    def wait(cond, what):
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if cond():
                return
            assert sup.poll_once() is None, sup.events
            time.sleep(0.05)
        raise AssertionError(f"timed out waiting for {what}: {sup.events}")

    sup.start()
    try:
        wait(lambda: len(_lines(status, "ready")) == 1, "incarnation 1")
        wait(lambda: os.path.exists(os.path.join(work, "hb.json")), "a beat")
        os.kill(sup.proc.pid, signal.SIGKILL)
        sup.proc.wait(timeout=30)
        assert sup.poll_once() == "crash"
        pm = [e for e in sup.events if e["event"] in ("postmortem", "bundle_failed")]
        assert [e["event"] for e in pm] == ["postmortem"]
        with open(pm[0]["bundle"]) as f:
            assert [r["verdict"] for r in json.load(f)["ranks"]] == ["no-clean-exit"]
        wait(lambda: len(_lines(status, "ready")) == 2, "incarnation 2")
        first, second = _lines(status, "ready")
        assert first["weights_digest"] == second["weights_digest"]
        assert first["remapped"] and first["warmup_compiles"] == 3
        sup.proc.terminate()
        assert sup.proc.wait(timeout=30) == 0
        assert sup.poll_once() == "exit" and sup.done
        drained = _lines(status, "drained")
        assert len(drained) == 1 and drained[0]["retraces"] == 0
        assert not os.path.exists(os.path.join(work, "hb.json"))  # swept
    finally:
        if sup.proc is not None and sup.proc.poll() is None:
            sup.proc.kill()
            sup.proc.wait()
