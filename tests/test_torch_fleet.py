"""The port's ``tpu_dist_torch/fleet/`` and the scrape half of
``obs/hub.py`` held against the JAX package's on the same inputs:

* the chip-second audit (``scheduler.py::audit_chip_seconds``) on the same
  ``tenancy`` records: a conserved pod over several ticks, a tick whose
  pools do not add up, records of other kinds mixed in, a tick length
  other than 1 s, and no snapshot at all (integer chip-ticks in both, so
  compared exactly);
* allocation files (``capacity.py``) written by one package and read by
  the other, with and without the decision tokens, torn or garbage, and
  the census's order over the file, the environment and the default;
* ``hub.sample_run`` and ``scheduler.read_signals`` over expositions and
  heartbeats present, absent, stale and malformed;
* ``FleetScheduler.step`` replayed over the same seeded signal sequences
  (a training market and a pod shared with a serving run): the same
  decisions, ``fleet`` and ``tenancy`` records field for field (both
  given the same ``ts``), allocation files, exposition and pools;
* the fleet drill's fleet phase: two port launchers over stub children,
  arbitrated by the port's scheduler.
"""

import json
import os

import numpy as np
import pytest

from tpu_dist.fleet import capacity as jax_capacity
from tpu_dist.fleet import scheduler as jax_sched
from tpu_dist.fleet.scheduler import audit_chip_seconds as jax_audit
from tpu_dist.obs import export as jax_export
from tpu_dist.obs import hub as jax_hub
from tpu_dist_torch.fleet import capacity
from tpu_dist_torch.fleet import scheduler as sched
from tpu_dist_torch.fleet.scheduler import audit_chip_seconds
from tpu_dist_torch.obs import export
from tpu_dist_torch.obs import hub

_CONSERVED = [
    {"kind": "tenancy", "tick": t, "alloc": {"train": 4 - t, "serve": t}, "free": 0,
     "pending": 0, "total_chips": 4}
    for t in range(4)
]
_VIOLATION = _CONSERVED[:2] + [
    {"kind": "tenancy", "tick": 2, "alloc": {"train": 3}, "free": 2, "pending": 0,
     "total_chips": 4},
]
_MIXED = [{"kind": "fleet", "tick": 1, "action": "grant", "recipient": "serve", "chips": 1},
          {"kind": "tenancy", "tick": 1, "alloc": {"train": 2}, "free": 1, "pending": 1,
           "total_chips": 4},
          {"kind": "serve", "requests": 3}]

CASES = {"conserved": (_CONSERVED, 1.0), "violation": (_VIOLATION, 1.0),
         "mixed_kinds": (_MIXED, 1.0), "tick_2_5_s": (_CONSERVED, 2.5), "empty": ([], 1.0)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_audit_chip_seconds_equals_jax(case):
    records, tick_s = CASES[case]
    ours = audit_chip_seconds(records, tick_s=tick_s)
    assert ours == jax_audit(records, tick_s=tick_s)
    assert ours["conserved"] == (case != "violation")


# -- the capacity census (fleet/capacity.py) -----------------------------------------

WRITERS = {"port": capacity.write_allocation, "jax": jax_capacity.write_allocation}
TOKENS = [{}, {"decision_id": 7}, {"decision_id": 7, "cause": "goodput"},
          {"decision_id": 12, "cause": "serve_breach"}, {"cause": "ignored_without_an_id"}]


@pytest.mark.parametrize("writer", sorted(WRITERS))
@pytest.mark.parametrize("tokens", range(len(TOKENS)))
def test_allocation_files_cross_between_the_packages(tmp_path, writer, tokens):
    path = str(tmp_path / "run" / "allocation")
    WRITERS[writer](path, 4, **TOKENS[tokens])
    other = jax_capacity.write_allocation if writer == "port" else capacity.write_allocation
    twin = str(tmp_path / "twin" / "allocation")
    other(twin, 4, **TOKENS[tokens])
    with open(path) as a, open(twin) as b:
        assert a.read() == b.read()  # byte for byte the same file
    for read in (capacity, jax_capacity):
        assert read.read_allocation(path) == 4
    assert capacity.read_allocation_meta(path) == jax_capacity.read_allocation_meta(path)
    assert capacity.read_allocation_meta(path)["decision_id"] == TOKENS[tokens].get(
        "decision_id")


@pytest.mark.parametrize("content", ["", "   \n", "not-a-number", "4.5", "-2 decision=3",
                                     "3 decision=x cause=", "8 cause=goodput decision=09",
                                     "5\x00\x00", None])
def test_torn_or_garbage_files_read_as_jax_reads_them(tmp_path, content):
    path = str(tmp_path / "allocation")
    if content is not None:
        with open(path, "w") as f:
            f.write(content)
    assert capacity.read_allocation(path) == jax_capacity.read_allocation(path)
    assert capacity.read_allocation_meta(path) == jax_capacity.read_allocation_meta(path)
    for env in ({}, {capacity.CAPACITY_ENV: "6"}, {capacity.CAPACITY_ENV: "--4"},
                {capacity.CAPACITY_ENV: "+3"}, {capacity.CAPACITY_ENV: " x9"}):
        assert (capacity.make_census(path, default=8, env=env)()
                == jax_capacity.make_census(path, default=8, env=env)())
    assert capacity.CAPACITY_ENV == jax_capacity.CAPACITY_ENV


# -- the hub's scrape primitive (obs/hub.py::sample_run) -------------------------------


@pytest.mark.parametrize("beat", ["none", "absent", "fresh", "stale", "no_ts", "bool_ts"])
@pytest.mark.parametrize("expo", ["textfile", "missing", "torn"])
def test_sample_run_equals_jax(tmp_path, beat, expo):
    prom = str(tmp_path / "metrics.prom")
    if expo == "textfile":
        with open(prom, "w") as f:
            f.write(export.render({"train.data_stall_frac": 0.41, "train.epoch": 2},
                                  labeled={"alert_active": {"stall_high": 1}}))
    elif expo == "torn":
        with open(prom, "w") as f:
            f.write("tpu_dist_train_data_stall_frac 0.4\ntpu_dist_train_ep")
    hb = None if beat == "none" else str(tmp_path / "hb.json")
    body = {"fresh": {"ts": 1000.0, "counter": 3}, "stale": {"ts": 800.0, "counter": 3},
            "no_ts": {"counter": 3}, "bool_ts": {"ts": True}}.get(beat)
    if body is not None:
        with open(hb, "w") as f:
            json.dump(body, f)
    kw = dict(metrics_file=prom, heartbeat_file=hb, now=1010.0)
    assert hub.sample_run("r", **kw) == jax_hub.sample_run("r", **kw)
    assert sched.read_signals("r", prom, hb, now=1010.0) == _as_port(
        jax_sched.read_signals("r", prom, hb, now=1010.0))
    assert hub.STALE_AFTER_S == jax_hub.STALE_AFTER_S == sched.STALE_AFTER_S


def test_run_source_validation_equals_jax():
    for kw in ({"run": ""}, {"run": "a"}, {"run": "a", "port": 1, "kind": "batch"}):
        with pytest.raises(ValueError):
            hub.RunSource(**kw)
        with pytest.raises(ValueError):
            jax_hub.RunSource(**kw)
    assert hub.RunSource("a", port=9) == hub.RunSource(**vars(jax_hub.RunSource("a", port=9)))


# -- the arbiter (fleet/scheduler.py) -----------------------------------------------


def _as_port(sig):
    return sched.RunSignals(**vars(sig))


def test_fleet_constants_equal_jax_and_the_history_schema():
    from tpu_dist_torch.metrics.history import SCHEMA_VERSION

    assert sched.FLEET_SCHEMA_VERSION == SCHEMA_VERSION == jax_sched.FLEET_SCHEMA_VERSION
    assert sched.RUN_KINDS == jax_sched.RUN_KINDS
    assert sched.DECISION_CAUSES == jax_sched.DECISION_CAUSES
    assert sched.FleetPolicy() == sched.FleetPolicy(**vars(jax_sched.FleetPolicy()))


def test_bad_configurations_are_refused_as_jax_refuses_them():
    cases = [
        lambda m: m.FleetScheduler([m.RunSpec("a", 8)], allocations={"a": 5}),
        lambda m: m.FleetScheduler([m.RunSpec("a", 8)], allocations={"a": 8}, total_chips=4),
        lambda m: m.FleetScheduler([m.RunSpec("a", 8), m.RunSpec("a", 4)]),
        lambda m: m.FleetScheduler([]),
        lambda m: m.FleetPolicy(donate_stall_frac=0.1, receive_stall_frac=0.4),
        lambda m: m.FleetPolicy(serve_breach_ticks=0),
        lambda m: m.FleetPolicy(serve_ok_availability=1.5),
        lambda m: m.RunSpec("a", 4, min_procs=5),
        lambda m: m.RunSpec("a", 4, kind="batch"),
    ]
    for make in cases:
        with pytest.raises(ValueError) as ours:
            make(sched)
        with pytest.raises(ValueError) as theirs:
            make(jax_sched)
        assert str(ours.value) == str(theirs.value)


# Fleets for the replay: (runs as (name, original, min_procs, kind), initial
# allocations, total cards).
FLEETS = {
    "market": ([("a", 8, 2, "train"), ("b", 8, 2, "train"), ("c", 4, 1, "train")],
               {"a": 8, "b": 4, "c": 2}, 16),
    "tenancy": ([("svc", 4, 1, "serve"), ("tr", 8, 2, "train"), ("tr2", 4, 1, "train")],
                {"svc": 1, "tr": 8, "tr2": 4}, 13),
}


def _signals(mod, rng, fleet, tick):
    """One tick's readings, drawn from the seeded stream: stall fractions
    around both thresholds, alerts, dead beats, absent runs; a serve run's
    queue climbing in bursts and draining, its SLO alerts and availability."""
    out = {}
    for name, _orig, _floor, kind in FLEETS[fleet][0]:
        if rng.random() < 0.08:
            continue  # no reading this tick
        alerts = ()
        if kind == "serve":
            burst = (tick // 6) % 2 == 0
            q = float(rng.integers(4, 20)) * (1 + tick % 6) if burst else float(rng.integers(0, 2))
            if burst and rng.random() < 0.5:
                alerts = ("slo_p99_latency",)
            if rng.random() < 0.05:
                alerts += ("serve_retrace",)
            out[name] = mod.RunSignals(
                run=name, queue_depth=q, availability=float(rng.choice([0.95, 0.995, 1.0])),
                latency_p99_ms=float(rng.integers(5, 80)), active_alerts=alerts,
                alive=bool(rng.random() > 0.05), epoch=None)
        else:
            if rng.random() < 0.1:
                alerts = ("grad_norm_high",)
            stall = None if rng.random() < 0.1 else float(rng.choice(
                [0.0, 0.02, 0.08, 0.11, 0.39, 0.43, 0.47, 0.62, 0.9]))
            out[name] = mod.RunSignals(
                run=name, data_stall_frac=stall, goodput_frac=float(rng.random()),
                mfu=float(rng.random()), active_alerts=alerts,
                alive=None if rng.random() < 0.5 else bool(rng.random() > 0.05),
                heartbeat_age_s=float(rng.integers(0, 90)), epoch=float(tick))
    return out


def _replay(mod, fleet, seed, root):
    runs, allocs, total = FLEETS[fleet]
    s = mod.FleetScheduler([mod.RunSpec(n, o, min_procs=f, kind=k) for n, o, f, k in runs],
                           fleet_dir=str(root), allocations=allocs, total_chips=total,
                           policy=mod.FleetPolicy(move_cooldown=1))
    rng = np.random.default_rng(seed)
    decisions = []
    for tick in range(40):
        decisions += s.step(tick, _signals(mod, rng, fleet, tick), ts=1000.0 + tick)
    with open(s.history_path()) as f:
        records = [json.loads(line) for line in f]
    files = {}
    for name, *_ in runs:
        with open(s.allocation_path(name)) as f:
            files[name] = f.read()
    state = (s.alloc, s.free, s.pending, s.decisions, s.preemptions, s.last_decision_id)
    return decisions, records, files, s.exposition(), state


@pytest.mark.parametrize("fleet", sorted(FLEETS))
@pytest.mark.parametrize("seed", range(4))
def test_scheduler_replay_equals_jax(tmp_path, fleet, seed):
    ours = _replay(sched, fleet, seed, tmp_path / "port")
    theirs = _replay(jax_sched, fleet, seed, tmp_path / "jax")
    # decisions, fleet and tenancy records field for field (the same ts
    # was passed to both), allocation files, exposition, final pools
    assert ours == theirs
    decisions, records, *_ = ours
    assert decisions, "the replay moved no cards: the comparison would be vacuous"
    assert sched.audit_chip_seconds(records)["conserved"]
    if fleet == "tenancy":
        assert {d["cause"] for d in decisions} & {"serve_breach", "serve_release"}


def test_exposition_and_gauges_equal_jax(tmp_path):
    runs = [("a", 8, 2), ("b", 8, 2)]
    ours = sched.FleetScheduler([sched.RunSpec(*r) for r in runs],
                                allocations={"a": 8, "b": 4}, total_chips=12)
    theirs = jax_sched.FleetScheduler([jax_sched.RunSpec(*r) for r in runs],
                                      allocations={"a": 8, "b": 4}, total_chips=12)
    assert ours.exposition() == theirs.exposition()
    path = str(tmp_path / "fleet.prom")
    ours.write_exposition(path)
    assert export.scrape(textfile=path) == jax_export.scrape(textfile=path)
    assert export.scrape(textfile=path)['tpu_dist_fleet_allocation{run="b"}'] == 4.0
    from tpu_dist_torch.obs import counters

    assert counters.snapshot()["fleet.allocation.a"] == 8


def test_fleet_drill_fleet_phase(tmp_path):
    """The arbitration half of the drill (the counterpart of
    ``tests/test_fleet.py:776``): two port launchers over stub children, a
    real scrape, real decisions, real relaunches through their probes."""
    from tpu_dist_torch.fleet import drill

    assert drill.main(["--workdir", str(tmp_path), "--phase", "fleet"]) == 0
    worlds = {run: drill._worlds(os.path.join(tmp_path, "fleet", run, "worlds.txt"))
              for run in ("stalled", "compute")}
    assert worlds == {"stalled": [4, 2], "compute": [2, 4]}
