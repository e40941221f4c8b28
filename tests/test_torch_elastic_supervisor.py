"""The port's elastic relaunch policy (``tpu_dist_torch/elastic/
supervisor.py``) held against the JAX package's
(``tpu_dist/elastic/supervisor.py``) on the same inputs, case by case:

* the size functions (``feasible_sizes``, ``next_world_size``,
  ``grow_target``, ``shrink_target``) over a grid of original size,
  current size, survivors or available capacity, floor and ceiling;
* ``CapacityProbe.poll`` under a census and a clock scripted from a numpy
  seed (with ``reset_timer`` and unreadable censuses mixed in): the same
  target at every ``now``, the same grow count;
* ``supervise`` under scripted round results (whole-world preemptions,
  lost ranks, resizes, clean ends), with and without a probe, a stop
  request and a start size: the same world sizes, sleeps, announcements,
  return code and stand-down;
* ``RoundResult``'s census, the survivor exits, the decision env names,
  ``read_decision`` and ``stamp_decision_env``.

All of it is host arithmetic, exact in both packages, so the results are
compared for equality.
"""

import signal

import numpy as np
import pytest

from tpu_dist.elastic import supervisor as jax_sup
from tpu_dist.fleet import capacity as jax_capacity
from tpu_dist_torch.elastic import supervisor as sup
from tpu_dist_torch.fleet import capacity

ORIGINALS = [1, 2, 3, 4, 6, 8, 12]


@pytest.mark.parametrize("original", ORIGINALS)
def test_size_functions_equal_jax_over_a_grid(original):
    assert sup.feasible_sizes(original) == jax_sup.feasible_sizes(original)
    for survivors in range(0, original + 3):
        for floor in range(0, original + 2):
            assert (sup.next_world_size(original, survivors, floor)
                    == jax_sup.next_world_size(original, survivors, floor))
    for current in sup.feasible_sizes(original):
        for available in range(0, original + 3):
            for max_procs in range(0, original + 2):
                assert (sup.grow_target(original, current, available, max_procs)
                        == jax_sup.grow_target(original, current, available, max_procs))
            for floor in range(0, original + 2):
                assert (sup.shrink_target(original, current, available, floor)
                        == jax_sup.shrink_target(original, current, available, floor))


def _census_script(seed: int, n: int, original: int):
    """A census that answers from a seeded script: an int, None (no
    answer) or an unreadable source (OSError)."""
    rng = np.random.default_rng(seed)
    kinds = rng.choice(["int", "int", "int", "none", "oserror"], size=n)
    values = rng.integers(0, original + 3, size=n)
    out = []
    for k, v in zip(kinds, values):
        out.append(int(v) if k == "int" else (None if k == "none" else OSError))
    return out


def _scripted(script):
    it = iter(script)

    def census():
        v = next(it)
        if v is OSError:
            raise OSError("census source gone")
        return v

    return census


@pytest.mark.parametrize("seed", range(6))
def test_capacity_probe_poll_equals_jax_under_a_scripted_census(seed):
    rng = np.random.default_rng(100 + seed)
    original = int(rng.choice([2, 4, 6, 8]))
    steps = 60
    script = _census_script(seed, 4 * steps, original)
    interval = float(rng.choice([1.0, 2.5, 10.0]))
    floor = 1 if seed % 2 == 0 else int(rng.integers(1, original + 1))
    kw = dict(original=original, min_procs=floor,
              max_procs=int(rng.integers(0, original + 1)), interval=interval,
              cooldown_max=float(rng.choice([5.0, 60.0, 600.0])))
    ours = sup.CapacityProbe(_scripted(script), **kw)
    theirs = jax_sup.CapacityProbe(_scripted(script), **kw)
    now, current = 0.0, original
    seen = []
    for _ in range(steps):
        now += float(rng.choice([0.3, interval / 2, interval, 3 * interval]))
        if rng.random() < 0.1:
            ours.reset_timer(now=now)
            theirs.reset_timer(now=now)
            continue
        a, b = ours.poll(current, now=now), theirs.poll(current, now=now)
        assert a == b, (now, current)
        assert ours.grows == theirs.grows
        seen.append(a)
        if a is not None:
            current = a
    assert ours.available() == theirs.available()
    if floor == 1:  # the script moved the world: the comparison is not vacuous
        assert any(t is not None for t in seen)


def test_capacity_probe_validation_equals_jax():
    for kw in ({"original": 0}, {"original": 4, "interval": 0.0}):
        with pytest.raises(ValueError):
            sup.CapacityProbe(lambda: 1, **kw)
        with pytest.raises(ValueError):
            jax_sup.CapacityProbe(lambda: 1, **kw)


def _round_script(seed: int, nproc: int):
    """Scripted round results: (kind, payload) drawn from a seed; the
    round function turns each into a RoundResult of the size it was run
    at, so both supervisors see the same rounds."""
    rng = np.random.default_rng(seed)
    kinds = rng.choice(["pod", "pod", "lost", "resize", "crash", "clean"], size=12,
                       p=[0.25, 0.15, 0.2, 0.2, 0.1, 0.1])
    return [(str(k), int(rng.integers(0, nproc + 1)), int(rng.integers(1, nproc + 1)))
            for k in kinds]


def _round_fn(mod, script, calls):
    it = iter(script)

    def run_round(n, idx):
        calls.append((n, idx))
        kind, a, b = next(it, ("clean", 0, 0))
        if kind == "clean":
            return mod.RoundResult(0, {i: 0 for i in range(n)})
        if kind == "pod":
            return mod.RoundResult(75, {i: 75 for i in range(n)})
        if kind == "lost":
            lost = min(max(a, 1), n)
            exits = {i: (-signal.SIGKILL if i < lost else 75) for i in range(n)}
            return mod.RoundResult(75, exits)
        if kind == "crash":
            return mod.RoundResult(1, {i: (1 if i == 0 else -signal.SIGTERM) for i in range(n)})
        return mod.RoundResult(75, {i: 75 for i in range(n)}, resize_to=b)

    return run_round


def _drive(mod, script, *, nproc, census=None, stop_after=None, **kw):
    calls, sleeps, said = [], [], []
    asked = [0]

    def keep_going():
        asked[0] += 1
        return stop_after is None or asked[0] <= stop_after

    probe = None
    if census is not None:
        probe = mod.CapacityProbe(_scripted(census), original=nproc, interval=1.0)
    rc = mod.supervise(_round_fn(mod, script, calls), nproc=nproc, sleep=sleeps.append,
                       announce=said.append, should_continue=keep_going, probe=probe, **kw)
    return rc, calls, sleeps, said, asked[0]


@pytest.mark.parametrize("seed", range(10))
def test_supervise_equals_jax_under_scripted_rounds(seed):
    rng = np.random.default_rng(200 + seed)
    nproc = int(rng.choice([2, 4, 6, 8]))
    script = _round_script(seed, nproc)
    kw = dict(min_procs=int(rng.integers(1, nproc + 1)),
              max_restarts=int(rng.integers(0, 5)),
              backoff_base=float(rng.choice([0.01, 0.5])),
              same_size_retries=int(rng.integers(0, 3)))
    if seed % 3 == 1:
        kw["census"] = [v if v is not OSError else None
                        for v in _census_script(seed, 40, nproc)]
    if seed % 4 == 2:
        kw["stop_after"] = int(rng.integers(0, 3))
    if seed % 5 == 3:
        starts = [s for s in sup.feasible_sizes(nproc) if s >= kw["min_procs"]]
        kw["start_procs"] = int(rng.choice(starts))
    ours = _drive(sup, script, nproc=nproc, **kw)
    theirs = _drive(jax_sup, script, nproc=nproc, **kw)
    assert ours == theirs


@pytest.mark.parametrize("case", ["resize_free", "census_cap", "floor", "stand_down",
                                  "stop_in_backoff", "budget"])
def test_supervise_contract_cases_equal_jax(case):
    """The named cases of ``tests/test_fleet.py`` and ``tests/test_elastic.py``
    through both supervisors."""
    if case == "resize_free":  # resizes charge no budget and wait no backoff
        script = [("resize", 0, 4), ("resize", 0, 8), ("clean", 0, 0)]
        args = dict(nproc=8, min_procs=1, max_restarts=0)
        want = (0, [(8, 0), (4, 1), (8, 2)], [])
    elif case == "census_cap":  # the census caps a failure relaunch
        script = [("pod", 0, 0), ("clean", 0, 0)]
        args = dict(nproc=8, min_procs=1, max_restarts=3, census=[4] * 10)
        want = (0, [(8, 0), (4, 1)], [0.5])
    elif case == "floor":  # lost ranks leave no feasible size: the round's code
        script = [("lost", 1, 0)]
        args = dict(nproc=2, min_procs=2, max_restarts=5)
        want = (75, [(2, 0)], [])
    elif case == "stand_down":  # the launcher's own SIGTERM outranks a resize
        script = [("resize", 0, 8)]
        args = dict(nproc=4, min_procs=1, max_restarts=5, stop_after=0)
        want = (75, [(4, 0)], [])
    elif case == "stop_in_backoff":  # a stop during the backoff spawns nothing
        script = [("pod", 0, 0)]
        args = dict(nproc=2, min_procs=1, max_restarts=5, stop_after=1)
        want = (75, [(2, 0)], [0.5])
    else:  # the budget spent surfaces the last round's code
        script = [("pod", 0, 0)] * 3
        args = dict(nproc=1, min_procs=1, max_restarts=2)
        want = (75, [(1, 0), (1, 1), (1, 2)], [0.5, 1.0])
    ours = _drive(sup, script, **args)
    assert ours == _drive(jax_sup, script, **args)
    assert ours[:3] == want


def test_round_result_census_and_env_names_equal_jax():
    assert sup.SURVIVOR_EXITS == jax_sup.SURVIVOR_EXITS
    assert (sup.DECISION_ID_ENV, sup.DECISION_CAUSE_ENV) == (
        jax_sup.DECISION_ID_ENV, jax_sup.DECISION_CAUSE_ENV)
    exits = {0: 0, 1: 75, 2: -signal.SIGTERM, 3: -signal.SIGKILL, 4: 1, 5: 75}
    ours, theirs = sup.RoundResult(75, exits), jax_sup.RoundResult(75, exits)
    assert (ours.survivors(), ours.lost()) == (theirs.survivors(), theirs.lost()) == (4, 2)


@pytest.mark.parametrize("content", [None, "4\n", "4 decision=7 cause=goodput\n",
                                     "2 decision=12\n", "3 decision=x cause=\n", "garbage"])
def test_read_and_stamp_decision_equal_jax(tmp_path, content):
    path = str(tmp_path / "allocation")
    if content is not None:
        with open(path, "w") as f:
            f.write(content)
    assert sup.read_decision(path) == jax_sup.read_decision(path)
    assert sup.read_decision(None) == jax_sup.read_decision(None)
    stale = {sup.DECISION_ID_ENV: "99", sup.DECISION_CAUSE_ENV: "old", "OTHER": "1"}
    ours, theirs = dict(stale), dict(stale)
    meta = sup.stamp_decision_env(ours, path)
    assert meta == jax_sup.stamp_decision_env(theirs, path)
    assert ours == theirs
    # what the child's trainer reads back is what the launcher stamped
    want = {} if meta["decision_id"] is None else {"decision_id": meta["decision_id"]}
    if want and meta["cause"]:
        want["decision_cause"] = meta["cause"]
    assert sup.decision_from_env(ours) == want
    # the port reads the JAX package's file and the other way round
    capacity.write_allocation(path, 6, decision_id=3, cause="serve_breach")
    assert jax_sup.read_decision(path) == {"decision_id": 3, "cause": "serve_breach"}
    jax_capacity.write_allocation(path, 6, decision_id=4)
    assert sup.read_decision(path) == {"decision_id": 4, "cause": None}
