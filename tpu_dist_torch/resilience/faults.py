"""Deterministic fault injection, the chaos harness behind ``--fault_plan``:
the port's copy of ``tpu_dist/resilience/faults.py``.

A *fault plan* is a semicolon-separated list of clauses::

    site@key=value[:key=value...]

Every trigger is a deterministic coordinate (a call count, an epoch, a
step, a batch index), never wall-clock time, so a plan replays the same
run after run. The grammar, the sites, the environment variable
(:data:`ENV_VAR`) and the corruption primitives are the JAX package's, so
one job spec drives either package. Sites:

``ckpt_write@call=K[:times=N][:errno=5]``
    Raise ``OSError(errno)`` from the K-th checkpoint write attempt
    (1-based, counted process-wide), for N consecutive attempts (default
    1). With ``--ckpt_io_retries`` the write succeeds once the clause is
    spent: the transient-EIO story.
``ckpt_corrupt@epoch=E[:mode=truncate|bitflip][:seed=S][:frac=0.5]``
    After ``ckpt_E.npz`` publishes, truncate it to ``frac`` of its bytes
    or flip 8 seeded bits in place: the torn or silently corrupted newest
    checkpoint the restore ladder must survive.
``nan_loss@step=S[:epoch=E]``
    Report a NaN training loss at step S (of epoch E; any epoch when
    omitted), through the NaN guard and ``auto_recover``.
``sigterm@step=S[:epoch=E]``
    Deliver a real ``SIGTERM`` to this process at step S: the preemption
    shutdown end to end, signal delivery included.
``rank_kill@step=S:rank=R[:epoch=E]``
    Deliver a real ``SIGKILL`` to process rank R at step S: no handler
    runs, no emergency save. A clause pinning a rank never fires on a
    process whose rank is unknown.
``loader_stall@batch=B[:epoch=E]``
    Kill the data loader's producer thread before it publishes batch B
    (it exits without its end-of-epoch sentinel): the consumer watchdog
    must raise instead of hanging the epoch.
``hang@step=S[:epoch=E][:rank=R][:seconds=T]``
    Wedge this process at step S: the hook sleeps in a loop (no
    exception, no exit code, the heartbeat frozen). The launcher's
    watchdog exists for this site: frozen-beat detection, the SIGUSR1
    stack dump (which names this loop), SIGTERM then SIGKILL, the
    postmortem bundle. ``seconds`` bounds the hang (0, the default, hangs
    for ever); SIGTERM does not end it, since the flag is read at step
    boundaries the process never reaches again.

Each clause fires ``times`` times (default 1) and then disarms. The
injection points call the ``on_*`` hooks below; with no plan installed
each hook is one global read and a ``None`` check. Every hook runs on the
host, so the step and the CUDA graph the fused epoch captures are the
same with or without a plan. Every firing increments the
``faults.injected`` counter (and ``faults.<site>``) of
:mod:`tpu_dist_torch.obs.counters`.

Stdlib only, beside the port's counter registry.
"""

from __future__ import annotations

import dataclasses
import os
import re
import signal
import time
from typing import Dict, FrozenSet, List, Optional

from tpu_dist_torch.obs import counters as _counters

#: The JAX package's variable, so one job spec reaches either package.
ENV_VAR = "TPU_DIST_FAULT_PLAN"

# action names surfaced to the trainer by on_step()
NAN_LOSS = "nan_loss"
SIGTERM = "sigterm"
RANK_KILL = "rank_kill"
HANG = "hang"

SITES = (
    "ckpt_write", "ckpt_corrupt", "nan_loss", "sigterm", "loader_stall",
    "rank_kill", "hang",
)

#: Sites that act at the step or batch grain, refused with --fused_epoch
#: (the whole epoch is one replayed graph: they would never fire).
STEPWISE_SITES = frozenset(
    ("nan_loss", "sigterm", "loader_stall", "rank_kill", "hang")
)

_CKPT_NAME_RE = re.compile(r"ckpt_(\d+)\.(?:npz|manifest\.json)$")

_INT_KEYS = {"call", "times", "errno", "epoch", "step", "batch", "seed", "rank"}
_ALLOWED_KEYS = {
    "ckpt_write": {"call", "times", "errno"},
    "ckpt_corrupt": {"epoch", "mode", "seed", "frac", "times"},
    "nan_loss": {"step", "epoch", "times"},
    "sigterm": {"step", "epoch", "times"},
    "loader_stall": {"batch", "epoch", "times"},
    "rank_kill": {"step", "rank", "epoch", "times"},
    "hang": {"step", "epoch", "rank", "seconds", "times"},
}
_REQUIRED_KEYS = {
    "ckpt_write": {"call"},
    "ckpt_corrupt": {"epoch"},
    "nan_loss": {"step"},
    "sigterm": {"step"},
    "loader_stall": {"batch"},
    "rank_kill": {"step", "rank"},
    "hang": {"step"},
}


class FaultPlanError(ValueError):
    """Malformed ``--fault_plan`` spec."""


@dataclasses.dataclass
class FaultClause:
    site: str
    params: Dict[str, object]
    fired: int = 0

    @property
    def times(self) -> int:
        return int(self.params.get("times", 1))

    def armed(self) -> bool:
        return self.fired < self.times

    def matches(self, **coords) -> bool:
        """Armed, and every coordinate the clause pins equals the site's
        current one (a parameter absent from ``coords`` is ignored: an
        unpinned ``epoch`` matches every epoch)."""
        if not self.armed():
            return False
        for key, want in self.params.items():
            if key in ("times", "mode", "seed", "frac", "errno", "seconds"):
                continue
            if key in coords and coords[key] != want:
                return False
        return True


class FaultPlan:
    """A parsed fault plan and its per-site deterministic counters."""

    def __init__(self, clauses: List[FaultClause], spec: str = ""):
        self.clauses = clauses
        self.spec = spec
        self.ckpt_write_calls = 0  # process-wide count of write attempts

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        clauses: List[FaultClause] = []
        for raw in spec.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            if "@" not in raw:
                raise FaultPlanError(
                    f"fault clause {raw!r} has no trigger — expected "
                    "site@key=value[:key=value...]"
                )
            site, _, rest = raw.partition("@")
            site = site.strip()
            if site not in SITES:
                raise FaultPlanError(f"unknown fault site {site!r}; have {SITES}")
            params: Dict[str, object] = {}
            for kv in rest.split(":"):
                if "=" not in kv:
                    raise FaultPlanError(
                        f"fault clause {raw!r}: bad parameter {kv!r} (expected key=value)"
                    )
                key, _, val = kv.partition("=")
                key = key.strip()
                if key not in _ALLOWED_KEYS[site]:
                    raise FaultPlanError(
                        f"fault site {site!r} does not take {key!r}; "
                        f"allowed: {sorted(_ALLOWED_KEYS[site])}"
                    )
                if key in _INT_KEYS:
                    try:
                        params[key] = int(val)
                    except ValueError as e:
                        raise FaultPlanError(
                            f"fault clause {raw!r}: {key} must be an integer, got {val!r}"
                        ) from e
                elif key in ("frac", "seconds"):
                    params[key] = float(val)
                else:
                    params[key] = val.strip()
            missing = _REQUIRED_KEYS[site] - set(params)
            if missing:
                raise FaultPlanError(
                    f"fault clause {raw!r} is missing required parameter(s) {sorted(missing)}"
                )
            mode = params.get("mode", "truncate")
            if site == "ckpt_corrupt" and mode not in ("truncate", "bitflip"):
                raise FaultPlanError(f"ckpt_corrupt mode must be truncate|bitflip, got {mode!r}")
            clauses.append(FaultClause(site, params))
        if not clauses:
            raise FaultPlanError(f"fault plan {spec!r} contains no clauses")
        return cls(clauses, spec)

    def _matching(self, site: str, **coords) -> List[FaultClause]:
        return [c for c in self.clauses if c.site == site and c.matches(**coords)]


# -- the process's plan (one a process) ------------------------------------------

_PLAN: Optional[FaultPlan] = None


def _record_fired(site: str) -> None:
    """Count every fault that lands, in total and per site."""
    _counters.inc("faults.injected")
    _counters.inc(f"faults.{site}")


def install(plan) -> FaultPlan:
    """Install a :class:`FaultPlan` (or parse a spec string) as the active
    plan and return it; its counters start fresh."""
    global _PLAN
    _PLAN = plan if isinstance(plan, FaultPlan) else FaultPlan.parse(plan)
    return _PLAN


def clear() -> None:
    global _PLAN
    _PLAN = None


def active() -> Optional[FaultPlan]:
    return _PLAN


def configure(spec: Optional[str]) -> Optional[FaultPlan]:
    """The trainer's entry point, once a construction: install ``spec``,
    else ``$TPU_DIST_FAULT_PLAN``; with neither, clear any plan installed
    before (a resumed run without ``--fault_plan`` must not replay the
    crashed run's faults)."""
    spec = spec or os.environ.get(ENV_VAR)
    if spec:
        return install(spec)
    clear()
    return None


# -- the injection hooks: one global read and a None check when off ---------------


def on_ckpt_write() -> None:
    """At the top of every checkpoint write attempt: raise the injected
    ``OSError`` when an armed ``ckpt_write`` clause covers this attempt's
    number. A retry is a new attempt, so ``call=1:times=2`` fails the first
    two attempts and a 2-retry ladder succeeds on the third."""
    plan = _PLAN
    if plan is None:
        return
    plan.ckpt_write_calls += 1
    for c in plan.clauses:
        if c.site != "ckpt_write" or not c.armed():
            continue
        first = int(c.params["call"])
        if first <= plan.ckpt_write_calls < first + c.times:
            c.fired += 1
            _record_fired("ckpt_write")
            eno = int(c.params.get("errno", 5))  # EIO
            raise OSError(
                eno,
                f"[fault-injected] checkpoint write failure "
                f"(call {plan.ckpt_write_calls}, clause {c.params})",
            )


def on_ckpt_published(path: str) -> Optional[str]:
    """After a checkpoint file is published: corrupt it in place when an
    armed ``ckpt_corrupt`` clause matches its epoch; returns the mode
    applied, or None."""
    plan = _PLAN
    if plan is None:
        return None
    m = _CKPT_NAME_RE.search(os.path.basename(path))
    if not m:
        return None
    epoch = int(m.group(1))
    for c in plan._matching("ckpt_corrupt", epoch=epoch):
        c.fired += 1
        _record_fired("ckpt_corrupt")
        mode = str(c.params.get("mode", "truncate"))
        if mode == "truncate":
            truncate_file(path, frac=float(c.params.get("frac", 0.5)))
        else:
            bitflip_file(path, seed=int(c.params.get("seed", 0)))
        return mode
    return None


def on_step(epoch: int, step: int, rank: Optional[int] = None) -> FrozenSet[str]:
    """Once a completed train step, on the host. Returns the actions the
    trainer must apply (``{'nan_loss'}``); a matching ``sigterm`` clause
    sends this process a real SIGTERM here, a matching ``rank_kill``
    clause (step and the caller's ``rank``) a real SIGKILL, and a matching
    ``hang`` clause never returns (or returns after its ``seconds``).
    ``rank=None`` never matches a rank-pinned clause."""
    plan = _PLAN
    if plan is None:
        return frozenset()
    actions = set()
    for c in plan._matching("nan_loss", epoch=epoch, step=step):
        c.fired += 1
        _record_fired("nan_loss")
        actions.add(NAN_LOSS)
    for c in plan._matching("sigterm", epoch=epoch, step=step):
        c.fired += 1
        _record_fired("sigterm")
        actions.add(SIGTERM)
        os.kill(os.getpid(), signal.SIGTERM)
    for c in plan._matching("rank_kill", epoch=epoch, step=step, rank=rank):
        c.fired += 1
        _record_fired("rank_kill")
        actions.add(RANK_KILL)
        # a hard death by design: no handler, no emergency save
        os.kill(os.getpid(), signal.SIGKILL)
    for c in plan._matching("hang", epoch=epoch, step=step, rank=rank):
        c.fired += 1
        _record_fired("hang")
        actions.add(HANG)
        # live but silent by design: only an outside watchdog ends it
        _hang(float(c.params.get("seconds", 0)))
    return frozenset(actions)


def _hang(seconds: float = 0) -> None:
    """Sleep in a loop, the stand-in for a deadlocked collective or stuck
    I/O. ``seconds <= 0`` hangs for ever (the drill: the watchdog's
    SIGKILL is the only way out); a bound makes the site usable in
    in-process tests. SIGUSR1 interrupts a sleep, the faulthandler dump
    runs, and the loop goes on, as in a real wedge."""
    deadline = time.monotonic() + seconds if seconds > 0 else None
    while deadline is None or time.monotonic() < deadline:
        time.sleep(0.25)


def on_loader_batch(batch: int, epoch: Optional[int] = None) -> Optional[str]:
    """In the loader's producer thread, before it publishes ``batch``:
    ``'die'`` when an armed ``loader_stall`` clause matches (the producer
    then exits without its sentinel, a thread killed mid-epoch)."""
    plan = _PLAN
    if plan is None:
        return None
    coords = {"batch": batch}
    if epoch is not None:
        coords["epoch"] = epoch
    for c in plan._matching("loader_stall", **coords):
        c.fired += 1
        _record_fired("loader_stall")
        return "die"
    return None


# -- the corruption primitives (the tests call them too) -------------------------


def truncate_file(path: str, frac: float = 0.5) -> None:
    """Truncate ``path`` to ``frac`` of its size: a torn write."""
    size = os.path.getsize(path)
    keep = max(1, int(size * frac)) if size else 0
    # only the process that owns the file corrupts it
    with open(path, "r+b") as f:
        f.truncate(keep)


def bitflip_file(path: str, seed: int = 0, nbits: int = 8) -> None:
    """Flip ``nbits`` seeded pseudo-random bits in the body of ``path``:
    silent corruption the zip directory may not notice. Deterministic: an
    LCG over (seed, i), no RNG state, no wall clock; the JAX package's
    bytes for the same arguments."""
    size = os.path.getsize(path)
    if size == 0:
        return
    # skip the first 64 bytes so the zip magic stays intact and the file
    # still looks like a checkpoint (the integrity layer must catch it)
    lo = min(64, size - 1)
    span = max(1, size - lo)
    with open(path, "r+b") as f:
        x = (seed * 6364136223846793005 + 1442695040888963407) & (2**64 - 1)
        for _ in range(nbits):
            x = (x * 6364136223846793005 + 1442695040888963407) & (2**64 - 1)
            off = lo + (x >> 33) % span
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ (1 << (x % 8))]))
