"""Per-process heartbeat files, the liveness signal for an outside
watchdog: the port's copy of ``tpu_dist/obs/heartbeat.py``.

Every process rewrites its own small JSON file (rank 0 the bare path,
rank k ``<path>.h<k>``: :func:`per_rank_path`) with a strictly monotonic
beat counter and its position; a watchdog that sees the counter stop
advancing knows the process is wedged, not slow. Writes are atomic
(temp file + ``os.replace``) and throttled (``min_interval``, default
1 s; ``force=True`` bypasses it). The file is removed on a clean exit
(:meth:`Heartbeat.sweep`): a leftover beat means the process died.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from tpu_dist_torch.obs import counters


class Heartbeat:
    """One writer per file (each process derives its own path)."""

    def __init__(self, path: str, min_interval: float = 1.0):
        self.path = path
        self.min_interval = min_interval
        self.counter = 0
        self._last_write = float("-inf")  # last ATTEMPT (drives the throttle)
        self._last_ok = float("-inf")     # last write that LANDED (drives age)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)

    def beat(
        self,
        *,
        epoch: Optional[int] = None,
        step: Optional[int] = None,
        phase: str = "train",
        force: bool = False,
    ) -> bool:
        """Advance the beat counter; write the file unless inside the
        throttle window (``force`` bypasses it). Returns True when the
        file was (re)written. Never raises on I/O: a full/absent disk must
        not kill the training step that beats."""
        self.counter += 1
        counters.inc("heartbeat.beats")
        now = time.monotonic()
        if not force and now - self._last_write < self.min_interval:
            return False
        self._last_write = now
        payload = {
            "counter": self.counter,
            "epoch": epoch,
            "step": step,
            "phase": phase,
            "ts": round(time.time(), 3),
            "mono_s": round(now, 3),
            "pid": os.getpid(),
        }
        tmp = self.path + ".tmp"
        try:
            # tpu-dist: ignore[TD002] — deliberately per-process I/O: each rank owns its derived heartbeat path
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path)
        except OSError:
            counters.inc("heartbeat.write_errors")
            return False
        self._last_ok = now
        return True

    def age(self) -> float:
        """Seconds since this writer's last beat LANDED on disk
        (monotonic) — the exporter publishes it as ``heartbeat.age_s``.
        Failed writes (full disk) do not reset it: the age must track the
        file an external watchdog reads, not our attempts. ``inf``
        before the first successful write."""
        last = self._last_ok
        return float("inf") if last == float("-inf") else time.monotonic() - last

    def sweep(self) -> None:
        """Remove the file — clean-exit signal. Best-effort by design."""
        for p in (self.path, self.path + ".tmp"):
            try:
                os.remove(p)
            except FileNotFoundError:
                pass
        _LAST_GOOD.pop(self.path, None)


def per_rank_path(base: str, rank: int) -> str:
    """The per-rank file naming of the heartbeat and of ``--per_host_log``
    alike: rank 0 keeps the bare path, rank k appends ``.h<k>``. The one
    definition in the port (``metrics/history.py`` imports it)."""
    return base if rank == 0 else f"{base}.h{rank}"


def sweep_stale_ranks(base: str, world: int) -> int:
    """Remove per-rank derived files (``base.h<k>``, plus their
    ``.tmp``) for ranks OUTSIDE the current world (``k >= world``).

    After a shrink (8 -> 4), the files of ranks 4-7 would linger and read
    as dead workers to a watchdog. Returns the number of files removed;
    best-effort (a racing unlink is fine: the file being gone is the
    goal)."""
    d = os.path.dirname(os.path.abspath(base))
    name = os.path.basename(base)
    prefix = name + ".h"
    removed = 0
    try:
        entries = os.listdir(d)
    except OSError:
        return 0
    for entry in entries:
        if not entry.startswith(prefix):
            continue
        suffix = entry[len(prefix):]
        core = suffix[:-4] if suffix.endswith(".tmp") else suffix
        if core.isdigit() and int(core) >= world:
            try:
                os.remove(os.path.join(d, entry))
                removed += 1
            # tpu-dist: ignore[TD006] — a racing unlink: the file is gone either way
            except OSError:
                pass
    return removed


# last successfully parsed beat per path: the torn-read fallback below.
# Process-local by design — each watchdog process keeps its own view.
_LAST_GOOD: dict = {}


def read(path: str) -> Optional[dict]:
    """Watchdog-side read; None when absent (clean exit or not started).

    Torn-read hardening: ``os.replace`` is atomic on POSIX local
    filesystems, but on NFS (and some overlay mounts) a reader racing
    the replace can observe a truncated/partial file. A beat that fails
    to parse is NOT a dead worker — so instead of reporting None (which
    a watchdog reads as "exited"), return the PREVIOUS good parse for
    this path and count it (``heartbeat.torn_reads``). A genuinely
    absent file still returns None and forgets the cache: absence is the
    clean-exit signal and must not be masked by a stale beat."""
    try:
        with open(path) as f:
            rec = json.load(f)
    except FileNotFoundError:
        _LAST_GOOD.pop(path, None)
        return None
    except (json.JSONDecodeError, OSError):
        counters.inc("heartbeat.torn_reads")
        return _LAST_GOOD.get(path)
    if isinstance(rec, dict):
        _LAST_GOOD[path] = rec
        return rec
    counters.inc("heartbeat.torn_reads")
    return _LAST_GOOD.get(path)
