"""Triggered profiler captures on ``torch.profiler``: the port's counterpart
of ``tpu_dist/obs/profile.py``.

``--profile_dir`` alone captures the first epoch and nothing else; the
step worth a timeline is the one where something went wrong: the loss
spiked, a rank straggled. This module keeps the profiler disarmed until a
health signal fires, then captures a bounded window of steps:

* **Triggers** (``--profile_trigger``): anomaly findings and straggler
  flags arm a capture; ``auto`` enables every kind, a comma list
  (``anomaly,straggler``) selects. Anomaly captures run on rank 0; a
  straggler capture runs on the flagged rank, whose timeline explains the
  skew. ``retrace`` parses (as does ``auto``, which names it) but never
  arms: eager PyTorch compiles nothing per shape, so the port has no
  retrace to trigger on (``serve/engine.py``, ROADMAP Queue C).
* **Manual** (``--profile_steps a:b``): capture global steps ``[a, b)``.
* **Bounds**: a triggered capture covers ``--profile_window`` steps (a
  manual one its whole ``[a, b)``), captures are ``--profile_cooldown``
  steps apart, and at most ``--profile_max_captures`` triggered captures
  run in a process.

Each capture is a ``torch.profiler.profile`` of the CPU, and of CUDA when
the run's device is a card, started and stopped inside the rank's own
process (:func:`start_trace`, :func:`stop_trace`: one capture at a time,
as ``jax.profiler`` allows). On a card both ends synchronize first, so a
window holds exactly its steps' kernels. The stop writes
``<capture_dir>/rank<k>.trace.json.gz`` (Kineto's Chrome trace), which
the port's and the JAX package's ``find_traces`` walks both find, and
reads it back at once (:func:`analyze_capture_quietly`, ``obs/xprof.py``):
the trainer turns the analysis into a ``profile_analysis`` history record
and a rank-0 line. An analysis failure is counted
(``xprof.analyze_errors``) and reported in the event, never raised.

A capture failure (no profiler, a second capture active) is counted
(``profile.errors``) and disables further captures: forensics must not
kill the training step that tripped them. Arming is host bookkeeping, and
an open window only observes the step: the step's launches and
collectives are the same with a capture in flight.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional, Tuple

from tpu_dist_torch.obs import counters

#: Trigger kinds ``--profile_trigger`` may name (``auto`` = all three).
TRIGGER_KINDS = ("anomaly", "straggler", "retrace")

#: Each rank's trace file in a capture directory.
TRACE_NAME = "rank{rank}.trace.json.gz"

_ACTIVE: Optional[dict] = None  # the capture in flight: {"prof", "path", "cuda"}


def start_trace(logdir: str, *, device=None, rank: int = 0) -> None:
    """Start this process's one ``torch.profiler`` capture into
    ``logdir`` (CPU activity, and CUDA's when ``device`` is a card).
    Raises ``RuntimeError`` when a capture is already in flight."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError(f"a profiler capture is already active ({_ACTIVE['path']})")
    import torch  # noqa: PLC0415

    cuda = device is not None and torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)  # the window holds no earlier step's kernels
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _ACTIVE = {"prof": prof, "path": os.path.join(logdir, TRACE_NAME.format(rank=rank)),
               "cuda": device if cuda else None}


def capturing() -> bool:
    """Whether a capture is in flight in this process."""
    return _ACTIVE is not None


def stop_trace() -> str:
    """Stop the capture in flight and write its Chrome trace; returns the
    file's path. On a card the device is synchronized first, so the last
    step's kernels are in the trace."""
    global _ACTIVE
    if _ACTIVE is None:
        raise RuntimeError("no profiler capture is active")
    active, _ACTIVE = _ACTIVE, None
    import torch  # noqa: PLC0415

    if active["cuda"] is not None:
        torch.cuda.synchronize(active["cuda"])
    active["prof"].stop()
    active["prof"].export_chrome_trace(active["path"])
    return active["path"]


@contextlib.contextmanager
def trace(logdir: str, *, primary_only: bool = True, device=None, rank: int = 0
          ) -> Iterator[None]:
    """Profile a whole region to ``logdir`` (the ``--profile_dir`` alone
    first-epoch capture; read it with ``obs xprof``). ``primary_only``
    keeps the rank-0 discipline: other ranks run the region untraced."""
    if primary_only and rank != 0:
        yield
        return
    os.makedirs(logdir, exist_ok=True)
    start_trace(logdir, device=device, rank=rank)
    try:
        yield
    finally:
        stop_trace()


def annotate_step(step: int):
    """Mark a training step in a capture (a ``train_step`` range carrying
    the step's number, as JAX's ``StepTraceAnnotation`` does)."""
    import torch  # noqa: PLC0415

    return torch.profiler.record_function("train_step", args=str(step))


# --------------------------------------------------------------------------
# Auto-analysis of a closed capture (obs/xprof.py behind a never-raise wall)
# --------------------------------------------------------------------------


def analyze_capture_quietly(
    capture_dir: str, top_k: int = 10
) -> Tuple[Optional[dict], Optional[str]]:
    """Run the xprof analyzer over a freshly closed capture directory.
    Returns ``(compact_record, None)`` on success or ``(None, error)`` on
    any failure; NEVER raises (the hook runs inside the training process;
    ``xprof.analyze_errors`` counts what went wrong, and per-trace drops
    inside a partial report count into ``xprof.dropped_traces``)."""
    try:
        from tpu_dist_torch.obs import xprof  # noqa: PLC0415

        report = xprof.analyze_capture(capture_dir, top_k=top_k)
        rec = xprof.compact(report)
    except Exception as e:
        counters.inc("xprof.analyze_errors")
        return None, str(e)[:300]
    counters.inc("xprof.analyses")
    dropped = sum((report.get("dropped") or {}).values())
    if dropped:
        counters.inc("xprof.dropped_traces", dropped)
    return rec, None


def parse_trigger(spec: str) -> frozenset:
    """``off`` → empty set, ``auto`` → all kinds, else a comma list of
    :data:`TRIGGER_KINDS`. Raises ValueError on anything else."""
    spec = (spec or "off").strip().lower()
    if spec in ("off", ""):
        return frozenset()
    if spec == "auto":
        return frozenset(TRIGGER_KINDS)
    kinds = frozenset(p.strip() for p in spec.split(",") if p.strip())
    bad = kinds - frozenset(TRIGGER_KINDS)
    if bad:
        raise ValueError(
            f"unknown profile trigger(s) {sorted(bad)}; use 'off', 'auto', "
            f"or a comma list of {TRIGGER_KINDS}"
        )
    return kinds


def parse_steps(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    """``--profile_steps a:b`` → ``(a, b)`` global-step window ``[a, b)``.
    Raises ValueError on a malformed or empty range."""
    if not spec:
        return None
    parts = spec.split(":")
    try:
        a, b = (int(p) for p in parts)
    except (TypeError, ValueError):
        raise ValueError(
            f"--profile_steps must be 'a:b' (global steps, capture [a, b)), "
            f"got {spec!r}"
        ) from None
    if a < 0 or b <= a:
        raise ValueError(
            f"--profile_steps needs 0 <= a < b, got {spec!r} (empty window)"
        )
    return a, b


class TriggeredProfiler:
    """Bounded ``torch.profiler`` windows armed by health signals.

    The trainer calls :meth:`on_step` once a step (on the host, before the
    step) with the run-global step index; :meth:`arm` is called from the
    anomaly and straggler sites. Each capture lands in its own
    subdirectory of ``out_dir`` (``capture_<n>_s<step>_<reason>``).
    ``device`` is the run's device (CUDA activity is captured on a card),
    ``rank`` names the trace file.
    """

    def __init__(
        self,
        out_dir: str,
        *,
        window_steps: int = 8,
        cooldown_steps: int = 200,
        max_captures: int = 3,
        manual_range: Optional[Tuple[int, int]] = None,
        analyze: bool = True,
        device=None,
        rank: int = 0,
    ):
        if window_steps < 1:
            raise ValueError(f"window_steps must be >= 1, got {window_steps}")
        if cooldown_steps < 0 or max_captures < 0:
            raise ValueError("cooldown_steps/max_captures must be >= 0")
        self.out_dir = out_dir
        self.window_steps = window_steps
        self.cooldown_steps = cooldown_steps
        self.max_captures = max_captures
        self.manual_range = manual_range
        self.analyze = analyze  # run obs/xprof over every closed capture
        self.device = device
        self.rank = rank
        self.captures = 0            # triggered captures taken (cap applies)
        self._armed: Optional[str] = None
        self._active: Optional[dict] = None  # {"reason","start_step","dir"}
        self._last_stop_step: Optional[int] = None
        self._last_step: Optional[int] = None  # newest on_step() index seen
        self._manual_done = False
        self._broken = False         # a capture failed: no more attempts

    @property
    def armed(self) -> Optional[str]:
        return self._armed

    @property
    def active(self) -> bool:
        return self._active is not None

    def arm(self, reason: str) -> bool:
        """Request a capture starting at the next step. No-ops (False)
        while a capture is in flight, once the capture cap is spent, or
        after a capture failure."""
        if self._broken or self._active is not None:
            return False
        if self.captures >= self.max_captures:
            counters.inc("profile.skipped_capped")
            return False
        if self._armed is None:
            counters.inc("profile.armed")
        self._armed = reason
        return True

    def on_step(self, step: int) -> Optional[dict]:
        """Advance the capture state machine at global step ``step``.
        Returns a ``{"event": "start"|"stop"|"error", ...}`` dict when a
        window opened, closed or failed on this call (the trainer logs
        it), else None."""
        self._last_step = step
        if self._active is not None:
            # a manual capture owns its FULL [a, b) range; window_steps
            # bounds triggered captures only
            if self._active["reason"] == "manual":
                if self.manual_range is not None and step >= self.manual_range[1]:
                    return self._stop(step)
            elif step - self._active["start_step"] >= self.window_steps:
                return self._stop(step)
            return None
        if (
            self.manual_range is not None
            and not self._manual_done
            and self.manual_range[0] <= step < self.manual_range[1]
        ):
            self._manual_done = True
            return self._start(step, "manual")
        if self._armed is not None:
            if (
                self._last_stop_step is not None
                and step - self._last_stop_step < self.cooldown_steps
            ):
                return None  # stays armed; fires when the cooldown expires
            reason, self._armed = self._armed, None
            self.captures += 1
            return self._start(step, reason)
        return None

    def _start(self, step: int, reason: str) -> Optional[dict]:
        tag = "".join(
            c if c.isalnum() or c in "-_" else "_" for c in reason
        )[:48]
        n = self.captures if reason != "manual" else "manual"
        d = os.path.join(self.out_dir, f"capture_{n}_s{step}_{tag}")
        try:
            os.makedirs(d, exist_ok=True)
            start_trace(d, device=self.device, rank=self.rank)
        except Exception as e:
            # a second live capture, no profiler, a full disk: training
            # outranks forensics; record and stand down for good
            self._broken = True
            self._active = None
            counters.inc("profile.errors")
            return {"event": "error", "reason": reason, "error": str(e)[:200]}
        self._active = {"reason": reason, "start_step": step, "dir": d}
        counters.inc("profile.captures")
        return {
            "event": "start", "reason": reason, "step": step, "dir": d,
            "window_steps": (
                self.manual_range[1] - self.manual_range[0]
                if reason == "manual" and self.manual_range is not None
                else self.window_steps
            ),
        }

    def _stop(self, step: int) -> Optional[dict]:
        info, self._active = self._active, None
        self._last_stop_step = step
        try:
            stop_trace()
        except Exception as e:
            self._broken = True
            counters.inc("profile.errors")
            return {"event": "error", "reason": info["reason"],
                    "error": str(e)[:200]}
        ev = {
            "event": "stop", "reason": info["reason"],
            "start_step": info["start_step"], "stop_step": step,
            "steps": step - info["start_step"], "dir": info["dir"],
        }
        if self.analyze:
            # read the capture back now, while the trainer still knows
            # which steps it covered; failures are counted and reported
            analysis, err = analyze_capture_quietly(info["dir"])
            if analysis is not None:
                ev["analysis"] = analysis
            elif err is not None:
                ev["analysis_error"] = err
        return ev

    def close(self) -> Optional[dict]:
        """Stop any in-flight capture (every exit of ``fit``, error exits
        included): an unterminated capture would hold the profiler for the
        process's life. The stop event reports the steps that actually ran
        (the newest ``on_step`` index, not the planned window) and is
        flagged ``aborted`` so the record never overstates coverage."""
        if self._active is None:
            return None
        last = (
            self._last_step if self._last_step is not None
            else self._active["start_step"]
        )
        ev = self._stop(last + 1)
        if ev is not None and ev.get("event") == "stop":
            ev["aborted"] = True  # the run ended inside the window
        return ev
