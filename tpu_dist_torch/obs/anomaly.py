"""Rolling-window anomaly detection over the per-step health scalars: the
port's copy of ``tpu_dist/obs/anomaly.py`` (the detector and its findings
are the JAX package's, record for record).

Host-side and stdlib only: the detector reads the metrics the trainer has
already fetched, so it adds no device work. The trainer feeds it at the
log cadence (the loss always, ``grad_norm`` and ``nonfinite_grads`` with
``--device_metrics``) and acts on the findings per ``--anomaly_action``:

* ``warn`` (default): a rank-0 warning and an ``anomaly`` history record.
* ``snapshot``: also a synchronous plain checkpoint off the ``ckpt_``
  namespace (``anomaly_<epoch>[_s<step>].npz``), stamped with the finding
  and the mid-epoch position, so the state before a divergence is on
  disk.
* ``off``: no detector.

Detection uses medians, not means (one spike must not drag its own
threshold up):

* **loss spike**: loss > ``loss_spike`` × the rolling median of the last
  ``window`` observations (median > 0 and the window warm).
* **grad-norm explosion**: grad_norm > ``grad_spike`` × the rolling
  median of recent grad norms.
* **nonfinite**: a non-finite loss or a positive ``nonfinite_grads``
  count, reported for the record; the trainer's NaN guard still raises.

After a finding the detector holds a per-kind cooldown (``min_points``
observations), so a plateau of bad steps yields one record, not one a
step. Observed values always enter the window: a genuine change of regime
stops firing once the median catches up.
"""

from __future__ import annotations

import math
from collections import deque
from statistics import median
from typing import List, Optional


class AnomalyDetector:
    def __init__(
        self,
        window: int = 50,
        loss_spike: float = 3.0,
        grad_spike: float = 10.0,
        min_points: Optional[int] = None,
    ):
        if window < 2:
            raise ValueError(f"anomaly window must be >= 2, got {window}")
        self.window = int(window)
        self.loss_spike = float(loss_spike)
        self.grad_spike = float(grad_spike)
        # warm-up/cooldown grain: enough points for a meaningful median,
        # never more than half the window
        self.min_points = (
            int(min_points) if min_points is not None
            else max(2, min(8, self.window // 2))
        )
        self._losses: deque = deque(maxlen=self.window)
        self._gnorms: deque = deque(maxlen=self.window)
        self._cooldown: dict = {}  # kind -> observations left to skip

    def _cooling(self, kind: str) -> bool:
        """Tick ``kind``'s cooldown on EVERY observation of its stream (not
        only on would-fire ones — a kind must come off cooldown after
        ``min_points`` observations regardless of what they looked like,
        or isolated later anomalies get silently swallowed)."""
        left = self._cooldown.get(kind, 0)
        if left > 0:
            self._cooldown[kind] = left - 1
            return True
        return False

    def _fire(self, kind: str, finding: dict) -> dict:
        self._cooldown[kind] = self.min_points
        return finding

    def _check_spike(
        self, kind: str, value: float, series: deque, factor: float,
        epoch, step,
    ) -> Optional[dict]:
        cooling = self._cooling(kind)
        out = None
        if not cooling and len(series) >= self.min_points:
            med = float(median(series))
            if med > 0.0 and value > factor * med:
                out = self._fire(kind, {
                    "anomaly": kind,
                    "epoch": epoch,
                    "step": step,
                    "value": round(value, 6),
                    "median": round(med, 6),
                    "ratio": round(value / med, 3),
                    "threshold": factor,
                })
        series.append(value)  # spikes enter the window too (self-limiting)
        return out

    def observe(
        self,
        *,
        epoch: Optional[int] = None,
        step: Optional[int] = None,
        loss: Optional[float] = None,
        grad_norm: Optional[float] = None,
        nonfinite: Optional[float] = None,
    ) -> List[dict]:
        """Feed one fetched-metrics observation; returns the (possibly
        empty) list of finding dicts — each self-describing enough to be a
        history record verbatim."""
        findings: List[dict] = []
        if loss is not None:
            loss = float(loss)
            if not math.isfinite(loss):
                if not self._cooling("nonfinite_loss"):
                    findings.append(self._fire("nonfinite_loss", {
                        "anomaly": "nonfinite_loss", "epoch": epoch,
                        "step": step, "value": str(loss),
                    }))
            else:
                self._cooling("nonfinite_loss")  # finite loss ticks it too
                f = self._check_spike(
                    "loss_spike", loss, self._losses, self.loss_spike,
                    epoch, step,
                )
                if f:
                    findings.append(f)
        if grad_norm is not None:
            grad_norm = float(grad_norm)
            if math.isfinite(grad_norm):
                f = self._check_spike(
                    "grad_norm_explosion", grad_norm, self._gnorms,
                    self.grad_spike, epoch, step,
                )
                if f:
                    findings.append(f)
        if nonfinite is not None:
            cooling = self._cooling("nonfinite_grads")
            if float(nonfinite) > 0 and not cooling:
                findings.append(self._fire("nonfinite_grads", {
                    "anomaly": "nonfinite_grads", "epoch": epoch,
                    "step": step, "value": float(nonfinite),
                }))
        return findings
