"""Declarative threshold alerting over windows of metrics: the port's copy
of ``tpu_dist/obs/alerts.py`` (``AlertRule``, ``BUILTIN_RULES``,
``load_rules`` with its minimal TOML reader, ``AlertEngine``).

A rule names a metric, a comparator, a threshold, a sustain count and a
cooldown. The engine keeps each rule's streak: it fires when a breach
holds for ``sustain`` consecutive observations of its metric, then
cannot fire again for the next ``cooldown`` observations. A window
without the rule's metric neither advances nor resets its streak.
``delta`` rules compare the change since the metric's previous
observation (monotonic counters). Fired rules come back as
history-ready dicts (the ``alert`` record).

Spec grammar (TOML; JSON is the same shape as a list under ``rule``)::

    [[rule]]
    name = "stall_high"            # unique; the alert_active label
    metric = "data_stall_frac"     # flat metric path (counter names too)
    op = ">"                       # > < >= <=
    threshold = 0.3
    sustain = 2                    # consecutive breaching windows (>= 1)
    cooldown = 5                   # no re-fire for the next 5 observations
    # delta = true                 # rule on the per-window change
    # profile = true               # carried into the alert record

    [[rule]]
    builtin = "mfu_low"            # start from the library...
    threshold = 0.4                # ...and override fields

``default`` loads the whole built-in library. Stdlib only: Python 3.11+
parses TOML with ``tomllib``; older interpreters use a reader for exactly
the flat ``[[rule]]`` grammar above.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

_OPS = {
    ">": lambda v, t: v > t,
    "<": lambda v, t: v < t,
    ">=": lambda v, t: v >= t,
    "<=": lambda v, t: v <= t,
}


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative threshold rule (see the module grammar)."""

    name: str
    metric: str
    op: str
    threshold: float
    sustain: int = 1
    cooldown: int = 0
    delta: bool = False
    profile: bool = False

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(
                f"rule {self.name!r}: op must be one of {sorted(_OPS)}, "
                f"got {self.op!r}"
            )
        # type-check every numeric field at LOAD time: a quoted threshold
        # in a JSON spec must fail at Trainer construction, not as a
        # TypeError inside the fit loop hours later
        if isinstance(self.threshold, bool) or not isinstance(
            self.threshold, (int, float)
        ):
            raise ValueError(
                f"rule {self.name!r}: threshold must be a number, got "
                f"{self.threshold!r}"
            )
        if isinstance(self.sustain, bool) or not isinstance(self.sustain, int):
            raise ValueError(
                f"rule {self.name!r}: sustain must be an integer, got "
                f"{self.sustain!r}"
            )
        if isinstance(self.cooldown, bool) or not isinstance(self.cooldown, int):
            raise ValueError(
                f"rule {self.name!r}: cooldown must be an integer, got "
                f"{self.cooldown!r}"
            )
        if self.sustain < 1:
            raise ValueError(
                f"rule {self.name!r}: sustain must be >= 1, got {self.sustain}"
            )
        if self.cooldown < 0:
            raise ValueError(
                f"rule {self.name!r}: cooldown must be >= 0, got {self.cooldown}"
            )
        if not self.name or not self.metric:
            raise ValueError("rule needs a non-empty name and metric")


#: The JAX package's built-in library (``default``), each rule
#: overridable from a spec with ``builtin = "<name>"``. The port's trainer
#: observes none of these metrics yet; the serving rules
#: (``serve/slo.py::SLO_BUILTINS``) resolve ``builtin =`` against this
#: library too, so a spec that names one loads in both packages.
BUILTIN_RULES: Dict[str, AlertRule] = {
    r.name: r
    for r in (
        # input pipeline starving the step loop for 2 epochs straight
        AlertRule("stall_high", "data_stall_frac", ">", 0.30,
                  sustain=2, cooldown=3),
        # hardware paid for, math not happening
        AlertRule("mfu_low", "mfu", "<", 0.20, sustain=2, cooldown=3),
        # run-level time-to-useful-work floor (goodput ledger fraction)
        AlertRule("goodput_low", "goodput_frac", "<", 0.50,
                  sustain=2, cooldown=3),
        # numeric blow-up in flight: fire fast, capture the step timeline
        AlertRule("grad_norm_high", "grad_norm", ">", 1e3,
                  sustain=1, cooldown=50, profile=True),
        # a watchdog/tail-side rule: feed heartbeat_age_s from the file's
        # mtime clock; the trainer itself never observes this metric
        AlertRule("heartbeat_stale", "heartbeat_age_s", ">", 60.0,
                  sustain=1, cooldown=10),
        # ANY mid-run retrace is a full compile stall (delta of the
        # monotonic compile.retraces counter per window)
        AlertRule("retrace", "compile.retraces", ">", 0.0,
                  sustain=1, cooldown=1, delta=True, profile=True),
        # the worst chip is within 10% of its HBM ceiling for 2 windows
        # straight: the next shape change / fragmentation creep OOMs the
        # pod. Fed by the mem.headroom_frac gauge (free fraction of the
        # allocator's bytes_limit — obs/memory.py, trainer epoch gauges);
        # backends without allocator limits (CPU) never observe the
        # metric, so the rule stays silently unarmed there.
        AlertRule("memory_headroom_low", "mem.headroom_frac", "<", 0.10,
                  sustain=2, cooldown=3),
    )
}

_RULE_FIELDS = {f.name for f in dataclasses.fields(AlertRule)}


def _rule_from_dict(
    d: dict, idx: int, builtins: Optional[Dict[str, AlertRule]] = None
) -> AlertRule:
    d = dict(d)
    base: Optional[AlertRule] = None
    library = builtins if builtins is not None else BUILTIN_RULES
    builtin = d.pop("builtin", None)
    if builtin is not None:
        if builtin not in library:
            raise ValueError(
                f"rule #{idx}: unknown builtin {builtin!r}; have "
                f"{sorted(library)}"
            )
        base = library[builtin]
    unknown = set(d) - _RULE_FIELDS
    if unknown:
        raise ValueError(
            f"rule #{idx}: unknown field(s) {sorted(unknown)}; valid: "
            f"{sorted(_RULE_FIELDS)} (+ builtin)"
        )
    if base is not None:
        return dataclasses.replace(base, **d)
    missing = {"name", "metric", "op", "threshold"} - set(d)
    if missing:
        raise ValueError(
            f"rule #{idx}: missing required field(s) {sorted(missing)} "
            "(or name a builtin)"
        )
    return AlertRule(**d)


def _parse_toml_minimal(text: str, path: str) -> List[dict]:
    """The fallback TOML reader for interpreters without ``tomllib``
    (< 3.11): exactly the flat ``[[rule]]`` grammar the spec documents —
    comments, bare ``key = value`` scalars (quoted string / number /
    bool).  Anything else raises with a pointer to the JSON spec form
    rather than half-parsing."""
    rules: List[dict] = []
    cur: Optional[dict] = None
    for ln, raw in enumerate(text.splitlines(), start=1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if line == "[[rule]]":
            cur = {}
            rules.append(cur)
            continue
        if "=" in line and cur is not None:
            key, _, val = line.partition("=")
            key, val = key.strip(), val.strip()
            if val.startswith('"') and val.endswith('"') and len(val) >= 2:
                cur[key] = val[1:-1]
            elif val in ("true", "false"):
                cur[key] = val == "true"
            else:
                try:
                    cur[key] = int(val)
                except ValueError:
                    try:
                        cur[key] = float(val)
                    except ValueError:
                        raise ValueError(
                            f"{path}:{ln}: unsupported TOML value {val!r} "
                            "(this interpreter has no tomllib; the built-in "
                            "reader takes strings/numbers/bools only — or "
                            "use the JSON spec form)"
                        ) from None
            continue
        raise ValueError(
            f"{path}:{ln}: unsupported TOML construct {line!r} (the spec "
            "grammar is [[rule]] tables of scalar key = value lines; use "
            "the JSON form for anything else)"
        )
    return rules


def load_rules(
    spec: str, builtins: Optional[Dict[str, AlertRule]] = None
) -> List[AlertRule]:
    """``--alert_rules`` → validated rule list.  ``default``/``builtin``
    loads the library; otherwise the value is a ``.toml``/``.json`` path.
    Raises ValueError on a malformed spec (call it at construction, so a
    typo fails before any model or data work). ``builtins`` overrides the library ``builtin =`` references resolve
    against (and what ``default`` returns) — the serving SLO loader
    passes the merged training+serving set (``serve/slo.py``)."""
    if spec in ("default", "builtin"):
        return list((builtins if builtins is not None else BUILTIN_RULES).values())
    if spec.endswith(".json"):
        with open(spec) as f:
            data = json.load(f)
        raw = data.get("rule") if isinstance(data, dict) else data
    elif spec.endswith(".toml"):
        with open(spec) as f:
            text = f.read()
        try:
            import tomllib  # noqa: PLC0415 — 3.11+

            raw = tomllib.loads(text).get("rule")
        except ImportError:
            raw = _parse_toml_minimal(text, spec)
    else:
        raise ValueError(
            f"--alert_rules must be 'default' or a .toml/.json spec path, "
            f"got {spec!r}"
        )
    if not isinstance(raw, list) or not raw:
        raise ValueError(f"{spec}: expected a non-empty list of [[rule]] tables")
    rules = [
        _rule_from_dict(d, i, builtins) for i, d in enumerate(raw)
        if isinstance(d, dict) or _bad_entry(spec, i, d)
    ]
    names = [r.name for r in rules]
    dupes = sorted({n for n in names if names.count(n) > 1})
    if dupes:
        raise ValueError(f"{spec}: duplicate rule name(s) {dupes}")
    return rules


def _bad_entry(spec: str, idx: int, d) -> bool:
    raise ValueError(f"{spec}: rule #{idx} is not a table/object: {d!r}")


class AlertEngine:
    """Streak/cooldown state machine over a rule list.

    :meth:`observe` takes one flat metrics window (epoch rollup, counter
    snapshot, step fetch — whatever the caller has) and returns the
    rules that FIRED on it.  Per rule: a breaching observation of its
    metric advances the streak, a clean one resets it; the rule fires
    when the streak reaches ``sustain`` with no cooldown pending, then
    cannot re-fire for the next ``cooldown`` observations of that metric
    (a rate limit — breaching observations drain it too).
    ``delta`` rules breach on the change since the metric's previous
    observation (monotonic counters).  Pure host arithmetic."""

    def __init__(self, rules: List[AlertRule]):
        names = [r.name for r in rules]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate rule names in {names}")
        self.rules = list(rules)
        self._streak: Dict[str, int] = {r.name: 0 for r in rules}
        self._cooldown: Dict[str, int] = {r.name: 0 for r in rules}
        self._prev: Dict[str, float] = {}
        self._active: Dict[str, float] = {r.name: 0.0 for r in rules}
        self.fired_total = 0

    def seed_deltas(self, window: Dict[str, object]) -> None:
        """Baseline the delta rules at run start: later observations fire
        on the change relative to NOW. Without this, a counter born
        mid-run (``compile.retraces`` first exists at the first retrace)
        would spend its first sighting establishing a baseline and the
        retrace that created it would never alert. Metrics absent from
        ``window`` baseline at 0 — the registry convention for counters
        that have not fired yet."""
        for rule in self.rules:
            if not rule.delta or rule.name in self._prev:
                continue
            v = window.get(rule.metric, 0)
            self._prev[rule.name] = (
                float(v)
                if isinstance(v, (int, float)) and not isinstance(v, bool)
                else 0.0
            )

    def observe(self, window: Dict[str, object]) -> List[dict]:
        """Evaluate every rule whose metric appears in ``window``;
        returns the fired alerts as history-ready dicts."""
        fired: List[dict] = []
        for rule in self.rules:
            raw = window.get(rule.metric)
            if isinstance(raw, bool) or not isinstance(raw, (int, float)):
                continue  # not measured this window: state untouched
            value = float(raw)
            if rule.delta:
                prev = self._prev.get(rule.name)
                self._prev[rule.name] = value
                if prev is None:
                    continue  # first sighting: no delta yet
                value = value - prev
            breach = _OPS[rule.op](value, rule.threshold)
            # cooldown = a rate limit: after a fire, the NEXT N
            # observations of this metric (breaching or not — they drain
            # it either way) can never re-fire, however sustained
            cooling = self._cooldown[rule.name] > 0
            if cooling:
                self._cooldown[rule.name] -= 1
            self._streak[rule.name] = (
                self._streak[rule.name] + 1 if breach else 0
            )
            sustained = breach and self._streak[rule.name] >= rule.sustain
            self._active[rule.name] = 1.0 if sustained else 0.0
            if sustained and not cooling:
                self._cooldown[rule.name] = rule.cooldown
                self.fired_total += 1
                fired.append({
                    "rule": rule.name,
                    "metric": rule.metric,
                    "value": round(value, 6),
                    "threshold": rule.threshold,
                    "op": rule.op,
                    "sustained": self._streak[rule.name],
                    **({"delta": True} if rule.delta else {}),
                    **({"profile": True} if rule.profile else {}),
                })
        return fired

    def active(self) -> Dict[str, float]:
        """Rule → 0/1 view for the exporter's ``alert_active`` gauges: 1
        while the rule's condition is currently sustained (fired or
        holding through its cooldown), 0 once a clean window lands."""
        return dict(self._active)
