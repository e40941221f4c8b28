"""The comm/compute overlap autotuner (Layer 4b, ``tune-overlap``), the
port's counterpart of ``tpu_dist/analysis/overlap.py``: search the
collective-scheduling knobs the step exposes and pick, per config family,
the setting with the most overlap headroom. The knobs move WHEN
collectives run, never WHAT they carry:

- ``pmean_fusion`` (``dp_sgd``): one all-reduce of the flat gradients vs
  one a leaf: the same payload in more, smaller collectives.
- ``quant_chunk`` (``dp_int8``/``dp_int8_ef``): the int8 wire's
  quantization block; the payload is the same, the f32 scale sideband
  changes.
- ``rs_ag_chunks`` (``zero1_sgd``): ZeRO-1's reduce-scatter/all-gather
  pair in k column groups that tile the padded extent exactly.

TD121 pins that per candidate: the payload bucket of the executed
inventory (``shardlint.hlo_wire_buckets``) is byte for byte the family
baseline's, and the schedule must move. The ``--inject-payload`` probe
perturbs a recorded payload and the detector must fire (the CLI exits 2
when it does not).

The objective: with a profiler capture (``obs/xprof.py``) its measured
``overlap_frac``; without one the dispatch-schedule proxy (objective
``dispatch_schedule_proxy``, where JAX's is ``hlo_schedule_proxy``): for
each executed collective, the number of ops dispatched between it and the
first op that reads what it wrote (``step_audit.StepTrace.
schedule_distances``). The count of collective calls stands where JAX's
count of collective equations stands (``jaxpr_collectives``).

``tune_report.json`` (schema ``tune_report_v1``, which JAX's loader reads)
feeds ``planner.build_plan(tune_report=...)`` and the trainer's
``--tune_report``.
"""

from __future__ import annotations

import copy
import json
import re
from typing import Optional

from tpu_dist_torch.analysis.rules import Violation

SCHEMA = "tune_report_v1"
SCHEMA_VERSION = 1
_SCHEMA_RE = re.compile(r"^tune_report_v(\d+)$")

#: The objective without a capture.
PROXY_OBJECTIVE = "dispatch_schedule_proxy"


class TuneReportError(ValueError):
    """A tune_report.json failed schema validation on load."""


#: JAX's knob space, baseline ({}) first: every candidate is judged
#: against it. The quant_chunk values are sized to the proxy (a rank's row
#: of the 480 parameters is 60 to 480 elements at 8 to 1 ranks), so each
#: changes the scale sideband there.
KNOB_SPACE: dict = {
    "dp_sgd": [{}, {"pmean_fusion": "per_leaf"}],
    "dp_int8": [{}, {"quant_chunk": 16}, {"quant_chunk": 32}],
    "dp_int8_ef": [{}, {"quant_chunk": 16}, {"quant_chunk": 32}],
    "zero1_sgd": [{}, {"rs_ag_chunks": 2}, {"rs_ag_chunks": 4}],
}


def tunable_families() -> list:
    return sorted(KNOB_SPACE)


def schedule_metric(distances: list) -> dict:
    """The tuner's objective from a step's schedule distances
    (``StepTrace.schedule_distances``): ``mean_distance`` (higher: more
    work dispatched behind each collective, more overlap headroom)."""
    n = len(distances)
    total = sum(d["distance"] for d in distances)
    return {"collectives": n, "total_distance": total,
            "mean_distance": (total / n) if n else 0.0,
            "min_distance": min((d["distance"] for d in distances), default=0),
            "per_op": distances}


def overlap_frac_from_capture(capture_dir: str) -> Optional[float]:
    """Measured comm/compute ``overlap_frac`` of a ``torch.profiler``
    capture (``obs/xprof.py``), the objective when a device trace exists;
    None when the capture is unreadable (the proxy is used then)."""
    from tpu_dist_torch.obs import xprof as xprof_lib  # noqa: PLC0415

    try:
        return float(xprof_lib.analyze_capture(capture_dir)["overlap"]["overlap_frac"])
    except (xprof_lib.CaptureError, OSError, KeyError, TypeError, ValueError):
        return None


def compile_candidate(family: str, knobs: dict, device=None) -> dict:
    """Build the family's step with ``knobs`` over its
    ``family_step_kwargs``, run it once over the process group (every rank
    must call it) and measure: the payload/sideband buckets of its
    executed inventory (what TD121 pins), its op fingerprint, the schedule
    distances and the count of collective calls. The name is JAX's, which
    compiles where the port runs."""
    from tpu_dist_torch.analysis import shardlint, step_audit  # noqa: PLC0415
    from tpu_dist_torch.train.step import family_step_kwargs  # noqa: PLC0415

    kwargs = dict(family_step_kwargs(family))
    kwargs.update(knobs)
    step, args = step_audit._dp_setup(device, **kwargs)
    _, trace = step_audit.traced(step, *args)
    ops = trace.ops
    metric = schedule_metric(trace.schedule_distances())
    distances = [d["distance"] for d in metric.pop("per_op")]
    return {
        "family": family,
        "knobs": dict(knobs),
        "wire": shardlint.hlo_wire_buckets(ops),
        "collective_ops": len(ops),
        "jaxpr_collectives": len(trace.calls),
        "fingerprint": [[op.kind, op.dtype, op.elems] for op in ops],
        "distances": distances,
        "schedule": metric,
    }


def _payload_key(entry: dict) -> tuple:
    w = entry.get("wire") or {}
    return (
        int(w.get("payload_bytes", -1)),
        int(w.get("quantized_payload_bytes", -1)),
    )


def check_candidate(
    family: str, baseline: dict, cand: dict
) -> list[Violation]:
    """The TD121 gate for one measured candidate against its family
    baseline: payload bucket byte-identical, schedule metric moved."""
    out: list[Violation] = []
    if not cand.get("knobs"):
        return out  # the baseline is its own reference
    where = f"<tune:{family}:{json.dumps(cand['knobs'], sort_keys=True)}>"
    if _payload_key(cand) != _payload_key(baseline):
        out.append(Violation(
            rule="TD121", path=where, line=0,
            message=(
                "knob changed the payload-byte inventory: baseline "
                f"payload={baseline.get('wire', {}).get('payload')} vs "
                f"candidate payload={cand.get('wire', {}).get('payload')} "
                "— tuner knobs must be schedule-only transforms"
            ),
        ))
    moved = (
        cand.get("fingerprint") != baseline.get("fingerprint")
        or cand.get("distances") != baseline.get("distances")
        or cand.get("jaxpr_collectives") != baseline.get("jaxpr_collectives")
    )
    if not moved:
        out.append(Violation(
            rule="TD121", path=where, line=0,
            message=(
                "knob did not move the collective schedule (identical "
                "executed op sequence, first-consumer distances, and "
                "collective-call count) — a vacuous knob poisons the "
                "search space"
            ),
        ))
    return out


def tune(device=None, names=None, capture_dir: Optional[str] = None) -> tuple:
    """Run every candidate of :data:`KNOB_SPACE` (of ``names`` when given;
    every rank of the process group must call it), gate each through
    TD121 and choose per family the TD121-clean candidate with the highest
    mean schedule distance, serialized knobs breaking ties. Failures are
    counted in ``skips``, never silent (a skipped family is CLI exit 2)."""
    from tpu_dist_torch.analysis import shardlint  # noqa: PLC0415
    from tpu_dist_torch.comm import collectives  # noqa: PLC0415

    fams = list(names) if names else tunable_families()
    measured_frac = overlap_frac_from_capture(capture_dir) if capture_dir else None
    families: dict = {}
    skips: dict = {}
    violations: list = []
    for fam in fams:
        if fam not in KNOB_SPACE:
            skips[fam] = f"no tunable knobs registered; tunable: {tunable_families()}"
            continue
        space = KNOB_SPACE[fam]
        try:
            baseline = compile_candidate(fam, space[0], device)
        except Exception as e:  # noqa: BLE001 — skip-with-count, as JAX's
            skips[fam] = f"{type(e).__name__}: {e}"
            continue
        cands = [baseline]
        for knobs in space[1:]:
            try:
                cand = compile_candidate(fam, knobs, device)
            except Exception as e:  # noqa: BLE001
                skips[f"{fam}:{json.dumps(knobs, sort_keys=True)}"] = f"{type(e).__name__}: {e}"
                continue
            vs = check_candidate(fam, baseline, cand)
            cand["td121"] = {"clean": not vs, "violations": [v.to_json() for v in vs]}
            violations.extend(vs)
            cands.append(cand)
        eligible = [c for c in cands if not c.get("knobs") or c.get("td121", {}).get("clean")]
        chosen = max(eligible, key=lambda c: (c["schedule"]["mean_distance"],
                                              json.dumps(c["knobs"], sort_keys=True)))
        base_mean = baseline["schedule"]["mean_distance"]
        families[fam] = {
            "baseline": baseline,
            "candidates": cands,
            "chosen": {
                "knobs": chosen["knobs"],
                "schedule": chosen["schedule"],
                "gain_frac": (chosen["schedule"]["mean_distance"] / base_mean - 1.0
                              if base_mean else 0.0),
            },
        }
    report = {
        "schema": SCHEMA,
        **shardlint.environment(device),
        "n_devices": collectives.world_size(),
        "objective": "xprof_overlap_frac" if measured_frac is not None else PROXY_OBJECTIVE,
        "measured_overlap_frac": measured_frac,
        "families": families,
        "skips": skips,
        "counts": {"families": len(families), "skipped": len(skips),
                   "violations": len(violations)},
    }
    return report, violations


def chosen_knobs(report: dict, family: str) -> dict:
    """The tuner's chosen knob dict for ``family`` (``{}`` when the
    family was not tuned / the baseline won) — the planner/trainer
    consumption hook."""
    entry = (report.get("families") or {}).get(family) or {}
    return dict((entry.get("chosen") or {}).get("knobs") or {})


# --------------------------------------------------------------------------
# TD121 acceptance probe
# --------------------------------------------------------------------------


def inject_payload(report: dict) -> dict:
    """The TD121 acceptance probe (the planner's ``inject_miscost``
    twin): a deep copy of ``report`` where every non-baseline
    candidate's recorded payload bytes are deterministically perturbed
    (doubled + 1). :func:`recheck_report` over the result MUST flag
    TD121 — a clean verdict means the detector is dead (CLI exit 2)."""
    out = copy.deepcopy(report)
    for entry in (out.get("families") or {}).values():
        for cand in entry.get("candidates") or []:
            if not cand.get("knobs"):
                continue
            w = cand.setdefault("wire", {})
            w["payload_bytes"] = int(w.get("payload_bytes", 0)) * 2 + 1
    return out


def recheck_report(report: dict) -> list[Violation]:
    """Re-run the TD121 gate over a report's RECORDED inventories (no
    recompile — this is the probe verifier and the cheap CI re-gate)."""
    out: list[Violation] = []
    for fam, entry in (report.get("families") or {}).items():
        baseline = entry.get("baseline") or {}
        for cand in entry.get("candidates") or []:
            out.extend(check_candidate(fam, baseline, cand))
    return out


# --------------------------------------------------------------------------
# tune_report.json — save / load (forward-compat), rendering
# --------------------------------------------------------------------------

_REQUIRED_CHOSEN_KEYS = ("knobs", "schedule")


def save_tune_report(report: dict, path: str) -> None:
    from tpu_dist_torch.analysis.shardlint import save_json  # noqa: PLC0415

    save_json(report, path)


def load_tune_report(path: str) -> dict:
    """Schema-pinned loader with the planner's forward-compat
    discipline: the tag must parse as ``tune_report_v<N>``; a NEWER
    version is tolerated — family entries missing the v1 keys are
    skipped with a count into ``load_notes`` — while a foreign tag, an
    older-than-supported version, or a same-version entry missing
    required keys raises the typed :class:`TuneReportError`."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise TuneReportError(f"{path}: not a JSON object")
    tag = data.get("schema")
    m = _SCHEMA_RE.match(tag) if isinstance(tag, str) else None
    if not m:
        raise TuneReportError(
            f"{path}: schema {tag!r} is not a tune_report tag — "
            "regenerate with `make tune-overlap`"
        )
    ver = int(m.group(1))
    if ver < SCHEMA_VERSION:
        raise TuneReportError(
            f"{path}: schema {tag!r} predates v{SCHEMA_VERSION} — "
            "regenerate with `make tune-overlap`"
        )
    newer = ver > SCHEMA_VERSION
    fams = data.get("families")
    if not isinstance(fams, dict):
        raise TuneReportError(f"{path}: no 'families' mapping")
    skipped: dict = {}
    kept: dict = {}
    for fam, entry in fams.items():
        chosen = entry.get("chosen") if isinstance(entry, dict) else None
        missing = (
            [k for k in _REQUIRED_CHOSEN_KEYS if k not in chosen]
            if isinstance(chosen, dict) else list(_REQUIRED_CHOSEN_KEYS)
        )
        if not missing:
            kept[fam] = entry
            continue
        if not newer:
            raise TuneReportError(
                f"{path}: family {fam!r} chosen entry is missing {missing}"
            )
        skipped[fam] = missing
    data["families"] = kept
    if newer:
        data["load_notes"] = {
            "newer_schema": tag,
            "reader_version": SCHEMA_VERSION,
            "skipped_families": skipped,
            "skipped_count": len(skipped),
        }
    return data


def format_text(report: dict) -> str:
    lines = [
        f"tune-overlap [{report.get('schema')}] "
        f"backend={report.get('backend')} "
        f"n_devices={report.get('n_devices')} "
        f"objective={report.get('objective')}",
    ]
    for fam, entry in sorted((report.get("families") or {}).items()):
        chosen = entry.get("chosen") or {}
        base = (entry.get("baseline") or {}).get("schedule") or {}
        lines.append(
            f"  {fam}: chosen={json.dumps(chosen.get('knobs'), sort_keys=True)} "
            f"mean_dist {base.get('mean_distance', 0):.2f} -> "
            f"{(chosen.get('schedule') or {}).get('mean_distance', 0):.2f} "
            f"({chosen.get('gain_frac', 0.0):+.1%})"
        )
        for cand in entry.get("candidates") or []:
            if not cand.get("knobs"):
                continue
            td = cand.get("td121") or {}
            tag = "ok" if td.get("clean") else "TD121-VIOLATION"
            lines.append(
                f"    cand {json.dumps(cand['knobs'], sort_keys=True)}: "
                f"mean_dist={cand['schedule']['mean_distance']:.2f} "
                f"payload={_payload_key(cand)[0]}B [{tag}]"
            )
    for key, why in sorted((report.get("skips") or {}).items()):
        lines.append(f"  SKIP {key}: {why}")
    c = report.get("counts") or {}
    lines.append(
        f"  families={c.get('families')} skipped={c.get('skipped')} "
        f"violations={c.get('violations')}"
    )
    return "\n".join(lines)
