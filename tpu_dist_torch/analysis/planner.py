"""Layer 4: the static ``--auto_shard`` planner, the port's counterpart of
``tpu_dist/analysis/planner.py``. The plan loop is JAX's:

1. **Enumerate** the train-kind families of the shardlint registry whose
   ``min_devices`` fit the world (``train/step.py::SHARD_CONFIG_FAMILIES``
   via ``analysis/shardlint.py``).
2. **Price** each with ``obs/costmodel.py::predicted_step_time``: the
   family step's counted FLOPs and bytes over the calibration rates, plus
   the ring-model wire bytes of its executed collectives.
3. **Filter** against the per-rank static memory ledger through
   ``obs/memory.py::preflight_check(action="refuse")``, the path
   ``--memory_check refuse`` takes: an infeasible candidate is refused with
   the typed ``InfeasibleMemoryError``, counted, never dropped silently.
4. **Rank** deterministically (predicted step time, family-name tie-break)
   into the schema-pinned ``plan_report.json`` (:data:`SCHEMA`).

* **TD118** ``plan-must-verify``: :func:`verify_plan` reruns the chosen
  family fresh through shardlint and requires its executed inventory (per
  kind ops, elements, bytes, and the total wire bytes) to be the priced
  one; the ``--inject-miscost`` probe (:func:`inject_miscost`) must be
  caught (the CLI exits 2 when it is not).
* **TD119** ``planner-error-tracked``: after a profiled run the trainer
  logs the predicted against the achieved step time as
  ``planner_error_frac`` in a ``plan`` record.

Pricing from a shard report is pure arithmetic; building the report runs
each family's step once over the process group.
"""

from __future__ import annotations

import copy
import json
import re
from typing import Optional

from tpu_dist_torch.analysis.rules import Violation

SCHEMA = "plan_report_v1"
SCHEMA_VERSION = 1
_SCHEMA_RE = re.compile(r"^plan_report_v(\d+)$")


class PlanReportError(ValueError):
    """A plan_report.json failed schema validation on load."""


#: Uncalibrated pricing rates (FLOP/s and bytes/s a device, overlap
#: fraction) used when no ``cost.calibration_*`` capture has been
#: published: JAX's fixed constants. They are no chip's measured rate, the
#: H100's included; they are one fixed pair that reduces the ranking to the
#: candidates' relative FLOP, byte and wire volumes and keeps the plan a
#: pure function of its inputs. A profiled capture's ``cost.calibration_*``
#: gauges replace them (:func:`pricing_gauges`).
UNCALIBRATED_RATES = {
    "cost.calibration_flops_per_s": 1.0e12,
    "cost.calibration_bytes_per_s": 1.0e11,
    "cost.calibration_overlap_frac": 0.0,
}

#: Families ``--auto_shard apply`` may rewrite a TrainConfig to: the flag
#: overrides that select each family on the real model. tp/sp stay
#: plan-only (their way counts need model support: ``--tp``/``--sp`` stay
#: explicit decisions).
FAMILY_TRAIN_OVERRIDES: dict = {
    "dp_sgd": {},
    "dp_sgd_accum4": {"grad_accu_steps": 4},
    "dp_bf16": {"bf16": True},
    "dp_wire_bf16": {"grad_compression": "bf16"},
    "dp_int8": {"grad_compression": "int8"},
    "dp_int8_ef": {"grad_compression": "int8_ef"},
    "zero1_sgd": {"shard_weight_update": True},
    "zero1_int8": {"shard_weight_update": True, "grad_compression": "int8"},
    "fsdp": {"fsdp": True},
}


def family_train_overrides(name: str) -> dict:
    """The :class:`TrainConfig` field overrides that apply family
    ``name`` to a real training run; raises ``KeyError`` with the
    applyable set for plan-only families (tp_vit/sp_vit)."""
    if name not in FAMILY_TRAIN_OVERRIDES:
        raise KeyError(
            f"family {name!r} is plan-only (not auto-applyable); "
            f"applyable: {sorted(FAMILY_TRAIN_OVERRIDES)}"
        )
    return dict(FAMILY_TRAIN_OVERRIDES[name])


def family_of(
    *,
    grad_compression: str = "none",
    bf16: bool = False,
    grad_accu_steps: int = 1,
    shard_weight_update: bool = False,
    fsdp: bool = False,
) -> Optional[str]:
    """The :data:`FAMILY_TRAIN_OVERRIDES` label of a flag combo — the
    inverse lookup bench.py uses to stamp which planner family a measured
    record corresponds to. ``None`` for combos outside the registry
    (e.g. bf16 compute + int8 wire together): an honest "no label" beats
    the nearest-match guess."""
    flags: dict = {}
    if grad_compression != "none":
        flags["grad_compression"] = grad_compression
    if bf16:
        flags["bf16"] = True
    if grad_accu_steps > 1:
        flags["grad_accu_steps"] = grad_accu_steps
    if shard_weight_update:
        flags["shard_weight_update"] = True
    if fsdp:
        flags["fsdp"] = True
    for name, overrides in FAMILY_TRAIN_OVERRIDES.items():
        if overrides == flags:
            return name
    return None


def pricing_gauges(gauges: Optional[dict] = None) -> tuple[dict, str]:
    """The rate gauges one plan prices every candidate with: the
    uncalibrated defaults, overlaid with any live ``cost.calibration_*``
    gauges (a capture ran), overlaid with ``gauges`` (tests / replaying
    a recorded calibration). Returns ``(gauges, source)`` where source
    is ``"calibrated"`` when any measured rate survived into the set —
    the report stamps it so a ranking priced on defaults can never be
    mistaken for a measured one."""
    from tpu_dist_torch.obs import counters as counters_lib  # noqa: PLC0415

    out = dict(UNCALIBRATED_RATES)
    source = "uncalibrated-defaults"
    live = {
        k: v for k, v in counters_lib.snapshot().items()
        if k.startswith("cost.calibration_")
    }
    for layer in (live, gauges or {}):
        for k, v in layer.items():
            if isinstance(v, (int, float)):
                out[k] = v
                if k in ("cost.calibration_flops_per_s",
                         "cost.calibration_bytes_per_s"):
                    source = "calibrated"
    return out, source


def plan_candidates(n_devices: int, names=None) -> list:
    """The search space: every registered *train*-kind shardlint family
    whose ``min_devices`` fits (serve families price a different
    objective and stay out). Deterministic order (sorted names)."""
    from tpu_dist_torch.analysis import shardlint  # noqa: PLC0415

    out = []
    for name in sorted(names if names is not None
                       else shardlint.registered_families()):
        fam = shardlint._FAMILIES.get(name)
        if fam is None or fam.kind != "train":
            continue
        if fam.min_devices > n_devices:
            continue
        out.append(name)
    return out


def priced_inventory_of(entry: dict) -> dict:
    """The TD118 basis extracted from one shard-report family entry: the
    per-kind executed-collective counts the plan's price rests on."""
    by_kind = (entry.get("hlo") or {}).get("by_kind") or {}
    return {
        kind: {
            "ops": int(e.get("ops", 0)),
            "elems": int(e.get("elems", 0)),
            "bytes": int(e.get("bytes", 0)),
        }
        for kind, e in sorted(by_kind.items())
    }


def price_candidate(
    name: str, entry: dict, *, n_devices: int, gauges: dict,
) -> dict:
    """One ranked-table row from a shard-report family entry: the
    calibrated step-time prediction over the entry's XLA cost + HLO
    ring-model wire bytes, plus the static HBM requirement and the
    priced collective inventory TD118 later verifies."""
    from tpu_dist_torch.obs import costmodel  # noqa: PLC0415

    hlo = entry.get("hlo") or {}
    wire_bytes = hlo.get("bytes")
    cost = entry.get("cost") or {}
    predicted = costmodel.predicted_step_time(
        cost, wire_bytes=wire_bytes, n_devices=n_devices, gauges=gauges,
    )
    hbm = entry.get("hbm") or {}
    return {
        "family": name,
        "mesh": entry.get("mesh"),
        "config": entry.get("config"),
        "note": entry.get("note", ""),
        "wire_bytes": wire_bytes,
        "cost": {
            "flops_per_step": cost.get("flops_per_step"),
            "bytes_per_step": cost.get("bytes_per_step"),
        },
        "static_bytes_per_device": hbm.get("static_bytes_per_device"),
        "predicted": predicted,
        "predicted_step_s": predicted.get("predicted_step_s"),
        "priced_inventory": priced_inventory_of(entry),
        "applyable": name in FAMILY_TRAIN_OVERRIDES,
    }


def build_plan(
    *,
    device=None,
    names=None,
    hbm_budget_bytes: Optional[int] = None,
    memory_headroom: float = 0.9,
    gauges: Optional[dict] = None,
    shard_report: Optional[dict] = None,
    applyable_only: bool = False,
    tune_report: Optional[dict] = None,
) -> dict:
    """Search the family space and return the schema-pinned plan report.

    ``shard_report``: a loaded ``shard_report.json`` dict — candidates
    are priced from its family entries instead of recompiling (the
    ``--from-report`` path). ``gauges`` overrides the calibration rates
    (determinism in tests; replaying a recorded capture).
    ``applyable_only`` restricts the space to
    :data:`FAMILY_TRAIN_OVERRIDES` (the ``--auto_shard apply`` search).
    ``tune_report``: a loaded ``tune_report.json`` dict
    (``analysis/overlap.py``) — every candidate row (and the chosen
    plan) gets the tuner's chosen schedule knobs attached as
    ``tune_knobs``, so an applied plan carries its overlap tuning along.
    Knobs never change the ranking: they are schedule-only transforms
    (TD121), and the priced wire bytes are knob-invariant by
    construction.

    Infeasible candidates are refused through
    :func:`tpu_dist_torch.obs.memory.preflight_check(action="refuse")` — the
    typed :class:`InfeasibleMemoryError` path ``--memory_check`` uses —
    and land in ``refused`` with their byte arithmetic; build/run
    failures land in ``skips``. Both are counted, never silent. The
    result is a pure function of (families, device count, gauges,
    budget): no wall clock, no environment reads beyond the world size
    and the card's kind. Without ``shard_report`` every rank of the process
    group must call it (each family's step runs over the group)."""
    from tpu_dist_torch.analysis import shardlint  # noqa: PLC0415
    from tpu_dist_torch.comm import collectives  # noqa: PLC0415
    from tpu_dist_torch.obs import costmodel  # noqa: PLC0415
    from tpu_dist_torch.obs import memory as memory_lib  # noqa: PLC0415

    n_devices = (
        int(shard_report.get("n_devices", collectives.world_size()))
        if shard_report is not None else collectives.world_size()
    )
    gauges, gauge_source = pricing_gauges(gauges)
    budget = hbm_budget_bytes
    if budget is None:
        budget = costmodel.chip_hbm_bytes()

    cands = plan_candidates(n_devices, names)
    if applyable_only:
        cands = [c for c in cands if c in FAMILY_TRAIN_OVERRIDES]

    rows: list = []
    refused: dict = {}
    skips: dict = {}
    for name in cands:
        if shard_report is not None:
            entry = (shard_report.get("families") or {}).get(name)
            if entry is None:
                skips[name] = "not in the supplied shard report"
                continue
        else:
            try:
                entry, _ = shardlint.shard_case(name, device)
            except Exception as e:
                skips[name] = f"{type(e).__name__}: {e}"
                continue
        row = price_candidate(
            name, entry, n_devices=n_devices, gauges=gauges
        )
        required = row["static_bytes_per_device"]
        if required is None:
            skips[name] = "no static HBM ledger in the family entry"
            continue
        if row["predicted_step_s"] is None:
            skips[name] = "unpriceable: XLA cost analysis reported nothing"
            continue
        try:
            row["feasibility"] = memory_lib.preflight_check(
                required, budget_bytes=budget,
                headroom=memory_headroom, action="refuse",
            )
        except memory_lib.InfeasibleMemoryError as e:
            refused[name] = {
                "error": f"{type(e).__name__}: {e}",
                "required_bytes": required,
                "budget_bytes": budget,
                "headroom": memory_headroom,
            }
            continue
        rows.append(row)

    # deterministic ranking: fastest predicted step first, family name
    # breaks exact ties (the dp variants price identically on tiny
    # proxies) — NEVER dict order or wall clock
    rows.sort(key=lambda r: (r["predicted_step_s"], r["family"]))
    for i, row in enumerate(rows):
        row["rank"] = i + 1
    if tune_report is not None:
        from tpu_dist_torch.analysis import overlap as overlap_lib  # noqa: PLC0415

        for row in rows:
            row["tune_knobs"] = overlap_lib.chosen_knobs(
                tune_report, row["family"]
            )

    # priced from a report alone, the plan describes the report's run
    env = (shardlint.environment(device) if shard_report is None or device is not None
           else {k: shard_report.get(k) for k in ("backend", "device_kind", "torch_version")})
    plan = {
        "schema": SCHEMA,
        **env,
        "n_devices": n_devices,
        "gauges": gauges,
        "gauge_source": gauge_source,
        "budget": {
            "hbm_budget_bytes": budget,
            "memory_headroom": memory_headroom,
        },
        "candidates": rows,
        "chosen": copy.deepcopy(rows[0]) if rows else None,
        "tune_objective": (
            tune_report.get("objective") if tune_report is not None else None
        ),
        "refused": refused,
        "skips": skips,
        "counts": {
            "candidates": len(rows),
            "refused": len(refused),
            "skipped": len(skips),
        },
    }
    return plan


# --------------------------------------------------------------------------
# TD118 — plan-must-verify
# --------------------------------------------------------------------------


def verify_plan(plan: dict, device=None) -> tuple[dict, list[Violation]]:
    """TD118: rerun the chosen family fresh through shardlint (every rank
    of the process group must call it) and require its executed
    collective inventory to match what the
    planner priced — per-kind op/element/byte counts exactly, total
    wire bytes exactly. Returns ``(probe, violations)``; ``probe``
    records both inventories and the verdict for the report."""
    chosen = plan.get("chosen")
    if not chosen:
        return {"verified": None, "reason": "no chosen plan"}, []
    from tpu_dist_torch.analysis import shardlint  # noqa: PLC0415

    name = chosen["family"]
    path = f"<plan:{name}>"
    fresh_entry, _ = shardlint.shard_case(name, device)
    fresh = priced_inventory_of(fresh_entry)
    fresh_wire = (fresh_entry.get("hlo") or {}).get("bytes")
    priced = chosen.get("priced_inventory") or {}
    out: list[Violation] = []
    for kind in sorted(set(priced) | set(fresh)):
        p, f = priced.get(kind), fresh.get(kind)
        if p == f:
            continue
        out.append(Violation(
            "TD118", path, 0,
            f"chosen plan's priced {kind} inventory {p} != the freshly "
            f"executed {f} — the plan's cost basis diverged from what "
            "the step dispatches; re-plan before trusting the ranking",
            snippet=f"{kind}:{p}!={f}",
        ))
    if chosen.get("wire_bytes") != fresh_wire:
        out.append(Violation(
            "TD118", path, 0,
            f"chosen plan priced {chosen.get('wire_bytes')} total wire "
            f"bytes but the fresh run moves {fresh_wire} — the "
            "step-time ranking was computed on stale wire accounting",
            snippet=f"wire:{chosen.get('wire_bytes')}!={fresh_wire}",
        ))
    probe = {
        "family": name,
        "priced": priced,
        "compiled": fresh,
        "priced_wire_bytes": chosen.get("wire_bytes"),
        "compiled_wire_bytes": fresh_wire,
        "verified": not out,
        "violations": [v.to_json() for v in out],
    }
    return probe, out


def inject_miscost(plan: dict) -> dict:
    """The TD118 acceptance probe: a deep copy of ``plan`` whose chosen
    candidate's priced wire bytes and per-kind inventory are
    deterministically perturbed (doubled + 1, so zero-byte entries
    still shift). :func:`verify_plan` over the result MUST flag TD118 —
    a clean verdict means the detector is dead (CLI exit 2)."""
    out = copy.deepcopy(plan)
    chosen = out.get("chosen")
    if not chosen:
        return out
    wb = chosen.get("wire_bytes")
    chosen["wire_bytes"] = (int(wb) * 2 + 1) if wb is not None else 1
    inv = chosen.get("priced_inventory") or {}
    for e in inv.values():
        e["bytes"] = e["bytes"] * 2 + 1
        e["elems"] = e["elems"] + 1
    if not inv:
        inv["all-reduce"] = {"ops": 1, "elems": 1, "bytes": 1}
        chosen["priced_inventory"] = inv
    return out


# --------------------------------------------------------------------------
# plan_report.json — save / load (forward-compat), rendering
# --------------------------------------------------------------------------


_REQUIRED_CHOSEN_KEYS = (
    "family", "predicted_step_s", "wire_bytes", "priced_inventory",
)


def save_plan_report(report: dict, path: str) -> None:
    from tpu_dist_torch.analysis.shardlint import save_json  # noqa: PLC0415

    save_json(report, path)


def load_plan_report(path: str) -> dict:
    """Schema-pinned loader with the summarize ``KNOWN_KINDS``
    forward-compat discipline: the tag must parse as
    ``plan_report_v<N>``; a NEWER version is tolerated — candidates
    missing the v1 pricing keys are skipped with a count into
    ``load_notes`` (additive fields are simply ignored) — while a
    foreign tag, an older-than-supported version, or a SAME-version
    entry missing required keys (corruption, not forward compat) raises
    the typed :class:`PlanReportError`."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise PlanReportError(f"{path}: not a JSON object")
    tag = data.get("schema")
    m = _SCHEMA_RE.match(tag) if isinstance(tag, str) else None
    if not m:
        raise PlanReportError(
            f"{path}: schema {tag!r} is not a plan_report tag — "
            "regenerate with `make plan-report`"
        )
    ver = int(m.group(1))
    if ver < SCHEMA_VERSION:
        raise PlanReportError(
            f"{path}: schema {tag!r} predates v{SCHEMA_VERSION} — "
            "regenerate with `make plan-report`"
        )
    newer = ver > SCHEMA_VERSION
    skipped: dict = {}
    cands = data.get("candidates")
    if not isinstance(cands, list):
        raise PlanReportError(f"{path}: no 'candidates' list")
    kept = []
    for entry in cands:
        missing = [k for k in _REQUIRED_CHOSEN_KEYS if k not in entry]
        if not missing:
            kept.append(entry)
            continue
        if not newer:
            raise PlanReportError(
                f"{path}: candidate {entry.get('family')!r} is missing "
                f"{missing}"
            )
        skipped[str(entry.get("family"))] = missing
    data["candidates"] = kept
    chosen = data.get("chosen")
    if chosen is not None:
        missing = [k for k in _REQUIRED_CHOSEN_KEYS if k not in chosen]
        if missing and not newer:
            raise PlanReportError(
                f"{path}: chosen plan is missing {missing}"
            )
        if missing:
            skipped["<chosen>"] = missing
            data["chosen"] = None
    if newer:
        data["load_notes"] = {
            "newer_schema": tag,
            "reader_version": SCHEMA_VERSION,
            "skipped_candidates": skipped,
            "skipped_count": len(skipped),
        }
    return data


def format_text(plan: dict) -> str:
    """Terminal rendering: the ranked table, refusals, skips, verdicts."""
    from tpu_dist_torch.obs.memory import fmt_bytes  # noqa: PLC0415

    c = plan["counts"]
    lines = [
        f"autoplan: {c['candidates']} candidate(s) over "
        f"{plan['n_devices']} device(s)"
        + (f", {c['refused']} REFUSED (HBM)" if c["refused"] else "")
        + (f", {c['skipped']} skipped" if c["skipped"] else "")
        + f"  [rates: {plan.get('gauge_source')}]"
    ]
    for row in plan.get("candidates", []):
        pred = row.get("predicted_step_s")
        req = row.get("static_bytes_per_device")
        lines.append(
            f"  #{row['rank']:<2} {row['family']:<16} "
            f"pred_step {pred * 1e3:>9.4g} ms  "
            f"wire {row.get('wire_bytes') or 0:>8} B  "
            f"hbm {fmt_bytes(req):>10}/dev"
            + ("" if row.get("applyable") else "  [plan-only]")
        )
    for name, why in sorted(plan.get("refused", {}).items()):
        lines.append(
            f"  --  {name:<16} REFUSED: needs "
            f"{fmt_bytes(why.get('required_bytes') or 0)}/dev over the "
            f"budget ({why.get('error')})"
        )
    for name, why in sorted(plan.get("skips", {}).items()):
        lines.append(f"  --  {name:<16} SKIPPED: {why}")
    chosen = plan.get("chosen")
    if chosen:
        lines.append(
            f"autoplan: chosen {chosen['family']} "
            f"(pred_step {chosen['predicted_step_s'] * 1e3:.4g} ms)"
        )
    else:
        lines.append("autoplan: NO feasible candidate")
    probe = plan.get("verification")
    if probe is not None:
        lines.append(
            "autoplan: TD118 "
            + ("verified — executed inventory matches the priced one"
               if probe.get("verified")
               else f"FAILED — {len(probe.get('violations', []))} "
                    "inventory mismatch(es)")
        )
    inj = plan.get("injected_miscost_probe")
    if inj is not None:
        # the probe outcome must be visible, not exit-code-only: a CI log
        # reader should see the detector proven live without rerunning
        lines.append(
            "autoplan: inject-miscost probe "
            + (f"CAUGHT ({len(inj.get('violations', []))} violation(s)) "
               "— the TD118 detector is live"
               if inj.get("caught")
               else "came back CLEAN — the TD118 detector is dead")
        )
    return "\n".join(lines)
