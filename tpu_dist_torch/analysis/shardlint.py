"""Layer 3: the collective audit of every config family (``shardlint``),
the port's counterpart of ``tpu_dist/analysis/shardlint.py``.

JAX lowers and compiles each family and parses the optimized HLO into a
collective inventory. The port runs each family's step once over the
process group inside a :class:`~tpu_dist_torch.analysis.step_audit.
StepTrace`: the ``c10d`` ops that reach the dispatcher are the executed
inventory (JAX's HLO), the calls the step made through
``comm/collectives.py`` the predicted one (JAX's jaxpr ring model). Two
rules ride on them:

* **TD116** ``compiled-collectives-match-predicted``: the executed wire
  accounting agrees with the predicted one, total elements exactly,
  integer legs byte for byte, float legs exactly in one declared dtype
  regime (``native``, or ``widened_to_f32``).
* **TD117** ``unintended-reshard-in-compiled-step``: a collective the
  prediction did not budget (an op issued outside the port's collectives,
  an unpredicted kind, or per-kind wire bytes past the prediction) is
  flagged with its op, shape, bytes and group. :func:`injected_bad_zero1`
  is the probe: a ZeRO-1 step that all-gathers its flat parameters with a
  raw ``torch.distributed`` call before each step.

The families are JAX's (``train/step.py::SHARD_CONFIG_FAMILIES``): the 8
data-parallel ones on the proxy MLP, ``fsdp`` over ``parallel/fsdp.py``
(the port writes FSDP's collectives by hand, so unlike JAX's GSPMD family
it gets a full prediction), ``tp_vit`` on ``[data, model=2]``, ``sp_vit``
on ``[data, seq=4]`` with ring attention (the port's ring sends n - 1
times where JAX's sends n; ``loop_trips`` is 1, the ring being unrolled
in Python) and ``serve_eval`` over ``make_eval_step``. Each lands in the
``shard_report.json`` the planner reads (schema ``shard_report_v1``, which
JAX's ``load_shard_report`` loads): the executed inventory under
``hlo``, ``cost`` from ``obs/costmodel.py::step_cost`` of the run,
``hbm.static_bytes_per_device`` from ``obs/memory.py::static_ledger`` of
the rank's state, ``predicted_step`` from
``costmodel.predicted_step_time``.

Every rank runs the families in the same order. A family is skipped for
facts every rank shares (its ``min_devices`` against the world size), or
when its build fails on any rank: the ranks agree on that by one
all-reduce before the step runs, so no rank is left waiting in a
collective of a step the others never start.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Callable, Optional

import numpy as np
import torch

from tpu_dist_torch import resolve_device
from tpu_dist_torch.analysis import step_audit
from tpu_dist_torch.analysis.rules import Violation
from tpu_dist_torch.comm import collectives

SCHEMA = "shard_report_v1"
SCHEMA_VERSION = 1
_SCHEMA_TAG_RE = re.compile(r"^shard_report_v(\d+)$")


class ShardReportError(ValueError):
    """A shard_report.json failed schema validation on load."""


# -- the inventory --------------------------------------------------------------------


def hlo_totals(ops: list) -> dict:
    """The executed inventory by kind (``ops``, ``elems``, ``bytes``,
    ``int_bytes``, ``float_bytes``) and its totals, JAX's ``_hlo_totals``."""
    by_kind: dict = {}
    for op in ops:
        e = by_kind.setdefault(op.kind, {"ops": 0, "elems": 0, "bytes": 0, "int_bytes": 0,
                                         "float_bytes": 0})
        e["ops"] += 1
        e["elems"] += op.elems
        e["bytes"] += op.wire_bytes
        e["int_bytes"] += op.int_bytes
        e["float_bytes"] += op.float_bytes
    totals = {k: sum(e[k] for e in by_kind.values())
              for k in ("ops", "elems", "bytes", "int_bytes", "float_bytes")}
    return {"by_kind": by_kind, "totals": totals}


def hlo_wire_buckets(ops: list) -> dict:
    """Payload/sideband bucketing of the executed inventory under the rule
    the predicted side uses (:func:`~tpu_dist_torch.analysis.step_audit.
    wire_buckets`). Ops are first regrouped by the call that issued them
    (``kind``, c10d op, call label, dtype), as JAX regroups HLO ops by
    their JAX call site, so the per-leaf all-reduces of one gradient
    reduce bucket as one message; an op of no call stays alone."""
    grouped: dict = {}
    for i, op in enumerate(ops):
        is_q = (op.int_bytes > 0 and op.float_bytes == 0
                and op.dtype not in ("s32", "u32", "s64", "u64", "pred"))
        key = ((op.kind, op.op_name, op.source, op.dtype, op.loop_trips) if op.source
               else (op.kind, "anon", i))
        g = grouped.setdefault(key, [op.kind, 0, 0, is_q, op.loop_trips])
        g[1] += op.elems // max(op.loop_trips, 1)
        g[2] += op.wire_bytes // max(op.loop_trips, 1)
        g[3] = g[3] and is_q
    return step_audit.wire_buckets([tuple(g) for g in grouped.values()])


# -- TD116 / TD117 ----------------------------------------------------------------------


def _within(actual: float, expected: float, tol: float) -> bool:
    return abs(actual - expected) <= tol * max(abs(expected), 1.0)


def compare_compiled_vs_predicted(name: str, ops: list, predicted: dict, *,
                                  tolerance: float = 0.0) -> tuple:
    """TD116 and TD117 over one family (JAX's function of the name):
    returns ``(verdict, violations)``, the verdict with the resolved
    ``float_wire`` regime and both totals."""
    path = f"<hlo:{name}>"
    out: list = []
    hlo = hlo_totals(ops)
    pt, ht = predicted["totals"], hlo["totals"]
    if not _within(ht["elems"], pt["elems"], tolerance):
        out.append(Violation(
            "TD116", path, 0,
            f"executed wire ELEMENTS {ht['elems']} != predicted {pt['elems']} (ring model "
            "over the step's collective calls) — the step moved a different amount of data "
            f"than its calls asked for; per-kind: executed="
            f"{ {k: v['elems'] for k, v in hlo['by_kind'].items()} } predicted="
            f"{ {k: v['elems'] for k, v in predicted['by_kind'].items()} }",
            snippet=f"elems:{ht['elems']}!={pt['elems']}"))
    if not _within(ht["int_bytes"], pt["int_bytes"], tolerance):
        out.append(Violation(
            "TD116", path, 0,
            f"executed integer-leg wire bytes {ht['int_bytes']} != predicted "
            f"{pt['int_bytes']} — a quantized leg widened or leaked",
            snippet=f"int_bytes:{ht['int_bytes']}!={pt['int_bytes']}"))
    float_wire = None
    if _within(ht["float_bytes"], pt["float_bytes"], tolerance):
        float_wire = "native"
    elif _within(ht["float_bytes"], pt["float_bytes_f32norm"], tolerance):
        float_wire = ("widened_to_f32" if pt["float_bytes_f32norm"] != pt["float_bytes"]
                      else "native")
    else:
        out.append(Violation(
            "TD116", path, 0,
            f"executed float-leg wire bytes {ht['float_bytes']} match neither the native "
            f"prediction {pt['float_bytes']} nor the f32-normalized prediction "
            f"{pt['float_bytes_f32norm']} — an undeclared dtype rewrite on the wire",
            snippet=f"float_bytes:{ht['float_bytes']}"))
    for op in ops:
        if not op.source:
            out.append(Violation(
                "TD117", path, 0,
                f"unpredicted {op.kind} {op.shape} ({op.wire_bytes} wire B, replica_groups="
                f"{op.replica_groups}, {op.op_name}) issued outside comm/collectives.py — "
                "no collective call of the step asked for it (a raw torch.distributed call)",
                snippet=f"raw:{op.kind}:{op.shape}"))
    for kind, he in sorted(hlo["by_kind"].items()):
        pe = predicted["by_kind"].get(kind)
        if pe is None or pe["elems"] == 0:
            for op in ops:
                if op.kind == kind and op.source:
                    out.append(Violation(
                        "TD117", path, 0,
                        f"unpredicted {op.kind} {op.shape} ({op.wire_bytes} wire B, "
                        f"replica_groups={op.replica_groups}, from {op.source}) — the "
                        f"step's calls budget no {kind} here",
                        snippet=f"{kind}:{op.shape}"))
            continue
        allowed = max(pe["bytes"], pe["bytes_f32norm"])
        if he["bytes"] > allowed * (1.0 + tolerance) + 0.5:
            excess = he["bytes"] - allowed
            culprits, acc = [], 0
            for op in sorted((o for o in ops if o.kind == kind), key=lambda o: o.wire_bytes):
                culprits.append(op)
                acc += op.wire_bytes
                if acc >= excess:
                    break
            desc = ", ".join(f"{o.shape}@{o.replica_groups}" for o in culprits[:4])
            out.append(Violation(
                "TD117", path, 0,
                f"{kind} wire bytes {he['bytes']} exceed the predicted {allowed} by {excess} "
                f"B — an unintended collective rides a predicted kind (smallest ops "
                f"covering the excess: {desc})",
                snippet=f"{kind}:{he['bytes']}>{allowed}"))
    verdict = {"float_wire": float_wire, "hlo": ht, "predicted": pt, "agree": not out}
    return verdict, out


def check_expected_kinds(name: str, ops: list, expected_kinds) -> list:
    """TD117 for a family with no prediction: the executed kinds stay
    inside its declared set (JAX's GSPMD families; every port family has
    a prediction, so only a caller's own family uses it)."""
    allowed = set(expected_kinds)
    return [Violation(
        "TD117", f"<hlo:{name}>", 0,
        f"unexpected {op.kind} {op.shape} ({op.wire_bytes} wire B, replica_groups="
        f"{op.replica_groups}, from {op.source or op.op_name}) — outside this family's "
        f"declared kind set {sorted(allowed)}",
        snippet=f"{op.kind}:{op.shape}") for op in ops if op.kind not in allowed]


# -- the config families ----------------------------------------------------------------


@dataclasses.dataclass
class ConfigFamily:
    """One auditable configuration: ``build(device)`` returns ``(step,
    args, mesh)``, ``args[0]`` the state the HBM ledger prices and
    ``mesh`` ``{axis: size}``. ``gspmd`` families have no prediction and
    declare ``expected_kinds`` (none of the port's: its collectives are
    all written by hand). ``loop_trips`` multiplies collectives in loops
    (1: the port unrolls every loop in Python)."""

    name: str
    build: Callable
    kind: str = "train"
    gspmd: bool = False
    expected_kinds: tuple = ()
    loop_trips: int = 1
    tolerance: float = 0.0
    min_devices: int = 1
    note: str = ""


_FAMILIES: dict = {}


def register_family(fam: ConfigFamily) -> None:
    _FAMILIES[fam.name] = fam


def registered_families() -> list:
    return sorted(_FAMILIES)


def family(name: str) -> ConfigFamily:
    if name not in _FAMILIES:
        raise ValueError(f"unknown config family {name!r}; registered: "
                         f"{registered_families()}")
    return _FAMILIES[name]


def _mlp_family_builder(name: str):
    def build(device):
        from tpu_dist_torch.train.step import family_step_kwargs  # noqa: PLC0415

        fn, args = step_audit._dp_setup(device, **family_step_kwargs(name))
        return fn, args, {"data": collectives.world_size()}

    return build


def _vit_batch(device, data_index: int, batch: int = 4) -> tuple:
    """A data row's batch of the ViT families: ``batch`` 8x8 images and
    labels below 8, the same on every rank of the row."""
    rng = np.random.default_rng([0, data_index])
    images = torch.from_numpy(rng.standard_normal((batch, 8, 8, 3), dtype=np.float32))
    labels = torch.from_numpy(rng.integers(0, 8, batch))
    return images.to(device), labels.to(device)


def _vit_state(device, patch: int, **model_kw):
    from tpu_dist_torch.nn import vit  # noqa: PLC0415
    from tpu_dist_torch.train.optim import SGD  # noqa: PLC0415
    from tpu_dist_torch.train.state import TrainState  # noqa: PLC0415

    model = vit.ViT(image_size=8, patch_size=patch, dim=16, depth=1, heads=2, num_classes=8,
                    device=device, **model_kw)
    opt = SGD(fused=True)
    return opt, TrainState.create(model, opt)


def _build_fsdp(device):
    from tpu_dist_torch.comm import mesh  # noqa: PLC0415
    from tpu_dist_torch.parallel import fsdp  # noqa: PLC0415
    from tpu_dist_torch.train.optim import SGD  # noqa: PLC0415
    from tpu_dist_torch.train.state import TrainState  # noqa: PLC0415

    model = step_audit._AuditMLP(device)
    opt = SGD(momentum=0.9, weight_decay=1e-4, fused=True)
    # min_size=64 so the proxy's matrices really shard (its leaves sit
    # under the production threshold), as JAX's family does
    state = fsdp.shard_state(TrainState.create(model, opt), axis=mesh.data_axis(1),
                             min_size=64, optimizer=opt)
    step = fsdp.make_fsdp_train_step(opt)
    images, labels = step_audit.proxy_batch(device)
    return step, (state, images, labels, 0.1), {"data": collectives.world_size()}


def _build_tp(device):
    from tpu_dist_torch.comm import mesh  # noqa: PLC0415
    from tpu_dist_torch.train.step import family_step_kwargs, make_train_step  # noqa: PLC0415

    m = mesh.tp_mesh(2)
    opt, state = _vit_state(device, 4, tp=m[mesh.MODEL_AXIS])
    kw = family_step_kwargs("tp")
    kw["tp_axis"] = m[kw["tp_axis"]]
    step = make_train_step(opt, sync_bn=False, axis=m[mesh.DATA_AXIS], preempt_flag=False, **kw)
    images, labels = _vit_batch(device, m.coords[0])
    return step, (state, images, labels, 0.1), dict(zip(m.names, m.sizes))


def _build_sp(device):
    from tpu_dist_torch.comm import mesh  # noqa: PLC0415
    from tpu_dist_torch.train.step import family_step_kwargs, make_train_step  # noqa: PLC0415

    m = mesh.seq_mesh(4)
    opt, state = _vit_state(device, 2)
    kw = family_step_kwargs("sp")
    kw["seq_axis"] = m.seq
    step = make_train_step(opt, sync_bn=False, preempt_flag=False, **kw)
    images, labels = _vit_batch(device, m.data.index)
    return step, (state, images, labels, 0.1), {"data": m.data.size, "seq": m.seq.size}


def _build_serve(device):
    from tpu_dist_torch.train.optim import SGD  # noqa: PLC0415
    from tpu_dist_torch.train.state import TrainState  # noqa: PLC0415
    from tpu_dist_torch.train.step import make_eval_step  # noqa: PLC0415

    model = step_audit._AuditMLP(device)
    state = TrainState.create(model, SGD())
    images, labels = step_audit.proxy_batch(device)
    mask = torch.ones(labels.shape[0], dtype=torch.float32, device=labels.device)
    return make_eval_step(), (state, images, labels, mask), {"data": collectives.world_size()}


for _name in ("dp_sgd", "dp_sgd_accum4", "dp_bf16", "dp_wire_bf16", "dp_int8", "dp_int8_ef",
              "zero1_sgd", "zero1_int8"):
    register_family(ConfigFamily(_name, _mlp_family_builder(_name)))
register_family(ConfigFamily(
    "fsdp", _build_fsdp,
    note="FSDP (parallel/fsdp.py): the per-leaf gathers and gradient reduce-scatters are "
         "the port's own calls, so the family is fully predicted"))
register_family(ConfigFamily("tp_vit", _build_tp, min_devices=2,
                             note="Megatron-TP ViT on [data, model=2]"))
register_family(ConfigFamily(
    "sp_vit", _build_sp, min_devices=4,
    note="ring-attention ViT on [data, seq=4]; the ring is unrolled: n - 1 sends a "
         "rotation (JAX's scan sends n)"))
register_family(ConfigFamily("serve_eval", _build_serve, kind="serve",
                             note="the inference/eval forward step (metric sums only)"))


def injected_bad_zero1(device=None) -> tuple:
    """The TD117 probe: the ZeRO-1 step behind a raw ``torch.distributed``
    all-gather of this rank's flat parameter shard before each step, the
    port's counterpart of JAX's mis-sharded ``in_shardings`` (state the
    step expects resident gathered again). Returns ``(step, args)`` for
    :func:`shard_case`'s ``step_override``; its report MUST carry TD117
    (a clean one means the detector is dead)."""
    from tpu_dist_torch.train.step import family_step_kwargs  # noqa: PLC0415

    fn, args = step_audit._dp_setup(device, **family_step_kwargs("zero1_sgd"))

    def bad(state, images, labels, lr):
        lay = state.layout
        flat = torch.cat([p.detach().reshape(-1) for p in state.params.parameters()])
        flat = torch.nn.functional.pad(flat, (0, lay.padded - lay.L))
        shard = flat[lay.lo:lay.lo + lay.chunk].contiguous()
        gathered = torch.empty(lay.padded, dtype=shard.dtype, device=shard.device)
        collectives._ALL_GATHER(gathered, shard)  # torch.distributed's own, not the wrapper
        return fn(state, images, labels, lr)

    return bad, args


# -- driving one family / the matrix ----------------------------------------------------


def _agree(ok: bool) -> bool:
    """Whether every rank of the default group says ``ok`` (one all-reduce
    of a flag; True without a group)."""
    if not collectives.active():
        return ok
    flag = torch.tensor([1.0 if ok else 0.0], device=collectives.group_device())
    return bool(collectives.all_reduce_(flag, op="min", kind="analysis").item() > 0)


def run_family(name: str, device=None, *, step_override=None) -> tuple:
    """Build family ``name`` on every rank (agreeing on failures) and run
    its step once, traced and cost-counted. Returns ``(family, trace,
    cost, state, mesh)``. Raises ValueError when the world is too small or
    the build failed on any rank."""
    from tpu_dist_torch.obs import costmodel  # noqa: PLC0415

    fam = family(name)
    n = collectives.world_size()
    if n < fam.min_devices:
        raise ValueError(f"family {name!r} needs >= {fam.min_devices} devices (got {n})")
    device = resolve_device(device if device is not None else "cuda")
    err = None
    try:
        fn, args, mesh = fam.build(device)
        if step_override is not None:
            fn, args = step_override
    except Exception as e:  # noqa: BLE001 — agreed on below, then re-raised
        err = e
    if not _agree(err is None):
        if err is not None:
            raise err
        raise ValueError(f"family {name!r} failed to build on another rank")
    with step_audit.StepTrace() as trace:
        _, cost = costmodel.step_cost(fn, *args, world=n)
    return fam, trace, cost, args[0], mesh


def _family_config(name: str) -> dict:
    from tpu_dist_torch.train.step import SHARD_CONFIG_FAMILIES  # noqa: PLC0415

    key = {"tp_vit": "tp", "sp_vit": "sp", "serve_eval": None}.get(name, name)
    return {} if key is None else dict(SHARD_CONFIG_FAMILIES.get(key, {}))


def _hbm(state) -> dict:
    from tpu_dist_torch.obs import memory as memory_lib  # noqa: PLC0415

    try:
        led = memory_lib.static_ledger(**memory_lib.state_sections(state))
    except Exception as e:  # noqa: BLE001 — the ledger must never block the audit
        return {"ledger_error": f"{type(e).__name__}: {e}"}
    return {"static_bytes_per_device": led["bytes_per_device"],
            "static_sections": {k: v["bytes_per_device"] for k, v in led["sections"].items()}}


def shard_case(name: str, device=None, *, step_override=None) -> tuple:
    """Run one family, check TD116/TD117 and assemble its shard-report
    entry (JAX's keys). ``step_override=(step, args)`` swaps in another
    step (the injected probe) under the family's name. Returns ``(entry,
    violations)``; every rank returns the same."""
    from tpu_dist_torch.obs import costmodel  # noqa: PLC0415

    fam, trace, cost, state, mesh = run_family(name, device, step_override=step_override)
    ops = trace.ops
    hlo = hlo_totals(ops)
    violations: list = []
    predicted = None
    if fam.gspmd:
        violations.extend(check_expected_kinds(name, ops, fam.expected_kinds))
        verdict = {"float_wire": None, "hlo": hlo["totals"], "predicted": None,
                   "agree": not violations,
                   "skipped_td116": "family without a prediction: kinds gated only"}
    else:
        predicted = trace.predicted()
        verdict, vs = compare_compiled_vs_predicted(name, ops, predicted,
                                                    tolerance=fam.tolerance)
        violations.extend(vs)
    predicted_step = costmodel.predicted_step_time(
        cost, wire_bytes=hlo["totals"]["bytes"], n_devices=collectives.world_size())
    entry = {
        "family": name,
        "kind": fam.kind,
        "config": _family_config(name),
        "mesh": mesh,
        "note": fam.note,
        "collectives": [op.to_json() for op in ops],
        "hlo": {**hlo["totals"], "by_kind": hlo["by_kind"], "wire": hlo_wire_buckets(ops),
                "float_wire": verdict.get("float_wire"), "sharding_annotations": None},
        "predicted": predicted,
        "verdict": verdict,
        "hbm": _hbm(state),
        "cost": cost,
        "predicted_step": predicted_step,
        "violations": [v.to_json() for v in violations],
    }
    return entry, violations


def shard_all(device=None, names=None) -> tuple:
    """Run the whole family matrix (or ``names``) in registry order. A
    family that cannot run is recorded under ``skips`` with its typed
    error, never a crash; the skip count is loud in the report."""
    report: dict = {"families": {}, "skips": {}}
    violations: list = []
    for name in names if names is not None else registered_families():
        try:
            entry, vs = shard_case(name, device)
        except Exception as e:  # noqa: BLE001 — skip-with-count, as JAX's
            report["skips"][name] = f"{type(e).__name__}: {e}"
            continue
        report["families"][name] = entry
        violations.extend(vs)
    report["counts"] = {"families": len(report["families"]),
                        "skipped": len(report["skips"]), "violations": len(violations)}
    return report, violations


def environment(device=None) -> dict:
    """The stamps of a report: ``backend`` (``gpu``/``cpu``), the card's
    ``device_kind``, ``n_devices`` (the ranks) and ``torch_version``."""
    from tpu_dist_torch.obs import costmodel  # noqa: PLC0415

    dev = resolve_device(device if device is not None else "cuda")
    return {"backend": "gpu" if dev.type == "cuda" else dev.type,
            "device_kind": costmodel.device_kind(dev),
            "n_devices": collectives.world_size(), "torch_version": torch.__version__}


def build_shard_report(device=None, names=None) -> tuple:
    """The persisted artifact: :func:`shard_all` with the schema pin and
    the environment stamps."""
    report, violations = shard_all(device, names)
    return {"schema": SCHEMA, **environment(device), **report}, violations


# -- shard_report.json ------------------------------------------------------------------


def save_json(report: dict, path: str) -> None:
    """Write ``report`` to ``path`` through a temporary file."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


save_shard_report = save_json

_REQUIRED_FAMILY_KEYS = ("collectives", "hlo", "verdict", "hbm", "cost", "predicted_step",
                         "violations")


def load_shard_report(path: str) -> dict:
    """The schema-pinned loader the planner reads through, JAX's: a newer
    ``shard_report_v<N>`` is tolerated (a family entry missing the v1
    keys is skipped with a count into ``load_notes``); a foreign tag, an
    older version, or a same-version entry missing keys raises
    :class:`ShardReportError`."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    tag = data.get("schema") if isinstance(data, dict) else None
    m = _SCHEMA_TAG_RE.match(tag) if isinstance(tag, str) else None
    if not isinstance(data, dict) or not m:
        got = tag if isinstance(data, dict) else type(data).__name__
        raise ShardReportError(f"{path}: schema {got!r} is not a shard_report tag — "
                               "regenerate with `make shard-report`")
    ver = int(m.group(1))
    if ver < SCHEMA_VERSION:
        raise ShardReportError(f"{path}: schema {tag!r} predates v{SCHEMA_VERSION} — "
                               "regenerate with `make shard-report`")
    newer = ver > SCHEMA_VERSION
    fams = data.get("families")
    if not isinstance(fams, dict):
        raise ShardReportError(f"{path}: no 'families' map")
    skipped: dict = {}
    for name, entry in list(fams.items()):
        missing = [k for k in _REQUIRED_FAMILY_KEYS if k not in entry]
        if not missing:
            continue
        if not newer:
            raise ShardReportError(f"{path}: family {name!r} is missing {missing}")
        skipped[name] = missing
        del fams[name]
    if newer:
        data["load_notes"] = {"newer_schema": tag, "reader_version": SCHEMA_VERSION,
                              "skipped_families": skipped, "skipped_count": len(skipped)}
    return data


def format_text(report: dict) -> str:
    """One line a family."""
    c = report["counts"]
    lines = [f"shardlint: {c['families']} famil(ies) analyzed"
             + (f", {c['skipped']} SKIPPED" if c["skipped"] else "")
             + f", {c['violations']} violation(s)"]
    for name, fam in sorted(report.get("families", {}).items()):
        h = fam["hlo"]
        kinds = ", ".join(f"{k}x{v['ops']}" for k, v in sorted(h["by_kind"].items())) \
            or "collective-free"
        pred = (fam.get("predicted_step") or {}).get("predicted_step_s")
        lines.append(f"  {name:<16} {kinds:<52} wire {h['bytes']:>8} B"
                     + (f"  float_wire={h['float_wire']}" if h.get("float_wire") else "")
                     + (f"  pred_step {pred * 1e3:.3f} ms" if pred else ""))
    for name, why in sorted(report.get("skips", {}).items()):
        lines.append(f"  {name:<16} SKIPPED: {why}")
    return "\n".join(lines)
