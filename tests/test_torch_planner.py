"""The port's ``--auto_shard`` planner (``tpu_dist_torch/analysis/
planner.py``) against JAX's:

* on one shard report (the port's, over 4 gloo ranks) with the same
  explicit gauges and memory budget, JAX's ``build_plan`` and the port's
  give the same candidate order, predicted step times, chosen family,
  refusals, skips and counts, under a roomy budget and under tight ones
  (the refusal matrix);
* ``family_of``, ``family_train_overrides`` and the registries are JAX's;
* TD118: the plan verifies against a fresh run of its family, and the
  ``inject_miscost`` copy is caught;
* plan reports cross both ways, and malformed ones give JAX's
  ``PlanReportError`` messages.
"""

import copy
import json

import pytest
from torch_ranks import plan_rank, run_ranks

from tpu_dist.analysis import planner as jax_planner
from tpu_dist.train import step as jax_step
from tpu_dist_torch.analysis import planner
from tpu_dist_torch.train import step

WORLD = 4
GAUGES = dict(planner.UNCALIBRATED_RATES)
ROW_KEYS = ("family", "rank", "predicted_step_s", "wire_bytes", "static_bytes_per_device",
            "priced_inventory", "applyable", "mesh", "config")


@pytest.fixture(scope="module")
def planned():
    report, plan, probe, vs, inj = run_ranks(plan_rank, WORLD, GAUGES, timeout=240)[0]
    return {"report": report, "plan": plan, "probe": probe, "vs": vs, "inj": inj}


def _both(report, **kw):
    ours = planner.build_plan(shard_report=copy.deepcopy(report), gauges=GAUGES, **kw)
    theirs = jax_planner.build_plan(shard_report=copy.deepcopy(report), gauges=GAUGES, **kw)
    return ours, theirs


def _rows(plan):
    return [{k: r.get(k) for k in ROW_KEYS} for r in plan["candidates"]]


def test_build_plan_ranks_as_jax_does(planned):
    ours, theirs = _both(planned["report"], hbm_budget_bytes=10**12)
    assert _rows(ours) == _rows(theirs)
    assert [r["predicted_step_s"] for r in ours["candidates"]] == sorted(
        r["predicted_step_s"] for r in ours["candidates"])
    for key in ("chosen", "refused", "skips", "counts", "gauges", "gauge_source", "budget",
                "n_devices"):
        if key == "chosen":
            assert {k: ours[key][k] for k in ROW_KEYS} == {k: theirs[key][k] for k in ROW_KEYS}
        else:
            assert ours[key] == theirs[key], key
    # every train family fits 4 ranks; serve_eval prices another objective
    assert ours["counts"] == {"candidates": 11, "refused": 0, "skipped": 0}
    assert ours["chosen"]["family"] == ours["candidates"][0]["family"]
    # the rank's step over the same report chose the same plan
    assert planned["plan"]["chosen"]["family"] == ours["chosen"]["family"]


def test_refusal_matrix_is_jaxs(planned):
    fams = planned["report"]["families"]
    need = sorted({e["hbm"]["static_bytes_per_device"] for n, e in fams.items()
                   if n != "serve_eval"})
    # budgets between the families' needs (at 0.9 headroom): each refuses
    # the families above it; the smallest refuses all
    budgets = [int(need[0] * 0.5)] + [int(b / 0.9) + 1 for b in need]
    seen = set()
    for budget in budgets:
        ours, theirs = _both(planned["report"], hbm_budget_bytes=budget)
        assert ours["refused"] == theirs["refused"], budget
        assert _rows(ours) == _rows(theirs), budget
        assert (ours["chosen"] or {}).get("family") == (theirs["chosen"] or {}).get("family")
        assert ours["counts"] == theirs["counts"]
        seen.add(ours["counts"]["refused"])
    assert max(seen) == 11 and min(seen) == 0 and len(seen) > 2


def test_applyable_only_is_jaxs(planned):
    ours, theirs = _both(planned["report"], hbm_budget_bytes=10**12, applyable_only=True)
    assert _rows(ours) == _rows(theirs)
    assert all(r["applyable"] and r["family"] in planner.FAMILY_TRAIN_OVERRIDES
               for r in ours["candidates"])


def test_the_registries_and_family_of_are_jaxs():
    assert planner.FAMILY_TRAIN_OVERRIDES == jax_planner.FAMILY_TRAIN_OVERRIDES
    assert planner.UNCALIBRATED_RATES == jax_planner.UNCALIBRATED_RATES
    assert step.SHARD_CONFIG_FAMILIES == jax_step.SHARD_CONFIG_FAMILIES
    combos = [dict(grad_compression=g, bf16=b, grad_accu_steps=k, shard_weight_update=z,
                   fsdp=f)
              for g in ("none", "bf16", "int8", "int8_ef") for b in (False, True)
              for k in (1, 4) for z in (False, True) for f in (False, True)]
    for kw in combos:
        assert planner.family_of(**kw) == jax_planner.family_of(**kw), kw
    for name in planner.FAMILY_TRAIN_OVERRIDES:
        assert planner.family_train_overrides(name) == jax_planner.family_train_overrides(name)
    for name in ("tp_vit", "sp_vit"):
        with pytest.raises(KeyError) as ours:
            planner.family_train_overrides(name)
        with pytest.raises(KeyError) as theirs:
            jax_planner.family_train_overrides(name)
        assert str(ours.value) == str(theirs.value)


def test_td118_verifies_and_catches_the_miscost(planned):
    assert planned["vs"] == [] and planned["probe"]["verified"]
    assert planned["probe"]["priced"] == planned["probe"]["compiled"]
    assert {v["rule"] for v in planned["inj"]} == {"TD118"}
    # the JAX verifier's arithmetic over the same probe: a perturbed copy
    # differs from the priced inventory wherever the port's caught it
    bad = planner.inject_miscost(planned["plan"])
    assert bad["chosen"]["wire_bytes"] == jax_planner.inject_miscost(
        planned["plan"])["chosen"]["wire_bytes"]


def test_plan_is_deterministic(planned):
    a, _ = _both(planned["report"], hbm_budget_bytes=10**12)
    b, _ = _both(planned["report"], hbm_budget_bytes=10**12)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_plan_reports_cross_both_ways(planned, tmp_path):
    ours, theirs = _both(planned["report"], hbm_budget_bytes=10**12)
    p1, p2 = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    planner.save_plan_report(ours, p1)
    jax_planner.save_plan_report(theirs, p2)
    assert jax_planner.load_plan_report(p1)["chosen"]["family"] == ours["chosen"]["family"]
    assert planner.load_plan_report(p2)["chosen"]["family"] == theirs["chosen"]["family"]
    assert planner.format_text(planner.load_plan_report(p2)).splitlines()[1:] == \
        jax_planner.format_text(jax_planner.load_plan_report(p2)).splitlines()[1:]


MALFORMED = (
    ("foreign", {"schema": "shard_report_v1", "candidates": []}),
    ("older", {"schema": "plan_report_v0", "candidates": []}),
    ("no candidates", {"schema": "plan_report_v1"}),
    ("missing keys", {"schema": "plan_report_v1", "candidates": [{"family": "dp_sgd"}]}),
    ("chosen missing keys", {"schema": "plan_report_v1", "candidates": [],
                             "chosen": {"family": "dp_sgd"}}),
    ("not a dict", [1]),
)


@pytest.mark.parametrize("name,data", MALFORMED, ids=[m[0] for m in MALFORMED])
def test_malformed_plan_reports_raise_jaxs_messages(tmp_path, name, data):
    path = str(tmp_path / "p.json")
    with open(path, "w") as f:
        json.dump(data, f)
    with pytest.raises(jax_planner.PlanReportError) as theirs:
        jax_planner.load_plan_report(path)
    with pytest.raises(planner.PlanReportError) as ours:
        planner.load_plan_report(path)
    assert str(ours.value) == str(theirs.value)
