"""The port's shardlint (``tpu_dist_torch/analysis/shardlint.py``) against
JAX's jaxpr-level accounting, on 4 gloo ranks and JAX's 4-device mesh (480
divides over both):

* each data-parallel family's executed elements per kind equal JAX's
  ``shardlint.predicted_inventory`` of the same family on the same weights
  (JAX's ``PRNGKey(0)`` proxy, bridged), and its wire buckets equal JAX's
  ring model over the jaxpr's collectives grouped by call site (how JAX's
  own HLO accounting groups them);
* the differences are pinned: the port's op counts (one flat buffer where
  JAX's jaxpr has an equation a leaf) and its metric reduce (one f32
  all-reduce of three sums where JAX reduces int32 counts);
* TD116 and TD117 are clean on every family, the injected ZeRO-1 gather is
  caught (TD117) and a mutated prediction is caught (TD116);
* reports cross both ways: JAX's ``load_shard_report`` loads the port's,
  the port's loads a JAX-shaped one, and the malformed files give JAX's
  ``ShardReportError`` messages;
* at one rank (the card's group of one) the inventory is pinned, as the
  chip smoke holds the card to it.
"""

import copy
import json

import jax
import numpy as np
import pytest
import torch.distributed as dist
from jax._src import source_info_util
from torch_ranks import free_port, run_ranks, shard_audit_rank

from tpu_dist.analysis import jaxpr_audit
from tpu_dist.analysis import shardlint as jax_shardlint
from tpu_dist.comm import mesh as jax_mesh
from tpu_dist.train.step import family_step_kwargs as jax_family_step_kwargs
from tpu_dist_torch.analysis import shardlint, step_audit
from tpu_dist_torch.comm import mesh

WORLD = 4
DP_FAMILIES = ("dp_sgd", "dp_sgd_accum4", "dp_bf16", "dp_wire_bf16", "dp_int8", "dp_int8_ef",
               "zero1_sgd", "zero1_int8")

# The port's collective ops a step, by kind, at 4 ranks: one flat gradient
# all-reduce and one metrics all-reduce where JAX's jaxpr has one psum a
# leaf (4) and one a metric (3); the int8 and ZeRO-1 legs are one op each,
# as JAX's equations are
PORT_OPS = {
    "dp_sgd": {"all-reduce": 2}, "dp_sgd_accum4": {"all-reduce": 2},
    "dp_bf16": {"all-reduce": 2}, "dp_wire_bf16": {"all-reduce": 2},
    "dp_int8": {"all-to-all": 2, "all-gather": 2, "all-reduce": 1},
    "dp_int8_ef": {"all-to-all": 2, "all-gather": 2, "all-reduce": 1},
    "zero1_sgd": {"reduce-scatter": 1, "all-gather": 1, "all-reduce": 1},
    "zero1_int8": {"all-to-all": 2, "all-gather": 1, "all-reduce": 1},
}
JAX_EQNS = {
    "dp_sgd": {"all-reduce": 7}, "dp_sgd_accum4": {"all-reduce": 7},
    "dp_bf16": {"all-reduce": 7}, "dp_wire_bf16": {"all-reduce": 7},
    "dp_int8": {"all-to-all": 2, "all-gather": 2, "all-reduce": 3},
    "dp_int8_ef": {"all-to-all": 2, "all-gather": 2, "all-reduce": 3},
    "zero1_sgd": {"reduce-scatter": 1, "all-gather": 1, "all-reduce": 3},
    "zero1_int8": {"all-to-all": 2, "all-gather": 1, "all-reduce": 3},
}

# At one rank (the chip smoke's NCCL group of one holds the card to these):
# (ops, elements, bytes) by kind, and the payload bytes. The data-parallel
# wrappers issue at a group of one; the int8 row of 480 takes 2 scales at
# the default chunk of 256; FSDP shards nothing at one rank, so only its
# metrics all-reduce (with the SIGTERM flag: 4 sums) is left.
WORLD1 = {
    "dp_sgd": ({"all-reduce": (2, 483, 3864)}, 3840),
    "dp_sgd_accum4": ({"all-reduce": (2, 483, 3864)}, 3840),
    "dp_bf16": ({"all-reduce": (2, 483, 3864)}, 3840),
    "dp_wire_bf16": ({"all-reduce": (2, 483, 1944)}, 1920),
    "dp_int8": ({"all-to-all": (2, 482, 488), "all-gather": (2, 482, 488),
                 "all-reduce": (1, 3, 24)}, 960),
    "dp_int8_ef": ({"all-to-all": (2, 482, 488), "all-gather": (2, 482, 488),
                    "all-reduce": (1, 3, 24)}, 960),
    "zero1_sgd": ({"reduce-scatter": (1, 480, 1920), "all-gather": (1, 480, 1920),
                   "all-reduce": (1, 3, 24)}, 3840),
    "zero1_int8": ({"all-to-all": (2, 482, 488), "all-gather": (1, 480, 1920),
                    "all-reduce": (1, 3, 24)}, 2400),
    "fsdp": ({"all-reduce": (1, 4, 32)}, 0),
    "serve_eval": ({"all-reduce": (1, 4, 32)}, 0),
}


def _jax_params():
    params, _ = jaxpr_audit._AuditMLP().init(jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in params.items()}


def _jax_side(family, mesh4):
    """JAX's predicted inventory of ``family`` and its ring model's
    buckets over the jaxpr's collectives grouped by call site."""
    fn, args = jaxpr_audit._dp_setup(mesh4, **jax_family_step_kwargs(family))
    predicted = jax_shardlint.predicted_inventory(fn, *args)
    groups = {}
    for eqn, mult in jaxpr_audit._walk_eqns(jax.make_jaxpr(fn)(*args).jaxpr):
        if eqn.primitive.name not in jaxpr_audit.COLLECTIVE_PRIMS:
            continue
        elems, byts, is_q = jaxpr_audit._eqn_wire(eqn)
        key = (eqn.primitive.name, source_info_util.summarize(eqn.source_info),
               str(eqn.invars[0].aval.dtype))
        g = groups.setdefault(key, [eqn.primitive.name, 0, 0, is_q, mult])
        g[1] += elems
        g[2] += byts
    return predicted, jaxpr_audit._wire_buckets([tuple(g) for g in groups.values()])


@pytest.fixture(scope="module")
def audit():
    mesh4 = jax_mesh.data_parallel_mesh(devices=jax.devices()[:WORLD])
    jax_sides = {fam: _jax_side(fam, mesh4) for fam in DP_FAMILIES}
    dp, report, vs, inj = run_ranks(shard_audit_rank, WORLD, _jax_params(), DP_FAMILIES,
                                    timeout=240)[0]
    return {"jax": jax_sides, "dp": dp, "report": report, "vs": vs, "inj": inj}


@pytest.mark.parametrize("family", DP_FAMILIES)
def test_executed_elements_and_payload_equal_jax(audit, family):
    predicted, buckets = audit["jax"][family]
    port = audit["dp"][family]
    # elements per kind: exact
    assert ({k: v["elems"] for k, v in port["executed"].items()}
            == {k: v["elems"] for k, v in predicted["by_kind"].items()})
    # the wire bytes per kind and the payload/sideband split: exact
    assert ({k: v["bytes"] for k, v in port["executed"].items()}
            == {k: v["bytes"] for k, v in predicted["by_kind"].items()})
    assert ({k: port["wire"][k] for k in ("payload_bytes", "quantized_payload_bytes",
                                          "sideband_bytes")}
            == {k: buckets[k] for k in ("payload_bytes", "quantized_payload_bytes",
                                        "sideband_bytes")})
    # the predicted side (the port's calls) agrees with its executed side
    assert ({k: v["elems"] for k, v in port["predicted"].items()}
            == {k: v["elems"] for k, v in port["executed"].items()})


@pytest.mark.parametrize("family", DP_FAMILIES)
def test_op_counts_and_metric_dtype_differ_from_jax_as_pinned(audit, family):
    predicted, _ = audit["jax"][family]
    port = audit["dp"][family]
    assert {k: v["ops"] for k, v in port["executed"].items()} == PORT_OPS[family]
    assert {k: v["eqns"] for k, v in predicted["by_kind"].items()} == JAX_EQNS[family]
    assert port["calls"] == sum(PORT_OPS[family].values())
    # JAX's top-1/top-5 counts reduce as int32 (16 integer bytes); the
    # port's three metric sums are one f32 all-reduce (no integer bytes)
    assert predicted["by_kind"]["all-reduce"]["int_bytes"] == 16
    assert port["executed"]["all-reduce"]["int_bytes"] == 0
    assert port["reduce_dtypes"] == (["bf16", "f32"] if family == "dp_wire_bf16" else ["f32"])


def test_td116_td117_clean_on_every_family(audit):
    report = audit["report"]
    assert audit["vs"] == [] and report["skips"] == {}
    assert sorted(report["families"]) == shardlint.registered_families()
    for name, entry in report["families"].items():
        assert entry["verdict"]["agree"] and entry["violations"] == [], name
        assert entry["verdict"]["float_wire"] == "native", name
        assert entry["hbm"]["static_bytes_per_device"] > 0, name
        assert entry["cost"]["flops_per_step"] > 0, name
    # the ring: the port sends n - 1 = 3 rotations of k and v a ring pass
    # (JAX's scan sends n), forward and backward: 12 sends for 6 calls
    sp = report["families"]["sp_vit"]
    assert sp["hlo"]["by_kind"]["collective-permute"]["ops"] == 12
    assert sp["predicted"]["by_kind"]["collective-permute"]["eqns"] == 6
    assert report["families"]["tp_vit"]["mesh"] == {"data": 2, "model": 2}


def test_injected_zero1_gather_is_caught(audit):
    rules = {v["rule"] for v in audit["inj"]}
    assert "TD117" in rules
    assert any("raw torch.distributed" in v["message"] for v in audit["inj"]
               if v["rule"] == "TD117")


def test_mutated_prediction_is_caught(audit):
    entry = audit["report"]["families"]["zero1_sgd"]
    ops = [step_audit.Collective(**op) for op in entry["collectives"]]
    verdict, vs = shardlint.compare_compiled_vs_predicted("zero1_sgd", ops, entry["predicted"])
    assert vs == [] and verdict["agree"]
    bad = copy.deepcopy(entry["predicted"])
    bad["totals"]["elems"] += 1
    bad["by_kind"]["all-gather"]["elems"] += 1
    _, vs = shardlint.compare_compiled_vs_predicted("zero1_sgd", ops, bad)
    assert [v.rule for v in vs] == ["TD116"]


def test_reports_cross_both_ways(audit, tmp_path):
    port_path = str(tmp_path / "port.json")
    shardlint.save_shard_report(audit["report"], port_path)
    loaded = jax_shardlint.load_shard_report(port_path)
    assert sorted(loaded["families"]) == sorted(audit["report"]["families"])
    assert loaded["schema"] == "shard_report_v1" and "torch_version" in loaded
    # a JAX-shaped report (JAX's keys, a jax_version stamp) through the port's
    jax_shaped = {k: v for k, v in json.load(open(port_path)).items() if k != "torch_version"}
    jax_shaped["jax_version"] = jax.__version__
    jax_path = str(tmp_path / "jax.json")
    jax_shardlint.save_shard_report(jax_shaped, jax_path)
    assert shardlint.load_shard_report(jax_path)["families"].keys() == loaded["families"].keys()


MALFORMED = (
    ("foreign", {"schema": "plan_report_v1", "families": {}}),
    ("older", {"schema": "shard_report_v0", "families": {}}),
    ("no families", {"schema": "shard_report_v1"}),
    ("missing keys", {"schema": "shard_report_v1", "families": {"dp_sgd": {"hlo": {}}}}),
    ("not a dict", [1, 2]),
)


@pytest.mark.parametrize("name,data", MALFORMED, ids=[m[0] for m in MALFORMED])
def test_malformed_reports_raise_jaxs_messages(tmp_path, name, data):
    path = str(tmp_path / "r.json")
    with open(path, "w") as f:
        json.dump(data, f)
    with pytest.raises(jax_shardlint.ShardReportError) as theirs:
        jax_shardlint.load_shard_report(path)
    with pytest.raises(shardlint.ShardReportError) as ours:
        shardlint.load_shard_report(path)
    assert str(ours.value) == str(theirs.value)


def test_newer_schema_is_tolerated_with_a_count(audit, tmp_path):
    data = copy.deepcopy(audit["report"])
    data["schema"] = "shard_report_v2"
    del data["families"]["dp_sgd"]["cost"]
    path = str(tmp_path / "r.json")
    shardlint.save_shard_report(data, path)
    ours, theirs = shardlint.load_shard_report(path), jax_shardlint.load_shard_report(path)
    assert ours["load_notes"] == theirs["load_notes"]
    assert ours["load_notes"]["skipped_count"] == 1 and "dp_sgd" not in ours["families"]


def test_one_rank_inventory_is_pinned():
    mesh.initialize_distributed("cpu", world_size=1, rank=0, master_port=free_port())
    try:
        report, vs = shardlint.shard_all("cpu", names=sorted(WORLD1))
    finally:
        dist.destroy_process_group()
    assert vs == [] and report["skips"] == {}
    got = {name: ({k: (v["ops"], v["elems"], v["bytes"]) for k, v in e["hlo"]["by_kind"].items()},
                  e["hlo"]["wire"]["payload_bytes"]) for name, e in report["families"].items()}
    assert got == WORLD1


# The port's collective-call budgets of the proxy step (JAX's
# CollectiveBudget, in calls): accumulation adds no collective (torch's
# no_sync contract, as JAX's _DP_BUDGET), bf16 compute declares JAX's 6
# bf16 -> f32 casts (a cast a leaf rebuilding the f32 gradients, the logits
# and the loss for the metrics), and no step copies between host and device
BUDGETS = {
    "dp_sgd": step_audit.CollectiveBudget({"psum": 2}, bf16_to_f32=0),
    "dp_sgd_accum4": step_audit.CollectiveBudget({"psum": 2}, bf16_to_f32=0),
    "dp_bf16": step_audit.CollectiveBudget({"psum": 2}, bf16_to_f32=jaxpr_audit._BF16_CONVERTS),
    "dp_int8": step_audit.CollectiveBudget({"all_gather": 2, "all_to_all": 2, "psum": 1},
                                           bf16_to_f32=0),
    "zero1_sgd": step_audit.CollectiveBudget({"all_gather": 1, "psum": 1, "reduce_scatter": 1},
                                             bf16_to_f32=0),
}


def test_trace_counts_hold_the_budgets():
    from tpu_dist_torch.train.step import family_step_kwargs  # noqa: PLC0415

    mesh.initialize_distributed("cpu", world_size=1, rank=0, master_port=free_port())
    try:
        counts = {}
        for name in BUDGETS:
            fn, args = step_audit._dp_setup("cpu", **family_step_kwargs(name))
            counts[name] = step_audit.trace_counts(fn, *args)
    finally:
        dist.destroy_process_group()
    for name, budget in BUDGETS.items():
        got = counts[name]
        assert got["collectives"] == budget.collectives, name
        assert got["transfers"] == budget.transfers, name
        assert got["bf16_to_f32"] == budget.bf16_to_f32, name
        # one c10d op a call on these paths
        assert sum(got["executed"].values()) == sum(budget.collectives.values()), name
