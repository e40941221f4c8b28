"""The port's memory ledger (``tpu_dist_torch/obs/memory.py``) and its
wiring in the trainer, held against the JAX package's
(``tpu_dist/obs/memory.py``, ``tpu_dist/train/trainer.py:937-984``).

* The static ledger of a port trainer (the narrow ResNet; SGD and AdamW at
  a world of one; ZeRO-1 with SGD and AdamW, and ``int8_ef``, on 2 gloo
  ranks) equals JAX's
  ledger of the same sections, built as the JAX trainer builds them
  (``init_sharded_opt_state``, ``init_ef_state`` on a 2-device mesh of the
  8-device CPU platform): every section's bytes a device and in total, leaf
  and sharded-leaf counts and its largest leaves' paths. At 2 ranks the
  step's ``device.flops_per_step`` is the step's total over the ranks, in
  the same band of XLA's count of the global step as at one rank.
* The census counts a storage once (views and aliases of it add nothing),
  and ``attributed + unattributed == bytes_in_use`` holds exactly, with
  and without allocator counters; the reconciliation is JAX's.
* The pre-flight: ``feasibility`` and ``preflight_check`` give JAX's
  decisions and messages, ``refuse`` included; no budget, no check. A
  trainer under ``--memory_check refuse`` stops before any step.
* ``obs memory`` (a history, and ``--oom`` over an XLA text) prints what
  the JAX package's CLI prints for the same input, and the history's
  summary (the ledger line, the peak the compare gate reads) is JAX's; the
  port's parser also reads PyTorch's CUDA text.
"""

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch_ranks import fit_run, free_port, ledger_rank, narrow_resnet, run_ranks

from tpu_dist.nn.resnet import ResNetDef
from tpu_dist.obs import __main__ as jax_obs
from tpu_dist.obs import costmodel as jax_costmodel
from tpu_dist.obs import memory as jax_memory
from tpu_dist.obs import summarize as jax_summarize
from tpu_dist.train import optim as jax_optim
from tpu_dist.train import state as jax_state
from tpu_dist.train import step as jax_step
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.obs import __main__ as obs
from tpu_dist_torch.obs import memory, summarize
from tpu_dist_torch.train import trainer

trainer.register_model("narrow_resnet", narrow_resnet)

NARROW = dict(block="basic", stage_blocks=(1, 1, 1, 1), widths=(8, 16, 32, 64))
RUN = dict(model="narrow_resnet", num_classes=10, dataset="synthetic", synthetic_n=64,
           batch_size=16, epochs=1, steps_per_epoch=1, lr=0.02, log_every=1, eval_every=0,
           seed=0, device="cpu")


def _jax_sections(optimizer: str, world: int, *, zero1=False, ef=False):
    """The JAX trainer's ledger sections of the narrow ResNet at ``world``
    data-parallel devices (``tpu_dist/train/trainer.py:937-964``)."""
    md = ResNetDef(NARROW["block"], NARROW["stage_blocks"], 10, widths=NARROW["widths"])
    shapes = jax.eval_shape(md.init, jax.random.PRNGKey(0))
    params, bn = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    opt = (jax_optim.SGD(momentum=0.9, weight_decay=1e-4) if optimizer == "sgd"
           else jax_optim.AdamW(weight_decay=1e-4))
    st = jax_state.TrainState.create(params, bn, opt)
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    opt_state = (jax_step.init_sharded_opt_state(params, mesh, optimizer=opt) if zero1
                 else st.opt_state)
    residuals = jax_step.init_ef_state(params, mesh, zero1=zero1) if ef else st.ef
    per_dev = RUN["batch_size"] // world
    batch = {"images": jax.ShapeDtypeStruct((per_dev, 32, 32, 3), np.uint8),
             "labels": jax.ShapeDtypeStruct((per_dev,), np.int32)}
    return dict(params=params, opt_state=opt_state, ef=residuals, bn_state=bn, batch=batch)


def _assert_same_ledger(ours: dict, theirs: dict) -> None:
    assert set(ours["sections"]) == set(theirs["sections"])
    for name, sec in theirs["sections"].items():
        mine = ours["sections"][name]
        for key in ("bytes_per_device", "bytes_total", "n_leaves", "sharded_leaves"):
            assert mine[key] == sec[key], (name, key)
        assert [e["path"] for e in mine["top"]] == [e["path"] for e in sec["top"]], name
        assert mine["top"] == sec["top"], name
    assert ours == theirs


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_the_static_ledger_is_jaxs_at_one_rank(optimizer):
    t = trainer.Trainer(TrainConfig(**RUN, optimizer=optimizer, port=free_port()))
    try:
        ours = t._mem_static
        # a module walks as its parameters, in the JAX tree's names
        assert (memory.static_ledger(params=t.model)
                == memory.static_ledger(params=memory.state_sections(t.state)["params"]))
    finally:
        t.close()
    _assert_same_ledger(ours, jax_memory.static_ledger(**_jax_sections(optimizer, 1)))


def _xla_flops(batch: int) -> float:
    md = ResNetDef(NARROW["block"], NARROW["stage_blocks"], 10, widths=NARROW["widths"])
    params, bn = jax.eval_shape(md.init, jax.random.PRNGKey(0))

    def loss(p, s, x, y):
        logits, _ = md.apply(p, s, x, train=True)
        return -jax.numpy.mean(jax.numpy.take_along_axis(
            jax.nn.log_softmax(logits), y[:, None], 1))

    x = jax.ShapeDtypeStruct((batch, 32, 32, 3), np.float32)
    y = jax.ShapeDtypeStruct((batch,), np.int32)
    return jax_costmodel.analyze_jitted(jax.jit(jax.grad(loss)), params, bn, x, y)[
        "flops_per_step"]


# the narrow ResNet's step against XLA's count of its gradient: XLA also
# counts the elementwise work (BN, ReLU, the loss), a larger share of a
# narrow model's FLOPs than of ResNet-18's (0.9942): measured 0.9463, the
# same at both worlds
NARROW_FLOPS_BAND = (0.94, 0.95)


def test_zero1_and_int8_ef_ledgers_and_the_global_flop_count_at_two_ranks(tmp_path):
    cases = {"zero1": dict(shard_weight_update=True),
             "zero1-adamw": dict(shard_weight_update=True, optimizer="adamw"),
             "int8_ef": dict(grad_compression="int8_ef")}
    cfgs = [{**RUN, **kw, "port": free_port()} for kw in cases.values()]
    ranks = run_ranks(ledger_rank, 2, cfgs, timeout=120)
    one = ledger_rank(0, 1, [{**RUN, "port": free_port()}])[0]
    xla = _xla_flops(RUN["batch_size"])
    for i, name in enumerate(cases):
        zero1 = name.startswith("zero1")
        theirs = jax_memory.static_ledger(**_jax_sections(
            "adamw" if name.endswith("adamw") else "sgd", 2, zero1=zero1, ef=name == "int8_ef"))
        for r in ranks:  # each rank holds its own shard: the same ledger
            _assert_same_ledger(r[i]["static"], theirs)
        assert theirs["sections"]["opt_state" if zero1 else "ef"]["sharded_leaves"]
        # each rank counts its half of the batch; the gauge is the step's
        # total over both, as XLA's count of the global step is
        assert ranks[0][i]["flops"] == ranks[1][i]["flops"] == one["flops"]
        assert NARROW_FLOPS_BAND[0] <= ranks[0][i]["flops"] / xla <= NARROW_FLOPS_BAND[1]
        rec = ranks[0][i]["record"]
        assert rec["static"] == ranks[0][i]["static"]
        rc = rec["reconciliation"]
        assert rc["source"] == "census"
        assert rc["attributed_bytes"] + rc["unattributed_bytes"] == rc["bytes_in_use"]


def test_the_census_counts_each_storage_once_and_reconciles_exactly():
    before = memory.live_census("cpu")
    a = torch.zeros(1000)
    b = torch.zeros(50, dtype=torch.float64)
    mid = memory.live_census("cpu")
    views = [a[10:20], a.view(10, 100), a, b[5:], a.reshape(-1)]
    after = memory.live_census("cpu")
    assert mid["n_arrays"] - before["n_arrays"] == 2
    assert mid["bytes_device0"] - before["bytes_device0"] == 4000 + 400
    assert (after["n_arrays"], after["bytes_device0"]) == (mid["n_arrays"], mid["bytes_device0"])
    assert after["bytes_total"] == after["bytes_device0"] == after["bytes_by_device"]["0"]
    del views
    for allocator in (None, {}, {"bytes_in_use": after["bytes_device0"] + 12345},
                      {"bytes_in_use": 3}):
        rc = memory.reconcile(after, allocator)
        assert rc == jax_memory.reconcile(after, allocator)
        assert rc["attributed_bytes"] + rc["unattributed_bytes"] == rc["bytes_in_use"]
    rec = memory.ledger("cpu", static={"bytes_per_device": 7})
    rc = rec["reconciliation"]
    assert rc["source"] == "census" and rc["unattributed_bytes"] == 0
    assert rc["bytes_in_use"] == rc["attributed_bytes"] == rec["census"]["bytes_device0"]
    assert "allocator" not in rec and "xla" not in rec


@pytest.mark.parametrize("required,budget,headroom", [
    (10, 100, 0.9), (90, 100, 0.9), (91, 100, 0.9), (100, 100, 1.0), (10 ** 10, 16 * 2 ** 30, 0.5),
])
@pytest.mark.parametrize("action", ["off", "warn", "refuse"])
def test_the_preflight_decides_and_words_as_jax(required, budget, headroom, action):
    assert memory.feasibility(required, budget, headroom) == jax_memory.feasibility(
        required, budget, headroom)

    def outcome(mod):
        try:
            return mod.preflight_check(required, budget_bytes=budget, headroom=headroom,
                                       action=action)
        except (memory.InfeasibleMemoryError, jax_memory.InfeasibleMemoryError) as e:
            return ("refused", str(e))

    assert outcome(memory) == outcome(jax_memory)
    # no budget on this CPU: no check, in both packages
    assert memory.preflight_check(required, action=action, chip_kind="cpu") is None
    assert jax_memory.preflight_check(required, action=action) is None


def test_the_preflight_refuses_a_bad_action_and_a_bad_budget():
    for mod in (memory, jax_memory):
        with pytest.raises(ValueError, match="memory_check must be off|warn|refuse"):
            mod.preflight_check(1, budget_bytes=2, action="maybe")
        with pytest.raises(ValueError, match="budget_bytes must be positive"):
            mod.feasibility(1, 0)


def test_memory_check_refuse_stops_the_trainer_before_any_step(capsys):
    t = trainer.Trainer(TrainConfig(**RUN, memory_check="off", port=free_port()))
    required = t._mem_static["bytes_per_device"]
    t.close()
    budget = required // 2
    with pytest.raises(memory.InfeasibleMemoryError) as ours:
        fit_run(dict(RUN, memory_check="refuse", hbm_budget_bytes=budget, port=free_port()))
    with pytest.raises(jax_memory.InfeasibleMemoryError) as theirs:
        jax_memory.preflight_check(required, budget_bytes=budget, action="refuse")
    assert str(ours.value) == str(theirs.value)
    # warn: the run goes on, with JAX's warning line
    capsys.readouterr()
    run = fit_run(dict(RUN, memory_check="warn", hbm_budget_bytes=budget, port=free_port()))
    assert run["error"] is None and len(run["losses"]) == 1
    assert (f"WARNING: static HBM requirement {memory.fmt_bytes(required)}/device exceeds 90% of "
            f"the {memory.fmt_bytes(budget)} per-chip budget — expect RESOURCE_EXHAUSTED; shard "
            "more or shrink the batch (--memory_check refuse stops here)"
            in capsys.readouterr().out)


_XLA_OOM = """RESOURCE_EXHAUSTED: Out of memory while trying to allocate 2684354560 bytes.
BufferAssignment OOM Debugging.
Largest program allocations in hbm:
  1. Size: 2.50G
     Operator: op_name="jit(train_step)/dot_general"
     Shape: f32[8192,81920]
  2. Size: 640.0M
     XLA Label: fusion
     Shape: bf16[320,1024,1024]
"""
_TORCH_OOM = ("torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 64.00 MiB. GPU 0 "
              "has a total capacity of 79.18 GiB of which 1.50 GiB is free. Of the allocated "
              "memory 800.25 MiB is allocated by PyTorch, and 20.00 MiB is reserved by PyTorch "
              "but unallocated.")


def test_obs_memory_prints_what_the_jax_cli_prints(tmp_path, capsys):
    log = str(tmp_path / "run.jsonl")
    assert fit_run(dict(RUN, log_file=log, port=free_port()))["error"] is None
    texts = {"xla": str(tmp_path / "xla.txt"), "torch": str(tmp_path / "torch.txt")}
    for name, body in (("xla", _XLA_OOM), ("torch", _TORCH_OOM)):
        with open(texts[name], "w") as f:
            f.write(body)
    capsys.readouterr()
    for argv in ([log], [log, "--format", "json"], ["--oom", texts["xla"]],
                 ["--oom", texts["xla"], "--format", "json"]):
        assert obs.main(["memory", *argv]) == 0
        ours = capsys.readouterr().out
        assert jax_obs.main(["memory", *argv]) == 0
        assert ours == capsys.readouterr().out
    # PyTorch's CUDA text: the port reads it, the JAX markers miss its case
    assert obs.main(["memory", "--oom", texts["torch"]]) == 0
    assert capsys.readouterr().out.splitlines()[0] == (
        "OOM: requested 64.0MiB, used 800.2MiB of 79.2GiB")
    assert jax_obs.main(["memory", "--oom", texts["torch"]]) == 1
    empty = str(tmp_path / "empty.jsonl")
    with open(empty, "w") as f:
        f.write(json.dumps({"kind": "eval", "epoch": 0}) + "\n")
    assert obs.main(["memory", empty]) == jax_obs.main(["memory", empty]) == 1
    assert obs.main(["memory", str(tmp_path / "missing.jsonl")]) == 2
    with open(log) as f:
        recs = [json.loads(line) for line in f]
    [mem] = [r for r in recs if r["kind"] == "memory"]
    assert memory.record_peak_hbm(mem) == mem["reconciliation"]["bytes_in_use"]
    # the summary (its ledger line and the compare gate's peak) is JAX's
    assert summarize.summarize(recs, 0) == jax_summarize.summarize(recs, 0)
    assert summarize.summarize(recs, 0)["memory"]["peak_hbm_bytes"] == memory.record_peak_hbm(mem)
