"""The refusals around ``--pp``, ``--pp_microbatches`` and
``--pp_interleave``, each held to the JAX package's own message on the same
configuration: the trainer's (``tpu_dist/train/trainer.py:260-276``,
``:494-558``: the interleave flag's range and its need of ``pp``, the
combinations, a model without a pipeline branch or without the interleaved
layout, fewer microbatches than stages under interleaving, a depth that
does not divide into the chunks, the fused epoch, ZeRO-1, the quantized
wires, a batch that does not divide into the microbatches,
``--device_metrics``) and the step's (``tpu_dist/train/step.py:517-531``)."""

import jax
import pytest
import torch
from torch_ranks import free_port, run_ranks, trainer_errors_rank

from tpu_dist.comm import mesh as mesh_lib
from tpu_dist.config import TrainConfig as JaxConfig
from tpu_dist.nn.vit_pp import ViTPipelineDef
from tpu_dist.train import trainer as jax_trainer
from tpu_dist.train.optim import SGD as JaxSGD
from tpu_dist.train.step import make_train_step as jax_make_train_step
from tpu_dist_torch.comm.mesh import AxisGroup
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.nn import vit, vit_pp
from tpu_dist_torch.train import optim, state, step, trainer

BASE = dict(dataset="synthetic", synthetic_n=160, batch_size=16, num_classes=10, epochs=1)
PP = dict(BASE, model="vit_pp_tiny")

# name -> (config, world: the port's ranks and the JAX mesh's devices, the
# JAX mesh's second axis)
CASES = {
    "pp_interleave-0": (dict(PP, pp=2, pp_interleave=0), 1, None),
    "interleave-without-pp": (dict(BASE, model="vit_tiny", pp_interleave=2), 1, None),
    "sp+pp": (dict(PP, sp=2, pp=2), 1, None),
    "ep+pp": (dict(BASE, model="vit_moe_tiny", ep=2, pp=2), 1, None),
    "pp-int8": (dict(PP, pp=2, grad_compression="int8"), 1, None),
    "pp-device_metrics": (dict(PP, pp=2, device_metrics=True), 1, None),
    "pp-resnet": (dict(BASE, model="resnet18", num_classes=100, pp=2), 2, "pipe"),
    "pp-interleave-microbatches": (dict(PP, pp=2, pp_interleave=2, pp_microbatches=1), 2,
                                   "pipe"),
    "pp-depth": (dict(PP, pp=2, pp_interleave=4), 2, "pipe"),
    "pp-fused": (dict(PP, pp=2, fused_epoch=True), 2, "pipe"),
    "pp-zero1": (dict(PP, pp=2, shard_weight_update=True), 2, "pipe"),
    "pp-batch": (dict(PP, pp=2, pp_microbatches=3), 2, "pipe"),
}


def _jax_error(cfg, world, second):
    """``"TypeName: message"`` the JAX trainer raises on ``cfg``, on a
    ``[1, world]`` mesh of ``[data, second]`` (or its default mesh)."""
    mesh = (mesh_lib.device_mesh([1, world], ["data", second], jax.devices()[:world])
            if second else None)
    try:
        jax_trainer.Trainer(JaxConfig(**cfg), mesh=mesh)
    except Exception as e:  # the refusal under test
        return f"{type(e).__name__}: {e}"
    return None


@pytest.fixture(scope="module")
def port_errors():
    out = {}
    for world in (1, 2):
        names = [n for n, (_, w, _) in CASES.items() if w == world]
        cfgs = [dict(CASES[n][0], device="cpu") for n in names]
        if world == 1:
            errs = trainer_errors_rank(0, 1, [dict(c, port=free_port()) for c in cfgs])
        else:
            errs = run_ranks(trainer_errors_rank, world, cfgs, timeout=90)[0]
        out.update(zip(names, errs))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_the_refusal_is_the_jax_trainers(port_errors, name):
    cfg, world, second = CASES[name]
    want = _jax_error(cfg, world, second)
    assert want is not None and want.startswith("ValueError: "), want
    assert port_errors[name] == want


def test_a_model_without_the_interleaved_layout_is_refused_as_jax_refuses_it():
    """A registered model with a pipeline branch but no interleave/pp_stages
    fields (the JAX package's own test model; a factory without those
    arguments here)."""

    class PPButNoInterleave:
        depth = 4

        def apply(self, params, state, x, *, train=False, axis_name=None, pp_axis=None,
                  n_microbatches=0):  # pragma: no cover - never reached
            raise NotImplementedError

    jax_trainer.register_model("pp_no_ilv", lambda num_classes=10: PPButNoInterleave())
    cfg = dict(PP, model="pp_no_ilv", pp=2, pp_interleave=2)
    want = _jax_error(cfg, 2, "pipe")
    trainer.register_model("pp_no_ilv", lambda num_classes=10, device="cpu", seed=0, pipe=None:
                           vit_pp.vit_pp_tiny(num_classes, device=device, seed=seed, pipe=pipe))
    with pytest.raises(ValueError) as info:
        trainer.build_model(TrainConfig(**cfg, device="cpu"), "cpu", 0,
                            **trainer.pipeline_shard(TrainConfig(**cfg), _FakeMesh()))
    assert f"ValueError: {info.value}" == want


class _FakeMesh:
    """The axes ``pipeline_shard`` reads of a ``[1, 2]`` pipe mesh, as rank 0
    sees it, without a process group."""

    def __getitem__(self, name):
        return AxisGroup(name, 2, 0)


def _jax_step_error(**kw):
    md = ViTPipelineDef()
    mesh = mesh_lib.device_mesh([1, 2], ["data", "pipe"], jax.devices()[:2])
    try:
        jax_make_train_step(md.apply, JaxSGD(), mesh, pp_axis="pipe", **kw)
    except ValueError as e:  # the refusal under test
        return str(e)
    return None


@pytest.mark.parametrize("kw", [dict(shard_weight_update=True), dict(seq_axis="seq"),
                                dict(ep_axis="expert"), dict(grad_compression="int8")],
                         ids=["zero1", "seq", "ep", "int8"])
def test_the_step_refuses_what_jax_refuses(kw):
    specs = ViTPipelineDef().pp_param_specs("pipe")
    want = _jax_step_error(param_specs=specs, **kw)
    axis = {"seq_axis": AxisGroup("seq", 1, 0), "ep_axis": AxisGroup("expert", 1, 0)}
    port = {k: axis.get(k, v) for k, v in kw.items()}
    with pytest.raises(ValueError) as info:
        step.make_train_step(optim.SGD(), pp_axis=AxisGroup("pipe", 1, 0), **port)
    assert want is not None and str(info.value) == want


def test_a_model_without_a_stage_is_refused_as_without_param_specs():
    want = _jax_step_error()
    model = vit.vit_tiny(device="cpu")
    opt = optim.SGD()
    with pytest.raises(ValueError) as info:
        step.make_train_step(opt, pp_axis=AxisGroup("pipe", 1, 0))(
            state.TrainState.create(model, opt), torch.zeros(2, 32, 32, 3),
            torch.zeros(2, dtype=torch.long), 0.1)
    assert want == "pp_axis requires param_specs (per-leaf shardings)"
    assert str(info.value).startswith(want)


def test_model_axes_across_hosts_are_refused():
    """JAX's ``_check_mesh_host_layout``: a pipe (and model) group must lie
    on one host. 8 ranks, 2 a host: ``[data, pipe] = [2, 4]`` puts a pipe
    group on 2 hosts; 4 a host keeps it on one; ``[data, pipe, model] = [4,
    1, 2]`` keeps each stage group on one host of 2."""
    from tpu_dist_torch.comm import mesh  # noqa: PLC0415

    with pytest.raises(ValueError) as info:
        mesh.check_model_axes_intra_host(mesh.pp_mesh(4, world=8, rank=0), {"pipe": 4}, 2)
    assert str(info.value) == (
        "mesh lays model axes ['pipe'] across hosts (DCN): with 2 devices/host, keep "
        "tp*ep*pp ways a divisor of the local device count")
    mesh.check_model_axes_intra_host(mesh.pp_mesh(4, world=8, rank=0), {"pipe": 4}, 4)
    mesh.check_model_axes_intra_host(mesh.pp_mesh(1, 2, world=8, rank=0),
                                     {"pipe": 1, "model": 2}, 2)
