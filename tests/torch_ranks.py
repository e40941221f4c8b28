"""Run a function on N CPU ranks of a gloo process group, for the port's
multi-rank tests.

Each rank is a process started with the ``spawn`` method (a fresh
interpreter that imports only this module, torch and the port, never
JAX), joins a gloo group on a free localhost port, calls
``fn(rank, world, *args)`` and writes what it returns to a pickle file
that the parent reads back, in rank order. The parent waits at most
``timeout`` seconds and then kills the ranks and fails.

The rank functions for those tests live here too, so the children import
nothing else.

Every port test module imports this one, and importing it gives the test
process one intra-op torch thread: the suite's workers share the host's
cores, and torch's default of a thread per core in each of them
oversubscribes the host many times over. ``child_env`` gives a test's
``subprocess`` children the same through ``OMP_NUM_THREADS=1``. The
program itself keeps torch's defaults.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import tempfile
import time

import numpy as np
import torch
import torch.multiprocessing as mp

torch.set_num_threads(1)


def child_env(**extra: str) -> dict:
    """The test process's environment with one OpenMP thread, and ``extra``,
    for a child started through ``subprocess``."""
    return {**os.environ, "OMP_NUM_THREADS": "1", **extra}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, out_dir, fn):
    import torch.distributed as dist  # noqa: PLC0415

    from tpu_dist_torch.comm import mesh  # noqa: PLC0415

    with open(os.path.join(out_dir, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    torch.set_num_threads(1)
    mesh.initialize_distributed("cpu", world_size=world, rank=rank, master_port=port)
    try:
        result = fn(rank, world, *args)
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, timeout: float = 120.0) -> list:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each run
    on its own rank of a ``world``-rank gloo group. The arguments reach the
    ranks through a pickle file: handed to the spawn itself, numpy arrays
    made each rank's start-up take ~20 s longer."""
    with tempfile.TemporaryDirectory() as out_dir:
        with open(os.path.join(out_dir, "args.pkl"), "wb") as f:
            pickle.dump(args, f)
        ctx = mp.start_processes(_entry, args=(world, free_port(), out_dir, fn),
                                 nprocs=world, join=False, start_method="spawn")
        try:
            deadline = time.monotonic() + timeout
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        out = []
        for rank in range(world):
            with open(os.path.join(out_dir, f"{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# -- rank functions ----------------------------------------------------------


def bn_rank(rank, world, cases):
    """Each case ``(x, w, scale, bias, sync, dtype)``: BatchNorm, synced over
    the group or per rank, on this rank's contiguous share of the global
    NHWC batch ``x``; returns per case the output, the new running
    statistics and the gradient of sum(y * w) by the input (NHWC)."""
    from tpu_dist_torch.comm import collectives  # noqa: PLC0415
    from tpu_dist_torch.nn import layers  # noqa: PLC0415

    def nchw(a):
        n = a.shape[0] // world
        return torch.from_numpy(a[rank * n:(rank + 1) * n]).permute(0, 3, 1, 2)

    def nhwc(t):
        return t.detach().float().permute(0, 2, 3, 1).numpy()

    out = []
    for x, w, scale, bias, sync, dtype in cases:
        xt = nchw(x).to(getattr(torch, dtype)).detach().requires_grad_()
        bn = layers.BatchNorm(x.shape[-1])
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(scale))
            bn.bias.copy_(torch.from_numpy(bias))
        y = bn(xt, train=True, group=collectives.sync_group(sync))
        (gx,) = torch.autograd.grad((y.float() * nchw(w)).sum(), xt)
        out.append({"y": nhwc(y), "gx": nhwc(gx), "mean": bn.running_mean.numpy(),
                    "var": bn.running_var.numpy()})
    return out


def dp_step_rank(rank, world, cases, model_kw, params, bn_state, batches):
    """Each case: the port's train step on this rank's half of every global
    batch, from the bridged JAX weights; returns, per case, the metrics of
    each step and the final parameters, momentum and BN state (as JAX
    pytrees) with the collective counts of the run."""
    from tpu_dist_torch import bridge  # noqa: PLC0415
    from tpu_dist_torch.nn import resnet  # noqa: PLC0415
    from tpu_dist_torch.obs import counters  # noqa: PLC0415
    from tpu_dist_torch.train import optim, state, step  # noqa: PLC0415

    out = {}
    for name, kw in cases.items():
        model = resnet.ResNet(**model_kw, device="cpu")
        bridge.load_jax_resnet(model, params, bn_state)
        opt = optim.SGD(momentum=0.9, weight_decay=1e-4, fused=True)
        st = state.TrainState.create(model, opt)
        dtype = torch.bfloat16 if kw.get("bf16") else torch.float32
        train_step = step.make_train_step(
            opt, grad_accum_steps=kw["K"], sync_bn=kw["sync_bn"], compute_dtype=dtype,
            pmean_fusion=kw["fusion"])
        counters.reset()
        metrics = []
        for images, labels, lr in batches:
            n = images.shape[0] // world
            st, m = train_step(st, images[rank * n:(rank + 1) * n],
                               labels[rank * n:(rank + 1) * n], lr)
            metrics.append({k: v.item() for k, v in m.items()})
        p, s = bridge.resnet_params_to_jax(model)
        out[name] = {"metrics": metrics, "params": p, "bn_state": s,
                     "momentum": bridge.resnet_sgd_state_to_jax(model, st.opt_state),
                     "counts": {k: v for k, v in counters.snapshot().items()
                                if k.startswith("comm.")}}
    return out


def remat_rank(rank, world, model_kw, batches):
    """The port's train step (SyncBN, fused gradient reduce) without and
    with ``remat`` from the same seeded weights on this rank's half of
    every global batch; returns, for each, the final module state dict and
    SGD momentum (numpy) and the collective counts of the run."""
    from tpu_dist_torch.nn import resnet  # noqa: PLC0415
    from tpu_dist_torch.obs import counters  # noqa: PLC0415
    from tpu_dist_torch.train import optim, state, step  # noqa: PLC0415

    out = {}
    for remat in (False, True):
        model = resnet.ResNet(**model_kw, device="cpu", seed=0)
        opt = optim.SGD(momentum=0.9, weight_decay=1e-4)
        st = state.TrainState.create(model, opt)
        train_step = step.make_train_step(opt, sync_bn=True, remat=remat)
        counters.reset()
        for images, labels, lr in batches:
            n = images.shape[0] // world
            st, _ = train_step(st, images[rank * n:(rank + 1) * n],
                               labels[rank * n:(rank + 1) * n], lr)
        out[remat] = {"state": {k: v.numpy().copy() for k, v in model.state_dict().items()},
                      "momentum": [b.numpy().copy() for b in st.opt_state],
                      "counts": {k: v for k, v in counters.snapshot().items()
                                 if k.startswith("comm.")}}
    return out


def collectives_rank(rank, world, x_global):
    """Each collective of ``tpu_dist_torch.comm.collectives`` on this rank's
    row of ``x_global``; returns the results and the all-reduce counts."""
    from tpu_dist_torch.comm import collectives  # noqa: PLC0415
    from tpu_dist_torch.obs import counters  # noqa: PLC0415

    x = torch.from_numpy(x_global[rank])
    out = {
        "reduce_mean": collectives.reduce_mean(x).numpy(),
        "reduce_sum": collectives.reduce_sum(x, kind="test").numpy(),
        "all_gather": collectives.all_gather(x).numpy(),
        "broadcast_from": collectives.broadcast_from(x.clone(), src=world - 1).numpy(),
        "host_allreduce_mean": collectives.host_allreduce_mean(float(rank)),
    }
    collectives.barrier()
    model = torch.nn.Linear(3, 2)
    with torch.no_grad():
        model.weight.fill_(rank)
    collectives.broadcast_module(model)
    out["broadcast_module"] = model.weight.detach().numpy().copy()
    out["input_unchanged"] = bool((x == torch.from_numpy(x_global[rank])).all())
    out["counts"] = {k: v for k, v in counters.snapshot().items() if k.startswith("comm.")}
    return out


# -- Trainer.fit runs (checkpoint / resume / preemption) ----------------------

NARROW = dict(block="basic", stage_blocks=(1, 1, 1, 1), widths=(8, 16, 32, 64))


def narrow_resnet(num_classes, device, seed):
    """The narrow ResNet of the trainer tests, for ``register_model``."""
    from tpu_dist_torch.nn import resnet  # noqa: PLC0415

    return resnet.ResNet(NARROW["block"], NARROW["stage_blocks"], num_classes,
                         widths=NARROW["widths"], device=device, seed=seed)


def fit_run(cfg_kw, *, epochs=None, interrupt_at=None, kill_at=None, nan_at=None,
            interrupt_rank=0):
    """``Trainer(TrainConfig(**cfg_kw)).fit(epochs)`` with its step wrapped:
    the call numbered ``interrupt_at`` (counting from 0, on rank
    ``interrupt_rank`` only) first sends this process SIGTERM, the call
    ``kill_at`` raises ``RuntimeError`` instead of stepping (a crash: no
    emergency snapshot), and the call ``nan_at`` reports a NaN loss. Returns
    a dict: per-call losses and learning rates, the epoch dicts, the final
    state as the flat checkpoint dict, the start epoch, the LR scale and the
    exception ``fit`` raised (its type name), if any, the ``--auto_shard``
    plan and ``--tune_report`` record, the config trained (as a dict), the
    static ledger's params section and the first step's cost count."""
    import signal  # noqa: PLC0415

    from tpu_dist_torch import bridge  # noqa: PLC0415
    from tpu_dist_torch.comm import mesh  # noqa: PLC0415
    from tpu_dist_torch.config.config import TrainConfig  # noqa: PLC0415
    from tpu_dist_torch.resilience.preemption import PreemptedError  # noqa: PLC0415
    from tpu_dist_torch.train import trainer  # noqa: PLC0415

    trainer.register_model("narrow_resnet", narrow_resnet)
    t = trainer.Trainer(TrainConfig(**cfg_kw))
    out = {"losses": [], "lrs": [], "epochs": [], "start_epoch": t.start_epoch, "error": None}
    calls = [0]
    inner_step, inner_epoch = t.train_step, t.train_epoch

    def step(st, images, labels, lr):
        i = calls[0]
        calls[0] += 1
        if i == kill_at:
            raise RuntimeError(f"killed at call {i}")
        if i == interrupt_at and mesh.process_index() == interrupt_rank:
            os.kill(os.getpid(), signal.SIGTERM)
        st, m = inner_step(st, images, labels, lr)
        if i == nan_at:
            m["loss"] = torch.full((), float("nan"))
        out["losses"].append(m["loss"].item())
        out["lrs"].append(float(lr))
        return st, m

    def train_epoch(epoch, *a, **k):
        out["epochs"].append(inner_epoch(epoch, *a, **k))
        return out["epochs"][-1]

    t.train_step, t.train_epoch = step, train_epoch
    try:
        t.fit(epochs)
    except (PreemptedError, RuntimeError) as e:
        out["error"] = type(e).__name__
    finally:
        t.close()
    out["state"] = bridge.train_state_to_flat(t.state)
    out["plan"], out["tune"] = t._plan, t._tune
    out["cfg"] = dataclasses.asdict(t.cfg)
    out["lr_scale"] = t._lr_scale
    out["ledger"] = t._mem_static["sections"]["params"]
    out["cost"] = t._step_cost
    return out


def resume_rank(rank, world, cfg_kw, root, interrupt_at):
    """An uninterrupted run, and the same run interrupted by a SIGTERM that
    only rank 0 sees, then resumed, each in its own ckpt_dir under
    ``root``."""
    from tpu_dist_torch import ckpt  # noqa: PLC0415
    from tpu_dist_torch.comm import collectives  # noqa: PLC0415

    full = fit_run({**cfg_kw, "ckpt_dir": os.path.join(root, "full")})
    cut = fit_run({**cfg_kw, "ckpt_dir": os.path.join(root, "cut")}, interrupt_at=interrupt_at)
    collectives.barrier()  # rank 0 has published the emergency snapshot
    cut["meta"] = ckpt.read_meta(ckpt.latest_checkpoint(os.path.join(root, "cut"))[0])
    rest = fit_run({**cfg_kw, "ckpt_dir": os.path.join(root, "cut"), "resume": True})
    return full, cut, rest


def ladder_rank(rank, world, cfg_kw):
    """A resuming trainer's start epoch, step and restored state."""
    from tpu_dist_torch import bridge  # noqa: PLC0415
    from tpu_dist_torch.config.config import TrainConfig  # noqa: PLC0415
    from tpu_dist_torch.train import trainer  # noqa: PLC0415

    trainer.register_model("narrow_resnet", narrow_resnet)
    t = trainer.Trainer(TrainConfig(**cfg_kw))
    try:
        return t.start_epoch, t.state.step, bridge.train_state_to_flat(t.state)
    finally:
        t.close()


def ladders_rank(rank, world, cfgs):
    """:func:`ladder_rank` of each config in turn."""
    return [ladder_rank(rank, world, cfg) for cfg in cfgs]


def fit_rank(rank, world, cfg_kw):
    """:func:`fit_run` on one rank; returns the error it raised (None)."""
    return fit_run(cfg_kw)["error"]


# -- the fused epoch ------------------------------------------------------------


def fused_epoch_rank(rank, world, cases, model_kw, params, bn_state, images, labels):
    """Each case (``pad``, ``bf16``, ``batch``, ``lr``, ``wire`` (the
    gradient reduce's ``grad_compression``) and ``draws``, where
    ``draws[epoch][rank]`` is this rank's ``(order, offsets)``): the port's
    fused epochs on this rank's share of ``images``/``labels``
    (``put_dataset_on_device``) from the bridged JAX weights, with plain
    SGD. Returns per case the epoch metrics and the final parameters,
    momentum and BN state as JAX pytrees, and this rank's device data."""
    from tpu_dist_torch import bridge  # noqa: PLC0415
    from tpu_dist_torch.nn import resnet  # noqa: PLC0415
    from tpu_dist_torch.train import epoch, optim, state  # noqa: PLC0415

    x, y = epoch.put_dataset_on_device(images, labels, world=world, rank=rank, device="cpu")
    out = {"data": (x.numpy(), y.numpy())}
    for name, case in cases.items():
        model = resnet.ResNet(**model_kw, device="cpu")
        bridge.load_jax_resnet(model, params, bn_state)
        opt = optim.SGD(momentum=0.9, weight_decay=1e-4)
        st = state.TrainState.create(model, opt)
        runner = epoch.make_fused_epoch(
            opt, batch_per_device=case["batch"], pad=case["pad"],
            compute_dtype=torch.bfloat16 if case["bf16"] else torch.float32,
            grad_compression=case.get("wire", "none"))
        metrics = []
        for draw in case["draws"]:
            order, offsets = (torch.from_numpy(a) for a in draw[rank])
            st, m = runner.run(st, x, y, case["lr"], order, offsets)
            metrics.append({k: v.item() for k, v in m.items()})
        p, s = bridge.resnet_params_to_jax(model)
        out[name] = {"metrics": metrics, "params": p, "bn_state": s, "step": st.step,
                     "momentum": bridge.resnet_sgd_state_to_jax(model, st.opt_state)}
    return out


def fused_eval_rank(rank, world, model_kw, params, bn_state, images, labels, batch):
    """The port's fused eval of the bridged weights over this rank's share
    of ``images``/``labels``; returns the global sums as floats."""
    from tpu_dist_torch import bridge  # noqa: PLC0415
    from tpu_dist_torch.nn import resnet  # noqa: PLC0415
    from tpu_dist_torch.train import epoch, optim, state  # noqa: PLC0415

    model = resnet.ResNet(**model_kw, device="cpu")
    bridge.load_jax_resnet(model, params, bn_state)
    st = state.TrainState.create(model, optim.SGD())
    x, y = epoch.put_dataset_on_device(images, labels, world=world, rank=rank, device="cpu")
    sums = epoch.make_fused_eval(batch_per_device=batch, compute_dtype=torch.float32)(st, x, y)
    return {k: v.item() for k, v in sums.items()}


def fused_fit_rank(rank, world, cfg_kw):
    """:func:`fit_run` of a ``fused_epoch`` config on one rank, with the
    counters after it."""
    from tpu_dist_torch.obs import counters  # noqa: PLC0415

    out = fit_run(cfg_kw)
    out["counters"] = counters.snapshot()
    return out


# -- compressed collectives and ZeRO-1 ----------------------------------------


class DrawsKey:
    """A stand-in for ``quantize.StreamKey`` that hands out given draws (the
    JAX package's ``jax.random.uniform``), by the path of folds that led to
    it: ``draws[(1,)]`` is what ``key.fold(1).uniform(...)`` returns."""

    def __init__(self, draws: dict, path: tuple = ()):
        self.draws, self.path = draws, path

    def fold(self, data) -> "DrawsKey":
        return DrawsKey(self.draws, self.path + (int(data),))

    def uniform(self, shape, device):
        return torch.tensor(self.draws[self.path]).reshape(tuple(shape)).to(device)


def pmean_rank(rank, world, cases, grads_global):
    """Each case ``(mode, chunk, ef_global, draws)``: the port's
    ``compressed_pmean`` of this rank's row of every array in
    ``grads_global``, with this rank's rows of the global residuals and
    the JAX draws of this rank (``draws[rank]``); returns the mean
    gradients, the new residuals and the collective counts."""
    from tpu_dist_torch.obs import counters  # noqa: PLC0415
    from tpu_dist_torch.train import step  # noqa: PLC0415

    out = {}
    for name, (mode, chunk, ef_global, draws) in cases.items():
        grads = [torch.from_numpy(np.ascontiguousarray(g[rank])) for g in grads_global]
        ef = ()
        if ef_global:
            ef = {k: torch.from_numpy(v.reshape(world, -1)[rank].copy())
                  for k, v in ef_global.items()}
        counters.reset()
        key = DrawsKey(draws[rank]) if draws else None
        red, new_ef = step.compressed_pmean(grads, mode, key=key, ef=ef, chunk=chunk)
        out[name] = {"grads": [r.numpy() for r in red],
                     "ef": {k: v.numpy() for k, v in (new_ef or {}).items()},
                     "counts": {k: v for k, v in counters.snapshot().items()
                                if k.startswith("comm.")}}
    return out


class Probe(torch.nn.Module):
    """A model whose flat parameter vector is the same in both packages:
    two 1-D leaves ``a`` and ``b`` (JAX ravels its sorted dict keys, the
    port its parameters in order). Its logits are 0 in every class but
    class 0's, ``sum((p - stop_gradient(p)) * x)`` over the raveled ``p``,
    which is 0 too, so the gradient is ``x`` scaled by the loss's
    cotangent, an exact product."""

    def __init__(self, a, b, num_classes):
        super().__init__()
        self.a = torch.nn.Parameter(torch.from_numpy(np.array(a)))
        self.b = torch.nn.Parameter(torch.from_numpy(np.array(b)))
        self.num_classes = num_classes

    def forward(self, x):
        flat = torch.cat([self.a, self.b])
        s = ((flat - flat.detach()) * x).sum(-1)
        return torch.nn.functional.pad(s[:, None], (0, self.num_classes - 1))


def zero1_probe_rank(rank, world, cases, params, num_classes, batches, draws):
    """Each case (``wire`` int8/int8_ef, ``clip``, ``chunk``): the port's
    ZeRO-1 step of :class:`Probe` on this rank's half of every global
    batch, with plain SGD, the int8 rounding handed the JAX draws of this
    rank and step (``draws[step][rank]``, in place of ``step.quant_key``).
    Returns per case the losses, the parameters, this rank's momentum
    shard and ``r1`` row, and the collective counts."""
    from tpu_dist_torch.obs import counters  # noqa: PLC0415
    from tpu_dist_torch.train import optim, state, step  # noqa: PLC0415

    step.quant_key = lambda s, rank=None: DrawsKey({(): draws[int(s)][rank]})
    out = {}
    for name, kw in cases.items():
        model = Probe(params["a"], params["b"], num_classes)
        opt = optim.SGD(momentum=0.9, weight_decay=1e-4, fused=True)
        lay = step.flat_layout(model)
        st = state.TrainState(model, {}, step.init_sharded_opt_state(model, opt, layout=lay),
                              layout=lay)
        if kw["wire"] == "int8_ef":
            st.ef = step.init_ef_state(model, zero1=True, layout=lay)
        train_step = step.make_train_step(opt, shard_weight_update=True,
                                          grad_compression=kw["wire"], quant_chunk=kw["chunk"],
                                          grad_clip_norm=kw["clip"])
        counters.reset()
        losses = []
        for images, labels, lr in batches:
            n = images.shape[0] // world
            st, m = train_step(st, images[rank * n:(rank + 1) * n],
                               labels[rank * n:(rank + 1) * n], lr)
            losses.append(m["loss"].item())
        out[name] = {"losses": losses, "a": model.a.detach().numpy().copy(),
                     "b": model.b.detach().numpy().copy(), "mom": st.opt_state.numpy().copy(),
                     "r1": st.ef["r1"].numpy().copy() if st.ef else None,
                     "counts": {k: v for k, v in counters.snapshot().items()
                                if k.startswith("comm.")}}
    return out


def zero1_rank(rank, world, cases, model_kw, params, bn_state, batches, probe=None):
    """Each case (``optimizer`` sgd/adamw, ``rs_ag_chunks``, ``wire``): the
    port's ZeRO-1 train step on this rank's half of every global batch,
    from the bridged JAX weights. Returns per case the metrics of each
    step, the parameters (JAX pytree), the flat optimizer state as the
    checkpoint writes it (JAX order, gathered) and the collective counts;
    then, under ``"probe"``, :func:`zero1_probe_rank` of the arguments
    ``probe``, if given."""
    from tpu_dist_torch import bridge  # noqa: PLC0415
    from tpu_dist_torch.nn import resnet  # noqa: PLC0415
    from tpu_dist_torch.obs import counters  # noqa: PLC0415
    from tpu_dist_torch.train import optim, state, step  # noqa: PLC0415

    out = {}
    for name, kw in cases.items():
        model = resnet.ResNet(**model_kw, device="cpu")
        bridge.load_jax_resnet(model, params, bn_state)
        opt = (optim.AdamW(weight_decay=0.05) if kw["optimizer"] == "adamw"
               else optim.SGD(momentum=0.9, weight_decay=1e-4, fused=True))
        lay = step.flat_layout(model)
        st = state.TrainState(model, dict(model.named_buffers()),
                              step.init_sharded_opt_state(model, opt, layout=lay),
                              layout=lay)
        if kw.get("wire") == "int8_ef":
            st.ef = step.init_ef_state(model, zero1=True, layout=lay)
        train_step = step.make_train_step(
            opt, shard_weight_update=True, rs_ag_chunks=kw.get("rs_ag_chunks", 1),
            grad_compression=kw.get("wire", "none"))
        counters.reset()
        metrics = []
        for images, labels, lr in batches:
            n = images.shape[0] // world
            st, m = train_step(st, images[rank * n:(rank + 1) * n],
                               labels[rank * n:(rank + 1) * n], lr * kw.get("lr_scale", 1.0))
            metrics.append({k: v.item() for k, v in m.items()})
        counts = {k: v for k, v in counters.snapshot().items() if k.startswith("comm.")}
        flat = bridge.train_state_to_flat(st)
        out[name] = {"metrics": metrics, "params": bridge.resnet_params_to_jax(model)[0],
                     "opt": {k: v for k, v in flat.items() if k.startswith("['opt_state']")
                             or k.startswith("['ef']")},
                     "local_opt": (st.opt_state.numpy().copy() if isinstance(st.opt_state, torch.Tensor)
                                   else st.opt_state["mu"].numpy().copy()),
                     "counts": counts}
    if probe is not None:
        out["probe"] = zero1_probe_rank(rank, world, *probe)
    return out


def elastic_fit_rank(rank, world, runs):
    """For each ``cfg_kw`` of ``runs`` in turn: ``Trainer.fit`` on this rank
    (a SIGTERM from a ``--fault_plan`` clause ends it with the emergency
    snapshot); returns per run the last epoch's dict (None when preempted),
    the start epoch, the state as the checkpoint writes it (gathered over
    the ranks; ``restored`` as the resume left it, for a resuming run) and
    this rank's counters."""
    from tpu_dist_torch import bridge  # noqa: PLC0415
    from tpu_dist_torch.config.config import TrainConfig  # noqa: PLC0415
    from tpu_dist_torch.obs import counters  # noqa: PLC0415
    from tpu_dist_torch.resilience.preemption import PreemptedError  # noqa: PLC0415
    from tpu_dist_torch.train import trainer  # noqa: PLC0415

    trainer.register_model("narrow_resnet", narrow_resnet)
    out = []
    for cfg_kw in runs:
        t = trainer.Trainer(TrainConfig(**cfg_kw))
        rec = {"start_epoch": t.start_epoch, "resume_examples": t._resume_examples}
        if cfg_kw.get("resume"):
            rec["restored"] = bridge.train_state_to_flat(t.state)
        try:
            rec["last"] = t.fit()
        except PreemptedError:
            rec["last"] = None
        rec["flat"] = bridge.train_state_to_flat(t.state)
        rec["counters"] = counters.snapshot()
        t.close()
        out.append(rec)
    return out


def ctrl_c_rank(rank, world, cfg_kw, at):
    """``Trainer.fit`` stopped by Ctrl-C at its step call ``at`` (from 0):
    on rank 0 it lands inside the step, once the step's collectives are
    done; on the other ranks after the step, at the stop vote. Returns
    the error ``fit`` raised (its type name) and the checkpoint files on
    disk after it."""
    from tpu_dist_torch.config.config import TrainConfig  # noqa: PLC0415
    from tpu_dist_torch.train import trainer  # noqa: PLC0415

    trainer.register_model("narrow_resnet", narrow_resnet)
    t = trainer.Trainer(TrainConfig(**cfg_kw))
    calls = [0]
    inner_step, inner_stop = t.train_step, t._stop_agreed

    def step(*a):
        out = inner_step(*a)
        calls[0] += 1
        if rank == 0 and calls[0] == at + 1:
            raise KeyboardInterrupt
        return out

    def stop(*a, **k):
        if rank != 0 and calls[0] == at + 1:
            raise KeyboardInterrupt
        return inner_stop(*a, **k)

    t.train_step, t._stop_agreed = step, stop
    error = None
    try:
        t.fit()
    except KeyboardInterrupt:
        error = "KeyboardInterrupt"
    finally:
        t.close()
    return error, sorted(os.listdir(cfg_kw["ckpt_dir"]))


def elastic_and_ctrl_c_rank(rank, world, runs, ctrl_c_kw, at):
    """:func:`elastic_fit_rank` of ``runs``, then :func:`ctrl_c_rank`, in
    one start of the ranks."""
    return elastic_fit_rank(rank, world, runs), ctrl_c_rank(rank, world, ctrl_c_kw, at)


# -- the training-health chain ------------------------------------------------------


def health_step_rank(rank, world, model_kw, params, bn_state, batches):
    """The port's train step without and with ``device_metrics`` from the
    same bridged weights, on this rank's half of every global batch.
    Returns, per flag, the metrics of each step (floats), the collective
    counts and the kernel wrappers' launch counts of the run."""
    from tpu_dist_torch import bridge  # noqa: PLC0415
    from tpu_dist_torch.nn import resnet  # noqa: PLC0415
    from tpu_dist_torch.obs import counters  # noqa: PLC0415
    from tpu_dist_torch.ops import flash_attention, fused_sgd  # noqa: PLC0415
    from tpu_dist_torch.train import optim, state, step  # noqa: PLC0415

    out = {}
    for flag in (False, True):
        model = resnet.ResNet(**model_kw, device="cpu")
        bridge.load_jax_resnet(model, params, bn_state)
        opt = optim.SGD(momentum=0.9, weight_decay=1e-4, fused=True)
        st = state.TrainState.create(model, opt)
        train_step = step.make_train_step(opt, device_metrics=flag)
        counters.reset()
        fused_sgd.fused_sgd.launches = flash_attention.flash_fwd.launches = 0
        metrics = []
        for images, labels, lr in batches:
            n = images.shape[0] // world
            st, m = train_step(st, images[rank * n:(rank + 1) * n],
                               labels[rank * n:(rank + 1) * n], lr)
            metrics.append({k: v.item() for k, v in m.items()})
        out[flag] = {"metrics": metrics,
                     "counts": {k: v for k, v in counters.snapshot().items()
                                if k.startswith("comm.")},
                     "launches": {"fused_sgd": fused_sgd.fused_sgd.launches,
                                  "flash_attention_fwd": flash_attention.flash_fwd.launches}}
    return out


def history_fit_rank(rank, world, cfg_kw):
    """``Trainer.fit`` of ``cfg_kw`` on this rank (the narrow ResNet
    registered); returns the error it raised (its type name), this rank's
    counters and, where it has one, the records of its history file."""
    import json  # noqa: PLC0415

    from tpu_dist_torch.obs import counters  # noqa: PLC0415

    err = fit_run(cfg_kw)["error"]
    records = []
    path = cfg_kw.get("log_file")
    if path and os.path.exists(path):
        with open(path) as f:
            records = [json.loads(line) for line in f if line.strip()]
    return {"error": err, "counters": counters.snapshot(), "records": records}


def ledger_rank(rank, world, cfgs):
    """For each config, ``Trainer.fit`` on this rank (the narrow ResNet
    registered); returns, for each, the construction's static ledger, the
    first dispatch's ledger snapshot and the ``device.flops_per_step``
    gauge."""
    from tpu_dist_torch.config.config import TrainConfig  # noqa: PLC0415
    from tpu_dist_torch.obs import counters  # noqa: PLC0415
    from tpu_dist_torch.train import trainer  # noqa: PLC0415

    trainer.register_model("narrow_resnet", narrow_resnet)
    out = []
    for cfg_kw in cfgs:
        t = trainer.Trainer(TrainConfig(**cfg_kw))
        try:
            t.fit()
        finally:
            t.close()
        out.append({"static": t._mem_static, "record": t._mem_record,
                    "flops": counters.snapshot().get("device.flops_per_step")})
    return out


# -- sequence parallelism -------------------------------------------------------


def _seq_shard(a, rank, world, dtype=None):
    """This rank's contiguous chunk of a global [B, S, H, D] array along S."""
    s = a.shape[1] // world
    t = torch.from_numpy(np.ascontiguousarray(a[:, rank * s:(rank + 1) * s]))
    return t.to(getattr(torch, dtype)) if dtype else t


def seq_attention_rank(rank, world, cases, q, k, v, ct):
    """Each case ``(fn, causal, dtype)``: this rank's output of
    ``ring_attention``, ``ulysses_attention`` or ``ring_flash_attention``
    over a seq group of the whole world, on its chunk of the global
    [B, S, H, D] ``q, k, v``, and the gradients of ``sum(out * ct)`` by its
    chunks, all as f32 numpy, and the collective counts of the case."""
    from tpu_dist_torch.comm import mesh  # noqa: PLC0415
    from tpu_dist_torch.nn import attention  # noqa: PLC0415
    from tpu_dist_torch.obs import counters  # noqa: PLC0415
    from tpu_dist_torch.ops import flash_attention  # noqa: PLC0415

    seq = mesh.seq_mesh(world).seq
    fns = {"ring": attention.ring_attention, "ulysses": attention.ulysses_attention,
           "ring_flash": flash_attention.ring_flash_attention}
    out = []
    for fn, causal, dtype in cases:
        counters.reset()
        ts = [_seq_shard(a, rank, world, dtype).requires_grad_() for a in (q, k, v)]
        o = fns[fn](*ts, seq, causal=causal)
        grads = torch.autograd.grad((o.float() * _seq_shard(ct, rank, world)).sum(), ts)
        out.append({"out": o.detach().float().numpy(),
                    "grads": [g.float().numpy() for g in grads],
                    "counts": {k: v for k, v in counters.snapshot().items()
                               if k.startswith("comm.")}})
    return out


def seq_step_rank(rank, world, cases, model_kw, params, batches):
    """Each case ``(sp_mode, attn_impl, zero1)``: the port's DP x SP step on
    a ``[world/2, 2]`` mesh from the bridged ``params``, this data row's
    share of every global batch ``(images, labels, lr)``. Returns per case
    the losses, the final parameters in the JAX tree (numpy) and the
    collective counts."""
    from tpu_dist_torch import bridge  # noqa: PLC0415
    from tpu_dist_torch.comm import mesh  # noqa: PLC0415
    from tpu_dist_torch.nn import vit  # noqa: PLC0415
    from tpu_dist_torch.obs import counters  # noqa: PLC0415
    from tpu_dist_torch.train import optim, state, step  # noqa: PLC0415

    m = mesh.seq_mesh(2)
    out = []
    for sp_mode, impl, zero1 in cases:
        model = vit.ViT(**model_kw, attn_impl=impl, device="cpu")
        bridge.load_jax_vit(model, params)
        opt = optim.SGD()
        st = state.TrainState.create(model, opt)
        if zero1:
            st.layout = step.axis_layout(model, m.data)
            st.opt_state = step.init_sharded_opt_state(model, opt, layout=st.layout)
        # the data axis is ZeRO-1's alone: the replicated step reduces over every rank
        zero_kw = {"shard_weight_update": True, "axis": m.data} if zero1 else {}
        train_step = step.make_train_step(opt, sync_bn=False, seq_axis=m.seq, sp_mode=sp_mode,
                                          **zero_kw)
        counters.reset()
        losses = []
        for images, labels, lr in batches:
            n = images.shape[0] // m.data.size
            lo = m.data.index * n
            st, metrics = train_step(st, images[lo:lo + n], labels[lo:lo + n], lr)
            losses.append(metrics["loss"].item())
        out.append({"losses": losses, "params": bridge.vit_params_to_jax(model),
                    "counts": {k: v for k, v in counters.snapshot().items()
                               if k.startswith("comm.")}})
    return out


def seq_fit_rank(rank, world, cfgs, params, augment=False):
    """For each config, ``Trainer.fit`` on this rank from the bridged ViT
    ``params`` (None: the trainer's own seeded weights), the augmentation
    held to the numpy path without crops unless ``augment``; returns per
    config the epoch dicts, the first dispatch's step cost, the data
    extent, the (train, eval) batch a rank and the first train batch's
    images and labels, and the final state (flat, on every rank)."""
    from tpu_dist_torch import bridge  # noqa: PLC0415
    from tpu_dist_torch.config.config import TrainConfig  # noqa: PLC0415
    from tpu_dist_torch.data import native  # noqa: PLC0415
    from tpu_dist_torch.train import trainer  # noqa: PLC0415

    if not augment:
        unaugmented(native)
    out = []
    for cfg_kw in cfgs:
        t = trainer.Trainer(TrainConfig(**cfg_kw))
        it = iter(t.train_loader)
        first = tuple(x.numpy() for x in next(it))
        it.close()
        epochs, inner = [], t.train_epoch

        def train_epoch(epoch, *a, _inner=inner, _epochs=epochs, **k):
            _epochs.append(_inner(epoch, *a, **k))
            return _epochs[-1]

        t.train_epoch = train_epoch
        try:
            if params is not None:
                bridge.load_jax_vit(t.model, params)
            t.fit()
        finally:
            t.close()
        out.append({"epochs": epochs, "cost": t._step_cost, "n_data": t.n_data,
                    "batches": (t.local_batch, t.eval_batch), "first_batch": first,
                    "state": bridge.train_state_to_flat(t.state)})
    return out


def unaugmented(native_module):
    """Make ``native_module.gather_augment`` (of either package) gather and
    normalise without the random crop and flip, and on the numpy path: the
    JAX trainer keys a batch's crops by its loader's shard, the port's by
    the data index, so only inputs without them are the same on both."""
    import functools  # noqa: PLC0415

    inner = native_module.gather_augment
    native_module._load = lambda: None

    @functools.wraps(inner)
    def gather(images, sel, *, train=False, **kw):
        return inner(images, sel, train=False, **kw)

    native_module.gather_augment = gather


def trainer_errors_rank(rank, world, cfgs):
    """For each config, the ``Trainer``'s construction on this rank: the
    error it raised as ``"TypeName: message"``, or None."""
    from tpu_dist_torch.config.config import TrainConfig  # noqa: PLC0415
    from tpu_dist_torch.train import trainer  # noqa: PLC0415

    out = []
    for cfg_kw in cfgs:
        try:
            trainer.Trainer(TrainConfig(**cfg_kw)).close()
            out.append(None)
        except Exception as e:  # the refusal under test
            out.append(f"{type(e).__name__}: {e}")
    return out


# -- tensor and expert parallelism ----------------------------------------------


def _grads_to_jax(model):
    """The parameters' gradients at full width (a sharded model's gathered
    over its group) as the JAX tree, numpy."""
    from tpu_dist_torch import bridge  # noqa: PLC0415

    named = {n: p.grad for n, p in model.named_parameters()}
    full = bridge.gather_shards(model, named)
    return bridge.state_dict_to_jax(model, {n: t.float().numpy() for n, t in full.items()})[0]


def tp_ops_rank(rank, world, x, ct, ct_mlp, w1, b1, w2, b2):
    """The conjugate pair and the column/row-parallel dense over a model
    group of the whole world: for ``copy_to_tp`` and ``reduce_from_tp``
    this rank's forward of ``x[rank]`` and the gradient of ``<out,
    ct[rank]>``; for the MLP ``row(gelu(column(copy(x))))`` on the
    replicated ``x[0]`` (``w1`` ``[din, dh]`` and ``w2`` ``[dh, dout]`` in
    JAX's layout, sharded here) the output and the gradients of ``<y,
    ct_mlp>`` for ``x`` and this rank's shards. Returns numpy and the
    collective counts."""
    import torch.nn.functional as F  # noqa: PLC0415

    from tpu_dist_torch.comm import collectives, mesh  # noqa: PLC0415
    from tpu_dist_torch.obs import counters  # noqa: PLC0415
    from tpu_dist_torch.parallel import tensor  # noqa: PLC0415

    tp = mesh.tp_mesh(world)[mesh.MODEL_AXIS]
    counters.reset()
    out = {}
    for name, fn in (("copy", collectives.copy_to_tp), ("reduce", collectives.reduce_from_tp)):
        xi = torch.tensor(x[rank], requires_grad=True)
        y = fn(xi, group=tp.group)
        (g,) = torch.autograd.grad((y * torch.tensor(ct[rank])).sum(), xi)
        out[name] = (y.detach().numpy(), g.numpy())
    xr = torch.tensor(x[0], requires_grad=True)
    w1l = torch.tensor(tensor.shard_columns(np.ascontiguousarray(w1.T), world, rank),
                       requires_grad=True)
    b1l = torch.tensor(tensor.shard_columns(b1, world, rank), requires_grad=True)
    w2l = torch.tensor(tensor.shard_rows(np.ascontiguousarray(w2.T), world, rank),
                       requires_grad=True)
    b2t = torch.tensor(b2, requires_grad=True)
    h = F.gelu(tensor.column_parallel_dense(collectives.copy_to_tp(xr, group=tp.group), w1l,
                                            b1l), approximate="tanh")
    y = tensor.row_parallel_dense(h, w2l, tp, b2t)
    grads = torch.autograd.grad((y * torch.tensor(ct_mlp)).sum(), (xr, w1l, b1l, w2l, b2t))
    out["mlp"] = (y.detach().numpy(), [g.numpy() for g in grads])
    out["counts"] = {k: v for k, v in counters.snapshot().items() if k.startswith("comm.")}
    return out


def tp_forward_rank(rank, world, tps, model_kw, params, images, labels):
    """For each model-group size ``tp``, the TP ViT on a ``[world/tp, tp]``
    mesh from the bridged ``params``: the logits, the loss and the full
    gradients (JAX tree) of the cross-entropy on the whole batch."""
    from tpu_dist_torch import bridge  # noqa: PLC0415
    from tpu_dist_torch.comm import mesh  # noqa: PLC0415
    from tpu_dist_torch.nn import functional as F  # noqa: PLC0415
    from tpu_dist_torch.nn import vit  # noqa: PLC0415

    out = []
    for tp in tps:
        m = mesh.tp_mesh(tp)
        model = vit.ViT(**model_kw, device="cpu", tp=m[mesh.MODEL_AXIS])
        bridge.load_jax_vit(model, params)
        logits = model(torch.from_numpy(images))
        loss = F.cross_entropy(logits, torch.from_numpy(labels))
        loss.backward()
        out.append({"logits": logits.detach().numpy(), "loss": loss.item(),
                    "grads": _grads_to_jax(model),
                    "shapes": {n: tuple(p.shape) for n, p in model.named_parameters()}})
    return out


def tp_step_rank(rank, world, cases, model_kw, params, batches):
    """Each case ``(tp, sp, sp_mode[, step kwargs])``: the port's DP x TP (x
    SP) step on ``tpu_dist_torch.comm.mesh.tp_mesh(tp, sp)`` from the
    bridged ``params``, this data row's share of every global batch
    ``(images, labels, lr)``. Returns per case the losses, the final
    parameters (JAX tree, gathered), the collective counts, and the final
    state as a checkpoint writes it (``train_state_to_flat(dst=0)``: None
    off rank 0) beside the one every rank gathers."""
    from tpu_dist_torch import bridge  # noqa: PLC0415
    from tpu_dist_torch.comm import mesh  # noqa: PLC0415
    from tpu_dist_torch.nn import vit  # noqa: PLC0415
    from tpu_dist_torch.obs import counters  # noqa: PLC0415
    from tpu_dist_torch.train import optim, state, step  # noqa: PLC0415

    out = []
    for tp, sp, sp_mode, *extra in cases:
        m = mesh.tp_mesh(tp, sp)
        seq = m.axes.get(mesh.SEQ_AXIS)
        reps = m["data,seq" if sp > 1 else mesh.DATA_AXIS]
        model = vit.ViT(**model_kw, device="cpu", tp=m[mesh.MODEL_AXIS])
        bridge.load_jax_vit(model, params)
        opt = optim.SGD()
        st = state.TrainState.create(model, opt)
        kw = dict(seq_axis=seq, sp_mode=sp_mode) if sp > 1 else {}
        train_step = step.make_train_step(opt, sync_bn=False, tp_axis=m[mesh.MODEL_AXIS],
                                          axis=reps, **kw, **(extra[0] if extra else {}))
        counters.reset()
        losses = []
        n_data, d = m.sizes[0], m.coords[0]
        for images, labels, lr in batches:
            n = images.shape[0] // n_data
            st, metrics = train_step(st, images[d * n:(d + 1) * n], labels[d * n:(d + 1) * n], lr)
            losses.append(metrics["loss"].item())
        counts = {k: v for k, v in counters.snapshot().items() if k.startswith("comm.")}
        out.append({"losses": losses, "params": bridge.vit_params_to_jax(model),
                    "counts": counts, "saved": bridge.train_state_to_flat(st, dst=0),
                    "gathered": bridge.train_state_to_flat(st)})
    return out


def ep_step_rank(rank, world, cases, model_kw, params, batches):
    """Each case ``(ep, top_k, clip)``: the port's DP x EP step of the
    ViT-MoE on ``ep_mesh(ep)`` from the bridged ``params``; rank ``r`` takes
    rows ``[r·b, (r+1)·b)`` of every global batch (JAX's sharding over
    ``(data, expert)``). Returns per case the losses, the final parameters
    (JAX tree, gathered) and the collective counts."""
    from tpu_dist_torch import bridge  # noqa: PLC0415
    from tpu_dist_torch.comm import mesh  # noqa: PLC0415
    from tpu_dist_torch.nn import vit_moe  # noqa: PLC0415
    from tpu_dist_torch.obs import counters  # noqa: PLC0415
    from tpu_dist_torch.train import optim, state, step  # noqa: PLC0415

    out = []
    for ep, top_k, clip in cases:
        m = mesh.ep_mesh(ep)
        model = vit_moe.ViTMoE(**model_kw, top_k=top_k, device="cpu", ep=m[mesh.EXPERT_AXIS])
        bridge.load_jax_vit(model, params)
        opt = optim.SGD()
        st = state.TrainState.create(model, opt)
        train_step = step.make_train_step(opt, sync_bn=False, ep_axis=m[mesh.EXPERT_AXIS],
                                          axis=m[mesh.DATA_AXIS], grad_clip_norm=clip)
        counters.reset()
        losses = []
        for images, labels, lr in batches:
            n = images.shape[0] // world
            st, metrics = train_step(st, images[rank * n:(rank + 1) * n],
                                     labels[rank * n:(rank + 1) * n], lr)
            losses.append(metrics["loss"].item())
        out.append({"losses": losses, "params": bridge.vit_params_to_jax(model),
                    "counts": {k: v for k, v in counters.snapshot().items()
                               if k.startswith("comm.")}})
    return out


def moe_ep_rank(rank, world, cases, params, x, ct):
    """Each case ``top_k``: ``MoE.apply_ep`` over an expert group of the
    whole world on this rank's rows of ``x`` ([T, d], ``params`` the JAX
    MoE tree, full): the output, the auxiliary loss, and the gradients of
    ``<y, ct> + aux`` for the rank's tokens, the router and its slabs."""
    from tpu_dist_torch.comm import mesh  # noqa: PLC0415
    from tpu_dist_torch.parallel.expert import MoE  # noqa: PLC0415

    ep = mesh.ep_mesh(world)[mesh.EXPERT_AXIS]
    n_exp = params["w_in"].shape[0]
    e_loc, t_loc = n_exp // world, x.shape[0] // world
    out = []
    for k in cases:
        moe = MoE(n_exp, 1.25, k)
        xs = torch.tensor(x[rank * t_loc:(rank + 1) * t_loc], requires_grad=True)
        router = torch.tensor(np.ascontiguousarray(params["router"].T), requires_grad=True)
        w_in = torch.tensor(params["w_in"][rank * e_loc:(rank + 1) * e_loc], requires_grad=True)
        w_out = torch.tensor(params["w_out"][rank * e_loc:(rank + 1) * e_loc],
                             requires_grad=True)
        y, aux = moe.apply_ep(router, w_in, w_out, xs, ep, with_aux=True)
        obj = (y * torch.tensor(ct[rank * t_loc:(rank + 1) * t_loc])).sum() + aux
        grads = torch.autograd.grad(obj, (xs, router, w_in, w_out))
        out.append({"y": y.detach().numpy(), "aux": aux.item(),
                    "grads": [g.numpy() for g in grads]})
    return out


def mp_fit_rank(rank, world, cfgs, params, root=None):
    """For each config, ``Trainer.fit`` on this rank from the bridged
    ``params`` (None: the trainer's own weights; a list: one such a
    config), unaugmented; with
    ``root``, ``ckpt_dir`` is ``root/<cfg's ckpt_dir>``. Returns per config
    the epoch dicts, the data extent, the (train, eval) batch, the first
    parameter's shape, the static ledger's params section, the resume
    line's epoch and the first step's cost count."""
    from tpu_dist_torch import bridge  # noqa: PLC0415
    from tpu_dist_torch.config.config import TrainConfig  # noqa: PLC0415
    from tpu_dist_torch.data import native  # noqa: PLC0415
    from tpu_dist_torch.train import trainer  # noqa: PLC0415

    unaugmented(native)
    out = []
    for cfg_kw, weights in zip(cfgs, params if isinstance(params, list) else [params] * len(cfgs)):
        if root is not None and cfg_kw.get("ckpt_dir"):
            cfg_kw = dict(cfg_kw, ckpt_dir=os.path.join(root, cfg_kw["ckpt_dir"]))
        t = trainer.Trainer(TrainConfig(**cfg_kw))
        epochs, inner = [], t.train_epoch

        def train_epoch(epoch, *a, _inner=inner, _epochs=epochs, **k):
            _epochs.append(_inner(epoch, *a, **k))
            return _epochs[-1]

        t.train_epoch = train_epoch
        try:
            if weights is not None:
                bridge.load_jax_vit(t.model, weights)
            start = t.start_epoch
            t.fit()
            final = bridge.vit_params_to_jax(t.model)
        finally:
            t.close()
        out.append({"epochs": epochs, "n_data": t.n_data,
                    "batches": (t.local_batch, t.eval_batch), "start_epoch": start,
                    "ledger": t._mem_static["sections"]["params"], "final": final,
                    "local_numel": sum(p.numel() for p in t.model.parameters()),
                    "cost": t._step_cost})
    return out


# -- pipeline parallelism ------------------------------------------------------


def pp_toy_rank(rank, world, cases, ws, x, ct):
    """Each case ``v``: the toy stage ``tanh(h @ w)`` of the JAX package's
    pipeline tests through the schedule over a pipe group of the whole
    world, on the microbatches ``x`` ``[M, b, d]``: GPipe
    (``pipeline_apply``) at ``v == 1``, else the interleaved schedule, whose
    chunk ``k`` here is virtual stage ``k·world + rank`` (weights ``ws[k ·
    world + rank]``). Returns per case the output, the gradient of ``<out,
    ct>`` for this rank's weights ``[v, d, d]`` and the collective
    counts."""
    from tpu_dist_torch.comm import mesh  # noqa: PLC0415
    from tpu_dist_torch.obs import counters  # noqa: PLC0415
    from tpu_dist_torch.parallel import pipeline  # noqa: PLC0415

    pipe = mesh.pp_mesh(world)[mesh.PIPE_AXIS]
    out = []
    for v in cases:
        w = torch.tensor(np.stack([ws[k * world + rank] for k in range(v)]), requires_grad=True)
        counters.reset()
        if v == 1:
            y = pipeline.pipeline_apply(lambda h: torch.tanh(h @ w[0]), torch.tensor(x), pipe,
                                        params=(w,))
        else:
            y = pipeline.pipeline_apply_interleaved(lambda k, h: torch.tanh(h @ w[k]),
                                                    torch.tensor(x), pipe, v, params=(w,))
        (g,) = torch.autograd.grad((y * torch.tensor(ct)).sum(), w)
        out.append({"y": y.detach().numpy(), "g": g.numpy(),
                    "counts": {k: n for k, n in counters.snapshot().items()
                               if k.startswith("comm.")}})
    return out


def _pp_model(model_kw, pp, tp, v, device="cpu"):
    """The pipelined ViT of ``model_kw`` on ``comm/mesh.py::pp_mesh(pp,
    tp)`` with ``v`` chunks a stage: (mesh, model)."""
    from tpu_dist_torch.comm import mesh  # noqa: PLC0415
    from tpu_dist_torch.nn import vit_pp  # noqa: PLC0415

    m = mesh.pp_mesh(pp, tp)
    model = vit_pp.ViTPipeline(**model_kw, interleave=v, pp_stages=pp if v > 1 else 0,
                               device=device, pipe=m[mesh.PIPE_AXIS],
                               tp=m.axes.get(mesh.MODEL_AXIS),
                               stage=m.axes.get(f"{mesh.PIPE_AXIS},{mesh.MODEL_AXIS}"))
    return m, model


def pp_step_rank(rank, world, cases, model_kw, params, batches):
    """Each case ``(pp, tp, v, M, step kwargs)``: the port's DP x PP (x TP)
    step of the pipelined ViT on ``pp_mesh(pp, tp)`` with ``v`` chunks a
    stage and ``M`` microbatches (0: the stage count), from the bridged JAX
    ``params`` (in that layout's storage order), this data row's share of
    every global batch ``(images, labels, lr)``. Returns per case the
    losses, the final parameters (JAX tree, gathered), this rank's own
    replicated leaves and their last gradients, the collective counts, and
    the final state as a checkpoint writes it (``train_state_to_flat(dst=
    0)``: None off rank 0) beside the one every rank gathers."""
    from tpu_dist_torch import bridge  # noqa: PLC0415
    from tpu_dist_torch.comm import mesh  # noqa: PLC0415
    from tpu_dist_torch.obs import counters  # noqa: PLC0415
    from tpu_dist_torch.train import optim, state, step  # noqa: PLC0415

    out = []
    for pp, tp, v, M, kw in cases:
        m, model = _pp_model(model_kw, pp, tp, v)
        bridge.load_jax_vit(model, params)
        opt = optim.SGD()
        st = state.TrainState.create(model, opt)
        train_step = step.make_train_step(opt, sync_bn=False, pp_axis=m[mesh.PIPE_AXIS],
                                          tp_axis=m.axes.get(mesh.MODEL_AXIS),
                                          axis=m[mesh.DATA_AXIS],
                                          model_kwargs={"n_microbatches": M} if M else None,
                                          **kw)
        counters.reset()
        losses = []
        n_data, d = m.sizes[0], m.coords[0]
        for images, labels, lr in batches:
            n = images.shape[0] // n_data
            st, metrics = train_step(st, images[d * n:(d + 1) * n], labels[d * n:(d + 1) * n], lr)
            losses.append(metrics["loss"].item())
        counts = {k: v for k, v in counters.snapshot().items() if k.startswith("comm.")}
        shared = {n: (p.detach().numpy().copy(), st.opt_state[i].numpy().copy())
                  for i, (n, p) in enumerate(model.named_parameters())
                  if not n.startswith("blocks.")}
        out.append({"losses": losses, "params": bridge.vit_params_to_jax(model),
                    "shared": shared, "counts": counts,
                    "saved": bridge.train_state_to_flat(st, dst=0),
                    "gathered": bridge.train_state_to_flat(st)})
    return out


# -- the sharded checkpoint format and FSDP --------------------------------------

# tests/fsdp_jax.py's ViT of the TP layout
FSDP_TP_KW = dict(image_size=32, patch_size=4, dim=32, depth=2, heads=4, num_classes=5)


def layout_state(kind, seed=5, opt=None, min_size=1024):
    """This rank's fresh state of a layout of ``tests/fsdp_jax.py``: ``dp``,
    ``fsdp`` (over every rank), ``zero1`` (the flat momentum over every
    rank) or ``tp`` (the ViT at tp 2 over ``[world/2, 2]``); ``vit`` is that
    ViT whole."""
    import dataclasses  # noqa: PLC0415

    from tpu_dist_torch.comm import mesh  # noqa: PLC0415
    from tpu_dist_torch.nn import vit  # noqa: PLC0415
    from tpu_dist_torch.parallel import fsdp  # noqa: PLC0415
    from tpu_dist_torch.train import step as step_lib  # noqa: PLC0415
    from tpu_dist_torch.train.optim import SGD  # noqa: PLC0415
    from tpu_dist_torch.train.state import TrainState  # noqa: PLC0415

    opt = opt or SGD()
    if kind == "vit":
        return TrainState.create(vit.ViT(**FSDP_TP_KW, device="cpu", seed=seed), opt)
    if kind == "tp":
        tm = mesh.tp_mesh(2)
        model = vit.ViT(**FSDP_TP_KW, device="cpu", seed=seed, tp=tm["model"])
        return dataclasses.replace(TrainState.create(model, opt), replicas=tm["data"])
    model = narrow_resnet(10, "cpu", seed)
    st = TrainState.create(model, opt)
    if kind == "fsdp":
        return fsdp.shard_state(st, axis=mesh.data_axis(1), optimizer=opt, min_size=min_size)
    if kind == "zero1":
        lay = step_lib.flat_layout(model)
        return dataclasses.replace(
            st, opt_state=step_lib.init_sharded_opt_state(model, opt, layout=lay), layout=lay)
    return st


def _n_data(kind, world):
    return world // 2 if kind == "tp" else world


def sharded_cross_rank(rank, world, jax_mpaths, port_root, flats):
    """For each layout of ``jax_mpaths``: a fresh state of it restored from
    the JAX package's sharded save there (through the elastic remapper),
    as the flat dict (rank 0's is compared); and with ``port_root``, the
    state of ``flats[kind]`` (laid out for this world) saved sharded to
    ``port_root/<kind>``, stamped with its extent."""
    from tpu_dist_torch import bridge, ckpt  # noqa: PLC0415
    from tpu_dist_torch.elastic import remap as remap_lib  # noqa: PLC0415

    out = {}
    for kind, mpath in jax_mpaths.items():
        st = layout_state(kind)
        remap = remap_lib.make_remapper(bridge.jax_layout_template(st.params)[0],
                                        ckpt.read_sharded_meta(mpath), _n_data(kind, world))
        st = ckpt.restore_sharded(mpath, st, remap=remap)
        out[kind] = bridge.train_state_to_flat(st)
        if port_root is not None:
            st = bridge.load_train_state(layout_state(kind, seed=6), flats[kind])
            L = ckpt.params_len(bridge.jax_layout_template(st.params)[0])
            ckpt.save_sharded(os.path.join(port_root, kind), st, 0, extra_meta={
                "elastic": ckpt.elastic_stamp(_n_data(kind, world), world, L)})
    return out


def fsdp_step_rank(rank, world, cases, flats, batches):
    """For each case ``{model: "dp" | "vit" | "tp", opt, flat, kw,
    min_size, lr}``: the port's plain step and its FSDP step (over the data
    axis, and under ``tp`` the model axis too) from the state
    ``flats[flat]``, on this rank's data rows of each global batch of
    ``batches`` (``(images, labels, lr)``). Returns per case the two
    steps' losses and final states (flat dicts)."""
    from tpu_dist_torch import bridge  # noqa: PLC0415
    from tpu_dist_torch.comm import mesh  # noqa: PLC0415
    from tpu_dist_torch.parallel import fsdp  # noqa: PLC0415
    from tpu_dist_torch.train import optim  # noqa: PLC0415
    from tpu_dist_torch.train import step as step_lib  # noqa: PLC0415

    out = []
    for case in cases:
        opt = getattr(optim, case["opt"])()
        kw = case.get("kw", {})
        plain = bridge.load_train_state(layout_state(case["model"], opt=opt), flats[case["flat"]])
        base = layout_state(case["model"], opt=opt)
        axis = base.replicas if base.replicas is not None else mesh.data_axis(1)
        sharded = bridge.load_train_state(
            fsdp.shard_state(base, axis=axis, optimizer=opt, min_size=case.get("min_size", 1024)),
            flats[case["flat"]])
        tp = getattr(plain.params, "tp", None)
        plain_step = step_lib.make_train_step(
            opt, **kw, **({"tp_axis": tp, "axis": plain.replicas} if tp is not None else {}))
        fsdp_step = fsdp.make_fsdp_train_step(opt, **kw)
        n = len(batches[0][1]) // axis.size
        rows = slice(axis.index * n, (axis.index + 1) * n)
        losses = ([], [])
        for images, labels, lr in batches:
            lr = case.get("lr", lr)
            plain, m = plain_step(plain, images[rows], labels[rows], lr)
            losses[0].append(m["loss"].item())
            sharded, m = fsdp_step(sharded, images[rows], labels[rows], lr)
            losses[1].append(m["loss"].item())
        out.append((losses, bridge.train_state_to_flat(plain), bridge.train_state_to_flat(sharded)))
    return out


def fsdp_fit_rank(rank, world, cfgs):
    """For each config: ``Trainer.fit`` (:func:`fit_run`), then a
    ``Trainer(resume=True)`` of one more epoch built on the same directory
    (:func:`ladder_rank`); returns per config the fit's losses, error,
    final state (flat), ledger and cost, and the resumed start epoch and
    state."""
    out = []
    for cfg in cfgs:
        first = fit_run(cfg)
        start, _, state = ladder_rank(rank, world, {**cfg, "resume": True,
                                                    "epochs": cfg["epochs"] + 1})
        out.append({"losses": first["losses"], "error": first["error"],
                    "state": first["state"], "start": start, "resumed": state,
                    "ledger": first["ledger"], "cost": first["cost"]})
    return out


# -- ZeRO-1 under the seq axis --------------------------------------------------


def zero1_sp_state(opt_name, data, seed=5):
    """A fresh ``vit_tiny`` state with ZeRO-1's flat optimizer state of
    ``opt_name`` laid over the data axis ``data`` (an ``AxisGroup``)."""
    import dataclasses  # noqa: PLC0415

    from tpu_dist_torch.nn import vit  # noqa: PLC0415
    from tpu_dist_torch.train import optim  # noqa: PLC0415
    from tpu_dist_torch.train import step as step_lib  # noqa: PLC0415
    from tpu_dist_torch.train.state import TrainState  # noqa: PLC0415

    opt = getattr(optim, opt_name)()
    model = vit.vit_tiny(device="cpu", seed=seed)
    lay = step_lib.axis_layout(model, data)
    return dataclasses.replace(
        TrainState.create(model, opt), layout=lay,
        opt_state=step_lib.init_sharded_opt_state(model, opt, layout=lay))


def zero1_sp_ckpt_rank(rank, world, cases, root):
    """For each case ``{opt, flat, jax}`` on a ``[world/2, 2]`` data x seq
    mesh: the state of ``flat`` (ZeRO-1 over the data axis) flattened to
    rank 0 and to every rank; its plain, sync-sharded and async-sharded
    saves under ``root/<opt>``, each restored into a fresh state; and the
    JAX saves ``jax`` (``{"plain", "sharded"}``) restored through the
    elastic remapper. Returns per case the flat dicts (None off rank 0
    for the ones gathered to it), this rank's layout and its data group's
    members."""
    import torch.distributed as dist  # noqa: PLC0415

    from tpu_dist_torch import bridge, ckpt  # noqa: PLC0415
    from tpu_dist_torch.comm import mesh  # noqa: PLC0415
    from tpu_dist_torch.elastic import remap as remap_lib  # noqa: PLC0415

    mesh.seq_axis(2)
    data = mesh.data_axis(2)
    out = []
    for case in cases:
        st = bridge.load_train_state(zero1_sp_state(case["opt"], data), case["flat"])
        L = ckpt.params_len(bridge.jax_layout_template(st.params)[0])
        meta = {"elastic": ckpt.elastic_stamp(data.size, data.size, L)}
        d = os.path.join(root, case["opt"])
        res = {"dst0": bridge.train_state_to_flat(st, dst=0),
               "all": bridge.train_state_to_flat(st),
               "layout": (st.layout.world, st.layout.rank, st.layout.lo),
               "group": dist.get_process_group_ranks(st.layout.group)}
        paths = {"plain": ckpt.save(os.path.join(d, "plain"), st, 0, extra_meta=meta),
                 "sharded": ckpt.save_sharded(os.path.join(d, "sharded"), st, 0,
                                              extra_meta=meta)}
        w = ckpt.AsyncShardedCheckpointer()
        paths["async"] = w.save(os.path.join(d, "async"), st, 0, extra_meta=meta)
        assert w.close(timeout=60.0)
        # every rank reads the paths rank 0 published
        paths = {k: os.path.join(d, k, "ckpt_0.npz" if k == "plain" else "ckpt_0.manifest.json")
                 for k in paths}
        res["paths"] = paths
        for src, path in list(paths.items()) + [("jax_" + k, p) for k, p in case["jax"].items()]:
            fresh = zero1_sp_state(case["opt"], data, seed=9)
            if path.endswith(".manifest.json"):
                remap = remap_lib.make_remapper(bridge.jax_layout_template(fresh.params)[0],
                                                ckpt.read_sharded_meta(path), data.size)
                fresh = ckpt.restore_sharded(path, fresh, remap=remap)
            else:
                remap = remap_lib.make_remapper(bridge.jax_layout_template(fresh.params)[0],
                                                ckpt.read_meta(path), data.size)
                fresh = bridge.load_train_state(fresh, ckpt.restore(
                    path, verify=True, template=bridge.restore_template(fresh), remap=remap))
            res[src] = bridge.train_state_to_flat(fresh, dst=0)
        out.append(res)
    return out


# -- the replica check ------------------------------------------------------------


def replica_check_rank(rank, world, delta):
    """``metrics/consistency.py::check_replicated`` on 4 ranks: ``vit_tiny``
    equal everywhere; its ``head.weight[0, 0]`` moved by ``delta`` on rank
    1; a narrow ResNet's BN statistics (``check_state``) with one running
    variance moved on rank 3; a TP ViT at tp 2 (``[data 2, model 2]``)
    checked over its replicas, over the world, and with a shard moved on
    rank 3. Returns each check's ``AssertionError`` message, or None."""
    import torch  # noqa: PLC0415

    from tpu_dist_torch.comm import mesh  # noqa: PLC0415
    from tpu_dist_torch.metrics import consistency  # noqa: PLC0415
    from tpu_dist_torch.nn import vit  # noqa: PLC0415
    from tpu_dist_torch.train.state import TrainState  # noqa: PLC0415
    from tpu_dist_torch.train.optim import SGD  # noqa: PLC0415

    def outcome(fn):
        try:
            fn()
        except AssertionError as e:
            return str(e)
        return None

    out = {}
    model = vit.vit_tiny(device="cpu", seed=0)
    out["equal"] = outcome(lambda: consistency.check_replicated(model, "params"))
    if rank == 1:
        with torch.no_grad():
            model.head.weight[0, 0] += delta
    out["perturbed"] = outcome(lambda: consistency.check_replicated(model, "params"))
    out["within_atol"] = outcome(lambda: consistency.check_replicated(
        model, "params", atol=2 * delta))
    st = TrainState.create(narrow_resnet(10, "cpu", 0), SGD())
    if rank == 3:
        next(v for k, v in st.bn_state.items() if k.endswith("running_var")).add_(0.5)
    out["bn"] = outcome(lambda: consistency.check_state(st))
    tm = mesh.tp_mesh(2)
    tp_model = vit.ViT(image_size=32, patch_size=4, dim=32, depth=1, heads=4, num_classes=5,
                       device="cpu", seed=0, tp=tm["model"])
    group = tm["data"].group
    out["tp_replicas"] = outcome(lambda: consistency.check_replicated(tp_model, "params",
                                                                      group=group))
    out["tp_world"] = outcome(lambda: consistency.check_replicated(tp_model, "params"))
    if rank == 3:
        with torch.no_grad():
            next(tp_model.parameters()).view(-1)[0] += delta
    out["tp_perturbed"] = outcome(lambda: consistency.check_replicated(tp_model, "params",
                                                                       group=group))
    return out


# -- the analysis layer ---------------------------------------------------------


def shard_audit_rank(rank, world, params, families):
    """The analysis layer over this group: for each data-parallel family of
    ``families``, its step from the JAX proxy's weights ``params`` run once,
    traced (its executed inventory by kind, the executed wire buckets, the
    predicted inventory by kind, the count of collective calls and the
    dtypes of its all-reduces); then the whole shard report, its
    violations, and the violations of the injected ZeRO-1 probe."""
    from tpu_dist_torch.analysis import shardlint, step_audit  # noqa: PLC0415
    from tpu_dist_torch.train.step import family_step_kwargs  # noqa: PLC0415

    dp = {}
    for fam in families:
        step, args = step_audit._dp_setup("cpu", params=params, **family_step_kwargs(fam))
        _, trace = step_audit.traced(step, *args)
        dp[fam] = {"executed": shardlint.hlo_totals(trace.ops)["by_kind"],
                   "wire": shardlint.hlo_wire_buckets(trace.ops),
                   "predicted": trace.predicted()["by_kind"], "calls": len(trace.calls),
                   "reduce_dtypes": sorted({op.dtype for op in trace.ops
                                            if op.kind == "all-reduce"})}
    report, vs = shardlint.build_shard_report("cpu")
    _, inj = shardlint.shard_case("zero1_sgd", "cpu",
                                  step_override=shardlint.injected_bad_zero1("cpu"))
    return dp, report, [v.to_json() for v in vs], [v.to_json() for v in inj]


def tune_rank(rank, world):
    """The overlap tuner over this group: its report and violations, and
    the TD121 violations of the payload-perturbed copy."""
    from tpu_dist_torch.analysis import overlap  # noqa: PLC0415

    report, vs = overlap.tune("cpu")
    return report, [v.to_json() for v in vs], [
        v.to_json() for v in overlap.recheck_report(overlap.inject_payload(report))]


def auto_shard_rank(rank, world, cfg_kw, tune_path):
    """The trainer's analysis flags on this group, each a ``fit_run``:
    ``--auto_shard apply``, then the chosen family's flags set by hand;
    ``--auto_shard plan``; ``--tune_report`` (a ZeRO-1 run, and the same
    with ``rs_ag_chunks`` set by the user). Returns the runs."""
    from tpu_dist_torch.analysis import planner  # noqa: PLC0415

    out = {"apply": fit_run({**cfg_kw, "auto_shard": "apply"})}
    family = out["apply"]["plan"]["family"]
    out["by_hand"] = fit_run({**cfg_kw, **planner.family_train_overrides(family)})
    out["plan"] = fit_run({**cfg_kw, "auto_shard": "plan"})
    zero1 = {**cfg_kw, "shard_weight_update": True, "tune_report": tune_path, "log_file": None}
    out["tuned"] = fit_run(zero1)
    out["user_knob"] = fit_run({**zero1, "rs_ag_chunks": 4})
    return out


def plan_rank(rank, world, gauges):
    """The shard report of every family over this group, the plan priced
    from it (``gauges``, no memory budget), the plan's TD118 probe and
    violations, and the violations of its ``inject_miscost`` copy."""
    from tpu_dist_torch.analysis import planner, shardlint  # noqa: PLC0415

    report, _ = shardlint.build_shard_report("cpu")
    plan = planner.build_plan(device="cpu", shard_report=report, gauges=gauges,
                              hbm_budget_bytes=10**12)
    probe, vs = planner.verify_plan(plan, "cpu")
    _, inj = planner.verify_plan(planner.inject_miscost(plan), "cpu")
    return report, plan, probe, [v.to_json() for v in vs], [v.to_json() for v in inj]


def audit_rank(rank, world):
    """Every audit case of ``analysis/step_audit.py`` over this group: the
    report and violations of ``audit_all`` (cases only), each case's
    budget, and three planted faults: ``dp_sgd`` under a budget one psum
    too high (TD101), ``dp_sgd`` reading its loss with ``.item()`` inside
    the call (TD102), and ``dp_int8``'s report with its all-gather leg
    decompressed to f32 (TD104)."""
    from tpu_dist_torch.analysis import noop_probes, step_audit  # noqa: PLC0415

    names = step_audit.registered_cases()
    report, vs = noop_probes.audit_all("cpu", names=names)
    budgets = {}
    for name in names:
        budget = step_audit.case_budget(name, "cpu")[2]
        budgets[name] = (budget.collectives, budget.transfers, budget.bf16_to_f32)

    fn, args, budget = step_audit.case_budget("dp_sgd", "cpu")
    budget.collectives["psum"] += 1
    _, trace = step_audit.traced(fn, *args)
    mutated = step_audit._compare("dp_sgd", step_audit._counts(trace), budget)

    fn, args, budget = step_audit.case_budget("dp_sgd", "cpu")

    def item_step(*a):
        out = fn(*a)
        out[1]["loss"].item()  # a planted host read inside the step
        return out

    _, trace = step_audit.traced(item_step, *args)
    item = step_audit._compare("dp_sgd", step_audit._counts(trace), budget)

    fn, args, _ = step_audit.case_budget("dp_int8", "cpu")
    _, trace = step_audit.traced(fn, *args)
    for call in trace.calls:
        if call["kind"] == "all-gather":
            call["tensors"] = [(torch.float32, n) for _, n in call["tensors"]]
    decompressed = {**report, "dp_int8": {**report["dp_int8"],
                                          "wire": step_audit.wire_buckets(trace.call_records())}}
    leg = step_audit.wire_ratio_violations(decompressed)
    return (report, [v.to_json() for v in vs], budgets,
            [[v.to_json() for v in x] for x in (mutated, item, leg)])


def elastic_probe_rank(rank, world):
    """TD111's and TD112's machinery over this group: ``(layouts_differ,
    remapper_fired, identical)`` of the shrink and the grow, and the two
    probes' violations."""
    from tpu_dist_torch.analysis import noop_probes  # noqa: PLC0415

    return (noop_probes._elastic_noop_probe("cpu", grow=False),
            noop_probes._elastic_noop_probe("cpu", grow=True),
            [v.to_json() for v in noop_probes.elastic_resume_noop_violations("cpu")
             + noop_probes.elastic_grow_noop_violations("cpu")])
