"""The trainer: the port's counterpart of the main path of
``tpu_dist/train/trainer.py`` (``build_model``, ``register_model``,
``Trainer``, ``TrainingDivergedError``).

One process per device, as the reference's ``torch.distributed`` scripts
run: each rank joins the process group (NCCL on CUDA, gloo on the CPU),
takes ``batch_size // world`` examples of every global batch through the
epoch-seeded :class:`~tpu_dist_torch.data.sampler.DistributedSampler`, and
runs :func:`~tpu_dist_torch.train.step.make_train_step` (the gradient
all-reduce once per step, SyncBN unless ``--no_sync_bn``). Parameters and
buffers are broadcast from rank 0 once at construction (DDP's init
broadcast; the model is never wrapped in ``DistributedDataParallel``).
SGD with momentum and weight decay, plain or through the fused CUDA
kernel; MultiStepLR or cosine, with warmup and the linear scaling rule;
``train_epoch`` with ``steps_per_epoch``, ``log_every`` and the NaN guard;
``fit`` with a distributed ``validate`` every ``eval_every`` epochs. Only
rank 0 prints. The per-epoch dict has the JAX trainer's keys.

Every config flag whose subsystem is not ported raises
:class:`~tpu_dist_torch.train.step.NotPortedError` naming its ROADMAP item
(:data:`UNPORTED`); none is ignored.
"""

from __future__ import annotations

import functools
import math
import time
from typing import Optional

import torch

from tpu_dist_torch.comm import collectives, mesh
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.data import cifar, synthetic, transforms
from tpu_dist_torch.data.loader import DataLoader
from tpu_dist_torch.data.sampler import DistributedSampler
from tpu_dist_torch.evaluation.validate import validate
from tpu_dist_torch.metrics.logging import rank0_print
from tpu_dist_torch.metrics.meters import AverageMeter
from tpu_dist_torch.nn import resnet, vit
from tpu_dist_torch.obs import counters
from tpu_dist_torch.train.optim import SGD, cosine_lr, linear_scaled_lr, multistep_lr
from tpu_dist_torch.train.state import TrainState
from tpu_dist_torch.train.step import WAITS_FOR, NotPortedError, make_eval_step, make_train_step

_MODELS = {
    "resnet18": resnet.resnet18, "resnet34": resnet.resnet34, "resnet50": resnet.resnet50,
    "resnet50_imagenet": resnet.resnet50_imagenet,
    "vit_b16": vit.vit_b16, "vit_s16": vit.vit_s16, "vit_tiny": vit.vit_tiny,
}

_CKPT = "Queue A 2a (checkpoint/resume, ckpt/checkpoint.py)"
_HISTORY = "Queue A 2c (the JSONL history, metrics/history.py)"
_TELEMETRY = "Queue A 6 (telemetry: obs/*)"
_PARALLEL = "Queue A 6 (model parallelism, parallel/*)"
_ANALYSIS = "Queue A 6 (the analysis layer)"

# flag -> (its default, the ROADMAP item its subsystem waits for)
UNPORTED = {
    "optimizer": ("sgd", "Queue A 6 (AdamW, LARS, LAMB)"),
    "fused_epoch": (False, "Queue A 6 (the fused epoch, train/epoch.py)"),
    "shard_weight_update": (False, WAITS_FOR["shard_weight_update"]),
    "fsdp": (False, "Queue A 6 (parallel/fsdp.py)"),
    "remat": (False, WAITS_FOR["remat"]),
    "grad_compression": ("none", WAITS_FOR["grad_compression"]),
    "quant_chunk": (0, WAITS_FOR["grad_compression"]),
    "rs_ag_chunks": (1, WAITS_FOR["rs_ag_chunks"]),
    "device_metrics": (False, WAITS_FOR["device_metrics"]),
    "sp": (1, WAITS_FOR["seq_axis"]),
    "sp_mode": ("ring", WAITS_FOR["seq_axis"]),
    "tp": (1, _PARALLEL),
    "ep": (1, _PARALLEL),
    "pp": (1, _PARALLEL),
    "pp_microbatches": (0, _PARALLEL),
    "pp_interleave": (1, _PARALLEL),
    "moe_top_k": (1, _PARALLEL),
    "ckpt_dir": (None, _CKPT),
    "resume": (False, _CKPT),
    "keep_last_ckpts": (None, _CKPT),
    "mid_epoch_save_every": (0, _CKPT),
    "async_ckpt": (False, _CKPT),
    "auto_recover": (0, _CKPT),
    "sharded_ckpt": (False, "Queue A 6 (the sharded checkpoint format)"),
    "log_file": (None, _HISTORY),
    "per_host_log": (False, _HISTORY),
    "tensorboard_dir": (None, _TELEMETRY),
    "trace_file": (None, _TELEMETRY),
    "heartbeat_file": (None, _TELEMETRY),
    "straggler_threshold": (0.0, _TELEMETRY),
    "anomaly_action": ("off", _TELEMETRY),
    "metrics_file": (None, _TELEMETRY),
    "metrics_port": (0, _TELEMETRY),
    "alert_rules": (None, _TELEMETRY),
    "crash_dir": (None, _TELEMETRY),
    "memory_check": ("off", _TELEMETRY),
    "hbm_budget_bytes": (None, _TELEMETRY),
    "profile_dir": (None, _TELEMETRY),
    "profile_trigger": ("off", _TELEMETRY),
    "profile_steps": (None, _TELEMETRY),
    "debug_replica_check": (False, _TELEMETRY),
    "fault_plan": (None, "Queue A 6 (resilience, resilience/faults.py)"),
    "auto_shard": ("off", _ANALYSIS),
    "tune_report": ("", _ANALYSIS),
    "compile_cache_dir": (None, "Queue A 6 (the fused epoch's CUDA-graph capture; "
                                "the port compiles no XLA program to cache)"),
}

_DATASET_CLASSES = {"cifar100": 100, "cifar10": 10, "synthetic_learnable": 4,
                    "synthetic_multifactor": 16}


class TrainingDivergedError(RuntimeError):
    """Raised by the NaN guard on a non-finite loss."""


def register_model(name: str, factory) -> None:
    """Extend the model zoo: ``factory(num_classes=, device=, seed=)``
    returns an ``nn.Module`` taking NHWC images (and ``group=`` if it has
    BatchNorm)."""
    _MODELS[name] = factory


def build_model(cfg: TrainConfig, device, seed: int = 0) -> torch.nn.Module:
    if cfg.model not in _MODELS:
        raise ValueError(f"unknown model {cfg.model!r}; have {sorted(_MODELS)}")
    model = _MODELS[cfg.model](num_classes=cfg.num_classes, device=device, seed=seed)
    if hasattr(model, "attn_impl"):
        model.attn_impl = "flash" if cfg.flash_attention else "xla"
    return model


def refuse_unported(cfg: TrainConfig) -> None:
    """Raise :class:`NotPortedError` for the first flag of :data:`UNPORTED`
    that is not at its default."""
    for flag, (default, queue) in UNPORTED.items():
        value = getattr(cfg, flag)
        if value != default:
            raise NotPortedError(flag, value, queue)


def _load_data(cfg: TrainConfig, world: int):
    if cfg.dataset == "synthetic":
        return (synthetic.synthetic_cifar(cfg.synthetic_n, cfg.num_classes, seed=1),
                synthetic.synthetic_cifar(max(cfg.synthetic_n // 5, world),
                                          cfg.num_classes, seed=2))
    if cfg.dataset == "synthetic_learnable":
        return (synthetic.synthetic_quadrant(cfg.synthetic_n, seed=1),
                synthetic.synthetic_quadrant(max(cfg.synthetic_n // 5, world), seed=2))
    if cfg.dataset == "synthetic_multifactor":
        return (synthetic.synthetic_multifactor(cfg.synthetic_n, seed=1),
                synthetic.synthetic_multifactor(max(cfg.synthetic_n // 5, world), seed=2,
                                                label_noise=0.0))
    if cfg.dataset in ("cifar100", "cifar10"):
        load = cifar.load_cifar100 if cfg.dataset == "cifar100" else cifar.load_cifar10
        return load(cfg.data_dir, train=True), load(cfg.data_dir, train=False)
    raise ValueError(f"unknown dataset {cfg.dataset!r}")


class _StepTimer:
    """Host laps between post-warmup steps (no device sync), for the step
    time percentiles of the epoch summary (``tpu_dist/obs/profile.py``)."""

    def __init__(self, warmup_steps: int = 1):
        self.warmup_steps, self._seen, self._last, self.laps = warmup_steps, 0, None, []

    def tick(self) -> None:
        now = time.perf_counter()
        self._seen += 1
        if self._seen > self.warmup_steps and self._last is not None:
            self.laps.append(now - self._last)
        if self._seen >= self.warmup_steps:
            self._last = now

    def percentiles(self, qs=(50, 95, 99)) -> Optional[dict]:
        if not self.laps:
            return None
        laps, n = sorted(self.laps), len(self.laps)
        return {f"p{q}": laps[min(n - 1, max(0, int(round(q / 100.0 * n)) - 1))] for q in qs}


class Trainer:
    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        refuse_unported(cfg)
        # a run is one Trainer's lifetime: its counters start at 0
        counters.reset()
        self.device, self._owns_group = mesh.initialize_distributed(
            cfg.device, world_size=cfg.num_processes, rank=cfg.process_id,
            master_addr=cfg.ip, master_port=cfg.port)
        try:
            self._init(cfg)
        except BaseException:
            self.close()
            raise

    def _init(self, cfg: TrainConfig) -> None:
        world, rank = mesh.process_count(), mesh.process_index()
        self.n_devices = world
        seed = cfg.seed if cfg.seed is not None else 0
        self.model = build_model(cfg, self.device, seed)

        # -- data -----------------------------------------------------------
        self.train_data, self.test_data = _load_data(cfg, world)
        expected = _DATASET_CLASSES.get(cfg.dataset)
        if expected is not None and cfg.num_classes != expected:
            raise ValueError(
                f"dataset {cfg.dataset!r} has {expected} classes but "
                f"num_classes={cfg.num_classes}; pass --num_classes {expected}"
            )
        if cfg.batch_size % world:
            raise ValueError(f"batch_size {cfg.batch_size} must divide over {world} ranks")
        # the reference's per-worker batch = global / nprocs (distributed.py:67)
        self.local_batch = cfg.batch_size // world
        if self.local_batch % cfg.grad_accu_steps:
            raise ValueError(
                f"per-rank batch {self.local_batch} must divide by grad_accu_steps="
                f"{cfg.grad_accu_steps}"
            )
        self.train_sampler = DistributedSampler(
            len(self.train_data[0]), world, rank, shuffle=True, seed=seed,
            drop_last=cfg.drop_last or cfg.grad_accu_steps > 1,
        )
        self.test_sampler = DistributedSampler(
            len(self.test_data[0]), world, rank, shuffle=False, seed=seed)
        if cfg.dataset == "cifar10":
            stats = dict(mean=transforms.CIFAR10_MEAN, std=transforms.CIFAR10_STD)
        else:
            stats = dict(mean=transforms.CIFAR100_MEAN, std=transforms.CIFAR100_STD)
        self.train_loader = DataLoader(
            *self.train_data, self.local_batch, self.train_sampler, device=self.device,
            gather_transform=functools.partial(transforms.gather_augment, train=True, **stats),
            seed=seed, prefetch=cfg.num_workers,
        )
        self.test_loader = DataLoader(
            *self.test_data, self.local_batch, self.test_sampler, device=self.device,
            gather_transform=functools.partial(transforms.gather_augment, train=False, **stats),
            seed=seed, prefetch=cfg.num_workers, with_mask=True,
        )

        # -- model / optimizer state ----------------------------------------
        self.optimizer = SGD(momentum=cfg.momentum, weight_decay=cfg.weight_decay,
                             fused=cfg.fused_optimizer)
        # DDP's init-time broadcast: every rank starts from rank 0's weights
        collectives.broadcast_module(self.model)
        self.state = TrainState.create(self.model, self.optimizer)
        base_lr = cfg.lr
        if cfg.lr_base_batch > 0:
            base_lr = linear_scaled_lr(cfg.lr, cfg.lr_base_batch, cfg.batch_size)
            rank0_print(f"=> linear LR scaling: {cfg.lr} x {cfg.batch_size}/"
                        f"{cfg.lr_base_batch} = {base_lr:g}")
        if cfg.lr_schedule == "cosine":
            self.lr_schedule = cosine_lr(base_lr, cfg.epochs, cfg.warmup_epochs)
        else:
            self.lr_schedule = multistep_lr(base_lr, cfg.lr_milestones, cfg.lr_gamma,
                                            warmup_epochs=cfg.warmup_epochs)
        compute_dtype = torch.bfloat16 if cfg.bf16 else torch.float32
        self.train_step = make_train_step(
            self.optimizer, grad_accum_steps=cfg.grad_accu_steps, sync_bn=cfg.sync_bn,
            compute_dtype=compute_dtype, label_smoothing=cfg.label_smoothing,
            grad_clip_norm=cfg.grad_clip_norm, pmean_fusion=cfg.pmean_fusion,
        )
        self.eval_step = make_eval_step(compute_dtype=compute_dtype)

    def close(self) -> None:
        """Leave the process group if this trainer created it."""
        if self._owns_group and collectives.active():
            torch.distributed.destroy_process_group()
        self._owns_group = False

    def _guard(self, loss: float, where: str, lr: float) -> None:
        if self.cfg.nan_guard and not math.isfinite(loss):
            raise TrainingDivergedError(f"non-finite loss {loss} {where} (lr={lr})")

    def train_epoch(self, epoch: int) -> dict:
        cfg = self.cfg
        self.train_sampler.set_epoch(epoch)
        lr = self.lr_schedule(epoch)
        lr_t = torch.full((), lr, dtype=torch.float32, device=self.device)
        losses = AverageMeter("Loss", ":.4e")  # epoch average of the logged steps
        images_seen, steps_run, metrics = 0, 0, {}
        nb = len(self.train_loader)
        timer = _StepTimer(warmup_steps=1)
        phase = {"data": 0.0, "dispatch": 0.0, "fetch": 0.0}
        t0 = time.time()
        it = iter(self.train_loader)
        for step in range(nb):
            if cfg.steps_per_epoch is not None and step >= cfg.steps_per_epoch:
                break
            t_w = time.perf_counter()
            try:
                images, labels = next(it)
            except StopIteration:
                break
            t_d = time.perf_counter()
            phase["data"] += t_d - t_w
            self.state, metrics = self.train_step(self.state, images, labels, lr_t)
            phase["dispatch"] += time.perf_counter() - t_d
            images_seen += cfg.batch_size
            steps_run += 1
            timer.tick()
            if step % cfg.log_every == 0:
                t_f = time.perf_counter()
                m = {k: v.item() for k, v in metrics.items()}
                phase["fetch"] += time.perf_counter() - t_f
                self._guard(m["loss"], f"at epoch {epoch} step {step}", lr)
                losses.update(m["loss"], cfg.batch_size)
                rank0_print(f"Epoch:[{epoch}/{cfg.epochs}] step:[{step}/{nb}] "
                            f"lr={lr:.5f} loss={m['loss']:.4f} "
                            f"acc1={m['acc1']:.2f} acc5={m['acc5']:.2f}")
        it.close()  # stop the prefetch thread of an epoch cut short
        out = {k: v.item() for k, v in metrics.items()}
        if out:
            self._guard(out["loss"], f"at end of epoch {epoch}", lr)
        dt = time.time() - t0
        ips = images_seen / dt if dt > 0 else 0.0
        rank0_print(f"Epoch {epoch} done in {dt:.2f}s ({ips:.0f} img/s, avg loss {losses.avg:.4f})")
        stall = phase["data"] / dt if dt > 0 else 0.0
        out.update(epoch_time=dt, images_per_sec=ips, steps=steps_run,
                   data_wait_s=round(phase["data"], 4), dispatch_s=round(phase["dispatch"], 4),
                   host_fetch_s=round(phase["fetch"], 4), data_stall_frac=round(stall, 4))
        pct = timer.percentiles()
        if pct:
            out.update(step_time_p50=round(pct["p50"], 6), step_time_p95=round(pct["p95"], 6),
                       step_time_p99=round(pct["p99"], 6))
            rank0_print(f"  step p50/p95/p99 {pct['p50'] * 1e3:.1f}/{pct['p95'] * 1e3:.1f}/"
                        f"{pct['p99'] * 1e3:.1f} ms, data stall {stall:.1%}")
        counters.inc("train.epochs")
        counters.inc("train.steps", steps_run)
        return out

    def fit(self, epochs: Optional[int] = None) -> dict:
        """Train ``epochs`` (default ``cfg.epochs``) epochs, validating every
        ``eval_every``; returns the last epoch's dict."""
        cfg, last = self.cfg, {}
        for epoch in range(epochs if epochs is not None else cfg.epochs):
            last = self.train_epoch(epoch)
            if cfg.eval_every and (epoch + 1) % cfg.eval_every == 0:
                t1, t5, vloss = validate(self.test_loader, self.state, self.eval_step,
                                         epoch=epoch)
                last.update(val_top1=t1, val_top5=t5, val_loss=vloss)
        return last
