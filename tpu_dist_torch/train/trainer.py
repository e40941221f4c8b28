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
kernel, or AdamW, LARS or LAMB (:func:`make_optimizer`, the JAX trainer's
dispatch and refusals); ``remat`` recomputes the forward in the backward;
``shard_weight_update`` (ZeRO-1, with ``rs_ag_chunks``) keeps this rank's
shard of a flat optimizer state, and ``grad_compression`` (``bf16``,
``int8``, ``int8_ef`` with ``quant_chunk``) puts the gradient reduce on a
compressed wire, ``int8_ef`` with its residuals in the state;
MultiStepLR or cosine, with warmup and the linear scaling rule;
``train_epoch`` with ``steps_per_epoch``, ``log_every`` and the NaN guard;
``fit`` with a distributed ``validate`` every ``eval_every`` epochs. The
loaders augment through the native C++ pipeline
(:mod:`tpu_dist_torch.data.native`), as the JAX trainer's do, and
``input_pipeline`` says which one feeds the run (native, or numpy with
the reason). Only rank 0 prints. The per-epoch dict has the JAX trainer's
keys.

Checkpoint / resume, preemption and the history are the JAX trainer's:

* ``ckpt_dir`` takes a plain-format checkpoint (:mod:`tpu_dist_torch.ckpt`,
  the JAX file format) every ``save_every`` epochs (and every epoch while
  ``mid_epoch_save_every`` is on), an exact mid-epoch snapshot every
  ``mid_epoch_save_every`` steps, and ``ckpt_best.npz`` on a better eval
  top-1; ``async_ckpt`` writes them on a worker thread after a
  synchronous device-to-host snapshot; ``keep_last_ckpts`` prunes.
* ``resume`` walks the checkpoints newest first (the restore ladder): a
  corrupt or unreadable file is quarantined to ``*.corrupt`` and the next
  older one is tried; a checkpoint of another configuration raises. The
  arrays are copied into the live parameters, BN buffers and momentum
  buffers (their storage, and so the fused SGD's cached launch plan,
  stays valid), and a mid-epoch snapshot re-enters its epoch at its step.
  Every rank checks that all picked the same checkpoint. The restore is
  elastic (``tpu_dist/train/trainer.py:2442-2581``): it lays the
  checkpoint onto this run's world through
  :func:`~tpu_dist_torch.elastic.remap.make_remapper` (ZeRO-1's flat
  state and the int8_ef residuals of another extent are re-laid, counted
  in ``resume.resharded``; a resume onto a larger world counts
  ``elastic.grows``), and a mid-epoch snapshot of another process count,
  or one that entered its epoch at an offset, re-enters through the
  consumed-example offset (``DistributedSampler.set_offset``): the rest
  of the epoch is re-partitioned over this world, nothing dropped or seen
  twice, as the batches the snapshot's world would have made
  (``DataLoader.replay_world``; the JAX loader re-keys their crops). The
  offset epoch keeps the whole epoch's step numbers, so
  ``steps_per_epoch`` caps the epoch, not the rest of it (the JAX trainer
  counts the rest from 0). ``fit`` logs the ``resume`` record
  (``resharded``, ``prev_dp``, ``prev_procs``, ``examples_offset``) and
  sets the ``elastic.world_size`` and ``elastic.restarts`` gauges
  (``$TPU_DIST_ELASTIC_RESTARTS``). AdamW stamps its
  ``adamw_decay_mask`` in every checkpoint; a resume under another mask
  raises, and one from a checkpoint without the stamp warns.
* SIGTERM (:mod:`tpu_dist_torch.resilience.preemption`) and Ctrl-C stop at
  a step boundary that every rank agrees on (the flag rides the step's
  metrics all-reduce), write the emergency snapshot and raise;
  ``cli/train.py`` exits 75 on SIGTERM.
* ``auto_recover`` reloads the newest checkpoint after a non-finite loss
  and scales the learning rate by ``recover_lr_factor``.
* ``log_file`` writes the JSONL history
  (:mod:`tpu_dist_torch.metrics.history`): ``train_epoch``, ``eval`` and
  ``auto_recover`` records, rank 0 only unless ``per_host_log``.
* ``crash_dir`` arms the crash forensics of every rank for ``fit``
  (:mod:`tpu_dist_torch.obs.flight`): a flight ring at
  ``per_rank_path(crash_dir/flight.ring, rank)`` with an ``open`` record,
  a ``resume`` record after a restore, a ``step`` record at every step
  boundary (once an epoch on the fused path), ``auto_recover`` records, a
  slot for every host span opened, a ``fatal`` slot from an unhandled
  exception, and the terminal record: ``exit`` (``clean`` or not),
  ``preempt``, ``interrupt``, or ``fatal`` then ``exit``; a faulthandler
  on ``stacks.txt`` (hard faults, and SIGUSR1 dumps every thread); and
  on an out-of-memory error (``torch.OutOfMemoryError``) the parsed
  report as a ``memory`` OOM history record, an ``oom`` ring record and
  ``oom.json``, which ``python -m tpu_dist_torch.obs postmortem`` reads
  as the ``oom`` verdict. The memory ledger snapshot beside the report
  is empty: the ledger is not ported.
* ``heartbeat_file``, ``metrics_file``, ``metrics_port`` and
  ``alert_rules``, the live telemetry the launcher's watchdog reads
  (``tpu_dist/train/trainer.py:2802-2860``): every rank beats its own
  ``per_rank_path`` file (``start``, then each step, throttled to 1 s;
  once an epoch on the fused path; ``preempted`` before the emergency
  snapshot; the file swept on a clean exit); an exporter publishes the
  counter registry and the epoch rollup as a per-rank OpenMetrics
  textfile and, on rank 0, over HTTP; the alert rules run at the epoch
  grain and at each metrics fetch, and a fired rule writes a warning, an
  ``alert`` history and ring record, and its ``alert_active`` gauge. The
  JAX exposition's goodput, MFU, memory and compile gauges belong to
  subsystems the port does not have yet.
* ``fault_plan`` (and ``$TPU_DIST_FAULT_PLAN``) installs
  :mod:`tpu_dist_torch.resilience.faults` at construction. Its step hook
  runs once a completed step, beside the flight ring's; ``nan_loss``
  raises :class:`TrainingDivergedError`, and a ``sigterm`` clause stops
  every rank at the step where it fired, as in the JAX trainer. The
  fused path refuses the step-grain sites.

``fused_epoch`` runs each epoch through :mod:`tpu_dist_torch.train.epoch`:
the dataset on the device, one step captured in a CUDA graph and replayed
(on the CPU, the same step eagerly), and the eval the same way; the
epoch's record has the JAX fused path's keys (``data_stall_frac`` 0.0).
A SIGTERM is honoured at the epoch boundary, and the whole epoch counts as
inside a step for the emergency snapshot (the replays update the state in
place). Options that JAX's fused runner never receives are refused
(:data:`FUSED_REFUSED`), as are mid-epoch snapshots and their resume.

Every config flag whose subsystem is not ported raises
:class:`~tpu_dist_torch.train.step.NotPortedError` naming its ROADMAP item
(:data:`UNPORTED`); none is ignored.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import math
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from tpu_dist_torch import bridge
from tpu_dist_torch import ckpt as ckpt_lib
from tpu_dist_torch.comm import collectives, mesh
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.data import cifar, native, synthetic, transforms
from tpu_dist_torch.data.loader import DataLoader
from tpu_dist_torch.data.sampler import DistributedSampler
from tpu_dist_torch.elastic import remap as remap_lib
from tpu_dist_torch.elastic.supervisor import decision_from_env
from tpu_dist_torch.evaluation.validate import validate
from tpu_dist_torch.metrics.history import MetricsHistory, per_rank_path
from tpu_dist_torch.metrics.logging import rank0_print
from tpu_dist_torch.metrics.meters import AverageMeter
from tpu_dist_torch.nn import resnet, vit
from tpu_dist_torch.obs import alerts as alerts_lib
from tpu_dist_torch.obs import counters, spans
from tpu_dist_torch.obs import flight as flight_lib
from tpu_dist_torch.obs import memory as memory_lib
from tpu_dist_torch.obs.export import MetricsExporter
from tpu_dist_torch.obs.heartbeat import Heartbeat
from tpu_dist_torch.resilience import faults, preemption
from tpu_dist_torch.resilience.preemption import PreemptedError
from tpu_dist_torch.train import epoch as epoch_lib
from tpu_dist_torch.train import step as step_lib
from tpu_dist_torch.train.optim import (LAMB, LARS, SGD, AdamW, cosine_lr, linear_scaled_lr,
                                        multistep_lr)
from tpu_dist_torch.train.state import TrainState
from tpu_dist_torch.train.step import WAITS_FOR, NotPortedError, make_eval_step, make_train_step

_MODELS = {
    "resnet18": resnet.resnet18, "resnet34": resnet.resnet34, "resnet50": resnet.resnet50,
    "resnet50_imagenet": resnet.resnet50_imagenet,
    "vit_b16": vit.vit_b16, "vit_s16": vit.vit_s16, "vit_tiny": vit.vit_tiny,
}

_TELEMETRY = "Queue A 6 (telemetry: obs/*)"
_PARALLEL = "Queue A 6 (model parallelism, parallel/*)"
_ANALYSIS = "Queue A 6 (the analysis layer)"

# flag -> (its default, the ROADMAP item its subsystem waits for)
UNPORTED = {
    "fsdp": (False, "Queue A 6 (parallel/fsdp.py)"),
    "device_metrics": (False, WAITS_FOR["device_metrics"]),
    "sp": (1, WAITS_FOR["seq_axis"]),
    "sp_mode": ("ring", WAITS_FOR["seq_axis"]),
    "tp": (1, _PARALLEL),
    "ep": (1, _PARALLEL),
    "pp": (1, _PARALLEL),
    "pp_microbatches": (0, _PARALLEL),
    "pp_interleave": (1, _PARALLEL),
    "moe_top_k": (1, _PARALLEL),
    "sharded_ckpt": (False, "Queue A 6 (the sharded checkpoint format)"),
    "tensorboard_dir": (None, _TELEMETRY),
    "trace_file": (None, _TELEMETRY),
    "straggler_threshold": (0.0, _TELEMETRY),
    "anomaly_action": ("off", _TELEMETRY),
    "memory_check": ("off", _TELEMETRY),
    "hbm_budget_bytes": (None, _TELEMETRY),
    "profile_dir": (None, _TELEMETRY),
    "profile_trigger": ("off", _TELEMETRY),
    "profile_steps": (None, _TELEMETRY),
    "debug_replica_check": (False, _TELEMETRY),
    "auto_shard": ("off", _ANALYSIS),
    "tune_report": ("", _ANALYSIS),
    "compile_cache_dir": (None, 'Queue A "No port owed" (the port compiles no XLA '
                                "program to cache)"),
}

# With fused_epoch: flag -> (its default, why the fused runner refuses it).
# JAX's make_fused_epoch never receives these (tpu_dist/train/trainer.py:
# 892-899, and its fused train_epoch ignores steps_per_epoch), so the JAX
# trainer drops them silently; the port refuses them instead.
FUSED_REFUSED = {
    "grad_accu_steps": (1, "the fused step takes the whole per-rank batch at once"),
    "label_smoothing": (0.0, "the fused step's loss is the plain cross-entropy"),
    "grad_clip_norm": (0.0, "the fused step does not clip the gradients"),
    "steps_per_epoch": (None, "a fused epoch runs every step of its data"),
    "mid_epoch_save_every": (0, "the fused epoch has no step boundary to snapshot at"),
    "remat": (False, "the fused step keeps its activations (no recomputation)"),
    "quant_chunk": (0, "the fused step quantizes in chunks of the default size"),
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


def refuse_fused_options(cfg: TrainConfig) -> None:
    """With ``fused_epoch``, raise ``ValueError`` for the first option of
    :data:`FUSED_REFUSED` that is not at its default."""
    if not cfg.fused_epoch:
        return
    for flag, (default, why) in FUSED_REFUSED.items():
        value = getattr(cfg, flag)
        if value != default:
            raise ValueError(f"{flag}={value!r} does not work with --fused_epoch: {why}; "
                             "drop the option or --fused_epoch")


def make_optimizer(cfg: TrainConfig):
    """The optimizer of ``cfg.optimizer``, with the JAX trainer's refusals
    and rank-0 lines (``tpu_dist/train/trainer.py:670-723``): the fused CUDA
    kernel is SGD's only, so ``fused_optimizer`` with another optimizer
    raises ``ValueError``; AdamW prints its decay mask; LARS and LAMB warn
    without the large-batch recipe (``lr_base_batch`` and
    ``warmup_epochs``). LARS and LAMB with ``shard_weight_update`` raise
    ``ValueError``: the ZeRO-1 flat layout loses their per-layer norms."""
    if cfg.optimizer == "sgd":
        return SGD(momentum=cfg.momentum, weight_decay=cfg.weight_decay,
                   fused=cfg.fused_optimizer)
    if cfg.optimizer not in ("adamw", "lars", "lamb"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r} (sgd | adamw | lars | lamb)")
    if cfg.fused_optimizer:
        raise ValueError(f"fused_optimizer is the CUDA fused-SGD kernel; {cfg.optimizer} uses "
                         "the plain (torch._foreach) update")
    if cfg.optimizer in ("lars", "lamb") and cfg.shard_weight_update:
        raise ValueError(f"{cfg.optimizer} needs per-layer norms, which the ZeRO-1 flat layout "
                         "destroys — use --fsdp (leaf-grained sharding) for a sharded "
                         "large-batch run")
    if cfg.optimizer == "adamw":
        rank0_print(f"=> adamw decay_mask={cfg.adamw_decay_mask} (auto: rank<=1 leaves excluded "
                    "from weight decay; --adamw_decay_mask all restores decay-everything)")
        return AdamW(weight_decay=cfg.weight_decay, decay_mask=cfg.adamw_decay_mask)
    if cfg.lr_base_batch <= 0 or cfg.warmup_epochs <= 0:
        rank0_print(f"=> WARNING: {cfg.optimizer} without the full large-batch recipe "
                    "(--lr_base_batch for linear LR scaling + --warmup_epochs) — trust ratios "
                    "alone rarely save an unscaled schedule")
    if cfg.optimizer == "lars":
        return LARS(momentum=cfg.momentum, weight_decay=cfg.weight_decay)
    return LAMB(weight_decay=cfg.weight_decay)


def install_fault_plan(cfg: TrainConfig) -> Optional[faults.FaultPlan]:
    """Install ``cfg.fault_plan`` (else ``$TPU_DIST_FAULT_PLAN``; with
    neither, clear a plan installed before) and return it. With
    ``fused_epoch`` its step- and batch-grain sites raise ``ValueError``:
    the epoch is one replayed graph with no step boundary and no streaming
    loader, so they would never fire (``tpu_dist/train/trainer.py:181-197``).
    A malformed spec raises :class:`~tpu_dist_torch.resilience.faults.FaultPlanError`."""
    plan = faults.configure(cfg.fault_plan)
    if plan is not None and cfg.fused_epoch:
        stepwise = sorted({c.site for c in plan.clauses} & faults.STEPWISE_SITES)
        if stepwise:
            raise ValueError(
                f"--fault_plan sites {stepwise} act at the step/batch grain, which "
                "--fused_epoch does not have (the epoch is one replayed CUDA graph and the "
                "streaming loader is bypassed): they would never fire. Use ckpt_write/"
                "ckpt_corrupt clauses, or drop --fused_epoch for chaos runs")
    return plan


def load_live_telemetry(cfg: TrainConfig) -> Optional[list]:
    """Check ``metrics_port`` and parse ``alert_rules`` before any model or
    data work (``tpu_dist/train/trainer.py:249-259``); returns the rules,
    or None."""
    if cfg.metrics_port < 0 or cfg.metrics_port > 65535:
        raise ValueError(f"metrics_port must be 0 (off) or a valid TCP port, got "
                         f"{cfg.metrics_port}")
    # raises on a malformed spec, an unknown builtin or duplicate names
    return alerts_lib.load_rules(cfg.alert_rules) if cfg.alert_rules else None


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
        refuse_fused_options(cfg)
        install_fault_plan(cfg)
        self._alert_rule_list = load_live_telemetry(cfg)
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
        # the fused C++ gather + crop + normalise, as the JAX trainer's
        # loaders take it; numpy when it cannot be built, with the reason
        self.input_pipeline = native.describe()
        if not native.available():
            rank0_print(f"=> WARNING: input pipeline: {self.input_pipeline}")
        self.train_loader = DataLoader(
            *self.train_data, self.local_batch, self.train_sampler, device=self.device,
            gather_transform=functools.partial(native.gather_augment, train=True, **stats),
            seed=seed, prefetch=cfg.num_workers,
        )
        self.test_loader = DataLoader(
            *self.test_data, self.local_batch, self.test_sampler, device=self.device,
            gather_transform=functools.partial(native.gather_augment, train=False, **stats),
            seed=seed, prefetch=cfg.num_workers, with_mask=True,
        )

        # -- model / optimizer state ----------------------------------------
        self.optimizer = make_optimizer(cfg)
        if cfg.shard_weight_update and cfg.fused_epoch:
            raise ValueError("shard_weight_update (ZeRO-1) is scoped to the plain DP step by "
                             "design — the fused-epoch scan keeps params replicated; use --fsdp "
                             "for sharded state")
        # DDP's init-time broadcast: every rank starts from rank 0's weights
        collectives.broadcast_module(self.model)
        self.state = TrainState.create(self.model, self.optimizer)
        if cfg.shard_weight_update or cfg.grad_compression == "int8_ef":
            # this rank's part of the flat state: ZeRO-1's optimizer shard,
            # the int8_ef residuals (zeros, the cold start)
            lay = step_lib.flat_layout(self.model)
            opt = (step_lib.init_sharded_opt_state(self.model, self.optimizer, layout=lay)
                   if cfg.shard_weight_update else self.state.opt_state)
            ef = (step_lib.init_ef_state(self.model, zero1=cfg.shard_weight_update, layout=lay)
                  if cfg.grad_compression == "int8_ef" else ())
            self.state = dataclasses.replace(self.state, opt_state=opt, ef=ef, layout=lay)
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
            grad_clip_norm=cfg.grad_clip_norm, pmean_fusion=cfg.pmean_fusion, remat=cfg.remat,
            shard_weight_update=cfg.shard_weight_update, grad_compression=cfg.grad_compression,
            quant_chunk=cfg.quant_chunk or None, rs_ag_chunks=cfg.rs_ag_chunks,
        )
        self.eval_step = make_eval_step(compute_dtype=compute_dtype)
        self._fused_runner = self._fused_eval = None
        if cfg.fused_epoch:
            place = functools.partial(epoch_lib.put_dataset_on_device, world=world, rank=rank,
                                      device=self.device)
            self._fused_data = place(*self.train_data)
            self._fused_runner = epoch_lib.make_fused_epoch(
                self.optimizer, batch_per_device=self.local_batch, sync_bn=cfg.sync_bn,
                compute_dtype=compute_dtype, pmean_fusion=cfg.pmean_fusion, seed=seed,
                grad_compression=cfg.grad_compression, **stats)
            # round the test set up to a multiple of the world with label -1
            # padding, so the fused eval counts every real example once
            ti, tl = self.test_data
            pad = (-len(tl)) % world
            if pad:
                ti = np.concatenate([ti, np.zeros((pad,) + ti.shape[1:], ti.dtype)])
                tl = np.concatenate([tl, np.full(pad, -1, tl.dtype)])
            self._fused_test_data = place(ti, tl)
            self._fused_eval = epoch_lib.make_fused_eval(
                batch_per_device=self.local_batch, compute_dtype=compute_dtype, **stats)

        # -- checkpoint / resume --------------------------------------------
        ckpt_lib.set_io_retries(cfg.ckpt_io_retries)
        self._async_ckpt = None  # made by _ckpt_io, released by _ckpt_close
        self._lr_scale = 1.0  # the auto-recovery backoff, carried in the meta
        self._state_poisoned = False  # the live state holds a diverged step
        self._best_top1 = -1.0
        self._params_len = ckpt_lib.params_len(self.model)
        # one id a run (config hash + construction second), in every record
        cfg_hash = hashlib.sha1(json.dumps(dataclasses.asdict(cfg), sort_keys=True,
                                           default=str).encode()).hexdigest()[:8]
        self._run_id = f"{cfg_hash}-{int(time.time())}"
        self._t0 = time.monotonic()  # the history's rel_s origin
        self.start_epoch = 0
        self._resume_step = 0  # > 0 only after restoring a mid-epoch snapshot
        self._resume_examples = 0  # > 0 only on an elastic mid-epoch resume (the offset)
        self._resume_world = None  # the process count of that resume's snapshot
        self._epoch_start_examples = 0  # the running epoch's entry offset
        self._resume_metrics = None  # that snapshot's last-step metrics
        self._step_metrics = None  # (epoch, steps done, metrics) of the last step
        self._last_epoch = 0
        # The training position of the live self.state, for _emergency_save:
        # (epoch, steps done in it, epoch complete). The step updates the
        # state in place, so while one runs (_in_step) the state may be
        # half updated and no snapshot is taken.
        self._progress = (-1, 0, True)
        self._in_step = False
        self._flight = None  # the rank's flight recorder, armed by fit (crash_dir)
        # the live telemetry of fit: heartbeat_file, metrics_file/_port and
        # alert_rules (made by _arm_live, released by _close_live)
        self._heartbeat = None
        self._exporter = None
        self._alerts = None
        self._history = None  # fit's history, for the alert records
        self._export_rollup: dict = {}
        self._export_t = float("-inf")
        self._resumed = None  # the restore's 'resume' ring record, stamped by fit
        if cfg.resume and cfg.ckpt_dir:
            epoch = self._restore_latest()
            if epoch is not None:
                # a mid-epoch snapshot re-enters its own epoch
                self.start_epoch = (epoch if self._resume_step or self._resume_examples
                                    else epoch + 1)

    def close(self) -> None:
        """Leave the process group if this trainer created it."""
        if self._owns_group and collectives.active():
            torch.distributed.destroy_process_group()
        self._owns_group = False

    def _lr(self, epoch: int) -> float:
        """The scheduled learning rate times the auto-recovery scale."""
        return self.lr_schedule(epoch) * self._lr_scale

    def _stop_agreed(self, votes: Optional[torch.Tensor] = None) -> bool:
        """Whether to stop for a SIGTERM at this boundary, decided alike on
        every rank. ``votes`` is the step's all-reduced count of ranks
        that had seen one; at an epoch boundary (no step) one all-reduce of
        the flags decides. A world of one reads its own flag, which costs
        no device sync."""
        if self.n_devices == 1:
            return preemption.requested()
        if votes is None:
            votes = collectives.all_reduce_(
                torch.full((), float(preemption.requested()),
                           device=collectives.group_device()), kind="preempt")
        return votes.item() > 0

    # -- checkpoint I/O ------------------------------------------------------

    def _ckpt_io(self):
        """The module's synchronous functions, or with ``async_ckpt`` the
        async writer (made anew after ``_ckpt_close`` released one)."""
        if not self.cfg.async_ckpt:
            return ckpt_lib
        if self._async_ckpt is None:
            self._async_ckpt = ckpt_lib.AsyncCheckpointer()
        return self._async_ckpt

    def _ckpt_close(self, suppress: bool = False) -> None:
        """Drain and release the async writer, waiting at most
        ``ckpt_drain_timeout_s`` (<= 0 waits for ever). ``suppress=True``
        logs a writer error instead of raising, where another exception is
        already on its way out. A drain that times out with writes in
        flight is a loud, counted loss (``ckpt.drain_abandoned``)."""
        if self._async_ckpt is None:
            return
        writer, self._async_ckpt = self._async_ckpt, None
        timeout = self.cfg.ckpt_drain_timeout_s
        timeout = timeout if timeout and timeout > 0 else None
        try:
            drained = writer.close(timeout=timeout)
        except Exception as e:
            if not suppress:
                raise
            rank0_print(f"WARNING: background checkpoint write failed: {e}")
            return
        if not drained:
            n = writer.in_flight
            counters.inc("ckpt.drain_abandoned", n)
            rank0_print(
                f"WARNING: abandoned {n} in-flight background checkpoint write(s) after "
                f"the {timeout:.0f}s drain timeout (--ckpt_drain_timeout_s) — their "
                "snapshots are LOST; the newest checkpoint on disk is the last one published"
            )
            if not suppress:
                raise RuntimeError(
                    f"background checkpoint drain timed out with {n} write(s) in flight")

    def _ckpt_meta(self) -> dict:
        """The layout stamps of every checkpoint: the pipeline layout (the
        JAX trainer refuses a mismatch), AdamW's decay mask (its state's
        shapes do not depend on it, so only the stamp tells a resume that
        would change which leaves decay), the auto-recovery LR scale, and
        the ``elastic`` stamp whose ``params_len`` the JAX restore checks."""
        cfg = self.cfg
        meta = {"pp": cfg.pp, "pp_interleave": cfg.pp_interleave}
        if cfg.optimizer == "adamw":
            meta["adamw_decay_mask"] = cfg.adamw_decay_mask
        if self._lr_scale != 1.0:
            meta["lr_scale"] = self._lr_scale
        meta["elastic"] = ckpt_lib.elastic_stamp(self.n_devices, self.n_devices,
                                                 self._params_len)
        return meta

    def _mid_epoch_position(self, steps_done: int) -> dict:
        """The data position of a mid-epoch snapshot: the step offset, the
        global batch size and seed that pin it, the process count and the
        consumed examples (which the JAX trainer's elastic resume reads),
        and the last step's metrics when they describe this position."""
        cfg = self.cfg
        base = self._epoch_start_examples // cfg.batch_size  # the steps the offset skipped
        out = {
            "mid_epoch_step": int(steps_done),
            "mid_epoch_batch_size": cfg.batch_size,
            "mid_epoch_seed": cfg.seed or 0,
            "mid_epoch_procs": self.n_devices,
            # the entry offset plus the steps since; the last batch of a
            # drop_last=False epoch is padded: clamp to N
            "mid_epoch_examples": min(
                self._epoch_start_examples + (int(steps_done) - base) * cfg.batch_size,
                len(self.train_data[0])),
        }
        stamped = self._step_metrics
        if stamped is not None and stamped[:2] == (self._progress[0], int(steps_done)):
            out["mid_epoch_metrics"] = {k: v.item() for k, v in stamped[2].items()}
        return out

    def _check_ckpt_meta(self, meta: dict, path: str) -> None:
        """Refuse a readable checkpoint of another configuration (raises
        :class:`~tpu_dist_torch.ckpt.ConfigMismatchError`, never
        quarantines): another pipeline layout, another model's parameter
        count, or another AdamW decay mask (a checkpoint without the stamp
        warns: which mask trained it is unknown)."""
        cfg = self.cfg
        ck_v, ck_pp = meta.get("pp_interleave"), meta.get("pp")
        if ck_v is not None and (ck_v != cfg.pp_interleave or (
                (ck_v > 1 or cfg.pp_interleave > 1) and ck_pp != cfg.pp)):
            raise ckpt_lib.ConfigMismatchError(
                f"checkpoint {path} was written with pp={ck_pp}, pp_interleave={ck_v}; its "
                f"block storage order is layout-specific (this run: pp={cfg.pp}, "
                f"pp_interleave={cfg.pp_interleave})")
        stamped = (meta.get("elastic") or {}).get("params_len")
        if stamped is not None and int(stamped) != self._params_len:
            raise ckpt_lib.ConfigMismatchError(
                f"checkpoint {path} was written with params_len={stamped} but the model has "
                f"{self._params_len} parameters — a different model")
        if cfg.optimizer == "adamw":
            ck_mask = meta.get("adamw_decay_mask")
            if ck_mask is None:
                rank0_print(
                    f"WARNING: checkpoint {path} predates the adamw_decay_mask stamp; resuming "
                    f"with --adamw_decay_mask {cfg.adamw_decay_mask} — if the run was trained "
                    "with a different mask, weight decay on bias/norm leaves silently changes "
                    "from here on")
            elif ck_mask != cfg.adamw_decay_mask:
                raise ckpt_lib.ConfigMismatchError(
                    f"checkpoint {path} was trained with adamw_decay_mask={ck_mask!r} but this "
                    f"run uses {cfg.adamw_decay_mask!r} — the optimizer state's shapes are the "
                    "same, so resuming would silently change which leaves get weight decay; "
                    f"pass --adamw_decay_mask {ck_mask} to resume faithfully")

    def _quarantine_ckpt(self, path: str, err: Exception) -> None:
        """Rank 0 renames a failed checkpoint to ``*.corrupt``; the other
        ranks only log (they stop seeing the file once the rename lands)."""
        if mesh.process_index() == 0:
            try:
                dst = ckpt_lib.quarantine(path)
            except OSError:
                dst = path + ".corrupt (rename failed)"
        else:
            dst = path + ".corrupt"
        rank0_print(f"WARNING: checkpoint {path} failed integrity verification ({err}) — "
                    f"quarantined to {dst}; falling back to the next older checkpoint")

    def _check_ladder_agreement(self, picked_epoch: int) -> None:
        """Every rank walks the ladder itself (reads and transient errors
        are local); resuming different epochs on different ranks would be
        silent divergence. One all-reduce of (pick, -pick) under MAX gives
        the largest and the smallest pick. Every rank reaches this once
        per restore (-1 when nothing usable was found)."""
        if self.n_devices <= 1:
            return
        picks = torch.tensor([picked_epoch, -picked_epoch], dtype=torch.int64,
                             device=collectives.group_device())
        collectives.all_reduce_(picks, "max", kind="ckpt_ladder")
        hi, lo = int(picks[0]), -int(picks[1])
        if hi != lo:
            raise RuntimeError(
                f"ranks disagree on the resume checkpoint (picks from epoch {lo} to {hi}): a "
                "transient read error or a racing quarantine made the walks diverge; "
                "inspect ckpt_dir (quarantined *.corrupt files) and relaunch")

    def _restore_latest(self) -> Optional[int]:
        """Restore the newest intact checkpoint of ``ckpt_dir`` into the
        live state; returns its epoch, or None when there is none.

        The ladder: newest to oldest, a candidate that is unreadable or
        fails its CRC32 stamps (``ckpt_verify``, fused into the one read)
        is quarantined and the next older one is tried. A checkpoint of
        another configuration, or one the port cannot lay out, raises.
        Each candidate is laid onto this run's world through the elastic
        remapper (``tpu_dist/train/trainer.py:2442-2506``)."""
        cfg = self.cfg
        if mesh.process_index() == 0:
            # no write is in flight at start-up: sweep what a crash leaked
            ckpt_lib.sweep_stale_tmp(cfg.ckpt_dir)
        candidates = ckpt_lib.all_checkpoints(cfg.ckpt_dir)
        if not candidates:
            if os.path.isdir(cfg.ckpt_dir) and any(
                    n.endswith(".manifest.json") for n in os.listdir(cfg.ckpt_dir)):
                raise NotPortedError("sharded_ckpt", f"checkpoints in {cfg.ckpt_dir}",
                                     UNPORTED["sharded_ckpt"][1])
            self._check_ladder_agreement(-1)
            return None
        template = bridge.restore_template(self.state)
        chosen = None
        for path, epoch in candidates:
            try:
                meta = ckpt_lib.read_meta(path)
            except ckpt_lib.CKPT_READ_ERRORS as e:
                self._quarantine_ckpt(path, e)
                continue
            self._check_ckpt_meta(meta, path)
            # the world-independent leaves load as they are; the flat
            # layouts of another extent are re-laid onto this one
            remapper = remap_lib.make_remapper(self.model, meta, self.n_devices)
            try:
                with spans.span("ckpt/restore_ladder", file=path):
                    flat = ckpt_lib.restore(path, verify=cfg.ckpt_verify, template=template,
                                            remap=remapper)
            except (ckpt_lib.CheckpointCorruptError,) + ckpt_lib.CKPT_READ_ERRORS as e:
                self._quarantine_ckpt(path, e)
                continue
            if remapper.used:
                counters.inc("resume.resharded")
                rank0_print(f"=> elastic resume: remapped {len(remapper.used)} dp-extent-"
                            f"dependent leaf(s) from dp={(meta.get('elastic') or {}).get('dp')} "
                            f"onto dp={self.n_devices} (ZeRO-1/EF flat layouts re-laid)")
            chosen = (path, epoch, meta, flat, bool(remapper.used))
            break
        self._check_ladder_agreement(chosen[1] if chosen is not None else -1)
        if chosen is None:
            rank0_print(f"WARNING: every checkpoint in {cfg.ckpt_dir} was corrupt and has been "
                        "quarantined — starting from scratch")
            return None
        path, epoch, meta, flat, resharded = chosen
        stamp = meta.get("elastic") or {}
        if isinstance(stamp.get("dp"), int) and stamp["dp"] < self.n_devices:
            counters.inc("elastic.grows")  # a resume onto a larger world
        resume_step = int(meta.get("mid_epoch_step", 0))
        resume_examples = self._check_mid_epoch(meta, path, resume_step) if resume_step else 0
        # copy_ into the live tensors: the step's module, its momentum list
        # and the fused SGD's plan cache keep pointing at the same storage
        self.state = bridge.load_train_state(self.state, flat)
        self._lr_scale = float(meta.get("lr_scale", 1.0))
        self._resume_step = 0 if resume_examples else resume_step
        self._resume_examples = resume_examples
        # the interrupted run's process count: its batches are replayed
        procs = meta.get("mid_epoch_procs")
        self._resume_world = int(procs) if resume_examples and procs else None
        self._resume_metrics = meta.get("mid_epoch_metrics") if resume_step else None
        self._state_poisoned = False
        self._progress = (epoch, self._resume_step, not resume_step)
        self._resumed = {"epoch": epoch, "world": mesh.process_count(), "dp": self.n_devices,
                         "resharded": resharded, "prev_dp": stamp.get("dp"),
                         "prev_procs": stamp.get("procs"),
                         "mid_epoch_step": self._resume_step,
                         "examples_offset": self._resume_examples}
        counters.inc("ckpt.restores")
        if self._resume_step:
            rank0_print(f"=> resumed from {path} (mid-epoch {epoch}, continuing at step "
                        f"{self._resume_step})")
        elif resume_examples:
            rank0_print(f"=> resumed from {path} (mid-epoch {epoch}, elastic: continuing at "
                        f"example offset {resume_examples}, remainder re-partitioned over "
                        f"{self.n_devices} process(es))")
        else:
            rank0_print(f"=> resumed from {path} (epoch {epoch})")
        return epoch

    def _check_mid_epoch(self, meta: dict, path: str, resume_step: int) -> int:
        """A mid-epoch snapshot re-enters its epoch at the same data
        position only with the same global batch size and seed (else it
        raises). Returns the consumed-example offset to re-enter through,
        or 0 to replay the per-rank step offset: that replay is exact only
        at the same process count for a snapshot that entered its epoch at
        offset 0 (``tpu_dist/train/trainer.py:2516-2566``)."""
        cfg = self.cfg
        for key, current in (("mid_epoch_batch_size", cfg.batch_size),
                             ("mid_epoch_seed", cfg.seed or 0)):
            saved = meta.get(key)
            if saved is not None and saved != current:
                raise ckpt_lib.ConfigMismatchError(
                    f"checkpoint {path} is a mid-epoch snapshot taken with "
                    f"{key.removeprefix('mid_epoch_')}={saved}; this run uses {current}, so "
                    "the step offset would re-enter the epoch at the wrong data position. "
                    "Resume with the matching value, or from the last clean epoch checkpoint.")
        procs, examples = meta.get("mid_epoch_procs"), meta.get("mid_epoch_examples")
        same_world = procs is None or int(procs) == self.n_devices
        offset_free = examples is None or int(examples) == resume_step * cfg.batch_size
        if same_world and offset_free:
            return 0
        # an offset at N is a legally empty epoch; past N is no position
        return min(int(examples if examples is not None else resume_step * cfg.batch_size),
                   len(self.train_data[0]))

    def _auto_recover(self, err: TrainingDivergedError) -> None:
        """The divergence response (``auto_recover``): reload the newest
        checkpoint and scale the LR schedule by ``recover_lr_factor`` (a
        bare retry on the same data order would diverge the same way).
        Raises ``err`` when there is no checkpoint to reload."""
        self._ckpt_close(suppress=True)
        epoch = self._restore_latest() if self.cfg.ckpt_dir else None
        if epoch is None:
            raise err
        # a mid-fit recovery is no new segment: its record is auto_recover
        self._resumed = None
        self.start_epoch = epoch if self._resume_step else epoch + 1
        self._lr_scale *= self.cfg.recover_lr_factor
        rank0_print(f"=> AUTO-RECOVER: {err}; resumed from epoch {epoch}, LR scale now "
                    f"{self._lr_scale:g} (factor {self.cfg.recover_lr_factor})")

    def _emergency_save(self) -> None:
        """The snapshot on SIGTERM or Ctrl-C, from ``self._progress``:

        - complete through epoch e: save the clean epoch e (kept as it is
          when ``ckpt_e`` exists); nothing when no epoch completed;
        - epoch e with k > 0 steps done: the exact snapshot under e stamped
          ``mid_epoch_step=k`` (and the batch size and seed that pin the
          data position), so ``resume`` continues epoch e at batch k;
        - epoch e with 0 steps done: the clean e - 1 (kept when on disk).

        Skipped while the live state holds a diverged step, or when Ctrl-C
        landed inside a step (the in-place update may be half done). Under
        a flat layout at a world > 1 the save gathers over the ranks, so
        they first agree: all skip when any rank must."""
        cfg = self.cfg
        if not cfg.ckpt_dir:
            return
        poisoned, in_step = self._state_poisoned, self._in_step
        if self.state.layout is not None and self.n_devices > 1:
            flags = torch.tensor([float(poisoned), float(in_step)],
                                 device=collectives.group_device())
            poisoned, in_step = (v > 0 for v in
                                 collectives.all_reduce_(flags, kind="ckpt").tolist())
        if poisoned:
            rank0_print("=> interrupted while the live state was NaN-poisoned — emergency "
                        "snapshot skipped; the last periodic checkpoint stays the newest")
            return
        if in_step:
            rank0_print("=> interrupted inside a step (or a fused epoch), whose in-place "
                        "update may be half done — emergency snapshot skipped; resume from "
                        "the last periodic checkpoint")
            return
        # the emergency snapshot must be the last file published
        self._ckpt_close(suppress=True)
        epoch, steps_done, complete = self._progress

        def clean_exists(e: int) -> bool:
            here = os.path.exists(os.path.join(cfg.ckpt_dir, f"ckpt_{e}.npz"))
            if self.state.layout is None or self.n_devices == 1:
                return here
            # a save gathers the flat state over the ranks: all must take
            # the same branch, rank 0's (which writes)
            flag = torch.full((1,), float(here), device=collectives.group_device())
            return bool(collectives.broadcast_from(flag).item())

        def save(ckpt_epoch: int, extra_meta: dict, msg: str) -> None:
            ckpt_lib.save(cfg.ckpt_dir, self.state, ckpt_epoch, cfg.keep_last_ckpts,
                          extra_meta=extra_meta)
            rank0_print(msg)

        if complete:
            if epoch < 0:
                return  # nothing trained yet
            if clean_exists(epoch):
                rank0_print(f"=> interrupted after epoch {epoch} completed; clean "
                            f"ckpt_{epoch} already on disk — kept as-is")
                return
            save(epoch, self._ckpt_meta(),
                 f"=> interrupted after epoch {epoch} completed; saved as epoch {epoch}")
            return
        if steps_done > 0:
            save(epoch, {**self._ckpt_meta(), **self._mid_epoch_position(steps_done)},
                 f"=> interrupted mid-epoch {epoch} after step {steps_done - 1}; exact "
                 f"snapshot saved — resume continues epoch {epoch} at step {steps_done}")
            return
        if epoch <= 0:
            return
        prev = epoch - 1
        if clean_exists(prev):
            rank0_print(f"=> interrupted mid-epoch {epoch}; clean ckpt_{prev} already on disk "
                        f"— kept as-is, resume re-runs epoch {epoch}")
            return
        save(prev, self._ckpt_meta(),
             f"=> interrupted mid-epoch {epoch}; state saved to {cfg.ckpt_dir} as epoch "
             f"{prev} — resume re-runs epoch {epoch}")

    def _guard(self, loss: float, where: str, lr: float) -> None:
        if self.cfg.nan_guard and not math.isfinite(loss):
            raise TrainingDivergedError(f"non-finite loss {loss} {where} (lr={lr})")

    def train_epoch(self, epoch: int, start_step: int = 0, start_examples: int = 0,
                    old_world: Optional[int] = None) -> dict:
        """Train one epoch from batch ``start_step`` (a mid-epoch resume at
        the same world), or past the first ``start_examples`` examples of
        the epoch's global order (an elastic resume: the rest is
        re-partitioned over this world, as the batches ``old_world`` ranks
        would have made when given, and the steps are numbered from
        ``start_examples // batch_size``); returns the epoch's dict."""
        if self._fused_runner is not None:
            if start_step or start_examples:
                raise ValueError(
                    "mid-epoch resume (checkpoint carries mid_epoch_step="
                    f"{start_step or start_examples}) is not possible with --fused_epoch: the "
                    "whole epoch is one run of the captured step; resume without --fused_epoch "
                    "to continue from the exact batch")
            return self._train_epoch_fused(epoch)
        cfg = self.cfg
        self.train_sampler.set_epoch(epoch)
        if start_examples:
            # skip the consumed prefix of the epoch's global order and
            # re-partition the rest over this world's ranks (set_epoch above
            # cleared any earlier offset, so only this epoch is shortened)
            self.train_sampler.set_offset(start_examples)
        # the interrupted run's batches for the rest of this epoch only
        self.train_loader.replay_world(old_world if start_examples else None)
        self._epoch_start_examples = start_examples
        base = start_examples // cfg.batch_size
        lr = self._lr(epoch)
        lr_t = torch.full((), lr, dtype=torch.float32, device=self.device)
        losses = AverageMeter("Loss", ":.4e")  # epoch average of the logged steps
        images_seen, steps_run, metrics = 0, 0, {}
        nb = len(self.train_loader)
        timer = _StepTimer(warmup_steps=1)
        phase = {"data": 0.0, "dispatch": 0.0, "fetch": 0.0}
        t0 = time.time()
        self._progress = (epoch, start_step + base, False)
        it = self.train_loader.iter_from(start_step)
        try:
            for step in range(start_step + base, nb + base):
                if cfg.steps_per_epoch is not None and step >= cfg.steps_per_epoch:
                    break
                t_w = time.perf_counter()
                try:
                    images, labels = next(it)
                except StopIteration:
                    break
                t_d = time.perf_counter()
                phase["data"] += t_d - t_w
                self._in_step = True
                self.state, metrics = self.train_step(self.state, images, labels, lr_t)
                votes = metrics.pop("preempt")
                self._step_metrics = (epoch, step + 1, metrics)
                self._progress = (epoch, step + 1, False)
                self._in_step = False
                phase["dispatch"] += time.perf_counter() - t_d
                images_seen += cfg.batch_size
                steps_run += 1
                timer.tick()
                if self._heartbeat is not None:
                    self._heartbeat.beat(epoch=epoch, step=step)  # throttled to 1 s
                if self._flight is not None:
                    # one pwrite a step: a killed rank's ring ends at its
                    # last completed step
                    self._flight.step(epoch, step)
                if self._exporter is not None:
                    self._export_live()  # the heartbeat's throttle: a clock read
                acts = (self._apply_step_faults(epoch, step, lr)
                        if faults.active() is not None else frozenset())
                want_save = bool(cfg.mid_epoch_save_every and cfg.ckpt_dir
                                 and (step + 1) % cfg.mid_epoch_save_every == 0)
                want_log = step % cfg.log_every == 0
                if want_save or want_log:  # one fetch serves the guard, the save and the log
                    t_f = time.perf_counter()
                    m = {k: v.item() for k, v in metrics.items()}
                    phase["fetch"] += time.perf_counter() - t_f
                    if self._alerts is not None:  # the step-fetch grain rules
                        fired = self._alerts.observe(m)
                        if fired:
                            self._fire_alerts(fired, epoch, step)
                    # a periodic exact snapshot never publishes a diverged state
                    self._guard(m["loss"], f"at epoch {epoch} step {step}", lr)
                if want_save:
                    self._ckpt_io().save(
                        cfg.ckpt_dir, self.state, epoch, cfg.keep_last_ckpts,
                        extra_meta={**self._ckpt_meta(), **self._mid_epoch_position(step + 1)})
                if want_log:
                    losses.update(m["loss"], cfg.batch_size)
                    rank0_print(f"Epoch:[{epoch}/{cfg.epochs}] step:[{step}/{nb}] "
                                f"lr={lr:.5f} loss={m['loss']:.4f} "
                                f"acc1={m['acc1']:.2f} acc5={m['acc5']:.2f}")
                # The vote in this step's metrics was cast before a sigterm@
                # clause fired after the step. Every rank runs the same plan,
                # so all fired here: one more all-reduce of the flags stops
                # them at this boundary, where the JAX trainer stops.
                if self._stop_agreed(None if faults.SIGTERM in acts else votes):
                    raise PreemptedError(f"SIGTERM observed at epoch {epoch} after step {step} "
                                         "— shutting down at the step boundary")
        finally:
            it.close()  # stop the prefetch thread of an epoch cut short
        if metrics:
            out = {k: v.item() for k, v in metrics.items()}
        elif steps_run == 0 and (start_step or start_examples):
            # the snapshot was taken after the epoch's last step: replay its
            # stamped metrics, so the epoch record matches the uninterrupted run
            out = dict(self._resume_metrics or {})
        else:
            out = {}
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

    def _train_epoch_fused(self, epoch: int) -> dict:
        """One fused epoch (:mod:`tpu_dist_torch.train.epoch`); its metrics
        are fetched once, at its end."""
        cfg = self.cfg
        self._progress = (epoch, 0, False)
        lr = self._lr(epoch)
        t0 = time.time()
        t_pc = time.perf_counter()
        # the replays update the state in place: until the epoch's metrics
        # are on the host, the state may be half trained
        self._in_step = True
        self.state, metrics = self._fused_runner(self.state, *self._fused_data, lr, epoch)
        m = dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))
        self._in_step = False
        spans.add_event("train/fused_epoch", t_pc, time.perf_counter() - t_pc, epoch=epoch)
        steps = len(self._fused_data[0]) // self.local_batch
        counters.inc("train.epochs")
        counters.inc("train.steps", steps)
        if self._heartbeat is not None:
            self._heartbeat.beat(epoch=epoch, phase="fused_epoch", force=True)
        if self._flight is not None:
            self._flight.step(epoch, None)  # the fused path's only grain
        self._guard(m["loss"], f"in fused epoch {epoch}", lr)
        dt = time.time() - t0
        n_images = len(self._fused_data[0]) * self.n_devices
        ips = n_images / dt if dt > 0 else 0.0
        rank0_print(f"Epoch:[{epoch}/{cfg.epochs}] (fused) lr={lr:.5f} loss={m['loss']:.4f} "
                    f"acc1={m['acc1']:.2f} acc5={m['acc5']:.2f}")
        rank0_print(f"Epoch {epoch} done in {dt:.2f}s ({ips:.0f} img/s)")
        # the data is on the device: there is no input pipeline to stall on
        m.update(epoch_time=dt, images_per_sec=ips, data_stall_frac=0.0)
        if self._stop_agreed():
            # the fused epoch has no step grain: its end is the first point a
            # SIGTERM can be honoured at, and the epoch is complete there
            self._progress = (epoch, 0, True)
            raise PreemptedError(f"SIGTERM observed during fused epoch {epoch} — shutting "
                                 "down at the epoch boundary")
        return m

    def _validate_fused(self, epoch: int):
        """The fused eval over the test set on the device; ``(top1, top5,
        loss)`` as :func:`validate` returns them."""
        t_ev = time.perf_counter()
        sums = self._fused_eval(self.state, *self._fused_test_data)
        sums = dict(zip(sums, torch.stack(list(sums.values())).tolist()))
        spans.add_event("eval/fused", t_ev, time.perf_counter() - t_ev, epoch=epoch)
        counters.inc("eval.runs")
        counters.inc("eval.examples", sums["count"])
        n = max(sums["count"], 1.0)
        t1, t5, vloss = sums["top1"] / n * 100.0, sums["top5"] / n * 100.0, sums["loss"] / n
        rank0_print(f" * Acc@1 {t1:.3f} Acc@5 {t5:.3f} (epoch {epoch}, fused)")
        return t1, t5, vloss

    def fit(self, epochs: Optional[int] = None) -> dict:
        """Train from ``start_epoch`` to ``epochs`` (default ``cfg.epochs``),
        validating every ``eval_every`` epochs and checkpointing into
        ``ckpt_dir``; returns the last epoch's dict. SIGTERM and Ctrl-C
        write the emergency snapshot and propagate (``PreemptedError``,
        ``KeyboardInterrupt``). Up to ``auto_recover`` times, a non-finite
        loss reloads the newest checkpoint at a lower LR."""
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.epochs
        log_path = cfg.log_file
        if cfg.per_host_log and cfg.log_file:
            log_path = per_rank_path(cfg.log_file, mesh.process_index())
        history = MetricsHistory(log_path, run_id=self._run_id, t0=self._t0,
                                 all_processes=cfg.per_host_log)
        self._last_epoch = self.start_epoch
        self._best_top1 = -1.0
        attempts = cfg.auto_recover
        fault_handle = self._arm_flight() if cfg.crash_dir else None
        self._log_segment(history)
        self._history = history
        sig_token = preemption.install()
        preemption.clear()
        try:
            self._arm_live()  # a port it cannot bind raises into the finally below
            while True:
                try:
                    result = self._fit_loop(epochs, history)
                    self._ckpt_close()  # the success path: writer errors raise
                    if self._heartbeat is not None:
                        self._heartbeat.sweep()  # a clean exit: the beat's absence says so
                    return result
                except TrainingDivergedError as e:
                    # until the restore lands, the live state is poisoned
                    self._state_poisoned = True
                    if attempts <= 0:
                        raise
                    attempts -= 1
                    self._auto_recover(e)
                    history.log("auto_recover", epoch=self._last_epoch,
                                lr_scale=self._lr_scale)
                    if self._flight is not None:
                        self._flight.record("auto_recover", epoch=self._last_epoch)
        except (KeyboardInterrupt, PreemptedError) as e:
            # one snapshot discipline for both; cli/train.py maps a
            # PreemptedError to exit 75
            if isinstance(e, PreemptedError):
                counters.inc("preemption.observed")
            if self._heartbeat is not None:
                # the last beat marks the position and stays on disk: with
                # the exit code it tells a watchdog the run was preempted
                self._heartbeat.beat(epoch=self._last_epoch, phase="preempted", force=True)
            self._emergency_save()
            raise
        finally:
            preemption.restore(sig_token)
            self._ckpt_close(suppress=True)
            self._close_live()
            self._oom_forensics(history)
            self._history = None
            history.close()
            if self._flight is not None:
                self._close_flight(fault_handle)

    def _log_segment(self, history: MetricsHistory) -> None:
        """The elastic gauges (``tpu_dist/train/trainer.py:2697-2744``): the
        world size, which relaunch this process is
        (``$TPU_DIST_ELASTIC_RESTARTS``) and the fleet decision that moved
        the run (``fleet.decision_id``); after a restore, one ``resume``
        history record that marks the segment's boundary, with the
        decision's id and cause when a fleet decision moved the run."""
        counters.set_gauge("elastic.world_size", self.n_devices)
        try:
            restarts = int(os.environ.get("TPU_DIST_ELASTIC_RESTARTS", "0") or 0)
        except ValueError:
            restarts = 0
        if restarts:
            counters.set_gauge("elastic.restarts", restarts)
        trace = decision_from_env()
        if "decision_id" in trace:
            counters.set_gauge("fleet.decision_id", trace["decision_id"])
        if self._resumed is not None:
            history.log("resume", restarts=restarts, **trace, **self._resumed)
            self._resumed = None

    def _arm_live(self) -> None:
        """The live telemetry of this ``fit`` (``tpu_dist/train/trainer.py:
        2802-2860``): every rank's heartbeat (``per_rank_path``, the scheme
        the launcher's watchdog reads) with its ``start`` beat; an exporter
        of the counter registry and the epoch rollup, as a per-rank
        textfile and a rank-0-only HTTP endpoint (a rank >= 1 with only
        ``metrics_port`` has nowhere to export and gets none); and the
        alert engine, fresh each ``fit``, its delta rules seeded with the
        counters now. All on the host: the captured graph is unchanged."""
        cfg, rank = self.cfg, mesh.process_index()
        if cfg.heartbeat_file:
            self._heartbeat = Heartbeat(per_rank_path(cfg.heartbeat_file, rank))
            self._heartbeat.beat(epoch=self.start_epoch, phase="start", force=True)
        self._export_rollup = {}
        self._export_t = float("-inf")
        textfile = per_rank_path(cfg.metrics_file, rank) if cfg.metrics_file else None
        port = (cfg.metrics_port or None) if rank == 0 else None
        if textfile or port:
            self._exporter = MetricsExporter(textfile=textfile, port=port, rank=rank)
        if self._alert_rule_list:
            self._alerts = alerts_lib.AlertEngine(self._alert_rule_list)
            # a delta rule fires on the change since fit began
            self._alerts.seed_deltas(counters.snapshot())

    def _close_live(self) -> None:
        """One last forced exposition (the textfile stays: it says how the
        run ended), then the HTTP thread stopped; the heartbeat's file is
        swept only on a clean exit, by ``fit``."""
        if self._exporter is not None:
            try:
                self._export_live(force=True)
            finally:
                self._exporter.close()
                self._exporter = None
        self._alerts = None
        self._heartbeat = None

    def _export_live(self, force: bool = False) -> None:
        """Publish one exposition: the counter registry, the epoch rollup,
        the heartbeat's age and the ``alert_active`` gauge of each rule.
        Throttled here to the exporter's ``min_interval``, so a step inside
        the window costs one clock read."""
        now = time.monotonic()
        if not force and now - self._export_t < self._exporter.min_interval:
            return
        self._export_t = now
        values = dict(counters.snapshot())
        values.update(self._export_rollup)
        if self._heartbeat is not None:
            age = self._heartbeat.age()
            if age != float("inf"):
                values["heartbeat.age_s"] = round(age, 3)
        labeled = {"alert_active": self._alerts.active()} if self._alerts is not None else None
        self._exporter.update(values, labeled, force=True)

    def _epoch_live_update(self, epoch: int, last: dict) -> None:
        """The end of an epoch for the live layer: the exporter's rollup,
        the epoch-grain alert rules over the epoch's numbers and the
        counters, and a forced exposition."""
        rollup = self._export_rollup
        rollup["train.epoch"] = epoch
        for key in ("images_per_sec", "loss", "data_stall_frac", "epoch_time"):
            if isinstance(last.get(key), (int, float)):
                rollup[f"train.{key}"] = last[key]
        for key in ("step_time_p50", "step_time_p95", "step_time_p99"):
            if isinstance(last.get(key), (int, float)):
                rollup[f"train.{key}_s"] = last[key]
        if isinstance(last.get("val_top1"), (int, float)):
            rollup["eval.top1"] = last["val_top1"]
        if self._alerts is not None:
            window = {k: v for k, v in last.items() if isinstance(v, (int, float))}
            window.update(counters.snapshot())
            fired = self._alerts.observe(window)
            if fired:
                self._fire_alerts(fired, epoch, None)
        if self._exporter is not None:
            self._export_live(force=True)

    def _fire_alerts(self, fired: list, epoch: int, step) -> None:
        """For each fired rule: the ``alerts.fired`` counter, a rank-0
        warning, an ``alert`` ring record and history record; then a forced
        exposition, whose ``alert_active`` gauge of the rule reads 1."""
        for a in fired:
            counters.inc("alerts.fired")
            rank0_print(f"WARNING: ALERT {a['rule']}: {a['metric']} = {a['value']} {a['op']} "
                        f"threshold {a['threshold']} (sustained {a['sustained']} window(s))")
            where = {"epoch": epoch, **({"step": step} if step is not None else {})}
            if self._flight is not None:
                self._flight.record("alert", rule=a["rule"], **where)
            if self._history is not None:
                self._history.log("alert", **where, **a)
        if self._exporter is not None:
            self._export_live(force=True)

    def _apply_step_faults(self, epoch: int, step: int, lr: float) -> frozenset:
        """The ``--fault_plan`` actions of a completed step; returns them.
        A ``sigterm`` clause has sent the real signal inside ``on_step``;
        ``nan_loss`` raises the NaN guard's error, so ``auto_recover``
        runs as for a real divergence."""
        acts = faults.on_step(epoch, step, rank=mesh.process_index())
        if faults.NAN_LOSS in acts:
            if self.cfg.nan_guard:
                raise TrainingDivergedError(
                    f"non-finite loss nan at epoch {epoch} step {step} (lr={lr}) "
                    "[fault-injected]; restore from ckpt_dir to recover")
            rank0_print(f"[faults] nan_loss injected at epoch {epoch} step {step} but "
                        "--no_nan_guard is set — ignored")
        return acts

    def _arm_flight(self):
        """The rank's flight ring (excepthooks, the span-open tap, the
        ``open`` and ``resume`` records) and its faulthandler on
        ``stacks.txt``; returns the faulthandler's handle."""
        cfg, rank = self.cfg, mesh.process_index()
        self._flight = flight_lib.FlightRecorder(
            per_rank_path(os.path.join(cfg.crash_dir, flight_lib.RING_NAME), rank),
            run_id=self._run_id, rank=rank)
        self._flight.install_excepthooks()
        spans.set_open_listener(self._flight.span_open)
        self._flight.record("open", epoch=self.start_epoch, world=mesh.process_count(),
                            dp=self.n_devices)
        if self._resumed is not None:
            self._flight.record("resume", **{k: self._resumed[k]
                                             for k in ("epoch", "world", "dp", "resharded")},
                                **decision_from_env())
        return flight_lib.arm_faulthandler(
            per_rank_path(os.path.join(cfg.crash_dir, flight_lib.STACKS_NAME), rank))

    def _close_flight(self, fault_handle) -> None:
        """The terminal record, from the exception ``fit`` is raising (if
        any), then the hooks and the faulthandler restored. A ring that
        ends without one was a hard kill."""
        spans.clear_open_listener()
        self._flight.uninstall_excepthooks()
        et, ev, tb = sys.exc_info()
        if et is None:
            self._flight.close("exit", clean=True)
        elif issubclass(et, PreemptedError):
            self._flight.close("preempt", epoch=self._last_epoch)
        elif issubclass(et, KeyboardInterrupt):
            self._flight.close("interrupt", epoch=self._last_epoch)
        else:
            self._flight.fatal(et, ev, tb)
            self._flight.close("exit", clean=False)
        self._flight = None
        flight_lib.disarm_faulthandler(fault_handle)

    def _oom_forensics(self, history: MetricsHistory) -> None:
        """An out-of-memory error on its way out of ``fit``, parsed into the
        typed report: a ``memory`` OOM history record, an ``oom`` ring
        record and ``crash_dir``'s per-rank ``oom.json``, beside an empty
        ledger snapshot."""
        _, err, _ = sys.exc_info()
        oom = memory_lib.parse_resource_exhausted(str(err)) if err is not None else None
        if oom is None:
            return
        counters.inc("mem.oom_events")
        snap: dict = {}
        rank0_print("FATAL: device " + memory_lib.oom_summary_line(oom) + " — "
                    + memory_lib.summary_line(snap))
        history.log("memory", event="oom", epoch=self._last_epoch, oom=oom, ledger=snap)
        if self._flight is not None:
            self._flight.record("oom", epoch=self._last_epoch,
                                requested=oom.get("requested_bytes"),
                                used=oom.get("used_bytes"), limit=oom.get("limit_bytes"))
        if self.cfg.crash_dir:
            memory_lib.write_oom_report(
                per_rank_path(os.path.join(self.cfg.crash_dir, memory_lib.OOM_NAME),
                              mesh.process_index()), oom, snap)

    def _fit_loop(self, epochs: int, history: MetricsHistory) -> dict:
        cfg, last = self.cfg, {}
        for epoch in range(self.start_epoch, epochs):
            self._last_epoch = epoch
            # a restored mid-epoch snapshot applies to its own epoch only
            start_step, self._resume_step = self._resume_step, 0
            start_examples, self._resume_examples = self._resume_examples, 0
            last = self.train_epoch(epoch, start_step=start_step, start_examples=start_examples,
                                    old_world=self._resume_world)
            self._progress = (epoch, 0, True)
            history.log("train_epoch", epoch=epoch, **last)
            if cfg.eval_every and (epoch + 1) % cfg.eval_every == 0:
                if self._fused_eval is not None:
                    t1, t5, vloss = self._validate_fused(epoch)
                else:
                    t1, t5, vloss = validate(self.test_loader, self.state, self.eval_step,
                                             epoch=epoch)
                last.update(val_top1=t1, val_top5=t5, val_loss=vloss)
                history.log("eval", epoch=epoch, top1=t1, top5=t5, loss=vloss)
                if cfg.ckpt_dir and t1 > self._best_top1:
                    self._best_top1 = t1
                    self._ckpt_io().save_best(cfg.ckpt_dir, self.state, epoch, t1,
                                              extra_meta=self._ckpt_meta())
            # with mid-epoch snapshots on, every epoch end writes the clean
            # checkpoint, or a stale mid-epoch ckpt_e would stay the newest
            if cfg.ckpt_dir and ((epoch + 1) % cfg.save_every == 0
                                 or cfg.mid_epoch_save_every > 0):
                self._ckpt_io().save(cfg.ckpt_dir, self.state, epoch, cfg.keep_last_ckpts,
                                     extra_meta=self._ckpt_meta())
            if self._exporter is not None or self._alerts is not None:
                self._epoch_live_update(epoch, last)
            if self._stop_agreed():
                # SIGTERM during the eval or the save: the epoch is complete
                raise PreemptedError(f"SIGTERM observed after epoch {epoch} completed — "
                                     "shutting down at the epoch boundary")
        if cfg.ckpt_dir:
            self._ckpt_io().save(cfg.ckpt_dir, self.state, epochs - 1, cfg.keep_last_ckpts,
                                 extra_meta=self._ckpt_meta())
        return last  # fit() drains the async writer
