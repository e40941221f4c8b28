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

``sp > 1`` lays the world out as a ``[world/sp, sp]`` mesh and trains the
ViT sequence-parallel over its seq groups
(:func:`~tpu_dist_torch.comm.mesh.seq_axis`; ``sp_mode`` ring or
ulysses), as the JAX trainer does:
the train batch is sharded over the data axis only (``batch_size //
(world/sp)`` a rank), and its stream, examples and crops, is keyed by the
data index, so every rank of a seq group draws the same batch; evaluation
is sharded over data x seq with no sequence parallelism. The JAX
trainer's refusals stand (:func:`check_sp_config`, :func:`check_sp_model`);
ZeRO-1 under ``sp`` waits for its checkpoint gather
(:data:`SP_ZERO1_QUEUE`). A checkpoint's ``dp`` and a mid-epoch snapshot's
process count are the data extent, the sampler's shard count.

``tp > 1`` (a ViT) lays the world out as ``[world/tp, tp]`` = ``[data,
model]``, or with ``sp`` as ``[world/(tp·sp), tp, sp]``
(:func:`~tpu_dist_torch.comm.mesh.tp_mesh`): each rank's model holds its
Megatron shards (``ViT(tp=)``), the ranks of a data row train its batch,
and the gradients, the evaluation's sums and the initial broadcast go over
the ranks that share a model index (``replicas``). ``ep > 1`` (a MoE ViT)
lays it out as ``[world/ep, ep]`` = ``[data, expert]``
(:func:`~tpu_dist_torch.comm.mesh.ep_mesh`): each rank holds its experts'
slabs (``ViTMoE(ep=)``) and trains and evaluates its contiguous slice of
the data row's batch, as the JAX trainer shards a batch over ``(data,
expert)``. ``moe_top_k`` sets the router's k; ``moe_aux_coef`` weighs its
load-balancing loss. The JAX trainer's refusals stand, with its messages
(:func:`check_parallel_config`, :func:`build_model`). A sharded model's
checkpoint is the plain format in JAX's full layout (gathered at save,
sliced by the rank's coordinates at restore), so it resumes at another
``tp`` or ``ep``.

``pp > 1`` (a pipelined ViT, ``vit_pp_*``) lays the world out as
``[world/pp, pp]`` = ``[data, pipe]``, or with ``tp`` as ``[world/(pp·tp),
pp, tp]`` = ``[data, pipe, model]`` (:func:`~tpu_dist_torch.comm.mesh.
pp_mesh`): each rank's model holds its stage's blocks (and, under PP×TP,
their Megatron shards), the ranks of a data row train and evaluate its
batch in ``pp_microbatches`` microbatches (default: the stage count;
evaluation always the stage count), GPipe or, with ``pp_interleave``, the
interleaved schedule, whose storage order the model takes from the config
as JAX relays it. The gradients, the evaluation's sums and the initial
broadcast go over the data axis. A pipelined checkpoint is JAX's full
stacked layout in storage order, stamped ``{pp, pp_interleave}``: a resume
under another layout is refused (:meth:`Trainer._check_ckpt_meta`).

``fsdp`` shards the parameters and the optimizer state over the data
axis (:mod:`tpu_dist_torch.parallel.fsdp`; with ``tp`` over the data axis
of ``[world/tp, tp]``, the TP shards again): the leaves and dimensions
JAX's ``fsdp_specs`` (``compose_fsdp_specs``) choose, the FSDP step and
eval (SyncBN over the group, the dense attention, the plain optimizer
update on the shards), and the JAX trainer's refusals and warnings
(:func:`check_fsdp_config`, :func:`fsdp_warnings`). The plain format
gathers the shards to rank 0; ``sharded_ckpt`` writes each rank's own.

Checkpoint / resume, preemption and the history are the JAX trainer's:

* ``ckpt_dir`` takes a plain-format checkpoint (:mod:`tpu_dist_torch.ckpt`,
  the JAX file format) every ``save_every`` epochs (and every epoch while
  ``mid_epoch_save_every`` is on), an exact mid-epoch snapshot every
  ``mid_epoch_save_every`` steps, and ``ckpt_best.npz`` on a better eval
  top-1; ``async_ckpt`` writes them on a worker thread after a
  synchronous device-to-host snapshot; ``keep_last_ckpts`` prunes.
  ``sharded_ckpt`` writes JAX's sharded format instead (every rank its
  pieces, rank 0 the manifest; with ``async_ckpt`` the snapshot blocks
  and the rest runs on the worker thread), for every layout the trainer
  runs.
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
  ``oom.json`` with the memory ledger's snapshot (the first dispatch's, or
  the static ledger before it), which ``python -m tpu_dist_torch.obs
  postmortem`` reads as the ``oom`` verdict.
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
  exposition carries the goodput gauges below, and the cost model's,
  the memory ledger's and the compile counters.
* The goodput ledger (:mod:`tpu_dist_torch.obs.goodput`,
  ``tpu_dist/train/trainer.py:143-144``): every second from the Trainer's
  construction to the end of ``fit`` lands in one bucket. A restore is
  ``ckpt`` (``recovery`` when it re-lays the state onto another world);
  a streaming epoch splits into ``data_stall`` (the loader waits),
  ``compile``, ``ckpt`` (its mid-epoch snapshots) and ``productive`` (the
  rest); the eval is ``eval``; every save and the writer's drain
  ``ckpt``; ``auto_recover`` is ``recovery``; the SIGTERM tail (the last
  beat and the emergency snapshot) is ``preempt``; what no region claims
  is ``unattributed``. The port compiles no XLA program, so its
  ``compile`` is the start-up cost of the step: on the streaming path the
  first step of each process, to its end on the device (the kernels'
  builds and loads, cuDNN's algorithm choice), as the JAX trainer charges
  its step 0's compile; on the fused path the CUDA graph's warmup and
  capture (``train/epoch.py::_GraphLoop``, none on the CPU). A
  ``goodput`` history record closes each epoch's window (rank 0, with
  ``log_file``), and the end of ``fit`` logs the ``tail`` window, the
  ``final`` totals and the ledger line; the exposition carries
  ``goodput.<bucket>_s`` and ``goodput.goodput_frac``, the totals of the
  windows closed so far, and the epoch-grain alert rules read
  ``goodput_frac``. ``obs/summarize.py::run_ledger`` folds the segments of
  a relaunched run, and charges a relaunch gap whose ``resume`` record
  carries a ``serve_breach`` fleet decision to ``preempt_for_serve_s``.
  Unlike the JAX trainer, a best-checkpoint save after an eval counts as
  ``ckpt`` alone, not inside ``eval`` as well.
* ``--seed`` makes cuDNN deterministic (:func:`seed_cudnn`), as the
  reference's ``init_seeds`` does.
* ``fault_plan`` (and ``$TPU_DIST_FAULT_PLAN``) installs
  :mod:`tpu_dist_torch.resilience.faults` at construction. Its step hook
  runs once a completed step, beside the flight ring's; ``nan_loss``
  raises :class:`TrainingDivergedError`, and a ``sigterm`` clause stops
  every rank at the step where it fired, as in the JAX trainer. The
  fused path refuses the step-grain sites.

* The training-health chain and the triggered profiler
  (``tpu_dist/train/trainer.py:205-244``, ``:766-808``, ``:1992-2290``,
  ``:3244-3304``): ``device_metrics`` adds the step's health scalars
  (:mod:`tpu_dist_torch.obs.device_stats`) to its metrics, which the loop
  fetches in one copy a logged step; every fetch writes a
  ``device_stats`` record, feeds the alert rules and the anomaly detector
  (``anomaly_action``, :mod:`tpu_dist_torch.obs.anomaly`: a warning, an
  ``anomaly`` record and ring entry, and under ``snapshot`` a save off the
  ``ckpt_`` namespace), before the NaN guard; ``straggler_threshold``
  gathers every rank's epoch time after each ``train_epoch`` record
  (:mod:`tpu_dist_torch.obs.straggler`). ``profile_dir`` alone captures
  the first epoch; with ``profile_steps`` or ``profile_trigger`` a
  :class:`~tpu_dist_torch.obs.profile.TriggeredProfiler` on every rank
  opens bounded ``torch.profiler`` windows (``host<rank>/`` below
  ``profile_dir`` at world > 1; anomaly findings arm rank 0, a straggler
  flag the flagged rank), logs ``profile`` and ``profile_analysis``
  records and closes on every exit of ``fit``.

* The memory ledger, the cost model and the trace export
  (``tpu_dist/train/trainer.py:937-984``, ``:1803-1815``, ``:1924-1993``,
  ``:2262-2310``, ``:3189-3235``; :mod:`tpu_dist_torch.obs.memory`,
  :mod:`tpu_dist_torch.obs.costmodel`). At construction the static
  ledger of ``params``, ``opt_state``, ``ef``, ``bn_state`` and one
  per-rank batch sets ``mem.static_bytes_per_device``, and
  ``memory_check`` prices it against the card's memory
  (``hbm_budget_bytes`` overrides, ``memory_headroom`` scales): ``warn``
  prints JAX's warning, ``refuse`` raises
  :class:`~tpu_dist_torch.obs.memory.InfeasibleMemoryError` before any
  step. The first dispatch (the first streaming step, or one of the fused
  graph's eager warmup steps, never the capture) runs under
  :func:`~tpu_dist_torch.obs.costmodel.step_cost`: the step's FLOPs and
  bytes across ranks become the ``device.{flops,bytes}_per_step`` gauges;
  on the card the allocator measures the step's waterfall (the ``xla``
  section, JAX's keys, ``source: "allocator"``); the ledger's census and
  reconciliation follow, as the ``mem.*`` gauges and one ``memory``
  history record. Each epoch's record carries ``mfu`` (the step p50, or
  the fused epoch's time a step after the capturing epoch, against the
  card's bf16 peak; none on the CPU) and sets ``mem.headroom_frac``. A
  capture's read-back publishes ``cost.calibration_*`` and the drift
  gauge ``plan.planner_error_frac`` with its ``plan`` record.
  ``compile.events`` and ``compile.seconds`` count the laps goodput books
  as ``compile``. With ``log_file`` or ``trace_file``, rank 0 records host
  spans: a ``spans`` history record an epoch (``log_file``) and, with
  ``trace_file``, one Chrome trace of the run at the end of ``fit``.

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

import contextlib
import dataclasses
import functools
import hashlib
import inspect
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
from tpu_dist_torch.nn import resnet, vit, vit_moe, vit_pp
from tpu_dist_torch.parallel import fsdp as fsdp_lib
from tpu_dist_torch.parallel.pipeline import bubble_fraction
from tpu_dist_torch.obs import alerts as alerts_lib
from tpu_dist_torch.obs import costmodel
from tpu_dist_torch.obs import counters, spans, straggler as straggler_lib
from tpu_dist_torch.obs import xprof as xprof_lib
from tpu_dist_torch.obs import flight as flight_lib
from tpu_dist_torch.obs import goodput as goodput_lib
from tpu_dist_torch.obs import memory as memory_lib
from tpu_dist_torch.obs import profile as profile_lib
from tpu_dist_torch.obs.anomaly import AnomalyDetector
from tpu_dist_torch.obs.export import MetricsExporter
from tpu_dist_torch.obs.heartbeat import Heartbeat
from tpu_dist_torch.resilience import faults, preemption
from tpu_dist_torch.resilience.preemption import PreemptedError
from tpu_dist_torch.train import epoch as epoch_lib
from tpu_dist_torch.train import step as step_lib
from tpu_dist_torch.train.optim import (LAMB, LARS, SGD, AdamW, cosine_lr, linear_scaled_lr,
                                        multistep_lr)
from tpu_dist_torch.train.state import TrainState
from tpu_dist_torch.train.step import NotPortedError, make_eval_step, make_train_step

_MODELS = {
    "resnet18": resnet.resnet18, "resnet34": resnet.resnet34, "resnet50": resnet.resnet50,
    "resnet50_imagenet": resnet.resnet50_imagenet,
    "vit_b16": vit.vit_b16, "vit_s16": vit.vit_s16, "vit_tiny": vit.vit_tiny,
    "vit_moe_tiny": vit_moe.vit_moe_tiny, "vit_pp_tiny": vit_pp.vit_pp_tiny,
}

_TELEMETRY = "Queue A 6 (telemetry: obs/*)"
_ANALYSIS = "Queue A 6 (the analysis layer)"

# flag -> (its default, the ROADMAP item its subsystem waits for)
UNPORTED = {
    "tensorboard_dir": (None, _TELEMETRY),
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
    BatchNorm); a model that takes ``tp=`` or ``ep=`` (a model or expert
    group) shards itself over it, and one that takes ``pipe=`` (with
    ``stage=``, ``interleave=`` and ``pp_stages=``) keeps its stage."""
    _MODELS[name] = factory


def build_model(cfg: TrainConfig, device, seed: int = 0, **shard) -> torch.nn.Module:
    """The zoo's ``cfg.model``, with ``shard`` (``tp=``, ``ep=`` or
    ``pipe=``, the groups, and the pipeline's layout) when given, and
    ``moe_top_k`` on a MoE model; the JAX trainer's refusals of a model
    without a tp, ep or pp branch or the interleaved layout, heads or
    experts that do not divide over the group, and a ``moe_top_k`` the model
    cannot take (``tpu_dist/train/trainer.py:422-527``)."""
    if cfg.model not in _MODELS:
        raise ValueError(f"unknown model {cfg.model!r}; have {sorted(_MODELS)}")
    try:
        model = _MODELS[cfg.model](num_classes=cfg.num_classes, device=device, seed=seed,
                                   **shard)
    except TypeError as e:
        if "pipe" in shard and "'pipe'" in str(e):
            raise ValueError(f"model {cfg.model!r} does not support pipeline parallelism "
                             f"(no pp_axis in apply); use vit_pp_* or pp=1") from None
        if "interleave" in shard and ("'interleave'" in str(e) or "'pp_stages'" in str(e)):
            raise ValueError(f"model {cfg.model!r} does not support the interleaved schedule "
                             f"(no interleave/pp_stages fields); use vit_pp_* or "
                             f"pp_interleave=1") from None
        if "tp" in shard and "'tp'" in str(e):
            raise ValueError(f"model {cfg.model!r} does not support tensor parallelism "
                             f"(no tp_axis in apply); use a ViT model or tp=1") from None
        if "ep" in shard and "'ep'" in str(e):
            raise ValueError(f"model {cfg.model!r} does not support expert parallelism "
                             f"(no ep_axis in apply); use a MoE model or ep=1") from None
        raise
    if hasattr(model, "attn_impl"):
        model.attn_impl = "flash" if cfg.flash_attention else "xla"
    if cfg.moe_top_k < 1:
        raise ValueError(f"moe_top_k must be >= 1, got {cfg.moe_top_k}")
    if cfg.moe_top_k > 1:
        if not hasattr(model, "top_k"):
            raise ValueError(f"model {cfg.model!r} has no MoE router (no top_k field) — "
                             f"--moe_top_k applies to vit_moe_* models")
        if cfg.moe_top_k > model.n_experts:
            raise ValueError(f"moe_top_k={cfg.moe_top_k} exceeds the model's "
                             f"{model.n_experts} experts")
        model.top_k = cfg.moe_top_k
    return model



def refuse_unported(cfg: TrainConfig) -> None:
    """Raise :class:`NotPortedError` for the first flag of :data:`UNPORTED`
    that is not at its default."""
    for flag, (default, queue) in UNPORTED.items():
        value = getattr(cfg, flag)
        if value != default:
            raise NotPortedError(flag, value, queue)


# what ZeRO-1 under sp > 1 waits for in the trainer (the step runs it)
SP_ZERO1_QUEUE = ("Queue A 3 (ZeRO-1 under --sp: the checkpoint's gather of the flat state "
                  "over the data axis)")


def check_sp_config(cfg: TrainConfig) -> None:
    """The JAX trainer's refusals of ``sp``/``sp_mode`` that need no model
    (``tpu_dist/train/trainer.py:326-380``): ``sp_mode`` is ring or
    ulysses; with ``sp > 1`` the fused epoch and fsdp are refused, and
    ZeRO-1 raises :class:`NotPortedError` (:data:`SP_ZERO1_QUEUE`)."""
    if cfg.sp_mode not in ("ring", "ulysses"):
        raise ValueError(f"sp_mode must be 'ring' or 'ulysses', got {cfg.sp_mode!r}")
    if cfg.sp < 1:
        raise ValueError(f"sp must be >= 1, got {cfg.sp}")
    if cfg.sp == 1:
        return
    if cfg.fused_epoch:
        raise ValueError("sp > 1 is not supported with fused_epoch")
    if cfg.fsdp:
        raise ValueError(
            "fsdp composes with --tp (GSPMD spec overlay) but not "
            "with sp/ep/pp: the ring/all_to_all/pipeline engines "
            "are shard_map programs, and a leaf cannot be owned by "
            "both a hand-written collective schedule and the "
            "GSPMD partitioner"
        )
    if cfg.shard_weight_update:
        raise NotPortedError("shard_weight_update", True, SP_ZERO1_QUEUE)


def check_fsdp_config(cfg: TrainConfig) -> None:
    """The JAX trainer's refusals of ``fsdp`` (``tpu_dist/train/trainer.py:
    373-421``), with its messages: sp, ep and pp, the fused epoch and
    ZeRO-1, ``fused_optimizer``, ``debug_replica_check`` and
    ``flash_attention`` (the FSDP step runs the dense attention). Its two
    warnings are :func:`fsdp_warnings`'."""
    if not cfg.fsdp:
        return
    if cfg.sp > 1 or cfg.ep > 1 or cfg.pp > 1:
        raise ValueError(
            "fsdp composes with --tp (GSPMD spec overlay) but not "
            "with sp/ep/pp: the ring/all_to_all/pipeline engines "
            "are shard_map programs, and a leaf cannot be owned by "
            "both a hand-written collective schedule and the "
            "GSPMD partitioner"
        )
    if cfg.fused_epoch or cfg.shard_weight_update:
        raise ValueError(
            "fsdp is incompatible with fused_epoch / zero1 (fsdp "
            "supersedes ZeRO-1: momentum AND params are sharded)"
        )
    if cfg.fused_optimizer:
        raise ValueError(
            "fsdp uses the plain SGD update (XLA fuses it into the "
            "sharded program); fused_optimizer is shard_map-path only"
        )
    if cfg.debug_replica_check:
        raise ValueError(
            "debug_replica_check asserts replicated params; under "
            "fsdp params are sharded by design"
        )
    if cfg.flash_attention:
        raise ValueError(
            "--fsdp with --flash_attention is not supported: the "
            "Pallas kernel runs inside the GSPMD-partitioned jit "
            "(no shard_map), where it has no SPMD partitioning "
            "rule — XLA would replicate or fail to compile. Use "
            "the default XLA attention under fsdp"
        )


def fsdp_warnings(cfg: TrainConfig) -> None:
    """The JAX trainer's rank-0 warnings under ``fsdp``: ``--no_sync_bn``
    and ``--grad_compression`` have no effect (the FSDP step's BatchNorm is
    the global batch's, and its reduce-scatters take no wire format)."""
    if not cfg.fsdp:
        return
    if not cfg.sync_bn:
        rank0_print(
            "WARNING: --no_sync_bn has no effect under --fsdp — "
            "BatchNorm statistics are global-batch (SyncBN) by "
            "construction in the GSPMD engine"
        )
    if cfg.grad_compression != "none":
        rank0_print(
            "WARNING: --grad_compression has no effect under --fsdp "
            "— the engine's collectives (including the gradient "
            "reduce-scatters the bf16/int8 wire formats would "
            "compress) are GSPMD-inserted from sharding specs, not "
            "hookable per-tensor (docs/compression.md)"
        )


def check_parallel_config(cfg: TrainConfig) -> None:
    """The JAX trainer's refusals of ``tp``, ``ep``, ``pp`` and their
    combinations that need no model (``tpu_dist/train/trainer.py:260-276``,
    ``:422-455``, ``:472-490``): ``pp_interleave`` at least 1 and only with
    ``pp > 1``, only sp+tp and pp+tp combine, TP and EP refuse the fused
    epoch and ZeRO-1, and the quantized wires refuse every model-parallel
    axis."""
    for flag in ("tp", "ep", "pp"):
        if getattr(cfg, flag) < 1:
            raise ValueError(f"{flag} must be >= 1, got {getattr(cfg, flag)}")
    if cfg.pp_interleave < 1:
        raise ValueError(f"pp_interleave must be >= 1, got {cfg.pp_interleave}")
    if cfg.pp_interleave > 1 and cfg.pp <= 1:
        raise ValueError(
            "pp_interleave > 1 has no effect without pp > 1 — set --pp "
            "to the stage count (refusing to silently ignore the flag)"
        )
    combined = sum(w > 1 for w in (cfg.sp, cfg.tp, cfg.ep, cfg.pp))
    if combined > 1 and not (combined == 2 and cfg.tp > 1 and (cfg.sp > 1 or cfg.pp > 1)):
        raise ValueError(
            "only sp+tp (3-D DPxTPxSP) and pp+tp (Megatron DPxPPxTP) "
            "may be combined; other sp/tp/ep/pp combinations are not "
            "supported yet"
        )
    if cfg.tp > 1 and (cfg.fused_epoch or cfg.shard_weight_update):
        raise ValueError(
            "tp > 1 is incompatible with fused_epoch / zero1 "
            "(grad_clip_norm composes — shard-aware norm in step.py)"
        )
    if (cfg.grad_compression in step_lib.QUANTIZED_MODES and not cfg.fsdp
            and (cfg.sp > 1 or cfg.tp > 1 or cfg.ep > 1 or cfg.pp > 1)):
        raise ValueError(
            f"grad_compression={cfg.grad_compression!r} is scoped to "
            "the plain data-parallel, fused-epoch, and ZeRO-1 paths — "
            "it cannot combine with sp/tp/ep/pp (use "
            "--grad_compression bf16 there)"
        )
    if cfg.ep > 1 and (cfg.fused_epoch or cfg.shard_weight_update):
        raise ValueError(
            "ep > 1 is incompatible with fused_epoch / zero1 "
            "(grad_clip_norm composes — shard-aware norm in step.py)"
        )


def pipeline_shard(cfg: TrainConfig, pm) -> dict:
    """The pipelined model's arguments on the mesh ``pm``
    (:func:`~tpu_dist_torch.comm.mesh.pp_mesh`): its groups, and the
    interleaved layout relayed from the config as the JAX trainer relays it
    into the model definition (``tpu_dist/train/trainer.py:502-525``)."""
    shard = {"pipe": pm[mesh.PIPE_AXIS]}
    if cfg.tp > 1:
        shard.update(tp=pm[mesh.MODEL_AXIS], stage=pm[f"{mesh.PIPE_AXIS},{mesh.MODEL_AXIS}"])
    if cfg.pp_interleave > 1:
        shard.update(interleave=cfg.pp_interleave, pp_stages=cfg.pp)
    return shard


def check_pp_model(cfg: TrainConfig, n_data: int) -> None:
    """The JAX trainer's refusals of ``pp > 1`` after the model (its depth
    over the chunks is the model's own refusal): fewer microbatches than
    stages under the interleaved schedule, the fused epoch and ZeRO-1, and
    a data shard's batch that does not divide into the microbatches
    (``tpu_dist/train/trainer.py:502-543``); then the rank-0 ``pipeline:``
    line with the bubble fraction."""
    if cfg.pp_interleave > 1 and (cfg.pp_microbatches or cfg.pp) < cfg.pp:
        raise ValueError(
            "pp_interleave > 1 requires pp_microbatches >= pp "
            "(fewer microbatches than stages starves the "
            "interleaved schedule's warmup ramp)"
        )
    if cfg.fused_epoch or cfg.shard_weight_update:
        raise ValueError(
            "pp > 1 is incompatible with fused_epoch / zero1 "
            "(grad_clip_norm composes — shard-aware norm in step.py)"
        )
    m = cfg.pp_microbatches or cfg.pp
    per_dev_batch = cfg.batch_size // max(1, n_data)
    if per_dev_batch % m:
        raise ValueError(
            f"per-data-shard batch {per_dev_batch} must divide into "
            f"{m} microbatches"
        )
    rank0_print(
        f"pipeline: {cfg.pp} stages x {cfg.pp_interleave} virtual, "
        f"{m} microbatches, bubble fraction "
        f"{bubble_fraction(cfg.pp, m, cfg.pp_interleave):.3f}"
    )


def check_sp_model(cfg: TrainConfig, model, world: int) -> None:
    """The JAX trainer's refusals of ``sp > 1`` that read the model and the
    world (``tpu_dist/train/trainer.py:326-370``, and its mesh's ``n %
    ways``): a model with no seq branch, ulysses with heads that do not
    divide over ``sp``, patch tokens that do not divide over ``sp``, a world
    or a batch that does not divide over data x seq. The model's come
    first, so a world of one rank shows them."""
    if cfg.sp == 1:
        return
    if "seq" not in inspect.signature(model.forward).parameters:
        raise ValueError(
            f"model {cfg.model!r} does not support sequence parallelism "
            f"(no seq in forward); use a ViT model or sp=1"
        )
    heads = getattr(model, "heads", None)
    # under sp x tp the attention sees heads/tp local heads
    local = heads // cfg.tp if heads is not None and cfg.tp > 1 else heads
    if cfg.sp_mode == "ulysses" and local is not None and local % cfg.sp:
        raise ValueError(
            f"sp_mode='ulysses' needs per-shard heads "
            f"({local}{f' = {heads}/tp' if cfg.tp > 1 else ''}) divisible by sp "
            f"({cfg.sp}); use sp_mode='ring'"
        )
    n_tokens = getattr(model, "n_patches", None)
    if n_tokens is not None and n_tokens % cfg.sp:
        raise ValueError(
            f"model has {n_tokens} patch tokens, not divisible by "
            f"sp={cfg.sp} — tokens would be dropped"
        )
    if world % cfg.sp:
        raise ValueError(f"{world} devices not divisible by sp/tp/ep/pp={cfg.sp}")
    if cfg.batch_size % world:
        raise ValueError(
            f"with sp>1, batch_size {cfg.batch_size} must also divide "
            f"over the {world} data x seq devices for "
            f"evaluation sharding"
        )


def _expert_slice(fn, ep):
    """``fn(state, images, labels, *rest)`` on this expert rank's rows of a
    data row's batch: the ``ep.index``-th of ``ep.size`` contiguous slices
    of every batch argument (not of a scalar such as the learning rate), as
    the JAX trainer shards a batch over the ``(data, expert)`` axes."""

    @functools.wraps(fn)
    def sliced(state, *batch):
        n = len(batch[0]) // ep.size
        return fn(state, *(b[ep.index * n:(ep.index + 1) * n] if np.ndim(b) else b
                           for b in batch))

    return sliced


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


def check_health_options(cfg: TrainConfig) -> tuple:
    """The JAX trainer's refusals of the health and profiler flags, with
    its messages (``tpu_dist/train/trainer.py:205-231``, ``:766-800``),
    before any model or data work: the profiler's specs parse, and need
    ``profile_dir`` and the step grain; ``device_metrics`` needs the
    replicated-parameter step and the per-step fetch; ``anomaly_action``
    is ``off|warn|snapshot``, and ``snapshot`` needs ``ckpt_dir``. Returns
    ``(the profile triggers, the manual window or None)``."""
    triggers = profile_lib.parse_trigger(cfg.profile_trigger)
    manual = profile_lib.parse_steps(cfg.profile_steps)
    if triggers or manual:
        if not cfg.profile_dir:
            raise ValueError(
                "--profile_trigger/--profile_steps capture on-device "
                "traces and need --profile_dir for the output "
                "(refusing to silently ignore the flags)"
            )
        if cfg.fused_epoch:
            raise ValueError(
                "--profile_trigger/--profile_steps need the per-step "
                "grain; --fused_epoch compiles the epoch into one "
                "call with no step boundary to open/close a capture "
                "window at (use --profile_dir alone for the epoch-0 "
                "blanket trace)"
            )
    if cfg.device_metrics:
        if cfg.fsdp or cfg.shard_weight_update or cfg.tp > 1 or cfg.ep > 1 or cfg.pp > 1:
            raise ValueError(
                "--device_metrics is scoped to the replicated-param "
                "paths (plain DP/SP, any --grad_compression): under "
                "ZeRO-1/FSDP/TP/EP/PP the reduced gradient exists "
                "only as shards, and the global norms would need the "
                "extra collectives the TD107 zero-cost contract "
                "forbids (docs/observability.md)"
            )
        if cfg.fused_epoch:
            raise ValueError(
                "--device_metrics needs the per-step metrics fetch; "
                "--fused_epoch compiles the epoch into one call with "
                "epoch-mean metrics, so the per-step norms would be "
                "averaged away (refusing to silently ignore the flag)"
            )
    if cfg.anomaly_action not in ("off", "warn", "snapshot"):
        raise ValueError(
            f"anomaly_action must be off|warn|snapshot, got "
            f"{cfg.anomaly_action!r}"
        )
    if cfg.anomaly_action == "snapshot" and not cfg.ckpt_dir:
        raise ValueError(
            "--anomaly_action snapshot writes an emergency mid-epoch "
            "checkpoint and needs --ckpt_dir (refusing to silently "
            "degrade to 'warn')"
        )
    return triggers, manual


def _fetch(metrics: dict) -> dict:
    """The metrics dict on the host in one device-to-host copy (one sync),
    the values those of ``.item()`` on each."""
    if not metrics:
        return {}
    return dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))


def seed_cudnn(seed: Optional[int]) -> None:
    """The cuDNN half of ``--seed``, as the reference's ``init_seeds``
    (``distributed_mp.py:29-39``): a seeded run takes cuDNN's deterministic
    algorithms with its autotuner off, so a rerun, or a relaunch resumed
    from a checkpoint, repeats the losses of an uninterrupted run bit for
    bit. Without a seed the flags are left as they are (torch's defaults in
    a fresh process: both off). The reference's unseeded
    ``init_seeds(cuda_deterministic=False)`` turns the autotuner on instead;
    the port does not, because the autotuner times candidate algorithms at
    the first call of every new shape, which adds to the first steps and
    lets the timing pick the algorithms, and so the last bits of a loss."""
    if seed is not None:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False


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
        self._profile_triggers, self._profile_manual = check_health_options(cfg)
        check_parallel_config(cfg)
        check_sp_config(cfg)
        check_fsdp_config(cfg)
        refuse_unported(cfg)
        refuse_fused_options(cfg)
        install_fault_plan(cfg)
        self._alert_rule_list = load_live_telemetry(cfg)
        # a run is one Trainer's lifetime: its counters start at 0
        counters.reset()
        # the goodput ledger's book opens now: construction (the process
        # group, the model, the data, the restore) is part of the run it
        # accounts, and its origin is the history's rel_s origin
        self._goodput = goodput_lib.GoodputLedger()
        self._t0 = self._goodput.t0
        self._t0_perf = time.perf_counter()  # the same instant on the span recorder's clock
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
        fsdp_warnings(cfg)
        # the triggered profiler (obs/profile.py), on every rank: anomaly
        # findings arm it on rank 0, a straggler flag on the flagged rank
        self._profiler = None
        self._global_step = 0  # run-global step index (--profile_steps grid)
        if self._profile_triggers or self._profile_manual:
            out = (os.path.join(cfg.profile_dir, f"host{rank}") if world > 1
                   else cfg.profile_dir)
            self._profiler = profile_lib.TriggeredProfiler(
                out, window_steps=cfg.profile_window, cooldown_steps=cfg.profile_cooldown,
                max_captures=cfg.profile_max_captures, manual_range=self._profile_manual,
                device=self.device, rank=rank)
        # raises on a degenerate window before training starts
        self._anomaly = (AnomalyDetector(window=cfg.anomaly_window,
                                         loss_spike=cfg.anomaly_loss_spike,
                                         grad_spike=cfg.anomaly_grad_spike)
                         if cfg.anomaly_action != "off" else None)
        seed = cfg.seed if cfg.seed is not None else 0
        seed_cudnn(cfg.seed)
        # the mesh, laid out as the JAX trainer's (tpu_dist/train/trainer.py:
        # 278-309): [world/sp, sp] as [data, seq], [world/tp, tp] as [data,
        # model], [world/ep, ep] as [data, expert], [world/(tp·sp), tp, sp]
        # as [data, model, seq], [world/pp, pp] as [data, pipe],
        # [world/(pp·tp), pp, tp] as [data, pipe, model]; the inner axes are
        # consecutive ranks
        ways = cfg.sp * cfg.tp * cfg.ep * cfg.pp
        if world % ways and (cfg.tp > 1 or cfg.ep > 1 or cfg.pp > 1):
            # (under sp alone the model's refusals come first: check_sp_model)
            if cfg.sp > 1 and cfg.tp > 1:
                raise ValueError(f"{world} devices not divisible by tp*sp={ways}")
            if cfg.pp > 1 and cfg.tp > 1:
                raise ValueError(f"{world} devices not divisible by pp*tp={ways}")
            raise ValueError(f"{world} devices not divisible by sp/tp/ep/pp={ways}")
        self.tp = self.ep = self.pipe = self.replicas = None
        self.seq = None
        shard = {}
        if cfg.pp > 1:
            pm = mesh.pp_mesh(cfg.pp, cfg.tp)
            mesh.check_model_axes_intra_host(
                pm, {mesh.PIPE_AXIS: cfg.pp, mesh.MODEL_AXIS: cfg.tp},
                mesh.ranks_per_host(self.device))
            shard = pipeline_shard(cfg, pm)
            self.pipe, self.tp = shard["pipe"], shard.get("tp")
            # the ranks that share this rank's stage (and model index)
            self.replicas = pm[mesh.DATA_AXIS]
        elif cfg.tp > 1:
            tmesh = mesh.tp_mesh(cfg.tp, cfg.sp)
            mesh.check_model_axes_intra_host(tmesh, {mesh.MODEL_AXIS: cfg.tp},
                                             mesh.ranks_per_host(self.device))
            self.tp, self.seq = tmesh[mesh.MODEL_AXIS], tmesh.axes.get(mesh.SEQ_AXIS)
            # the ranks that share this rank's model index: the gradient
            # reduce's, the evaluation's and the initial broadcast's group
            self.replicas = tmesh["data,seq" if cfg.sp > 1 else mesh.DATA_AXIS]
            shard = {"tp": self.tp}
        elif cfg.ep > 1:
            emesh = mesh.ep_mesh(cfg.ep)
            mesh.check_model_axes_intra_host(emesh, {mesh.EXPERT_AXIS: cfg.ep},
                                             mesh.ranks_per_host(self.device))
            self.ep, self.replicas = emesh[mesh.EXPERT_AXIS], emesh[mesh.DATA_AXIS]
            shard = {"ep": self.ep}
        self.model = build_model(cfg, self.device, seed, **shard)
        if cfg.pp > 1:
            check_pp_model(cfg, world // ways)
        check_sp_model(cfg, self.model, world // cfg.tp)  # the data x seq devices
        if cfg.sp > 1 and cfg.tp == 1:
            self.seq = mesh.seq_axis(cfg.sp)
        if cfg.ep > 1 and cfg.batch_size % world:
            raise ValueError(f"with ep>1, batch_size {cfg.batch_size} must divide over all "
                             f"{world} devices (the expert axis carries data)")
        # the train batch is sharded over the data axis and the same on the
        # ranks of a data row (its seq and model ranks), whose stream is
        # keyed by the data index; under EP the expert axis carries data too,
        # each rank its slice of the data row's batch
        self.n_data = world // ways
        data_index = mesh.mesh_coords(rank, ways)[0]
        if self.seq and not mesh.axis_intra_host(
                mesh.axis_groups(world, (cfg.tp, cfg.sp), (2,)),
                mesh.ranks_per_host(self.device)):
            # the ring still works across hosts, just slower: warn only
            rank0_print("WARNING: sequence-parallel axis spans hosts; ring attention "
                        "will run over the network between hosts instead of the links "
                        "inside one")

        # -- data -----------------------------------------------------------
        self.train_data, self.test_data = _load_data(cfg, world)
        expected = _DATASET_CLASSES.get(cfg.dataset)
        if expected is not None and cfg.num_classes != expected:
            raise ValueError(
                f"dataset {cfg.dataset!r} has {expected} classes but "
                f"num_classes={cfg.num_classes}; pass --num_classes {expected}"
            )
        if cfg.batch_size % self.n_data:
            raise ValueError(f"batch_size {cfg.batch_size} must divide over {self.n_data} "
                             f"data-parallel devices")
        # the reference's per-worker batch = global / nprocs (distributed.py:67);
        # under sp, tp and pp the train batch is a data row's, evaluation
        # sharded over every axis but the model's and the pipe's
        # (tpu_dist/train/trainer.py:643-654); under ep both are a data
        # row's, cut over its expert ranks
        self.local_batch = cfg.batch_size // self.n_data
        eval_ways = world // (cfg.tp * cfg.pp)
        eval_index = rank // (cfg.tp * cfg.pp) if cfg.sp == 1 else (
            data_index * cfg.sp + mesh.mesh_coords(rank, cfg.tp, cfg.sp)[2])
        if cfg.ep > 1:
            eval_ways, eval_index = self.n_data, data_index
        self.eval_batch = cfg.batch_size // eval_ways
        per_device = cfg.batch_size // (world if cfg.ep > 1 else self.n_data)
        if per_device % cfg.grad_accu_steps:
            raise ValueError(
                f"per-rank batch {per_device} must divide by grad_accu_steps="
                f"{cfg.grad_accu_steps}"
            )
        # the train stream (its examples and its crops) is keyed by the
        # data index, so every rank of a seq group draws the same batch;
        # evaluation shards over data x seq, with no sequence parallelism
        self.train_sampler = DistributedSampler(
            len(self.train_data[0]), self.n_data, data_index, shuffle=True, seed=seed,
            drop_last=cfg.drop_last or cfg.grad_accu_steps > 1,
        )
        self.test_sampler = DistributedSampler(
            len(self.test_data[0]), eval_ways, eval_index, shuffle=False, seed=seed)
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
            *self.test_data, self.eval_batch, self.test_sampler, device=self.device,
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
        # (under tp/ep from the first rank of the ranks that hold its shards)
        group = self.replicas.group if self.replicas is not None else None
        collectives.broadcast_module(self.model, collectives.global_rank(group, 0), group=group)
        self.state = TrainState.create(self.model, self.optimizer)
        self.state = dataclasses.replace(self.state, replicas=self.replicas)
        if cfg.fsdp:
            # params and optimizer state sharded over the data axis, laid as
            # JAX's fsdp_specs (compose_fsdp_specs under --tp) lay them
            axis = self.replicas if self.replicas is not None else mesh.data_axis(1)
            self.state = fsdp_lib.shard_state(self.state, axis=axis, optimizer=self.optimizer)
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
        if cfg.fsdp:
            # the arguments the JAX trainer hands make_fsdp_train_step
            # (tpu_dist/train/trainer.py:838-860)
            self.train_step = fsdp_lib.make_fsdp_train_step(
                self.optimizer, grad_accum_steps=cfg.grad_accu_steps,
                compute_dtype=compute_dtype, label_smoothing=cfg.label_smoothing,
                grad_clip_norm=cfg.grad_clip_norm, moe_aux_coef=cfg.moe_aux_coef,
                remat=cfg.remat)
            self.eval_step = fsdp_lib.make_fsdp_eval_step(
                compute_dtype=compute_dtype, tp_axis=self.tp, axis=self.replicas)
        else:
            self.train_step = make_train_step(
                self.optimizer, grad_accum_steps=cfg.grad_accu_steps, sync_bn=cfg.sync_bn,
                compute_dtype=compute_dtype, label_smoothing=cfg.label_smoothing,
                grad_clip_norm=cfg.grad_clip_norm, pmean_fusion=cfg.pmean_fusion,
                remat=cfg.remat, shard_weight_update=cfg.shard_weight_update,
                grad_compression=cfg.grad_compression, quant_chunk=cfg.quant_chunk or None,
                rs_ag_chunks=cfg.rs_ag_chunks, device_metrics=cfg.device_metrics,
                seq_axis=self.seq, sp_mode=cfg.sp_mode, tp_axis=self.tp, ep_axis=self.ep,
                pp_axis=self.pipe, axis=self.replicas, moe_aux_coef=cfg.moe_aux_coef,
                model_kwargs=({"n_microbatches": cfg.pp_microbatches}
                              if cfg.pp > 1 and cfg.pp_microbatches else None),
            )
            self.eval_step = make_eval_step(compute_dtype=compute_dtype, tp_axis=self.tp,
                                            ep_axis=self.ep, pp_axis=self.pipe,
                                            axis=self.replicas)
        if self.ep is not None:
            # each expert rank takes its slice of the data row's batch
            self.train_step = _expert_slice(self.train_step, self.ep)
            self.eval_step = _expert_slice(self.eval_step, self.ep)
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

        # -- the memory ledger and the pre-flight check ---------------------
        self._chip_kind = costmodel.device_kind(self.device)  # "cpu" on the CPU: no row
        self._peak = costmodel.chip_peak_flops(self._chip_kind)
        img, lbl = self.train_data
        per_dev = max(per_device, 1)
        self._mem_static = memory_lib.static_ledger(
            **memory_lib.state_sections(self.state),
            batch={"images": memory_lib.Leaf((per_dev,) + tuple(img.shape[1:]), str(img.dtype)),
                   "labels": memory_lib.Leaf((per_dev,), str(lbl.dtype))})
        counters.set_gauge("mem.static_bytes_per_device", self._mem_static["bytes_per_device"])
        self._mem_record = None  # the first dispatch's ledger snapshot
        self._step_cost = None  # the first dispatch's {flops,bytes}_per_step
        self._fused_traced = False  # a fused epoch has captured its graph (MFU from the next)
        # InfeasibleMemoryError under memory_check refuse, before any step
        self._mem_feasibility = memory_lib.preflight_check(
            self._mem_static["bytes_per_device"], budget_bytes=cfg.hbm_budget_bytes,
            headroom=cfg.memory_headroom, action=cfg.memory_check, chip_kind=self._chip_kind)
        if self._mem_feasibility and not self._mem_feasibility["fits"]:
            rank0_print(
                "WARNING: static HBM requirement "
                f"{memory_lib.fmt_bytes(self._mem_feasibility['required_bytes'])}/device exceeds "
                f"{cfg.memory_headroom:.0%} of the "
                f"{memory_lib.fmt_bytes(self._mem_feasibility['budget_bytes'])} per-chip budget "
                "— expect RESOURCE_EXHAUSTED; shard more or shrink the batch (--memory_check "
                "refuse stops here)")
        # host spans on rank 0 (a history record an epoch, the trace file),
        # armed before the restore so its ladder's spans are in the trace
        self._telemetry = bool(mesh.is_primary() and (cfg.log_file or cfg.trace_file))
        self._trace_events: list = []  # drained spans held for trace_file
        if self._telemetry:
            spans.enable(origin=self._t0_perf)

        # -- checkpoint / resume --------------------------------------------
        ckpt_lib.set_io_retries(cfg.ckpt_io_retries)
        self._async_ckpt = None  # made by _ckpt_io, released by _ckpt_close
        self._lr_scale = 1.0  # the auto-recovery backoff, carried in the meta
        self._state_poisoned = False  # the live state holds a diverged step
        self._best_top1 = -1.0
        # the full model's (a sharded model's checkpoint is written whole)
        self._params_len = ckpt_lib.params_len(bridge.jax_layout_template(self.model)[0])
        # one id a run (config hash + construction second), in every record
        cfg_hash = hashlib.sha1(json.dumps(dataclasses.asdict(cfg), sort_keys=True,
                                           default=str).encode()).hexdigest()[:8]
        self._run_id = f"{cfg_hash}-{int(time.time())}"
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
        self._stepped = False  # this process has run a streaming step (goodput's compile)
        self._last_reshard_s = 0.0  # wall time of the last restore that re-laid the state
        if cfg.resume and cfg.ckpt_dir:
            # a plain restore is ckpt time; one that re-lays the state onto
            # another world is the elastic recovery's
            t_res = time.monotonic()
            epoch = self._restore_latest()
            self._goodput.add("ckpt", time.monotonic() - t_res - self._last_reshard_s)
            self._goodput.add("recovery", self._last_reshard_s)
            if epoch is not None:
                # a mid-epoch snapshot re-enters its own epoch
                self.start_epoch = (epoch if self._resume_step or self._resume_examples
                                    else epoch + 1)
                self._seed_global_step()

    def _seed_global_step(self) -> None:
        """Re-anchor the ``--profile_steps`` grid after a restore. The grid
        is run-global (the flag's contract: "global steps"), so a resumed
        process must not restart it at 0, or a manual window that already
        ran before the preemption would fire again at the wrong steps. An
        epoch's step count is the loader's length capped by
        ``--steps_per_epoch``, the bound ``train_epoch`` keeps; a window
        cut short by the preemption resumes mid-range (the profiler
        captures the rest of it)."""
        n = len(self.train_loader)
        if self.cfg.steps_per_epoch is not None:
            n = min(n, self.cfg.steps_per_epoch)
        self._global_step = self.start_epoch * n + self._resume_step

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
        """The module's synchronous functions, the sharded writer
        (``sharded_ckpt``), or with ``async_ckpt`` the async writer, plain
        or snapshot-then-write sharded (made anew after ``_ckpt_close``
        released one)."""
        if not self.cfg.async_ckpt:
            return ckpt_lib.ShardedCheckpointer if self.cfg.sharded_ckpt else ckpt_lib
        if self._async_ckpt is None:
            self._async_ckpt = (ckpt_lib.AsyncShardedCheckpointer() if self.cfg.sharded_ckpt
                                else ckpt_lib.AsyncCheckpointer())
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
        meta["elastic"] = ckpt_lib.elastic_stamp(self.n_data, self.n_data, self._params_len)
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
            "mid_epoch_procs": self.n_data,
            # the entry offset plus the steps since; the last batch of a
            # drop_last=False epoch is padded: clamp to N
            "mid_epoch_examples": min(
                self._epoch_start_examples + (int(steps_done) - base) * cfg.batch_size,
                len(self.train_data[0])),
        }
        stamped = self._step_metrics
        if stamped is not None and stamped[:2] == (self._progress[0], int(steps_done)):
            out["mid_epoch_metrics"] = _fetch(stamped[2])
        return out

    def _check_ckpt_meta(self, meta: dict, path: str) -> None:
        """Refuse a readable checkpoint of another configuration (raises
        :class:`~tpu_dist_torch.ckpt.ConfigMismatchError`, never
        quarantines) with the JAX trainer's messages: another pipeline
        layout (or none stamped, under an interleaved run: such a
        checkpoint is in logical block order), another model's parameter
        count, or another AdamW decay mask (a checkpoint without the stamp
        warns: which mask trained it is unknown)."""
        cfg = self.cfg
        ck_v, ck_pp = meta.get("pp_interleave"), meta.get("pp")
        if ck_v is None and cfg.pp_interleave > 1:
            raise ckpt_lib.ConfigMismatchError(
                f"checkpoint {path} has no pipeline-layout tag (written "
                f"before interleaving existed, logical block order) — it "
                f"cannot be resumed with pp_interleave={cfg.pp_interleave}"
            )
        if ck_v is not None and (ck_v != cfg.pp_interleave or (
                (ck_v > 1 or cfg.pp_interleave > 1) and ck_pp != cfg.pp)):
            raise ckpt_lib.ConfigMismatchError(
                f"checkpoint {path} was written with pp={ck_pp}, "
                f"pp_interleave={ck_v} — its block storage order is "
                f"layout-specific; resume with the same flags (got "
                f"pp={cfg.pp}, pp_interleave={cfg.pp_interleave})"
            )
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
        remapper (``tpu_dist/train/trainer.py:2442-2506``).

        With ``sharded_ckpt`` the ladder walks the committed manifests
        (``tpu_dist/train/trainer.py:2385-2445``): a candidate is verified
        first (deeply only at one process: every rank would otherwise
        decompress the whole checkpoint; the overlap reads of the restore
        surface piece-level corruption), then restored in place. A
        directory that holds only the other format raises ``ValueError``:
        the formats do not convert, and starting from scratch would be
        silent."""
        cfg = self.cfg
        sharded = cfg.sharded_ckpt
        if sharded:
            list_, read_meta_ = ckpt_lib.all_sharded_checkpoints, ckpt_lib.read_sharded_meta
            other = ckpt_lib.latest_checkpoint
        else:
            list_, read_meta_ = ckpt_lib.all_checkpoints, ckpt_lib.read_meta
            other = ckpt_lib.latest_sharded_checkpoint
        if mesh.process_index() == 0:
            # no write is in flight at start-up: sweep what a crash leaked
            ckpt_lib.sweep_stale_tmp(cfg.ckpt_dir)
        candidates = list_(cfg.ckpt_dir)
        if not candidates:
            if other(cfg.ckpt_dir):
                raise ValueError(
                    f"ckpt_dir {cfg.ckpt_dir} holds checkpoints in the "
                    f"{'plain' if sharded else 'sharded'} format "
                    f"but this run asked for the "
                    f"{'sharded' if sharded else 'plain'} one — "
                    "flip --sharded_ckpt to match (the formats do not "
                    "auto-convert)"
                )
            self._check_ladder_agreement(-1)
            return None
        template = None if sharded else bridge.restore_template(self.state)
        template_params = bridge.jax_layout_template(self.model)[0]  # at full width
        chosen = None
        self._last_reshard_s = 0.0
        for path, epoch in candidates:
            try:
                if sharded and cfg.ckpt_verify:
                    ckpt_lib.verify_sharded(path, deep=self.n_devices == 1)
                meta = read_meta_(path)
            except (ckpt_lib.CheckpointCorruptError,) + ckpt_lib.CKPT_READ_ERRORS as e:
                self._quarantine_ckpt(path, e)
                continue
            self._check_ckpt_meta(meta, path)
            # the world-independent leaves load as they are; the flat
            # layouts of another extent are re-laid onto this one
            remapper = remap_lib.make_remapper(template_params, meta, self.n_data)
            t_restore = time.monotonic()
            try:
                with spans.span("ckpt/restore_ladder", file=path):
                    if sharded:
                        # in place: the shards of this rank's windows only
                        flat = ckpt_lib.restore_sharded(path, self.state, remap=remapper)
                    else:
                        flat = ckpt_lib.restore(path, verify=cfg.ckpt_verify, template=template,
                                                remap=remapper)
            except (ckpt_lib.CheckpointCorruptError,) + ckpt_lib.CKPT_READ_ERRORS as e:
                self._quarantine_ckpt(path, e)
                continue
            if remapper.used:
                # this restore was the reshard: goodput's recovery
                self._last_reshard_s = time.monotonic() - t_restore
                counters.inc("resume.resharded")
                rank0_print(f"=> elastic resume: remapped {len(remapper.used)} dp-extent-"
                            f"dependent leaf(s) from dp={(meta.get('elastic') or {}).get('dp')} "
                            f"onto dp={self.n_data} (ZeRO-1/EF flat layouts re-laid)")
            chosen = (path, epoch, meta, flat, bool(remapper.used))
            break
        self._check_ladder_agreement(chosen[1] if chosen is not None else -1)
        if chosen is None:
            rank0_print(f"WARNING: every checkpoint in {cfg.ckpt_dir} was corrupt and has been "
                        "quarantined — starting from scratch")
            return None
        path, epoch, meta, flat, resharded = chosen
        stamp = meta.get("elastic") or {}
        if isinstance(stamp.get("dp"), int) and stamp["dp"] < self.n_data:
            counters.inc("elastic.grows")  # a resume onto a larger world
        resume_step = int(meta.get("mid_epoch_step", 0))
        resume_examples = self._check_mid_epoch(meta, path, resume_step) if resume_step else 0
        # copy_ into the live tensors: the step's module, its momentum list
        # and the fused SGD's plan cache keep pointing at the same storage
        # (the sharded restore copied them already)
        self.state = flat if sharded else bridge.load_train_state(self.state, flat)
        self._lr_scale = float(meta.get("lr_scale", 1.0))
        self._resume_step = 0 if resume_examples else resume_step
        self._resume_examples = resume_examples
        # the interrupted run's process count: its batches are replayed
        procs = meta.get("mid_epoch_procs")
        self._resume_world = int(procs) if resume_examples and procs else None
        self._resume_metrics = meta.get("mid_epoch_metrics") if resume_step else None
        self._state_poisoned = False
        self._progress = (epoch, self._resume_step, not resume_step)
        self._resumed = {"epoch": epoch, "world": mesh.process_count(), "dp": self.n_data,
                         "resharded": resharded, "prev_dp": stamp.get("dp"),
                         "prev_procs": stamp.get("procs"),
                         "mid_epoch_step": self._resume_step,
                         "examples_offset": self._resume_examples}
        counters.inc("ckpt.restores")
        if self._resume_step:
            rank0_print(f"=> resumed from {path} (mid-epoch {epoch}, continuing at step "
                        f"{self._resume_step})")
        elif resume_examples:
            shards = "data shard(s)" if self.seq else "process(es)"
            rank0_print(f"=> resumed from {path} (mid-epoch {epoch}, elastic: continuing at "
                        f"example offset {resume_examples}, remainder re-partitioned over "
                        f"{self.n_data} {shards})")
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
        same_world = procs is None or int(procs) == self.n_data
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
        self.start_epoch = epoch if self._resume_step or self._resume_examples else epoch + 1
        self._seed_global_step()  # the --profile_steps grid follows the restored position
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
        a flat layout, FSDP, or with a tensor- or expert-parallel model, at
        a world > 1 the save gathers over the ranks, so they first agree: all
        skip when any rank must. With ``sharded_ckpt`` at a world > 1 it is
        skipped, as in JAX: the manifest's commit waits on a barrier."""
        cfg = self.cfg
        if not cfg.ckpt_dir:
            return
        poisoned, in_step = self._state_poisoned, self._in_step
        gathers = (self.state.layout is not None or self.replicas is not None
                   or self.state.fsdp is not None) and self.n_devices > 1
        if gathers:
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
        if cfg.sharded_ckpt and self.n_devices > 1:
            # the manifest's commit waits on a barrier across the ranks
            rank0_print("=> interrupted; state (or the sharded-ckpt commit barrier) is "
                        "cross-process — emergency snapshot skipped (collectives cannot run "
                        "from a signal handler); resume from the last periodic checkpoint")
            return
        io = ckpt_lib.ShardedCheckpointer if cfg.sharded_ckpt else ckpt_lib
        marker = "ckpt_{}.manifest.json" if cfg.sharded_ckpt else "ckpt_{}.npz"

        def clean_exists(e: int) -> bool:
            here = os.path.exists(os.path.join(cfg.ckpt_dir, marker.format(e)))
            if not gathers:
                return here
            # a save gathers the flat state or the shards over the ranks:
            # all must take the same branch, rank 0's (which writes)
            flag = torch.full((1,), float(here), device=collectives.group_device())
            return bool(collectives.broadcast_from(flag).item())

        def save(ckpt_epoch: int, extra_meta: dict, msg: str) -> None:
            io.save(cfg.ckpt_dir, self.state, ckpt_epoch, cfg.keep_last_ckpts,
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

    def _guard(self, loss: float, where: str, lr: float,
               then: str = "; restore from ckpt_dir to recover") -> None:
        """The NaN guard, with the JAX trainer's messages."""
        if self.cfg.nan_guard and not math.isfinite(loss):
            raise TrainingDivergedError(f"non-finite loss {loss} {where} (lr={lr}){then}")

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
        # goodput: the first step's seconds and the mid-epoch checkpoints'
        # go to their own buckets, out of the epoch's productive remainder
        compile_d = 0.0
        ckpt_s0 = self._goodput.window_value("ckpt")
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
                d_w = time.perf_counter() - t_w
                phase["data"] += d_w
                spans.add_event("train/data_wait", t_w, d_w, epoch=epoch)
                if self._profiler is not None:
                    # the capture's state machine before the step, so a
                    # window holds whole steps (host bookkeeping only)
                    ev = self._profiler.on_step(self._global_step)
                    if ev is not None:
                        self._note_profile_event(ev, epoch, step)
                self._global_step += 1
                t_d = time.perf_counter()
                self._in_step = True
                with (profile_lib.annotate_step(step) if profile_lib.capturing()
                      else contextlib.nullcontext()):
                    if self._step_cost is None:
                        # the first dispatch: counted, and the ledger taken
                        self.state, metrics = self._first_dispatch(
                            self.train_step, self.state, images, labels, lr_t)
                    else:
                        self.state, metrics = self.train_step(self.state, images, labels, lr_t)
                votes = metrics.pop("preempt")
                self._step_metrics = (epoch, step + 1, metrics)
                self._progress = (epoch, step + 1, False)
                self._in_step = False
                first = not self._stepped
                if first:
                    # this process's first step, to its end on the device:
                    # the kernels' builds and loads, cuDNN's algorithm
                    # choice, the allocator's first blocks
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    compile_d = time.perf_counter() - t_d
                    self._count_compile(compile_d)
                    self._stepped = True
                d_d = time.perf_counter() - t_d
                phase["dispatch"] += d_d
                # only this Trainer's first dispatch holds the start-up cost
                spans.add_event("train/compile+dispatch" if first else "train/dispatch", t_d,
                                d_d, step=step)
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
                    m = _fetch(metrics)
                    phase["fetch"] += time.perf_counter() - t_f
                    # the health layer on the same host copy: device_stats,
                    # the alert rules, the anomaly detector (a non-finite
                    # finding is logged before the guard below raises)
                    self._observe_health(epoch, step, m)
                    # a periodic exact snapshot never publishes a diverged state
                    self._guard(m["loss"], f"at epoch {epoch} step {step}", lr,
                                " — caught at the mid-epoch snapshot boundary before writing "
                                "it; restore from ckpt_dir to recover" if want_save else
                                "; restore from ckpt_dir to recover")
                if want_save:
                    with self._goodput.timed("ckpt"):
                        self._ckpt_io().save(
                            cfg.ckpt_dir, self.state, epoch, cfg.keep_last_ckpts,
                            extra_meta={**self._ckpt_meta(),
                                        **self._mid_epoch_position(step + 1)})
                if want_log:
                    losses.update(m["loss"], cfg.batch_size)
                    rank0_print(f"Epoch:[{epoch}/{cfg.epochs}] step:[{step}/{nb}] "
                                f"lr={lr:.5f} loss={m['loss']:.4f} "
                                f"acc1={m['acc1']:.2f} acc5={m['acc5']:.2f}"
                                + (f" gnorm={m['grad_norm']:.3e} upd={m['update_ratio']:.2e}"
                                   if "grad_norm" in m else ""))
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
            out = _fetch(metrics)
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
        # MFU from the first dispatch's FLOPs over the steady step time (the
        # p50 leaves the first step out; else the epoch mean); none on the CPU
        if self._step_cost and self._peak and steps_run:
            mfu = costmodel.mfu(self._step_cost.get("flops_per_step"),
                                pct["p50"] if pct else dt / steps_run, self.n_devices,
                                peak=self._peak)
            if mfu is not None:
                out["mfu"] = mfu
                rank0_print(f"  MFU {mfu:.1%}")
        self._publish_memory_gauges()
        # the epoch's wall time: the loader waits, the first step, the
        # mid-epoch checkpoints, and the step loop stepping as the rest
        ckpt_d = max(self._goodput.window_value("ckpt") - ckpt_s0, 0.0)
        self._goodput.add("data_stall", phase["data"])
        self._goodput.add("compile", compile_d)
        self._goodput.add("productive", dt - phase["data"] - compile_d - ckpt_d)
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
        capture_s0 = self._fused_runner.capture_s
        if self._step_cost is None:
            # the first dispatch is one of the graph's eager warmup steps
            self._fused_runner.probe = self._first_dispatch
        self.state, metrics = self._fused_runner(self.state, *self._fused_data, lr, epoch)
        m = _fetch(metrics)
        self._in_step = False
        capture_s = self._fused_runner.capture_s
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
        # goodput: the graph's warmup and capture (a first epoch on the
        # card) is the compile bucket, the rest of the epoch productive
        compile_d = capture_s if capture_s is not None and capture_s != capture_s0 else 0.0
        if compile_d:
            self._count_compile(compile_d)
        self._goodput.add("compile", compile_d)
        self._goodput.add("productive", dt - compile_d)
        # MFU only from epochs after the first: the first one's time holds
        # the warmup and the capture
        if self._step_cost and self._peak and self._fused_traced and steps:
            mfu = costmodel.mfu(self._step_cost.get("flops_per_step"), dt / steps,
                                self.n_devices, peak=self._peak)
            if mfu is not None:
                m["mfu"] = mfu
                rank0_print(f"  MFU {mfu:.1%}")
        self._fused_traced = True
        self._publish_memory_gauges()
        # the only grain the fused path has: the epoch-mean loss
        # (device_metrics is refused with fused_epoch)
        self._observe_health(epoch, None, m)
        if self._stop_agreed():
            # the fused epoch has no step grain: its end is the first point a
            # SIGTERM can be honoured at, and the epoch is complete there
            self._progress = (epoch, 0, True)
            raise PreemptedError(f"SIGTERM observed during fused epoch {epoch} — shutting "
                                 "down at the epoch boundary")
        return m

    def _first_dispatch(self, fn, *args):
        """``fn(*args)``, this Trainer's first step, counted
        (``obs/costmodel.py::step_cost``: the step's FLOPs and bytes across
        the ranks, the ``device.*`` gauges and the MFU's numerator). On the
        card the allocator measures the step around it: what is allocated
        at its entry (``argument_bytes``), its peak less that
        (``temp_bytes``), what it left allocated less the entry
        (``output_bytes``, floored at 0) and the peak; then the ledger
        (:meth:`_capture_memory_ledger`)."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            entry = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        out, cost = costmodel.step_cost(fn, *args, world=self.n_devices, pp=self.cfg.pp)
        xla = None
        if cuda:
            torch.cuda.synchronize(self.device)
            peak = torch.cuda.max_memory_allocated(self.device)
            xla = {"argument_bytes": entry,
                   "output_bytes": max(torch.cuda.memory_allocated(self.device) - entry, 0),
                   "temp_bytes": peak - entry, "peak_bytes": peak, "source": "allocator"}
        self._step_cost = cost
        costmodel.publish(cost)
        self._capture_memory_ledger(xla)
        return out

    def _capture_memory_ledger(self, xla) -> None:
        """The ledger snapshot of the first dispatch (``obs/memory.py``):
        the live census reconciled against the allocator (``attributed +
        unattributed == bytes_in_use``, exact), the static ledger of the
        construction, the pre-flight's verdict and the step's waterfall;
        published as ``mem.*`` gauges and one ``memory`` history record."""
        rec = memory_lib.ledger(self.device, static=self._mem_static, xla=xla)
        if self._mem_feasibility:
            rec["feasibility"] = self._mem_feasibility
        memory_lib.publish_ledger(rec)
        self._mem_record = rec
        if self._history is not None:
            self._history.log("memory", **rec)
        rank0_print("=> " + memory_lib.summary_line(rec))

    def _publish_memory_gauges(self) -> None:
        """The epoch's allocator gauges (``mem.bytes_in_use``,
        ``mem.peak_bytes_in_use``, ``mem.bytes_limit``,
        ``mem.mem_devices_reporting``) and ``mem.headroom_frac``, the free
        fraction of the card, which the built-in ``memory_headroom_low``
        alert reads; nothing on the CPU."""
        mem = costmodel.device_memory_stats(self.device)
        if mem:
            for key, value in mem.items():
                counters.set_gauge(f"mem.{key}", value)
            lim, use = mem.get("bytes_limit"), mem.get("bytes_in_use")
            if lim and isinstance(use, (int, float)):
                counters.set_gauge("mem.headroom_frac", round(1.0 - use / lim, 4))

    @staticmethod
    def _count_compile(seconds: float) -> None:
        """A lap goodput books as ``compile`` (the first streaming step of
        the process, a fused graph's warmup and capture): one
        ``compile.events`` and its ``compile.seconds``."""
        counters.inc("compile.events")
        counters.inc("compile.seconds", round(seconds, 3))

    def _validate_fused(self, epoch: int):
        """The fused eval over the test set on the device; ``(top1, top5,
        loss)`` as :func:`validate` returns them."""
        t_ev = time.perf_counter()
        sums = self._fused_eval(self.state, *self._fused_test_data)
        sums = _fetch(sums)
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
        if self._telemetry:
            # construction armed the recorder; a second fit re-arms it,
            # keeping the buffer and the clock origin
            spans.enable(fresh=False)
            # the gradient reduce's wire bytes a step: the ring's two legs
            # (reduce-scatter + all-gather) of every parameter in the
            # wire's format
            n_params = sum(p.numel() for p in self.model.parameters())
            bpe = {"none": 4, "bf16": 2, "int8": 1, "int8_ef": 1}[cfg.grad_compression]
            counters.set_gauge("comm.grad_wire_bytes_per_step", 2 * bpe * n_params)
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
                    with self._goodput.timed("ckpt"):
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
                    with self._goodput.timed("recovery"):
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
            # goodput's preempt: the shutdown tail from here (the beat and
            # the snapshot); the seconds from the signal to the boundary
            # stay in the bucket that spent them (a partial epoch's are
            # unattributed), and the relaunch gap is the offline half's
            t_pre = time.monotonic()
            if self._heartbeat is not None:
                # the last beat marks the position and stays on disk: with
                # the exit code it tells a watchdog the run was preempted
                self._heartbeat.beat(epoch=self._last_epoch, phase="preempted", force=True)
            self._emergency_save()
            self._goodput.add("preempt", time.monotonic() - t_pre)
            raise
        finally:
            preemption.restore(sig_token)
            with self._goodput.timed("ckpt"):  # the writer's drain
                self._ckpt_close(suppress=True)
            if self._profiler is not None:
                # a capture window in flight must not outlive the run
                ev = self._profiler.close()
                if ev is not None:
                    self._note_profile_event(ev, self._last_epoch, None)
            self._close_goodput(history)
            self._close_live()
            if self._telemetry:
                self._export_telemetry(history)
            self._oom_forensics(history)
            self._history = None
            history.close()
            if self._flight is not None:
                self._close_flight(fault_handle)

    def _close_goodput(self, history: MetricsHistory) -> None:
        """The ledger's end of ``fit``: the tail window (the last save, the
        drain, the teardown) as a ``goodput`` record marked ``tail``, the
        run's ``final`` totals record, and the rank-0 ledger line. A write
        that fails is reported and never masks the exception ``fit`` may
        be raising."""
        try:
            tail = self._goodput.window_record()
            totals = self._goodput.run_totals()
            if history.path:
                history.log("goodput", epoch=self._last_epoch, tail=True, **tail)
                history.log("goodput", final=True, **totals)
            if history.path or self.cfg.trace_file:
                rank0_print("=> " + goodput_lib.ledger_line(totals))
        except OSError as e:
            rank0_print(f"WARNING: goodput ledger close failed: {e}")

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
        # the run's goodput over the windows closed so far: the numbers the
        # ledger's final record will carry
        totals = self._goodput.run_totals()
        for b in goodput_lib.ALL_BUCKETS:
            values[f"goodput.{b}_s"] = totals[f"{b}_s"]
        values["goodput.goodput_frac"] = totals["goodput_frac"]
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
        for key in ("images_per_sec", "loss", "mfu", "data_stall_frac", "epoch_time"):
            if isinstance(last.get(key), (int, float)):
                rollup[f"train.{key}"] = last[key]
        for key in ("step_time_p50", "step_time_p95", "step_time_p99"):
            if isinstance(last.get(key), (int, float)):
                rollup[f"train.{key}_s"] = last[key]
        if isinstance(last.get("val_top1"), (int, float)):
            rollup["eval.top1"] = last["val_top1"]
        if self._alerts is not None:
            window = {k: v for k, v in last.items() if isinstance(v, (int, float))}
            window["goodput_frac"] = self._goodput.run_totals()["goodput_frac"]
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
            if a.get("profile") and self._profiler is not None and mesh.is_primary():
                # the steps that explain the breach land in a capture
                self._profiler.arm(f"alert_{a['rule']}")
        if self._exporter is not None:
            self._export_live(force=True)

    def _observe_health(self, epoch: int, step, m: dict) -> None:
        """The health layer over the metrics the loop already fetched
        (``tpu_dist/train/trainer.py:1992-2103``), with no device traffic
        of its own: a ``device_stats`` history record (with
        ``device_metrics``), the exporter's ``device.*`` rollup, the
        step-grain alert rules, and the anomaly detector, whose findings
        become a rank-0 warning, an ``anomaly`` history record and ring
        entry, the ``anomaly.findings`` counter, an armed capture (rank 0,
        ``profile_trigger`` anomaly) and, under ``anomaly_action
        snapshot``, a synchronous plain save off the ``ckpt_`` namespace.
        The fed values are the same on every rank and the detector is
        deterministic, so every rank takes the same snapshot branch. The
        JAX trainer's per-step TensorBoard scalars wait for
        ``tensorboard_dir`` (ROADMAP Queue A 4)."""
        cfg, history = self.cfg, self._history
        if history is not None and "grad_norm" in m:
            history.log("device_stats", epoch=epoch, step=step,
                        **{k: m[k] for k in step_lib.DEVICE_STATS if k in m})
        if self._exporter is not None:
            for k in ("grad_norm", "param_norm", "update_ratio"):
                if k in m:
                    self._export_rollup[f"device.{k}"] = m[k]
        if self._alerts is not None:  # the step-fetch grain rules
            fired = self._alerts.observe(m)
            if fired:
                self._fire_alerts(fired, epoch, step)
        if self._anomaly is None:
            return
        findings = self._anomaly.observe(epoch=epoch, step=step, loss=m.get("loss"),
                                         grad_norm=m.get("grad_norm"),
                                         nonfinite=m.get("nonfinite_grads"))
        for f in findings:
            rank0_print(f"WARNING: anomaly {f['anomaly']} at epoch {epoch} step {step}: value "
                        f"{f.get('value')}"
                        + (f" = {f['ratio']}x the rolling median {f['median']}"
                           if f.get("ratio") is not None else ""))
            if history is not None:
                history.log("anomaly", **f)
            if self._flight is not None:
                self._flight.record("anomaly", anomaly=f["anomaly"], epoch=epoch, step=step)
            counters.inc("anomaly.findings")
            if (self._profiler is not None and "anomaly" in self._profile_triggers
                    and mesh.is_primary()):
                # the next steps, which tell data from numerics, land in a
                # bounded capture
                self._profiler.arm(f"anomaly_{f['anomaly']}")
            if (cfg.anomaly_action == "snapshot" and cfg.ckpt_dir
                    and f["anomaly"] in ("loss_spike", "grad_norm_explosion")):
                # the spike kinds fire on finite values only, so the state
                # is safe to publish; off the ckpt_ namespace, no resume
                # picks it and no pruning removes it. Synchronous even
                # under async_ckpt: a rare forensic event
                extra = {**self._ckpt_meta(), "anomaly": f["anomaly"]}
                if step is not None:
                    extra.update(self._mid_epoch_position(step + 1))
                stem = f"anomaly_{epoch}" + (f"_s{step + 1}" if step is not None else "")
                with self._goodput.timed("ckpt"):
                    if cfg.sharded_ckpt:
                        ckpt_lib.save_sharded(cfg.ckpt_dir, self.state, epoch, extra_meta=extra,
                                              stem=stem)
                    else:
                        ckpt_lib.save(cfg.ckpt_dir, self.state, epoch, extra_meta=extra,
                                      name=f"{stem}.npz")
                counters.inc("anomaly.snapshots")
                rank0_print(f"=> anomaly snapshot written ({stem}, epoch {epoch}"
                            + (f" step {step + 1}" if step is not None else "")
                            + ") — pre-divergence state preserved off the resume namespace")

    def _note_profile_event(self, ev: dict, epoch: int, step) -> None:
        """A capture window opened, closed or failed: a rank-0 line and a
        ``profile`` history record; a stop's analysis goes on to
        :meth:`_note_capture_analysis`."""
        ev = dict(ev)
        analysis = ev.pop("analysis", None)
        analysis_error = ev.pop("analysis_error", None)
        if ev.get("event") == "start":
            rank0_print(f"=> profiler capture started ({ev.get('reason')}) at epoch {epoch} "
                        f"step {step} — {ev.get('window_steps')} step window → {ev.get('dir')}")
        elif ev.get("event") == "stop":
            rank0_print(f"=> profiler capture done ({ev.get('reason')}, {ev.get('steps')} "
                        f"step(s)) → {ev.get('dir')}")
        else:
            rank0_print(f"WARNING: profiler capture failed ({ev.get('reason')}): "
                        f"{ev.get('error')} — triggered profiling disabled for this run")
        if self._history is not None:
            self._history.log("profile", epoch=epoch, **ev)
        if ev.get("event") == "stop":
            self._note_capture_analysis(analysis, analysis_error, epoch=epoch,
                                        reason=ev.get("reason"), capture_dir=ev.get("dir"),
                                        steps=ev.get("steps"))

    def _note_capture_analysis(self, analysis, error, *, epoch: int, reason, capture_dir,
                               steps) -> None:
        """The read-back of a capture (``obs/xprof.py``): the cost model's
        ``cost.calibration_*`` gauges, a rank-0 attribution line and a
        ``profile_analysis`` history record, then the drift of the step's
        priced time from its measured one (``plan.planner_error_frac`` and a
        ``plan`` record, priced from this run's ``step_cost``: the port has
        no planner); a failed analysis (counted by the hook) a warning and a
        record with its error, never an exception."""
        if analysis is None:
            if error:
                rank0_print(f"WARNING: capture analysis failed ({reason}): {error}")
                if self._history is not None:
                    self._history.log("profile_analysis", epoch=epoch, reason=reason,
                                      dir=capture_dir, error=error)
            return
        # the capture is this process's card: price the card's share of the
        # step (the count is the step's total across ranks); peak 0.0 is
        # the CPU's none
        card = {k: v / self.n_devices if v else v for k, v in (self._step_cost or {}).items()}
        cal = costmodel.calibration(card, analysis, steps=steps, n_devices=1,
                                    peak=self._peak or 0.0)
        if cal:
            costmodel.publish_calibration(cal)
        rank0_print(f"=> capture analysis ({reason}): " + xprof_lib.summary_line(analysis))
        if self._history is not None:
            rec = dict(analysis)
            if cal:
                rec["calibration"] = cal
            if steps is not None:
                rec["steps"] = steps
            self._history.log("profile_analysis", epoch=epoch, reason=reason,
                              dir=capture_dir, **rec)
        busy = analysis.get("device_busy_s")
        if not (steps and isinstance(busy, (int, float)) and busy > 0 and self._step_cost):
            return
        achieved = busy / steps
        pred = costmodel.predicted_step_time(card, n_devices=1, peak=self._peak or 0.0)
        predicted = pred.get("predicted_step_s") if pred else None
        err = costmodel.planner_error_frac(predicted, achieved)
        if err is None:
            return
        counters.set_gauge("plan.planner_error_frac", err)
        rank0_print(f"=> planner drift (TD119): predicted {predicted:g}s vs achieved "
                    f"{achieved:g}s per step — planner_error_frac={err:.4f} [step_cost]")
        if self._history is not None:
            self._history.log("plan", epoch=epoch, family=None, mode=None,
                              predicted_step_s=predicted,
                              achieved_step_s=float(f"{achieved:.4g}"),
                              planner_error_frac=err, prediction_source="step_cost")

    def _drain_spans(self, history: MetricsHistory, epoch: int) -> None:
        """Move the epoch's host spans out of the recorder: into a ``spans``
        history record (``log_file``) and the ``trace_file`` accumulator,
        capped at the recorder's ``MAX_EVENTS``: a long run keeps its
        earliest events and counts the rest in
        ``spans.trace_export_dropped``."""
        if not spans.enabled():
            return
        ev = spans.drain()
        if not ev:
            return
        if self.cfg.log_file:
            history.log("spans", epoch=epoch, events=ev)
        if self.cfg.trace_file:
            room = spans.MAX_EVENTS - len(self._trace_events)
            if room > 0:
                self._trace_events.extend(ev[:room])
            if len(ev) > max(room, 0):
                counters.inc("spans.trace_export_dropped", len(ev) - max(room, 0))

    def _export_telemetry(self, history: MetricsHistory) -> None:
        """The end of ``fit`` for the spans (rank 0): the tail drained into
        the history, ``trace_file`` written, the recorder disarmed. A write
        that fails is reported and never masks the exception ``fit`` may be
        raising."""
        cfg = self.cfg
        try:
            self._drain_spans(history, self._last_epoch)
            if cfg.trace_file:
                spans.export_chrome_trace(cfg.trace_file, extra_events=self._trace_events)
                rank0_print(f"=> wrote host-span Chrome trace to {cfg.trace_file} "
                            f"({len(self._trace_events)} events; load in Perfetto)")
        except OSError as e:
            rank0_print(f"WARNING: telemetry export failed: {e}")
        finally:
            spans.disable()
            self._trace_events = []

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
        record and ``crash_dir``'s per-rank ``oom.json``, beside the ledger
        snapshot that was live (the first dispatch's, or the static ledger
        when the first step itself ran out)."""
        _, err, _ = sys.exc_info()
        oom = memory_lib.parse_resource_exhausted(str(err)) if err is not None else None
        if oom is None:
            return
        counters.inc("mem.oom_events")
        snap = self._mem_record or {"static": self._mem_static}
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
            run_epoch = functools.partial(self.train_epoch, epoch, start_step=start_step,
                                          start_examples=start_examples,
                                          old_world=self._resume_world)
            if cfg.profile_dir and epoch == self.start_epoch and self._profiler is None:
                # profile_dir alone: the first epoch's blanket capture, on
                # rank 0, read back as a triggered one is
                rank = mesh.process_index()
                with profile_lib.trace(cfg.profile_dir, device=self.device, rank=rank):
                    last = run_epoch()
                if rank == 0:
                    analysis, a_err = profile_lib.analyze_capture_quietly(cfg.profile_dir)
                    self._note_capture_analysis(analysis, a_err, epoch=epoch,
                                                reason="profile_dir",
                                                capture_dir=cfg.profile_dir,
                                                steps=last.get("steps"))
            else:
                last = run_epoch()
            self._progress = (epoch, 0, True)
            history.log("train_epoch", epoch=epoch, **last)
            self._drain_spans(history, epoch)
            if cfg.straggler_threshold > 0:
                # a collective at world > 1 (an all-gather of two floats a
                # rank): every rank reaches it once an epoch
                srec = straggler_lib.epoch_skew(
                    float(last.get("epoch_time", 0.0)), float(last.get("data_stall_frac", 0.0)),
                    epoch=epoch, threshold=cfg.straggler_threshold)
                if srec["straggler"]:
                    history.log("straggler", epoch=epoch, **srec)
                    if (self._profiler is not None and "straggler" in self._profile_triggers
                            and mesh.process_index() == srec["worst_rank"]):
                        # the flagged rank's next steps explain the skew
                        # (rank 0's would show it waiting in the all-reduce)
                        self._profiler.arm("straggler")
            if cfg.eval_every and (epoch + 1) % cfg.eval_every == 0:
                with self._goodput.timed("eval"):
                    if self._fused_eval is not None:
                        t1, t5, vloss = self._validate_fused(epoch)
                    else:
                        t1, t5, vloss = validate(self.test_loader, self.state, self.eval_step,
                                                 epoch=epoch)
                last.update(val_top1=t1, val_top5=t5, val_loss=vloss)
                history.log("eval", epoch=epoch, top1=t1, top5=t5, loss=vloss)
                if cfg.ckpt_dir and t1 > self._best_top1:
                    self._best_top1 = t1
                    # outside the eval's region: no second counts twice
                    with self._goodput.timed("ckpt"):
                        self._ckpt_io().save_best(cfg.ckpt_dir, self.state, epoch, t1,
                                                  extra_meta=self._ckpt_meta())
            # with mid-epoch snapshots on, every epoch end writes the clean
            # checkpoint, or a stale mid-epoch ckpt_e would stay the newest
            if cfg.ckpt_dir and ((epoch + 1) % cfg.save_every == 0
                                 or cfg.mid_epoch_save_every > 0):
                with self._goodput.timed("ckpt"):
                    self._ckpt_io().save(cfg.ckpt_dir, self.state, epoch,
                                         cfg.keep_last_ckpts, extra_meta=self._ckpt_meta())
            # the epoch's goodput window closes (train, eval, save): one
            # record an epoch, and the records chain over the run
            live = self._exporter is not None or self._alerts is not None
            if history.path or live:
                window = self._goodput.window_record()
                if history.path:
                    history.log("goodput", epoch=epoch, **window)
            if live:
                self._epoch_live_update(epoch, last)
            if self._stop_agreed():
                # SIGTERM during the eval or the save: the epoch is complete
                raise PreemptedError(f"SIGTERM observed after epoch {epoch} completed — "
                                     "shutting down at the epoch boundary")
        if cfg.ckpt_dir:
            with self._goodput.timed("ckpt"):
                self._ckpt_io().save(cfg.ckpt_dir, self.state, epochs - 1, cfg.keep_last_ckpts,
                                     extra_meta=self._ckpt_meta())
        return last  # fit() drains the async writer
