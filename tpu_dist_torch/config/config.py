"""The training configuration and its flags: the port's own copy of
``tpu_dist/config/config.py`` (``TrainConfig``, ``add_reference_flags``,
``config_from_args``), so every flag of the JAX trainer parses.

What differs:

* ``device`` (default ``"cuda"``; ``"cpu"`` runs on the CPU with gloo) is
  new; ``--ip/--port`` are the process group's rendezvous address
  (``MASTER_ADDR``/``MASTER_PORT`` win where a launcher sets them).
* ``--backend`` takes ``nccl`` (CUDA) or ``gloo`` (CPU) and must agree
  with ``--device``; the JAX package's ``xla`` is refused.

A flag whose subsystem is not ported yet still parses; the trainer refuses
it with ``NotPortedError`` (``tpu_dist_torch/train/trainer.py::UNPORTED``)
instead of ignoring it.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

from tpu_dist_torch.comm.mesh import backend_for


@dataclass
class TrainConfig:
    # -- reference flags (distributed.py:18-25) -----------------------------
    device: str = "cuda"           # cuda (one card per process, NCCL) | cpu (gloo)
    batch_size: int = 256          # GLOBAL batch; per-replica = batch_size / n_devices
    epochs: int = 200
    lr: float = 0.1
    seed: Optional[int] = None     # per-rank seeding when set (distributed_mp.py:29-39)
    ip: str = "127.0.0.1"          # coordinator host (was hard-coded 10.24.82.29)
    port: int = 23456              # coordinator port
    grad_accu_steps: int = 1       # distributed_gradient_accumulation.py:26

    # -- optimizer / schedule (hard-coded in the reference) -----------------
    optimizer: str = "sgd"         # sgd (reference, distributed.py:63) |
                                   # adamw | lars | lamb (large-batch
                                   # trust-ratio recipes, train/optim.py)
    momentum: float = 0.9          # distributed.py:63 (sgd/lars)
    weight_decay: float = 1e-4     # distributed.py:63
    adamw_decay_mask: str = "auto" # auto: skip rank<=1 leaves | all: decay every leaf
    lr_schedule: str = "multistep" # multistep (reference) | cosine
    lr_milestones: Tuple[int, ...] = (60, 120, 160)  # distributed.py:64
    lr_gamma: float = 0.2          # distributed.py:64
    warmup_epochs: int = 0         # linear LR warmup epochs (both schedules)
    lr_base_batch: int = 0         # Goyal linear-scaling rule: when > 0,
                                   # lr is scaled by batch_size/lr_base_batch
                                   # (optim.linear_scaled_lr — the
                                   # large-batch LARS/LAMB recipe)
    label_smoothing: float = 0.0
    grad_clip_norm: float = 0.0    # 0 = off; global-norm clip of reduced grads

    # -- switches that replace whole reference scripts -----------------------
    bf16: bool = False             # apex AMP path (distributed_apex.py) → bf16 policy
    sync_bn: bool = True           # SyncBN on by default (README.md:62)
    drop_last: bool = False        # grad-accum path uses True (…accumulation.py:71)

    # -- data ---------------------------------------------------------------
    dataset: str = "cifar100"      # cifar100 | cifar10 | synthetic
    data_dir: str = "./data"
    synthetic_n: int = 50_000      # synthetic train-set size (tests/smokes)
    num_workers: int = 4           # loader prefetch depth (passed to DataLoader)

    # -- model --------------------------------------------------------------
    model: str = "resnet18"        # resnet18 | resnet34 | resnet50 | vit_b16
    num_classes: int = 100

    # -- multi-host ---------------------------------------------------------
    num_processes: Optional[int] = None
    process_id: Optional[int] = None

    # -- mesh shape ----------------------------------------------------------
    sp: int = 1                    # sequence-parallel ways (DPxSP mesh);
                                   # model must support seq_axis (ViT)
    sp_mode: str = "ring"          # 'ring' (ppermute K/V rotation) or
                                   # 'ulysses' (all_to_all tokens<->heads)
    tp: int = 1                    # tensor-parallel ways (DPxTP mesh);
                                   # model must support tp_axis (ViT)
    ep: int = 1                    # expert-parallel ways (DPxEP mesh);
                                   # model must support ep_axis (ViT-MoE)
    moe_top_k: int = 1             # experts per token (1=Switch, 2=GShard)
    moe_aux_coef: float = 0.01     # router load-balancing loss coefficient
    pp: int = 1                    # pipeline-parallel stages (DPxPP mesh);
                                   # model must support pp_axis (ViT-PP)
    pp_microbatches: int = 0       # 0 = one microbatch per stage
    pp_interleave: int = 1         # virtual stages per device (Megatron
                                   # interleaved schedule: bubble shrinks
                                   # (S-1)/(M+S-1) -> (S-1)/(vM+S-1))

    # -- checkpoint / eval cadence -----------------------------------------
    ckpt_dir: Optional[str] = None
    save_every: int = 15           # dead utils/config.py:7 'save_epoch', made real
    keep_last_ckpts: Optional[int] = None  # prune to N newest (None = keep all)
    mid_epoch_save_every: int = 0  # >0: periodic EXACT snapshots every N steps
                                   # inside an epoch (kill-9 safety for long
                                   # epochs; resume re-enters at the batch)
    resume: bool = False
    async_ckpt: bool = False       # overlap ckpt writes with training
                                   # (ckpt/checkpoint.py::AsyncCheckpointer;
                                   # with --sharded_ckpt: the snapshot-then-
                                   # write AsyncShardedCheckpointer)
    ckpt_drain_timeout_s: float = 120.0  # bounded drain of in-flight async
                                   # ckpt writes at fit end / interrupt;
                                   # expiry abandons them LOUDLY (counted
                                   # as ckpt.drain_abandoned); <=0 = wait
                                   # forever
    eval_every: int = 1
    log_every: int = 20
    log_file: Optional[str] = None # JSONL metrics history (rank 0)
    tensorboard_dir: Optional[str] = None  # the reference's dead
                                   # utils/config.py:8 knob, made real
                                   # (metrics/tensorboard.py, rank 0)

    # -- run telemetry (docs/observability.md) ------------------------------
    trace_file: Optional[str] = None  # Chrome trace-event JSON of host
                                   # spans (ckpt/loader/eval/dispatch),
                                   # Perfetto-loadable; rank 0. Spans are
                                   # also armed when log_file is set (they
                                   # ride the JSONL as 'spans' records)
    heartbeat_file: Optional[str] = None  # per-process liveness file (rank
                                   # 0 the bare path, rank k .h<k>) updated
                                   # at the step grain (monotonic counter +
                                   # epoch/step); swept on clean exit —
                                   # external watchdogs distinguish a hung
                                   # step from a slow one
    straggler_threshold: float = 1.5  # epoch-end max/median skew of the
                                   # allgathered per-process epoch times
                                   # above which a rank-0 straggler warning
                                   # (+ history record) fires; 0 disables
    device_metrics: bool = False   # in-step health scalars (global grad
                                   # norm, param norm, update ratio,
                                   # nonfinite-leaf count) computed in the
                                   # step after the gradient reduce — no
                                   # extra collective or fetch
                                   # (obs/device_stats.py). Replicated-
                                   # param paths only (no zero1/fsdp/
                                   # tp/ep/pp/fused_epoch)
    anomaly_action: str = "warn"   # off | warn | snapshot — response to a
                                   # rolling-window loss-spike/grad-norm
                                   # anomaly (obs/anomaly.py): warn logs a
                                   # rank-0 warning + 'anomaly' history
                                   # record; snapshot additionally writes
                                   # an exact mid-epoch checkpoint
    anomaly_window: int = 50       # rolling-median window (observations at
                                   # the log cadence)
    anomaly_loss_spike: float = 3.0   # loss > X * rolling median => anomaly
    anomaly_grad_spike: float = 10.0  # grad_norm > X * rolling median
                                   # (needs --device_metrics for the norm)
    metrics_file: Optional[str] = None  # live OpenMetrics textfile
                                   # (node-exporter textfile-collector
                                   # format), written atomically at the
                                   # heartbeat's step-grain throttle;
                                   # per-rank derived path like the
                                   # heartbeat (obs/export.py)
    metrics_port: int = 0          # rank-0-only background HTTP /metrics
                                   # endpoint serving the last rendered
                                   # snapshot (never touches jax state
                                   # from the serving thread); 0 disables
    alert_rules: Optional[str] = None  # declarative threshold alerting:
                                   # 'default' (built-in library) or a
                                   # TOML/JSON rule-spec path — fired
                                   # rules emit 'alert' history records,
                                   # rank-0 warnings, exporter gauge
                                   # flips, and optionally arm the
                                   # triggered profiler (obs/alerts.py)
    crash_dir: Optional[str] = None  # crash-forensics dir (docs/
                                   # observability.md "Crash forensics"):
                                   # per-rank SIGKILL-surviving flight-
                                   # recorder ring (flight.ring[.h<k>],
                                   # fixed-slot atomic writes at the step
                                   # grain) + faulthandler stack-dump
                                   # file (stacks.txt[.h<k>]: hard-fault
                                   # tracebacks, SIGUSR1 on-demand
                                   # all-threads dumps); read back by
                                   # `python -m tpu_dist.obs postmortem`
    memory_check: str = "warn"     # off | warn | refuse — pre-flight HBM
                                   # feasibility lint (obs/memory.py):
                                   # the static per-leaf ledger (params/
                                   # opt-state/EF/BN/batch at sharded
                                   # extents) is priced against the
                                   # per-chip HBM budget BEFORE the
                                   # first compile; 'refuse' raises
                                   # InfeasibleMemoryError, 'warn'
                                   # prints. Unknown chips (CPU
                                   # emulation) skip the check unless
                                   # hbm_budget_bytes overrides
    memory_headroom: float = 0.9   # fraction of the per-chip budget the
                                   # STATIC estimate may claim — the
                                   # rest is reserved for XLA temps/
                                   # workspace the ledger cannot see
    hbm_budget_bytes: Optional[int] = None  # per-device HBM budget
                                   # override (default: the chip table,
                                   # costmodel.CHIP_HBM_BYTES); lets CPU
                                   # tests and exotic parts drive the
                                   # feasibility lint
    per_host_log: bool = False     # every process writes its own JSONL
                                   # history (<log_file>.h<rank>; rank 0
                                   # keeps the bare path) so `obs pod`
                                   # can merge a cross-host view
    profile_trigger: str = "off"   # off | auto | comma list of
                                   # anomaly,straggler,retrace — arm a
                                   # bounded torch.profiler capture when
                                   # the health signal fires; retrace
                                   # parses but never arms (eager torch
                                   # does not retrace) (obs/profile.py;
                                   # needs profile_dir)
    profile_steps: Optional[str] = None  # "a:b": manual capture of global
                                   # steps [a, b) (needs profile_dir;
                                   # replaces the epoch-0 blanket trace)
    profile_window: int = 8        # steps per triggered capture
    profile_cooldown: int = 200    # min steps between triggered captures
    profile_max_captures: int = 3  # triggered-capture cap per process

    # -- fast paths and sharding (the trainer refuses the unported ones) -----
    fused_epoch: bool = False      # device-resident data, one jit per epoch
                                   # (docs in train/epoch.py; small datasets)
    shard_weight_update: bool = False  # ZeRO-1 weight-update sharding
                                       # (arXiv:2004.13336; train/step.py)
    fsdp: bool = False             # fully-sharded (ZeRO-3) params+momentum
                                   # via GSPMD (parallel/fsdp.py)
    fused_optimizer: bool = False  # the CUDA fused SGD kernel (ops/fused_sgd.py)
    flash_attention: bool = False  # the CUDA flash attention kernels
                                   # (ops/flash_attention.py) for the ViTs
    remat: bool = False            # recompute the forward in the backward
                                   # (torch.utils.checkpoint; less memory)
    grad_compression: str = "none" # none | bf16 | int8 | int8_ef: gradient
                                   # wire format for the cross-replica reduce
                                   # (DDP comm-hook equivalent). bf16 halves
                                   # grad ICI/DCN traffic; int8 quarters it
                                   # (per-chunk scales, stochastic rounding,
                                   # two-stage quantized RS+AG); int8_ef adds
                                   # error-feedback residuals in TrainState
                                   # (docs/compression.md)
    quant_chunk: int = 0           # elements per int8 quantization scale
                                   # (0 = comm/quantize.DEFAULT_CHUNK); a
                                   # tune-overlap schedule knob — payload
                                   # bytes are chunk-invariant (TD121)
    pmean_fusion: str = "fused"    # fused | per_leaf: one multi-operand grad
                                   # pmean vs one per leaf — schedule-only
                                   # overlap knob (analysis/overlap.py)
    rs_ag_chunks: int = 1          # split the ZeRO-1 reduce-scatter/all-
                                   # gather pair into k pipelined column-
                                   # group collectives (payload-identical;
                                   # tune-overlap's zero1 knob)
    tune_report: str = ""          # path to a tune_report.json (make
                                   # tune-overlap): apply the tuner's chosen
                                   # schedule knobs for this config's family
                                   # (explicit knob flags win over the report)
    sharded_ckpt: bool = False     # per-process shard files + rank-0 manifest;
                                   # no gather at save time (FSDP/ZeRO scale)
    auto_shard: str = "off"        # off | plan | apply — run the static
                                   # sharding planner (analysis/planner.py)
                                   # at startup: enumerate the shardlint
                                   # family matrix, price each with the
                                   # calibrated cost model, refuse HBM-
                                   # infeasible configs through the
                                   # --memory_check path, print the ranked
                                   # table. 'apply' additionally rewrites
                                   # this config to the chosen plan's
                                   # family (docs/planner.md)

    # -- resilience (docs/resilience.md) ------------------------------------
    ckpt_verify: bool = True       # CRC32-verify checkpoints at restore and
                                   # walk newest→oldest past quarantined
                                   # (*.corrupt) files instead of raising
    ckpt_io_retries: int = 2       # transient ckpt-write retries (exponential
                                   # backoff, deterministic delays; 0 = off)
    fault_plan: Optional[str] = None  # deterministic fault-injection spec
                                   # (chaos testing; env TPU_DIST_FAULT_PLAN
                                   # when unset — resilience/faults.py)

    # -- bench / smoke / debug ---------------------------------------------
    steps_per_epoch: Optional[int] = None  # cap steps (smoke tests / benches)
    debug_replica_check: bool = False  # assert params replicated each epoch
    profile_dir: Optional[str] = None  # capture a torch.profiler trace of epoch 0
    nan_guard: bool = True         # raise TrainingDivergedError on NaN loss
    auto_recover: int = 0          # divergence responses: reload last ckpt +
                                   # LR backoff, up to N times (0 = just raise)
    recover_lr_factor: float = 0.5 # schedule scale applied per recovery
    compile_cache_dir: Optional[str] = None  # persistent XLA compile cache:
                                   # repeat invocations of the same config
                                   # skip the cold first-compile. NOTE:
                                   # applied as PROCESS-GLOBAL jax.config
                                   # state (XLA's cache is per-process) —
                                   # it persists for later Trainers in the
                                   # same process

    @property
    def coordinator_address(self) -> str:
        return f"{self.ip}:{self.port}"

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def add_reference_flags(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    d = TrainConfig()
    p.add_argument("--device", type=str, default=d.device,
                   help="cuda (one card per process, NCCL) or cpu (gloo)")
    p.add_argument("--batch_size", "--batch-size", type=int, default=d.batch_size,
                   help="GLOBAL batch size (split across data-parallel devices)")
    p.add_argument("--epochs", type=int, default=d.epochs)
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--seed", type=int, default=None,
                   help="deterministic seeding (reference init_seeds semantics)")
    p.add_argument("--ip", type=str, default=d.ip,
                   help="multi-host coordinator address (reference --ip)")
    p.add_argument("--port", type=int, default=d.port)
    p.add_argument("--grad_accu_steps", type=int, default=d.grad_accu_steps,
                   help="gradient accumulation sub-steps (no_sync semantics)")
    p.add_argument("--optimizer", choices=("sgd", "adamw", "lars", "lamb"),
                   default=d.optimizer,
                   help="sgd (reference parity), adamw (decoupled weight "
                        "decay; the transformer default), or the large-batch "
                        "trust-ratio recipes: lars (layer-wise adaptive SGD, "
                        "conv nets at 16k+ batch) and lamb (layer-wise "
                        "AdamW, BERT-style) — pair with --lr_base_batch and "
                        "--warmup_epochs")
    p.add_argument("--momentum", type=float, default=d.momentum)
    p.add_argument("--weight_decay", type=float, default=d.weight_decay)
    p.add_argument("--adamw_decay_mask", choices=("auto", "all"),
                   default=d.adamw_decay_mask,
                   help="adamw only: 'auto' (default) skips weight decay on "
                        "rank<=1 leaves (biases/norm scales, standard "
                        "transformer practice); 'all' decays every leaf "
                        "(pre-r3 behavior — use when resuming a pre-r3 "
                        "adamw run)")
    p.add_argument("--lr_schedule", choices=("multistep", "cosine"), default=d.lr_schedule)
    p.add_argument("--lr_milestones", type=int, nargs="+",
                   default=list(d.lr_milestones), metavar="EPOCH",
                   help="multistep decay epochs (reference hard-codes "
                        "[60, 120, 160], distributed.py:64)")
    p.add_argument("--lr_gamma", type=float, default=d.lr_gamma,
                   help="multistep decay factor (reference: 0.2)")
    p.add_argument("--warmup_epochs", type=int, default=d.warmup_epochs,
                   help="linear LR warmup epochs (cosine and multistep; "
                        "mandatory half of the large-batch LARS/LAMB recipe)")
    p.add_argument("--lr_base_batch", type=int, default=d.lr_base_batch,
                   metavar="B0",
                   help="Goyal linear-scaling rule: scale --lr by "
                        "batch_size/B0 (0 = off). The other half of the "
                        "large-batch recipe")
    p.add_argument("--label_smoothing", type=float, default=d.label_smoothing)
    p.add_argument("--grad_clip_norm", type=float, default=d.grad_clip_norm,
                   help="global-norm gradient clip; 0 disables")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute policy (the apex-AMP equivalent)")
    p.add_argument("--fused_epoch", action="store_true",
                   help="device-resident data: one jit call per epoch")
    p.add_argument("--shard_weight_update", "--zero1", action="store_true",
                   help="ZeRO-1 weight-update sharding (arXiv:2004.13336), "
                        "sgd or adamw; plain-DP fast path by design — use "
                        "--fsdp for model-parallel compositions")
    p.add_argument("--fsdp", action="store_true",
                   help="fully-sharded data parallelism (ZeRO-3): params and "
                        "momentum sharded over the data axis via GSPMD")
    p.add_argument("--fused_optimizer", action="store_true",
                   help="the hand-written CUDA fused SGD kernel (one launch "
                        "over every leaf)")
    p.add_argument("--flash_attention", action="store_true",
                   help="the hand-written CUDA flash attention kernels for "
                        "the ViTs")
    p.add_argument("--remat", action="store_true",
                   help="recompute the forward in the backward "
                        "(torch.utils.checkpoint: less activation memory)")
    p.add_argument("--grad_compression",
                   choices=("none", "bf16", "int8", "int8_ef"),
                   default=d.grad_compression,
                   help="gradient wire format for the cross-replica reduce "
                        "(torch DDP communication-hook equivalent; update "
                        "math stays f32): bf16 halves gradient ICI/DCN "
                        "traffic; int8 quarters it via per-chunk scaled "
                        "stochastic-rounded quantization on BOTH legs of a "
                        "two-stage reduce-scatter + all-gather (EQuARX-"
                        "style); int8_ef adds per-replica error-feedback "
                        "residuals (carried in the TrainState, "
                        "checkpointed) so quantization error is "
                        "compensated, not accumulated. int8 modes apply to "
                        "the plain DP, fused-epoch, and ZeRO-1 paths; not "
                        "under --fsdp (GSPMD-inserted collectives) or "
                        "sp/tp/ep/pp (docs/compression.md)")
    p.add_argument("--quant_chunk", type=int, default=d.quant_chunk,
                   metavar="N",
                   help="elements per int8 quantization scale (0 = the "
                        "comm/quantize default) — a tune-overlap schedule "
                        "knob: payload bytes are chunk-invariant, only the "
                        "f32 scale sideband granularity moves (TD121)")
    p.add_argument("--pmean_fusion", choices=("fused", "per_leaf"),
                   default=d.pmean_fusion,
                   help="data-parallel grad reduce granularity: one fused "
                        "multi-operand pmean, or one pmean per gradient "
                        "leaf (schedule-only overlap knob; identical "
                        "payload bytes — analysis/overlap.py)")
    p.add_argument("--rs_ag_chunks", type=int, default=d.rs_ag_chunks,
                   metavar="K",
                   help="split the ZeRO-1 reduce-scatter/all-gather pair "
                        "into K pipelined column-group collectives "
                        "(payload-identical schedule knob; needs "
                        "--shard_weight_update)")
    p.add_argument("--tune_report", type=str, default=d.tune_report,
                   metavar="PATH",
                   help="tune_report.json from `make tune-overlap`: apply "
                        "the tuner's chosen schedule knobs for this "
                        "config's family (explicitly-set knob flags win)")
    p.add_argument("--no_sync_bn", dest="sync_bn", action="store_false",
                   help="per-replica BatchNorm statistics (SyncBN off)")
    p.add_argument("--no_nan_guard", dest="nan_guard", action="store_false")
    p.add_argument("--auto_recover", type=int, default=d.auto_recover,
                   metavar="N",
                   help="on divergence (NaN guard), reload the last "
                        "checkpoint and retry with the LR schedule scaled "
                        "by --recover_lr_factor, up to N times — a bare "
                        "retry would diverge identically (deterministic "
                        "epoch-seeded data order)")
    p.add_argument("--recover_lr_factor", type=float, default=d.recover_lr_factor)
    p.add_argument("--dataset", type=str, default=d.dataset,
                   help="cifar100 | cifar10 | synthetic")
    p.add_argument("--data_dir", type=str, default=d.data_dir)
    p.add_argument("--synthetic_n", type=int, default=d.synthetic_n,
                   help="synthetic train-set size")
    p.add_argument("--model", type=str, default=d.model,
                   help="resnet18/34/50, resnet50_imagenet, vit_b16/s16/tiny, "
                        "vit_moe_tiny, vit_pp_tiny, or a register_model name")
    p.add_argument("--num_classes", type=int, default=d.num_classes)
    p.add_argument("--num_processes", type=int, default=None,
                   help="multi-host world size (one process per host)")
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--sp", type=int, default=d.sp,
                   help="sequence-parallel ways (ring attention; ViT)")
    p.add_argument("--sp_mode", choices=("ring", "ulysses"), default=d.sp_mode,
                   help="sequence-parallel strategy: 'ring' (ppermute K/V "
                        "rotation) or 'ulysses' (all_to_all tokens<->heads; "
                        "composes with --flash_attention)")
    p.add_argument("--tp", type=int, default=d.tp,
                   help="tensor-parallel ways (Megatron; ViT); composes with --sp")
    p.add_argument("--ep", type=int, default=d.ep,
                   help="expert-parallel ways (MoE ViT)")
    p.add_argument("--moe_top_k", type=int, default=d.moe_top_k,
                   help="experts per token for MoE models (1 = Switch, "
                        "2 = GShard-style renormalized gates)")
    p.add_argument("--moe_aux_coef", type=float, default=d.moe_aux_coef,
                   help="coefficient of the MoE router load-balancing loss "
                        "(Switch Transformer aux loss); 0 disables")
    p.add_argument("--pp", type=int, default=d.pp,
                   help="pipeline stages (staged ViT)")
    p.add_argument("--pp_microbatches", type=int, default=d.pp_microbatches,
                   help="pipeline microbatches; 0 = one per stage")
    p.add_argument("--pp_interleave", type=int, default=d.pp_interleave,
                   help="virtual pipeline stages per device (interleaved "
                        "schedule; v-fold bubble reduction)")
    p.add_argument("--ckpt_dir", type=str, default=None)
    p.add_argument("--keep_last_ckpts", type=int, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--async_ckpt", action="store_true",
                   help="write checkpoints on a background thread (training "
                        "continues during the serialization); composes with "
                        "--sharded_ckpt as snapshot-then-write: the step loop "
                        "blocks only for the device→host snapshot, the "
                        "background writer owns serialize+CRC+commit")
    p.add_argument("--sharded_ckpt", action="store_true",
                   help="sharded checkpoint format: every process writes only "
                        "its own shard slices + a rank-0 manifest (commit "
                        "marker) — no allgather at save time, the FSDP/ZeRO-"
                        "scale choice; add --async_ckpt to move everything "
                        "but the snapshot off the step loop")
    p.add_argument("--ckpt_drain_timeout_s", type=float,
                   default=d.ckpt_drain_timeout_s, metavar="S",
                   help="bounded drain of in-flight async checkpoint writes "
                        "at fit end/interrupt; on expiry they are abandoned "
                        "LOUDLY (counted as ckpt.drain_abandoned) — <=0 "
                        "waits forever")
    p.add_argument("--ckpt_verify", dest="ckpt_verify", action="store_true",
                   default=d.ckpt_verify,
                   help="verify per-entry CRC32 stamps at restore and fall "
                        "back newest→oldest past corrupt checkpoints "
                        "(quarantined to *.corrupt) — the default")
    p.add_argument("--no_ckpt_verify", dest="ckpt_verify", action="store_false",
                   help="restore the newest checkpoint unverified (a corrupt "
                        "file still falls back, but silent bit-flips pass)")
    p.add_argument("--ckpt_io_retries", type=int, default=d.ckpt_io_retries,
                   metavar="N",
                   help="retry transient checkpoint-write failures "
                        "(OSError/EIO/ENOSPC-style) up to N times with "
                        "deterministic exponential backoff; 0 disables")
    p.add_argument("--fault_plan", type=str, default=d.fault_plan,
                   help="deterministic fault-injection plan for chaos "
                        "testing, e.g. 'ckpt_write@call=1:times=2;"
                        "sigterm@epoch=1:step=5' (docs/resilience.md; env "
                        "TPU_DIST_FAULT_PLAN when the flag is unset)")
    p.add_argument("--log_file", type=str, default=None,
                   help="JSONL metrics history path (rank 0)")
    p.add_argument("--tensorboard_dir", type=str, default=None,
                   help="TensorBoard event-file dir (self-contained writer, "
                        "no TF dependency; the reference's utils/config.py:8 "
                        "knob made functional)")
    p.add_argument("--trace_file", type=str, default=None,
                   help="write host-span Chrome trace-event JSON here at "
                        "the end of the run (Perfetto / chrome://tracing "
                        "loadable; rank 0 — docs/observability.md)")
    p.add_argument("--heartbeat_file", type=str, default=None,
                   help="per-process liveness file rewritten at the step "
                        "grain (rank 0 the bare path, rank k .h<k>; "
                        "monotonic beat counter + epoch/step position), "
                        "swept on clean exit — lets an external watchdog "
                        "tell a hung step from a slow one")
    p.add_argument("--straggler_threshold", type=float,
                   default=d.straggler_threshold, metavar="X",
                   help="warn (rank 0) + log a history record when the "
                        "slowest process's epoch time exceeds X times the "
                        "median across processes (allgathered at epoch "
                        "end); 0 disables")
    p.add_argument("--device_metrics", action="store_true",
                   help="compute in-step training-health scalars (global "
                        "grad norm, param norm, update ratio, nonfinite-"
                        "leaf count) inside the step, after the gradient "
                        "reduce — no extra collective and no extra "
                        "per-step fetch. Replicated-param paths only")
    p.add_argument("--anomaly_action", choices=("off", "warn", "snapshot"),
                   default=d.anomaly_action,
                   help="response to a rolling-window loss-spike/grad-norm "
                        "anomaly: 'warn' (default) logs a rank-0 warning + "
                        "history record; 'snapshot' additionally writes an "
                        "exact mid-epoch checkpoint (the emergency-snapshot "
                        "discipline) before the run can diverge further; "
                        "'off' disables detection")
    p.add_argument("--anomaly_window", type=int, default=d.anomaly_window,
                   metavar="N",
                   help="rolling-median window of the anomaly detector, in "
                        "observations at the --log_every cadence")
    p.add_argument("--anomaly_loss_spike", type=float,
                   default=d.anomaly_loss_spike, metavar="X",
                   help="flag a loss above X times the rolling median")
    p.add_argument("--anomaly_grad_spike", type=float,
                   default=d.anomaly_grad_spike, metavar="X",
                   help="flag a grad norm above X times the rolling median "
                        "(grad norms need --device_metrics)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="torch.profiler output dir: alone, captures epoch 0 "
                        "(read it with obs xprof); with --profile_trigger/"
                        "--profile_steps, holds their bounded capture "
                        "windows instead")
    p.add_argument("--metrics_file", type=str, default=None,
                   help="live OpenMetrics/Prometheus textfile (node-"
                        "exporter textfile-collector format): counters, "
                        "epoch rollup, goodput and alert gauges, written "
                        "atomically at the heartbeat's step-grain throttle "
                        "(rank 0 the bare path, rank k .h<k> — "
                        "docs/observability.md)")
    p.add_argument("--metrics_port", type=int, default=d.metrics_port,
                   help="serve the same exposition on a rank-0-only "
                        "background HTTP /metrics endpoint (stdlib, "
                        "serves the last snapshot — a scrape can never "
                        "stall a step); 0 disables")
    p.add_argument("--alert_rules", type=str, default=None,
                   help="declarative threshold alerting: 'default' (the "
                        "built-in library: stall/MFU/goodput/grad-norm/"
                        "heartbeat/retrace rules) or a TOML/JSON spec "
                        "path (metric, comparator, threshold, sustain-"
                        "for-N-windows, cooldown). Fired rules emit "
                        "'alert' history records, rank-0 warnings, and "
                        "alert_active exporter gauges; rules with "
                        "profile=true arm the triggered profiler")
    p.add_argument("--crash_dir", type=str, default=None,
                   help="crash-forensics directory: every rank writes a "
                        "SIGKILL-surviving flight-recorder ring "
                        "(fixed-slot atomic writes — step boundaries, "
                        "span opens, ckpt/alert/anomaly/resume events, "
                        "counter deltas, a fatal slot from the excepthook "
                        "wrappers) plus a faulthandler stack-dump file "
                        "(hard faults; SIGUSR1 dumps all threads on "
                        "demand, the launcher watchdog's stack-capture "
                        "channel). Assemble with `python -m tpu_dist.obs "
                        "postmortem <dir>` (docs/observability.md)")
    p.add_argument("--memory_check", type=str, default=d.memory_check,
                   choices=("off", "warn", "refuse"),
                   help="pre-flight HBM feasibility lint: price the "
                        "static per-leaf memory ledger (params/opt-state/"
                        "EF/BN/batch, sharded extents) against the "
                        "per-chip HBM budget BEFORE the first compile; "
                        "'refuse' stops an infeasible config, 'warn' "
                        "prints (docs/observability.md)")
    p.add_argument("--memory_headroom", type=float,
                   default=d.memory_headroom, metavar="FRAC",
                   help="fraction of the per-chip HBM budget the static "
                        "estimate may claim (rest reserved for XLA "
                        "temps/workspace)")
    p.add_argument("--hbm_budget_bytes", type=int, default=None,
                   help="per-device HBM budget override in bytes "
                        "(default: the chip table — "
                        "obs/costmodel.CHIP_HBM_BYTES)")
    p.add_argument("--auto_shard", choices=("off", "plan", "apply"),
                   default=d.auto_shard,
                   help="static sharding planner at startup "
                        "(analysis/planner.py): enumerate the shardlint "
                        "family matrix, price each candidate with the "
                        "calibrated cost model + HLO wire bytes, refuse "
                        "HBM-infeasible ones through the --memory_check "
                        "path, and print the ranked plan (also lands in "
                        "the history as a 'plan' record, TD119-gated). "
                        "'apply' rewrites this config to the winning "
                        "family's flags before training (docs/planner.md)")
    p.add_argument("--per_host_log", action="store_true",
                   help="every process writes its own JSONL history "
                        "(<log_file>.h<rank>; rank 0 keeps the bare path) "
                        "so `python -m tpu_dist.obs pod` can merge the "
                        "cross-host view (docs/observability.md)")
    p.add_argument("--profile_trigger", type=str, default=d.profile_trigger,
                   help="arm a bounded on-device profiler capture when a "
                        "health signal fires: 'auto' (all), or a comma "
                        "list of anomaly,straggler,retrace; 'off' (the "
                        "default) disables. Anomaly captures run on rank "
                        "0; straggler captures on the flagged rank; "
                        "retrace never arms in eager torch. Needs "
                        "--profile_dir; bounded by "
                        "--profile_window/cooldown/max_captures")
    p.add_argument("--profile_steps", type=str, default=None, metavar="A:B",
                   help="manually capture global steps [A, B) to "
                        "--profile_dir (replaces the epoch-0 blanket "
                        "trace that --profile_dir alone takes)")
    p.add_argument("--profile_window", type=int, default=d.profile_window,
                   help="steps per triggered profiler capture")
    p.add_argument("--profile_cooldown", type=int,
                   default=d.profile_cooldown,
                   help="minimum steps between triggered captures")
    p.add_argument("--profile_max_captures", type=int,
                   default=d.profile_max_captures,
                   help="cap on triggered captures per process (an anomaly "
                        "storm must not trace the whole run)")
    p.add_argument("--eval_every", type=int, default=d.eval_every,
                   help="epochs between evaluations; 0 disables")
    p.add_argument("--save_every", type=int, default=d.save_every)
    p.add_argument("--mid_epoch_save_every", type=int,
                   default=d.mid_epoch_save_every,
                   help="periodic exact mid-epoch snapshots every N steps "
                        "(0 = off); resume continues at the exact batch — "
                        "kill-9 safety for long epochs")
    p.add_argument("--steps_per_epoch", type=int, default=None,
                   help="cap steps per epoch (smokes/benches)")
    p.add_argument("--log_every", type=int, default=d.log_every)
    p.add_argument("--compile_cache_dir", type=str, default=None,
                   help="persistent XLA compile-cache dir (repeat runs skip "
                        "the cold first compile)")
    # accepted for command-line parity with torch.distributed.launch; unused
    p.add_argument("--local_rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--gpu", type=str, default=None, help=argparse.SUPPRESS)
    p.add_argument(
        "--backend", choices=("xla", "nccl", "gloo", "mpi"), default=None,
        help="process group backend: nccl for --device cuda, gloo for "
             "--device cpu (the default follows --device)",
    )
    return p


def config_from_args(args: argparse.Namespace, **overrides) -> TrainConfig:
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    kw = {k: v for k, v in vars(args).items() if k in fields}
    if "lr_milestones" in kw:  # argparse nargs gives a list; config is a tuple
        kw["lr_milestones"] = tuple(kw["lr_milestones"])
    kw.update(overrides)
    cfg = TrainConfig(**kw)
    backend = getattr(args, "backend", None)
    want = backend_for(cfg.device)
    if backend is not None and backend != want:
        raise SystemExit(
            f"--backend {backend} does not fit --device {cfg.device}: the port runs "
            f"{want} there (nccl on CUDA cards, gloo on the CPU)"
        )
    return cfg
