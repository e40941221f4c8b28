"""The fused epoch: the port's counterpart of ``tpu_dist/train/epoch.py``
(``put_dataset_on_device``, ``fused_steps_per_epoch``, ``make_fused_epoch``,
``make_fused_eval``).

The JAX package compiles a whole epoch into one program (a ``lax.scan``
over the steps). On a card the same idea is one training step captured in
a ``torch.cuda.CUDAGraph`` and replayed once a step: the ~1,800 kernels
of a ResNet-18 step (NCCL calls included) cost one host call instead of
one each. What the JAX runner does, this one does:

* the uint8 dataset stays on the device, each rank holding its contiguous
  slice of one global shuffle (:func:`put_dataset_on_device`);
* each epoch, a permutation of the rank's own shard and the crop offsets
  are drawn on the device (:meth:`FusedEpoch.draw`, from a
  ``torch.Generator`` seeded by ``(seed, epoch, rank)``: another stream
  than ``jax.random``'s, so the port's epochs visit the data in another
  order than the JAX package's);
* each step gathers its batch, pads it in uint8 (so the border reads
  ``(0/255 - mean)/std``, as in the numpy loader), crops, normalises into
  the compute dtype, and runs the step's body
  (:func:`~tpu_dist_torch.train.step.make_step_body`: forward, SyncBN,
  ``autograd.grad``, the gradient all-reduce, the optimizer's update, any
  of SGD, AdamW, LARS and LAMB: their norms and AdamW's and LAMB's step
  count are device tensors, captured with the step, so each replay reads
  the count as it stands), on the ``grad_compression`` wire: under the
  int8 modes the rounding draws are keyed on a step count on the device
  (the run's first step plus the step counter), so each replay draws
  what the eager step at that count draws, and under ``int8_ef`` the
  residuals of ``state.ef`` are updated in place like the momentum;
* the metrics are the epoch means of the per-step ``loss``, ``acc1`` and
  ``acc5``, kept in a device buffer and fetched by the caller once.

Drawing and running are separate (:meth:`FusedEpoch.run` takes the order
and offsets), so a test can feed the JAX package's own draws to the port.

The graph (:class:`_GraphLoop`). Every step reads its row of the order
and the offsets through a step counter on the device, which the step
advances; the learning rate, the order, the offsets and the metrics are
static device buffers. On the first call the first steps run eagerly on a
side stream (cuDNN, the NCCL communicators, the autograd streams and the
fused SGD's plan settle there), then one step is captured and replayed for
the rest of the epoch; later epochs only replay. Nothing reads the device
inside an epoch. A capture or replay that fails raises: there is no eager
fallback on a CUDA device. On the CPU the same step runs eagerly, step by
step (the tests' plain version).

Host-side counts (:mod:`tpu_dist_torch.obs.counters`, the kernels'
``launches``) run once at capture, where no kernel executes. The capture's
increments are set aside and added once a replay, so
``comm.all_reduce.grad`` and ``fused_sgd.launches`` still read one a step.

The JAX runner shuffles within each device's shard (``epoch.py:18-22``),
and so does this one.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_dist_torch.comm import collectives, mesh
from tpu_dist_torch.data.transforms import CIFAR100_MEAN, CIFAR100_STD
from tpu_dist_torch.obs import counters
from tpu_dist_torch.ops import flash_attention, fused_sgd
from tpu_dist_torch.train.state import TrainState
from tpu_dist_torch.train.step import (QUANTIZED_MODES, eval_sums, make_step_body,
                                      metrics_from_sums)

WARMUP_STEPS = 3  # eager steps on a side stream before the capture
# The NCCL watchdog thread polls the events of earlier collectives; under a
# "global" capture such a query from another thread invalidates the capture.
CAPTURE_MODE = "thread_local"
# the host-side launch counts a captured step may move, (holder, attribute)
_LAUNCH_COUNTS = (
    (fused_sgd.fused_sgd, "launches"),
    (flash_attention.flash_fwd, "launches"), (flash_attention.flash_fwd, "launches_mma"),
    (flash_attention.flash_bwd_dkdv, "launches"),
    (flash_attention.flash_bwd_dkdv, "launches_mma"),
    (flash_attention.flash_bwd_dq, "launches"), (flash_attention.flash_bwd_dq, "launches_mma"),
)


def put_dataset_on_device(images_u8: np.ndarray, labels: np.ndarray, *, world: int,
                          rank: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's share of the dataset on ``device``: one global shuffle
    (``np.random.default_rng(0)``), truncated to a multiple of ``world``,
    and the rank's contiguous slice of that order, as uint8 images and
    int64 labels. Every rank passes the same full arrays."""
    n = (len(images_u8) // world) * world
    perm = np.random.default_rng(0).permutation(len(images_u8))[:n]
    per = n // world
    sel = perm[rank * per:(rank + 1) * per]
    images = torch.from_numpy(np.ascontiguousarray(images_u8[sel], dtype=np.uint8))
    labels_t = torch.from_numpy(np.asarray(labels)[sel].astype(np.int64))
    return images.to(device), labels_t.to(device)


def fused_steps_per_epoch(dataset_len: int, global_batch: int) -> int:
    """Steps one fused epoch runs (floor division: the ragged tail batch
    is dropped)."""
    return max(1, int(dataset_len) // int(global_batch))


def normalizer(mean, std, device):
    """(mean, 1/std) as f32 tensors on ``device``, ``1/std`` rounded in f32
    as the JAX runner's ``jnp.asarray(1.0 / std, jnp.float32)``."""
    mean = np.asarray(mean, np.float32)
    std_inv = (1.0 / np.asarray(std, np.float32)).astype(np.float32)
    return torch.from_numpy(mean).to(device), torch.from_numpy(std_inv).to(device)


def _normalize(x_u8: torch.Tensor, mean: torch.Tensor, std_inv: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """``(x/255 - mean) · 1/std`` in f32, into ``dtype``."""
    return ((x_u8.float() / 255.0 - mean) * std_inv).to(dtype)


def augment(images_u8: torch.Tensor, idx: torch.Tensor, offsets: torch.Tensor, *, pad: int,
            mean: torch.Tensor, std_inv: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The batch ``images_u8[idx]`` ([B, H, W, C] uint8) zero-padded by
    ``pad`` in uint8, cropped back to H x W at ``offsets`` ([B, 2]: row,
    column, each in [0, 2·pad]) and normalised (``mean`` and ``std_inv``
    from :func:`normalizer`) into ``dtype``: the JAX runner's
    ``augment``."""
    imgs = images_u8.index_select(0, idx)
    b, h, w, _ = imgs.shape
    if pad:
        imgs = torch.nn.functional.pad(imgs, (0, 0, pad, pad, pad, pad))
    rows = offsets[:, 0, None] + torch.arange(h, device=imgs.device)
    cols = offsets[:, 1, None] + torch.arange(w, device=imgs.device)
    batch = torch.arange(b, device=imgs.device)[:, None, None]
    crop = imgs[batch, rows[:, :, None], cols[:, None, :]]
    return _normalize(crop, mean, std_inv, dtype)


def _read_launches() -> list:
    return [getattr(holder, attr, 0) for holder, attr in _LAUNCH_COUNTS]


def _add_launches(deltas: Sequence[int]) -> None:
    for (holder, attr), d in zip(_LAUNCH_COUNTS, deltas):
        if d:
            setattr(holder, attr, getattr(holder, attr, 0) + d)


class _GraphLoop:
    """``run(n)`` calls ``fn()`` (one step, which advances its own device
    counter) ``n`` times. On the CPU: eagerly. On CUDA: the first call
    runs up to ``WARMUP_STEPS`` steps eagerly on a side stream, captures
    one step in a ``CUDAGraph`` and replays it for the rest; later calls
    replay only. ``capture_s`` is the warmup plus capture time. A
    ``probe`` set before a call runs the call's first eager step as
    ``probe(fn)`` (the trainer's cost count), once; never a capture."""

    def __init__(self, fn: Callable[[], None], device: torch.device):
        self.fn, self.device = fn, device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.capture_s: Optional[float] = None
        self.probe: Optional[Callable] = None
        self._counts: dict = {}
        self._launches: list = []

    def _eager_step(self) -> None:
        probe, self.probe = self.probe, None
        if probe is None:
            self.fn()
        else:
            probe(self.fn)

    def run(self, n: int) -> None:
        if self.device.type != "cuda":
            for _ in range(n):
                self._eager_step()
            return
        done = 0
        if self.graph is None:
            t0 = time.perf_counter()
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                while done < min(WARMUP_STEPS, n):
                    self._eager_step()
                    done += 1
            torch.cuda.current_stream(self.device).wait_stream(side)
            if done == n:
                return  # an epoch no longer than the warmup needs no graph
            self._capture()
            self.capture_s = time.perf_counter() - t0
        for _ in range(n - done):
            self.graph.replay()
            counters.add_all(self._counts)
            _add_launches(self._launches)

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        before = _read_launches()
        # The garbage collector must not run inside the capture: freeing an
        # older graph there (one held in a reference cycle) is not permitted
        # while a stream captures and invalidates this capture (CUDA error
        # 901). torch.cuda.graph collects once before the capture begins.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with counters.deferred() as counts:
                with torch.cuda.graph(graph, capture_error_mode=CAPTURE_MODE):
                    self.fn()
        finally:
            if collecting:
                gc.enable()
        after = _read_launches()
        # nothing ran at capture: its launches count at each replay instead
        self._launches = [a - b for a, b in zip(after, before)]
        _add_launches([-d for d in self._launches])
        self._counts, self.graph = counts, graph


class _Runner:
    """What the two runners share: a step built over static buffers for one
    model and one dataset on the device, and the :class:`_GraphLoop` that
    runs it."""

    def __init__(self, *, batch_per_device: int, compute_dtype: torch.dtype, mean, std):
        self.batch, self.compute_dtype = int(batch_per_device), compute_dtype
        self._mean, self._std = mean, std
        self._key = None
        self._loop: Optional[_GraphLoop] = None
        # probe(step) runs the next call's first eager step (_GraphLoop.probe)
        self.probe: Optional[Callable] = None

    @property
    def capture_s(self) -> Optional[float]:
        """Seconds of the warmup and capture (None before, and on the CPU)."""
        return self._loop.capture_s if self._loop is not None else None

    def prepare(self, state: TrainState, images_u8: torch.Tensor, labels: torch.Tensor) -> None:
        """Build the step and its static buffers on the device for this
        model and dataset, if the last call did not (the first call does it
        otherwise): the normalizer's two host-to-device copies land here."""
        if self._set_up(state, images_u8, labels):
            self._build(state, images_u8, labels)

    def _set_up(self, state: TrainState, images_u8: torch.Tensor, labels: torch.Tensor) -> bool:
        """Whether the step must be built (again, with a new graph): the
        first call, or another model or dataset than the last."""
        key = (id(state.params), images_u8.data_ptr(), labels.data_ptr(),
               tuple(images_u8.shape), images_u8.device)
        if key == self._key:
            return False
        self._key = key
        return True


class FusedEpoch(_Runner):
    """The runner :func:`make_fused_epoch` returns; calling it runs one
    epoch: ``runner(state, images_u8, labels, lr, epoch) -> (state,
    metrics)`` is ``run(state, images_u8, labels, lr, *draw(epoch,
    len(images_u8), images_u8.device))``."""

    def __init__(self, optimizer, *, batch_per_device: int, sync_bn: bool,
                 compute_dtype: torch.dtype, pad: int, mean, std, pmean_fusion: str,
                 seed: int, grad_compression: str = "none", quant_chunk: Optional[int] = None):
        super().__init__(batch_per_device=batch_per_device, compute_dtype=compute_dtype,
                         mean=mean, std=std)
        self.pad, self.seed = int(pad), int(seed)
        self._keyed = grad_compression in QUANTIZED_MODES  # the step count keys the rounding
        self._body = make_step_body(optimizer, sync_bn=sync_bn, compute_dtype=compute_dtype,
                                    pmean_fusion=pmean_fusion, preempt_flag=False,
                                    grad_compression=grad_compression, quant_chunk=quant_chunk)

    def draw(self, epoch: int, n_local: int, device,
             rank: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """This epoch's ``order`` ([steps, B] int64: a permutation of the
        rank's ``n_local`` examples, cut into batches, the tail dropped)
        and crop ``offsets`` ([steps, B, 2] int64 in [0, 2·pad]), drawn on
        ``device`` from a generator seeded by (seed, epoch, rank)."""
        rank = mesh.process_index() if rank is None else rank
        steps = int(n_local) // self.batch
        gen = torch.Generator(device=device)
        gen.manual_seed(int(np.random.SeedSequence(
            (self.seed, int(epoch), int(rank))).generate_state(1, np.uint64)[0]) >> 1)
        perm = torch.randperm(int(n_local), generator=gen, device=device)
        order = perm[:steps * self.batch].view(steps, self.batch)
        offsets = torch.randint(0, 2 * self.pad + 1, (steps, self.batch, 2), generator=gen,
                                device=device)
        return order, offsets

    def __call__(self, state: TrainState, images_u8, labels, lr, epoch: int):
        return self.run(state, images_u8, labels, lr,
                        *self.draw(epoch, len(images_u8), images_u8.device))

    @property
    def step_metrics(self) -> torch.Tensor:
        """``[steps, 3]`` (loss, acc1, acc5) of every step of the last run,
        on the device."""
        return self._per_step[:self._steps].clone()

    def _build(self, state: TrainState, images_u8: torch.Tensor, labels: torch.Tensor) -> None:
        """The static buffers and the step over them."""
        dev, b = images_u8.device, self.batch
        rows = max(1, len(images_u8) // b)
        self._order = order = torch.zeros((rows, b), dtype=torch.int64, device=dev)
        self._offsets = offsets = torch.zeros((rows, b, 2), dtype=torch.int64, device=dev)
        self._counter = counter = torch.zeros((1,), dtype=torch.int64, device=dev)
        self._step0 = step0 = torch.zeros((), dtype=torch.int64, device=dev)
        self._lr = lr = torch.zeros((), dtype=torch.float32, device=dev)
        self._per_step = per_step = torch.zeros((rows, 3), dtype=torch.float32, device=dev)
        mean, std_inv = normalizer(self._mean, self._std, dev)
        body, pad, dtype, keyed = self._body, self.pad, self.compute_dtype, self._keyed

        # the step holds the buffers, not the runner: no reference cycle
        # keeps a dropped runner's graph alive until a collection
        def one_step() -> None:
            idx = order.index_select(0, counter)[0]
            offs = offsets.index_select(0, counter)[0]
            x = augment(images_u8, idx, offs, pad=pad, mean=mean, std_inv=std_inv, dtype=dtype)
            m = metrics_from_sums(body(state, x, labels.index_select(0, idx), lr,
                                       step=step0 + counter[0] if keyed else None), b)
            per_step.index_copy_(0, counter, torch.stack([m["loss"], m["acc1"], m["acc5"]])[None])
            counter.add_(1)

        self._loop = _GraphLoop(one_step, dev)

    def run(self, state: TrainState, images_u8: torch.Tensor, labels: torch.Tensor, lr,
            order: torch.Tensor, offsets: torch.Tensor):
        """Train one step per row of ``order`` ([steps, B] indices into this
        rank's ``images_u8``/``labels``) with the crops ``offsets``
        ([steps, B, 2]); updates the state in place and returns it with
        ``step`` advanced, and the epoch means (0-dim device tensors)."""
        self.prepare(state, images_u8, labels)
        steps = int(order.shape[0])
        if tuple(order.shape) != (steps, self.batch) or tuple(offsets.shape) != (
                steps, self.batch, 2) or steps > len(self._order):
            raise ValueError(f"order {tuple(order.shape)} / offsets {tuple(offsets.shape)}: "
                             f"expected [steps <= {len(self._order)}, {self.batch}(, 2)]")
        self._order[:steps].copy_(order)
        self._offsets[:steps].copy_(offsets)
        if isinstance(lr, torch.Tensor):
            self._lr.copy_(lr)
        else:
            self._lr.fill_(float(lr))
        self._counter.zero_()
        self._step0.fill_(int(state.step))
        self._steps = steps
        self._loop.probe, self.probe = self.probe, None
        self._loop.run(steps)
        means = self._per_step[:steps].mean(dim=0)
        metrics = dict(zip(("loss", "acc1", "acc5"), means))
        return dataclasses.replace(state, step=state.step + steps), metrics


def make_fused_epoch(
    optimizer,
    *,
    batch_per_device: int,
    sync_bn: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
    pad: int = 4,
    mean: np.ndarray = CIFAR100_MEAN,
    std: np.ndarray = CIFAR100_STD,
    pmean_fusion: str = "fused",
    seed: int = 0,
    grad_compression: str = "none",
    quant_chunk: Optional[int] = None,
) -> FusedEpoch:
    """Build ``epoch(state, images_u8, labels, lr, epoch_idx) -> (state,
    metrics)`` running every step of the epoch on the device, over the
    rank's data from :func:`put_dataset_on_device`. ``state.params`` is the
    model; the process group (if any) is the data-parallel world.
    ``grad_compression`` and ``quant_chunk`` are the streaming step's
    (under ``int8_ef`` ``state.ef`` holds the residuals:
    ``step.init_ef_state``)."""
    return FusedEpoch(optimizer, batch_per_device=batch_per_device, sync_bn=sync_bn,
                      compute_dtype=compute_dtype, pad=pad, mean=mean, std=std,
                      pmean_fusion=pmean_fusion, seed=seed, grad_compression=grad_compression,
                      quant_chunk=quant_chunk)


class FusedEval(_Runner):
    """The evaluator :func:`make_fused_eval` returns."""

    def _build(self, state: TrainState, images_u8: torch.Tensor, labels: torch.Tensor) -> None:
        dev, b, n, dtype = images_u8.device, self.batch, len(images_u8), self.compute_dtype
        self._counter = counter = torch.zeros((), dtype=torch.int64, device=dev)
        self._sums = sums = torch.zeros(4, dtype=torch.float32, device=dev)
        mean, std_inv = normalizer(self._mean, self._std, dev)
        lanes = torch.arange(b, device=dev)
        model = state.params

        def one_step() -> None:
            pos = counter * b + lanes
            real = pos < n
            # the scan's tail: slots past the end repeat the last example,
            # masked out like the label -1 padding of the dataset
            idx = torch.clamp(pos, max=n - 1)
            x = _normalize(images_u8.index_select(0, idx), mean, std_inv, dtype)
            y = labels.index_select(0, idx)
            mask = (real & (y >= 0)).float()
            with torch.no_grad():
                logits = model(x)
            sums.add_(eval_sums(logits, torch.clamp(y, min=0), mask))
            counter.add_(1)

        self._loop = _GraphLoop(one_step, dev)

    def __call__(self, state: TrainState, images_u8: torch.Tensor,
                 labels: torch.Tensor) -> dict:
        """``{loss, top1, top5, count}``: global sums over every rank's
        examples whose label is >= 0 (0-dim f32 device tensors; one
        all-reduce)."""
        model = state.params
        was_training = model.training
        model.eval()
        try:
            self.prepare(state, images_u8, labels)
            self._counter.zero_()
            self._sums.zero_()
            self._loop.run(-(-len(images_u8) // self.batch))
        finally:
            model.train(was_training)
        sums = collectives.all_reduce_(self._sums.clone(), kind="eval")
        return dict(zip(("loss", "top1", "top5", "count"), sums))


def make_fused_eval(
    *,
    batch_per_device: int,
    compute_dtype: torch.dtype = torch.bfloat16,
    mean: np.ndarray = CIFAR100_MEAN,
    std: np.ndarray = CIFAR100_STD,
) -> FusedEval:
    """Build ``eval(state, images_u8, labels) -> {loss, top1, top5, count}``
    over the rank's test set on the device (from
    :func:`put_dataset_on_device`): ``ceil(n / B)`` batches, normalised on
    the device, slots past the end and labels < 0 masked out, so every real
    example counts exactly once. To round a test set up to a multiple of
    the world, pad it with label -1 before placing it, as the JAX trainer
    does."""
    return FusedEval(batch_per_device=batch_per_device, compute_dtype=compute_dtype,
                     mean=mean, std=std)
