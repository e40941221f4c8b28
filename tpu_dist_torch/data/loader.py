"""Batched, prefetching feeder for one rank: the port's counterpart of
``tpu_dist/data/loader.py`` (``DataLoader``, ``LoaderProducerDiedError``).

* :meth:`DataLoader._host_batches` is the JAX loader's, line for line:
  the sampler's indices in batches of ``batch_size`` (the per-rank
  batch), a last partial batch padded with wrap-around samples from the
  start of the rank's epoch stream, and each batch's augmentation seeded
  by ``np.random.default_rng((seed, epoch, shard_id, batch))``, the
  sampler's shard: the rank, or under sequence parallelism the data
  index, so every rank of a seq group draws the same examples and crops.
* :meth:`DataLoader.iter_from` starts the epoch at a given batch (the
  exact mid-epoch resume); ``iter(loader)`` is ``iter_from(0)``.
* :meth:`DataLoader.replay_world` (the port's own): for the rest of an
  epoch that an elastic resume re-entered at the sampler's offset, each
  step's global batch is the one the old world's ranks would have made,
  the same examples with the same crops (each old rank's batch keyed by
  its own ``(seed, epoch, shard_id, batch)``), cut into this world's
  per-rank slices, so the continued trajectory repeats the interrupted
  run's inputs. The JAX loader re-partitions the remainder strided over
  the new shards, whose crops are keyed anew (the same examples, other
  crops).
* A background thread produces the host batches one step ahead (the
  ``pin_memory`` + workers role); for a CUDA device it pins each batch's
  host tensors, and the consumer copies them to the rank's device with
  ``non_blocking=True``.
* A consumer watchdog: a producer thread that died without finishing the
  epoch raises :class:`LoaderProducerDiedError` within one
  ``watchdog_timeout`` tick instead of blocking forever. The
  ``loader_stall`` clause of ``--fault_plan``
  (:func:`tpu_dist_torch.resilience.faults.on_loader_batch`) kills the
  producer before a given batch, as the JAX loader's does.
* The JAX loader's counters: ``loader.batches_produced`` and
  ``loader.batches_consumed``, ``loader.data_wait_s`` (the consumer's
  waits, its polling ticks included) and ``loader.producer_wait_s`` (the
  producer blocked on a full queue).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from tpu_dist_torch.data.sampler import DistributedSampler
from tpu_dist_torch.obs import counters, spans
from tpu_dist_torch.resilience import faults


class LoaderProducerDiedError(RuntimeError):
    """The prefetch producer thread died without finishing the epoch (and
    without surfacing an exception)."""


class DataLoader:
    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        batch_size: int,
        sampler: DistributedSampler,
        *,
        device="cpu",
        gather_transform: Optional[Callable] = None,
        seed: int = 0,
        prefetch: int = 2,
        with_mask: bool = False,
        watchdog_timeout: float = 5.0,
    ):
        """``batch_size`` is the PER-RANK batch. ``gather_transform(images,
        sel, seed=...)`` gathers, augments and normalizes one batch
        (:func:`tpu_dist_torch.data.transforms.gather_augment`); without it
        the raw images are gathered. ``with_mask`` adds the sampler's pad
        mask to each batch for exact distributed eval."""
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.images = images
        self.labels = labels
        self.batch_size = batch_size
        self.sampler = sampler
        self.device = torch.device(device)
        self.gather_transform = gather_transform
        self.seed = seed
        self.prefetch = max(1, prefetch)
        self.with_mask = with_mask
        self.watchdog_timeout = watchdog_timeout
        self._replay: Optional[int] = None  # the old world of an elastic epoch

    def replay_world(self, old_world: Optional[int]) -> None:
        """Make the rest of this epoch (past the sampler's offset, a whole
        number of global batches) the batches ``old_world`` ranks of this
        per-rank batch times this world's size would have made
        (module docstring); None, or an offset that is no whole number of
        global batches, restores the sampler's own partition."""
        g = self.batch_size * self.sampler.num_shards
        ok = old_world and g % old_world == 0 and self.sampler.offset % g == 0
        self._replay = int(old_world) if ok else None

    def _old_sampler(self, rank: int) -> DistributedSampler:
        s = self.sampler
        old = DistributedSampler(s.num_examples, self._replay, rank, shuffle=s.shuffle,
                                 seed=s.seed, drop_last=s.drop_last)
        old.set_epoch(s.epoch)
        return old

    def __len__(self) -> int:
        if self._replay:
            old_batch = self.batch_size * self.sampler.num_shards // self._replay
            old = len(self._old_sampler(0))
            nb = old // old_batch if self.sampler.drop_last else -(-old // old_batch)
            return nb - self.sampler.offset // (self.batch_size * self.sampler.num_shards)
        return len(self.sampler) // self.batch_size if self.sampler.drop_last else -(
            -len(self.sampler) // self.batch_size
        )

    def _batch(self, idx, mask, b: int, shard_id: int, batch_size: int) -> tuple:
        # epoch-, rank- and batch-keyed augmentation stream: batch b is
        # the same whether or not batches 0..b-1 were produced here
        rng = np.random.default_rng((self.seed, self.sampler.epoch, shard_id, b))
        sel = idx[b * batch_size : (b + 1) * batch_size]
        pad = batch_size - len(sel)
        bmask = mask[b * batch_size : b * batch_size + len(sel)] if mask is not None else None
        if pad:
            # last partial batch: wrap-around samples from the start of
            # this shard's epoch stream (torch's sampler padding)
            sel = np.concatenate([sel, np.resize(idx, pad)])
            if bmask is not None:
                bmask = np.concatenate([bmask, np.zeros(pad, bool)])
        if self.gather_transform is not None:
            imgs = self.gather_transform(self.images, sel, seed=int(rng.integers(0, 2**63)))
        else:
            imgs = self.images[sel]
        out = (imgs, self.labels[sel])
        if bmask is not None:
            out = out + (bmask.astype(np.float32),)
        return out

    def _host_batches(self, start_batch: int = 0) -> Iterator[Tuple[np.ndarray, ...]]:
        if self._replay:
            yield from self._replayed_batches(start_batch)
            return
        idx = self.sampler.indices()
        mask = self.sampler.pad_mask() if self.with_mask else None
        for b in range(start_batch, len(self)):
            yield self._batch(idx, mask, b, self.sampler.shard_id, self.batch_size)

    def _replayed_batches(self, start_batch: int) -> Iterator[Tuple[np.ndarray, ...]]:
        """The old world's batches past the offset, this rank's slice of
        each: positions ``[rank·B, (rank+1)·B)`` of the old ranks' batches
        end to end."""
        b_new, s = self.batch_size, self.sampler
        b_old = b_new * s.num_shards // self._replay
        base = s.offset // (b_new * s.num_shards)
        lo, hi = s.shard_id * b_new, (s.shard_id + 1) * b_new
        ranks = range(lo // b_old, (hi - 1) // b_old + 1)
        idx = {q: self._old_sampler(q).indices() for q in ranks}
        for k in range(start_batch, len(self)):
            parts = [self._batch(idx[q], None, base + k, q, b_old) for q in ranks]
            cut = slice(lo - ranks[0] * b_old, hi - ranks[0] * b_old)
            yield tuple(np.concatenate(a)[cut] for a in zip(*parts))

    def _to_host_tensors(self, batch) -> tuple:
        tensors = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in batch)
        if self.device.type == "cuda":
            tensors = tuple(t.pin_memory() for t in tensors)
        return tensors

    def __iter__(self):
        """Yields the epoch's batches as tensors on ``device``, produced one
        step ahead."""
        return self.iter_from(0)

    def iter_from(self, start_batch: int):
        """The epoch's batches from batch ``start_batch`` on: the exact
        mid-epoch resume's entry point. Skipped batches are never gathered
        or augmented, and batch b is the one an uninterrupted epoch gives
        (its augmentation stream is keyed by b)."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        err = []
        stop = threading.Event()
        killed = []  # --fault_plan loader_stall: the producer died, no sentinel

        def producer():
            try:
                for b, hb in enumerate(self._host_batches(start_batch), start=start_batch):
                    if faults.on_loader_batch(b, self.sampler.epoch) == "die":
                        # a producer killed mid-epoch: it exits without the
                        # sentinel, and the consumer's watchdog must notice
                        killed.append(b)
                        return
                    with spans.span("loader/produce", batch=b):
                        batch = self._to_host_tensors(hb)
                    counters.inc("loader.batches_produced")
                    # bounded put that notices consumer abandonment (the
                    # trainer's steps_per_epoch early break)
                    t_put = time.perf_counter()
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    # the producer blocked on a full queue: the loader
                    # outrunning the step (the healthy direction)
                    counters.inc("loader.producer_wait_s", time.perf_counter() - t_put)
                    if stop.is_set():
                        return
            except Exception as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                if not stop.is_set() and not killed:
                    q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                t_wait = time.perf_counter()
                try:
                    item = q.get(timeout=self.watchdog_timeout)
                except queue.Empty:
                    # the polling ticks are the consumer's wait too
                    counters.inc("loader.data_wait_s", time.perf_counter() - t_wait)
                    # only a DEAD producer with a drained queue is a failure
                    # (a live-but-slow one just keeps us polling)
                    if not t.is_alive() and q.empty():
                        if err:
                            raise err[0]
                        raise LoaderProducerDiedError(
                            "DataLoader producer thread died without finishing the "
                            "epoch (no sentinel, no error); restart the epoch instead "
                            "of waiting on q.get() forever"
                        )
                    continue
                counters.inc("loader.data_wait_s", time.perf_counter() - t_wait)
                if item is None:
                    break
                counters.inc("loader.batches_consumed")
                yield tuple(x.to(self.device, non_blocking=True) for x in item)
        finally:
            stop.set()
            # one drain makes room for a put in flight; the producer's
            # bounded put then lands or sees `stop` within one tick
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join()
            if err:
                raise err[0]
