"""Batched, prefetching feeder for one rank: the port's counterpart of
``tpu_dist/data/loader.py`` (``DataLoader``, ``LoaderProducerDiedError``).

* :meth:`DataLoader._host_batches` is the JAX loader's, line for line:
  the sampler's indices in batches of ``batch_size`` (the per-rank
  batch), a last partial batch padded with wrap-around samples from the
  start of the rank's epoch stream, and each batch's augmentation seeded
  by ``np.random.default_rng((seed, epoch, shard_id, batch))``.
* :meth:`DataLoader.iter_from` starts the epoch at a given batch (the
  exact mid-epoch resume); ``iter(loader)`` is ``iter_from(0)``.
* A background thread produces the host batches one step ahead (the
  ``pin_memory`` + workers role); for a CUDA device it pins each batch's
  host tensors, and the consumer copies them to the rank's device with
  ``non_blocking=True``.
* A consumer watchdog: a producer thread that died without finishing the
  epoch raises :class:`LoaderProducerDiedError` within one
  ``watchdog_timeout`` tick instead of blocking forever.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from tpu_dist_torch.data.sampler import DistributedSampler
from tpu_dist_torch.obs import counters, spans


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

    def __len__(self) -> int:
        return len(self.sampler) // self.batch_size if self.sampler.drop_last else -(
            -len(self.sampler) // self.batch_size
        )

    def _host_batches(self, start_batch: int = 0) -> Iterator[Tuple[np.ndarray, ...]]:
        idx = self.sampler.indices()
        mask = self.sampler.pad_mask() if self.with_mask else None
        nb = len(self)
        for b in range(start_batch, nb):
            # epoch-, rank- and batch-keyed augmentation stream: batch b is
            # the same whether or not batches 0..b-1 were produced here
            rng = np.random.default_rng(
                (self.seed, self.sampler.epoch, self.sampler.shard_id, b)
            )
            sel = idx[b * self.batch_size : (b + 1) * self.batch_size]
            pad = self.batch_size - len(sel)
            bmask = mask[b * self.batch_size : b * self.batch_size + len(sel)] if self.with_mask else None
            if pad:
                # last partial batch: wrap-around samples from the start of
                # this shard's epoch stream (torch's sampler padding)
                sel = np.concatenate([sel, np.resize(idx, pad)])
                if bmask is not None:
                    bmask = np.concatenate([bmask, np.zeros(pad, bool)])
            if self.gather_transform is not None:
                imgs = self.gather_transform(
                    self.images, sel, seed=int(rng.integers(0, 2**63))
                )
            else:
                imgs = self.images[sel]
            out = (imgs, self.labels[sel])
            if self.with_mask:
                out = out + (bmask.astype(np.float32),)
            yield out

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

        def producer():
            try:
                for b, hb in enumerate(self._host_batches(start_batch), start=start_batch):
                    with spans.span("loader/produce", batch=b):
                        batch = self._to_host_tensors(hb)
                    counters.inc("loader.batches_produced")
                    # bounded put that notices consumer abandonment (the
                    # trainer's steps_per_epoch early break)
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except Exception as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                if not stop.is_set():
                    q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                try:
                    item = q.get(timeout=self.watchdog_timeout)
                except queue.Empty:
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
