"""Distributed sampler with exact reference semantics: the port's copy of
``tpu_dist/data/sampler.py`` (numpy only, bit for bit the same indices).

Re-implements the contract of ``torch.utils.data.distributed.DistributedSampler``
as the reference uses it (``distributed.py:70,74,81``):

* same epoch-seeded global permutation on every shard (``set_epoch``, whose
  shuffle-correctness role is explained in reference ``tutorials/2:§2``),
* pad-to-even division across shards (and, new here, the pad indices are
  *reported* so evaluation can mask them instead of double-counting —
  the reference's eval bug documented in SURVEY §3.4),
* optional ``drop_last`` (the grad-accum trainer's loader,
  ``distributed_gradient_accumulation.py:71``).

In the port one process drives one card, so a shard is a rank of the
process group; under sequence parallelism it is a data index, the ranks
of one seq group sharing it (``train/trainer.py``).
"""

from __future__ import annotations

import numpy as np


class DistributedSampler:
    def __init__(
        self,
        num_examples: int,
        num_shards: int = 1,
        shard_id: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if not (0 <= shard_id < num_shards):
            raise ValueError(f"shard_id {shard_id} out of range for {num_shards} shards")
        self.num_examples = num_examples
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.offset = 0  # consumed-prefix skip (elastic mid-epoch resume)
        self._recompute_sizes()

    def _recompute_sizes(self) -> None:
        remaining = self.num_examples - self.offset
        if self.drop_last:
            self.num_samples = remaining // self.num_shards
        else:
            self.num_samples = -(-remaining // self.num_shards)  # ceil
        self.total_size = self.num_samples * self.num_shards

    def set_epoch(self, epoch: int) -> None:
        """Reference ``train_sampler.set_epoch(epoch)`` (``distributed.py:81``).
        Also clears any mid-epoch offset — the skip applies to the resumed
        epoch only; the next epoch partitions the full permutation again."""
        self.epoch = epoch
        if self.offset:
            self.set_offset(0)

    def set_offset(self, n_examples: int) -> None:
        """Skip the first ``n_examples`` of the current epoch's GLOBAL
        order and re-partition the remainder over the shards — the elastic
        mid-epoch-resume entry point (docs/resilience.md).

        Why this is exact: shards advance in lockstep (steps are
        synchronous), so after ``k`` global batches every shard has
        consumed the first ``k * local_batch`` elements of its strided
        stream — and the union of those per-shard prefixes is precisely
        the first ``k * global_batch`` elements of the epoch permutation.
        Resuming with ``offset = k * global_batch`` therefore hands out
        exactly the not-yet-seen examples, no matter how many shards the
        OLD run had: nothing is dropped, nothing is double-seen. (For the
        same shard count, ``order[C:][j::n] == order[j::n][C//n:]`` since
        the global batch divides over the shards — the offset path
        strictly generalizes ``DataLoader._host_batches(start_batch)``.)"""
        if not 0 <= n_examples <= self.num_examples:
            raise ValueError(
                f"offset {n_examples} outside [0, {self.num_examples}]"
            )
        self.offset = int(n_examples)
        self._recompute_sizes()

    def indices(self) -> np.ndarray:
        """This shard's indices for the current epoch (deterministic)."""
        if self.shuffle:
            g = np.random.default_rng(self.seed + self.epoch)
            order = g.permutation(self.num_examples)
        else:
            order = np.arange(self.num_examples)
        if self.offset:
            order = order[self.offset :]
        if self.drop_last:
            order = order[: self.total_size]
        elif 0 < len(order) < self.total_size:
            # wrap-around padding, same policy as torch's sampler; tile so
            # even num_shards > num_examples pads fully
            reps = -(-self.total_size // len(order))
            order = np.tile(order, reps)[: self.total_size]
        return order[self.shard_id :: self.num_shards]

    def pad_mask(self) -> np.ndarray:
        """True for real examples, False for wrap-around padding — lets eval
        count each example exactly once (deliberate fix of SURVEY §3.4)."""
        if self.drop_last:
            return np.ones(self.num_samples, dtype=bool)
        # Padding occupies the tail of the padded global order regardless of
        # shuffle (the permutation covers only the first num_examples slots
        # past the consumed offset).
        positions = np.arange(self.shard_id, self.total_size, self.num_shards)
        return positions < self.num_examples - self.offset

    def __len__(self) -> int:
        return self.num_samples
