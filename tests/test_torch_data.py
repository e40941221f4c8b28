"""The port's data path (``tpu_dist_torch.data``) held against the JAX
package's: the synthetic sets, the transforms, the sampler's indices and
pad mask, and the loader's host batches, all bit for bit; the loader's
tensors and its dead-producer watchdog."""

import functools

import jax
import numpy as np
import pytest
import torch
import torch_ranks  # noqa: F401  (one torch thread in this process)

import tpu_dist.data.native as jax_native
from tpu_dist.comm import mesh as mesh_lib
from tpu_dist.data import loader as jax_loader
from tpu_dist.data import sampler as jax_sampler
from tpu_dist.data import synthetic as jax_synthetic
from tpu_dist.data import transforms as jax_transforms
from tpu_dist_torch.data import loader, sampler, synthetic, transforms


@pytest.mark.parametrize("fn,args", [
    ("synthetic_cifar", (64, 100)), ("synthetic_quadrant", (40,)),
    ("synthetic_multifactor", (40,)),
])
def test_synthetic_sets_are_bit_identical(fn, args):
    for ours, theirs in zip(getattr(synthetic, fn)(*args, seed=3),
                            getattr(jax_synthetic, fn)(*args, seed=3)):
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)


def test_transforms_are_bit_identical():
    x = jax_synthetic.synthetic_cifar(16, seed=0)[0]
    np.testing.assert_array_equal(transforms.normalize(x), jax_transforms.normalize(x))
    np.testing.assert_array_equal(
        transforms.random_crop_batch(x, np.random.default_rng(4)),
        jax_transforms.random_crop_batch(x, np.random.default_rng(4)))


@pytest.mark.parametrize("train", (True, False))
def test_gather_augment_is_the_jax_numpy_path(train, monkeypatch):
    """The JAX function takes its C++ pipeline when built, whose crops come
    from another RNG stream; without it, its numpy path."""
    monkeypatch.setattr(jax_native, "_load", lambda: None)
    x = jax_synthetic.synthetic_cifar(32, seed=1)[0]
    sel = np.array([5, 3, 31, 0, 7])
    stats = dict(mean=jax_transforms.CIFAR10_MEAN, std=jax_transforms.CIFAR10_STD)
    np.testing.assert_array_equal(
        transforms.gather_augment(x, sel, seed=99, train=train, **stats),
        jax_native.gather_augment(x, sel, seed=99, train=train, **stats))


SAMPLER_CASES = [
    # num_examples, shards, shuffle, drop_last, offset
    (103, 1, True, False, 0), (103, 4, True, False, 0), (103, 4, False, False, 0),
    (103, 4, True, True, 0), (100, 8, True, False, 0), (3, 8, True, False, 0),
    (103, 4, True, False, 37), (103, 3, True, True, 50),
]


@pytest.mark.parametrize("n,shards,shuffle,drop_last,offset", SAMPLER_CASES)
def test_sampler_matches_jax(n, shards, shuffle, drop_last, offset):
    for shard in range(shards):
        ours = sampler.DistributedSampler(n, shards, shard, shuffle=shuffle, seed=7,
                                          drop_last=drop_last)
        theirs = jax_sampler.DistributedSampler(n, shards, shard, shuffle=shuffle, seed=7,
                                                drop_last=drop_last)
        for epoch in (0, 1, 5):
            for s in (ours, theirs):
                s.set_epoch(epoch)
                if offset:
                    s.set_offset(offset)
            assert len(ours) == len(theirs)
            np.testing.assert_array_equal(ours.indices(), theirs.indices())
            np.testing.assert_array_equal(ours.pad_mask(), theirs.pad_mask())


def _pair(n, shards, shard, batch, *, train, with_mask, drop_last=False, seed=3):
    images, labels = jax_synthetic.synthetic_cifar(n, 10, seed=2)
    stats = dict(mean=jax_transforms.CIFAR100_MEAN, std=jax_transforms.CIFAR100_STD)
    mk = functools.partial(sampler.DistributedSampler, n, shards, shard, shuffle=train,
                           seed=seed, drop_last=drop_last)
    jmk = functools.partial(jax_sampler.DistributedSampler, n, shards, shard, shuffle=train,
                            seed=seed, drop_last=drop_last)
    ours = loader.DataLoader(
        images, labels, batch, mk(),
        gather_transform=functools.partial(transforms.gather_augment, train=train, **stats),
        seed=seed, with_mask=with_mask)
    mesh = mesh_lib.device_mesh([1], [mesh_lib.DATA_AXIS], jax.devices()[:1])
    theirs = jax_loader.DataLoader(
        images, labels, batch, jmk(), mesh,
        gather_transform=functools.partial(jax_native.gather_augment, train=train, **stats),
        seed=seed, with_mask=with_mask, batch_divisor=1)
    return ours, theirs


@pytest.mark.parametrize("shards,shard,train,with_mask,drop_last", [
    (1, 0, True, False, False), (3, 2, True, False, False), (3, 1, True, False, True),
    (3, 0, False, True, False), (4, 3, False, True, False),
])
def test_host_batches_match_jax(shards, shard, train, with_mask, drop_last, monkeypatch):
    monkeypatch.setattr(jax_native, "_load", lambda: None)  # the numpy crop stream
    ours, theirs = _pair(50, shards, shard, 8, train=train, with_mask=with_mask,
                         drop_last=drop_last)
    for epoch in (0, 2):
        ours.sampler.set_epoch(epoch)
        theirs.sampler.set_epoch(epoch)
        assert len(ours) == len(theirs)
        got, want = list(ours._host_batches()), list(theirs._host_batches())
        assert len(got) == len(want) == len(ours)
        for g, w in zip(got, want):
            assert len(g) == len(w) == (3 if with_mask else 2)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        # a later start is the tail of the full stream (mid-epoch resume)
        for g, w in zip(list(ours._host_batches(1)), got[1:]):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def test_loader_yields_tensors_on_its_device_in_order():
    ours, _ = _pair(20, 2, 1, 4, train=False, with_mask=True)
    host = list(ours._host_batches())
    got = list(ours)
    assert len(got) == len(host) == 3
    for g, h in zip(got, host):
        assert [t.device.type for t in g] == ["cpu"] * 3
        assert (g[0].dtype, g[1].dtype, g[2].dtype) == (torch.float32, torch.int32, torch.float32)
        for t, a in zip(g, h):
            np.testing.assert_array_equal(t.numpy(), a)
    # abandoning an epoch midway stops the producer and leaves nothing behind
    it = iter(ours)
    next(it)
    it.close()


def test_watchdog_raises_on_a_dead_producer(monkeypatch):
    """A producer thread that dies without its end-of-epoch sentinel (here:
    one that never runs) raises within one watchdog tick, not a hang."""

    class DeadThread:
        def __init__(self, target, daemon):
            pass

        def start(self):
            pass

        def is_alive(self):
            return False

        def join(self):
            pass

    monkeypatch.setattr(loader.threading, "Thread", DeadThread)
    ours, _ = _pair(20, 1, 0, 4, train=True, with_mask=False)
    ours.watchdog_timeout = 0.05
    with pytest.raises(loader.LoaderProducerDiedError):
        next(iter(ours))


def test_producer_errors_reach_the_consumer():
    ours, _ = _pair(20, 1, 0, 4, train=True, with_mask=False)

    def broken(*a, **k):
        raise OSError("disk gone")

    ours.gather_transform = broken
    with pytest.raises(OSError, match="disk gone"):
        list(ours)
