"""NumPy image transforms: the port's copy of ``tpu_dist/data/transforms.py``
plus the numpy path of ``tpu_dist/data/native.py::gather_augment``
(:func:`gather_augment`), bit for bit.

Mirrors the reference pipeline exactly (``utils/dataset.py:5-21``):
train = RandomCrop(32, padding=4) + normalize; test = normalize only; same
hard-coded CIFAR-100 per-channel mean/std. Operates on NHWC uint8 batches
and is fully vectorized. The JAX package's C++ gather+crop+normalize
(``tpu_dist/csrc/pipeline.cpp``) draws its crop offsets from another RNG
stream; the port runs this numpy path only.
"""

from __future__ import annotations

import numpy as np

# utils/dataset.py:8,20
CIFAR100_MEAN = np.array([0.5070751592371323, 0.48654887331495095, 0.4409178433670343], np.float32)
CIFAR100_STD = np.array([0.2673342858792401, 0.2564384629170883, 0.27615047132568404], np.float32)
# standard torchvision CIFAR-10 statistics
CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


def normalize(x: np.ndarray) -> np.ndarray:
    """uint8 NHWC → float32 normalized (ToTensor + Normalize)."""
    return (x.astype(np.float32) / 255.0 - CIFAR100_MEAN) / CIFAR100_STD


def random_crop_batch(x: np.ndarray, rng: np.random.Generator, padding: int = 4) -> np.ndarray:
    """Vectorized RandomCrop(H, padding=4) over a NHWC batch.

    Pads with zeros (torch default) and gathers one HxW window per image via
    strided view indexing — no Python loop over the batch.
    """
    n, h, w, c = x.shape
    xp = np.pad(x, ((0, 0), (padding, padding), (padding, padding), (0, 0)))
    ys = rng.integers(0, 2 * padding + 1, size=n)
    xs = rng.integers(0, 2 * padding + 1, size=n)
    # windowed view: [N, 2p+1, 2p+1, H, W, C] is too big; gather row/col idx
    rows = ys[:, None] + np.arange(h)[None, :]          # [N, H]
    cols = xs[:, None] + np.arange(w)[None, :]          # [N, W]
    out = xp[np.arange(n)[:, None, None], rows[:, :, None], cols[:, None, :], :]
    return out


def gather_augment(
    images: np.ndarray,
    indices: np.ndarray,
    *,
    seed: int,
    train: bool,
    padding: int = 4,
    mean: np.ndarray = CIFAR100_MEAN,
    std: np.ndarray = CIFAR100_STD,
) -> np.ndarray:
    """``normalize(random_crop(images[indices]))`` -> f32 NHWC batch, with
    the crop offsets drawn from ``np.random.default_rng(seed)`` (train
    only): the numpy path of ``tpu_dist/data/native.py::gather_augment``."""
    batch = images[indices]
    if train:
        batch = random_crop_batch(batch, np.random.default_rng(seed), padding)
    return (batch.astype(np.float32) / 255.0 - mean) / std
