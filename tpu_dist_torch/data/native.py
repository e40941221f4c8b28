"""The native C++ input pipeline through ctypes: the port's counterpart of
``tpu_dist/data/native.py`` (``available``, ``gather_augment``).

``tpu_dist_torch/csrc/pipeline.cpp`` is the JAX package's
``tpu_dist/csrc/pipeline.cpp`` byte for byte (a test holds the two
equal): one fused, multi-threaded gather + zero pad + random crop +
normalise over a batch of uint8 NHWC images into f32, its crop offsets
drawn by splitmix64 per (seed, position in the batch). So the same seed
gives the same batch in both packages, bit for bit, where the numpy path
(:func:`tpu_dist_torch.data.transforms.gather_augment`) draws its crops
from ``np.random.default_rng`` and gives other ones.

At first use the port builds its own copy with the host compiler and the
JAX Makefile's flags into ``tpu_dist_torch/csrc/build/``
(:func:`tpu_dist_torch.ops._build.build_host`) and loads it; it never
loads the JAX package's library. Where the library cannot be built or
loaded, :func:`gather_augment` takes the numpy path, as the JAX module
does, but not silently: :func:`describe` gives the reason, and the
trainer prints it on its rank-0 start line.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from tpu_dist_torch.data import transforms
from tpu_dist_torch.ops import _build

NAME = "pipeline"
ABI_VERSION = 1


class Pipeline:
    """The loaded library, built at the first :meth:`load`, or the reason
    there is none (:attr:`error`). One attempt a process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tried = False
        self.lib: Optional[ctypes.CDLL] = None
        self.path: Optional[str] = None
        self.error: Optional[str] = None

    def load(self) -> Optional[ctypes.CDLL]:
        with self._lock:
            if not self._tried:
                self._tried = True
                try:
                    self.lib = self._open()
                except (OSError, RuntimeError, AttributeError) as e:
                    # OSError: no compiler, or a library that does not load;
                    # RuntimeError: the compiler failed; AttributeError: a
                    # library without the pipeline's symbols
                    self.error = f"{type(e).__name__}: {str(e).strip().splitlines()[0]}"
            return self.lib

    def _open(self) -> ctypes.CDLL:
        path, _, _ = _build.build_host(NAME)
        lib = ctypes.CDLL(str(path))
        lib.tpu_dist_augment_batch.restype = ctypes.c_int
        lib.tpu_dist_augment_batch.argtypes = [
            ctypes.c_void_p,   # images, uint8 [N_src, H, W, C]
            ctypes.c_void_p,   # indices, int64 [n]
            ctypes.c_void_p,   # out, f32 [n, H, W, C]
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # n, h, w, c
            ctypes.c_int64,    # pad
            ctypes.c_uint64,   # seed
            ctypes.c_void_p,   # mean, f32 [C]
            ctypes.c_void_p,   # std, f32 [C]
            ctypes.c_int,      # train
            ctypes.c_int,      # n_threads (0: one a hardware thread)
        ]
        lib.tpu_dist_pipeline_abi_version.restype = ctypes.c_int
        lib.tpu_dist_pipeline_abi_version.argtypes = []
        version = lib.tpu_dist_pipeline_abi_version()
        if version != ABI_VERSION:
            raise RuntimeError(f"{path.name} has ABI version {version}, expected {ABI_VERSION}")
        self.path = str(path)
        return lib


_PIPELINE = Pipeline()


def _load() -> Optional[ctypes.CDLL]:
    """The library, or None (the reason in :func:`describe`)."""
    return _PIPELINE.load()


def available() -> bool:
    return _load() is not None


def describe() -> str:
    """Which pipeline :func:`gather_augment` runs: ``native (<library>)``,
    or ``numpy (<why the library is not there>)``."""
    if _load() is not None:
        return f"native ({os.path.basename(_PIPELINE.path)})"
    return f"numpy ({_PIPELINE.error or 'the native library was not loaded'})"


def gather_augment(
    images: np.ndarray,
    indices: np.ndarray,
    *,
    seed: int,
    train: bool,
    padding: int = 4,
    mean: np.ndarray = transforms.CIFAR100_MEAN,
    std: np.ndarray = transforms.CIFAR100_STD,
    n_threads: int = 0,
) -> np.ndarray:
    """``normalize(random_crop(images[indices]))`` -> f32 NHWC batch, in the
    C++ library when it is loaded and on the numpy path otherwise (the same
    function with another crop stream). ``images`` is uint8 NHWC; an index
    out of range raises before the library reads it."""
    images = np.asarray(images)
    if images.dtype != np.uint8 or images.ndim != 4:
        raise ValueError(f"images must be uint8 NHWC, got {images.dtype} {images.shape}")
    idx = np.ascontiguousarray(indices, np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= len(images)):
        raise IndexError(f"indices in [{idx.min()}, {idx.max()}] for {len(images)} images")
    lib = _load()
    if lib is None:
        return transforms.gather_augment(images, idx, seed=seed, train=train, padding=padding,
                                         mean=mean, std=std)
    images = np.ascontiguousarray(images)
    n, (_, h, w, c) = len(idx), images.shape
    out = np.empty((n, h, w, c), np.float32)
    mean32 = np.ascontiguousarray(mean, np.float32)
    std32 = np.ascontiguousarray(std, np.float32)
    if mean32.shape != (c,) or std32.shape != (c,):
        raise ValueError(f"mean {mean32.shape} and std {std32.shape} must have {c} channels")
    rc = lib.tpu_dist_augment_batch(
        images.ctypes.data, idx.ctypes.data, out.ctypes.data, n, h, w, c,
        padding if train else 0, int(seed) & 0xFFFFFFFFFFFFFFFF,
        mean32.ctypes.data, std32.ctypes.data, 1 if train else 0, int(n_threads))
    if rc != 0:
        raise RuntimeError(f"tpu_dist_augment_batch returned {rc}")
    return out
