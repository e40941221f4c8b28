"""Self-contained CIFAR-100/10 reader: the port's copy of
``tpu_dist/data/cifar.py`` (numpy and pickle only).

Reads the standard ``cifar-100-python`` pickle layout that the reference's
``datasets.CIFAR100(root='./data', download=True)`` produces
(``utils/dataset.py:10-13``). This build runs with zero network egress, so
there is no downloader: the loader looks for an existing extraction (or
``.tar.gz``) under ``data_dir`` and raises a clear error otherwise; tests
and benches use :func:`tpu_dist_torch.data.synthetic.synthetic_cifar`.
"""

from __future__ import annotations

import os
import pickle
import tarfile
from typing import Tuple

import numpy as np

def _find_root(data_dir: str, dirname: str, archive: str, label: str) -> str:
    """Locate an extracted dataset dir, extracting the archive if present."""
    d = os.path.join(data_dir, dirname)
    if os.path.isdir(d):
        return d
    tar = os.path.join(data_dir, archive)
    if os.path.isfile(tar):
        with tarfile.open(tar, "r:gz") as tf:
            tf.extractall(data_dir)
        if os.path.isdir(d):
            return d
    raise FileNotFoundError(
        f"{label} not found under {data_dir!r} (need {dirname}/ or {archive}); "
        "this environment has no network egress — place the archive there, or use "
        "dataset='synthetic'."
    )


def load_cifar100(data_dir: str = "./data", train: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Returns ``(images_u8 [N,32,32,3], labels_i32 [N])`` — fine labels,
    matching the reference's ``datasets.CIFAR100`` splits."""
    root = _find_root(data_dir, "cifar-100-python", "cifar-100-python.tar.gz", "CIFAR-100")
    fname = "train" if train else "test"
    with open(os.path.join(root, fname), "rb") as f:
        d = pickle.load(f, encoding="latin1")
    data = np.asarray(d["data"], np.uint8).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    labels = np.asarray(d["fine_labels"], np.int32)
    return np.ascontiguousarray(data), labels


def load_cifar10(data_dir: str = "./data", train: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-10 in the standard ``cifar-10-batches-py`` layout
    (``data_batch_1..5`` / ``test_batch`` pickles). Same NHWC uint8 output
    contract as :func:`load_cifar100`."""
    root = _find_root(data_dir, "cifar-10-batches-py", "cifar-10-python.tar.gz", "CIFAR-10")
    names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    datas, labels = [], []
    for n in names:
        with open(os.path.join(root, n), "rb") as f:
            d = pickle.load(f, encoding="latin1")
        datas.append(np.asarray(d["data"], np.uint8))
        labels.append(np.asarray(d["labels"], np.int32))
    data = np.concatenate(datas).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(data), np.concatenate(labels)
