"""The one generator of inputs and weights: everything a cell feeds the
program is drawn here on the device from ``--seed``, in a few large calls,
and drawn the same again for the reference.

Each kind of draw has a stream of its own (``weights``, ``pool``,
``dataset``, ``order``), keyed by the seed and the stream's name, so the
same seed gives the same tensors on the same device whichever is drawn
first. What is drawn, and how much, the traffic file says:

* ``pool``: the streaming step's inputs, ``pool`` distinct batches of
  ``batch`` images of ``image_size`` px (standard normal, the statistics
  of normalised pixels) and labels uniform over the classes, cycled by the
  window;
* ``dataset`` and ``epochs``: the fused epoch's inputs, the configuration's
  ``train_images`` uint8 images (uniform, as ``data/synthetic.py``'s
  ``synthetic_cifar``) with uniform labels, and for each of ``epochs_drawn``
  epochs a permutation cut into ``steps_per_call`` batches and each image's
  crop offsets in ``[0, 2·pad]``.
"""

from __future__ import annotations

import hashlib
import math

import torch


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A generator on ``device`` for ``stream`` under ``seed`` (any
    integer, negative and past 64 bits included)."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return torch.Generator(device=device).manual_seed(int.from_bytes(digest[:8], "little") >> 1)


def weights(specs, seed: int, device) -> dict:
    """``{name: float32 tensor}`` from ``specs`` (``[(name, shape, (kind,
    value))]``): ``("normal", std)`` leaves cut from one standard normal
    draw and scaled, ``("const", v)`` leaves filled with ``v``."""
    n = sum(math.prod(shape) for _, shape, (kind, _) in specs if kind == "normal")
    flat = torch.randn(n, generator=generator(seed, "weights", device), device=device)
    out, off = {}, 0
    for name, shape, (kind, value) in specs:
        if kind == "normal":
            k = math.prod(shape)
            out[name] = flat[off:off + k].view(shape).mul_(value)
            off += k
        elif kind == "const":
            out[name] = torch.full(shape, float(value), device=device)
        else:
            raise ValueError(f"{name}: unknown initial distribution {kind!r}")
    return out


def pool(cfg: dict, traffic: dict, seed: int, device) -> list:
    """``[(images [B, H, W, C] float32, labels [B] int64)]``, ``pool``
    batches."""
    gen = generator(seed, "pool", device)
    b, hw, c = traffic["batch"], traffic["image_size"], cfg["num_channels"]
    return [(torch.randn(b, hw, hw, c, generator=gen, device=device),
             torch.randint(0, cfg["num_classes"], (b,), generator=gen, device=device))
            for _ in range(traffic["pool"])]


def dataset(cfg: dict, seed: int, device) -> tuple:
    """``(images [N, H, W, C] uint8, labels [N] int64)`` of the
    configuration's training set's shapes."""
    gen = generator(seed, "dataset", device)
    n, hw, c = cfg["data"]["train_images"], cfg["image_size"], cfg["num_channels"]
    images = torch.randint(0, 256, (n, hw, hw, c), dtype=torch.uint8, generator=gen,
                           device=device)
    return images, torch.randint(0, cfg["num_classes"], (n,), generator=gen, device=device)


def epochs(cfg: dict, traffic: dict, seed: int, device) -> list:
    """``[(order [steps, B] int64, offsets [steps, B, 2] int64)]``, one per
    drawn epoch."""
    gen = generator(seed, "order", device)
    n, b, steps = cfg["data"]["train_images"], traffic["batch"], traffic["steps_per_call"]
    pad = cfg["data"]["pad"]
    out = []
    for _ in range(traffic["epochs_drawn"]):
        order = torch.randperm(n, generator=gen, device=device)[:steps * b].view(steps, b)
        offsets = torch.randint(0, 2 * pad + 1, (steps, b, 2), generator=gen, device=device)
        out.append((order, offsets))
    return out
