"""SGD with momentum, step by step, over the reference model, and the
fused epoch's crop and normalisation."""

from __future__ import annotations

import torch

from gpubench.reference import layers as L


def augment(images_u8, idx, offsets, pad: int, mean, std):
    """The batch ``images_u8[idx]`` (NHWC uint8) zero-padded by ``pad``,
    cropped back to its size at ``offsets`` (``[B, 2]``: row, column) and
    normalised, ``(x/255 - mean) / std``, in float32 (the JAX runner's
    ``augment``, copied)."""
    x = images_u8[idx]
    b, h, w, _ = x.shape
    x = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    rows = offsets[:, 0, None] + torch.arange(h, device=x.device)
    cols = offsets[:, 1, None] + torch.arange(w, device=x.device)
    x = x[torch.arange(b, device=x.device)[:, None, None], rows[:, :, None], cols[:, None, :]]
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x.float() / 255.0 - mean) / std


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def follow(forward, weights: dict, batches, cfg: dict, *, precision: str = "f32",
           rows=None) -> dict:
    """Train ``len(batches)`` steps of SGD (``cfg["optimizer"]``: ``g' = g
    + wd·p``, ``b = μ·b + g'``, ``p = p − lr·b``) from ``weights`` on
    ``batches`` (callables returning ``(images, labels)``), the loss the
    mean cross-entropy of each batch. With ``rows`` a batch runs that many
    images at a time and their gradients add up (for models whose rows are
    independent). Returns the loss of each step, each leaf's gradient norm
    at the first step and each leaf's change over all of them."""
    opt = cfg["optimizer"]
    lr, mu, wd = opt["lr"], opt["momentum"], opt["weight_decay"]
    names = list(weights)
    params = [weights[n].detach().clone().requires_grad_(True) for n in names]
    start = [p.detach().clone() for p in params]
    bufs = [torch.zeros_like(p) for p in params]
    losses, grad_norms = [], None
    with L.full_float32():
        for t, batch in enumerate(batches):
            x, y = batch()
            b = len(y)
            step = b if rows is None else rows
            grads, loss = None, 0.0
            for lo in range(0, b, step):
                w = dict(zip(names, params))
                part = L.cross_entropy_sum(forward(w, x[lo:lo + step], cfg, precision),
                                           y[lo:lo + step]) / b
                g = torch.autograd.grad(part, params)
                grads = list(g) if grads is None else [a + c for a, c in zip(grads, g)]
                loss += float(part.detach())
            del x, y
            if t == 0:
                grad_norms = leaf_norms(dict(zip(names, grads)))
            with torch.no_grad():
                for p, g, buf in zip(params, grads, bufs):
                    buf.mul_(mu).add_(g + wd * p)
                    p.sub_(lr * buf)
            losses.append(loss)
    with torch.no_grad():
        delta = leaf_norms({n: p - s for n, p, s in zip(names, params, start)})
    return {"losses": losses, "grad_norms": grad_norms, "delta_norms": delta}
