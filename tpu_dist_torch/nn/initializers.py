"""Parameter initializers: the port's counterpart of
``tpu_dist/nn/initializers.py``, drawing from an explicit
:class:`torch.Generator` (the JAX functions take a PRNG key).

torch's defaults, as the reference model uses them: Kaiming-uniform with
``a=sqrt(5)`` for conv/linear weights, uniform ``±1/sqrt(fan_in)`` for the
linear bias. The draws differ from JAX's (another generator); weights that
must match the JAX package come through :mod:`tpu_dist_torch.bridge`.
"""

from __future__ import annotations

import math

import torch


def _uniform(shape, bound: float, gen: torch.Generator, dtype) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=dtype) * 2.0 - 1.0) * bound


def kaiming_uniform(shape, fan_in: int, gen: torch.Generator, a: float = math.sqrt(5.0),
                    dtype=torch.float32) -> torch.Tensor:
    """torch's default ``kaiming_uniform_(a=sqrt(5))`` for a conv/linear weight."""
    gain = math.sqrt(2.0 / (1.0 + a * a))
    return _uniform(shape, gain * math.sqrt(3.0 / fan_in), gen, dtype)


def uniform_fan_in(shape, fan_in: int, gen: torch.Generator, dtype=torch.float32) -> torch.Tensor:
    """torch's default bias init: U(±1/sqrt(fan_in))."""
    return _uniform(shape, 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0, gen, dtype)
