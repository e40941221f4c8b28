"""TrainState: the port's counterpart of ``tpu_dist/train/state.py``.

The JAX state is one immutable pytree; here ``params`` is the
``nn.Module`` itself and ``opt_state`` the optimizer's state, as its
``init`` makes it: one momentum buffer per parameter in parameter order
(SGD, LARS), or AdamW's and LAMB's ``{"mu": [...], "nu": [...],
"count": 0-d int32 tensor}``, the JAX dict with lists in parameter
order. The train step updates both in place and
returns a state with the step counter advanced. ``bn_state`` maps the
model's buffer names to its buffers (the ResNets' BatchNorm running
statistics, which the forward updates in place; empty for the ViT), and
``ef`` (the int8 error-feedback residuals) stays empty until compressed
collectives are ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class TrainState:
    params: torch.nn.Module  # the model; its parameters are the trained leaves
    bn_state: Any            # BatchNorm running statistics, by name ({} for the ViT)
    opt_state: Any           # the optimizer's state (optimizer.init), in parameter order
    step: int = 0            # global step counter
    ef: Any = ()             # error-feedback residuals (not ported: always ())

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer) -> "TrainState":
        return cls(params=model, bn_state=dict(model.named_buffers()),
                   opt_state=optimizer.init(list(model.parameters())), step=0)
