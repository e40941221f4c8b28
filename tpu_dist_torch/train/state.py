"""TrainState: the port's counterpart of ``tpu_dist/train/state.py``.

The JAX state is one immutable pytree; here ``params`` is the
``nn.Module`` itself and ``opt_state`` the optimizer's state, as its
``init`` makes it: one momentum buffer per parameter in parameter order
(SGD, LARS), or AdamW's and LAMB's ``{"mu": [...], "nu": [...],
"count": 0-d int32 tensor}``, the JAX dict with lists in parameter
order. The train step updates both in place and
returns a state with the step counter advanced. ``bn_state`` maps the
model's buffer names to its buffers (the ResNets' BatchNorm running
statistics, which the forward updates in place; empty for the ViT).

Two parts of a state may be flat vectors laid over the ranks, as JAX lays
them over the data axis; ``layout`` (a :class:`FlatLayout`) then says how:

* under ZeRO-1 (``shard_weight_update``) ``opt_state`` is this rank's
  shard of the flat optimizer state: SGD's momentum, one f32 tensor of
  ``layout.chunk`` elements, or AdamW's ``{"mu", "nu", "count"}`` with
  ``mu`` and ``nu`` such tensors;
* under ``grad_compression="int8_ef"`` ``ef`` holds this rank's
  error-feedback residuals: ``{"r1", "r2"}``, ``r1`` its row of
  ``layout.padded`` elements (JAX's global ``r1`` is the ``world`` rows
  end to end) and ``r2`` its ``layout.chunk`` elements of the reduced
  gradient's residual; ZeRO-1 keeps ``r1`` only. Otherwise ``ef`` is
  ``()``.

Under ``--sp`` the flat state lies over the data axis alone: ``layout.rank``
is the data index, and every seq index of a data row holds the same part.

The flat coordinates follow the model's parameter order and layout; the
checkpoint writes them in the JAX ravel order (``bridge.py``).

Under FSDP (:mod:`tpu_dist_torch.parallel.fsdp`) ``fsdp`` holds this
rank's shards of the parameters (an :class:`~tpu_dist_torch.parallel.fsdp.
FSDPShards`): the model's sharded parameters keep their full shapes with
their storage released between steps, and ``opt_state`` is the
optimizer's state over the shards (``fsdp.entries``), in their order.
``replicas`` is the group of the ranks that hold the same shards of a
tensor-, expert- or pipeline-parallel model (the data axis; ``data,seq``
under TP×SP): the sharded checkpoint's writer of each piece is its first
rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """The flat state's lay-out over the ranks: ``L`` raveled parameters,
    padded to ``padded = chunk·world`` (``chunk = ceil(L/world)``) with a
    zero tail, rank ``rank`` holding ``[rank·chunk, (rank+1)·chunk)``.
    ``group`` is the process group of the ``world`` ranks (the data axis's
    under ``--sp``; None: the default group), over which a checkpoint
    gathers the flat parts."""

    L: int
    world: int
    rank: int
    group: Any = dataclasses.field(default=None, compare=False)

    @property
    def chunk(self) -> int:
        return -(-self.L // self.world)

    @property
    def padded(self) -> int:
        return self.chunk * self.world

    @property
    def lo(self) -> int:
        return self.rank * self.chunk


@dataclasses.dataclass
class TrainState:
    params: torch.nn.Module  # the model; its parameters are the trained leaves
    bn_state: Any            # BatchNorm running statistics, by name ({} for the ViT)
    opt_state: Any           # the optimizer's state (optimizer.init), in parameter order
    step: int = 0            # global step counter
    ef: Any = ()             # this rank's error-feedback residuals (int8_ef), else ()
    layout: Optional[FlatLayout] = None  # how the flat parts lie over the ranks
    fsdp: Any = None         # this rank's FSDP parameter shards (FSDPShards), else None
    replicas: Any = None     # the ranks that share this rank's model index (an AxisGroup), if any

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer) -> "TrainState":
        return cls(params=model, bn_state=dict(model.named_buffers()),
                   opt_state=optimizer.init(list(model.parameters())), step=0)
