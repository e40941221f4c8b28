"""Process group bring-up and rank queries: the port's counterpart of
``tpu_dist/comm/mesh.py`` (``initialize_distributed``, ``process_index``,
``process_count``, ``local_device_count``, ``is_primary``).

The JAX package runs one process per host driving every local chip over a
device mesh; the port runs one process per card, as the reference's
``torch.distributed`` scripts do, and joins them into one
``torch.distributed`` process group: NCCL for CUDA devices, gloo for the
CPU. The rendezvous reads ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/
``MASTER_ADDR``/``MASTER_PORT`` as ``torchrun`` sets them, falling back to
the caller's values. A world of one process still builds a real group, so
the card runs real NCCL collectives.

Sequence parallelism lays the world out as a ``[data, seq]`` mesh
(:func:`seq_mesh`), as the JAX trainer's ``device_mesh([n/sp, sp], ["data",
"seq"])`` does: ranks host-major and row-major, so a seq group is ``sp``
consecutive ranks, and each axis has a ``torch.distributed`` group per row
(:class:`AxisGroup`): :func:`seq_axis` builds the seq groups alone, which
is all the replicated step needs, :func:`data_axis` the data groups of
ZeRO-1's shards. Tensor and expert parallelism name more axes
(:func:`named_mesh`, the JAX names ``model`` and ``expert``):
:func:`tp_mesh` is ``[data, model]`` or ``[data, model, seq]`` with the
joined ``data,seq`` group, :func:`ep_mesh` ``[data, expert]``, and
pipeline parallelism :func:`pp_mesh` ``[data, pipe]`` or ``[data, pipe,
model]`` with the joined ``pipe,model`` group; every rank creates every
group in one order. :func:`axis_intra_host` is ``model_axes_intra_host``,
and :func:`check_model_axes_intra_host` the JAX trainer's refusal of model
axes that cross hosts. FSDP shards over the data axis: :func:`data_axis`
``(1)`` (every rank), or the ``data`` axis of :func:`tp_mesh` under
FSDP×TP.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
from typing import Optional

import torch
import torch.distributed as dist

from tpu_dist_torch import resolve_device


def _env_int(name: str, fallback: Optional[int]) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else fallback


def backend_for(device) -> str:
    """``"nccl"`` for a CUDA device, ``"gloo"`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(
    device="cuda",
    *,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    master_addr: str = "127.0.0.1",
    master_port: int = 23456,
) -> tuple:
    """Join the default process group; returns ``(rank device, created)``.

    ``created`` is False when a group already exists (it is then reused as
    it is, and its owner destroys it). Environment variables set by
    ``torchrun`` or a spawning launcher win over the arguments. For CUDA
    the process takes card ``LOCAL_RANK`` (else its rank) of the visible
    ones; for the CPU every rank shares the host."""
    dev = resolve_device(device)
    rank = _env_int("RANK", rank if rank is not None else 0)
    world_size = _env_int("WORLD_SIZE", world_size if world_size is not None else 1)
    local_rank = _env_int("LOCAL_RANK", rank)
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for a world of {world_size}")
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else local_rank
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank} wants card {index} but {torch.cuda.device_count()} are visible"
            )
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev, False
    addr = os.environ.get("MASTER_ADDR") or master_addr
    port = _env_int("MASTER_PORT", master_port)
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group(
        backend_for(dev), init_method=f"tcp://{addr}:{port}",
        world_size=world_size, rank=rank, **kw,
    )
    return dev, True


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The world size (1 without a process group)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def local_device_count(device="cuda") -> int:
    """Cards of ``device``'s type visible on this host (one process each);
    1 for the CPU."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def is_primary() -> bool:
    """True on the process allowed to print (rank-0 discipline)."""
    return process_index() == 0


# -- named mesh axes: [data, seq], [data, model], [data, expert], [data, model, seq],
# [data, pipe], [data, pipe, model] --

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One mesh axis as this rank sees it: the axis ``name``, its ``size``,
    this rank's ``index`` along it and the process ``group`` of the ranks
    that share every other coordinate (None: the default group, which is
    the whole axis only when the mesh is 1-D). What a JAX axis name selects
    inside a ``shard_map``, as a value. A group over several axes (the
    ranks that share the remaining coordinates) names them joined by a
    comma, and its index is this rank's row-major position over them."""

    name: str
    size: int
    index: int
    group: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ``[data, seq]`` mesh of the world, as this rank sees it: its
    coordinates and its group along each axis."""

    data: AxisGroup
    seq: AxisGroup


def mesh_coords(rank: int, *inner: int) -> tuple:
    """Coordinates of ``rank`` on a ``[world/prod(inner), *inner]`` mesh laid
    out host-major and row-major (the last axis fastest), as
    ``tpu_dist/comm/mesh.py::device_mesh`` lays devices: an inner axis of
    size ``k`` is ``k`` ranks a stride apart, the last one consecutive
    ranks. ``mesh_coords(rank, sp)`` is ``(data, seq)``."""
    coords = []
    for size in reversed(inner):
        rank, c = divmod(rank, size)
        coords.append(c)
    return (rank, *reversed(coords))


def axis_groups(world: int, inner: tuple, axes: tuple) -> list:
    """The ranks of each group along the axes ``axes`` (indices into the
    mesh ``[world/prod(inner), *inner]``) of that mesh: every group holds
    the ranks that share the other coordinates, in row-major order over
    ``axes``, and the groups come in row-major order of those other
    coordinates."""
    sizes = (world // math.prod(inner), *inner)
    fixed = [a for a in range(len(sizes)) if a not in axes]
    groups = []
    for other in itertools.product(*(range(sizes[a]) for a in fixed)):
        ranks = []
        for mine in itertools.product(*(range(sizes[a]) for a in axes)):
            c = [0] * len(sizes)
            for a, v in zip(fixed, other):
                c[a] = v
            for a, v in zip(axes, mine):
                c[a] = v
            r = 0
            for size, v in zip(sizes, c):
                r = r * size + v
            ranks.append(r)
        groups.append(tuple(ranks))
    return groups


def seq_groups(world: int, sp: int) -> list:
    """The ranks of each seq group of a ``[world/sp, sp]`` mesh, by data
    index: ``sp`` consecutive ranks each."""
    return axis_groups(world, (sp,), (1,))


def data_groups(world: int, sp: int) -> list:
    """The ranks of each data group of a ``[world/sp, sp]`` mesh, by seq
    index: every ``sp``-th rank."""
    return axis_groups(world, (sp,), (0,))


def _checked(sp: int, world: Optional[int], rank: Optional[int]) -> tuple:
    world = process_count() if world is None else int(world)
    rank = process_index() if rank is None else int(rank)
    if sp < 1 or world % sp:
        raise ValueError(f"{world} ranks do not divide over sp={sp}")
    return world, rank


def _new_groups(ranks_of: list, mine: int):
    """One ``dist.new_group`` per rank tuple of ``ranks_of``, created on
    every rank in the same order, its own or not, as ``new_group``
    requires; returns the group of entry ``mine`` (None without a process
    group)."""
    group = None
    if dist.is_available() and dist.is_initialized():
        for i, ranks in enumerate(ranks_of):
            g = dist.new_group(list(ranks))
            group = g if i == mine else group
    return group


def seq_axis(sp: int, world: Optional[int] = None, rank: Optional[int] = None) -> AxisGroup:
    """The seq axis of the ``[world/sp, sp]`` mesh over the default process
    group: one group per data index (``sp`` consecutive ranks). All the
    sequence-parallel model and the replicated step need."""
    world, rank = _checked(sp, world, rank)
    d, s = mesh_coords(rank, sp)
    return AxisGroup(SEQ_AXIS, sp, s, _new_groups(seq_groups(world, sp), d))


def data_axis(sp: int, world: Optional[int] = None, rank: Optional[int] = None) -> AxisGroup:
    """The data axis of the ``[world/sp, sp]`` mesh: one group per seq
    index (every ``sp``-th rank), over which ZeRO-1 shards its flat state."""
    world, rank = _checked(sp, world, rank)
    d, s = mesh_coords(rank, sp)
    return AxisGroup(DATA_AXIS, world // sp, d, _new_groups(data_groups(world, sp), s))


def seq_mesh(sp: int, world: Optional[int] = None, rank: Optional[int] = None) -> Mesh:
    """The ``[world/sp, sp]`` mesh, both axes with their groups (the seq
    groups created first). Without a process group (a world of one) both
    axes have size 1 and no group."""
    seq = seq_axis(sp, world, rank)
    return Mesh(data_axis(sp, world, rank), seq)


@dataclasses.dataclass(frozen=True)
class NamedMesh:
    """A mesh ``[data, *inner]`` of named axes as this rank sees it:
    ``axes[name]`` is the :class:`AxisGroup` along one axis, or along
    several joined by a comma (``"data,seq"``: the ranks that share the
    other coordinates)."""

    names: tuple
    sizes: tuple
    coords: tuple
    axes: dict

    def __getitem__(self, name: str) -> AxisGroup:
        return self.axes[name]


def named_mesh(inner: list, joined: tuple = (), world: Optional[int] = None,
               rank: Optional[int] = None) -> NamedMesh:
    """The mesh ``[data = world / prod(sizes), *sizes]`` of the axes
    ``inner`` (``[(name, size), ...]``, the last the fastest: consecutive
    ranks), as the JAX trainer lays its meshes out
    (``tpu_dist/train/trainer.py:278-309``). Every rank creates the groups
    of every axis, in the mesh's order (data first), then of each tuple of
    axis names in ``joined``, in that order. Without a process group every
    axis has no group."""
    world = process_count() if world is None else int(world)
    rank = process_index() if rank is None else int(rank)
    sizes = tuple(int(s) for _, s in inner)
    if any(s < 1 for s in sizes) or world % math.prod(sizes):
        raise ValueError(f"{world} ranks do not divide over "
                         + " x ".join(f"{n}={s}" for n, s in inner))
    names = (DATA_AXIS, *(n for n, _ in inner))
    full = (world // math.prod(sizes), *sizes)
    coords = mesh_coords(rank, *sizes)
    axes = {}
    for spec in [(n,) for n in names] + [tuple(j) for j in joined]:
        idx = tuple(names.index(n) for n in spec)
        fixed = [a for a in range(len(names)) if a not in idx]
        mine = 0
        for a in fixed:
            mine = mine * full[a] + coords[a]
        index = 0
        for a in idx:
            index = index * full[a] + coords[a]
        axes[",".join(spec)] = AxisGroup(
            ",".join(spec), math.prod(full[a] for a in idx), index,
            _new_groups(axis_groups(world, sizes, idx), mine))
    return NamedMesh(names, full, coords, axes)


def tp_mesh(tp: int, sp: int = 1, world: Optional[int] = None,
            rank: Optional[int] = None) -> NamedMesh:
    """``[world/tp, tp]`` as ``[data, model]``, or with ``sp > 1``
    ``[world/(tp·sp), tp, sp]`` as ``[data, model, seq]`` with the joined
    ``data,seq`` group (the ranks that share a model index: the gradient
    reduce and the evaluation's)."""
    if sp > 1:
        return named_mesh([(MODEL_AXIS, tp), (SEQ_AXIS, sp)], ((DATA_AXIS, SEQ_AXIS),),
                          world, rank)
    return named_mesh([(MODEL_AXIS, tp)], (), world, rank)


def ep_mesh(ep: int, world: Optional[int] = None, rank: Optional[int] = None) -> NamedMesh:
    """``[world/ep, ep]`` as ``[data, expert]``: the expert groups are
    ``ep`` consecutive ranks."""
    return named_mesh([(EXPERT_AXIS, ep)], (), world, rank)


def pp_mesh(pp: int, tp: int = 1, world: Optional[int] = None,
            rank: Optional[int] = None) -> NamedMesh:
    """``[world/pp, pp]`` as ``[data, pipe]``, or with ``tp > 1``
    ``[world/(pp·tp), pp, tp]`` as ``[data, pipe, model]`` with the joined
    ``pipe,model`` group (the ranks of one data row: a stage's shards), as
    the JAX trainer lays out Megatron PP×TP: the model axis innermost
    (consecutive ranks), the pipe next, the data outermost
    (``tpu_dist/train/trainer.py:287-298``)."""
    if tp > 1:
        return named_mesh([(PIPE_AXIS, pp), (MODEL_AXIS, tp)], ((PIPE_AXIS, MODEL_AXIS),),
                          world, rank)
    return named_mesh([(PIPE_AXIS, pp)], (), world, rank)


def axis_intra_host(groups, ranks_per_host: int) -> bool:
    """True iff each rank group of ``groups`` lies on one host, the hosts
    holding ``ranks_per_host`` consecutive ranks each (``torchrun``'s
    ``LOCAL_WORLD_SIZE``): the counterpart of ``model_axes_intra_host``,
    whose collectives then never leave a host's links."""
    per = max(int(ranks_per_host), 1)
    return all(len({r // per for r in ranks}) <= 1 for ranks in groups)


def ranks_per_host(device="cuda") -> int:
    """Ranks on one host: ``LOCAL_WORLD_SIZE`` as ``torchrun`` sets it, else
    the cards visible here (one rank a card), else the whole world (the
    CPU ranks of one host)."""
    local = _env_int("LOCAL_WORLD_SIZE", None)
    if local:
        return local
    if torch.device(device).type == "cuda":
        return max(torch.cuda.device_count(), 1)
    return process_count()


def check_model_axes_intra_host(m: NamedMesh, ways: dict, ranks_per_host: int) -> None:
    """The JAX trainer's ``_check_mesh_host_layout``: refuse a mesh whose
    model axes (``ways``: ``{axis name: its size}``, the model, expert and
    pipe axes the run asked for) put one group of theirs on more than one
    host, whose collectives would then leave the host's links. A world on
    one host passes."""
    world = math.prod(m.sizes)
    if world <= ranks_per_host:
        return
    hard = [a for a, w in ways.items() if w > 1 and a in m.names]
    if not hard:
        return
    idx = tuple(m.names.index(a) for a in hard)
    if not axis_intra_host(axis_groups(world, m.sizes[1:], idx), ranks_per_host):
        raise ValueError(
            f"mesh lays model axes {hard} across hosts (DCN): with "
            f"{ranks_per_host} devices/host, keep "
            f"tp*ep*pp ways a divisor of the local device count"
        )
