"""The process mesh and its SPMD axis context (counterpart of
singa_tpu/parallel/mesh.py).

The reference's mesh is a `jax.sharding.Mesh` of chips with named axes,
and a collective names the axis it runs over inside a `shard_map`. Here
each rank is one process, and a mesh lays the ranks of the
`torch.distributed` group out row-major over its axes, as JAX's mesh
lays out devices: in `get_mesh((dp, sp), ("data", "seq"))` rank
`d * sp + s` has data index d and seq index s. Each axis is a process
group: the ranks that differ only in that axis's index, made by
`dist.new_group` on every rank in the same order (an axis that spans
the whole world is the world's group). With no group initialised the
mesh is a world of one process whose every axis has size 1 and whose
collectives are the identity, the reference's "outside SPMD" case.

`axis_context` / `axes_context` push axis names (and the mesh that
carries them) while a distributed step runs, as the reference's SPMD
wrapper does: axis-aware code (ring and Ulysses attention, the
position offsets of sequence-parallel models, DistOpt's extra gradient
axes) keys off `in_axis` and reads its axis's size, index and group
from the innermost mesh (`axis_size`, `axis_index`, `axis_group`).
An axis entered without a mesh has size 1.

`batch_axis_context` marks the data group as THE batch axis while a
distributed step runs (`model.Model` enters it under DistOpt):
`autograd.batchnorm(sync=None)` then averages its moments over the
group (cross-replica BN, reference :167-180).

`get_mesh_3d(dp, tp, sp)` is the (data, model, sp) mesh of the 3-D
recipe, in the reference's axis order. `get_mesh(devices=)` lays the
mesh over a subset of the group's ranks (a list of ranks, or of devices
each naming its rank by index). A rank outside the subset gets a
ValueError, or with `allow_outside=True` the mesh's LAYOUT: a `Mesh`
with `member` False that knows its `ranks` and `dims` and holds no
group (the disaggregated serving engine's prefill and decode meshes
each name the other's ranks this way). `discovery_context` / `in_discovery`
mark a shape-discovery pass, as the reference's do (reference
:216-225); they are surface only: the port runs no discovery pass
(a rank's first eager call gives the shapes), so nothing in it enters
or reads the flag.
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Dict, Optional, Sequence, Tuple

import torch.distributed as dist

__all__ = ["DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "EXPERT_AXIS",
           "PIPE_AXIS", "COMPATIBLE_ROLE_PAIRS", "Mesh", "get_mesh", "axis_entry", "axis_size",
           "axis_index", "axis_group", "axis_context", "axes_context",
           "in_axis", "live_axes", "restore_axes", "local_world_size", "batch_axis_context",
           "current_batch_axis", "current_batch_axis_size",
           "current_batch_group", "get_mesh_3d", "discovery_context",
           "in_discovery"]

# -- the canonical axis names (the reference's) ---------------------------------

#: data parallelism: batch shards and DistOpt's gradient sync
DATA_AXIS = "data"
#: Megatron tensor parallelism: weight column/row shards
MODEL_AXIS = "model"
#: sequence parallelism: ring/Ulysses token shards
SEQ_AXIS = "sp"
#: expert parallelism: Switch-MoE expert shards
EXPERT_AXIS = "expert"
#: pipeline parallelism: GPipe stage shards
PIPE_AXIS = "pipe"

#: the parallelism roles that may share one mesh axis (reference :44-51):
#: ZeRO-3 rides the data axis (weight shards gathered per block, batch
#: shards for the loss); any other pair on one axis would mix the shards
#: of two schemes in its collectives. The roles are "data", "tp",
#: "zero3", "seq", "expert" and "pipe"; `ScanTransformerStack` refuses
#: an axis kwarg pair on one axis unless its roles are listed here
COMPATIBLE_ROLE_PAIRS = frozenset({frozenset({"data", "zero3"})})


def _live() -> bool:
    return dist.is_available() and dist.is_initialized()


class Mesh:
    """Ranks of the process group laid out over named axes.

    `Mesh(group, axis_names)` is a 1-D mesh over `group` (a process
    group, or None for the world of one process with no group), as in
    the data-parallel slices; `get_mesh` builds N-D meshes. `shape` maps
    each axis to its size, as a jax mesh's does; `axis_group`,
    `axis_index` give this rank's group and index along an axis; `group`,
    `size` and `rank` are the whole mesh's."""

    def __init__(self, group=None, axis_names: Tuple[str, ...] = (
            DATA_AXIS,), *, axis_groups: Optional[Dict] = None,
            ranks: Optional[Sequence[int]] = None,
            dims: Optional[Sequence[int]] = None, member: bool = True):
        self.group = group
        self.axis_names = tuple(axis_names)
        if axis_groups is None:
            if len(self.axis_names) != 1:
                raise ValueError(
                    f"Mesh(group, {self.axis_names}): a group makes a 1-D "
                    f"mesh; build N-D meshes with get_mesh(shape, names)")
            axis_groups = {self.axis_names[0]: group}
        self._groups = dict(axis_groups)
        self._ranks = None if ranks is None else tuple(int(r) for r in ranks)
        self._dims = None if dims is None else tuple(int(d) for d in dims)
        #: whether this rank is one of the mesh's (False: a layout only)
        self.member = bool(member)

    @property
    def ranks(self) -> Tuple[int, ...]:
        """The global ranks of the mesh's positions, row-major."""
        if self._ranks is None:
            if self.group is None or not _live():
                self._ranks = (dist.get_rank() if _live() else 0,)
            else:
                self._ranks = tuple(dist.get_process_group_ranks(
                    self.group))
        return self._ranks

    @property
    def dims(self) -> Tuple[int, ...]:
        """The extent of each axis, in `axis_names` order."""
        if self._dims is None:
            self._dims = tuple(self.axis_size(n) for n in self.axis_names)
        return self._dims

    def axis_group(self, name: str):
        """This rank's process group along axis `name` (None: a world of
        one)."""
        if name not in self._groups:
            raise ValueError(f"mesh {self.axis_names} has no axis {name!r}")
        if not self.member:
            raise ValueError(f"this rank is outside the mesh {self.ranks}: "
                             f"it holds the layout, not the groups")
        return self._groups[name]

    def axis_size(self, name: str) -> int:
        if not self.member:
            if name not in self.axis_names:
                raise ValueError(
                    f"mesh {self.axis_names} has no axis {name!r}")
            return self._dims[self.axis_names.index(name)]
        g = self.axis_group(name)
        if g is None or not _live():
            return 1
        return dist.get_world_size(g)

    def axis_index(self, name: str) -> int:
        g = self.axis_group(name)
        if g is None or not _live():
            return 0
        return dist.get_rank(g)

    @property
    def shape(self) -> Dict[str, int]:
        return {n: self.axis_size(n) for n in self.axis_names}

    @property
    def size(self) -> int:
        if not self.member:
            return math.prod(self.dims)
        if self.group is None or not _live():
            return 1
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        if self.group is None or not _live():
            return 0
        return dist.get_rank(self.group)

    def flat_index(self, axes: Sequence[str]) -> int:
        """This rank's row-major index over `axes` (in mesh order), the
        other axes left out: the dropout stream of a rank, which the
        ranks of a tensor-parallel axis share (they hold the same
        activations)."""
        idx = 0
        for name in self.axis_names:
            if name in axes:
                idx = idx * self.axis_size(name) + self.axis_index(name)
        return idx

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def get_mesh(shape: Optional[Sequence[int]] = None,
             axis_names: Tuple[str, ...] = (DATA_AXIS,),
             devices=None, allow_outside: bool = False) -> Mesh:
    """The mesh of `shape` over `axis_names` across every process of the
    initialised group (one process with no group when none is), ranks
    laid out row-major. `shape` None is the 1-D mesh over the ranks.
    `devices` lays it over a subset of the group instead: a list of
    ranks, or of devices that map one to one onto ranks (a device's
    `index`, or a port `Device`'s `id`), in mesh order; every rank of
    the group must still call this (group creation is collective), and
    a rank outside the subset gets a ValueError, or with
    `allow_outside=True` the mesh's layout (`member` False: `ranks`,
    `dims` and `axis_size` answer, no group is held). The product of
    `shape` must be the number of ranks the mesh spans."""
    axis_names = tuple(axis_names)
    world = dist.get_world_size() if _live() else 1
    ranks = list(range(world)) if devices is None else [
        _rank_of(d) for d in devices]
    if len(set(ranks)) != len(ranks) or not all(
            0 <= r < world for r in ranks):
        raise ValueError(f"mesh devices {ranks} are not distinct ranks of "
                         f"the {world} processes of the group")
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError(
                f"mesh shape None does not match axis names {axis_names}")
        shape = (len(ranks),)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(
            f"mesh shape {shape} does not match axis names {axis_names}")
    if math.prod(shape) != len(ranks):
        raise ValueError(
            f"mesh shape {shape} does not match the {len(ranks)} processes "
            f"of the " + ("group" if devices is None else "devices"))
    if not _live():
        return Mesh(None, axis_names, axis_groups={n: None
                                                   for n in axis_names},
                    ranks=ranks, dims=shape)
    rank = dist.get_rank()
    whole = ranks == list(range(world))
    mesh_group = dist.group.WORLD if whole else dist.new_group(ranks)
    groups = {}
    for a, name in enumerate(axis_names):
        if shape[a] == len(ranks):
            groups[name] = mesh_group
            continue
        # every rank makes every group of this axis, in the same order
        for pos in _axis_rank_sets(shape, a):
            members = [ranks[i] for i in pos]
            g = dist.new_group(members)
            if rank in members:
                groups[name] = g
    if rank not in ranks:
        if allow_outside:
            return Mesh(None, axis_names,
                        axis_groups={n: None for n in axis_names},
                        ranks=ranks, dims=shape, member=False)
        raise ValueError(f"rank {rank} is not among the mesh's devices "
                         f"{ranks}")
    return Mesh(mesh_group, axis_names, axis_groups=groups, ranks=ranks,
                dims=shape)


def _rank_of(device) -> int:
    """The rank a mesh device names: an int, a torch.device's index or a
    port Device's id."""
    if isinstance(device, int):
        return device
    for attr in ("index", "id"):
        v = getattr(device, attr, None)
        if isinstance(v, int):
            return v
    raise ValueError(f"mesh device {device!r} names no rank: pass ranks, "
                     f"or devices with an index")


def get_mesh_3d(dp: int = 1, tp: int = 1, sp: int = 1,
                axis_names: Tuple[str, str, str] = (DATA_AXIS, MODEL_AXIS,
                                                    SEQ_AXIS),
                devices=None) -> Mesh:
    """The dp x tp x sp mesh of the 3-D recipe (reference :76-93): "data"
    carries the batch shards, "model" the Megatron column/row shards,
    "sp" the ring's sequence shards. The order is the reference's: the
    model and sp axes vary fastest, so ranks d*tp*sp + m*sp + s."""
    return get_mesh((dp, tp, sp), tuple(axis_names), devices=devices)


def _axis_rank_sets(shape: Tuple[int, ...], axis: int):
    """The rank sets of axis `axis`: for each index of the other axes
    (row-major), the ranks that differ only along `axis`, in order."""
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    others = [i for i in range(len(shape)) if i != axis]
    sets = []
    for flat in range(math.prod(shape[i] for i in others)):
        base, rem = 0, flat
        for i in reversed(others):
            base += (rem % shape[i]) * strides[i]
            rem //= shape[i]
        sets.append([base + j * strides[axis] for j in range(shape[axis])])
    return sets


def axis_entry(*axis_names: Optional[str]):
    """Collapse mesh-axis names into one PartitionSpec dim entry: Nones
    drop out; no names -> None, one name -> that name, several -> a
    tuple (the first name major)."""
    named = tuple(a for a in axis_names if a)
    if not named:
        return None
    if len(named) == 1:
        return named[0]
    return named


def local_world_size() -> int:
    """The processes of the group (each drives one device)."""
    return dist.get_world_size() if _live() else 1


# -- the SPMD axis context -------------------------------------------------------

_state = threading.local()


def _stack():
    if not hasattr(_state, "axes"):
        _state.axes = []
    return _state.axes


@contextmanager
def axis_context(axis_name: str, mesh: Optional[Mesh] = None):
    """Mark `axis_name` (an axis of `mesh`) live while the block runs."""
    _stack().append((axis_name, mesh))
    try:
        yield
    finally:
        _stack().pop()


@contextmanager
def axes_context(*axis_names: str, mesh: Optional[Mesh] = None):
    """Enter several axis contexts at once, as the reference's SPMD
    wrapper does for every axis of the mesh (the distributed step enters
    all of them)."""
    s = _stack()
    s.extend((n, mesh) for n in axis_names)
    try:
        yield
    finally:
        del s[len(s) - len(axis_names):]


def live_axes() -> Tuple:
    """A snapshot of this thread's live axes (names and meshes)."""
    return tuple(_stack())


@contextmanager
def restore_axes(snapshot):
    """Run the block with exactly `snapshot`'s axes live on this thread.
    The autograd engine runs a CUDA backward on a thread of its own, so a
    forward recomputed there (a checkpointed or prefetched block) must
    bring the axes its first run saw."""
    s = _stack()
    saved = list(s)
    s[:] = list(snapshot)
    try:
        yield
    finally:
        s[:] = saved


def in_axis(axis_name: str) -> bool:
    return any(n == axis_name for n, _ in _stack())


def _axis_mesh(axis_name: str) -> Optional[Mesh]:
    for n, m in reversed(_stack()):
        if n == axis_name:
            return m
    raise ValueError(f"axis {axis_name!r} is not live: enter "
                     f"axis_context({axis_name!r}, mesh) first")


def axis_size(axis_name: str) -> int:
    """The size of a live axis (the reference's `psum(1, axis)`)."""
    m = _axis_mesh(axis_name)
    return 1 if m is None else m.axis_size(axis_name)


def axis_index(axis_name: str) -> int:
    """This rank's index along a live axis (`lax.axis_index`)."""
    m = _axis_mesh(axis_name)
    return 0 if m is None else m.axis_index(axis_name)


def axis_group(axis_name: str):
    """This rank's process group along a live axis (None: a world of
    one)."""
    m = _axis_mesh(axis_name)
    return None if m is None else m.axis_group(axis_name)


# -- the batch axis ------------------------------------------------------------


def _batch_stack():
    if not hasattr(_state, "batch_axes"):
        _state.batch_axes = []
    return _state.batch_axes


@contextmanager
def batch_axis_context(axis_name: str, size: int = 0, group=None):
    """Mark `axis_name` (its `size` and process `group`) as the batch axis
    while the block runs; batch-statistic ops sync over it."""
    _batch_stack().append((axis_name, int(size), group))
    try:
        yield
    finally:
        _batch_stack().pop()


def current_batch_axis() -> Optional[str]:
    s = _batch_stack()
    return s[-1][0] if s else None


def current_batch_axis_size() -> int:
    """Extent of the active batch axis (1 when none / unknown)."""
    s = _batch_stack()
    return max(1, s[-1][1]) if s else 1


def current_batch_group():
    """The process group of the active batch axis (None when none)."""
    s = _batch_stack()
    return s[-1][2] if s else None


# -- shape discovery -------------------------------------------------------------


@contextmanager
def discovery_context():
    """Mark a shape-discovery pass (the reference runs one outside its
    SPMD wrapper to learn a step's output structure): ops whose shapes
    depend on a collective check `in_discovery` and make placeholders."""
    prev = getattr(_state, "discovery", 0)
    _state.discovery = prev + 1
    try:
        yield
    finally:
        _state.discovery = prev


def in_discovery() -> bool:
    return getattr(_state, "discovery", 0) > 0
