"""The data axis and its batch context (counterpart of the data-axis part
of singa_tpu/parallel/mesh.py).

The reference's mesh is a `jax.sharding.Mesh` of chips with named axes.
Here the one axis the port has, `DATA_AXIS`, is a `torch.distributed`
process group with one process a rank: `Mesh` names the group (None
when no group is initialised, a world of 1 whose collectives are the
identity). The tensor, sequence, expert and pipe axes come with ROADMAP
queue 1 items 13-15.

`batch_axis_context` marks the data group as THE batch axis while a
distributed step runs (`model.Model` enters it under DistOpt):
`autograd.batchnorm(sync=None)` then averages its moments over the
group (cross-replica BN, reference :167-180).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional, Sequence, Tuple

import torch.distributed as dist

__all__ = ["DATA_AXIS", "Mesh", "get_mesh", "batch_axis_context",
           "current_batch_axis", "current_batch_axis_size",
           "current_batch_group"]

#: data parallelism: batch shards and DistOpt's gradient sync
DATA_AXIS = "data"


class Mesh:
    """A 1-D data mesh: `group` (a process group, or None for the world
    of one process with no group) under `axis_names[0]`. `shape` maps the
    axis to the group's size, as a jax mesh's does."""

    def __init__(self, group=None, axis_names: Tuple[str, ...] = (
            DATA_AXIS,)):
        if len(axis_names) != 1:
            raise NotImplementedError(
                f"a mesh over {axis_names}: only the 1-D data mesh is "
                f"ported (ROADMAP queue 1 item 13)")
        self.group = group
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        if self.group is None or not dist.is_initialized():
            return 1
        return dist.get_world_size(self.group)

    @property
    def shape(self):
        return {self.axis_names[0]: self.size}

    @property
    def rank(self) -> int:
        if self.group is None or not dist.is_initialized():
            return 0
        return dist.get_rank(self.group)


def get_mesh(shape: Optional[Sequence[int]] = None,
             axis_names: Tuple[str, ...] = (DATA_AXIS,),
             devices=None) -> Mesh:
    """The data mesh over every process of the initialised group (one
    process with no group when none is). `shape`, when given, must be
    that world; a device subset is not ported (item 13)."""
    if devices is not None:
        raise NotImplementedError(
            "get_mesh(devices=): a mesh over a device subset is not ported "
            "(ROADMAP queue 1 item 13); each process of the group is one "
            "device")
    mesh = Mesh(dist.group.WORLD if dist.is_initialized() else None,
                axis_names)
    if shape is not None and tuple(shape) != (mesh.size,):
        raise ValueError(
            f"mesh shape {tuple(shape)} does not match the {mesh.size} "
            f"processes of the group")
    return mesh


# -- the batch axis ------------------------------------------------------------

_state = threading.local()


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
