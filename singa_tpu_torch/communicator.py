"""Communicator and DistOpt (counterpart of singa_tpu/communicator.py:140-1429):
data-parallel gradient sync over `torch.distributed`.

The reference emits XLA collectives inside a `shard_map` over its data
axis. Here each rank is one process and the collectives are
`torch.distributed` calls on the mesh's process group: NCCL on the card,
gloo on the CPU. A mean is a SUM followed by `/ world`, exact at world
1, so NCCL and gloo take one code path, and on the card a world-1 group
really launches NCCL. When the mesh has no process group (no `init`),
every collective is the identity, the reference's "outside SPMD" case.
`reduce_scatter` and `all_gather` are the backends' own
`reduce_scatter_tensor` and `all_gather_into_tensor` (gloo has both in
the torch this runs on; torch 2.13 renames them `reduce_scatter_single`
and `all_gather_single` and warns on the old names, so the new name is
called where torch has it); ZeRO-1's step runs on them.

Every collective here is capturable in a CUDA Graph with its step
(`graph.GraphStep`): it enqueues on the current stream and reads no
value on the host.

`DistOpt` wraps a local optimizer: `backward_and_update` (fused buckets
of at most `buffSize` elements, one all-reduce each, then the wrapped
optimizer's clipping and update), `backward_and_update_half` (a bf16
wire), `backward_and_sparse_update` (top-k or threshold selection with
error-feedback residuals; the residuals and the threshold mode's
dropped-entry count stay on the device) and
`backward_and_partial_update`. With `shard_states=True` (ZeRO-1)
`backward_and_update` reduce-scatters one flat gradient, updates this
rank's 1/world shard of the flat parameter vector (the wrapped
optimizer's slots exist only for that shard) and all-gathers it back;
`half_wire` and `gather_half` put the two collectives on a bf16 wire,
`overlap` runs one pair a `plan_buckets` bucket. `grad_axes` names
the mesh axes every gradient reduces over: in each mode a gradient is
first averaged over the live ones other than the data axis (a
sequence-parallel model's distributed step adds its seq axis, an
expert-parallel one its expert axis), in fused buckets, then synced
over the data axis as above. The sync is pspec-aware
(`_grad_axes_for`): a parameter sharded over a grad axis (a ZeRO-3
stack over the data axis, an expert shard over the expert axis) skips
that axis and is divided by its size, and one set of fused buckets is
made for each distinct axis set. `set_sentinel` attaches a
`resilience.GradSentinel` to the wrapped optimizer (reference :561-572):
the loss is scaled before the backward in the plain, half and ZeRO-1
syncs, and the ZeRO-1 step keeps the reference's sentinel branches (the
shard unscaled and checked over the group's square sum, a skipped step's
shard, slots and step counter put back, branch-free); the sparse and
partial-update modes refuse it.

`is_per_chip_state_key` and `opt_state_pspec` (reference :91-116) say
how an optimizer state lies over the ranks: the checkpoint's manifest
and its elastic restore read them.

`all_gather_tiled` is ZeRO-3's per-block weight gather (its backward a
reduce-scatter); `pspec_axis_names` gives the axes a parameter is
sharded over.

`psum_over`, `pmean_over` and `broadcast_from` are the reference's
functional collectives over mesh axis names (the live axes of
`parallel.mesh`'s context), differentiable `torch.autograd.Function`s
over each axis's process group.

Each collective here first calls `analysis.trace.record` (a no-op
unless a shardlint recorder is active), naming the mesh axis it serves;
an axis of one rank that a functional collective skips is recorded as
not run.

`plan_buckets` plans through the native library (`native/comm_core.cc`,
`singa_tpu_torch.native.plan_buckets_native`), as the reference's
distributed step can: the fused all-reduce and ZeRO-1's overlapped
buckets ask for it, and a missing or refusing g++ raises
`native.NativeBuildError` rather than planning in Python.
`plan_buckets_plain` is the port's own copy of the reference's Python
planner, the oracle the library is held to.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from singa_tpu_torch import autograd
from singa_tpu_torch.analysis import trace as _trace
from singa_tpu_torch.parallel import mesh as mesh_module

__all__ = ["Communicator", "DistOpt", "plan_buckets",
           "plan_buckets_plain", "pmean_over",
           "psum_over", "broadcast_from", "all_gather_tiled",
           "pspec_axis_names", "is_per_chip_state_key", "opt_state_pspec"]


def is_per_chip_state_key(k: str) -> bool:
    """True for optimizer-state keys holding PER-RANK data (reference
    :91-96): sparse error-feedback residuals and ZeRO-1 shards. The
    reference stacks them `(world, ...)` over its data axis; a rank here
    holds its own row."""
    return k.endswith("//__residual__") or "//__zshard__" in k


def opt_state_pspec(key: str, params_pspec: Dict[str, Tuple],
                    axis_name: Optional[str], ndim: int) -> Tuple:
    """The pspec of an optimizer-state key (reference :99-116): per-rank
    entries split their leading world dim over the comm axis, slots take
    their parameter's pspec, scalars and ownerless keys replicate.
    `ndim` is the state's rank: a scalar under a parameter's name does
    not take the parameter's pspec."""
    if is_per_chip_state_key(key):
        return (axis_name,) if axis_name else ()
    spec = tuple(params_pspec.get(key.rpartition("//")[0], ()) or ())
    if ndim < len(spec):
        return ()
    return spec


class _GroupMean(torch.autograd.Function):
    """The mean over a process group, differentiable: the backward takes
    the mean of the cotangent over the group, the transpose of the
    reference's `pmean`."""

    @staticmethod
    def forward(ctx, x, group, world, axis):
        ctx.group, ctx.world, ctx.axis = group, world, axis
        return _mean(x, group, world, axis)

    @staticmethod
    def backward(ctx, g):
        return _mean(g, ctx.group, ctx.world, ctx.axis), None, None, None


def _mean(x: torch.Tensor, group, world: int, axis) -> torch.Tensor:
    _trace.record("psum", x, axis=axis, group=group)
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y / world


def group_mean(x: torch.Tensor, group, world: int) -> torch.Tensor:
    """The differentiable mean of `x` over a process `group` of `world`
    ranks (batchnorm's cross-replica moments, over the batch axis)."""
    return _GroupMean.apply(x, group, world,
                            mesh_module.current_batch_axis())


# -- the functional collectives over axis names (reference :61-90) --------------
#
# Each reduces over the live mesh axes it names (`parallel.mesh`'s axis
# context), one all-reduce per axis of more than one rank; an axis of
# one rank is the identity. They are differentiable with the adjoints of
# the reference's SPMD program, where every rank's loss adds into the
# objective: psum's is psum, pmean's pmean, and broadcast_from's the sum
# of the cotangents landing on the root.


def _live_axes(axes) -> Tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in axes if mesh_module.axis_size(a) > 1)


def _skipped(op: str, x: torch.Tensor, axes, live) -> None:
    """Record the axes of one rank that a functional collective skips
    (the reference's program reduces over them all the same)."""
    if _trace.recording():
        for a in (axes,) if isinstance(axes, str) else axes:
            if a not in live:
                _trace.record(op, x, axis=a, group=mesh_module.axis_group(a),
                              ran=False)


def _reduce_groups(x: torch.Tensor, groups, mean: bool) -> torch.Tensor:
    for group, size, axis in groups:
        _trace.record("psum", x, axis=axis, group=group)
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        x = y / size if mean else y
    return x


class _AxesReduce(torch.autograd.Function):
    """The reduction over the axes' groups, resolved in the forward (the
    backward may run on the autograd engine's thread, where no axis is
    live)."""

    @staticmethod
    def forward(ctx, x, axes, mean):
        ctx.groups = [(mesh_module.axis_group(ax), mesh_module.axis_size(ax),
                       ax) for ax in axes]
        ctx.mean = mean
        return _reduce_groups(x, ctx.groups, mean)

    @staticmethod
    def backward(ctx, g):
        return _reduce_groups(g, ctx.groups, ctx.mean), None, None


def psum_over(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum of `x` over the named mesh axes (one name or several)."""
    live = _live_axes(axes)
    _skipped("psum", x, axes, live)
    return _AxesReduce.apply(x, live, False) if live else x


def pmean_over(x: torch.Tensor, axes) -> torch.Tensor:
    """The mean of `x` over the named mesh axes (graph.py's merge of the
    loss, the extra gradient axes of DistOpt)."""
    live = _live_axes(axes)
    _skipped("psum", x, axes, live)
    return _AxesReduce.apply(x, live, True) if live else x


class _BroadcastFrom(torch.autograd.Function):
    """psum of the root-masked value (reference :78-90): shard `root`'s
    `x` on every rank of the axis; the backward sums the cotangents of
    every rank onto the root and gives the others zero."""

    @staticmethod
    def forward(ctx, x, axis, root):
        ctx.group, ctx.axis = mesh_module.axis_group(axis), axis
        ctx.mine = mesh_module.axis_index(axis) == root
        _trace.record("psum", x, axis=axis, group=ctx.group)
        y = (x if ctx.mine else torch.zeros_like(x)).contiguous().clone()
        dist.all_reduce(y, group=ctx.group)
        return y

    @staticmethod
    def backward(ctx, g):
        _trace.record("psum", g, axis=ctx.axis, group=ctx.group)
        y = g.contiguous().clone()
        dist.all_reduce(y, group=ctx.group)
        if not ctx.mine:
            y = torch.zeros_like(y)
        return y, None, None


def broadcast_from(x: torch.Tensor, axis_name: str, root: int = 0
                   ) -> torch.Tensor:
    """Shard `root`'s value of `x` on every rank of a live axis (Bert's
    CLS row, which lives on sequence shard 0)."""
    if mesh_module.axis_size(axis_name) == 1:
        _skipped("psum", x, axis_name, ())
        return x
    return _BroadcastFrom.apply(x, axis_name, int(root))


class _GatherTiled(torch.autograd.Function):
    """The tiled all-gather along `dim` over an axis group; its backward
    reduce-scatters (sums) the cotangent back to this rank's shard."""

    @staticmethod
    def forward(ctx, x, group, world, dim, axis):
        ctx.cfg = (group, world, dim, axis)
        return _gather_dim(x, group, world, dim, axis=axis)

    @staticmethod
    def backward(ctx, g):
        group, world, dim, axis = ctx.cfg
        return (_scatter_dim(g, group, world, dim, axis=axis), None, None,
                None, None)


def _gather_dim(x: torch.Tensor, group, world: int, dim: int,
                async_op: bool = False, axis: Optional[str] = None):
    """The shards of the group joined along `dim`: gathered into a
    leading world dim (the backends gather along dim 0), then moved.
    With `async_op` returns (work, finish), `finish()` giving the
    result once the work is waited on. `axis` names the mesh axis for
    the shardlint record."""
    _trace.record("all_gather", x, axis=axis, group=group)
    y = x.contiguous()
    flat = y.new_empty((world * y.shape[0], *y.shape[1:]))
    work = _all_gather_into_tensor(flat, y, group=group, async_op=async_op)

    def finish():
        out = flat.view(world, *y.shape)
        return out.movedim(0, dim).reshape(
            *y.shape[:dim], world * y.shape[dim], *y.shape[dim + 1:])

    return (work, finish) if async_op else finish()


def _scatter_dim(g: torch.Tensor, group, world: int, dim: int,
                 axis: Optional[str] = None) -> torch.Tensor:
    """This rank's chunk along `dim` of the sum of `g` over the group."""
    _trace.record("reduce_scatter", g, axis=axis, group=group)
    shape = list(g.shape)
    n = shape[dim] // world
    send = g.reshape(*shape[:dim], world, n, *shape[dim + 1:]).movedim(
        dim, 0).contiguous()
    out = send.new_empty(send.shape[1:])
    _reduce_scatter_tensor(
        out, send.view(world * out.shape[0], *out.shape[1:]), group=group)
    return out


def all_gather_tiled(x: torch.Tensor, axis_name: str,
                     dim: int = 0) -> torch.Tensor:
    """The tiled all-gather of `x` along `dim` over a live mesh axis
    (reference :73-78): the ZeRO-3 per-block weight gather of
    `layer.ScanTransformerStack`. Differentiable: its backward is the
    tiled reduce-scatter (sum) of the cotangent back to the shard.
    Outside the axis, or on an axis of one rank with no group, the
    identity."""
    if not mesh_module.in_axis(axis_name):
        return x
    group = mesh_module.axis_group(axis_name)
    if group is None:
        _trace.record("all_gather", x, axis=axis_name, ran=False)
        return x
    return _GatherTiled.apply(x, group, mesh_module.axis_size(axis_name),
                              dim, axis_name)


def pspec_axis_names(p) -> frozenset:
    """The mesh axes a parameter's pspec shards over (empty for a
    replicated one; reference :118-137). The pspec-aware reductions
    read it: a gradient of a parameter sharded over an axis is already
    that axis's sum (the gather's or the all-to-all's backward), so it
    skips that axis's reduction, and its square sum enters a global
    norm only after a sum over it."""
    names = set()
    for entry in getattr(p, "pspec", None) or ():
        if isinstance(entry, (tuple, list)):
            names.update(a for a in entry if a)
        elif entry is not None:
            names.add(entry)
    return frozenset(names)


class Communicator:
    """Collectives over the mesh's process group (see the module
    docstring)."""

    def __init__(self, mesh: Optional[mesh_module.Mesh] = None,
                 axis_name: str = mesh_module.DATA_AXIS):
        if mesh is not None and axis_name not in mesh.axis_names:
            if len(mesh.axis_names) != 1:
                raise ValueError(f"mesh {mesh.axis_names} has no axis "
                                 f"{axis_name!r}")
            axis_name = mesh.axis_names[0]  # a 1-D mesh: its one axis
        self.mesh = mesh
        self.axis_name = axis_name

    @property
    def world_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.axis_size(
            self.axis_name)

    @property
    def rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.axis_index(
            self.axis_name)

    @property
    def group(self):
        return None if self.mesh is None else self.mesh.axis_group(
            self.axis_name)

    def _active(self) -> bool:
        """True when a process group is initialised under the mesh (at
        any world, 1 included)."""
        return (self.mesh is not None and self.mesh.group is not None
                and dist.is_initialized())

    def _sum(self, x: torch.Tensor) -> torch.Tensor:
        _trace.record("psum", x, axis=self.axis_name, group=self.group)
        y = x.contiguous().clone()
        dist.all_reduce(y, group=self.group)
        return y

    def _gather(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """The shards of every rank joined along `axis`, by the backend's
        own all-gather into one tensor."""
        _trace.record("all_gather", x, axis=self.axis_name, group=self.group)
        y = x.movedim(axis, 0).contiguous()
        out = y.new_empty((self.world_size * y.shape[0], *y.shape[1:]))
        _all_gather_into_tensor(out, y, group=self.group)
        return out.movedim(0, axis)

    def _scatter(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """This rank's chunk along `axis` of the sum over the group, by
        the backend's own reduce-scatter."""
        _trace.record("reduce_scatter", x, axis=self.axis_name,
                      group=self.group)
        y = x.movedim(axis, 0).contiguous()
        if y.shape[0] % self.world_size:
            raise ValueError(
                f"reduce_scatter: axis {axis} has {y.shape[0]} entries, not "
                f"a multiple of the world {self.world_size}")
        out = y.new_empty((y.shape[0] // self.world_size, *y.shape[1:]))
        _reduce_scatter_tensor(out, y, group=self.group)
        return out.movedim(0, axis)

    # -- core collectives ------------------------------------------------------
    def all_reduce(self, x: torch.Tensor, average: bool = True
                   ) -> torch.Tensor:
        """Sum (or mean) over the data group (reference `synch`, :162)."""
        if not self._active():
            return x
        y = self._sum(x)
        return y / self.world_size if average else y

    def all_reduce_half(self, x: torch.Tensor, average: bool = True,
                        axes=None) -> torch.Tensor:
        """The bf16 wire (reference :174): cast to bfloat16, sum in bf16,
        cast back to the input dtype, then the mean. `axes` names the
        axes to reduce over (None: the data axis; an empty tuple:
        none)."""
        axes = (self.axis_name,) if axes is None else tuple(axes)
        if self.axis_name not in axes or not self._active():
            return x
        y = self._sum(x.to(torch.bfloat16)).to(x.dtype)
        return y / self.world_size if average else y

    def all_gather(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """The shards of every rank joined along `axis` (tiled; reference
        :197)."""
        return self._gather(x, axis) if self._active() else x

    def reduce_scatter(self, x: torch.Tensor, axis: int = 0,
                       average: bool = True) -> torch.Tensor:
        """This rank's chunk along `axis` of the sum (or mean) over the
        group (tiled; reference :205); the axis must divide by the
        world."""
        if not self._active():
            return x
        y = self._scatter(x, axis)
        return y / self.world_size if average else y

    def reduce_scatter_half(self, x: torch.Tensor, axis: int = 0,
                            average: bool = True) -> torch.Tensor:
        """The bf16-wire reduce-scatter (reference :215): summed in bf16,
        cast back to the input dtype before the mean."""
        if not self._active():
            return x
        y = self._scatter(x.to(torch.bfloat16), axis).to(x.dtype)
        return y / self.world_size if average else y

    def all_gather_half(self, x: torch.Tensor, axis: int = 0
                        ) -> torch.Tensor:
        """The bf16-wire all-gather (reference :230; rounds the gathered
        values)."""
        if not self._active():
            return x
        return self._gather(x.to(torch.bfloat16), axis).to(x.dtype)

    def broadcast(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        """Rank `root`'s value on every rank."""
        if not self._active():
            return x
        _trace.record("broadcast", x, axis=self.axis_name, group=self.group)
        y = x.contiguous().clone()
        dist.broadcast(y, dist.get_global_rank(self.group, root)
                       if self.group is not dist.group.WORLD else root,
                       group=self.group)
        return y

    # -- fused all-reduce ------------------------------------------------------
    def fused_all_reduce(self, arrays: Sequence[torch.Tensor],
                         average: bool = True, bucket_elems: int = 2 ** 21,
                         axes=None) -> List[torch.Tensor]:
        """Pack the tensors into flat buckets of at most `bucket_elems`
        elements (`plan_buckets`), one all-reduce a bucket, and unpack
        (reference `fusedSynch`; `bucket_elems` is its `buffSize`)."""
        if not arrays:
            return []
        axes = (self.axis_name,) if axes is None else tuple(axes)
        reduce = self.axis_name in axes and self._active()
        sizes = [a.numel() for a in arrays]
        # each tensor packs in its memory order and unpacks as a view with
        # its own strides (a channels-last weight gradient stays one), so
        # what reads the result (the clip's norm) reduces in the order it
        # would read the tensor itself
        orders = [_memory_order(a) for a in arrays]
        out: List[Optional[torch.Tensor]] = [None] * len(arrays)
        for bucket in plan_buckets(sizes, bucket_elems):
            flat = torch.cat([arrays[i].permute(orders[i]).reshape(-1)
                              for i in bucket])
            if reduce:
                _trace.record("psum", flat, axis=self.axis_name,
                              group=self.group)
                dist.all_reduce(flat, group=self.group)
                if average:
                    flat = flat / self.world_size
            for i, part in zip(bucket, flat.split([sizes[i]
                                                   for i in bucket])):
                order = orders[i]
                out[i] = part.view([arrays[i].shape[d] for d in order]
                                   ).permute(_inverse(order))
        return out  # type: ignore[return-value]

    def reduce_scatter_buckets(self, bucket_flats, average: bool = True,
                               half: bool = False):
        """One reduce-scatter a bucket (reference :294; each flat already
        padded to a world multiple): DistOpt(overlap=True)'s sync."""
        fn = self.reduce_scatter_half if half else self.reduce_scatter
        return [fn(f, axis=0, average=average) for f in bucket_flats]

    def all_gather_buckets(self, bucket_shards, half: bool = False):
        """One all-gather a bucket shard, the inverse of
        `reduce_scatter_buckets` (reference :309)."""
        fn = self.all_gather_half if half else self.all_gather
        return [fn(s, axis=0) for s in bucket_shards]

    # -- sparsified all-reduce -------------------------------------------------
    def sparse_all_reduce(self, arr: torch.Tensor, spars: float = 0.05,
                          topK: bool = True, average: bool = True,
                          return_local: bool = False, max_frac: float = 0.25,
                          return_stats: bool = False):
        """Sparsified sync (reference `sparsification`).

        topK=True keeps the k = ceil(spars * n) entries of largest |g| on
        each rank; topK=False keeps the entries with |g| >= spars, taken
        from a fixed top-k of k = ceil(max_frac * n) so the shapes stay
        static (entries over the threshold outside that top-k are dropped
        this step; `return_stats` appends their local count, a float32
        device scalar, 0 in topK mode). The (values, indices) of every
        rank are gathered and scatter-added into the dense result, then
        averaged. `return_local` also returns this rank's own densified
        selection, the term error feedback subtracts."""
        flat = arr.reshape(-1)
        n = flat.numel()
        k = max(1, math.ceil(float(spars) * n)) if topK else max(
            1, math.ceil(max_frac * n))
        idxs = torch.topk(flat.abs(), k).indices
        sel = flat[idxs]
        dropped = torch.zeros((), dtype=torch.float32, device=flat.device)
        if not topK:
            keep = sel.abs() >= spars
            sel = torch.where(keep, sel, torch.zeros_like(sel))
            if return_stats:
                dropped = ((flat.abs() >= spars).sum() - keep.sum()).to(
                    torch.float32)
        local = torch.zeros_like(flat).index_add_(0, idxs, sel)
        if self._active():
            dense = torch.zeros_like(flat).index_add_(
                0, self._gather(idxs), self._gather(sel))
            if average:
                dense = dense / self.world_size
        else:
            dense = local
        outs = [dense.view(arr.shape)]
        if return_local:
            outs.append(local.view(arr.shape))
        if return_stats:
            outs.append(dropped)
        return outs[0] if len(outs) == 1 else tuple(outs)

    # the reference's names
    synch = all_reduce
    fusedSynch = fused_all_reduce
    sparsification = sparse_all_reduce


#: the backends' own reduce-scatter and all-gather into one tensor, under
#: the name torch 2.13 gives them where torch has it
_reduce_scatter_tensor = (getattr(dist, "reduce_scatter_single", None)
                          or dist.reduce_scatter_tensor)
_all_gather_into_tensor = (getattr(dist, "all_gather_single", None)
                           or dist.all_gather_into_tensor)


def _pad(flat: torch.Tensor, n: int) -> torch.Tensor:
    """`flat` zero-padded to `n` entries (itself when it has them)."""
    return flat if flat.numel() == n else F.pad(flat, (0, n - flat.numel()))


def _cat(parts: List[torch.Tensor]) -> torch.Tensor:
    """torch.cat, without the copy of a single part."""
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _memory_order(t: torch.Tensor) -> List[int]:
    """t's dims from the largest stride down: t.permute(order) is
    contiguous for a dense tensor in any memory format."""
    return sorted(range(t.dim()), key=lambda d: (-t.stride(d), d))


def _inverse(order: List[int]) -> List[int]:
    inv = [0] * len(order)
    for k, d in enumerate(order):
        inv[d] = k
    return inv


def plan_buckets(sizes: Sequence[int], bucket_elems: int
                 ) -> List[List[int]]:
    """Greedy bucket assignment in the native library: consecutive sizes
    packed up to `bucket_elems`; a size over it gets a bucket of its
    own. Raises `native.NativeBuildError` without the library."""
    from singa_tpu_torch import native

    return native.plan_buckets_native(sizes, bucket_elems)


def plan_buckets_plain(sizes: Sequence[int], bucket_elems: int
                       ) -> List[List[int]]:
    """`plan_buckets` in Python: the plain version the library is held
    to."""
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_elems = 0
    for i, s in enumerate(sizes):
        if cur and cur_elems + s > bucket_elems:
            buckets.append(cur)
            cur, cur_elems = [], 0
        cur.append(i)
        cur_elems += s
    if cur:
        buckets.append(cur)
    return buckets


# -- DistOpt -------------------------------------------------------------------

#: the name the wrapped optimizer keeps ZeRO-1's shard proxy (and its slots)
#: under, and the key of gather_half's fp32 master shard (the reference's)
ZSHARD = "__zero1__//__zshard__"
ZMASTER = "__zero1__//__master__//__zshard__"
_DENSE_ONLY = ("shard_states=True composes with the dense fused sync only "
               "(dist_option='plain'): the half/sparse/partial paths update "
               "full parameters and would mint full-size slots, defeating "
               "the sharding")


class DistOpt:
    """Data-parallel optimizer wrapper (reference `singa.opt.DistOpt`,
    `singa_tpu/communicator.py:418-1429`): the gradients are synced over
    the mesh's group after the backward, then the wrapped optimizer
    steps. The reference constructor's `nccl_id`, `local_rank` and
    `world_size` are accepted; the group comes from `distributed.init`
    and the mesh.

    `shard_states=True` is ZeRO-1 (reference :451-476): the gradients
    reduce-scatter instead of all-reducing, each rank updates only its
    1/world shard of the concatenated parameter vector (the wrapped
    optimizer's slots exist only for that shard, `(1, chunk)` on each
    rank where the reference holds the `(world, chunk)` stack), and the
    updated shards all-gather back into the replicated parameters.
    `half_wire` reduce-scatters in bf16, `gather_half` all-gathers in
    bf16 and keeps an fp32 master shard, `overlap` runs one
    reduce-scatter and one all-gather a `plan_buckets(sizes, buffSize)`
    bucket. With no process group the shard is the whole vector (the
    reference's world-1 "outside SPMD" case)."""

    def __init__(self, opt, mesh: Optional[mesh_module.Mesh] = None,
                 axis_name: str = mesh_module.DATA_AXIS, nccl_id=None,
                 local_rank: Optional[int] = None,
                 world_size: Optional[int] = None, buffSize: int = 2 ** 21,
                 use_sparse: bool = False, shard_states: bool = False,
                 grad_axes: Optional[Tuple[str, ...]] = None,
                 half_wire: bool = False, gather_half: bool = False,
                 overlap: bool = False):
        del nccl_id
        if overlap and not shard_states:
            raise ValueError(
                "DistOpt(overlap=True) buckets the ZeRO-1 reduce-scatter "
                "(shard_states=True); the plain DP sync is already "
                "bucketed per-collective via fused_all_reduce - drop "
                "overlap= or add shard_states=True")
        if use_sparse and shard_states:
            raise ValueError(
                "shard_states composes with the dense sync path only "
                "(sparse sync updates from densified gradients whose "
                "residual bookkeeping is per-chip already)")
        if (half_wire or gather_half) and not shard_states:
            raise ValueError(
                "half_wire/gather_half are ZeRO-1 wire formats "
                "(shard_states=True); for plain DP use "
                "dist_option='half' instead")
        grad_axes = tuple(grad_axes) if grad_axes else (axis_name,)
        self.opt = opt
        self.comm = Communicator(mesh, axis_name)
        #: the mesh axes each gradient reduces over: the data axis (the
        #: per-mode sync) and, first, any other live one (a sequence
        #: axis registers itself here; reference :501)
        self.grad_axes: Tuple[str, ...] = grad_axes
        self.buffSize = buffSize
        self.use_sparse = use_sparse
        self.shard_states = bool(shard_states)
        self.half_wire = bool(half_wire)
        self.gather_half = bool(gather_half)
        self.overlap = bool(overlap)
        self._rank_shim = local_rank
        self._world_shim = world_size
        #: error-feedback residuals, keyed by id(param), param-shaped on
        #: each rank (the reference's (world, ...) stack, one row here)
        self._residuals: Dict[int, torch.Tensor] = {}
        #: the threshold mode's dropped-entry count of the LAST step,
        #: over the group: a device scalar written in place each step
        self._sparse_dropped = torch.zeros((), dtype=torch.float32)
        # ZeRO-1's layout, fixed by the first prepare(): the parameters
        # in canonical order, their flat sizes, the world and this
        # rank's chunk, the bucket plan (overlap), the shard proxy the
        # wrapped optimizer keeps its slots against, gather_half's fp32
        # master shard, and the has-gradient masks by pattern
        self._z_params: List[torch.Tensor] = []
        self._z_sizes: List[int] = []
        self._z_world = 1
        self._z_chunk = 0
        self._z_buckets: Optional[List[List[int]]] = None
        self._z_btotals: List[int] = []
        self._z_proxy: Optional[torch.Tensor] = None
        self._z_master: Optional[torch.Tensor] = None
        self._z_master_set = False
        self._z_masks: Dict[Tuple[bool, ...], torch.Tensor] = {}

    # -- introspection ---------------------------------------------------------
    @property
    def world_size(self) -> int:
        ws = self.comm.world_size
        return ws if ws > 1 else (self._world_shim or ws)

    @property
    def local_rank(self) -> int:
        if self.comm._active():
            return self.comm.rank
        return self._rank_shim or 0

    @property
    def lr(self):
        return self.opt.lr

    @property
    def step_counter(self) -> int:
        return self.opt.step_counter

    @step_counter.setter
    def step_counter(self, value: int) -> None:
        self.opt.step_counter = value

    @property
    def sentinel(self):
        return getattr(self.opt, "sentinel", None)

    def set_sentinel(self, sentinel) -> None:
        """Attach a `resilience.GradSentinel` to the wrapped optimizer
        (it owns the update and the state): composes with the plain and
        half syncs and ZeRO-1; the sparse and partial modes refuse it."""
        self.opt.set_sentinel(sentinel)
        if sentinel is not None and self._z_proxy is not None:
            sentinel.to(self._z_proxy.device)

    # -- optimizer protocol ----------------------------------------------------
    def prepare(self, named_params) -> None:
        """Name the parameters' slots and make them (reference :575).
        Under shard_states the wrapped optimizer gets one proxy instead,
        this rank's `(1, chunk)` shard of the flat parameter vector, under
        `ZSHARD`; a second prepare of the same parameters changes nothing
        and one of another set raises."""
        if self.shard_states:
            self._z_prepare(named_params)
            return
        self.opt.prepare(named_params)
        for p in named_params.values():
            self._sparse_dropped = self._sparse_dropped.to(p.device)
            break
        if self.use_sparse:
            for p in named_params.values():
                if id(p) not in self._residuals:
                    self._residuals[id(p)] = torch.zeros_like(p)

    def _z_prepare(self, named_params) -> None:
        for name, p in named_params.items():
            self.opt._names[id(p)] = name
            if getattr(p, "pspec", None):
                raise NotImplementedError(
                    f"DistOpt(shard_states=True) with the sharded parameter "
                    f"{name!r} (pspec {p.pspec}) is not supported: ZeRO-1 "
                    f"shards REPLICATED params over the data axis")
        params = list(named_params.values())
        if self._z_proxy is not None:
            if [id(p) for p in params] != [id(p) for p in self._z_params]:
                raise RuntimeError(
                    "DistOpt(shard_states=True): the parameter set changed "
                    "after the first prepare(); the ZeRO shard layout is "
                    "fixed at first compile - build a fresh DistOpt for the "
                    "new parameter set")
            return
        world = self.comm.world_size
        self._z_params = params
        self._z_sizes = [p.numel() for p in params]
        self._z_world = world
        if self.overlap and params:
            self._z_buckets = plan_buckets(self._z_sizes, self.buffSize)
            self._z_btotals = [sum(self._z_sizes[i] for i in b)
                               for b in self._z_buckets]
            self._z_chunk = sum(self._z_bchunks(world))
        else:
            self._z_chunk = -(-max(1, sum(self._z_sizes)) // world)
        dev = params[0].device if params else torch.device("cpu")
        self._sparse_dropped = self._sparse_dropped.to(dev)
        if self.sentinel is not None:
            self.sentinel.to(dev)
        self._z_proxy = torch.zeros((1, self._z_chunk), dtype=torch.float32,
                                    device=dev)
        if self.gather_half:
            # filled from the parameters at the first step (the reference
            # makes it at its first step's prepare), unless loaded first
            self._z_master = torch.zeros_like(self._z_proxy)
            self._z_master_set = False
        self.opt.prepare({ZSHARD: self._z_proxy})

    def dump_states(self) -> Dict[str, torch.Tensor]:
        """The wrapped optimizer's states (under shard_states the proxy's
        `(1, chunk)` slots, `ZSHARD + "//" + slot`), the residuals, the
        dropped count and gather_half's master shard (`ZMASTER`, once a
        step or a load has set it)."""
        states = dict(self.opt.dump_states())
        for pid, arr in self._residuals.items():
            states[f"{self.opt._names[pid]}//__residual__"] = arr
        if self.use_sparse:
            states["//__sparse_dropped__"] = self._sparse_dropped
        if self._z_master_set:
            states[ZMASTER] = self._z_master
        return states

    def load_states(self, states, strict: bool = False) -> None:
        """Load a `dump_states` dict (the port's or the reference's, in
        place). An entry the reference stacks over its data axis, a
        residual `(world, ...)` or a ZeRO-1 slot or master `(world,
        chunk)`, gives this rank its row."""
        own = {k for k in states if k.endswith("//__residual__")
               or k == "//__sparse_dropped__" or k == ZMASTER}
        rest = {k: self._z_row(k, v) if "//__zshard__" in k else v
                for k, v in states.items() if k not in own}
        self.opt.load_states(rest, strict=strict)
        by_name = {n: pid for pid, n in self.opt._names.items()}
        for k in own:
            arr = torch.as_tensor(states[k])
            if k == "//__sparse_dropped__":
                self._sparse_dropped.copy_(arr)
                continue
            if k == ZMASTER:
                if self._z_master is None:
                    raise RuntimeError(
                        "the states hold the ZeRO gather_half fp32 master "
                        "shard but this DistOpt has none: construct it with "
                        "shard_states=True, gather_half=True and call "
                        "prepare() before load_states")
                self._z_master.copy_(self._z_row(k, arr))
                self._z_master_set = True
                continue
            pid = by_name.get(k[: -len("//__residual__")])
            if pid is None:
                continue
            res = self._residuals.get(pid)
            ndim = None if res is None else res.dim()
            if ndim is not None and arr.dim() == ndim + 1:
                arr = arr[self.local_rank]
            if res is None:
                self._residuals[pid] = arr.clone()
            else:  # in place: a captured step keeps reading `res`
                res.copy_(arr)

    def _z_row(self, key: str, arr) -> torch.Tensor:
        """This rank's `(1, chunk)` row of a ZeRO-1 entry: the port's own
        row as it is, the reference's `(world, chunk)` stack's row
        `rank`."""
        arr = torch.as_tensor(arr)
        if not self._z_chunk:
            return arr
        if arr.dim() == 2 and arr.shape[0] == self._z_world > 1:
            arr = arr[self.comm.rank:self.comm.rank + 1]
        if tuple(arr.shape) != (1, self._z_chunk):
            raise ValueError(
                f"ZeRO entry {key!r} has shape {tuple(arr.shape)}; this "
                f"rank's shard is (1, {self._z_chunk}) at world "
                f"{self._z_world}: reshard a raw dump of another world or "
                f"layout with reshard_raw_states, or load the canonical "
                f"form through reshard_states")
        return arr

    # -- ZeRO-1's layout (plain or bucketed) -----------------------------------
    def zero1_layout(self) -> Optional[Dict]:
        """The world-independent ZeRO-1 layout stamp (reference :710):
        {"overlap", "buckets" (the bucket totals, or None), "total"}; None
        before `prepare` or without shard_states. A raw dump of another
        layout is refused (`reshard_raw_states(layout=)`)."""
        if not self.shard_states or not self._z_sizes:
            return None
        return {"overlap": self._z_bucketed(),
                "buckets": (list(self._z_btotals) if self._z_bucketed()
                            else None),
                "total": sum(self._z_sizes)}

    def _z_bchunks(self, world: int) -> List[int]:
        """Each bucket's per-rank shard length at `world` (the plan itself
        depends only on the sizes and buffSize; reference :734)."""
        return [-(-t // world) for t in self._z_btotals]

    def _z_bucketed(self) -> bool:
        return self.overlap and bool(self._z_buckets)

    @staticmethod
    def _z_flat(tensors, dev, sizes=None) -> torch.Tensor:
        """The fp32 concatenation of `tensors` in logical order; a None
        entry is `sizes[i]` zeros (a parameter without a gradient)."""
        parts = [torch.zeros(sizes[i], dtype=torch.float32, device=dev)
                 if t is None else t.reshape(-1).float()
                 for i, t in enumerate(tensors)]
        return torch.cat(parts) if parts else torch.zeros(
            0, dtype=torch.float32, device=dev)

    def _z_segments(self, flat: torch.Tensor, world: int
                    ) -> List[torch.Tensor]:
        """The canonical flat vector in proxy layout at `world`: one
        padded segment (world * chunk), or one a bucket (world * its
        chunk)."""
        if not self._z_bucketed():
            return [_pad(flat, world * self._z_chunk)]
        out, off = [], 0
        for tot, cb in zip(self._z_btotals, self._z_bchunks(world)):
            out.append(_pad(flat[off:off + tot], world * cb))
            off += tot
        return out

    def _z_shard(self, flat: torch.Tensor, world: int, rank: int
                 ) -> torch.Tensor:
        """Rank `rank`'s proxy-layout shard of a canonical flat vector
        (reference `_z_shard_jnp`, :764)."""
        return _cat([seg.view(world, -1)[rank]
                     for seg in self._z_segments(flat, world)])

    def _z_rows(self, flat: torch.Tensor, world: int) -> torch.Tensor:
        """Canonical flat vector -> the `(world, chunk)` proxy stack
        (reference `_z_proxy_np`, :792)."""
        return torch.cat([seg.view(world, -1) for seg in
                          self._z_segments(flat, world)], dim=1)

    def _z_canonical(self, rows: torch.Tensor) -> torch.Tensor:
        """A `(world, chunk)` proxy stack (its leading dim the world it
        was written at) -> the unpadded canonical flat vector (reference
        `_z_canonical_np`, :743)."""
        rows = rows.reshape(rows.shape[0], -1) if rows.dim() > 1 \
            else rows.reshape(1, -1)
        world, total = rows.shape[0], sum(self._z_sizes)
        if not self._z_bucketed():
            return rows.reshape(-1)[:total]
        parts, off = [], 0
        for tot, cb in zip(self._z_btotals, self._z_bchunks(world)):
            parts.append(rows[:, off:off + cb].reshape(-1)[:tot])
            off += cb
        return torch.cat(parts)

    def _z_mask(self, has_grad: Tuple[bool, ...], dev) -> torch.Tensor:
        """This rank's shard of the has-gradient mask, made once a
        pattern (reference :1208-1220)."""
        mask = self._z_masks.get(has_grad)
        if mask is None:
            flat = torch.cat([torch.full((n,), float(h), device=dev)
                              for h, n in zip(has_grad, self._z_sizes)])
            mask = self._z_masks[has_grad] = self._z_shard(
                flat, self._z_world, self.comm.rank) > 0
        return mask

    # -- world-size-portable state forms ---------------------------------------
    def canonicalize_states(self, states) -> Dict[str, torch.Tensor]:
        """This rank's `dump_states()` -> the world-independent canonical
        form (reference :809): each ZeRO-1 entry becomes the unpadded
        flat vector, each sparse residual the sum over the ranks, the
        rest passes through. A COLLECTIVE: every rank of the group calls
        it, in the same order, with its own dump (the rows of the other
        ranks come over the wire), never inside a captured step."""
        out = {}
        for k, v in states.items():
            arr = torch.as_tensor(v)
            if "//__zshard__" in k:
                if not self._z_sizes:
                    raise RuntimeError(
                        "canonicalize_states: ZeRO entries present but "
                        "prepare() has not established the flat layout")
                out[k] = self._z_canonical(self.comm.all_gather(
                    self._z_row(k, arr)))
            elif k.endswith("//__residual__"):
                out[k] = self.comm.all_reduce(arr, average=False)
            else:
                out[k] = arr
        return out

    def reshard_states(self, states) -> Dict[str, torch.Tensor]:
        """The canonical form (either package's) -> this rank's states at
        this world (reference :848): a flat ZeRO-1 vector becomes this
        rank's `(1, chunk)` row, a residual sum this rank's 1/world share.
        Needs `prepare` first."""
        world, out = self._z_world, {}
        for k, v in states.items():
            arr = torch.as_tensor(v)
            if "//__zshard__" in k:
                if not self._z_chunk:
                    raise RuntimeError(
                        f"reshard_states: canonical ZeRO entry {k!r} but "
                        f"this DistOpt has no ZeRO flat layout: construct "
                        f"it with shard_states=True and call prepare() "
                        f"before loading, or drop the '//__zshard__' "
                        f"entries to resume without optimizer-state "
                        f"sharding")
                total = sum(self._z_sizes)
                if tuple(arr.shape) != (total,):
                    raise ValueError(
                        f"canonical ZeRO entry {k!r} has {arr.numel()} "
                        f"elements; this parameter set needs {total}: the "
                        f"states belong to a different model")
                out[k] = self._z_shard(arr, world, self.comm.rank)[None]
            elif k.endswith("//__residual__"):
                out[k] = arr / self.comm.world_size
            else:
                out[k] = arr
        return out

    def reshard_raw_states(self, states, layout: Optional[Dict] = None
                           ) -> Dict[str, torch.Tensor]:
        """Raw states of a run at ANY world -> this rank's at this world
        (reference :885). A ZeRO-1 entry is the saving run's `(world_A,
        chunk_A)` stack (the reference's dump, or every rank's row
        stacked) and goes through the canonical vector; an entry already
        this rank's `(1, chunk)` row passes through; a residual stacked
        `(world_A, ...)` is summed, and every residual split evenly.
        `layout` is the saving run's `zero1_layout()`: a raw stack is
        bucket-dependent, so another layout is refused."""
        mine = self.zero1_layout()
        if layout is not None and mine is not None and layout != mine:
            raise ValueError(
                f"raw ZeRO-1 states with shard layout {layout} but this "
                f"DistOpt uses {mine} (overlap/buffSize changed between "
                f"save and load): the raw proxy layout is bucket-dependent "
                f"and would scramble the slots. Load with the saving run's "
                f"overlap/buffSize, or go through the CANONICAL layout-blind "
                f"form (canonicalize_states, then reshard_states)")
        world, out = self._z_world, {}
        for k, v in states.items():
            arr = torch.as_tensor(v)
            if "//__zshard__" in k:
                if not self._z_chunk:
                    raise RuntimeError(
                        f"reshard_raw_states: ZeRO entry {k!r} but this "
                        f"DistOpt has no ZeRO flat layout: construct it "
                        f"with shard_states=True and call prepare() before "
                        f"loading")
                total = sum(self._z_sizes)
                if arr.numel() < total:
                    raise ValueError(
                        f"raw ZeRO entry {k!r} holds {arr.numel()} "
                        f"elements; this parameter set needs {total}: the "
                        f"states belong to a different model")
                if world > 1 and tuple(arr.shape) == (1, self._z_chunk):
                    out[k] = arr
                else:
                    out[k] = self._z_shard(self._z_canonical(arr), world,
                                           self.comm.rank)[None]
            elif k.endswith("//__residual__"):
                pnd = self._residual_param_ndim(k)
                canon = arr.sum(0) if pnd is not None and \
                    arr.dim() == pnd + 1 else arr
                out[k] = canon / self.comm.world_size
            else:
                out[k] = arr
        return out

    def _residual_param_ndim(self, key: str) -> Optional[int]:
        pname = key[: -len("//__residual__")]
        for pid, arr in self._residuals.items():
            if self.opt._names.get(pid) == pname:
                return arr.dim()
        return None

    @property
    def sparse_dropped_last(self) -> float:
        """The last step's count, over the group, of entries above the
        threshold that the threshold sparsifier's cap dropped (0 in topK
        mode; kept with use_sparse=True). Reads the device."""
        return float(self._sparse_dropped)

    def step(self) -> None:
        self.opt.step()

    def update(self, p: torch.Tensor, g: torch.Tensor) -> None:
        with torch.no_grad():
            self.opt.update(p, g)

    def _stream_or_clip(self, pairs) -> None:
        """Update from (param, synced grad) pairs: one pair at a time
        without clipping; all of them clipped together (the global norm
        needs every gradient) with clip_norm or clip_value, or a sentinel
        (its all-finite check needs every gradient too)."""
        if self.opt.clip_norm is None and self.opt.clip_value is None \
                and self.sentinel is None:
            with torch.no_grad():
                for p, g in pairs:
                    self.opt.update(p, g)
            self.opt.step()
        else:
            self.opt.apply_updates(list(pairs))

    def _grad_axes_for(self, p) -> Tuple[Tuple[str, ...], float]:
        """The grad axes `p`'s gradient reduces over, and the divisor it
        owes for the axes it skips (reference :977-995). The data axis
        counts whenever the group is; another grad axis while it is live
        with more than one rank. A parameter sharded over one of them (a
        ZeRO-3 stack over the data axis, an expert shard over the expert
        axis) skips it: its gradient is already the sum over that axis
        (the gather's or the all-to-all's backward), so it is divided by
        the axis size instead, and every update stays the gradient of
        the global mean loss."""
        active = tuple(
            ax for ax in self.grad_axes if ax == self.comm.axis_name or (
                mesh_module.in_axis(ax) and mesh_module.axis_size(ax) > 1))
        skip = pspec_axis_names(p) & set(active)
        if not skip or self.comm.mesh is None:
            return active, 1.0
        scale = 1.0
        for ax in sorted(skip):
            scale *= float(self.comm.mesh.axis_size(ax))
        return tuple(ax for ax in active if ax not in skip), scale

    def _skips_data(self, p) -> bool:
        """Whether `p` is sharded over the data axis (a ZeRO-3 stack): its
        gradient takes no data-axis sync."""
        return self.comm.axis_name in pspec_axis_names(p)

    def _presync(self, pairs, bucket_elems: int, data: bool):
        """Each gradient divided by the sizes of the axes it skips, then
        averaged over its other grad axes, the axes other than the data
        axis first and the data axis last (only with `data`): one set of
        fused buckets of `bucket_elems` an axis for each distinct axis
        set (reference :1028-1063)."""
        groups: Dict[Tuple[str, ...], List[int]] = {}
        grads = []
        for i, (p, g) in enumerate(pairs):
            axes, scale = self._grad_axes_for(p)
            data_last = tuple(a for a in axes if a != self.comm.axis_name)
            if data and self.comm.axis_name in axes:
                data_last += (self.comm.axis_name,)
            groups.setdefault(data_last, []).append(i)
            grads.append(g if scale == 1.0 else g / scale)
        for axes, idxs in groups.items():
            part = [grads[i] for i in idxs]
            for ax in axes:
                comm = (self.comm if ax == self.comm.axis_name
                        else Communicator(self.comm.mesh, ax))
                part = comm.fused_all_reduce(part, average=True,
                                             bucket_elems=bucket_elems)
            for i, g in zip(idxs, part):
                grads[i] = g
        return [(p, g) for (p, _), g in zip(pairs, grads)]

    def _synced_grad_pairs(self, loss: torch.Tensor):
        """`grad_pairs` with the pre-reduction over the grad axes other
        than the data axis (reference :996-1026, pspec-aware): under
        sequence or expert parallelism each gradient is averaged over
        the live extra axes it is not sharded over (each shard saw other
        tokens), so it is the same on every shard of those axes; a
        gradient sharded over an axis is divided by its size instead.
        The per-mode data-axis sync then runs as in plain data
        parallelism (a ZeRO-3 stack's gradients skip it,
        `_skips_data`)."""
        return self._presync(list(autograd.grad_pairs(loss)),
                             self.buffSize, data=False)

    # -- the reference's API ---------------------------------------------------
    def __call__(self, loss: torch.Tensor):
        return self.backward_and_update(loss)

    def backward_and_update(self, loss: torch.Tensor,
                            threshold: Optional[int] = None) -> None:
        """Backward, the fused-bucket all-reduce (`threshold` aliases
        buffSize), then the clip and the update (reference :1028); with
        shard_states the ZeRO-1 step instead. A sentinel's loss scale
        multiplies the loss before the backward in both."""
        loss = self.opt._scaled_loss(loss)
        if self.shard_states:
            return self._backward_and_zero1_update(loss)
        self._stream_or_clip(self._presync(
            list(autograd.grad_pairs(loss)), threshold or self.buffSize,
            data=True))

    def _backward_and_zero1_update(self, loss: torch.Tensor) -> None:
        """The ZeRO-1 step (reference :1065-1287): the gradients flat in
        prepare() order (zeros for a parameter without one), padded to a
        world multiple and reduce-scattered (bf16 with half_wire; one
        collective a bucket with overlap); with a sentinel the shard
        unscaled and its square sum over the group checked for
        finiteness (the clip reuses that sum); clip_value, then clip_norm
        over the group's square sum; the wrapped optimizer's update of
        this rank's parameter
        shard (from the replicated parameters, or the fp32 master with
        gather_half), values and slot coordinates of gradient-less
        parameters rolled back; the all-gather (bf16 with gather_half)
        and the write-back. A non-finite step puts the shard, its slots
        and the step counter back (`torch.where`), so the all-gather
        rebroadcasts unchanged parameters. Every state is written in
        place, so a captured step replays against the same tensors."""
        if self._z_proxy is None:
            raise RuntimeError(
                "DistOpt(shard_states=True) requires prepare() before "
                "stepping (Model.set_optimizer / compile does this)")
        world, rank = self._z_world, self.comm.rank
        active = self.comm._active()
        if world != self.comm.world_size or (world > 1 and not active):
            raise RuntimeError(
                f"DistOpt(shard_states=True) was prepared over a world of "
                f"{world}; its process group is gone or changed")
        grads = {id(p): g for p, g in self._synced_grad_pairs(loss)}
        known = {id(p) for p in self._z_params}
        unknown = [pid for pid in grads if pid not in known]
        if unknown:
            raise RuntimeError(
                f"DistOpt(shard_states=True): gradients arrived for "
                f"{len(unknown)} tensor(s) outside the prepare()-time "
                f"parameter set (parameters replaced after the first "
                f"compile?); rebuild the DistOpt or copy into the "
                f"parameters in place. Known-name sample: "
                f"{[self.opt._names[id(p)] for p in self._z_params[:3]]}")
        opt, proxy, dev = self.opt, self._z_proxy, self._z_proxy.device
        with torch.no_grad():
            segs = self._z_segments(self._z_flat(
                [grads.get(id(p)) for p in self._z_params], dev,
                self._z_sizes), world)
            gsh = _cat(self.comm.reduce_scatter_buckets(
                segs, average=True, half=self.half_wire) if active
                else segs)  # no group: the shard is the whole vector
            sent, ok, sq = opt.sentinel, None, None
            if sent is not None:
                # the loss-scaled shard unscaled (the fault plan's factor
                # multiplies in) and checked: the square sum spans every
                # shard, so every rank takes the same verdict
                gsh = sent.unscale(gsh)
                sq = self.comm.all_reduce(gsh.float().square().sum(),
                                          average=False)
                ok = sent.check(sq)
            if opt.clip_value is not None:
                cv = float(opt.clip_value)
                gsh = gsh.clamp(-cv, cv)
                sq = None  # the clamp changed the norm
            if opt.clip_norm is not None:
                if sq is None:
                    sq = self.comm.all_reduce(gsh.square().sum(),
                                              average=False)
                gsh = gsh * torch.clamp(
                    opt.clip_norm / torch.clamp(sq.sqrt(), min=1e-12),
                    max=1.0)
            if self._z_master is None or not self._z_master_set:
                psh = self._z_shard(self._z_flat(
                    [p.detach() for p in self._z_params], dev), world, rank)
                if self._z_master is not None:
                    self._z_master.copy_(psh[None])
                    self._z_master_set = True
            if self._z_master is not None:
                psh = self._z_master[0]
            has_grad = tuple(id(p) in grads for p in self._z_params)
            mask = None if all(has_grad) else self._z_mask(has_grad, dev)
            proxy.copy_(psh[None])
            slots = opt._slots.get(id(proxy), {})
            before = ({k: v.clone() for k, v in slots.items()}
                      if mask is not None or ok is not None else None)
            opt.update(proxy, gsh[None])
            new_sh = proxy[0]
            if mask is not None:
                for k, v in slots.items():
                    v.copy_(torch.where(mask[None], v, before[k]))
                new_sh = torch.where(mask, new_sh, psh)
            if ok is not None:
                # a non-finite step: the shard and its slot coordinates
                # resolve to their pre-step values
                new_sh = torch.where(ok, new_sh, psh)
                for k, v in slots.items():
                    v.copy_(torch.where(ok, v, before[k]))
            if self._z_master is not None:
                self._z_master.copy_(new_sh[None])
            shards = list(new_sh.split(self._z_bchunks(world))) \
                if self._z_bucketed() else [new_sh]
            fulls = (self.comm.all_gather_buckets(shards,
                                                  half=self.gather_half)
                     if active else shards)
            groups = self._z_buckets if self._z_bucketed() else [
                range(len(self._z_params))]
            for idx, full in zip(groups, fulls):
                off = 0
                for i in idx:
                    p, n = self._z_params[i], self._z_sizes[i]
                    if has_grad[i]:
                        p.copy_(full[off:off + n].view(p.shape))
                    off += n
            if ok is not None:
                # a skipped step does not advance the lr schedule either
                before_step = opt._step.clone()
        opt.step()
        if ok is not None:
            with torch.no_grad():
                opt._step.copy_(torch.where(ok, opt._step, before_step))
            sent.advance(ok)

    def backward_and_update_half(self, loss: torch.Tensor) -> None:
        """The bf16-wire sync, one all-reduce a gradient (reference
        :1303)."""
        if self.shard_states:
            raise RuntimeError(_DENSE_ONLY)
        # the scaled gradient rides the bf16 wire (what the loss scale is
        # for); an overflow on the wire comes back Inf and skips the step
        loss = self.opt._scaled_loss(loss)
        self._stream_or_clip(
            (p, g if self._skips_data(p) else self.comm.all_reduce_half(g))
            for p, g in self._synced_grad_pairs(loss))

    def backward_and_sparse_update(self, loss: torch.Tensor,
                                   spars: float = 0.05, topK: bool = True,
                                   corr: bool = True) -> None:
        """Sparsified sync with error feedback (`corr`): g~ = g + e, put
        select(g~) on the wire, e' = g~ - select(g~), this rank's own
        untransmitted remainder (never the averaged result; reference
        :1331)."""
        if self.sentinel is not None:
            raise RuntimeError(
                "the resilience sentinel does not compose with the "
                "sparse sync: error-feedback residuals would accumulate "
                "gradient mass at WHATEVER loss scale each step ran, "
                "and a backoff between steps silently mixes scales. "
                "Use dist_option='plain'/'half' with the sentinel.")
        if self.shard_states:
            raise RuntimeError(_DENSE_ONLY)
        count = (not topK) and self.use_sparse
        dropped = []

        def dense_pairs():
            for p, g in self._synced_grad_pairs(loss):
                res = self._residuals.get(id(p)) if corr else None
                if corr and res is None and (
                        torch.cuda.is_available()
                        and torch.cuda.is_current_stream_capturing()):
                    raise RuntimeError(
                        "sparse sync with error feedback in a captured "
                        "step needs DistOpt(..., use_sparse=True), so the "
                        "residuals exist before the capture; or pass "
                        "corr=False")
                if self._skips_data(p):  # summed over the data axis
                    yield p, g
                    continue
                if res is not None:
                    g = g + res
                dense, local, n_drop = self.comm.sparse_all_reduce(
                    g, spars=spars, topK=topK, return_local=True,
                    return_stats=True)
                if count:
                    dropped.append(n_drop)
                if corr:
                    with torch.no_grad():
                        if res is None:
                            self._residuals[id(p)] = g - local
                        else:  # in place: replays read the same tensor
                            res.copy_(g - local)
                yield p, dense

        self._stream_or_clip(dense_pairs())
        if count and dropped:
            total = torch.stack(dropped).sum()
            total = self.comm.all_reduce(total, average=False)
            self._sparse_dropped = self._sparse_dropped.to(total.device)
            self._sparse_dropped.copy_(total)

    def backward_and_partial_update(self, loss: torch.Tensor,
                                    idx: int = 0) -> None:
        """Update a rotating subset of the parameters from the synced
        gradient (parameter i when i % world == idx % world), the others
        from their local one. No clipping: the update set mixes synced
        and per-rank gradients, so a global norm would differ by rank
        (reference :1397)."""
        if self.sentinel is not None:
            raise RuntimeError(
                "the resilience sentinel does not compose with the "
                "partial-update mode: its gradients are replica-VARYING, "
                "so the all-finite verdict (and therefore the skip) "
                "would differ per replica and permanently diverge the "
                "synced parameters. Use dist_option='plain'/'half'.")
        if self.shard_states:
            raise RuntimeError(_DENSE_ONLY)
        w = max(1, self.world_size)
        with torch.no_grad():
            for i, (p, g) in enumerate(self._synced_grad_pairs(loss)):
                self.opt.update(p, self.comm.all_reduce(g)
                                if i % w == idx % w
                                and not self._skips_data(p) else g)
        self.opt.step()
