"""Communicator and DistOpt (counterpart of singa_tpu/communicator.py:140-1064
and 1289-1429): data-parallel gradient sync over `torch.distributed`.

The reference emits XLA collectives inside a `shard_map` over its data
axis. Here each rank is one process and the collectives are
`torch.distributed` calls on the mesh's process group: NCCL on the card,
gloo on the CPU. A mean is a SUM followed by `/ world`, exact at world
1, so NCCL and gloo take one code path, and on the card a world-1 group
really launches NCCL. When the mesh has no process group (no `init`),
every collective is the identity, the reference's "outside SPMD" case.
`reduce_scatter` sums the whole vector and keeps this rank's chunk, on
both backends (gloo has no reduce-scatter); nothing on the ported path
calls it, and ZeRO-1 (item 12's open part) is where NCCL's own
reduce-scatter would pay.

Every collective here is capturable in a CUDA Graph with its step
(`graph.GraphStep`): it enqueues on the current stream and reads no
value on the host.

`DistOpt` wraps a local optimizer: `backward_and_update` (fused buckets
of at most `buffSize` elements, one all-reduce each, then the wrapped
optimizer's clipping and update), `backward_and_update_half` (a bf16
wire), `backward_and_sparse_update` (top-k or threshold selection with
error-feedback residuals; the residuals and the threshold mode's
dropped-entry count stay on the device) and
`backward_and_partial_update`. Its ZeRO-1 options (`shard_states`,
`half_wire`, `gather_half`, `overlap`) are the next part of ROADMAP
queue 1 item 12 and raise here; `set_sentinel` is item 17.

`plan_buckets` is the port's own copy of the reference's Python bucket
planner (the oracle its native planner is held to).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from singa_tpu_torch import autograd
from singa_tpu_torch.parallel import mesh as mesh_module

__all__ = ["Communicator", "DistOpt", "plan_buckets", "pmean_over"]


class _GroupMean(torch.autograd.Function):
    """The mean over a process group, differentiable: the backward takes
    the mean of the cotangent over the group, the transpose of the
    reference's `pmean`."""

    @staticmethod
    def forward(ctx, x, group, world):
        ctx.group, ctx.world = group, world
        return _mean(x, group, world)

    @staticmethod
    def backward(ctx, g):
        return _mean(g, ctx.group, ctx.world), None, None


def _mean(x: torch.Tensor, group, world: int) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y / world


def pmean_over(x: torch.Tensor, group, world: int) -> torch.Tensor:
    """The differentiable mean of `x` over `group` (batchnorm's
    cross-replica moments)."""
    return _GroupMean.apply(x, group, world)


class Communicator:
    """Collectives over the mesh's process group (see the module
    docstring)."""

    def __init__(self, mesh: Optional[mesh_module.Mesh] = None,
                 axis_name: str = mesh_module.DATA_AXIS):
        self.mesh = mesh
        self.axis_name = axis_name

    @property
    def world_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    @property
    def rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.rank

    @property
    def group(self):
        return None if self.mesh is None else self.mesh.group

    def _active(self) -> bool:
        """True when a process group is initialised under the mesh (at
        any world, 1 included)."""
        return (self.mesh is not None and self.mesh.group is not None
                and dist.is_initialized())

    def _sum(self, x: torch.Tensor) -> torch.Tensor:
        y = x.contiguous().clone()
        dist.all_reduce(y, group=self.group)
        return y

    def _gather(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        parts = [torch.empty_like(x) for _ in range(self.world_size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, axis)

    # -- core collectives ------------------------------------------------------
    def all_reduce(self, x: torch.Tensor, average: bool = True
                   ) -> torch.Tensor:
        """Sum (or mean) over the data group (reference `synch`)."""
        if not self._active():
            return x
        y = self._sum(x)
        return y / self.world_size if average else y

    def all_reduce_half(self, x: torch.Tensor, average: bool = True,
                        axes=None) -> torch.Tensor:
        """The bf16 wire: cast to bfloat16, sum in bf16, cast back to the
        input dtype, then the mean. `axes` names the axes to reduce over
        (None: the data axis; an empty tuple: none)."""
        axes = (self.axis_name,) if axes is None else tuple(axes)
        if self.axis_name not in axes or not self._active():
            return x
        y = self._sum(x.to(torch.bfloat16)).to(x.dtype)
        return y / self.world_size if average else y

    def all_gather(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """The shards of every rank joined along `axis` (tiled)."""
        return self._gather(x, axis) if self._active() else x

    def _scatter(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """This rank's chunk of the sum over the group along `axis`."""
        return self._sum(x).chunk(self.world_size, axis)[self.rank]

    def reduce_scatter(self, x: torch.Tensor, axis: int = 0,
                       average: bool = True) -> torch.Tensor:
        if not self._active():
            return x
        y = self._scatter(x, axis)
        return y / self.world_size if average else y

    def reduce_scatter_half(self, x: torch.Tensor, axis: int = 0,
                            average: bool = True) -> torch.Tensor:
        """The bf16-wire reduce-scatter, cast back to the input dtype
        before the mean."""
        if not self._active():
            return x
        y = self._scatter(x.to(torch.bfloat16), axis).to(x.dtype)
        return y / self.world_size if average else y

    def all_gather_half(self, x: torch.Tensor, axis: int = 0
                        ) -> torch.Tensor:
        """The bf16-wire all-gather (rounds the gathered values)."""
        if not self._active():
            return x
        return self._gather(x.to(torch.bfloat16), axis).to(x.dtype)

    def broadcast(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        """Rank `root`'s value on every rank."""
        if not self._active():
            return x
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
        """One reduce-scatter a bucket (each flat already padded to a
        world multiple)."""
        fn = self.reduce_scatter_half if half else self.reduce_scatter
        return [fn(f, axis=0, average=average) for f in bucket_flats]

    def all_gather_buckets(self, bucket_shards, half: bool = False):
        """The inverse of `reduce_scatter_buckets`."""
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
    """Greedy bucket assignment: consecutive sizes packed up to
    `bucket_elems`; a size over it gets a bucket of its own."""
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

_ZERO1 = ("DistOpt({}=) is ZeRO-1, the next part of ROADMAP queue 1 item 12 "
          "(shard_states, half_wire, gather_half, overlap)")


class DistOpt:
    """Data-parallel optimizer wrapper (reference `singa.opt.DistOpt`):
    the gradients are synced over the mesh's group after the backward,
    then the wrapped optimizer steps. The reference constructor's
    `nccl_id`, `local_rank` and `world_size` are accepted; the group
    comes from `distributed.init` and the mesh."""

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
        for name, val in (("shard_states", shard_states),
                          ("half_wire", half_wire),
                          ("gather_half", gather_half),
                          ("overlap", overlap)):
            if val:
                raise NotImplementedError(_ZERO1.format(name))
        if grad_axes and tuple(grad_axes) != (axis_name,):
            raise NotImplementedError(
                f"DistOpt(grad_axes={tuple(grad_axes)}): the sequence and "
                f"expert axes come with ROADMAP queue 1 items 14-15")
        self.opt = opt
        self.comm = Communicator(mesh, axis_name)
        self.buffSize = buffSize
        self.use_sparse = use_sparse
        self._rank_shim = local_rank
        self._world_shim = world_size
        #: error-feedback residuals, keyed by id(param), param-shaped on
        #: each rank (the reference's (world, ...) stack, one row here)
        self._residuals: Dict[int, torch.Tensor] = {}
        #: the threshold mode's dropped-entry count of the LAST step,
        #: over the group: a device scalar written in place each step
        self._sparse_dropped = torch.zeros((), dtype=torch.float32)

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

    def set_sentinel(self, sentinel) -> None:
        raise NotImplementedError(
            "DistOpt.set_sentinel (the resilience GradSentinel) is not "
            "ported yet (ROADMAP queue 1 item 17)")

    # -- optimizer protocol ----------------------------------------------------
    def prepare(self, named_params) -> None:
        self.opt.prepare(named_params)
        for p in named_params.values():
            self._sparse_dropped = self._sparse_dropped.to(p.device)
            break
        if self.use_sparse:
            for p in named_params.values():
                if id(p) not in self._residuals:
                    self._residuals[id(p)] = torch.zeros_like(p)

    def dump_states(self) -> Dict[str, torch.Tensor]:
        states = dict(self.opt.dump_states())
        for pid, arr in self._residuals.items():
            states[f"{self.opt._names[pid]}//__residual__"] = arr
        if self.use_sparse:
            states["//__sparse_dropped__"] = self._sparse_dropped
        return states

    def load_states(self, states, strict: bool = False) -> None:
        """Load a `dump_states` dict (the port's or the reference's). A
        residual stacked (world, ...) over the reference's data axis
        gives this rank its row."""
        own = {k for k in states if k.endswith("//__residual__")
               or k == "//__sparse_dropped__"}
        self.opt.load_states({k: v for k, v in states.items()
                              if k not in own}, strict=strict)
        by_name = {n: pid for pid, n in self.opt._names.items()}
        for k in own:
            arr = torch.as_tensor(states[k])
            if k == "//__sparse_dropped__":
                self._sparse_dropped.copy_(arr)
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
        needs every gradient) with clip_norm or clip_value."""
        if self.opt.clip_norm is None and self.opt.clip_value is None:
            with torch.no_grad():
                for p, g in pairs:
                    self.opt.update(p, g)
            self.opt.step()
        else:
            self.opt.apply_updates(list(pairs))

    # -- the reference's API ---------------------------------------------------
    def __call__(self, loss: torch.Tensor):
        return self.backward_and_update(loss)

    def backward_and_update(self, loss: torch.Tensor,
                            threshold: Optional[int] = None) -> None:
        """Backward, the fused-bucket all-reduce (`threshold` aliases
        buffSize), then the clip and the update."""
        pairs = list(autograd.grad_pairs(loss))
        synced = self.comm.fused_all_reduce(
            [g for _, g in pairs], average=True,
            bucket_elems=threshold or self.buffSize)
        self._stream_or_clip((p, g) for (p, _), g in zip(pairs, synced))

    def backward_and_update_half(self, loss: torch.Tensor) -> None:
        """The bf16-wire sync, one all-reduce a gradient."""
        self._stream_or_clip((p, self.comm.all_reduce_half(g))
                             for p, g in autograd.grad_pairs(loss))

    def backward_and_sparse_update(self, loss: torch.Tensor,
                                   spars: float = 0.05, topK: bool = True,
                                   corr: bool = True) -> None:
        """Sparsified sync with error feedback (`corr`): g~ = g + e, put
        select(g~) on the wire, e' = g~ - select(g~), this rank's own
        untransmitted remainder (never the averaged result)."""
        count = (not topK) and self.use_sparse
        dropped = []

        def dense_pairs():
            for p, g in autograd.grad_pairs(loss):
                res = self._residuals.get(id(p)) if corr else None
                if corr and res is None and (
                        torch.cuda.is_available()
                        and torch.cuda.is_current_stream_capturing()):
                    raise RuntimeError(
                        "sparse sync with error feedback in a captured "
                        "step needs DistOpt(..., use_sparse=True), so the "
                        "residuals exist before the capture; or pass "
                        "corr=False")
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
        and per-rank gradients, so a global norm would differ by rank."""
        w = max(1, self.world_size)
        with torch.no_grad():
            for i, (p, g) in enumerate(autograd.grad_pairs(loss)):
                self.opt.update(p, self.comm.all_reduce(g)
                                if i % w == idx % w else g)
        self.opt.step()
