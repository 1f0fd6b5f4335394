"""Process-group bootstrap (counterpart of singa_tpu/distributed.py:58-181).

The reference joins a multi-host JAX job through its coordination
service; here one process drives one device and `init` joins a
`torch.distributed` process group, the reference SINGA's NCCL-id
rendezvous in PyTorch's form. The backend follows the device: NCCL for
a CUDA device, gloo for `device="cpu"`; there is no switch between them.

    from singa_tpu_torch import distributed as dist

    dist.init("host:port", num_processes=4, process_id=rank)
    mesh = dist.global_mesh()                    # the 1-D data group
    # or dist.global_mesh((2, 2), ("data", "sp")): data x sequence
    # or dist.global_mesh(dcn_mesh_shape=(n_hosts,)): a slice per host
    opt_ = opt.DistOpt(opt.SGD(lr), mesh=mesh)
    out, loss = model(tx, ty)                    # the global batch

A world of one with no address rendezvouses through an in-process
`HashStore` (no socket); otherwise `coordinator_address` ("host:port",
or an init method such as "file:///path") is the rendezvous. The
model's step takes the GLOBAL batch, as the reference's does, and each
rank runs its 1/world share (`model.Model`); `shard_batch` marks a
process's own slice as its share of that global batch, so that no input
crosses the wire.

The pspec helpers (reference :207-311). A parameter of a tensor-parallel
layer carries `pspec`, one entry per dim: None (replicated), a mesh
axis name, or a tuple of names (split jointly, the first major). The
reference keeps one global array and its SPMD wrapper hands each chip
its block; here a rank is one process, so it holds ONLY its block.
`place_model_states(mesh, model)` slices each such parameter down to
this rank's block in place (the block of dim i is index
`mesh.axis_index(axis)` of `mesh.axis_size(axis)` equal parts) and tags
it `placed` = (full shape, active spec, mesh); `Model` does this when a
DistOpt over a mesh meets the model, before the optimizer makes its
slots. `gather_full` all-gathers a placed block back into the full
array (what `Model.get_states` and `save_states` return, so a
checkpoint does not depend on the layout) and `block_of` slices a full
array the way `place_model_states` does (what `set_states` and
`load_singa_tpu_states` copy in). `active_pspec` drops the axes the mesh
lacks (extent 1, replicated). `shard_owner_map(tensor)` (reference
:182-204) gives every distinct shard of a tensor's full array and the
lowest rank holding it, from its pspec and the mesh's dims alone (no
collective): the sharded checkpoint writes each shard from that rank
only.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from singa_tpu_torch import device as device_module
from singa_tpu_torch.parallel import mesh as mesh_module

__all__ = ["init", "shutdown", "is_initialized", "process_index",
           "process_count", "device", "global_mesh", "host_slices",
           "hybrid_layout", "shard_batch", "is_rank_local", "active_pspec",
           "infer_state_mesh", "place_model_states", "place_opt_states",
           "gather_full", "block_of", "shard_owner_map", "owner_table",
           "block_bounds", "mesh_block_bounds"]

_device: Optional[torch.device] = None
#: the rendezvous and collective timeout
TIMEOUT = timedelta(seconds=300)


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         local_device_ids: Optional[Sequence[int]] = None, *,
         device=None) -> None:
    """Join the process group (reference `Communicator(nccl_id, rank,
    world)` bootstrap): `num_processes` ranks (1 when None), this one
    `process_id`. `device` is this rank's device (the card, `cuda:i` with
    i = local_device_ids[0] or the rank modulo the cards, unless "cpu");
    its type picks the backend. Idempotent when the live group matches
    this call's backend, device, world and rank; raises otherwise."""
    global _device
    world = int(num_processes or 1)
    rank = int(process_id or 0)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    if device is None and torch.cuda.is_available():
        ids = list(local_device_ids or [])
        device = f"cuda:{ids[0] if ids else rank % torch.cuda.device_count()}"
    dev = device_module.resolve(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        live = (dist.get_backend(), _device, dist.get_world_size(),
                dist.get_rank())
        if live != (backend, dev, world, rank):
            raise RuntimeError(
                f"a process group is live as (backend, device, world, "
                f"rank) {live}; this call asks for "
                f"{(backend, dev, world, rank)}: shutdown() first")
        return
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, world_size=world, rank=rank, timeout=TIMEOUT)
    if coordinator_address is not None:
        dist.init_process_group(
            init_method=coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}", **kw)
    elif world == 1:
        dist.init_process_group(store=dist.HashStore(), **kw)
    else:
        raise ValueError(
            f"a world of {world} needs a rendezvous: coordinator_address "
            f"('host:port' or an init method such as 'file:///path')")
    _device = dev


def shutdown() -> None:
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None


def is_initialized() -> bool:
    return dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def device() -> Optional[torch.device]:
    """The device `init` bound this rank to (None before `init`)."""
    return _device


def global_mesh(shape: Optional[Sequence[int]] = None,
                axis_names: Tuple[str, ...] = (mesh_module.DATA_AXIS,),
                dcn_mesh_shape: Optional[Sequence[int]] = None
                ) -> mesh_module.Mesh:
    """The mesh of `shape` over `axis_names` across every rank of the
    group, ranks laid out row-major (`parallel.mesh.get_mesh`): by
    default the 1-D data mesh, e.g. `global_mesh((2, 4), ("data",
    "sp"))` for data x sequence parallelism.

    Multi-slice (reference :100-157): with `dcn_mesh_shape`, one entry
    per axis whose product is the number of slices, `shape` is the
    per-slice mesh (by default all of a slice's ranks on the last axis).
    A slice is a host (`host_slices`), and each axis's groups are the
    lines of `hybrid_layout`, the reference's
    `create_hybrid_device_mesh` layout. A process group orders its
    members by rank, so a rank's index along an axis is its order within
    its line: where the reference's layout orders a line otherwise (hosts
    holding interleaved ranks), the mesh keeps the line's members in rank
    order; a layout whose lines cannot all be so ordered raises."""
    if dcn_mesh_shape is None:
        return mesh_module.get_mesh(shape, axis_names)
    axis_names = tuple(axis_names)
    dcn = tuple(int(d) for d in dcn_mesh_shape)
    if len(dcn) != len(axis_names):
        raise ValueError(f"dcn_mesh_shape {dcn} must have one entry per "
                         f"mesh axis {axis_names}")
    world = process_count()
    n_slices = int(np.prod(dcn))
    if world % n_slices:
        raise ValueError(f"{world} devices do not split into "
                         f"prod(dcn_mesh_shape)={n_slices} slices")
    if shape is None:
        shape = (1,) * (len(dcn) - 1) + (world // n_slices,)
    if len(shape) != len(axis_names):
        raise ValueError(f"per-slice shape {tuple(shape)} does not match "
                         f"axis names {axis_names}")
    layout = _rank_ordered(hybrid_layout(host_slices(), shape, dcn),
                           axis_names)
    return mesh_module.get_mesh(layout.shape, axis_names,
                                devices=layout.reshape(-1).tolist())


def hybrid_layout(slices: Sequence[Sequence[int]], shape: Sequence[int],
                  dcn_mesh_shape: Sequence[int]) -> np.ndarray:
    """The ranks of `slices` (one list a slice, in slice order) laid out
    as `create_hybrid_device_mesh` lays devices out: the index along axis
    i is d_i * shape_i + s_i, d the slice's position in `dcn_mesh_shape`
    and s the rank's in its slice's row-major reshape to `shape`
    (`np.block` of the per-slice meshes)."""
    shape = tuple(int(s) for s in shape)
    dcn = tuple(int(d) for d in dcn_mesh_shape)
    per = int(np.prod(shape))
    if len(slices) != int(np.prod(dcn)) or any(len(h) != per
                                               for h in slices):
        raise ValueError(
            f"dcn_mesh_shape {dcn} asks for {int(np.prod(dcn))} slices of "
            f"{per} ranks; the slices hold {[len(h) for h in slices]}")
    blocks = np.empty(dcn, dtype=object)
    for d, ranks in enumerate(slices):
        blocks[np.unravel_index(d, dcn)] = np.asarray(ranks).reshape(shape)
    return np.block(blocks.tolist())


def _lines(a: np.ndarray, axis: int) -> set:
    return {frozenset(v.tolist())
            for v in np.moveaxis(a, axis, -1).reshape(-1, a.shape[axis])}


def _rank_ordered(layout: np.ndarray, axis_names) -> np.ndarray:
    """`layout` with every line along every axis in rank order, each
    line keeping its members; raises when no such layout exists."""
    out = layout
    for a in range(out.ndim):
        out = np.sort(out, axis=a)
    if any(_lines(out, a) != _lines(layout, a)
           or (np.diff(out, axis=a) < 0).any() for a in range(out.ndim)):
        raise ValueError(
            f"the hybrid layout {layout.tolist()} over {axis_names} has no "
            f"order in which every axis group's ranks ascend (a process "
            f"group orders its members by rank)")
    return out


def host_slices() -> list:
    """The ranks of each host, the hosts ordered by their lowest rank: a
    rank's host is torchrun's GROUP_RANK where it is set, else its
    hostname, gathered once over the group (`all_gather_object`: every
    rank calls this)."""
    import socket

    me = os.environ.get("GROUP_RANK") or socket.gethostname()
    if dist.is_initialized():
        keys = [None] * dist.get_world_size()
        dist.all_gather_object(keys, me)
    else:
        keys = [me]
    hosts: dict = {}
    for r, k in enumerate(keys):
        hosts.setdefault(k, []).append(r)
    return sorted(hosts.values(), key=min)


def shard_batch(mesh: mesh_module.Mesh, arrays,
                axis: str = mesh_module.DATA_AXIS):
    """This process's slice of the global batch, marked as this rank's
    share of it (the reference's `make_array_from_process_local_data`:
    nothing crosses the wire). The model's step runs a marked batch as
    this rank's rows and a plain one as the global batch. A numpy array
    goes to this rank's device (the CPU before `init`); a tensor keeps
    its own device."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}")
    single = isinstance(arrays, (np.ndarray, torch.Tensor))
    out = []
    for a in ([arrays] if single else list(arrays)):
        t = (torch.from_numpy(np.ascontiguousarray(a)).to(
            _device or torch.device("cpu")) if isinstance(a, np.ndarray)
            else torch.as_tensor(a))
        # a new tensor object on the same memory: the caller's stays
        # unmarked
        t = t.contiguous().view(t.shape)
        t.rank_local = True
        out.append(t)
    return out[0] if single else tuple(out)


def is_rank_local(t) -> bool:
    """Whether `t` came from `shard_batch`: this rank's share of the
    global batch."""
    return bool(getattr(t, "rank_local", False))


# -- the pspec helpers ------------------------------------------------------------


def active_pspec(spec, mesh: mesh_module.Mesh) -> Tuple:
    """`spec` restricted to the axes `mesh` has (reference :207-227): an
    axis the mesh lacks is a collapsed axis of extent 1, so its entry
    becomes None (inside joint tuples too)."""
    names = set(mesh.axis_names)
    out = []
    for entry in (spec or ()):
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a and a in names)
            out.append(kept if kept else None)
        elif entry is not None and entry not in names:
            out.append(None)
        else:
            out.append(entry)
    return tuple(out)


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def block_of(full: torch.Tensor, spec, mesh: mesh_module.Mesh
             ) -> torch.Tensor:
    """This rank's block of `full` under the active `spec` on `mesh`: along
    each dim, part `index` of `n` equal parts, where n is the product of
    the entry's axis sizes and index their joint index (first major;
    `mesh_block_bounds`). A view of `full`."""
    out = full
    for dim, (a, b) in enumerate(mesh_block_bounds(full.shape, spec, mesh)):
        if b - a != full.shape[dim]:
            out = out.narrow(dim, a, b - a)
    return out


def gather_full(t: torch.Tensor) -> torch.Tensor:
    """The full array of a placed block (`place_model_states`): one
    all-gather over each axis of its spec, minor axes first, every rank
    of the mesh calling; an unplaced tensor comes back as it is. A
    collective: call on every rank."""
    from singa_tpu_torch.parallel.tp import gather_in_group

    placed = getattr(t, "placed", None)
    if placed is None:
        return t
    _, spec, mesh = placed
    out = t.detach()
    for dim, entry in enumerate(spec):
        for a in reversed(_axes_of(entry)):
            g = mesh.axis_group(a)
            world = mesh.axis_size(a)
            if g is None or world == 1:
                continue
            out = gather_in_group(out, g, world, dim, axis=a)
    return out


def _joint(entry, coords, sizes) -> Tuple[int, int]:
    """(number of parts, this position's part) of a dim split over the
    axes of `entry`, the first major."""
    n, idx = 1, 0
    for a in _axes_of(entry):
        n *= sizes[a]
        idx = idx * sizes[a] + coords[a]
    return n, idx


def _bounds(shape, spec, coords, sizes) -> Tuple[Tuple[int, int], ...]:
    out = []
    for dim, size in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        n, idx = _joint(entry, coords, sizes)
        if size % n:
            raise ValueError(
                f"dim {dim} of size {size} is not divisible by the {n} "
                f"shards of {_axes_of(entry)} on {sizes}")
        out.append((idx * (size // n), (idx + 1) * (size // n)))
    return tuple(out)


def owner_table(shape, spec, axis_names, dims, ranks=None) -> dict:
    """{bounds: owner} for every distinct shard of an array of `shape`
    split by `spec` over a mesh of `dims` along `axis_names` whose
    positions, row-major, are the global `ranks` (default 0..n-1):
    `bounds` is one (start, stop) pair a dim, and the owner is the
    lowest rank holding that shard (reference `shard_owner_map`, where
    a device's process index plays the rank). Axes of `spec` the mesh
    lacks are replicated."""
    shape = tuple(int(d) for d in shape)
    dims = tuple(int(d) for d in dims)
    n = int(np.prod(dims)) if dims else 1
    ranks = tuple(range(n)) if ranks is None else tuple(ranks)
    names = tuple(axis_names)
    spec = tuple(spec or ())
    spec = tuple(tuple(a for a in _axes_of(e) if a in names) or None
                 for e in spec)
    sizes = dict(zip(names, dims))
    owners: dict = {}
    for pos in range(n):
        coords = dict(zip(names, np.unravel_index(pos, dims) if dims
                          else ()))
        b = _bounds(shape, spec, {a: int(c) for a, c in coords.items()},
                    sizes)
        r = int(ranks[pos])
        owners[b] = r if b not in owners else min(owners[b], r)
    return owners


def mesh_block_bounds(full, spec, mesh: mesh_module.Mesh
                      ) -> Tuple[Tuple[int, int], ...]:
    """This rank's (start, stop) pairs, one a dim, of its block of an
    array of shape `full` split by the active `spec` over `mesh`: the
    bounds `owner_table` keys this block by. Only the axes `spec` names
    are read off the mesh."""
    spec = tuple(spec or ())
    used = {a for e in spec for a in _axes_of(e)}
    coords = {a: mesh.axis_index(a) for a in used}
    sizes = {a: mesh.axis_size(a) for a in used}
    return _bounds(tuple(int(d) for d in full), spec, coords, sizes)


def block_bounds(t: torch.Tensor) -> Tuple[Tuple[int, int], ...]:
    """This rank's (start, stop) pairs, one a dim, of a placed tensor's
    block within its full array (`place_model_states`); the whole extent
    for an unplaced one."""
    placed = getattr(t, "placed", None)
    if placed is None:
        return tuple((0, int(d)) for d in t.shape)
    return mesh_block_bounds(*placed)


def shard_owner_map(t) -> dict:
    """{bounds: owner rank} for every distinct shard of a tensor's full
    array (reference :182-204): a placed block's table follows from its
    pspec and its mesh's dims and ranks (`owner_table`), the lowest rank
    holding a shard owning it; a tensor with no placement (no pspec, or
    a world of one) maps its whole extent to rank 0. Every rank computes
    the same table from this metadata alone: no collective runs."""
    placed = getattr(t, "placed", None)
    if placed is None:
        return {tuple((0, int(d)) for d in getattr(t, "shape", ())): 0}
    full, spec, mesh = placed
    return owner_table(full, spec, mesh.axis_names, mesh.dims, mesh.ranks)


def infer_state_mesh(model, optimizer=None
                     ) -> Optional[mesh_module.Mesh]:
    """The mesh a (model, optimizer) pair's states belong on (reference
    :230-253): the DistOpt's mesh, else the mesh the model's parameters
    are already placed on; None for a mesh of one rank (or none). The
    reference's checkpoint code calls it; the port's model places its
    states where DistOpt meets it (`model.Model`) and does not."""
    comm = getattr(optimizer, "comm", None)
    mesh = getattr(comm, "mesh", None)
    if mesh is None:
        for t in list(model.parameters()) + list(model.buffers()):
            placed = getattr(t, "placed", None)
            if placed is not None:
                mesh = placed[2]
                break
    if mesh is not None and mesh.size <= 1:
        mesh = None
    return mesh


def place_model_states(mesh: mesh_module.Mesh, model,
                       optimizer=None) -> int:
    """Slice every parameter and buffer of `model` that has a pspec down
    to this rank's block on `mesh`, in place (`tensor.data` becomes a
    contiguous copy of the block, so the parameter object, its name and
    its `pspec` stay), before the optimizer makes slots for it
    (reference :256-281: there the arrays are placed on their
    NamedSharding). Tensors without a pspec stay replicated. With
    `optimizer`, its loaded states are placed too (`place_opt_states`).
    Placing twice on the same mesh changes nothing; on another mesh it
    raises. Returns the number of tensors placed."""
    placed = 0
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            spec = getattr(t, "pspec", None)
            if not spec:
                continue
            prior = getattr(t, "placed", None)
            if prior is not None:
                if prior[2] is not mesh:
                    raise ValueError(
                        f"a tensor of pspec {spec} is placed on "
                        f"{prior[2]} already; its states cannot move to "
                        f"{mesh} in place (save_states, then load them "
                        f"into a fresh model)")
                continue
            act = active_pspec(spec, mesh)
            full = tuple(t.shape)
            t.data = block_of(t.data, act, mesh).contiguous()
            t.placed = (full, act, mesh)
            placed += 1
    if optimizer is not None:
        placed += place_opt_states(mesh, model, optimizer)
    return placed


def place_opt_states(mesh: mesh_module.Mesh, model, optimizer) -> int:
    """Re-place an optimizer's loaded states (reference :284-311): a slot
    of a placed parameter given as the full array (a checkpoint's) is
    sliced to the parameter's block; the rest stay. Call after
    `optimizer.load_states(...)`; returns the number of slots sliced.
    A parameter placed on another mesh than `mesh` raises."""
    by_name = {n: p for n, p in model.named_parameters()}
    out, n = {}, 0
    for k, v in optimizer.dump_states().items():
        pname = k.rpartition("//")[0]
        p = by_name.get(pname)
        placed = getattr(p, "placed", None)
        if placed is not None and placed[2] is not mesh:
            raise ValueError(
                f"{pname} is placed on {placed[2]}, not on {mesh}")
        if placed is not None and tuple(v.shape) == placed[0]:
            v = block_of(v, placed[1], mesh).contiguous()
            n += 1
        out[k] = v
    optimizer.load_states(out)
    return n
