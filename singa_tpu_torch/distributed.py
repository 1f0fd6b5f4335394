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
    opt_ = opt.DistOpt(opt.SGD(lr), mesh=mesh)
    out, loss = model(tx, ty)                    # the global batch

A world of one with no address rendezvouses through an in-process
`HashStore` (no socket); otherwise `coordinator_address` ("host:port",
or an init method such as "file:///path") is the rendezvous. The
model's step takes the GLOBAL batch, as the reference's does, and each
rank runs its 1/world share (`model.Model`); `shard_batch` marks a
process's own slice as its share of that global batch, so that no input
crosses the wire. The pspec helpers (`shard_owner_map`, `active_pspec`,
`place_*`) come with tensor parallelism (ROADMAP queue 1 item 13).
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from singa_tpu_torch import device as device_module
from singa_tpu_torch.parallel import mesh as mesh_module

__all__ = ["init", "shutdown", "is_initialized", "process_index",
           "process_count", "device", "global_mesh", "shard_batch",
           "is_rank_local"]

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
                dcn_mesh_shape=None) -> mesh_module.Mesh:
    """The mesh of `shape` over `axis_names` across every rank of the
    group, ranks laid out row-major (`parallel.mesh.get_mesh`): by
    default the 1-D data mesh, e.g. `global_mesh((2, 4), ("data",
    "sp"))` for data x sequence parallelism."""
    if dcn_mesh_shape is not None:
        raise NotImplementedError(
            "global_mesh(dcn_mesh_shape=): multi-slice meshes are not "
            "ported (ROADMAP queue 1 item 13)")
    return mesh_module.get_mesh(shape, axis_names)


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
