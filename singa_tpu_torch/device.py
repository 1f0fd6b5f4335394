"""Device abstraction (counterpart of singa_tpu/device.py).

The reference routes every tensor op through a SINGA-shaped `Device`
(`exec`, `put`, `sync`, an op counter, allocator statistics) over a JAX
device, with `CppCPU` for the host, `TpuDevice` for the chip, and
`CudaGPU` / `OpenclGPU` as aliases of the chip, so reference trainer
scripts run with a one-line device change. Here a `Device` wraps a
`torch.device`:

- `CppCPU` is the host; `CudaGPU` is the card; `TpuDevice` and
  `OpenclGPU` are aliases of the card, so a script that asks for a TPU
  gets the H100 (the reference's `CudaGPU` is the same kind of alias,
  the other way round).
- There is no CPU fallback. Where the reference warns and falls back to
  the host when no accelerator is visible, the card's classes and
  factories raise; the host is used only when a caller asks for it
  (`create_cpu_device()`, `device="cpu"`), as the parity tests do.
- `exec(fn, *args)` counts one op and calls `fn`. Every SINGA-level op
  goes through it: `autograd.op` (and so `Operator.__call__`) and the
  `tensor` module's math dispatch through the `Device` of their first
  tensor operand (`of`). A tensor knows only its `torch.device`, so the
  op count lives with the `torch.device`: every `Device` object of one
  `torch.device` reads and resets the same count. A captured step's
  replay (`graph.GraphStep` on the card) runs no Python and adds none.
- `resolve(device)` is what every entry point calls on its `device=`
  argument: None is the card, a `Device` its `torch.device`, anything
  else `torch.device(device)`. It returns a plain `torch.device`.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Union

import torch

__all__ = ["Device", "CppCPU", "TpuDevice", "CudaGPU", "OpenclGPU",
           "get_default_device", "create_cpu_device", "create_tpu_device",
           "create_cuda_gpu", "create_cuda_gpu_on", "create_opencl_device",
           "enable_lazy_stats", "resolve", "of", "dispatch"]

#: the op count of each torch.device (a one-element list, so `exec`
#: bumps it without a lookup of its own)
_counts: Dict[torch.device, list] = {}
#: the canonical Device of each torch.device (`of`)
_canonical: Dict[torch.device, "Device"] = {}
_lock = threading.Lock()


def _counter(dev: torch.device) -> list:
    with _lock:
        return _counts.setdefault(dev, [0])


class Device:
    """A device of the port: a `torch.device` with the reference's seam
    (`exec`, `put`, `sync`, `op_count`, `memory_stats`, `device_info`)."""

    kind = "abstract"
    #: the execution stack under the seam, for introspection
    backend = "torch"

    def __init__(self, torch_device: Union[str, torch.device]):
        self.torch_device = torch.device(torch_device)
        self.id: int = self.torch_device.index or 0
        self._count = _counter(self.torch_device)
        self.graph_enabled = False  # toggled by EnableGraph

    # -- the dispatch seam ---------------------------------------------------
    def exec(self, fn: Callable, *args, **kwargs):
        """Dispatch one op on this device: count it, then call `fn`."""
        self._count[0] += 1
        return fn(*args, **kwargs)

    # -- placement -----------------------------------------------------------
    def put(self, x: torch.Tensor) -> torch.Tensor:
        """`x` on this device; a tensor already there comes back as it
        is."""
        x = torch.as_tensor(x)
        return x if x.device == self.torch_device else x.to(
            self.torch_device)

    def sync(self) -> None:
        """Wait until every kernel queued on this device has finished (a
        no-op on the host)."""
        if self.torch_device.type == "cuda":
            torch.cuda.synchronize(self.torch_device)

    # -- introspection -------------------------------------------------------
    @property
    def platform(self) -> str:
        return "gpu" if self.torch_device.type == "cuda" else "cpu"

    @property
    def op_count(self) -> int:
        return self._count[0]

    def reset_op_count(self) -> None:
        self._count[0] = 0

    def memory_stats(self) -> dict:
        """The allocator's statistics under the reference's keys
        (`bytes_in_use`, `peak_bytes_in_use`, `bytes_limit`, ...): the
        caching allocator's on the card, {} on the host (the reference's
        host stats are none as well)."""
        if self.torch_device.type != "cuda":
            return {}
        s = torch.cuda.memory_stats(self.torch_device)
        free, total = torch.cuda.mem_get_info(self.torch_device)
        return {
            "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "num_allocs": int(s.get("allocation.all.allocated", 0)),
            "bytes_reserved": int(s.get("reserved_bytes.all.current", 0)),
            "peak_bytes_reserved": int(s.get("reserved_bytes.all.peak", 0)),
            "bytes_limit": int(total),
            "bytes_free": int(free),
        }

    def device_info(self) -> dict:
        """The reference's topology keys: ids, process index, memory
        spaces, `device_kind` (the card's name) and `platform`."""
        import torch.distributed as dist

        cuda = self.torch_device.type == "cuda"
        return {
            "id": self.id,
            "process_index": dist.get_rank() if dist.is_initialized() else 0,
            "local_hardware_id": self.id,
            "is_addressable": True,
            "num_memories": 1,
            "device_kind": (torch.cuda.get_device_name(self.torch_device)
                            if cuda else "cpu"),
            "platform": self.platform,
        }

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.torch_device})"

    def __eq__(self, other) -> bool:
        return (isinstance(other, Device)
                and other.torch_device == self.torch_device)

    def __hash__(self) -> int:
        return hash(self.torch_device)

    # -- the reference's API names -------------------------------------------
    def EnableGraph(self, enable: bool) -> None:
        """The reference's switch of buffered-graph mode (stored)."""
        self.graph_enabled = bool(enable)

    def Sync(self) -> None:
        self.sync()


class CppCPU(Device):
    """The host (reference `CppCPU`)."""

    kind = "cpp_cpu"

    def __init__(self, torch_device: Union[str, torch.device] = "cpu"):
        dev = torch.device(torch_device)
        if dev.type != "cpu":
            raise ValueError(f"CppCPU is the host, not {dev}")
        super().__init__(dev)


def _card(device_id: int) -> torch.device:
    """`cuda:device_id`; raises when no CUDA device is visible (no CPU
    fallback) or the id is out of range."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' explicitly to "
            "run the plain PyTorch versions on the host")
    if not 0 <= device_id < torch.cuda.device_count():
        raise ValueError(
            f"cuda:{device_id} does not exist "
            f"({torch.cuda.device_count()} visible)")
    return torch.device("cuda", device_id)


class CudaGPU(Device):
    """The card (reference `CudaGPU`): `cuda:device_id`. Raises where the
    reference would fall back to the host."""

    kind = "cuda_gpu"

    def __init__(self, device_id: Union[int, str, torch.device] = 0):
        if not isinstance(device_id, int):
            dev = torch.device(device_id)
            if dev.type != "cuda":
                raise ValueError(f"{type(self).__name__} is the card, "
                                 f"not {dev}")
            device_id = dev.index or 0
        super().__init__(_card(device_id))


class TpuDevice(CudaGPU):
    """Alias of the card, so a reference script that asks for a TPU runs
    on the H100 with no change."""

    kind = "tpu_alias"


class OpenclGPU(CudaGPU):
    """Alias of the card, as `TpuDevice`."""

    kind = "opencl_gpu_alias"


# -- the factories (the reference's module-level API) ---------------------------


def get_default_device() -> CudaGPU:
    """The card, `cuda:0`; raises when no CUDA device is visible."""
    return CudaGPU(0)


def create_cpu_device() -> CppCPU:
    return CppCPU()


def create_tpu_device(device_id: int = 0) -> TpuDevice:
    """The card `device_id` (a reference script's TPU)."""
    return TpuDevice(device_id)


def create_cuda_gpu() -> CudaGPU:
    return CudaGPU(0)


def create_cuda_gpu_on(device_id: int) -> CudaGPU:
    return CudaGPU(device_id)


def create_opencl_device() -> OpenclGPU:
    return OpenclGPU(0)


def enable_lazy_stats(enable: bool = True) -> None:
    """A placeholder, as in the reference."""
    del enable


def of(x: Any) -> Optional[Device]:
    """The canonical `Device` of a tensor's `torch.device` (CppCPU or
    CudaGPU), None for a non-tensor."""
    if not isinstance(x, torch.Tensor):
        return None
    dev = x.device
    d = _canonical.get(dev)
    if d is None:
        d = (CppCPU(dev) if dev.type == "cpu" else CudaGPU(dev)
             if dev.type == "cuda" else Device(dev))
        _canonical[dev] = d
    return d


def dispatch(fn: Callable, tensors, *args, **kwargs):
    """`fn(*args, **kwargs)` through the `exec` of the device of the
    first tensor among `tensors`; called directly when there is none."""
    for t in tensors:
        if isinstance(t, torch.Tensor):
            return of(t).exec(fn, *args, **kwargs)
    return fn(*args, **kwargs)


# -- resolution of an entry point's device= -------------------------------------

DeviceLike = Union[str, torch.device, Device, None]


def _strict_fp32() -> None:
    """fp32 matrix products and convolutions in full fp32, never TF32:
    the port is held to the reference's fp32 numerics."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: the default CUDA device when
    `device` is None, a `Device`'s `torch.device`, else `device` as
    given. Also pins fp32 matrix products to full fp32 (TF32 off) for
    every entry point."""
    _strict_fp32()
    if device is None:
        return get_default_device().torch_device
    if isinstance(device, Device):
        return device.torch_device
    dev = torch.device(device)
    if dev.type == "cuda":
        return _card(0 if dev.index is None else dev.index)
    return dev
