"""Device resolution (counterpart of singa_tpu/device.py).

The reference wraps JAX devices in SINGA-shaped `Device` objects and
falls back to the host CPU when no accelerator is visible. Here a device
is a plain `torch.device`, and there is no fallback: the default device
is `cuda:0` or an error. The CPU is used only when a caller asks for it
(`device="cpu"`), as the parity tests do.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["get_default_device", "create_cuda_gpu", "create_cuda_gpu_on",
           "create_cpu_device", "resolve"]

DeviceLike = Union[str, torch.device, None]


def _strict_fp32() -> None:
    """fp32 matrix products and convolutions in full fp32, never TF32:
    the port is held to the reference's fp32 numerics."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def get_default_device() -> torch.device:
    """`cuda:0`; raises when no CUDA device is visible (no CPU fallback)."""
    return create_cuda_gpu_on(0)


def create_cuda_gpu() -> torch.device:
    return create_cuda_gpu_on(0)


def create_cuda_gpu_on(device_id: int) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' explicitly to "
            "run the plain PyTorch versions on the host")
    if not 0 <= device_id < torch.cuda.device_count():
        raise ValueError(
            f"cuda:{device_id} does not exist "
            f"({torch.cuda.device_count()} visible)")
    return torch.device("cuda", device_id)


def create_cpu_device() -> torch.device:
    return torch.device("cpu")


def resolve(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: the default CUDA device when
    `device` is None, else `device` as given. Also pins fp32 matrix
    products to full fp32 (TF32 off) for every entry point."""
    _strict_fp32()
    if device is None:
        return get_default_device()
    dev = torch.device(device)
    if dev.type == "cuda":
        return create_cuda_gpu_on(0 if dev.index is None else dev.index)
    return dev

