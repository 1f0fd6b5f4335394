"""Internal image layout (counterpart of singa_tpu/layout.py).

The reference keeps SINGA's NCHW public surface (inputs, OIHW conv
weights, checkpoints) and can run a model's convolutional stack
channels-last inside: under "NHWC" it transposes the input once at the
model boundary, and every conv, batch-norm and pool op then indexes an
(N, H, W, C) array, with the channel axis last.

The port takes PyTorch's idiom for the same choice. Under "NHWC" an
activation keeps its *logical* NCHW shape and uses the
`torch.channels_last` memory format, which is NHWC in memory: cuDNN's
convolutions and PyTorch's pooling and elementwise kernels read and
write it as such, and a 4-D view `x.permute(0, 2, 3, 1)` of it is a
contiguous (N, H, W, C) tensor with no copy (the max-pool op hands that
view to `ops.max_pool.maxpool2d_nhwc`). So, unlike the reference:

- the channel axis is 1 and the spatial axes are (2, 3) in both layouts
  (`channel_axis`, `spatial_axes`);
- `from_nchw` and `to_nchw` change the memory format, not the shape;
- `layer.Flatten` needs no rotation back to NCHW: flattening the logical
  NCHW shape already gives the NCHW feature order, so a Linear after it
  takes the same weights in both layouts.

Weights stay OIHW in both layouts, so a checkpoint is layout-portable,
as in the reference. The layout is read when an op runs; it is
thread-local, as the reference's is.
"""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["image_layout", "set_image_layout", "use_image_layout",
           "channel_axis", "spatial_axes", "from_nchw", "to_nchw"]

_LAYOUTS = ("NCHW", "NHWC")
_state = threading.local()


def _check(layout: str) -> str:
    if layout not in _LAYOUTS:
        raise ValueError(
            f"image layout must be one of {_LAYOUTS}, got {layout!r}")
    return layout


def image_layout() -> str:
    """The layout the 4-D image activations are currently kept in."""
    return getattr(_state, "current", "NCHW")


def set_image_layout(layout: str) -> None:
    _state.current = _check(layout)


@contextlib.contextmanager
def use_image_layout(layout: str):
    """Scope the image layout (models wrap their forward in this)."""
    prev = image_layout()
    _state.current = _check(layout)
    try:
        yield
    finally:
        _state.current = prev


def channel_axis(ndim: int = 4) -> int:
    """Channel axis of an activation: 1 for (N, C) and for the logical
    (N, C, H, W) shape, in either layout."""
    del ndim
    return 1


def spatial_axes() -> tuple:
    """(H, W) axes of a 4-D activation's logical shape, in either
    layout."""
    return (2, 3)


def from_nchw(x: torch.Tensor) -> torch.Tensor:
    """Model-boundary adapter: a public NCHW input in the internal
    layout (under "NHWC", one copy into channels-last memory)."""
    if image_layout() == "NCHW":
        return x
    return x.contiguous(memory_format=torch.channels_last)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """Inverse boundary adapter: a 4-D output back in NCHW memory."""
    if image_layout() == "NCHW":
        return x
    return x.contiguous()
