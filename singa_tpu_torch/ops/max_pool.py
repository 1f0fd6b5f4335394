"""NHWC max-pool with a hand-written CUDA backward kernel (counterpart
of singa_tpu/ops/max_pool.py).

`maxpool2d_nhwc(x, window, strides, pads)` pools an (N, H, W, C) tensor,
as the reference's custom-VJP op does. Its forward is PyTorch's max-pool
without indices (the reference's is `lax.reduce_window`, outside Pallas),
through `max_pool2d`, which also takes pads over half the window.
Its backward is chosen by a process-global switch, off by default as in
the reference:

- off: PyTorch's own max-pool backward, recorded by autograd (the
  counterpart of XLA's select-and-scatter);
- on: `_MaxPoolNHWC`, a `torch.autograd.Function` that saves x and y and
  whose backward is `_max_pool_bwd`. On CUDA tensors that wrapper
  launches `csrc/max_pool_bwd.cu`, the port of the Pallas `_bwd_kernel`
  (:152, `pallas_call` at :287), and counts the launch in
  `MAX_POOL_BWD_LAUNCHES`; on CPU tensors it runs `_max_pool_bwd_plain`,
  the same function in plain PyTorch.

The switch is read when the op runs forward, as the reference reads it
when its step is traced. Both routes give each input position the sum
of dy over the windows whose first maximum, in row-major window order,
it is (select-and-scatter's ties); the kernel and its plain version sum
in fp32 and write dx in x's dtype. The kernel decides each window's
first maximum once and then gathers into dx; it moves channels 16 bytes
at a time where C is innermost and every row is 16-byte aligned, the
main path's channels-last layout, and one channel at a time otherwise
(`_vector_width` says which route given operands take).

Not carried over: the TPU's VMEM sizing (`_pick_cblock`) with its silent
XLA fallback, and the shard_map guard. The kernel takes every shape.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["maxpool2d_nhwc", "max_pool2d", "pool_kernel_enabled",
           "set_pool_kernel_enabled"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the CUDA kernel, bumped once per launch in `_max_pool_bwd`
MAX_POOL_BWD_LAUNCHES = 0

_pool = {"enabled": False}


def set_pool_kernel_enabled(enabled: bool) -> None:
    """Process-global switch for the kernel backward (default off)."""
    _pool["enabled"] = bool(enabled)


def pool_kernel_enabled() -> bool:
    return _pool["enabled"]


def _out_dim(size: int, k: int, s: int, p: int) -> int:
    return (size + 2 * p - k) // s + 1


def max_pool2d(x: torch.Tensor, window, strides, pads) -> torch.Tensor:
    """PyTorch's max-pool of x (N,C,H,W), padding never selected, for any
    padding: where a pad exceeds half its window (which PyTorch's pool
    refuses) x is padded with -inf first, so a window lying wholly in
    padding gives -inf, as `lax.reduce_window` does."""
    if any(2 * p > k for k, p in zip(window, pads)):
        (ph, pw), pads = pads, (0, 0)
        x = F.pad(x, (pw, pw, ph, ph), value=float("-inf"))
    return F.max_pool2d(x, window, strides, pads)


def _fwd(x: torch.Tensor, window, strides, pads) -> torch.Tensor:
    """Max-pool of x (N,H,W,C) -> (N,OH,OW,C), padding never selected."""
    y = max_pool2d(x.permute(0, 3, 1, 2), window, strides, pads)
    return y.permute(0, 2, 3, 1)


def _max_pool_bwd_plain(x, y, dy, window, strides, pads) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x (N,H,W,C), y and dy
    (N,OH,OW,C) -> dx (N,H,W,C) in x's dtype. Pads with NaN (never equal
    to y), unfolds the windows, keeps each window's first position equal
    to y (a cumulative count of matches that is 1), weighs it by dy and
    folds the windows back, summing in fp32."""
    n, h, w, c = x.shape
    (kh, kw), (sh, sw), (ph, pw) = window, strides, pads
    xp = F.pad(x.permute(0, 3, 1, 2).float(), (pw, pw, ph, ph),
               value=float("nan"))
    cols = F.unfold(xp, (kh, kw), stride=(sh, sw))
    cols = cols.view(n, c, kh * kw, -1)
    yf = y.permute(0, 3, 1, 2).float().reshape(n, c, 1, -1)
    dyf = dy.permute(0, 3, 1, 2).float().reshape(n, c, 1, -1)
    eq = cols == yf
    first = eq & (eq.cumsum(2, dtype=torch.int32) == 1)
    contrib = (first * dyf).view(n, c * kh * kw, -1)
    dxp = F.fold(contrib, (h + 2 * ph, w + 2 * pw), (kh, kw),
                 stride=(sh, sw))
    dx = dxp[:, :, ph:ph + h, pw:pw + w]
    return dx.to(x.dtype).permute(0, 2, 3, 1).contiguous()


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
             + [ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    """The built library of `csrc/max_pool_bwd.cu` with its C
    signatures."""
    from singa_tpu_torch.ops import _build

    lib = _build.load("max_pool_bwd")
    lib.max_pool_bwd.argtypes = _ARGTYPES
    lib.max_pool_bwd.restype = ctypes.c_int
    lib.max_pool_bwd_error_string.argtypes = [ctypes.c_int]
    lib.max_pool_bwd_error_string.restype = ctypes.c_char_p
    lib.max_pool_bwd_vector_width.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int, ctypes.POINTER(ctypes.c_int64), ctypes.c_int])
    lib.max_pool_bwd_vector_width.restype = ctypes.c_int
    return lib


def _strides(x, y, dy, dx):
    return (ctypes.c_int64 * 16)(*x.stride(), *y.stride(), *dy.stride(),
                                 *dx.stride())


def _vector_width(x, y, dy, dx) -> int:
    """Channels per 16-byte access that the kernel takes for these CUDA
    operands (4 for fp32, 8 for bf16), or 1 where it runs its scalar
    route: the kernel's own test of strides and alignment."""
    return _lib().max_pool_bwd_vector_width(
        x.data_ptr(), y.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        x.shape[3], _strides(x, y, dy, dx), _DTYPES[x.dtype])


def _check(x, y, dy, window, strides, pads) -> None:
    """Raise on what the kernel does not take."""
    for name, t in (("x", x), ("y", y), ("dy", dy)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be (N, H, W, C), got "
                             f"{tuple(t.shape)}")
        if t.dtype not in _DTYPES or t.dtype != x.dtype:
            raise TypeError(
                f"{name} is {t.dtype}; the kernel takes float32 or "
                f"bfloat16, the same for x, y and dy (x is {x.dtype})")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    n, h, w, c = x.shape
    want = (n, _out_dim(h, window[0], strides[0], pads[0]),
            _out_dim(w, window[1], strides[1], pads[1]), c)
    for name, t in (("y", y), ("dy", dy)):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} {tuple(t.shape)} must be {want} for "
                             f"x {tuple(x.shape)}, window {window}, "
                             f"strides {strides}, pads {pads}")


def _max_pool_bwd(x, y, dy, window: Tuple[int, int],
                  strides: Tuple[int, int],
                  pads: Tuple[int, int]) -> torch.Tensor:
    """dx (N,H,W,C) of the max-pool y = maxpool(x), for any strides of
    x, y and dy. CUDA tensors launch the kernel; CPU tensors run
    `_max_pool_bwd_plain`."""
    global MAX_POOL_BWD_LAUNCHES
    _check(x, y, dy, window, strides, pads)
    if x.device.type == "cpu":
        return _max_pool_bwd_plain(x, y, dy, window, strides, pads)
    if x.device.type != "cuda":
        raise ValueError(f"no max-pool kernel for device {x.device}")
    n, h, w, c = x.shape
    dx = torch.empty((n, h, w, c), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.max_pool_bwd(
            x.data_ptr(), y.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            n, h, w, c, y.shape[1], y.shape[2], *window, *strides, *pads,
            _strides(x, y, dy, dx), _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        msg = lib.max_pool_bwd_error_string(err).decode()
        raise RuntimeError(f"max_pool_bwd launch failed: {msg} "
                           f"(cudaError {err})")
    MAX_POOL_BWD_LAUNCHES += 1
    return dx


class _MaxPoolNHWC(torch.autograd.Function):
    """PyTorch's max-pool forward; `_max_pool_bwd` backward."""

    @staticmethod
    def forward(ctx, x, window, strides, pads):
        y = _fwd(x, window, strides, pads)
        ctx.save_for_backward(x, y)
        ctx.cfg = (window, strides, pads)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        return _max_pool_bwd(x, y, dy, *ctx.cfg), None, None, None


def maxpool2d_nhwc(x: torch.Tensor, window: Tuple[int, int],
                   strides: Tuple[int, int],
                   pads: Tuple[int, int]) -> torch.Tensor:
    """Max-pool of x (N,H,W,C) -> (N,OH,OW,C): the kernel backward when
    the switch is on, PyTorch's max-pool backward when it is off."""
    window, strides, pads = tuple(window), tuple(strides), tuple(pads)
    if _pool["enabled"]:
        return _MaxPoolNHWC.apply(x, window, strides, pads)
    return _fwd(x, window, strides, pads)
