"""Autocast policy (counterpart of singa_tpu/autograd.py:143-194).

Only the mixed-precision policy of the reference's autograd is ported in
this slice; PyTorch's own tape stands in for the rest. The policy is the
reference's: off by default (fp32 everywhere); when on, matrix-product
operands are cast to the autocast dtype (bf16) and, under
`keep_activations=True`, the bf16 result flows on as the activation
stream, else it rejoins fp32 after the product.
"""

from __future__ import annotations

import torch

__all__ = ["set_autocast", "autocast_enabled", "autocast"]

_autocast = {"enabled": False, "dtype": torch.bfloat16, "keep": True}


def set_autocast(enabled: bool, dtype: torch.dtype = torch.bfloat16,
                 keep_activations: bool = True) -> None:
    _autocast["enabled"] = bool(enabled)
    _autocast["dtype"] = dtype
    _autocast["keep"] = bool(keep_activations)


def autocast_enabled() -> bool:
    return _autocast["enabled"]


class autocast:
    """Context manager: `with autograd.autocast(): ...`"""

    def __init__(self, enabled: bool = True,
                 dtype: torch.dtype = torch.bfloat16,
                 keep_activations: bool = True):
        self.enabled, self.dtype = enabled, dtype
        self.keep = keep_activations

    def __enter__(self):
        self._prev = dict(_autocast)
        set_autocast(self.enabled, self.dtype, self.keep)

    def __exit__(self, *exc):
        _autocast.update(self._prev)


def _mxu_cast(*tensors: torch.Tensor):
    """Cast float operands to the autocast dtype (no-op when disabled)."""
    if not _autocast["enabled"]:
        return tensors
    dt = _autocast["dtype"]
    return tuple(t.to(dt) if t.is_floating_point() else t for t in tensors)


def _mxu_result(y: torch.Tensor) -> torch.Tensor:
    """Post-product dtype policy: the bf16 result as-is under
    keep_activations, else back to fp32."""
    if not _autocast["enabled"] or _autocast["keep"]:
        return y
    return y.float()
