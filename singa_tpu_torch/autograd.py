"""Autograd (counterpart of singa_tpu/autograd.py).

PyTorch's own tape stands in for the reference's `Operator` tape. Ported
on top of it:

- the autocast policy (reference :143-194): off by default (fp32
  everywhere); when on, matrix-product operands are cast to the autocast
  dtype (bf16) and, under `keep_activations=True`, the bf16 result flows
  on as the activation stream, else it rejoins fp32 after the product;
- `training` (reference :126), the flag `Model.train()` sets: when it is
  False a model's forward records no tape;
- `backward` and `grad_pairs` (reference :559-634): the (param, grad)
  pairs of every parameter the loss reaches, computed fresh on each call
  with `torch.autograd.grad` (nothing accumulates in `.grad`);
- the remat policies `REMAT_POLICIES` and `remat_wrap` (reference
  :427-450) on `torch.utils.checkpoint`;
- `softmax_cross_entropy` / `cross_entropy` (reference :1507-1533).
"""

from __future__ import annotations

import functools
from typing import Callable, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["set_autocast", "autocast_enabled", "autocast", "training",
           "backward", "grad_pairs", "REMAT_POLICIES", "remat_wrap",
           "softmax_cross_entropy", "cross_entropy"]

#: reference parity: `Model.train(mode)` sets it; a model's forward
#: records no tape while it is False
training = False

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


# -- backward ----------------------------------------------------------------


def _leaves(y: torch.Tensor) -> List[torch.Tensor]:
    """The leaf tensors that need grad and that `y` was computed from, in
    a fixed order (depth first over the tape from `y`)."""
    out, seen, stack = [], set(), [y.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)  # AccumulateGrad: a leaf
        if var is not None:
            out.append(var)
        stack.extend(nxt for nxt, _ in reversed(fn.next_functions))
    return out


def grad_pairs(y: torch.Tensor, dy: Optional[torch.Tensor] = None
               ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Yield (param, grad) for every leaf tensor needing grad that `y`
    reaches, from one `torch.autograd.grad` over the tape; `dy` defaults
    to ones. Unlike the reference's walk, which yields each gradient as it
    finalizes, all of them are computed before the first is yielded."""
    if y.grad_fn is None:
        return
    params = _leaves(y)
    if not params:
        return
    grads = torch.autograd.grad(y, params, grad_outputs=dy,
                                allow_unused=True)
    for p, g in zip(params, grads):
        if g is not None:
            yield p, g


def backward(y: torch.Tensor, dy: Optional[torch.Tensor] = None):
    """[(param, grad), ...] for every parameter `y` reaches."""
    return list(grad_pairs(y, dy))


# -- rematerialization policies ----------------------------------------------
#
# - "none":          save every residual (fastest step, most memory).
# - "per_block":     save only the wrapped function's inputs; the whole
#                    body runs again in backward (torch.utils.checkpoint).
# - "dots_saveable": save the outputs of matrix products, recompute the
#                    elementwise chains between them (a selective
#                    checkpoint). A hand-written kernel is no matrix
#                    product to PyTorch's dispatcher, so it runs again,
#                    as a Pallas call does under the reference's policy.

REMAT_POLICIES = ("none", "per_block", "dots_saveable")

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_saveable_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(_save_dots)


def remat_wrap(fn: Callable, policy: str = "none") -> Callable:
    """Wrap `fn` with the named rematerialization policy (see
    REMAT_POLICIES). Without grad recording the policy has nothing to
    save, and `fn` runs as it is."""
    if policy not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat policy {policy!r}; pick one of {REMAT_POLICIES}")
    if policy == "none":
        return fn
    from torch.utils.checkpoint import checkpoint

    kw = {"context_fn": _dots_saveable_context} if (
        policy == "dots_saveable") else {}

    @functools.wraps(fn)
    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


# -- losses ------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, target) -> torch.Tensor:
    """Mean softmax cross-entropy over the rows of `logits` (..., C);
    `target` is int labels (...) or one-hot (..., C). The loss math is
    fp32 whatever the logits' dtype."""
    logp = F.log_softmax(logits.float(), dim=-1)
    target = torch.as_tensor(target, device=logits.device)
    if target.is_floating_point():
        return -(target.float() * logp).sum(dim=-1).mean()
    # the one-hot sum picks one term: a gather computes it exactly
    return -logp.gather(-1, target.long().unsqueeze(-1)).mean()


cross_entropy = softmax_cross_entropy
