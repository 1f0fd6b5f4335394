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
- `softmax_cross_entropy` / `cross_entropy` (reference :1507-1533);
- the CNN ops, as plain functions on tensors: `conv2d`, `batchnorm`,
  `max_pool2d`, `avg_pool2d`, `global_avg_pool2d`, `relu`, `add` and
  `flatten` (reference :640-682, :895, :982-1323). Under the "NHWC"
  image layout (`layout.py`) the activations are channels-last tensors
  of logical NCHW shape, so every op indexes channels on axis 1.
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import Callable, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from singa_tpu_torch import layout as layout_module
from singa_tpu_torch.ops import max_pool

__all__ = ["set_autocast", "autocast_enabled", "autocast", "training",
           "backward", "grad_pairs", "REMAT_POLICIES", "remat_wrap",
           "softmax_cross_entropy", "cross_entropy", "add", "flatten",
           "relu", "conv2d", "DEGENERATE_STAT_COUNT", "batchnorm",
           "max_pool2d", "avg_pool2d", "global_avg_pool2d"]

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


# -- CNN ops -------------------------------------------------------------------


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def flatten(x: torch.Tensor, start_axis: int = 1) -> torch.Tensor:
    """Flatten the dims from `start_axis` on (the batch axis stays)."""
    return x.reshape(*x.shape[:start_axis], -1)


def relu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)


def _pair(v) -> Tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def conv2d(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None, stride=1, padding=0,
           dilation=1, groups: int = 1) -> torch.Tensor:
    """2-D convolution, weight OIHW in both image layouts; operands under
    the autocast policy, the bias joined at the output dtype. cuDNN keeps
    a channels-last input channels-last. The reference lowers 1x1 convs
    over small outputs to matrix products, a tiling choice of the TPU;
    here every conv is one `F.conv2d` (only the summation order
    differs)."""
    if isinstance(padding, str):
        raise NotImplementedError(
            "conv2d(padding='same'/'valid') comes with SeparableConv2d "
            "and the mobile nets (ROADMAP queue 1 item 6)")
    a, ww = _mxu_cast(x, w)
    out = _mxu_result(F.conv2d(a, ww, None, _pair(stride), _pair(padding),
                               _pair(dilation), groups))
    if b is not None:
        out = out + b.view(1, -1, 1, 1).to(out.dtype)
    return out


#: per-channel statistic count (N*H*W) below which training-mode batch
#: norm normalizes with the running statistics (reference :1083)
DEGENERATE_STAT_COUNT = 16


def batchnorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              running_mean: torch.Tensor, running_var: torch.Tensor,
              momentum: float = 0.9, eps: float = 1e-5, train: bool = True,
              sync: Optional[bool] = None):
    """Batch normalization over the channel axis; returns (y,
    new_running_mean, new_running_var). The reference's formula, not
    `F.batch_norm`:

    - statistics in fp32 in one pass, var = E[x^2] - E[x]^2 clamped at 0,
      and y cast back to x's dtype;
    - running update `r * momentum + batch * (1 - momentum)` with the
      biased batch variance (PyTorch's own uses the unbiased variance and
      the opposite momentum);
    - when N*H*W < DEGENERATE_STAT_COUNT, training normalizes with the
      running statistics and still updates them from the batch moments
      held without gradient, and warns.

    `sync` (cross-replica statistics) belongs to the distributed slice:
    None and False mean local statistics."""
    if sync:
        raise NotImplementedError(
            "batchnorm(sync=True) needs DistOpt's process group (ROADMAP "
            "queue 1 item 12)")
    c_axis = layout_module.channel_axis(x.dim())
    red = tuple(i for i in range(x.dim()) if i != c_axis)
    bshape = [1] * x.dim()
    bshape[c_axis] = x.shape[c_axis]
    xf = x.float()
    if not train:
        xhat = (xf - running_mean.view(bshape)) * torch.rsqrt(
            running_var.view(bshape) + eps)
        y = xhat * gamma.view(bshape) + beta.view(bshape)
        return y.to(x.dtype), running_mean, running_var
    n_stat = math.prod(x.shape[i] for i in red)
    degenerate = n_stat < DEGENERATE_STAT_COUNT
    with torch.set_grad_enabled(torch.is_grad_enabled() and not degenerate):
        m = xf.mean(red)
        v = (xf.square().mean(red) - m.square()).clamp_min(0.0)
    if degenerate:
        warnings.warn(
            f"BatchNorm: only {n_stat} elements per channel "
            f"(< {DEGENERATE_STAT_COUNT}); batch statistics are "
            "degenerate, so normalizing with the running statistics "
            "instead (the running moments still update from the batch)",
            stacklevel=2)
        xhat = (xf - running_mean.view(bshape)) * torch.rsqrt(
            running_var.view(bshape) + eps)
    else:
        xhat = (xf - m.view(bshape)) * torch.rsqrt(v.view(bshape) + eps)
    y = xhat * gamma.view(bshape) + beta.view(bshape)
    new_rm = running_mean * momentum + m.detach() * (1 - momentum)
    new_rv = running_var * momentum + v.detach() * (1 - momentum)
    return y.to(x.dtype), new_rm, new_rv


def _pool2d(x: torch.Tensor, kernel, stride, padding, kind: str):
    k = _pair(kernel)
    s = _pair(stride if stride is not None else kernel)
    p = _pair(padding)
    if kind == "avg":
        # padding excluded from the average, as cuDNN's default
        return F.avg_pool2d(x, k, s, p, count_include_pad=False)
    if x.dim() == 4 and layout_module.image_layout() == "NHWC":
        # the channels-last activation seen as the (N, H, W, C) tensor it
        # is in memory; the op's backward is the K2a kernel when on
        y = max_pool.maxpool2d_nhwc(x.permute(0, 2, 3, 1), k, s, p)
        return y.permute(0, 3, 1, 2)
    return F.max_pool2d(x, k, s, p)


def max_pool2d(x: torch.Tensor, kernel, stride=None,
               padding=0) -> torch.Tensor:
    """Max-pool; padding is never selected. Under "NHWC" 4-D inputs go
    through `ops.max_pool.maxpool2d_nhwc` (reference :1264-1277), under
    "NCHW" through PyTorch's max-pool and its autograd."""
    return _pool2d(x, kernel, stride, padding, "max")


def avg_pool2d(x: torch.Tensor, kernel, stride=None,
               padding=0) -> torch.Tensor:
    return _pool2d(x, kernel, stride, padding, "avg")


def global_avg_pool2d(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C), the mean taken in fp32."""
    return x.float().mean(dim=layout_module.spatial_axes()).to(x.dtype)
