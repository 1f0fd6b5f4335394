"""Layers (counterpart of singa_tpu/layer.py), as `nn.Module`s.

The reference's layers infer their input width lazily at the first call;
here widths are constructor arguments, and parameters are made at once
on `device=` from a `torch.Generator`, with the reference's init
distributions (not its random bits). Parameter names and layouts are the
reference's, so `model.load_singa_tpu_params` maps them one to one:
`Linear.W` is (in, out), and `ScanTransformerStack` keeps its per-block
weights stacked on a leading (L, ...) dim under the names of `STACKED`.

Numerics follow the reference exactly: layer-norm statistics in fp32 with
the population variance (`jnp.var`), cast back to the input dtype; the
tanh approximation of GELU (`jax.nn.gelu(approximate=True)`); the bias
joined at the product's output dtype; matrix products under the autocast
policy of `autograd`.

The CNN layers (`Conv2d` with OIHW `W` and "he" init, `BatchNorm2d` with
`scale`, `offset` and the buffers `running_mean`, `running_var`, the
pools, `ReLU`, `Flatten`, `Sequential`) run in the current image layout
(`layout.py`). `Sequential` keeps its layers in an `nn.ModuleList` named
`layers`, so dotted names are the reference's
(`layer1.layers.0.conv1.layers.0.W`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from singa_tpu_torch import autograd
from singa_tpu_torch import device as device_module
from singa_tpu_torch.ops import flash_attention as fa

__all__ = ["Linear", "Embedding", "LayerNorm", "Dropout",
           "ScanTransformerStack", "Conv2d", "BatchNorm2d", "MaxPool2d",
           "AvgPool2d", "GlobalAvgPool2d", "ReLU", "Flatten", "Sequential"]


def _new(shape, dev, gen, init: str, a: float = 0.0) -> nn.Parameter:
    """A parameter: uniform(-a, a), normal(0, a), he (normal with
    std sqrt(2 / a), `a` the fan-in), ones or zeros."""
    t = torch.empty(shape, dtype=torch.float32, device=dev)
    if init == "uniform":
        t.uniform_(-a, a, generator=gen)
    elif init == "normal":
        t.normal_(0.0, a, generator=gen)
    elif init == "he":
        t.normal_(0.0, math.sqrt(2.0 / max(1, a)), generator=gen)
    elif init == "ones":
        t.fill_(1.0)
    else:
        t.zero_()
    return nn.Parameter(t)


def _setup(device, generator):
    dev = device_module.resolve(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    return dev, generator


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    a, w = autograd._mxu_cast(a, w)
    return autograd._mxu_result(torch.matmul(a, w))


def _layernorm(x, scale, offset, eps: float = 1e-5) -> torch.Tensor:
    """fp32 statistics, population variance, cast back to x's dtype."""
    xf = x.float()
    m = xf.mean(dim=-1, keepdim=True)
    v = xf.var(dim=-1, keepdim=True, correction=0)
    return ((xf - m) * torch.rsqrt(v + eps) * scale + offset).to(x.dtype)


class Linear(nn.Module):
    """y = x W (+ b) with W stored (in, out), as in the reference."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = _setup(device, generator)
        a = math.sqrt(6.0 / max(1, in_features + out_features))  # xavier
        self.W = _new((in_features, out_features), dev, gen, "uniform", a)
        self.b = _new((out_features,), dev, gen, "zeros") if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _mm(x, self.W)
        if self.b is None:
            return y
        return y + self.b.to(y.dtype)  # bias joins at the output dtype


class Embedding(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = _setup(device, generator)
        self.table = _new((vocab_size, embed_dim), dev, gen, "normal", 0.1)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return self.table[idx]


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, *, device=None):
        super().__init__()
        dev = device_module.resolve(device)
        self.eps = eps
        self.scale = _new((dim,), dev, None, "ones")
        self.offset = _new((dim,), dev, None, "zeros")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _layernorm(x, self.scale, self.offset, self.eps)


class Dropout(nn.Module):
    """Inverted dropout in training mode, identity in eval mode. The
    draws are PyTorch's, not the reference's."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout(x, self.p, training=self.training)


class ScanTransformerStack(nn.Module):
    """N identical post-LN transformer blocks over stacked (L, ...)
    weights, looped in Python (the reference rolls them into one
    `lax.scan`). Dense single-device branch only (reference
    layer.py:1373-1389): fused QKV projection, attention through the
    `attention_qkv` dispatcher (the fused-layout flash kernel once T
    clears its threshold), output projection, LN, GELU FFN, LN.
    `remat` applies one of `autograd.REMAT_POLICIES` to each block, as
    the reference wraps its scan body."""

    #: the stacked parameter names, in the reference's order
    STACKED = ("w_qkv", "b_qkv", "w_o", "b_o", "ln1_s", "ln1_o",
               "ln2_s", "ln2_o", "w1", "b1", "w2", "b2")

    def __init__(self, n_blocks: int, num_heads: int, d_model: int,
                 ffn_mult: int = 4, causal: bool = False,
                 remat: str = "none", tp_axis: Optional[str] = None,
                 zero3_axis: Optional[str] = None,
                 seq_axis: Optional[str] = None, overlap: bool = False,
                 *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        for name, val in (("tp_axis", tp_axis), ("zero3_axis", zero3_axis),
                          ("seq_axis", seq_axis)):
            if val is not None:
                raise NotImplementedError(
                    f"ScanTransformerStack({name}=) is the sharded stack of "
                    f"the distributed slice (ROADMAP queue 1 item 15)")
        if overlap:
            raise NotImplementedError(
                "ScanTransformerStack(overlap=) belongs to the distributed "
                "slice (ROADMAP queue 1 item 15)")
        if remat not in autograd.REMAT_POLICIES:
            raise ValueError(
                f"unknown remat policy {remat!r}; pick one of "
                f"{autograd.REMAT_POLICIES}")
        if n_blocks < 1:
            raise ValueError("n_blocks must be >= 1")
        if d_model % num_heads:
            raise ValueError(
                f"d_model {d_model} not divisible by {num_heads} heads")
        dev, gen = _setup(device, generator)
        self.n_blocks, self.num_heads = n_blocks, num_heads
        self.ffn_mult, self.causal, self.remat = ffn_mult, causal, remat
        L, d, ff = n_blocks, d_model, ffn_mult * d_model
        k = 1.0 / math.sqrt(d)
        self.w_qkv = _new((L, d, 3 * d), dev, gen, "uniform", k)
        self.b_qkv = _new((L, 3 * d), dev, gen, "uniform", k)
        self.w_o = _new((L, d, d), dev, gen, "uniform", k)
        self.b_o = _new((L, d), dev, gen, "uniform", k)
        self.ln1_s = _new((L, d), dev, gen, "ones")
        self.ln1_o = _new((L, d), dev, gen, "zeros")
        self.ln2_s = _new((L, d), dev, gen, "ones")
        self.ln2_o = _new((L, d), dev, gen, "zeros")
        xavier = math.sqrt(6.0 / (d + ff))
        self.w1 = _new((L, d, ff), dev, gen, "uniform", xavier)
        self.b1 = _new((L, ff), dev, gen, "zeros")
        self.w2 = _new((L, ff, d), dev, gen, "uniform", xavier)
        self.b2 = _new((L, d), dev, gen, "zeros")

    def _block(self, h: torch.Tensor, wqkv, bqkv, wo, bo, l1s, l1o, l2s,
               l2o, w1, b1, w2, b2) -> torch.Tensor:
        qkv = _mm(h, wqkv)
        qkv = qkv + bqkv.to(qkv.dtype)
        o = fa.attention_qkv(qkv, self.num_heads, causal=self.causal)
        a = _mm(o, wo)
        a = a + bo.to(a.dtype)
        h = _layernorm(h + a, l1s, l1o)
        f1 = _mm(h, w1)
        f = F.gelu(f1 + b1.to(f1.dtype), approximate="tanh")
        f2 = _mm(f, w2)
        f = f2 + b2.to(f2.dtype)
        return _layernorm(h + f, l2s, l2o)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        block = autograd.remat_wrap(self._block, self.remat)
        # one unbind per stacked weight: its backward stacks the blocks'
        # gradients in one write, where indexing w[i] per block would
        # zero-fill and sum a full (L, ...) gradient for every block
        for params in zip(*(getattr(self, n).unbind(0)
                            for n in self.STACKED)):
            x = block(x, *params)
        return x


# -- CNN layers ----------------------------------------------------------------


class Conv2d(nn.Module):
    """Convolution in the current image layout; `W` is OIHW
    (nb_kernels, in_channels // group, kh, kw) in both layouts, with the
    reference's "he" init, and `b` (nb_kernels,) zeros."""

    def __init__(self, in_channels: int, nb_kernels: int, kernel_size,
                 stride=1, padding=0, dilation=1, group: int = 1,
                 bias: bool = True, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = _setup(device, generator)
        kh, kw = autograd._pair(kernel_size)
        self.stride, self.padding = stride, padding
        self.dilation, self.group = dilation, group
        fan_in = in_channels * kh * kw // group
        self.W = _new((nb_kernels, in_channels // group, kh, kw), dev, gen,
                      "he", fan_in)
        self.b = _new((nb_kernels,), dev, gen, "zeros") if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return autograd.conv2d(x, self.W, self.b, self.stride, self.padding,
                               self.dilation, self.group)


class BatchNorm2d(nn.Module):
    """`autograd.batchnorm` with `scale` (ones), `offset` (zeros) and the
    buffers `running_mean` (zeros) and `running_var` (ones). In training
    mode each call updates the running statistics in place, including
    calls without grad recording (such as `Model.compile`'s forward, as
    in the reference)."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, sync: Optional[bool] = None, *,
                 device=None):
        super().__init__()
        dev = device_module.resolve(device)
        self.momentum, self.eps, self.sync = momentum, eps, sync
        self.scale = _new((num_features,), dev, None, "ones")
        self.offset = _new((num_features,), dev, None, "zeros")
        self.register_buffer("running_mean", torch.zeros(
            num_features, dtype=torch.float32, device=dev))
        self.register_buffer("running_var", torch.ones(
            num_features, dtype=torch.float32, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, new_rm, new_rv = autograd.batchnorm(
            x, self.scale, self.offset, self.running_mean, self.running_var,
            momentum=self.momentum, eps=self.eps, train=self.training,
            sync=self.sync)
        if self.training:
            with torch.no_grad():
                self.running_mean.copy_(new_rm)
                self.running_var.copy_(new_rv)
        return y


class MaxPool2d(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return autograd.max_pool2d(x, self.k, self.s, self.p)


class AvgPool2d(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return autograd.avg_pool2d(x, self.k, self.s, self.p)


class GlobalAvgPool2d(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return autograd.global_avg_pool2d(x)


class ReLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return autograd.relu(x)


class Flatten(nn.Module):
    """Flatten the dims from `start_axis` on. The reference rotates an
    NHWC activation back to NCHW first, so that the following Linear
    sees the NCHW feature order in both layouts; here a channels-last
    activation already has the logical NCHW shape, and flattening it
    gives that order, so there is nothing to rotate."""

    def __init__(self, start_axis: int = 1):
        super().__init__()
        self.start_axis = start_axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return autograd.flatten(x, self.start_axis)


class Sequential(nn.Module):
    def __init__(self, *layers: nn.Module):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for lyr in self.layers:
            x = lyr(x)
        return x
