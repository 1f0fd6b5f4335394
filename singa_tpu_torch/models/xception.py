"""Xception (counterpart of singa_tpu/models/xception.py): entry,
middle and exit flows of `SeparableConv2d` units with BatchNorm, each
block with a shortcut (a strided 1x1 conv with BatchNorm where the shape
changes) and, in the strided blocks, a 3x3 stride-2 max-pool. `xception`
is the ImageNet shape (224 x 224 input, 8 middle blocks), and
`xception_cifar` the CIFAR-10 one of the reference trainer (stride-1
stem, 4 middle blocks).

The nets pass each block its input width (`in_ch=`), so every weight is
made at construction; a block built without it makes its separable
units and shortcut at the first call, as the reference's `initialize`
does. Parameter and buffer names are the reference's
(`entry.layers.0.seps.1.layers.0.depthwise.W`, `middle.layers.0.short`
absent where the shape is kept); `device=` and `generator=` as in
`models/resnet`.

Under the NHWC layout each max-pool runs through
`ops.max_pool.maxpool2d_nhwc`, whose backward is the K2a kernel when
`set_pool_kernel_enabled(True)`: four launches a training step (three
entry blocks and the exit block).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from singa_tpu_torch import autograd, layer
from singa_tpu_torch.models.common import Classifier

__all__ = ["Xception", "xception", "xception_cifar"]


def _sep_bn(out_ch, *, in_ch=None, dev=None, gen=None):
    return layer.Sequential(
        layer.SeparableConv2d(out_ch, 3, padding=1, bias=False,
                              in_channels=in_ch, device=dev, generator=gen),
        layer.BatchNorm2d(num_features=out_ch, device=dev))


class _XBlock(layer.Layer):
    """relu -> sepconv-bn (x reps), an optional stride-2 max-pool, plus
    the shortcut: the Xception unit.

    `grow_first` says where the width changes: on the first separable
    unit (True, the entry flow) or on the last (False, the exit block,
    728 -> 728 -> 1024)."""

    def __init__(self, out_ch: int, reps: int, stride: int = 1,
                 relu_first: bool = True, grow_first: bool = True, *,
                 in_ch: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._dev, self._gen = layer._setup(device, generator)
        self.stride, self.out_ch, self.reps = stride, out_ch, reps
        self.relu_first, self.grow_first = relu_first, grow_first
        self.relus = nn.ModuleList(layer.ReLU() for _ in range(reps))
        if stride != 1:
            self.pool = layer.MaxPool2d(3, stride=stride, padding=1)
        self._lazy = True  # the units and the shortcut wait for the width
        self._settle(in_ch)

    _in_width = staticmethod(layer._channels)

    def _make(self, c):
        kw = dict(dev=self._dev, gen=self._gen)
        chans = ([self.out_ch] * self.reps if self.grow_first
                 else [c] * (self.reps - 1) + [self.out_ch])
        self.seps = nn.ModuleList(
            _sep_bn(o, in_ch=i, **kw)
            for i, o in zip([c] + chans[:-1], chans))
        self.short = None
        if self.stride != 1 or c != self.out_ch:
            self.short = layer.Sequential(
                layer.Conv2d(self.out_ch, 1, stride=self.stride, bias=False,
                             in_channels=c, device=self._dev,
                             generator=self._gen),
                layer.BatchNorm2d(num_features=self.out_ch,
                                  device=self._dev))

    def forward(self, x):
        self._ready(x)
        idn = x if self.short is None else self.short(x)
        h = x
        for i, (relu, sep) in enumerate(zip(self.relus, self.seps)):
            if i > 0 or self.relu_first:
                h = relu(h)
            h = sep(h)
        if self.stride != 1:
            h = self.pool(h)
        return autograd.add(h, idn)


class Xception(Classifier):
    """Entry, middle and exit flows; `middle_reps` middle blocks (8 in
    the ImageNet original)."""

    def __init__(self, num_classes: int = 1000, middle_reps: int = 8,
                 stem_stride: int = 2, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = layer._setup(device, generator)
        kw = dict(device=dev, generator=gen)
        self.stem = layer.Sequential(
            layer.Conv2d(32, 3, stride=stem_stride, padding=1, bias=False,
                         in_channels=3, **kw),
            layer.BatchNorm2d(num_features=32, device=dev),
            layer.ReLU(),
            layer.Conv2d(64, 3, padding=1, bias=False, in_channels=32, **kw),
            layer.BatchNorm2d(num_features=64, device=dev),
            layer.ReLU())
        # the entry flow's first block has no leading relu: the stem's is
        # just before it
        self.entry = layer.Sequential(
            _XBlock(128, 2, stride=2, relu_first=False, in_ch=64, **kw),
            _XBlock(256, 2, stride=2, in_ch=128, **kw),
            _XBlock(728, 2, stride=2, in_ch=256, **kw))
        self.middle = layer.Sequential(*[
            _XBlock(728, 3, in_ch=728, **kw) for _ in range(middle_reps)])
        self.exit_block = _XBlock(1024, 2, stride=2, grow_first=False,
                                  in_ch=728, **kw)
        self.exit_sep1 = _sep_bn(1536, in_ch=1024, dev=dev, gen=gen)
        self.exit_relu1 = layer.ReLU()
        self.exit_sep2 = _sep_bn(2048, in_ch=1536, dev=dev, gen=gen)
        self.exit_relu2 = layer.ReLU()
        self.pool = layer.GlobalAvgPool2d()
        self.fc = layer.Linear(num_classes, in_features=2048, device=dev,
                               generator=gen)

    def forward(self, x):
        h = self.stem(x)
        h = self.exit_block(self.middle(self.entry(h)))
        h = self.exit_relu1(self.exit_sep1(h))
        h = self.exit_relu2(self.exit_sep2(h))
        return self.fc(self.pool(h))


def xception(num_classes=1000, **kw):
    return Xception(num_classes, **kw)


def xception_cifar(num_classes=10, **kw):
    """CIFAR shape: a stride-1 stem and 4 middle blocks."""
    return Xception(num_classes, middle_reps=4, stem_stride=1, **kw)
