"""MobileNetV1 (counterpart of singa_tpu/models/mobilenet.py): a stem
conv, then 13 depthwise-separable units, each a depthwise 3x3 conv
(groups = its input width) with BatchNorm and ReLU, then a pointwise
1x1 conv with BatchNorm and ReLU; global average pool and fc.
`mobilenet_v1` is the ImageNet shape (224 x 224 input), and
`mobilenet_v1_cifar` the CIFAR-10 one of the reference trainer (stride-1
stem, width multiplier 0.5).

The units are built from plain `Conv2d`s rather than `SeparableConv2d`,
as in the reference: BatchNorm and ReLU sit between the two convs. The
nets pass each unit its input width (`in_ch=`), so every weight is made
at construction; a unit built without it makes its depthwise conv at
the first call, as the reference's `initialize` does. Parameter and
buffer names are the reference's (`blocks.layers.0.dw.W`); `device=`
and `generator=` as in `models/resnet`.

Depthwise convs do one multiply-add per weight per pixel, so they move
bytes rather than arithmetic; every conv here is one `F.conv2d`.
"""

from __future__ import annotations

from typing import Optional

import torch

from singa_tpu_torch import layer
from singa_tpu_torch.models.common import Classifier

__all__ = ["MobileNetV1", "mobilenet_v1", "mobilenet_v1_cifar"]


class _SepBlock(layer.Layer):
    """Depthwise 3x3 (+BN/ReLU) then pointwise 1x1 (+BN/ReLU): the
    MobileNetV1 unit."""

    def __init__(self, out_ch: int, stride: int = 1, *,
                 in_ch: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._dev, self._gen = layer._setup(device, generator)
        self.stride, self.out_ch = stride, out_ch
        self.bn_dw = layer.BatchNorm2d(num_features=in_ch, device=self._dev)
        self.relu_dw = layer.ReLU()
        self.pw = layer.Conv2d(out_ch, 1, bias=False, in_channels=in_ch,
                               device=self._dev, generator=self._gen)
        self.bn_pw = layer.BatchNorm2d(num_features=out_ch, device=self._dev)
        self.relu_pw = layer.ReLU()
        self._lazy = True  # the depthwise conv waits for the input width
        self._settle(in_ch)

    _in_width = staticmethod(layer._channels)

    def _make(self, c):
        self.dw = layer.Conv2d(c, 3, stride=self.stride, padding=1, group=c,
                               bias=False, in_channels=c, device=self._dev,
                               generator=self._gen)

    def forward(self, x):
        self._ready(x)
        h = self.relu_dw(self.bn_dw(self.dw(x)))
        return self.relu_pw(self.bn_pw(self.pw(h)))


class MobileNetV1(Classifier):
    """MobileNetV1 with width multiplier `alpha`; 224 x 224 NCHW input
    at the default stem stride."""

    #: (out_channels, stride) per separable unit, at alpha 1
    _CFG = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
            (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
            (1024, 1)]

    def __init__(self, num_classes: int = 1000, alpha: float = 1.0,
                 stem_stride: int = 2, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = layer._setup(device, generator)
        width = max(8, int(32 * alpha))
        self.stem = layer.Sequential(
            layer.Conv2d(width, 3, stride=stem_stride, padding=1, bias=False,
                         in_channels=3, device=dev, generator=gen),
            layer.BatchNorm2d(num_features=width, device=dev),
            layer.ReLU())
        blocks = []
        for c, s in self._CFG:
            c = max(8, int(c * alpha))
            blocks.append(_SepBlock(c, s, in_ch=width, device=dev,
                                    generator=gen))
            width = c
        self.blocks = layer.Sequential(*blocks)
        self.pool = layer.GlobalAvgPool2d()
        self.fc = layer.Linear(num_classes, in_features=width, device=dev,
                               generator=gen)

    def forward(self, x):
        return self.fc(self.pool(self.blocks(self.stem(x))))


def mobilenet_v1(num_classes=1000, alpha=1.0, **kw):
    return MobileNetV1(num_classes, alpha, **kw)


def mobilenet_v1_cifar(num_classes=10, alpha=0.5, **kw):
    """CIFAR shape: a stride-1 stem keeps 32 x 32 longer."""
    return MobileNetV1(num_classes, alpha, stem_stride=1, **kw)
