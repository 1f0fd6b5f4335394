"""VGG (counterpart of singa_tpu/models/vgg.py): VGG-11/13/16/19 with
optional BatchNorm at ImageNet shape (224 x 224 input, 7 x 7 x 512
features), and `vgg16_cifar`, the CIFAR-10 shape (32 x 32 input, 512
features, 512-wide classifier) of the reference trainer. Parameter names
are the reference's; `device=` and `generator=` as in `models/resnet`.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from singa_tpu_torch import layer
from singa_tpu_torch.models.common import Classifier

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "vgg16_cifar"]

_CFGS = {
    11: [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    13: [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512,
         "M"],
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
         512, 512, 512, "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
         512, "M", 512, 512, 512, 512, "M"],
}


def _features(cfg: List[Union[int, str]], batch_norm: bool, dev,
              gen) -> layer.Sequential:
    layers, width = [], 3
    for v in cfg:
        if v == "M":
            layers.append(layer.MaxPool2d(2, stride=2))
            continue
        layers.append(layer.Conv2d(v, 3, in_channels=width, padding=1,
                                   bias=not batch_norm, device=dev,
                                   generator=gen))
        if batch_norm:
            layers.append(layer.BatchNorm2d(num_features=v, device=dev))
        layers.append(layer.ReLU())
        width = v
    return layer.Sequential(*layers)


class VGG(Classifier):
    def __init__(self, depth: int = 16, num_classes: int = 1000,
                 batch_norm: bool = False, cifar: bool = False, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = layer._setup(device, generator)
        self.features = _features(_CFGS[depth], batch_norm, dev, gen)
        self.flatten = layer.Flatten()
        # CIFAR input is 32x32 -> 1x1x512 after 5 pools; no 4096 FCs
        hidden = 512 if cifar else 4096
        flat = 512 if cifar else 512 * 7 * 7
        kw = dict(device=dev, generator=gen)
        self.classifier = layer.Sequential(
            layer.Linear(hidden, in_features=flat, **kw),
            layer.ReLU(),
            layer.Dropout(0.5),
            layer.Linear(hidden, in_features=hidden, **kw),
            layer.ReLU(),
            layer.Dropout(0.5),
            layer.Linear(num_classes, in_features=hidden, **kw),
        )

    def forward(self, x):
        return self.classifier(self.flatten(self.features(x)))


def vgg11(num_classes=1000, batch_norm=False, **kw):
    return VGG(11, num_classes, batch_norm, **kw)


def vgg13(num_classes=1000, batch_norm=False, **kw):
    return VGG(13, num_classes, batch_norm, **kw)


def vgg16(num_classes=1000, batch_norm=False, **kw):
    return VGG(16, num_classes, batch_norm, **kw)


def vgg19(num_classes=1000, batch_norm=False, **kw):
    return VGG(19, num_classes, batch_norm, **kw)


def vgg16_cifar(num_classes=10, batch_norm=True, **kw):
    return VGG(16, num_classes, batch_norm, cifar=True, **kw)
