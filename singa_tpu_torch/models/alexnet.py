"""AlexNet (counterpart of singa_tpu/models/alexnet.py): the one-tower,
BN-free ImageNet net (224 or 227 x 227 input, 6 x 6 x 256 features) and
the CIFAR-10 adaptation of the reference trainer (32 x 32 input,
2 x 2 x 256 features). Parameter names are the reference's; `device=`
and `generator=` as in `models/resnet`.
"""

from __future__ import annotations

from typing import Optional

import torch

from singa_tpu_torch import layer
from singa_tpu_torch.models.common import Classifier

__all__ = ["AlexNet", "CifarAlexNet", "alexnet", "alexnet_cifar"]


class AlexNet(Classifier):
    """ImageNet AlexNet."""

    def __init__(self, num_classes: int = 1000, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = layer._setup(device, generator)
        kw = dict(device=dev, generator=gen)
        self.features = layer.Sequential(
            layer.Conv2d(64, 11, in_channels=3, stride=4, padding=2, **kw),
            layer.ReLU(),
            layer.MaxPool2d(3, stride=2),
            layer.Conv2d(192, 5, in_channels=64, padding=2, **kw),
            layer.ReLU(),
            layer.MaxPool2d(3, stride=2),
            layer.Conv2d(384, 3, in_channels=192, padding=1, **kw),
            layer.ReLU(),
            layer.Conv2d(256, 3, in_channels=384, padding=1, **kw),
            layer.ReLU(),
            layer.Conv2d(256, 3, in_channels=256, padding=1, **kw),
            layer.ReLU(),
            layer.MaxPool2d(3, stride=2),
        )
        self.flatten = layer.Flatten()
        self.classifier = layer.Sequential(
            layer.Dropout(0.5),
            layer.Linear(4096, in_features=256 * 6 * 6, **kw),
            layer.ReLU(),
            layer.Dropout(0.5),
            layer.Linear(4096, in_features=4096, **kw),
            layer.ReLU(),
            layer.Linear(num_classes, in_features=4096, **kw),
        )

    def forward(self, x):
        return self.classifier(self.flatten(self.features(x)))


class CifarAlexNet(Classifier):
    """CIFAR-10-shaped AlexNet (32 x 32 input)."""

    def __init__(self, num_classes: int = 10, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = layer._setup(device, generator)
        kw = dict(device=dev, generator=gen)
        self.features = layer.Sequential(
            layer.Conv2d(64, 3, in_channels=3, stride=2, padding=1, **kw),
            layer.ReLU(),
            layer.MaxPool2d(2),
            layer.Conv2d(192, 3, in_channels=64, padding=1, **kw),
            layer.ReLU(),
            layer.MaxPool2d(2),
            layer.Conv2d(384, 3, in_channels=192, padding=1, **kw),
            layer.ReLU(),
            layer.Conv2d(256, 3, in_channels=384, padding=1, **kw),
            layer.ReLU(),
            layer.Conv2d(256, 3, in_channels=256, padding=1, **kw),
            layer.ReLU(),
            layer.MaxPool2d(2),
        )
        self.flatten = layer.Flatten()
        self.classifier = layer.Sequential(
            layer.Dropout(0.5),
            layer.Linear(1024, in_features=256 * 2 * 2, **kw),
            layer.ReLU(),
            layer.Dropout(0.5),
            layer.Linear(512, in_features=1024, **kw),
            layer.ReLU(),
            layer.Linear(num_classes, in_features=512, **kw),
        )

    def forward(self, x):
        return self.classifier(self.flatten(self.features(x)))


def alexnet(num_classes=1000, **kw):
    return AlexNet(num_classes, **kw)


def alexnet_cifar(num_classes=10, **kw):
    return CifarAlexNet(num_classes, **kw)
