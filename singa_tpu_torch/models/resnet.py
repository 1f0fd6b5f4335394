"""ResNets (counterpart of singa_tpu/models/resnet.py): the ImageNet
family (224 x 224 input; `resnet50` is the model behind the reference's
ResNet-50 images/s metric) and the CIFAR-10 family (32 x 32 input).

Widths are constructor arguments here, where the reference infers each
layer's input width at its first call; the parameter and buffer names
are the reference's, so `model.load_singa_tpu_states` carries its
weights over. Every constructor takes `device=` (CUDA unless "cpu") and
`generator=` (seeded 0 when None) for the initial weights.
"""

from __future__ import annotations

from typing import List, Optional, Type

import torch
from torch import nn

from singa_tpu_torch import autograd, layer
from singa_tpu_torch.models.common import Classifier

__all__ = ["ResNet", "BasicBlock", "Bottleneck", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "CifarResNet",
           "resnet20_cifar", "resnet32_cifar", "resnet56_cifar"]


def _conv_bn(in_ch, nb_kernels, kernel_size, stride=1, padding=0, *, dev,
             gen):
    return layer.Sequential(
        layer.Conv2d(in_ch, nb_kernels, kernel_size, stride=stride,
                     padding=padding, bias=False, device=dev, generator=gen),
        layer.BatchNorm2d(nb_kernels, device=dev),
    )


class BasicBlock(nn.Module):
    """Two 3x3 convs and the shortcut (ResNet-18/34, the CIFAR nets)."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = layer._setup(device, generator)
        kw = dict(dev=dev, gen=gen)
        self.conv1 = _conv_bn(in_planes, planes, 3, stride=stride, padding=1,
                              **kw)
        self.relu1 = layer.ReLU()
        self.conv2 = _conv_bn(planes, planes, 3, padding=1, **kw)
        self.downsample = (_conv_bn(in_planes, planes * self.expansion, 1,
                                    stride=stride, **kw)
                           if downsample else None)
        self.relu2 = layer.ReLU()

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.conv2(self.relu1(self.conv1(x)))
        return self.relu2(autograd.add(out, identity))


class Bottleneck(nn.Module):
    """1x1 reduce, 3x3 (the stride), 1x1 expand (ResNet-50/101/152)."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = layer._setup(device, generator)
        kw = dict(dev=dev, gen=gen)
        self.conv1 = _conv_bn(in_planes, planes, 1, **kw)
        self.relu1 = layer.ReLU()
        self.conv2 = _conv_bn(planes, planes, 3, stride=stride, padding=1,
                              **kw)
        self.relu2 = layer.ReLU()
        self.conv3 = _conv_bn(planes, planes * self.expansion, 1, **kw)
        self.downsample = (_conv_bn(in_planes, planes * self.expansion, 1,
                                    stride=stride, **kw)
                           if downsample else None)
        self.relu3 = layer.ReLU()

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu1(self.conv1(x))
        out = self.relu2(self.conv2(out))
        out = self.conv3(out)
        return self.relu3(autograd.add(out, identity))


def _stage(block, in_planes, planes, blocks, stride, dev, gen):
    """`blocks` blocks, the first with the stride and, where the width or
    the stride changes, the projection shortcut; returns the stage and
    its output width."""
    downsample = stride != 1 or in_planes != planes * block.expansion
    stage = [block(in_planes, planes, stride=stride, downsample=downsample,
                   device=dev, generator=gen)]
    in_planes = planes * block.expansion
    for _ in range(1, blocks):
        stage.append(block(in_planes, planes, device=dev, generator=gen))
    return layer.Sequential(*stage), in_planes


class ResNet(Classifier):
    """ImageNet-shape ResNet (224 x 224 NCHW input)."""

    def __init__(self, block: Type[nn.Module], layers: List[int],
                 num_classes: int = 1000, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = layer._setup(device, generator)
        self.conv1 = layer.Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                                  device=dev, generator=gen)
        self.bn1 = layer.BatchNorm2d(64, device=dev)
        self.relu = layer.ReLU()
        self.maxpool = layer.MaxPool2d(3, stride=2, padding=1)
        width = 64
        self.layer1, width = _stage(block, width, 64, layers[0], 1, dev, gen)
        self.layer2, width = _stage(block, width, 128, layers[1], 2, dev,
                                    gen)
        self.layer3, width = _stage(block, width, 256, layers[2], 2, dev,
                                    gen)
        self.layer4, width = _stage(block, width, 512, layers[3], 2, dev,
                                    gen)
        self.avgpool = layer.GlobalAvgPool2d()
        self.fc = layer.Linear(width, num_classes, device=dev, generator=gen)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.fc(self.avgpool(x))


class CifarResNet(Classifier):
    """CIFAR-10 shape ResNet (32 x 32 input, three stages of
    BasicBlocks), the reference trainer's resnet."""

    def __init__(self, depth: int = 20, num_classes: int = 10, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if (depth - 2) % 6 != 0:
            raise ValueError("CifarResNet depth must be 6n+2")
        n = (depth - 2) // 6
        dev, gen = layer._setup(device, generator)
        self.conv1 = layer.Conv2d(3, 16, 3, padding=1, bias=False,
                                  device=dev, generator=gen)
        self.bn1 = layer.BatchNorm2d(16, device=dev)
        self.relu = layer.ReLU()
        width = 16
        self.stage1, width = _stage(BasicBlock, width, 16, n, 1, dev, gen)
        self.stage2, width = _stage(BasicBlock, width, 32, n, 2, dev, gen)
        self.stage3, width = _stage(BasicBlock, width, 64, n, 2, dev, gen)
        self.avgpool = layer.GlobalAvgPool2d()
        self.fc = layer.Linear(width, num_classes, device=dev, generator=gen)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.stage3(self.stage2(self.stage1(x)))
        return self.fc(self.avgpool(x))


def resnet18(num_classes=1000, **kw):
    return ResNet(BasicBlock, [2, 2, 2, 2], num_classes, **kw)


def resnet34(num_classes=1000, **kw):
    return ResNet(BasicBlock, [3, 4, 6, 3], num_classes, **kw)


def resnet50(num_classes=1000, **kw):
    return ResNet(Bottleneck, [3, 4, 6, 3], num_classes, **kw)


def resnet101(num_classes=1000, **kw):
    return ResNet(Bottleneck, [3, 4, 23, 3], num_classes, **kw)


def resnet152(num_classes=1000, **kw):
    return ResNet(Bottleneck, [3, 8, 36, 3], num_classes, **kw)


def resnet20_cifar(num_classes=10, **kw):
    return CifarResNet(20, num_classes, **kw)


def resnet32_cifar(num_classes=10, **kw):
    return CifarResNet(32, num_classes, **kw)


def resnet56_cifar(num_classes=10, **kw):
    return CifarResNet(56, num_classes, **kw)
