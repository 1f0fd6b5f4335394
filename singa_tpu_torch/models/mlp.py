"""MLP (counterpart of singa_tpu/models/mlp.py): the judged eager
configuration, the reference SINGA's `examples/mlp` model, an autograd
MLP on MNIST.

Linear -> ReLU -> Dropout(0.2) -> Linear. The reference infers fc1's
input width at the first call; here `in_features` (keyword-only beside
the reference's arguments) defaults to 784, a flattened MNIST image, so
the layers are built at once; `in_features=None` infers it at the first
call, as the reference does. Parameter names are the reference's (`fc1.W`,
`fc1.b`, `fc2.W`, `fc2.b`), so `model.load_singa_tpu_params` carries its
weights across unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch

from singa_tpu_torch import autograd, layer, model

__all__ = ["MLP"]


class MLP(model.Model):
    def __init__(self, perceptron_size: int = 100, num_classes: int = 10, *,
                 in_features: Optional[int] = 784, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = layer._setup(device, generator)
        self.fc1 = layer.Linear(perceptron_size, in_features=in_features,
                                device=dev, generator=gen)
        self.relu = layer.ReLU()
        self.fc2 = layer.Linear(num_classes, in_features=perceptron_size,
                                device=dev, generator=gen)
        self.dropout = layer.Dropout(0.2)

    def forward(self, x):
        h = self.relu(self.fc1(x))
        h = self.dropout(h)
        return self.fc2(h)

    def train_one_batch(self, x, y, dist_option: str = "plain",
                        spars=None):
        out = self.forward(x)
        loss = autograd.softmax_cross_entropy(out, y)
        self._apply_opt(loss, dist_option, spars)
        return out, loss
