"""Char-RNN / LSTM language model (counterpart of
singa_tpu/models/char_rnn.py, the reference's judged RNN configuration).

A character-level LSTM LM trained with truncated backpropagation
through time over fixed-length chunks: Embedding -> (stacked) LSTM ->
vocabulary projection. The LSTM's input projection of every step is one
product and a Python loop carries the recurrent one (`autograd.lstm`);
on the card `compile(..., use_graph=True)` captures the whole training
step, loop included, as one CUDA Graph.
"""

from __future__ import annotations

from typing import Optional

import torch

from singa_tpu_torch import autograd, layer
from singa_tpu_torch import device as device_module
from singa_tpu_torch.model import Model

__all__ = ["CharRNN"]


class CharRNN(Model):
    """Embedding -> LSTM -> Linear. `train_one_batch(x, y)` takes int
    chunks x, y (B, T), y being x shifted by one; the loss is the mean
    cross-entropy over all B*T positions."""

    def __init__(self, vocab_size: int, hidden_size: int = 256,
                 embed_dim: int = 64, num_layers: int = 1,
                 remat: bool = False, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = device_module.resolve(device)
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
        self.vocab_size = vocab_size
        self.embed = layer.Embedding(vocab_size, embed_dim, device=dev,
                                     generator=generator)
        self.lstm = layer.LSTM(hidden_size, num_layers=num_layers,
                               batch_first=True, return_sequences=True,
                               remat=remat, input_size=embed_dim,
                               device=dev, generator=generator)
        self.fc = layer.Linear(vocab_size, in_features=hidden_size,
                               device=dev, generator=generator)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def forward(self, x) -> torch.Tensor:
        """x (B, T) int -> logits (B, T, V)."""
        h = self.embed(torch.as_tensor(x, device=self.device).long())
        return self.fc(self.lstm(h))

    def train_one_batch(self, x, y):
        logits = self.forward(x)
        flat = autograd.reshape(logits, (-1, self.vocab_size))
        y = torch.as_tensor(y, device=flat.device).reshape(-1)
        loss = autograd.softmax_cross_entropy(flat, y)
        self._optimizer(loss)
        return logits, loss
