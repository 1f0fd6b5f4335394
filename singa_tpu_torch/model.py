"""Model API and the weight carry-over (counterpart of singa_tpu/model.py).

`Model` is an `nn.Module` with the reference's training surface
(`singa_tpu/model.py:49-261`):

    m.set_optimizer(opt.AdamW(lr=3e-4))
    m.compile([x], is_train=True, use_graph=True, precision="bf16")
    logits, loss = m(x, y)               # or m.train_one_batch(x, y)

After `compile(..., is_train=True)` a call in training mode runs the
subclass's `train_one_batch`; otherwise `m(ids)` runs `forward`, with
grad recording only while `autograd.training` is set (so scoring in eval
mode keeps no tape, as the reference records none).

`graph(True)` keeps the reference's API, but in this slice it runs the
same step uncaptured: capturing forward, backward and update as one CUDA
graph is ROADMAP queue 1 item 7, and `memory_estimate` is None until then.

`load_singa_tpu_params` carries a `singa_tpu` model's weights into the
port: it takes `{name: np.asarray(t.data) for name, t in
jax_model.get_params().items()}` and copies each array into the port's
parameter of the same name, in the same layout.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from singa_tpu_torch import autograd

__all__ = ["Model", "load_singa_tpu_params"]


class Model(nn.Module):
    """Base user model; `named_parameters()` gives the reference's
    dotted parameter names. Subclasses define `forward` and
    `train_one_batch`."""

    def __init__(self):
        super().__init__()
        self._optimizer = None
        # bound user implementation, captured by graph(): its presence
        # routes training-mode calls to the training step
        self._user_train_one_batch = None

    def _apply_opt(self, loss, dist_option: str = "plain", spars=None):
        """The reference trainers' optimizer dispatch. With a plain (not
        distributed) optimizer every `dist_option` takes a local step, as
        the reference's does; `spars` only means something to DistOpt."""
        del dist_option, spars
        if self._optimizer is None:
            raise RuntimeError("no optimizer: call set_optimizer() first")
        self._optimizer(loss)

    @property
    def memory_estimate(self):
        """None: the reference reads this from its compiled step's memory
        plan, and step capture is not ported yet (ROADMAP queue 1
        item 7)."""
        return None

    @property
    def optimizer(self):
        return self._optimizer

    def set_optimizer(self, opt) -> None:
        """Use `opt` for the training step; its slots take this model's
        parameter names (the reference names them at its first traced
        step; here every parameter already exists)."""
        self._optimizer = opt
        opt.prepare(dict(self.named_parameters()))

    def compile(self, inputs: Sequence, is_train: bool = True,
                use_graph: bool = False, sequential: bool = False,
                precision: Optional[str] = None) -> None:
        """Run one forward without a tape (the reference infers shapes
        there), then set the mode and the execution mode.
        precision="bf16" turns on the autocast policy for this process
        (fp32 master weights, bf16 matrix-product operands);
        precision="fp32" turns it off."""
        if precision is not None:
            if precision not in ("fp32", "bf16"):
                raise ValueError(f"unknown precision {precision!r}")
            autograd.set_autocast(precision == "bf16")
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        with torch.no_grad():
            self.forward(*inputs)
        self.train(is_train)
        self.graph(use_graph, sequential)

    def graph(self, mode: bool = True, sequential: bool = False) -> None:
        """Route training-mode calls to `train_one_batch`. `mode` and
        `sequential` are the reference's API: the step runs uncaptured
        either way in this slice (see the module docstring)."""
        del mode, sequential
        if self._user_train_one_batch is None:
            self._user_train_one_batch = type(self).train_one_batch.__get__(
                self)

    def train(self, mode: bool = True):
        super().train(mode)
        autograd.training = bool(mode)
        return self

    def train_one_batch(self, *args):
        raise NotImplementedError(
            "Model subclasses must define train_one_batch")

    def __call__(self, *args, **kwargs):
        if self.training and self._user_train_one_batch is not None:
            return self._user_train_one_batch(*args, **kwargs)
        with torch.set_grad_enabled(
                autograd.training and torch.is_grad_enabled()):
            return super().__call__(*args, **kwargs)


def load_singa_tpu_params(model: nn.Module,
                          params: Mapping[str, np.ndarray]) -> None:
    """Copy reference parameters into `model`, name for name. Raises on
    an unknown name, a missing name or a shape mismatch."""
    own = dict(model.named_parameters())
    unknown = sorted(set(params) - set(own))
    missing = sorted(set(own) - set(params))
    if unknown or missing:
        raise KeyError(f"parameter names differ: unknown {unknown}, "
                       f"missing {missing}")
    bad = {k: (tuple(np.shape(v)), tuple(own[k].shape))
           for k, v in params.items() if tuple(np.shape(v)) != own[k].shape}
    if bad:
        raise ValueError(f"shape mismatch (given, expected): {bad}")
    with torch.no_grad():
        for k, v in params.items():
            own[k].copy_(torch.from_numpy(np.array(v)))
