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

`graph(True)` (the default of `compile(..., use_graph=True)`) routes the
training step through `graph.GraphStep`: on the card the whole step
(forward, backward, clipping, the optimizer update) is captured as one
CUDA Graph per input signature at its second call and replayed after
that; on the CPU the same function runs uncaptured. `graph(False)` runs
the step eagerly. Calls in eval mode run `forward` as they are (the
reference's compiled eval step is not ported), and `memory_estimate` is
None (ROADMAP queue 1 item 7).

`load_singa_tpu_params` carries a `singa_tpu` model's weights into the
port: it takes `{name: np.asarray(t.data) for name, t in
jax_model.get_params().items()}` and copies each array into the port's
parameter of the same name, in the same layout. `load_singa_tpu_states`
does the same for parameters and buffers (BatchNorm's running
statistics) together, from the reference's `get_states()`.

`set_image_layout("NHWC")` runs a CNN channels-last inside while its
inputs and outputs stay NCHW (`layout.py`). As in the reference,
`compile`'s forward runs with the layers in training mode (only the tape
is off), so a BatchNorm's running statistics take one update from it.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from singa_tpu_torch import autograd
from singa_tpu_torch import layout as layout_module
from singa_tpu_torch.graph import GraphStep

__all__ = ["Model", "load_singa_tpu_params", "load_singa_tpu_states"]


class Model(nn.Module):
    """Base user model; `named_parameters()` gives the reference's
    dotted parameter names. Subclasses define `forward` and
    `train_one_batch`."""

    def __init__(self):
        super().__init__()
        self._optimizer = None
        # bound user implementation, captured by graph(): its presence
        # routes training-mode calls (and direct `train_one_batch` calls)
        # to the training step
        self._user_train_one_batch = None
        self._use_graph = False
        self._train_step: Optional[GraphStep] = None

    def _apply_opt(self, loss, dist_option: str = "plain", spars=None):
        """The reference trainers' optimizer dispatch. With a plain (not
        distributed) optimizer every `dist_option` takes a local step, as
        the reference's does; `spars` only means something to DistOpt."""
        del dist_option, spars
        if self._optimizer is None:
            raise RuntimeError("no optimizer: call set_optimizer() first")
        self._optimizer(loss)

    def set_image_layout(self, img_layout: str) -> None:
        """Run this model's forward in `img_layout` ("NCHW" or "NHWC")
        while its 4-D inputs and outputs stay NCHW: under "NHWC" a 4-D
        input is copied into channels-last memory once at the boundary
        and a 4-D output back. Weights keep their OIHW shapes. Call
        before `compile()`; "NCHW" restores the default."""
        if img_layout not in ("NCHW", "NHWC"):
            raise ValueError(f"unknown image layout {img_layout!r}")
        if getattr(self, "_img_layout", None) is None:
            inner = type(self).forward.__get__(self)

            def adapt(a, convert):
                return convert(a) if getattr(a, "ndim", 0) == 4 else a

            def adapt_out(o):
                if isinstance(o, (tuple, list)):
                    return type(o)(adapt_out(v) for v in o)
                return adapt(o, layout_module.to_nchw)

            def wrapped_forward(*args, **kwargs):
                with layout_module.use_image_layout(self._img_layout):
                    out = inner(
                        *[adapt(a, layout_module.from_nchw) for a in args],
                        **{k: adapt(v, layout_module.from_nchw)
                           for k, v in kwargs.items()})
                    return adapt_out(out)

            self.forward = wrapped_forward
        self._img_layout = img_layout

    @property
    def memory_estimate(self):
        """None: the reference reads this from its compiled step's memory
        plan, which is not ported yet (ROADMAP queue 1 item 7)."""
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
        """Route training-mode calls and direct `train_one_batch` calls
        to the training step: captured (`GraphStep`) when `mode`, eager
        otherwise. Drops the steps captured so far. `sequential` is
        accepted for the reference's API: the stream orders the step's
        kernels either way."""
        del sequential
        self._use_graph = bool(mode)
        self._train_step = None
        if self._user_train_one_batch is None:
            self._user_train_one_batch = type(self).train_one_batch.__get__(
                self)
            # an instance attribute shadows the class's method: direct
            # `m.train_one_batch(x, y)` calls (the reference trainers'
            # style) take the route of `m(x, y)`, as the reference's
            # `__getattribute__` routes them
            self.train_one_batch = self._dispatch_train

    def _dispatch_train(self, *args, **kwargs):
        if self._use_graph:
            if self._train_step is None:
                self._train_step = GraphStep(self, self._user_train_one_batch)
            return self._train_step(*args, **kwargs)
        return self._user_train_one_batch(*args, **kwargs)

    def train(self, mode: bool = True):
        super().train(mode)
        autograd.training = bool(mode)
        return self

    def train_one_batch(self, *args):
        raise NotImplementedError(
            "Model subclasses must define train_one_batch")

    def __call__(self, *args, **kwargs):
        if self.training and self._user_train_one_batch is not None:
            return self._dispatch_train(*args, **kwargs)
        with torch.set_grad_enabled(
                autograd.training and torch.is_grad_enabled()):
            return super().__call__(*args, **kwargs)


def _copy_named(own: Mapping[str, torch.Tensor],
                given: Mapping[str, np.ndarray]) -> None:
    unknown = sorted(set(given) - set(own))
    missing = sorted(set(own) - set(given))
    if unknown or missing:
        raise KeyError(f"names differ: unknown {unknown}, "
                       f"missing {missing}")
    bad = {k: (tuple(np.shape(v)), tuple(own[k].shape))
           for k, v in given.items() if tuple(np.shape(v)) != own[k].shape}
    if bad:
        raise ValueError(f"shape mismatch (given, expected): {bad}")
    with torch.no_grad():
        for k, v in given.items():
            own[k].copy_(torch.from_numpy(np.array(v)))


def load_singa_tpu_params(model: nn.Module,
                          params: Mapping[str, np.ndarray]) -> None:
    """Copy reference parameters into `model`, name for name. Raises on
    an unknown name, a missing name or a shape mismatch."""
    _copy_named(dict(model.named_parameters()), params)


def load_singa_tpu_states(model: nn.Module,
                          states: Mapping[str, np.ndarray]) -> None:
    """Copy a reference model's `get_states()` (parameters and buffers)
    into `model`, name for name. Raises on an unknown name, a missing
    name or a shape mismatch."""
    own = dict(model.named_parameters())
    own.update(model.named_buffers())
    _copy_named(own, states)
