"""Optimizers and lr schedules, single device (counterpart of
singa_tpu/opt.py:42-504).

The update formulas, slot names and state names are the reference's:
each parameter's slots (`"momentum"`, `"m"`/`"v"`, `"accum"`, `"ms"`)
dump as `"{param}//{slot}"` beside `"__step__"`. They are torch tensors
on the parameters' device, and each update writes its parameter in place
(under `torch.no_grad()`), where the reference rebinds a new array.

`opt(loss)` runs the backward (`autograd.grad_pairs`) and the update, as
the reference's `backward_and_update` does.

Every update is capturable as part of one CUDA Graph (`graph.GraphStep`):

- the step counter is an int32 tensor on the parameters' device, as the
  reference's is, and the schedules and Adam's bias corrections are
  computed from it on the device inside the step (in float32, as the
  reference computes them), so a replay reads the step it runs, not the
  one it was captured at; `step_counter` is the host's mirror of it;
- every slot is written in place, so a replay updates the tensors the
  next replay reads.

`set_sentinel(resilience.GradSentinel(...))` guards the update (reference
:136-149, :230-320): the loss is scaled before the backward, the
gradients are unscaled and their global-norm square sum checked for
finiteness (`clip_gradients(square_sum=)` shares that reduction), and a
non-finite step puts the parameters, the slots and the step counter back
to their pre-step values with `torch.where`, on the device, so the
guarded step stays one CUDA Graph. With a sentinel `step_counter`, the
host mirror, counts update attempts; the device counter `_step` (in
`dump_states`) does not advance on a skipped step.

`DistOpt` (data-parallel sync over `torch.distributed`) is
`communicator.DistOpt`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch

from singa_tpu_torch import autograd

__all__ = ["DecayScheduler", "Constant", "ExponentialDecay", "CosineDecay",
           "Warmup", "Optimizer", "SGD", "Adam", "AdamW", "AdaGrad",
           "RMSProp", "DistOpt"]


# -- lr schedules ------------------------------------------------------------


def _as_step(step) -> torch.Tensor:
    """A step as a tensor: the optimizer's device counter as it is, a
    host number as a 0-dim int64 tensor on the host."""
    return step if isinstance(step, torch.Tensor) else torch.as_tensor(step)


class DecayScheduler:
    """A learning rate as a function of the step. Called with the
    optimizer's device counter it returns a float32 tensor on that
    device (the constant schedule returns its float)."""

    def __init__(self, init_value: float):
        self.init_value = float(init_value)

    def __call__(self, step):
        raise NotImplementedError


class Constant(DecayScheduler):
    def __call__(self, step) -> float:
        return self.init_value


class ExponentialDecay(DecayScheduler):
    def __init__(self, init_value, decay_steps, decay_rate, staircase=False):
        super().__init__(init_value)
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def __call__(self, step) -> torch.Tensor:
        p = _as_step(step) / self.decay_steps
        if self.staircase:
            p = torch.floor(p)
        return self.init_value * torch.pow(self.decay_rate, p)


class CosineDecay(DecayScheduler):
    def __init__(self, init_value, total_steps, alpha: float = 0.0):
        super().__init__(init_value)
        self.total_steps = total_steps
        self.alpha = alpha

    def __call__(self, step) -> torch.Tensor:
        frac = torch.clamp(_as_step(step) / self.total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return self.init_value * ((1 - self.alpha) * cos + self.alpha)


class Warmup(DecayScheduler):
    """Linear lr warmup over the first `warmup_steps`, then the wrapped
    schedule: `Warmup(0.1, 50)` or `Warmup(CosineDecay(0.1, 10_000), 50)`.
    """

    def __init__(self, base, warmup_steps: int):
        base = base if isinstance(base, DecayScheduler) else Constant(base)
        super().__init__(base.init_value)
        self.base = base
        self.warmup_steps = int(warmup_steps)

    def __call__(self, step):
        if self.warmup_steps <= 0:
            return self.base(step)
        ramp = torch.clamp((_as_step(step) + 1.0) / self.warmup_steps,
                           0.0, 1.0)
        return ramp * self.base(step)


# -- base optimizer ----------------------------------------------------------


class Optimizer:
    """Slots, clipping and the backward-and-update step.

    `clip_norm` / `clip_value`: gradient clipping across the whole
    gradient set right before the update: clip_value clamps each element,
    then clip_norm rescales every gradient by min(1, clip_norm / global
    norm), the norm accumulated in fp32.
    """

    #: state slot names this optimizer keeps per parameter (subclass sets)
    slot_names: Tuple[str, ...] = ()

    def __init__(self, lr: Union[float, DecayScheduler],
                 clip_norm: Optional[float] = None,
                 clip_value: Optional[float] = None):
        self.lr = lr if isinstance(lr, DecayScheduler) else Constant(lr)
        self.clip_norm = clip_norm
        self.clip_value = clip_value
        #: the host's mirror of `_step`, the device step counter
        self.step_counter = 0
        self._step = torch.zeros((), dtype=torch.int32)
        self._slots: Dict[int, Dict[str, torch.Tensor]] = {}
        self._names: Dict[int, str] = {}  # id(param) -> name (dump/load)
        #: id(param) -> param, of the prepared ones (load_states reads a
        #: placed parameter's block layout)
        self._params: Dict[int, torch.Tensor] = {}
        self._anon = 0
        #: the resilience GradSentinel (`set_sentinel`), or None
        self.sentinel = None

    # -- the resilience sentinel ---------------------------------------------
    def set_sentinel(self, sentinel) -> None:
        """Attach a `resilience.GradSentinel` (module docstring): the loss
        is scaled before the backward, the gradients unscaled and checked,
        and a non-finite step leaves the parameters, slots and step
        counter bitwise as they were while the scale backs off. Attach
        before the first captured step."""
        self.sentinel = sentinel
        if sentinel is not None:
            sentinel.to(self._step.device)

    def _scaled_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return loss if self.sentinel is None else (
            self.sentinel.scale_loss(loss))

    # -- reference call style: opt(loss) ------------------------------------
    def __call__(self, loss: torch.Tensor):
        return self.backward_and_update(loss)

    def backward_and_update(self, loss: torch.Tensor) -> None:
        """Gradients of every parameter `loss` reaches (of the scaled loss
        with a sentinel), then the update."""
        self.apply_updates(autograd.grad_pairs(self._scaled_loss(loss)))

    # -- clipping ------------------------------------------------------------
    @staticmethod
    def _grad_square_sum(grads, params=None) -> torch.Tensor:
        """fp32 square-sum of the whole gradient set, pspec-aware with
        `params` (reference :174-206): the square sum of a gradient
        whose parameter is sharded over live mesh axes (a tensor-parallel
        block, a ZeRO-3 stack, an expert shard) is only its shard's, so
        it is summed over those axes (in sorted order) before it enters
        the total, and every rank clips by the same global norm. The
        gradients are grouped by axis set: one all-reduce a set."""
        from singa_tpu_torch.communicator import pspec_axis_names, psum_over
        from singa_tpu_torch.parallel import mesh as mesh_module

        groups: Dict[Tuple[str, ...], torch.Tensor] = {}
        for i, g in enumerate(grads):
            p = params[i] if params is not None else None
            axes = tuple(sorted(ax for ax in pspec_axis_names(p)
                                if mesh_module.in_axis(ax)))
            s = g.float().square().sum()
            groups[axes] = groups[axes] + s if axes in groups else s
        return sum(psum_over(groups[axes], axes) if axes else groups[axes]
                   for axes in sorted(groups))

    def clip_gradients(self, grads, params=None, square_sum=None):
        """clip_value (elementwise), then clip_norm (global-norm
        rescale), on a list of gradient tensors; `params` (the
        gradients' parameters) makes the norm pspec-aware
        (`_grad_square_sum`). `square_sum`, when given, is taken as the
        square sum of `grads` as passed (the sentinel's, shared so the
        reduction runs once); clip_value changes the norm, so it is
        ignored then."""
        if self.clip_value is not None:
            cv = float(self.clip_value)
            grads = [g.clamp(-cv, cv) for g in grads]
            square_sum = None  # the clamp changed the norm
        if self.clip_norm is not None and grads:
            sq = square_sum if square_sum is not None else (
                self._grad_square_sum(grads, params))
            norm = sq.sqrt()
            scale = torch.clamp(
                self.clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
            grads = [g * scale.to(g.dtype) for g in grads]
        return grads

    def apply_updates(self, pairs) -> None:
        """Clip the whole gradient set, run the per-param updates, step.
        With a sentinel the gradients are first unscaled, the all-finite
        check rides the clip's square sum, and the update is guarded
        (`_guarded_apply`)."""
        pairs = list(pairs)
        if pairs:
            self._place_step(pairs[0][0].device)
        grads = [g for _, g in pairs]
        params = [p for p, _ in pairs]
        sent = self.sentinel
        if sent is None:
            grads = self.clip_gradients(grads, params=params)
            with torch.no_grad():
                for p, g in zip(params, grads):
                    self.update(p, g)
            self.step()
            return
        grads = [sent.unscale(g) for g in grads]
        sq = self._grad_square_sum(grads, params)
        ok = sent.check(sq)
        grads = self.clip_gradients(
            grads, params=params,
            square_sum=sq if self.clip_value is None else None)
        self._guarded_apply(params, grads, ok)

    @torch.no_grad()
    def _guarded_apply(self, params, grads, ok: torch.Tensor) -> None:
        """The updates, then every parameter, slot and the step counter
        put back to its pre-step value where `ok` is false (reference
        :264-300, one `lax.cond` there): `torch.where` against copies
        taken before the update, written in place."""
        for p in params:
            self._slot(p)  # every slot exists before the snapshot
        slots = [t for p in params for t in self._slots[id(p)].values()]
        state = list(params) + slots + [self._step]
        old = [t.clone() for t in state]
        for p, g in zip(params, grads):
            self.update(p, g)
        self.step()
        for t, o in zip(state, old):
            t.copy_(torch.where(ok, t, o))
        self.sentinel.advance(ok)

    # -- slots ---------------------------------------------------------------
    def _slot(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        s = self._slots.get(id(p))
        if s is None:
            s = {name: torch.zeros_like(p, memory_format=torch.preserve_format)
                 for name in self.slot_names}
            self._slots[id(p)] = s
            if id(p) not in self._names:
                self._names[id(p)] = f"param{self._anon}"
                self._anon += 1
        return s

    def _place_step(self, dev: torch.device) -> None:
        """Keep the step counter (and the sentinel's scalars) on the
        parameters' device."""
        if self._step.device != dev:
            self._step = self._step.to(dev)
        if self.sentinel is not None:
            self.sentinel.to(dev)

    def prepare(self, named_params: Dict[str, torch.Tensor]) -> None:
        """Name every parameter's slots (for dump/load) and make them,
        and put the step counter on the parameters' device."""
        for name, p in named_params.items():
            self._names[id(p)] = name
            self._params[id(p)] = p
            self._slot(p)
            self._place_step(p.device)

    def dump_states(self) -> Dict[str, torch.Tensor]:
        out = {"__step__": self._step.clone()}
        for pid, slots in self._slots.items():
            pname = self._names[pid]
            for sname, arr in slots.items():
                out[f"{pname}//{sname}"] = arr
        if self.sentinel is not None:
            # the loss-scale and skip scalars ride checkpoints like slots
            out.update(self.sentinel.dump_states())
        return out

    def load_states(self, states: Dict[str, torch.Tensor],
                    strict: bool = False) -> None:
        """Load a `dump_states`-shaped dict back into the slots, in
        place. ``strict=True`` refuses entries that match no registered
        parameter by name (call `prepare` with the named parameters
        first); ownerless `//`-prefixed scalars (the sentinel's) are
        exempt both ways."""
        if self.sentinel is not None:
            states = self.sentinel.absorb_states(states)
        if "__step__" in states:
            self.step_counter = int(states["__step__"])
            self._step.fill_(self.step_counter)
        by_name = {n: pid for pid, n in self._names.items()}
        dropped = []
        for k, arr in states.items():
            if k == "__step__":
                continue
            pname, _, sname = k.rpartition("//")
            pid = by_name.get(pname)
            if pid is not None and pid in self._slots:
                slot = self._slots[pid].get(sname)
                src = torch.as_tensor(arr)
                p = self._params.get(pid)
                if p is not None:
                    from singa_tpu_torch.layer import block_source

                    # a parameter placed on a mesh takes the block of a
                    # full (checkpoint) slot
                    src = block_source(p, src)
                if slot is None:
                    self._slots[pid][sname] = src.clone()
                else:  # in place: a captured step keeps reading `slot`
                    slot.copy_(src)
            elif pname:
                dropped.append(k)
        if strict and dropped:
            raise ValueError(
                f"load_states(strict=True): {len(dropped)} state "
                f"entr{'y' if len(dropped) == 1 else 'ies'} match no "
                f"registered parameter (e.g. {sorted(dropped)[:3]}); call "
                f"prepare() with this run's named params first, or the "
                f"states belong to a different model")

    # -- update --------------------------------------------------------------
    def lr_value(self):
        """The learning rate at the current step: a float32 tensor on the
        step counter's device, or the float of a constant schedule."""
        return self.lr(self._step)

    def step(self) -> None:
        self._step.add_(1)
        self.step_counter += 1

    def update(self, p: torch.Tensor, g: torch.Tensor) -> None:
        raise NotImplementedError

    def apply(self, p: torch.Tensor, g: torch.Tensor) -> None:
        """Reference-style alias of `update`."""
        with torch.no_grad():
            self.update(p, g)


class SGD(Optimizer):
    """SGD with momentum / nesterov / weight decay / dampening."""

    def __init__(self, lr: Union[float, DecayScheduler] = 0.1,
                 momentum: float = 0.0, weight_decay: float = 0.0,
                 dampening: float = 0.0, nesterov: bool = False,
                 clip_norm: Optional[float] = None,
                 clip_value: Optional[float] = None):
        super().__init__(lr, clip_norm=clip_norm, clip_value=clip_value)
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.dampening = dampening
        self.nesterov = nesterov
        self.slot_names = ("momentum",) if momentum != 0.0 else ()

    def update(self, p, g) -> None:
        grad = g.to(p.dtype)
        if self.weight_decay:
            grad = grad + self.weight_decay * p
        if self.momentum:
            s = self._slot(p)
            buf = s["momentum"]
            buf.copy_(self.momentum * buf + (1 - self.dampening) * grad)
            grad = grad + self.momentum * buf if self.nesterov else buf
        p.sub_(self.lr_value() * grad)


class Adam(Optimizer):
    slot_names = ("m", "v")

    def __init__(self, lr: Union[float, DecayScheduler] = 1e-3,
                 beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 clip_norm: Optional[float] = None,
                 clip_value: Optional[float] = None):
        super().__init__(lr, clip_norm=clip_norm, clip_value=clip_value)
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.weight_decay = weight_decay

    def update(self, p, g) -> None:
        grad = g.to(p.dtype)
        if self.weight_decay:
            grad = grad + self.weight_decay * p
        s = self._slot(p)
        t = (self._step + 1).to(p.dtype)
        s["m"].copy_(self.beta1 * s["m"] + (1 - self.beta1) * grad)
        s["v"].copy_(self.beta2 * s["v"] + (1 - self.beta2) * grad * grad)
        mhat = s["m"] / (1 - torch.pow(self.beta1, t))
        vhat = s["v"] / (1 - torch.pow(self.beta2, t))
        p.sub_(self.lr_value() * mhat / (vhat.sqrt() + self.eps))


class AdamW(Adam):
    """Adam with decoupled weight decay (Loshchilov & Hutter): the decay
    multiplies the parameter directly at the update, outside the adaptive
    moments."""

    def __init__(self, lr: Union[float, DecayScheduler] = 1e-3,
                 beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-2,
                 clip_norm: Optional[float] = None,
                 clip_value: Optional[float] = None):
        super().__init__(lr, beta1, beta2, eps, weight_decay=0.0,
                         clip_norm=clip_norm, clip_value=clip_value)
        self.decoupled_decay = weight_decay

    def update(self, p, g) -> None:
        if self.decoupled_decay:
            p.mul_(1.0 - self.lr_value() * self.decoupled_decay)
        super().update(p, g)


class AdaGrad(Optimizer):
    slot_names = ("accum",)

    def __init__(self, lr=0.01, eps: float = 1e-10, weight_decay: float = 0.0,
                 clip_norm: Optional[float] = None,
                 clip_value: Optional[float] = None):
        super().__init__(lr, clip_norm=clip_norm, clip_value=clip_value)
        self.eps = eps
        self.weight_decay = weight_decay

    def update(self, p, g) -> None:
        grad = g.to(p.dtype)
        if self.weight_decay:
            grad = grad + self.weight_decay * p
        s = self._slot(p)
        s["accum"].add_(grad * grad)
        p.sub_(self.lr_value() * grad / (s["accum"].sqrt() + self.eps))


class RMSProp(Optimizer):
    slot_names = ("ms",)

    def __init__(self, lr=0.01, rho=0.9, eps=1e-8, weight_decay: float = 0.0,
                 clip_norm: Optional[float] = None,
                 clip_value: Optional[float] = None):
        super().__init__(lr, clip_norm=clip_norm, clip_value=clip_value)
        self.rho, self.eps = rho, eps
        self.weight_decay = weight_decay

    def update(self, p, g) -> None:
        grad = g.to(p.dtype)
        if self.weight_decay:
            grad = grad + self.weight_decay * p
        s = self._slot(p)
        s["ms"].copy_(self.rho * s["ms"] + (1 - self.rho) * grad * grad)
        p.sub_(self.lr_value() * grad / (s["ms"].sqrt() + self.eps))


# the data-parallel wrapper lives beside its Communicator, as in the
# reference; `opt.DistOpt` is its public name
from singa_tpu_torch.communicator import DistOpt  # noqa: E402
