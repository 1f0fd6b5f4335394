"""Port's optimizers and lr schedules (singa_tpu_torch.opt) against the
reference's (singa_tpu.opt) on the same seeded parameters and gradients.

Each optimizer takes 3 steps through `apply_updates` on both sides, with
a fresh seeded gradient per step; parameters after every step and the
slots after the last must agree within rtol 1e-5 / atol 1e-6 (fp32 on
both sides; both evaluate schedules and bias corrections in float32
from the step counter on the device).
"""

import numpy as np
import pytest
import torch

from singa_tpu import opt as jax_opt
from singa_tpu.tensor import from_numpy
from singa_tpu_torch import opt
from tests.helper_torch_parity import rand, to_torch

RTOL, ATOL = 1e-5, 1e-6
SHAPES = {"w": (6, 5), "b": (5,)}

OPTIMIZERS = [
    ("SGD", dict(lr=0.1)),
    ("SGD", dict(lr=0.1, momentum=0.9)),
    ("SGD", dict(lr=0.1, momentum=0.9, nesterov=True, weight_decay=1e-2)),
    ("SGD", dict(lr=0.05, momentum=0.8, dampening=0.3, weight_decay=0.1)),
    ("Adam", dict(lr=1e-2)),
    ("Adam", dict(lr=1e-2, weight_decay=1e-2, beta1=0.8, beta2=0.99)),
    ("AdamW", dict(lr=1e-2, weight_decay=0.1)),
    ("AdaGrad", dict(lr=0.1, weight_decay=1e-2)),
    ("RMSProp", dict(lr=1e-2, rho=0.8, weight_decay=1e-2)),
    ("SGD", dict(lr=0.1, clip_norm=0.5)),
    ("SGD", dict(lr=0.1, momentum=0.9, clip_value=0.3)),
    ("Adam", dict(lr=1e-2, clip_norm=1.0, clip_value=0.5)),
]


def _pair(name, kw, sched=None):
    ref_kw, port_kw = dict(kw), dict(kw)
    if sched is not None:
        ref_kw["lr"] = sched(jax_opt)
        port_kw["lr"] = sched(opt)
    return getattr(jax_opt, name)(**ref_kw), getattr(opt, name)(**port_kw)


def _params(seed):
    arrays = {n: rand(s, seed + i) for i, (n, s) in enumerate(SHAPES.items())}
    ref = {n: from_numpy(a) for n, a in arrays.items()}
    port = {n: torch.nn.Parameter(to_torch(a)) for n, a in arrays.items()}
    return ref, port


def _step(ref_opt, port_opt, ref, port, seed, scale=1.0):
    grads = {n: rand(s, seed + i, scale=scale)
             for i, (n, s) in enumerate(SHAPES.items())}
    ref_opt.apply_updates([(ref[n], grads[n]) for n in SHAPES])
    port_opt.apply_updates([(port[n], to_torch(grads[n])) for n in SHAPES])


def _assert_params_match(ref, port):
    for n in SHAPES:
        np.testing.assert_allclose(port[n].detach().numpy(),
                                   np.asarray(ref[n].data), rtol=RTOL,
                                   atol=ATOL, err_msg=n)


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(OPTIMIZERS)])
def test_three_steps_match_reference(name, kw):
    ref_opt, port_opt = _pair(name, kw)
    ref, port = _params(0)
    ref_opt.prepare(ref)
    port_opt.prepare(port)
    for step in range(3):
        # a large gradient scale makes the clip modes bind
        _step(ref_opt, port_opt, ref, port, 100 + 10 * step, scale=3.0)
        _assert_params_match(ref, port)
    want = {k: np.asarray(v) for k, v in ref_opt.dump_states().items()}
    got = {k: v.numpy() for k, v in port_opt.dump_states().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


SCHEDULES = [
    lambda m: m.Constant(0.1),
    lambda m: m.ExponentialDecay(0.1, 10, 0.5),
    lambda m: m.ExponentialDecay(0.1, 10, 0.5, staircase=True),
    lambda m: m.CosineDecay(0.1, 100),
    lambda m: m.CosineDecay(0.1, 100, alpha=0.2),
    lambda m: m.Warmup(0.1, 20),
    lambda m: m.Warmup(m.CosineDecay(0.1, 100), 20),
    lambda m: m.Warmup(0.1, 0),
]


@pytest.mark.parametrize("i", range(len(SCHEDULES)))
def test_schedules_match_reference(i):
    """atol 1e-8 = a few float32 steps of the 0.1 init value: near the
    end of a cosine the reference's float32 `1 + cos` cancels."""
    ref, port = SCHEDULES[i](jax_opt), SCHEDULES[i](opt)
    for step in (0, 1, 5, 9, 10, 19, 50, 99, 100, 150):
        np.testing.assert_allclose(port(step), float(ref(np.int32(step))),
                                   rtol=1e-6, atol=1e-8,
                                   err_msg=f"step {step}")


def test_scheduled_lr_drives_the_update():
    sched = (lambda m: m.Warmup(m.ExponentialDecay(0.1, 2, 0.5), 2))
    ref_opt, port_opt = _pair("AdamW", dict(weight_decay=0.1), sched)
    ref, port = _params(1)
    for step in range(3):
        _step(ref_opt, port_opt, ref, port, 200 + step)
        _assert_params_match(ref, port)


def test_clip_gradients_match_reference():
    for kw in (dict(clip_norm=0.7), dict(clip_value=0.2),
               dict(clip_norm=0.7, clip_value=0.2), dict(clip_norm=1e6)):
        ref_opt, port_opt = _pair("SGD", dict(lr=1.0, **kw))
        grads = [rand(s, 7 + i, scale=2.0) for i, s in
                 enumerate(SHAPES.values())]
        want = ref_opt.clip_gradients(grads)
        got = port_opt.clip_gradients([to_torch(g) for g in grads])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7, err_msg=str(kw))


def test_dump_names_and_load_round_trip():
    ref_opt, port_opt = _pair("Adam", dict(lr=1e-2))
    ref, port = _params(2)
    ref_opt.prepare(ref)
    port_opt.prepare(port)
    for step in range(2):
        _step(ref_opt, port_opt, ref, port, 300 + step)
    states = port_opt.dump_states()
    assert sorted(states) == ["__step__", "b//m", "b//v", "w//m", "w//v"]
    assert sorted(states) == sorted(ref_opt.dump_states())
    assert int(states["__step__"]) == 2

    # a fresh optimizer loaded with the dump continues where this one is
    fresh = opt.Adam(lr=1e-2)
    copies = {n: torch.nn.Parameter(p.detach().clone())
              for n, p in port.items()}
    fresh.prepare(copies)
    fresh.load_states({k: v.clone() for k, v in states.items()},
                      strict=True)
    assert fresh.step_counter == 2
    grads = [to_torch(rand(s, 400 + i)) for i, s in
             enumerate(SHAPES.values())]
    port_opt.apply_updates(zip(port.values(), grads))
    fresh.apply_updates(zip(copies.values(), grads))
    for n in SHAPES:
        assert torch.equal(port[n], copies[n])
    with pytest.raises(ValueError, match="match no registered"):
        fresh.load_states({"nope//m": states["w//m"]}, strict=True)


def test_unported_parts_raise():
    # set_sentinel is ported: the sentinel's scalars join the states
    from singa_tpu_torch.resilience import GradSentinel
    from singa_tpu_torch.resilience.sentinel import STATE_KEYS

    sgd, sentinel = opt.SGD(), GradSentinel()
    sgd.set_sentinel(sentinel)
    assert sgd.sentinel is sentinel
    assert set(STATE_KEYS) <= set(sgd.dump_states())
    # the expert axis is a grad axis like the seq axis (the MoE FFN)
    assert opt.DistOpt(opt.SGD(), grad_axes=("data", "expert")).grad_axes \
        == ("data", "expert")
    assert opt.DistOpt(opt.SGD(), grad_axes=("data", "seq")).grad_axes == (
        "data", "seq")


def test_call_runs_backward_and_update():
    """`opt(loss)` is the reference's backward_and_update: one SGD(lr=1)
    step moves each parameter by exactly minus its gradient."""
    w = torch.nn.Parameter(to_torch(rand((4, 3), 9)))
    x = to_torch(rand((5, 4), 10))
    before = w.detach().clone()
    loss = (x @ w).square().mean()
    (want,) = torch.autograd.grad(loss, w, retain_graph=True)
    opt.SGD(lr=1.0)(loss)
    torch.testing.assert_close(w.detach(), before - want)
    assert w.grad is None  # nothing accumulates in .grad
