"""The rest of the reference's autograd surface in the port
(singa_tpu_torch.autograd), against singa_tpu.autograd.

- `__all__`: every name the reference exports, the port exports;
- the 40 functional ops (`sub` ... `mse_loss`): forward and gradient of
  sum(op(x) * w) against the reference on the same seeded numpy inputs,
  one case each, within 1e-5 (relative and absolute: the two sum in
  different orders); `argsort` and `one_hot` have no gradient, and their
  values are equal;
- the tie rules: a reduction's max or min shares the gradient evenly,
  elementwise `maximum` and `clip` give half to each side of a tie,
  `sort` sends gradients back through the (stable) permutation, `norm`
  over every `ord`, `axis` and `keepdims`, `one_hot` of labels outside
  the classes, `mse_loss`'s mean;
- the cases of `tests/test_autograd.py` and `tests/test_ops_extended.py`
  that hold the tape and the ops against numpy;
- `Operator` and `Function` against the reference's: the default VJP, a
  custom backward used as written, a multi-output op, an input whose
  backward gives None, no recording outside training, a `Function`
  inside a graph-mode training step, and outputs freed when dropped (no
  reference cycle through the node);
- the op cache switches: eager training equal with the cache off and on,
  disabling flushes, and `set_flash_enabled` flushes.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import autograd as R
from singa_tpu import tensor as ref_tensor
from singa_tpu_torch import autograd as P
from singa_tpu_torch import opt
from singa_tpu_torch.models import MLP

TOL = 1e-5


@pytest.fixture(autouse=True)
def _training():
    R.training = P.training = True
    yield
    R.training = P.training = False


def rand(shape, seed, kind="any"):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if kind == "pos":
        a = np.abs(a) + 0.5
    elif kind == "small":
        a = 0.5 * a
    return a


def ref_param(a):
    t = ref_tensor.from_numpy(a)
    t.requires_grad = True
    t.stores_grad = True
    return t


def port_param(a):
    return torch.from_numpy(a.copy()).requires_grad_(True)


def close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


IDX = np.array([[2, 0], [1, 2]], np.int32)
COND = rand((3, 4), 99) > 0
LABELS = np.array([0, 3, 1, -1, 4], np.int32)  # -1 and 4: rows of zeros

#: name -> (fn(A, *xs) with A the autograd module, input (shape, kind)s)
CASES = {
    "sub": (lambda A, a, b: A.sub(a, b), [((3, 4), "any")] * 2),
    "mul": (lambda A, a, b: A.mul(a, b), [((3, 4), "any")] * 2),
    "div": (lambda A, a, b: A.div(a, b), [((3, 4), "any"), ((3, 4), "pos")]),
    "pow": (lambda A, a, b: A.pow(a, b), [((3, 4), "pos"), ((3, 4), "small")]),
    "matmul": (lambda A, a, b: A.matmul(a, b), [((2, 3, 4), "any"),
                                                ((4, 5), "any")]),
    "squeeze": (lambda A, a: A.squeeze(a, 1), [((3, 1, 4), "any")]),
    "unsqueeze": (lambda A, a: A.unsqueeze(a, (0, 2)), [((3, 4), "any")]),
    "split": (lambda A, a: A.mul(A.split(a, [1, 3], axis=1)[1],
                                 A.split(a, [1, 3], axis=1)[2]),
              [((3, 5), "any")]),
    "gather": (lambda A, a: A.gather(a, IDX, axis=1), [((3, 4), "any")]),
    "stack": (lambda A, a, b: A.stack([a, b], axis=1), [((3, 4), "any")] * 2),
    "where": (lambda A, a, b: A.where(COND, a, b), [((3, 4), "any")] * 2),
    "clip": (lambda A, a: A.clip(a, -0.5, 0.5), [((3, 4), "any")]),
    "abs": (lambda A, a: A.abs(a), [((3, 4), "any")]),
    "exp": (lambda A, a: A.exp(a), [((3, 4), "any")]),
    "log": (lambda A, a: A.log(a), [((3, 4), "pos")]),
    "sqrt": (lambda A, a: A.sqrt(a), [((3, 4), "pos")]),
    "square": (lambda A, a: A.square(a), [((3, 4), "any")]),
    "maximum": (lambda A, a, b: A.maximum(a, b), [((3, 4), "any")] * 2),
    "minimum": (lambda A, a, b: A.minimum(a, b), [((3, 4), "any")] * 2),
    "max": (lambda A, a: A.max(a, axis=1, keepdims=True), [((3, 4), "any")]),
    "min": (lambda A, a: A.min(a, axis=(0, 2)), [((3, 4, 2), "any")]),
    "prod": (lambda A, a: A.prod(a, axis=1), [((3, 4), "any")]),
    "var": (lambda A, a: A.var(a, axis=0, ddof=1), [((5, 4), "any")]),
    "std": (lambda A, a: A.std(a, axis=1, keepdims=True), [((3, 6), "any")]),
    "cumsum": (lambda A, a: A.cumsum(a, axis=1), [((3, 4), "any")]),
    "cumprod": (lambda A, a: A.cumprod(a, axis=0), [((4, 3), "any")]),
    "norm": (lambda A, a: A.norm(a, ord=3.0, axis=1), [((3, 4), "any")]),
    "sort": (lambda A, a: A.sort(a, axis=0, descending=True),
             [((4, 3), "any")]),
    "argsort": (lambda A, a: A.argsort(a, descending=True),
                [((3, 5), "any")]),
    "topk": (lambda A, a: A.topk(a, 2, axis=0)[0], [((5, 3), "any")]),
    "one_hot": (lambda A, a: A.one_hot(LABELS, 4), [((1,), "any")]),
    "einsum": (lambda A, a, b: A.einsum("bij,jk->bik", a, b),
               [((2, 3, 4), "any"), ((4, 5), "any")]),
    "pad": (lambda A, a: A.pad(a, ((1, 0), (2, 1)), value=0.5),
            [((3, 4), "any")]),
    "elu": (lambda A, a: A.elu(a, alpha=0.7), [((3, 4), "any")]),
    "erf": (lambda A, a: A.erf(a), [((3, 4), "any")]),
    "softplus": (lambda A, a: A.softplus(a), [((3, 4), "any")]),
    "log_softmax": (lambda A, a: A.log_softmax(a, axis=0), [((3, 4), "any")]),
    "sum": (lambda A, a: A.sum(a, axis=(0, 1)), [((3, 4, 2), "any")]),
    "mean": (lambda A, a: A.mean(a, axis=-1, keepdims=True),
             [((3, 4), "any")]),
    "mse_loss": (lambda A, a: A.mse_loss(a, rand((3, 4), 7)),
                 [((3, 4), "any")]),
}
NO_GRAD = {"argsort", "one_hot"}


def run_both(fn, arrays, wseed=1):
    """fn on both packages: (ref value, port value, ref grads, port
    grads) of sum(fn(*xs) * w), w seeded, of the shape of fn's value."""
    rx = [ref_param(a) for a in arrays]
    px = [port_param(a) for a in arrays]
    rv, pv = fn(R, *rx), fn(P, *px)
    if not pv.requires_grad:
        return np.asarray(rv.data), pv.numpy(), None, None
    w = rand(tuple(pv.shape), wseed)
    rg = dict(R.backward(R.sum(R.mul(rv, ref_tensor.from_numpy(w)))))
    pg = dict((id(p), g) for p, g in P.backward(
        P.sum(P.mul(pv, torch.from_numpy(w)))))
    return (np.asarray(rv.data), pv.detach().numpy(),
            [np.asarray(rg[t].data) if t in rg else None for t in rx],
            [pg[id(t)].numpy() if id(t) in pg else None for t in px])


def test_every_reference_name_is_exported():
    missing = sorted(set(R.__all__) - set(P.__all__))
    assert not missing, f"not exported by the port: {missing}"
    for name in R.__all__:
        assert hasattr(P, name), name


def test_the_cases_cover_the_ported_ops():
    ported = ("sub mul div pow matmul squeeze unsqueeze split gather stack "
              "where clip abs exp log sqrt square maximum minimum max min "
              "prod var std cumsum cumprod norm sort argsort topk one_hot "
              "einsum pad elu erf softplus log_softmax sum mean "
              "mse_loss").split()
    assert len(ported) == 40 and sorted(CASES) == sorted(ported)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_the_reference(name):
    fn, specs = CASES[name]
    arrays = [rand(shape, 10 + i, kind) for i, (shape, kind)
              in enumerate(specs)]
    rv, pv, rg, pg = run_both(fn, arrays)
    assert rv.shape == pv.shape, (rv.shape, pv.shape)
    if name in NO_GRAD:
        np.testing.assert_array_equal(pv, rv)
        assert rg is None
        return
    close(pv, rv, f"{name} value")
    for i, (g, w) in enumerate(zip(pg, rg)):
        assert (g is None) == (w is None), (name, i)
        if w is not None:
            close(g, w, f"{name} grad {i}")


# -- the tie rules ---------------------------------------------------------------


@pytest.mark.parametrize("name,fn,arrays", [
    ("reduction max", lambda A, a: A.max(a),
     [np.array([1.0, 3.0, 3.0, 0.0], np.float32)]),
    ("reduction min over an axis", lambda A, a: A.min(a, axis=1),
     [np.array([[2.0, -1.0, -1.0], [0.0, 0.0, 0.0]], np.float32)]),
    ("maximum", lambda A, a, b: A.maximum(a, b),
     [np.array([1.0, 2.0, 3.0], np.float32),
      np.array([1.0, 5.0, 0.0], np.float32)]),
    ("minimum", lambda A, a, b: A.minimum(a, b),
     [np.array([1.0, 2.0], np.float32), np.array([1.0, 0.0], np.float32)]),
    ("clip at its bounds", lambda A, a: A.clip(a, -0.5, 0.5),
     [np.array([-0.5, 0.5, 0.2, 2.0], np.float32)]),
    ("sort with ties", lambda A, a: A.sort(a, descending=True),
     [np.array([[2.0, 1.0, 2.0, 0.0, 1.0]], np.float32)]),
    ("norm inf with ties", lambda A, a: A.norm(a, ord=math.inf),
     [np.array([-2.0, 1.0, 2.0], np.float32)]),
])
def test_tie_rules_are_the_reference_rules(name, fn, arrays):
    rv, pv, rg, pg = run_both(fn, arrays)
    close(pv, rv, name)
    for g, w in zip(pg, rg):
        close(g, w, f"{name} grad")


@pytest.mark.parametrize("ord_", [1, 2, math.inf, 3.0])
def test_norm_ord_axis_keepdims(ord_):
    x = rand((3, 5), 33)
    for axis in (None, 0, 1, (0, 1)):
        for kd in (False, True):
            rv, pv, rg, pg = run_both(
                lambda A, a: A.norm(a, ord=ord_, axis=axis, keepdims=kd), [x])
            assert rv.shape == pv.shape, (axis, kd)
            close(pv, rv, f"norm {ord_} {axis} {kd}")
            close(pg[0], rg[0], f"norm grad {ord_} {axis} {kd}")


def test_one_hot_and_mse_loss_match_numpy():
    got = P.one_hot(torch.from_numpy(LABELS), 4).numpy()
    want = np.zeros((5, 4), np.float32)
    for i, c in enumerate(LABELS):
        if 0 <= c < 4:
            want[i, c] = 1.0
    np.testing.assert_array_equal(got, want)
    x, t = rand((3, 4), 1), rand((3, 4), 2)
    close(P.mse_loss(torch.from_numpy(x), t).item(),
          np.mean(np.square(x - t)), "mse_loss")


# -- tests/test_autograd.py and tests/test_ops_extended.py ------------------------


def _grad_of(fn, x):
    t = port_param(x)
    return dict((id(p), g) for p, g in P.backward(P.sum(fn(t))))[id(t)]


def test_tape_chain_fanout_and_getitem():
    w, x = port_param(np.array([2.0, 3.0], np.float32)), torch.tensor(
        [1.0, 4.0])
    y = P.mul(x, w)
    (_, g), = P.backward(P.sum(P.mul(y, y)))
    close(g, 2 * np.array([1.0, 16.0]) * [2, 3], "chain")
    w = port_param(np.ones(2, np.float32))
    (_, g), = P.backward(P.sum(P.add(w, w)))
    close(g, [2.0, 2.0], "fanout")
    w = port_param(np.array([1.0, 2.0, 3.0], np.float32))
    (_, g), = P.backward(P.sum(P.mul(w[1:], w[1:])))
    close(g, [0.0, 4.0, 6.0], "getitem")


def test_grad_pairs_yields_the_layer_nearest_the_loss_first():
    w1, w2 = port_param(np.ones(1, np.float32)), port_param(
        np.full(1, 2.0, np.float32))
    h = P.mul(w1, torch.tensor([5.0]))
    order = [p for p, _ in P.grad_pairs(P.sum(P.mul(h, w2)))]
    assert order[0] is w2 and order[1] is w1


def test_op_values_against_numpy():
    x = rand((3, 5), 0)
    t = torch.from_numpy(x)
    close(P.cumsum(t, axis=1), np.cumsum(x, 1), "cumsum")
    close(P.cumprod(t, axis=0), np.cumprod(x, 0), "cumprod")
    for o in (1, 2, np.inf, 3.0):
        close(P.norm(t, ord=o).item(), np.linalg.norm(x.ravel(), ord=o),
              f"norm {o}")
    close(P.norm(t, axis=1), np.linalg.norm(x, axis=1), "norm axis")
    close(P.sort(t, descending=True), -np.sort(-x, axis=-1), "sort")
    np.testing.assert_array_equal(P.argsort(t[0]).numpy(), np.argsort(x[0]))
    v, i = P.topk(t, k=3)
    want_i = np.argsort(-x, axis=-1)[:, :3]
    np.testing.assert_array_equal(i.numpy(), want_i)
    close(v, np.take_along_axis(x, want_i, -1), "topk")
    close(P.topk(t, k=2, axis=0)[0], -np.sort(-x, axis=0)[:2], "topk axis 0")
    assert np.isclose(P.max(t).item(), x.max())
    assert np.isclose(P.min(t).item(), x.min())
    close(P.prod(t, axis=1), x.prod(1), "prod")
    close(P.var(t, axis=0), x.var(0), "var")
    close(P.std(t, axis=0), x.std(0), "std")
    close(P.clip(t, -0.5, 0.5), np.clip(x, -0.5, 0.5), "clip")
    close(P.sqrt(torch.from_numpy(np.abs(x))), np.sqrt(np.abs(x)), "sqrt")
    a, b = rand((3, 3), 10), rand((3, 3), 11)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    close(P.where(a > 0, ta, tb), np.where(a > 0, a, b), "where")
    close(P.stack([ta, tb], axis=1), np.stack([a, b], axis=1), "stack")
    close(P.maximum(ta, tb), np.maximum(a, b), "maximum")
    close(P.einsum("ij,jk->ik", ta, tb), a @ b, "einsum")
    assert [s.shape[1] for s in P.split(t, 5, axis=1)] == [1] * 5
    with pytest.raises(ValueError, match="divide"):
        P.split(t, 2, axis=1)


def test_op_grads_against_numpy():
    x = rand((3, 4), 20)
    close(_grad_of(lambda t: P.cumsum(t, axis=1), x),
          np.tile(np.arange(4, 0, -1, dtype=np.float32), (3, 1)), "cumsum")
    x = rand((5,), 21)
    close(_grad_of(lambda t: P.mul(P.sort(t), P.sort(t)), x), 2 * x, "sort")
    x = rand((6,), 22)
    want = np.zeros(6, np.float32)
    want[np.argsort(-x)[:2]] = 1.0
    close(_grad_of(lambda t: P.topk(t, 2)[0], x), want, "topk")
    x = rand((4,), 23)
    close(_grad_of(P.norm, x), x / np.linalg.norm(x), "norm")
    x = rand((5,), 26)
    want = np.zeros(5, np.float32)
    want[np.argmax(x)] = 1.0
    close(_grad_of(P.max, x), want, "max")


# -- Operator and Function --------------------------------------------------------


def test_function_default_vjp_matches_the_reference():
    a, b = rand((3, 4), 1), rand((3, 4), 2)
    rv, pv, rg, pg = run_both(lambda A, x, y: A.Function(
        (lambda u, v: u * v + jnp.exp(u)) if A is R else
        (lambda u, v: u * v + torch.exp(u)), name="MulExp")(x, y), [a, b])
    close(pv, rv, "value")
    for g, w in zip(pg, rg):
        close(g, w, "grad")


class _TripleGrad:
    """An op whose custom backward is deliberately not its VJP: x * 2
    forward, 3 * dy backward."""

    def backward(self, *dys):
        return (dys[0] * 3.0,)


class RefTriple(_TripleGrad, R.Operator):
    def forward(self, x):
        return x * 2.0


class PortTriple(_TripleGrad, P.Operator):
    def forward(self, x):
        return x * 2.0


def test_custom_backward_is_used_as_written():
    a = rand((2, 3), 3)
    rv, pv, rg, pg = run_both(
        lambda A, x: (RefTriple if A is R else PortTriple)()(x), [a])
    close(pv, 2 * a, "value")
    close(pv, rv, "value vs reference")
    w = rand((2, 3), 1)
    close(pg[0], 3 * w, "custom grad")
    close(pg[0], rg[0], "custom grad vs reference")


def test_multi_output_function():
    a = rand((3, 4), 4)

    def fn(A, x):
        mod = jnp if A is R else torch
        lo, hi = A.Function(lambda u: (mod.sin(u), u * u), name="Two")(x)
        return A.add(A.mul(lo, lo), hi)

    rv, pv, rg, pg = run_both(fn, [a])
    close(pv, rv, "value")
    close(pg[0], rg[0], "grad")
    op_ = P.Function(lambda u: (torch.sin(u), u * u), name="Two")
    x = port_param(a)
    outs = op_(x)
    assert op_.name == "Two" and op_.inputs == (x,)
    assert len(op_.outputs) == 2 and op_.outputs[0] is outs[0]
    # an integer output (indices) takes no gradient
    v, i = P.Function(lambda u: torch.topk(u, 2))(x)
    assert not i.dtype.is_floating_point and v.requires_grad


def test_none_grad_consumer_still_finalizes():
    w = port_param(np.array([3.0], np.float32))

    class NoGrad(P.Function):
        def backward(self, *dys):
            return (None,)

    a = NoGrad(lambda v: v * 2.0)(w)
    loss = P.sum(P.add(a, P.mul(w, w)))
    (_, g), = P.backward(loss)
    close(g, [6.0], "grad")


def test_no_record_outside_training():
    P.training = False
    w = port_param(np.ones(2, np.float32))
    f = P.Function(lambda v: v * v)
    y = f(w)
    assert not y.requires_grad and f.inputs == ()
    P.training = True
    with torch.no_grad():
        assert not P.Function(lambda v: v * v)(w).requires_grad
    assert P.Function(lambda v: v * v)(torch.ones(2)).grad_fn is None


class _SquashMLP(MLP):
    """An MLP whose hidden activation is a user Function with its own
    backward (softsign: x / (1 + |x|))."""

    class Softsign(P.Function):
        def __init__(self):
            super().__init__(lambda x: x / (1.0 + x.abs()), name="Softsign")

        def backward(self, dy):
            (x,) = self.inputs
            return (dy / (1.0 + x.abs()).square(),)

    def forward(self, x):
        h = self.Softsign()(self.fc1(x))
        return self.fc2(P.Function(lambda v: v * 0.5 + v.sin())(h))


def test_functions_inside_a_graph_mode_step():
    """Two user Functions in an MLP: the graph-mode step (plain on the
    CPU) equals the eager one, and the custom backward is the softsign's
    derivative (held by the default VJP of the same forward)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, 8))

    def train(use_graph):
        torch.manual_seed(0)
        m = _SquashMLP(16, 3, in_features=6, device="cpu")
        m.dropout.p = 0.0
        m.set_optimizer(opt.SGD(lr=0.1))
        m.compile([x], is_train=True, use_graph=use_graph)
        losses = [m(x, y)[1].item() for _ in range(3)]
        return losses, {k: v.detach().clone() for k, v in
                        m.get_params().items()}

    (lg, pg), (le, pe) = train(True), train(False)
    assert lg == le and lg[-1] < lg[0]
    for k in pg:
        assert torch.equal(pg[k], pe[k]), k
    xs = port_param(rand((4,), 5))
    (_, g1), = P.backward(P.sum(_SquashMLP.Softsign()(xs)))
    (_, g2), = P.backward(P.sum(P.Function(
        lambda v: v / (1.0 + v.abs()))(xs)))
    close(g1, g2, "softsign backward")


# -- the op cache ---------------------------------------------------------------


def test_eager_training_matches_with_the_op_cache_off():
    """tests/test_op_cache.py:95's counterpart: the numbers are the same
    with the cache off and on."""
    x = torch.from_numpy(rand((8, 12), 0))
    y = torch.arange(8) % 4

    def run():
        torch.manual_seed(0)
        m = MLP(16, 4, in_features=12, device="cpu")
        m.set_optimizer(opt.SGD(lr=0.1))
        m.compile([x], is_train=True, use_graph=False)
        return [m.train_one_batch(x, y)[1].item() for _ in range(5)]

    on = run()
    try:
        P.set_op_cache_enabled(False)
        off = run()
    finally:
        P.set_op_cache_enabled(True)
    assert on == off


def test_disabling_and_set_flash_enabled_flush_the_cache(monkeypatch):
    flushes = []
    monkeypatch.setattr(P, "clear_op_cache", lambda: flushes.append(1))
    P.set_op_cache_enabled(True)
    assert not flushes
    P.set_op_cache_enabled(False)
    assert len(flushes) == 1
    P.set_op_cache_enabled(True)
    fa = importlib.import_module("singa_tpu_torch.ops.flash_attention")
    prev = fa.flash_enabled()
    try:
        fa.set_flash_enabled(not prev)
        assert len(flushes) == 2
    finally:
        fa.set_flash_enabled(prev)


def test_an_operators_output_is_freed_when_dropped():
    """The op keeps its outputs by weak reference and the default VJP
    returns fresh tensor objects, so an output does not hold itself
    alive through its node (freed without the garbage collector)."""
    import gc
    import weakref

    x = port_param(rand((64, 64), 0))
    gc.disable()
    try:
        for op_ in (P.Function(lambda v: v.sin() * 2.0), PortTriple()):
            y = op_(x)
            assert op_.outputs[0] is y
            ref = weakref.ref(y)
            del y
            assert ref() is None and op_.outputs == (None,)
    finally:
        gc.enable()
