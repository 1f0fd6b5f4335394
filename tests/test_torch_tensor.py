"""The port's tensor module (singa_tpu_torch.tensor) against the
reference's (singa_tpu.tensor) on the same numpy inputs, one case per
function and form (the oracles of tests/test_tensor.py and
tests/test_ops_extended.py, held across the packages):

- integer, index, comparison and shape results exactly (`gather`'s
  out-of-range index fills NaN, as `jnp.take` does); fp32 elementwise
  results within 1e-6 relative; reductions, scans, norms, products,
  `einsum` and `tensordot` within 1e-5;
- the in-place forms (`axpy`, the `_colrow` family) write their operand
  and return it, and both packages refuse a vector of the wrong length;
- the RNG by its laws (the draws are PyTorch's, not JAX's threefry):
  shape, dtype, range, moments within 5 standard errors, the same draws
  after `set_seed` (dropout's too), after `set_rng_state(get_rng_state())`,
  and `rng_scope` leaving the default stream untouched;
- every math result carries no autograd history;
- `Tensor(...)` builds the reference's shapes and dtypes, and
  `isinstance(t, tensor.Tensor)` holds for every torch tensor;
- the names: every one of the reference's `__all__`, and `rng_scope`.
"""

import numpy as np
import pytest
import torch

from singa_tpu import tensor as ref
from singa_tpu_torch import autograd
from singa_tpu_torch import tensor

A = np.random.default_rng(0).standard_normal((3, 4, 5)).astype(np.float32)
B = np.random.default_rng(1).standard_normal((3, 4, 5)).astype(np.float32)
POS = np.abs(A) + 0.5
NEAR1 = (1.0 + 0.1 * A).astype(np.float32)
M = np.random.default_rng(2).standard_normal((4, 6)).astype(np.float32)
N = np.random.default_rng(3).standard_normal((6, 3)).astype(np.float32)
V = np.random.default_rng(4).standard_normal(6).astype(np.float32)
W = np.random.default_rng(5).standard_normal(6).astype(np.float32)
IDX = np.array([[0, 2, 1], [3, 1, 0]], np.int64)
LABELS = np.array([0, 3, 1, 9, -1, 2], np.int64)
EXACT, ELEM, RED = 0.0, 1e-6, 1e-5


class Arr:
    """A numpy operand: a reference Tensor on that side, a torch tensor
    on the port's."""

    def __init__(self, a):
        self.a = a


def _side(obj, port):
    if isinstance(obj, Arr):
        return (torch.from_numpy(obj.a.copy()) if port
                else ref.from_numpy(obj.a))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_side(o, port) for o in obj)
    return obj


def _np(out):
    if isinstance(out, torch.Tensor):
        return out.numpy()
    if isinstance(out, ref.Tensor):
        return np.asarray(out.data)
    return np.asarray(out)


def _flat(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


a, b, m, n, v, w = (Arr(x) for x in (A, B, M, N, V, W))
CASES = [
    # elementwise binary
    ("add", (a, b), {}, ELEM), ("add_scalar", (a, 2.5), {}, ELEM),
    ("sub", (a, b), {}, ELEM), ("eltwise_mult", (a, b), {}, ELEM),
    ("div", (a, Arr(POS)), {}, ELEM), ("pow", (Arr(POS), 1.7), {}, ELEM),
    ("pow_tensor", (Arr(POS), b), {}, ELEM),
    ("maximum", (a, b), {}, EXACT), ("minimum", (a, 0.1), {}, EXACT),
    # elementwise unary
    ("abs", (a,), {}, EXACT), ("exp", (a,), {}, ELEM),
    ("log", (Arr(POS),), {}, ELEM), ("sign", (a,), {}, EXACT),
    ("sqrt", (Arr(POS),), {}, ELEM), ("square", (a,), {}, ELEM),
    ("tanh", (a,), {}, ELEM), ("floor", (Arr(3 * A),), {}, EXACT),
    ("ceil", (Arr(3 * A),), {}, EXACT),
    ("round", (Arr(np.array([0.5, 1.5, 2.5, -0.5, 1.2], np.float32)),), {},
     EXACT),
    ("relu", (a,), {}, EXACT), ("sigmoid", (a,), {}, ELEM),
    ("softmax", (a,), {}, ELEM), ("softmax_axis1", (a, 1), {}, ELEM),
    ("clip", (a, -0.5, 0.7), {}, EXACT),
    # reductions
    ("sum", (a,), {}, RED), ("sum_axis", (a, 1), {}, RED),
    ("sum_axes_keep", (a, (0, 2)), {"keepdims": True}, RED),
    ("mean", (a,), {}, RED), ("mean_axis_keep", (a, -1), {"keepdims": True},
                              RED),
    ("max", (a,), {}, EXACT), ("max_axis", (a, 2), {}, EXACT),
    ("min_axes", (a, (1, 2)), {}, EXACT),
    ("prod", (Arr(NEAR1),), {}, RED), ("prod_axis", (Arr(NEAR1), 1), {},
                                       RED),
    ("prod_axes_keep", (Arr(NEAR1), (0, 2)), {"keepdims": True}, RED),
    ("argmax", (a,), {}, EXACT), ("argmax_axis", (a, 1), {}, EXACT),
    ("argmin_axis", (a, 2), {}, EXACT),
    ("var", (a,), {}, RED), ("var_axis_ddof", (a, 1), {"ddof": 1}, RED),
    ("std_keep", (a, 2), {"keepdims": True}, RED),
    # linear algebra and scans
    ("mult", (m, n), {}, RED), ("dot", (m, n), {}, RED),
    ("einsum", ("ij,jk->ik", m, n), {}, RED),
    ("einsum_batch", ("bij,bkj->bik", a, b), {}, RED),
    ("tensordot", (a, Arr(B.transpose(1, 2, 0).copy())), {"axes": 2}, RED),
    ("tensordot_pairs", (m, n), {"axes": ([1], [0])}, RED),
    ("cossim", (v, w), {}, RED), ("cumsum", (a,), {}, RED),
    ("cumsum_axis", (a, 2), {}, RED), ("cumprod", (Arr(NEAR1), 1), {}, RED),
    ("sort", (a,), {}, EXACT), ("sort_desc_axis0", (a, 0, True), {}, EXACT),
    ("argsort", (a,), {}, EXACT),
    ("argsort_desc", (a, 1), {"descending": True}, EXACT),
    ("topk", (a, 3), {}, EXACT), ("topk_axis1", (a, 2, 1), {}, EXACT),
    ("norm", (a,), {}, RED), ("norm_1", (a, 1), {}, RED),
    ("norm_inf_axis", (a, np.inf, 1), {}, RED),
    ("norm_3_keep", (a, 3, 2), {"keepdims": True}, RED),
    ("norm_flat_keep", (a,), {"keepdims": True}, RED),
    ("one_hot", (Arr(LABELS), 10), {}, EXACT),
    # shapes
    ("transpose", (a,), {}, EXACT), ("transpose_axes", (a, (1, 0, 2)), {},
                                     EXACT),
    ("reshape", (a, (5, -1)), {}, EXACT), ("flatten", (a,), {}, EXACT),
    ("squeeze", (Arr(A[:, :1, :1]),), {}, EXACT),
    ("squeeze_axis", (Arr(A[:, :1]), 1), {}, EXACT),
    ("expand_dims", (a, 1), {}, EXACT),
    ("expand_dims_axes", (a, (0, -1)), {}, EXACT),
    ("concatenate", ([a, b], 1), {}, EXACT), ("stack", ([a, b], -1), {},
                                              EXACT),
    ("split", (a, 2, 1), {}, EXACT), ("split_points", (a, [1, 3], 2), {},
                                      EXACT),
    ("tile", (m, (2, 1)), {}, EXACT), ("repeat", (m, 2), {}, EXACT),
    ("repeat_axis", (m, 3, 1), {}, EXACT),
    ("gather", (a, Arr(IDX)), {}, EXACT),
    ("gather_axis", (a, Arr(IDX), 2), {}, EXACT),
    ("gather_negative", (a, [-1, 0], 1), {}, EXACT),
    # comparisons
    ("lt", (a, b), {}, EXACT), ("le", (a, 0.0), {}, EXACT),
    ("gt", (a, b), {}, EXACT), ("ge", (a, b), {}, EXACT),
    ("eq", (a, a), {}, EXACT), ("ne", (a, b), {}, EXACT),
    ("where", (Arr((A > 0).astype(np.float32)), a, b), {}, EXACT),
]


def _fn(case):
    """The function a case "name_form" calls: its longest prefix that is
    a reference name."""
    parts = case.split("_")
    return next("_".join(parts[:i]) for i in range(len(parts), 0, -1)
                if "_".join(parts[:i]) in ref.__all__)


@pytest.mark.parametrize("name,args,kwargs,tol", CASES,
                         ids=[c[0] for c in CASES])
def test_math_matches_the_reference(name, args, kwargs, tol):
    fn = _fn(name)
    want = _flat(getattr(ref, fn)(*_side(args, False), **kwargs))
    x = _side(args, True)
    for t in (x if isinstance(x, (list, tuple)) else [x]):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            t.requires_grad_(True)  # results still carry no history
    got = _flat(getattr(tensor, fn)(*x, **kwargs))
    assert len(got) == len(want)
    for g, wv in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.grad_fn is None
        gv, wv = _np(g), _np(wv)
        assert gv.shape == wv.shape, (gv.shape, wv.shape)
        if tol == EXACT:
            np.testing.assert_array_equal(gv, wv)
        else:
            np.testing.assert_allclose(gv, wv, rtol=tol, atol=tol)


def test_split_refuses_unequal_sections_in_both():
    with pytest.raises(ValueError):
        ref.split(ref.from_numpy(A), 2, 2)
    with pytest.raises(ValueError):
        tensor.split(torch.from_numpy(A), 2, 2)


@pytest.mark.parametrize("name", ["add_column", "add_row", "mult_column",
                                  "mult_row", "div_column", "div_row"])
def test_colrow_writes_the_matrix_in_place(name):
    col = name.endswith("column")
    vec = (np.abs(V[:4]) + 0.5 if col else np.abs(V) + 0.5).astype(
        np.float32)
    rm = ref.from_numpy(M)
    want = _np(getattr(ref, name)(ref.from_numpy(vec), rm))
    pm = torch.from_numpy(M.copy())
    got = getattr(tensor, name)(torch.from_numpy(vec), pm)
    assert got is pm
    np.testing.assert_allclose(pm.numpy(), want, rtol=ELEM, atol=ELEM)
    np.testing.assert_allclose(_np(rm), want, rtol=0, atol=0)
    bad = np.ones(5, np.float32)
    with pytest.raises(ValueError, match="1-D vector of length"):
        getattr(ref, name)(ref.from_numpy(bad), ref.from_numpy(M))
    with pytest.raises(ValueError, match="1-D vector of length"):
        getattr(tensor, name)(torch.from_numpy(bad), torch.from_numpy(M))


def test_axpy_writes_y_in_place():
    want = _np(ref.axpy(0.3, ref.from_numpy(A), ref.from_numpy(B)))
    y = torch.from_numpy(B.copy())
    assert tensor.axpy(0.3, torch.from_numpy(A), y) is y
    np.testing.assert_allclose(y.numpy(), want, rtol=ELEM, atol=ELEM)


def test_conversions_match_the_reference():
    f64 = np.linspace(-1, 1, 6)
    t = tensor.from_numpy(f64, "cpu")
    assert t.dtype == torch.float32 and ref.from_numpy(f64).dtype == \
        np.float32
    np.testing.assert_array_equal(tensor.to_numpy(t),
                                  ref.to_numpy(ref.from_numpy(f64)))
    # integers keep their width in the port (int64 stays int64)
    assert tensor.from_numpy(np.arange(3), "cpu").dtype == torch.int64
    x = torch.from_numpy(A.copy())
    assert tensor.from_raw(x) is x
    h = tensor.as_type(x, tensor.float16)
    assert h.dtype == torch.float16
    np.testing.assert_array_equal(
        h.numpy(), np.asarray(ref.as_type(ref.from_numpy(A),
                                          ref.float16).data))
    dst = torch.zeros(3, 4, 5)
    tensor.copy_data_to_from(dst, x)
    assert torch.equal(dst, x)
    p = x.clone().requires_grad_(True)
    moved = tensor.to_device(p, "cpu")
    assert moved is not p and moved.requires_grad and moved.grad_fn is None


@pytest.mark.parametrize("name,args,kwargs", [
    ("zeros", ((2, 3),), {}), ("ones", ((4,),), {}),
    ("full", ((2, 2), 7.0), {}), ("eye", (3,), {}), ("arange", (5,), {}),
    ("arange", (1, 7, 2), {}),
    ("zeros", ((2, 3),), {"dtype": "int32"}),
    ("full", ((3,), 2), {"dtype": "int8"})])
def test_creation_matches_the_reference(name, args, kwargs):
    kw = {k: getattr(ref, v) for k, v in kwargs.items()}
    want = _np(getattr(ref, name)(*args, **kw))
    kw = {k: getattr(tensor, v) for k, v in kwargs.items()}
    got = getattr(tensor, name)(*args, dev="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy().dtype == want.dtype
    like = torch.from_numpy(A)
    assert torch.equal(tensor.zeros_like(like), torch.zeros(3, 4, 5))
    assert torch.equal(tensor.ones_like(like), torch.ones(3, 4, 5))


def test_creation_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tensor.zeros((2,)), lambda: tensor.random((2,)),
                 lambda: tensor.Tensor((2,))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def _moments_ok(x, mean, var):
    n = x.numel()
    se = (var / n) ** 0.5
    assert abs(x.double().mean().item() - mean) < 5 * se
    assert abs(x.double().var().item() - var) < 5 * var * (2 / n) ** 0.5


def test_draws_follow_their_laws():
    tensor.set_seed(0)
    g = tensor.gaussian((20000,), 1.0, 2.0, dev="cpu")
    assert g.shape == (20000,) and g.dtype == torch.float32
    _moments_ok(g, 1.0, 4.0)
    u = tensor.uniform((20000,), -1.0, 3.0, dev="cpu")
    assert float(u.min()) >= -1.0 and float(u.max()) < 3.0
    _moments_ok(u, 1.0, 16.0 / 12)
    r = tensor.random((20000,), dev="cpu")
    assert float(r.min()) >= 0.0 and float(r.max()) < 1.0
    bern = tensor.bernoulli(0.3, torch.empty(20000))
    assert set(bern.unique().tolist()) <= {0.0, 1.0}
    _moments_ok(bern, 0.3, 0.21)
    # on a tensor given: filled in place
    t = torch.zeros(1000, dtype=torch.float64)
    assert tensor.gaussian(t) is t and t.std() > 0.5 and t.dtype == \
        torch.float64
    assert tensor.uniform(t, 2.0, 3.0) is t and float(t.min()) >= 2.0


def test_set_seed_repeats_the_draws_and_dropout():
    def draws():
        x = torch.ones(64, 64)
        return (tensor.gaussian((8,), dev="cpu"),
                autograd.dropout(x, 0.5, train=True))

    tensor.set_seed(7)
    g1, d1 = draws()
    tensor.set_seed(7)
    g2, d2 = draws()
    assert torch.equal(g1, g2) and torch.equal(d1, d2)
    tensor.set_seed(8)
    assert not torch.equal(draws()[0], g1)


def test_rng_state_snapshot_repeats_the_draws():
    tensor.set_seed(3)
    tensor.random((5,), dev="cpu")
    state = tensor.get_rng_state()
    a1 = tensor.random((5,), dev="cpu")
    tensor.random((5,), dev="cpu")
    tensor.set_rng_state(state)
    assert torch.equal(tensor.random((5,), dev="cpu"), a1)


def test_rng_scope_leaves_the_default_stream_untouched():
    tensor.set_seed(11)
    plain = [tensor.random((4,), dev="cpu") for _ in range(2)]
    tensor.set_seed(11)
    first = tensor.random((4,), dev="cpu")
    gen = torch.Generator().manual_seed(5)
    with tensor.rng_scope(gen):
        scoped = tensor.gaussian((4,), dev="cpu")
    second = tensor.random((4,), dev="cpu")
    assert torch.equal(first, plain[0]) and torch.equal(second, plain[1])
    assert torch.equal(scoped, torch.randn(
        4, generator=torch.Generator().manual_seed(5)))


@pytest.mark.parametrize("kw", [
    {"shape": (2, 3)}, {"shape": ()}, {"shape": (4,), "dtype": "int32"},
    {"data": np.arange(6, dtype=np.float64).reshape(2, 3)},
    {"data": [[1, 2], [3, 4]], "dtype": "int8"}])
def test_tensor_builds_the_references_shapes_and_dtypes(kw):
    rk = {k: getattr(ref, v) if k == "dtype" else v for k, v in kw.items()}
    pk = {k: getattr(tensor, v) if k == "dtype" else v
          for k, v in kw.items()}
    want = ref.Tensor(**rk)
    got = tensor.Tensor(device="cpu", **pk)
    assert isinstance(got, tensor.Tensor) and isinstance(got, torch.Tensor)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.data))
    assert got.numpy().dtype == np.asarray(want.data).dtype


def test_tensor_isinstance_and_its_copy():
    assert isinstance(torch.zeros(1), tensor.Tensor)
    assert issubclass(torch.nn.Parameter, tensor.Tensor)
    assert not isinstance(np.zeros(1), tensor.Tensor)
    src = torch.ones(3)
    t = tensor.Tensor(data=src, device="cpu")
    assert torch.equal(t, src) and t.data_ptr() != src.data_ptr()
    p = tensor.Tensor((2,), device="cpu", stores_grad=True)
    assert p.requires_grad and p.is_leaf
    assert not tensor.Tensor((2,), device="cpu").requires_grad


def test_dtypes_are_the_torch_ones():
    for name in ("float32", "float16", "bfloat16", "int32", "int64", "int8",
                 "uint8"):
        assert getattr(tensor, name) == getattr(torch, name)
    assert tensor.bool_ is torch.bool


def test_every_reference_name_is_ported():
    assert set(ref.__all__) <= set(tensor.__all__)
    assert len(tensor.__all__) == len(ref.__all__) == 99
    assert all(hasattr(tensor, n) for n in tensor.__all__)
    assert callable(tensor.rng_scope)
