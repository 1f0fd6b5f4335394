"""The tensor module (counterpart of singa_tpu/tensor.py): the
reference's 99 public names and `rng_scope`, as plain functions on
`torch.Tensor`.

The reference wraps a `jax.Array` in a SINGA `Tensor` and routes ~150
math functions through its `Device`. Here a tensor is a `torch.Tensor`,
and the module's functions take and return them:

- dtypes: `float32` ... `bool_` are the torch dtypes. Integers keep
  their width: int64 stays int64 where the reference, JAX without x64,
  narrows it to int32 (`from_numpy`, `argmax`, `sum` of integers);
- RNG: `set_seed`, `get_rng_state` and `set_rng_state` act on the
  generators the port draws from, PyTorch's default ones (the host's
  and every card's), which dropout and this module's draws use, so
  `set_seed(s)` makes both repeatable and a `get_rng_state` snapshot
  restored by `set_rng_state` repeats the same draws. `rng_scope(gen)`
  routes this module's draws to an explicit `torch.Generator` while it
  is entered. The values are PyTorch's, not JAX's threefry draws;
- `Tensor(shape, device, dtype, data, requires_grad, stores_grad, ...)`
  has the reference's signature and returns a `torch.Tensor`: zeros of
  `shape`, or a copy of `data` (as `dtype` unless it is a tensor), on
  the card unless a CPU device is given. `stores_grad=True` (a leaf
  whose gradient backward yields, the reference's parameter) makes it
  `requires_grad`; the reference's `requires_grad` (take part in a
  backward) is what every torch tensor does, so it is accepted and
  ignored, as are `creator` and `name`. `isinstance(t, Tensor)` holds
  for every `torch.Tensor`;
- creation (`zeros` ... `bernoulli`) defaults to the card, with no
  CPU fallback (`device.resolve`);
- the math (`add` ... `where`) is raw: each function computes under
  `torch.no_grad()`, so its result carries no autograd history, as the
  reference's module functions record no tape. `sort`, `argsort`,
  `topk`, `norm` and `one_hot` share one formulation with the autograd
  ops through `_kernels.py`. `axpy`, the `_colrow` family
  (`add_column` ...) and `gaussian`/`uniform`/`bernoulli` on a tensor
  write their tensor in place, where the reference rebinds its storage.

The reference `Tensor`'s methods are not patched onto `torch.Tensor`;
their counterparts: `gaussian`/`uniform`/`bernoulli` -> this module's
functions on the tensor (or `normal_`, `uniform_`, `bernoulli_`);
`set_value(v)` -> `fill_(v)`; `copy_from`/`copy_data` -> `copy_`;
`to_device(dev)` -> `to(dev)`; `nDim()`/`ndim` -> `dim()`; `size` ->
`numel()`; `as_type`/`astype` -> `to(dtype)`; `numpy()` -> `to_numpy`;
`item`, `tolist`, `clone`, `detach`, `T`, `shape` and `dtype` -> the
torch ones; `sync()` -> `torch.cuda.synchronize()`; `is_transpose()` ->
`not is_contiguous()`; the taped `reshape`/`transpose`/`flatten` ->
`autograd.reshape`/`transpose`/`flatten`; the arithmetic dunders and
indexing -> torch's own, which record on PyTorch's tape.

The serving engine's KV pools use `quantize_int8_rows`,
`dequantize_int8_rows` and `paged_gather` (`singa_tpu/tensor.py:
882-931`).
"""

from __future__ import annotations

import functools
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from singa_tpu_torch import _kernels
from singa_tpu_torch import device as device_module

__all__ = [
    "Tensor", "float32", "float16", "bfloat16", "int32", "int64", "int8",
    "uint8", "bool_", "set_seed", "get_rng_state", "set_rng_state",
    "from_numpy", "from_raw", "to_numpy", "to_device", "as_type",
    "copy_data_to_from", "zeros", "ones", "zeros_like", "ones_like", "full",
    "eye", "arange", "random", "gaussian", "uniform", "bernoulli",
    "paged_gather", "quantize_int8_rows", "dequantize_int8_rows", "add",
    "sub", "eltwise_mult", "div", "pow", "axpy", "cossim", "cumsum",
    "cumprod", "sort", "argsort", "topk", "norm", "one_hot", "var", "std",
    "add_column", "add_row", "mult_column", "mult_row", "div_column",
    "div_row", "abs", "exp", "log", "sign", "sqrt", "square", "relu",
    "sigmoid", "tanh", "softmax", "clip", "floor", "ceil", "round", "sum",
    "mean", "max", "min", "prod", "argmax", "argmin", "mult", "einsum",
    "tensordot", "dot", "transpose", "reshape", "flatten", "squeeze",
    "expand_dims", "concatenate", "stack", "split", "tile", "repeat",
    "gather", "lt", "le", "gt", "ge", "eq", "ne", "where", "maximum",
    "minimum",
]

float32 = torch.float32
float16 = torch.float16
bfloat16 = torch.bfloat16
int32 = torch.int32
int64 = torch.int64
int8 = torch.int8
uint8 = torch.uint8
bool_ = torch.bool

# -- RNG ----------------------------------------------------------------------

#: the generator `rng_scope` routes this module's draws to, or None
_rng_override: Optional[torch.Generator] = None


def set_seed(seed: int) -> None:
    """Seed PyTorch's default generators (the host's and every card's),
    which dropout and this module's draws use."""
    torch.manual_seed(seed)


def get_rng_state() -> dict:
    """A host snapshot of the generators: {"cpu": uint8 array, "cuda":
    [one per card, when CUDA is initialised]}, and "ranks" where a rank
    r > 0 of a distributed step has drawn dropout masks from its own
    generator (`autograd.rank_generator_states`)."""
    from singa_tpu_torch import autograd

    cuda = ([s.numpy() for s in torch.cuda.get_rng_state_all()]
            if torch.cuda.is_initialized() else [])
    out = {"cpu": torch.get_rng_state().numpy(), "cuda": cuda}
    ranks = autograd.rank_generator_states()
    if ranks:
        out["ranks"] = ranks
    return out


def set_rng_state(state: dict) -> None:
    """Restore the generators from a `get_rng_state` snapshot (the rank
    generators by `autograd.set_rank_generator_states`)."""
    from singa_tpu_torch import autograd

    torch.set_rng_state(torch.from_numpy(np.asarray(state["cpu"])))
    for i, s in enumerate(state["cuda"]):
        torch.cuda.set_rng_state(torch.from_numpy(np.asarray(s)), i)
    autograd.set_rank_generator_states(state.get("ranks", ()))


class rng_scope:
    """Route this module's draws to the generator `gen` while entered
    (the reference routes its `next_key()` to an explicit key); the
    default generators are left untouched."""

    def __init__(self, gen: torch.Generator):
        self._gen = gen

    def __enter__(self):
        global _rng_override
        self._saved, _rng_override = _rng_override, self._gen
        return self

    def __exit__(self, *exc):
        global _rng_override
        _rng_override = self._saved
        return False


# -- Tensor -------------------------------------------------------------------


class _TensorMeta(type):
    def __instancecheck__(cls, obj) -> bool:
        return isinstance(obj, torch.Tensor)

    def __subclasscheck__(cls, sub) -> bool:
        return issubclass(sub, torch.Tensor)


class Tensor(metaclass=_TensorMeta):
    """`Tensor(shape=None, device=None, dtype=float32, data=None,
    requires_grad=True, stores_grad=False, creator=None, name=None)`:
    a `torch.Tensor` (see the module docstring)."""

    def __new__(cls, shape: Optional[Sequence[int]] = None, device=None,
                dtype: torch.dtype = float32, data=None,
                requires_grad: bool = True, stores_grad: bool = False,
                creator=None, name: Optional[str] = None) -> torch.Tensor:
        del requires_grad, creator, name
        dev = device_module.resolve(device)
        with torch.no_grad():
            if isinstance(data, torch.Tensor):
                t = data.detach().to(dev, copy=True)
            elif data is not None:
                t = torch.tensor(np.asarray(data), dtype=dtype, device=dev)
            else:
                t = torch.zeros(tuple(shape or ()), dtype=dtype, device=dev)
        if stores_grad and t.is_floating_point():
            t.requires_grad_(True)
        return t


def _raw(fn):
    """Run `fn` under `torch.no_grad()`: raw math, no autograd history.
    A view it returns of an operand that requires grad is detached too;
    an operand it wrote in place comes back as itself."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with torch.no_grad():
            # the Device dispatch seam, as the reference's module math
            out = device_module.dispatch(fn, args, *args, **kwargs)
        given = {id(a) for a in args if isinstance(a, torch.Tensor)}

        def own(t):
            return t if id(t) in given else t.detach()

        if isinstance(out, torch.Tensor):
            return own(out)
        if isinstance(out, (list, tuple)):
            return type(out)(own(t) for t in out)
        return out
    return run


def _as(b, like: torch.Tensor):
    """A numpy operand as a tensor on `like`'s device; tensors and
    Python numbers as they are."""
    if isinstance(b, np.ndarray):
        return torch.as_tensor(b, device=like.device)
    return b


# -- creation / conversion ----------------------------------------------------


def from_numpy(arr: np.ndarray, dev=None) -> torch.Tensor:
    """A copy of `arr` on `dev` (the card unless "cpu" is given); float64
    becomes float32, the reference's default precision. Integers keep
    their width: the reference, JAX without x64, narrows int64 to int32,
    while torch indexes with int64."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(arr.copy()).to(device_module.resolve(dev))


def from_raw(arr: torch.Tensor, dev=None) -> torch.Tensor:
    """The tensor itself (no copy), moved to `dev` when one is given."""
    return arr if dev is None else arr.to(device_module.resolve(dev))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """The tensor's values on the host (a device-to-host read)."""
    return t.detach().cpu().numpy()


def to_device(t: torch.Tensor, dev) -> torch.Tensor:
    """A copy on `dev`, a leaf that requires grad where `t` does."""
    out = t.detach().to(device_module.resolve(dev), copy=True)
    return out.requires_grad_(t.requires_grad)


@_raw
def as_type(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(dtype)


@_raw
def copy_data_to_from(dst: torch.Tensor, src: torch.Tensor) -> None:
    dst.copy_(src)


def _dev(dev) -> torch.device:
    return device_module.resolve(dev)


@_raw
def zeros(shape, dev=None, dtype: torch.dtype = float32) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=_dev(dev))


@_raw
def ones(shape, dev=None, dtype: torch.dtype = float32) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=_dev(dev))


@_raw
def zeros_like(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(t)


@_raw
def ones_like(t: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(t)


@_raw
def full(shape, value, dev=None, dtype: torch.dtype = float32
         ) -> torch.Tensor:
    return torch.full(tuple(shape), value, dtype=dtype, device=_dev(dev))


@_raw
def eye(n: int, dev=None, dtype: torch.dtype = float32) -> torch.Tensor:
    return torch.eye(n, dtype=dtype, device=_dev(dev))


@_raw
def arange(*args, dev=None, dtype: torch.dtype = float32) -> torch.Tensor:
    return torch.arange(*args, dtype=dtype, device=_dev(dev))


@_raw
def gaussian(t_or_shape, mean: float = 0.0, std: float = 1.0, dev=None,
             dtype: torch.dtype = float32) -> torch.Tensor:
    """Normal(mean, std) draws: into the tensor given (in place), or a
    new tensor of the shape given."""
    t = t_or_shape if isinstance(t_or_shape, torch.Tensor) else torch.empty(
        tuple(t_or_shape), dtype=dtype, device=_dev(dev))
    return t.normal_(mean, std, generator=_rng_override)


@_raw
def uniform(t_or_shape, low: float = 0.0, high: float = 1.0, dev=None,
            dtype: torch.dtype = float32) -> torch.Tensor:
    """Uniform [low, high) draws, in place or new as `gaussian`."""
    t = t_or_shape if isinstance(t_or_shape, torch.Tensor) else torch.empty(
        tuple(t_or_shape), dtype=dtype, device=_dev(dev))
    return t.uniform_(low, high, generator=_rng_override)


def random(shape, dev=None, dtype: torch.dtype = float32) -> torch.Tensor:
    """Uniform [0, 1) draws (the reference's `tensor.random`)."""
    return uniform(shape, 0.0, 1.0, dev, dtype)


@_raw
def bernoulli(p: float, t: torch.Tensor) -> torch.Tensor:
    """Fill `t` in place with Bernoulli(p) draws (1 or 0, t's dtype)."""
    return t.bernoulli_(p, generator=_rng_override)


# -- elementwise --------------------------------------------------------------


def _binary(fn):
    @_raw
    def op(a: torch.Tensor, b) -> torch.Tensor:
        return fn(a, _as(b, a))
    return op


add = _binary(torch.add)
sub = _binary(torch.sub)
eltwise_mult = _binary(torch.mul)
div = _binary(torch.true_divide)
pow = _binary(torch.pow)  # noqa: A001 - reference name


def _tensor_like(b, a: torch.Tensor) -> torch.Tensor:
    return b if isinstance(b, torch.Tensor) else torch.as_tensor(
        b, dtype=a.dtype, device=a.device)


maximum = _binary(lambda a, b: torch.maximum(a, _tensor_like(b, a)))
minimum = _binary(lambda a, b: torch.minimum(a, _tensor_like(b, a)))


@_raw
def axpy(alpha: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y += alpha * x, in place; returns y."""
    return y.add_(x, alpha=alpha)


def _unary(fn):
    return _raw(lambda t: fn(t))


abs = _unary(torch.abs)  # noqa: A001 - reference name
exp = _unary(torch.exp)
log = _unary(torch.log)
sign = _unary(torch.sign)
sqrt = _unary(torch.sqrt)
square = _unary(torch.square)
tanh = _unary(torch.tanh)
floor = _unary(torch.floor)
ceil = _unary(torch.ceil)
round = _unary(torch.round)  # noqa: A001 - half to even, as jnp.round
relu = _unary(torch.relu)
sigmoid = _unary(torch.sigmoid)


@_raw
def softmax(t: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.softmax(t, dim=axis)


@_raw
def clip(t: torch.Tensor, low, high) -> torch.Tensor:
    return torch.clamp(t, low, high)


# -- reductions ---------------------------------------------------------------


def _axes(t: torch.Tensor, axis):
    """`axis` (None, an int or a tuple) as a tuple of dims."""
    if axis is None:
        return tuple(range(t.dim()))
    return (axis,) if isinstance(axis, int) else tuple(axis)


def _reduction(fn):
    @_raw
    def op(t: torch.Tensor, axis=None, keepdims: bool = False
           ) -> torch.Tensor:
        dims = _axes(t, axis)
        if not dims:  # a 0-d tensor
            return fn(t.reshape(1), (0,), False).reshape(())
        return fn(t, dims, keepdims)
    return op


def _prod(t, dims, keepdim):
    for d in sorted((d % t.dim() for d in dims), reverse=True):
        t = torch.prod(t, dim=d, keepdim=True)
    return t if keepdim else t.squeeze(dims)


def _mean(t, dims, keepdim):
    t = t if t.is_floating_point() else t.float()
    return torch.mean(t, dim=dims, keepdim=keepdim)


sum = _reduction(lambda t, d, k: torch.sum(t, dim=d, keepdim=k))  # noqa: A001
mean = _reduction(_mean)
max = _reduction(lambda t, d, k: torch.amax(t, dim=d, keepdim=k))  # noqa: A001
min = _reduction(lambda t, d, k: torch.amin(t, dim=d, keepdim=k))  # noqa: A001
prod = _reduction(_prod)


@_raw
def argmax(t: torch.Tensor, axis=None) -> torch.Tensor:
    """Index of the first maximum along `axis` (of the flattened tensor
    when None), int64 where the reference gives int32."""
    return torch.argmax(t, dim=axis)


@_raw
def argmin(t: torch.Tensor, axis=None) -> torch.Tensor:
    return torch.argmin(t, dim=axis)


@_raw
def var(t: torch.Tensor, axis=None, keepdims: bool = False, ddof: int = 0
        ) -> torch.Tensor:
    return torch.var(t, dim=_axes(t, axis), correction=ddof,
                     keepdim=keepdims)


@_raw
def std(t: torch.Tensor, axis=None, keepdims: bool = False, ddof: int = 0
        ) -> torch.Tensor:
    return torch.std(t, dim=_axes(t, axis), correction=ddof,
                     keepdim=keepdims)


# -- linear algebra and scans -------------------------------------------------


@_raw
def mult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matrix product (the reference's `tensor.mult`)."""
    return torch.matmul(a, b)


dot = mult


@_raw
def cossim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of two 1-D tensors."""
    na, nb = a.square().sum().sqrt(), b.square().sum().sqrt()
    return (a * b).sum() / torch.clamp(na * nb, min=1e-30)


@_raw
def cumsum(t: torch.Tensor, axis: int = 0) -> torch.Tensor:
    return torch.cumsum(t, dim=axis)


@_raw
def cumprod(t: torch.Tensor, axis: int = 0) -> torch.Tensor:
    return torch.cumprod(t, dim=axis)


@_raw
def sort(t: torch.Tensor, axis: int = -1, descending: bool = False
         ) -> torch.Tensor:
    return _kernels.sort_(t, axis, descending)


@_raw
def argsort(t: torch.Tensor, axis: int = -1, descending: bool = False
            ) -> torch.Tensor:
    return _kernels.argsort_(t, axis, descending)


@_raw
def topk(t: torch.Tensor, k: int, axis: int = -1):
    """(values, indices) of the k largest along `axis`."""
    return _kernels.topk_(t, k, axis)


@_raw
def norm(t: torch.Tensor, ord: float = 2, axis=None,  # noqa: A002
         keepdims: bool = False) -> torch.Tensor:
    """Vector p-norm; axis=None norms the flattened tensor."""
    return _kernels.norm_(t, ord, axis, keepdims)


@_raw
def one_hot(t, num_classes: int, dtype: torch.dtype = float32
            ) -> torch.Tensor:
    """Rows of `num_classes` with a 1 at each index (zeros for an index
    out of range); a non-tensor goes to the card first."""
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(np.asarray(t), device=_dev(None))
    return _kernels.one_hot_(t, num_classes, dtype)


def _colrow(fn, along_col: bool):
    """The reference's row/column broadcast family: combine vector `v`
    with every column (or row) of matrix `M`, writing M in place, and
    return M."""
    @_raw
    def op(v: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
        want = M.shape[0] if along_col else M.shape[1]
        if v.dim() != 1 or v.shape[0] != want:
            raise ValueError(
                f"expected a 1-D vector of length {want} for this "
                f"{'column' if along_col else 'row'} op on matrix "
                f"{tuple(M.shape)}, got shape {tuple(v.shape)}")
        return fn(M, v[:, None] if along_col else v[None, :])
    return op


add_column = _colrow(torch.Tensor.add_, True)
add_row = _colrow(torch.Tensor.add_, False)
mult_column = _colrow(torch.Tensor.mul_, True)
mult_row = _colrow(torch.Tensor.mul_, False)
div_column = _colrow(torch.Tensor.div_, True)
div_row = _colrow(torch.Tensor.div_, False)


@_raw
def einsum(expr: str, *ts: torch.Tensor) -> torch.Tensor:
    return torch.einsum(expr, *ts)


@_raw
def tensordot(a: torch.Tensor, b: torch.Tensor, axes=2) -> torch.Tensor:
    if not isinstance(axes, int):
        axes = [list(np.atleast_1d(x)) for x in axes]
    return torch.tensordot(a, b, dims=axes)


# -- shapes -------------------------------------------------------------------


@_raw
def transpose(t: torch.Tensor, axes: Optional[Sequence[int]] = None
              ) -> torch.Tensor:
    """Permute the axes (reversed when `axes` is None)."""
    return t.permute(tuple(axes) if axes is not None
                     else tuple(reversed(range(t.dim()))))


@_raw
def reshape(t: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    return t.reshape(tuple(shape))


def flatten(t: torch.Tensor) -> torch.Tensor:
    return reshape(t, (-1,))


@_raw
def squeeze(t: torch.Tensor, axis=None) -> torch.Tensor:
    """Drop size-1 dims (`axis` only; a dim there that is not 1 raises,
    as in numpy)."""
    if axis is None:
        return t.squeeze()
    dims = _axes(t, axis)
    bad = [d for d in dims if t.shape[d] != 1]
    if bad:
        raise ValueError(f"cannot squeeze axis {bad} of shape "
                         f"{tuple(t.shape)}: size is not 1")
    return t.squeeze(dims)


@_raw
def expand_dims(t: torch.Tensor, axis) -> torch.Tensor:
    """New size-1 dims at `axis` (an int or a tuple, positions in the
    result)."""
    dims = _axes(t, axis)
    out_dim = t.dim() + len(dims)
    for d in sorted(d % out_dim for d in dims):
        t = t.unsqueeze(d)
    return t


@_raw
def concatenate(ts: Iterable[torch.Tensor], axis: int = 0) -> torch.Tensor:
    return torch.cat(list(ts), dim=axis)


@_raw
def stack(ts: Iterable[torch.Tensor], axis: int = 0) -> torch.Tensor:
    return torch.stack(list(ts), dim=axis)


@_raw
def split(t: torch.Tensor, parts, axis: int = 0):
    """numpy's split: `parts` equal sections (which must divide the
    axis) or a list of split points."""
    if isinstance(parts, int) and t.shape[axis] % parts:
        raise ValueError("array split does not result in an equal "
                         "division")
    return list(torch.tensor_split(
        t, parts if isinstance(parts, int) else list(parts), dim=axis))


@_raw
def tile(t: torch.Tensor, reps) -> torch.Tensor:
    return torch.tile(t, tuple(np.atleast_1d(reps)))


@_raw
def repeat(t: torch.Tensor, repeats, axis=None) -> torch.Tensor:
    """Repeat each element (of the flattened tensor when `axis` is
    None)."""
    if axis is None:
        return torch.repeat_interleave(t.reshape(-1), repeats)
    return torch.repeat_interleave(t, repeats, dim=axis)


def _fill_value(dtype: torch.dtype):
    """`jnp.take`'s fill for an index out of range: NaN for floats, the
    most negative value for signed integers, the largest for unsigned
    ones, True for booleans."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


@_raw
def gather(t: torch.Tensor, indices, axis: int = 0) -> torch.Tensor:
    """`jnp.take` along `axis`: negative indices count from the end, and
    an index out of range gives `_fill_value` there."""
    idx = torch.as_tensor(indices, device=t.device).long()
    axis, size = axis % t.dim(), t.shape[axis % t.dim()]
    flat = idx.reshape(-1)
    valid = (flat >= -size) & (flat < size)
    got = t.index_select(axis, torch.where(valid, flat % size, 0))
    shape = [1] * t.dim()
    shape[axis] = -1
    got = torch.where(valid.view(shape), got,
                      torch.full((), _fill_value(t.dtype), dtype=t.dtype,
                                 device=t.device))
    return got.reshape(tuple(t.shape[:axis]) + tuple(idx.shape)
                       + tuple(t.shape[axis + 1:]))


# -- comparisons --------------------------------------------------------------


def _cmp(fn):
    @_raw
    def op(a: torch.Tensor, b) -> torch.Tensor:
        return fn(a, _as(b, a)).to(float32)
    return op


lt = _cmp(torch.lt)
le = _cmp(torch.le)
gt = _cmp(torch.gt)
ge = _cmp(torch.ge)
eq = _cmp(torch.eq)
ne = _cmp(torch.ne)


@_raw
def where(cond: torch.Tensor, a: torch.Tensor, b) -> torch.Tensor:
    return torch.where(cond.bool(), a, _as(b, a))


# -- the serving engine's KV pools --------------------------------------------


def quantize_int8_rows(x: torch.Tensor):
    """Symmetric per-row int8 quantization for the serving KV pools: a
    "row" is one token's K (or V) across every head, the trailing two
    dims (H, hd), so x (..., H, hd) gives (q (..., H, hd) int8,
    scale (...) float32) with x ~= q * scale and scale = max|row| / 127.
    An all-zero row gets the reference's scale guard (1e-30 / 127), so
    its quanta are 0, not NaN. `torch.round` rounds half to even, as
    `jnp.round` does. Row granularity lets the paged cache quantize one
    new token row per decode step without re-quantizing the rows
    already in its block."""
    xf = x.float()
    amax = xf.abs().amax(dim=(-2, -1))
    scale = amax.clamp_min(1e-30) / 127.0
    q = torch.round(xf / scale[..., None, None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize_int8_rows(q: torch.Tensor, scale: torch.Tensor):
    """Inverse of `quantize_int8_rows`: q (..., H, hd) int8 and scale
    (...) -> float32. Max absolute error per element is scale/2 =
    max|row|/254."""
    return q.float() * scale[..., None, None]


def paged_gather(pool: torch.Tensor, page_table: torch.Tensor):
    """Block-indexed cache read: `pool` (NB, bs, ...) holds NB blocks of
    bs rows, `page_table` (S, P) maps each of S slots to its P blocks.
    Returns (S, P*bs, ...): slot s's pages concatenated in table order,
    the contiguous view a dense per-slot cache would hold. Logical
    position p of slot s lives at pool[page_table[s, p // bs], p % bs].
    Pure data movement, so values are bitwise the dense layout's."""
    idx = torch.as_tensor(page_table, device=pool.device).long()
    s, p = idx.shape
    got = pool.index_select(0, idx.reshape(-1))  # (S*P, bs, ...)
    return got.reshape((s, p * pool.shape[1]) + tuple(pool.shape[2:]))

