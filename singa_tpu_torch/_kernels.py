"""One formulation each of the ops that both `tensor` and (later)
`autograd` expose (counterpart of singa_tpu/_kernels.py): `sort_`,
`argsort_`, `topk_`, `norm_` and `one_hot_`, tensor in, tensor out, so
the two namespaces cannot part in shape, keepdims or axis handling."""

from __future__ import annotations

import math

import torch

__all__ = ["sort_", "argsort_", "topk_", "norm_", "one_hot_"]


def sort_(a: torch.Tensor, axis: int = -1, descending: bool = False):
    """Ascending sort, reversed along `axis` when `descending` (ties
    then come last index first, as the reference's flip gives)."""
    s = torch.sort(a, dim=axis, stable=True).values
    return s.flip(axis) if descending else s


def argsort_(a: torch.Tensor, axis: int = -1, descending: bool = False):
    i = torch.argsort(a, dim=axis, stable=True)
    return i.flip(axis) if descending else i


def topk_(a: torch.Tensor, k: int, axis: int = -1):
    """(values, indices) of the k largest along `axis`, largest first;
    always a tuple."""
    v, i = torch.topk(a, k, dim=axis, largest=True, sorted=True)
    return v, i


def norm_(a: torch.Tensor, ord=2, axis=None,  # noqa: A002
          keepdims: bool = False):
    """Vector p-norm. axis=None norms the FLATTENED tensor (NumPy's
    default, never the matrix operator norm); keepdims then gives shape
    (1,) * ndim."""
    flat = axis is None
    arr = a.reshape(-1) if flat else a
    dims = None if flat else axis
    kd = False if flat else keepdims

    def total(t):
        return t.sum() if dims is None else t.sum(dim=dims, keepdim=kd)

    if ord == math.inf:
        v = arr.abs().amax() if dims is None else arr.abs().amax(
            dim=dims, keepdim=kd)
    elif ord == 2:
        v = torch.sqrt(total(arr.square()))
    elif ord == 1:
        v = total(arr.abs())
    else:
        p = float(ord)
        v = torch.pow(total(torch.pow(arr.abs(), p)), 1.0 / p)
    if flat and keepdims:
        v = v.reshape((1,) * a.dim())
    return v


def one_hot_(a: torch.Tensor, num_classes: int,
             dtype: torch.dtype = torch.float32):
    """`jax.nn.one_hot`: an index outside [0, num_classes) gives a row
    of zeros."""
    classes = torch.arange(num_classes, device=a.device)
    return (a.unsqueeze(-1) == classes).to(dtype)
