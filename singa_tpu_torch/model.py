"""Model base and the weight carry-over (counterpart of singa_tpu/model.py).

`Model` is an `nn.Module` (`train()`/`eval()` are PyTorch's). Its
compile/graph/optimizer machinery belongs to the training slice.

`load_singa_tpu_params` carries a `singa_tpu` model's weights into the
port: it takes `{name: np.asarray(t.data) for name, t in
jax_model.get_params().items()}` and copies each array into the port's
parameter of the same name, in the same layout.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["Model", "load_singa_tpu_params"]


class Model(nn.Module):
    """Base user model; `named_parameters()` gives the reference's
    dotted parameter names."""


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
