"""Shared pieces of the parity tests between singa_tpu (JAX, the
reference) and its PyTorch port singa_tpu_torch: seeded numpy inputs fed
to both packages, and the carry-over of a reference model's weights."""

import importlib

import numpy as np
import torch

# The tier-1 suite runs several pytest workers on a few cores; torch's
# default of one intra-op thread per core in every worker would starve
# the timing-sensitive multi-process tests that share the machine. The
# parity shapes here are tiny, so two threads lose nothing.
torch.set_num_threads(2)


def jax_flash():
    """The reference's flash-attention MODULE (singa_tpu.ops rebinds the
    name `flash_attention` to the function)."""
    return importlib.import_module("singa_tpu.ops.flash_attention")


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def to_torch(a):
    return torch.from_numpy(np.array(a))


def to_np(x):
    return np.asarray(x.detach().float().numpy() if hasattr(x, "detach")
                      else x)


def randomize_params(jax_layer, seed):
    """Give every reference parameter seeded random values (so scales,
    offsets and biases are not the trivial ones/zeros of a fresh init)
    and return them as the numpy dict the port's carry-over takes."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, t in jax_layer.get_params().items():
        shape = tuple(t.shape)
        fan_in = shape[-2] if len(shape) >= 2 else 1
        if name.endswith(("scale", "ln1_s", "ln2_s")):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif len(shape) >= 2 and not name.endswith(".table"):
            a = rng.standard_normal(shape) / np.sqrt(fan_in)
        else:
            a = 0.1 * rng.standard_normal(shape)
        params[name] = a.astype(np.float32)
    jax_layer.set_params(params)
    return {k: np.asarray(v.data) for k, v in
            jax_layer.get_params().items()}
