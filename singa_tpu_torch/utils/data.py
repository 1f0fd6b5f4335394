"""Datasets for the example trainers (counterpart of
singa_tpu/utils/data.py, the image part).

Each loader first looks for the real dataset on disk (the standard
binary layout, under ``SINGA_DATA_DIR`` or ``~/data``) and otherwise
makes a class-conditional surrogate of the same shapes and dtypes from a
seed, with the reference's numpy draws, so both packages see the same
images. Arrays are numpy; `batches` yields numpy batches for the trainer
to move, `prefetch_batches` the same from the native threaded prefetcher,
`device_batches` slices a split already on the device.
"""

from __future__ import annotations

import gzip
import os
import pickle
import itertools
from typing import Iterator, Tuple

import numpy as np
import torch

__all__ = ["load_mnist", "load_cifar10", "synthetic_imagenet", "batches",
           "prefetch_batches", "device_batches"]


def _data_dir() -> str:
    return os.environ.get(
        "SINGA_DATA_DIR", os.path.join(os.path.expanduser("~"), "data"))


def _synth_images(n: int, shape, classes: int, seed: int,
                  proto_seed: int = 1234) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional Gaussian images: learnable but not trivial. The
    class prototypes come from `proto_seed` (fixed per dataset), so the
    splits share one distribution; `seed` drives the labels and the
    noise."""
    protos = np.random.RandomState(proto_seed).randn(classes, *shape)
    rng = np.random.RandomState(seed)
    y = rng.randint(0, classes, n).astype(np.int32)
    x = protos[y] * 0.5 + rng.randn(n, *shape) * 0.5
    return x.astype(np.float32), y


def load_mnist(n_train: int = 60000, n_val: int = 10000,
               flatten: bool = True):
    """(x_train, y_train, x_val, y_val); images in [0, 1] float32, labels
    int32, flattened to 784 (the reference MLP example's format) unless
    flatten=False (1 x 28 x 28). Reads the four idx gz files under
    ``<data dir>/mnist``; without them, 4096 / 512 synthetic images
    scaled into [0, 1] by each split's min and range."""
    d = os.path.join(_data_dir(), "mnist")
    names = ["train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz",
             "t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz"]
    if all(os.path.exists(os.path.join(d, f)) for f in names):
        def read(name, offset):
            with gzip.open(os.path.join(d, name), "rb") as f:
                return np.frombuffer(f.read(), np.uint8, offset=offset)

        xt = read(names[0], 16).reshape(-1, 28, 28)[:n_train]
        yt = read(names[1], 8)[:n_train].astype(np.int32)
        xv = read(names[2], 16).reshape(-1, 28, 28)[:n_val]
        yv = read(names[3], 8)[:n_val].astype(np.int32)
        xt = xt.astype(np.float32) / 255.0
        xv = xv.astype(np.float32) / 255.0
    else:
        xt, yt = _synth_images(min(n_train, 4096), (28, 28), 10, seed=0,
                               proto_seed=100)
        xv, yv = _synth_images(min(n_val, 512), (28, 28), 10, seed=1,
                               proto_seed=100)
        xt, xv = (xt - xt.min()) / np.ptp(xt), (xv - xv.min()) / np.ptp(xv)
    shape = (-1,) if flatten else (1, 28, 28)
    return (xt.reshape((len(xt),) + shape), yt,
            xv.reshape((len(xv),) + shape), yv)


def load_cifar10(n_train: int = 50000, n_val: int = 10000):
    """(x_train, y_train, x_val, y_val); NCHW 3x32x32 float32, normalized
    per channel with the training split's statistics."""
    d = os.path.join(_data_dir(), "cifar-10-batches-py")
    if os.path.isdir(d):
        xs, ys = [], []
        for i in range(1, 6):
            with open(os.path.join(d, f"data_batch_{i}"), "rb") as f:
                batch = pickle.load(f, encoding="bytes")
            xs.append(batch[b"data"])
            ys.extend(batch[b"labels"])
        xt = np.concatenate(xs).reshape(-1, 3, 32, 32).astype(np.float32)
        yt = np.asarray(ys, np.int32)
        with open(os.path.join(d, "test_batch"), "rb") as f:
            batch = pickle.load(f, encoding="bytes")
        xv = batch[b"data"].reshape(-1, 3, 32, 32).astype(np.float32)
        yv = np.asarray(batch[b"labels"], np.int32)
        xt, xv = xt / 255.0, xv / 255.0
    else:
        xt, yt = _synth_images(min(n_train, 2048), (3, 32, 32), 10, seed=2,
                               proto_seed=200)
        xv, yv = _synth_images(min(n_val, 256), (3, 32, 32), 10, seed=3,
                               proto_seed=200)
    mean = xt.mean((0, 2, 3), keepdims=True)
    std = xt.std((0, 2, 3), keepdims=True) + 1e-7
    return (((xt - mean) / std)[:n_train], yt[:n_train],
            ((xv - mean) / std)[:n_val], yv[:n_val])


def synthetic_imagenet(n: int = 512, classes: int = 1000, size: int = 224):
    """ImageNet-shaped synthetic images (3 x size x size, `classes`
    classes)."""
    return _synth_images(n, (3, size, size), classes, seed=4)


def batches(x: np.ndarray, y: np.ndarray, batch_size: int,
            shuffle: bool = True, seed: int = 0,
            drop_last: bool = True) -> Iterator[Tuple[np.ndarray,
                                                      np.ndarray]]:
    """One epoch of (x, y) batches, shuffled from `seed`; the last short
    batch is dropped unless `drop_last=False`."""
    n = len(x)
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    end = n - (n % batch_size) if drop_last else n
    for i in range(0, end, batch_size):
        j = idx[i:i + batch_size]
        yield x[j], y[j]


def prefetch_batches(x: np.ndarray, y: np.ndarray, batch_size: int,
                     steps: int, seed: int = 0, shuffle: bool = True,
                     copy: bool = True
                     ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """`steps` batches from the native threaded prefetcher
    (`native.NativeLoader` over native/dataloader_core.cc): the next
    batches are gathered on a background thread while the device runs
    the current step; the loader is closed when the iteration ends or is
    abandoned. `copy=True` yields owned arrays. `copy=False` yields views
    into the loader's ring, each valid only until the next batch is
    asked for: finish its host-to-device copy first (`NativeLoader`
    says why and how)."""
    from singa_tpu_torch.native import NativeLoader

    loader = NativeLoader(x, y, batch_size, seed=seed, shuffle=shuffle,
                          copy=copy)
    try:
        yield from itertools.islice(loader, steps)
    finally:
        loader.close()


def device_batches(tx: torch.Tensor, ty: torch.Tensor, batch_size: int,
                   shuffle: bool = True, seed: int = 0,
                   drop_last: bool = True):
    """One epoch of (x, y) batches over a split already on the device:
    the permutation `RandomState(seed).permutation(n)` (the reference's
    batch order) applied by one on-device `index_select` per epoch, then
    slices of static shape; the last short batch is dropped unless
    `drop_last=False`."""
    n = tx.shape[0]
    if shuffle:
        perm = torch.from_numpy(np.random.RandomState(seed).permutation(n))
        perm = perm.to(tx.device)
        tx, ty = tx.index_select(0, perm), ty.index_select(0, perm)
    end = n - (n % batch_size) if drop_last else n
    for i in range(0, end, batch_size):
        yield tx[i:i + batch_size], ty[i:i + batch_size]
