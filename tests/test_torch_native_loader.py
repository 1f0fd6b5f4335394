"""The port's prefetch loader (singa_tpu_torch.native.NativeLoader over
`native/dataloader_core.cc`, and `utils.data.prefetch_batches`) against
the reference's `singa_tpu.native.NativeLoader`.

- batch by batch and bitwise equal to the reference's (run in a process
  of its own, `helper_torch_parity.run_reference`): seeded data of 100
  items of 3 x 4 x 4, batch 16, shuffle on and off, three epochs (across
  two reshuffles), `copy=True` and `copy=False`;
- `copy=False` yields views into the ring (no copy), `copy=True` owned
  arrays;
- a batch larger than the data ends the iteration, and `close()` in the
  middle of an epoch returns within a deadline;
- `prefetch_batches` yields `steps` batches and closes its loader, also
  when abandoned early;
- the plain loader gives the same coverage and shapes (it cannot give
  libstdc++'s shuffle order);
- a missing or refusing g++ raises `NativeBuildError`: no Python
  fallback.
"""

import itertools
import threading
import time

import numpy as np
import pytest

from helper_torch_parity import run_reference
from singa_tpu_torch import native
from singa_tpu_torch.utils import data

N, ITEM, BATCH = 100, (3, 4, 4), 16
#: three epochs of N // BATCH batches (the last short batch dropped)
STEPS = 3 * (N // BATCH)
CASES = [(shuffle, copy) for shuffle in (True, False)
         for copy in (True, False)]


def dataset(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, *ITEM)).astype(np.float32)
    return x, np.arange(N, dtype=np.int32)


def take(loader, steps=STEPS):
    """`steps` batches, each copied out before the next is asked for (a
    view is valid only until then)."""
    return [(bx.copy(), by.copy())
            for bx, by in itertools.islice(loader, steps)]


def reference_batches():
    """The reference loader's batches for every case."""
    from singa_tpu.native import NativeLoader, available

    assert available()
    x, y = dataset()
    out = {}
    for shuffle, copy in CASES:
        loader = NativeLoader(x, y, BATCH, seed=5, shuffle=shuffle,
                              copy=copy)
        out[shuffle, copy] = take(loader)
        loader.close()
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(__name__, "reference_batches",
                         tmp_path_factory.mktemp("ref"))


@pytest.mark.parametrize("shuffle,copy", CASES)
def test_batches_equal_the_reference_bitwise(reference, shuffle, copy):
    x, y = dataset()
    before = native.native_call_count()
    loader = native.NativeLoader(x, y, BATCH, seed=5, shuffle=shuffle,
                                 copy=copy)
    assert native.native_call_count() == before + 1
    got = take(loader)
    loader.close()
    want = reference[shuffle, copy]
    assert len(got) == len(want) == STEPS
    for k, ((gx, gy), (wx, wy)) in enumerate(zip(got, want)):
        assert gx.shape == (BATCH, *ITEM) and gx.dtype == np.float32
        assert gy.shape == (BATCH,) and gy.dtype == np.int32
        np.testing.assert_array_equal(gy, wy, err_msg=f"batch {k}")
        np.testing.assert_array_equal(gx, wx, err_msg=f"batch {k}")
        np.testing.assert_array_equal(gx, x[gy])
    epochs = [np.concatenate([b[1] for b in got[e * 6:(e + 1) * 6]])
              for e in range(3)]
    if shuffle:
        # mt19937_64(seed + epoch): each epoch its own order
        assert not np.array_equal(epochs[0], epochs[1])
    else:
        assert all(np.array_equal(e, np.arange(96)) for e in epochs)


def test_views_live_in_the_ring_and_copies_are_owned():
    x, y = dataset()
    views = native.NativeLoader(x, y, BATCH, copy=False)
    bx, by = next(views)
    assert not bx.flags.owndata and not by.flags.owndata
    assert not np.shares_memory(bx, x)
    first = by.copy()
    bx2, by2 = next(views)  # the first slot is released to the producer
    assert not np.array_equal(first, by2)
    views.close()
    owned = native.NativeLoader(x, y, BATCH, copy=True)
    cx, cy = next(owned)
    assert cx.flags.owndata or cx.base is not None and cx.base.flags.owndata
    assert cy.flags.owndata
    owned.close()
    with pytest.raises(StopIteration):
        next(owned)


@pytest.mark.parametrize("copy", [True, False])
def test_a_batch_larger_than_the_data_ends_the_iteration(copy):
    x, y = dataset()
    t = time.monotonic()
    assert list(native.NativeLoader(x, y, N + 1, copy=copy)) == []
    assert time.monotonic() - t < 10.0


@pytest.mark.parametrize("copy", [True, False])
def test_close_in_the_middle_of_an_epoch_returns(copy):
    x, y = dataset()
    loader = native.NativeLoader(x, y, BATCH, prefetch=2, copy=copy)
    next(loader)
    next(loader)
    done = threading.Event()

    def close():
        loader.close()
        done.set()

    threading.Thread(target=close, daemon=True).start()
    assert done.wait(10.0), "close() did not return within 10 s"
    with pytest.raises(StopIteration):
        next(loader)


def test_prefetch_batches_yields_steps_and_closes(monkeypatch):
    closed = []
    real_close = native.NativeLoader.close

    def close(self):
        if self._h is not None:
            closed.append(self.batch)
        real_close(self)

    monkeypatch.setattr(native.NativeLoader, "close", close)
    x, y = dataset()
    got = list(data.prefetch_batches(x, y, BATCH, 9, seed=5))
    assert len(got) == 9 and closed == [BATCH]
    assert all(bx.shape == (BATCH, *ITEM) and by.shape == (BATCH,)
               for bx, by in got)
    # the same stream as the loader's own, across an epoch boundary
    want = take(native.NativeLoader(x, y, BATCH, seed=5), 9)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gy, wy)
        np.testing.assert_array_equal(gx, wx)
    # abandoned after 2 of 5: closed all the same
    it = data.prefetch_batches(x, y, 8, 5, copy=False)
    next(it), next(it)
    it.close()
    assert closed[-1] == 8


@pytest.mark.parametrize("shuffle", [True, False])
def test_the_plain_loader_gives_the_same_coverage_and_shapes(shuffle):
    x, y = dataset()
    plain = list(itertools.islice(
        native.plain_loader(x, y, BATCH, seed=5, shuffle=shuffle), STEPS))
    lib = take(native.NativeLoader(x, y, BATCH, seed=5, shuffle=shuffle))
    for got in (plain, lib):
        assert len(got) == STEPS
        for e in range(3):
            labels = np.concatenate([b[1] for b in got[e * 6:(e + 1) * 6]])
            # each epoch: 96 distinct items, the last short batch dropped
            assert len(set(labels.tolist())) == 96
        for bx, by in got:
            assert bx.shape == (BATCH, *ITEM) and bx.dtype == np.float32
            assert by.dtype == np.int32
            np.testing.assert_array_equal(bx, x[by])
    assert list(native.plain_loader(x, y, N + 1)) == []


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: with g++ missing, and with g++ refusing the source,
    making a loader raises NativeBuildError."""
    x, y = dataset()
    monkeypatch.setattr(native, "_loader_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(native.NativeBuildError, match=r"g\+\+ not found"):
        native.NativeLoader(x, y, BATCH)
    with pytest.raises(native.NativeBuildError):
        next(data.prefetch_batches(x, y, BATCH, 1))
    monkeypatch.undo()
    bad = tmp_path / "dataloader_core.cc"
    bad.write_text('extern "C" { long loader_new( }\n')
    monkeypatch.setattr(native, "_loader_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "LOADER_SOURCE", bad)
    with pytest.raises(native.NativeBuildError, match="error"):
        native.NativeLoader(x, y, BATCH)
