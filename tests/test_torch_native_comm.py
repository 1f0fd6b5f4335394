"""The port's native communicator planners (singa_tpu_torch.native over
`native/comm_core.cc`): the counterpart of tests/test_plan_buckets.py and
tests/test_native.py:95-115.

- `plan_buckets_native` equals its plain version
  (`communicator.plan_buckets_plain`) and the reference's
  `communicator.plan_buckets` over random size lists and the edge cases:
  empty, an element over the cap, sizes that meet the cap exactly;
- `plan_buckets_balanced` and `ring_schedule` equal the reference's
  native results;
- `communicator.plan_buckets` is the library's, and `native_call_count()`
  rises across one DistOpt step over a world-1 gloo group;
- without the library a distributed step raises `NativeBuildError`, with
  g++ missing or g++ refusing the source: it never plans in Python.
"""

import numpy as np
import pytest
import torch

from singa_tpu import native as ref_native
from singa_tpu.communicator import plan_buckets as ref_plan
from singa_tpu_torch import communicator, distributed, native, opt
from singa_tpu_torch.communicator import plan_buckets, plan_buckets_plain

EDGE_CASES = [
    ([], 4),
    ([10], 4),                 # one element over the cap
    ([2, 2, 2], 4),            # the cap met exactly, then a new bucket
    ([4, 4, 4], 4),            # every element exactly the cap
    ([1, 9, 1], 4),            # an oversized element between small ones
    ([0, 0, 5, 0], 5),         # empty gradients
    ([3, 1, 3, 1, 3], 4),
]


def random_sizes(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 60))
    sizes = rng.integers(1, 5000, n) * (rng.random(n) < 0.9)
    return [int(s) for s in sizes], int(rng.integers(1, 20000))


@pytest.mark.parametrize("case", [*EDGE_CASES,
                                  *(random_sizes(s) for s in range(20))])
def test_plan_buckets_native_equals_plain_and_the_reference(case):
    sizes, cap = case
    got = native.plan_buckets_native(sizes, cap)
    assert got == plan_buckets_plain(sizes, cap), (sizes, cap)
    assert got == ref_plan(sizes, cap), (sizes, cap)
    assert plan_buckets(sizes, cap) == got


@pytest.mark.parametrize("seed", range(6))
def test_balanced_and_ring_schedule_equal_the_reference(seed):
    sizes, _ = random_sizes(seed)
    rng = np.random.default_rng(100 + seed)
    for n_buckets in (1, 2, int(rng.integers(3, 9))):
        got = native.plan_buckets_balanced(sizes, n_buckets)
        assert got == ref_native.plan_buckets_balanced(sizes, n_buckets)
        assert sorted(i for b in got for i in b) == list(range(len(sizes)))
    for world in (1, 2, 3, int(rng.integers(4, 9))):
        n = int(rng.integers(0, 100000))
        got = native.ring_schedule(n, world)
        assert got.shape == (world - 1, world, 2)
        np.testing.assert_array_equal(got, ref_native.ring_schedule(n, world))
        # each step's chunks tile [0, n)
        for step in got:
            assert sorted(map(tuple, step.tolist()))[0][0] == 0
            assert int(step[:, 1].sum()) == n


def test_planner_arguments_are_validated():
    with pytest.raises(ValueError, match="n_buckets"):
        native.plan_buckets_balanced([1, 2], 0)
    with pytest.raises(ValueError, match="world >= 1"):
        native.ring_schedule(10, 0)


def _mlp_step():
    """One DistOpt step of a small MLP over the live group."""
    from singa_tpu_torch import autograd, layer, model

    class Net(model.Model):
        def __init__(self):
            super().__init__()
            gen = torch.Generator().manual_seed(0)
            self.fc1 = layer.Linear(8, in_features=6, device="cpu",
                                    generator=gen)
            self.fc2 = layer.Linear(3, in_features=8, device="cpu",
                                    generator=gen)

        def forward(self, x):
            return self.fc2(autograd.relu(self.fc1(x)))

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = autograd.softmax_cross_entropy(out, y)
            self.optimizer(loss)
            return out, loss

    m = Net()
    m.set_optimizer(opt.DistOpt(opt.SGD(lr=0.1),
                                mesh=distributed.global_mesh()))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 6)).astype(np.float32))
    y = torch.arange(4) % 3
    m.compile([x], is_train=True, use_graph=False)
    return m.train_one_batch(x, y)[1]


@pytest.fixture
def world1_gloo():
    distributed.init(device="cpu")
    try:
        yield
    finally:
        distributed.shutdown()


def test_distopt_step_plans_through_the_library(world1_gloo):
    before = native.native_call_count()
    loss = _mlp_step()
    assert torch.isfinite(loss)
    assert native.native_call_count() > before


def test_distributed_step_refuses_to_plan_in_python(world1_gloo, tmp_path,
                                                    monkeypatch):
    """No fallback: with g++ missing, and with g++ refusing the source,
    the step raises NativeBuildError (the compiler's output in the
    message)."""
    monkeypatch.setattr(native, "_comm_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(native.NativeBuildError, match=r"g\+\+ not found"):
        _mlp_step()
    monkeypatch.undo()
    bad = tmp_path / "comm_core.cc"
    bad.write_text('extern "C" { int comm_plan_buckets( }\n')
    monkeypatch.setattr(native, "_comm_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "COMM_SOURCE", bad)
    with pytest.raises(native.NativeBuildError, match="error"):
        communicator.plan_buckets([1, 2, 3], 4)
