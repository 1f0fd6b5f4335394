"""The port's `GradSentinel` (resilience/sentinel.py) against the
reference's (tests/test_resilience_sentinel.py's oracles).

A small net (a Linear 12 -> 16, ReLU, a Linear -> 4) from the port's
init trains 6 steps on one batch with Adam(0.01) and a sentinel
(init scale 2^6, growth every 3 good steps, backoff 1/2) whose fault
plan makes step 2's gradients NaN (`faults.nonfinite_grad_at(2)`), in
four modes: the plain optimizer, the plain one with a global-norm clip
of 0.5 (the clip shares the sentinel's square sum,
`clip_gradients(square_sum=)`), DistOpt's bf16 wire
(`backward_and_update_half`) and DistOpt's ZeRO-1
(`shard_states=True`). The reference runs the same (its DistOpt on a
mesh of one virtual device, the port's without a process group) in a
process of its own (`run_reference`). Held:

- the injected step leaves every parameter, slot and the step counter
  bitwise as they were (the port's own state around it);
- the loss scale, the skip count and the good-step streak after every
  step equal the reference's (the scale backs off to 2^5 at step 2 and
  grows back to 2^6 at step 5);
- every loss within 1e-6 of the reference's.

Then: the sparse and partial-update modes refuse the sentinel, as the
reference's do; `Model.fault_counters` (None without a sentinel, the
sentinel's counters merged with the supervisor's with one), the eval
step's None, and the `sentinel.skip` trace event.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from helper_torch_parity import _np, run_reference  # noqa: E402
from singa_tpu_torch import autograd, layer, model, opt  # noqa: E402
from singa_tpu_torch.observability import trace  # noqa: E402
from singa_tpu_torch.resilience import GradSentinel, counters, faults  # noqa: E402

K, STEPS, TOL = 2, 6, 1e-6
MODES = ("plain", "clip", "half", "zero1")
SENT = dict(init_scale=2.0 ** 6, growth_interval=3)


def inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 12)).astype(np.float32)
    y = (np.arange(8) % 4).astype(np.int32)
    torch.manual_seed(0)
    m = PortNet("plain")
    m.compile([torch.from_numpy(x)], is_train=False)
    return {k: _np(v) for k, v in m.get_states().items()}, x, y


class PortNet(model.Model):
    def __init__(self, mode):
        super().__init__()
        self.mode = mode
        self.fc1 = layer.Linear(16, in_features=12, device="cpu")
        self.act = layer.ReLU()
        self.fc2 = layer.Linear(4, in_features=16, device="cpu")

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))

    def train_one_batch(self, x, y):
        loss = autograd.softmax_cross_entropy(self.forward(x), y)
        if self.mode == "half":
            self.optimizer.backward_and_update_half(loss)
        else:
            self.optimizer(loss)
        return loss


def reference_side(init, x, y):
    """Each mode's losses, parameters after each step and counters."""
    from singa_tpu import autograd as ref_autograd
    from singa_tpu import layer as ref_layer
    from singa_tpu import model as ref_model
    from singa_tpu import opt as ref_opt
    from singa_tpu.parallel import mesh as ref_mesh
    from singa_tpu.resilience import GradSentinel as RefSentinel
    from singa_tpu.resilience import faults as ref_faults
    from singa_tpu.tensor import from_numpy

    class Net(ref_model.Model):
        def __init__(self, mode):
            super().__init__()
            self.mode = mode
            self.fc1 = ref_layer.Linear(16)
            self.act = ref_layer.ReLU()
            self.fc2 = ref_layer.Linear(4)

        def forward(self, x):
            return self.fc2(self.act(self.fc1(x)))

        def train_one_batch(self, x, y):
            loss = ref_autograd.softmax_cross_entropy(self.forward(x), y)
            if self.mode == "half":
                self.optimizer.backward_and_update_half(loss)
            else:
                self.optimizer(loss)
            return loss

    tx, ty = from_numpy(x), from_numpy(y)
    mesh = ref_mesh.get_mesh((1,), ("data",), devices=jax.devices()[:1])
    out = {}
    for mode in MODES:
        m = Net(mode)
        adam = ref_opt.Adam(lr=0.01, clip_norm=0.5 if mode == "clip"
                            else None)
        o = adam if mode in ("plain", "clip") else ref_opt.DistOpt(
            adam, mesh=mesh, axis_name="data",
            shard_states=mode == "zero1")
        o.set_sentinel(RefSentinel(
            **SENT, fault_plan=ref_faults.nonfinite_grad_at(K)))
        m.set_optimizer(o)
        m.compile([tx], is_train=True, use_graph=True)
        m.set_params(init)
        got = dict(losses=[], params=[], counters=[])
        for _ in range(STEPS):
            got["losses"].append(float(np.asarray(
                m.train_one_batch(tx, ty).data)))
            got["params"].append({k: np.asarray(v.data) for k, v in
                                  m.get_params().items()})
            got["counters"].append(dict(m.fault_counters))
        out[mode] = got
    return out


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    init, x, y = inputs()
    ref = run_reference("test_torch_sentinel", "reference_side",
                        tmp_path_factory.mktemp("reference"), init=init,
                        x=x, y=y)
    return init, x, y, ref


def port_run(mode, init, x, y, plan=True):
    torch.manual_seed(0)
    m = PortNet(mode)
    adam = opt.Adam(lr=0.01, clip_norm=0.5 if mode == "clip" else None)
    o = adam if mode in ("plain", "clip") else opt.DistOpt(
        adam, shard_states=mode == "zero1")
    o.set_sentinel(GradSentinel(
        **SENT, fault_plan=faults.nonfinite_grad_at(K) if plan else None))
    m.set_optimizer(o)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y).long()
    m.compile([tx], is_train=True, use_graph=True)
    m.set_params(init)
    got = dict(losses=[], params=[], counters=[], state=[])
    for _ in range(STEPS):
        got["losses"].append(m.train_one_batch(tx, ty).item())
        got["params"].append({k: _np(v) for k, v in
                              m.get_params().items()})
        got["state"].append({k: _np(torch.as_tensor(v)) for k, v in
                             o.dump_states().items()
                             if not k.startswith("//")})
        got["counters"].append(dict(m.fault_counters))
    return m, got


@pytest.mark.parametrize("mode", MODES)
def test_the_skipped_step_matches_the_reference(case, mode):
    init, x, y, ref = case
    _, got = port_run(mode, init, x, y)
    want = ref[mode]
    # the injected step moved nothing: parameters, slots, step counter
    for k, v in got["state"][K - 1].items():
        np.testing.assert_array_equal(got["state"][K][k], v, err_msg=k)
    for k, v in got["params"][K - 1].items():
        np.testing.assert_array_equal(got["params"][K][k], v, err_msg=k)
    keys = ("loss_scale", "nonfinite_skips", "good_steps", "steps_seen")
    for i in range(STEPS):
        assert {k: got["counters"][i][k] for k in keys} == {
            k: want["counters"][i][k] for k in keys}, f"step {i}"
    scales = [c["loss_scale"] for c in got["counters"]]
    assert scales == [64.0, 64.0, 32.0, 32.0, 32.0, 64.0]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL,
                               atol=TOL)
    for i in range(STEPS):
        for k, v in want["params"][i].items():
            np.testing.assert_allclose(got["params"][i][k], v, rtol=TOL,
                                       atol=TOL, err_msg=f"step {i}: {k}")


def test_a_fault_free_sentinel_run_is_the_unguarded_run(case):
    """Scaling by powers of two is exact: with no fault the guarded run
    equals the run without a sentinel, bitwise."""
    init, x, y, _ = case
    _, guarded = port_run("plain", init, x, y, plan=False)
    torch.manual_seed(0)
    m = PortNet("plain")
    m.set_optimizer(opt.Adam(lr=0.01))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y).long()
    m.compile([tx], is_train=True, use_graph=True)
    m.set_params(init)
    plain = [m.train_one_batch(tx, ty).item() for _ in range(STEPS)]
    assert guarded["losses"] == plain
    assert guarded["counters"][-1]["nonfinite_skips"] == 0


def test_the_sparse_and_partial_modes_refuse_the_sentinel():
    d = opt.DistOpt(opt.SGD(lr=0.1), use_sparse=True)
    d.set_sentinel(GradSentinel())
    assert d.sentinel is d.opt.sentinel
    loss = torch.zeros(())
    with pytest.raises(RuntimeError, match="sparse sync"):
        d.backward_and_sparse_update(loss)
    with pytest.raises(RuntimeError, match="partial-update mode"):
        d.backward_and_partial_update(loss)
    with pytest.raises(ValueError, match="power of two"):
        GradSentinel(init_scale=3.0)


def test_fault_counters_and_the_skip_event(case, tmp_path):
    init, x, y, _ = case
    counters.reset()
    torch.manual_seed(0)
    bare = PortNet("plain")
    bare.set_optimizer(opt.Adam(lr=0.01))
    assert bare.fault_counters is None
    base = str(tmp_path / "trace.jsonl")
    trace.enable(base)
    try:
        m, got = port_run("plain", init, x, y)
    finally:
        trace.disable()
    fc = m.fault_counters
    assert fc["nonfinite_skips"] == 1 and fc["steps_seen"] == STEPS
    assert {"restarts", "rollbacks", "hangs"} <= set(fc)
    events = [e for e in trace.read_events(base)
              if e.get("name") == "sentinel.skip"]
    assert len(events) == 1
    assert events[0]["attrs"] == {"skips": 1, "nonfinite_skips": 1,
                                  "loss_scale": 32.0}
    m.eval()
    m(torch.from_numpy(x))
    assert m._eval_step.fault_counters() is None
