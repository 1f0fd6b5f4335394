"""The self-healing layer on the port: the counterpart of
tests/test_resilience_supervisor.py, tests/test_supervisor_mesh.py, the
retry cases of tests/test_resilience_faults.py and the heal span tree of
tests/test_observability_trace.py.

- `retry_transient`: transients absorbed and counted, bounded,
  deterministic classes and out-of-memory errors (the reference's
  ``RESOURCE_EXHAUSTED`` and PyTorch's `torch.OutOfMemoryError`) never
  retried, a known transient signature overriding the class.
- `Watchdog`: an interruptible stall becomes a `StepHangError` naming
  the step; `on_hang` fires from the timer thread; a step that ends in
  time cancels its timer.
- `SpikeDetector` flags the same indices as the reference's on seeded
  loss sequences; `choose_mesh` equals the reference's over a grid of
  (n, dp, tp, sp).
- `Supervisor` on a small graph-mode MLP (SGD with momentum and a
  `GradSentinel`), with the deterministic injectors: a crash and a
  watchdog-detected hang heal bitwise the fault-free run; a poisoned
  batch rolls back once and, on a constant batch, ends bitwise the
  fault-free run at n-1 steps; the counters ride `fault_counters`; the
  budget is bounded with its history; disk stays bounded and a foreign
  checkpoint is refused; the rollback's cursor is durable; a
  deterministic error fails fast.
- Parity: the reference's supervised MLP (in a process of its own) and
  the port's, the same weights carried across, under a crash at step 2,
  a poisoned batch at step 2 and both: equal steps, restarts, rollbacks
  and skipped windows, losses within 1e-5.
- The heal span tree: `supervisor.rollback` parents exactly
  `anomaly.spike`, `checkpoint.read` and `checkpoint.write`, and the
  per-step commits are root spans.
- `mesh_fn`: at world 1 in this process; at world 2 over gloo
  (`helper_torch_parity._rank_supervisor_mesh`) the default policy heals
  a crash bitwise the unsupervised steps, a probe folding dp into tp at
  the rebuild reshapes once, and a probe over fewer ranks than the group
  is refused (the shrink re-forms the group across processes: a fleet
  epoch, tests/test_torch_fleet_leader_loss.py).
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from helper_torch_parity import (_rank_supervisor_mesh, ckpt_net, run_both,
                                 run_ranks)
from singa_tpu_torch import autograd, layer, model, opt, resilience
from singa_tpu_torch.observability import trace
from singa_tpu_torch.resilience import (GradSentinel, SpikeDetector,
                                        StepHangError, Supervisor, Watchdog,
                                        choose_mesh, counters,
                                        default_mesh_fn, faults)
from singa_tpu_torch.resilience.retry import (DETERMINISTIC_ERRORS,
                                              RETRY_ATTEMPTS,
                                              TRANSIENT_SIGNATURES,
                                              exp_backoff_s, is_oom,
                                              retry_transient)

PARITY_TOL = 1e-5


@pytest.fixture(autouse=True)
def _counters_isolation():
    counters.reset()
    yield
    counters.reset()


# -- retry ---------------------------------------------------------------------


def test_retry_absorbs_transient_and_bumps_counter():
    flaky = faults.TransientCalls(lambda: 42.0, fail_calls=(1, 2))
    assert retry_transient("inject", flaky, backoff_s=0) == 42.0
    assert flaky.calls == 3
    assert counters.snapshot()["retries"] == 2


def test_retry_is_bounded():
    flaky = faults.TransientCalls(
        lambda: None, fail_calls=tuple(range(1, 100)))
    with pytest.raises(RuntimeError, match="injected transient"):
        retry_transient("inject", flaky, backoff_s=0)
    assert flaky.calls == RETRY_ATTEMPTS


@pytest.mark.parametrize("exc", [
    ValueError("bad shapes"),
    RuntimeError("RESOURCE_EXHAUSTED: hbm"),
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB")],
    ids=["deterministic", "resource_exhausted", "torch_oom", "oom_message"])
def test_retry_fails_fast_on_deterministic_and_oom(exc):
    """A deterministic class fails the same way on every attempt, and an
    out-of-memory error is the batch-halving path's: neither is retried.
    `torch.OutOfMemoryError` is a RuntimeError, which the class test alone
    would retry."""
    assert ValueError in DETERMINISTIC_ERRORS
    assert isinstance(exc, ValueError) or is_oom(exc)
    once = faults.TransientCalls(lambda: None, fail_calls=(1,),
                                 exc_factory=lambda i: exc)
    with pytest.raises(type(exc)):
        retry_transient("inject", once, backoff_s=0)
    assert once.calls == 1
    assert counters.snapshot().get("retries", 0) == 0


def test_retry_known_transient_signature_overrides_class():
    msg = ("INTERNAL: http://127.0.0.1:8113/remote_compile: read "
           "body: response body closed before all bytes were read")
    assert any(s in msg for s in TRANSIENT_SIGNATURES)
    flaky = faults.TransientCalls(lambda: "ok", fail_calls=(1,),
                                  exc_factory=lambda i: ValueError(msg))
    assert retry_transient("inject", flaky, backoff_s=0) == "ok"
    assert flaky.calls == 2
    flaky2 = faults.TransientCalls(lambda: "ok", fail_calls=(1,),
                                   exc_factory=lambda i: RuntimeError(msg))
    assert retry_transient("inject", flaky2, backoff_s=0) == "ok"


def test_exp_backoff_matches_the_reference():
    from singa_tpu.resilience import retry as ref_retry

    for attempt in range(10):
        for base, factor, cap in ((5.0, 2.0, 120.0), (0.5, 3.0, 7.0)):
            assert exp_backoff_s(attempt, base, factor, cap) == \
                ref_retry.exp_backoff_s(attempt, base, factor, cap)
    assert (ref_retry.RETRY_ATTEMPTS, ref_retry.RETRY_BACKOFF_S,
            ref_retry.DETERMINISTIC_ERRORS, ref_retry.TRANSIENT_SIGNATURES
            ) == (RETRY_ATTEMPTS, 5.0, DETERMINISTIC_ERRORS,
                  TRANSIENT_SIGNATURES)


# -- watchdog ------------------------------------------------------------------


def test_watchdog_converts_stall_to_named_hang_error():
    wd = Watchdog(timeout_s=0.25)
    t0 = time.monotonic()
    with pytest.raises(StepHangError) as ei:
        with wd.guard(7):
            for _ in range(400):  # an interruptible host stall
                time.sleep(0.02)
    assert time.monotonic() - t0 < 5.0  # detected, not waited out
    e = ei.value
    assert e.step == 7 and e.elapsed_s >= 0.25
    assert "step 7" in str(e) and "hung" in str(e)
    assert counters.snapshot().get("hangs", 0) == 1
    with wd.guard(8):
        pass


def test_watchdog_on_hang_callback_and_disarm_race(tmp_path):
    seen = []
    hb = str(tmp_path / "hb")
    wd = Watchdog(timeout_s=0.2, on_hang=lambda s, e: seen.append((s, e)),
                  heartbeat_path=hb)
    assert os.path.exists(hb)  # beats at construction
    with pytest.raises(StepHangError):
        with wd.guard(3):
            for _ in range(400):
                time.sleep(0.02)
    assert seen and seen[0][0] == 3
    with wd.guard(4):
        time.sleep(0.01)
    time.sleep(0.3)  # past the would-be deadline: disarm cancelled it
    assert len(seen) == 1
    assert wd.pop_fired() is None  # the hang's record was consumed


def test_watchdog_heartbeat_defaults_to_the_env(tmp_path, monkeypatch):
    hb = str(tmp_path / "hb_env")
    monkeypatch.setenv(resilience.HEARTBEAT_ENV, hb)
    wd = Watchdog(timeout_s=60.0)
    assert wd.heartbeat_path == hb and os.path.exists(hb)
    os.utime(hb, (0, 0))
    with wd.guard(0):
        pass
    assert os.stat(hb).st_mtime > time.time() - 60


# -- spike detector ------------------------------------------------------------


def test_spike_detector_flags_outlier_not_trend():
    det = SpikeDetector(window=16, zmax=6.0, min_history=4)
    for i in range(10):
        assert det.update(2.0 - 0.02 * i) is False
    assert det.update(50.0) is True
    assert det.update(49.0) is True  # the first spike never entered
    assert det.update(1.8) is False
    assert det.stats()["spikes"] == 2


def test_spike_detector_ignores_nonfinite_and_drops():
    det = SpikeDetector(window=8, zmax=6.0, min_history=3)
    for v in (1.0, 1.1, 0.9, 1.0):
        det.update(v)
    assert det.update(float("nan")) is False
    assert det.update(float("inf")) is False
    assert det.update(0.01) is False
    assert det.stats()["spikes"] == 0


@pytest.mark.parametrize("seed", range(4))
def test_spike_detector_flags_what_the_reference_flags(seed):
    from singa_tpu.resilience.anomaly import SpikeDetector as RefDetector

    rng = np.random.default_rng(seed)
    losses = 3.0 * np.exp(-0.01 * np.arange(200)) + rng.normal(0, 0.05, 200)
    hit = rng.choice(200, 12, replace=False)
    losses[hit] *= rng.choice([0.2, 3.0, 40.0, 1e4], 12)
    losses[rng.choice(200, 3, replace=False)] = np.nan
    kw = dict(window=int(rng.integers(4, 33)), zmax=float(rng.choice(
        [3.0, 6.0, 8.0])), min_history=int(rng.integers(2, 5)))
    port, ref = SpikeDetector(**kw), RefDetector(**kw)
    got = [i for i, v in enumerate(losses) if port.update(v)]
    want = [i for i, v in enumerate(losses) if ref.update(v)]
    assert got == want and got
    assert port.stats() == pytest.approx(ref.stats(), nan_ok=True)


# -- the mesh policy -----------------------------------------------------------


def test_choose_mesh_equals_the_reference_over_a_grid():
    from singa_tpu.resilience import supervisor as ref_sup

    for n in range(1, 17):
        for dp in (1, 2, 3, 4, 8):
            for tp in (1, 2, 4):
                for sp in (1, 2, 4):
                    try:
                        want = ref_sup.choose_mesh(n, dp, tp, sp)
                    except RuntimeError as e:
                        with pytest.raises(RuntimeError,
                                           match="cannot carry tp"):
                            choose_mesh(n, dp, tp, sp)
                        assert "cannot carry tp" in str(e)
                        continue
                    assert choose_mesh(n, dp, tp, sp) == want, (n, dp, tp,
                                                                sp)
    assert choose_mesh(8, 4, 2, 1) == (4, 2, 1)
    assert choose_mesh(6, 4, 2, 1) == (2, 2, 1)
    assert choose_mesh(64, 4, 2, 2) == (4, 2, 2)
    with pytest.raises(ValueError, match="must be positive"):
        choose_mesh(0, 1)


def test_default_mesh_fn_probes_devices():
    fn = default_mesh_fn(4, 1, 1)
    assert fn(list(range(4))) == (4, 1, 1)
    assert fn(list(range(2))) == (2, 1, 1)


# -- the supervisor --------------------------------------------------------------


class Net(model.Model):
    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(3)
        self.fc1 = layer.Linear(16, in_features=12, device="cpu",
                                generator=gen)
        self.act = layer.ReLU()
        self.fc2 = layer.Linear(4, in_features=16, device="cpu",
                                generator=gen)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))

    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = autograd.softmax_cross_entropy(out, y)
        self.optimizer(loss)
        return out, loss


def _build():
    """A deterministic fresh build: the same init, compiled; a restore
    supplies the rest."""
    torch.manual_seed(3)
    m = Net()
    o = opt.SGD(lr=0.1, momentum=0.9)
    o.set_sentinel(GradSentinel(init_scale=2.0 ** 4, growth_interval=8))
    m.set_optimizer(o)
    m.compile([_batches(1)[0][0]], is_train=True, use_graph=True)
    return m


def _batches(n, constant=False):
    out = []
    for i in range(n):
        rng = np.random.default_rng(50 if constant else 50 + i)
        out.append((
            torch.from_numpy(rng.standard_normal((8, 12)).astype(
                np.float32)),
            torch.from_numpy((np.arange(8) % 4).astype(np.int64))))
    return out


def _ref_params(n_steps, batches):
    m = _build()
    for x, y in batches[:n_steps]:
        m.train_one_batch(x, y)
    return {k: v.detach().numpy().copy() for k, v in m.get_params().items()}


def _assert_params(m, want, label):
    got = m.get_params()
    assert sorted(got) == sorted(want), label
    for k, v in got.items():
        np.testing.assert_array_equal(v.detach().numpy(), want[k],
                                      err_msg=f"{label}: {k}")


def _quiet(**kw):
    return dict(restart_backoff_s=0.0, sleep=lambda s: None, **kw)


def test_supervisor_heals_crash_bitwise(tmp_path):
    n = 6
    batches = _batches(n)
    want = _ref_params(n, batches)
    res = Supervisor(_build, str(tmp_path), **_quiet(
        fault_hook=faults.crash_at(3))).run(batches)
    assert res["restarts"] == 1 and res["rollbacks"] == 0
    assert res["steps"] == n and len(res["losses"]) == n
    assert all(isinstance(v, float) for v in res["losses"])
    _assert_params(res["model"], want, "crash heal")
    assert counters.snapshot().get("restarts", 0) == 1


def test_supervisor_heals_hang_via_watchdog(tmp_path):
    n = 5
    batches = _batches(n)
    want = _ref_params(n, batches)
    res = Supervisor(_build, str(tmp_path), **_quiet(
        fault_hook=faults.stall_at(2, seconds=3600.0),
        step_timeout_s=3.0)).run(batches)
    assert res["hangs"] == 1 and res["restarts"] == 1
    assert res["steps"] == n
    _assert_params(res["model"], want, "hang heal")
    snap = counters.snapshot()
    assert snap.get("hangs", 0) == 1 and snap.get("restarts", 0) == 1


def test_supervisor_rolls_back_past_poisoned_batch(tmp_path):
    n = 6
    batches = _batches(n, constant=True)
    want = _ref_params(n - 1, batches)  # the shift oracle
    res = Supervisor(_build, str(tmp_path), **_quiet(
        fault_hook=faults.poison_batch_at(3, factor=1e4),
        spike_detector=SpikeDetector(window=8, zmax=6.0,
                                     min_history=2))).run(batches)
    assert res["rollbacks"] == 1 and res["restarts"] == 0
    assert res["skipped"] == [[3, 3]]
    assert res["steps"] == n - 1
    assert all(np.isfinite(v) for v in res["losses"])
    _assert_params(res["model"], want, "spike rollback")
    assert counters.snapshot().get("rollbacks", 0) == 1


def test_supervisor_counters_surface_in_fault_counters(tmp_path):
    res = Supervisor(_build, str(tmp_path), **_quiet(
        fault_hook=faults.poison_batch_at(2, factor=1e4),
        spike_detector=SpikeDetector(window=8, zmax=6.0, min_history=2))
    ).run(_batches(4, constant=True))
    c = res["model"].fault_counters
    assert c["rollbacks"] == 1 and c["restarts"] == 0
    assert c["hangs"] == 0 and c["nonfinite_skips"] == 0


def test_supervisor_restart_budget_is_bounded(tmp_path):
    delays = []
    sup = Supervisor(_build, str(tmp_path), max_restarts=2,
                     fault_hook=faults.crash_at(1, times=99),
                     restart_backoff_s=0.5, sleep=delays.append)
    with pytest.raises(RuntimeError, match="injected crash") as ei:
        sup.run(_batches(3))
    assert sup.restarts == 2
    assert delays == [0.5, 1.0]
    hist = ei.value.restart_history
    assert [h["restart"] for h in hist] == [1, 2]
    assert all("injected crash" in h["error"] for h in hist), hist
    assert [h["backoff_s"] for h in hist] == [0.5, 1.0]
    assert [h["step"] for h in hist] == [0, 1], hist


def test_supervisor_bounds_disk_and_refuses_foreign_checkpoint(tmp_path):
    res = Supervisor(_build, str(tmp_path), **_quiet(
        keep_checkpoints=2)).run(_batches(5))
    assert res["steps"] == 5
    dirs = [n for n in os.listdir(tmp_path) if n.startswith("step-")]
    assert len(dirs) <= 2, dirs

    foreign = str(tmp_path / "foreign")
    tm, to, x, y = ckpt_net(seed=0, hidden=5)
    tm.train_one_batch(x, y)
    resilience.save(foreign, tm, to, step=1)
    before = resilience.latest_step_dir(foreign)
    with pytest.raises(resilience.CheckpointError):
        Supervisor(_build, foreign, **_quiet()).run(_batches(2))
    assert resilience.latest_step_dir(foreign) == before


def test_supervisor_rollback_cursor_is_durable(tmp_path):
    n = 6
    batches = _batches(n, constant=True)
    want = _ref_params(n - 1, batches)
    crash = faults.crash_at(4)
    poison = faults.poison_batch_at(3, factor=1e4)

    def hook(step, batch):
        crash(step, batch)
        return poison(step, batch)

    res = Supervisor(_build, str(tmp_path), **_quiet(
        fault_hook=hook, spike_detector=SpikeDetector(
            window=8, zmax=6.0, min_history=2))).run(batches)
    assert res["rollbacks"] == 1 and res["restarts"] == 1
    assert res["skipped"] == [[3, 3]]
    assert poison.trips == 1, "the poisoned batch was fed again"
    assert res["steps"] == n - 1 and len(res["losses"]) == n - 1
    _assert_params(res["model"], want, "rollback+crash heal")


def test_supervisor_deterministic_error_fails_fast(tmp_path):
    def broken_hook(step, batch):
        raise TypeError("bad kwarg — identical on every attempt")

    sup = Supervisor(_build, str(tmp_path), **_quiet(
        fault_hook=broken_hook))
    with pytest.raises(TypeError, match="identical"):
        sup.run(_batches(2))
    assert sup.restarts == 0
    assert counters.snapshot().get("restarts", 0) == 0


def test_supervisor_async_save_heals_crash_bitwise(tmp_path):
    n = 5
    batches = _batches(n)
    want = _ref_params(n, batches)
    res = Supervisor(_build, str(tmp_path), **_quiet(
        fault_hook=faults.crash_at(2), async_save=True,
        checkpoint_every=2)).run(batches)
    assert res["restarts"] == 1 and res["steps"] == n
    _assert_params(res["model"], want, "async crash heal")
    assert resilience.latest_step_dir(str(tmp_path)).endswith(
        f"step-{n:08d}")


def test_supervisor_drops_the_failed_model_before_the_rebuild(tmp_path):
    """Nothing the supervisor holds keeps a failed model alive into the
    next build (on the card each holds a CUDA Graph and its pool)."""
    import weakref

    built = []

    def build():
        m = _build()
        if built:
            assert built[-1]() is None, "the failed model is still alive"
        built.append(weakref.ref(m))
        return m

    res = Supervisor(build, str(tmp_path), **_quiet(
        fault_hook=faults.stall_at(1, seconds=3600.0), step_timeout_s=2.0,
        max_restarts=3)).run(_batches(3))
    assert res["restarts"] == 1 and len(built) == 2


def test_supervisor_mesh_fn_at_world_1(tmp_path):
    """No group: the probe finds one rank, the mesh is (1, 1, 1), and a
    crash rebuilds onto the same extents (no reshape)."""
    seen = []

    def build(mesh):
        seen.append(dict(mesh.shape))
        m = _build()
        m.set_optimizer(opt.DistOpt(opt.SGD(lr=0.1, momentum=0.9),
                                    mesh=mesh, axis_name="data"))
        m.compile([_batches(1)[0][0]], is_train=True, use_graph=True)
        return m

    res = Supervisor(build, str(tmp_path), **_quiet(
        mesh_fn=default_mesh_fn(4), fault_hook=faults.crash_at(1))
    ).run(_batches(3))
    assert res["steps"] == 3 and res["restarts"] == 1
    assert res["reshapes"] == 0 and res["mesh_extents"] == (1, 1, 1)
    assert seen == [{"data": 1, "model": 1, "sp": 1}] * 2
    res = Supervisor(lambda: _build(), str(tmp_path / "none"),
                     **_quiet()).run(_batches(2))
    assert res["reshapes"] == 0 and res["mesh_extents"] is None
    assert counters.snapshot().get("reshapes", 0) == 0


# -- the heal span tree --------------------------------------------------------


def test_rollback_heal_span_tree(tmp_path):
    trace_file = str(tmp_path / "trace.jsonl")
    trace.enable(trace_file)
    try:
        res = Supervisor(_build, str(tmp_path / "ck"), **_quiet(
            fault_hook=faults.poison_batch_at(2, factor=1e4),
            spike_detector=SpikeDetector(window=8, zmax=6.0,
                                         min_history=2))
        ).run(_batches(5, constant=True))
    finally:
        trace.disable()
    assert res["rollbacks"] == 1 and res["skipped"] == [[2, 2]]
    events = trace.read_events(trace_file)
    rollbacks = trace.find_spans(events, "supervisor.rollback")
    assert len(rollbacks) == 1
    rb = rollbacks[0]
    assert rb["attrs"]["cause"] == "loss_spike" and rb["attrs"]["step"] == 2
    kids = sorted(e["name"] for e in events if e.get("parent") == rb["sid"])
    assert kids == ["anomaly.spike", "checkpoint.read", "checkpoint.write"]
    outside = [e for e in events if e["name"] == "checkpoint.write"
               and e.get("parent") is None]
    assert len(outside) >= 4
    assert all(e["dur_s"] >= 0.0 for e in events)


def test_restart_heal_span_nests_the_restore(tmp_path):
    trace_file = str(tmp_path / "trace.jsonl")
    trace.enable(trace_file)
    try:
        Supervisor(_build, str(tmp_path / "ck"), **_quiet(
            fault_hook=faults.crash_at(2))).run(_batches(3))
    finally:
        trace.disable()
    events = trace.read_events(trace_file)
    heal, = trace.find_spans(events, "supervisor.restart")
    assert heal["attrs"]["cause"] == "RuntimeError"
    assert heal["attrs"]["restored_step"] == 2
    kids = [e["name"] for e in events if e.get("parent") == heal["sid"]]
    assert kids == ["checkpoint.read"]
    json.dumps(heal)  # the attributes are plain values, no model


# -- parity with the reference's supervisor ----------------------------------


def _parity_data():
    rng = np.random.default_rng(21)
    w1 = (rng.standard_normal((12, 16)) * 0.3).astype(np.float32)
    b1 = (rng.standard_normal(16) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((16, 4)) * 0.3).astype(np.float32)
    b2 = (rng.standard_normal(4) * 0.1).astype(np.float32)
    xs = [rng.standard_normal((8, 12)).astype(np.float32) for _ in range(6)]
    y = (np.arange(8) % 4).astype(np.int32)
    return dict(w=(w1, b1, w2, b2), xs=xs, y=y)


PARITY_CASES = ("crash", "poison", "crash_then_poison")


def _parity_hook(case, faults_module):
    if case == "crash":
        return faults_module.crash_at(2)
    if case == "poison":
        return faults_module.poison_batch_at(2, factor=1e4)
    crash = faults_module.crash_at(2)
    poison = faults_module.poison_batch_at(2, factor=1e4)

    def hook(step, batch):
        crash(step, batch)
        return poison(step, batch)

    return hook


def _summary(res):
    return {k: res[k] for k in ("steps", "restarts", "rollbacks", "skipped",
                                "hangs", "losses")}


def reference_side(data, base):
    """The reference's supervised MLP under each parity case."""
    from singa_tpu import autograd as rautograd
    from singa_tpu import layer as rlayer, model as rmodel, opt as ropt
    from singa_tpu.resilience import SpikeDetector as RDet
    from singa_tpu.resilience import Supervisor as RSup
    from singa_tpu.resilience import faults as rfaults
    from singa_tpu.tensor import from_numpy

    class RNet(rmodel.Model):
        def __init__(self):
            super().__init__()
            self.fc1 = rlayer.Linear(16)
            self.act = rlayer.ReLU()
            self.fc2 = rlayer.Linear(4)

        def forward(self, x):
            return self.fc2(self.act(self.fc1(x)))

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = rautograd.softmax_cross_entropy(out, y)
            self.optimizer(loss)
            return out, loss

    batches = [(from_numpy(x), from_numpy(data["y"])) for x in data["xs"]]
    w1, b1, w2, b2 = data["w"]

    def build():
        m = RNet()
        m.set_optimizer(ropt.SGD(lr=0.1, momentum=0.9))
        m.compile([batches[0][0]], is_train=True, use_graph=True)
        m.set_states({"fc1.W": w1, "fc1.b": b1, "fc2.W": w2, "fc2.b": b2})
        return m

    out = {}
    for case in PARITY_CASES:
        res = RSup(build, os.path.join(base, case),
                   fault_hook=_parity_hook(case, rfaults),
                   spike_detector=RDet(window=8, zmax=6.0, min_history=2),
                   restart_backoff_s=0.0, sleep=lambda s: None).run(batches)
        out[case] = _summary(res)
    return out


@pytest.fixture(scope="module")
def world2_and_reference(tmp_path_factory):
    base = tmp_path_factory.mktemp("ref_sup")
    return run_both(
        ("test_torch_supervisor", "reference_side",
         tmp_path_factory.mktemp("reference"),
         dict(data=_parity_data(), base=str(base))),
        (_rank_supervisor_mesh, 2, tmp_path_factory.mktemp("ranks"),
         dict(directory=str(tmp_path_factory.mktemp("mesh")), steps=4)))


@pytest.mark.parametrize("case", PARITY_CASES)
def test_supervisor_parity_with_the_reference(case, world2_and_reference,
                                              tmp_path):
    ref = world2_and_reference[0][case]
    data = _parity_data()
    batches = [(torch.from_numpy(x), torch.from_numpy(data["y"]).long())
               for x in data["xs"]]
    w1, b1, w2, b2 = data["w"]

    def build():
        m = ckpt_net(seed=0, optimizer="sgd")[0]
        m.compile([batches[0][0]], is_train=True, use_graph=True)
        m.set_states({"fc1.W": w1, "fc1.b": b1, "fc2.W": w2, "fc2.b": b2})
        return m

    got = _summary(Supervisor(build, str(tmp_path), **_quiet(
        fault_hook=_parity_hook(case, faults),
        spike_detector=SpikeDetector(window=8, zmax=6.0, min_history=2))
    ).run(batches))
    for k in ("steps", "restarts", "rollbacks", "skipped", "hangs"):
        assert got[k] == ref[k], (case, k, got[k], ref[k])
    np.testing.assert_allclose(got["losses"], ref["losses"],
                               rtol=PARITY_TOL, atol=PARITY_TOL)


# -- the mesh hook over two ranks --------------------------------------------


def test_supervisor_mesh_fn_over_two_ranks(world2_and_reference):
    for r, got in enumerate(world2_and_reference[1]):
        assert got["probe"] == [0, 1]
        d = got["default"]
        assert d["steps"] == 4 and d["restarts"] == 1
        assert d["reshapes"] == 0 and d["mesh_extents"] == (2, 1, 1)
        assert d["losses"] == got["plain"]["losses"], r
        for k, v in got["plain"]["params"].items():
            np.testing.assert_array_equal(d["params"][k], v,
                                          err_msg=f"rank {r}: {k}")
        f = got["fold"]
        assert f["probes"] == [2, 2]
        assert f["steps"] == 4 and f["restarts"] == 1
        assert f["reshapes"] == 1 and f["mesh_extents"] == (1, 2, 1)
        assert f["mesh"] == {"data": 1, "model": 2, "sp": 1}
        assert f["fault_counters"]["reshapes"] == 1
        assert f["losses"][:2] == got["plain"]["losses"][:2]
        assert all(np.isfinite(f["losses"]))
        assert "smaller SINGA_FLEET_WORLD" in got["shrink"], got["shrink"]
