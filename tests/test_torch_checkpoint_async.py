"""The port's async saves (`resilience.save(async_=True)`), the oracles
of tests/test_resilience_async.py on the port:

- the snapshot is complete when `save` returns: steps that update the
  model in place right after it leave the committed files equal to a
  sync save of the same step (same files, bytes, crcs);
- at most one commit is in flight a directory: an async save drains its
  predecessor before its snapshot (a slowed store shows it), a sync
  save and `wait_pending` drain the queue, and `prune` never deletes
  the step dir a commit is writing;
- a failed background commit bumps `ckpt_async_failures`, re-raises
  from `result()`, and leaves the previous checkpoint committed;
- the counters (`saves`, `restores`, `ckpt_async_saves`) and the spans
  (`checkpoint.snapshot`, `checkpoint.commit_async`, `checkpoint.write`,
  `checkpoint.read`).
"""

import json
import threading
import uuid

import numpy as np
import pytest

from helper_torch_parity import ckpt_net, ckpt_state
from singa_tpu_torch import resilience, storage
from singa_tpu_torch.observability import trace
from singa_tpu_torch.resilience import checkpoint as ckpt
from singa_tpu_torch.resilience import counters
from singa_tpu_torch.storage import ObjectStoreDriver


def files(step_dir):
    """{file: bytes} of a step dir, and its manifest's leaf table."""
    drv = storage.get_driver(step_dir)
    man = json.loads(drv.read(storage.join(step_dir, ckpt.MANIFEST)))
    return ({n: drv.read(storage.join(step_dir, n))
             for n in drv.list(step_dir) if n.endswith(".bin")},
            man["leaves"])


def test_an_async_save_equals_the_sync_save_under_later_steps(tmp_path):
    m, o, x, y = ckpt_net()
    for _ in range(2):
        m.train_one_batch(x, y)
    want = ckpt_state(m, o)
    sync_dir = resilience.save(str(tmp_path / "sync"), m, o, step=2)
    handle = resilience.save(str(tmp_path / "async"), m, o, step=2,
                             async_=True)
    for _ in range(3):  # in place, while the commit may still run
        m.train_one_batch(x, y)
    async_dir = handle.result(timeout=60)
    assert handle.done and async_dir.endswith("step-00000002")
    assert files(async_dir) == files(sync_dir)
    m2, o2, _, _ = ckpt_net(seed=1)
    resilience.restore(str(tmp_path / "async"), m2, o2)
    got = ckpt_state(m2, o2)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture
def slow_scheme():
    """A `slow://` object store whose every put sleeps 0.05 s."""
    drv = ObjectStoreDriver()
    drv.put_delay_s = 0.05
    storage.register_scheme("slow://", drv)
    yield drv
    del storage._SCHEMES["slow://"]


def test_at_most_one_commit_in_flight(slow_scheme):
    d = f"slow://b-{uuid.uuid4().hex[:8]}/ck"
    m, o, x, y = ckpt_net()
    m.train_one_batch(x, y)
    first = resilience.save(d, m, o, step=1, async_=True)
    assert not first.done
    # the step dir being written is in flight: prune leaves it
    assert ckpt._inflight_names(d) == {"step-00000001"}
    assert resilience.prune(d, keep=1) == []
    second = resilience.save(d, m, o, step=2, async_=True)
    # the second snapshot waited for the first commit
    assert first.done and first.result().endswith("step-00000001")
    assert ckpt._pending[ckpt._dir_key(d)] is second
    assert not resilience.wait_pending(d, timeout=0.01)
    assert resilience.wait_pending(d, timeout=60)
    assert second.result().endswith("step-00000002")
    assert ckpt._dir_key(d) not in ckpt._pending
    # a sync save drains an async one first
    third = resilience.save(d, m, o, step=3, async_=True)
    resilience.save(d, m, o, step=4)
    assert third.done
    assert resilience.latest_step_dir(d).endswith("step-00000004")
    slow_scheme.delete_prefix(d)


class _FailingShards(ObjectStoreDriver):
    """An object store that refuses shard files once `fail` is set."""

    fail = False

    def put_atomic(self, path, data):
        if self.fail and path.endswith(".bin"):
            raise OSError(f"injected write failure: {path}")
        super().put_atomic(path, data)


def test_a_failed_background_commit_reraises_and_counts():
    drv = _FailingShards()
    storage.register_scheme("failing://", drv)
    try:
        d = "failing://b/ck"
        m, o, x, y = ckpt_net()
        m.train_one_batch(x, y)
        first = resilience.save(d, m, o, step=1)
        before = counters.snapshot()
        drv.fail = True
        handle = resilience.save(d, m, o, step=2, async_=True)
        with pytest.raises(OSError, match="injected write failure"):
            handle.result(timeout=60)
        after = counters.snapshot()
        assert after.get("ckpt_async_failures", 0) == before.get(
            "ckpt_async_failures", 0) + 1
        assert after.get("ckpt_async_saves", 0) == before.get(
            "ckpt_async_saves", 0)
        assert resilience.latest_step_dir(d) == first
        drv.fail = False
        assert resilience.restore(d, m, o)["step"] == 1
    finally:
        del storage._SCHEMES["failing://"]


def test_a_result_timeout_raises_torn():
    drv = ObjectStoreDriver()
    drv.put_delay_s = 0.05
    storage.register_scheme("slower://", drv)
    try:
        m, o, x, y = ckpt_net()
        h = resilience.save("slower://b/ck", m, o, step=1, async_=True)
        with pytest.raises(resilience.TornSaveError, match="still"):
            h.result(timeout=0.01)
        assert h.result(timeout=60).endswith("step-00000001")
    finally:
        del storage._SCHEMES["slower://"]


def test_counters_and_spans(tmp_path):
    m, o, x, y = ckpt_net()
    m.train_one_batch(x, y)
    before = counters.snapshot()
    base = str(tmp_path / "trace.jsonl")
    trace.enable(base)
    try:
        resilience.save(str(tmp_path / "a"), m, o, step=1)
        resilience.save(str(tmp_path / "a"), m, o, step=2,
                        async_=True).result(timeout=60)
        resilience.restore(str(tmp_path / "a"), m, o)
    finally:
        trace.disable()
    after = counters.snapshot()
    for key in ("saves", "restores", "ckpt_async_saves"):
        assert after.get(key, 0) - before.get(key, 0) == (
            2 if key == "saves" else 1), key
    events = trace.read_events(base)
    for name in ("checkpoint.write", "checkpoint.snapshot",
                 "checkpoint.commit_async", "checkpoint.read"):
        assert trace.find_spans(events, name), name


def test_the_snapshot_is_taken_on_the_callers_thread(tmp_path):
    """The phase hook's "snapshot" fires on the caller's thread and every
    later phase on the background commit thread."""
    m, o, x, y = ckpt_net()
    seen = []
    ckpt._phase_hook = lambda p: seen.append((p, threading.get_ident()))
    try:
        resilience.save(str(tmp_path), m, o, step=1,
                        async_=True).result(timeout=60)
    finally:
        ckpt._phase_hook = None
    me = threading.get_ident()
    assert [p for p, _ in seen] == ["snapshot", "shard_writes", "manifest"]
    assert seen[0][1] == me and all(t != me for _, t in seen[1:])
