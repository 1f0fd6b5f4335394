"""The port's replica router (singa_tpu_torch.serving.router) against
the oracles of tests/test_serving_router.py and
test_serving_router_proc.py, on the small random GPT of the serving
tests (vocab 61, d 48, 2 scanned blocks, window 64) whose seeded weights
both packages carry.

- Routed greedy and sampled streams equal one engine's (greedy: the
  reference's `generate`; sampled: the port's own, its noise being its
  own); affinity beats round-robin on engine-verified prefix hits; the
  chunked schedulers share one deficit table; a replica killed
  mid-stream reroutes with identical tokens, each delivered once; the
  quorum judgment, and refusal when every replica is dead; the parallel
  pump equals the serial one.
- A `ProcessReplica` child started through the port's own entry
  (``python -m singa_tpu_torch.serving.router --spool DIR --device
  cpu``) serves spooled streams equal to the in-process model's; a
  stale heartbeat drains a process replica onto an in-process survivor.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from singa_tpu_torch.examples.serve_gpt import seeded_weights
from singa_tpu_torch.model import load_singa_tpu_params
from singa_tpu_torch.models.gpt import GPT
from singa_tpu_torch.serving import (
    ProcessReplica, ReplicaRouter, ServingEngine)
from tests.helper_torch_parity import serving_gpt_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_VOCAB = 61
_W = 64


@pytest.fixture(scope="module")
def pair():
    return serving_gpt_pair(vocab=_VOCAB, max_len=_W)


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


_GENERATED = {}


def _ref(pair, prompt, n_new, temperature=0.0, seed=0):
    """Greedy: the REFERENCE's solo `generate` (memoized), held against
    the port's. Sampled: the port's own `generate`."""
    ref_model, port = pair
    ours = port.generate(prompt, n_new, window=_W, temperature=temperature,
                         seed=seed)[0, len(prompt):]
    if temperature > 0:
        return ours
    key = (np.asarray(prompt, np.int32).tobytes(), n_new)
    if key not in _GENERATED:
        _GENERATED[key] = np.asarray(ref_model.generate(
            prompt, n_new=n_new, window=_W)[0, len(prompt):], np.int32)
        np.testing.assert_array_equal(ours, _GENERATED[key])
    return _GENERATED[key]


def _prompt(rng, n, vocab=_VOCAB):
    return rng.integers(0, vocab, size=n).astype(np.int32)


def _engines(model, n, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("block_size", 16)
    kw.setdefault("window", _W)
    return [ServingEngine(model, **kw) for _ in range(n)]


def _tokens(h):
    return np.asarray(h.tokens, np.int32)


def test_routed_streams_match_single_engine_greedy_and_sampled(pair,
                                                               model):
    rng = np.random.default_rng(0)
    engines = _engines(model, 2)
    router = ReplicaRouter(engines)
    specs, handles = [], []
    for r in range(6):
        p = _prompt(rng, 5 + 7 * r)
        temp = 0.0 if r % 2 == 0 else 0.8
        specs.append((p, 6 + r, temp, 10 + r))
        handles.append(router.submit(p, 6 + r, temperature=temp,
                                     seed=10 + r))
    report = router.run()
    router.close()
    assert sorted(report["completed"]) == [h.rid for h in handles]
    assert not report["drained"]
    for (p, n_new, temp, seed), h in zip(specs, handles):
        assert h.status == "done"
        np.testing.assert_array_equal(
            _tokens(h), _ref(pair, p, n_new, temperature=temp, seed=seed))
    assert all(eng.decode_compiles == 1 for eng in engines)
    assert router.stats["dispatches"] == 6
    assert router.stats["replica_deaths"] == 0
    assert all(eng.tokens_emitted > 0 for eng in engines)


def test_affinity_routing_raises_prefix_hits_vs_round_robin(pair, model):
    def serve(affinity):
        rng = np.random.default_rng(7)
        shared = [_prompt(rng, 32) for _ in range(2)]
        engines = _engines(model, 2, prefix_cache=True)
        router = ReplicaRouter(engines, affinity=affinity,
                               affinity_weight=4.0, parallel_pump=False)
        for p in shared:
            router.submit(p, 4)
        router.run()
        prompts = [np.concatenate([shared[i // 4], _prompt(rng, 4)])
                   for i in range(8)]
        handles = [router.submit(p, 4) for p in prompts]
        router.run()
        for p, h in zip(prompts, handles):
            assert h.status == "done"
            np.testing.assert_array_equal(_tokens(h), _ref(pair, p, 4))
        return sum(e.prefix_hits for e in engines), dict(router.stats)

    hits_on, stats_on = serve(True)
    hits_off, stats_off = serve(False)
    assert hits_on > hits_off
    assert stats_on["affinity_hits"] > 0
    assert stats_off["affinity_hits"] == 0


def test_chunked_sched_replicas_share_one_deficit_table(pair, model):
    rng = np.random.default_rng(3)
    engines = _engines(model, 2)
    router = ReplicaRouter(engines, sched="chunked", parallel_pump=False)
    scheds = [rep.backend.sched for rep in router.replicas]
    assert all(s is not None for s in scheds)
    assert all(s._served is router.shared_accounts for s in scheds)
    specs, handles = [], []
    for r in range(6):
        p = _prompt(rng, 6 + 5 * r)
        specs.append(p)
        handles.append(router.submit(p, 6, tenant=f"t{r % 3}",
                                     priority="normal"))
    router.run()
    for p, h in zip(specs, handles):
        assert h.status == "done"
        np.testing.assert_array_equal(_tokens(h), _ref(pair, p, 6))
    assert set(router.shared_accounts) == {"t0", "t1", "t2"}
    assert sum(s.lane_picks["normal"] for s in scheds) == 6
    assert all(s.tenant_deficit() == scheds[0].tenant_deficit()
               for s in scheds)


def test_replica_kill_mid_stream_reroutes_token_identically(pair, model):
    rng = np.random.default_rng(11)
    engines = _engines(model, 2)
    router = ReplicaRouter(engines, parallel_pump=False)
    prompts = [_prompt(rng, 8) for _ in range(4)]
    seen = {i: [] for i in range(4)}
    state = {"n": 0}

    def cb(i):
        def _cb(tok, done):
            seen[i].append(tok)
            state["n"] += 1
            if state["n"] == 6:
                router.kill_replica(0)
        return _cb

    handles = [router.submit(p, 12, on_token=cb(i))
               for i, p in enumerate(prompts)]
    router.run()
    assert router.stats["replica_deaths"] == 1
    assert router.stats["requeued"] > 0
    assert router.stats["dispatches"] == 4 + router.stats["requeued"]
    rerouted = 0
    for i, (p, h) in enumerate(zip(prompts, handles)):
        assert h.status == "done"
        want = _ref(pair, p, 12)
        np.testing.assert_array_equal(_tokens(h), want)
        # the callback saw each token exactly once, in order
        np.testing.assert_array_equal(np.asarray(seen[i], np.int32), want)
        if h.attempts > 1:
            rerouted += 1
            assert h.replica == "r1"
    assert rerouted == router.stats["requeued"]
    assert engines[1].decode_compiles == 1


def test_healthz_quorum_flips_on_replica_death(model):
    router = ReplicaRouter(_engines(model, 2))
    h = router.healthz()
    assert h["status"] == "ok" and h["live"] == 2 and h["quorum"] == 2
    assert set(h["replica_health"]) == {"r0", "r1"}
    for payload in h["replica_health"].values():
        assert payload["alive"] and payload["status"] == "ok"
        assert payload["slots"] == 2 and payload["free_slots"] == 2
    router.kill_replica("r1")
    h = router.healthz()
    assert h["status"] == "degraded" and h["live"] == 1
    assert h["replica_health"]["r1"]["alive"] is False
    router.revive_replica("r1")
    h = router.healthz()
    assert h["status"] == "ok" and h["live"] == 2


def test_all_replicas_dead_refuses_loudly(model):
    router = ReplicaRouter(_engines(model, 1))
    router.submit(_prompt(np.random.default_rng(13), 6), 4)
    router.kill_replica(0)
    with pytest.raises(RuntimeError, match="replicas are dead"):
        router.run()


def test_parallel_pump_matches_serial(pair, model):
    rng = np.random.default_rng(17)
    specs = [(_prompt(rng, 5 + 6 * r), 5 + r) for r in range(5)]
    outs = []
    for par in (False, True):
        router = ReplicaRouter(_engines(model, 2), parallel_pump=par)
        assert router.parallel_pump is par
        handles = [router.submit(p, n) for p, n in specs]
        router.run()
        router.close()
        assert all(h.status == "done" for h in handles)
        outs.append([tuple(h.tokens) for h in handles])
    assert outs[0] == outs[1]
    for (p, n), toks in zip(specs, outs[1]):
        np.testing.assert_array_equal(np.asarray(toks, np.int32),
                                      _ref(pair, p, n))


# -- process replicas through the port's spool-server entry -------------------

_PVOCAB, _PW = 31, 32


@pytest.fixture(scope="module")
def spool_model():
    """The spool server's small GPT, rebuilt in-process with the same
    seeded weights."""
    m = GPT(vocab_size=_PVOCAB, d_model=32, num_layers=1, num_heads=2,
            max_len=_PW, dropout=0.0, scan_blocks=True, device="cpu")
    load_singa_tpu_params(m, seeded_weights(m, 0))
    m.eval()
    return m


def test_process_replica_serves_spooled_streams(spool_model, tmp_path):
    spool = tmp_path / "r0"
    rep = ProcessReplica(str(spool), block_size=8, stale_after_s=60.0)
    router = ReplicaRouter([rep])
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "singa_tpu_torch.serving.router",
         "--spool", str(spool), "--device", "cpu"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        rng = np.random.default_rng(0)
        prompts = [_prompt(rng, 4 + 3 * i, _PVOCAB) for i in range(3)]
        handles = [router.submit(p, 6) for p in prompts]
        t0 = time.monotonic()
        while (not all(h.done for h in handles)
               and time.monotonic() - t0 < 90.0):
            router.pump()
            time.sleep(0.05)
        for p, h in zip(prompts, handles):
            assert h.status == "done", (h.rid, h.status, h.error)
            np.testing.assert_array_equal(
                _tokens(h),
                spool_model.generate(p, 6, window=_PW)[0, len(p):])
        assert len({tuple(h.tokens) for h in handles}) > 1
        st = rep.status()
        assert st.get("decode_compiles") == 1, st
        assert st.get("slots") == 2
        assert router.healthz()["status"] == "ok"
        rep.stop()
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
        assert "3 streams served" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_stale_heartbeat_drains_process_replica(spool_model, tmp_path):
    spool = tmp_path / "r0"
    spool.mkdir()
    hb = spool / "heartbeat"
    hb.write_text("")  # a server that beat once, then died
    os.utime(hb, (0, 0))
    rep = ProcessReplica(str(spool), block_size=8, stale_after_s=5.0)
    survivor = ServingEngine(spool_model, slots=2, block_size=8,
                             window=_PW)
    router = ReplicaRouter([rep, survivor], quorum=1, parallel_pump=False)
    rng = np.random.default_rng(1)
    prompts = [_prompt(rng, 5, _PVOCAB) for _ in range(2)]
    handles = [router.submit(p, 6) for p in prompts]
    router._dispatch_one(router._queue.popleft())  # onto the dead one
    assert router.run()["completed"]
    assert router.stats["replica_deaths"] == 1
    assert router.healthz()["replica_health"]["r0"]["alive"] is False
    for p, h in zip(prompts, handles):
        assert h.status == "done", (h.rid, h.status, h.error)
        np.testing.assert_array_equal(
            _tokens(h), spool_model.generate(p, 6, window=_PW)[0, len(p):])
    assert survivor.decode_compiles == 1
