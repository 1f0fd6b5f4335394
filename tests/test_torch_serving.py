"""The port's serving engine (singa_tpu_torch.serving) against the
reference's (singa_tpu.serving) and the port's own `generate`.

Mirrors tests/test_serving.py on a small random GPT (vocab 61, d 48,
2 scanned blocks, 4 heads, window 64) whose seeded weights both
packages carry:

- TOKEN IDENTITY: under staggered admits/evicts and fragmented block
  tables, every greedy stream equals the reference engine's stream and
  the port's solo `generate(use_cache=True)`; sampled streams equal the
  port's solo `generate` (the port's counter-based noise is its own, so
  sampled tokens are not compared across packages), and a row's sample
  does not depend on its batch;
- one decode step serves every interleaving (`decode_compiles == 1`);
- the refusals carry the reference's messages.
"""

import numpy as np
import pytest
import torch

from singa_tpu.serving import Request as JaxRequest
from singa_tpu.serving import ServingEngine as JaxEngine
from singa_tpu_torch.models.gpt import gumbel_noise, pick_rows
from singa_tpu_torch.serving import (
    BlockAllocator, OutOfBlocksError, OutOfSlotsError, Request,
    ServingEngine, blocks_needed)
from tests.helper_torch_parity import serving_gpt_pair

_VOCAB = 61
_W = 64


@pytest.fixture(scope="module")
def pair():
    return serving_gpt_pair(vocab=_VOCAB, max_len=_W)


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


def _prompt(rng, n):
    return rng.integers(0, _VOCAB, size=n).astype(np.int32)


def _ref(model, prompt, n_new, temperature=0.0, seed=0):
    """The oracle: the port's solo cached decode, generated suffix."""
    out = model.generate(prompt, n_new=n_new, window=_W,
                         temperature=temperature, seed=seed)
    return out[0, len(prompt):]


def _staggered(eng, make_request, rng):
    """The reference's fragmentation scenario: 5 requests, admits at
    staggered steps, a mid-run cancel whose freed blocks the next
    admissions reuse."""
    spec = {"a": (5, 20), "b": (30, 16), "c": (37, 20), "d": (12, 8),
            "e": (22, 10)}
    reqs = {rid: make_request(rid, _prompt(rng, n), m)
            for rid, (n, m) in spec.items()}
    eng.admit(reqs["a"])
    eng.admit(reqs["b"])
    for _ in range(3):
        eng.step()
    eng.admit(reqs["c"])            # admitted mid-flight
    for _ in range(4):
        eng.step()
    eng.cancel("b")                 # evict mid-flight: blocks fragment
    eng.admit(reqs["d"])            # reuses b's freed blocks
    eng.admit(reqs["e"])
    while eng.n_active:
        eng.step()
    return reqs


@pytest.mark.parametrize("block_size", [16, 64])
def test_greedy_streams_match_reference_engine_and_generate(pair,
                                                            block_size):
    ref_model, model = pair
    ours = _staggered(ServingEngine(model, slots=4, block_size=block_size,
                                    window=_W),
                      Request, np.random.default_rng(7))
    jax_eng = JaxEngine(ref_model, slots=4, block_size=block_size,
                        window=_W)
    theirs = _staggered(jax_eng, JaxRequest, np.random.default_rng(7))
    assert jax_eng.decode_compiles == 1
    for rid, req in ours.items():
        got = np.asarray(req.tokens, np.int32)
        np.testing.assert_array_equal(
            got, np.asarray(theirs[rid].tokens, np.int32),
            err_msg=f"request {rid} diverged from the reference engine")
        want = _ref(model, req.prompt, req.max_new)
        np.testing.assert_array_equal(got, want[:got.size],
                                      err_msg=f"request {rid} vs generate")
        assert got.size == (8 if rid == "b" else req.max_new)


def test_decode_builds_once_across_admits_and_evicts(model):
    """One build across the whole interleaving; the occupancy and
    utilisation probes read the host state, and drain to 0."""
    eng = ServingEngine(model, slots=4, block_size=16, window=_W)
    assert eng.decode_compiles == 1
    rng = np.random.default_rng(8)
    eng.admit_many([Request(0, _prompt(rng, 20), 12),
                    Request(1, _prompt(rng, 5), 8)])
    assert eng.slot_occupancy == 0.5 and eng.free_slots == 2
    assert eng.kv_utilization == 3 / 16  # 2 + 1 of 16 blocks, +1 trash
    while eng.n_active:
        eng.step()
    _staggered(eng, Request, rng)
    assert eng.decode_compiles == 1
    assert eng.allocator.used_blocks == 0 and eng.n_active == 0
    assert eng.slot_occupancy == 0.0 and eng.kv_utilization == 0.0


def test_fragmented_page_table_is_actually_fragmented(model):
    rng = np.random.default_rng(3)
    eng = ServingEngine(model, slots=3, block_size=16, window=_W,
                        num_blocks=7)  # 6 allocatable
    a = Request("a", _prompt(rng, 5), 20)    # 2 blocks
    b = Request("b", _prompt(rng, 20), 20)   # 3 blocks
    eng.admit(a)
    eng.admit(b)
    for _ in range(2):
        eng.step()
    eng.cancel("a")
    c = Request("c", _prompt(rng, 30), 4)    # 3 blocks: a's 2 + 1 new
    eng.admit(c)
    row = eng.page_table[[s for s, r in enumerate(eng._reqs)
                          if r is c][0]]
    used = row[row > 0]
    assert not np.array_equal(used, np.sort(used)) or \
        (used.max() - used.min() >= len(used)), (
            f"page table row {row} is contiguous")
    while eng.n_active:
        eng.step()
    np.testing.assert_array_equal(
        np.asarray(c.tokens, np.int32), _ref(model, c.prompt, 4))
    np.testing.assert_array_equal(
        np.asarray(b.tokens, np.int32), _ref(model, b.prompt, 20))


def test_sampled_streams_match_generate(model):
    """A sampled stream beside a greedy one and another sampled one with
    its own seed and temperature: each equals its solo `generate`."""
    rng = np.random.default_rng(11)
    eng = ServingEngine(model, slots=3, block_size=16, window=_W)
    r = Request("s", _prompt(rng, 9), 14, temperature=0.8, seed=5)
    r2 = Request("g", _prompt(rng, 17), 14)
    r3 = Request("t", _prompt(rng, 4), 20, temperature=1.3, seed=9)
    eng.admit_many([r, r2, r3])
    while eng.n_active:
        eng.step()
    for q in (r, r2, r3):
        np.testing.assert_array_equal(
            np.asarray(q.tokens, np.int32),
            _ref(model, q.prompt, q.max_new, q.temperature, q.seed),
            err_msg=str(q.rid))
    assert len(set(r.tokens)) > 1


def test_a_rows_sample_does_not_depend_on_its_batch():
    """pick_rows: a row's sample is a function of (seed, index, logits)
    alone, whatever rows share the batch; greedy rows are argmax; the
    noise is standard Gumbel."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((5, 40)).astype(
        np.float32))
    seeds = torch.tensor([3, 3, 7, 11, 3])
    index = torch.tensor([0, 1, 0, 4, 0])
    temps = torch.tensor([0.8, 0.8, 1.0, 0.5, 0.8])
    sample = torch.tensor([True, True, True, True, False])
    batch = pick_rows(logits, seeds, index, temps, sample)
    for i in range(5):
        one = pick_rows(logits[i:i + 1], seeds[i:i + 1], index[i:i + 1],
                        temps[i:i + 1], sample[i:i + 1])
        assert int(one) == int(batch[i])
    assert int(batch[4]) == int(logits[4].argmax())
    g = gumbel_noise(torch.tensor([1]), torch.tensor([2]), 200000)
    assert abs(float(g.mean()) - 0.5772) < 0.01   # Euler's constant
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.03
    other = gumbel_noise(torch.tensor([1]), torch.tensor([3]), 200000)
    assert not torch.equal(g, other)


def test_scan_stack_and_batched_prefill_serve(model):
    rng = np.random.default_rng(5)
    eng = ServingEngine(model, slots=3, block_size=16, window=_W,
                        prefill_batch=2)
    reqs = [Request(i, _prompt(rng, 6 + 11 * i), 10) for i in range(3)]
    eng.admit_many(reqs)
    while eng.n_active:
        eng.step()
    for req in reqs:
        np.testing.assert_array_equal(
            np.asarray(req.tokens, np.int32), _ref(model, req.prompt, 10))
    assert eng.decode_compiles == 1


# -- refusals ----------------------------------------------------------------


def test_out_of_blocks_refusal_names_capacity_math(model):
    eng = ServingEngine(model, slots=4, block_size=16, window=_W,
                        num_blocks=5)  # 4 allocatable
    rng = np.random.default_rng(1)
    eng.admit(Request("a", _prompt(rng, 20), 20))  # 3 blocks
    with pytest.raises(OutOfBlocksError,
                       match=r"needs 3 blocks.*48 token rows.*"
                             r"block_size=16.*1 of 4 allocatable.*"
                             r"3 held by in-flight"):
        eng.admit(Request("b", _prompt(rng, 30), 10))
    eng.cancel("a")
    eng.admit(Request("b", _prompt(rng, 30), 10))


def test_out_of_slots_refusal(model):
    eng = ServingEngine(model, slots=1, block_size=16, window=_W)
    rng = np.random.default_rng(2)
    eng.admit(Request("a", _prompt(rng, 4), 4))
    with pytest.raises(OutOfSlotsError, match="1 decode slots"):
        eng.admit(Request("b", _prompt(rng, 4), 4))


def test_over_window_request_refused_by_name(model):
    eng = ServingEngine(model, slots=1, block_size=16, window=_W)
    with pytest.raises(ValueError, match="sliding|window"):
        eng.admit(Request("a", np.zeros(40, np.int32), 40))


def test_window_must_divide_into_blocks(model):
    with pytest.raises(ValueError, match="multiple of block_size"):
        ServingEngine(model, slots=1, block_size=24, window=_W)


def _mesh_refusals():
    from singa_tpu_torch.parallel.mesh import Mesh, get_mesh

    model1 = get_mesh((1,), ("model",))
    data1 = get_mesh((1,), ("data",))
    # the layout of a 2-rank prefill mesh, as a rank outside it holds it
    data2 = Mesh(None, ("data",), axis_groups={"data": None}, ranks=(0, 1),
                 dims=(2,), member=False)
    return [
        (dict(mesh=model1), "needs tp_axis"),
        (dict(mesh=model1, tp_axis="nope"), "not on the mesh"),
        (dict(prefill_mesh=data1, prefill_axis="nope"),
         "not on the prefill mesh"),
        (dict(prefill_mesh=data2), "does not divide over the prefill mesh "
                                   "axis 'data' \\(extent 2\\)"),
    ]


@pytest.mark.parametrize("case", _mesh_refusals(),
                         ids=[f"kw{i}" for i in range(4)])
def test_mesh_options_raise_naming_the_roadmap(model, case):
    """The decode and prefill mesh options refuse what they cannot
    serve, naming the cause with the reference's words (they raised
    naming ROADMAP items before the prefill mesh was ported)."""
    kw, match = case
    with pytest.raises(ValueError, match=match):
        ServingEngine(model, slots=1, window=_W, **kw)


def test_allocator_math_and_fragmented_reuse():
    assert blocks_needed(5, 20, 16) == 2
    assert blocks_needed(37, 27, 16) == 4
    assert blocks_needed(1, 63, 64) == 1
    alloc = BlockAllocator(num_blocks=6, block_size=16)
    a = alloc.alloc("a", 2)
    b = alloc.alloc("b", 3)
    assert alloc.free_blocks == 0
    assert set(a) | set(b) == {1, 2, 3, 4, 5}  # block 0 never granted
    alloc.free("a")
    c = alloc.alloc("c", 2)
    assert set(c) == set(a)  # LIFO reuse: exactly the freed blocks
    with pytest.raises(OutOfBlocksError, match="needs 1 blocks"):
        alloc.alloc("d", 1)
    assert alloc.free("unknown") == 0  # idempotent eviction


def test_serve_example_streams_every_request(capsys, monkeypatch):
    """The example server on the CPU: every request is served to
    max_new through on_token (the Frontend's handles), one decode
    build; `--metrics-port 0` prints its URL and a scrape after the
    serve answers 200 with the serving gauges; `--tp 2 --draft tiny`
    (the sharded speculative round, rank 1 spawned over gloo) streams
    what `--draft tiny` alone does."""
    import re
    import urllib.request

    from singa_tpu_torch.examples import serve_gpt

    handles = serve_gpt.main(["--device", "cpu", "--requests", "5",
                              "--slots", "2", "--max-new", "8",
                              "--d-model", "32", "--heads", "2",
                              "--prefix-cache", "--echo",
                              "--temperature", "0.7"])
    out = capsys.readouterr().out
    assert "served 5/5 requests" in out and "decode executables: 1" in out
    assert out.count("<done>") == 5
    assert all(len(h.tokens) == 8 and h.done for h in handles)
    # the first two admit together, before either registers its blocks
    assert sum(h.request.cached_tokens > 0 for h in handles) == 3

    scraped = {}

    class Scraping(serve_gpt.Frontend):
        def run(self, *a, **k):
            report = super().run(*a, **k)
            url = re.search(r"metrics: (http://\S+)",
                            capsys.readouterr().out).group(1)
            for path in ("/metrics", "/healthz"):
                with urllib.request.urlopen(url + path, timeout=5) as r:
                    scraped[path] = (r.status, r.read().decode())
            return report

    monkeypatch.setattr(serve_gpt, "Frontend", Scraping)
    small = ["--device", "cpu", "--requests", "3", "--slots", "2",
             "--max-new", "6", "--d-model", "32", "--heads", "2"]
    serve_gpt.main(small + ["--metrics-port", "0"])
    code, page = scraped["/metrics"]
    assert code == 200 and scraped["/healthz"][0] == 200
    for name in ("serve_slot_occupancy", "serve_kv_utilization",
                 "serve_token_ms_count"):
        assert name in page, name
    monkeypatch.undo()
    plain = serve_gpt.main(small + ["--draft", "tiny"])
    sharded = serve_gpt.main(small + ["--draft", "tiny", "--tp", "2"])
    assert [list(h.tokens) for h in sharded] == [
        list(h.tokens) for h in plain]
    assert capsys.readouterr().out.count("verify executables: 1") == 2
