"""The port's native graph planner and the memory accounting of its graph
steps (singa_tpu_torch.native, singa_tpu_torch.graph), against
singa_tpu's.

- `native.GraphPlanner`, g++'s build of `native/graph_core.cc`, against
  its plain Python version on random DAGs: the same order, offsets, peak
  and naive bytes, and both raise on a cycle; against the reference's
  `GraphPlanner` on the same graphs;
- `Model.memory_estimate`, the port counterparts of
  `tests/test_native.py:134-200`: the planner over a real tape
  (0 < peak <= naive), a default graph-mode step that calls into the
  library (the native count moves, the estimate appears), and a deep
  chain (ResNet-20) whose peak is below its naive sum. `ops` counts
  PyTorch's autograd nodes, so the invariants are held, not the count;
- `step_memory_analysis`: the remat floor of
  `tests/test_scan_stack.py:103` (per_block's `temp_bytes` below none's,
  at 2 and 4 blocks; a block adds only its input), the reference's
  formula for `peak_bytes`, the state put back after the run, and the
  analytic keys equal to the reference's at world 1.
"""

import numpy as np
import pytest
import torch

from singa_tpu import graph as ref_graph
from singa_tpu import opt as ref_opt
from singa_tpu import tensor as ref_tensor
from singa_tpu.models.gpt import GPT as RefGPT
from singa_tpu.native import GraphPlanner as RefPlanner
from singa_tpu_torch import autograd, graph, native, opt
from singa_tpu_torch.models import MLP, resnet20_cifar
from singa_tpu_torch.models.gpt import GPT

GPT_KW = dict(vocab_size=64, d_model=32, num_heads=4, max_len=32,
              dropout=0.0, scan_blocks=True)


@pytest.fixture(autouse=True)
def _reset_process_flags():
    yield
    autograd.training = False


def random_dag(seed):
    """(n_nodes, edges): forward edges between random nodes, graph inputs
    and outputs, buffers shared by several consumers, sizes of any
    alignment."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    edges, buf = [], 0
    for dst in range(n):
        for _ in range(int(rng.integers(0, 3))):
            src = int(rng.integers(-1, dst)) if dst else -1
            edges.append((src, dst, buf, int(rng.integers(1, 5000))))
            if rng.random() < 0.3 and dst + 1 < n:  # a second consumer
                edges.append((src, int(rng.integers(dst + 1, n)), buf,
                              edges[-1][3]))
            buf += 1
        if rng.random() < 0.2:
            edges.append((dst, -1, buf, int(rng.integers(1, 3000))))
            buf += 1
    perm = rng.permutation(n)  # node ids no longer in topological order
    return n, [(int(perm[s]) if s >= 0 else -1,
                int(perm[d]) if d >= 0 else -1, b, nb)
               for s, d, b, nb in edges]


def build(planner_cls, n, edges, **kw):
    p = planner_cls(**kw)
    for _ in range(n):
        p.add_node()
    for e in edges:
        p.add_edge(*e)
    return p


@pytest.mark.parametrize("seed", range(12))
def test_native_planner_equals_its_plain_version(seed):
    n, edges = random_dag(seed)
    p = build(native.GraphPlanner, n, edges, require_native=True)
    assert p.native
    order = p.toposort()
    assert order == native.toposort_plain(n, edges)
    n_buf = 1 + max((e[2] for e in edges), default=-1)
    offsets, peak, naive = p.plan_memory(order)
    assert (offsets, peak, naive) == native.plan_memory_plain(
        edges, order, n_buf)
    assert 0 <= peak <= naive or not edges
    # and the reference's planner on the same graph
    ref = build(RefPlanner, n, edges)
    assert ref.toposort() == order
    assert tuple(ref.plan_memory(order)) == (offsets, peak, naive)


def test_both_planners_raise_on_a_cycle():
    edges = [(0, 1, 0, 8), (1, 2, 1, 8), (2, 0, 2, 8)]
    with pytest.raises(ValueError, match="cycle"):
        build(native.GraphPlanner, 3, edges, require_native=True).toposort()
    with pytest.raises(ValueError, match="cycle"):
        native.toposort_plain(3, edges)


def test_planner_refuses_malformed_edges_and_orders():
    p = build(native.GraphPlanner, 2, [(0, 1, 0, 8)], require_native=True)
    with pytest.raises(ValueError, match="not a node"):
        p.add_edge(0, 5, 1, 8)
    with pytest.raises(ValueError, match="every node once"):
        p.plan_memory([0])


def test_native_calls_are_counted():
    before = native.native_call_count()
    p = build(native.GraphPlanner, 2, [(0, 1, 0, 8)], require_native=True)
    p.plan_memory()
    assert native.native_call_count() == before + 2


def test_tape_memory_plan_on_a_real_model():
    """tests/test_native.py:134's counterpart: the planner over the tape
    of an MLP's loss."""
    m = MLP(32, 10, in_features=20, device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(8, 20)).astype(np.float32))
    m.compile([x], is_train=True, use_graph=False)
    loss = autograd.softmax_cross_entropy(m.forward(x),
                                          torch.arange(8) % 10)
    order, peak, naive = graph.tape_memory_plan(loss)
    assert len(order) > 0
    assert 0 < peak <= naive
    # the logits alone: fewer nodes, and no tape at all gives nothing
    assert len(graph.tape_memory_plan(m.forward(x))[0]) < len(order)
    assert graph.tape_memory_plan(torch.ones(3)) == ([], 0, 0)


def test_default_graph_step_is_native_load_bearing():
    """tests/test_native.py:155's counterpart: a default graph-mode step
    runs the C++ planner and surfaces its estimate."""
    m = MLP(16, 4, in_features=10, device="cpu")
    m.dropout.p = 0.0
    m.set_optimizer(opt.SGD(lr=0.1))
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(8, 10)).astype(np.float32))
    y = torch.arange(8) % 4
    m.compile([x], is_train=True, use_graph=True)
    before = native.native_call_count()
    assert m.memory_estimate is None
    _, loss = m.train_one_batch(x, y)
    assert np.isfinite(loss.item())
    assert native.native_call_count() > before
    est = m.memory_estimate
    assert est is not None and est["ops"] > 0
    assert 0 < est["peak_bytes"] <= est["naive_bytes"]
    assert m._train_step.memory_plan is est
    # planned once: later steps do not plan again
    calls = native.native_call_count()
    m.train_one_batch(x, y)
    assert native.native_call_count() == calls
    # the eval step is planned too; the estimate stays the train step's
    m.eval()
    m(x)
    plan = m._eval_step.memory_plan
    assert plan is not None and 0 < plan["peak_bytes"] <= plan["naive_bytes"]
    assert plan["ops"] < est["ops"]
    assert m.memory_estimate is est
    m.graph(True)  # drops both steps
    assert m.memory_estimate is None


def test_eval_plan_alone_is_the_estimate():
    m = MLP(16, 4, in_features=10, device="cpu")
    x = torch.ones(4, 10)
    m.compile([x], is_train=False, use_graph=True)
    m(x)
    assert m._train_step is None
    assert m.memory_estimate is m._eval_step.memory_plan is not None
    # under inference mode no tape can be recorded: no plan, no error
    m.graph(True)
    with torch.inference_mode():
        m(x)
    assert m.memory_estimate is None


def test_memory_plan_reflects_lifetime_reuse():
    """tests/test_native.py:185's counterpart: on a deep chain the arena
    peak is below the naive sum of buffers."""
    torch.manual_seed(0)
    m = resnet20_cifar(num_classes=10, device="cpu")
    m.set_optimizer(opt.SGD(lr=0.05))
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(4, 3, 16, 16)).astype(np.float32))
    y = torch.arange(4) % 10
    m.compile([x], is_train=True, use_graph=True)
    m.train_one_batch(x, y)
    est = m.memory_estimate
    assert est["peak_bytes"] < est["naive_bytes"]


def _batch(b=4, t=16, vocab=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (b, t)).astype(np.int32),
            rng.integers(0, vocab, (b, t)).astype(np.int32))


def _port_analysis(policy, num_layers, train=True):
    torch.manual_seed(0)
    m = GPT(**GPT_KW, num_layers=num_layers, remat_policy=policy,
            device="cpu")
    m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
    x, y = (torch.from_numpy(a).long() for a in _batch())
    m.compile([x], is_train=True, use_graph=True)
    args = (x, y) if train else (x,)
    return m, graph.step_memory_analysis(m, *args, train=train)


def test_per_block_remat_floor():
    """tests/test_scan_stack.py:103's floor: per_block's saved bytes are
    below none's at every depth; a block adds only its input under
    per_block (the checkpoint's), every residual under none."""
    stats = {(p, n): _port_analysis(p, n)[1]
             for p in ("none", "per_block") for n in (2, 4)}
    for n in (2, 4):
        assert stats[("per_block", n)]["temp_bytes"] \
            < stats[("none", n)]["temp_bytes"]
        assert stats[("per_block", n)]["peak_bytes"] \
            < stats[("none", n)]["peak_bytes"]
    # two more blocks: per_block keeps two more block inputs (B, T, d)
    # fp32, none keeps every residual of two more blocks
    block_input = 4 * 16 * GPT_KW["d_model"] * 4
    grow = {p: stats[(p, 4)]["temp_bytes"] - stats[(p, 2)]["temp_bytes"]
            for p in ("none", "per_block")}
    assert grow["per_block"] == 2 * block_input
    assert grow["none"] > 10 * grow["per_block"]
    for s in stats.values():
        assert s["peak_bytes"] == (s["argument_bytes"] + s["output_bytes"]
                                   - s["alias_bytes"] + s["temp_bytes"])
        assert s["alias_bytes"] > 0 and s["temp_bytes"] > 0


def test_analysis_puts_the_state_back():
    m, _ = _port_analysis("none", 2)
    x, y = (torch.from_numpy(a).long() for a in _batch())
    before = {k: v.clone() for k, v in m.get_states().items()}
    slots = {k: v.clone() for k, v in m.optimizer.dump_states().items()}
    rng = torch.get_rng_state()
    graph.step_memory_analysis(m, x, y)
    for k, v in m.get_states().items():
        assert torch.equal(v, before[k]), k
    for k, v in m.optimizer.dump_states().items():
        assert torch.equal(torch.as_tensor(v), slots[k]), k
    assert m.optimizer.step_counter == 0
    assert torch.equal(torch.get_rng_state(), rng)
    ev = graph.step_memory_analysis(m, x, train=False)
    assert ev["alias_bytes"] == 0 and ev["temp_bytes"] == 0
    assert ev["output_bytes"] == 4 * 16 * 64 * 4  # the logits


@pytest.mark.parametrize("policy", ["none", "per_block"])
def test_analytic_keys_equal_the_reference(policy):
    """parameter_bytes, attention_bytes and gathered_block_bytes are the
    reference's analytic terms: equal at world 1."""
    _, got = _port_analysis(policy, 2)
    ref_tensor.set_seed(0)
    ref = RefGPT(**GPT_KW, num_layers=2, remat_policy=policy)
    ref.set_optimizer(ref_opt.SGD(lr=0.1, momentum=0.9))
    x, y = (ref_tensor.from_numpy(a) for a in _batch())
    ref.compile([x], is_train=True, use_graph=True)
    want = ref_graph.step_memory_analysis(ref, x, y)
    for key in ("parameter_bytes", "attention_bytes",
                "gathered_block_bytes"):
        assert got[key] == want[key], key
    assert set(got) == set(want)
