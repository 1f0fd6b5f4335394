"""The port's training-step graph (singa_tpu_torch.graph.GraphStep and
Model's routing through it) on the CPU, where the step runs uncaptured.

- one build per input signature: a new shape, dtype, static argument or
  mode is a new key, and `graph_compiles` counts it (the reference's
  metric names, with `train_steps` and `train_step_ms` behind the
  hot-path gate and the `graph.compile` span in the trace);
- routing: `m(x, y)` and direct `m.train_one_batch(x, y)` calls go
  through the step after `compile(..., use_graph=True)`, straight to the
  user's method under `graph(False)`, and `graph()` drops the step;
- `graph(True)` against `graph(False)` over 3 steps of a small CharRNN
  with SGD with momentum, Adam under `Warmup(CosineDecay)` and AdaGrad:
  losses, parameters and every optimizer state equal bitwise (the same
  function runs on the CPU);
- what capture on the card needs, checked here: every parameter and slot
  keeps its storage across steps (`data_ptr`), the step counter lives on
  the parameters' device and its host mirror follows it, and a scheduled
  learning rate is a tensor computed from that counter; `load_states`
  writes into the slots in place;
- F7: the key carries `layer.mutation_stamp()`, which a parameter object
  replaced on a layer moves (a new key, one more build, the old entry
  dropped) and in-place writes (`set_params`, `set_states`, the
  carry-over, a lazy parameter's materialisation) do not; after such a
  replacement the step trains the new tensor with fresh slots, as
  `singa_tpu`'s graph step does after the same replacement (the MLP,
  SGD with momentum, 2 steps before and 2 after, within 1e-5).
"""

import numpy as np
import pytest
import torch

from singa_tpu_torch import autograd, layer, opt
from singa_tpu_torch.graph import GraphStep
from singa_tpu_torch.model import Model, load_singa_tpu_params
from singa_tpu_torch.models import MLP, CharRNN
from singa_tpu_torch.observability import metrics, trace

KW = dict(vocab_size=12, hidden_size=16, embed_dim=8, num_layers=1)
OPTIMIZERS = {
    "sgd_momentum": lambda: opt.SGD(lr=0.1, momentum=0.9),
    "adam_warmup_cosine": lambda: opt.Adam(
        lr=opt.Warmup(opt.CosineDecay(1e-2, 10), 2)),
    "adagrad": lambda: opt.AdaGrad(lr=0.1),
}


@pytest.fixture(autouse=True)
def _reset_process_flags():
    yield
    autograd.training = False
    metrics.disable()


def _batch(b=4, t=10, seed=0):
    ids = np.random.default_rng(seed).integers(0, 12, (b, t + 1))
    return torch.from_numpy(ids[:, :-1]), torch.from_numpy(ids[:, 1:])


def _model(make_opt, use_graph=True):
    m = CharRNN(**KW, device="cpu",
                generator=torch.Generator().manual_seed(3))
    m.set_optimizer(make_opt())
    x, _ = _batch()
    m.compile([x], is_train=True, use_graph=use_graph)
    return m


class _Regressor(Model):
    """A linear model whose step takes a static option, as the
    reference trainers' `train_one_batch(x, y, dist_option)` does."""

    def __init__(self):
        super().__init__()
        self.fc = layer.Linear(1, in_features=3, device="cpu")

    def forward(self, x):
        return self.fc(x)

    def train_one_batch(self, x, y, dist_option="plain"):
        out = self.forward(x)
        loss = (out - y).square().mean()
        self._apply_opt(loss, dist_option)
        return out, loss


def test_one_build_per_signature():
    m = _Regressor()
    m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
    x, y = torch.ones(4, 3), torch.zeros(4, 1)
    m.compile([x], is_train=True, use_graph=True)
    before = metrics.snapshot().get("graph_compiles", 0)
    m(x, y)
    m(x, y)
    step = m._train_step
    assert isinstance(step, GraphStep) and step.captures == 1
    m(torch.ones(5, 3), torch.zeros(5, 1))         # a new shape
    m(x, y.double())                               # a new dtype
    m(x, y, "local")                               # a new static argument
    m(x.numpy(), y.numpy())                        # numpy is a tensor too
    assert step.captures == 4
    assert metrics.snapshot()["graph_compiles"] - before == 4
    assert len(step._cache) == 4
    with pytest.raises(NotImplementedError, match="positional"):
        m(x, y=y)
    assert step.replays == 0  # nothing replays on the CPU


def test_metric_names_and_compile_span(tmp_path):
    m = _model(OPTIMIZERS["adagrad"])
    x, y = _batch()
    metrics.enable()
    steps0 = metrics.snapshot().get("train_steps", 0)
    path = tmp_path / "trace.jsonl"
    trace.enable(str(path))
    try:
        for _ in range(3):
            m(x, y)
    finally:
        trace.disable()
    assert metrics.snapshot()["train_steps"] - steps0 == 3
    assert metrics.histogram("train_step_ms").count >= 3
    spans = trace.find_spans(trace.read_events(str(path)), "graph.compile")
    assert len(spans) == 1 and spans[0]["attrs"]["train"] is True
    for name in ("graph_compiles", "train_steps", "train_step_ms"):
        assert metrics.HELP[name]


def test_direct_train_one_batch_calls_take_the_graph_route():
    x, y = _batch()
    m = CharRNN(**KW, device="cpu")
    m.set_optimizer(opt.SGD(lr=0.1))
    # before compile: the user's method itself
    assert m.train_one_batch.__func__ is CharRNN.train_one_batch
    m.compile([x], is_train=True, use_graph=True)
    _, loss = m.train_one_batch(x, y)
    assert m._train_step is not None and m._train_step.captures == 1
    m.eval()  # routed in eval mode too, as in the reference
    m.train_one_batch(x, y)
    assert m._train_step.captures == 2  # `training` is part of the key
    m.train()
    m.graph(False)
    assert m._train_step is None
    m.train_one_batch(x, y)
    m(x, y)
    assert m._train_step is None and m.optimizer.step_counter == 4
    m.graph(True)
    m(x, y)
    assert m._train_step.captures == 1


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_graph_mode_equals_eager(name):
    sides = {}
    for use_graph in (True, False):
        m = _model(OPTIMIZERS[name], use_graph)
        losses = [m.train_one_batch(*_batch())[1].item() for _ in range(3)]
        sides[use_graph] = (losses, dict(m.named_parameters()),
                            m.optimizer.dump_states(), m)
    (l1, p1, s1, m1), (l0, p0, s0, m0) = sides[True], sides[False]
    assert m1._train_step is not None and m0._train_step is None
    assert l1 == l0 and l1[-1] < l1[0]
    for k in p0:
        assert torch.equal(p1[k], p0[k]), k
    assert sorted(s1) == sorted(s0) and int(s1["__step__"]) == 3
    for k in s0:
        assert torch.equal(s1[k], s0[k]), k


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_state_keeps_its_storage_across_steps(name):
    m = _model(OPTIMIZERS[name])
    o = m.optimizer

    def ptrs():
        out = {n: p.data_ptr() for n, p in m.named_parameters()}
        out.update({k: v.data_ptr() for k, v in
                    ((f"{pid}//{s}", t) for pid, slots in o._slots.items()
                     for s, t in slots.items())})
        out["__step__"] = o._step.data_ptr()
        return out

    before = ptrs()
    n_params = len(list(m.parameters()))
    assert len(before) == n_params * (1 + len(o.slot_names)) + 1
    for s in range(3):
        m(*_batch(seed=s))
        assert ptrs() == before
    assert o._step.device == m.embed.table.device
    assert o._step.dtype == torch.int32
    assert int(o._step) == o.step_counter == 3

    # load_states writes into the same slots
    states = {k: v.clone() + 1 for k, v in o.dump_states().items()}
    o.load_states(states)
    assert ptrs() == before and o.step_counter == int(o._step) == 4


def test_scheduled_learning_rate_is_a_tensor_of_the_device_step():
    o = opt.Adam(lr=opt.Warmup(opt.CosineDecay(1e-2, 10), 2))
    w = torch.nn.Parameter(torch.ones(3))
    o.prepare({"w": w})
    lr0 = o.lr_value()
    assert isinstance(lr0, torch.Tensor) and lr0.dtype == torch.float32
    assert lr0.device == w.device
    o.apply_updates([(w, torch.ones(3))])
    lr1 = o.lr_value()
    assert float(lr1) == pytest.approx(float(o.lr(1)))
    assert float(lr1) > float(lr0)  # the warmup ramp read the new step
    # a constant rate stays a host float: a constant of the step
    assert opt.SGD(lr=0.5).lr_value() == 0.5


def test_a_replaced_parameter_moves_the_key_and_in_place_writes_do_not():
    m = _Regressor()
    m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
    x, y = torch.ones(4, 3), torch.zeros(4, 1)
    m.compile([x], is_train=True, use_graph=True)
    lazy = layer.Linear(2, device="cpu")  # building a layer moves it
    m(x, y)
    step = m._train_step
    (key,) = step._cache
    stamp = layer.mutation_stamp()
    m.set_params({"fc.W": np.full((3, 1), 0.5, np.float32)})
    m.set_states({"fc.b": np.zeros(1, np.float32)})
    load_singa_tpu_params(m, {"fc.W": np.ones((3, 1), np.float32),
                              "fc.b": np.ones(1, np.float32)})
    m.eval()
    m.train()
    lazy(torch.ones(1, 3))  # materialises W in place
    assert layer.mutation_stamp() == stamp
    m(x, y)
    assert step.captures == 1 and list(step._cache) == [key]

    old = m.fc.W
    old0 = old.detach().clone()
    m.fc.W = torch.nn.Parameter(torch.full((3, 1), 2.0))
    assert layer.mutation_stamp() > stamp
    m(x, y)
    (new_key,) = step._cache  # the entry of the old stamp is gone
    assert new_key != key and new_key[:-1] == key[:-1]
    assert step.captures == 2
    assert not torch.equal(m.fc.W, torch.full((3, 1), 2.0))
    assert torch.equal(old, old0)
    assert id(m.fc.W) in m.optimizer._slots


def test_steps_after_a_replacement_match_the_reference():
    from singa_tpu import autograd as ref_autograd
    from singa_tpu import opt as ref_opt
    from singa_tpu import tensor as ref_tensor
    from singa_tpu.models import MLP as RefMLP

    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 6)).astype(np.float32)
    y = rng.integers(0, 3, 8).astype(np.int32)
    new_w = rng.standard_normal((5, 3)).astype(np.float32)
    ref = RefMLP(perceptron_size=5, num_classes=3)
    ref.dropout.p = 0.0
    ref.eval()
    ref(ref_tensor.from_numpy(x))
    params = {k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in ref.get_params().items()}
    ref.set_params(params)
    ref.set_optimizer(ref_opt.SGD(lr=0.1, momentum=0.9))
    ref.compile([ref_tensor.from_numpy(x)], is_train=True, use_graph=True)
    port = MLP(5, 3, in_features=6, device="cpu")
    port.dropout.p = 0.0
    load_singa_tpu_params(port, params)
    port.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
    port.compile([torch.from_numpy(x)], is_train=True, use_graph=True)
    try:
        losses = {"ref": [], "port": []}
        for i in range(4):
            if i == 2:
                ref.fc2.W = ref_tensor.Tensor(data=new_w, requires_grad=True,
                                              stores_grad=True)
                port.fc2.W = torch.nn.Parameter(torch.from_numpy(
                    new_w.copy()))
            losses["ref"].append(float(np.asarray(ref(
                ref_tensor.from_numpy(x), ref_tensor.from_numpy(y))[1].data)))
            losses["port"].append(port(torch.from_numpy(x),
                                       torch.from_numpy(y).long())[1].item())
    finally:
        ref_autograd.training = False
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=1e-5)
    want = {k: np.asarray(v.data) for k, v in ref.get_params().items()}
    got = {k: v.detach().numpy() for k, v in port.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    assert not np.allclose(got["fc2.W"], new_w)  # the new tensor trained
    assert port._train_step.captures == 2


def test_a_collected_owners_stream_goes_to_the_next_owner(monkeypatch):
    """cuBLAS keeps a workspace per stream for the life of the process: a
    graph owner made after another was collected (a model rebuilt after a
    crash) takes the collected owner's stream, not a fresh one from the
    pool, while live owners never share one."""
    import gc

    from singa_tpu_torch import graph

    made = []

    class FakeStream:
        def __init__(self, dev):
            self.device = torch.device(dev)
            self.cuda_stream = 1000 + len(made)
            made.append(self)

    class Owner:
        pass

    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(graph, "_HELD_STREAMS", set())
    monkeypatch.setattr(graph, "_FREE_STREAMS", [])
    a, b = Owner(), Owner()
    sa = graph.private_stream(a, "cuda:0")
    sb = graph.private_stream(b, "cuda:0")
    assert sa is not sb and len(made) == 2
    del a
    gc.collect()
    c, d = Owner(), Owner()
    assert graph.private_stream(c, "cuda:0") is sa and len(made) == 2
    assert graph.private_stream(d, "cuda:1").device == torch.device(
        "cuda:1") and len(made) == 3
    assert graph._HELD_STREAMS == {1000, 1001, 1002}
    del b, c, d
    gc.collect()  # before the patches are undone: the finalizers ran
    assert not graph._HELD_STREAMS and len(graph._FREE_STREAMS) == 3
