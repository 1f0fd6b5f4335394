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
  writes into the slots in place.
"""

import numpy as np
import pytest
import torch

from singa_tpu_torch import autograd, layer, opt
from singa_tpu_torch.graph import GraphStep
from singa_tpu_torch.model import Model
from singa_tpu_torch.models import CharRNN
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
