"""The port's eval step (`GraphStep(model, forward, train_step=False)`
and `Model._dispatch_eval`) against singa_tpu's on the CPU, where the
step runs uncaptured.

- outputs: a graph-mode model called in eval mode goes through its eval
  step on both sides, and the port's equals `singa_tpu`'s
  `_dispatch_eval` within 1e-5 (relative and absolute): the MLP, and a
  small scanned GPT at T 256, where both sides take the fused attention
  route (the reference's Pallas in interpret mode, the port's kernel's
  plain version, whose calls are counted);
- the step: no tape on its outputs, one build per key (shape, mode and
  `layer.mutation_stamp()`: F7's replaced parameter is a new key and the
  old entry goes), `graph_compiles` counting builds, no `train_steps`,
  the `graph.compile` span marked `train=False`; `graph()` and a changed
  `set_image_layout` drop it, as they drop the training step; under
  `graph(False)` eval calls are plain module calls.
"""

import numpy as np
import pytest
import torch

from singa_tpu import tensor as ref_tensor
from singa_tpu.models import MLP as RefMLP
from singa_tpu.models.gpt import GPT as RefGPT
from singa_tpu_torch import autograd
from singa_tpu_torch.graph import GraphStep
from singa_tpu_torch.model import load_singa_tpu_params
from singa_tpu_torch.models import MLP
from singa_tpu_torch.models.gpt import GPT
from singa_tpu_torch.observability import metrics, trace
from singa_tpu_torch.ops import flash_attention as fa
from tests.helper_torch_parity import randomize_params

TOL = 1e-5
GPT_KW = dict(vocab_size=64, d_model=64, num_layers=2, num_heads=2,
              max_len=256, dropout=0.0, scan_blocks=True)


@pytest.fixture(autouse=True)
def _reset_process_flags():
    yield
    autograd.training = False
    metrics.disable()


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def mlp_pair():
    ref_tensor.set_seed(0)
    ref = RefMLP(perceptron_size=16, num_classes=4)
    ref.compile([ref_tensor.from_numpy(_x((4, 12)))], is_train=False,
                use_graph=True)
    params = randomize_params(ref, 1)
    port = MLP(16, 4, in_features=12, device="cpu")
    load_singa_tpu_params(port, params)
    port.compile([torch.from_numpy(_x((4, 12)))], is_train=False,
                 use_graph=True)
    return ref, port


def test_mlp_eval_step_matches_the_reference():
    ref, port = mlp_pair()
    for seed in (1, 2):  # the key's build, then its second call
        x = _x((4, 12), seed)
        want = np.asarray(ref(ref_tensor.from_numpy(x)).data)
        got = port(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
        assert not got.requires_grad and got.grad_fn is None
    assert ref._eval_step is not None and ref._train_step is None
    step = port._eval_step
    assert isinstance(step, GraphStep) and not step.train_step
    assert step.captures == 1 and len(step._cache) == 1
    port(torch.from_numpy(_x((6, 12))))  # a new shape: a new key
    assert step.captures == 2


def test_gpt_eval_step_matches_the_reference_through_the_fused_route(
        monkeypatch):
    ref = RefGPT(**GPT_KW)
    ref.eval()
    ids = np.random.default_rng(3).integers(0, 64, (2, 256)).astype(np.int32)
    ref.compile([ref_tensor.from_numpy(ids)], is_train=False,
                use_graph=True)
    params = randomize_params(ref, 4)
    port = GPT(**GPT_KW, device="cpu")
    load_singa_tpu_params(port, params)
    port.compile([torch.from_numpy(ids).long()], is_train=False,
                 use_graph=True)
    calls = []
    fwd = fa._flash_fwd

    def counted(*a, **k):
        calls.append(1)
        return fwd(*a, **k)

    monkeypatch.setattr(fa, "_flash_fwd", counted)
    want = np.asarray(ref(ref_tensor.from_numpy(ids)).data)
    for _ in range(2):
        got = port(torch.from_numpy(ids).long())
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert len(calls) == 2 * GPT_KW["num_layers"]
    assert ref._eval_step is not None and port._eval_step.captures == 1
    assert port.memory_estimate is port._eval_step.memory_plan is not None


def test_eval_step_counts_builds_not_training_steps(tmp_path):
    _, port = mlp_pair()
    x = torch.from_numpy(_x((4, 12)))
    metrics.enable()
    snap = metrics.snapshot()
    compiles0 = snap.get("graph_compiles", 0)
    steps0 = snap.get("train_steps", 0)
    path = tmp_path / "trace.jsonl"
    trace.enable(str(path))
    try:
        for _ in range(3):
            port(x)
    finally:
        trace.disable()
    snap = metrics.snapshot()
    assert snap["graph_compiles"] - compiles0 == 1
    assert snap.get("train_steps", 0) == steps0
    spans = trace.find_spans(trace.read_events(str(path)), "graph.compile")
    assert len(spans) == 1 and spans[0]["attrs"]["train"] is False


def test_graph_and_image_layout_drop_the_eval_step():
    _, port = mlp_pair()
    x = torch.from_numpy(_x((4, 12)))
    port(x)
    step = port._eval_step
    port.set_image_layout("NHWC")  # changed: dropped
    assert port._eval_step is None
    port(x)
    step = port._eval_step
    port.set_image_layout("NHWC")  # unchanged: the step stays
    assert port._eval_step is step
    port.set_image_layout("NCHW")
    assert port._eval_step is None
    port.graph(True)
    assert port._eval_step is None and port._train_step is None
    port.graph(False)
    out = port(x)  # a plain module call: no step
    assert port._eval_step is None and not out.requires_grad


def test_replaced_parameter_is_a_new_key():
    """F7 carries over: the eval key holds `layer.mutation_stamp()`, so
    a parameter object replaced between calls takes a new key (one more
    build, the old entry dropped) and the new tensor is read."""
    _, port = mlp_pair()
    x = torch.from_numpy(_x((4, 12)))
    port(x)
    port(x)
    step = port._eval_step
    assert step.captures == 1
    port.fc2.W = torch.nn.Parameter(torch.zeros_like(port.fc2.W))
    out = port(x)
    assert step.captures == 2 and len(step._cache) == 1
    np.testing.assert_array_equal(
        out.numpy(), np.broadcast_to(port.fc2.b.detach().numpy(), (4, 4)))


def test_training_mode_calls_keep_the_training_step():
    ref, port = mlp_pair()
    from singa_tpu_torch import opt

    port.set_optimizer(opt.SGD(lr=0.1))
    x, y = torch.from_numpy(_x((4, 12))), torch.arange(4)
    port.compile([x], is_train=True, use_graph=True)
    port(x, y)
    assert port._train_step is not None and port._eval_step is None
    port.eval()
    port(x)
    assert port._eval_step is not None
    assert port._train_step.captures == 1 and port._eval_step.captures == 1
