"""The native DP training step over 2 gloo ranks (singa_tpu_torch.native:
`hlo_bridge.run_replicated`, the StableHLO runtime's collectives, R7)
against the reference's `run_replicated` on its 2-device CPU mesh
(tests/test_hlo_native.py:107, :356), in one spawn of 2 ranks beside the
reference's process (`helper_torch_parity.run_both`):

- the `native_dp` recipe (the strategies runner's, the reference's
  `_dryrun_native_dp`: `MLP(24, 10)`, 2 rows a replica, lr 0.1) for 2
  steps on the fp32 and the bf16 wire, from the port's seeded weights,
  which the reference loads: each rank's losses equal the reference's
  replica's within rtol 2e-4, atol 2e-5, and `run_replicated` finds the
  updated parameters bitwise identical on both ranks after each step;
- the ZeRO-1 wire pattern (bf16 gradient reduce_scatter, fp32 shard
  update, bf16 all_gather) emitted by the C++ buffer runs on the ranks
  and gives the host's arithmetic;
- with one all_reduce deleted from the text, R7 flags "emitter declares
  4, module carries 3" and `run_replicated` raises on the parted
  replicas, naming the parameter and the step;
- a `CollectiveRecorder` around a step records the text's census (4
  psum), and nothing of the replica check.
"""

import re

import numpy as np
import pytest
import torch

from helper_torch_parity import run_both
from singa_tpu_torch import analysis, native
from singa_tpu_torch.analysis import hlo
from singa_tpu_torch.examples.parallel_strategies import native_dp_step

WORLD = 2
#: the ZeRO-1 wire module's shapes and lr (tests/test_hlo_native.py:107)
Z1_GRAD, Z1_SHARD, Z1_LR = (16, 4), (8, 4), 0.1


def port_params():
    """The port's seeded MLP weights, which both sides start from."""
    m = native_dp_step(1)[0]
    names = ["fc1.W", "fc1.b", "fc2.W", "fc2.b"]
    return {k: m.args[i] for k, i in zip(names, m.param_idx)}


def drop_first_all_reduce(text):
    """`text` with its first all_reduce deleted: the op's lines go and
    its result's uses read its operand."""
    m = re.search(r'    (%\d+) = "stablehlo\.all_reduce"\((%\d+)\).*?\n'
                  r'    \}\) : [^\n]*\n', text, re.S)
    out = text[:m.start()] + text[m.end():]
    return re.sub(rf"{m.group(1)}\b", m.group(2), out)


def zero1_module():
    b = native.HloGraphBuilder()
    g = b.param_t(Z1_GRAD, "bf16")   # local gradient on the bf16 wire
    p = b.param_t(Z1_SHARD, "f32")   # this rank's fp32 master shard
    rs = b.reduce_scatter_sum(g, WORLD)
    upd = b.sub(p, b.scale(b.convert(rs, "f32"), Z1_LR))
    out = b.all_gather(b.convert(upd, "bf16"), WORLD)
    text = b.emit_multi([out, upd], n_replicas=WORLD)
    b.close()
    rng = np.random.default_rng(0)
    return {"text": text,
            "g": [rng.standard_normal(Z1_GRAD).astype(np.float32)
                  for _ in range(WORLD)],
            "p": [rng.standard_normal(Z1_SHARD).astype(np.float32)
                  for _ in range(WORLD)]}


def reference_side(params):
    """The reference's per-step per-replica losses of the recipe on its
    2-device mesh, on both wires."""
    from jax._src import xla_bridge
    from jax._src.lib import xla_client as xc

    from singa_tpu import autograd, device, models
    from singa_tpu import tensor as tm
    from singa_tpu.native.hlo_bridge import (compile_stablehlo,
                                             lower_train_step,
                                             run_replicated)
    from singa_tpu.tensor import Tensor

    n, local_b, in_dim, n_steps, lr = WORLD, 2, 12, 2, 0.1
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n_steps, n * local_b, in_dim)).astype(
        np.float32)
    onehots = np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, (n_steps, n * local_b))]
    cpu = xla_bridge.get_backend("cpu")
    devs = cpu.local_devices()[:n]
    autograd.set_autocast(False)
    autograd.training = True
    out = {}
    for wire in ("fp32", "bf16"):
        tm.set_seed(3)
        m = models.MLP(perceptron_size=24, num_classes=10)
        m.dropout.training = False
        x0 = Tensor(data=x[0][:local_b], device=device.create_cpu_device())
        m.forward(x0)
        m.set_params(params)
        loss = autograd.softmax_cross_entropy(m.forward(x0),
                                              onehots[0][:local_b])
        step = lower_train_step(loss, list(m.get_params().values()), lr,
                                inputs=[x0], n_replicas=n, wire=wire)
        copts = xc.CompileOptions()
        copts.num_replicas = n
        exe = compile_stablehlo(cpu, step.text, devs, copts)
        out[wire] = run_replicated(
            exe, step, devs, [([x[i]], onehots[i]) for i in range(n_steps)])
        out[wire + "_text"] = step.text
    return out


def _scenario():
    import helper_torch_parity

    return helper_torch_parity._rank_hlo_native_dp


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    params = port_params()
    step, _ = native_dp_step(WORLD, params=params)
    ranks_dir = tmp_path_factory.mktemp("ranks")
    ref, ranks = run_both(
        (__name__, "reference_side", tmp_path_factory.mktemp("ref"),
         dict(params=params)),
        (_scenario(), WORLD, ranks_dir,
         dict(params=params, dropped=drop_first_all_reduce(step.text),
              zero1=zero1_module())))
    return ref, ranks


@pytest.mark.parametrize("wire", ["fp32", "bf16"])
def test_losses_equal_the_reference_replicas(both, wire):
    ref, ranks = both
    step, _ = native_dp_step(WORLD, wire, params=port_params())
    assert step.text == ref[wire + "_text"]
    for r in range(WORLD):
        got = [row[r] for row in ranks[r][wire]]
        want = [row[r] for row in ref[wire]]
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
        # every rank gathered the same per-replica losses
        assert ranks[r][wire] == ranks[0][wire]


def test_the_zero1_wire_pattern_gives_the_host_arithmetic(both):
    _, ranks = both
    z = zero1_module()
    assert '"stablehlo.reduce_scatter"' in z["text"]
    assert '"stablehlo.all_gather"' in z["text"]

    def bf16(a):
        return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float()

    gsum = sum(bf16(g) for g in z["g"])
    rows = Z1_SHARD[0]
    upd = [torch.from_numpy(z["p"][r]) - Z1_LR * gsum[
        r * rows:(r + 1) * rows].bfloat16().float() for r in range(WORLD)]
    want = torch.cat(upd).bfloat16().float().numpy()
    for r in range(WORLD):
        gathered, shard = ranks[r]["zero1"]
        np.testing.assert_array_equal(gathered, want)
        np.testing.assert_allclose(shard, upd[r].numpy(), rtol=0, atol=1e-6)


def test_a_deleted_all_reduce_is_flagged_and_parts_the_replicas(both):
    _, ranks = both
    step, _ = native_dp_step(WORLD, params=port_params())
    dropped = drop_first_all_reduce(step.text)
    assert dropped.count('"stablehlo.all_reduce"') == 3
    clean = analysis.run_rules(hlo.trace_native_module(step),
                               rules=analysis.HLO_RULES)
    assert clean.ok and clean.hlo == {"census": {"all_reduce": 4},
                                      "expected": {"all_reduce": 4}}
    trace = hlo.trace_native_module(step)
    trace.lowered_text = dropped
    rep = analysis.run_rules(trace, rules=analysis.HLO_RULES)
    assert not rep.ok
    assert "emitter declares 4, module carries 3" in rep.violations[0].message
    for r in range(WORLD):
        msg = ranks[r]["parted"]
        assert msg is not None and "step 0: parameter 0" in msg, msg
        assert "replicas are parted" in msg


def test_a_recorder_sees_the_text_census(both):
    _, ranks = both
    for r in range(WORLD):
        assert ranks[r]["census"] == {"psum@": 4}
        assert ranks[r]["ops"] == [("psum", "float32", (0, 1))]
