"""Shardlint on the port (singa_tpu_torch/analysis) against the reference
(singa_tpu/analysis): the rule units, R5's in-place cases, the lint's
restore of the training state, and the registry at world 1.

- `check_ring_perm` gives the reference's verdict on its truth table
  (tests/test_shardlint.py:64-80);
- R1 flags one axis claimed by two roles and passes {data, zero3};
- `ScanTransformerStack.declared_schedule` composes tp's, ring's and the
  stack's own constants (tests/test_shardlint.py:104-134);
- the report has the reference's JSON keys; R3, R6 and R7 (on a step
  without module text) are refused;
- R7's text layer (`analysis.hlo`): `check_collective` gives the
  reference's verdicts on its truth table, and the synthetic module's
  collectives, census and device count are the reference's
  (tests/test_shardlint_hlo.py:55-128);
- R5 passes the sentinel's `torch.where` skip and a restore's `copy_`,
  and flags a re-bound `.data`;
- a lint leaves the next two steps bitwise those of an unlinted twin
  (dropout on the default generator or a rank's, Adam, the sentinel's
  scale);
- at world 1 (a gloo group of one) `dp_plain` and `tp_bert` give the
  reference's `ok` and `schedule` at one device. `scan_seq` declares the
  reference's schedule there, but the two steps differ: the reference's
  takes no shard_map at one device, so its R2 finds no sharded block
  body ("not running"), while the port's world-1 step is its
  distributed step over a group of one (as on the card) and its blocks
  record the declared collectives (the ring's as not run).
"""

import numpy as np
import pytest
import torch

from helper_torch_parity import run_reference
from singa_tpu_torch import analysis, autograd, distributed, opt
from singa_tpu_torch.analysis import rules, trace
from singa_tpu_torch.parallel import mesh as mesh_module
from singa_tpu_torch.parallel import ring, tp

#: the cases held to the reference's at one device
WORLD1_CASES = ("dp_plain", "tp_bert", "scan_seq")

#: (perm, extent) of the reference's truth table
RING_CASES = [
    ([(0, 1), (1, 2)], 4),
    ([(0, 0), (1, 1)], 2),
    ([(0, 1), (1, 0), (2, 3), (3, 2)], 4),
    ([(0, 1), (1, 1), (2, 3), (3, 0)], 4),
    ([(0, 1), (1, 2), (2, 3), (3, 0)], 4),
    ([(0, 0)], 1),
]


def layout_mesh(dims, names):
    """A mesh's layout (no groups): its shape answers, as R1 and the
    declared schedules read it."""
    return mesh_module.Mesh(None, names, axis_groups={n: None
                                                      for n in names},
                            dims=dims, member=False)


@pytest.mark.parametrize("perm,extent", RING_CASES)
def test_check_ring_perm_gives_the_reference_verdict(perm, extent):
    from singa_tpu.analysis.rules import check_ring_perm as ref

    assert rules.check_ring_perm(perm, extent) == ref(perm, extent)


#: (op, replica_groups, source_target_pairs, devices) of the reference's
#: R7 truth table
R7_CASES = [
    ("all_reduce", [[0, 1], [2, 3]], None, 4),
    ("all_reduce", [[0, 0], [2, 3]], None, 4),
    ("all_reduce", [[0, 9]], None, 4),
    ("all_reduce", [[0, 1], [1, 2]], None, 3),
    ("all_reduce", [[0, 1]], None, 4),
    ("all_reduce", [[0, 1, 2], [3]], None, 4),
    ("all_gather", [[0, 1, 2], [3]], None, 4),
    ("collective_permute", None, [(0, 1), (0, 2)], 4),
    ("collective_permute", None, [(0, 1), (2, 1)], 4),
]

#: the reference's synthetic module: an all_reduce, a permute, and a
#: private function with an all_gather called twice
_SYNTH = """
module @jit_step attributes {mhlo.num_replicas = 2 : i32, mhlo.num_partitions = 4 : i32} {
  func.func public @main(%arg0: tensor<8xf32>) -> tensor<8xf32> {
    %0 = "stablehlo.all_reduce"(%arg0) ({
      ^bb0(%a: tensor<f32>, %b: tensor<f32>):
        %s = stablehlo.add %a, %b : tensor<f32>
        stablehlo.return %s : tensor<f32>
    }) {channel_handle = #stablehlo.channel_handle<handle = 3, type = 1>, replica_groups = dense<[[0, 1, 2, 3], [4, 5, 6, 7]]> : tensor<2x4xi64>, use_global_device_ids} : (tensor<8xf32>) -> tensor<8xf32>
    %1 = func.call @helper(%0) : (tensor<8xf32>) -> tensor<8xf32>
    %2 = func.call @helper(%1) : (tensor<8xf32>) -> tensor<8xf32>
    %3 = "stablehlo.collective_permute"(%2) {source_target_pairs = dense<[[0, 1], [1, 2], [2, 3], [3, 0]]> : tensor<4x2xi64>} : (tensor<8xf32>) -> tensor<8xf32>
    return %3 : tensor<8xf32>
  }
  func.func private @helper(%arg0: tensor<8xf32>) -> tensor<8xf32> {
    %0 = "stablehlo.all_gather"(%arg0) {all_gather_dim = 0 : i64, replica_groups = dense<[[0, 1], [2, 3], [4, 5], [6, 7]]> : tensor<4x2xi64>} : (tensor<8xf32>) -> tensor<8xf32>
    return %0 : tensor<8xf32>
  }
}
"""


@pytest.mark.parametrize("op,groups,pairs,n", R7_CASES)
def test_check_collective_gives_the_reference_verdict(op, groups, pairs, n):
    from singa_tpu.analysis import hlo as ref
    from singa_tpu_torch.analysis import hlo

    got = hlo.check_collective(hlo.HloCollective(
        op=op, replica_groups=groups, source_target_pairs=pairs), n)
    want = ref.check_collective(ref.HloCollective(
        op=op, replica_groups=groups, source_target_pairs=pairs), n)
    assert got == want
    assert bool(got) == ((op, groups, pairs, n) not in (
        R7_CASES[0], R7_CASES[5]))


def test_hlo_text_layer_parses_the_reference_synthetic_module():
    import dataclasses

    from singa_tpu.analysis import hlo as ref
    from singa_tpu_torch.analysis import hlo

    got = [dataclasses.asdict(c) for c in hlo.hlo_collectives(_SYNTH)]
    assert got == [dataclasses.asdict(c) for c in
                   ref.hlo_collectives(_SYNTH)]
    assert [c["op"] for c in got] == ["all_reduce", "collective_permute",
                                      "all_gather"]
    assert got[0]["channel_id"] == 3 and got[0]["use_global_device_ids"]
    assert hlo.hlo_census(_SYNTH) == ref.hlo_census(_SYNTH) == {
        "all_reduce": 1, "collective_permute": 1, "all_gather": 2}
    assert hlo.module_device_count(_SYNTH) == 8


def test_check_ring_perm_truth_table():
    for world in (1, 2, 3, 4, 8):
        assert rules.check_ring_perm(ring.ring_permutation(world),
                                     world) is None
    assert "missing" in rules.check_ring_perm([(0, 1), (1, 2)], 4)
    assert "cycles" in rules.check_ring_perm([(0, 0), (1, 1)], 2)
    assert "cycles" in rules.check_ring_perm(
        [(0, 1), (1, 0), (2, 3), (3, 2)], 4)
    assert "permutation" in rules.check_ring_perm(
        [(0, 1), (1, 1), (2, 3), (3, 0)], 4)


def test_r1_flags_one_axis_claimed_by_two_roles():
    mesh = layout_mesh((4,), ("data",))
    st = trace.StepTrace(target="synthetic", mesh=mesh,
                         axis_roles={"data": {"data", "seq"}})
    report = analysis.Report("synthetic")
    rules.rule_r1(st, report)
    assert any(v.rule == "R1" and "two parallelism roles" in v.message
               for v in report.violations)
    # ZeRO-3 rides the data axis: compatible
    st = trace.StepTrace(target="synthetic", mesh=mesh,
                         axis_roles={"data": {"data", "zero3"}})
    report = analysis.Report("synthetic")
    rules.rule_r1(st, report)
    assert report.ok, report.summary()
    # a recorded call over an axis the mesh lacks
    st = trace.StepTrace(target="synthetic", mesh=mesh, records=[[
        trace.Record("psum", "sq", (0,), (2,), "float32")]])
    report = analysis.Report("synthetic")
    rules.rule_r1(st, report)
    assert [v.subject for v in report.violations] == ["sq"]


def test_declared_schedule_matches_the_module_constants():
    from singa_tpu_torch.layer import ScanTransformerStack

    st = ScanTransformerStack(3, 2, tp_axis=mesh_module.MODEL_AXIS,
                              zero3_axis=mesh_module.DATA_AXIS,
                              seq_axis=mesh_module.SEQ_AXIS, d_model=8,
                              device="cpu")
    mesh = layout_mesh((2, 2, 2), ("data", "model", "sp"))
    sched = st.declared_schedule(mesh)
    assert sched["n_blocks"] == 3
    assert sched["per_block"] == {
        ("psum", mesh_module.MODEL_AXIS): tp.PSUMS_PER_BLOCK,
        ("all_gather", mesh_module.DATA_AXIS): len(
            ScanTransformerStack.STACKED),
        ("ppermute", mesh_module.SEQ_AXIS):
            ring.KV_TENSORS_PER_HOP * ring.rotation_steps(2),
    }
    # an axis the mesh lacks declares nothing
    assert st.declared_schedule(layout_mesh((2,), ("data",)))[
        "per_block"] == {("all_gather", "data"): 12}


def test_report_has_the_reference_keys_and_rules():
    from singa_tpu.analysis.report import Report as RefReport

    assert set(analysis.Report("t").to_json()) == set(
        RefReport("t").to_json())
    assert analysis.DEFAULT_RULES == ("R1", "R2", "R4", "R5")
    assert analysis.HLO_RULES == ("R7",)
    assert set(analysis.RULES) == set(analysis.DEFAULT_RULES
                                      + analysis.HLO_RULES)
    v = analysis.Violation("R4", "msg", subject="sp")
    assert v.to_json() == {"rule": "R4", "subject": "sp", "message": "msg"}


@pytest.mark.parametrize("rid,what", [("R3", "jaxpr"), ("R6", "StableHLO"),
                                      ("R7", "module text")])
def test_rules_without_a_torch_object_are_refused(rid, what):
    """R3 and R6 have no torch object to read; R7 reads module text,
    which a PyTorch step does not make."""
    with pytest.raises(ValueError, match=f"rule {rid} .*{what}"):
        analysis.lint_step(None, rules=(rid,))


def _mlp(sentinel=None):
    from singa_tpu_torch.models import MLP

    torch.manual_seed(0)
    m = MLP(8, 3, in_features=5, device="cpu")
    o = opt.Adam(1e-2)
    if sentinel is not None:
        o.set_sentinel(sentinel)
    m.set_optimizer(o)
    x, y = torch.randn(4, 5), torch.arange(4) % 3
    m.compile([x], is_train=True, use_graph=True)
    return m, x, y


def test_r5_passes_the_sentinel_skip():
    from singa_tpu_torch.resilience import GradSentinel, faults

    m, x, y = _mlp(GradSentinel(fault_plan=faults.nonfinite_grad_at(0)))
    w = {k: v.clone() for k, v in m.get_params().items()}
    rep = analysis.lint_step(m, x, y)  # a skip, then an update
    assert rep.ok, rep.summary()
    # the lint put the sentinel back: the next real step is the skip
    m.train_one_batch(x, y)
    assert m.fault_counters["nonfinite_skips"] == 1
    assert all(torch.equal(w[k], v) for k, v in m.get_params().items())


def test_r5_passes_a_restore_copy_and_flags_a_rebind(tmp_path):
    import helper_torch_analysis as ha
    from singa_tpu_torch import resilience

    m, x, y = _mlp()
    resilience.save(str(tmp_path / "ck"), m, m.optimizer, step=0)
    step = type(m).train_one_batch

    def restoring(self, *a):
        out = step(self, *a)
        resilience.restore(str(tmp_path / "ck"), self, self.optimizer)
        return out

    m._user_train_one_batch = restoring.__get__(m)
    rep = analysis.lint_step(m, x, y)
    assert rep.ok, rep.summary()
    bad = ha.dropped_donation([0])
    assert [v.rule for v in bad.violations] == ["R5"]
    assert "param:fc.W" in bad.violations[0].subject


def _twin_run(lint: bool, rank: int):
    """Two graph-mode steps of a dropout-0.1 unrolled GPT with Adam and a
    growing loss scale, its dropout on rank `rank`'s stream (0: the
    default generator); with `lint`, shardlint first. Returns the losses
    and every state."""
    from singa_tpu_torch.models.gpt import GPT
    from singa_tpu_torch.resilience import GradSentinel

    torch.manual_seed(0)
    autograd.reset_rank_draws()
    m = GPT(vocab_size=32, d_model=16, num_layers=2, num_heads=2,
            max_len=8, dropout=0.1, device="cpu")
    o = opt.Adam(1e-2)
    o.set_sentinel(GradSentinel(init_scale=2.0 ** 4, growth_interval=1))
    m.set_optimizer(o)
    x = torch.randint(0, 32, (2, 8), generator=torch.Generator()
                      .manual_seed(1))
    m.compile([x], is_train=True, use_graph=True)
    with autograd.rank_draws(rank):
        if lint:
            assert analysis.lint_step(m, x, x).ok
        losses = [m.train_one_batch(x, x)[1].item() for _ in range(2)]
    states = {k: v.clone() for k, v in m.get_states().items()}
    states.update({f"opt:{k}": v.clone() for k, v in
                   o.dump_states().items()})
    return losses, states


@pytest.mark.parametrize("rank", [0, 1])
def test_a_lint_leaves_training_bitwise_where_it_was(rank):
    torch.set_num_threads(1)
    got, got_states = _twin_run(True, rank)
    want, want_states = _twin_run(False, rank)
    assert got == want
    assert sorted(got_states) == sorted(want_states)
    for k, v in want_states.items():
        assert torch.equal(got_states[k], v), k


def test_an_unsharded_engine_refuses():
    from singa_tpu_torch.models.gpt import GPT
    from singa_tpu_torch.serving import ServingEngine

    m = GPT(vocab_size=16, d_model=16, num_layers=1, num_heads=2,
            max_len=8, dropout=0.0, scan_blocks=True, device="cpu")
    eng = ServingEngine(m, slots=1, block_size=4, window=8)
    with pytest.raises(NotImplementedError, match="SHARDED"):
        analysis.lint_step(eng)


# -- the registry at world 1 against the reference at one device ---------------


def reference_world1():
    """The reference's {case: {"ok", "schedule"}} at one device."""
    import jax

    from singa_tpu import analysis as ref_analysis, autograd as ref_ag
    from singa_tpu.analysis import cases

    out = {}
    for c in cases.iter_cases(1):
        if c.name in WORLD1_CASES:
            ref_ag.set_autocast(False)
            m, args = c.build(jax.devices()[:1])
            rep = ref_analysis.lint_step(m, *args, target=c.name)
            out[c.name] = {"ok": rep.ok, "schedule": rep.schedule}
    return out


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """(the reference's results, the port's: {case: (report, hlo
    text)}) over a gloo group of one."""
    from concurrent.futures import ThreadPoolExecutor

    from singa_tpu_torch import graph
    from singa_tpu_torch.analysis import cases

    with ThreadPoolExecutor(1) as ex:
        ref = ex.submit(run_reference, __name__, "reference_world1",
                        tmp_path_factory.mktemp("ref1"))
        distributed.init(device="cpu")
        try:
            got = {}
            for name in WORLD1_CASES:
                autograd.set_autocast(False)
                m, args = cases.build_case(name, [0])
                got[name] = (analysis.lint_step(m, *args, target=name),
                             graph.hlo_text(m, *args))
        finally:
            distributed.shutdown()
        return ref.result(), got


@pytest.mark.parametrize("name", ["dp_plain", "tp_bert"])
def test_world1_ok_and_schedule_equal_the_reference(world1, name):
    ref, (rep, _) = world1[0][name], world1[1][name]
    assert rep.ok and ref["ok"], rep.summary()
    assert rep.schedule == ref["schedule"]


def test_world1_scan_seq_declares_the_reference_schedule(world1):
    ref, (rep, _) = world1[0]["scan_seq"], world1[1]["scan_seq"]
    assert rep.schedule["expected"] == ref["schedule"]["expected"] == {
        "ppermute@sp": 2}
    assert rep.ok and rep.schedule["found"] == {"ppermute@sp": 2}
    # the reference's one-device step runs outside shard_map
    assert not ref["ok"] and ref["schedule"]["found"] == {}


def test_hlo_text_dumps_the_records(world1):
    rep, text = world1[1]["scan_seq"]
    lines = text.splitlines()
    assert len(lines) == sum(rep.collectives.values())
    # at one rank the ring moves nothing: the reference's two ppermutes
    # a block are recorded as not run
    ring_lines = [ln for ln in lines if "ppermute@sp" in ln]
    assert len(ring_lines) == 2 * 3
    assert all(ln.endswith("(not run)") for ln in ring_lines)
    assert np.all([ln.startswith("rank 0 ") for ln in lines])
