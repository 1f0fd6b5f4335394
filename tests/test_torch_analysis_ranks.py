"""Shardlint on the port over 4 gloo ranks, against the reference's at 4
virtual devices (singa_tpu/analysis).

One spawn of 4 ranks (`helper_torch_parity._rank_analysis`, its body in
tests/helper_torch_analysis.py) beside one reference process
(`reference_side`):

- the recorder sees every collective the backends run in a DistOpt, a
  tp, a ring and a ZeRO-3 step, forward and backward (each entry point
  wrapped and counted in the rank; tp's against `tp.COUNTS`);
- the six mutation fixtures are flagged with the reference's rule;
- `scan_tp`, `scan_zero3` and `scan_seq` give the reference's `ok` and
  `schedule`;
- the serving engines' `declared_schedule` at (L 3, tp 2) and
  (L 3, draft 1, spec_k 4) equals the reference's.
"""

import pytest

import helper_torch_analysis as ha
from helper_torch_parity import _rank_analysis, run_both

WORLD = 4


def reference_side():
    """The reference at 4 virtual devices: {"cases": {name: {"ok",
    "schedule"}}, "schedules": {engine case: declared schedule}}."""
    import jax

    from singa_tpu import analysis, autograd
    from singa_tpu.analysis import cases

    devs = jax.devices()[:WORLD]
    out = {"cases": {}, "schedules": {}}
    for c in cases.iter_cases(WORLD):
        if c.name not in ha.PARITY_CASES + ha.SERVE_CASES:
            continue
        autograd.set_autocast(False)
        obj, args = c.build(devs)
        if c.name in ha.SERVE_CASES:
            out["schedules"][c.name] = ha.plain_sched(
                obj.declared_schedule(obj.mesh))
            continue
        rep = analysis.lint_step(obj, *args, target=c.name)
        out["cases"][c.name] = {"ok": rep.ok, "schedule": rep.schedule,
                                "summary": rep.summary()}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's side, rank 0's results)."""
    ref_tmp = tmp_path_factory.mktemp("analysis_ref")
    rank_tmp = tmp_path_factory.mktemp("analysis_ranks")
    ref, got = run_both(
        (__name__, "reference_side", ref_tmp, {}),
        (_rank_analysis, WORLD, rank_tmp, {}))
    return ref, got[0]


@pytest.mark.parametrize("step", ["distopt_mlp", "scan_tp", "scan_seq",
                                  "scan_zero3"])
def test_the_recorder_sees_every_collective_that_runs(runs, step):
    got = runs[1]["recorder"][step]
    assert got["recorded"] == got["run"], got
    assert got["run"], got
    if step != "distopt_mlp":  # its collectives follow the backward
        assert got["phases"] == ["backward", "forward"], got
    # tp's own counter agrees: "g" forward, "f" backward, by axis
    assert got["tp_recorded"] == got["tp"], got
    if step == "scan_tp":
        assert got["tp"] == {("g", "model"): 6, ("f", "model"): 6}


@pytest.mark.parametrize("name", sorted(ha.FIXTURES))
def test_seeded_bug_is_flagged_with_the_reference_rule(runs, name):
    got = runs[1]["fixtures"][name]
    assert got["rule"] in got["rules"], got["summary"]
    if got["rule"] == "R2":
        assert got["schedule"] is not None and got["schedule"]["expected"]


@pytest.mark.parametrize("name", ha.PARITY_CASES)
def test_ok_and_schedule_equal_the_reference(runs, name):
    ref, got = runs[0]["cases"][name], runs[1]["cases"][name]
    assert got["ok"] and ref["ok"], (got["summary"], ref["summary"])
    assert got["schedule"] == ref["schedule"], (got, ref)


@pytest.mark.parametrize("name", ha.SERVE_CASES)
def test_engine_declared_schedule_equals_the_reference(runs, name):
    ref, got = runs[0]["schedules"][name], runs[1]["schedules"][name]
    assert got == ref
    assert runs[1]["cases"][name]["ok"], runs[1]["cases"][name]["summary"]
