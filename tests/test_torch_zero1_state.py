"""ZeRO-1 of the port over 2 ranks, its state forms and its trainer:
`DistOpt(shard_states=True)` and its wires against singa_tpu's on a
2-device virtual mesh, a reference `(world, chunk)` dump loading row by
row, the scatter and gather along another axis, and `gpt_lm
--shard-states` over 2 ranks against one process of the global batch.

The port runs in 2 spawned processes over gloo (one spawn for the whole
file, `helper_torch_parity.run_ranks`); the reference under `shard_map`
over the first 2 devices of its 8-device mesh, in a process of its own
(`helper_torch_parity.run_reference`, F8's follow-up). Tolerances (relative and
absolute): fp32 1e-5; the bf16 wires 1e-2. On the CPU the trainer runs
the port's plain attention. The attention's K bias has a gradient of 0
analytically (softmax ignores a shift shared by a row), so AdamW moves
it by g / (|g| + eps) of rounding noise: it is held to AdamW's step
size, 2 lr a step (as tests/test_torch_train_gpt.py holds it).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from helper_torch_parity import (_rank_many, ref_zero1,  # noqa: E402
                                 run_ranks, run_reference, zero1_data)
from singa_tpu_torch import distributed  # noqa: E402
from singa_tpu_torch.examples import gpt_lm  # noqa: E402

WORLD = 2
STEPS, LR = 3, 0.1
FP32, BF16 = 1e-5, 1e-2
CASES = {"zero": dict(shard_states=True),
         "half_wire": dict(shard_states=True, half_wire=True),
         "gather_half": dict(shard_states=True, gather_half=True),
         "overlap": dict(shard_states=True, overlap=True, buffSize=64)}
#: gpt_lm at a tiny width, dropout off, 2 sequences a rank
GPT_ARGV = ["--device", "cpu", "--steps", "3", "--seq", "32", "--d-model",
            "32", "--heads", "2", "--dropout", "0", "--sample-chars", "0",
            "--shard-states"]


def scatter_inputs():
    return np.random.default_rng(0).standard_normal(
        (WORLD, 3, 4 * WORLD)).astype(np.float32)


def reference_side():
    """The reference's ZeRO-1 runs on its 2-device mesh (run by
    `run_reference` in a process of its own, F8)."""
    refs = {name: ref_zero1(WORLD, kw, None, 0.0, "mlp", "plain", 3, STEPS,
                            LR) for name, kw in CASES.items()}
    refs["resume"] = ref_zero1(WORLD, CASES["zero"], None, 0.0, "mlp",
                               "plain", 4, STEPS + 1, LR,
                               snapshot_at=STEPS)
    return refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of 2 gloo ranks for the whole file; the reference's side
    in a process of its own."""
    X, y = zero1_data("mlp")
    refs = run_reference("test_torch_zero1_state", "reference_side",
                         tmp_path_factory.mktemp("reference"))
    calls = [(name, "_rank_zero1", dict(
        params=refs[name]["params"], X=X, y=y, steps=STEPS, lr=LR,
        distkw=kw)) for name, kw in CASES.items()]
    params, dump = refs["resume"]["snapshot"]
    calls.append(("resume", "_rank_zero1", dict(
        params=params, X=X, y=y, steps=1, lr=LR, distkw=CASES["zero"],
        states=dump)))
    calls.append(("scatter", "_rank_scatter_axis",
                  dict(xs=scatter_inputs())))
    calls.append(("gpt_lm", "_rank_gpt_lm", dict(
        argv=[*GPT_ARGV, "--batch", "2"])))
    port = run_ranks(_rank_many, WORLD, tmp_path_factory.mktemp("ranks"),
                     calls=calls)
    return refs, port


def close(got, want, what, tol=FP32):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_zero1_over_two_ranks_matches_the_reference(runs, case):
    refs, port = runs
    ref = refs[case]
    tol = BF16 if case in ("half_wire", "gather_half") else FP32
    total = sum(v.size for v in ref["params"].values())
    for r in range(WORLD):
        got = port[r][case]
        close(got["losses"], ref["losses"], f"{case} losses", tol)
        for k, v in ref["after"].items():
            close(got[f"param:{k}"], v, f"{case} {k}, rank {r}", tol)
        for k, v in ref["dump"].items():
            if "//__zshard__" in k:
                close(got[f"state:{k}"], v[r:r + 1], f"{case} {k}", tol)
        if case != "overlap":
            assert int(got["chunk"]) == -(-total // WORLD)
        assert bool(got["reshard_roundtrip"]) and bool(got["raw_roundtrip"])


def test_a_reference_dump_loads_row_by_row_and_the_next_step_matches(runs):
    """The reference's dump after 3 steps, `(2, chunk)` slots, loads into
    each rank as its row; the 4th step then equals the reference's."""
    refs, port = runs
    ref = refs["resume"]
    _, dump = ref["snapshot"]
    for r in range(WORLD):
        got = port[r]["resume"]
        close(got["losses"], ref["losses"][-1:], "4th loss")
        for k, v in ref["after"].items():
            close(got[f"param:{k}"], v, f"{k} after the 4th step, rank {r}")
        for k, v in ref["dump"].items():
            if "//__zshard__" in k:
                assert dump[k].shape[0] == WORLD
                close(got[f"state:{k}"], v[r:r + 1], f"{k}, rank {r}")
        assert int(got["state:__step__"]) == STEPS + 1


def test_scatter_and_gather_along_another_axis(runs):
    """Axis 1 through `movedim`: this rank's chunk of the sum (and the
    mean), and the ranks' pieces side by side; the bf16 wires round."""
    _, port = runs
    xs = scatter_inputs()
    total = xs.sum(0)
    chunk = xs.shape[2] // WORLD

    def bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16).float().numpy()

    gathered = np.concatenate(list(xs), axis=1)
    for r in range(WORLD):
        got = port[r]["scatter"]
        mine = total[:, r * chunk:(r + 1) * chunk]
        close(got["reduce_scatter_sum"], mine, "reduce_scatter sum")
        close(got["reduce_scatter"], mine / WORLD, "reduce_scatter mean")
        close(got["reduce_scatter_half"], mine / WORLD, "half", BF16)
        np.testing.assert_array_equal(got["all_gather"], gathered)
        np.testing.assert_array_equal(got["all_gather_half"],
                                      bf16(gathered))


def test_gpt_lm_shard_states_over_two_ranks_is_one_process_of_the_batch(
        runs, capsys):
    """`gpt_lm --shard-states` inside a group of 2 (2 sequences a rank)
    trains as one process of the global batch of 4 (its world-1 gloo
    group): the same losses and parameters."""
    _, port = runs
    try:
        out = gpt_lm.run(gpt_lm.parser().parse_args([*GPT_ARGV, "--batch",
                                                     "4"]))
    finally:
        distributed.shutdown()
    assert out["world"] == 1
    assert "(ZeRO-1 sharded slots)" in capsys.readouterr().out
    for r in range(WORLD):
        got = port[r]["gpt_lm"]
        assert int(got["world"]) == WORLD
        close(got["losses"], out["losses"], f"gpt_lm losses, rank {r}")
        for k, v in out["model"].get_params().items():
            want, have = v.detach().numpy(), got[f"param:{k}"]
            if k.endswith("attn.b_qkv"):  # the K bias: Adam's noise
                d = want.shape[0] // 3
                assert np.abs(have - want)[d:2 * d].max() <= 2 * 3e-3 * 3
                want, have = np.delete(want, np.s_[d:2 * d]), np.delete(
                    have, np.s_[d:2 * d])
            close(have, want, f"gpt_lm {k}")
    assert out["losses"][-1] < out["losses"][0]


def test_gpt_lm_shard_states_trains_on_one_process_and_leaves_no_group(
        capsys):
    gpt_lm.main([*GPT_ARGV, "--batch", "2", "--dropout", "0.1",
                 "--sample-chars", "8"])
    out = capsys.readouterr().out
    assert "DistOpt over 1 chips (gloo) (ZeRO-1 sharded slots)" in out
    assert "--- sample ---" in out
    assert not distributed.is_initialized()
