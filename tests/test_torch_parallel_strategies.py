"""The port's strategies runner (`examples/parallel_strategies.py`, the
counterpart of examples/parallel_strategies.py and of the reference's
`__graft_entry__.run_all_strategies`) at world 4 over gloo: one spawn of
4 ranks (`helper_torch_parity.run_ranks`) runs every entry, each rank
printing every line. Held: every entry's line in the reference's order
(each entry trains its steps with finite losses or raises), the skip
notices of the entries a world of 4 does not factor, the native DP
entry's line naming its ROADMAP item, and the closing line. The runner
at world 2, through `--virtual-devices 2`, runs to its closing line.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest

from helper_torch_parity import _rank_strategies, run_ranks

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4

#: the reference's lines at world 4 (`__graft_entry__.run_all_strategies`
#: and its `_dryrun_*` helpers), in order; a trailing "(...)" detail is
#: matched by pattern
EXPECTED = [
    r"\[dryrun\] DP dist_option=plain: ok",
    r"\[dryrun\] DP dist_option=half: ok",
    r"\[dryrun\] DP dist_option=sparse-topk: ok",
    r"\[dryrun\] DP dist_option=sparse-thresh: ok",
    r"\[dryrun\] DP zero-1 \(shard_states\): ok",
    r"\[dryrun\] DP zero-1 half-wire \(bf16 rs/ag\): ok",
    r"\[dryrun\] DP native C\+\+ training step \(hlo_bridge\): ok",
    r"\[dryrun\] scan x TP GPT \(train_one_batch\): ok",
    r"\[dryrun\] DP zero-3 scan stack \(per-block gather\): ok \(per-shard "
    r"parameter bytes \d+\)",
    r"\[dryrun\] scan x \(TP x ZeRO-3\) GPT \(train_one_batch, per_block "
    r"re-gather\): ok \(per-shard parameter bytes \d+\)",
    r"\[dryrun\] scan x seq ring GPT \(train_one_batch\): ok \(per-device "
    r"attention bytes \d+\)",
    r"\[dryrun\] scan x \(TP x ZeRO-3\) x seq 3D GPT \(train_one_batch\): "
    r"ok \(per-shard parameter bytes \d+, per-device attention bytes \d+\)",
    r"\[dryrun\] scan x ZeRO-3 overlap \(double-buffered prefetch\): ok "
    r"\(gathered block bytes \d+ = 2 live blocks\)",
    r"\[dryrun\] scan x \(TP x ZeRO-3\) x seq 3D overlap \(prefetch \+ "
    r"pipelined ring, per_block re-gather\): ok \(gathered block bytes "
    r"\d+\)",
    r"\[dryrun\] DP zero-1 overlap \(bucketed reduce_scatter\): ok \(\d+ "
    r"independent buckets\)",
    r"\[dryrun\] SP ring attention: ok",
    r"\[dryrun\] SP ulysses \(all-to-all\): ok",
    r"\[dryrun\] SP model-level \(train_one_batch\): ok",
    r"\[dryrun\] TP megatron mlp: ok",
    r"\[dryrun\] TP model-level: ok",
    r"\[dryrun\] EP moe all_to_all: ok",
    r"\[dryrun\] EP model-level \(train_one_batch\): ok",
    r"\[dryrun\] PP gpipe ppermute: ok",
    r"\[dryrun\] PP model-level \(train_one_batch\): ok",
    r"\[dryrun\] PP transformer GPT \(train_one_batch\): ok",
    r"\[dryrun\] 3-axis hybrid: skipped \(needs a multiple of 8 devices, "
    r"have 4\)",
    r"dp \(DistOpt graph step: plain/half/sparse/ZeRO sync\), sp \(ring \+ "
    r"ulysses \+ model-level GPT\), tp \(Megatron MLP \+ model-level BERT\), "
    r"ep \(MoE all_to_all \+ model-level MoE-GPT\), pp \(GPipe scan \+ "
    r"model-level transformer GPT\): OK",
]


@pytest.fixture(scope="module")
def world_two():
    """`python -m singa_tpu_torch.examples.parallel_strategies
    --virtual-devices 2 --device cpu`, started before the 4-rank spawn
    so that it runs beside it."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "singa_tpu_torch.examples.parallel_strategies",
         "--virtual-devices", "2", "--device", "cpu"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def lines(tmp_path_factory, world_two):
    return run_ranks(_rank_strategies, WORLD,
                     tmp_path_factory.mktemp("ranks"))


def test_every_entry_prints_its_line_in_the_reference_order(lines):
    for r in range(WORLD):
        got = [ln for ln in lines[r] if ln.startswith(("[dryrun]", "dp ("))]
        assert len(got) == len(EXPECTED), (r, got)
        for g, want in zip(got, EXPECTED):
            assert re.fullmatch(want, g), (r, g, want)


def test_the_hybrid_prints_its_skip_notice(lines):
    for r in range(WORLD):
        assert ("[dryrun] 3-axis hybrid: skipped (needs a multiple of 8 "
                "devices, have 4)") in lines[r]


def test_native_dp_names_its_roadmap_item(lines):
    """The native DP entry (ROADMAP queue 1 item 22, ported) runs the
    C++-emitted module on every rank and prints the reference's line."""
    for r in range(WORLD):
        native = [ln for ln in lines[r] if "native" in ln]
        assert native == [
            "[dryrun] DP native C++ training step (hlo_bridge): ok"], native


def test_the_closing_line_is_printed_last(lines):
    for r in range(WORLD):
        assert lines[r][-1].startswith("dp (DistOpt graph step") and \
            lines[r][-1].endswith(": OK")


def test_world_two_through_virtual_devices(world_two):
    """At world 2 (two gloo ranks through `--virtual-devices 2`) the sp
    and ep cases' meshes are (data 2, sp 1) and (data 2, expert 1): an
    axis of one rank adds nothing to DistOpt's `grad_axes`, and the
    runner checks the axis only where it has more than one rank (it
    checked wherever the world did, and failed here)."""
    out, err = world_two.communicate(timeout=120)
    assert world_two.returncode == 0, err
    got = out.splitlines()
    assert "[dryrun] SP model-level (train_one_batch): ok" in got
    assert "[dryrun] EP model-level (train_one_batch): ok" in got
    assert got[-1].startswith("dp (DistOpt graph step") and \
        got[-1].endswith(": OK")
