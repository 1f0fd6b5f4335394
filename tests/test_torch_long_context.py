"""The port's long-context trainer (`singa_tpu_torch.examples.
long_context`, counterpart of examples/long_context.py) on the CPU: at
world 1 in-process (a gloo group of one, the mesh (data 1, sp 1)), and
its `run` inside a 4-rank gloo group with both `--seq-impl` values
(`tests/test_examples_cli.py::test_long_context_cli_model_path`'s two
runs), one spawn for the file. A sharded run trains the same global
batch as the world-1 run, so its losses are held to it at 2e-4 (the
sequence-parallel models' tolerance, `tests/test_torch_sp_model.py`).
`--virtual-devices 2` (two gloo ranks, one process each) is held to the
reference's `--virtual-devices 2` within 1e-4.
"""

import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from helper_torch_parity import _rank_many, run_ranks
from singa_tpu_torch import distributed
from singa_tpu_torch.examples import long_context

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--steps", "2", "--seq-len", "128",
         "--layers", "1", "--d-model", "64"]
RING = SMALL + ["--heads", "2"]
ULYSSES = SMALL + ["--heads", "4", "--dp", "2", "--seq-impl", "ulysses"]


def world_one(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        long_context.main(argv)
    assert not distributed.is_initialized()
    return out.getvalue()


def losses(text):
    return [float(line.split("loss ")[1].split()[0])
            for line in text.splitlines() if line.startswith("step ")]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_rank_many, 4, tmp_path_factory.mktemp("ranks"),
                     calls=[("ring", "_rank_long_context", dict(argv=RING)),
                            ("ulysses", "_rank_long_context",
                             dict(argv=ULYSSES))])


def test_world_one_trains_in_process():
    out = world_one(RING)
    assert "mesh (data=1, sp=1)" in out and "impl=ring" in out
    assert "step 1" in out and len(losses(out)) == 2


def test_ring_over_four_ranks_matches_world_one(ranks):
    assert ranks[0]["ring"]["mesh"] == {"data": 1, "sp": 4}
    want = losses(world_one(RING))
    for r in ranks:
        np.testing.assert_allclose(r["ring"]["losses"], want, rtol=2e-4,
                                   atol=2e-4)


def test_ulysses_over_two_by_two_matches_world_one(ranks):
    assert ranks[0]["ulysses"]["mesh"] == {"data": 2, "sp": 2}
    # the 2 x 2 run's global batch is --batch 2 times dp 2
    out = world_one(SMALL + ["--heads", "4", "--batch", "4",
                             "--seq-impl", "ulysses"])
    assert "impl=ulysses" in out
    for r in ranks:
        np.testing.assert_allclose(r["ulysses"]["losses"], losses(out),
                                   rtol=2e-4, atol=2e-4)


def test_virtual_devices_raise_naming_the_item(tmp_path):
    """`--virtual-devices 2` runs the trainer as two gloo ranks, one
    process each (mesh (data 1, sp 2): the ring over both), and its
    losses equal the reference's `examples/long_context.py
    --virtual-devices 2` with the same flags, started from the port's
    initial weights (`tests/helper_torch_virtual.py`: the packages draw
    their initial weights from different generators), within 1e-4.
    Step 1 holds the gradient sync over sp: with each rank's own
    gradient in place of the average, its loss is 6.9232, not 6.9411."""
    states = tmp_path / "init.zip"
    out = long_context.run(long_context.parser().parse_args(
        RING + ["--steps", "0"]))
    out["model"].save_states(str(states))
    distributed.shutdown()
    ref = subprocess.Popen(
        [sys.executable, "tests/helper_torch_virtual.py",
         "examples/long_context.py", "--virtual-devices", "2", *RING[2:]],
        cwd=ROOT, env=dict(os.environ, SINGA_TORCH_INIT_STATES=str(states)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = subprocess.run(
        [sys.executable, "-m", "singa_tpu_torch.examples.long_context",
         "--virtual-devices", "2", *RING], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    want, err = ref.communicate(timeout=120)
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, err
    assert "mesh (data=1, sp=2)" in port.stdout
    assert "mesh (data=1, sp=2)" in want
    assert len(losses(port.stdout)) == 2
    np.testing.assert_allclose(losses(port.stdout), losses(want), rtol=1e-4,
                               atol=1e-4)
