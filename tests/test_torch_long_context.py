"""The port's long-context trainer (`singa_tpu_torch.examples.
long_context`, counterpart of examples/long_context.py) on the CPU: at
world 1 in-process (a gloo group of one, the mesh (data 1, sp 1)), and
its `run` inside a 4-rank gloo group with both `--seq-impl` values
(`tests/test_examples_cli.py::test_long_context_cli_model_path`'s two
runs), one spawn for the file. A sharded run trains the same global
batch as the world-1 run, so its losses are held to it at 2e-4 (the
sequence-parallel models' tolerance, `tests/test_torch_sp_model.py`).
"""

import contextlib
import io

import numpy as np
import pytest

from helper_torch_parity import _rank_many, run_ranks
from singa_tpu_torch import distributed
from singa_tpu_torch.examples import long_context

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


def test_virtual_devices_raise_naming_the_item():
    with pytest.raises(NotImplementedError, match="item 20"):
        long_context.run(long_context.parser().parse_args(
            SMALL + ["--virtual-devices", "8"]))
