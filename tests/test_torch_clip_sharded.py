"""Fault F10: a tensor-parallel model's global-norm clip
(`Optimizer.clip_gradients` under `DistOpt`) must read the norm of the
WHOLE gradient, not of the shard a rank holds.

One spawn of 2 gloo ranks (`helper_torch_parity.run_ranks`) trains the
reference's TpMLP (tests/test_tp_model.py: a plain Linear, then a column
-> row tensor-parallel pair) on a (data 1, model 2) mesh with
DistOpt(SGD(lr=0.1, clip_norm=0.01)) for 3 steps, each rank holding its
blocks of fc1 and fc2; rank 0 also trains the port's dense twin from the
same init with SGD(lr=0.1, clip_norm=0.01). The reference trains the same
model on a (1, 2) mesh of its virtual devices and on one device, in a
process of its own (`run_reference`).

A clip of 0.01 is far below the gradient norm, so every step is clipped:
a rank that clips by its own shard's norm moves its parameters by up to
2e-4 from the dense run. Held: the gathered parameters after 3 steps
against the reference's tp run and the port's dense run within 1e-6
(the gap without a clip is 6e-8), the losses within 1e-6, and the two
ranks' losses bitwise equal.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from helper_torch_parity import _rank_clip_sharded, run_ranks, run_reference  # noqa: E402

WORLD, STEPS, LR, CLIP, TOL = 2, 3, 0.1, 0.01, 1e-6


def reference_side():
    """The reference's TpMLP from the seed-0 init, trained with a clip
    on a (1, 2) mesh and on one device: init states, batch, losses and
    states after."""
    import test_tp_model as ref
    from singa_tpu import opt
    from singa_tpu import tensor as tensor_module
    from singa_tpu.parallel import mesh as ref_mesh

    def run(tp_axis, mesh):
        tensor_module.set_seed(0)
        m, x, y, _ = ref._mlp_setup(tp_axis)
        sgd = opt.SGD(lr=LR, clip_norm=CLIP)
        m.set_optimizer(sgd if mesh is None else opt.DistOpt(
            sgd, mesh=mesh, axis_name="data"))
        m.compile([x], is_train=True, use_graph=True)
        init = {k: np.asarray(t.data) for k, t in m.get_states().items()}
        losses = [float(np.asarray(m.train_one_batch(x, y)[1].data))
                  for _ in range(STEPS)]
        after = {k: np.asarray(t.data) for k, t in m.get_states().items()}
        return dict(init=init, losses=losses, after=after,
                    x=np.asarray(x.data), y=np.asarray(y.data))

    mesh = ref_mesh.get_mesh((1, 2), ("data", "model"),
                             devices=jax.devices()[:2])
    return dict(tp=run("model", mesh), single=run(None, None))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("test_torch_clip_sharded", "reference_side",
                         tmp_path_factory.mktemp("reference"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, reference):
    r = reference["tp"]
    return run_ranks(_rank_clip_sharded, WORLD,
                     tmp_path_factory.mktemp("ranks"), states=r["init"],
                     x=r["x"], y=r["y"], steps=STEPS, lr=LR, clip=CLIP)


def close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


def test_the_clipped_tp_run_matches_the_reference_and_the_dense_run(
        ranks, reference):
    want = reference["tp"]
    close(want["losses"], reference["single"]["losses"],
          "the reference's tp run vs its single device")
    dense = ranks[0]["dense"]
    for r in range(WORLD):
        got = ranks[r]["tp"]
        close(got["losses"], want["losses"], f"losses, rank {r}")
        close(got["losses"], dense["losses"], f"vs the dense run, rank {r}")
        for k, v in want["after"].items():
            close(got["after"][k], v, f"{k} after, rank {r}")
            close(got["after"][k], dense["after"][k],
                  f"{k} vs the dense run, rank {r}")


def test_both_ranks_clip_by_the_same_norm(ranks):
    np.testing.assert_array_equal(ranks[0]["tp"]["losses"],
                                  ranks[1]["tp"]["losses"])
    for k, v in ranks[0]["tp"]["after"].items():
        np.testing.assert_array_equal(ranks[1]["tp"]["after"][k], v)
