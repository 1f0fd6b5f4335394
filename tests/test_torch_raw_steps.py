"""The port's hand-written strategy steps (`parallel.raw_steps`) against
the reference's same steps.

One spawn of 4 gloo ranks (`helper_torch_parity.run_ranks`) runs each
of the five build functions at world 4, and the reference, in a process
of its own spawned first (`run_reference`), runs its own under shard_map
on 4 virtual CPU devices; the two BERT steps start from the
reference's parameters, carried by name. Each rank's operands are the
reference's, cut by its `in_specs`, and each rank's new operands and
loss are held to the reference's step output (its block of a sharded
one) within 1e-5, relative and absolute. `raw_pipe` keeps the
reference's world factor: its update is world times the sequential
gradient (the bare psum's transpose is a psum).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from helper_torch_parity import (_rank_raw_steps, run_ranks,  # noqa: E402
                                 run_reference)

WORLD, TOL = 4, 1e-5
NAMES = ("raw_sp", "raw_ulysses", "raw_tp", "raw_ep", "raw_pipe")


def reference_side():
    """Each reference step at world 4: its operands and its step's
    outputs, as numpy (dicts stay dicts, tuples stay tuples)."""
    from singa_tpu.parallel.raw_steps import RAW_STEP_BUILDERS

    def host(tree):
        if isinstance(tree, dict):
            return {k: np.asarray(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return tuple(host(v) for v in tree)
        return np.asarray(tree)

    out = {}
    for name in NAMES:
        step, ops, _ = RAW_STEP_BUILDERS[name](4, jax.devices()[:4])
        new, loss = step(*ops)
        out[name] = dict(ops=host(ops), new=host(new), loss=float(loss))
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("test_torch_raw_steps", "reference_side",
                         tmp_path_factory.mktemp("reference"))


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    bert = {n: reference[n]["ops"][0] for n in ("raw_sp", "raw_ulysses")}
    return run_ranks(_rank_raw_steps, WORLD,
                     tmp_path_factory.mktemp("ranks"), bert_params=bert)


def close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _tp_blocks(r):
    """Rank r's slices of raw_tp's (x, w1, b1, w2, b2) on the (data 2,
    model 2) mesh, ranks row-major."""
    di, mi = divmod(r, 2)
    cols = np.s_[16 * mi:16 * mi + 16]  # 4d = 32 columns over 2
    return (np.s_[2 * di:2 * di + 2], np.s_[:, cols], cols, cols, np.s_[:])


def _blocks(name, r):
    """(slices of the operands, slices of the new operands) of rank r."""
    if name in ("raw_sp", "raw_ulysses"):
        return (None, np.s_[:, 4 * r:4 * r + 4]), None
    if name == "raw_tp":
        ops = _tp_blocks(r)
        return ops, ops[1:]
    if name == "raw_ep":
        ops = (np.s_[4 * r:4 * r + 4], np.s_[:]) + (np.s_[r:r + 1],) * 4
        return ops, ops[1:]
    return (np.s_[:], np.s_[r:r + 1]), np.s_[r:r + 1]


@pytest.mark.parametrize("name", NAMES)
def test_raw_step_matches_the_reference(ranks, reference, name):
    """The operands, the loss and every updated operand, on every rank."""
    want = reference[name]
    for r in range(WORLD):
        got = ranks[r][name]
        ops_at, new_at = _blocks(name, r)
        close(got["loss"], want["loss"], f"{name} loss, rank {r}")
        if name in ("raw_sp", "raw_ulysses"):
            close(got["ops"][1], want["ops"][1][ops_at[1]],
                  f"{name} ids, rank {r}", 0)
            for k, v in want["new"].items():
                close(got["new"][k], v, f"{name} {k}, rank {r}")
            continue
        for i, (g, w) in enumerate(zip(got["ops"], want["ops"])):
            close(g, w[ops_at[i]], f"{name} operand {i}, rank {r}", 0)
        news = got["new"] if isinstance(got["new"], tuple) else (got["new"],)
        wants = want["new"] if isinstance(want["new"], tuple) else (
            want["new"],)
        at = new_at if isinstance(new_at, tuple) else (new_at,)
        for i, (g, w) in enumerate(zip(news, wants)):
            close(g, w[at[i]], f"{name} new operand {i}, rank {r}")


def test_raw_pipe_update_is_world_times_the_sequential_gradient(ranks,
                                                                reference):
    """The reference's raw pipe step closes its loss with a bare psum,
    whose transpose is another psum: its update is 4x the sequential
    gradient, and so is the port's."""
    x, w = (torch.from_numpy(a) for a in reference["raw_pipe"]["ops"])
    w = w.clone().requires_grad_(True)
    h = x
    for s in range(WORLD):
        h = torch.tanh(h @ w[s])
    (h ** 2).sum().backward()
    g_seq = w.grad.numpy()
    want = (reference["raw_pipe"]["ops"][1]
            - reference["raw_pipe"]["new"]) / 0.1
    close(want, WORLD * g_seq, "the reference's update", 1e-4)
    for r in range(WORLD):
        got = (ranks[r]["raw_pipe"]["ops"][1]
               - ranks[r]["raw_pipe"]["new"]) / 0.1
        close(got, WORLD * g_seq[r:r + 1], f"rank {r}", 1e-4)
