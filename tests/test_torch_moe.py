"""The Switch MoE functions of the port (`parallel/moe.py`) against
singa_tpu's (`singa_tpu/parallel/moe.py`), the port of
tests/test_parallel.py's expert-parallel cases (:188-260).

`gate_top1` (the one-hot combine and dispatch, and the auxiliary loss)
and `moe_ffn_dense` (its output, aux, and the gradients of
sum(y * r) + aux for every input) are held on the same seeded inputs
in this process. `moe_ffn` runs over an expert axis of 4 gloo ranks
(one spawn, `helper_torch_parity.run_ranks`), one expert and one row
block of the tokens a rank, against the reference's `moe_ffn` under
`shard_map` on 4 virtual devices (computed in a process of its own,
spawned at the same time as the ranks: `run_both`) and its explicit
per-shard exchange oracle: outputs,
aux and the gradients of sum(y * r) for the tokens and the expert
weights. The capacity case routes every token to expert 0: only the
per-shard capacity survives, the rest are zero rows.

Tolerance: 1e-5 (relative and absolute), the reference test's; a
gradient's absolute tolerance is 1e-5 of its largest entry.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from helper_torch_parity import _rank_moe_ffn, run_both  # noqa: E402
from singa_tpu_torch.parallel import moe  # noqa: E402

WORLD, TOL = 4, 1e-5


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def inputs():
    """tests/test_parallel.py's exchange case (world 4, 8 tokens a rank,
    d 8, ff 16) and its capacity case (every token to expert 0)."""
    n, d, ff = WORLD * 8, 8, 16
    exchange = dict(x=rand((n, d), 0), w_gate=rand((d, WORLD), 1),
                    w1=rand((WORLD, d, ff), 2), b1=rand((WORLD, ff), 3),
                    w2=rand((WORLD, ff, d), 4), b2=rand((WORLD, d), 5),
                    r=rand((n, d), 7))
    gate = np.zeros((d, WORLD), np.float32)
    gate[:, 0] = 10.0
    drops = dict(x=np.abs(rand((n, d), 6)) + 1.0, w_gate=gate,
                 w1=np.full((WORLD, d, ff), 0.01, np.float32),
                 b1=np.zeros((WORLD, ff), np.float32),
                 w2=np.full((WORLD, ff, d), 0.01, np.float32),
                 b2=np.zeros((WORLD, d), np.float32), r=rand((n, d), 8))
    return dict(exchange=exchange, drops=drops)


def reference_side():
    """The reference's gate_top1, moe_ffn_dense (with gradients) and
    moe_ffn under shard_map over 4 virtual devices (with gradients), and
    the explicit exchange oracle of tests/test_parallel.py."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from singa_tpu.parallel import mesh as mesh_module
    from singa_tpu.parallel import moe as rmoe

    out = {}
    mesh = mesh_module.get_mesh((WORLD,), ("expert",),
                                devices=jax.devices()[:WORLD])
    names = ("x", "w_gate", "w1", "b1", "w2", "b2")
    for case, c in inputs().items():
        a = {k: jnp.asarray(v) for k, v in c.items()}
        n = c["x"].shape[0]
        cap = int(math.ceil(n / WORLD * 1.25))
        comb, disp, aux = rmoe.gate_top1(a["x"], a["w_gate"], WORLD, cap)
        res = dict(combine=np.asarray(comb), dispatch=np.asarray(disp),
                   aux=float(aux), cap=cap)

        def dense_loss(*w):
            y, aux = rmoe.moe_ffn_dense(*w, WORLD)
            return jnp.sum(y * a["r"]) + aux, (y, aux)

        grads, (y, aux) = jax.grad(dense_loss, argnums=tuple(range(6)),
                                   has_aux=True)(*(a[k] for k in names))
        res["dense"] = dict(y=np.asarray(y), aux=float(aux), grads={
            k: np.asarray(g) for k, g in zip(names, grads)})

        def ep(x, g, w1, b1, w2, b2):
            return rmoe.moe_ffn(x, g, w1[0], b1[0], w2[0], b2[0], "expert")

        sharded = jax.shard_map(
            ep, mesh=mesh,
            in_specs=(P("expert"), P(), P("expert"), P("expert"),
                      P("expert"), P("expert")),
            out_specs=(P("expert"), P()), check_vma=False)

        def ep_loss(*w):
            y, aux = sharded(*w)
            return jnp.sum(y * a["r"]), (y, aux)

        grads, (y, aux) = jax.jit(jax.grad(
            ep_loss, argnums=(0, 2, 3, 4, 5), has_aux=True))(
                *(a[k] for k in names))
        res["ep"] = dict(y=np.asarray(y), aux=float(aux), grads={
            k: np.asarray(g) for k, g in zip(("x", "w1", "b1", "w2", "b2"),
                                               grads)})
        # tests/test_parallel.py's explicit per-sender-shard exchange
        n_local = n // WORLD
        cap_l = int(math.ceil(n_local / WORLD * 1.25))
        shards = a["x"].reshape(WORLD, n_local, -1)
        combines, queues = [], []
        for s in range(WORLD):
            cm, dp, _ = rmoe.gate_top1(shards[s], a["w_gate"], WORLD, cap_l)
            combines.append(cm)
            queues.append(jnp.einsum("nec,nd->ecd", dp, shards[s]))
        outs = [[None] * WORLD for _ in range(WORLD)]
        for e in range(WORLD):
            st = jnp.concatenate([queues[s][e] for s in range(WORLD)], 0)
            r = jax.nn.gelu(st @ a["w1"][e] + a["b1"][e]) @ a["w2"][e] + \
                a["b2"][e]
            for s in range(WORLD):
                outs[s][e] = r[s * cap_l:(s + 1) * cap_l]
        res["explicit"] = np.asarray(jnp.concatenate([
            jnp.einsum("nec,ecd->nd", combines[s],
                       jnp.stack([outs[s][e] for e in range(WORLD)]))
            for s in range(WORLD)], axis=0))
        res["cap_local"] = cap_l
        out[case] = res
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The reference's side and the one spawn of the ranks, at once."""
    return run_both(("test_torch_moe", "reference_side",
                     tmp_path_factory.mktemp("reference"), {}),
                    (_rank_moe_ffn, WORLD, tmp_path_factory.mktemp("ranks"),
                     dict(cases=inputs())))


@pytest.fixture(scope="module")
def reference(both):
    return both[0]


@pytest.fixture(scope="module")
def ranks(both):
    return both[1]


def close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def close_grad(got, want, what):
    """A gradient: 1e-5 relative, and 1e-5 of its largest entry absolute
    (the two packages sum the contractions in different orders)."""
    np.testing.assert_allclose(
        got, want, rtol=TOL, atol=TOL * max(1.0, float(np.abs(want).max())),
        err_msg=what)


def t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


@pytest.mark.parametrize("case", ["exchange", "drops"])
def test_gate_top1_matches_the_reference(reference, case):
    c, want = inputs()[case], reference[case]
    comb, disp, aux = moe.gate_top1(t(c["x"]), t(c["w_gate"]), WORLD,
                                    want["cap"])
    close(comb.numpy(), want["combine"], "combine")
    np.testing.assert_array_equal(disp.numpy(), want["dispatch"])
    close(float(aux), want["aux"], "aux")


@pytest.mark.parametrize("case", ["exchange", "drops"])
def test_moe_ffn_dense_matches_the_reference(reference, case):
    c, want = inputs()[case], reference[case]["dense"]
    names = ("x", "w_gate", "w1", "b1", "w2", "b2")
    a = {k: t(c[k], grad=True) for k in names}
    y, aux = moe.moe_ffn_dense(*(a[k] for k in names), WORLD)
    ((y * t(c["r"])).sum() + aux).backward()
    close(y.detach().numpy(), want["y"], "y")
    close(aux.item(), want["aux"], "aux")
    for k in names:
        close_grad(a[k].grad.numpy(), want["grads"][k], f"d{k}")


def test_moe_matches_explicit_exchange(ranks, reference):
    want = reference["exchange"]
    y = np.concatenate([ranks[r]["exchange"]["y"] for r in range(WORLD)])
    close(y, want["explicit"], "vs the explicit exchange")
    close(y, want["ep"]["y"], "vs the reference's moe_ffn")
    for r in range(WORLD):
        close(ranks[r]["exchange"]["aux"], want["ep"]["aux"], f"aux {r}")
    n = y.shape[0] // WORLD
    for k, g in want["ep"]["grads"].items():
        for r in range(WORLD):
            mine = g[r * n:(r + 1) * n] if k == "x" else g[r]
            close_grad(ranks[r]["exchange"]["grads"][k], mine,
                       f"d{k}, rank {r}")


def test_moe_capacity_drops_overflow(ranks, reference):
    """Every token prefers expert 0: only the per-shard capacity
    survives on each rank, the rest get a zero update."""
    want = reference["drops"]
    y = np.concatenate([ranks[r]["drops"]["y"] for r in range(WORLD)])
    close(y, want["ep"]["y"], "vs the reference's moe_ffn")
    assert int(np.any(y != 0, axis=-1).sum()) == WORLD * want["cap_local"]
