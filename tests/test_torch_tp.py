"""Tensor parallelism's functions (singa_tpu_torch.parallel.tp) over 2
gloo ranks, against singa_tpu's on a (2,) "model" mesh of its virtual
devices.

One spawn of 2 ranks (`helper_torch_parity.run_ranks`) computes every
case inside the model axis on the same seeded full weights: the
Megatron MLP, the head-parallel attention block, a column product
gathered by `gather_cols`, a row product; each rank's output and its
gradients of sum(out**2), the loss replicated over the axis. The
reference computes the same cases under `shard_map` with the weights
replicated in and the output replicated out, and its gradients by
`jax.grad` through the shard_map (in a process of its own,
`run_reference`). A weight a rank uses only a block of gets that
block's part of the gradient, so the ranks' gradients add up to the
reference's; a replicated leaf's gradient is the reference's on every
rank. The pre-sharded MLP and the interleaved pre-sharded attention run
on each rank's blocks; the interleave helpers are held one to one.

Tolerances are the reference tests' (tests/test_parallel.py): outputs
1e-5, gradients 2e-4 (relative and absolute).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from helper_torch_parity import (TP_FUNCTION_LEAVES, _rank_tp_funcs,  # noqa: E402
                                 run_ranks, run_reference,
                                 tp_function_arrays)
from singa_tpu_torch.parallel import mesh as mesh_module  # noqa: E402
from singa_tpu_torch.parallel import tp  # noqa: E402

WORLD = 2
OUT_TOL, GRAD_TOL = 1e-5, 2e-4
ARRAYS = tp_function_arrays(WORLD)


def reference_side():
    """The reference's cases under shard_map over its first 2 devices:
    {case: (output, {leaf: gradient})}, and the pre-sharded forms."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from singa_tpu.parallel import mesh as ref_mesh
    from singa_tpu.parallel import tp as rtp
    from singa_tpu.parallel.ring import full_attention

    mesh = ref_mesh.get_mesh((WORLD,), ("model",),
                             devices=jax.devices()[:WORLD])
    a = {k: jnp.asarray(v) for k, v in ARRAYS.items()}
    h = int(ARRAYS["heads"])
    fns = {
        "mlp": lambda x, w1, b1, w2, b2: rtp.tp_mlp(
            x, w1, b1, w2, b2, "model"),
        "attention": lambda x, wq, bq, wo, bo: rtp.tp_attention_out(
            full_attention(*rtp.tp_attention_qkv(x, wq, bq, h, "model")),
            wo, bo, "model"),
        "col_gather": lambda x, w, b: rtp.gather_cols(rtp.col_linear(
            x, rtp.shard_col(w, "model"), rtp.shard_col(b, "model")),
            "model"),
        "row": lambda x, w, b: rtp.row_linear(
            rtp.shard_col(x, "model"), rtp.shard_row(w, "model"), "model",
            b),
    }
    out = {}
    for name, fn in fns.items():
        names = TP_FUNCTION_LEAVES[name][0]
        f = jax.jit(jax.shard_map(fn, mesh=mesh,
                                  in_specs=(P(),) * len(names),
                                  out_specs=P(), check_vma=False))
        args = [a[n] for n in names]
        # jitted: an eager grad through shard_map compiles op by op
        grads = jax.jit(jax.grad(lambda *xs: jnp.sum(f(*xs) ** 2),
                                 argnums=tuple(range(len(names)))))(*args)
        out[name] = (np.asarray(f(*args)),
                     {n: np.asarray(g) for n, g in zip(names, grads)})
    w_int = rtp.interleave_qkv_shards(a["w_qkv"], WORLD)
    b_int = rtp.interleave_qkv_shards(a["b_qkv"], WORLD)
    out["attention_interleaved"] = np.asarray(jax.jit(jax.shard_map(
        lambda x, w, b, wo, bo: rtp.tp_attention_out(full_attention(
            *rtp.tp_attention_qkv(x, w, b, h, "model", pre_sharded=True)),
            wo, bo, "model", pre_sharded=True),
        mesh=mesh, in_specs=(P(), P(None, "model"), P("model"),
                             P("model", None), P()),
        out_specs=P(), check_vma=False))(a["x"], w_int, b_int, a["w_o"],
                                         a["b_o"]))
    out["mlp_pre_sharded"] = np.asarray(jax.jit(jax.shard_map(
        lambda x, w1, b1, w2, b2: rtp.tp_mlp(x, w1, b1, w2, b2, "model",
                                             pre_sharded=True),
        mesh=mesh, in_specs=(P(), P(None, "model"), P("model"),
                             P("model", None), P()),
        out_specs=P(), check_vma=False))(a["x"], a["w1"], a["b1"],
                                         a["w2"], a["b2"]))
    out["interleave"] = {
        f"{n}:{w}": np.asarray(rtp.interleave_qkv_shards(a[n], w))
        for n in ("w_qkv", "b_qkv") for w in (2, 4)}
    q, k, v = rtp.split_interleaved_qkv(
        rtp.interleave_qkv_shards(a["w_qkv"], h)[None], 16 // h)
    out["split"] = [np.asarray(t) for t in (q, k, v)]
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("test_torch_tp", "reference_side",
                         tmp_path_factory.mktemp("reference"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_rank_tp_funcs, WORLD, tmp_path_factory.mktemp("ranks"),
                     arrays=ARRAYS)


def close(got, want, what, tol=OUT_TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("case", sorted(TP_FUNCTION_LEAVES))
def test_each_function_matches_the_reference_forward_and_gradients(
        ranks, reference, case):
    want, want_grads = reference[case]
    leaves, blocked = TP_FUNCTION_LEAVES[case]
    for r in range(WORLD):
        close(ranks[r][case]["out"], want, f"{case} output, rank {r}")
    for name in leaves:
        got = [ranks[r][case][f"grad:{name}"] for r in range(WORLD)]
        if name in blocked:
            close(sum(got), want_grads[name], f"{case} d{name}, summed",
                  GRAD_TOL)
        else:
            for r in range(WORLD):
                close(got[r], want_grads[name], f"{case} d{name}, rank {r}",
                      GRAD_TOL)


def test_megatron_pairs_cost_one_all_reduce_each_way(ranks):
    """A column -> row pair is one "g" forward and one "f" backward; a
    block (attention + MLP) is PSUMS_PER_BLOCK of each."""
    for r in range(WORLD):
        for case in ("mlp", "attention"):
            assert ranks[r][case]["counts"] == {"g:model": 1,
                                                "f:model": 1}, case
        assert ranks[r]["col_gather"]["counts"] == {"f:model": 1,
                                                    "gather:model": 1}
        assert ranks[r]["row"]["counts"] == {"g:model": 1}
    assert tp.PSUMS_PER_BLOCK == 2 and tp.LOGITS_GATHERS_PER_STEP == 1


def test_the_pre_sharded_forms_on_each_ranks_blocks(ranks, reference):
    for r in range(WORLD):
        close(ranks[r]["mlp_pre_sharded"], reference["mlp_pre_sharded"],
              f"pre-sharded MLP, rank {r}")
        close(ranks[r]["attention_interleaved"],
              reference["attention_interleaved"],
              f"interleaved attention, rank {r}")


def test_the_divisibility_guard_and_the_dense_forms(ranks, reference):
    for r in range(WORLD):
        assert "not divisible by axis size 2" in ranks[r]["guard"]
        # outside the axis: the dense function, no collective
        assert ranks[r]["dense_collectives"] == 0
        for case in TP_FUNCTION_LEAVES:
            close(ranks[r]["dense"][case], reference[case][0],
                  f"dense {case}, rank {r}")


def test_the_interleave_helpers_match_the_reference(reference):
    a = {k: torch.from_numpy(v) for k, v in ARRAYS.items()}
    h = int(ARRAYS["heads"])
    for key, want in reference["interleave"].items():
        name, world = key.split(":")
        got = tp.interleave_qkv_shards(a[name], int(world))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            tp.deinterleave_qkv_shards(got, int(world)).numpy(),
            ARRAYS[name])
    got = tp.split_interleaved_qkv(
        tp.interleave_qkv_shards(a["w_qkv"], h)[None], 16 // h)
    for g, w in zip(got, reference["split"]):
        np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="multiple of 3\\*head_dim"):
        tp.split_interleaved_qkv(torch.zeros(1, 2, 10), 4)


def test_without_a_group_every_function_is_dense():
    """A mesh of one process with no group: the axis is live, its size
    is 1 and the guards are the identity."""
    mesh = mesh_module.get_mesh((1,), ("model",))
    x = torch.from_numpy(ARRAYS["x"])
    with mesh_module.axes_context("model", mesh=mesh):
        y = tp.tp_mlp(x, *(torch.from_numpy(ARRAYS[n])
                           for n in ("w1", "b1", "w2", "b2")), "model")
        assert tp.gather_cols(x, "model") is x
    dense = torch.nn.functional.gelu(
        x @ torch.from_numpy(ARRAYS["w1"]) + torch.from_numpy(ARRAYS["b1"]),
        approximate="tanh") @ torch.from_numpy(ARRAYS["w2"]) \
        + torch.from_numpy(ARRAYS["b2"])
    close(y.numpy(), dense.numpy(), "dense MLP")
