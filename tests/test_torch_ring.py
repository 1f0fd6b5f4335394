"""Ring and Ulysses attention of the port (singa_tpu_torch.parallel.ring,
.ulysses) over 2 and 4 gloo ranks.

Every case runs in one spawn of ranks per world (`helper_torch_parity.
run_ranks`): each rank holds its shard of the sequence of the same
seeded global q, k, v and returns its output shard and the gradients of
sum(sin(out)) for its q, k, v shards. They are held against the port's
`full_attention` over the whole sequence and its gradients (the
reference's ring gradients are no oracle: its own
`test_ring_attention_grads_match_full` fails on this container), and
the fp32 forwards also against singa_tpu's ring and Ulysses on its
virtual mesh, computed in a process of its own
(`helper_torch_parity.run_reference`).

Cases: the plain ring and the ring with flash blocks, serial and
pipelined, causal and not, with fp32 and bf16 inputs; Ulysses plain
and through the flash kernels, with and without remat, causal and not.
Head dim 32, which the flash kernels take.

Tolerances are the reference tests' (`tests/test_parallel.py:324-530`,
`tests/test_transformer.py:41-61`, `tests/test_scan_overlap.py:43-75`):
fp32 outputs 2e-5, fp32 gradients 5e-5, bf16 outputs 3e-2 (relative and
absolute); bf16 gradients, which the reference does not test, 3e-2 of
the largest gradient (one bf16 rounding of each shard's gradient).
"""

import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from helper_torch_parity import _rank_ring, run_ranks, run_reference  # noqa: E402
from singa_tpu_torch.parallel.ring import (  # noqa: E402
    KV_TENSORS_PER_HOP, full_attention, ring_permutation, rotation_steps)

B, H, T_LOCAL, D = 1, 4, 16, 32
WORLDS = (2, 4)


def qkv(world):
    rng = np.random.default_rng(world)
    return tuple(rng.standard_normal((B, H, world * T_LOCAL, D)).astype(
        np.float32) for _ in range(3))


def _cases():
    out = {}
    for flash, pipe, causal, dt in itertools.product(
            (False, True), (False, True), (False, True),
            ("float32", "bfloat16")):
        name = (f"ring-{'flash' if flash else 'plain'}-"
                f"{'pipelined' if pipe else 'serial'}-"
                f"{'causal' if causal else 'bidir'}-{dt}")
        out[name] = dict(impl="ring", use_flash=flash, pipelined=pipe,
                         causal=causal, dtype=dt, remat=True)
    for flash, remat, causal in itertools.product(
            (False, True), (False, True), (False, True)):
        name = (f"ulysses-{'flash' if flash else 'plain'}-"
                f"{'remat' if remat else 'store'}-"
                f"{'causal' if causal else 'bidir'}-float32")
        out[name] = dict(impl="ulysses", use_flash=flash, pipelined=False,
                         causal=causal, dtype="float32", remat=remat)
    return out


CASES = _cases()


def reference_side():
    """singa_tpu's ring (plain and flash) and Ulysses (plain and flash)
    forwards over `world` shards of its virtual mesh, causal and not,
    on the fp32 inputs of each world (run in a process of its own)."""
    from jax.sharding import PartitionSpec as P

    from singa_tpu.parallel import mesh as mesh_module
    from singa_tpu.parallel.ring import ring_attention
    from singa_tpu.parallel.ulysses import ulysses_attention

    out = {}
    for world in WORLDS:
        q, k, v = qkv(world)
        mesh = mesh_module.get_mesh((world,), ("sp",),
                                    devices=jax.devices()[:world])
        spec = (P(None, None, "sp"),) * 3
        for impl, flash, causal in itertools.product(
                ("ring", "ulysses"), (False, True), (False, True)):
            if impl == "ring":
                def fn(a, b, c, flash=flash, causal=causal):
                    return ring_attention(a, b, c, "sp", causal=causal,
                                          use_flash=flash)
            else:
                def fn(a, b, c, flash=flash, causal=causal):
                    return ulysses_attention(a, b, c, "sp", causal=causal,
                                             use_flash=flash)
            got = jax.jit(jax.shard_map(
                fn, mesh=mesh, in_specs=spec, out_specs=P(None, None, "sp"),
                check_vma=False))(q, k, v)
            out[(world, impl, flash, causal)] = np.asarray(got)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("test_torch_ring", "reference_side",
                         tmp_path_factory.mktemp("reference"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn a world: every case on each rank."""
    out = {}
    for world in WORLDS:
        q, k, v = qkv(world)
        out[world] = run_ranks(_rank_ring, world,
                               tmp_path_factory.mktemp(f"ranks{world}"),
                               q=q, k=k, v=v, cases=CASES)
    return out


def full(world, causal, dtype):
    """The port's full_attention over the whole sequence (on the inputs
    rounded to `dtype`, computed in fp32) and the gradients of
    sum(sin(out))."""
    xs = [torch.from_numpy(a).to(getattr(torch, dtype)).float()
          .requires_grad_() for a in qkv(world)]
    o = full_attention(*xs, causal=causal)
    torch.sin(o).sum().backward()
    return o.detach().numpy(), [x.grad.numpy() for x in xs]


def joined(ranks, name, key):
    return np.concatenate([r[name][key] for r in ranks], axis=2)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_outputs_and_gradients_match_full_attention(runs, world, name):
    c = CASES[name]
    want_o, want_g = full(world, c["causal"], c["dtype"])
    ranks = runs[world]
    assert ranks[0][name]["dtype"] == f"torch.{c['dtype']}"
    if c["dtype"] == "float32":
        np.testing.assert_allclose(joined(ranks, name, "o"), want_o,
                                   rtol=2e-5, atol=2e-5)
        for g, w in zip(("dq", "dk", "dv"), want_g):
            np.testing.assert_allclose(joined(ranks, name, g), w,
                                       rtol=5e-5, atol=5e-5, err_msg=g)
    else:
        np.testing.assert_allclose(joined(ranks, name, "o"), want_o,
                                   rtol=3e-2, atol=3e-2)
        for g, w in zip(("dq", "dk", "dv"), want_g):
            err = np.abs(joined(ranks, name, g) - w).max()
            assert err <= 3e-2 * max(1.0, np.abs(w).max()), (g, err)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("impl,flash,causal", list(itertools.product(
    ("ring", "ulysses"), (False, True), (False, True))))
def test_forward_matches_the_reference(runs, reference, world, impl, flash,
                                       causal):
    name = next(n for n, c in CASES.items()
                if c["impl"] == impl and c["use_flash"] == flash
                and c["causal"] == causal and c["dtype"] == "float32"
                and not c["pipelined"])
    np.testing.assert_allclose(joined(runs[world], name, "o"),
                               reference[(world, impl, flash, causal)],
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_ulysses_refuses_heads_the_axis_does_not_divide(runs, world):
    for r in runs[world]:
        assert f"{world - 1} heads do not divide over {world}-way axis" in (
            r["head_guard"])


def test_schedule_names_match_the_reference():
    from singa_tpu.parallel import ring as ref_ring

    for w in (1, 2, 4, 8):
        assert ring_permutation(w) == ref_ring.ring_permutation(w)
        assert rotation_steps(w) == ref_ring.rotation_steps(w)
    assert KV_TENSORS_PER_HOP == ref_ring.KV_TENSORS_PER_HOP


def test_world_one_ring_is_the_flash_kernels_own_output():
    """Outside a group the axis has one rank: the ring is one diagonal
    block, which equals the flash kernel's plain version, and Ulysses
    moves nothing."""
    from singa_tpu_torch.ops import flash_attention as fa
    from singa_tpu_torch.parallel import mesh as mesh_module
    from singa_tpu_torch.parallel.ring import ring_attention
    from singa_tpu_torch.parallel.ulysses import ulysses_attention

    q, k, v = (torch.from_numpy(a) for a in qkv(2))
    mesh = mesh_module.get_mesh((1,), ("sp",))
    with mesh_module.axes_context("sp", mesh=mesh):
        assert mesh_module.axis_size("sp") == 1
        got = ring_attention(q, k, v, "sp", causal=True, use_flash=True)
        uly = ulysses_attention(q, k, v, "sp", causal=True, use_flash=True)
    want = fa.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, want)
    assert torch.equal(uly, want)
