"""ZeRO-1 of the port (`DistOpt(shard_states=True)` with `half_wire`,
`gather_half` and `overlap`), held against singa_tpu's on its virtual
CPU mesh, as `tests/test_zero1.py` holds the reference to plain DP.

The port runs in 4 spawned processes over gloo (one spawn for the whole
file, `helper_torch_parity.run_ranks`); the reference runs the same
seeded MLP on the same global batch under `shard_map` over the first 4
devices of its 8-device mesh, in a process of its own
(`helper_torch_parity.run_reference`, F8's follow-up). Each rank's losses, parameters and ZeRO-1
rows are held to the reference's, the rows to the reference's row of
that rank. A canonical dump of the 4 ranks then takes one more step on
ranks 0-1 as a group of 2 and on the reference's 2-device mesh.

Tolerances (relative and absolute): fp32 1e-5 (the two packages' sums
add in different orders); the bf16 wires 1e-2 (XLA and gloo round their
bf16 sums at different points); equalities inside the port that change
no arithmetic are bitwise.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from helper_torch_parity import (_rank_many, port_mlp,  # noqa: E402
                                 ref_zero1, ref_zero1_continue, run_ranks,
                                 run_reference, zero1_data)
from singa_tpu_torch import autograd, communicator, opt  # noqa: E402

WORLD = 4
STEPS, LR = 3, 0.1
FP32, BF16 = 1e-5, 1e-2
#: each case: (the reference's DistOpt keywords, clip_norm, weight decay,
#: the model, dist_option, seed)
CASES = {
    "zero": (dict(shard_states=True), None, 0.0, "mlp", "plain", 3),
    "clip": (dict(shard_states=True), 0.5, 0.0, "mlp", "plain", 3),
    "half_wire": (dict(shard_states=True, half_wire=True), None, 0.0, "mlp",
                  "plain", 3),
    "gather_half": (dict(shard_states=True, gather_half=True), None, 0.0,
                    "mlp", "plain", 3),
    "overlap": (dict(shard_states=True, overlap=True, buffSize=64), None,
                0.0, "mlp", "plain", 3),
    "two_head": (dict(shard_states=True), None, 1e-2, "two_head", "plain",
                 7),
}
#: the port's plain-DP runs the ZeRO-1 ones are held to
PLAIN = {"plain": ({}, None, "plain"), "plain_clip": ({}, 0.5, "plain"),
         "plain_half": ({}, None, "half")}
BF16_CASES = ("half_wire", "gather_half")


def reference_side():
    """The reference's ZeRO-1 run of every case on its 4-device mesh and
    its world-1 runs with and without ZeRO-1 (run by `run_reference` in
    a process of its own, F8)."""
    out = {name: ref_zero1(WORLD, *case, STEPS, LR)
           for name, case in CASES.items()}
    out["world1_zero"] = ref_zero1(1, dict(shard_states=True), None, 0.0,
                                   "mlp", "plain", 5, STEPS, LR)
    out["world1_plain"] = ref_zero1(1, {}, None, 0.0, "mlp", "plain", 5,
                                    STEPS, LR)
    return out


def reference_continue(after, canon):
    """The reference's next step from a canonical dump on its 2-device
    mesh (for `run_reference`)."""
    return ref_zero1_continue(2, after, canon, 3, LR)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("test_torch_zero1", "reference_side",
                         tmp_path_factory.mktemp("reference"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, reference):
    """One spawn of 4 gloo ranks for the whole file: every ZeRO-1 case
    and the port's plain-DP runs; beside them, the reference's."""
    refs = {name: reference[name] for name in CASES}
    calls = []
    for name, (distkw, clip, wd, kind, option, _) in CASES.items():
        X, y = zero1_data(kind)
        calls.append((name, "_rank_zero1", dict(
            params=refs[name]["params"], X=X, y=y, steps=STEPS, lr=LR,
            distkw=distkw, clip_norm=clip, wd=wd,
            two_head=kind == "two_head", dist_option=option,
            reshard_to=2 if name == "zero" else None)))
    X, y = zero1_data("mlp")
    for name, (distkw, clip, option) in PLAIN.items():
        calls.append((name, "_rank_zero1", dict(
            params=refs["zero"]["params"], X=X, y=y, steps=STEPS, lr=LR,
            distkw=distkw, clip_norm=clip, dist_option=option)))
    port = run_ranks(_rank_many, WORLD, tmp_path_factory.mktemp("ranks"),
                     calls=calls)
    return refs, port


def close(got, want, what, tol=FP32):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def zrows(dump):
    return sorted(k for k in dump if "//__zshard__" in k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_zero1_matches_the_reference(runs, case):
    """Every rank's losses and parameters after 3 steps, and its ZeRO-1
    slot (and master) row against the reference's row of that rank."""
    refs, port = runs
    ref = refs[case]
    tol = BF16 if case in BF16_CASES else FP32
    assert zrows(ref["dump"])
    for r in range(WORLD):
        got = port[r][case]
        close(got["losses"], ref["losses"], f"{case} losses, rank {r}", tol)
        for k, v in ref["after"].items():
            close(got[f"param:{k}"], v, f"{case} {k}, rank {r}", tol)
        for k in zrows(ref["dump"]):
            close(got[f"state:{k}"], ref["dump"][k][r:r + 1],
                  f"{case} {k}, rank {r}", tol)
        assert int(got["state:__step__"]) == STEPS


@pytest.mark.parametrize("case,plain,tol", [
    ("zero", "plain", FP32), ("clip", "plain_clip", FP32),
    ("overlap", "plain", FP32), ("half_wire", "plain_half", BF16)])
def test_zero1_matches_the_ports_plain_data_parallel_step(runs, case, plain,
                                                          tol):
    """ZeRO-1 (with clipping: the global norm from the group's square
    sum) against the port's plain DistOpt, and the bf16-wire
    reduce-scatter against the plain `half` all-reduce."""
    _, port = runs
    for r in range(WORLD):
        got, want = port[r][case], port[r][plain]
        close(got["losses"], want["losses"], f"{case} losses", tol)
        for k in want:
            if k.startswith("param:"):
                close(got[k], want[k], f"{case} {k}, rank {r}", tol)


def test_each_rank_holds_ceil_total_over_world_slot_elements(runs):
    refs, port = runs
    total = sum(v.size for v in refs["zero"]["params"].values())
    chunk = -(-total // WORLD)
    for r in range(WORLD):
        got = port[r]["zero"]
        assert int(got["chunk"]) == chunk
        assert got["state:__zero1__//__zshard__//momentum"].shape == (
            1, chunk)
        plain = sum(v.size for k, v in port[r]["plain"].items()
                    if k.endswith("//momentum"))
        assert plain == total
    assert refs["zero"]["dump"]["__zero1__//__zshard__//momentum"].shape \
        == (WORLD, chunk)


def test_gradient_less_parameters_are_left_untouched(runs):
    """The head the loss never reaches keeps its values and its slot
    coordinates (0) under weight decay and momentum, as the reference's
    (tests/test_zero1.py::test_gradless_params_left_untouched)."""
    refs, port = runs
    start = refs["two_head"]["params"]
    canon = port[0]["two_head"]["canon:__zero1__//__zshard__//momentum"]
    sizes = [(k, v.size) for k, v in start.items()]
    off = 0
    for k, n in sizes:
        if k.startswith("unused"):
            assert not canon[off:off + n].any(), k
            for r in range(WORLD):
                np.testing.assert_array_equal(
                    port[r]["two_head"][f"param:{k}"], start[k])
        else:
            assert canon[off:off + n].any(), k
        off += n


def test_gather_half_master_round_trips_and_matches_the_reference(runs):
    """The fp32 master shard: each rank's row equals the reference's row
    (bf16 wire tolerance), survives a dump/load bitwise, and every
    parameter is the master rounded to bf16, exactly."""
    refs, port = runs
    key = "__zero1__//__master__//__zshard__"
    params = refs["gather_half"]["after"]
    for r in range(WORLD):
        got = port[r]["gather_half"]
        close(got[f"state:{key}"], refs["gather_half"]["dump"][key][r:r + 1],
              f"master, rank {r}", BF16)
        assert bool(got["load_roundtrip"])
        flat = np.concatenate([got[f"param:{k}"].reshape(-1)
                               for k in params])
        master = torch.from_numpy(got[f"canon:{key}"])
        np.testing.assert_array_equal(
            flat, master.to(torch.bfloat16).float().numpy())


def test_overlap_buckets_and_its_canonical_form_is_layout_blind(runs):
    """buffSize 64 splits the MLP into several buckets; the bucketed
    run's canonical form equals the plain ZeRO-1 run's and the
    reference's, and inverts bitwise to the rank's own rows, raw stacks
    too."""
    refs, port = runs
    for r in range(WORLD):
        ov, zero = port[r]["overlap"], port[r]["zero"]
        assert int(ov["buckets"]) > 1 and int(zero["buckets"]) == 0
        keys = sorted(k for k in ov if k.startswith("canon:"))
        assert keys == sorted(k for k in zero if k.startswith("canon:"))
        for k in keys:
            close(ov[k], zero[k], f"overlap vs plain ZeRO {k}")
            close(ov[k], refs["overlap"]["canon"][k[len("canon:"):]],
                  f"overlap vs reference {k}")
        for case in CASES:
            assert bool(port[r][case]["reshard_roundtrip"]), case
            assert bool(port[r][case]["raw_roundtrip"]), case


def test_a_raw_dump_of_another_layout_is_refused(runs):
    _, port = runs
    for case in ("zero", "overlap"):
        msg = port[0][case]["raw_refused"]
        assert "overlap/buffSize" in msg and "CANONICAL" in msg


def test_a_canonical_dump_of_4_ranks_reshards_into_2_ranks_and_the_reference(
        runs, tmp_path):
    """The 4 ranks' canonical form equals the reference's; resharded on
    ranks 0-1 (a group of 2) and on the reference's 2-device mesh, the
    next step of the global batch matches."""
    refs, port = runs
    canon = {k[len("canon:"):]: v for k, v in port[0]["zero"].items()
             if k.startswith("canon:")}
    for k, v in refs["zero"]["canon"].items():
        close(canon[k], v, f"canonical {k}")
    after = {k[len("param:"):]: v for k, v in port[0]["zero"].items()
             if k.startswith("param:")}
    loss, params = run_reference("test_torch_zero1", "reference_continue",
                                 tmp_path, after=after, canon=canon)
    for r in range(2):
        got = port[r]["zero"]
        close(got["next_losses"], [loss], f"next loss, rank {r}")
        for k, v in params.items():
            close(got[f"next:{k}"], v, f"next {k}, rank {r}")
    assert "next_losses" not in port[2]["zero"]


# -- without a process group -----------------------------------------------------


def test_world_one_without_a_group_is_the_plain_step_and_the_reference(
        reference):
    """No group: the shard is the whole vector (the reference's
    "outside SPMD" case). Bitwise the wrapped optimizer's step, dropout
    on (rank 0 draws the default stream), and within fp32 tolerance of
    the reference's world-1 ZeRO-1 run."""
    X, y = zero1_data("mlp")
    ref, want_ref = reference["world1_zero"], reference["world1_plain"]
    close(ref["losses"], want_ref["losses"], "reference world 1")
    tx, ty = torch.from_numpy(X), torch.from_numpy(y).long()
    got = {}
    for kind, p in (("zero", 0.0), ("plain", 0.0), ("zero_drop", 0.3),
                    ("plain_drop", 0.3)):
        torch.manual_seed(0)
        m = port_mlp(ref["params"], 16, 3, X.shape[1])
        m.dropout.p = p
        sgd = opt.SGD(lr=LR, momentum=0.9)
        m.set_optimizer(opt.DistOpt(sgd, shard_states=True)
                        if kind.startswith("zero") else sgd)
        m.compile([tx], is_train=True, use_graph=True)
        losses = [m(tx, ty)[1].item() for _ in range(STEPS)]
        got[kind] = (losses, {k: v.detach().clone()
                              for k, v in m.get_params().items()})
    for a, b in (("zero", "plain"), ("zero_drop", "plain_drop")):
        assert got[a][0] == got[b][0], a
        for k, v in got[b][1].items():
            assert torch.equal(got[a][1][k], v), (a, k)
    close(got["zero"][0], ref["losses"], "port vs reference losses")
    for k, v in ref["after"].items():
        close(got["zero"][1][k].numpy(), v, f"port vs reference {k}")


def test_zero1_refuses_what_the_reference_refuses():
    sgd = opt.SGD(lr=0.1)
    assert not hasattr(communicator, "_ZERO1")
    with pytest.raises(ValueError, match="shard_states"):
        opt.DistOpt(sgd, overlap=True)
    with pytest.raises(ValueError, match="shard_states"):
        opt.DistOpt(sgd, use_sparse=True, shard_states=True)
    for kw in ("half_wire", "gather_half"):
        with pytest.raises(ValueError, match="ZeRO-1"):
            opt.DistOpt(sgd, **{kw: True})

    p = torch.ones(3, requires_grad=True)
    d = opt.DistOpt(opt.SGD(lr=0.1), shard_states=True)
    with pytest.raises(RuntimeError, match="prepare"):
        d.backward_and_update((p * p).sum())
    d.prepare({"p": p})
    d.prepare({"p": p})  # the same set again: nothing changes
    with pytest.raises(RuntimeError, match="parameter set changed"):
        d.prepare({"q": torch.ones(3, requires_grad=True)})
    autograd.training = True
    try:
        for step in (d.backward_and_update_half,
                     d.backward_and_sparse_update,
                     d.backward_and_partial_update):
            with pytest.raises(RuntimeError, match="dense fused sync"):
                step(p.sum())
        stray = torch.ones(3, requires_grad=True)
        with pytest.raises(RuntimeError, match="outside the prepare"):
            d.backward_and_update((p * stray).sum())
    finally:
        autograd.training = False
    with pytest.raises(RuntimeError, match="master shard"):
        d.load_states({"__zero1__//__master__//__zshard__": torch.ones(1, 3)})
    with pytest.raises(ValueError, match="different model"):
        d.reshard_states({"__zero1__//__zshard__//momentum": torch.ones(4)})
    with pytest.raises(ValueError, match="shape"):
        d.load_states({"__zero1__//__zshard__//momentum": torch.ones(1, 4)})
    with pytest.raises(RuntimeError, match="no ZeRO flat layout"):
        opt.DistOpt(opt.SGD(lr=0.1)).reshard_states(
            {"__zero1__//__zshard__//momentum": torch.ones(3)})
    sharded = torch.ones(3, requires_grad=True)
    sharded.pspec = ("model",)
    with pytest.raises(NotImplementedError, match="sharded parameter"):
        opt.DistOpt(opt.SGD(lr=0.1), shard_states=True).prepare(
            {"w": sharded})

