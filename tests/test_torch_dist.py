"""Communicator, plan_buckets and every DistOpt mode of the port
(singa_tpu_torch.communicator), held against singa_tpu's on its virtual
CPU mesh.

The port runs in 4 spawned processes over gloo (one spawn for the whole
file, `helper_torch_parity.run_ranks`); the reference runs the same
inputs under `shard_map` over the first 4 devices of its 8-device
virtual mesh, so both sides shard the same global batch 4 ways. Each
rank's result is held to the reference's shard of that rank.

The reference's side runs in a spawned process of its own too
(`helper_torch_parity.run_reference`, ROADMAP fault F8): computed in the
pytest worker, it read whatever process-wide switch of singa_tpu an
earlier test file on that worker had left set, so the parity of the
DistOpt cases rested on which files shared the worker.

Tolerances: fp32 results 1e-5 (relative and absolute; the sums of the
two packages add in different orders); the bf16 wire 1e-2 relative (the
bf16 sums of XLA and gloo round at different points). Top-k inputs have
no ties in |g|: `torch.topk` and `jax.lax.top_k` break ties
differently.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from jax.sharding import PartitionSpec as P  # noqa: E402

from helper_torch_parity import _rank_many, run_ranks, run_reference  # noqa: E402
from singa_tpu import opt as ref_opt  # noqa: E402
from singa_tpu import autograd as ref_autograd  # noqa: E402
from singa_tpu import parallel, tensor  # noqa: E402
from singa_tpu.communicator import Communicator as RefCommunicator  # noqa: E402
from singa_tpu.communicator import DistOpt as RefDistOpt  # noqa: E402
from singa_tpu.communicator import plan_buckets as ref_plan  # noqa: E402
from singa_tpu.models import MLP as RefMLP  # noqa: E402
from singa_tpu_torch.communicator import Communicator, plan_buckets  # noqa: E402
from singa_tpu_torch.opt import SGD, DistOpt  # noqa: E402

WORLD = 4
SPARSE = {"topk": dict(spars=0.25, topK=True),
          "thresh": dict(spars=0.8, topK=False, max_frac=0.25)}
MODES = ("plain", "half", "sparse-topk", "sparse-thresh", "partial")
#: the sparse modes' spars: top-k keeps 25%; the threshold puts most of
#: the MLP's entries above it, so the 25% cap drops some each step
DIST_SPARS = {"sparse-topk": 0.25, "sparse-thresh": 1e-3}
STEPS, LR = 3, 0.1
#: the parameter the partial update syncs at idx 0: the first in the
#: reference's gradient order (the layer nearest the loss first)
PARTIAL_SYNCED = "fc2.W"


def ref_mesh():
    return parallel.get_mesh((WORLD,), devices=jax.devices()[:WORLD])


def per_rank(fn, *arrays):
    """fn on each rank's row of the (WORLD, ...) arrays under shard_map
    over the reference's 4-device mesh: {name: (WORLD, ...)}."""
    def wrapped(*a):
        with parallel.mesh.axis_context("data"):
            out = fn(*[x[0] for x in a])
        return {k: v[None] for k, v in out.items()}

    out = jax.shard_map(wrapped, mesh=ref_mesh(),
                        in_specs=tuple(P("data") for _ in arrays),
                        out_specs=P("data"), check_vma=False)(*arrays)
    return {k: np.asarray(v) for k, v in out.items()}


def comm_inputs():
    rng = np.random.default_rng(0)
    g = rng.permutation(np.linspace(-2.0, 2.0, WORLD * 40)).reshape(
        WORLD, 40)  # distinct magnitudes: no top-k ties
    return {
        "a": rng.standard_normal((WORLD, 3, 2)).astype(np.float32),
        "flat": rng.standard_normal((WORLD, WORLD * 3)).astype(np.float32),
        "f0": rng.standard_normal((WORLD, 3)).astype(np.float32),
        "f1": rng.standard_normal((WORLD, 5)).astype(np.float32),
        "f2": rng.standard_normal((WORLD, 2, 2)).astype(np.float32),
        "g": g.astype(np.float32),
    }


def blobs(n, d=12, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    W = rng.randn(d, classes).astype(np.float32)
    return X, (X @ W).argmax(1).astype(np.int32)


class PartialRefMLP(RefMLP):
    def train_one_batch(self, x, y, dist_option="plain", spars=None):
        out = self.forward(x)
        loss = ref_autograd.softmax_cross_entropy(out, y)
        self.optimizer.backward_and_partial_update(loss, idx=0)
        return out, loss


def ref_distopt(mode, X, y, seed):
    """The reference's run of `mode`: its MLP on the 4-device mesh, from
    seeded parameters (and seeded non-zero residuals in the sparse
    modes); returns the parameters, the dump before the first step (the
    port's starting state), the losses, the parameters and dump after,
    and the dropped count."""
    from helper_torch_parity import randomize_params

    tensor.set_seed(seed)
    m = (PartialRefMLP if mode == "partial" else RefMLP)(
        perceptron_size=16, num_classes=3)
    m.dropout.p = 0.0
    sparse = mode.startswith("sparse")
    d = RefDistOpt(ref_opt.SGD(lr=LR, momentum=0.9), mesh=ref_mesh(),
                   use_sparse=sparse)
    m.set_optimizer(d)
    tx, ty = tensor.from_numpy(X), tensor.from_numpy(y)
    m.compile([tx], is_train=True, use_graph=True)
    params = randomize_params(m, seed)
    d.prepare(m.get_params())
    if sparse:
        rng = np.random.default_rng(seed + 1)
        d.load_states({
            f"{k}//__residual__": 0.05 * rng.standard_normal(
                (WORLD,) + v.shape).astype(np.float32)
            for k, v in params.items()})
    before = {k: np.asarray(v) for k, v in d.dump_states().items()}
    opt_name = "plain" if mode == "partial" else mode
    spars = DIST_SPARS.get(mode)
    losses = [float(np.asarray(m(tx, ty, opt_name, spars)[1].data))
              for _ in range(STEPS)]
    after = {k: np.asarray(v.data) for k, v in m.get_params().items()}
    dump = {k: np.asarray(v) for k, v in d.dump_states().items()}
    return dict(params=params, before=before, losses=losses, after=after,
                dump=dump, dropped=d.sparse_dropped_last if sparse else 0.0,
                spars=spars)


def reference_side():
    """Everything the file holds the port to: the reference's
    Communicator cases and its DistOpt run of each mode (run by
    `run_reference` in a process of its own)."""
    X, y = blobs(32)
    return {"comm": _ref_comm_cases(),
            "distopt": {mode: ref_distopt(mode, X, y, seed=3 + i)
                        for i, mode in enumerate(MODES)}}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's side, computed while a process-wide switch of
    singa_tpu is left set in this worker (F8's regression: the bf16
    autocast policy moves every DistOpt case's numbers by up to 8e-3
    when they are computed here, and not at all in `run_reference`'s
    process)."""
    prev = ref_autograd.autocast_enabled()
    ref_autograd.set_autocast(True)
    try:
        return run_reference("test_torch_dist", "reference_side",
                             tmp_path_factory.mktemp("reference"))
    finally:
        ref_autograd.set_autocast(prev)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, reference):
    """One spawn of 4 gloo ranks for the whole file: the Communicator
    cases and a DistOpt run per mode; beside them, the reference's."""
    X, y = blobs(32)
    refs = reference["distopt"]
    calls = [("comm", "_rank_communicator",
              dict(xs=comm_inputs(), sparse=SPARSE))]
    for mode, r in refs.items():
        calls.append((mode, "_rank_distopt", dict(
            params=r["params"], X=X, y=y, mode=mode, steps=STEPS, lr=LR,
            spars=r["spars"], states=r["before"])))
    port = run_ranks(_rank_many, WORLD, tmp_path_factory.mktemp("ranks"),
                     calls=calls)
    return refs, port


def close(got, want, what, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


# -- plan_buckets ----------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_plan_buckets_matches_the_reference_planner(seed):
    rng = np.random.default_rng(seed)
    sizes = [int(s) for s in rng.integers(1, 60, size=int(
        rng.integers(0, 40)))]
    for cap in (1, 16, 64, 1000):
        assert plan_buckets(sizes, cap) == ref_plan(sizes, cap), (sizes,
                                                                  cap)
    assert plan_buckets([2, 2, 2], 4) == [[0, 1], [2]]
    assert plan_buckets([10], 4) == [[0]]
    assert plan_buckets([], 4) == []


# -- Communicator --------------------------------------------------------------


def _ref_comm_cases():
    c = RefCommunicator(ref_mesh())
    xs = comm_inputs()

    def fn(a, flat, f0, f1, f2, g):
        out = {
            "all_reduce": c.all_reduce(a),
            "all_reduce_sum": c.all_reduce(a, average=False),
            "all_reduce_half": c.all_reduce_half(a),
            "all_gather": c.all_gather(a),
            "reduce_scatter": c.reduce_scatter(flat),
            "reduce_scatter_half": c.reduce_scatter_half(flat),
            "all_gather_half": c.all_gather_half(a),
            "broadcast": c.broadcast(a, root=1),
            "reduce_scatter_buckets": jax.numpy.concatenate(
                c.reduce_scatter_buckets([flat, flat * 2])),
            "all_gather_buckets": jax.numpy.concatenate(
                c.all_gather_buckets([a, a * 2])),
        }
        for i, t in enumerate(c.fused_all_reduce([f0, f1, f2],
                                                 bucket_elems=6)):
            out[f"fused{i}"] = t
        for name, kw in SPARSE.items():
            dense, local, dropped = c.sparse_all_reduce(
                g, return_local=True, return_stats=True, **kw)
            out[f"{name}_dense"], out[f"{name}_local"] = dense, local
            out[f"{name}_dropped"] = dropped
        return out

    return per_rank(fn, *(jax.numpy.asarray(xs[k])
                          for k in ("a", "flat", "f0", "f1", "f2", "g")))


COMM_KEYS = ("all_reduce", "all_reduce_sum", "all_gather", "reduce_scatter",
             "broadcast", "reduce_scatter_buckets", "all_gather_buckets",
             "fused0", "fused1", "fused2", "topk_dense", "topk_local",
             "thresh_dense", "thresh_local", "topk_dropped",
             "thresh_dropped")
HALF_KEYS = ("all_reduce_half", "reduce_scatter_half", "all_gather_half")


@pytest.fixture(scope="module")
def ref_comm(reference):
    return reference["comm"]


@pytest.mark.parametrize("key", COMM_KEYS + HALF_KEYS)
def test_communicator_method_matches_the_reference(runs, ref_comm, key):
    _, port = runs
    tol = 1e-2 if key in HALF_KEYS else 1e-5
    for r in range(WORLD):
        assert port[r]["comm"]["world"] == WORLD
        close(port[r]["comm"][key], ref_comm[key][r], f"{key}, rank {r}",
              tol)


def test_threshold_mode_counts_its_dropped_entries(ref_comm):
    """With |g| in [0, 2] and the threshold 0.8, 60% of the entries pass
    it and the cap keeps 25%: the count is what the cap dropped."""
    g = comm_inputs()["g"]
    for r in range(WORLD):
        want = (np.abs(g[r]) >= 0.8).sum() - 10
        assert ref_comm["thresh_dropped"][r] == want


def test_communicator_is_the_identity_without_a_group():
    import torch

    c = Communicator(None)
    x = torch.arange(6.0).reshape(2, 3)
    for fn in (c.all_reduce, c.all_reduce_half, c.all_gather, c.broadcast,
               c.reduce_scatter, c.all_gather_half):
        assert fn(x) is x
    assert c.world_size == 1 and c.synch == c.all_reduce
    dense, local = c.sparse_all_reduce(torch.tensor([5.0, 0.1, -3.0, 0.2]),
                                       spars=0.5, return_local=True)
    np.testing.assert_array_equal(local.numpy(), [5.0, 0.0, -3.0, 0.0])
    np.testing.assert_array_equal(dense.numpy(), local.numpy())


# -- DistOpt -------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_distopt_mode_matches_the_reference(runs, mode):
    """Each rank's losses, parameters, momentum slots and (sparse)
    error-feedback residuals after 3 steps against the reference's, the
    residuals row by row from the same non-zero start."""
    refs, port = runs
    ref = refs[mode]
    tol = 1e-2 if mode == "half" else 1e-5
    for r in range(WORLD):
        got = port[r][mode]
        close(got["losses"], ref["losses"], f"{mode} losses", tol)
        for k, v in ref["after"].items():
            if mode == "partial" and r and k != PARTIAL_SYNCED:
                continue  # updated from this rank's own gradient
            close(got[f"param:{k}"], v, f"{mode} {k}, rank {r}", tol)
        for k, v in ref["dump"].items():
            if k.endswith("//__residual__"):
                close(got[f"state:{k}"], v[r], f"{mode} {k}, rank {r}", tol)
            elif k.endswith("//momentum") and (mode != "partial" or r == 0):
                close(got[f"state:{k}"], v, f"{mode} {k}, rank {r}", tol)
        assert int(got["state:__step__"]) == int(ref["dump"]["__step__"])
        if mode == "sparse-thresh":
            assert float(got["dropped_last"]) == ref["dropped"] > 0


def test_partial_update_syncs_one_parameter_a_step(runs):
    """With 4 parameters over 4 ranks and idx 0, only the first parameter
    of the reference's gradient order (fc2.W) takes the synced gradient;
    the others move by each rank's own, so they part between ranks (the
    reference reports device 0's copy, which rank 0 matches)."""
    _, port = runs
    for k in ("fc1.W", "fc1.b", "fc2.b", PARTIAL_SYNCED):
        rows = [port[r]["partial"][f"param:{k}"] for r in range(WORLD)]
        same = all(np.array_equal(rows[0], rows[r]) for r in range(WORLD))
        assert same == (k == PARTIAL_SYNCED), k


def test_sparse_residuals_differ_by_rank(runs):
    """Error feedback keeps what each rank did not send: the ranks'
    residuals part, as the reference's rows do."""
    _, port = runs
    k = "state:fc1.W//__residual__"
    rows = [port[r]["sparse-topk"][k] for r in range(WORLD)]
    assert not all(np.allclose(rows[0], rows[r]) for r in range(1, WORLD))


def test_distopt_refuses_what_the_reference_refuses():
    sgd = SGD(lr=0.1)
    with pytest.raises(ValueError, match="overlap"):
        DistOpt(sgd, overlap=True)
    with pytest.raises(ValueError, match="shard_states"):
        DistOpt(sgd, use_sparse=True, shard_states=True)
    with pytest.raises(ValueError, match="ZeRO-1"):
        DistOpt(sgd, half_wire=True)
    with pytest.raises(ValueError, match="ZeRO-1"):
        DistOpt(sgd, gather_half=True)
    for kw in ("shard_states", "overlap", "half_wire", "gather_half"):
        extra = {"shard_states": True} if kw != "shard_states" else {}
        assert getattr(DistOpt(sgd, **{kw: True}, **extra), kw) is True
    # the sentinel is ported: DistOpt hands it to the wrapped optimizer
    from singa_tpu_torch.resilience import GradSentinel

    guarded, sentinel = SGD(lr=0.1), GradSentinel()
    d = DistOpt(guarded)
    d.set_sentinel(sentinel)
    assert d.sentinel is sentinel and guarded.sentinel is sentinel
    # the expert axis is a grad axis like the seq axis (the MoE FFN)
    assert DistOpt(sgd, grad_axes=("data", "expert")).grad_axes == (
        "data", "expert")
    assert DistOpt(sgd).grad_axes == ("data",)
    assert DistOpt(sgd, grad_axes=("data", "seq")).grad_axes == ("data",
                                                                 "seq")

