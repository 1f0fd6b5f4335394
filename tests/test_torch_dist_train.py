"""DistOpt training of the port against singa_tpu: the reference's
equivalences (`tests/test_dist.py:166, 182`), its batch refusal (:212),
the world-1 step against the plain optimizer, each rank's own dropout
draws (F6: the reference folds the rank into the step's key,
`singa_tpu/graph.py:669-674`), and the two trainers that take DistOpt
(`cnn_cifar10 --dist`, `dist_imagenet`) on the CPU.

The multi-rank runs are the port in 2 spawned processes over gloo
(`helper_torch_parity.run_ranks`, one spawn for the file); the
reference trains the same global batch single-device and, for the
BatchNorm model, data-parallel on its 8-device virtual mesh, in a
process of its own (`helper_torch_parity.run_reference`, F8's
follow-up: no process-wide switch of singa_tpu an earlier file left set
in the pytest worker reaches it). Tolerances
are 1e-5 for the MLP and 1e-4 for the CNN (relative and absolute: the
two packages' convolutions and all-reduces sum in different orders, and
three SGD steps carry that rounding).
"""

import contextlib
import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from helper_torch_parity import (_rank_many, randomize_params,  # noqa: E402
                                 run_ranks, run_reference)
from singa_tpu import opt as ref_opt  # noqa: E402
from singa_tpu import parallel, tensor  # noqa: E402
from singa_tpu.communicator import DistOpt as RefDistOpt  # noqa: E402
from singa_tpu.models import MLP as RefMLP  # noqa: E402
from singa_tpu.models import resnet as ref_resnet  # noqa: E402
from singa_tpu_torch import distributed, opt  # noqa: E402
from singa_tpu_torch.examples import cnn_cifar10, dist_imagenet  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
STEPS = 3
#: the dropout runs (F6): the MLP's dropout rate and the torch seed
DROP_P, DROP_SEED = 0.5, 7
#: dist_imagenet at 32 px on the CPU (its ranks add --world and --rank)
TRAINER = ["--device", "cpu", "--steps", "3", "--image-size", "32",
           "--classes", "10"]


def blobs(n, d=12, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    W = rng.randn(d, classes).astype(np.float32)
    return X, (X @ W).argmax(1).astype(np.int32)


def ref_mlp_single(X, y, lr=0.1):
    """The reference MLP trained single-device on the global batch from
    seeded parameters: (params before, losses, params after)."""
    tensor.set_seed(11)
    m = RefMLP(perceptron_size=16, num_classes=3)
    m.dropout.p = 0.0
    m.set_optimizer(ref_opt.SGD(lr=lr, momentum=0.9))
    tx, ty = tensor.from_numpy(X), tensor.from_numpy(y)
    m.compile([tx], is_train=True, use_graph=True)
    params = randomize_params(m, 11)
    losses = [float(np.asarray(m(tx, ty)[1].data)) for _ in range(STEPS)]
    return params, losses, {k: np.asarray(v.data)
                            for k, v in m.get_params().items()}


def cnn_data():
    rng = np.random.RandomState(3)
    X = rng.randn(16, 3, 8, 8).astype(np.float32)
    return X, (np.arange(16) % 10).astype(np.int32)


def ref_bn_dist(X, y, lr=0.05):
    """The reference's sync-BN oracle model trained data-parallel on its
    8-device mesh from seeded states: (states, losses, states after)."""
    from chip_smoke import cnn_states
    from helper_torch_parity import ref_states, set_ref_states

    m = ref_resnet.resnet20_cifar(num_classes=10)
    m.set_optimizer(RefDistOpt(ref_opt.SGD(lr=lr, momentum=0.9),
                               mesh=parallel.get_mesh()))
    tx, ty = tensor.from_numpy(X), tensor.from_numpy(y)
    m.compile([tx], is_train=True, use_graph=True)
    states = cnn_states({k: v.shape for k, v in m.get_states().items()}, 5)
    set_ref_states(m, states)
    losses = [float(np.asarray(m(tx, ty)[1].data)) for _ in range(STEPS)]
    return states, losses, ref_states(m)


def reference_side():
    """Everything the file holds the port to, from the reference: the
    MLP's single-device runs on the 64-row and the 16-row batches and
    the sync-BN model's data-parallel run (run by `run_reference` in a
    process of its own, F8)."""
    return {"mlp": ref_mlp_single(*blobs(64)),
            "mlp16": ref_mlp_single(*blobs(16)),
            "bn": ref_bn_dist(*cnn_data())}


#: `dist_imagenet --virtual-devices 2` at the harness ranks' flags, its
#: first 2 of their 3 steps
VIRTUAL = ["--virtual-devices", "2", *TRAINER, "--batch-per-chip", "2",
           "--steps", "2"]


@pytest.fixture(scope="module")
def virtual_run():
    """`VIRTUAL` as a child process, started before the file's other
    spawns so that its two ranks run beside them."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "singa_tpu_torch.examples.dist_imagenet",
         *VIRTUAL], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference(tmp_path_factory, virtual_run):
    """The reference's side, computed in a process of its own, so no
    process-wide switch an earlier file left set in this worker reaches
    it (F8)."""
    return run_reference("test_torch_dist_train", "reference_side",
                         tmp_path_factory.mktemp("reference"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, reference):
    X, y = blobs(64)
    params, losses, after = reference["mlp"]
    Xc, yc = cnn_data()
    states, bn_losses, bn_after = reference["bn"]
    calls = [
        ("mlp", "_rank_distopt", dict(params=params, X=X, y=y, mode="plain",
                                      steps=STEPS, lr=0.1, spars=None)),
        ("bn", "_rank_bn_equivalence", dict(states=states, X=Xc, y=yc,
                                            steps=STEPS, lr=0.05)),
        ("refusals", "_rank_refusals", dict(X=X[:5], y=y[:5])),
        ("trainer", "_rank_dist_imagenet", dict(argv=[
            *TRAINER, "--batch-per-chip", "2"])),
        ("dropout", "_rank_dropout", dict(params=params, X=X, y=y,
                                          steps=STEPS, lr=0.1, p=DROP_P,
                                          seed=DROP_SEED)),
    ]
    port = run_ranks(_rank_many, WORLD, tmp_path_factory.mktemp("ranks"),
                     calls=calls)
    return dict(mlp=(losses, after), bn=(bn_losses, bn_after),
                params=params, X=X, y=y), port


def close(got, want, what, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def test_plain_distopt_equals_the_single_device_large_batch_step(runs):
    """Sync SGD over 2 ranks equals the reference's single-device SGD on
    the same global batch (the correctness contract of DistOpt)."""
    ref, port = runs
    losses, after = ref["mlp"]
    for r in range(WORLD):
        got = port[r]["mlp"]
        close(got["losses"], losses, "losses", 1e-5)
        for k, v in after.items():
            close(got[f"param:{k}"], v, f"{k}, rank {r}", 1e-5)


def test_sync_batchnorm_model_equals_the_reference_data_parallel(runs):
    """Cross-replica BatchNorm: the BN CNN trained over 2 ranks (8 images
    each) matches the reference's over 8 chips (2 each) step for step,
    both the single-device large-batch step; the running statistics
    too, and every rank holds the same state."""
    ref, port = runs
    losses, after = ref["bn"]
    for r in range(WORLD):
        got = port[r]["bn"]
        close(got["losses"], losses, "losses", 1e-4)
        for k, v in after.items():
            close(got[k], v, f"{k}, rank {r}", 1e-4)
            np.testing.assert_array_equal(got[k], port[0]["bn"][k])


def test_a_batch_the_world_does_not_divide_is_refused(runs):
    _, port = runs
    for r in range(WORLD):
        got = port[r]["refusals"]
        assert "divisible by the batch world size 2" in got["divisible"]
        assert "(5, 12)" in got["divisible"]
        assert "outside a data-parallel batch-axis" in got["sync"]


@contextlib.contextmanager
def world_of_one():
    distributed.init(device="cpu")
    try:
        yield distributed.global_mesh()
    finally:
        distributed.shutdown()


def test_world_one_plain_distopt_is_bitwise_the_plain_optimizer(reference):
    """At world 1 the fused buckets, the NCCL/gloo sum and the division
    by 1 are exact, so DistOpt's plain step equals the wrapped SGD's bit
    for bit (the claim chip_smoke.py checks on the card)."""
    from helper_torch_parity import port_mlp

    X, y = blobs(16)
    params, _, _ = reference["mlp16"]
    tx, ty = torch.from_numpy(X), torch.from_numpy(y).long()
    got = {}
    with world_of_one() as mesh:
        for kind in ("dist", "plain"):
            m = port_mlp(params, 16, 3, 12)
            sgd = opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-4,
                          clip_norm=10.0)
            m.set_optimizer(opt.DistOpt(sgd, mesh=mesh) if kind == "dist"
                            else sgd)
            m.compile([tx], is_train=True, use_graph=True)
            for _ in range(STEPS):
                m(tx, ty)
            got[kind] = {k: v.detach().clone()
                         for k, v in m.get_params().items()}
    for k, v in got["plain"].items():
        assert torch.equal(got["dist"][k], v), k


def test_init_is_idempotent_only_for_the_live_group():
    """A second `init` that asks for the live group's backend, device,
    world and rank returns; one that asks for another raises rather
    than keep the live group."""
    with world_of_one():
        distributed.init(device="cpu")
        assert distributed.device() == torch.device("cpu")
        with pytest.raises(RuntimeError, match="shutdown"):
            distributed.init(device="cpu", num_processes=2, process_id=1)
        assert torch.distributed.get_world_size() == 1


def test_shard_batch_keeps_the_local_slice_where_it_is():
    """`shard_batch` gathers nothing: it marks this process's slice as
    its share of the global batch, a tensor on its own device and a
    numpy array on this rank's (the CPU before `init`)."""
    mesh = distributed.global_mesh()
    x = torch.arange(6.0).reshape(3, 2)
    tx, ty = distributed.shard_batch(mesh, (x, np.arange(3)))
    assert tx.shape == (3, 2) and ty.shape == (3,)
    assert torch.equal(tx, x) and tx.device == x.device
    assert ty.device == torch.device("cpu")
    assert distributed.is_rank_local(tx) and distributed.is_rank_local(ty)
    assert not distributed.is_rank_local(x)
    with pytest.raises(ValueError, match="no axis"):
        distributed.shard_batch(mesh, x, axis="model")


def test_batchnorm_sync_true_needs_the_group_and_false_is_local():
    from singa_tpu_torch import autograd

    x = torch.randn(4, 3, 2, 2)
    args = (torch.ones(3), torch.zeros(3), torch.zeros(3), torch.ones(3))
    with pytest.raises(ValueError, match="batch-axis"):
        autograd.batchnorm(x, *args, sync=True)
    local, _, _ = autograd.batchnorm(x, *args, sync=False)
    auto, _, _ = autograd.batchnorm(x, *args)
    assert torch.equal(local, auto)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = main(argv)
    return code, buf.getvalue()


def test_cnn_cifar10_trains_with_dist():
    code, out = _run(cnn_cifar10.main, [
        "--device", "cpu", "--model", "alexnet", "--epochs", "1",
        "--batch", "64", "--dist", "--dist-option", "sparse-topk",
        "--spars", "0.1"])
    assert code == 0, out
    assert "DistOpt over 1 chips" in out
    assert "epoch 0: loss" in out
    assert not distributed.is_initialized()


@pytest.mark.parametrize("option", ["plain", "sparse-thresh"])
def test_dist_imagenet_trains_at_32_pixels(option):
    code, out = _run(dist_imagenet.main, [
        "--device", "cpu", "--steps", "3", "--batch-per-chip", "2",
        "--image-size", "32", "--classes", "10", "--dist-option", option])
    assert code == 0, out
    assert "mesh: 1 chips / 1 processes (gloo), global batch 2" in out
    assert "model gradient payload: 94.1 MB/step" in out
    assert "loss sanity:" in out and "ok" in out.splitlines()[-1]
    assert "images/sec/chip" in out
    assert ("threshold sparsifier" in out) == (option == "sparse-thresh")
    assert not distributed.is_initialized()


def test_dist_imagenet_over_two_ranks_equals_one_rank_of_the_global_batch(
        runs):
    """The trainer over 2 ranks (its --world and --rank; the harness's
    group): 2 ranks of 2 images, each sending its slice through
    `shard_batch` as its share (nothing gathered), train as one rank of
    the 4 (sync BatchNorm and the averaged gradients make them one
    step)."""
    _, port = runs
    code, out = _run(dist_imagenet.main, [*TRAINER, "--batch-per-chip",
                                          "4"])
    assert code == 0, out
    losses = [float(l.split("loss ")[1].split()[0]) for l in
              out.splitlines() if l.startswith("step ")]
    for r in range(WORLD):
        got = port[r]["trainer"]
        assert got["world"] == WORLD
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("flag,item", [
    (["--checkpoint", "ck.zip"], "item 17"),
    (["--save-every", "5"], "item 17"),
    (["--loader", "prefetch"], "item 20"),
    (["--virtual-devices", "2"], "item 20")])
def test_dist_imagenet_refuses_the_unported_flags(flag, item, tmp_path,
                                                  monkeypatch, runs,
                                                  virtual_run):
    """Every flag runs. Item 20's: `--loader prefetch` feeds the steps
    zero-copy views of the native prefetcher, and its losses equal,
    bitwise, those of the same run fed the loader's owned copies (the
    views are read whole before the next is asked for);
    `--virtual-devices 2` runs the trainer as two gloo ranks, one process
    each, whose losses equal the harness's two ranks of the same flags
    (tests/test_torch_virtual.py holds them to the reference's). Item
    17's: `--save-every 5` beside `--checkpoint` commits step 5
    (DistOpt's states in canonical form), and `--checkpoint ck.zip`
    resumes a run that saved at step 2, its batches continuing the
    stream (`--loader sync`: the prefetch stream starts over on a
    resume, as the reference's does)."""
    from singa_tpu_torch import resilience

    if flag[0] == "--virtual-devices":
        assert VIRTUAL[:2] == flag
        out, err = virtual_run.communicate(timeout=120)
        assert virtual_run.returncode == 0, err
        assert "mesh: 2 chips / 2 processes (gloo)" in out
        losses = [float(l.split("loss ")[1].split()[0]) for l in
                  out.splitlines() if l.startswith("step ")]
        _, port = runs
        assert len(losses) == 2
        np.testing.assert_allclose(losses, port[0]["trainer"]["losses"][:2],
                                   rtol=1e-4, atol=1e-4)
        return
    if item == "item 20":
        calls, real = [], dist_imagenet.data.prefetch_batches

        def owned(*a, **k):
            calls.append(k["copy"])
            return real(*a, **dict(k, copy=True))

        def train():
            with contextlib.redirect_stdout(io.StringIO()):
                res = dist_imagenet.run(dist_imagenet.parser().parse_args(
                    [*TRAINER, "--batch-per-chip", "2", "--steps", "2",
                     *flag]))
            distributed.shutdown()
            return res

        views = train()
        monkeypatch.setattr(dist_imagenet.data, "prefetch_batches", owned)
        copies = train()
        assert calls == [False]  # the trainer asked for views
        assert len(views["loader_wait_s"]) == 2
        assert copies["losses"] == views["losses"]
        return
    flag = [*flag, "--loader", "sync"]
    monkeypatch.chdir(tmp_path)
    small = ["--device", "cpu", "--batch-per-chip", "2", "--image-size",
             "32", "--classes", "10"]
    if flag[0] == "--save-every":
        code, out = _run(dist_imagenet.main, small + [
            "--steps", "5", "--checkpoint", "ck", *flag])
        assert code == 0, out
        manifest, step_dir = resilience.read_manifest("ck")
        assert step_dir.endswith("step-00000005")
        assert manifest["meta"] == {"opt_canonical": True}
    else:
        code, out = _run(dist_imagenet.main, small + [
            "--steps", "2", "--save-every", "2", *flag])
        assert code == 0, out
        code, out = _run(dist_imagenet.main, small + ["--steps", "1",
                                                      *flag])
        assert code == 0, out
        assert "resumed from ck.zip at step 2" in out
        assert "step 2 (first, uncaptured)" in out
    assert not distributed.is_initialized()


# -- F6: each rank's dropout draws ---------------------------------------------


def test_each_rank_draws_its_own_dropout_masks(runs):
    """Seeded alike, the two ranks draw different masks on their rows
    (rank 1 from its own generator, rank 0 from the default one)."""
    _, port = runs
    m0, m1 = port[0]["dropout"]["mask"], port[1]["dropout"]["mask"]
    assert m0.shape == m1.shape and m0.any() and m1.any()
    assert not np.array_equal(m0, m1)


def test_two_rank_dropout_step_equals_one_process_of_both_shares(runs):
    """The 2-rank DistOpt steps equal one process that runs rank 0's
    share on the default generator and rank 1's under
    `autograd.rank_draws(1)`, averages the two losses and steps the
    plain SGD: the same masks, losses and parameters (1e-5)."""
    from helper_torch_parity import dropout_masks, port_mlp
    from singa_tpu_torch import autograd

    ref, port = runs
    X, y = ref["X"], ref["y"]
    torch.manual_seed(DROP_SEED)
    autograd.reset_rank_draws()
    m = port_mlp(ref["params"], 16, 3, X.shape[1])
    m.dropout.p = DROP_P
    sgd = opt.SGD(lr=0.1, momentum=0.9)
    m.set_optimizer(sgd)
    tx, ty = torch.from_numpy(X), torch.from_numpy(y).long()
    m.compile([tx], is_train=True)
    masks = dropout_masks(m)
    b = len(X) // WORLD
    losses = []
    for _ in range(STEPS):
        shares = []
        for r in range(WORLD):
            with autograd.rank_draws(r):
                out = m.forward(tx[r * b:(r + 1) * b])
            shares.append(autograd.softmax_cross_entropy(
                out, ty[r * b:(r + 1) * b]))
        loss = sum(shares) / WORLD
        sgd(loss)
        losses.append(loss.item())
    for r in range(WORLD):
        got = port[r]["dropout"]
        np.testing.assert_array_equal(got["mask"], masks[r])
        close(got["losses"], losses, "losses", 1e-5)
        for k, v in m.get_params().items():
            close(got[f"param:{k}"], v.detach().numpy(), f"{k}, rank {r}",
                  1e-5)


def test_world_one_distopt_step_with_dropout_is_bitwise_the_plain_one(
        reference):
    """Rank 0 draws what the non-distributed step draws, so at world 1
    the DistOpt step with dropout stays bitwise the wrapped SGD's."""
    from helper_torch_parity import port_mlp

    X, y = blobs(16)
    params, _, _ = reference["mlp16"]
    tx, ty = torch.from_numpy(X), torch.from_numpy(y).long()
    got = {}
    with world_of_one() as mesh:
        for kind in ("dist", "plain"):
            torch.manual_seed(DROP_SEED)
            m = port_mlp(params, 16, 3, 12)
            m.dropout.p = DROP_P
            sgd = opt.SGD(lr=0.1, momentum=0.9)
            m.set_optimizer(opt.DistOpt(sgd, mesh=mesh) if kind == "dist"
                            else sgd)
            m.compile([tx], is_train=True, use_graph=True)
            got[kind] = [m(tx, ty)[1].item() for _ in range(STEPS)], {
                k: v.detach().clone() for k, v in m.get_params().items()}
    assert got["dist"][0] == got["plain"][0]
    for k, v in got["plain"][1].items():
        assert torch.equal(got["dist"][1][k], v), k
