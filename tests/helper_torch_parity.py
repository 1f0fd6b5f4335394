"""Shared pieces of the parity tests between singa_tpu (JAX, the
reference) and its PyTorch port singa_tpu_torch: seeded numpy inputs fed
to both packages, and the carry-over of a reference model's weights."""

import importlib

import numpy as np
import torch

# The tier-1 suite runs several pytest workers on a few cores; torch's
# default of one intra-op thread per core in every worker would starve
# the timing-sensitive multi-process tests that share the machine. The
# parity shapes here are tiny, so two threads lose nothing.
torch.set_num_threads(2)


def jax_flash():
    """The reference's flash-attention MODULE (singa_tpu.ops rebinds the
    name `flash_attention` to the function)."""
    return importlib.import_module("singa_tpu.ops.flash_attention")


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def to_torch(a):
    return torch.from_numpy(np.array(a))


def to_np(x):
    return np.asarray(x.detach().float().numpy() if hasattr(x, "detach")
                      else x)


def randomize_params(jax_layer, seed):
    """Give every reference parameter seeded random values (so scales,
    offsets and biases are not the trivial ones/zeros of a fresh init)
    and return them as the numpy dict the port's carry-over takes."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, t in jax_layer.get_params().items():
        shape = tuple(t.shape)
        fan_in = shape[-2] if len(shape) >= 2 else 1
        if name.endswith(("scale", "ln1_s", "ln2_s")):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif len(shape) >= 2 and not name.endswith(".table"):
            a = rng.standard_normal(shape) / np.sqrt(fan_in)
        else:
            a = 0.1 * rng.standard_normal(shape)
        params[name] = a.astype(np.float32)
    jax_layer.set_params(params)
    return {k: np.asarray(v.data) for k, v in
            jax_layer.get_params().items()}


def ref_cnn(ref_model, x, seed):
    """Build a reference CNN's lazy layers on x (eval mode, so no state
    moves), give every parameter and buffer seeded values, and return
    them as the numpy dict `load_singa_tpu_states` takes."""
    from chip_smoke import cnn_states
    from singa_tpu.tensor import from_numpy

    ref_model.eval()
    ref_model(from_numpy(x))
    states = cnn_states({k: v.shape for k, v in
                         ref_model.get_states().items()}, seed)
    set_ref_states(ref_model, states)
    return states


def ref_cnn_case(jax_ctor, shape, seed):
    """A reference CNN built on seeded images of `shape` with seeded
    states (`ref_cnn`), and its eval-mode logits: (model, states, x, y,
    logits), y the labels 3, 7, 3, ..."""
    from singa_tpu.tensor import from_numpy

    x = rand(shape, seed)
    ref = jax_ctor()
    states = ref_cnn(ref, x, seed + 1)
    ref.eval()
    logits = np.asarray(ref(from_numpy(x)).data)
    y = np.array([3, 7] * (shape[0] // 2) + [3] * (shape[0] % 2), np.int32)
    return ref, states, x, y, logits


def check_cnn_eval(states, make_port, x, want, lay, tol):
    """The port's eval-mode logits in layout `lay` against the
    reference's `want` (the function is the same in both layouts), and
    no tape recorded."""
    from singa_tpu_torch.model import load_singa_tpu_states

    m = make_port()
    load_singa_tpu_states(m, states)
    m.set_image_layout(lay)
    got = m.eval()(torch.from_numpy(x))
    assert got.grad_fn is None
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)
    return m


def set_ref_states(ref_model, states):
    ref_model.set_params({k: v for k, v in states.items()
                          if k in ref_model.get_params()})
    for k, buf in ref_model.get_buffers().items():
        buf.copy_from(states[k])


def ref_states(ref_model):
    return {k: np.asarray(v.data) for k, v in ref_model.get_states().items()}


def check_cnn_training(ref_model, states, make_port, x, y, lay, lr, tol,
                       tol_steps, steps=3, momentum=0.9, wd=5e-4,
                       tol_grads=None):
    """Train the reference CNN (graph mode) and the port's from the same
    states in image layout `lay` with SGD(lr, momentum, weight decay wd)
    on one batch for `steps` steps, and hold the port to the reference
    within `tol` (absolute and relative):

    - after `compile` (whose forward moves the BatchNorm running
      statistics in both packages) every parameter and buffer;
    - the first step's logits and loss;
    - the gradients at the compiled state: the port's from
      `autograd.grad_pairs`, the reference's from its first update,
      g = (p0 - p1) / lr - wd * p0 (the first momentum buffer is g);

    and within `tol_steps` every later loss and every parameter and
    buffer after the last step (the two trajectories part where a ReLU
    input lies within rounding of 0, so the steps carry more than one
    step's rounding). `tol_grads`, when given, replaces `tol` for the
    gradients."""
    from singa_tpu import opt as jax_opt
    from singa_tpu.tensor import from_numpy
    from singa_tpu_torch import autograd, opt
    from singa_tpu_torch.model import load_singa_tpu_states

    def close(got, want, what, t=tol):
        np.testing.assert_allclose(got, want, atol=t, rtol=t, err_msg=what)

    set_ref_states(ref_model, states)
    ref_model.set_image_layout(lay)
    ref_model.train()
    ref_model.set_optimizer(jax_opt.SGD(lr=lr, momentum=momentum,
                                        weight_decay=wd))
    xr, yr = from_numpy(x), from_numpy(y)
    ref_model.compile([xr], is_train=True, use_graph=True)
    want = [ref_states(ref_model)]
    want_logits, want_losses = None, []
    for _ in range(steps):
        out, loss = ref_model(xr, yr)
        want_logits = np.asarray(out.data) if want_logits is None else (
            want_logits)
        want_losses.append(float(np.asarray(loss.data)))
        want.append(ref_states(ref_model))

    def port():
        m = make_port()
        load_singa_tpu_states(m, states)
        m.set_image_layout(lay)
        m.set_optimizer(opt.SGD(lr=lr, momentum=momentum, weight_decay=wd))
        m.compile([xt], is_train=True, use_graph=True)
        return m

    def port_states(m):
        own = dict(m.named_parameters())
        own.update(m.named_buffers())
        return {k: v.detach().numpy() for k, v in own.items()}

    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    g = port()
    compiled = port_states(g)
    assert sorted(compiled) == sorted(want[0])
    for k in want[0]:
        close(compiled[k], want[0][k], f"after compile: {k}")
        if k.endswith("running_mean"):
            assert not np.array_equal(compiled[k], states[k]), k  # moved
    logits = g.forward(xt)
    loss = autograd.softmax_cross_entropy(logits, yt)
    close(logits.detach().numpy(), want_logits, "first step's logits")
    close(loss.item(), want_losses[0], "first step's loss")
    names = {id(p): n for n, p in g.named_parameters()}
    grads = {names[id(p)]: v.numpy() for p, v in autograd.grad_pairs(loss)}
    assert sorted(grads) == sorted(n for n, _ in g.named_parameters())
    for k, v in grads.items():
        p0, p1 = want[0][k], want[1][k]
        close(v, (p0 - p1) / lr - wd * p0, f"gradient of {k}",
              tol if tol_grads is None else tol_grads)

    m = port()
    losses = [m(xt, yt)[1].item() for _ in range(steps)]
    close(losses, want_losses, "losses", tol_steps)
    after = port_states(m)
    for k in want[-1]:
        close(after[k], want[-1][k], f"after {steps} steps: {k}", tol_steps)
    return losses


def serving_gpt_pair(vocab=61, d_model=48, layers=2, heads=4, max_len=64,
                     seed=0):
    """A small scanned reference GPT with seeded random weights, and the
    port's GPT (on the CPU) carrying the same weights: the serving
    tests' model pair."""
    from singa_tpu.models.gpt import GPT as JaxGPT
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import GPT

    kw = dict(vocab_size=vocab, d_model=d_model, num_layers=layers,
              num_heads=heads, max_len=max_len, dropout=0.0,
              scan_blocks=True)
    ref = JaxGPT(**kw)
    ref.eval()
    ref._ensure_initialized(max_len)
    params = randomize_params(ref, seed)
    port = GPT(**kw, device="cpu")
    port.eval()
    load_singa_tpu_params(port, params)
    return ref, port


# -- gloo ranks ----------------------------------------------------------------
#
# The distributed parity tests run the port in `world` spawned processes
# joined by a gloo group whose rendezvous is a file under the test's
# tmp_path (no TCP port, so parallel pytest workers never collide). Each
# rank runs one of the `_rank_*` scenarios below, which import only the
# port, and returns a dict of numpy arrays.
#
# The children run beside the suite's other workers on shared cores, so
# the harness holds them to rules that hold under that load:
# - one deadline for the whole group (and for the reference's process),
#   `SPAWN_DEADLINE_S`, the per-file budget of tests/conftest.py: a run
#   that needs longer is over the file's budget anyway;
# - each child writes its stderr (C++ aborts included) and, just before
#   the deadline, every thread's Python stack (`faulthandler`) to a log
#   beside its result; a failure's message carries that log's tail;
# - a rank passes a barrier of the whole group before the group is
#   destroyed, so no rank tears down its gloo pairs while a peer still
#   talks to them, and only then writes its result; a rank that failed
#   writes its traceback at once and skips the barrier;
# - the first rank that fails ends the wait: its peers, stuck in a
#   collective with it, are killed after a short grace.

#: seconds a spawn (a rank group, or the reference's process) may take
SPAWN_DEADLINE_S = 120.0
#: seconds before the deadline at which a child dumps its stacks
_DUMP_MARGIN_S = 10.0
#: seconds the surviving ranks get to finish once a peer has failed
_GRACE_S = 5.0


def _wait_all(procs, deadline_s):
    """Wait for every process until the deadline or the first nonzero
    exit (then the others get `_GRACE_S`); kill what is left. Returns
    {index: "killed at the deadline" | "killed after a peer failed"}."""
    import time

    end = time.monotonic() + deadline_s
    failed_at = None
    while True:
        alive = [p for p in procs if p.is_alive()]
        if not alive:
            break
        now = time.monotonic()
        if failed_at is None and any(
                p.exitcode not in (None, 0) for p in procs):
            failed_at = now
        if now >= end or (failed_at is not None
                          and now >= failed_at + _GRACE_S):
            break
        time.sleep(0.02)
    why = {}
    for i, p in enumerate(procs):
        if p.is_alive():
            why[i] = ("killed after a peer failed" if failed_at is not None
                      and time.monotonic() < end else
                      f"killed at the {deadline_s:.0f} s deadline")
            p.kill()
            p.join()
    return why


def _log_tail(path, n=4000) -> str:
    try:
        with open(path, "r", errors="replace") as f:
            text = f.read()
    except OSError:
        return ""
    return text[-n:]


def _child_logging(log, deadline_s):
    """Send this child's stderr (fd 2, so C++ messages too) to `log` and
    arm a dump of every thread's stack just before the deadline."""
    import faulthandler
    import os
    import sys

    f = open(log, "w", buffering=1)
    os.dup2(f.fileno(), 2)
    sys.stderr = f
    faulthandler.enable(file=f)
    faulthandler.dump_traceback_later(
        max(1.0, deadline_s - _DUMP_MARGIN_S), exit=False, file=f)
    return f


def _write_result(out, got) -> None:
    """Write a child's result whole: to a temporary name, flushed and
    synced, then renamed, so the parent never reads half a file."""
    import os
    import pickle

    tmp = f"{out}.part"
    with open(tmp, "wb") as f:
        pickle.dump(got, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, out)


def run_ranks(scenario, world, tmp_path, timeout=SPAWN_DEADLINE_S,
              **payload):
    """[result of rank r for r in range(world)] of `scenario(rank, world,
    **payload)`, a function of this module run in `world` spawned
    processes over gloo, all within one deadline of `timeout` seconds; a
    rank's exception, nonzero exit or missing result fails the call with
    every failed rank's traceback and log tail."""
    import multiprocessing as mp
    import pickle

    ctx = mp.get_context("spawn")
    init = f"file://{tmp_path}/rendezvous"
    outs = [tmp_path / f"rank{r}.pkl" for r in range(world)]
    logs = [tmp_path / f"rank{r}.log" for r in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(scenario.__name__, r, world, init, payload,
                               str(outs[r]), str(logs[r]), float(timeout)))
             for r in range(world)]
    for p in procs:
        p.start()
    why = _wait_all(procs, timeout)
    results, errors = [], []
    for r, (p, f) in enumerate(zip(procs, outs)):
        got = pickle.loads(f.read_bytes()) if f.exists() else None
        if p.exitcode != 0 or got is None or "traceback" in got:
            errors.append(
                f"rank {r} of {world} failed (exit {p.exitcode}"
                f"{', ' + why[r] if r in why else ''}"
                f"{', no result' if got is None else ''}):\n"
                f"{(got or {}).get('traceback', '')}"
                f"--- its log ---\n{_log_tail(logs[r])}")
        results.append(got)
    if errors:
        raise AssertionError("\n".join(errors))
    return results


def run_reference(module, name, tmp_path, timeout=SPAWN_DEADLINE_S,
                  **kwargs):
    """`name(**kwargs)`, a function of the test module `module` that
    computes the reference's side of a parity test, run in a spawned
    process of its own: a fresh singa_tpu, so no process-wide switch an
    earlier test left set in this pytest worker (the autocast policy,
    `autograd.training`, a mesh axis pushed and not popped, the op
    cache) reaches the reference's numbers. It inherits the worker's
    environment (conftest's 8-device CPU platform). Returns what the
    function returned (picklable: numpy arrays and numbers); its
    exception, a nonzero exit or the deadline fails the call with its
    traceback and its log's tail."""
    import multiprocessing as mp
    import pickle

    out = tmp_path / f"{name}.pkl"
    log = tmp_path / f"{name}.log"
    p = mp.get_context("spawn").Process(
        target=_reference_main,
        args=(module, name, kwargs, str(out), str(log), float(timeout)))
    p.start()
    why = _wait_all([p], timeout)
    got = pickle.loads(out.read_bytes()) if out.exists() else None
    if p.exitcode != 0 or got is None or "traceback" in got:
        raise AssertionError(
            f"the reference's {module}.{name} failed (exit {p.exitcode}"
            f"{', ' + why[0] if why else ''}"
            f"{', no result' if got is None else ''}):\n"
            f"{(got or {}).get('traceback', '')}"
            f"--- its log ---\n{_log_tail(log)}")
    return got["result"]


def run_both(reference, ranks):
    """(`run_reference(*reference)`, `run_ranks(*ranks[:-1], **ranks[-1])`)
    spawned at once, each waited on by a thread of its own: a file whose
    ranks do not need the reference's results pays the longer of the two
    spawns, not their sum."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as ex:
        ref = ex.submit(run_reference, *reference[:-1], **reference[-1])
        got = ex.submit(run_ranks, *ranks[:-1], **ranks[-1])
        return ref.result(), got.result()


def _reference_main(module, name, kwargs, out, log, deadline_s):
    import traceback

    _child_logging(log, deadline_s)
    try:
        import jax

        jax.config.update("jax_platforms", "cpu")
        got = {"result": getattr(importlib.import_module(module), name)(
            **kwargs)}
    except BaseException:  # reported to the parent, which fails the test
        got = {"traceback": traceback.format_exc()}
    _write_result(out, got)


def _rank_main(name, rank, world, init, payload, out, log, deadline_s):
    import traceback

    import torch.distributed as dist

    from singa_tpu_torch import distributed

    _child_logging(log, deadline_s)
    torch.set_num_threads(1)
    try:
        distributed.init(init, num_processes=world,
                         process_id=rank, device="cpu")
        got = globals()[name](rank, world, **payload)
    except BaseException:  # reported to the parent, which fails the test
        # the peers may be stuck in a collective with this rank: no
        # barrier, the parent ends them
        _write_result(out, {"traceback": traceback.format_exc()})
        distributed.shutdown()
        return
    try:
        # every rank is done talking before any tears its pairs down
        dist.barrier()
    except BaseException:
        got = {"traceback": traceback.format_exc()}
    finally:
        distributed.shutdown()
    _write_result(out, got)


def _np(t):
    return t.detach().cpu().numpy().copy()


def _rank_communicator(rank, world, xs, sparse):
    """Every Communicator method on this rank's rows of `xs` (name ->
    (world, ...) array)."""
    from singa_tpu_torch import distributed
    from singa_tpu_torch.communicator import Communicator

    c = Communicator(distributed.global_mesh())
    x = {k: torch.from_numpy(v[rank]) for k, v in xs.items()}
    out = {
        "world": np.asarray(c.world_size),
        "all_reduce": c.all_reduce(x["a"]),
        "all_reduce_sum": c.all_reduce(x["a"], average=False),
        "all_reduce_half": c.all_reduce_half(x["a"]),
        "all_gather": c.all_gather(x["a"]),
        "reduce_scatter": c.reduce_scatter(x["flat"]),
        "reduce_scatter_half": c.reduce_scatter_half(x["flat"]),
        "all_gather_half": c.all_gather_half(x["a"]),
        "broadcast": c.broadcast(x["a"], root=1),
        "reduce_scatter_buckets": torch.cat(c.reduce_scatter_buckets(
            [x["flat"], x["flat"] * 2])),
        "all_gather_buckets": torch.cat(c.all_gather_buckets(
            [x["a"], x["a"] * 2])),
    }
    for i, t in enumerate(c.fused_all_reduce(
            [x["f0"], x["f1"], x["f2"]], bucket_elems=6)):
        out[f"fused{i}"] = t
    for name, kw in sparse.items():
        dense, local, dropped = c.sparse_all_reduce(
            x["g"], return_local=True, return_stats=True, **kw)
        out[f"{name}_dense"], out[f"{name}_local"] = dense, local
        out[f"{name}_dropped"] = dropped
    return {k: v if isinstance(v, np.ndarray) else _np(v)
            for k, v in out.items()}


def port_mlp(params, hidden, classes, in_features, partial=False):
    """The port's MLP carrying `params`, dropout off; `partial` makes its
    step DistOpt's partial update (parameter subset idx 0)."""
    from singa_tpu_torch import autograd
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models import MLP

    class PartialMLP(MLP):
        def train_one_batch(self, x, y, dist_option="plain", spars=None):
            out = self.forward(x)
            loss = autograd.softmax_cross_entropy(out, y)
            self.optimizer.backward_and_partial_update(loss, idx=0)
            return out, loss

    m = (PartialMLP if partial else MLP)(hidden, classes,
                                         in_features=in_features,
                                         device="cpu")
    m.dropout.p = 0.0
    load_singa_tpu_params(m, params)
    return m


def _rank_distopt(rank, world, params, X, y, mode, steps, lr, spars,
                  states=None, hidden=16, classes=3):
    """`steps` DistOpt steps of the port's MLP on the global batch (X, y)
    in `mode` ("plain", "half", "sparse-topk", "sparse-thresh" or
    "partial"), from `params` and, when given, the reference's
    `dump_states()` (its residuals stacked (world, ...)); returns the
    losses, the parameters and the optimizer's dump."""
    from singa_tpu_torch import distributed, opt

    m = port_mlp(params, hidden, classes, X.shape[1],
                 partial=mode == "partial")
    d = opt.DistOpt(opt.SGD(lr=lr, momentum=0.9),
                    mesh=distributed.global_mesh(),
                    use_sparse=mode.startswith("sparse"))
    m.set_optimizer(d)
    if states is not None:
        d.load_states(states, strict=True)
    tx, ty = torch.from_numpy(X), torch.from_numpy(y).long()
    m.compile([tx], is_train=True, use_graph=True)
    dist_option = "plain" if mode == "partial" else mode
    losses = [m(tx, ty, dist_option, spars)[1].item()
              for _ in range(steps)]
    out = {"losses": np.asarray(losses)}
    out.update({f"param:{k}": _np(v) for k, v in m.get_params().items()})
    out.update({f"state:{k}": _np(torch.as_tensor(v))
                for k, v in d.dump_states().items()})
    out["dropped_last"] = np.asarray(d.sparse_dropped_last)
    return out


def _rank_bn_equivalence(rank, world, states, X, y, steps, lr):
    """The reference's sync-BN oracle model (`resnet20_cifar`) trained by
    DistOpt from `states`; returns the losses and every state."""
    from singa_tpu_torch import distributed, opt
    from singa_tpu_torch.model import load_singa_tpu_states
    from singa_tpu_torch.models import resnet20_cifar

    m = resnet20_cifar(10, device="cpu")
    m.set_optimizer(opt.DistOpt(opt.SGD(lr=lr, momentum=0.9),
                                mesh=distributed.global_mesh()))
    tx, ty = torch.from_numpy(X), torch.from_numpy(y).long()
    m.compile([tx], is_train=True, use_graph=True)
    load_singa_tpu_states(m, states)  # after compile's forward, as there
    losses = [m(tx, ty)[1].item() for _ in range(steps)]
    out = {"losses": np.asarray(losses)}
    out.update({k: _np(v) for k, v in m.get_states().items()})
    return out


def _rank_refusals(rank, world, X, y):
    """The distributed step's refusals: a batch the world does not
    divide, and sync BatchNorm outside a DistOpt step."""
    from singa_tpu_torch import autograd, distributed, opt
    from singa_tpu_torch.models import MLP

    m = MLP(8, 3, in_features=X.shape[1], device="cpu")
    m.set_optimizer(opt.DistOpt(opt.SGD(lr=0.1),
                                mesh=distributed.global_mesh()))
    tx, ty = torch.from_numpy(X), torch.from_numpy(y).long()
    m.compile([tx], is_train=True, use_graph=True)
    out = {}
    try:
        m(tx, ty)
    except ValueError as e:
        out["divisible"] = str(e)
    z = torch.ones(4, 2, 3, 3)
    try:
        autograd.batchnorm(z, torch.ones(2), torch.zeros(2), torch.zeros(2),
                           torch.ones(2), sync=True)
    except ValueError as e:
        out["sync"] = str(e)
    return out


def _rank_dist_imagenet(rank, world, argv):
    """`dist_imagenet.run` as rank `rank` of the group: its losses."""
    from singa_tpu_torch.examples import dist_imagenet

    out = dist_imagenet.run(dist_imagenet.parser().parse_args(
        [*argv, "--world", str(world), "--rank", str(rank)]))
    return {"losses": np.asarray(out["losses"]), "world": out["world"]}


#: the hybrid meshes of tests/test_torch_multislice.py: name -> (per-slice
#: shape or None, axis names, dcn_mesh_shape)
MULTISLICE_MESHES = {"data": (None, ("data",), (2,)),
                     "data_model": ((1, 2), ("data", "model"), (2, 1))}
#: global_mesh arguments the reference refuses, and the one the port adds
#: (more slices asked for than there are hosts)
MULTISLICE_REFUSALS = {
    "axes": (((2,), ("data",)), dict(dcn_mesh_shape=(2, 1))),
    "split": ((None, ("data",)), dict(dcn_mesh_shape=(3,))),
    "shape": (((2,), ("data", "model")), dict(dcn_mesh_shape=(2, 1))),
    "hosts": (((1,), ("data",)), dict(dcn_mesh_shape=(4,))),
}


def _rank_multislice(rank, world, group_ranks, flat_names, X, y, lr):
    """The multi-slice meshes with this rank's host given by torchrun's
    GROUP_RANK (`group_ranks[rank]`): each mesh's hybrid layout, ranks,
    dims, axis indices and axis groups; the refusals' messages; one
    DistOpt step of an MLP on this rank's two rows of `X` over the data
    axis of the hybrid (data, model) mesh, over the data axis of the
    flat 2 x 2 mesh over `flat_names` (`get_mesh`, no slices), and one
    plain SGD step on the rows of the hybrid data group's ranks (losses
    and parameters)."""
    import os

    import torch.distributed as dist

    from singa_tpu_torch import distributed, opt
    from singa_tpu_torch.models import MLP

    os.environ["GROUP_RANK"] = str(group_ranks[rank])
    slices = distributed.host_slices()
    out = {"slices": slices}
    for key, (shape, names, dcn) in MULTISLICE_MESHES.items():
        mesh = distributed.global_mesh(shape, names, dcn_mesh_shape=dcn)
        per = shape or (world // 2,)
        out[key] = dict(
            layout=distributed.hybrid_layout(slices, per, dcn),
            ranks=mesh.ranks, dims=mesh.dims,
            index={n: mesh.axis_index(n) for n in names},
            members={n: dist.get_process_group_ranks(mesh.axis_group(n))
                     for n in names})
    out["errors"] = {}
    for key, (args, kw) in MULTISLICE_REFUSALS.items():
        try:
            distributed.global_mesh(*args, **kw)
        except ValueError as e:
            out["errors"][key] = str(e)
    hybrid = distributed.global_mesh((1, 2), ("data", "model"),
                                     dcn_mesh_shape=(2, 1))
    group = dist.get_process_group_ranks(hybrid.axis_group("data"))
    rows = [2 * r + i for r in (rank,) for i in range(2)]
    whole = [2 * r + i for r in group for i in range(2)]
    flat = distributed.global_mesh((2, 2), flat_names)
    for key, mesh, idx in (("hybrid", hybrid, rows), ("flat", flat, rows),
                           ("group", None, whole)):
        tx = torch.from_numpy(X[idx])
        ty = torch.from_numpy(y[idx]).long()
        o = opt.SGD(lr=lr)
        if mesh is not None:
            # this rank's own rows, not a share of a global batch
            tx, ty = distributed.shard_batch(mesh, (tx, ty))
            o = opt.DistOpt(o, mesh=mesh)
        m = MLP(16, 3, in_features=X.shape[1], device="cpu",
                generator=torch.Generator().manual_seed(0))
        m.dropout.p = 0.0
        m.set_optimizer(o)
        m.compile([tx], is_train=True, use_graph=True)
        m(tx, ty)
        out[key] = {k: _np(v) for k, v in m.get_params().items()}
    out["data_group"] = group
    return out


def _rank_many(rank, world, calls):
    """Several scenarios in one spawn: {key: scenario(rank, world,
    **kwargs)} for each (key, scenario name, kwargs) of `calls`."""
    return {key: globals()[name](rank, world, **kw)
            for key, name, kw in calls}


# -- ZeRO-1 and each rank's dropout draws -----------------------------------------


def port_two_head(params, d_in=8):
    """The port's counterpart of the reference ZeRO-1 oracle's model
    (`tests/test_zero1.py::test_gradless_params_left_untouched`): a head
    the loss reads and one it never reaches, carrying `params`."""
    from singa_tpu_torch import autograd, layer, model
    from singa_tpu_torch.model import load_singa_tpu_params

    class TwoHead(model.Model):
        def __init__(self):
            super().__init__()
            self.fc = layer.Linear(3, in_features=d_in, device="cpu")
            self.unused = layer.Linear(5, in_features=d_in, device="cpu")

        def forward(self, x):
            return self.fc(x)

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = autograd.softmax_cross_entropy(out, y)
            self.optimizer(loss)
            return out, loss

    m = TwoHead()
    load_singa_tpu_params(m, params)
    return m


def _zero1_step(m, X, y, steps, dist_option="plain"):
    tx, ty = torch.from_numpy(X), torch.from_numpy(y).long()
    m.compile([tx], is_train=True, use_graph=True)
    args = () if dist_option == "plain" else (dist_option,)
    return [m(tx, ty, *args)[1].item() for _ in range(steps)]


def _rank_zero1(rank, world, params, X, y, steps, lr, distkw,
                clip_norm=None, wd=0.0, states=None, two_head=False,
                reshard_to=None, dist_option="plain"):
    """`steps` DistOpt(SGD(lr, momentum 0.9), **distkw) steps of the
    port's MLP (or the two-head model) on the global batch (X, y) from
    `params` and, when given, the states `states` (a reference dump);
    returns the losses, the parameters, this rank's dump, its canonical
    form (a collective over the group), the layout, and the state round
    trips' verdicts. `reshard_to=w`: then ranks [0, w) take one more
    step as a group of w from the canonical form."""
    import torch.distributed as tdist

    from singa_tpu_torch import distributed, opt
    from singa_tpu_torch.parallel import mesh as mesh_module

    def build(p, mesh):
        m = (port_two_head(p) if two_head
             else port_mlp(p, 16, 3, X.shape[1]))
        d = opt.DistOpt(opt.SGD(lr=lr, momentum=0.9, weight_decay=wd,
                                clip_norm=clip_norm), mesh=mesh, **distkw)
        m.set_optimizer(d)
        return m, d

    m, d = build(params, distributed.global_mesh())
    if states is not None:
        d.load_states(states, strict=True)
    out = {"losses": np.asarray(_zero1_step(m, X, y, steps,
                                            dist_option))}
    out.update({f"param:{k}": _np(v) for k, v in m.get_params().items()})
    dump = d.dump_states()
    out.update({f"state:{k}": _np(torch.as_tensor(v))
                for k, v in dump.items()})
    if not d.shard_states:
        return out
    out["chunk"] = np.asarray(d._z_chunk)
    out["buckets"] = np.asarray(len(d._z_buckets or []))
    canon = d.canonicalize_states(dump)
    out.update({f"canon:{k}": _np(v) for k, v in canon.items()})
    back = d.reshard_states(canon)
    out["reshard_roundtrip"] = np.asarray(all(
        torch.equal(back[k], torch.as_tensor(dump[k])) for k in dump))
    # the raw stack of every rank's rows, resharded at this world
    raw = {k: d.comm.all_gather(torch.as_tensor(v)) if "//__zshard__" in k
           else v for k, v in dump.items()}
    layout = d.zero1_layout()
    again = d.reshard_raw_states(raw, layout=layout)
    out["raw_roundtrip"] = np.asarray(all(
        torch.equal(again[k], torch.as_tensor(dump[k])) for k in dump))
    other = dict(layout, overlap=not layout["overlap"])
    try:
        d.reshard_raw_states(raw, layout=other)
    except ValueError as e:
        out["raw_refused"] = str(e)
    before = {k: torch.as_tensor(v).clone() for k, v in dump.items()}
    d.load_states(before, strict=True)
    out["load_roundtrip"] = np.asarray(all(
        torch.equal(torch.as_tensor(v), before[k])
        for k, v in d.dump_states().items()))
    if reshard_to is not None:
        sub = tdist.new_group(list(range(reshard_to)))
        if rank < reshard_to:
            after = {k: _np(v) for k, v in m.get_params().items()}
            m2, d2 = build(after, mesh_module.Mesh(sub))
            d2.load_states(d2.reshard_states(canon), strict=True)
            out["next_losses"] = np.asarray(_zero1_step(m2, X, y, 1))
            out.update({f"next:{k}": _np(v)
                        for k, v in m2.get_params().items()})
    return out


def _rank_gpt_lm(rank, world, argv):
    """`gpt_lm.run` as rank `rank` of the group: its losses and
    parameters."""
    from singa_tpu_torch.examples import gpt_lm

    out = gpt_lm.run(gpt_lm.parser().parse_args(argv))
    got = {"losses": np.asarray(out["losses"]),
           "world": np.asarray(out["world"])}
    got.update({f"param:{k}": _np(v)
                for k, v in out["model"].get_params().items()})
    return got


def dropout_masks(m):
    """Record the zero pattern each call of `m.dropout` leaves (where
    its input was not already 0)."""
    masks = []
    m.dropout.register_forward_hook(
        lambda mod, inp, o: masks.append(_np((o == 0) & (inp[0] != 0))))
    return masks


def _rank_dropout(rank, world, params, X, y, steps, lr, p, seed):
    """Plain DistOpt steps of the port's MLP at dropout `p` from torch
    seed `seed`: the losses, the parameters and the first step's mask
    (each rank draws its own, `autograd.rank_draws`)."""
    from singa_tpu_torch import autograd, distributed, opt

    torch.manual_seed(seed)
    autograd.reset_rank_draws()
    m = port_mlp(params, 16, 3, X.shape[1])
    m.dropout.p = p
    m.set_optimizer(opt.DistOpt(opt.SGD(lr=lr, momentum=0.9),
                                mesh=distributed.global_mesh()))
    tx, ty = torch.from_numpy(X), torch.from_numpy(y).long()
    m.compile([tx], is_train=True, use_graph=True)
    masks = dropout_masks(m)
    losses = [m(tx, ty)[1].item() for _ in range(steps)]
    out = {"losses": np.asarray(losses), "mask": masks[0]}
    out.update({f"param:{k}": _np(v) for k, v in m.get_params().items()})
    return out


# -- the reference's ZeRO-1 runs ---------------------------------------------------


def zero1_blobs(n, d, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    W = rng.randn(d, classes).astype(np.float32)
    return X, (X @ W).argmax(1).astype(np.int32)


def zero1_data(kind):
    """The global batch of the ZeRO-1 cases: the MLP's (32 x 12) or the
    two-head model's (16 x 8)."""
    return zero1_blobs(32, 12) if kind == "mlp" else zero1_blobs(
        16, 8, seed=1)


def ref_mesh(world):
    """The reference's mesh over its first `world` virtual devices."""
    import jax

    from singa_tpu import parallel

    return parallel.get_mesh((world,), devices=jax.devices()[:world])


def ref_two_head():
    """The reference ZeRO-1 oracle's two-head model
    (`tests/test_zero1.py::test_gradless_params_left_untouched`)."""
    from singa_tpu import autograd, layer, model

    class TwoHead(model.Model):
        def __init__(self):
            super().__init__()
            self.fc = layer.Linear(3)
            self.unused = layer.Linear(5)

        def forward(self, x):
            return self.fc(x)

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = autograd.softmax_cross_entropy(out, y)
            self.optimizer(loss)
            return out, loss

    return TwoHead()


def ref_zero1(world, distkw, clip_norm, wd, kind, dist_option, seed, steps,
              lr, snapshot_at=None):
    """The reference's DistOpt(SGD(lr, momentum 0.9, wd, clip_norm),
    **distkw) run on its `world`-device mesh: the seeded parameters, the
    losses, the parameters and dump after, its canonical form; with
    `snapshot_at=k`, also the parameters and dump after step k."""
    from singa_tpu import opt as ref_opt
    from singa_tpu import tensor
    from singa_tpu.communicator import DistOpt as RefDistOpt
    from singa_tpu.models import MLP as RefMLP

    tensor.set_seed(seed)
    X, y = zero1_data(kind)
    if kind == "two_head":
        m = ref_two_head()
    else:
        m = RefMLP(perceptron_size=16, num_classes=3)
        m.dropout.p = 0.0
    d = RefDistOpt(ref_opt.SGD(lr=lr, momentum=0.9, weight_decay=wd,
                               clip_norm=clip_norm), mesh=ref_mesh(world),
                   **distkw)
    m.set_optimizer(d)
    tx, ty = tensor.from_numpy(X), tensor.from_numpy(y)
    if kind == "two_head":  # build the head the loss never reaches too
        m.compile([tx], is_train=False, use_graph=False)
        m.unused(tx)
        m.train()
    m.compile([tx], is_train=True, use_graph=True)
    params = randomize_params(m, seed)
    args = () if dist_option == "plain" else (dist_option,)

    def state():
        return ({k: np.asarray(v.data) for k, v in m.get_params().items()},
                {k: np.asarray(v) for k, v in d.dump_states().items()})

    out = dict(params=params, losses=[])
    for i in range(steps):
        out["losses"].append(float(np.asarray(m(tx, ty, *args)[1].data)))
        if i + 1 == snapshot_at:
            out["snapshot"] = state()
    out["after"], out["dump"] = state()
    out["canon"] = ({k: np.asarray(v) for k, v in d.canonicalize_states(
        d.dump_states()).items()} if d.shard_states else None)
    return out


def ref_zero1_continue(world, params, canonical, seed, lr):
    """One reference ZeRO-1 step of the MLP on a `world`-device mesh from
    `params` and a canonical dump: (loss, parameters after)."""
    from singa_tpu import opt as ref_opt
    from singa_tpu import tensor
    from singa_tpu.communicator import DistOpt as RefDistOpt
    from singa_tpu.models import MLP as RefMLP

    tensor.set_seed(seed)
    X, y = zero1_data("mlp")
    m = RefMLP(perceptron_size=16, num_classes=3)
    m.dropout.p = 0.0
    d = RefDistOpt(ref_opt.SGD(lr=lr, momentum=0.9), mesh=ref_mesh(world),
                   shard_states=True)
    m.set_optimizer(d)
    tx, ty = tensor.from_numpy(X), tensor.from_numpy(y)
    m.compile([tx], is_train=True, use_graph=True)
    m.set_params(params)
    d.prepare(m.get_params())
    d.load_states(d.reshard_states(canonical))
    loss = float(np.asarray(m(tx, ty)[1].data))
    return loss, {k: np.asarray(v.data) for k, v in m.get_params().items()}


def _rank_scatter_axis(rank, world, xs):
    """reduce_scatter and all_gather along axis 1 and on the bf16 wires,
    on this rank's rows of `xs`."""
    from singa_tpu_torch import distributed
    from singa_tpu_torch.communicator import Communicator

    c = Communicator(distributed.global_mesh())
    x = torch.from_numpy(xs[rank])
    return {k: _np(v) for k, v in {
        "reduce_scatter": c.reduce_scatter(x, axis=1),
        "reduce_scatter_sum": c.reduce_scatter(x, axis=1, average=False),
        "reduce_scatter_half": c.reduce_scatter_half(x, axis=1),
        "all_gather": c.all_gather(x, axis=1),
        "all_gather_half": c.all_gather_half(x, axis=1)}.items()}


# -- sequence parallelism -----------------------------------------------------------


def _rank_ring(rank, world, q, k, v, cases):
    """Ring or Ulysses attention on this rank's sequence shard of the
    global (B, H, T, D) q, k, v, for each case (name -> dict of impl,
    dtype, causal, use_flash, pipelined, remat), over a 1-D "sp" mesh of
    the group: the output shard and the shards' gradients of
    sum(sin(out)); and the Ulysses head guard's message."""
    from singa_tpu_torch.parallel import mesh as mesh_module
    from singa_tpu_torch.parallel.ring import ring_attention
    from singa_tpu_torch.parallel.ulysses import ulysses_attention

    mesh = mesh_module.get_mesh((world,), ("sp",))
    t = q.shape[2] // world
    out = {}
    for name, c in cases.items():
        dt = getattr(torch, c["dtype"])
        xs = [torch.from_numpy(a[:, :, rank * t:(rank + 1) * t].copy()).to(
            dt).requires_grad_() for a in (q, k, v)]
        with mesh_module.axes_context("sp", mesh=mesh):
            if c["impl"] == "ring":
                o = ring_attention(*xs, "sp", causal=c["causal"],
                                   remat=c["remat"],
                                   use_flash=c["use_flash"],
                                   pipelined=c["pipelined"])
            else:
                o = ulysses_attention(*xs, "sp", causal=c["causal"],
                                      use_flash=c["use_flash"],
                                      remat=c["remat"])
        torch.sin(o.float()).sum().backward()
        out[name] = {"o": _np(o.float()), "dtype": str(o.dtype),
                     **{g: _np(x.grad.float())
                        for g, x in zip(("dq", "dk", "dv"), xs)}}
    with mesh_module.axes_context("sp", mesh=mesh):
        try:
            x = torch.zeros(1, world - 1, t, 32)
            ulysses_attention(x, x, x, "sp")
        except ValueError as e:
            out["head_guard"] = str(e)
    return out


def port_sp_model(kind, params, **kw):
    """A port model on the CPU carrying `params`: "gpt" is
    `GPT(**kw)`, "bert" `BertForClassification(**kw)`."""
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import GPT
    from singa_tpu_torch.models.transformer import BertForClassification

    m = (GPT if kind == "gpt" else BertForClassification)(
        device="cpu", **kw)
    load_singa_tpu_params(m, params)
    return m


def sp_train(m, opt_, x, y, steps, dist_option="plain"):
    """`steps` graph-mode `train_one_batch(x, y[, dist_option])` calls of
    `m` under `opt_`: the losses."""
    tx, ty = torch.from_numpy(x).long(), torch.from_numpy(y).long()
    m.set_optimizer(opt_)
    m.compile([tx], is_train=True, use_graph=True)
    args = () if dist_option == "plain" else (dist_option,)
    return [m.train_one_batch(tx, ty, *args)[1].item()
            for _ in range(steps)]


def _rank_sp(rank, world, kind, params, kw, x, y, steps, mesh_shape, lr,
             momentum=0.0, dist_option="plain", seq_axis="seq"):
    """The port's `kind` model with `seq_axis` trained by DistOpt(SGD)
    over a (data, seq_axis) mesh of `mesh_shape` on the global batch:
    its losses, the optimizer's grad_axes, or the error it raised."""
    from singa_tpu_torch import opt
    from singa_tpu_torch.parallel import mesh as mesh_module

    mesh = mesh_module.get_mesh(mesh_shape, ("data", seq_axis))
    m = port_sp_model(kind, params, seq_axis=seq_axis, **kw)
    d = opt.DistOpt(opt.SGD(lr=lr, momentum=momentum), mesh=mesh,
                    axis_name="data")
    try:
        losses = sp_train(m, d, x, y, steps, dist_option)
    except ValueError as e:
        return {"error": str(e)}
    return {"losses": np.asarray(losses),
            "grad_axes": list(d.grad_axes)}


def _rank_long_context(rank, world, argv):
    """`long_context.run` as rank `rank` of the group: its losses and
    mesh."""
    from singa_tpu_torch.examples import long_context

    out = long_context.run(long_context.parser().parse_args(argv))
    return {"losses": np.asarray(out["losses"]), "mesh": out["mesh"]}


# -- tensor parallelism ------------------------------------------------------------


#: the cases of `tp_function_cases`: their leaves, and of those the ones
#: each rank uses only a block of (its gradient is that block's part)
TP_FUNCTION_LEAVES = {
    "mlp": (("x", "w1", "b1", "w2", "b2"), ("w1", "b1", "w2")),
    "attention": (("x", "w_qkv", "b_qkv", "w_o", "b_o"),
                  ("w_qkv", "b_qkv", "w_o")),
    "col_gather": (("x", "w_col", "b_col"), ("w_col", "b_col")),
    "row": (("x_row", "w_row", "b_row"), ("x_row", "w_row")),
}


def tp_function_cases(tp, full_attention, arrays):
    """The port's Part-B functions of `tp` on full weights from `arrays`
    (numpy), each output replicated over the model axis: yields (case,
    output, {name: leaf tensor}), each case's forward run as it is
    drawn. The column product opens with "f", as the composites do."""
    a = arrays
    h = int(a["heads"])

    def leaf(name):
        return torch.from_numpy(a[name].copy()).requires_grad_()

    def cases():
        x = leaf("x")
        w1, b1, w2, b2 = (leaf(n) for n in ("w1", "b1", "w2", "b2"))
        yield "mlp", tp.tp_mlp(x, w1, b1, w2, b2, "model"), dict(
            x=x, w1=w1, b1=b1, w2=w2, b2=b2)
        x = leaf("x")
        wq, bq, wo, bo = (leaf(n) for n in ("w_qkv", "b_qkv", "w_o", "b_o"))
        q, k, v = tp.tp_attention_qkv(x, wq, bq, h, "model")
        yield "attention", tp.tp_attention_out(
            full_attention(q, k, v), wo, bo, "model"), dict(
            x=x, w_qkv=wq, b_qkv=bq, w_o=wo, b_o=bo)
        x, w, b = leaf("x"), leaf("w_col"), leaf("b_col")
        xin = tp.identity_psum_bwd("model")(x)
        yield "col_gather", tp.gather_cols(tp.col_linear(
            xin, tp.shard_col(w, "model"), tp.shard_col(b, "model")),
            "model"), dict(x=x, w_col=w, b_col=b)
        x, w, b = leaf("x_row"), leaf("w_row"), leaf("b_row")
        yield "row", tp.row_linear(tp.shard_col(x, "model"),
                                   tp.shard_row(w, "model"), "model", b), \
            dict(x_row=x, w_row=w, b_row=b)

    return cases()


def tp_function_arrays(world=2, b=2, t=4, d=16, heads=4):
    """Seeded inputs of the tp function cases: weights at the 1/sqrt(fan
    in) scale of an init, so activations stay O(1) through the blocks."""
    rng = np.random.default_rng(17)

    def r(*shape):
        scale = 1.0 if len(shape) != 2 else shape[0] ** -0.5
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(x=r(b, t, d), w1=r(d, 4 * d), b1=r(4 * d), w2=r(4 * d, d),
                b2=r(d), w_qkv=r(d, 3 * d), b_qkv=r(3 * d), w_o=r(d, d),
                b_o=r(d), w_col=r(d, 8), b_col=r(8), x_row=r(b, t, 8),
                w_row=r(8, d), b_row=r(d), heads=np.array(heads),
                world=np.array(world))


def _rank_tp_funcs(rank, world, arrays):
    """Every Part-B function of `parallel.tp` over a 1-D "model" mesh of
    the group, on the full weights of `arrays`: each case's output and
    this rank's gradients of sum(out**2) (the loss replicated over the
    axis, counted once), the "g"/"f" counts of each case, the
    pre-sharded MLP and interleaved attention on this rank's blocks, the
    divisibility guard's message, and the dense forms outside the
    axis."""
    from singa_tpu_torch.parallel import mesh as mesh_module
    from singa_tpu_torch.parallel import tp
    from singa_tpu_torch.parallel.ring import full_attention

    mesh = mesh_module.get_mesh((world,), ("model",))
    out = {}
    with mesh_module.axes_context("model", mesh=mesh):
        cases = tp_function_cases(tp, full_attention, arrays)
        while True:
            before = dict(tp.COUNTS)
            try:
                name, y, leaves = next(cases)
            except StopIteration:
                break
            (y ** 2).sum().backward()
            out[name] = {"out": _np(y), **{
                f"grad:{k}": _np(v.grad) for k, v in leaves.items()}}
            out[name]["counts"] = {
                f"{k[0]}:{k[1]}": v - before.get(k, 0)
                for k, v in tp.COUNTS.items() if v != before.get(k, 0)}
        # the production layout: each rank holds only its blocks
        a = {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}
        loc = 4 * a["x"].shape[-1] // world
        w1 = a["w1"][:, rank * loc:(rank + 1) * loc]
        b1 = a["b1"][rank * loc:(rank + 1) * loc]
        w2 = a["w2"][rank * loc:(rank + 1) * loc]
        out["mlp_pre_sharded"] = _np(tp.tp_mlp(a["x"], w1, b1, w2, a["b2"],
                                               "model", pre_sharded=True))
        h = int(arrays["heads"])
        w_int = tp.interleave_qkv_shards(a["w_qkv"], world)
        b_int = tp.interleave_qkv_shards(a["b_qkv"], world)
        c3 = w_int.shape[-1] // world
        d_loc = a["w_o"].shape[0] // world
        q, k, v = tp.tp_attention_qkv(
            a["x"], w_int[:, rank * c3:(rank + 1) * c3],
            b_int[rank * c3:(rank + 1) * c3], h, "model", pre_sharded=True)
        out["attention_interleaved"] = _np(tp.tp_attention_out(
            full_attention(q, k, v), a["w_o"][rank * d_loc:(rank + 1) *
                                              d_loc],
            a["b_o"], "model", pre_sharded=True))
        try:
            tp.shard_col(torch.zeros(3, 2 * world + 1), "model")
        except ValueError as e:
            out["guard"] = str(e)
    # outside the axis: the dense forms, no collective
    before = sum(tp.COUNTS.values())
    out["dense"] = {name: _np(y) for name, y, _ in tp_function_cases(
        tp, full_attention, arrays)}
    out["dense_collectives"] = sum(tp.COUNTS.values()) - before
    return out


def port_tp_mlp(hidden=16, num_classes=4, tp_axis=None):
    """The port's counterpart of tests/test_tp_model.py's TpMLP: a plain
    Linear upstream of a column -> row tensor-parallel pair."""
    from singa_tpu_torch import autograd, layer, model

    class TpMLP(model.Model):
        def __init__(self):
            super().__init__()
            self.fc0 = layer.Linear(12, device="cpu")
            self.fc1 = layer.Linear(hidden, tp_axis=tp_axis, tp_mode="col",
                                    device="cpu")
            self.act = layer.Gelu()
            self.fc2 = layer.Linear(num_classes, tp_axis=tp_axis,
                                    tp_mode="row", device="cpu")

        def forward(self, x):
            return self.fc2(self.act(self.fc1(self.fc0(x))))

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = autograd.softmax_cross_entropy(out, y)
            self.optimizer(loss)
            return out, loss

    return TpMLP()


def port_tp_bert(tp_axis=None):
    """tests/test_tp_model.py's BERT: one block, d 16, 4 heads."""
    from singa_tpu_torch.models.transformer import BertForClassification

    return BertForClassification(
        num_classes=4, num_layers=1, d_model=16, num_heads=4, vocab_size=50,
        max_len=8, dropout=0.0, tp_axis=tp_axis, device="cpu")


def tp_train(m, states, x, y, steps, lr, momentum, mesh):
    """`steps` graph-mode steps of `m` from `states` (full arrays,
    loaded after compile: a DistOpt over `mesh` places the model there)
    on the global batch: (losses, gathered states after, the eval
    logits)."""
    from singa_tpu_torch import opt

    tx, ty = torch.from_numpy(x), torch.from_numpy(y).long()
    sgd = opt.SGD(lr=lr, momentum=momentum)
    m.set_optimizer(sgd if mesh is None else opt.DistOpt(
        sgd, mesh=mesh, axis_name="data"))
    m.compile([tx], is_train=True, use_graph=True)
    m.set_states(states)
    losses = [m.train_one_batch(tx, ty)[1].item() for _ in range(steps)]
    after = {k: _np(v) for k, v in m.get_states().items()}
    m.eval()
    with torch.no_grad():
        logits = _np(m(tx))
    return losses, after, logits


def _rank_tp_model(rank, world, mlp, bert, steps):
    """tests/test_tp_model.py's training cases over the group: the MLP
    and BERT on a (data 2, model 2) mesh of the 4 ranks, the MLP on a
    (data 1, model 2) mesh of ranks 0-1 (`get_mesh(devices=)`), rank 0's
    dense twins without a group's mesh; each run's losses, gathered
    states and eval logits, and the placed blocks' shapes and pspecs."""
    from singa_tpu_torch.parallel import mesh as mesh_module

    out = {}
    dp_tp = mesh_module.get_mesh((2, 2), ("data", "model"))
    try:
        tp_only = mesh_module.get_mesh((1, 2), ("data", "model"),
                                       devices=[0, 1])
    except ValueError as e:
        tp_only, out["outside_the_subset"] = None, str(e)
    cfg = dict(mlp=(lambda ax: port_tp_mlp(tp_axis=ax), mlp, 0.1, 0.9),
               bert=(port_tp_bert, bert, 0.1, 0.0))
    for kind, (make, d, lr, mom) in cfg.items():
        m = make("model")
        out[f"{kind}_dp_tp"] = tp_train(m, d["states"], d["x"], d["y"],
                                        steps[kind], lr, mom, dp_tp)
        out[f"{kind}_blocks"] = {
            n: (tuple(p.shape), p.pspec, p.placed[0])
            for n, p in m.named_parameters() if getattr(p, "placed", None)}
        if rank == 0:
            out[f"{kind}_dense"] = tp_train(
                make(None), d["dense_states"], d["x"], d["y"], steps[kind],
                lr, mom, None)
    if tp_only is not None:
        out["mlp_tp"] = tp_train(port_tp_mlp(tp_axis="model"),
                                 mlp["states"], mlp["x"], mlp["y"],
                                 steps["mlp"], 0.1, 0.9, tp_only)
    return out


def _rank_clip_sharded(rank, world, states, x, y, steps, lr, clip):
    """F10: the TpMLP on a (data 1, model 2) mesh with
    DistOpt(SGD(lr, clip_norm=clip)), and rank 0's dense twin with
    SGD(lr, clip_norm=clip), from the same full states: each run's
    losses and gathered states after."""
    from singa_tpu_torch import opt
    from singa_tpu_torch.parallel import mesh as mesh_module

    def run(m, optimizer):
        tx, ty = torch.from_numpy(x), torch.from_numpy(y).long()
        m.set_optimizer(optimizer)
        m.compile([tx], is_train=True, use_graph=True)
        m.set_states(states)
        losses = [m.train_one_batch(tx, ty)[1].item() for _ in range(steps)]
        return dict(losses=np.asarray(losses), after={
            k: _np(v) for k, v in m.get_states().items()})

    mesh = mesh_module.get_mesh((1, 2), ("data", "model"))
    out = dict(tp=run(port_tp_mlp(tp_axis="model"), opt.DistOpt(
        opt.SGD(lr=lr, clip_norm=clip), mesh=mesh, axis_name="data")))
    if rank == 0:
        out["dense"] = run(port_tp_mlp(), opt.SGD(lr=lr, clip_norm=clip))
    return out


def _rank_scan_tp(rank, world, kw, states, dense_params, x, y, steps, lr,
                  prompt, n_new, window):
    """The scanned GPT with `tp_axis` trained by DistOpt(SGD) on a (data
    1, model 2) mesh of ranks 0-1 (`get_mesh(devices=)`), and with
    `tp_axis` x `seq_axis` on `get_mesh_3d(1, 2, 2)` of the 4 ranks:
    losses, gathered states after, the "g"/"f" counts of one step, the
    declared schedule, and the greedy `generate` of the trained stack
    (its blocks gathered, its QKV de-interleaved); rank 0's dense twin
    (the unrolled decoder) losses and `generate` from the same init."""
    from singa_tpu_torch import opt
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import GPT
    from singa_tpu_torch.parallel import mesh as mesh_module
    from singa_tpu_torch.parallel import tp

    out = {}
    meshes = {}
    try:
        meshes["tp"] = mesh_module.get_mesh((1, 2), ("data", "model"),
                                            devices=[0, 1])
    except ValueError:
        pass
    meshes["tp_seq"] = mesh_module.get_mesh_3d(1, 2, 2)
    tx, ty = torch.from_numpy(x).long(), torch.from_numpy(y).long()
    for name, mesh in meshes.items():
        m = GPT(**kw, scan_blocks=True, tp_axis="model",
                seq_axis="sp" if name == "tp_seq" else None, device="cpu")
        m.set_optimizer(opt.DistOpt(opt.SGD(lr=lr), mesh=mesh,
                                    axis_name="data"))
        m.compile([tx], is_train=True, use_graph=True)
        m.set_states(states)
        losses = []
        for i in range(steps):
            before = dict(tp.COUNTS)
            losses.append(m.train_one_batch(tx, ty)[1].item())
            if i == 0:
                counts = {f"{k[0]}:{k[1]}": v - before.get(k, 0)
                          for k, v in tp.COUNTS.items()
                          if v != before.get(k, 0)}
        out[name] = dict(
            losses=np.asarray(losses), counts=counts,
            schedule=m.decoder.declared_schedule(mesh),
            block_shape=tuple(m.decoder.w_qkv.shape),
            after={k: _np(v) for k, v in m.get_states().items()},
            tokens=m.generate(prompt, n_new, window=window))
    if rank == 0:
        d = GPT(**kw, scan_blocks=False, device="cpu")
        load_singa_tpu_params(d, dense_params)
        d.set_optimizer(opt.SGD(lr=lr))
        d.compile([tx], is_train=True, use_graph=True)
        out["dense"] = dict(
            losses=np.asarray([d.train_one_batch(tx, ty)[1].item()
                               for _ in range(steps)]),
            tokens=d.generate(prompt, n_new, window=window))
    return out


# -- ZeRO-3 on the scanned stack ---------------------------------------------------

#: the meshes of `_rank_zero3`, built on every rank in this order
Z3_MESHES = {"data": ((4,), ("data",)), "dp_tp": ((2, 2), ("data", "model")),
             "dp_sp": ((2, 2), ("data", "sp")),
             "tp4": ((1, 4), ("data", "model"))}


def _rank_zero3(rank, world, kw, states, x, y, steps, lr, cases, prompt,
                n_new):
    """The scanned GPT with `zero3_axis="data"` (alone, beside `tp_axis`
    or `seq_axis`, serial or `overlap`) trained by DistOpt(SGD) on the
    meshes of `Z3_MESHES`, one run a case (`cases`: name -> dict(mesh,
    gpt, remat, clip, mutate, kw), or with `expect` the ValueError of
    its first step), each from the full init states of
    its layout (`states["plain"]` or `states["tp"]`): losses, gathered
    states after, the local shapes of the stack, its declared schedule
    and `step_memory_analysis`'s parameter and gathered bytes; and for
    the serial zero3 case the greedy decode of the trained model, the
    momentum slot's local shape, and a dense scanned twin's decode from
    the gathered states (rank 0)."""
    from singa_tpu_torch import graph, layer, opt
    from singa_tpu_torch.models.gpt import GPT
    from singa_tpu_torch.parallel import mesh as mesh_module

    meshes = {k: mesh_module.get_mesh(*v) for k, v in Z3_MESHES.items()}
    tx, ty = torch.from_numpy(x).long(), torch.from_numpy(y).long()
    out = {}
    for name, c in cases.items():
        mesh = meshes[c["mesh"]]
        m = GPT(**{**kw, **c.get("kw", {})}, scan_blocks=True,
                remat_policy=c.get("remat", "none"), device="cpu",
                **c["gpt"])
        m.set_optimizer(opt.DistOpt(opt.SGD(lr=lr, clip_norm=c.get("clip")),
                                    mesh=mesh, axis_name="data"))
        if "expect" in c:
            try:
                m.compile([tx], is_train=True, use_graph=True)
                m.train_one_batch(tx, ty)
            except ValueError as e:
                out[name] = {"error": str(e)}
                continue
            raise AssertionError(f"{name}: no ValueError")
        m.compile([tx], is_train=True, use_graph=True)
        m.set_states(states["tp" if "tp_axis" in c["gpt"] else "plain"])
        layer._MUTATE_CONSUME_CURRENT_GATHER = bool(c.get("mutate"))
        try:
            losses = [m.train_one_batch(tx, ty)[1].item()
                      for _ in range(steps)]
        finally:
            layer._MUTATE_CONSUME_CURRENT_GATHER = False
        mem = graph.step_memory_analysis(m, tx, ty)
        dec = m.decoder
        got = dict(
            losses=np.asarray(losses),
            after={k: _np(v) for k, v in m.get_states().items()},
            shapes={n: tuple(getattr(dec, n).shape) for n in dec.STACKED},
            schedule=dec.declared_schedule(mesh),
            parameter_bytes=mem["parameter_bytes"],
            gathered_block_bytes=mem["gathered_block_bytes"])
        if name == "z3":
            got["tokens"] = m.generate(prompt, n_new, window=32)
            if rank == 0:
                twin = GPT(**kw, scan_blocks=True, device="cpu")
                twin.set_states(got["after"])
                got["twin_tokens"] = twin.generate(prompt, n_new, window=32)
            mom = GPT(**kw, scan_blocks=True, zero3_axis="data",
                      device="cpu")
            sgd = opt.SGD(lr=lr, momentum=0.9)
            mom.set_optimizer(opt.DistOpt(sgd, mesh=mesh, axis_name="data"))
            got["slot_shape"] = tuple(
                sgd._slots[id(mom.decoder.w1)]["momentum"].shape)
        out[name] = got
    return out


# -- the Switch MoE FFN and expert parallelism -------------------------------------


def _rank_moe_ffn(rank, world, cases):
    """`parallel.moe.moe_ffn` over an expert axis of the 4 ranks, each
    rank on its rows of x and its expert of the stacked weights (name ->
    dict(x, w_gate, w1, b1, w2, b2, r)): this rank's output, aux, and
    the gradients of sum(y * r) for x and its expert's weights."""
    from singa_tpu_torch.parallel import mesh as mesh_module
    from singa_tpu_torch.parallel.moe import moe_ffn

    mesh = mesh_module.get_mesh((world,), ("expert",))
    out = {}
    for name, c in cases.items():
        n = c["x"].shape[0] // world
        t = {k: torch.from_numpy(np.ascontiguousarray(
            c[k][rank * n:(rank + 1) * n] if k in ("x", "r") else
            c[k] if k == "w_gate" else c[k][rank])).requires_grad_(True)
            for k in ("x", "w_gate", "w1", "b1", "w2", "b2", "r")}
        with mesh_module.axes_context("expert", mesh=mesh):
            y, aux = moe_ffn(t["x"], t["w_gate"], t["w1"], t["b1"], t["w2"],
                             t["b2"], "expert")
            (y * t["r"]).sum().backward()
        out[name] = dict(y=_np(y), aux=float(aux), grads={
            k: _np(t[k].grad) for k in ("x", "w1", "b1", "w2", "b2")})
    return out


def port_moe_net(num_classes=4, n_experts=4, moe_axis=None, cf=8.0,
                 aux_coef=0.0):
    """The port's counterpart of tests/test_moe_model.py's MoeNet:
    Linear(16) -> MoEFFN(ffn_mult 2) -> Linear(classes), the aux loss at
    `aux_coef`; `train_one_batch(x, y, dist_option)` takes the plain or
    the bf16-wire sync."""
    from singa_tpu_torch import autograd, layer, model

    class MoeNet(model.Model):
        def __init__(self):
            super().__init__()
            self.fc0 = layer.Linear(16, device="cpu")
            self.moe = layer.MoEFFN(n_experts, ffn_mult=2, moe_axis=moe_axis,
                                    capacity_factor=cf, device="cpu")
            self.fc1 = layer.Linear(num_classes, device="cpu")
            self.moe_axis = moe_axis

        def forward(self, x):
            return self.fc1(self.moe(self.fc0(x)))

        def train_one_batch(self, x, y, dist_option="plain"):
            out = self.forward(x)
            loss = autograd.softmax_cross_entropy(out, y)
            if aux_coef:
                loss = loss + self.moe.aux * aux_coef
            self._apply_opt(loss, dist_option)
            return out, loss

    return MoeNet()


def port_moe_model(kind, moe_axis, **kw):
    """The port's MoE model of a tests/test_moe_model.py or
    tests/test_hybrid_3axis.py case: "net" (`port_moe_net(**kw)`),
    "bert" (one block, d 16, 4 heads, 4 experts), "gpt" (2 blocks, d 16,
    4 heads; `kw` its experts, capacity, tp and seq axes)."""
    from singa_tpu_torch.models.gpt import GPT
    from singa_tpu_torch.models.transformer import BertForClassification

    if kind == "net":
        return port_moe_net(moe_axis=moe_axis, **kw)
    if kind == "bert":
        return BertForClassification(
            num_classes=4, num_layers=1, d_model=16, num_heads=4,
            vocab_size=50, max_len=8, dropout=0.0, moe_experts=4,
            moe_axis=moe_axis, moe_aux_coef=0.0, moe_capacity_factor=8.0,
            device="cpu")
    return GPT(vocab_size=64, d_model=16, num_layers=2, num_heads=4,
               dropout=0.0, moe_axis=moe_axis, moe_aux_coef=0.0,
               device="cpu", **kw)


#: the meshes of `_rank_moe`, built on every rank in this order
MOE_MESHES = {"dp_ep": ((2, 2), ("data", "expert")),
              "ep": ((1, 4), ("data", "expert")),
              "dp_ep_tp": ((1, 2, 2), ("data", "expert", "model")),
              "dp_sp_ep": ((1, 2, 2), ("data", "sp", "expert")),
              "dp_sp_tp": ((1, 2, 2), ("data", "sp", "model"))}


def _rank_moe(rank, world, cases, steps, lr):
    """The MoE cases over the meshes of `MOE_MESHES`: each case (name ->
    dict(kind, kw, mesh, states, x, y, momentum, dist_option, expect))
    builds `port_moe_model(kind, moe_axis, **kw)`, trains it `steps`
    times by DistOpt(SGD) on the global batch from the full `states`, and
    gives the losses, the gathered states after, the gate's motion and
    the expert shards' local shapes; a case with `expect` (an exception
    type's name) gives the message it raised."""
    from singa_tpu_torch import opt
    from singa_tpu_torch.parallel import mesh as mesh_module

    meshes = {k: mesh_module.get_mesh(*v) for k, v in MOE_MESHES.items()}
    out = {}
    for name, c in cases.items():
        ax = "expert" if "expert" in MOE_MESHES[c["mesh"]][1] else None
        m = port_moe_model(c["kind"], c.get("moe_axis", ax), **c["kw"])
        for attr, v in c.get("model_attrs", {}).items():
            setattr(m, attr, v)
        sgd = opt.SGD(lr=lr, momentum=c.get("momentum", 0.0))
        tx = torch.from_numpy(c["x"])
        tx = tx.long() if tx.dtype == torch.int32 else tx
        ty = torch.from_numpy(c["y"]).long()
        try:
            m.set_optimizer(opt.DistOpt(sgd, mesh=meshes[c["mesh"]],
                                        axis_name="data",
                                        **c.get("distkw", {})))
            m.compile([tx], is_train=True, use_graph=True)
            m.set_states(c["states"])
            gate = _np(m.moe.w_gate) if c["kind"] == "net" else None
            args = (c["dist_option"],) if "dist_option" in c else ()
            losses = [m.train_one_batch(tx, ty, *args)[1].item()
                      for _ in range(steps[c["kind"]])]
        except Exception as e:  # noqa: BLE001 - reported, the test checks
            if c.get("expect") != type(e).__name__:
                raise
            out[name] = {"error": str(e)}
            continue
        got = dict(losses=np.asarray(losses), after={
            k: _np(v) for k, v in m.get_states().items()})
        if gate is not None:
            got["gate_moved"] = not np.allclose(_np(m.moe.w_gate), gate)
            got["w1_shape"] = tuple(m.moe.w1.shape)
        out[name] = got
    return out


# -- the tensor-parallel serving decode --------------------------------------------


def staggered_workload(engine, prompts, max_new, temperature=0.0, seed=0):
    """tests/test_serving_tp.py's staggered admit/evict workload over the
    prompts a-d (b cancelled mid-flight so its freed blocks fragment
    and c, d reuse them): the surviving requests' tokens by id."""
    from singa_tpu_torch.serving import Request

    reqs = {k: Request(k, prompts[k], max_new[k], temperature=temperature,
                       seed=seed) for k in "abcd"}
    engine.admit(reqs["a"])
    engine.admit(reqs["b"])
    for _ in range(3):
        engine.step()
    engine.cancel("b")
    engine.admit(reqs["c"])
    engine.admit(reqs["d"])
    while engine.n_active:
        engine.step()
    return {k: np.asarray(reqs[k].tokens, np.int32) for k in "acd"}


def shared_workload(engine, shared, tails, max_new, temperature=0.0):
    """tests/test_serving_prefix_tp.py's workload: one cold registering
    admission and two warm sharers of a 32-token prefix (the third
    admitted mid-decode): each request's tokens and cached tokens."""
    from singa_tpu_torch.serving import Request

    reqs = [Request(f"r{i}", np.concatenate([shared, t]), max_new,
                    temperature=temperature, seed=3)
            for i, t in enumerate(tails)]
    engine.admit(reqs[0])
    engine.admit(reqs[1])
    for _ in range(2):
        engine.step()
    engine.admit(reqs[2])
    while engine.n_active:
        engine.step()
    return [(np.asarray(r.tokens, np.int32), r.cached_tokens) for r in reqs]


def _rank_serving_tp(rank, world, kw, params, window, prompts, max_new,
                     shared, tails, odd_kw):
    """The port's tensor-parallel decode over the group's (2,) "model"
    mesh, on a GPT carrying `params`: the staggered workload greedy fp32,
    int8 and sampled, the prefix-cache workload greedy and sampled, one
    step's collectives, the per-rank block bytes, the refusals; a (1,)
    mesh of this rank alone against the single-device engine (peek
    logits); rank 0's solo `generate` of every stream."""
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import GPT
    from singa_tpu_torch.parallel import mesh as mesh_module
    from singa_tpu_torch.parallel import tp
    from singa_tpu_torch.serving import (Request, ServingEngine,
                                         SpeculativeEngine)

    def gpt(k, p=None):
        m = GPT(**k, device="cpu")
        if p is not None:
            load_singa_tpu_params(m, p)
        m.eval()
        return m

    m = gpt(kw, params)
    mesh = mesh_module.get_mesh((world,), ("model",))
    alone = None
    for r in range(world):
        try:
            got = mesh_module.get_mesh((1,), ("model",), devices=[r])
        except ValueError:
            continue
        alone = got
    ekw = dict(slots=3, block_size=16, window=window, mesh=mesh,
               tp_axis="model")
    out = {}
    if True:
        for name, extra, temp in (("fp32", {}, 0.0),
                                  ("int8", {"kv_dtype": "int8"}, 0.0),
                                  ("sampled", {}, 0.8)):
            eng = ServingEngine(m, **ekw, **extra)
            out[name] = staggered_workload(eng, prompts, max_new, temp,
                                           seed=5)
            out[f"{name}_compiles"] = eng.decode_compiles
        eng = ServingEngine(m, **ekw)
        eng.admit(Request("s", prompts["a"], 4))
        before = dict(tp.COUNTS)
        eng.step()
        out["step_counts"] = {f"{k[0]}:{k[1]}": v - before.get(k, 0)
                              for k, v in tp.COUNTS.items()
                              if v != before.get(k, 0)}
        out["bytes_per_block"] = eng.allocator.bytes_per_block
        out["pool_heads"] = tuple(eng._kdata.shape)
        for temp in (0.0, 0.9):
            eng = ServingEngine(m, **ekw, prefix_cache=True)
            out[f"prefix_{temp}"] = shared_workload(eng, shared, tails, 8,
                                                    temp)
            out[f"prefix_{temp}_stats"] = (eng.prefix_stats["hits"],
                                           eng.decode_compiles,
                                           eng.prefix_prefill_compiles)
        # a mesh of this rank alone: the single-device engine's logits
        pair = (ServingEngine(m, slots=2, block_size=16, window=window),
                ServingEngine(m, slots=2, block_size=16, window=window,
                              mesh=alone, tp_axis="model"))
        for e in pair:
            e.admit(Request("a", prompts["d"].copy(), 8))
            e.step()
            e.step()
        out["tp1_logits"] = [e.peek_logits() for e in pair]
        refusals = {}
        for key, fn in (
                ("needs_tp_axis", lambda: ServingEngine(
                    m, window=window, mesh=mesh)),
                ("not_on_mesh", lambda: ServingEngine(
                    m, window=window, mesh=mesh, tp_axis="nope")),
                ("heads", lambda: ServingEngine(
                    gpt(odd_kw), window=window, mesh=mesh,
                    tp_axis="model")),
                ("prefill_mesh", lambda: ServingEngine(
                    m, window=window, mesh=mesh, tp_axis="model",
                    prefill_mesh=mesh)),
                ("prefill_axis", lambda: ServingEngine(
                    m, window=window, mesh=mesh, tp_axis="model",
                    prefill_batch=2, prefill_mesh=mesh,
                    prefill_axis="data")),
                ("speculative", lambda: SpeculativeEngine(
                    m, gpt(odd_kw), window=window, mesh=mesh,
                    tp_axis="model"))):
            try:
                fn()
                refusals[key] = "no error"
            except (ValueError, NotImplementedError) as e:
                refusals[key] = f"{type(e).__name__}: {e}"
        out["refusals"] = refusals
        if rank == 0:
            def solo(p, n, temp=0.0, seed=5):
                return m.generate(p, n, window=window, temperature=temp,
                                  seed=seed)[0, len(p):]

            out["solo"] = {k: solo(prompts[k], max_new[k]) for k in "acd"}
            out["solo_sampled"] = {k: solo(prompts[k], max_new[k], 0.8)
                                   for k in "acd"}
            out["solo_prefix"] = {
                temp: [solo(np.concatenate([shared, t]), 8, temp, 3)
                       for t in tails] for temp in (0.0, 0.9)}
    return out


def serving_params(kw, seed=0):
    """Seeded random weights for a serving test's GPT, as the numpy dict
    both packages load (the reference by `set_params`, the port by
    `load_singa_tpu_params`): `randomize_params`'s scales, drawn in
    name order over the port GPT's parameters, whose names and shapes are
    the reference's. Made without the reference, so its process and the
    ranks can start together (`run_both`)."""
    from singa_tpu_torch.models.gpt import GPT

    rng = np.random.default_rng(seed)
    params = {}
    for name, p in sorted(GPT(**kw, device="cpu").named_parameters()):
        shape = tuple(p.shape)
        if name.endswith(("scale", "ln1_s", "ln2_s")):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif len(shape) >= 2 and not name.endswith(".table"):
            a = rng.standard_normal(shape) / np.sqrt(shape[-2])
        else:
            a = 0.1 * rng.standard_normal(shape)
        params[name] = a.astype(np.float32)
    return params


def serving_draft(target, seed=1):
    """The untrained draft of the serving tests: the port's `gpt_draft`
    at d_model 32, 1 block, 4 heads (the reference test's), with seeded
    numpy weights, the same on every rank."""
    from singa_tpu_torch.examples.serve_gpt import seeded_weights
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import gpt_draft

    d = gpt_draft(target, d_model=32, num_layers=1, num_heads=4)
    load_singa_tpu_params(d, seeded_weights(d, seed))
    d.eval()
    return d


def _serving_gpt(kw, params):
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import GPT

    m = GPT(**kw, device="cpu")
    load_singa_tpu_params(m, params)
    m.eval()
    return m


def _rank_serving_disagg(rank, world, kw, params, window, prompts, max_new):
    """The disaggregated prefill over 4 ranks: decode on a (2,) "model"
    mesh of ranks 0-1, prefill on a (2,) "data" mesh of ranks 2-3, each
    mesh's layout known to the ranks outside it. Every case builds its
    engine on the ranks it names; a decode rank serves the requests and
    `close()`s, a prefill-only rank runs `serve_prefill()`. Requests a, b
    are admitted as one 2-wide prefill; in the single-device case c, d
    join through `begin_prefill_async` after three decode steps."""
    from singa_tpu_torch.parallel import mesh as mesh_module
    from singa_tpu_torch.serving import (Frontend, Request, ServingEngine,
                                         SpeculativeEngine)

    m = _serving_gpt(kw, params)
    draft = serving_draft(m)
    dmesh = mesh_module.get_mesh((2,), ("model",), devices=[0, 1],
                                 allow_outside=True)
    pmesh = mesh_module.get_mesh((2,), ("data",), devices=[2, 3],
                                 allow_outside=True)
    tp = dict(mesh=dmesh, tp_axis="model")
    ekw = dict(slots=2, block_size=16, window=window, prefill_batch=2,
               prefill_mesh=pmesh)
    out = {"layouts": (dmesh.member, pmesh.member, dmesh.ranks,
                       pmesh.ranks)}

    def reqs(keys, temp=0.0):
        return [Request(k, prompts[k], max_new[k], temperature=temp,
                        seed=5) for k in keys]

    def serve(name, make, ranks, drive):
        if rank not in ranks:
            return
        eng = make()
        if eng._plan.decodes:
            got = drive(eng)
            eng.close()
            out[name] = {r.rid: np.asarray(r.tokens, np.int32)
                         for r in got}
            out[f"{name}_compiles"] = (
                eng.decode_compiles, getattr(eng, "verify_compiles", 0))
            out[f"{name}_accept"] = getattr(eng, "acceptance_rate", None)
        else:
            out[f"{name}_served"] = eng.serve_prefill()

    def together(eng):
        got = reqs("ab")
        eng.admit_many(got)
        while eng.n_active:
            eng.step()
        return got

    def staggered(eng):
        got = reqs("abcd")
        eng.admit_many(got[:2])
        for _ in range(3):
            eng.step()
        # a reserved slot's page row stays trash until finish_prefill
        ticket, err = eng.begin_prefill_async(got[2:])
        slots = list(eng._pending)
        out["async_rows"] = (err, [int(eng.page_table[s].sum())
                                   for s in slots])
        eng.finish_prefill(ticket)
        out["async_rows_after"] = [int(eng.page_table[s].sum())
                                   for s in slots]
        while eng.n_active:
            eng.step()
        return got

    def frontend(overlap):
        def drive(eng):
            fe = Frontend(eng, overlap_prefill=overlap)
            hs = [fe.submit(prompts[k], max_new[k]) for k in "abcd"]
            fe.run()
            return [Request(k, prompts[k], max_new[k], tokens=list(
                h.tokens)) for k, h in zip("abcd", hs)]
        return drive

    all4, dec0 = (0, 1, 2, 3), (0, 2, 3)
    serve("tp", lambda: ServingEngine(m, **tp, **ekw), all4, together)
    serve("single", lambda: ServingEngine(m, **dict(ekw, slots=4)), dec0,
          staggered)
    serve("spec_tiny", lambda: SpeculativeEngine(
        m, draft, spec_k=3, **tp, **ekw), all4, together)
    serve("spec_self", lambda: SpeculativeEngine(
        m, m, spec_k=3, **tp, **ekw), all4, together)
    serve("fifo", lambda: ServingEngine(m, **tp, **ekw), all4,
          frontend(False))
    serve("overlap", lambda: ServingEngine(m, **tp, **ekw), all4,
          frontend(True))
    refusals = {}
    for key, fn in (
            ("prefill_batch", lambda: ServingEngine(
                m, **tp, **dict(ekw, prefill_batch=3))),
            ("no_role", lambda: ServingEngine(m, **ekw))):
        try:
            fn()
            refusals[key] = "no error"
        except ValueError as e:
            refusals[key] = str(e)
    out["refusals"] = refusals
    return out


def _rank_serving_tp_spec(rank, world, kw, params, window, prompts,
                          max_new, shared, tails, odd_kw):
    """The sharded speculative round over the group's (2,) "model" mesh:
    the staggered workload greedy (an untrained draft), int8 and sampled
    (against the single-device speculative engine on the same seeds),
    the model as its own draft, the prefix cache's warm streams, one
    round's collectives, the draft-heads refusal."""
    from singa_tpu_torch.parallel import mesh as mesh_module
    from singa_tpu_torch.parallel import tp
    from singa_tpu_torch.serving import Request, SpeculativeEngine

    m = _serving_gpt(kw, params)
    draft = serving_draft(m)
    mesh = mesh_module.get_mesh((world,), ("model",))
    ekw = dict(spec_k=3, slots=3, block_size=16, window=window)
    tkw = dict(ekw, mesh=mesh, tp_axis="model")
    out = {}
    for name, dm, extra, temp in (
            ("greedy", draft, {}, 0.0), ("int8", draft,
                                         {"kv_dtype": "int8"}, 0.0),
            ("sampled", draft, {}, 0.8)):
        eng = SpeculativeEngine(m, dm, **tkw, **extra)
        out[name] = staggered_workload(eng, prompts, max_new, temp, seed=5)
        out[f"{name}_compiles"] = (eng.decode_compiles,
                                   eng.verify_compiles)
    if rank == 0:
        solo = SpeculativeEngine(m, draft, **ekw)
        out["solo_sampled"] = staggered_workload(solo, prompts, max_new,
                                                 0.8, seed=5)
    eng = SpeculativeEngine(m, m, **tkw)
    r = Request("s", prompts["d"], max_new["d"])
    eng.admit(r)
    while eng.n_active:
        eng.step()
    out["self"] = (np.asarray(r.tokens, np.int32), eng.acceptance_rate)
    eng = SpeculativeEngine(m, draft, **tkw)
    eng.admit(Request("s", prompts["a"], 12))
    before = dict(tp.COUNTS)
    eng.step()
    out["round_counts"] = {f"{k[0]}:{k[1]}": v - before.get(k, 0)
                           for k, v in tp.COUNTS.items()
                           if v != before.get(k, 0)}
    out["draft_pool"] = tuple(eng._dkdata.shape)
    eng = SpeculativeEngine(m, draft, **tkw, prefix_cache=True)
    out["prefix"] = shared_workload(eng, shared, tails, 8)
    out["prefix_stats"] = (eng.prefix_stats["hits"], eng.decode_compiles,
                           eng.verify_compiles)
    from singa_tpu_torch.models.gpt import GPT

    try:
        SpeculativeEngine(m, GPT(**odd_kw, device="cpu"), **tkw)
        out["refusal"] = "no error"
    except ValueError as e:
        out["refusal"] = str(e)
    return out


# -- GPipe, the raw strategy steps and the strategies runner -------------------


#: the meshes of `_rank_pipeline`, built on every rank in this order
PP_MESHES = {"dp_pp": ((2, 2), ("data", "pipe")),
             "pp": ((1, 4), ("data", "pipe"))}


def port_pp_model(kind, pipe_axis, n_blocks, n_micro):
    """The port's model of a tests/test_pp_model.py case: "mlp" (the
    PipeMLP: Linear(16), a PipelineStack, Linear(4)) or "gpt" (vocab 64,
    d 16, 4 heads, max_len 16, dropout 0, `pp_axis`)."""
    from singa_tpu_torch.examples.parallel_strategies import build_pipe_mlp
    from singa_tpu_torch.models.gpt import GPT

    if kind == "mlp":
        return build_pipe_mlp(n_blocks, n_micro=n_micro, pipe_axis=pipe_axis,
                              device="cpu")
    return GPT(vocab_size=64, d_model=16, num_layers=n_blocks, num_heads=4,
               max_len=16, dropout=0.0, pp_axis=pipe_axis, pp_micro=n_micro,
               device="cpu")


def _rank_pipeline(rank, world, arrays, cases):
    """`pipeline_apply` and the pipelined models over the meshes of
    `PP_MESHES`. `arrays`: the pipe-4 values case (x, w) at n_micro 2 and
    4, whose psum'd output this rank gives, and the pipe-2 gradient case
    (gx, gw) on the (2, 2) mesh, whose stage gradient it gives. `cases`
    (name -> dict(kind, mesh, n_blocks, n_micro, states, x, y, steps,
    sgd, expect)): each builds `port_pp_model`, trains it by
    DistOpt(SGD(**sgd)) over the data axis from the full states, and
    gives the losses, the gathered states after, this rank's stacked
    weight and slot shapes and `step_memory_analysis`'s parameter bytes;
    a case with `expect` gives the message it raised."""
    from singa_tpu_torch import graph, opt
    from singa_tpu_torch.communicator import psum_over
    from singa_tpu_torch.parallel import mesh as mesh_module
    from singa_tpu_torch.parallel.pipeline import pipeline_apply
    from singa_tpu_torch.parallel.tp import psum_identity_bwd

    meshes = {k: mesh_module.get_mesh(*v) for k, v in PP_MESHES.items()}

    def stage(p, h):
        return torch.tanh(h @ p[0])

    out = {"values": {}}
    pp, dp_pp = meshes["pp"], meshes["dp_pp"]
    me = pp.axis_index("pipe")
    x = torch.from_numpy(arrays["x"])
    w = torch.from_numpy(arrays["w"][me:me + 1])
    with mesh_module.axes_context("data", "pipe", mesh=pp):
        for n_micro in (2, 4):
            y, valid = pipeline_apply(stage, w, x, "pipe", n_micro)
            out["values"][n_micro] = _np(psum_over(y * valid, "pipe"))
    me = dp_pp.axis_index("pipe")
    gw = torch.from_numpy(arrays["gw"][me:me + 1]).requires_grad_(True)
    with mesh_module.axes_context("data", "pipe", mesh=dp_pp):
        y, valid = pipeline_apply(stage, gw, torch.from_numpy(arrays["gx"]),
                                  "pipe", 2)
        (psum_identity_bwd("pipe")(y * valid) ** 2).sum().backward()
    out["grad"] = (me, _np(gw.grad))
    for name, c in cases.items():
        m = port_pp_model(c["kind"], "pipe", c["n_blocks"], c["n_micro"])
        tx = torch.from_numpy(c["x"])
        tx = tx.long() if c["kind"] == "gpt" else tx
        ty = torch.from_numpy(c["y"]).long()
        try:
            m.set_optimizer(opt.DistOpt(opt.SGD(**c["sgd"]),
                                        mesh=meshes[c["mesh"]],
                                        axis_name="data"))
            m.compile([tx], is_train=True, use_graph=True)
            m.set_states(c["states"])
            losses = [m.train_one_batch(tx, ty)[1].item()
                      for _ in range(c["steps"])]
        except Exception as e:  # noqa: BLE001 - reported, the test checks
            if c.get("expect") != type(e).__name__:
                raise
            out[name] = {"error": str(e)}
            continue
        stack = m.stack if c["kind"] == "mlp" else m.decoder
        first = stack.W if c["kind"] == "mlp" else stack.w_qkv
        slots = {k: tuple(v.shape) for k, v in
                 m.optimizer.dump_states().items() if k.count("//")}
        out[name] = dict(
            losses=np.asarray(losses),
            after={k: _np(v) for k, v in m.get_states().items()},
            local_shape=tuple(first.shape),
            pspecs={n: p.pspec for n, p in stack.named_parameters()},
            slots=slots,
            parameter_bytes=graph.step_memory_analysis(
                m, tx, ty)["parameter_bytes"],
            local_bytes=sum(p.numel() * 4 for p in m.parameters()))
    return out


def _rank_raw_steps(rank, world, bert_params):
    """Each step of `parallel.raw_steps` at this world: this rank's
    operands and its step's new operands (numpy) and loss; the BERT
    steps start from the reference's parameters (`bert_params`: name ->
    {parameter: array})."""
    from singa_tpu_torch.parallel.raw_steps import RAW_STEP_BUILDERS

    def host(tree):
        if isinstance(tree, dict):
            return {k: _np(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return tuple(host(v) for v in tree)
        return _np(tree)

    out = {}
    for name, build in RAW_STEP_BUILDERS.items():
        step, ops, _ = build(world, list(range(world)))
        if name in bert_params:
            pv = ops[0]
            if set(pv) != set(bert_params[name]):
                raise KeyError(f"{name}: parameter names differ: "
                               f"{sorted(set(pv) ^ set(bert_params[name]))}")
            ops = ({k: torch.from_numpy(v) for k, v in
                    bert_params[name].items()}, ops[1])
        new, loss = step(*ops)
        out[name] = dict(ops=host(ops), new=host(new), loss=float(loss))
    return out


def _rank_strategies(rank, world):
    """The strategies runner on the group's ranks: every line it printed
    (rank 0's stdout is what a user reads; every rank prints the
    same)."""
    import contextlib
    import io

    from singa_tpu_torch.examples import parallel_strategies

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        parallel_strategies.run(list(range(world)))
    return buf.getvalue().splitlines()


# -- the sharded checkpoint ---------------------------------------------------


def ckpt_net(seed=0, optimizer="adam", sentinel=None, hidden=16):
    """A small port model for the checkpoint tests (a Linear 12 ->
    `hidden`, ReLU, a Linear -> 4, softmax cross-entropy) from seed
    `seed`, with Adam(0.01) or SGD(0.1, momentum 0.9) and an optional
    sentinel, compiled for graph mode on its batch: (model, optimizer,
    x, y)."""
    from singa_tpu_torch import autograd, layer, model, opt

    class Net(model.Model):
        def __init__(self):
            super().__init__()
            gen = torch.Generator().manual_seed(seed)
            self.fc1 = layer.Linear(hidden, in_features=12, device="cpu",
                                    generator=gen)
            self.act = layer.ReLU()
            self.fc2 = layer.Linear(4, in_features=hidden, device="cpu",
                                    generator=gen)

        def forward(self, x):
            return self.fc2(self.act(self.fc1(x)))

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = autograd.softmax_cross_entropy(out, y)
            self.optimizer(loss)
            return out, loss

    m = Net()
    o = opt.Adam(lr=0.01) if optimizer == "adam" else opt.SGD(
        lr=0.1, momentum=0.9)
    if sentinel is not None:
        o.set_sentinel(sentinel)
    m.set_optimizer(o)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((8, 12)).astype(np.float32))
    y = torch.from_numpy((np.arange(8) % 4).astype(np.int64))
    m.compile([x], is_train=True, use_graph=True)
    return m, o, x, y


def ckpt_state(m, o):
    """Every parameter, buffer and optimizer state, as numpy."""
    out = {f"param/{k}": _np(v) for k, v in m.get_states().items()}
    out.update({f"opt/{k}": _np(torch.as_tensor(v))
                for k, v in o.dump_states().items()})
    return out


def _ckpt_kill_child(directory, phase, async_=False):
    """A doomed process: save step 1 of `ckpt_net`, then die
    (`faults.kill_at_phase`, exit 42) at `phase` of the save of step 2:
    "snapshot", "shard_writes" and "manifest" in the model's own save
    (sync, or with `async_` on its background commit), "receipts" in a
    two-phase commit of two thread-hosted ranks over the same directory.
    Exits 0 only if the kill did not fire."""
    import threading

    from singa_tpu_torch import resilience
    from singa_tpu_torch.resilience import checkpoint as ckpt
    from singa_tpu_torch.resilience import faults

    m, o, x, y = ckpt_net()
    m.train_one_batch(x, y)
    resilience.save(directory, m, o, step=1)
    m.train_one_batch(x, y)
    ckpt._phase_hook = faults.kill_at_phase(phase)
    if phase != "receipts":
        got = resilience.save(directory, m, o, step=2, async_=async_)
        if async_:
            got.result(timeout=60)
        return
    step_dir, step_name = ckpt._probe_step_dir(directory, 2)
    snap = list(ckpt._snapshot_owned(m, o, None, 0))

    def rank(pidx):
        # rank 0 writes every shard; rank 1 only its receipt
        ckpt._save_two_phase(
            directory, step_dir, step_name,
            lambda: snap if pidx == 0 else [dict(leaf, owned=[])
                                            for leaf in snap],
            pidx=pidx, pcount=2, step=2, data_cursor=None,
            rng_state=[0], meta=None, timeout_s=30)

    threads = [threading.Thread(target=rank, args=(i,), daemon=True)
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)


def ckpt_tp_states(seed=0):
    """The TpMLP's (`port_tp_mlp`) full states from a seeded dense build,
    with its batch (8 x 12, labels 0..3)."""
    torch.manual_seed(seed)
    m = port_tp_mlp()
    m.compile([torch.zeros(8, 12)], is_train=False)
    states = {k: _np(v) for k, v in m.get_states().items()}
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((8, 12)).astype(np.float32)
    y = (np.arange(8) % 4).astype(np.int32)
    return states, x, y


#: the elastic tests' scanned GPT (ZeRO-3 over a data axis of 2)
CKPT_GPT = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=4,
                max_len=16, dropout=0.0)


def _ckpt_train(m, states, x, y, steps, mesh, lr=0.1, momentum=0.9):
    """`steps` graph-mode SGD steps of `m` from full `states` (DistOpt
    over `mesh` when given): the losses."""
    from singa_tpu_torch import opt

    tx, ty = torch.from_numpy(x), torch.from_numpy(y).long()
    sgd = opt.SGD(lr=lr, momentum=momentum)
    m.set_optimizer(sgd if mesh is None else opt.DistOpt(
        sgd, mesh=mesh, axis_name="data"))
    m.compile([tx], is_train=True, use_graph=True)
    m.set_states(states)
    return [m.train_one_batch(tx, ty)[1].item() for _ in range(steps)]


def _rank_ckpt_elastic(rank, world, tp, gpt, steps, dirs):
    """The sharded checkpoint over 2 gloo ranks:

    - the TpMLP on a (data 1, model 2) mesh and the scanned GPT with
      `zero3_axis="data"` on a data axis of 2, `steps` steps each
      (DistOpt(SGD(0.1, momentum 0.9))), then a save (each rank writes
      the shards it owns; the two-phase commit) under dirs["tp"] /
      dirs["z3"]: the losses, the gathered states and optimizer states
      after, each rank's block shapes;
    - a fresh TpMLP on the same mesh restored from dirs["w1"], a
      checkpoint of one process: its gathered states and its blocks;
    - a save only rank 0 joins (rank 1 writes no receipt) under
      dirs["torn"], which must raise `TornSaveError` naming rank 1 on
      rank 0 after its deadline."""
    import torch.distributed as dist

    from singa_tpu_torch import resilience
    from singa_tpu_torch.models.gpt import GPT
    from singa_tpu_torch.parallel import mesh as mesh_module

    out = {}
    tp_mesh = mesh_module.get_mesh((1, 2), ("data", "model"))
    z3_mesh = mesh_module.get_mesh((2,), ("data",))
    cases = (("tp", lambda: port_tp_mlp(tp_axis="model"), tp, tp_mesh),
             ("z3", lambda: GPT(**CKPT_GPT, scan_blocks=True,
                                zero3_axis="data", device="cpu"), gpt,
              z3_mesh))
    for name, make, d, mesh in cases:
        m = make()
        losses = _ckpt_train(m, d["states"], d["x"], d["y"], steps, mesh)
        step_dir = resilience.save(dirs[name], m, m.optimizer, step=steps,
                                   data_cursor=steps)
        out[name] = dict(
            losses=losses, step_dir=step_dir,
            after={k: _np(v) for k, v in m.get_states().items()},
            opt={k: _np(v) for k, v in m.optimizer.dump_states().items()},
            blocks={n: tuple(p.shape) for n, p in m.named_parameters()
                    if getattr(p, "placed", None)})
    m = port_tp_mlp(tp_axis="model")
    _ckpt_train(m, tp["states"], tp["x"], tp["y"], 0, tp_mesh)
    meta = resilience.restore(dirs["w1"], m, m.optimizer)
    out["from_w1"] = dict(
        step=meta["step"],
        after={k: _np(v) for k, v in m.get_states().items()},
        blocks={n: (tuple(p.shape), _np(p)) for n, p in m.named_parameters()
                if getattr(p, "placed", None)},
        opt={k: _np(v) for k, v in m.optimizer.dump_states().items()})
    if rank == 0:
        try:
            resilience.save(dirs["torn"], m, m.optimizer, step=9,
                            receipt_timeout_s=3)
            out["torn"] = None
        except resilience.TornSaveError as e:
            out["torn"] = str(e)
    dist.barrier()
    return out


# -- F12: every rank's dropout stream across a resume --------------------------

#: the resume test's unrolled GPT (tests/test_torch_resume.py), dropout 0.1
RNG_RESUME_GPT = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=4,
                      max_len=8, scan_blocks=False, dropout=0.1)


def rng_resume_batches(n, b=4, t=8, vocab=64):
    """n distinct global batches (tests/test_torch_resume.py's)."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        out.append((rng.integers(0, vocab, (b, t)),
                    rng.integers(0, vocab, (b, t))))
    return out


def _rng_resume_model():
    """The GPT under DistOpt(AdamW) over the group, built from seed 18
    on every rank (what a trainer does at start-up)."""
    from singa_tpu_torch import autograd, distributed, opt, tensor
    from singa_tpu_torch.models.gpt import GPT

    autograd.reset_rank_draws()
    tensor.set_seed(18)
    m = GPT(**RNG_RESUME_GPT, device="cpu",
            generator=torch.Generator().manual_seed(18))
    m.set_optimizer(opt.DistOpt(opt.AdamW(lr=3e-3),
                                mesh=distributed.global_mesh()))
    x = torch.from_numpy(rng_resume_batches(1)[0][0])
    m.compile([x], is_train=True, use_graph=True)
    return m


def _rng_resume_state(m, losses):
    out = {"losses": np.asarray(losses)}
    out.update({f"param:{k}": _np(v) for k, v in m.get_params().items()})
    out.update({f"opt:{k}": torch.as_tensor(v).numpy().copy()
                for k, v in m.optimizer.dump_states().items()})
    return out


def _rank_rng_resume(rank, world, phase, directory, data):
    """F12's oracle over the group. phase "ab": run A, 8 unbroken steps,
    then run B, 4 steps and a save (every rank joins the two-phase
    commit); phase "c", in fresh processes: a new incarnation's own
    generator state, `restore`, then the last 4 steps. Each run's
    losses, parameters and optimizer slots."""
    from singa_tpu_torch import resilience

    def step(m, i):
        x, y = data[i]
        return m(torch.from_numpy(x), torch.from_numpy(y))[1].item()

    if phase == "ab":
        a = _rng_resume_model()
        losses = [step(a, i) for i in range(len(data))]
        out = {"a": _rng_resume_state(a, losses)}
        b = _rng_resume_model()
        losses = [step(b, i) for i in range(4)]
        resilience.save(directory, b, b.optimizer, step=4, data_cursor=4)
        out["b"] = _rng_resume_state(b, losses)
        return out
    c = _rng_resume_model()
    torch.manual_seed(12345 + rank)  # a new incarnation's own state
    meta = resilience.restore(directory, c, c.optimizer)
    start = int(meta["data_cursor"])
    losses = [step(c, i) for i in range(start, len(data))]
    return {"c": _rng_resume_state(c, losses), "start": start}


# -- the supervisor's mesh hook over a group ----------------------------------


def _rank_supervisor_mesh(rank, world, directory, steps):
    """`Supervisor(mesh_fn=)` over the group (every rank runs the same
    supervised loop, the checkpoint's two-phase commit under it):

    - "default": `default_mesh_fn(world)` with a crash at step 2, against
      the same steps unsupervised: (dp world, tp 1, sp 1) on every build,
      no reshape, the losses and parameters bitwise;
    - "fold": a probe that folds dp into tp at the rebuild after a crash
      at step 2: one reshape, the run ends on (1, world, 1), the elastic
      restore re-placing the data-parallel checkpoint;
    - "shrink": a probe that picks fewer ranks than the group, which the
      port refuses (ROADMAP queue 3): the message."""
    from singa_tpu_torch import opt
    from singa_tpu_torch.resilience import Supervisor, counters, faults
    from singa_tpu_torch.resilience import supervisor as sup_module

    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (8, 12)).astype(np.float32))
    y = torch.from_numpy((np.arange(8) % 4).astype(np.int64))

    def build(mesh=None):
        m = ckpt_net(seed=13, optimizer="sgd")[0]
        if mesh is not None:
            m.set_optimizer(opt.DistOpt(opt.SGD(lr=0.1, momentum=0.9),
                                        mesh=mesh, axis_name="data"))
            m.compile([x], is_train=True, use_graph=True)
        return m

    def run(name, mesh_fn, hook):
        counters.reset()
        sup = Supervisor(build, f"{directory}/{name}", mesh_fn=mesh_fn,
                         fault_hook=hook, restart_backoff_s=0.0,
                         sleep=lambda s: None)
        res = sup.run([(x, y)] * steps)
        m = res.pop("model")
        res["params"] = {k: _np(v) for k, v in m.get_params().items()}
        res["mesh"] = dict(m.optimizer.comm.mesh.shape)
        res["fault_counters"] = dict(m.fault_counters or {})
        return res

    out = {"probe": sup_module.probe_ranks()}
    from singa_tpu_torch.parallel import mesh as mesh_module
    plain = build(mesh_module.get_mesh_3d(world, 1, 1))
    out["plain"] = dict(
        losses=[plain.train_one_batch(x, y)[1].item()
                for _ in range(steps)],
        params={k: _np(v) for k, v in plain.get_params().items()})
    out["default"] = run("default", sup_module.default_mesh_fn(world),
                         faults.crash_at(2))
    probes = []

    def fold(devices):
        probes.append(len(devices))
        return (len(devices), 1, 1) if len(probes) == 1 else (
            1, len(devices), 1)

    out["fold"] = run("fold", fold, faults.crash_at(2))
    out["fold"]["probes"] = probes
    try:
        run("shrink", lambda devices: (1, 1, 1), None)
        out["shrink"] = None
    except NotImplementedError as e:
        out["shrink"] = str(e)
    return out


def _rank_analysis(rank, world):
    """Shardlint over the port's ranks (tests/helper_torch_analysis.py)."""
    import helper_torch_analysis

    return helper_torch_analysis.rank_analysis(rank, world)


def _rank_hlo_native_dp(rank, world, params, dropped, zero1):
    """The native DP module on this rank (tests/test_torch_hlo_native_dp.py):
    `parallel_strategies.native_dp_step` from `params` run by
    `hlo_bridge.run_replicated` on both wires (each step's per-rank
    losses); one step under a `CollectiveRecorder` (its census); the
    module with one all_reduce `dropped` from its text (the error
    `run_replicated` raises); the ZeRO-1 wire module `zero1["text"]` on
    this rank's (bf16 gradient, fp32 shard) operands (its outputs)."""
    import dataclasses

    from singa_tpu_torch.analysis import trace
    from singa_tpu_torch.examples.parallel_strategies import native_dp_step
    from singa_tpu_torch.native import hlo_bridge
    from singa_tpu_torch.native.hlo_runtime import HloRuntime

    out = {}
    for wire in ("fp32", "bf16"):
        step, batches = native_dp_step(world, wire, params=params)
        out[wire] = hlo_bridge.run_replicated(step, batches, device="cpu")
    step, batches = native_dp_step(world, "fp32", params=params)
    with trace.CollectiveRecorder() as rec:
        hlo_bridge.run_replicated(step, batches[:1], device="cpu")
    out["census"] = trace.census(rec.records)
    out["ops"] = sorted({(r.op, r.dtype, r.ranks) for r in rec.records})
    try:
        hlo_bridge.run_replicated(dataclasses.replace(step, text=dropped),
                                  batches, device="cpu")
        out["parted"] = None
    except AssertionError as e:
        out["parted"] = str(e)
    rt = HloRuntime("cpu")
    exe = rt.executable(rt.compile_mlir(zero1["text"]))
    g = torch.from_numpy(zero1["g"][rank]).to(torch.bfloat16)
    p = torch.from_numpy(zero1["p"][rank])
    out["zero1"] = [_np(o.float()) for o in exe.run([g, p])]
    return out
