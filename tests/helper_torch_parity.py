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


def run_ranks(scenario, world, tmp_path, timeout=100, **payload):
    """[result of rank r for r in range(world)] of `scenario(rank, world,
    **payload)`, a function of this module run in `world` spawned
    processes over gloo; a rank's exception fails the call with its
    traceback."""
    import multiprocessing as mp
    import pickle

    ctx = mp.get_context("spawn")
    init = f"file://{tmp_path}/rendezvous"
    outs = [tmp_path / f"rank{r}.pkl" for r in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(scenario.__name__, r, world, init, payload,
                               str(outs[r])))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results = []
    for r, (p, f) in enumerate(zip(procs, outs)):
        got = pickle.loads(f.read_bytes()) if f.exists() else None
        if p.exitcode != 0 or got is None or "traceback" in got:
            raise AssertionError(
                f"rank {r} of {world} failed (exit {p.exitcode}):\n"
                f"{(got or {}).get('traceback', '')}")
        results.append(got)
    return results


def run_reference(module, name, tmp_path, timeout=300, **kwargs):
    """`name(**kwargs)`, a function of the test module `module` that
    computes the reference's side of a parity test, run in a spawned
    process of its own: a fresh singa_tpu, so no process-wide switch an
    earlier test left set in this pytest worker (the autocast policy,
    `autograd.training`, a mesh axis pushed and not popped, the op
    cache) reaches the reference's numbers. It inherits the worker's
    environment (conftest's 8-device CPU platform). Returns what the
    function returned (picklable: numpy arrays and numbers); its
    exception fails the call with its traceback."""
    import multiprocessing as mp
    import pickle

    out = tmp_path / f"{name}.pkl"
    p = mp.get_context("spawn").Process(
        target=_reference_main, args=(module, name, kwargs, str(out)))
    p.start()
    p.join(timeout)
    if p.is_alive():
        p.kill()
        p.join()
    got = pickle.loads(out.read_bytes()) if out.exists() else None
    if p.exitcode != 0 or got is None or "traceback" in got:
        raise AssertionError(
            f"the reference's {module}.{name} failed (exit {p.exitcode}):\n"
            f"{(got or {}).get('traceback', '')}")
    return got["result"]


def _reference_main(module, name, kwargs, out):
    import pickle
    import traceback

    try:
        import jax

        jax.config.update("jax_platforms", "cpu")
        got = {"result": getattr(importlib.import_module(module), name)(
            **kwargs)}
    except BaseException:  # reported to the parent, which fails the test
        got = {"traceback": traceback.format_exc()}
    with open(out, "wb") as f:
        pickle.dump(got, f)


def _rank_main(name, rank, world, init, payload, out):
    import pickle
    import traceback

    from singa_tpu_torch import distributed

    torch.set_num_threads(1)
    try:
        distributed.init(init, num_processes=world,
                         process_id=rank, device="cpu")
        got = globals()[name](rank, world, **payload)
    except BaseException:  # reported to the parent, which fails the test
        got = {"traceback": traceback.format_exc()}
    finally:
        distributed.shutdown()
    with open(out, "wb") as f:
        pickle.dump(got, f)


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
