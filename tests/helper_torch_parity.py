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


def set_ref_states(ref_model, states):
    ref_model.set_params({k: v for k, v in states.items()
                          if k in ref_model.get_params()})
    for k, buf in ref_model.get_buffers().items():
        buf.copy_from(states[k])


def ref_states(ref_model):
    return {k: np.asarray(v.data) for k, v in ref_model.get_states().items()}


def check_cnn_training(ref_model, states, make_port, x, y, lay, lr, tol,
                       tol_steps, steps=3, momentum=0.9, wd=5e-4):
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
    step's rounding)."""
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
        close(v, (p0 - p1) / lr - wd * p0, f"gradient of {k}")

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
