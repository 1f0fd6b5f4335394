"""Layers (counterpart of singa_tpu/layer.py), as `nn.Module`s.

Every layer derives from `Layer`, which adds the reference's state API
to `nn.Module` (`get_params`, `get_buffers`, `get_states`, `set_params`,
`set_states`, keyed by dotted name; reference `layer.py:92-193`).

The constructors take the reference's positional arguments: output
widths only (`Linear(10)`, `Conv2d(32, 3, 1)`, `LSTM(64, 2)`,
`BatchNorm2d()`). The input width is keyword-only and optional
(`in_features=`, `in_channels=`, `num_features=`, `dim=`, `d_model=`,
`input_size=`): given, the parameters are made at once; absent, they are
`UninitializedParameter`s (PyTorch's lazy-module idiom) until the first
call, which infers the width from its input as the reference's
`Layer.initialize` does. A layer made of sub-layers whose widths follow
its input (`SeparableConv2d`, the blocks of MobileNet and Xception)
makes those sub-layers at the same point, on its device and from its
generator: at once when the width is given, else at the first call,
which is where the reference's `initialize(x)` hook makes them.
`Model.compile`'s forward materialises them, before `set_optimizer`'s
`prepare` names the slots and before any capture.

Setting a layer attribute to a tensor, a module or a list/tuple bumps
the process-wide `mutation_stamp()` (reference `layer.py:92-107`), which
keys `graph.GraphStep`'s captured steps: a step after `layer.W =
nn.Parameter(...)` trains the new tensor, with fresh optimizer slots.

Parameters are made on `device=` from a `torch.Generator`, with
the reference's init distributions (not its random bits). Parameter
names and layouts are the reference's, so `model.load_singa_tpu_params`
maps them one to one: `Linear.W` is (in, out), and
`ScanTransformerStack` keeps its per-block weights stacked on a leading
(L, ...) dim under the names of `STACKED`.

Numerics follow the reference exactly: layer-norm statistics in fp32 with
the population variance (`jnp.var`), cast back to the input dtype; the
tanh approximation of GELU (`jax.nn.gelu(approximate=True)`); the bias
joined at the product's output dtype; matrix products under the autocast
policy of `autograd`.

The CNN layers (`Conv2d` with OIHW `W` and "he" init, `padding` a
number or "same"/"valid"; `SeparableConv2d`, a depthwise `Conv2d` named
`depthwise` into a 1x1 one named `pointwise`; `BatchNorm2d` with
`scale`, `offset` and the buffers `running_mean`, `running_var`; the
pools, `ReLU`, `LeakyReLU`, `Sigmoid`, `SoftMax`, `Flatten`, `Cat`,
`Add`, `Sequential`) run in the current image layout (`layout.py`).
`Sequential` keeps its layers in an `nn.ModuleList` named `layers`, so
dotted names are the reference's (`layer1.layers.0.conv1.layers.0.W`).

The recurrent layers (`RNN`, `LSTM`, `GRU`, `CudnnRNN`) run the
`autograd` recurrent ops per layer and direction, with the reference's
parameter names (`w_ih_l{l}`, `w_hh_l{l}`, `b_l{l}`, GRU's `b_ih_l{l}`
and `b_hh_l{l}`, `_r` for the reverse direction) and layouts ((in, G*H),
(H, G*H)), each uniform(-1/sqrt(H), 1/sqrt(H)).

The paged KV-cache ops (`paged_kv_gather` and the three writes) are the
serving engine's read/write surface over a block pool laid out (NB, bs,
H, hd), rows first (reference `layer.py:1647-1715`). The reference
returns new pools under donation; here the writes go IN PLACE into a
pool allocated once (`index_put_`), which is what lets the engine
capture its decode step as one CUDA Graph. Each write still returns the
pool. Only leading (block, row) indexing is used, so the int8 scale
pools (NB, bs) ride the same ops.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.nn.parameter import UninitializedBuffer, UninitializedParameter

from singa_tpu_torch import autograd
from singa_tpu_torch import device as device_module
from singa_tpu_torch import layout as layout_module
from singa_tpu_torch import tensor as tensor_module
from singa_tpu_torch.analysis import trace as _trace
from singa_tpu_torch.ops import flash_attention as fa
from singa_tpu_torch.parallel import mesh as mesh_module
from singa_tpu_torch.parallel import tp as tp_module

__all__ = ["Layer", "Linear", "Embedding", "LayerNorm", "Dropout", "Gelu",
           "Tanh", "Sigmoid", "ScanTransformerStack", "Conv2d",
           "SeparableConv2d", "BatchNorm2d", "MaxPool2d", "AvgPool2d",
           "GlobalAvgPool2d", "ReLU", "LeakyReLU", "SoftMax", "Flatten",
           "Sequential", "Cat", "Add", "RNN", "LSTM", "GRU", "CudnnRNN",
           "paged_kv_gather", "paged_kv_token_write",
           "paged_kv_window_write", "paged_kv_pages_write",
           "mutation_stamp", "MoEFFN", "PipelineStack",
           "PipelineTransformerStack"]


def _fill(t: torch.Tensor, gen, init: str, a: float = 0.0) -> torch.Tensor:
    """Fill `t` in place: uniform(-a, a), normal(0, a), he (normal with
    std sqrt(2 / a), `a` the fan-in), ones or zeros."""
    with torch.no_grad():
        if init == "uniform":
            t.uniform_(-a, a, generator=gen)
        elif init == "normal":
            t.normal_(0.0, a, generator=gen)
        elif init == "he":
            t.normal_(0.0, math.sqrt(2.0 / max(1, a)), generator=gen)
        elif init == "ones":
            t.fill_(1.0)
        else:
            t.zero_()
    return t


def _new(shape, dev, gen, init: str, a: float = 0.0) -> nn.Parameter:
    """A float32 parameter made at once, filled as `_fill` says."""
    return nn.Parameter(_fill(torch.empty(shape, dtype=torch.float32,
                                          device=dev), gen, init, a))


#: bumped whenever a Layer attribute is set to a tensor, a module or a
#: list/tuple (reference layer.py:92-107): `graph.GraphStep` keys its
#: captured steps by it, so a step after `layer.W = new_tensor` captures
#: afresh against the new tensor instead of replaying onto the old one.
#: In-place writes (`set_params`, `set_states`, the carry-overs) and the
#: materialisation of a lazy parameter keep the objects and the stamp
_MUTATION = [0]


def mutation_stamp() -> int:
    """The process-wide count of structural attribute assignments."""
    return _MUTATION[0]


def _setup(device, generator):
    dev = device_module.resolve(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    return dev, generator


class Layer(nn.Module):
    """Base of the port's layers: `nn.Module` with the reference's state
    API and lazy input widths.

    A layer whose input width was not given holds
    `UninitializedParameter`s (and `UninitializedBuffer`s); its first
    call materialises them (`_make`) at the width its input shows
    (`_in_width`), drawing from the generator the layer kept.
    `get_params` and `get_states` leave out what is not materialised
    yet, as the reference's leave out what its `initialize` has not
    made."""

    def __init__(self):
        super().__init__()
        self._lazy = False
        self._gen = None

    def __setattr__(self, key, value):
        if isinstance(value, (torch.Tensor, nn.Module, list, tuple)):
            _MUTATION[0] += 1
        super().__setattr__(key, value)

    def _lazy_param(self) -> UninitializedParameter:
        self._lazy = True
        return UninitializedParameter(device=self._dev, dtype=torch.float32)

    def _lazy_buffer(self, name: str) -> None:
        self._lazy = True
        self.register_buffer(name, UninitializedBuffer(
            device=self._dev, dtype=torch.float32))

    def _materialize(self, t: torch.Tensor, shape, init: str,
                     a: float = 0.0) -> None:
        t.materialize(tuple(shape))
        _fill(t, self._gen, init, a)

    def _in_width(self, x: torch.Tensor) -> int:
        return x.shape[-1]

    def _make(self, width: int) -> None:
        """Materialise the input-width-dependent tensors, or make the
        input-width-dependent sub-layers (the layers with lazy widths
        define it)."""
        raise NotImplementedError

    def _settle(self, width: Optional[int]) -> None:
        """Make the lazy tensors at `width` now (a no-op when None)."""
        if width is not None and self._lazy:
            self._make(int(width))
            self._lazy = False
            self._gen = None  # every draw is done

    def _ready(self, x: torch.Tensor) -> None:
        if self._lazy:
            self._settle(self._in_width(x))

    # -- the reference's state API -------------------------------------------
    def get_params(self, prefix: str = "") -> Dict[str, torch.Tensor]:
        return {prefix + k: p for k, p in self.named_parameters()
                if not isinstance(p, UninitializedParameter)}

    def get_buffers(self, prefix: str = "") -> Dict[str, torch.Tensor]:
        return {prefix + k: b for k, b in self.named_buffers()
                if not isinstance(b, UninitializedBuffer)}

    def get_states(self, prefix: str = "") -> Dict[str, torch.Tensor]:
        """Parameters and buffers: the checkpointable state."""
        out = self.get_params(prefix)
        out.update(self.get_buffers(prefix))
        return out

    def set_params(self, params: Mapping) -> None:
        _copy_into(self.get_params(), params, "parameter")

    def set_states(self, states: Mapping) -> None:
        _copy_into(self.get_states(), states, "state")


def _copy_into(own: Mapping[str, torch.Tensor], given: Mapping,
               what: str) -> None:
    """Copy each given array (numpy or torch) into the tensor of the same
    name, in place; KeyError on an unknown name, ValueError on a shape
    mismatch. A tensor placed on a mesh (`distributed.place_model_states`)
    takes either its block or the full array, of which it copies its
    block."""
    for k, v in given.items():
        if k not in own:
            raise KeyError(f"unknown {what} {k!r}")
        if tuple(np.shape(v)) not in _accepted_shapes(own[k]):
            raise ValueError(f"{what} {k!r}: shape {tuple(np.shape(v))} "
                             f"given, {tuple(own[k].shape)} expected")
    with torch.no_grad():
        for k, v in given.items():
            src = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.array(v))
            own[k].copy_(block_source(own[k], src))


def _accepted_shapes(t: torch.Tensor):
    placed = getattr(t, "placed", None)
    return {tuple(t.shape)} | ({tuple(placed[0])} if placed else set())


def block_source(t: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """`src` as `t` takes it: this rank's block of a full array when `t`
    is placed on a mesh and `src` has the full shape, else `src`."""
    placed = getattr(t, "placed", None)
    if placed is not None and tuple(src.shape) == tuple(placed[0]) and (
            tuple(src.shape) != tuple(t.shape)):
        from singa_tpu_torch.distributed import block_of

        return block_of(src, placed[1], placed[2])
    return src


class Linear(Layer):
    """y = x W (+ b) with W stored (in, out), as in the reference.
    `Linear(out_features, bias=True, tp_axis=None, tp_mode="col")`;
    `in_features=` makes W at once.

    Tensor parallelism (reference :222-281): `tp_axis` names a mesh axis
    and `tp_mode` the split. "col" splits W's output dim (pspec (None,
    axis), the bias (axis,)); "row" splits its input dim (pspec (axis,
    None), the bias replicated and added once, after the all-reduce).
    Inside the axis a column layer takes its input through Megatron's
    "f" (full input gradient upstream) and a row layer closes with "g"
    (the all-reduce); a col -> act -> row pair is the Megatron MLP.
    Outside the axis the same layer is the dense product. A rank holds
    W's block once the layer's model is placed on a mesh
    (`distributed.place_model_states`); until then W is full."""

    def __init__(self, out_features: int, bias: bool = True, tp_axis=None,
                 tp_mode: str = "col", *, in_features: Optional[int] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        if tp_axis is not None and tp_mode not in ("col", "row"):
            raise ValueError(
                f"tp_mode must be 'col' or 'row', got {tp_mode!r}")
        super().__init__()
        self._dev, self._gen = _setup(device, generator)
        self.out_features = out_features
        self.tp_axis, self.tp_mode = tp_axis, tp_mode
        self.W = self._lazy_param()
        self.b = _new((out_features,), self._dev, None, "zeros") if (
            bias) else None
        if tp_axis is not None:
            if tp_mode == "col":
                self.W.pspec = (None, tp_axis)
                if bias:
                    self.b.pspec = (tp_axis,)
            else:
                self.W.pspec = (tp_axis, None)
        self._settle(in_features)

    def _make(self, fan_in):
        self._materialize(self.W, (fan_in, self.out_features), "uniform",
                          math.sqrt(6.0 / max(1, fan_in + self.out_features)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._ready(x)
        if self.tp_axis is not None and mesh_module.in_axis(self.tp_axis):
            if self.tp_mode == "row":
                y = tp_module.psum_identity_bwd(self.tp_axis)(
                    autograd.linear(x, self.W))
                return y if self.b is None else autograd.add(
                    y, self.b.to(y.dtype))
            x = tp_module.identity_psum_bwd(self.tp_axis)(x)
        return autograd.linear(x, self.W, self.b)


class Embedding(Layer):
    def __init__(self, vocab_size: int, embed_dim: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = _setup(device, generator)
        self.table = _new((vocab_size, embed_dim), dev, gen, "normal", 0.1)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return autograd.embedding(idx, self.table)


class LayerNorm(Layer):
    """`LayerNorm(eps=1e-5)` over the last axis; `dim=` makes the
    parameters at once."""

    def __init__(self, eps: float = 1e-5, *, dim: Optional[int] = None,
                 device=None):
        super().__init__()
        self._dev = device_module.resolve(device)
        self.eps = eps
        self.scale = self._lazy_param()
        self.offset = self._lazy_param()
        self._settle(dim)

    def _make(self, d):
        self._materialize(self.scale, (d,), "ones")
        self._materialize(self.offset, (d,), "zeros")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._ready(x)
        return autograd.layernorm(x, self.scale, self.offset, self.eps)


class Dropout(Layer):
    """Inverted dropout in training mode, identity in eval mode. The
    draws are PyTorch's, not the reference's."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return autograd.dropout(x, self.p, train=self.training)


class Gelu(Layer):
    """tanh-approximate GELU, the function `ScanTransformerStack`'s FFN
    applies."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return autograd.gelu(x)


class Tanh(Layer):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return autograd.tanh(x)


#: the stacked transformer blocks' parameter names, in the reference's
#: order (`ScanTransformerStack`, `PipelineTransformerStack`)
STACKED_BLOCK = ("w_qkv", "b_qkv", "w_o", "b_o", "ln1_s", "ln1_o", "ln2_s",
                 "ln2_o", "w1", "b1", "w2", "b2")


def _make_stacked_blocks(lyr: Layer, d: int) -> None:
    """Materialise a stack's (L, ...) block weights at width d, with the
    reference's draws: the attention's uniform(+-1/sqrt(d)), LN ones and
    zeros, the FFN's xavier and zero biases."""
    if d % lyr.num_heads:
        raise ValueError(
            f"d_model {d} not divisible by {lyr.num_heads} heads")
    L, ff = lyr.n_blocks, lyr.ffn_mult * d
    k, xavier = 1.0 / math.sqrt(d), math.sqrt(6.0 / (d + ff))
    for name, shape, init, a in (
            ("w_qkv", (L, d, 3 * d), "uniform", k),
            ("b_qkv", (L, 3 * d), "uniform", k),
            ("w_o", (L, d, d), "uniform", k),
            ("b_o", (L, d), "uniform", k),
            ("ln1_s", (L, d), "ones", 0.0),
            ("ln1_o", (L, d), "zeros", 0.0),
            ("ln2_s", (L, d), "ones", 0.0),
            ("ln2_o", (L, d), "zeros", 0.0),
            ("w1", (L, d, ff), "uniform", xavier),
            ("b1", (L, ff), "zeros", 0.0),
            ("w2", (L, ff, d), "uniform", xavier),
            ("b2", (L, d), "zeros", 0.0)):
        lyr._materialize(getattr(lyr, name), shape, init, a)


def _post_ln_block(h: torch.Tensor, attend, wqkv, bqkv, wo, bo, l1s, l1o,
                   l2s, l2o, w1, b1, w2, b2) -> torch.Tensor:
    """One post-LN transformer block: the fused QKV projection,
    `attend` (B, T, 3d) -> (B, T, d), the output projection, LN, the
    tanh-GELU FFN, LN."""
    qkv = autograd.linear(h, wqkv, bqkv)
    o = attend(qkv)
    h = autograd._layer_norm(h + autograd.linear(o, wo, bo), l1s, l1o)
    f = autograd.gelu(autograd.linear(h, w1, b1))
    return autograd._layer_norm(h + autograd.linear(f, w2, b2), l2s, l2o)


class ScanTransformerStack(Layer):
    """N identical post-LN transformer blocks over stacked (L, ...)
    weights, looped in Python (the reference rolls them into one
    `lax.scan`): fused QKV projection, attention, output projection,
    LN, GELU FFN, LN. `remat` applies one of `autograd.REMAT_POLICIES`
    to each block, as the reference wraps its scan body. The model
    width is the input's last dim, or `d_model=`.

    Dense (reference layer.py:1373-1389), attention goes through the
    `attention_qkv` dispatcher (the fused-layout flash kernel once T
    clears its threshold). With `seq_axis` (reference :1341-1372) the
    heads are split out of the projection: inside the axis's context
    they go through `ring_attention` over the axis (the plain ring,
    its block update checkpointed; `overlap=True` pipelines it, posting
    hop s+1 before block s), outside it the same head-split tensors go
    through the plain `attention` dispatcher, the same function.

    With `tp_axis` (reference :1213-1230, :1301-1330) the fused QKV is
    drawn in the standard layout and stored HEAD-INTERLEAVED
    (`tp.interleave_qkv_shards(w, num_heads)`, as the reference stores
    it), so a contiguous column block over any axis size dividing the
    heads is a rank's [q|k|v] head triples; `w_qkv`, `w1` split their
    output dim over the axis, `b_qkv`, `b1` too, `w_o`, `w2` their input
    dim, and the rest stays replicated. Each block runs "f", the local
    heads through the head-split `attention` dispatcher (the ring over
    `seq_axis` when that distinct axis is live), "g" after the out
    projection, "f" and "g" around the FFN: `tp.PSUMS_PER_BLOCK`
    all-reduces on the model axis a block. Outside the axis the same
    body runs dense.

    With `zero3_axis` (reference :1008-1025, :1186-1256, :1391-1425),
    ZeRO-3 over that axis (the data axis, as a rule): each stacked
    weight keeps 1/world of one non-block dim on a rank (dim 1 without
    tp; with tp on a distinct axis the dim the tp split does not claim,
    the tp-split biases jointly (tp, zero3)), and each block's shards
    are all-gathered (`communicator.all_gather_tiled`) inside the
    remat-wrapped block, so one block's full (per-tp-shard) weights are
    live at once and `remat="per_block"` re-gathers in the backward;
    the gather's backward reduce-scatters each gradient back to the
    shard, and DistOpt's pspec-aware sync skips the data axis for them.
    `overlap=True` adds the double-buffered prefetch (reference
    :1045-1062, :1427-1510): block k+1's gather is issued
    (`async_op=True`) before block k's products and waited on before
    block k+1; a prologue gather fills block 0's buffer, and the last
    block re-gathers block 0 and drops it, so each block issues the same
    gathers. Each block is then a `torch.autograd.Function` that saves
    its input and its shards only: its backward re-gathers the shards,
    recomputes the block and reduce-scatters the weight gradients (the
    ZeRO-3 recipe under every remat policy; the prefetched buffer is
    never saved). `overlap` without a live zero3 or seq axis changes
    nothing."""

    #: the stacked parameter names, in the reference's order
    STACKED = STACKED_BLOCK

    #: each sharding-axis kwarg's role (of `mesh.COMPATIBLE_ROLE_PAIRS`'s
    #: vocabulary) and the scheme it implements (the distinct-axes
    #: refusal names what would collide)
    _AXIS_ROLES = {
        "tp_axis": ("tp", "Megatron weight columns/rows (replicated "
                          "tokens)"),
        "zero3_axis": ("zero3", "ZeRO-3 weight/slot shards gathered per "
                                "block"),
        "seq_axis": ("seq", "ring-attention token shards rotated per "
                            "block"),
    }

    def __init__(self, n_blocks: int, num_heads: int, ffn_mult: int = 4,
                 causal: bool = False, remat: str = "none",
                 tp_axis: Optional[str] = None,
                 zero3_axis: Optional[str] = None,
                 seq_axis: Optional[str] = None, overlap: bool = False,
                 *, d_model: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        named = [(k, v) for k, v in (("tp_axis", tp_axis),
                                     ("zero3_axis", zero3_axis),
                                     ("seq_axis", seq_axis))
                 if v is not None]
        for i in range(len(named)):
            for j in range(i + 1, len(named)):
                (ki, ax), (kj, axj) = named[i], named[j]
                ri, si = self._AXIS_ROLES[ki]
                rj, sj = self._AXIS_ROLES[kj]
                if ax == axj and frozenset(
                        {ri, rj}) not in mesh_module.COMPATIBLE_ROLE_PAIRS:
                    raise ValueError(
                        f"ScanTransformerStack needs {ki} and {kj} on "
                        f"DISTINCT mesh axes (both got {ax!r}): {ki} "
                        f"carries {si} while {kj} carries {sj}, and a "
                        f"single axis cannot serve both — its collectives "
                        f"would mix DIFFERENT shards. Build the mesh with "
                        f"one axis per scheme, e.g. parallel.mesh."
                        f"get_mesh_3d(dp, tp, sp, ('data', 'model', "
                        f"'sp'))")
        if remat not in autograd.REMAT_POLICIES:
            raise ValueError(
                f"unknown remat policy {remat!r}; pick one of "
                f"{autograd.REMAT_POLICIES}")
        if n_blocks < 1:
            raise ValueError("n_blocks must be >= 1")
        super().__init__()
        self._dev, self._gen = _setup(device, generator)
        self.n_blocks, self.num_heads = n_blocks, num_heads
        self.ffn_mult, self.causal, self.remat = ffn_mult, causal, remat
        self.seq_axis, self.tp_axis = seq_axis, tp_axis
        self.zero3_axis = zero3_axis
        #: communication-compute overlap: the double-buffered ZeRO-3
        #: prefetch and the pipelined ring (a no-op without a live
        #: zero3_axis or seq_axis)
        self.overlap = bool(overlap)
        #: each stacked weight's per-block gather dim under zero3 (0
        #: unless set by _make)
        self._z3_gather_axes: Dict[str, int] = {}
        for n in self.STACKED:
            setattr(self, n, self._lazy_param())
        self._settle(d_model)

    def _make(self, d):
        _make_stacked_blocks(self, d)
        ax, z3 = self.tp_axis, self.zero3_axis
        if ax is not None:
            with torch.no_grad():
                for name in ("w_qkv", "b_qkv"):
                    t = getattr(self, name)
                    t.copy_(tp_module.interleave_qkv_shards(
                        t.clone(), self.num_heads))
            # zero3 on a distinct axis shards the dim the tp split does
            # not claim, so the per-block gather reassembles this rank's
            # tp block; the tp-split biases shard jointly, tp major
            joint = mesh_module.axis_entry(ax, z3)
            for name, spec in (("w_qkv", (None, z3, ax)),
                               ("b_qkv", (None, joint)),
                               ("w_o", (None, ax, z3)),
                               ("w1", (None, z3, ax)), ("b1", (None, joint)),
                               ("w2", (None, ax, z3))):
                getattr(self, name).pspec = spec
            if z3 is not None:
                for name in ("b_o", "b2", "ln1_s", "ln1_o", "ln2_s",
                             "ln2_o"):
                    getattr(self, name).pspec = (None, z3)
                # row-split weights gather their output dim
                self._z3_gather_axes = {"w_o": 1, "w2": 1}
        elif z3 is not None:
            for name in self.STACKED:
                t = getattr(self, name)
                t.pspec = (None, z3) + (None,) * (t.dim() - 2)

    def declared_schedule(self, mesh) -> Dict:
        """The per-block forward collective schedule this stack declares
        for `mesh` (reference :1137-1185): `{"n_blocks": L, "per_block":
        {(primitive, axis): count}}`. The seq axis's entry is the
        reference's count of ring ppermutes, `KV_TENSORS_PER_HOP *
        rotation_steps(world)`, the same with `overlap` (the pipelined
        ring only reorders). An axis the mesh lacks adds nothing."""
        from singa_tpu_torch.parallel import ring

        per_block: Dict = {}
        shape = mesh.shape
        if self.tp_axis is not None and self.tp_axis in shape:
            per_block[("psum", self.tp_axis)] = tp_module.PSUMS_PER_BLOCK
        if self.zero3_axis is not None and self.zero3_axis in shape:
            # one gather a stacked weight, the same under overlap (the
            # last block re-gathers block 0; the prologue is outside)
            per_block[("all_gather", self.zero3_axis)] = len(self.STACKED)
        if self.seq_axis is not None and self.seq_axis in shape:
            per_block[("ppermute", self.seq_axis)] = (
                ring.KV_TENSORS_PER_HOP
                * ring.rotation_steps(int(shape[self.seq_axis])))
        return {"n_blocks": self.n_blocks, "per_block": per_block}

    def _attend(self, qkv: torch.Tensor) -> torch.Tensor:
        """Attention of the fused projection (B, T, 3d) -> (B, T, d)."""
        if self.seq_axis is None:
            return fa.attention_qkv(qkv, self.num_heads, causal=self.causal)
        from singa_tpu_torch.parallel import mesh as mesh_module
        from singa_tpu_torch.parallel.ring import ring_attention

        b, t, d3 = qkv.shape
        q, k, v = fa._split_qkv(qkv, self.num_heads)
        if mesh_module.in_axis(self.seq_axis):
            o = ring_attention(q, k, v, self.seq_axis, causal=self.causal,
                               pipelined=self.overlap)
        else:
            o = fa.attention(q, k, v, causal=self.causal)
        return o.permute(0, 2, 1, 3).reshape(b, t, d3 // 3)

    def _tp_block(self, h: torch.Tensor, wqkv, bqkv, wo, bo, l1s, l1o, l2s,
                  l2o, w1, b1, w2, b2) -> torch.Tensor:
        """The tensor-parallel block (reference :1301-1330): the same body
        dense (full weights, local heads = all heads) and sharded (this
        rank's blocks), "f" and "g" the identity outside the axis."""
        f_op = tp_module.identity_psum_bwd(self.tp_axis)
        g_op = tp_module.psum_identity_bwd(self.tp_axis)
        hd = h.shape[-1] // self.num_heads
        qkv = autograd.linear(f_op(h), wqkv, bqkv)
        q, k, v = tp_module.split_interleaved_qkv(qkv, hd)
        if self.seq_axis is not None and mesh_module.in_axis(self.seq_axis):
            from singa_tpu_torch.parallel.ring import ring_attention

            o = ring_attention(q, k, v, self.seq_axis, causal=self.causal,
                               pipelined=self.overlap)
        else:
            o = fa.attention(q, k, v, causal=self.causal)
        b_, hl, t, _ = o.shape
        a = g_op(autograd.linear(o.transpose(1, 2).reshape(b_, t, hl * hd),
                                 wo))
        h = autograd._layer_norm(h + (a + bo.to(a.dtype)), l1s, l1o)
        f = autograd.gelu(autograd.linear(f_op(h), w1, b1))
        f2 = g_op(autograd.linear(f, w2))
        return autograd._layer_norm(h + (f2 + b2.to(f2.dtype)), l2s, l2o)

    def _block(self, h: torch.Tensor, *params) -> torch.Tensor:
        return _post_ln_block(h, self._attend, *params)

    def _body(self, h: torch.Tensor, *params) -> torch.Tensor:
        return (self._block if self.tp_axis is None else self._tp_block)(
            h, *params)

    def _gather_block(self, shards, async_op: bool = False):
        """One block's shards gathered over the zero3 axis, each along its
        per-block gather dim: differentiable (`all_gather_tiled`), or,
        with `async_op` (the overlapped forward's prefetch), detached and
        issued at once, returning a function that waits and gives the
        gathered tuple."""
        dims = [self._z3_gather_axes.get(n, 0) for n in self.STACKED]
        if not async_op:
            from singa_tpu_torch.communicator import all_gather_tiled

            return tuple(all_gather_tiled(t, self.zero3_axis, d)
                         for t, d in zip(shards, dims))
        from singa_tpu_torch.communicator import _gather_dim

        group = mesh_module.axis_group(self.zero3_axis)
        world = mesh_module.axis_size(self.zero3_axis)
        if group is None:
            for t in shards:
                _trace.record("all_gather", t, axis=self.zero3_axis,
                              ran=False)
            got = tuple(t.detach() for t in shards)
            return lambda: got
        pending = [_gather_dim(t.detach(), group, world, d, async_op=True,
                               axis=self.zero3_axis)
                   for t, d in zip(shards, dims)]

        def finish():
            for work, _ in pending:
                work.wait()
            return tuple(f() for _, f in pending)

        return finish

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._ready(x)
        # one unbind per stacked weight: its backward stacks the blocks'
        # gradients in one write, where indexing w[i] per block would
        # zero-fill and sum a full (L, ...) gradient for every block
        blocks = list(zip(*(getattr(self, n).unbind(0)
                            for n in self.STACKED)))
        z3 = self.zero3_axis is not None and mesh_module.in_axis(
            self.zero3_axis)
        if z3 and self.overlap:
            return self._prefetched(x, blocks)
        # a block recomputed in the backward (remat) runs on the autograd
        # engine's thread: it brings the axes live here
        axes = mesh_module.live_axes()

        def body(h, *params):
            with mesh_module.restore_axes(axes):
                return self._body(h, *(self._gather_block(params) if z3
                                       else params))

        block = autograd.remat_wrap(body, self.remat)
        for i, params in enumerate(blocks):
            with _trace.block(i, self):
                x = block(x, *params)
        return x

    def _prefetched(self, x: torch.Tensor, blocks) -> torch.Tensor:
        """The double-buffered ZeRO-3 loop: block k runs on the buffer
        gathered during block k-1 while block k+1's gather is in
        flight."""
        n = len(blocks)
        buf = self._gather_block(blocks[0], async_op=True)()
        for k in range(n):
            with _trace.block(k, self):  # block k+1's gather is in k's
                pending = self._gather_block(blocks[(k + 1) % n],
                                             async_op=True)
                broken = _MUTATE_CONSUME_CURRENT_GATHER
                if broken:  # the mutation test: k on k+1's gather
                    buf = pending()
                x = _PrefetchedBlock.apply(x, self, buf, *blocks[k])
                if not broken:
                    buf = pending()
        return x


#: test hook (the port of tests/test_scan_overlap.py's mutation case): a
#: defective prefetch rotation that runs block k on block k+1's weights,
#: which the equality oracle must catch
_MUTATE_CONSUME_CURRENT_GATHER = False


class _PrefetchedBlock(torch.autograd.Function):
    """One block of the overlapped ZeRO-3 loop. The forward runs the
    block on the prefetched buffer and saves only its input and this
    block's shards; the backward re-gathers the shards, recomputes the
    block with grad on, and reduce-scatters the weight gradients back to
    the shards (the gather's adjoint)."""

    @staticmethod
    def forward(ctx, h, stack, buf, *shards):
        ctx.stack, ctx.axes = stack, mesh_module.live_axes()
        ctx.save_for_backward(h, *shards)
        return stack._body(h, *buf)

    @staticmethod
    def backward(ctx, dh):
        from singa_tpu_torch.communicator import _scatter_dim

        stack = ctx.stack
        h, *shards = ctx.saved_tensors
        # the engine's thread: the forward's axes, brought back
        with mesh_module.restore_axes(ctx.axes):
            buf = stack._gather_block(shards)  # grad is off here
            with torch.enable_grad():
                hh = h.detach().requires_grad_(True)
                bb = [b.detach().requires_grad_(True) for b in buf]
                out = stack._body(hh, *bb)
                grads = torch.autograd.grad(out, [hh] + bb, dh,
                                            allow_unused=True)
            group = mesh_module.axis_group(stack.zero3_axis)
            world = mesh_module.axis_size(stack.zero3_axis)
        dshards = []
        for name, s, g in zip(stack.STACKED, shards, grads[1:]):
            if g is None:
                dshards.append(torch.zeros_like(s))
            elif group is None:
                dshards.append(g)
            else:
                dshards.append(_scatter_dim(
                    g, group, world, stack._z3_gather_axes.get(name, 0),
                    axis=stack.zero3_axis))
        return (grads[0], None, None, *dshards)


def _pipelined(lyr: Layer, x: torch.Tensor, weights) -> torch.Tensor:
    """A pipelined stack's forward (reference :771-813, :918-945): outside
    its pipe axis, `lyr._stage` over all the blocks; inside it, the
    blocks of this rank's stage through `parallel.pipeline_apply`, with
    Megatron's "f" before it (only pipe rank 0 reads x, so the input's
    gradient is summed over the axis) and "g" after it (the last stage's
    output broadcast, identity backward: a bare all-reduce would scale
    the cotangents by the world)."""
    from singa_tpu_torch.parallel.pipeline import pipeline_apply

    # one unbind per stacked weight, as in ScanTransformerStack.forward
    blocks = list(zip(*(w.unbind(0) for w in weights)))
    axis = lyr.pipe_axis
    if axis is None or not mesh_module.in_axis(axis):
        return lyr._stage(blocks, x)
    world = mesh_module.axis_size(axis)
    if len(blocks) * world != lyr.n_blocks:
        raise ValueError(
            f"{type(lyr).__name__}: n_blocks {lyr.n_blocks} must divide "
            f"evenly over the '{axis}' axis (size {world})")
    x = tp_module.identity_psum_bwd(axis)(x)
    y, valid = pipeline_apply(lyr._stage, blocks, x, axis, lyr.n_micro)
    return tp_module.psum_identity_bwd(axis)(y * valid)


class PipelineStack(Layer):
    """A stack of dense residual blocks, pipeline-parallel (GPipe) over
    a mesh axis (reference :724-813). `PipelineStack(n_blocks,
    pipe_axis=None, n_micro=4, activation="relu", residual=True)`;
    `d_model=` makes the weights at once.

    The blocks' weights are stacked: W (n_blocks, d, d) xavier, b
    (n_blocks, d) zeros, with pspec (pipe_axis, ...) on the block dim,
    so a rank placed on a mesh (`distributed.place_model_states`) holds
    its n_blocks/world blocks and their optimizer slots. Each block is
    act(h W_i + b_i), added to h when `residual`; the activations are
    "relu", "gelu" (tanh-approximate), "tanh" and "identity". Outside
    the pipe axis the blocks run in a loop; inside it each rank runs its
    stage and microbatches stream between the ranks (`_pipelined`), so
    a pipelined model's loss equals the single-device run step for
    step."""

    _ACTS = {"relu": autograd.relu, "gelu": autograd.gelu,
             "tanh": autograd.tanh, "identity": lambda v: v}

    def __init__(self, n_blocks: int, pipe_axis=None, n_micro: int = 4,
                 activation: str = "relu", residual: bool = True, *,
                 d_model: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        if n_blocks < 1:
            raise ValueError("n_blocks must be >= 1")
        if activation not in self._ACTS:
            raise ValueError(f"unknown activation {activation!r}; pick one "
                             f"of {sorted(self._ACTS)}")
        super().__init__()
        self._dev, self._gen = _setup(device, generator)
        self.n_blocks, self.n_micro = n_blocks, n_micro
        self.pipe_axis, self.activation = pipe_axis, activation
        self.residual = residual
        self.W, self.b = self._lazy_param(), self._lazy_param()
        self._settle(d_model)

    def _make(self, d):
        self._materialize(self.W, (self.n_blocks, d, d), "uniform",
                          math.sqrt(6.0 / (2 * d)))
        self._materialize(self.b, (self.n_blocks, d), "zeros")
        if self.pipe_axis is not None:
            self.W.pspec = (self.pipe_axis, None, None)
            self.b.pspec = (self.pipe_axis, None)

    def _stage(self, blocks, h: torch.Tensor) -> torch.Tensor:
        act = self._ACTS[self.activation]
        for w, b in blocks:
            o = act(autograd.linear(h, w, b))
            h = h + o if self.residual else o
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._ready(x)
        return _pipelined(self, x, (self.W, self.b))


class PipelineTransformerStack(Layer):
    """A stack of post-LN transformer blocks (fused QKV, head-split
    attention, tanh-GELU FFN), pipeline-parallel (GPipe) over a mesh
    axis (reference :816-945). `PipelineTransformerStack(n_blocks,
    num_heads, ffn_mult=4, causal=False, pipe_axis=None, n_micro=4)`;
    `d_model=` makes the weights at once.

    The twelve per-block parameters of `STACKED_BLOCK` are stacked on a
    leading (n_blocks, ...) dim with the reference's draws and pspec
    (pipe_axis, None...), as `PipelineStack`'s. The block is
    `ScanTransformerStack`'s, with the heads split out of the
    projection and attended through `ops.flash_attention.attention`
    (the head-split flash kernels once a causal T reaches its
    threshold). GPipe splits the batch, so attention always sees the
    whole sequence. Dropout is deliberately absent, so the pipelined and
    the single-device runs stay step for step equal."""

    STACKED = STACKED_BLOCK

    def __init__(self, n_blocks: int, num_heads: int, ffn_mult: int = 4,
                 causal: bool = False, pipe_axis=None, n_micro: int = 4, *,
                 d_model: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        if n_blocks < 1:
            raise ValueError("n_blocks must be >= 1")
        super().__init__()
        self._dev, self._gen = _setup(device, generator)
        self.n_blocks, self.num_heads = n_blocks, num_heads
        self.ffn_mult, self.causal = ffn_mult, causal
        self.pipe_axis, self.n_micro = pipe_axis, n_micro
        for n in self.STACKED:
            setattr(self, n, self._lazy_param())
        self._settle(d_model)

    def _make(self, d):
        _make_stacked_blocks(self, d)
        if self.pipe_axis is not None:
            for name in self.STACKED:
                t = getattr(self, name)
                t.pspec = (self.pipe_axis,) + (None,) * (t.dim() - 1)

    def _attend(self, qkv: torch.Tensor) -> torch.Tensor:
        b, t, d3 = qkv.shape
        q, k, v = fa._split_qkv(qkv, self.num_heads)
        o = fa.attention(q, k, v, causal=self.causal)
        return o.permute(0, 2, 1, 3).reshape(b, t, d3 // 3)

    def _stage(self, blocks, h: torch.Tensor) -> torch.Tensor:
        for params in blocks:
            h = _post_ln_block(h, self._attend, *params)
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._ready(x)
        return _pipelined(self, x, tuple(getattr(self, n)
                                         for n in self.STACKED))


class MoEFFN(Layer):
    """The Switch Mixture-of-Experts FFN (top-1 routing; reference
    :1527-1611), expert-parallel over the mesh axis `moe_axis`.
    `MoEFFN(n_experts, ffn_mult=4, ff_dim=None, moe_axis=None,
    capacity_factor=1.25, activation="gelu")`; `d_model=` makes the
    weights at once.

    The gate `w_gate` (d, E) is replicated; the experts' `w1` (E, d, ff),
    `b1` (E, ff), `w2` (E, ff, d), `b2` (E, d) are stacked over E, with
    pspec (moe_axis, ...) when `moe_axis` is set, so a placed rank holds
    its E/world experts. Inside the axis (a distributed step over a mesh
    that has it, the batch cut over (data, expert)) the layer runs the
    expert-parallel `parallel.moe.moe_ffn` (per-shard capacity, the
    all-to-all dispatch); outside it the dense `moe_ffn_dense` (global
    capacity). Without a dropped token the two route alike. The
    load-balance loss of the last forward is `self.aux`; the models add
    `aux_coef * aux` to their loss. `activation` is "relu", "gelu"
    (tanh-approximate) or "tanh"."""

    _ACTS = {"relu": autograd.relu, "gelu": autograd.gelu,
             "tanh": autograd.tanh}

    def __init__(self, n_experts: int, ffn_mult: int = 4,
                 ff_dim: Optional[int] = None, moe_axis=None,
                 capacity_factor: float = 1.25, activation: str = "gelu",
                 *, d_model: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        if n_experts < 1:
            raise ValueError("n_experts must be >= 1")
        if activation not in self._ACTS:
            raise ValueError(f"unknown activation {activation!r}; pick one "
                             f"of {sorted(self._ACTS)}")
        super().__init__()
        self._dev, self._gen = _setup(device, generator)
        self.n_experts, self.ffn_mult, self.ff_dim = n_experts, ffn_mult, ff_dim
        self.moe_axis, self.capacity_factor = moe_axis, capacity_factor
        self.activation = activation
        self.__dict__["aux"] = None  # not a mutation: written each forward
        for n in ("w_gate", "w1", "b1", "w2", "b2"):
            setattr(self, n, self._lazy_param())
        self._settle(d_model)

    def _make(self, d):
        ff, e = self.ff_dim or self.ffn_mult * d, self.n_experts
        for name, shape, init, a in (
                ("w_gate", (d, e), "uniform", math.sqrt(6.0 / (d + e))),
                ("w1", (e, d, ff), "uniform", math.sqrt(6.0 / (d + ff))),
                ("b1", (e, ff), "zeros", 0.0),
                ("w2", (e, ff, d), "uniform", math.sqrt(6.0 / (ff + d))),
                ("b2", (e, d), "zeros", 0.0)):
            self._materialize(getattr(self, name), shape, init, a)
        if self.moe_axis is not None:
            for name in ("w1", "b1", "w2", "b2"):
                t = getattr(self, name)
                t.pspec = (self.moe_axis,) + (None,) * (t.dim() - 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from singa_tpu_torch.parallel.moe import moe_ffn, moe_ffn_dense

        self._ready(x)
        act = self._ACTS[self.activation]
        tok = x.reshape(-1, x.shape[-1])
        weights = (self.w_gate, self.w1, self.b1, self.w2, self.b2)
        if self.moe_axis is not None and mesh_module.in_axis(self.moe_axis):
            y, aux = moe_ffn(tok, *weights, self.moe_axis,
                             capacity_factor=self.capacity_factor, act=act)
        else:
            y, aux = moe_ffn_dense(tok, *weights, self.n_experts,
                                   capacity_factor=self.capacity_factor,
                                   act=act)
        self.__dict__["aux"] = aux
        return y.reshape(*x.shape[:-1], y.shape[-1])


# -- CNN layers ----------------------------------------------------------------


def _channels(x: torch.Tensor) -> int:
    return x.shape[layout_module.channel_axis(x.dim())]


class Conv2d(Layer):
    """Convolution in the current image layout;
    `Conv2d(nb_kernels, kernel_size, stride, padding, dilation, group,
    bias)`. `W` is OIHW (nb_kernels, in_channels // group, kh, kw) in
    both layouts, with the reference's "he" init, and `b` (nb_kernels,)
    zeros; `in_channels=` makes W at once."""

    def __init__(self, nb_kernels: int, kernel_size, stride=1, padding=0,
                 dilation=1, group: int = 1, bias: bool = True, *,
                 in_channels: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._dev, self._gen = _setup(device, generator)
        self.nb_kernels = nb_kernels
        self.kernel_size = autograd._pair(kernel_size)
        self.stride, self.padding = stride, padding
        self.dilation, self.group = dilation, group
        self.W = self._lazy_param()
        self.b = _new((nb_kernels,), self._dev, None, "zeros") if (
            bias) else None
        self._settle(in_channels)

    _in_width = staticmethod(_channels)

    def _make(self, c):
        kh, kw = self.kernel_size
        self._materialize(self.W, (self.nb_kernels, c // self.group, kh, kw),
                          "he", c * kh * kw // self.group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._ready(x)
        return autograd.conv2d(x, self.W, self.b, self.stride, self.padding,
                               self.dilation, self.group)


class SeparableConv2d(Layer):
    """A depthwise convolution (groups = in_channels) into a pointwise
    1x1 one, as the reference's (`layer.py:335-359`):
    `SeparableConv2d(nb_kernels, kernel_size, stride, padding, bias)`.
    Both sub-layers depend on the input width, so they are made when
    `in_channels=` is given, else at the first call."""

    def __init__(self, nb_kernels: int, kernel_size, stride=1, padding=0,
                 bias: bool = False, *, in_channels: Optional[int] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self._dev, self._gen = _setup(device, generator)
        self.nb_kernels, self.kernel_size = nb_kernels, kernel_size
        self.stride, self.padding, self.bias = stride, padding, bias
        self._lazy = True  # the sub-layers wait for the input width
        self._settle(in_channels)

    _in_width = staticmethod(_channels)

    def _make(self, c):
        kw = dict(bias=self.bias, in_channels=c, device=self._dev,
                  generator=self._gen)
        self.depthwise = Conv2d(c, self.kernel_size, stride=self.stride,
                                padding=self.padding, group=c, **kw)
        self.pointwise = Conv2d(self.nb_kernels, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._ready(x)
        return self.pointwise(self.depthwise(x))


class BatchNorm2d(Layer):
    """`autograd.batchnorm` with `scale` (ones), `offset` (zeros) and the
    buffers `running_mean` (zeros) and `running_var` (ones);
    `BatchNorm2d(momentum=0.9, eps=1e-5, sync=None)`, `num_features=`
    makes them at once. In training mode each call updates the running
    statistics in place, including calls without grad recording (such
    as `Model.compile`'s forward, as in the reference). `sync` is
    `autograd.batchnorm`'s: None averages the moments over the data
    group when the step runs under DistOpt's group."""

    def __init__(self, momentum: float = 0.9, eps: float = 1e-5,
                 sync: Optional[bool] = None, *,
                 num_features: Optional[int] = None, device=None):
        super().__init__()
        self._dev = device_module.resolve(device)
        self.momentum, self.eps, self.sync = momentum, eps, sync
        self.scale = self._lazy_param()
        self.offset = self._lazy_param()
        self._lazy_buffer("running_mean")
        self._lazy_buffer("running_var")
        self._settle(num_features)

    _in_width = staticmethod(_channels)

    def _make(self, c):
        c = (c,)
        self._materialize(self.scale, c, "ones")
        self._materialize(self.offset, c, "zeros")
        self._materialize(self.running_mean, c, "zeros")
        self._materialize(self.running_var, c, "ones")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._ready(x)
        y, new_rm, new_rv = autograd.batchnorm(
            x, self.scale, self.offset, self.running_mean, self.running_var,
            momentum=self.momentum, eps=self.eps, train=self.training,
            sync=self.sync)
        if self.training:
            with torch.no_grad():
                self.running_mean.copy_(new_rm)
                self.running_var.copy_(new_rv)
        return y


class MaxPool2d(Layer):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return autograd.max_pool2d(x, self.k, self.s, self.p)


class AvgPool2d(Layer):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return autograd.avg_pool2d(x, self.k, self.s, self.p)


class GlobalAvgPool2d(Layer):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return autograd.global_avg_pool2d(x)


class ReLU(Layer):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return autograd.relu(x)


class LeakyReLU(Layer):
    def __init__(self, a: float = 0.01):
        super().__init__()
        self.a = a

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return autograd.leakyrelu(x, self.a)


class Sigmoid(Layer):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return autograd.sigmoid(x)


class SoftMax(Layer):
    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return autograd.softmax(x, self.axis)


class Flatten(Layer):
    """Flatten the dims from `start_axis` on. The reference rotates an
    NHWC activation back to NCHW first, so that the following Linear
    sees the NCHW feature order in both layouts; here a channels-last
    activation already has the logical NCHW shape, and flattening it
    gives that order, so there is nothing to rotate."""

    def __init__(self, start_axis: int = 1):
        super().__init__()
        self.start_axis = start_axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return autograd.flatten(x, self.start_axis)


class Sequential(Layer):
    def __init__(self, *layers: nn.Module):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for lyr in self.layers:
            x = lyr(x)
        return x


class Cat(Layer):
    """Concatenate the inputs on `axis`. Axes are logical NCHW ones in
    both image layouts, so `Cat(axis=1)` joins channels under "NHWC"
    too; the reference concatenates the raw NHWC array there, where
    axis 1 is the height."""

    def __init__(self, axis: int = 1):
        super().__init__()
        self.axis = axis

    def forward(self, *xs: torch.Tensor) -> torch.Tensor:
        return autograd.cat(list(xs), self.axis)


class Add(Layer):
    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return autograd.add(a, b)


# -- recurrent layers (reference layer.py:514-698) -----------------------------


class _RNNBase(Layer):
    """Multi-layer, optionally bidirectional recurrent stack over the
    `autograd` recurrent ops. The reverse direction runs the op with
    `reverse=True` (outputs stay time-aligned) and joins the forward one
    on the feature axis, the composition cuDNN fuses. `batch_first`
    inputs are (B, T, in), else (T, B, in). `return_sequences=False`
    gives the last layer's final hidden state (directions joined);
    `return_state=True` adds the final states, one per (layer,
    direction): LSTM `(hs, cs)`, the others `hs`; `hx` takes the same
    form as the initial states (zeros when None). `remat=True`
    recomputes each cell in the backward."""

    mode = "lstm"
    n_gates = 4

    def __init__(self, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False, batch_first: bool = True,
                 return_sequences: bool = True, return_state: bool = False,
                 remat: bool = False, nonlinearity: str = "tanh", *,
                 input_size: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if nonlinearity not in ("tanh", "relu"):
            raise ValueError(f"unknown nonlinearity {nonlinearity!r}")
        self._dev, self._gen = _setup(device, generator)
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layers, self.bidirectional = num_layers, bidirectional
        self.batch_first = batch_first
        self.return_sequences = return_sequences
        self.return_state = return_state
        self.remat, self.nonlinearity = remat, nonlinearity
        # every weight waits for the input width, so the draws keep one
        # order whether it is given here or inferred at the first call
        for name, _ in self._weights(0):
            setattr(self, name, self._lazy_param())
        self._settle(input_size)

    def _weights(self, input_size: int):
        """(name, shape) of every weight, in the order of the draws."""
        H, G = self.hidden_size, self.n_gates
        biases = ("b_ih", "b_hh") if self.mode == "gru" else ("b",)
        for l in range(self.num_layers):
            layer_in = input_size if l == 0 else H * self._dirs
            for d in range(self._dirs):
                yield self._wname("w_ih", l, d), (layer_in, G * H)
                yield self._wname("w_hh", l, d), (H, G * H)
                for kind in biases:
                    yield self._wname(kind, l, d), (G * H,)

    def _make(self, input_size):
        self.input_size = input_size
        k = 1.0 / math.sqrt(self.hidden_size)
        for name, shape in self._weights(input_size):
            self._materialize(getattr(self, name), shape, "uniform", k)

    @property
    def _dirs(self) -> int:
        return 2 if self.bidirectional else 1

    @staticmethod
    def _wname(kind: str, l: int, d: int) -> str:
        return f"{kind}_l{l}" + ("_r" if d else "")

    def _run_dir(self, x, l, d, h0, c0):
        """One direction of one layer: (ys, h_T, c_T or None)."""
        def w(kind):
            return getattr(self, self._wname(kind, l, d))

        reverse = d == 1
        if self.mode == "lstm":
            return autograd.lstm(x, w("w_ih"), w("w_hh"), w("b"), h0, c0,
                                 reverse=reverse, remat=self.remat)
        if self.mode == "gru":
            ys, h = autograd.gru(x, w("w_ih"), w("w_hh"), w("b_ih"),
                                 w("b_hh"), h0, reverse=reverse,
                                 remat=self.remat)
        else:
            ys, h = autograd.vanilla_rnn(
                x, w("w_ih"), w("w_hh"), w("b"), h0,
                nonlinearity=self.nonlinearity, reverse=reverse,
                remat=self.remat)
        return ys, h, None

    def forward(self, x: torch.Tensor, hx=None):
        self._ready(x)
        if self.batch_first:
            x = autograd.transpose(x, (1, 0, 2))  # -> (T, B, in)
        h0s, c0s = (hx if self.mode == "lstm" else (hx, None)) if (
            hx is not None) else (None, None)
        zeros = torch.zeros((x.shape[1], self.hidden_size), dtype=x.dtype,
                            device=x.device)
        h_lasts, c_lasts = [], []
        for l in range(self.num_layers):
            outs = []
            for d in range(self._dirs):
                i = l * self._dirs + d
                ys, h, c = self._run_dir(
                    x, l, d, zeros if h0s is None else h0s[i],
                    zeros if c0s is None else c0s[i])
                outs.append(ys)
                h_lasts.append(h)
                if c is not None:
                    c_lasts.append(c)
            x = autograd.cat(outs, axis=-1) if len(outs) > 1 else outs[0]
        if self.return_sequences:
            y = autograd.transpose(x, (1, 0, 2)) if self.batch_first else x
        else:
            finals = h_lasts[-self._dirs:]
            y = autograd.cat(finals, axis=-1) if len(finals) > 1 else (
                finals[0])
        if self.return_state:
            return y, ((h_lasts, c_lasts) if self.mode == "lstm"
                       else h_lasts)
        return y


class RNN(_RNNBase):
    mode = "rnn"
    n_gates = 1


class LSTM(_RNNBase):
    mode = "lstm"
    n_gates = 4


class GRU(_RNNBase):
    mode = "gru"
    n_gates = 3


class CudnnRNN(_RNNBase):
    """The reference's cuDNN-layer surface, `CudnnRNN(hidden_size,
    rnn_mode=...)` with rnn_mode "lstm", "gru", "tanh" or "relu",
    sequence-major by default as cuDNN is; backed by the same recurrent
    ops as the other layers."""

    _MODES = {"lstm": ("lstm", 4, "tanh"), "gru": ("gru", 3, "tanh"),
              "tanh": ("rnn", 1, "tanh"), "relu": ("rnn", 1, "relu")}

    def __init__(self, hidden_size: int, rnn_mode: str = "lstm", **kw):
        if rnn_mode not in self._MODES:
            raise ValueError(f"unknown rnn_mode {rnn_mode!r}")
        self.mode, self.n_gates, nonlin = self._MODES[rnn_mode]
        kw.setdefault("nonlinearity", nonlin)
        kw.setdefault("batch_first", False)
        super().__init__(hidden_size, **kw)


# -- paged KV cache (the serving engine's pools) ------------------------------


def paged_kv_gather(pool: torch.Tensor, page_table) -> torch.Tensor:
    """Every slot's cache through its page table: pool (NB, bs, H, hd)
    and page_table (S, P) -> (S, H, P*bs, hd), the dense (S, H, W, hd)
    cache the non-paged decode step attends (W = P*bs)."""
    return tensor_module.paged_gather(pool, page_table).transpose(1, 2)


def _block_rows(pool, page_table, positions):
    """(block, row) of each logical position; positions past the table's
    window go to the trash block 0 instead of clamping onto the last
    real page."""
    bs, pages = pool.shape[1], page_table.shape[1]
    page = (positions // bs).clamp(max=pages - 1)
    blocks = page_table.gather(1, page)
    blocks = torch.where(positions < pages * bs, blocks,
                         torch.zeros_like(blocks))
    return blocks, positions % bs


def paged_kv_token_write(pool: torch.Tensor, page_table, pos,
                         kv: torch.Tensor) -> torch.Tensor:
    """One new token's K (or V) per slot, in place: kv (S, H, hd) lands
    at logical position pos (S,) of each slot, block
    page_table[s, pos[s] // bs], row pos[s] % bs. Slots that must not
    write point their page-table row at the trash block, so the write
    keeps one shape; colliding trash writes are never read back."""
    blocks, rows = _block_rows(pool, page_table, pos[:, None])
    pool[blocks[:, 0], rows[:, 0]] = kv
    return pool


def paged_kv_window_write(pool: torch.Tensor, page_table, pos,
                          kv: torch.Tensor) -> torch.Tensor:
    """T new token rows per slot, in place: kv (S, T, ...) lands at
    logical positions pos[s] + j for j in [0, T). Positions past the
    window go to trash. Trailing dims are free: the int8 path writes
    its (S, T) row scales through this too."""
    steps = torch.arange(kv.shape[1], device=pos.device)
    blocks, rows = _block_rows(pool, page_table,
                               pos[:, None] + steps[None, :])
    pool[blocks, rows] = kv
    return pool


def paged_kv_pages_write(pool: torch.Tensor, pages,
                         kv_pages: torch.Tensor) -> torch.Tensor:
    """Whole pages, in place (the prefill write): kv_pages
    (B, P, bs, H, hd), each request's full-window K (or V) chunked into
    pages, lands at blocks pages (B, P). Unallocated table entries point
    at the trash block; its slack pages are never attended."""
    pool[pages] = kv_pages
    return pool
