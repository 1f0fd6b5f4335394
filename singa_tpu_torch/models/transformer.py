"""Transformer encoder and the BERT family (counterpart of
singa_tpu/models/transformer.py).

- `MultiHeadAttention`: one fused (d, 3d) QKV projection, attention
  through the `attention_qkv` dispatcher (the fused-layout flash kernels
  once T clears the threshold and no mask is given; a key-padding or
  other mask takes the plain `full_attention`), then the output
  projection. `w_qkv`, `b_qkv`, `w_o`, `b_o` are drawn from
  uniform(-1/sqrt(d), 1/sqrt(d)), as the reference's. With `seq_axis`
  naming a mesh axis of sequence shards, inside that axis's context
  (a distributed step over a mesh that has it) attention runs as ring
  attention over the axis (`parallel/ring.py`; `ring_flash=True` puts
  each block through the head-split flash kernels) or, with
  `seq_impl="ulysses"`, as Ulysses' all-to-all (`parallel/ulysses.py`;
  `ring_flash=True` attends through the flash kernels); outside it, the
  same weights compute ordinary attention. `remat` reaches the ring's
  block update and Ulysses' attention, as in the reference.
- `TransformerEncoderLayer`: post-LN, attention + Add&LN, then the dense
  tanh-GELU FFN + Add&LN, each branch behind its dropout.
- `TransformerEncoder`: the blocks in an `nn.ModuleList` named `blocks`,
  so the parameter names are the reference's
  (`encoder.blocks.0.attn.w_qkv`, `...ln1.scale`, `...fc1.W`) and
  `model.load_singa_tpu_params` carries weights across unchanged. It is
  also the unrolled decoder of `GPT(scan_blocks=False)`.
- `Bert`, `BertForClassification` (`train_one_batch(ids, y)`),
  `bert_base`, `bert_small`. Under their `seq_axis` the positions are
  offset by the shard's index times T_local and the CLS row, which
  lives on shard 0, reaches every shard by `broadcast_from`;
  `seq_sharded_args` tells the distributed step which arguments to cut
  along the sequence.

The reference infers widths at the first call; here every layer is built
at once, so the attention and encoder layers take `d_model=` beside the
reference's arguments, and every constructor takes `device=` and
`generator=` keyword-only. Dropout's draws are PyTorch's.

Tensor parallelism (reference :110-200, :275-325, :330-476): with
`tp_axis`, `MultiHeadAttention` keeps separate `w_q`, `w_k`, `w_v`
(drawn as ONE fused (d, 3d) tensor from the layer's generator, then
split, so a tp model starts from exactly the dense init; each pspec
(None, axis), the biases (axis,)), and `w_o` row-split (axis, None)
with `b_o` replicated. Inside the axis each rank projects and attends
its own heads through the head-split `attention` dispatcher (the
head-split flash kernels from T 256 causal or T 1024 non-causal, where
the dense layer's fused `attention_qkv` takes the fused kernel from
T 256 causal or T 512), and the out projection closes with one
all-reduce; outside it the same weights compute dense attention. The
encoder block's `fc1` is column- and `fc2` row-parallel. A distinct
`seq_axis` beside `tp_axis` leaves attention to the ring (the FFN stays
tensor-parallel), as the reference does; the same axis for both raises.
`states_to_tp` / `states_from_tp` convert checkpoints between the fused
and the split layout.

The Switch MoE FFN (reference :326-425): `moe_experts=N` replaces each
encoder block's dense FFN by a `layer.MoEFFN` of N experts named `ffn`
(`encoder.blocks.0.ffn.w1`, ...), expert-parallel over `moe_axis` when
the distributed step runs over a mesh with that axis (the batch cut over
(data, expert)); `moe_capacity_factor` is its capacity factor.
`collect_moe_aux` gathers the blocks' load-balance losses, which
`BertForClassification` (and `models.gpt.GPT`) add to the loss at
`moe_aux_coef`. With `tp_axis` on a distinct axis, attention is
head-parallel over tp and the FFN expert-parallel; the same axis for
both, or no `moe_axis`, is refused as the reference refuses it.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from singa_tpu_torch import autograd, layer, model
from singa_tpu_torch.ops import flash_attention as fa
from singa_tpu_torch.parallel import mesh as mesh_module

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "Bert", "BertForClassification",
           "bert_base", "bert_small", "collect_moe_aux", "states_to_tp",
           "states_from_tp"]


def states_to_tp(states):
    """A fused-attention checkpoint (`w_qkv`/`b_qkv` entries) in the
    head-parallel layout (`w_q`/`w_k`/`w_v`, the biases alike), so a model
    trained without `tp_axis` restores into a `tp_axis=` one (reference
    :43-57). Exact: the tp initializer splits the same fused draw."""
    out = {}
    for k, v in states.items():
        if k.endswith("w_qkv") or k.endswith("b_qkv"):
            base = k[: -len("_qkv")]
            q, kk, vv = np.split(np.asarray(v), 3, axis=-1)
            out[base + "_q"], out[base + "_k"], out[base + "_v"] = q, kk, vv
        else:
            out[k] = v
    return out


def states_from_tp(states):
    """The inverse of `states_to_tp`: re-fuse each `w_q`/`w_k`/`w_v` (and
    bias) triple into `w_qkv` (reference :60-75)."""
    out, triples = {}, {}
    for k, v in states.items():
        root, _, leaf = k.rpartition(".")
        if leaf in ("w_q", "w_k", "w_v", "b_q", "b_k", "b_v"):
            triples.setdefault((root, leaf[0]), {})[leaf[-1]] = np.asarray(v)
        else:
            out[k] = v
    for (root, kind), t in triples.items():
        if set(t) != {"q", "k", "v"}:
            raise ValueError(
                f"incomplete q/k/v triple under {root!r}: {sorted(t)}")
        prefix = f"{root}." if root else ""
        out[f"{prefix}{kind}_qkv"] = np.concatenate(
            [t["q"], t["k"], t["v"]], axis=-1)
    return out


def refuse_distributed(seq_impl="ring"):
    """Raise on an unknown `seq_impl` (every distributed option of the
    encoder is ported)."""
    if seq_impl not in ("ring", "ulysses"):
        raise ValueError(f"seq_impl must be 'ring' or 'ulysses', "
                         f"got {seq_impl!r}")


def collect_moe_aux(root: nn.Module):
    """The load-balance auxiliary losses the `layer.MoEFFN`s under `root`
    recorded in their last forward, in module order (reference :80-90);
    [] for a dense model."""
    return [m.aux for m in root.modules()
            if isinstance(m, layer.MoEFFN) and m.aux is not None]


class MultiHeadAttention(nn.Module):
    """Self-attention with a fused QKV projection (or, with `tp_axis`,
    head-parallel q/k/v projections); `forward(x, mask)` with x (B, T, d)
    and an optional mask broadcastable to (B, H, T, T), True where a
    query may attend a key. Inside the context of `seq_axis`, x is this
    rank's sequence shard and attention runs over the global sequence
    (ring or Ulysses, `seq_impl`)."""

    def __init__(self, num_heads: int, causal: bool = False,
                 seq_axis: Optional[str] = None, remat: bool = False,
                 bias: bool = True, ring_flash: bool = False,
                 tp_axis: Optional[str] = None, seq_impl: str = "ring", *,
                 d_model: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if tp_axis is not None and seq_axis is not None:
            raise NotImplementedError(
                "tp_axis and seq_axis on the same MultiHeadAttention are "
                "not supported yet; pick head-parallel or ring attention")
        refuse_distributed(seq_impl)
        if d_model % num_heads:
            raise ValueError(
                f"d_model {d_model} not divisible by {num_heads}")
        dev, gen = layer._setup(device, generator)
        self.num_heads, self.causal, self.remat = num_heads, causal, remat
        self.seq_axis, self.ring_flash = seq_axis, ring_flash
        self.seq_impl, self.tp_axis = seq_impl, tp_axis
        k = 1.0 / math.sqrt(d_model)
        d = d_model
        w_qkv = layer._new((d, 3 * d), dev, gen, "uniform", k)
        w_o = layer._new((d, d), dev, gen, "uniform", k)
        b_qkv = layer._new((3 * d,), dev, gen, "uniform", k) if bias else None
        b_o = layer._new((d,), dev, gen, "uniform", k) if bias else None
        if tp_axis is None:
            self.w_qkv, self.w_o, self.b_qkv, self.b_o = w_qkv, w_o, b_qkv, b_o
            return
        # the dense layer's draws, split: the same init at any world
        for name, part in zip(("w_q", "w_k", "w_v"), w_qkv.detach().chunk(
                3, dim=-1)):
            setattr(self, name, nn.Parameter(part.contiguous()))
            getattr(self, name).pspec = (None, tp_axis)
        self.w_o = w_o
        self.w_o.pspec = (tp_axis, None)
        for name, part in zip(("b_q", "b_k", "b_v"), (
                b_qkv.detach().chunk(3) if bias else (None,) * 3)):
            setattr(self, name, None if part is None else nn.Parameter(
                part.contiguous()))
            if part is not None:
                getattr(self, name).pspec = (tp_axis,)
        self.b_o = b_o

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        if mask is not None:
            mask = torch.as_tensor(mask, device=x.device)
        if self.tp_axis is not None:
            return self._head_parallel(x, mask)
        qkv = autograd.linear(x, self.w_qkv, self.b_qkv)  # (B, T, 3d)
        if self.seq_axis is not None and mesh_module.in_axis(self.seq_axis):
            if mask is not None:
                raise NotImplementedError(
                    "ring attention with an explicit attention mask is not "
                    "supported yet; use causal=True or pad-free batches")
            ctx = self._sequence_parallel(qkv)
        elif mask is not None:  # no ONNX decomposition: a trace raises
            ctx = fa.attention_qkv(qkv, self.num_heads, causal=self.causal,
                                   mask=mask)
        else:
            d = x.shape[-1]
            ctx = autograd.op(
                "Attention", {"num_heads": self.num_heads,
                              "causal": int(self.causal),
                              "scale": (d // self.num_heads) ** -0.5,
                              "d_model": d, "seq_len": x.shape[1]},
                lambda a: fa.attention_qkv(a, self.num_heads,
                                           causal=self.causal), qkv)
        return autograd.linear(ctx, self.w_o, self.b_o)

    def _head_parallel(self, x: torch.Tensor, mask) -> torch.Tensor:
        """Megatron's attention block (reference :275-325): "f", this
        rank's heads projected and attended through the head-split
        dispatcher, the row-parallel out projection, "g", then the bias.
        Outside the axis the same weights give dense attention."""
        from singa_tpu_torch.parallel import tp as tp_module

        hd = x.shape[-1] // self.num_heads
        sharded = mesh_module.in_axis(self.tp_axis)
        if sharded:
            x = tp_module.identity_psum_bwd(self.tp_axis)(x)
        q, k, v = (autograd.linear(x, w, b) for w, b in (
            (self.w_q, self.b_q), (self.w_k, self.b_k),
            (self.w_v, self.b_v)))
        b_, t, width = q.shape
        if width % hd:
            raise ValueError(
                f"head-parallel attention: local projection width {width} "
                f"is not a multiple of head_dim {hd} — num_heads "
                f"({self.num_heads}) must be divisible by the "
                f"'{self.tp_axis}' axis size")

        def heads(a):  # (B, T, h_local*hd) -> (B, h_local, T, hd)
            return a.reshape(b_, t, width // hd, hd).transpose(1, 2)

        o = fa.attention(heads(q), heads(k), heads(v), causal=self.causal,
                         mask=mask)
        y = autograd.linear(o.transpose(1, 2).reshape(b_, t, width),
                            self.w_o)
        if sharded:
            y = tp_module.psum_identity_bwd(self.tp_axis)(y)
        return y if self.b_o is None else autograd.add(
            y, self.b_o.to(y.dtype))

    def _sequence_parallel(self, qkv: torch.Tensor) -> torch.Tensor:
        """Attention of this rank's sequence shard over the global
        sequence: the heads split out of the fused projection, then ring
        attention or Ulysses over `seq_axis` (no ONNX decomposition: an
        export trace raises by name)."""
        from singa_tpu_torch.parallel.ring import ring_attention
        from singa_tpu_torch.parallel.ulysses import ulysses_attention

        b, t, d3 = qkv.shape
        q, k, v = fa._split_qkv(qkv, self.num_heads)
        if self.seq_impl == "ulysses":
            o = ulysses_attention(q, k, v, self.seq_axis, causal=self.causal,
                                  use_flash=self.ring_flash,
                                  remat=self.remat)
        else:
            o = ring_attention(q, k, v, self.seq_axis, causal=self.causal,
                               remat=self.remat, use_flash=self.ring_flash)
        return o.permute(0, 2, 1, 3).reshape(b, t, d3 // 3)


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder block (the BERT convention): MHA + Add&LN, then
    the dense GELU FFN (or, with `moe_experts`, the Switch MoE FFN
    `ffn`) + Add&LN."""

    def __init__(self, num_heads: int, ffn_mult: int = 4,
                 dropout: float = 0.1, causal: bool = False,
                 seq_axis: Optional[str] = None, remat: bool = False,
                 ring_flash: bool = False, tp_axis: Optional[str] = None,
                 seq_impl: str = "ring", moe_experts: Optional[int] = None,
                 moe_axis: Optional[str] = None,
                 moe_capacity_factor: float = 1.25, *, d_model: int,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if tp_axis is not None and tp_axis == seq_axis:
            raise ValueError(
                "seq_axis and tp_axis must be distinct mesh axes: the FFN "
                "col->row pair would psum partial contractions of "
                "DIFFERENT sequence shards over the shared axis")
        if moe_experts is not None and tp_axis is not None and (
                moe_axis is None or moe_axis == tp_axis):
            raise NotImplementedError(
                f"moe_experts with tp_axis needs a DISTINCT moe_axis (got "
                f"moe_axis={moe_axis!r}, tp_axis={tp_axis!r}): the "
                f"expert-parallel FFN shards the batch/tokens over its axis "
                f"for the all-to-all dispatch, while Megatron TP shards "
                f"weight columns/rows over its axis with replicated "
                f"activations; a single axis cannot carry both shardings. "
                f"Pass moe_axis='expert' and tp_axis='model' on a (data, "
                f"expert, model) mesh for head-parallel attention over TP "
                f"with expert-parallel FFNs")
        refuse_distributed(seq_impl)
        dev, gen = layer._setup(device, generator)
        # with seq_axis the ring owns attention and only the FFN is
        # tensor-parallel (reference :379-388)
        self.tp_axis = tp_axis
        self.attn = MultiHeadAttention(
            num_heads, causal=causal, seq_axis=seq_axis, remat=remat,
            ring_flash=ring_flash,
            tp_axis=tp_axis if seq_axis is None else None,
            seq_impl=seq_impl, d_model=d_model, device=dev, generator=gen)
        self.ln1 = layer.LayerNorm(dim=d_model, device=dev)
        self.ln2 = layer.LayerNorm(dim=d_model, device=dev)
        self.drop1 = layer.Dropout(dropout)
        self.drop2 = layer.Dropout(dropout)
        self.moe_experts, self.moe_axis = moe_experts, moe_axis
        if moe_experts is not None:
            self.ffn = layer.MoEFFN(
                moe_experts, ffn_mult=ffn_mult, moe_axis=moe_axis,
                capacity_factor=moe_capacity_factor, d_model=d_model,
                device=dev, generator=gen)
            return
        self.fc1 = layer.Linear(ffn_mult * d_model, tp_axis=tp_axis,
                                tp_mode="col", in_features=d_model,
                                device=dev, generator=gen)
        self.gelu = layer.Gelu()
        self.fc2 = layer.Linear(d_model, tp_axis=tp_axis, tp_mode="row",
                                in_features=ffn_mult * d_model,
                                device=dev, generator=gen)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        a = self.drop1(self.attn(x, mask))
        x = self.ln1(autograd.add(x, a))
        if self.moe_experts is not None:
            f = self.drop2(self.ffn(x))
        else:
            f = self.drop2(self.fc2(self.gelu(self.fc1(x))))
        return self.ln2(autograd.add(x, f))


class TransformerEncoder(nn.Module):
    """`num_layers` encoder blocks in order. `num_heads` and `n_blocks`
    are `ScanTransformerStack`'s attributes of the same names, so the
    decode and serving code reads either decoder."""

    def __init__(self, num_layers: int, num_heads: int, *, d_model: int,
                 device=None, generator: Optional[torch.Generator] = None,
                 **block_kw):
        super().__init__()
        dev, gen = layer._setup(device, generator)
        self.num_heads, self.n_blocks = num_heads, num_layers
        self.blocks = nn.ModuleList(
            TransformerEncoderLayer(num_heads, d_model=d_model, device=dev,
                                    generator=gen, **block_kw)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        for b in self.blocks:
            x = b(x, mask)
        return x


class Bert(model.Model):
    """BERT encoder: token + position (+ segment) embeddings, LN,
    dropout, the blocks, and the pooler on the CLS row. `forward(ids,
    seg_ids=None, mask=None)` returns (hidden (B, T, d), pooled (B, d)).
    `bert_base()` is the reference's BERT-base (12 layers, d 768, 12
    heads of hd 64)."""

    def __init__(self, vocab_size: int = 30522, d_model: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 max_len: int = 512, type_vocab: int = 2,
                 dropout: float = 0.1, seq_axis: Optional[str] = None,
                 remat: bool = False, ring_flash: bool = False,
                 tp_axis: Optional[str] = None, seq_impl: str = "ring",
                 moe_experts: Optional[int] = None,
                 moe_axis: Optional[str] = None,
                 moe_capacity_factor: float = 1.25, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = layer._setup(device, generator)
        self.d_model = d_model
        self.tok = layer.Embedding(vocab_size, d_model, device=dev,
                                   generator=gen)
        self.pos = layer.Embedding(max_len, d_model, device=dev,
                                   generator=gen)
        self.seg = layer.Embedding(type_vocab, d_model, device=dev,
                                   generator=gen)
        self.ln = layer.LayerNorm(dim=d_model, device=dev)
        self.drop = layer.Dropout(dropout)
        self.encoder = TransformerEncoder(
            num_layers, num_heads, dropout=dropout, seq_axis=seq_axis,
            remat=remat, ring_flash=ring_flash, tp_axis=tp_axis,
            seq_impl=seq_impl, moe_experts=moe_experts, moe_axis=moe_axis,
            moe_capacity_factor=moe_capacity_factor, d_model=d_model,
            device=dev, generator=gen)
        self.pooler = layer.Linear(d_model, in_features=d_model,
                                   device=dev, generator=gen)
        self.pool_act = layer.Tanh()
        self.seq_axis, self.tp_axis = seq_axis, tp_axis
        #: the expert axis: the distributed step cuts the batch over
        #: (data, moe_axis) and DistOpt reduces over it
        self.moe_axis = moe_axis
        #: the distributed step's token arguments (dim 1 is T): ids and
        #: seg_ids
        self.seq_sharded_args = (0, 1)

    @property
    def device(self) -> torch.device:
        return self.tok.table.device

    def _sharded(self) -> bool:
        return self.seq_axis is not None and mesh_module.in_axis(
            self.seq_axis)

    def forward(self, ids, seg_ids=None, mask=None):
        ids = torch.as_tensor(ids, device=self.device).long()
        t = ids.shape[-1]
        # positions: offset by this rank's shard under sequence parallel
        off = mesh_module.axis_index(self.seq_axis) * t if (
            self._sharded()) else 0
        emb = autograd.add(self.tok(ids), self.pos(
            torch.arange(off, off + t, device=ids.device)))
        if seg_ids is not None:
            emb = autograd.add(emb, self.seg(
                torch.as_tensor(seg_ids, device=ids.device).long()))
        x = self.encoder(self.drop(self.ln(emb)), mask)
        if self._sharded():
            from singa_tpu_torch.communicator import broadcast_from

            # the global CLS row lives on shard 0
            cls = broadcast_from(x[:, 0], self.seq_axis, root=0)
        else:
            cls = autograd.op("GatherCLS", {}, lambda a: a[:, 0], x)
        return x, self.pool_act(self.pooler(cls))


class BertForClassification(model.Model):
    """Bert + a classification head on the pooled CLS row;
    `train_one_batch(ids, y)` is the mean cross-entropy over the batch,
    then the optimizer."""

    def __init__(self, num_classes: int, moe_aux_coef: float = 0.01, *,
                 device=None, generator: Optional[torch.Generator] = None,
                 **bert_kw):
        super().__init__()
        dev, gen = layer._setup(device, generator)
        self.bert = Bert(**bert_kw, device=dev, generator=gen)
        self.head = layer.Linear(num_classes, in_features=self.bert.d_model,
                                 device=dev, generator=gen)
        self.moe_aux_coef = moe_aux_coef
        self.seq_axis, self.tp_axis = self.bert.seq_axis, self.bert.tp_axis
        self.moe_axis = self.bert.moe_axis
        #: per method: train_one_batch(ids, y) has per-example labels at
        #: arg 1 (data axis only), eval forward(ids, seg_ids) token
        #: arguments at both
        self.seq_sharded_args = {"train_one_batch": (0,),
                                 "forward": (0, 1)}

    @property
    def device(self) -> torch.device:
        return self.bert.device

    def forward(self, ids, seg_ids=None, mask=None):
        _, pooled = self.bert(ids, seg_ids, mask)
        return self.head(pooled)

    def train_one_batch(self, ids, y, dist_option: str = "plain",
                        spars=None):
        out = self.forward(ids)
        loss = autograd.softmax_cross_entropy(out, y)
        if self.moe_aux_coef:
            for aux in collect_moe_aux(self):
                loss = loss + aux * self.moe_aux_coef
        self._apply_opt(loss, dist_option, spars)
        return out, loss


def bert_base(**kw) -> Bert:
    return Bert(d_model=768, num_layers=12, num_heads=12, **kw)


def bert_small(**kw) -> Bert:
    kw.setdefault("d_model", 128)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("vocab_size", 1000)
    kw.setdefault("max_len", 128)
    return Bert(**kw)
