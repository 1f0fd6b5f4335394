"""Transformer encoder and the BERT family (counterpart of
singa_tpu/models/transformer.py), dense and on one device.

- `MultiHeadAttention`: one fused (d, 3d) QKV projection, attention
  through the `attention_qkv` dispatcher (the fused-layout flash kernels
  once T clears the threshold and no mask is given; a key-padding or
  other mask takes the plain `full_attention`), then the output
  projection. `w_qkv`, `b_qkv`, `w_o`, `b_o` are drawn from
  uniform(-1/sqrt(d), 1/sqrt(d)), as the reference's.
- `TransformerEncoderLayer`: post-LN, attention + Add&LN, then the dense
  tanh-GELU FFN + Add&LN, each branch behind its dropout.
- `TransformerEncoder`: the blocks in an `nn.ModuleList` named `blocks`,
  so the parameter names are the reference's
  (`encoder.blocks.0.attn.w_qkv`, `...ln1.scale`, `...fc1.W`) and
  `model.load_singa_tpu_params` carries weights across unchanged. It is
  also the unrolled decoder of `GPT(scan_blocks=False)`.
- `Bert`, `BertForClassification` (`train_one_batch(ids, y)`),
  `bert_base`, `bert_small`.

The reference infers widths at the first call; here every layer is built
at once, so the attention and encoder layers take `d_model=` beside the
reference's arguments, and every constructor takes `device=` and
`generator=` keyword-only. Dropout's draws are PyTorch's.

Not ported in this slice, raising `NotImplementedError` naming their
ROADMAP items: sequence parallelism (`seq_axis`, `ring_flash`,
`seq_impl="ulysses"`) and head-parallel tensor parallelism (`tp_axis`),
items 14-15; the Switch MoE FFN (`moe_experts`), item 15; and
`states_to_tp` / `states_from_tp`, which come with item 14. `remat` is
stored: on one device the reference threads it only into ring and
Ulysses attention.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from singa_tpu_torch import autograd, layer, model
from singa_tpu_torch.ops import flash_attention as fa

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "Bert", "BertForClassification",
           "bert_base", "bert_small", "collect_moe_aux"]


def refuse_distributed(seq_axis=None, tp_axis=None, ring_flash=False,
                       seq_impl="ring", moe_experts=None, moe_axis=None):
    """Raise on the options of the distributed slice, naming the ROADMAP
    items that port them, and on an unknown `seq_impl`."""
    if seq_impl not in ("ring", "ulysses"):
        raise ValueError(f"seq_impl must be 'ring' or 'ulysses', "
                         f"got {seq_impl!r}")
    for name, val in (("seq_axis", seq_axis), ("tp_axis", tp_axis),
                      ("ring_flash", ring_flash or None),
                      ("seq_impl", None if seq_impl == "ring" else seq_impl)):
        if val is not None:
            raise NotImplementedError(
                f"{name}= belongs to the distributed slice (ROADMAP queue 1 "
                f"items 14-15)")
    for name, val in (("moe_experts", moe_experts), ("moe_axis", moe_axis)):
        if val is not None:
            raise NotImplementedError(
                f"{name}= is the Switch MoE FFN (ROADMAP queue 1 item 15)")


def collect_moe_aux(root: nn.Module):
    """The load-balance auxiliary losses the MoE FFNs under `root`
    recorded in the last forward. The port has no MoE FFN yet (ROADMAP
    queue 1 item 15), so a dense model gives []."""
    return [m.aux for m in root.modules()
            if isinstance(getattr(m, "aux", None), torch.Tensor)]


class MultiHeadAttention(nn.Module):
    """Self-attention with a fused QKV projection; `forward(x, mask)`
    with x (B, T, d) and an optional mask broadcastable to
    (B, H, T, T), True where a query may attend a key."""

    def __init__(self, num_heads: int, causal: bool = False,
                 seq_axis: Optional[str] = None, remat: bool = False,
                 bias: bool = True, ring_flash: bool = False,
                 tp_axis: Optional[str] = None, seq_impl: str = "ring", *,
                 d_model: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        refuse_distributed(seq_axis, tp_axis, ring_flash, seq_impl)
        if d_model % num_heads:
            raise ValueError(
                f"d_model {d_model} not divisible by {num_heads}")
        dev, gen = layer._setup(device, generator)
        self.num_heads, self.causal, self.remat = num_heads, causal, remat
        k = 1.0 / math.sqrt(d_model)
        d = d_model
        self.w_qkv = layer._new((d, 3 * d), dev, gen, "uniform", k)
        self.w_o = layer._new((d, d), dev, gen, "uniform", k)
        self.b_qkv = layer._new((3 * d,), dev, gen, "uniform", k) if (
            bias) else None
        self.b_o = layer._new((d,), dev, gen, "uniform", k) if bias else None

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        if mask is not None:
            mask = torch.as_tensor(mask, device=x.device)
        qkv = autograd.linear(x, self.w_qkv, self.b_qkv)  # (B, T, 3d)
        if mask is not None:  # no ONNX decomposition: a trace raises
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


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder block (the BERT convention): MHA + Add&LN, then
    the dense GELU FFN + Add&LN."""

    def __init__(self, num_heads: int, ffn_mult: int = 4,
                 dropout: float = 0.1, causal: bool = False,
                 seq_axis: Optional[str] = None, remat: bool = False,
                 ring_flash: bool = False, tp_axis: Optional[str] = None,
                 seq_impl: str = "ring", moe_experts: Optional[int] = None,
                 moe_axis: Optional[str] = None,
                 moe_capacity_factor: float = 1.25, *, d_model: int,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        del moe_capacity_factor
        refuse_distributed(moe_experts=moe_experts, moe_axis=moe_axis)
        dev, gen = layer._setup(device, generator)
        self.attn = MultiHeadAttention(
            num_heads, causal=causal, seq_axis=seq_axis, remat=remat,
            ring_flash=ring_flash, tp_axis=tp_axis, seq_impl=seq_impl,
            d_model=d_model, device=dev, generator=gen)
        self.ln1 = layer.LayerNorm(dim=d_model, device=dev)
        self.ln2 = layer.LayerNorm(dim=d_model, device=dev)
        self.drop1 = layer.Dropout(dropout)
        self.drop2 = layer.Dropout(dropout)
        self.fc1 = layer.Linear(ffn_mult * d_model, in_features=d_model,
                                device=dev, generator=gen)
        self.gelu = layer.Gelu()
        self.fc2 = layer.Linear(d_model, in_features=ffn_mult * d_model,
                                device=dev, generator=gen)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        a = self.drop1(self.attn(x, mask))
        x = self.ln1(autograd.add(x, a))
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

    @property
    def device(self) -> torch.device:
        return self.tok.table.device

    def forward(self, ids, seg_ids=None, mask=None):
        ids = torch.as_tensor(ids, device=self.device).long()
        t = ids.shape[-1]
        emb = autograd.add(self.tok(ids),
                           self.pos(torch.arange(t, device=ids.device)))
        if seg_ids is not None:
            emb = autograd.add(emb, self.seg(
                torch.as_tensor(seg_ids, device=ids.device).long()))
        x = self.encoder(self.drop(self.ln(emb)), mask)
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
