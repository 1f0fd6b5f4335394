"""GPT-style causal decoder (counterpart of singa_tpu/models/gpt.py).

Two decoders, as in the reference: by default (`scan_blocks=False`) the
unrolled `TransformerEncoder(causal=True)` of `models/transformer.py`,
with per-block dropout; with `scan_blocks=True` (and `dropout=0.0`, as
`gpt_medium` builds it) a `ScanTransformerStack` over stacked weights.
Both compute the same function of the same weights (`unstack_params`
renames the stacked ones). For either:

- `forward(ids)` scores full sequences; every block's attention goes
  through `attention_qkv`, so from T = 256 on it runs the fused-layout
  flash kernel once per block.
- `train_one_batch(x, y)` is the reference's next-token step: mean
  cross-entropy over every position, then the optimizer's backward and
  update. The backward runs the flash backward kernels once per block.
- `generate(prompt, n_new, window, temperature, seed)` decodes as the
  reference does: a prefill fills a per-layer K/V cache, each new token
  is one cached step while the sequence fits the window (left-aligned
  positions, right pads never attended), then the window slides by
  full-window recomputes (a slide moves every learned position). The
  reference compiles this into one executable; here it is a Python loop
  over a preallocated (L, B, H, W, hd) cache written in place. Its
  attention is the plain `full_attention`, as in the reference. Tokens
  are picked by `pick_rows`, which the serving engine shares: greedy is
  `argmax` (first maximum), as `jnp.argmax`; sampling is Gumbel-max
  over counter-based noise, an integer hash of (seed, index of the
  generated token, vocab id), so a row's sample depends only on its
  seed, its index and its logits, never on the rest of the batch (the
  counterpart of the reference's `fold_in(key, i)`, without
  `jax.random`'s bits).
- `generate(..., use_cache=False)` is the reference's eager debugging
  loop: a full forward per token over the last `window` tokens, short
  contexts left-padded with `pad_id` (attended, as in the reference, so
  it equals the cached path only once the context fills the window),
  picked on the host with numpy's generator seeded with `seed`, as the
  reference's is.

Sequence parallelism, as in the reference: with `seq_axis` naming a
mesh axis, inside that axis's context (a distributed step over a mesh
that has it) each rank holds a T/world shard of the tokens, the
positions are offset by the shard's index times T_local, and the
blocks' attention runs over the global sequence. The unrolled decoder's
attention is ring attention (`ring_flash=True`: each block through the
head-split flash kernels) or, with `seq_impl="ulysses"`, Ulysses'
all-to-all; `remat=True` reaches the ring's block update and Ulysses'
attention. The scanned stack runs the plain ring, pipelined with
`overlap=True`. `seq_sharded_args = (0, 1)`: x and y of
`train_one_batch` and ids of `forward` are cut along dim 1.

Tensor parallelism (reference :103-170): `tp_axis` reaches either
decoder (the scanned stack's head-interleaved blocks, or the unrolled
blocks' head-parallel attention and col/row FFN); `seq_axis` on a
distinct axis composes with it. Cached decoding of a scanned tp stack
gathers its blocks (when placed on a mesh) and de-interleaves the QKV
on the host (reference :270-282); that of an unrolled tp GPT raises, as
the reference's does.

ZeRO-3 (reference :90-103): `zero3_axis` (with `scan_blocks=True`)
shards the scanned stack's weights and slots over that axis, each
block gathered as it runs; `overlap=True` prefetches the next block's
gather (`layer.ScanTransformerStack`). Cached decoding of a ZeRO-3 stack
gathers its blocks first. The unrolled decoder refuses both.

The Switch MoE FFN (reference :66-69, :84-86, :191-195): `moe_experts`
on the unrolled decoder replaces each block's FFN by a `layer.MoEFFN`,
expert-parallel over `moe_axis`; `train_one_batch` adds `moe_aux_coef`
times each block's load-balance loss. The scanned decoder refuses
`moe_experts`, and cached decoding of a MoE GPT raises, as the
reference's do.

Pipeline parallelism (reference :118-159): `pp_axis` makes the decoder
a `layer.PipelineTransformerStack` whose stacked blocks shard over that
axis, `pp_micro` microbatches streaming through the stages in a
distributed step over a (data, pipe) mesh (GPipe); outside the axis the
same blocks run in a loop. It composes with plain data parallelism only:
with `scan_blocks=True` it raises the scanned stack's refusal, with
`seq_axis`, `tp_axis` or `moe_experts` it raises, and so does dropout,
as the reference's do. Cached decoding of a pipelined GPT raises,
pointing at the serving path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from singa_tpu_torch import autograd, layer, model
from singa_tpu_torch.models.transformer import (TransformerEncoder,
                                               refuse_distributed)
from singa_tpu_torch.parallel import mesh as mesh_module
from singa_tpu_torch.parallel.ring import full_attention

__all__ = ["GPT", "gpt_medium", "gpt_draft", "gpt_small", "pick_rows",
           "gumbel_noise", "uniform_noise", "fold_seed", "unstack_params"]

#: a stacked `ScanTransformerStack` weight -> its name in an unrolled
#: block (`decoder.blocks.{i}.<name>`)
_BLOCK_NAMES = dict(
    w_qkv="attn.w_qkv", b_qkv="attn.b_qkv", w_o="attn.w_o", b_o="attn.b_o",
    ln1_s="ln1.scale", ln1_o="ln1.offset", ln2_s="ln2.scale",
    ln2_o="ln2.offset", w1="fc1.W", b1="fc1.b", w2="fc2.W", b2="fc2.b")
#: the decode functions' key of each stacked weight
_DECODE_KEYS = dict(
    wqkv="w_qkv", bqkv="b_qkv", wo="w_o", bo="b_o", ln1_s="ln1_s",
    ln1_o="ln1_o", ln2_s="ln2_s", ln2_o="ln2_o", w1="w1", b1="b1", w2="w2",
    b2="b2")


def unstack_params(params):
    """A scanned GPT's parameters {name: array} under the unrolled
    decoder's names: the i-th slice of each stacked `decoder.<w>` becomes
    `decoder.blocks.{i}.<attr>.<p>`; other names pass through. The two
    models then compute the same function."""
    out = {}
    for name, a in params.items():
        leaf = name[len("decoder."):] if name.startswith("decoder.") else None
        if leaf not in _BLOCK_NAMES:
            out[name] = a
            continue
        for i in range(len(a)):
            out[f"decoder.blocks.{i}.{_BLOCK_NAMES[leaf]}"] = a[i]
    return out

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """An integer hash of 32-bit values held in int64 (lowbias32's
    shape; both multipliers are below 2**31, so no product leaves
    int64)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def fold_seed(seeds: torch.Tensor, domain: int) -> torch.Tensor:
    """Seeds of a separate random stream: each seed hashed with a
    `domain` constant (the speculative engine's draft, acceptance and
    residual streams), so no draw of one stream repeats another's."""
    return _mix32((seeds.long() & _M32) ^ domain)


def _unit(u: torch.Tensor) -> torch.Tensor:
    """24 bits of a hash, centred in its interval: strictly in (0, 1)."""
    return ((u >> 8).float() + 0.5) * (1.0 / (1 << 24))


def _key(seeds: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    return _mix32(_mix32(seeds.long() & _M32) ^ (index.long() & _M32))


def gumbel_noise(seeds: torch.Tensor, index: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """Gumbel noise (S, vocab) in fp32, a function of each row's
    (seed, index) and the vocab id alone."""
    h = _key(seeds, index)
    ids = torch.arange(vocab, device=seeds.device)
    u = _mix32((_mix32(h[:, None] ^ ids[None, :]) + 0x632BE5AB) & _M32)
    return -torch.log(-torch.log(_unit(u)))


def uniform_noise(seeds: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """One uniform in (0, 1) per (seed, index) pair, fp32: seeds (S,)
    against index (S, K)."""
    return _unit(_mix32((_key(seeds[:, None], index) + 0x2545F491) & _M32))


def pick_rows(logits: torch.Tensor, seeds: torch.Tensor,
              index: torch.Tensor, temps: torch.Tensor,
              sample: torch.Tensor) -> torch.Tensor:
    """Per-row token pick for logits (S, V): `argmax` where `sample` is
    False, else the Gumbel-max sample at temperature `temps` from the
    noise of (seeds, index). Plain tensor ops with no host sync, so a
    captured decode step replays it per slot."""
    greedy = logits.argmax(dim=-1)
    g = gumbel_noise(seeds, index, logits.shape[-1])
    drawn = (logits.float() / temps[:, None] + g).argmax(dim=-1)
    return torch.where(sample, drawn, greedy)


class GPT(model.Model):
    """Causal decoder LM over a `TransformerEncoder(causal=True)` or,
    with `scan_blocks=True`, a `ScanTransformerStack`."""

    def __init__(
        self,
        vocab_size: int = 50257,
        d_model: int = 768,
        num_layers: int = 12,
        num_heads: int = 12,
        max_len: int = 1024,
        dropout: float = 0.1,
        seq_axis: Optional[str] = None,
        remat: bool = False,
        ring_flash: bool = False,
        seq_impl: str = "ring",
        tp_axis: Optional[str] = None,
        moe_experts: Optional[int] = None,
        moe_axis: Optional[str] = None,
        moe_aux_coef: float = 0.01,
        moe_capacity_factor: float = 1.25,
        pp_axis: Optional[str] = None,
        pp_micro: int = 4,
        scan_blocks: bool = False,
        remat_policy: str = "none",
        zero3_axis: Optional[str] = None,
        overlap: bool = False,
        *,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        refuse_distributed(seq_impl)
        if not scan_blocks and (zero3_axis is not None or overlap):
            raise NotImplementedError(
                "GPT(zero3_axis=) and GPT(overlap=) belong to the scanned "
                "stack; pass scan_blocks=True: the unrolled decoder has no "
                "stacked (L, ...) weights to shard or loop to pipeline")
        if scan_blocks and (moe_experts is not None or pp_axis is not None):
            raise NotImplementedError(
                "GPT(scan_blocks=True) composes with data parallelism "
                "(ZeRO-1/ZeRO-3), tensor parallelism (tp_axis=) and ring "
                "sequence parallelism (seq_axis=) on distinct mesh axes; "
                "moe_experts/pp_axis rewire the block body the scanned "
                "stack re-implements")
        if scan_blocks and dropout:
            raise NotImplementedError(
                "GPT(scan_blocks=True) has no per-block dropout; pass "
                "dropout=0.0 (as the reference requires)")
        if pp_axis is not None and not scan_blocks:
            if any(v is not None for v in (seq_axis, tp_axis, moe_experts)):
                raise NotImplementedError(
                    "GPT(pp_axis=) composes with plain data parallelism "
                    "only for now; seq_axis/tp_axis/moe_experts rewire the "
                    "block body the pipelined stack re-implements")
            if dropout:
                raise NotImplementedError(
                    "GPT(pp_axis=) has no per-block dropout (the pipelined "
                    "stack keeps its blocks deterministic so pipelined == "
                    "single-device holds step for step); pass dropout=0.0")
        dev, gen = layer._setup(device, generator)
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.seq_axis, self.tp_axis = seq_axis, tp_axis
        self.moe_axis, self.moe_aux_coef = moe_axis, moe_aux_coef
        #: the distributed step's token arguments (dim 1 is T): x and y
        #: of train_one_batch, ids of forward
        self.seq_sharded_args = (0, 1)
        self.tok = layer.Embedding(vocab_size, d_model, device=dev,
                                   generator=gen)
        self.pos = layer.Embedding(max_len, d_model, device=dev,
                                   generator=gen)
        self.drop = layer.Dropout(dropout)
        if scan_blocks:
            self.decoder = layer.ScanTransformerStack(
                num_layers, num_heads, causal=True, remat=remat_policy,
                tp_axis=tp_axis, zero3_axis=zero3_axis, seq_axis=seq_axis,
                overlap=overlap, d_model=d_model,
                device=dev, generator=gen)
        elif pp_axis is not None:
            self.decoder = layer.PipelineTransformerStack(
                num_layers, num_heads, causal=True, pipe_axis=pp_axis,
                n_micro=pp_micro, d_model=d_model, device=dev,
                generator=gen)
        else:
            self.decoder = TransformerEncoder(
                num_layers, num_heads, dropout=dropout, causal=True,
                seq_axis=seq_axis, remat=remat, ring_flash=ring_flash,
                seq_impl=seq_impl, tp_axis=tp_axis, moe_experts=moe_experts,
                moe_axis=moe_axis, moe_capacity_factor=moe_capacity_factor,
                d_model=d_model, device=dev, generator=gen)
        self.ln_f = layer.LayerNorm(dim=d_model, device=dev)
        self.head = layer.Linear(vocab_size, in_features=d_model,
                                 device=dev, generator=gen)
        self._decode_cache = None

    @property
    def device(self) -> torch.device:
        return self.tok.table.device

    def forward(self, ids) -> torch.Tensor:
        """ids (B, T) int -> logits (B, T, V)."""
        ids = torch.as_tensor(ids, device=self.device).long()
        t = ids.shape[-1]
        # positions: offset by this rank's shard under sequence parallel
        off = mesh_module.axis_index(self.seq_axis) * t if (
            self.seq_axis is not None
            and mesh_module.in_axis(self.seq_axis)) else 0
        h = autograd.add(self.tok(ids), self.pos(
            torch.arange(off, off + t, device=ids.device)))
        h = self.drop(h)
        h = self.decoder(h)
        return self.head(self.ln_f(h))

    def train_one_batch(self, x, y, dist_option: str = "plain",
                        spars=None):
        """Next-token LM step: mean cross-entropy over every position,
        then the optimizer. x, y (B, T) int; returns (logits, loss)."""
        logits = self.forward(x)
        flat = logits.reshape(-1, self.vocab_size)
        y = torch.as_tensor(y, device=flat.device).reshape(-1)
        loss = autograd.softmax_cross_entropy(flat, y)
        if self.moe_aux_coef:
            from singa_tpu_torch.models.transformer import collect_moe_aux

            for aux in collect_moe_aux(self):
                loss = loss + aux * self.moe_aux_coef
        self._apply_opt(loss, dist_option, spars)
        return logits, loss

    # -- incremental decoding ---------------------------------------------

    def _ensure_initialized(self, window: int) -> None:
        """The reference materializes its lazy layers here with one
        forward before decoding. The port builds every parameter in the
        constructor, so there is nothing to materialize; the serving
        engine calls this as it calls the reference's. A pipelined GPT
        refuses, as the reference's does (reference :226-233)."""
        del window
        if isinstance(self.decoder, layer.PipelineTransformerStack):
            raise NotImplementedError(
                "cached decoding needs per-block parameter handles; "
                "pipeline-parallel GPTs are not supported — generate (or "
                "build a serving.ServingEngine) on an unrolled (default) or "
                "scan_blocks=True model; a pp-trained model's states load "
                "into either (the stacked weights under "
                "models.gpt.unstack_params' names for the unrolled one)")

    def _functional_params(self):
        """The decode functions' parameters: full arrays (a placed
        tensor-parallel stack's blocks gathered, a collective on every
        rank of its mesh), the stacked QKV of a tp stack de-interleaved
        into [q | k | v]."""
        from singa_tpu_torch.distributed import gather_full

        dec = self.decoder
        if isinstance(dec, layer.ScanTransformerStack):
            stacked = {k: gather_full(getattr(dec, n)).detach()
                       for k, n in _DECODE_KEYS.items()}
            if dec.tp_axis is not None:
                from singa_tpu_torch.parallel import tp as tp_module

                for k in ("wqkv", "bqkv"):
                    stacked[k] = tp_module.deinterleave_qkv_shards(
                        stacked[k], dec.num_heads)
            # block i's parameters: the i-th slice of each stacked weight
            blocks = [{k: v[i] for k, v in stacked.items()}
                      for i in range(dec.n_blocks)]
        elif any(getattr(b.attn, "tp_axis", None) or getattr(b, "tp_axis",
                                                             None)
                 for b in dec.blocks):
            raise NotImplementedError(
                "cached decoding of a tensor-parallel GPT is not supported; "
                "generate on the single-device model")
        elif any(b.moe_experts is not None for b in dec.blocks):
            raise NotImplementedError(
                "cached decoding of a MoE GPT is not supported yet; the "
                "decode functions assume dense FFN blocks")
        else:
            blocks = [{k: blk.get_parameter(_BLOCK_NAMES[n]).detach()
                       for k, n in _DECODE_KEYS.items()}
                      for blk in dec.blocks]
        return dict(
            tok=self.tok.table.detach(), pos=self.pos.table.detach(),
            lnf_s=self.ln_f.scale.detach(), lnf_o=self.ln_f.offset.detach(),
            head_w=self.head.W.detach(), head_b=self.head.b.detach(),
            blocks=blocks)

    @staticmethod
    def _ln(x, s, o, eps=1e-5):
        xf = x.float()
        m = xf.mean(dim=-1, keepdim=True)
        v = xf.var(dim=-1, keepdim=True, correction=0)
        return (xf - m) * torch.rsqrt(v + eps) * s + o

    def _build_decode(self, window: int):
        """Build (prefill, decode_step, window_step, decode_loop)."""
        heads = self.decoder.num_heads
        d = self.d_model
        hd = d // heads
        scale = hd ** -0.5
        ln = self._ln

        def ffn(h, bp):
            f = F.gelu(h @ bp["w1"] + bp["b1"], approximate="tanh")
            return f @ bp["w2"] + bp["b2"]

        def prefill(pv, ctx):
            """ctx (B, W) int; returns (logits (B, W, V), kc, vc) with
            kc/vc (L, B, H, W, hd). Rows past the real prompt length hold
            values the position-based masks never attend."""
            b = ctx.shape[0]
            h = pv["tok"][ctx] + pv["pos"][:window]
            kc = torch.empty((len(pv["blocks"]), b, heads, window, hd),
                             dtype=h.dtype, device=h.device)
            vc = torch.empty_like(kc)
            for i, bp in enumerate(pv["blocks"]):
                qkv = h @ bp["wqkv"] + bp["bqkv"]
                q, k, v = (a.reshape(b, window, heads, hd).transpose(1, 2)
                           for a in qkv.chunk(3, dim=-1))
                kc[i] = k
                vc[i] = v
                o = full_attention(q, k, v, causal=True, scale=scale)
                o = o.transpose(1, 2).reshape(b, window, d)
                a = o @ bp["wo"] + bp["bo"]
                h = ln(h + a, bp["ln1_s"], bp["ln1_o"])
                h = ln(h + ffn(h, bp), bp["ln2_s"], bp["ln2_o"])
            hf = ln(h, pv["lnf_s"], pv["lnf_o"])
            return hf @ pv["head_w"] + pv["head_b"], kc, vc

        def decode_step(pv, kc, vc, tok, pos: int):
            """tok (B,) int, pos the slot tok occupies. Writes its K/V
            into the cache in place and attends cached positions <= pos."""
            b = tok.shape[0]
            h = pv["tok"][tok] + pv["pos"][pos]  # (B, d)
            live = (torch.arange(window, device=h.device) <= pos)[None, None]
            for i, bp in enumerate(pv["blocks"]):
                qkv = h @ bp["wqkv"] + bp["bqkv"]
                q, k, v = (a.reshape(b, heads, hd)
                           for a in qkv.chunk(3, dim=-1))
                kc[i, :, :, pos] = k
                vc[i, :, :, pos] = v
                s = torch.einsum("bhd,bhwd->bhw", q.float(),
                                 kc[i].float()) * scale
                s = s.masked_fill(~live, -1e30)
                p = torch.softmax(s, dim=-1)
                o = torch.einsum("bhw,bhwd->bhd", p, vc[i].float())
                a = o.reshape(b, d) @ bp["wo"] + bp["bo"]
                h = ln(h + a, bp["ln1_s"], bp["ln1_o"])
                h = ln(h + ffn(h, bp), bp["ln2_s"], bp["ln2_o"])
            hf = ln(h, pv["lnf_s"], pv["lnf_o"])
            return hf @ pv["head_w"] + pv["head_b"]  # (B, V)

        def window_step(pv, ctx):
            logits, _, _ = prefill(pv, ctx)
            return logits[:, -1]

        def decode_loop(pv, buf, seed, temperature, *, t0, n_grow,
                        n_slide, sampling):
            """Fill buf (B, t0+n) past the prompt in [0, t0): n_grow
            cached steps, then n_slide full-window recomputes. Every row
            samples from `seed` at the index of the token it picks."""
            b = buf.shape[0]
            seeds = torch.full((b,), seed, dtype=torch.long,
                               device=buf.device)
            temps = torch.full((b,), temperature, device=buf.device)
            smp = torch.full((b,), sampling, device=buf.device)

            def pick(logits, i):
                if not sampling:
                    return logits.argmax(dim=-1)
                return pick_rows(logits, seeds, torch.full_like(seeds, i),
                                 temps, smp)

            if n_grow > 0:
                pad_w = max(0, window - buf.shape[1])
                ctx0 = F.pad(buf, (0, pad_w))[:, :window]
                logits, kc, vc = prefill(pv, ctx0)
                nxt = pick(logits[:, t0 - 1], 0)
                buf[:, t0] = nxt
                for i in range(n_grow - 1):
                    pos = t0 + i
                    nxt = pick(decode_step(pv, kc, vc, nxt, pos), i + 1)
                    buf[:, pos + 1] = nxt
            for i in range(n_slide):
                end = t0 + n_grow + i  # tokens produced so far
                buf[:, end] = pick(window_step(pv, buf[:, end - window:end]),
                                   n_grow + i)
            return buf

        return prefill, decode_step, window_step, decode_loop

    def _decode_fns(self, window: int):
        if self._decode_cache is None or self._decode_cache[0] != window:
            self._decode_cache = (window, self._build_decode(window))
        return self._decode_cache[1]

    @torch.inference_mode()
    def generate(self, prompt, n_new: int, window: int = 64,
                 temperature: float = 0.0, pad_id: int = 0, seed: int = 0,
                 use_cache: bool = True) -> np.ndarray:
        """Autoregressive decoding from `prompt` (B, T0) int tokens;
        returns (B, T0 + n_new) int32. temperature 0 is greedy argmax;
        > 0 samples from the softmax at that temperature."""
        if window > self.pos.table.shape[0]:
            raise ValueError(
                f"window {window} exceeds max_len "
                f"{self.pos.table.shape[0]}")
        toks = np.asarray(prompt, np.int64)
        if toks.ndim == 1:
            toks = toks[None]
        if toks.size == 0:
            raise ValueError("prompt must contain at least one token")
        if not use_cache:
            return self._generate_eager(toks.astype(np.int32), n_new, window,
                                        temperature, pad_id, seed)
        self._ensure_initialized(window)
        dev = self.device
        decode_loop = self._decode_fns(window)[3]
        t0 = toks.shape[1]
        n_grow = max(0, min(n_new, window - t0))
        n_slide = n_new - n_grow
        buf = torch.zeros((toks.shape[0], t0 + n_new), dtype=torch.long,
                          device=dev)
        buf[:, :t0] = torch.from_numpy(toks).to(dev)
        out = decode_loop(self._functional_params(), buf, int(seed),
                          max(temperature, 1e-6), t0=t0, n_grow=n_grow,
                          n_slide=n_slide, sampling=temperature > 0)
        return out.cpu().numpy().astype(np.int32)

    def _generate_eager(self, toks, n_new, window, temperature, pad_id,
                        seed):
        """The reference's eager loop: per token, a full forward over the
        last `window` tokens, a short context right-aligned behind
        ATTENDED `pad_id` left-pads; the pick on the host, greedy or
        drawn by numpy's generator seeded with `seed`."""
        rng = np.random.default_rng(seed)

        def pick(logits):
            if temperature > 0:
                p = logits / temperature
                p = np.exp(p - p.max(-1, keepdims=True))
                p = p / p.sum(-1, keepdims=True)
                return np.array(
                    [rng.choice(self.vocab_size, p=row) for row in p],
                    np.int32)
            return logits.argmax(-1).astype(np.int32)

        was_training = self.training
        self.eval()
        try:
            for _ in range(n_new):
                ctx = toks[:, -window:]
                if ctx.shape[1] < window:
                    pad = np.full((ctx.shape[0], window - ctx.shape[1]),
                                  pad_id, np.int32)
                    ctx = np.concatenate([pad, ctx], axis=1)
                logits = self(torch.from_numpy(ctx))[:, -1]
                toks = np.concatenate(
                    [toks, pick(logits.float().cpu().numpy())[:, None]],
                    axis=1)
        finally:
            self.train(was_training)
        return toks


def gpt_small(**kw):
    """A small GPT for tests and demos (GPT-2 small's head count at 1/6
    of its width), the reference's `gpt_small`."""
    kw.setdefault("vocab_size", 256)
    kw.setdefault("d_model", 128)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("max_len", 256)
    return GPT(**kw)


def gpt_draft(target: Optional[GPT] = None, **kw) -> GPT:
    """A small draft GPT for speculative serving (`SpeculativeEngine`):
    d_model 64, 4 heads of hd 16, 1 block, sharing the target's
    vocabulary and max_len when `target` is given (the verify pass
    scores the draft's token ids under the target's head, so the vocab
    must match; the engine refuses otherwise). Any kwarg overrides. A
    random draft lowers acceptance, never correctness: greedy
    speculative streams equal the target's `generate` whatever the
    draft. Built with `scan_blocks=True`, as `gpt_medium` is."""
    if target is not None:
        kw.setdefault("vocab_size", target.vocab_size)
        kw.setdefault("max_len", target.pos.table.shape[0])
        kw.setdefault("device", target.device)
    kw.setdefault("vocab_size", 256)
    kw.setdefault("d_model", 64)
    kw.setdefault("num_layers", 1)
    kw.setdefault("num_heads", 4)
    kw.setdefault("max_len", 256)
    kw.setdefault("dropout", 0.0)
    kw.setdefault("scan_blocks", True)
    return GPT(**kw)


def gpt_medium(**kw) -> GPT:
    """The reference's large decoder: d_model 1024, 8 heads of hd 128,
    12 scanned blocks, vocab 32768, max_len 1024."""
    kw.setdefault("vocab_size", 32768)
    kw.setdefault("d_model", 1024)
    kw.setdefault("num_layers", 12)
    kw.setdefault("num_heads", 8)  # 1024 / 8 = head dim 128
    kw.setdefault("max_len", 1024)
    kw.setdefault("dropout", 0.0)
    kw.setdefault("scan_blocks", True)
    kw.setdefault("remat_policy", "none")
    return GPT(**kw)
