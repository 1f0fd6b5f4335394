"""GPT-style causal decoder (counterpart of singa_tpu/models/gpt.py).

Inference only in this slice, for the reference's scanned decoder
(`scan_blocks=True`, `dropout=0.0`, as `gpt_medium` builds it):

- `forward(ids)` scores full sequences; every block's attention goes
  through `attention_qkv`, so from T = 256 on it runs the fused-layout
  flash kernel once per block.
- `generate(prompt, n_new, window, temperature, seed)` decodes as the
  reference does: a prefill fills a per-layer K/V cache, each new token
  is one cached step while the sequence fits the window (left-aligned
  positions, right pads never attended), then the window slides by
  full-window recomputes (a slide moves every learned position). The
  reference compiles this into one executable; here it is a Python loop
  over a preallocated (L, B, H, W, hd) cache written in place. Its
  attention is the plain `full_attention`, as in the reference. Greedy
  picks are `argmax` (first maximum), as `jnp.argmax`; sampling draws
  from a `torch.Generator` seeded with `seed`, which cannot reproduce
  `jax.random`'s bits.

Other constructor options raise `NotImplementedError` naming the ROADMAP
item that ports them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from singa_tpu_torch import layer, model
from singa_tpu_torch.parallel.ring import full_attention

__all__ = ["GPT", "gpt_medium"]


class GPT(model.Model):
    """Causal decoder LM over a `ScanTransformerStack`."""

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
        del ring_flash, seq_impl, moe_aux_coef, moe_capacity_factor, pp_micro
        if not scan_blocks:
            raise NotImplementedError(
                "GPT(scan_blocks=False) is the unrolled TransformerEncoder "
                "decoder (ROADMAP queue 1 item 9.4); pass scan_blocks=True")
        if remat:
            raise NotImplementedError(
                "GPT(remat=True) is the unrolled decoder's checkpointing "
                "(ROADMAP queue 1 item 9.4)")
        for name, val in (("seq_axis", seq_axis), ("tp_axis", tp_axis),
                          ("moe_experts", moe_experts),
                          ("moe_axis", moe_axis), ("pp_axis", pp_axis)):
            if val is not None:
                raise NotImplementedError(
                    f"GPT({name}=) belongs to the distributed slice "
                    f"(ROADMAP queue 1 items 14-15)")
        if dropout:
            raise NotImplementedError(
                "GPT(scan_blocks=True) has no per-block dropout; pass "
                "dropout=0.0 (as the reference requires)")
        dev, gen = layer._setup(device, generator)
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.tok = layer.Embedding(vocab_size, d_model, device=dev,
                                   generator=gen)
        self.pos = layer.Embedding(max_len, d_model, device=dev,
                                   generator=gen)
        self.drop = layer.Dropout(dropout)
        self.decoder = layer.ScanTransformerStack(
            num_layers, num_heads, d_model, causal=True, remat=remat_policy,
            zero3_axis=zero3_axis, overlap=overlap, device=dev,
            generator=gen)
        self.ln_f = layer.LayerNorm(d_model, device=dev)
        self.head = layer.Linear(d_model, vocab_size, device=dev,
                                 generator=gen)
        self._decode_cache = None

    @property
    def device(self) -> torch.device:
        return self.tok.table.device

    def forward(self, ids) -> torch.Tensor:
        """ids (B, T) int -> logits (B, T, V)."""
        ids = torch.as_tensor(ids, device=self.device).long()
        t = ids.shape[-1]
        h = self.tok(ids) + self.pos(torch.arange(t, device=ids.device))
        h = self.drop(h)
        h = self.decoder(h)
        return self.head(self.ln_f(h))

    # -- incremental decoding ---------------------------------------------

    def _functional_params(self):
        dec = self.decoder
        stacked = dict(
            wqkv=dec.w_qkv, bqkv=dec.b_qkv, wo=dec.w_o, bo=dec.b_o,
            ln1_s=dec.ln1_s, ln1_o=dec.ln1_o, ln2_s=dec.ln2_s,
            ln2_o=dec.ln2_o, w1=dec.w1, b1=dec.b1, w2=dec.w2, b2=dec.b2)
        # block i's parameters are the i-th slice of every stacked weight
        blocks = [{k: v.detach()[i] for k, v in stacked.items()}
                  for i in range(dec.n_blocks)]
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

        def decode_loop(pv, buf, gen, temperature, *, t0, n_grow,
                        n_slide, sampling):
            """Fill buf (B, t0+n) past the prompt in [0, t0): n_grow
            cached steps, then n_slide full-window recomputes."""

            def pick(logits):
                if sampling:
                    probs = torch.softmax(logits.float() / temperature, -1)
                    return torch.multinomial(probs, 1,
                                             generator=gen).squeeze(-1)
                return logits.argmax(dim=-1)

            if n_grow > 0:
                pad_w = max(0, window - buf.shape[1])
                ctx0 = F.pad(buf, (0, pad_w))[:, :window]
                logits, kc, vc = prefill(pv, ctx0)
                nxt = pick(logits[:, t0 - 1])
                buf[:, t0] = nxt
                for i in range(n_grow - 1):
                    pos = t0 + i
                    nxt = pick(decode_step(pv, kc, vc, nxt, pos))
                    buf[:, pos + 1] = nxt
            for i in range(n_slide):
                end = t0 + n_grow + i  # tokens produced so far
                buf[:, end] = pick(window_step(pv, buf[:, end - window:end]))
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
        del pad_id  # only the uncached loop pads
        if not use_cache:
            raise NotImplementedError(
                "generate(use_cache=False), the reference's eager "
                "debugging loop, is not ported (ROADMAP queue 1 item 9.5)")
        if window > self.pos.table.shape[0]:
            raise ValueError(
                f"window {window} exceeds max_len "
                f"{self.pos.table.shape[0]}")
        toks = np.asarray(prompt, np.int64)
        if toks.ndim == 1:
            toks = toks[None]
        if toks.size == 0:
            raise ValueError("prompt must contain at least one token")
        dev = self.device
        decode_loop = self._decode_fns(window)[3]
        t0 = toks.shape[1]
        n_grow = max(0, min(n_new, window - t0))
        n_slide = n_new - n_grow
        buf = torch.zeros((toks.shape[0], t0 + n_new), dtype=torch.long,
                          device=dev)
        buf[:, :t0] = torch.from_numpy(toks).to(dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        out = decode_loop(self._functional_params(), buf, gen,
                          max(temperature, 1e-6), t0=t0, n_grow=n_grow,
                          n_slide=n_slide, sampling=temperature > 0)
        return out.cpu().numpy().astype(np.int32)


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
