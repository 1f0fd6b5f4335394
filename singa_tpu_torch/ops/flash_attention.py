"""Flash attention, forward (counterpart of singa_tpu/ops/flash_attention.py).

One hand-written CUDA kernel (`csrc/flash_fwd.cu`) replaces both forward
Pallas kernels of the reference, the head-split `_fwd_kernel` and the
fused-layout `_fwd_kernel_qkv`: it takes (batch, head, time) strides, so
`flash_attention_qkv` hands it per-head views into the fused (B, T, 3d)
projection and a (B, T, d) output, with no copy or transpose.

Beside the kernel's wrapper (`_flash_fwd`) live its plain PyTorch version
(`_flash_fwd_plain`, the same function computed with whole-row softmax)
and its launch count (`FLASH_FWD_LAUNCHES`). The wrapper runs the plain
version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.

Deviations from the reference, on purpose:

- `mxu_bf16` defaults to False on every device. The TPU kernel defaulted
  to True only to match XLA's bf16-pass fp32 dots on that chip; an fp32
  product on the H100 (TF32 off) is full fp32, so the port's fp32 path is
  fp32 throughout. `mxu_bf16=True` still rounds q, k, v and p to bf16
  before each product, with fp32 accumulation.
- The fused layout takes any number of heads: per-head strides work for
  every H on Hopper, so the reference's head groups (`_qkv_group`) and its
  even-H refusal, both from the TPU's 128-lane tiling, are gone.
  `attention_qkv` equals the reference's output for every H.
- The TPU block sizes and `interpret` have no counterpart.
- Forward only: the backward kernels land with the training slice, so the
  wrapper refuses CUDA tensors that require grad.

The dispatch thresholds are the reference's values (set on a TPU v5e), so
the port routes exactly the cases the reference routes.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from singa_tpu_torch.parallel.ring import full_attention

__all__ = ["flash_attention", "flash_attention_qkv", "attention",
           "attention_qkv", "flash_enabled", "set_flash_enabled"]

_NEG = -1e30  # matches parallel/ring.py
_HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the CUDA kernel, bumped by `_flash_fwd` once per launch
FLASH_FWD_LAUNCHES = 0

_flash = {"enabled": True}


def set_flash_enabled(enabled: bool) -> None:
    """Process-global switch for the kernel path of the dispatchers."""
    _flash["enabled"] = bool(enabled)


def flash_enabled() -> bool:
    return _flash["enabled"]


def _flash_fwd_plain(q, k, v, causal: bool, scale: float,
                     mxu_bf16: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: q (B,H,Tq,D), k/v
    (B,H,Tk,D) -> O (B,H,Tq,D) in q's dtype and lse (B,H,Tq) fp32."""

    def op(x):
        x = x.float()
        return x.to(torch.bfloat16).float() if mxu_bf16 else x

    s = torch.einsum("bhqd,bhkd->bhqk", op(q), op(k)) * scale
    tq, tk = s.shape[-2], s.shape[-1]
    allowed = None
    if causal:
        allowed = torch.ones(tq, tk, dtype=torch.bool,
                             device=s.device).tril(tk - tq)
        s = s.masked_fill(~allowed, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if allowed is not None:
        p = p.masked_fill(~allowed, 0.0)  # masked p is an exact 0
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", op(p), op(v)) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float]
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    from singa_tpu_torch.ops import _build

    lib = _build.load("flash_fwd")
    lib.flash_fwd.argtypes = _ARGTYPES
    lib.flash_fwd.restype = ctypes.c_int
    lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, o):
    for name, x in (("q", q), ("k", k), ("v", v), ("o", o)):
        if x.dim() != 4:
            raise ValueError(f"{name} must be (B, H, T, D), got {x.shape}")
        if x.dtype not in _DTYPES or x.dtype != q.dtype:
            raise TypeError(
                f"{name} is {x.dtype}; the kernel takes float32 or bfloat16, "
                f"the same for q, k, v and o (q is {q.dtype})")
        if x.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dim, got "
                             f"strides {x.stride()}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    b, h, tq, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; the kernel is "
                         f"built for {_HEAD_DIMS}")
    if k.shape[:2] != (b, h) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if o.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} must be q's shape "
                         f"{tuple(q.shape)}")


def _flash_fwd(q, k, v, o, causal: bool, scale: float,
               mxu_bf16: bool) -> torch.Tensor:
    """Attention of q (B,H,Tq,D) over k/v (B,H,Tk,D), any (batch, head,
    time) strides, written into `o` (q's shape and dtype); returns lse
    (B,H,Tq) fp32. CUDA tensors launch the kernel; CPU tensors run
    `_flash_fwd_plain`."""
    global FLASH_FWD_LAUNCHES
    _check(q, k, v, o)
    if q.device.type == "cpu":
        out, lse = _flash_fwd_plain(q, k, v, causal, scale, mxu_bf16)
        o.copy_(out)
        return lse
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash attention on CUDA is forward-only: the backward kernel "
            "lands with the training slice (run under torch.no_grad() or "
            "torch.inference_mode())")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 15)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        *lse.stride())
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, tq, tk, d, strides, float(scale),
            int(bool(causal)), int(bool(mxu_bf16)), _DTYPES[q.dtype],
            stream)
    if err:
        raise RuntimeError(
            f"flash_fwd launch failed: "
            f"{lib.flash_fwd_error_string(err).decode()} (cudaError {err})")
    FLASH_FWD_LAUNCHES += 1
    return lse


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, mxu_bf16: bool = False,
                    return_lse: bool = False):
    """Fused attention. q (B,H,Tq,D), k/v (B,H,Tk,D) -> (B,H,Tq,D); with
    `return_lse=True` also the logsumexp rows (B,H,Tq) fp32."""
    if q.dim() != 4:
        raise ValueError(f"expected (B, H, T, D), got {tuple(q.shape)}")
    scale = float(scale) if scale is not None else float(q.shape[-1]) ** -0.5
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = _flash_fwd(q, k, v, o, causal, scale, mxu_bf16)
    return (o, lse) if return_lse else o


def _split_qkv(qkv: torch.Tensor, num_heads: int):
    """Per-head (B,H,T,hd) views of q, k, v inside the fused (B,T,3d)."""
    b, t, d3 = qkv.shape
    hd = d3 // (3 * num_heads)
    parts = qkv.view(b, t, 3, num_heads, hd)
    return tuple(parts[:, :, i].permute(0, 2, 1, 3) for i in range(3))


def flash_attention_qkv(qkv, num_heads: int, causal: bool = False,
                        scale: Optional[float] = None,
                        mxu_bf16: bool = False) -> torch.Tensor:
    """Flash attention over the FUSED projection: qkv (B, T, 3d), the
    direct output of `x @ w_qkv + b`, returns the merged-head context
    (B, T, d). Self-attention only (Tq == Tk)."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"expected (B, T, 3*H*hd) with H={num_heads}, "
                         f"got {tuple(qkv.shape)}")
    if qkv.stride(-1) != 1:
        raise ValueError("qkv needs a contiguous last dim")
    b, t, d3 = qkv.shape
    d = d3 // 3
    hd = d // num_heads
    scale = float(scale) if scale is not None else float(hd) ** -0.5
    q, k, v = _split_qkv(qkv, num_heads)
    out = torch.empty((b, t, d), dtype=qkv.dtype, device=qkv.device)
    o = out.view(b, t, num_heads, hd).permute(0, 2, 1, 3)
    _flash_fwd(q, k, v, o, causal, scale, mxu_bf16)
    return out


#: minimum sequence length at which `attention` picks the flash kernel,
#: per attention kind: the reference's values, measured on a TPU v5e (see
#: singa_tpu/ops/flash_attention.py); re-tuning for the H100 is queued.
FLASH_MIN_SEQ = 1024
FLASH_MIN_SEQ_CAUSAL = 256


def attention(q, k, v, causal: bool = False, scale: Optional[float] = None,
              mask=None):
    """Dispatcher: the flash kernel when it covers the case (no arbitrary
    mask) and the sequence clears the threshold, else `full_attention`."""
    min_seq = FLASH_MIN_SEQ_CAUSAL if causal else FLASH_MIN_SEQ
    if mask is None and flash_enabled() and q.shape[-2] >= min_seq:
        return flash_attention(q, k, v, causal=causal, scale=scale)
    return full_attention(q, k, v, causal=causal, scale=scale, mask=mask)


#: minimum sequence length at which `attention_qkv` picks the fused-layout
#: kernel over the split-heads path: the reference's values.
FUSED_QKV_MIN_SEQ = 512
FUSED_QKV_MIN_SEQ_CAUSAL = 256


def attention_qkv(qkv, num_heads: int, causal: bool = False,
                  scale: Optional[float] = None, mask=None):
    """Dispatcher over the FUSED projection layout: qkv (B, T, 3d) in,
    merged-head context (B, T, d) out. The fused-layout kernel for any H
    once the sequence clears the threshold; otherwise heads are split and
    the plain `attention` dispatcher decides."""
    b, t, d3 = qkv.shape
    d = d3 // 3
    min_seq = FUSED_QKV_MIN_SEQ_CAUSAL if causal else FUSED_QKV_MIN_SEQ
    if mask is None and flash_enabled() and t >= min_seq:
        return flash_attention_qkv(qkv, num_heads, causal=causal,
                                   scale=scale)
    q, k, v = _split_qkv(qkv, num_heads)
    o = attention(q, k, v, causal=causal, scale=scale, mask=mask)
    return o.permute(0, 2, 1, 3).reshape(b, t, d)
