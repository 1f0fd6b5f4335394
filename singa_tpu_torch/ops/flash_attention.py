"""Flash attention, forward and backward (counterpart of
singa_tpu/ops/flash_attention.py).

Three hand-written CUDA kernels replace the reference's six Pallas
kernels:

- `csrc/flash_fwd.cu` replaces both forwards, the head-split
  `_fwd_kernel` and the fused-layout `_fwd_kernel_qkv`;
- `csrc/flash_bwd.cu` holds the dQ kernel, for `_bwd_dq_kernel` and
  `_bwd_dq_kernel_qkv`, and the dK/dV kernel, for `_bwd_dkv_kernel` and
  `_bwd_dkv_kernel_qkv`.

Each takes (batch, head, time) strides, so `flash_attention_qkv` hands
them per-head views into the fused (B, T, 3d) projection, its (B, T, d)
output and the (B, T, 3d) gradient of qkv, with no copy, transpose or
concatenation. The forward and the dK/dV kernel run on the tensor cores
and copy rows into shared memory 16 bytes at a time, so every
(B, H, T, D) operand needs 16-byte-aligned rows (pointer and strides);
`_check` refuses others with a ValueError on every device.

`flash_attention` and `flash_attention_qkv` are `torch.autograd.Function`s
(`_FlashAttention`, `_FlashAttentionQKV`), the counterparts of the
reference's custom VJPs `_core`/`_core_with_lse` and `_core_qkv`. The
forward saves what theirs saves (q, k, v or qkv, O and lse). The backward
computes `delta = rowsum(dO * O)` in fp32 with torch ops, as the
reference does outside Pallas, folds an lse cotangent in as
`delta - g_lse`, and runs the two backward kernels.

Beside each kernel's wrapper (`_flash_fwd`, `_flash_bwd`) live its plain
PyTorch version (`_flash_fwd_plain`, `_flash_bwd_plain`: the same function
with whole-row softmax) and its launch counts (`FLASH_FWD_LAUNCHES`,
`FLASH_BWD_DQ_LAUNCHES`, `FLASH_BWD_DKV_LAUNCHES`). A wrapper runs the
plain version only for tensors on the CPU; for CUDA tensors it launches
the kernel or raises.

Deviations from the reference, on purpose:

- `mxu_bf16` defaults to False on every device. The TPU kernel defaulted
  to True only to match XLA's bf16-pass fp32 dots on that chip; an fp32
  product on the H100 (TF32 off) is full fp32, so the port's fp32 path is
  fp32 throughout. `mxu_bf16=True` still rounds the operands of each
  product to bf16 (q, k, v, p and dO; p and dS in the backward), with
  fp32 accumulation, exactly where the reference's `_op` does.
- The fused layout takes any number of heads: per-head strides work for
  every H on Hopper, so the reference's head groups (`_qkv_group`) and its
  even-H refusal, both from the TPU's 128-lane tiling, are gone.
  `attention_qkv` equals the reference's output for every H.
- The TPU block sizes and `interpret` have no counterpart.

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

#: launches of each CUDA kernel, bumped once per launch where it is
#: launched (`_flash_fwd`, `_flash_bwd_launch`)
FLASH_FWD_LAUNCHES = 0
FLASH_BWD_DQ_LAUNCHES = 0
FLASH_BWD_DKV_LAUNCHES = 0

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


def _flash_bwd_plain(q, k, v, do, lse, delta, causal: bool, scale: float,
                     mxu_bf16: bool):
    """The backward kernels' function in plain PyTorch, with whole-row
    softmax: q/do (B,H,Tq,D), k/v (B,H,Tk,D), lse/delta (B,H,Tq) fp32 ->
    dq, dk, dv in the inputs' dtypes. `delta` is rowsum(dO * O), minus an
    lse cotangent where there is one."""

    def op(x):
        x = x.float()
        return x.to(torch.bfloat16).float() if mxu_bf16 else x

    qo, ko, vo, doo = op(q), op(k), op(v), op(do)
    s = torch.einsum("bhqd,bhkd->bhqk", qo, ko) * scale
    p = torch.exp(s - lse.float()[..., None])
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        allowed = torch.ones(tq, tk, dtype=torch.bool,
                             device=s.device).tril(tk - tq)
        # explicit zero: on a row with no key, exp(s - lse) is not small
        p = p.masked_fill(~allowed, 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", op(p), doo)
    dp = torch.einsum("bhqd,bhkd->bhqk", doo, vo)
    ds = op(p * (dp - delta.float()[..., None]) * scale)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, ko)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qo)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_FWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                 + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float]
                 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 5
                 + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float]
                 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _lib(name: str) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cu` with its C signatures."""
    from singa_tpu_torch.ops import _build

    lib = _build.load(name)
    if name == "flash_fwd":
        lib.flash_fwd.argtypes = _FWD_ARGTYPES
        lib.flash_fwd.restype = ctypes.c_int
    else:
        for fn in (lib.flash_bwd_dq, lib.flash_bwd_dkv):
            fn.argtypes = _BWD_ARGTYPES
            fn.restype = ctypes.c_int
    err_string = getattr(lib, f"{name}_error_string")
    err_string.argtypes = [ctypes.c_int]
    err_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, name: str, kernel: str, err: int) -> None:
    if err:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} (cudaError {err})")


def _check(q, k, v, like_q=(), like_k=(), rows=()):
    """Raise on what the kernels do not take. q, k, v and the tensors of
    `like_q` / `like_k` (named pairs) are (B,H,T,D) float32 or bfloat16 of
    one dtype with a contiguous last dim; `rows` are (B,H,Tq) fp32."""
    mats = [("q", q), ("k", k), ("v", v), *like_q, *like_k]
    for name, x in mats:
        if x.dim() != 4:
            raise ValueError(f"{name} must be (B, H, T, D), got {x.shape}")
        if x.dtype not in _DTYPES or x.dtype != q.dtype:
            raise TypeError(
                f"{name} is {x.dtype}; the kernel takes float32 or bfloat16, "
                f"the same for every (B, H, T, D) operand (q is {q.dtype})")
        if x.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dim, got "
                             f"strides {x.stride()}")
        # the kernels copy rows in 16-byte pieces (cp.async)
        nbytes = x.element_size()
        if x.data_ptr() % 16 or any(s * nbytes % 16 for s in x.stride()[:3]):
            raise ValueError(
                f"{name} needs 16-byte-aligned rows: its data pointer and "
                f"its (batch, head, time) strides in bytes must be "
                f"multiples of 16, got pointer {x.data_ptr()} and strides "
                f"{x.stride()} of {nbytes}-byte elements")
    for name, x in mats + list(rows):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    b, h, tq, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; the kernel is "
                         f"built for {_HEAD_DIMS}")
    if k.shape[:2] != (b, h) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    for group, shape in ((like_q, q.shape), (like_k, k.shape)):
        for name, x in group:
            if x.shape != shape:
                raise ValueError(f"{name} {tuple(x.shape)} must be "
                                 f"{tuple(shape)}")
    for name, x in rows:
        if x.dtype != torch.float32 or x.shape != q.shape[:3]:
            raise ValueError(f"{name} must be float32 {tuple(q.shape[:3])}, "
                             f"got {x.dtype} {tuple(x.shape)}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _flash_fwd(q, k, v, o, causal: bool, scale: float,
               mxu_bf16: bool) -> torch.Tensor:
    """Attention of q (B,H,Tq,D) over k/v (B,H,Tk,D), any (batch, head,
    time) strides, written into `o` (q's shape and dtype); returns lse
    (B,H,Tq) fp32. CUDA tensors launch the kernel; CPU tensors run
    `_flash_fwd_plain`."""
    global FLASH_FWD_LAUNCHES
    _check(q, k, v, like_q=[("o", o)])
    if q.device.type == "cpu":
        out, lse = _flash_fwd_plain(q, k, v, causal, scale, mxu_bf16)
        o.copy_(out)
        return lse
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 15)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        *lse.stride())
    lib = _lib("flash_fwd")
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, tq, tk, d, strides, float(scale),
            int(bool(causal)), int(bool(mxu_bf16)), _DTYPES[q.dtype],
            _stream(q))
    _raise_on(lib, "flash_fwd", "flash_fwd", err)
    FLASH_FWD_LAUNCHES += 1
    return lse


def _flash_bwd_launch(kernel: str, q, k, v, do, lse, delta, dq, dk, dv,
                      causal: bool, scale: float, mxu_bf16: bool) -> None:
    """One launch of `flash_bwd_dq` or `flash_bwd_dkv` on CUDA tensors;
    the gradients it does not write may be any tensor."""
    global FLASH_BWD_DQ_LAUNCHES, FLASH_BWD_DKV_LAUNCHES
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if b * h == 0 or (tq if kernel == "flash_bwd_dq" else tk) == 0:
        return
    tensors = (q, k, v, do, lse, delta, dq, dk, dv)
    ptrs = (ctypes.c_void_p * 9)(*(x.data_ptr() for x in tensors))
    strides = (ctypes.c_int64 * 27)(*(s for x in tensors
                                      for s in x.stride()[:3]))
    lib = _lib("flash_bwd")
    with torch.cuda.device(q.device):
        err = getattr(lib, kernel)(
            ptrs, b, h, tq, tk, d, strides, float(scale), int(bool(causal)),
            int(bool(mxu_bf16)), _DTYPES[q.dtype], _stream(q))
    _raise_on(lib, "flash_bwd", kernel, err)
    if kernel == "flash_bwd_dq":
        FLASH_BWD_DQ_LAUNCHES += 1
    else:
        FLASH_BWD_DKV_LAUNCHES += 1


def _flash_bwd_dq(q, k, v, do, lse, delta, dq, causal: bool, scale: float,
                  mxu_bf16: bool) -> None:
    """dQ of attention written into `dq` (q's shape): the dQ kernel on
    CUDA tensors, `_flash_bwd_plain` on CPU tensors. Operands as in
    `_flash_bwd`."""
    _check(q, k, v, like_q=[("do", do), ("dq", dq)],
           rows=[("lse", lse), ("delta", delta)])
    if q.device.type == "cpu":
        dq.copy_(_flash_bwd_plain(q, k, v, do, lse, delta, causal, scale,
                                  mxu_bf16)[0])
        return
    _flash_bwd_launch("flash_bwd_dq", q, k, v, do, lse, delta, dq, dq, dq,
                      causal, scale, mxu_bf16)


def _flash_bwd_dkv(q, k, v, do, lse, delta, dk, dv, causal: bool,
                   scale: float, mxu_bf16: bool) -> None:
    """dK and dV of attention written into `dk`, `dv` (k's shape): the
    dK/dV kernel on CUDA tensors, `_flash_bwd_plain` on CPU tensors.
    Operands as in `_flash_bwd`."""
    _check(q, k, v, like_q=[("do", do)], like_k=[("dk", dk), ("dv", dv)],
           rows=[("lse", lse), ("delta", delta)])
    if q.device.type == "cpu":
        _, gk, gv = _flash_bwd_plain(q, k, v, do, lse, delta, causal, scale,
                                     mxu_bf16)
        dk.copy_(gk)
        dv.copy_(gv)
        return
    _flash_bwd_launch("flash_bwd_dkv", q, k, v, do, lse, delta, dk, dk, dv,
                      causal, scale, mxu_bf16)


def _flash_bwd(q, k, v, do, lse, delta, dq, dk, dv, causal: bool,
               scale: float, mxu_bf16: bool) -> None:
    """Gradients of attention written into dq (q's shape) and dk, dv (k's
    shape), from the incoming gradient `do` (q's shape), the forward's lse
    and delta (B,H,Tq) fp32; every (B,H,T,D) operand may have any (batch,
    head, time) strides. CUDA tensors launch the dQ and the dK/dV
    kernels; CPU tensors run `_flash_bwd_plain` (for each of the two)."""
    _flash_bwd_dq(q, k, v, do, lse, delta, dq, causal, scale, mxu_bf16)
    _flash_bwd_dkv(q, k, v, do, lse, delta, dk, dv, causal, scale, mxu_bf16)


def _grad_in(g: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """The incoming gradient as the kernels take it: `like`'s dtype and a
    contiguous last dim (autograd may hand in any strides, an expanded
    zero, or nothing at all)."""
    if g is None:
        return torch.zeros_like(like)
    g = g.to(like.dtype)
    return g if g.stride(-1) == 1 else g.contiguous()


class _FlashAttention(torch.autograd.Function):
    """Head-split attention with its lse: (q, k, v) -> (O, lse), the
    counterpart of the reference's `_core` and `_core_with_lse`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, mxu_bf16):
        o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        lse = _flash_fwd(q, k, v, o, causal, scale, mxu_bf16)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (causal, scale, mxu_bf16)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        g = _grad_in(g, o)
        delta = (g.float() * o.float()).sum(dim=-1)
        if g_lse is not None:
            # p = exp(s - lse): the lse cotangent shifts delta (:549-551)
            delta = delta - g_lse.float()
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
        dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
        _flash_bwd(q, k, v, g, lse, delta, dq, dk, dv, *ctx.cfg)
        return dq, dk, dv, None, None, None


class _FlashAttentionQKV(torch.autograd.Function):
    """Attention over the fused projection: qkv (B,T,3d) -> (B,T,d), the
    counterpart of the reference's `_core_qkv`. The gradient of qkv is
    one (B,T,3d) tensor whose three column blocks the kernels write."""

    @staticmethod
    def forward(ctx, qkv, num_heads, causal, scale, mxu_bf16):
        b, t, d3 = qkv.shape
        q, k, v = _split_qkv(qkv, num_heads)
        out = torch.empty((b, t, d3 // 3), dtype=qkv.dtype,
                          device=qkv.device)
        lse = _flash_fwd(q, k, v, _heads(out, num_heads), causal, scale,
                         mxu_bf16)
        ctx.save_for_backward(qkv, out, lse)
        ctx.cfg = (num_heads, causal, scale, mxu_bf16)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, out, lse = ctx.saved_tensors
        num_heads, causal, scale, mxu_bf16 = ctx.cfg
        g = _grad_in(g, out)
        # per-head rowsum(dO * O), (B, H, T) as a strided view
        delta = (g.float() * out.float()).unflatten(
            -1, (num_heads, -1)).sum(dim=-1).transpose(1, 2)
        dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
        _flash_bwd(*_split_qkv(qkv, num_heads), _heads(g, num_heads), lse,
                   delta, *_split_qkv(dqkv, num_heads), causal, scale,
                   mxu_bf16)
        return dqkv, None, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, mxu_bf16: bool = False,
                    return_lse: bool = False):
    """Fused attention. q (B,H,Tq,D), k/v (B,H,Tk,D) -> (B,H,Tq,D); with
    `return_lse=True` also the logsumexp rows (B,H,Tq) fp32, which take a
    cotangent. Differentiable through the backward kernels."""
    if q.dim() != 4:
        raise ValueError(f"expected (B, H, T, D), got {tuple(q.shape)}")
    scale = float(scale) if scale is not None else float(q.shape[-1]) ** -0.5
    o, lse = _FlashAttention.apply(q, k, v, bool(causal), scale,
                                   bool(mxu_bf16))
    return (o, lse) if return_lse else o


def _split_qkv(qkv: torch.Tensor, num_heads: int):
    """Per-head (B,H,T,hd) views of q, k, v inside the fused (B,T,3d)."""
    b, t, d3 = qkv.shape
    hd = d3 // (3 * num_heads)
    parts = qkv.view(b, t, 3, num_heads, hd)
    return tuple(parts[:, :, i].permute(0, 2, 1, 3) for i in range(3))


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The (B,H,T,hd) view of a merged-head (B,T,d) tensor whose last dim
    is contiguous."""
    return x.unflatten(-1, (num_heads, -1)).transpose(1, 2)


def flash_attention_qkv(qkv, num_heads: int, causal: bool = False,
                        scale: Optional[float] = None,
                        mxu_bf16: bool = False) -> torch.Tensor:
    """Flash attention over the FUSED projection: qkv (B, T, 3d), the
    direct output of `x @ w_qkv + b`, returns the merged-head context
    (B, T, d). Self-attention only (Tq == Tk). Differentiable through the
    backward kernels, which write the (B, T, 3d) gradient of qkv."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"expected (B, T, 3*H*hd) with H={num_heads}, "
                         f"got {tuple(qkv.shape)}")
    if qkv.stride(-1) != 1:
        raise ValueError("qkv needs a contiguous last dim")
    hd = qkv.shape[-1] // (3 * num_heads)
    scale = float(scale) if scale is not None else float(hd) ** -0.5
    return _FlashAttentionQKV.apply(qkv, num_heads, bool(causal), scale,
                                    bool(mxu_bf16))


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
