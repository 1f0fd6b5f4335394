"""The precision plan of the tensor-core flash kernels (csrc/flash_fwd.cu,
the dQ and dK/dV kernels of csrc/flash_bwd.cu), emulated in PyTorch on the
CPU and held against the reference (singa_tpu.ops.flash_attention, Pallas in
interpret mode, mxu_bf16=False) at gpt_medium's head dim.

- fp32 inputs: every product runs as three TF32 passes. x = hi + lo with
  hi = tf32(x), lo = tf32(x - hi), tf32 rounding to nearest with ties away
  from zero on the fp32 bit pattern (cvt.rna.tf32.f32); a.b is
  a_lo.b_hi + a_hi.b_lo + a_hi.b_hi with fp32 sums. A TF32 product is
  exact in fp32, so an fp32 matmul of TF32 values is the tensor core's.
- bf16 inputs: q.k^T and dO.v^T are exact bf16 products; p and dS, which
  the reference keeps in fp32, run as two bf16 products each,
  p = p_hi + p_lo with p_hi = bf16(p), p_lo = bf16(p - p_hi): P.V, P^T.dO,
  dS^T.Q and dS.K.

Limits are chip_smoke.py's: max|d| within 1e-4 (fp32) or 2e-2 (bf16) of
max(1, max|reference|). A plan that cannot meet them fails here, before
the card runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helper_torch_parity import jax_flash, rand

B, H, T, D = 1, 2, 256, 128
LIMIT = {"fp32": 1e-4, "bf16": 2e-2}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest, ties away from
    zero: add half of the dropped 13 bits to the magnitude, then cut."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def split_tf32(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_tf32x3(a, b):
    """a @ b as the kernels run it on fp32 operands."""
    ahi, alo = split_tf32(a)
    bhi, blo = split_tf32(b)
    return alo @ bhi + ahi @ blo + ahi @ bhi


def bf16(x):
    return x.to(torch.bfloat16).float()


def mm_bf16_split(p, b):
    """p @ b with p split into two bf16 parts and b exactly bf16."""
    hi = bf16(p)
    return hi @ b + bf16(p - hi) @ b


def _mask(causal):
    return (torch.ones(T, T, dtype=torch.bool).tril() if causal
            else torch.ones(T, T, dtype=torch.bool))


def emulated_forward(q, k, v, causal, mode):
    """O and lse of the kernel's arithmetic; q, k, v (B,H,T,D) fp32 (for
    bf16, holding bf16 values)."""
    scale = D ** -0.5
    keep = _mask(causal)
    if mode == "fp32":
        s = mm_tf32x3(q, k.transpose(-1, -2))
    else:
        s = q @ k.transpose(-1, -2)  # bf16 products are exact in fp32
    s = (s * scale).masked_fill(~keep, -1e30)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~keep, 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    pv = mm_tf32x3(p, v) if mode == "fp32" else mm_bf16_split(p, v)
    o = pv / l
    if mode == "bf16":
        o = bf16(o)  # written in the input dtype
    return o, (m + torch.log(l)).squeeze(-1)


def emulated_p_ds(q, k, v, do, o, lse, causal, mode):
    """P and dS as the backward kernels form them in registers: S and dP
    from the kernels' products, masked p an exact 0."""
    scale = D ** -0.5
    keep = _mask(causal)
    delta = (do * o).sum(-1, keepdim=True)
    kt, vt = k.transpose(-1, -2), v.transpose(-1, -2)
    if mode == "fp32":
        s, dp = mm_tf32x3(q, kt), mm_tf32x3(do, vt)
    else:
        s, dp = q @ kt, do @ vt
    p = torch.exp(s * scale - lse[..., None]).masked_fill(~keep, 0.0)
    return p, p * (dp - delta) * scale


def emulated_dkv(q, k, v, do, o, lse, causal, mode):
    """dK, dV of the kernel's arithmetic, from the emulated forward."""
    p, ds = emulated_p_ds(q, k, v, do, o, lse, causal, mode)
    pt, dst = p.transpose(-1, -2), ds.transpose(-1, -2)
    if mode == "fp32":
        return mm_tf32x3(dst, q), mm_tf32x3(pt, do)
    return bf16(mm_bf16_split(dst, q)), bf16(mm_bf16_split(pt, do))


def emulated_dq(q, k, v, do, o, lse, causal, mode):
    """dQ of the dQ kernel's arithmetic: dS from the accumulators of S and
    dP, then dS.K as three TF32 passes (fp32) or as dS_hi.K + dS_lo.K
    (bf16 inputs, K exact), written in the input dtype."""
    _, ds = emulated_p_ds(q, k, v, do, o, lse, causal, mode)
    if mode == "fp32":
        return mm_tf32x3(ds, k)
    return bf16(mm_bf16_split(ds, k))


def _inputs(mode, seed):
    arrays = [rand((B, H, T, D), seed + i) for i in range(4)]
    if mode == "bf16":  # bf16 inputs: the reference runs on their values
        arrays = [np.asarray(bf16(torch.from_numpy(a))) for a in arrays]
    return arrays


def _reference(q, k, v, do, causal):
    def fwd(q_, k_, v_):
        return jax_flash().flash_attention(q_, k_, v_, causal=causal,
                                           interpret=True, mxu_bf16=False,
                                           return_lse=True)

    (o, lse), vjp = jax.vjp(fwd, *(jnp.asarray(a) for a in (q, k, v)))
    dq, dk, dv = vjp((jnp.asarray(do), jnp.zeros_like(lse)))
    return [np.asarray(x) for x in (o, lse, dq, dk, dv)]


def _worst(got, want):
    """max|d| / max(1, max|want|)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
def test_precision_plan_meets_the_chip_limits(causal, mode):
    q, k, v, do = _inputs(mode, seed=70 + 10 * causal)
    want_o, want_lse, _, want_dk, want_dv = _reference(q, k, v, do, causal)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = emulated_forward(tq, tk, tv, causal, mode)
    dk, dv = emulated_dkv(tq, tk, tv, tdo, o, lse, causal, mode)
    limit = LIMIT[mode]
    for name, got, want in (("O", o, want_o), ("lse", lse, want_lse),
                            ("dK", dk, want_dk), ("dV", dv, want_dv)):
        worst = _worst(got, want)
        assert worst <= limit, (
            f"{mode} {name}: max|d| / max(1, max|ref|) = {worst:.3e} over "
            f"the limit {limit:.0e}")


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
def test_dq_plan_meets_the_chip_limits(causal, mode):
    """The dQ kernel's products (3xTF32 for S, dP and dS.K in fp32; exact
    bf16 S and dP and a hi + lo dS for bf16 inputs) against the
    reference's dq, from the emulated forward's O and lse."""
    q, k, v, do = _inputs(mode, seed=110 + 10 * causal)
    want_dq = _reference(q, k, v, do, causal)[2]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = emulated_forward(tq, tk, tv, causal, mode)
    dq = emulated_dq(tq, tk, tv, tdo, o, lse, causal, mode)
    worst = _worst(dq, want_dq)
    assert worst <= LIMIT[mode], (
        f"{mode} dQ: max|d| / max(1, max|ref|) = {worst:.3e} over the "
        f"limit {LIMIT[mode]:.0e}")


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10  # the TF32 neighbour above 1
    x = torch.tensor([1.0 + 2.0 ** -11,             # a tie: away from 0
                      -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -20,  # below the tie: down
                      3.0], dtype=torch.float32)
    assert tf32(x).tolist() == [one, -one, 1.0, 3.0]
    hi, lo = split_tf32(x)
    assert torch.equal(hi + lo, x)  # the split is exact here


def test_one_tf32_pass_would_miss_the_fp32_limit():
    """Why three passes: a single TF32 product per matmul (about 1e-3
    relative) breaks chip_smoke.py's 1e-4 limit on the forward."""
    q, k, v, _ = _inputs("fp32", seed=90)
    want_o = _reference(q, k, v, np.zeros_like(q), True)[0]
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    keep = _mask(True)
    s = (tf32(tq) @ tf32(tk).transpose(-1, -2)) * D ** -0.5
    s = s.masked_fill(~keep, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True)).masked_fill(~keep, 0.0)
    o = (tf32(p) @ tf32(tv)) / p.sum(-1, keepdim=True)
    worst = _worst(o, want_o)
    assert worst > LIMIT["fp32"], f"one TF32 pass: {worst:.3e}"
