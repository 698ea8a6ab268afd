"""The forms of the port's attention backward, on the CPU.

  * `attention.backward_plan`, the rule that picks the backward kernel's
    form: "wgmma" for bf16 at head_dim 64, 80 and 128, "simt" for fp32 and
    head_dim 16, 32 and 256, whatever the lengths.
  * An emulation of the wgmma form's arithmetic in plain PyTorch
    (`csrc/flash_attention_bwd.cu`, form 1): bf16 operands whose
    products are exact in fp32 and summed in fp32; P and dS split into
    two bf16 terms by `split_hi_lo` (the forward's P split,
    `test_torch_attention_forms.py`); (b) -- dK and dV per 64-key block
    -- walks the GQA group's heads in order and each head's 64-query
    blocks in order, in the transposed orientation (S^T = K Q^T, lse and
    delta by column), and (c) -- dQ per 64-query block -- the 64-key
    blocks in order.  Rows past Sq or Sk are zero tiles, as TMA fills
    them; a query past Sq gets lse = +inf.  Tiles the kernel skips under
    the causal mask add exact zeros here.  D lies in 64-column panels,
    zero-filled past D as TMA fills them (head_dim 80: two panels, the
    second holding columns 64-79); the score products take D / 16 k16
    steps over the real columns, and the products with N = D run over the
    panels, their columns past D dropped.

The emulation is held against `jax.vjp` of `repro.models.layers.
flash_attention` and against `flash_attention_backward_plain`, on the
same numpy inputs rounded to bf16, with the forward's output and lse from
`flash_attention_plain`.  Tolerance: against the plain backward one bf16
ulp (atol 1e-4, rtol 2^-7, the card tests' `ATTN_TOL`): both compute the
same fp32 values in other orders and round once, and hi + lo keeps ~16
bits of P and dS, far inside one bf16 ulp.  Against `repro`, 5e-2 of
each gradient's largest magnitude (`test_torch_attention_grad.py`'s
bf16 class): `repro` differentiates its fp32 recurrence and rounds
once, the port takes delta from the bf16 output.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_allclose
from repro.models import layers as jL
from repro_torch.kernels.attention import (BWD_FORMS, BWD_WGMMA_DIMS,
                                           backward_plan,
                                           flash_attention_backward_plain,
                                           flash_attention_plain)
from test_torch_attention_forms import split_hi_lo

TILE = 64
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
ULP_TOL = (1e-4, 2.0 ** -7)      # (atol, rtol): one bf16 ulp
BF16_TOL = 5e-2                  # of each gradient's largest magnitude


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", [16, 32, 64, 80, 128, 256])
@pytest.mark.parametrize("Sq,Sk", [(1, 40), (63, 63), (65, 130),
                                   (4096, 4096)])
def test_backward_plan_picks_the_form(dtype, D, Sq, Sk):
    form = backward_plan(dtype, 2, Sq, Sk, 16, 8, D)
    assert form in BWD_FORMS
    assert form == ("wgmma" if dtype == torch.bfloat16 and D in (64, 80,
                                                                  128)
                    else "simt")


def test_backward_plan_rows_and_heads_do_not_move_the_form():
    assert BWD_WGMMA_DIMS == (64, 80, 128)
    for B, Hq, Hk in ((1, 1, 1), (2, 16, 8), (1, 8, 1), (3, 12, 4)):
        assert backward_plan(torch.bfloat16, B, 70, 70, Hq, Hk, 128) == \
            "wgmma"
        assert backward_plan(torch.float32, B, 70, 70, Hq, Hk, 128) == \
            "simt"


def _tiles(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, S, H, D) bf16 -> (B, H, n, 64, 64 * panels) fp32, as TMA
    fills a tile's 64-column panels: rows past S and columns past D
    zero."""
    B, S, H, D = x.shape
    width = -(-D // TILE) * TILE
    pad = torch.zeros((B, n * TILE, H, width), dtype=torch.float32)
    pad[:, :S, :, :D] = x.float()
    return pad.permute(0, 2, 1, 3).reshape(B, H, n, TILE, width)


def k16_scores(a: torch.Tensor, b: torch.Tensor, D: int) -> torch.Tensor:
    """a @ b^T over the first D columns of two panel tiles, as the
    kernel's D / 16 k16 steps (4 a panel) sum them in fp32: the padding
    past D is never read."""
    out = 0.0
    for kk in range(D // 16):
        cols = slice(16 * kk, 16 * kk + 16)
        out = out + a[..., cols] @ b[..., cols].transpose(-1, -2)
    return out


def _split_product(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (fp32) @ b as the kernel's two wgmma passes: hi, then lo; b's
    columns run over its panels (N = D, then the zeros past D)."""
    hi, lo = split_hi_lo(x)
    return hi.float() @ b + lo.float() @ b


def wgmma_backward_emulated(q, k, v, out, dout, lse, *, causal: bool,
                            q_offset: int):
    """(dq, dk, dv) in bf16 through the wgmma form's arithmetic."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hk, _ = k.shape
    g = Hq // Hk
    scale = torch.tensor(D ** -0.5, dtype=torch.float32)
    scale2 = scale * LOG2E
    nq, nk = -(-Sq // TILE), -(-Sk // TILE)
    # (a) delta, and lse in base 2; a query past Sq has lse = +inf.
    delta = torch.zeros((B, Hq, nq * TILE))
    delta[:, :, :Sq] = (dout.float() * out.float()).sum(-1).permute(0, 2, 1)
    lse2 = torch.full((B, Hq, nq * TILE), float("inf"))
    lse2[:, :, :Sq] = lse.float() * LOG2E
    Q, dO = _tiles(q, nq), _tiles(dout, nq)     # (B, Hq, nq, 64, D)
    K, V = _tiles(k, nk), _tiles(v, nk)         # (B, Hk, nk, 64, D)
    qpos = torch.arange(nq * TILE).reshape(nq, TILE)
    kpos = torch.arange(nk * TILE).reshape(nk, TILE)

    # (b) every key block of every (b, kv head) at once: heads in order,
    # then query blocks in order.
    dK = torch.zeros_like(K)
    dV = torch.zeros_like(V)
    for hh in range(g):
        h = torch.arange(Hk) * g + hh
        for qb in range(nq):
            Qt, dOt = Q[:, h, qb, None], dO[:, h, qb, None]   # (B,Hk,1,64,D)
            cols = slice(qb * TILE, (qb + 1) * TILE)
            St = k16_scores(K, Qt, D)                          # keys x queries
            dPt = k16_scores(V, dOt, D)
            Pt = torch.exp2(St * scale2 - lse2[:, h, None, None, cols])
            if causal:
                live = kpos[:, :, None] <= q_offset + qpos[qb][None, None, :]
                Pt = torch.where(live, Pt, 0.0)
            dSt = Pt * (dPt - delta[:, h, None, None, cols])
            dV = dV + _split_product(Pt, dOt)
            dK = dK + _split_product(dSt, Qt)

    # (c) every query block of every (b, head) at once: key blocks in order.
    hk = torch.arange(Hq) // g
    dQ = torch.zeros_like(Q)
    for kb in range(nk):
        Kt, Vt = K[:, hk, kb, None], V[:, hk, kb, None]       # (B,Hq,1,64,D)
        S = k16_scores(Q, Kt, D)                              # queries x keys
        dP = k16_scores(dO, Vt, D)
        P = torch.exp2(S * scale2 - lse2.reshape(B, Hq, nq, TILE, 1))
        live = kpos[kb][None, None, :] < Sk
        if causal:
            live = live & (kpos[kb][None, None, :]
                           <= q_offset + qpos[:, :, None])
        P = torch.where(live, P, 0.0)
        dS = P * (dP - delta.reshape(B, Hq, nq, TILE, 1))
        dQ = dQ + _split_product(dS, Kt)

    def untile(x, S):
        B_, H, n, _, width = x.shape
        return x.reshape(B_, H, n * TILE, width)[:, :, :S, :D].permute(
            0, 2, 1, 3)

    return ((untile(dQ, Sq) * scale).to(torch.bfloat16),
            (untile(dK, Sk) * scale).to(torch.bfloat16),
            untile(dV, Sk).to(torch.bfloat16))


# (B, Sq, Sk, Hq, Hk, D, causal, q_offset): GQA g = 1, 2 and 8, causal and
# not, q_offset = Sk - Sq and below it (keys no query sees), Sq and Sk
# ragged about the 64-row tiles, one query; head_dim 64, 80 (two panels,
# the second 16 columns wide) and 128.
EMU_CASES = [
    (1, 70, 70, 2, 2, 64, True, 0),
    (2, 65, 130, 4, 2, 64, True, 65),
    (1, 40, 100, 8, 1, 64, True, 37),
    (1, 33, 70, 4, 2, 64, False, 0),
    (1, 130, 130, 4, 2, 128, True, 0),
    (1, 1, 40, 4, 4, 64, True, 39),
    (1, 70, 70, 2, 2, 80, True, 0),
    (2, 65, 130, 4, 2, 80, True, 65),
    (1, 33, 70, 4, 2, 80, False, 0),
    (1, 130, 130, 2, 2, 80, True, 0),
]


@jax.jit(static_argnums=(0, 1))
def _jax_vjp(causal, off, q, k, v, do):
    _, vjp = jax.vjp(lambda a, b, c: jL.flash_attention(
        a, b, c, causal=causal, chunk=16, q_offset=off), q, k, v)
    return vjp(do)


@pytest.mark.parametrize("case", EMU_CASES,
                         ids=["-".join(map(str, c)) for c in EMU_CASES])
def test_emulated_wgmma_backward_matches_repro_and_the_plain_backward(case):
    B, Sq, Sk, Hq, Hk, D, causal, off = case
    rng = np.random.default_rng(sum(case[:6]))
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, Sq, Hq, D), (B, Sk, Hk, D), (B, Sk, Hk, D),
                        (B, Sq, Hq, D))]
    q, k, v, do = (torch.tensor(a).to(torch.bfloat16) for a in arrays)
    out, lse = flash_attention_plain(q, k, v, causal=causal, q_offset=off,
                                     return_lse=True)
    got = wgmma_backward_emulated(q, k, v, out, do, lse, causal=causal,
                                  q_offset=off)
    plain = flash_attention_backward_plain(q, k, v, out, do, lse,
                                           causal=causal, q_offset=off)
    want = _jax_vjp(causal, off, *(jnp.asarray(t.float().numpy())
                                   for t in (q, k, v, do)))
    atol, rtol = ULP_TOL
    for g_, p, w, t in zip(got, plain, want, (q, k, v)):
        assert g_.dtype == torch.bfloat16 and g_.shape == t.shape
        assert bool(torch.isfinite(g_.float()).all())
        torch.testing.assert_close(g_.float(), p.float(), atol=atol,
                                   rtol=rtol)
        w = np.asarray(w, np.float32)
        big = float(np.abs(w).max())
        assert_allclose(g_.float(), w, rtol=BF16_TOL, atol=BF16_TOL * big)


def test_split_hi_lo_of_ds_keeps_its_sign_and_sixteen_bits():
    """dS = P (dP - delta) takes both signs: hi + lo keeps each value to
    2^-16 relative, and one bf16 term alone does not."""
    rng = np.random.default_rng(4)
    p = torch.softmax(torch.tensor(rng.standard_normal((64, 64)) * 3,
                                   dtype=torch.float32), dim=-1)
    ds = p * torch.tensor(rng.standard_normal((64, 64)), dtype=torch.float32)
    hi, lo = split_hi_lo(ds)
    err = (hi.double() + lo.double() - ds.double()).abs()
    assert (err <= 2.0 ** -16 * ds.double().abs()).all()
    assert ((hi.double() - ds.double()).abs()
            > 2.0 ** -16 * ds.double().abs()).any()
