"""The forms of the port's flash-attention kernel, on the CPU.

  * `attention.plan`, the rule that picks the kernel's form and split
    count from the shapes: the engine's prefill and decode shapes, the
    `ATTN_SWEEP` shapes, MQA, fp32 and head_dim 16, and the split counts'
    invariants over a grid.
  * `attention.split_kv_plain`, the split form's arithmetic (partials per
    (split, warp), combined in a fixed order), against `repro`'s Pallas
    kernel in interpret mode and `repro.models.layers.flash_attention`
    over `ATTN_SWEEP` and decode lengths around the tile edges.
  * the wgmma form's P split into two bf16 terms (`split_hi_lo`, its
    arithmetic in plain PyTorch): P.V from the two stays within 2^-15
    relative of the fp32 P.V.
  * the wgmma form at head_dim 80, emulated (`wgmma_forward_emulated`):
    64-row tiles of (query, head-of-group) rows, D in two zero-filled
    64-column panels as TMA fills them, S from 5 k16 steps, the online
    softmax in base 2, O += P_hi V + P_lo V over 80 columns -- against
    `repro`'s Pallas kernel in interpret mode and its chunked layer.

Inputs come from numpy seeds.  Tolerance: rtol = atol = 2e-5 against
`repro`, the bound of `repro`'s own sweep (`test_kernels.py`); the
emulated wgmma form, whose output is bf16, one bf16 ulp (atol 1e-4, rtol
2^-7, the card tests' `ATTN_TOL`), and its lse 2e-5.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import ATTN_SWEEP, attention_case
from conftest import assert_allclose
from repro.kernels.attention import flash_attention_pallas
from repro.models import layers as jlayers
from repro_torch.kernels.attention import (MAX_SPLITS, NEG_INF,
                                          SPLIT_MAX_ROWS, SPLIT_TILE,
                                          WGMMA_ROWS, AttentionPlan,
                                          flash_attention_plain, plan,
                                          split_kv_plain)

TOL = 2e-5
BF16, F32 = torch.bfloat16, torch.float32

# (dtype, B, Sq, Sk, Hq, Hk, D) -> (form, splits).  qwen3-0.6b at slot
# batch 4 (Hq 16, Hk 8, head_dim 128): B * Hk = 32 CTAs per split, so
# 2 * 132 / 32 -> 9, capped at 8 and at one split per 64-key tile, then
# as few as give each split the same number of tiles.
PLAN_CASES = [
    ((BF16, 4, 128, 128, 16, 8, 128), ("wgmma", 1)),     # engine prefill
    ((BF16, 4, 1024, 1024, 16, 8, 128), ("wgmma", 1)),
    ((BF16, 4, 1, 129, 16, 8, 128), ("split", 3)),       # engine decode
    ((BF16, 4, 1, 257, 16, 8, 128), ("split", 5)),
    ((BF16, 4, 1, 513, 16, 8, 128), ("split", 5)),       # 9 tiles: 2 each
    ((BF16, 4, 1, 1025, 16, 8, 128), ("split", 6)),      # 17 tiles: 3 each
    ((BF16, 4, 1, 64, 16, 8, 128), ("split", 1)),
    ((F32, 4, 1024, 1024, 16, 8, 128), ("tile", 1)),     # fp32 prefill
    ((F32, 4, 1, 1025, 16, 8, 128), ("split", 6)),       # fp32 decode
    ((BF16, 2, 300, 300, 8, 1, 256), ("wgmma", 1)),      # MQA, head_dim 256
    ((F32, 2, 300, 300, 8, 1, 256), ("tile", 1)),
    ((BF16, 2, 1, 300, 8, 1, 256), ("split", 5)),        # 8 rows per kv head
    ((BF16, 1, 2, 300, 8, 1, 256), ("tile", 1)),         # 16 rows: no split
    ((BF16, 1, 40, 40, 2, 1, 16), ("tile", 1)),          # head_dim 16
    ((BF16, 1, 64, 64, 1, 1, 32), ("tile", 1)),          # head_dim 32
    ((BF16, 1, 64, 64, 1, 1, 64), ("wgmma", 1)),
    ((BF16, 1, 63, 63, 1, 1, 64), ("tile", 1)),          # no whole tile
    ((BF16, 1, 32, 32, 2, 1, 64), ("wgmma", 1)),         # 32 x 2 rows
    ((BF16, 1, 9, 40, 1, 1, 64), ("tile", 1)),
    # zamba2-2.7b's shared block (head_dim 80, MHA 32 heads) at the engine's
    # batch 4: a bf16 prefill on wgmma (two 64-column panels), fp32 and a
    # bf16 call with fewer than 64 rows on tile; decode on split.
    ((BF16, 4, 1024, 1024, 32, 32, 80), ("wgmma", 1)),
    ((BF16, 2, 4096, 4096, 32, 32, 80), ("wgmma", 1)),   # its training
    ((BF16, 4, 63, 63, 32, 32, 80), ("tile", 1)),
    ((F32, 4, 1000, 1000, 32, 32, 80), ("tile", 1)),
    ((BF16, 4, 1, 1025, 32, 32, 80), ("split", 3)),
    ((F32, 4, 1, 129, 32, 32, 80), ("split", 3)),
]

# ATTN_SWEEP's shapes (bq, bk are the Pallas block sizes) in both dtypes.
SWEEP_PLANS = {
    (2, 64, 64, 4, 2, 32): ("tile", "tile"),
    (1, 128, 128, 8, 8, 64): ("tile", "wgmma"),
    (2, 48, 96, 4, 1, 32): ("tile", "tile"),
    (1, 33, 70, 8, 2, 16): ("tile", "tile"),
    (1, 1, 40, 4, 4, 32): ("split", "split"),
    (2, 70, 70, 2, 2, 128): ("tile", "wgmma"),
}


@pytest.mark.parametrize("shape,want", PLAN_CASES,
                         ids=[str(c[0][1:]) + str(c[0][0])[6:]
                              for c in PLAN_CASES])
def test_plan_picks_the_form_and_split_count(shape, want):
    assert plan(*shape) == AttentionPlan(*want)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hk,D,causal,bq,bk", ATTN_SWEEP)
def test_plan_of_the_sweep_shapes(B, Sq, Sk, Hq, Hk, D, causal, bq, bk):
    f32, bf16 = SWEEP_PLANS[(B, Sq, Sk, Hq, Hk, D)]
    assert plan(F32, B, Sq, Sk, Hq, Hk, D).form == f32
    assert plan(BF16, B, Sq, Sk, Hq, Hk, D).form == bf16


def test_split_counts_fill_the_card_and_leave_no_split_empty():
    for B in (1, 2, 4, 8, 64):
        for Hk in (1, 2, 8):
            for Sk in (1, 31, 64, 65, 200, 513, 1025, 2048, 32768):
                p = plan(BF16, B, 1, Sk, Hk, Hk, 128)
                tiles = -(-Sk // SPLIT_TILE)
                chunk = -(-tiles // p.splits)
                assert p.form == "split" and 1 <= p.splits <= MAX_SPLITS
                assert p.splits <= tiles
                assert (p.splits - 1) * chunk < tiles      # last one non-empty
                assert p.splits * chunk >= tiles            # all covered
                if tiles >= MAX_SPLITS and B * Hk * MAX_SPLITS <= 2 * 132:
                    assert p.splits > MAX_SPLITS // 2       # a full cluster


def test_split_rows_bound():
    """A split CTA holds at most SPLIT_MAX_ROWS (query, head) rows."""
    assert plan(F32, 1, 1, 100, 8, 1, 64).form == "split"       # 8 rows
    assert plan(F32, 1, 1, 100, 16, 1, 64).form == "tile"       # 16 rows
    assert plan(F32, 1, SPLIT_MAX_ROWS // 2, 100, 2, 1, 64).form == "split"


def _repro_pair(q, k, v, causal, q_offset, bq, bk):
    """`repro`'s Pallas kernel (interpret mode) and its chunked layer."""
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, blk_q=bq,
                                    blk_k=bk, q_offset=q_offset,
                                    interpret=True)
    layer = jlayers.flash_attention(jq, jk, jv, causal=causal, chunk=bk,
                                    q_offset=q_offset)
    return pallas, layer


def _split_counts(q, k):
    """The plan's split count, one, and the most that leave no split
    empty."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    tiles = -(-Sk // SPLIT_TILE)
    most = min(MAX_SPLITS, tiles)
    most = -(-tiles // -(-tiles // most))
    return sorted({1, plan(F32, B, Sq, Sk, Hq, Hk, D).splits, most})


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hk,D,causal,bq,bk", ATTN_SWEEP)
def test_split_combine_matches_repro_over_the_sweep(B, Sq, Sk, Hq, Hk, D,
                                                    causal, bq, bk):
    q, k, v = attention_case(B, Sq, Sk, Hq, Hk, D, seed=Sq * 10 + Sk)
    off = Sk - Sq
    pallas, layer = _repro_pair(q, k, v, causal, off, bq, bk)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    for splits in _split_counts(tq, tk):
        got = split_kv_plain(tq, tk, tv, causal=causal, q_offset=off,
                             splits=splits)
        assert got.shape == (B, Sq, Hq, D)
        assert_allclose(got, pallas, rtol=TOL, atol=TOL)
        assert_allclose(got, layer, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("length", [1, 31, 32, 33, 64, 65, 1025])
def test_split_combine_matches_repro_at_decode_lengths(length):
    """One query per sequence over `length` cached keys (q_offset =
    length - 1), as the engine's decode step calls it: GQA g = 2, and
    MQA with 8 rows per kv head."""
    for B, Hq, Hk, D in ((2, 4, 2, 32), (1, 8, 1, 16)):
        q, k, v = attention_case(B, 1, length, Hq, Hk, D, seed=length)
        pallas, layer = _repro_pair(q, k, v, True, length - 1, 8, 32)
        tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
        for splits in _split_counts(tq, tk):
            got = split_kv_plain(tq, tk, tv, causal=True,
                                 q_offset=length - 1, splits=splits)
            assert_allclose(got, pallas, rtol=TOL, atol=TOL)
            assert_allclose(got, layer, rtol=TOL, atol=TOL)


def test_split_combine_with_a_later_q_offset_and_empty_partials():
    """Sq = 2 rows that see fewer keys than the cache holds: the later
    splits' partials see no key at all and must weigh nothing."""
    q, k, v = attention_case(1, 2, 300, 4, 1, 32, seed=3)
    pallas, layer = _repro_pair(q, k, v, True, 40, 8, 32)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    for splits in (1, 2, 5):
        got = split_kv_plain(tq, tk, tv, causal=True, q_offset=40,
                             splits=splits)
        assert bool(torch.isfinite(got).all())
        assert_allclose(got, pallas, rtol=TOL, atol=TOL)
        assert_allclose(got, layer, rtol=TOL, atol=TOL)


def split_hi_lo(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 p as the wgmma form's two bf16 P operands, p_hi = bf16(p) and
    p_lo = bf16(p - p_hi) (`csrc/flash_attention.cu::split_pair`)."""
    hi = p.to(torch.bfloat16)
    return hi, (p - hi.float()).to(torch.bfloat16)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("keys", [64, 1024])
def test_hi_lo_split_keeps_p_v_within_2_to_the_minus_15(seed, keys):
    """Random softmax rows p (fp32) against bf16 V: P.V from p_hi + p_lo,
    each product exact in fp32 as on the tensor cores, stays within
    2^-15 relative of the fp32 P.V; one bf16 P does not."""
    rng = np.random.default_rng(seed)
    scores = torch.tensor(rng.standard_normal((64, keys)) * 4,
                          dtype=torch.float32)
    p = torch.softmax(scores, dim=-1)
    v = torch.tensor(rng.standard_normal((keys, 128)),
                     dtype=torch.float32).bfloat16().double()
    hi, lo = split_hi_lo(p)
    assert hi.dtype == lo.dtype == torch.bfloat16
    want = p.double() @ v
    got = hi.double() @ v + lo.double() @ v
    scale = p.double().abs() @ v.abs()            # sum |p| |v| per output
    assert ((got - want).abs() / scale).max().item() <= 2.0 ** -15
    one = hi.double() @ v
    assert ((one - want).abs() / scale).max().item() > 2.0 ** -15
    # p_hi + p_lo itself within 2^-16 of p, elementwise.
    assert ((hi.double() + lo.double() - p.double()).abs()
            <= 2.0 ** -16 * p.double().abs()).all()


def wgmma_forward_emulated(q, k, v, *, causal: bool, q_offset: int):
    """(out bf16, lse fp32 (B,Hq,Sq)) through the wgmma form's arithmetic
    (`csrc/flash_attention.cu`, form 2) on bf16 q, k, v.  A CTA's 64 rows
    are (query, head of the group) pairs of one kv head, row r query r / g
    of head hk * g + r % g; its keys come in tiles of 64.  D lies in
    64-column panels, zero past D; S sums D / 16 k16 steps (exact bf16
    products in fp32), is scaled by D**-0.5 log2(e), masked to -1e30, and
    the online softmax runs in base 2; P is split into p_hi + p_lo and
    both go through P V over the panels.  Every CTA here walks every key
    tile: a tile the kernel skips is wholly masked, adding p = 0 and
    scaling by 2^0 = 1, exact no-ops."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hk, _ = k.shape
    g = Hq // Hk
    width = -(-D // 64) * 64
    rows = Sq * g
    nt, nk = -(-rows // WGMMA_ROWS), -(-Sk // 64)

    def panels(x, n, S):       # (B, S, H, D) -> (B, H, n * 64, width) fp32
        out = torch.zeros((B, x.shape[2], n * 64, width))
        out[:, :, :S, :D] = x.float().permute(0, 2, 1, 3)
        return out

    # (B, Hk, rows): row r of kv head hk is query r // g of head hk g + r % g.
    Q = torch.zeros((B, Hk, nt * WGMMA_ROWS, width))
    Q[:, :, :rows, :D] = q.float().reshape(B, Sq, Hk, g, D).permute(
        0, 2, 1, 3, 4).reshape(B, Hk, rows, D)
    K, V = panels(k, nk, Sk), panels(v, nk, Sk)
    qpos = q_offset + torch.arange(nt * WGMMA_ROWS) // g
    scale2 = torch.tensor(D ** -0.5, dtype=torch.float32) * torch.tensor(
        1.4426950408889634, dtype=torch.float32)
    m = torch.full((B, Hk, nt * WGMMA_ROWS), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(Q)
    for t in range(nk):
        keys = slice(64 * t, 64 * t + 64)
        s = 0.0
        for kk in range(D // 16):
            cols = slice(16 * kk, 16 * kk + 16)
            s = s + Q[..., cols] @ K[:, :, keys, cols].transpose(-1, -2)
        kpos = 64 * t + torch.arange(64)
        live = (kpos < Sk)[None, :].expand(len(qpos), 64)
        if causal:
            live = live & (kpos[None, :] <= qpos[:, None])
        s = torch.where(live, s * scale2, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        m = m_new
        hi, lo = split_hi_lo(p)
        acc = acc * corr[..., None] + hi.float() @ V[:, :, keys] \
            + lo.float() @ V[:, :, keys]
    out = acc[:, :, :rows, :D] / torch.clamp_min(l[:, :, :rows], 1e-30)[
        ..., None]
    out = out.reshape(B, Hk, Sq, g, D).permute(0, 2, 1, 3, 4).reshape(
        B, Sq, Hq, D).to(torch.bfloat16)
    lse = m[:, :, :rows] * 0.6931471805599453 + torch.log(
        torch.clamp_min(l[:, :, :rows], 1e-30))
    lse = lse.reshape(B, Hk, Sq, g).permute(0, 1, 3, 2).reshape(B, Hq, Sq)
    return out, lse


# (B, Sq, Sk, Hq, Hk, D, causal, q_offset, bq, bk) at head_dim 80: MHA and
# GQA g = 2, rows ragged about the 64-row tile, Sq < Sk with a q_offset,
# and full attention.
D80_CASES = [
    (1, 70, 70, 2, 2, 80, True, 0, 32, 32),
    (2, 65, 130, 4, 2, 80, True, 65, 32, 64),
    (1, 40, 100, 4, 2, 80, True, 37, 16, 32),
    (1, 33, 70, 4, 2, 80, False, 0, 32, 32),
    (1, 128, 200, 2, 2, 80, True, 72, 64, 64),
]


@pytest.mark.parametrize("case", D80_CASES,
                         ids=["-".join(map(str, c[:8])) for c in D80_CASES])
def test_emulated_wgmma_forward_at_head_dim_80_matches_repro(case):
    B, Sq, Sk, Hq, Hk, D, causal, off, bq, bk = case
    q, k, v = attention_case(B, Sq, Sk, Hq, Hk, D, seed=sum(case[:6]))
    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16) for a in (q, k, v))
    out, lse = wgmma_forward_emulated(tq, tk, tv, causal=causal, q_offset=off)
    pallas, layer = _repro_pair(*(t.float().numpy() for t in (tq, tk, tv)),
                                causal, off, bq, bk)
    assert out.dtype == torch.bfloat16 and out.shape == (B, Sq, Hq, D)
    for want in (pallas, layer):
        assert_allclose(out.float(), want, rtol=2.0 ** -7, atol=1e-4)
    _, plain_lse = flash_attention_plain(tq, tk, tv, causal=causal,
                                         q_offset=off, return_lse=True)
    assert_allclose(lse, plain_lse, rtol=TOL, atol=TOL)
