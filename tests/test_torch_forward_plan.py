"""The forward kernels' plan and split-order arithmetic, on the CPU.

`tconv_phase` and `dconv_forward` launch the dx and ddy roles of the
tiled implicit-GEMM engine (`csrc/conv_body.cuh`) alone, with tiles and
splits from `dconv_backward.plan`:

  * `plan` for the two forward ops at the layers `chip_smoke.py` runs
    (the generator's t1 and t2 and the ASPP branches at the serving slot
    batch 4; t1, t2, discriminator c1-c3 and CNN l1-l3 at batch 64), and
    its invariants over `TCONV_GRID` and `FWD_GRID`: every output stored
    by exactly one tile (the kernels' tile decode, repeated here in
    numpy), the chunks covering each reduction once with no split empty,
    at most MAX_SPLITS splits, no dW or db tiles, the workspace and
    tickets the kernels count.
  * `dconv_backward.split_forward_plain`, the kernels' split reduction
    (partials over consecutive k-chunks, added in split order, then the
    epilogue once), against `repro`'s `xla_zero_free` backend under each
    of `EP_KW`'s four epilogues, at the plan's split and at an 8-way
    split; among the cases, the bias fill at residues no tap reaches
    (S = 3, K = 2) and a non-exact n_out tail.

Inputs come from numpy seeds.  Tolerance: rtol = atol = 1e-4 (fp32 sums
in another order).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import EP_KW, FWD_GRID, TCONV_GRID, tconv_case
from conftest import assert_allclose
from repro.core import spec as jspec
from repro_torch.core.spec import ConvSpec, Epilogue
from repro_torch.kernels.dconv_backward import (GEMM_BK, HALF, MAX_SPLITS,
                                                TALL, THIN, TILES,
                                                BackwardPlan, phase_classes,
                                                plan, split_chunk,
                                                split_forward_plain)

TOL = 1e-4


def _cdiv(a, b):
    return -(-a // b)


def _spec(k, s, p, d):
    return ConvSpec.make(stride=s, padding=p, filter_shape=k, dilation=d)


def _tconv_plan(spec, B, o, n_out, cin, cout):
    return plan("tconv_phase", spec, B, n_out, o, cin, cout, n_out=n_out)


def _fwd_plan(spec, B, hw, cin, cout):
    return plan("dconv_forward", spec, B, hw, spec.out_size(hw), cin, cout)


# (op, B, (dy side or x side), Cin, Cout, K, S, P, D) -> (tile, splits,
# tiles, workspace).  tconv_phase: 128 x 32 tiles over the four residue
# classes, split towards 2 * 132 CTAs where they are fewer than 66, at
# least 32 of k each (16 ways for t1 at B = 4, 8 for t2, 4 for t1 at
# B = 64); dconv_forward:
# the ASPP branches (3 -> 16 at 128 x 128) on 256 x 16, the training
# layers on 128 x 32, split 4 or 8 ways at Cout 64 / 128.
MAIN_PATH = [
    ("gan_t1_B4", ("tconv_phase", 4, (4, 4), 64, 128, 4, 2, 1, 1),
     (TALL, 16, 8, 524288)),
    ("gan_t2_B4", ("tconv_phase", 4, (8, 8), 32, 64, 4, 2, 1, 1),
     (TALL, 8, 8, 262144)),
    ("aspp_rate1_B4", ("dconv_forward", 4, (128, 128), 3, 16, 3, 1, 1, 1),
     (HALF, 1, 256, 0)),
    ("aspp_rate2_B4", ("dconv_forward", 4, (128, 128), 3, 16, 3, 1, 2, 2),
     (HALF, 1, 256, 0)),
    ("aspp_rate4_B4", ("dconv_forward", 4, (128, 128), 3, 16, 3, 1, 4, 4),
     (HALF, 1, 256, 0)),
    ("gan_t1_B64", ("tconv_phase", 64, (4, 4), 64, 128, 4, 2, 1, 1),
     (TALL, 4, 64, 1048576)),
    ("gan_t2_B64", ("tconv_phase", 64, (8, 8), 32, 64, 4, 2, 1, 1),
     (TALL, 1, 128, 0)),
    ("disc_c1_B64", ("dconv_forward", 64, (32, 32), 3, 32, 4, 2, 1, 1),
     (TALL, 1, 128, 0)),
    ("disc_c2_B64", ("dconv_forward", 64, (16, 16), 32, 64, 4, 2, 1, 1),
     (TALL, 4, 64, 1048576)),
    ("disc_c3_B64", ("dconv_forward", 64, (8, 8), 64, 128, 4, 2, 1, 1),
     (TALL, 8, 32, 1048576)),
    ("cnn_l1_B64", ("dconv_forward", 64, (32, 32), 3, 32, 3, 2, 1, 1),
     (TALL, 1, 128, 0)),
    ("cnn_l2_B64", ("dconv_forward", 64, (16, 16), 32, 64, 3, 2, 1, 1),
     (TALL, 4, 64, 1048576)),
    ("cnn_l3_B64", ("dconv_forward", 64, (8, 8), 64, 128, 3, 2, 1, 1),
     (TALL, 8, 32, 1048576)),
]


@pytest.mark.parametrize("case,want", [c[1:] for c in MAIN_PATH],
                         ids=[c[0] for c in MAIN_PATH])
def test_plan_at_the_main_path_layers(case, want):
    op, B, hw, cin, cout, k, s, p, d = case
    spec = _spec(k, s, p, d)
    if op == "tconv_phase":
        got = _tconv_plan(spec, B, hw, spec.input_size(hw), cin, cout)
    else:
        got = _fwd_plan(spec, B, hw, cin, cout)
    tile, splits, tiles, workspace = want
    assert got == BackwardPlan(tile, splits, -1, 1, 0, tiles, 0, 0,
                               workspace)


# -- the kernels' tile decode, repeated in numpy --------------------------------

def _class_rows(n, s, p_, r):
    """(first, count) of the phase rows m >= 0 with 0 <= m*s + r - p_ < n,
    found by trying every m (they must be consecutive)."""
    rows = [m for m in range(n + p_ + s) if 0 <= m * s + r - p_ < n]
    lo = rows[0] if rows else 0
    assert rows == list(range(lo, lo + len(rows)))
    return lo, len(rows)


def _dx_stores(p, spec, B, n_out, cin):
    """How many times tconv_phase's launch of plan p stores each dx
    element: tiles over the residue classes in (p, q) order, each class's
    rows m = (b, mh, mw) in BM-row blocks, Cin in BN-column blocks, n
    fastest (conv_body.cuh::dx_tile)."""
    bm, bn = TILES[p.tile]
    (sh, sw), (ph, pw) = spec.stride, spec.padding
    nh, nw = n_out
    counts = np.zeros(B * nh * nw * cin, np.int64)
    n_tiles, tiles = _cdiv(cin, bn), 0
    for cls in range(sh * sw):
        r, q = divmod(cls, sw)
        lo_h, hc = _class_rows(nh, sh, ph, r)
        lo_w, wc = _class_rows(nw, sw, pw, q)
        rows = B * hc * wc
        for t in range(_cdiv(rows, bm) * n_tiles):
            m = np.arange((t // n_tiles) * bm, (t // n_tiles + 1) * bm)
            n = np.arange((t % n_tiles) * bn, (t % n_tiles + 1) * bn)
            m, n = m[m < rows], n[n < cin]
            b, rem = m // (hc * wc), m % (hc * wc)
            y = (lo_h + rem // wc) * sh + r - ph
            x = (lo_w + rem % wc) * sw + q - pw
            assert ((0 <= y) & (y < nh) & (0 <= x) & (x < nw)).all()
            flat = ((b * nh + y) * nw + x)[:, None] * cin + n[None, :]
            np.add.at(counts, flat.ravel(), 1)
            tiles += 1
    assert tiles == p.tiles
    return counts


def _y_stores(p, B, oh_ow, cout):
    """How many times dconv_forward's launch of plan p stores each output:
    rows m = (b, i, j) in BM-row blocks, Cout in BN-column blocks, n
    fastest (conv_body.cuh::ddy_tile)."""
    bm, bn = TILES[p.tile]
    rows = B * oh_ow[0] * oh_ow[1]
    counts = np.zeros(rows * cout, np.int64)
    n_tiles = _cdiv(cout, bn)
    assert p.tiles == _cdiv(rows, bm) * n_tiles
    for t in range(p.tiles):
        m = np.arange((t // n_tiles) * bm, (t // n_tiles + 1) * bm)
        n = np.arange((t % n_tiles) * bn, (t % n_tiles + 1) * bn)
        m, n = m[m < rows], n[n < cout]
        np.add.at(counts, (m[:, None] * cout + n[None, :]).ravel(), 1)
    return counts


def _check_split(k, splits):
    """`splits` chunks of whole slabs cover [0, k) once, none empty."""
    chunk = split_chunk(k, splits)
    assert chunk % GEMM_BK == 0 and chunk > 0
    assert (splits - 1) * chunk < k
    covered = [0] * k
    for s in range(splits):
        for i in range(s * chunk, min(k, (s + 1) * chunk)):
            covered[i] += 1
    assert covered == [1] * k


def _check_plan(p, n, ks):
    """The invariants every forward plan keeps: N channels, the
    reductions `ks` (one per residue class for tconv_phase)."""
    assert (p.dw_tile, p.dw_splits, p.chunk, p.dw_tiles, p.db_tiles) == \
        (-1, 1, 0, 0, 0)
    assert p.tile == (THIN if n <= 4 else HALF if n <= 16 else TALL)
    assert 1 <= p.splits <= MAX_SPLITS
    # Every class's reduction is cut the same way; the longest one's
    # splits are all non-empty.
    assert all(p.splits * split_chunk(k, p.splits) >= k for k in ks)
    _check_split(max(ks), p.splits)
    bm, bn = TILES[p.tile]
    assert p.workspace == (p.tiles * p.splits * bm * bn
                           if p.splits > 1 else 0)
    assert p.tickets == p.tiles


@pytest.mark.parametrize("batch", ["grid", 64])
@pytest.mark.parametrize("geom", TCONV_GRID)
def test_tconv_phase_plan_invariants(geom, batch):
    spec, n_out, dy, w, _ = tconv_case(geom, 0)
    B = dy.shape[0] if batch == "grid" else batch
    o, cin, cout = dy.shape[1:3], w.shape[2], w.shape[3]
    p = _tconv_plan(spec, B, o, n_out, cin, cout)
    classes = phase_classes(spec, n_out)
    _check_plan(p, cin, [taps * cout for _, _, taps in classes])
    assert (_dx_stores(p, spec, B, n_out, cin) == 1).all()


@pytest.mark.parametrize("batch", [3, 64])
@pytest.mark.parametrize("geom", FWD_GRID)
def test_dconv_forward_plan_invariants(geom, batch):
    s, d, k, p_ = geom
    spec = _spec(k, s, p_, d)
    for cin, cout in ((5, 7), (3, 16), (40, 100)):
        p = _fwd_plan(spec, batch, (17, 13), cin, cout)
        _check_plan(p, cout, [spec.filter_shape[0] * spec.filter_shape[1]
                              * cin])
        assert (_y_stores(p, batch, spec.out_size((17, 13)), cout)
                == 1).all()


# -- the split reduction against repro ------------------------------------------

# (stride, dilation, filter, padding, batch, dy size, Cin, Cout, n_out
# slack), as TCONV_GRID: a residue no tap reaches (S = 3 > K = 2, exact
# fit), a non-exact n_out tail (a row and a column past the full frame),
# and a reduction the plan splits (4 taps x 96 = 384, 12 ways).
TCONV_SPLIT_CASES = [
    ("bias_fill_s3_k2", (3, 1, 2, 0, 2, (4, 4), 3, 40, 0)),
    ("nonexact_tail", (2, 1, 3, 0, 2, (4, 4), 3, 48, 1)),
    ("plan_splits", (2, 1, 4, 1, 1, (3, 3), 6, 96, 0)),
] + [(f"grid{i}", g) for i, g in enumerate(TCONV_GRID)]


def _eps(kw):
    if kw is None:
        return None, None
    return Epilogue(**kw), jspec.Epilogue(**kw)


def _jspec(spec):
    return jspec.ConvSpec.make(stride=spec.stride, padding=spec.padding,
                               filter_shape=spec.filter_shape,
                               dilation=spec.dilation)


def _splits_of(split, p):
    """(splits, slab): the plan's, or 8 chunks of any length."""
    return (p.splits, GEMM_BK) if split == "plan" else (8, 1)


@pytest.mark.parametrize("split", ["plan", "eight_way"])
@pytest.mark.parametrize("name,geom", TCONV_SPLIT_CASES,
                         ids=[c[0] for c in TCONV_SPLIT_CASES])
def test_split_tconv_phase_matches_xla_zero_free(name, geom, split):
    spec, n_out, dy, w, bias = tconv_case(geom, 17)
    o, cin, cout = dy.shape[1:3], w.shape[2], w.shape[3]
    p = _tconv_plan(spec, dy.shape[0], o, n_out, cin, cout)
    classes = phase_classes(spec, n_out)
    if name == "bias_fill_s3_k2":
        assert any(taps == 0 for _, _, taps in classes)
    elif name == "nonexact_tail":
        full = spec.full_size(o)
        assert all(spec.padding[a] + n_out[a] > full[a] for a in range(2))
    elif name == "plan_splits":
        assert p.splits > 1
    splits, slab = _splits_of(split, p)
    base = jspec.resolve_backend("xla_zero_free")
    plain = base.input_grad(jnp.asarray(dy), jnp.asarray(w), _jspec(spec),
                            n_out)
    for kw in EP_KW:
        te, je = _eps(kw)
        b = bias if te is not None and te.bias else None
        got = split_forward_plain(
            "tconv_phase", torch.tensor(dy), torch.tensor(w), spec, splits,
            n_out=n_out, bias=None if b is None else torch.tensor(b),
            epilogue=te, slab=slab)
        want = plain if je is None else je.apply(
            plain, None if b is None else jnp.asarray(b))
        assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL,
                        err_msg=f"{name} {split} {kw}")


@pytest.mark.parametrize("split", ["plan", "eight_way"])
@pytest.mark.parametrize("geom", FWD_GRID + [(2, 1, 3, 1)])
def test_split_dconv_forward_matches_xla_zero_free(geom, split):
    """FWD_GRID at Cin 5 / Cout 7, and a reduction the plan splits
    (3 x 3 taps x 64 channels = 576, at one tile of 16 positions)."""
    s, d, k, p_ = geom
    spec = _spec(k, s, p_, d)
    cin, cout, hw = (5, 7, (11, 9)) if geom in FWD_GRID else (64, 24, (8, 8))
    rng = np.random.default_rng(23)
    x = rng.standard_normal((2,) + hw + (cin,)).astype(np.float32)
    w = rng.standard_normal(spec.filter_shape + (cin, cout)).astype(
        np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    p = _fwd_plan(spec, 2, hw, cin, cout)
    if geom not in FWD_GRID:
        assert p.splits > 1
    splits, slab = _splits_of(split, p)
    base, js = jspec.resolve_backend("xla_zero_free"), _jspec(spec)
    for kw in EP_KW:
        te, je = _eps(kw)
        b = bias if te is not None and te.bias else None
        got = split_forward_plain(
            "dconv_forward", torch.tensor(x), torch.tensor(w), spec, splits,
            bias=None if b is None else torch.tensor(b), epilogue=te,
            slab=slab)
        want = base.forward(jnp.asarray(x), jnp.asarray(w), js) \
            if je is None else base.forward_ep(
                jnp.asarray(x), jnp.asarray(w),
                None if b is None else jnp.asarray(b), js, je)
        assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL,
                        err_msg=f"{geom} {split} {kw}")


def test_split_forward_plain_refuses_a_backward_op():
    x, w = torch.zeros((1, 4, 4, 2)), torch.zeros((3, 3, 2, 2))
    with pytest.raises(ValueError, match="forward"):
        split_forward_plain("conv_backward", x, w, _spec(3, 1, 1, 1), 2)
