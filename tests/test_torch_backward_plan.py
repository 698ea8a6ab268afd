"""The fused conv backwards' plan and split-position dW, on the CPU.

  * `dconv_backward.plan`, the rule that picks each launch's tiles and
    how many CTAs split each tile's reduction: the nine main-path layers
    of conv training, the plan's edges (a position count the split count
    does not divide, Cin = 3, ragged channels), and its invariants over
    `BACKWARD_GRID`: every dx pixel in exactly one residue class, every
    output covered by one tile, at most MAX_SPLITS splits, the chunks
    covering each reduction exactly with no split empty, a thin N on the
    thin tile, the workspace and tickets the kernels count.
  * `dconv_backward.split_filter_grad_plain`, the split's arithmetic
    (partials per chunk of positions, added in split order), against
    `repro`'s `reference` filter gradient over `BACKWARD_GRID`, at the
    plan's split and at an eight-way split.

Inputs come from numpy seeds.  Tolerance: rtol = atol = 2e-4, as in
`test_torch_backward.py` (dW sums over B*O*O products in another order).
"""
from __future__ import annotations

import jax.numpy as jnp
import pytest
import torch

from _torch_cases import BACKWARD_GRID, backward_case
from conftest import assert_allclose
from repro.core import spec as jspec
from repro_torch.core.spec import ConvSpec
from repro_torch.kernels.dconv_backward import (CHANNEL_TILE, GEMM_BK,
                                                MAX_SPLITS, SMALL, SQUARE,
                                                TALL, THIN, TILES,
                                                BackwardPlan,
                                                phase_classes, plan,
                                                split_chunk,
                                                split_filter_grad_plain)

TOL = 2e-4
OPS = ("conv_backward", "tconv_backward", "filter_grad")

# (op, B, big side (H, W), Cin, Cout, K) -> plan: the nine main-path
# layers at batch 64, all S = 2, P = 1, no bias.  dx / ddy: 256 x 4 at
# N = 3, else 128 x 32, split only where the tiles are fewer than 66
# (4 ways at 64 tiles, 8 at 32); dW: 64 x 32 at Cout = 32, else 64 x 64,
# split towards 128 CTAs (64 ways for the one tile of the Cin = 3
# layers); every split a power of two.
MAIN_PATH = [
    (("conv_backward", 64, (32, 32), 3, 32, 4),
     (THIN, 1, SMALL, 64, 256, 256, 1, 0, 131072)),
    (("conv_backward", 64, (16, 16), 32, 64, 4),
     (TALL, 1, SQUARE, 16, 256, 128, 8, 0, 524288)),
    (("conv_backward", 64, (8, 8), 64, 128, 4),
     (TALL, 4, SQUARE, 4, 256, 64, 32, 0, 1572864)),
    (("conv_backward", 64, (32, 32), 3, 32, 3),
     (THIN, 1, SMALL, 64, 256, 256, 1, 0, 131072)),
    (("conv_backward", 64, (16, 16), 32, 64, 3),
     (TALL, 1, SQUARE, 16, 256, 128, 5, 0, 327680)),
    (("conv_backward", 64, (8, 8), 64, 128, 3),
     (TALL, 4, SQUARE, 4, 256, 64, 18, 0, 1343488)),
    (("tconv_backward", 64, (8, 8), 64, 128, 4),
     (TALL, 8, SQUARE, 4, 256, 32, 32, 0, 1572864)),
    (("tconv_backward", 64, (16, 16), 32, 64, 4),
     (TALL, 4, SQUARE, 16, 256, 64, 8, 0, 1572864)),
    (("tconv_backward", 64, (32, 32), 3, 32, 4),
     (TALL, 1, SMALL, 64, 256, 128, 1, 0, 131072)),
]
MAIN_IDS = ["disc_c1", "disc_c2", "disc_c3", "cnn_l1", "cnn_l2", "cnn_l3",
            "gan_t1", "gan_t2", "gan_t3"]

# The plan's edges: 7 * 13 * 13 = 1183 positions, which the split count
# does not divide (4 splits of 304, the last 271); Cin = 3 at B = 16;
# Cin 130 / Cout 37 ragged (chip_smoke.py's ragged_channels).
EDGES = [("positions_1183", 7, (26, 26), 8, 16, 3, 2, 1, 1),
         ("cin3_b16", 16, (32, 32), 3, 32, 4, 2, 1, 1),
         ("ragged_channels", 2, (9, 9), 130, 37, 3, 2, 1, 1)]


def _spec(k, s, p, d):
    return ConvSpec.make(stride=s, padding=p, filter_shape=k, dilation=d)


def _plan(op, B, hw, cin, cout, spec, bias=False):
    return plan(op, spec, B, hw, spec.out_size(hw), cin, cout, n_out=hw,
                bias=bias)


@pytest.mark.parametrize("case,want", MAIN_PATH, ids=MAIN_IDS)
def test_plan_at_the_main_path_layers(case, want):
    op, B, hw, cin, cout, k = case
    assert _plan(op, B, hw, cin, cout, _spec(k, 2, 1, 1)) == \
        BackwardPlan(*want)


def _check_split(k, splits, chunk=None):
    """`splits` chunks of whole slabs cover [0, k) once, none empty."""
    chunk = split_chunk(k, splits) if chunk is None else chunk
    assert 1 <= splits <= MAX_SPLITS
    assert chunk % GEMM_BK == 0 and (k == 0 or chunk > 0)
    assert splits == 1 or (splits - 1) * chunk < k
    covered = [0] * k
    for s in range(splits):
        for i in range(s * chunk, min(k, (s + 1) * chunk)):
            covered[i] += 1
    assert covered == [1] * k


def _check_plan(op, p, B, hw, cin, cout, spec, bias):
    """The invariants of one plan."""
    oh, ow = spec.out_size(hw)
    positions = B * oh * ow
    kh, kw = spec.filter_shape
    _check_split(positions, p.dw_splits, p.chunk)
    assert p.chunk == split_chunk(positions, p.dw_splits)
    # dW tiles cover (Kh*Kw*Cin) x Cout; db tiles the bias channels.
    dbm, dbn = TILES[p.dw_tile]
    assert p.dw_tile in (SMALL, SQUARE)
    assert p.dw_tiles == -(-kh * kw * cin // dbm) * -(-cout // dbn)
    channels = cin if op == "tconv_backward" else cout
    assert p.db_tiles == (-(-channels // CHANNEL_TILE)
                          if bias and op != "filter_grad" else 0)
    assert p.tickets == p.tiles + p.dw_tiles + p.db_tiles
    ws = (p.dw_tiles * dbm * dbn + p.db_tiles * CHANNEL_TILE) \
        * p.dw_splits if p.dw_splits > 1 else 0
    if op == "filter_grad":
        assert (p.tile, p.tiles, p.splits) == (-1, 0, 1)
        assert p.workspace == ws
        return
    n = cin if op == "conv_backward" else cout
    bm, bn = TILES[p.tile]
    assert p.tile in (THIN, TALL)
    assert (p.tile == THIN) == (n <= 4)         # a thin N: a thin tile
    if op == "conv_backward":
        classes = phase_classes(spec, hw)
        # Every dx pixel lies in exactly one residue class.
        assert sum(hc * wc for hc, wc, _ in classes) == hw[0] * hw[1]
        rows = [B * hc * wc for hc, wc, _ in classes]
        ks = [taps * cout for _, _, taps in classes]
    else:
        rows, ks = [positions], [kh * kw * cin]
    assert p.tiles == sum(-(-r // bm) for r in rows) * -(-n // bn)
    # Each class's reduction is cut the same way; only the longest one's
    # splits are all non-empty.
    assert all(p.splits * split_chunk(k, p.splits) >= k for k in ks)
    _check_split(max(ks), p.splits)
    assert p.workspace == ws + (p.tiles * p.splits * bm * bn
                                if p.splits > 1 else 0)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("geom", BACKWARD_GRID, ids=lambda g: g[0])
def test_plan_invariants_over_the_backward_grid(geom, op):
    _, B, N, K, S, P, D, ci, co = geom
    spec = _spec(K, S, P, D)
    for bias in (False, True):
        p = _plan(op, B, (N, N), ci, co, spec, bias)
        _check_plan(op, p, B, (N, N), ci, co, spec, bias)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("edge", EDGES, ids=lambda e: e[0])
def test_plan_at_its_edges(edge, op):
    _, B, hw, ci, co, K, S, P, D = edge
    spec = _spec(K, S, P, D)
    for bias in (False, True):
        p = _plan(op, B, hw, ci, co, spec, bias)
        _check_plan(op, p, B, hw, ci, co, spec, bias)
    positions = B * spec.out_size(hw)[0] * spec.out_size(hw)[1]
    if edge[0] == "positions_1183":
        assert p.dw_splits > 1 and positions % p.dw_splits and \
            positions % p.chunk


def test_classes_a_tap_never_reaches_are_empty():
    """K = 2 < S = 4: residues 2 and 3 of each axis get no tap."""
    taps = [t for _, _, t in phase_classes(_spec(2, 4, 0, 1), (12, 12))]
    assert taps == [1, 1, 0, 0] * 2 + [0] * 8


def _reference_filter_grad(c):
    S, P, K, D = c["spec"]
    js = jspec.ConvSpec.make(stride=S, padding=P, filter_shape=K,
                             dilation=D)
    return jspec.resolve_backend("reference").filter_grad(
        jnp.asarray(c["x"]), jnp.asarray(c["dy"]), js)


@pytest.mark.parametrize("split", ["plan", "eight_way"])
@pytest.mark.parametrize("geom", BACKWARD_GRID, ids=lambda g: g[0])
def test_split_filter_grad_matches_reference(geom, split):
    c = backward_case(geom, 21)
    S, P, K, D = c["spec"]
    spec = _spec(K, S, P, D)
    x, dy = torch.tensor(c["x"]), torch.tensor(c["dy"])
    p = plan("filter_grad", spec, x.shape[0], x.shape[1:3], dy.shape[1:3],
             x.shape[3], dy.shape[3])
    if split == "eight_way":      # chunks of any length, not whole slabs
        positions = dy.shape[0] * dy.shape[1] * dy.shape[2]
        chunk = -(-positions // 8)
        p = p._replace(dw_splits=-(-positions // chunk), chunk=chunk)
        assert p.dw_splits > 1
    got = split_filter_grad_plain(x, dy, spec, p)
    assert_allclose(got, _reference_filter_grad(c), rtol=TOL, atol=TOL)
