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
  * The patch roles of conv_backward: `plan` sends exactly the
    non-overlapping convs (S = K, P = 0, D = 1; at S = K = 14, 4, 2 and
    1x1 at S = 1) with Cout >= PATCH_MIN_COUT to them and keeps every
    other geometry and op on its roles; their tile counts; and
    `split_conv_backward_plain` at their splits (dx over chunks of Cout,
    dW over chunks of positions) against `repro`'s `reference` backward
    (and `xla_zero_free`'s) under a bias and each epilogue of
    `test_epilogue.py`'s grid -- frames that S does not divide (dx 0
    past the last patch), Cin 3, Cout 8 and 32.

Inputs come from numpy seeds.  Tolerance: rtol = atol = 2e-4, as in
`test_torch_backward.py` (dW sums over B*O*O products in another order);
the patch roles' emulation at rtol = atol = 1e-4 (fp32, sums of at most
a few hundred terms).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import BACKWARD_GRID, backward_case
from conftest import assert_allclose
from repro.core import spec as jspec
from repro_torch.core.spec import ConvSpec, Epilogue
from repro_torch.kernels.dconv_backward import (CHANNEL_TILE, GEMM_BK,
                                                MAX_SPLITS, PATCH,
                                                PATCH_MIN_COUT, SMALL,
                                                SQUARE, TALL, THIN, TILES,
                                                BackwardPlan, candidates,
                                                counted, non_overlapping,
                                                patch_m_tiles, patch_plan,
                                                phase_classes, plan,
                                                split_chunk,
                                                split_conv_backward_plain,
                                                split_filter_grad_plain)
from test_epilogue import EPILOGUES

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


# -- the patch roles ----------------------------------------------------------

# (name, B, (H, W), Cin, Cout, K) at S = K, P = 0, D = 1 that `plan` sends
# to the patch roles: patchify's layer, S = K = 4 on a 15 x 15 frame, S =
# K = 2 with ragged channels, a 1x1 conv at S = 1.
PATCH_ROUTED = [("patchify", 8, (448, 448), 3, 1024, 14),
                ("s4_frame15", 2, (15, 15), 3, 32, 4),
                ("s2_ragged", 3, (17, 16), 5, 37, 2),
                ("conv1x1_s1", 4, (20, 20), 48, 64, 1)]
# (name, B, (H, W), Cin, Cout, K, S, P, D) that keep the residue-class
# roles: S != K, P > 0, D > 1, and the atrous head's 1x1 fuse (Cout 4 <
# PATCH_MIN_COUT).
PATCH_KEPT = [("s2_k4", 2, (16, 16), 3, 32, 4, 2, 0, 1),
              ("s4_k2", 2, (16, 16), 3, 32, 2, 4, 0, 1),
              ("s2_k2_p1", 2, (16, 16), 3, 32, 2, 2, 1, 1),
              ("s2_k2_d2", 2, (16, 16), 3, 32, 2, 2, 0, 2),
              ("atrous_fuse", 16, (128, 128), 48, 4, 1, 1, 0, 1)]


@pytest.mark.parametrize("case", PATCH_ROUTED, ids=lambda c: c[0])
def test_plan_routes_non_overlapping_convs_to_the_patch_roles(case):
    _, B, hw, cin, cout, k = case
    spec = _spec(k, k, 0, 1)
    oh, ow = spec.out_size(hw)
    assert non_overlapping(spec) and cout >= PATCH_MIN_COUT
    for bias in (False, True):
        p = _plan("conv_backward", B, hw, cin, cout, spec, bias)
        assert (p.tile, p.dw_tile) == (PATCH, PATCH)
        assert p == patch_plan(spec, B, (oh, ow), cin, cout, bias)
        # dx: (B*Oh*Ow) x (K*K*Cin) in 128 x 128 tiles; dW: tiles of whole
        # runs of K*Cin rows x Cout.
        assert p.tiles == -(-B * oh * ow // 128) * -(-k * k * cin // 128)
        run = k * cin
        per = 128 // run
        assert p.dw_tiles == (-(-k // per) if per else k * -(-run // 128)) \
            * -(-cout // 128)
        assert p.tickets == p.tiles + p.dw_tiles + p.db_tiles
        _check_split(cout, p.splits)
        _check_split(B * oh * ow, p.dw_splits, p.chunk)
        assert p.workspace == (p.tiles * p.splits * 128 * 128
                               if p.splits > 1 else 0) \
            + ((p.dw_tiles * 128 * 128 + p.db_tiles * CHANNEL_TILE)
               * p.dw_splits if p.dw_splits > 1 else 0)
        # The other ops keep their roles at the same geometry.
        for op in ("tconv_backward", "filter_grad"):
            q = _plan(op, B, hw, cin, cout, spec, bias)
            assert PATCH not in (q.tile, q.dw_tile)


def test_the_patchify_plan():
    """320 dx tiles (64 x 5) of K = 1024 unsplit; 40 dW tiles (5 x 8, 3
    runs of 42 rows a tile) over 8192 positions in 8 chunks of 1024."""
    spec = _spec(14, 14, 0, 1)
    assert _plan("conv_backward", 8, (448, 448), 3, 1024, spec) == \
        BackwardPlan(PATCH, 1, PATCH, 8, 1024, 320, 40, 0, 5242880)
    assert patch_m_tiles(14, 42, 128) == 5 and patch_m_tiles(3, 390, 128) \
        == 12


@pytest.mark.parametrize("case", PATCH_KEPT, ids=lambda c: c[0])
def test_plan_keeps_other_geometries_on_their_roles(case):
    _, B, hw, cin, cout, k, s, p, d = case
    spec = _spec(k, s, p, d)
    for op in OPS:
        for bias in (False, True):
            q = _plan(op, B, hw, cin, cout, spec, bias)
            assert PATCH not in (q.tile, q.dw_tile)
            _check_plan(op, q, B, hw, cin, cout, spec, bias)


def test_candidates_hold_both_roles_at_a_non_overlapping_conv():
    """Patchify's candidates: the plan's own first, the patch roles at
    every split pair, then every residue-class candidate (the tile cache's
    older rows stay candidates); other geometries' sets are unchanged."""
    spec = _spec(14, 14, 0, 1)
    got = candidates("conv_backward", spec, 8, (32, 32), 3, 1024,
                     n_out=(448, 448))
    assert got[0] == _plan("conv_backward", 8, (448, 448), 3, 1024, spec)
    patch = [c for c in got if c.tile == PATCH]
    assert {(c.splits, c.dw_splits) for c in patch} == {
        (s, d) for s in (1, 2, 4, 8, 16) for d in (4, 8, 16, 32, 64)}
    rest = [c for c in got if c.tile != PATCH]
    assert rest and all(c.tile == THIN and c.dw_tile in (SMALL, SQUARE)
                        for c in rest)
    fuse = _spec(1, 1, 0, 1)
    got = candidates("conv_backward", fuse, 16, (128, 128), 48, 4,
                     n_out=(128, 128))
    assert got[0].tile == TALL and any(c.tile == PATCH for c in got)


def test_counted_refuses_patch_tiles_the_kernel_refuses():
    for spec, op, dw in ((_spec(4, 2, 1, 1), "conv_backward", PATCH),
                         (_spec(4, 4, 0, 1), "tconv_backward", PATCH),
                         (_spec(4, 4, 0, 1), "conv_backward", SQUARE)):
        with pytest.raises(ValueError, match="patch roles"):
            counted(op, spec, 2, (4, 4), 3, 32, PATCH, 1, dw)


# (name, B, (H, W), Cin, Cout, K) of the emulation: frames S does not
# divide (15 at S = K = 4: dx 0 on the last 3 rows and columns; 9 at
# S = K = 2), patchify's S = K = 14 at two patches a side, a 1x1 conv.
PATCH_EMULATED = [("s4_frame15_cout32", 2, (15, 15), 3, 32, 4),
                  ("s4_frame15_cout8", 2, (15, 15), 3, 8, 4),
                  ("s14_frame30", 1, (30, 29), 3, 8, 14),
                  ("s2_frame9", 2, (9, 9), 3, 32, 2),
                  ("conv1x1_s1", 2, (6, 6), 5, 32, 1)]


def _patch_operands(case, seed):
    _, B, (H, W), cin, cout, k = case
    oh, ow = H // k, W // k
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return (_spec(k, k, 0, 1), (oh, ow), r(B, H, W, cin), r(k, k, cin, cout),
            r(B, oh, ow, cout), r(B, oh, ow, cout))


def _patch_plans(spec, B, oh_ow, cin, cout, bias):
    """`patch_plan`'s and one with both reductions split as far as
    their lengths let every split hold a slab."""
    positions = B * oh_ow[0] * oh_ow[1]
    splits = 2 if cout > split_chunk(cout, 2) else 1
    dw = next(d for d in (4, 2, 1)
              if d == 1 or (d - 1) * split_chunk(positions, d) < positions)
    return [patch_plan(spec, B, oh_ow, cin, cout, bias),
            counted("conv_backward", spec, B, oh_ow, cin, cout, PATCH,
                    splits, PATCH, dw, bias=bias)]


def _repro_backward(backend, x, y, dy, w, spec_k, n_out, ep):
    js = jspec.ConvSpec.make(stride=spec_k, padding=0, filter_shape=spec_k)
    be = jspec.resolve_backend(backend)
    if ep is None:
        return be.backward(jnp.asarray(x), jnp.asarray(dy), jnp.asarray(w),
                           js, n_out) + (None,)
    return be.backward_ep(jnp.asarray(x), jnp.asarray(y), jnp.asarray(dy),
                          jnp.asarray(w), js, n_out, ep)


def _check_emulation(case, backend, je, seed):
    spec, oh_ow, x, w, dy, y = _patch_operands(case, seed)
    _, B, hw, cin, cout, k = case
    if je is not None and je.activation == "tanh":
        y = np.tanh(y)
    te = None if je is None else Epilogue(activation=je.activation,
                                          bias=je.bias, slope=je.slope,
                                          scale=je.scale)
    want = _repro_backward(backend, x, y, dy, w, k, hw, je)
    tx, tdy, tw, ty = (torch.tensor(a) for a in (x, dy, w, y))
    for p in _patch_plans(spec, B, oh_ow, cin, cout, te is not None
                          and te.bias):
        got = split_conv_backward_plain(
            tx, tdy, tw, spec, p, n_out=hw,
            y=ty if te is not None and te.needs_y else None, epilogue=te)
        for a, b, name in zip(got, want, ("dx", "dW", "db")):
            if b is None:
                assert a is None, name
                continue
            assert tuple(a.shape) == tuple(b.shape), name
            assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=name)
        dx = got[0]
        assert not dx[:, oh_ow[0] * k:].any()
        assert not dx[:, :, oh_ow[1] * k:].any()


@pytest.mark.parametrize("kind", [None] + [k for k, _ in EPILOGUES])
@pytest.mark.parametrize("case", PATCH_EMULATED, ids=lambda c: c[0])
def test_patch_split_order_matches_reference(case, kind):
    """The patch roles' split sums under no epilogue and each of
    test_epilogue.py's six (bias, activations, slope, scale) against
    repro's `reference` backward."""
    je = None if kind is None else dict(EPILOGUES)[kind]
    _check_emulation(case, "reference", je, 31)


@pytest.mark.parametrize("case", PATCH_EMULATED, ids=lambda c: c[0])
def test_patch_split_order_matches_xla_zero_free(case):
    _check_emulation(case, "xla_zero_free", dict(EPILOGUES)["bias_leaky02"],
                     32)
