"""The implicit-GEMM transposed conv's plan and decomposition, on the CPU.

`csrc/implicit_gemm.cu` runs one CTA per tile of TH x TW output sites and
Cin_t output channels, stages the tile's dy halo and the weights one Cout
chunk at a time, and lets each thread sum one site over the taps its
stride residue makes live.  No card is needed here:

  * `implicit_gemm.plan` at the shapes `chip_smoke.py` runs (the
    generator's t3 at the serving slot batch 4 and at batch 64, t1 and t2
    as the race's other layers, the ragged cases) and over `TCONV_GRID`:
    every output element stored by exactly one CTA (the kernel's thread
    decode, repeated in numpy), the Cout chunks covering Cout once, the
    halo holding every dy row and column a live (site, tap) lane reads
    (found by enumerating the lanes), and the shared memory within the
    plan's limit.
  * `_emulate`, the kernel's decomposition in plain PyTorch -- tiles,
    zero-filled halo, chunk order, residue classes, epilogue in the store
    -- against `repro`'s `tconv_implicit_gemm_pallas(interpret=True)` and
    `ecoflow.transposed_conv_zero_free` under `EP_KW`'s epilogues, at the
    plan's own tiles and at the smallest tiles with 4-deep chunks.  Among
    the cases: residues no tap reaches (S = 3, K = 2), non-exact n_out
    tails and halos that start before dy's first row.

Inputs come from numpy seeds.  Tolerance: rtol = atol = 1e-4 (fp32 sums
in another order).
"""
from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import EP_KW, TCONV_GRID, tconv_case
from conftest import assert_allclose
from repro.core import ecoflow as jeco
from repro.core import spec as jspec
from repro.kernels.implicit_gemm import tconv_implicit_gemm_pallas
from repro_torch.core.spec import ConvSpec, Epilogue
from repro_torch.kernels import build
from repro_torch.kernels.implicit_gemm import (CHUNKS, CIN_TILES, MAX_CHUNK,
                                               MAX_THREADS, SMEM_BYTES,
                                               IGPlan, counted, halo_extent,
                                               halo_origin, plan)

TOL = 1e-4


def _cdiv(a, b):
    return -(-a // b)


def _spec(k, s, p, d):
    return ConvSpec.make(stride=s, padding=p, filter_shape=k, dilation=d)


# (B, dy side, n_out, Cin, Cout, K, S, P, D): chip_smoke.py's
# implicit-GEMM launches -- t3 on the main path, t1 and t2 timed for the
# race, the ragged cases -- and the card tests' plan edges.
SHAPES = [
    ("gan_t3_B4", (4, (16, 16), (32, 32), 3, 32, 4, 2, 1, 1)),
    ("gan_t3_B64", (64, (16, 16), (32, 32), 3, 32, 4, 2, 1, 1)),
    ("gan_t2_B4", (4, (8, 8), (16, 16), 32, 64, 4, 2, 1, 1)),
    ("gan_t2_B64", (64, (8, 8), (16, 16), 32, 64, 4, 2, 1, 1)),
    ("gan_t1_B4", (4, (4, 4), (8, 8), 64, 128, 4, 2, 1, 1)),
    ("gan_t1_B64", (64, (4, 4), (8, 8), 64, 128, 4, 2, 1, 1)),
    ("ragged_s3k2", (3, (5, 6), (14, 12), 5, 7, (2, 3), (3, 2), (1, 1), 1)),
    ("ragged_s2d2", (2, (6, 5), (14, 14), 4, 6, 3, 2, 1, (2, 3))),
    ("tconv_split_k648", (2, (4, 4), (8, 8), 24, 72, 3, 2, 1, 1)),
    ("ragged_channels", (2, (5, 5), (9, 9), 130, 37, 3, 2, 1, 1)),
    ("cout130", (2, (5, 5), (9, 9), 5, 130, 3, 2, 1, 1)),
    ("b1_64x64", (1, (32, 32), (64, 64), 3, 32, 4, 2, 1, 1)),
    ("s1_d2", (2, (20, 20), (20, 20), 5, 12, 3, 1, 2, 2)),
    ("k11_s4", (2, (6, 6), (31, 31), 5, 40, 11, 4, 0, 1)),
]


def _shape_plan(case):
    B, o, n_out, cin, cout, k, s, p, d = case
    spec = _spec(k, s, p, d)
    assert spec.out_size(n_out) == o
    return spec, B, n_out, cin, cout, plan(spec, B, n_out, o, cin, cout)


def _grid_plan(geom):
    spec, n_out, dy, w, _ = tconv_case(geom, 0)
    B, o, cout = dy.shape[0], dy.shape[1:3], dy.shape[3]
    cin = w.shape[2]
    return spec, B, n_out, cin, cout, plan(spec, B, n_out, o, cin, cout)


def test_plan_at_the_main_path_layer():
    """t3: 4 x 32 tiles, one warp of sites per residue class (128
    threads), 8 per image: 32 CTAs at the slot batch, 512 at batch 64;
    Cin = 3 in one tile, Cout = 32 in one chunk.  t1 and t2 (the race's
    other arm): 8 x 16 tiles, Cin in tiles of 8, Cout in chunks of 32
    through two stages."""
    _, _, _, _, _, p4 = _shape_plan(SHAPES[0][1])
    _, _, _, _, _, p64 = _shape_plan(SHAPES[1][1])
    assert p4 == IGPlan(4, 32, 3, 32, 32, 16512, 128, 32, (4, 18), 1)
    assert p64 == IGPlan(4, 32, 3, 32, 512, 16512, 128, 512, (4, 18), 1)
    for name, case in SHAPES[2:6]:
        p = _shape_plan(case)[-1]
        assert (p.th, p.tw, p.cin_t, p.chunk, p.threads, p.stages) == \
            (8, 16, 8, 32, 128, 2), name


def _thread_sites(p, spec):
    """Each thread's residue class (a, c) and site (u, v), as the kernel
    decodes threadIdx.x: class-major, v fastest."""
    (sh, sw) = spec.stride
    cu, cv = p.th // sh, p.tw // sw
    tid = np.arange(p.threads)
    cls, e = tid // (cu * cv), tid % (cu * cv)
    return cls // sw, cls % sw, e // cv, e % cv


def _check_plan(spec, B, n_out, cin, cout, p):
    (sh, sw), (ph, pw) = spec.stride, spec.padding
    (dh, dw), (kh, kw) = spec.dilation, spec.filter_shape
    nh, nw = n_out
    assert p.th % sh == 0 and p.tw % sw == 0
    assert p.threads == p.th * p.tw <= MAX_THREADS
    assert p.cin_t in CIN_TILES and p.cin_t >= min(cin, 4)
    assert p.chunk in CHUNKS
    assert p.smem <= SMEM_BYTES
    assert p.halo == halo_extent(spec, p.th, p.tw)
    assert p == counted(spec, B, n_out, cin, cout, p.th, p.tw, p.cin_t,
                        p.chunk)
    # The Cout chunks cover [0, Cout) once, through 2 stages when more
    # than one.
    n_chunks = _cdiv(cout, p.chunk)
    covered = np.zeros(cout, np.int64)
    for c in range(n_chunks):
        covered[c * p.chunk:(c + 1) * p.chunk] += 1
    assert (covered == 1).all() and (n_chunks - 1) * p.chunk < cout
    assert p.stages == (2 if n_chunks > 1 else 1)

    # Every output element stored by exactly one CTA, and the halo holds
    # every dy row and column a live lane of the tile reads.
    ty, tx = _cdiv(nh, p.th), _cdiv(nw, p.tw)
    ci_tiles = _cdiv(cin, p.cin_t)
    assert p.tiles == B * ty * tx and p.ctas == p.tiles * ci_tiles
    a, c, u, v = _thread_sites(p, spec)
    counts = np.zeros((B, nh, nw, cin), np.int64)
    hh, hw = p.halo
    for t in range(ty * tx):
        y0, x0 = t // tx * p.th, t % tx * p.tw
        y, x = y0 + a + sh * u, x0 + c + sw * v
        keep = (y < nh) & (x < nw)
        for cit in range(ci_tiles):
            ci = np.arange(cit * p.cin_t, min(cin, (cit + 1) * p.cin_t))
            np.add.at(counts, (slice(None), y[keep][:, None],
                               x[keep][:, None], ci[None, :]), 1)
        i0, j0 = halo_origin(spec, y0, x0)
        for r, s, d_, k, o, n in ((y + ph, sh, dh, kh, i0, hh),
                                  (x + pw, sw, dw, kw, j0, hw)):
            h = r[:, None] - d_ * np.arange(k)[None, :]   # (sites, taps)
            idx = h[h % s == 0] // s                       # live lanes
            assert ((idx >= o) & (idx < o + n)).all()
    assert (counts == 1).all()


@pytest.mark.parametrize("name,case", SHAPES, ids=[c[0] for c in SHAPES])
def test_plan_covers_every_output_once_at_chip_smoke_shapes(name, case):
    spec, B, n_out, cin, cout, p = _shape_plan(case)
    _check_plan(spec, B, n_out, cin, cout, p)
    if name.startswith("gan_t3"):
        # A class holds whole warps: every tap's residue test is one
        # branch per warp.
        assert (p.th // 2) * (p.tw // 2) % 32 == 0
    if name in ("cout130", "ragged_channels"):
        assert _cdiv(cout, p.chunk) > 1
    if name == "k11_s4":
        assert p.chunk < MAX_CHUNK     # the wide halo shrank the chunk


@pytest.mark.parametrize("batch", ["grid", 64])
@pytest.mark.parametrize("geom", TCONV_GRID)
def test_plan_covers_every_output_once_over_the_grid(geom, batch):
    spec, B, n_out, cin, cout, p = _grid_plan(geom)
    if batch != "grid":
        B = batch
        p = plan(spec, B, n_out, spec.out_size(n_out), cin, cout)
    _check_plan(spec, B, n_out, cin, cout, p)


def test_plan_raises_naming_a_geometry_that_does_not_fit():
    spec = _spec(2, 23, 0, 1)           # 529 residue classes > 512 threads
    with pytest.raises(ValueError, match=r"stride=\(23, 23\)"):
        plan(spec, 1, (46, 46), (2, 2), 3, 4)


def test_plan_limits_match_the_kernel_source():
    """The plan's limits are the C entry's (no compiler here to ask)."""
    text = (build.CSRC / "implicit_gemm.cu").read_text()
    for name, want in (("kMaxThreads", MAX_THREADS), ("kMaxChunk", MAX_CHUNK),
                       ("kSmemBytes", SMEM_BYTES)):
        assert int(re.search(rf"constexpr int {name} = (\d+);",
                             text).group(1)) == want
    assert "cin_t == 1 || cin_t == 2 || cin_t == 3 || cin_t == 4 || " \
           "cin_t == 8" in text and CIN_TILES == (1, 2, 3, 4, 8)
    assert "chunk == 4 || chunk == 8 || chunk == 16 || chunk == kMaxChunk" \
        in text and CHUNKS == (4, 8, 16, 32)


# -- the kernel's decomposition in plain PyTorch ------------------------------

def _emulate(dy, w, spec, n_out, p, bias=None, ep=None):
    """dx as csrc/implicit_gemm.cu computes it under plan p: per CTA (b,
    tile, Cin tile) and Cout chunk in order, the halo [i0, i0 + hh) x
    [j0, j0 + hw) of dy zero-filled outside dy and past Cout, the chunk's
    weights zero-filled past Cin; each residue class's sites summed over
    its live taps; the epilogue on the finished sum; the store cropped to
    n_out."""
    B, Oh, Ow, Cout = dy.shape
    Kh, Kw, Cin, _ = w.shape
    (sh, sw), (ph, pw), (dh, dw) = spec.stride, spec.padding, spec.dilation
    nh, nw = n_out
    hh, hw = p.halo
    cu, cv = p.th // sh, p.tw // sw
    dx = torch.full((B, nh, nw, Cin), float("nan"))
    for b in range(B):
        for y0 in range(0, nh, p.th):
            for x0 in range(0, nw, p.tw):
                i0, j0 = halo_origin(spec, y0, x0)
                for ci0 in range(0, Cin, p.cin_t):
                    nci = min(p.cin_t, Cin - ci0)
                    acc = torch.zeros(sh, sw, cu, cv, p.cin_t)
                    for co0 in range(0, Cout, p.chunk):
                        nco = min(p.chunk, Cout - co0)
                        halo = torch.zeros(hh, hw, p.chunk)
                        ia, ib = max(i0, 0), min(i0 + hh, Oh)
                        ja, jb = max(j0, 0), min(j0 + hw, Ow)
                        if ia < ib and ja < jb:
                            halo[ia - i0:ib - i0, ja - j0:jb - j0, :nco] = \
                                dy[b, ia:ib, ja:jb, co0:co0 + nco]
                        wt = torch.zeros(Kh, Kw, p.cin_t, p.chunk)
                        wt[:, :, :nci, :nco] = \
                            w[:, :, ci0:ci0 + nci, co0:co0 + nco]
                        for a in range(sh):
                            for c in range(sw):
                                r, s = y0 + ph + a, x0 + pw + c
                                for kx in range(Kh):
                                    h = r - kx * dh
                                    if h % sh:
                                        continue
                                    row = h // sh - i0
                                    for ky in range(Kw):
                                        g = s - ky * dw
                                        if g % sw:
                                            continue
                                        col = g // sw - j0
                                        win = halo[row:row + cu,
                                                   col:col + cv]
                                        assert win.shape == (cu, cv,
                                                             p.chunk)
                                        acc[a, c] += win @ wt[kx, ky].T
                    for a in range(sh):
                        for c in range(sw):
                            ys = y0 + a + sh * np.arange(cu)
                            xs = x0 + c + sw * np.arange(cv)
                            ym, xm = ys < nh, xs < nw
                            v = acc[a, c][ym][:, xm][..., :nci]
                            if ep is not None:
                                v = ep.apply(v, None if bias is None
                                             else bias[ci0:ci0 + nci])
                            dx[b, ys[ym][:, None], xs[xm][None, :],
                               ci0:ci0 + nci] = v
    assert not torch.isnan(dx).any()
    return dx


def _smallest(spec, B, n_out, cin, cout):
    """One site per residue class per tile and 4-deep chunks: the most
    tiles, halos and chunks a geometry can take."""
    return counted(spec, B, n_out, cin, cout, spec.stride[0],
                   spec.stride[1], cin if cin <= 4 else 8, 4)


def _references(spec, n_out, dy, w, bias, kw, pallas):
    """`repro`'s zero-free transposed conv with the epilogue, and (when
    `pallas`) its implicit-GEMM Pallas kernel in interpret mode."""
    je = None if kw is None else jspec.Epilogue(**kw)
    jb = jnp.asarray(bias) if je is not None and je.bias else None
    geo = dict(stride=spec.stride, padding=spec.padding, n_out=n_out,
               dilation=spec.dilation)
    base = jeco.transposed_conv_zero_free(jnp.asarray(dy), jnp.asarray(w),
                                          **geo)
    out = [base if je is None else je.apply(base, jb)]
    if pallas:
        out.append(tconv_implicit_gemm_pallas(
            jnp.asarray(dy), jnp.asarray(w), bias=jb, epilogue=je,
            interpret=True, **geo))
    return out


@pytest.mark.parametrize("tiles", ["plan", "smallest"])
@pytest.mark.parametrize("i", range(len(TCONV_GRID)))
def test_emulated_kernel_matches_repro(i, tiles):
    """Under each of EP_KW's epilogues against the zero-free transposed
    conv; against the Pallas kernel (interpret mode, ~1 s a call) at the
    grid's first four geometries -- the S = 3, K = 2 residues and n_out
    tails among them -- under one epilogue each, EP_KW's four in turn."""
    spec, n_out, dy, w, bias = tconv_case(TCONV_GRID[i], 5)
    B, cout, cin = dy.shape[0], dy.shape[3], w.shape[2]
    p = plan(spec, B, n_out, dy.shape[1:3], cin, cout) if tiles == "plan" \
        else _smallest(spec, B, n_out, cin, cout)
    for j, kw in enumerate(EP_KW):
        ep = None if kw is None else Epilogue(**kw)
        b = torch.tensor(bias) if ep is not None and ep.bias else None
        got = _emulate(torch.tensor(dy), torch.tensor(w), spec, n_out, p,
                       b, ep)
        pallas = tiles == "plan" and j == i
        for want in _references(spec, n_out, dy, w, bias, kw, pallas):
            assert_allclose(got, want, rtol=TOL, atol=TOL,
                            err_msg=f"{TCONV_GRID[i]} {tiles} {kw}")


def test_emulated_kernel_matches_repro_at_ragged_channels():
    """Cin 130 in 17 tiles of 8, Cout 37 in two chunks (the second 5
    deep), and the 4-byte copy path's Cout; a bias fill, a tail."""
    spec = _spec(3, 2, 1, 1)
    rng = np.random.default_rng(9)
    dy = rng.standard_normal((2, 5, 5, 37)).astype(np.float32)
    w = rng.standard_normal((3, 3, 130, 37)).astype(np.float32)
    bias = rng.standard_normal(130).astype(np.float32)
    n_out = (10, 10)
    p = plan(spec, 2, n_out, (5, 5), 130, 37)
    assert (p.cin_t, p.chunk, p.stages) == (8, 32, 2)
    kw = EP_KW[2]
    got = _emulate(torch.tensor(dy), torch.tensor(w), spec, n_out, p,
                   torch.tensor(bias), Epilogue(**kw))
    for want in _references(spec, n_out, dy, w, bias, kw, pallas=True):
        assert_allclose(got, want, rtol=TOL, atol=TOL)
