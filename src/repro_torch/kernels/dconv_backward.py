"""Fused dual-gradient conv backwards: the CUDA kernels
`csrc/conv_backward.cu` and `csrc/tconv_backward.cu` and their plain
PyTorch versions (port of `repro/kernels/dconv_backward.py`).

`conv_backward` -- the VJP of y = ep(conv(x, W)) for cotangent dy:
    m  = dy * act'(y)                    masked, unscaled
    dx = tconv(scale * m, W)             packed phase windows
    dW = filter_grad(x, scale * m)       per-tap gathers
    db = m summed over (b, i, j)         no scale

`tconv_backward` -- the VJP of z = ep(tconv(dy, W)) for cotangent g:
    gm  = g * act'(z)
    ddy = conv(scale * gm, W)            per-tap gathers
    dW  = filter_grad(scale * gm, dy)    the cotangent in the input role
    db  = gm summed over (b, h, w)       over Cin, no scale

act' comes from the forward OUTPUT (`Epilogue.grad_factor`).  The plain
versions repeat the Pallas arithmetic with the port's plain tconv,
forward and filter-grad versions.  In bf16 every output takes `repro`'s
dtype (dx, ddy and dW the operands', db the cotangent's) and is rounded
once: both versions widen the operands to fp32 and form the masked
cotangent and every sum in fp32 (`csrc/conv_body.cuh` says why the mask
is not rounded to bf16 first, as `repro`'s is).  Each kernel computes all of its
outputs in ONE launch, as `repro` does in one `pallas_call`, and forms
the mask as it loads the cotangent.  Public entries:
`kernels/ops.py::conv_backward` / `tconv_backward`.

Every role of the kernels is a tiled implicit GEMM
(`csrc/conv_body.cuh`), and the two forward kernels (`csrc/tconv_phase.cu`,
`csrc/dconv_forward.cu`) launch its dx and ddy roles alone.  `plan`, a
pure function of the shapes, picks each launch's tiles and how many CTAs
split each tile's reduction, for the backwards and the forwards alike:
the splits write partial tiles to a workspace and the last of them adds
the partials in split order.  A non-overlapping conv (S = K, P = 0, D = 1
on both axes) takes `conv_backward`'s patch roles: dx and dW as two GEMMs
over the patch matrix on the 128 x 128 tile (PATCH for both roles).  The
launchers take their plan from `kernels/tiling.py`, which gives `plan`'s
(analytical mode) or the fastest of `candidates` on the card (autotune).
`split_filter_grad_plain`, `split_forward_plain` and
`split_conv_backward_plain` are the split arithmetic for the dW role, for
the forwards and for a whole backward in plain PyTorch.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.core.spec import ConvSpec, Epilogue
from repro_torch.kernels import build, tiling
from repro_torch.kernels.dconv_filtergrad import dconv_filter_grad_plain
from repro_torch.kernels.dconv_forward import dconv_forward_plain
from repro_torch.kernels.tconv_phase import tconv_fused_plain

_EP_ARGS = [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_float]
# tile, splits, dw_tile, dw_splits, chunk; the workspace and its floats;
# the tickets and their count.
_PLAN_ARGS = ([ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int64]
              + [ctypes.c_void_p, ctypes.c_int])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 23 + _EP_ARGS
                 + _PLAN_ARGS + [ctypes.c_void_p])
_CT_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 15 + _EP_ARGS
                + _PLAN_ARGS + [ctypes.c_void_p])

# (BM, BN) of the kernels' tile shapes, by the C entries' tile id
# (csrc/conv_body.cuh: TileThin, TileTall, TileSquare, TileSmall,
# TileHalf, TilePatch).
TILES = ((256, 4), (128, 32), (64, 64), (64, 32), (256, 16), (128, 128))
THIN, TALL, SQUARE, SMALL, HALF, PATCH = range(6)
# The ops a plan is made for: the backwards and the standalone filter
# gradient, and the forwards, which launch one gather role alone.
FORWARD_OPS = ("tconv_phase", "dconv_forward")
OPS = ("conv_backward", "tconv_backward", "filter_grad") + FORWARD_OPS
GEMM_BK = 16          # reduction depth of one slab; chunks are multiples
MAX_SPLITS = 64       # CTAs one tile's reduction may take (csrc kMaxSplits)
MIN_CHUNK = 128       # positions a dW split sums at the least
MIN_K_CHUNK = 32      # reduction length a dx / ddy split takes at the least
SM_COUNT = 132        # H100 SXM
DW_CTAS = 128         # CTAs the dW role aims at
CHANNEL_TILE = 256    # channels of one db tile (the CTA's threads)
PATCH_MIN_COUT = 16   # the least Cout of a conv on the patch roles


class BackwardPlan(NamedTuple):
    tile: int       # TILES id of the dx / ddy role (-1: no such role)
    splits: int     # CTAs per dx / ddy tile
    dw_tile: int    # TILES id of the dW role (-1: none, a forward)
    dw_splits: int  # CTAs per dW tile (and per db tile)
    chunk: int      # positions each dW split sums (a multiple of GEMM_BK)
    tiles: int      # dx / ddy tiles
    dw_tiles: int   # dW tiles
    db_tiles: int   # db tiles (0 without a bias)
    workspace: int  # floats of the splits' partial tiles

    @property
    def tickets(self) -> int:
        """One ticket per tile of every role."""
        return self.tiles + self.dw_tiles + self.db_tiles


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _residue_rows(n: int, s: int, p_: int, r: int) -> tuple[int, int]:
    """(first, count) of the phase rows m with 0 <= m*s + r - p_ < n."""
    lo = _cdiv(p_ - r, s) if p_ - r > 0 else 0
    top = n - 1 + p_ - r
    hi = top // s + 1 if top >= 0 else 0
    return lo, max(0, hi - lo)


def phase_classes(spec: ConvSpec, n_out) -> list[tuple[int, int, int]]:
    """(Hc, Wc, taps) of each residue class (p, q), p-major, as the dx
    role tiles them: the class's rows and columns of the (Nh, Nw) frame
    and its taps (0 when no tap reaches it, K < S)."""
    (sh, sw), (ph, pw), (dh, dw) = spec.stride, spec.padding, spec.dilation
    kh, kw = spec.filter_shape
    (per_h, per_w), (tph, tpw) = spec.tap_phase_period, spec.n_tap_phases
    out = []
    for p in range(sh):
        for q in range(sw):
            a = [s for s in range(tph) if (s * dh) % sh == p]
            c = [s for s in range(tpw) if (s * dw) % sw == q]
            taps = _cdiv(kh - a[0], per_h) * _cdiv(kw - c[0], per_w) \
                if a and c else 0
            out.append((_residue_rows(n_out[0], sh, ph, p)[1],
                        _residue_rows(n_out[1], sw, pw, q)[1], taps))
    return out


def non_overlapping(spec: ConvSpec) -> bool:
    """S = K, P = 0 and D = 1 on both axes: every input pixel lies under
    one tap of one patch (patchify; a 1x1 conv at S = 1)."""
    return (spec.stride == spec.filter_shape and spec.padding == (0, 0)
            and spec.dilation == (1, 1))


def patch_m_tiles(kh: int, run: int, bm: int) -> int:
    """The patch dW role's M tiles (csrc/conv_body.cuh::patch_m_tiles):
    bm // run whole runs of Kw*Cin rows a tile, or ceil(run / bm) tiles a
    run when a run is longer than a tile."""
    return _cdiv(kh, bm // run) if run <= bm else kh * _cdiv(run, bm)


def split_chunk(k: int, splits: int) -> int:
    """The reduction length each of `splits` CTAs takes of k: whole slabs
    (csrc/conv_body.cuh::split_range)."""
    return _cdiv(_cdiv(k, splits), GEMM_BK) * GEMM_BK


def _pow2_floor(n: int) -> int:
    return 1 << max(0, n.bit_length() - 1)


def _splits(k: int, want: int, min_chunk: int) -> int:
    """CTAs per tile for a reduction of length k: `want`, at most
    MAX_SPLITS, at least `min_chunk` each, then as few as leave no split
    empty."""
    splits = max(1, min(MAX_SPLITS, want, k // min_chunk))
    while splits > 1 and (splits - 1) * split_chunk(k, splits) >= k:
        splits -= 1
    return splits


def _gather_tile(op: str, n: int) -> int:
    """The dx / ddy tile for N = n output channels: 256 x 4 at n <= 4;
    for the forwards 256 x 16 at 4 < n <= 16; else 128 x 32."""
    if n <= 4:
        return THIN
    return HALF if op in FORWARD_OPS and n <= 16 else TALL


def plan(op: str, spec: ConvSpec, batch: int, big_hw, small_hw, cin: int,
         cout: int, n_out=None, bias: bool = False) -> BackwardPlan:
    """The tiles and splits of one launch of `op`: "conv_backward" (dx
    over the `n_out` frame), "tconv_backward" (ddy) or "filter_grad" (dW
    alone), with `bias` adding the db role; or a forward, whose gather
    role runs alone: "tconv_phase" (dx = tconv(dy, W) over the `n_out`
    frame, as conv_backward's dx) or "dconv_forward" (y = conv(x, W), as
    tconv_backward's ddy).  `big_hw` is the (Nh, Nw) side (x, g, or the
    tconv's output), `small_hw` the (Oh, Ow) side (dy, or the conv's
    output).

    dx / ddy: the thin 256 x 4 tile when N (Cin, or Cout) <= 4, a
    forward's 256 x 16 at 4 < N <= 16, else 128 x 32; its reduction (the
    class's taps x Cout, or taps x Cin) is split only when the tiles are
    fewer than half the SMs, into the power of two nearest below
    2 * SM_COUNT / tiles.  dW: 64 x 32 when Cout <= 32, else 64 x 64;
    its B*Oh*Ow positions are split into the power of two nearest below
    DW_CTAS / tiles.  At most MAX_SPLITS, at least MIN_K_CHUNK (dx / ddy)
    or MIN_CHUNK (dW) each, in whole slabs, and no split empty; db takes
    the dW split.  A forward has no dW or db tiles (dw_tile -1, one
    dW split of chunk 0).  The constants are the best of
    `scripts/backward_plan_sweep.py` at the main-path layers on the
    H100.

    A conv_backward of a non-overlapping conv with Cout >= PATCH_MIN_COUT
    takes the patch roles (`patch_plan`; below it the 128 x 128 tile is
    mostly empty, the dx reduction and the dW columns being Cout).  The
    constant lies between the atrous head's 1x1 fuse (Cout 4, faster on
    the residue classes) and patchify (Cout 1024) on the H100."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}")
    if op == "conv_backward" and non_overlapping(spec) \
            and cout >= PATCH_MIN_COUT:
        return patch_plan(spec, batch, small_hw, cin, cout, bias)
    return _class_plan(op, spec, batch, small_hw, cin, cout, n_out, bias)


def _class_plan(op: str, spec: ConvSpec, batch: int, small_hw, cin: int,
                cout: int, n_out, bias: bool) -> BackwardPlan:
    """`plan`'s rule for every launch but the patch roles'."""
    n = cin if op in ("conv_backward", "tconv_phase") else cout
    tile = -1 if op == "filter_grad" else _gather_tile(op, n)
    dw_tile = -1 if op in FORWARD_OPS else SMALL if cout <= 32 else SQUARE
    one = counted(op, spec, batch, small_hw, cin, cout, tile, 1, dw_tile,
                  1, n_out=n_out, bias=bias)
    splits = 1 if 2 * one.tiles >= SM_COUNT else _splits(
        reduction(op, spec, small_hw, cin, cout, n_out),
        _pow2_floor(2 * SM_COUNT // max(one.tiles, 1)), MIN_K_CHUNK)
    dw_splits = 1 if op in FORWARD_OPS else _splits(
        batch * small_hw[0] * small_hw[1],
        _pow2_floor(max(1, DW_CTAS // one.dw_tiles)), MIN_CHUNK)
    return counted(op, spec, batch, small_hw, cin, cout, tile, splits,
                   dw_tile, dw_splits, n_out=n_out, bias=bias)


def patch_plan(spec: ConvSpec, batch: int, small_hw, cin: int, cout: int,
               bias: bool = False) -> BackwardPlan:
    """The patch roles' plan of a conv_backward of the non-overlapping
    conv `spec`, whatever its Cout (`plan` gives it from PATCH_MIN_COUT
    on): 128 x 128 tiles for both roles; dx's reduction over Cout split
    as `plan` splits a gather role's; dW's positions split into the
    power of two nearest below positions / Cout, so that a dW CTA sums
    about as many terms as a dx CTA."""
    one = counted("conv_backward", spec, batch, small_hw, cin, cout, PATCH,
                  1, PATCH, 1, bias=bias)
    positions = batch * small_hw[0] * small_hw[1]
    splits = 1 if 2 * one.tiles >= SM_COUNT else _splits(
        cout, _pow2_floor(2 * SM_COUNT // max(one.tiles, 1)), MIN_K_CHUNK)
    dw_splits = _splits(positions, _pow2_floor(max(1, positions // cout)),
                        MIN_CHUNK)
    return counted("conv_backward", spec, batch, small_hw, cin, cout, PATCH,
                   splits, PATCH, dw_splits, bias=bias)


def counted(op: str, spec: ConvSpec, batch: int, small_hw, cin: int,
            cout: int, tile: int, splits: int, dw_tile: int = -1,
            dw_splits: int = 1, n_out=None, bias: bool = False
            ) -> BackwardPlan:
    """The BackwardPlan of these tiles and splits for one launch of `op`,
    counted as `plan` counts its tiles, chunk and workspace (`plan` picks
    the four choices; a planner's candidate or a cache row names them).
    A forward takes no dW or db role: dw_tile -1, one dW split.  PATCH
    (both tiles) counts the patch roles: dx tiles over (B*Oh*Ow) x
    (Kh*Kw*Cin), dW tiles of whole runs (`patch_m_tiles`) x Cout."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}")
    kh, kw = spec.filter_shape
    if tile == PATCH:
        if op != "conv_backward" or dw_tile != PATCH \
                or not non_overlapping(spec):
            raise ValueError("the patch roles take a conv_backward of a "
                             "non-overlapping conv, PATCH for both tiles")
        n, rows = kh * kw * cin, [batch * small_hw[0] * small_hw[1]]
    elif op in ("conv_backward", "tconv_phase"):
        n = cin
        rows = [batch * hc * wc for hc, wc, _ in phase_classes(spec, n_out)]
    elif op in ("tconv_backward", "dconv_forward"):
        n, rows = cout, [batch * small_hw[0] * small_hw[1]]
    else:
        n, rows = 0, []
    tiles = sum(_cdiv(r, TILES[tile][0]) for r in rows) \
        * _cdiv(n, TILES[tile][1]) if rows else 0
    workspace = tiles * splits * TILES[tile][0] * TILES[tile][1] \
        if splits > 1 and rows else 0
    if op in FORWARD_OPS:
        return BackwardPlan(tile, splits, -1, 1, 0, tiles, 0, 0, workspace)
    bm, bn = TILES[dw_tile]
    dw_tiles = (patch_m_tiles(kh, kw * cin, bm) if dw_tile == PATCH
                else _cdiv(kh * kw * cin, bm)) * _cdiv(cout, bn)
    positions = batch * small_hw[0] * small_hw[1]
    channels = cin if op == "tconv_backward" else cout
    db_tiles = _cdiv(channels, min(channels, CHANNEL_TILE)) \
        if bias and op != "filter_grad" else 0
    workspace += (dw_splits > 1) * (dw_tiles * bm * bn + db_tiles
                                    * CHANNEL_TILE) * dw_splits
    return BackwardPlan(tile, splits, dw_tile, dw_splits,
                        split_chunk(positions, dw_splits), tiles, dw_tiles,
                        db_tiles, workspace)


def reduction(op: str, spec: ConvSpec, small_hw, cin: int, cout: int,
              n_out=None) -> int:
    """Length of the dx / ddy role's reduction (0 without one): the
    longest residue class's taps x Cout, or Kh*Kw*Cin."""
    kh, kw = spec.filter_shape
    if op in ("conv_backward", "tconv_phase"):
        return max(taps for _, _, taps in phase_classes(spec, n_out)) * cout
    if op in ("tconv_backward", "dconv_forward"):
        return kh * kw * cin
    return 0


SWEEP_SPLITS = (1, 2, 4, 8, 16)     # dx / ddy splits a sweep tries
SWEEP_DW_SPLITS = (4, 8, 16, 32, 64)


def candidates(op: str, spec: ConvSpec, batch: int, small_hw, cin: int,
               cout: int, n_out=None, bias: bool = False) -> list:
    """The plans an autotune sweep times for one launch of `op`, `plan`'s
    own first (`scripts/backward_plan_sweep.py` walks the same set): the
    dx / ddy role at the residue-class rule's tile (a forward also at 256
    x 16 or 128 x 32, whichever it did not take, when N > 4), split over
    SWEEP_SPLITS; the dW role at 64 x 32 and, at Cout > 32, 64 x 64,
    split over SWEEP_DW_SPLITS.  A conv_backward of a non-overlapping
    conv also takes the patch roles at every split pair of SWEEP_SPLITS x
    SWEEP_DW_SPLITS, whichever roles `plan` picks.  No reduction is split
    so far that a split is left empty."""
    own = plan(op, spec, batch, None, small_hw, cin, cout, n_out=n_out,
               bias=bias)
    positions = batch * small_hw[0] * small_hw[1]

    def fills(length, splits):
        return splits == 1 or (splits - 1) * split_chunk(length,
                                                         splits) < length

    out = [own]
    if op == "conv_backward" and non_overlapping(spec):
        for s in SWEEP_SPLITS:
            for ds in SWEEP_DW_SPLITS:
                p = counted(op, spec, batch, small_hw, cin, cout, PATCH, s,
                            PATCH, ds, bias=bias)
                if fills(cout, s) and fills(positions, ds) and p not in out:
                    out.append(p)
    cls = _class_plan(op, spec, batch, small_hw, cin, cout, n_out, bias)
    if cls not in out:
        out.append(cls)
    k = reduction(op, spec, small_hw, cin, cout, n_out)
    tiles = [cls.tile]
    if op in FORWARD_OPS and cls.tile != THIN:   # 128 x 32 or 256 x 16
        tiles.append(HALF if cls.tile == TALL else TALL)
    splits = [1] if cls.tile < 0 else [s for s in SWEEP_SPLITS
                                       if fills(k, s)]
    if op in FORWARD_OPS:
        dw = [(-1, 1)]
    else:
        dw = [(t, s) for t in ((SMALL,) if cout <= 32 else (SQUARE, SMALL))
              for s in SWEEP_DW_SPLITS if fills(positions, s)]
    for t in tiles:
        for s in splits:
            for dt, ds in dw:
                p = counted(op, spec, batch, small_hw, cin, cout, t, s, dt,
                            ds, n_out=n_out, bias=bias)
                if p not in out:
                    out.append(p)
    return out


_TICKETS: dict = {}


def launch_buffers(p: BackwardPlan, device) -> tuple:
    """(workspace pointer, floats, tickets pointer, count) for a launch of
    plan `p` on the current stream of `device`.  The workspace is
    torch.empty (no kernel); the tickets are one int32 buffer per (device,
    stream), zeroed once when it is allocated and left at 0 by every
    launch, so no call adds a fill kernel.  The caller keeps the returned
    workspace tensor alive until the launch is queued."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    tickets = _TICKETS.get(key)
    if tickets is None or tickets.numel() < p.tickets:
        tickets = torch.zeros(max(p.tickets, 1024), dtype=torch.int32,
                              device=device)
        _TICKETS[key] = tickets
    ws = torch.empty(p.workspace, dtype=torch.float32, device=device) \
        if p.workspace else None
    return ws, (None if ws is None else ws.data_ptr(), p.workspace,
                tickets.data_ptr(), tickets.numel())


def split_filter_grad_plain(x: torch.Tensor, dy: torch.Tensor,
                            spec: ConvSpec,
                            p: Optional[BackwardPlan] = None) -> torch.Tensor:
    """The dW role's split-position sum in plain PyTorch: one partial
    filter gradient per chunk of the flat (b, i, j) positions of dy (the
    other positions' dy zeroed), added in split order 0, 1, ..."""
    B, _, _, cin = x.shape
    _, oh, ow, cout = dy.shape
    if p is None:
        p = plan("filter_grad", spec, B, x.shape[1:3], (oh, ow), cin, cout)
    flat = dy.reshape(B * oh * ow, cout)
    total = None
    for s in range(p.dw_splits):
        part_dy = torch.zeros_like(flat)
        part_dy[s * p.chunk:(s + 1) * p.chunk] = \
            flat[s * p.chunk:(s + 1) * p.chunk]
        part = dconv_filter_grad_plain(x, part_dy.reshape(dy.shape), spec)
        total = part if total is None else total + part
    return total


def split_forward_plain(op: str, a: torch.Tensor, w: torch.Tensor,
                        spec: ConvSpec, splits: int, *, n_out=None,
                        bias=None, epilogue: Epilogue | None = None,
                        slab: int = GEMM_BK) -> torch.Tensor:
    """A forward kernel's split reduction in plain PyTorch: one partial
    per chunk of consecutive k, the filter's other entries zeroed, the
    partials added in split order 0, 1, ..., then the epilogue applied
    once to the sum.  Chunks are ceil(ceil(K / splits) / slab) * slab
    long (`slab` = GEMM_BK: the kernels' split_range).

    "dconv_forward": a = x; k = (kx*Kw + ky)*Cin + ci, K = Kh*Kw*Cin.
    "tconv_phase": a = dy; each residue class has its own k = (slot,
    co), slot = u*nv + v over its taps (kx, ky) = (a + u*per_h, c +
    v*per_w), and its own K = taps * Cout.  Positions no tap reaches sum
    nothing and take ep(0)."""
    kh, kw, cin, cout = w.shape
    if op == "dconv_forward":
        k = torch.arange(kh * kw * cin).reshape(kh, kw, cin, 1)
        big_k = kh * kw * cin
    elif op == "tconv_phase":
        per_h, per_w = spec.tap_phase_period
        kx = torch.arange(kh).reshape(kh, 1, 1, 1)
        ky = torch.arange(kw).reshape(1, kw, 1, 1)
        nu = -(-(kh - kx % per_h) // per_h)
        nv = -(-(kw - ky % per_w) // per_w)
        co = torch.arange(cout).reshape(1, 1, 1, cout)
        k = ((kx // per_h) * nv + ky // per_w) * cout + co
        big_k = nu * nv * cout
    else:
        raise ValueError(f"not a forward op: {op!r}")
    chunk = _cdiv(_cdiv(big_k, splits), slab) * slab
    total = None
    for s in range(splits):
        part_w = w * ((k >= s * chunk) & (k < (s + 1) * chunk))
        part = dconv_forward_plain(a, part_w, spec) if op == "dconv_forward" \
            else tconv_fused_plain(a, part_w, spec, n_out=n_out)
        total = part if total is None else total + part
    return total if epilogue is None else epilogue.apply(total, bias)


def split_conv_backward_plain(x: torch.Tensor, dy: torch.Tensor,
                              w: torch.Tensor, spec: ConvSpec,
                              p: BackwardPlan, *, n_out, y=None,
                              epilogue: Epilogue | None = None):
    """`conv_backward_plain` with its two reductions split as plan `p`
    splits them: dx's in p.splits chunks of its k (`split_forward_plain`'s
    "tconv_phase" order; for the patch roles, chunks of Cout), dW's
    positions in p.dw_splits chunks of p.chunk (`split_filter_grad_plain`),
    the partials added in split order.  (dx, dW, db or None)."""
    dtype = x.dtype
    x, dy, w, y = build.widened(x, dy, w, y)
    m, g = _masked(dy, y, epilogue)
    db = m.sum(dim=(0, 1, 2)) if epilogue is not None and epilogue.bias \
        else None
    dx = split_forward_plain("tconv_phase", g, w, spec, p.splits,
                             n_out=n_out)
    return _rounded(dtype, dx, split_filter_grad_plain(x, g, spec, p), db)


def _masked(cot: torch.Tensor, out, epilogue: Epilogue | None):
    """(cot * act'(out), the same times the epilogue's scale)."""
    if epilogue is None:
        return cot, cot
    m = cot if out is None else epilogue.mask_cotangent(out, cot)
    return m, (m if epilogue.scale is None else m * epilogue.scale)


def _rounded(dtype, *outs):
    """The outputs in `dtype` (None stays None)."""
    return tuple(None if t is None else t.to(dtype) for t in outs)


def conv_backward_plain(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor,
                        spec: ConvSpec, *, n_out, y=None,
                        epilogue: Epilogue | None = None):
    """(dx (B,Nh,Nw,Cin), dW (Kh,Kw,Cin,Cout), db (Cout,) or None)."""
    dtype = x.dtype
    x, dy, w, y = build.widened(x, dy, w, y)
    m, g = _masked(dy, y, epilogue)
    db = m.sum(dim=(0, 1, 2)) if epilogue is not None and epilogue.bias \
        else None
    dx = tconv_fused_plain(g, w, spec, n_out=n_out)
    return _rounded(dtype, dx, dconv_filter_grad_plain(x, g, spec), db)


def tconv_backward_plain(g: torch.Tensor, dy: torch.Tensor, w: torch.Tensor,
                         spec: ConvSpec, *, z=None,
                         epilogue: Epilogue | None = None):
    """(ddy (B,Oh,Ow,Cout), dW (Kh,Kw,Cin,Cout), db (Cin,) or None)."""
    dtype = g.dtype
    g, dy, w, z = build.widened(g, dy, w, z)
    gm, gs = _masked(g, z, epilogue)
    db = gm.sum(dim=(0, 1, 2)) if epilogue is not None and epilogue.bias \
        else None
    ddy = dconv_forward_plain(gs, w, spec)
    return _rounded(dtype, ddy, dconv_filter_grad_plain(gs, dy, spec), db)


def conv_backward_cuda(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor,
                       spec: ConvSpec, *, n_out, y=None,
                       epilogue: Epilogue | None = None,
                       plan: BackwardPlan | None = None):
    """Launch the kernel on the current stream at `plan` (default: the
    planner's).  fp32 or bf16, one dtype, contiguous, one device -- the
    wrapper in `kernels/ops.py` checks all four."""
    B, nh_x, nw_x, cin = x.shape
    _, oh, ow, cout = dy.shape
    kh, kw = spec.filter_shape
    nh, nw = n_out
    dev = x.device
    dx = torch.empty((B, nh, nw, cin), dtype=x.dtype, device=dev)
    dw = torch.empty((kh, kw, cin, cout), dtype=x.dtype, device=dev)
    has_db = epilogue is not None and epilogue.bias
    db = torch.empty((cout,), dtype=dy.dtype, device=dev) \
        if has_db else None
    p = plan or tiling.plan_tiles("backward", spec, x_shape=dx.shape,
                                  dy_shape=dy.shape, epilogue=epilogue,
                                  dtype=x.dtype)
    ws, bufs = launch_buffers(p, dev)
    fn = build.kernel_function("conv_backward",
                               build.symbol("conv_backward", x.dtype),
                               _BWD_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), dy.data_ptr(),
                 None if y is None else y.data_ptr(), w.data_ptr(),
                 dx.data_ptr(), dw.data_ptr(),
                 None if db is None else db.data_ptr(),
                 B, nh_x, nw_x, cin, oh, ow, cout, kh, kw, nh, nw,
                 *spec.stride, *spec.padding, *spec.dilation,
                 *spec.tap_phase_period, *spec.tap_phase_step,
                 *spec.n_tap_phases,
                 *build.epilogue_args(epilogue), *p[:5], *bufs,
                 torch.cuda.current_stream().cuda_stream)
    build.check_launch("conv_backward", err)
    return dx, dw, db


def tconv_backward_cuda(g: torch.Tensor, dy: torch.Tensor, w: torch.Tensor,
                        spec: ConvSpec, *, z=None,
                        epilogue: Epilogue | None = None,
                        plan: BackwardPlan | None = None):
    """Launch the kernel on the current stream at `plan` (default: the
    planner's).  fp32 or bf16, one dtype, contiguous, one device -- the
    wrapper in `kernels/ops.py` checks all four."""
    B, nh, nw, cin = g.shape
    _, oh, ow, cout = dy.shape
    kh, kw = spec.filter_shape
    dev = g.device
    ddy = torch.empty((B, oh, ow, cout), dtype=g.dtype, device=dev)
    dw = torch.empty((kh, kw, cin, cout), dtype=g.dtype, device=dev)
    has_db = epilogue is not None and epilogue.bias
    db = torch.empty((cin,), dtype=g.dtype, device=dev) \
        if has_db else None
    p = plan or tiling.plan_tiles("ct_backward", spec, x_shape=g.shape,
                                  dy_shape=dy.shape, epilogue=epilogue,
                                  dtype=g.dtype)
    ws, bufs = launch_buffers(p, dev)
    fn = build.kernel_function("tconv_backward",
                               build.symbol("tconv_backward", g.dtype),
                               _CT_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(g.data_ptr(), None if z is None else z.data_ptr(),
                 dy.data_ptr(), w.data_ptr(), ddy.data_ptr(), dw.data_ptr(),
                 None if db is None else db.data_ptr(),
                 B, nh, nw, cin, oh, ow, cout, kh, kw,
                 *spec.stride, *spec.padding, *spec.dilation,
                 *build.epilogue_args(epilogue), *p[:5], *bufs,
                 torch.cuda.current_stream().cuda_stream)
    build.check_launch("tconv_backward", err)
    return ddy, dw, db


def _autotune_operands(spec: ConvSpec, x_shape, dy_shape, epilogue,
                       out_shape, dtype=torch.float32):
    """Fixed random inputs of `dtype` on the card for a backward's
    runner: the big side, the small side at scale 1/sqrt(B*Oh*Ow) (each
    dW sum of order 1), the filter at 1/sqrt(Kh*Kw*max(Cin, Cout)), and
    an `out_shape` output the epilogue could give."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    kh, kw = spec.filter_shape
    big = torch.randn(x_shape, generator=gen, device="cuda")
    small = torch.randn(dy_shape, generator=gen, device="cuda") \
        / (dy_shape[0] * dy_shape[1] * dy_shape[2]) ** 0.5
    w = torch.randn((kh, kw, x_shape[3], dy_shape[3]), generator=gen,
                    device="cuda") / (kh * kw * max(x_shape[3],
                                                    dy_shape[3])) ** 0.5
    out = None
    if epilogue is not None and epilogue.needs_y:
        act = Epilogue(activation=epilogue.activation, slope=epilogue.slope)
        out = act.apply(torch.randn(out_shape, generator=gen, device="cuda"))
    return _rounded(dtype, big, small, w, out)


def _conv_backward_runner(spec: ConvSpec, x_shape, dy_shape, epilogue=None,
                          dtype=torch.float32):
    x, dy, w, y = _autotune_operands(spec, x_shape, dy_shape, epilogue,
                                     dy_shape, dtype)
    return lambda p: conv_backward_cuda(x, dy, w, spec, n_out=x_shape[1:3],
                                        y=y, epilogue=epilogue, plan=p)


def _tconv_backward_runner(spec: ConvSpec, x_shape, dy_shape, epilogue=None,
                           dtype=torch.float32):
    g, dy, w, z = _autotune_operands(spec, x_shape, dy_shape, epilogue,
                                     x_shape, dtype)
    return lambda p: tconv_backward_cuda(g, dy, w, spec, z=z,
                                         epilogue=epilogue, plan=p)


tiling.register_autotune_runner("backward", _conv_backward_runner)
tiling.register_autotune_runner("ct_backward", _tconv_backward_runner)
