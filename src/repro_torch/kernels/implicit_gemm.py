"""Predicated implicit-GEMM transposed convolution, any (stride S,
dilation D): the CUDA kernel `csrc/implicit_gemm.cu`, its plan and its
plain PyTorch version (port of `repro/kernels/implicit_gemm.py`).

The same function as `kernels/tconv_phase.py`, written as ONE flat GEMM
over the full (Fh, Fw) transposed frame and all Kh*Kw taps, where lane
(site r, tap kx) is in bound iff h = r - kx*D satisfies h >= 0,
h % S == 0 and h // S < Oh.  The masked fraction is exactly
`ecoflow.predicated_mac_fraction(spec, (Oh, Ow))`.

The plain version repeats the reference's arithmetic: dy zero-interleaved
and framed by the tap reach D*(K-1), one static window and matmul per
tap over the full frame, the epilogue, then the tail fill and padding
crop (bf16 operands widened to fp32 first, dx rounded to bf16 once, as
`repro`'s kernel casts back).  The kernel's stages hold the operands in
their own dtype, so `plan` counts shared memory at the launch's
`itemsize`.  The kernel skips the dead lanes instead: one CTA per tile of
TH x TW output sites and Cin_t output channels stages the tile's dy halo
and the weights in shared memory, one Cout chunk at a time, and each
thread sums one site over the live taps.  `plan`, a pure function of the
shapes, picks the tile, the Cin tile and the chunk (the launcher takes
it, or an autotuned one of `candidates`, from `kernels/tiling.py`);
`halo_origin` and `halo_extent` are the halo the kernel copies.
Public entry: `kernels/ops.py::tconv_phase(strategy="implicit_gemm")`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.spec import ConvSpec, Epilogue
from repro_torch.kernels import build, tiling

# dy, w, bias, dx; the geometry; the epilogue; the plan's tile, Cin tile
# and chunk; the stream.
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 15
             + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_float]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])

SMEM_BYTES = 232448   # dynamic shared memory of one CTA (csrc kSmemBytes)
MAX_THREADS = 512     # one thread per site of a tile (csrc kMaxThreads)
MAX_CHUNK = 32        # Cout of one stage (csrc kMaxChunk)
CHUNKS = (4, 8, 16, MAX_CHUNK)   # the kernel's instantiations
CIN_TILES = (1, 2, 3, 4, 8)      # the kernel's instantiations
WARP = 32
CTA_SITES = 128       # sites of a tile when a class's warp gives fewer
MIN_CLASS_COLS = 8    # columns of one residue class in a tile
MAX_CLASS_COLS = 16


class IGPlan(NamedTuple):
    th: int         # tile rows (sites), a multiple of the row stride
    tw: int         # tile columns, a multiple of the column stride
    cin_t: int      # output channels per CTA (CIN_TILES)
    chunk: int      # Cout per stage of the in-CTA loop (CHUNKS)
    ctas: int       # tiles x Cin tiles
    smem: int       # dynamic shared-memory bytes
    threads: int    # per CTA: one per site, th * tw
    tiles: int      # spatial tiles over (B, Nh, Nw)
    halo: tuple     # (rows, cols) of the dy halo
    stages: int     # 2 when Cout takes more than one chunk


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _pow2_floor(n: int) -> int:
    return 1 << max(0, n.bit_length() - 1)


def halo_origin(spec: ConvSpec, y0: int, x0: int) -> tuple[int, int]:
    """The first dy row and column of the halo of the tile at site (y0,
    x0): the least i with i*S >= y0 + P - D*(K-1)."""
    return tuple(_cdiv(o + p - d * (k - 1), s) for o, s, p, d, k in zip(
        (y0, x0), spec.stride, spec.padding, spec.dilation,
        spec.filter_shape))


def halo_extent(spec: ConvSpec, th: int, tw: int) -> tuple[int, int]:
    """(rows, cols) of dy that the sites of a th x tw tile reach through
    a tap: the same for every tile, since each starts at a multiple of
    the stride."""
    return tuple((p + t - 1) // s - _cdiv(p - d * (k - 1), s) + 1
                 for t, s, p, d, k in zip(
                     (th, tw), spec.stride, spec.padding, spec.dilation,
                     spec.filter_shape))


def halo_pitch(chunk: int, itemsize: int = 4) -> int:
    """Elements per halo position: the chunk padded to an odd number of
    16-byte words, so a quarter-warp's lanes hit distinct banks."""
    word = 16 // itemsize
    words = _cdiv(chunk, word)
    return (words if words % 2 else words + 1) * word


def counted(spec: ConvSpec, batch: int, n_out, cin: int, cout: int,
            th: int, tw: int, cin_t: int, chunk: int,
            itemsize: int = 4) -> IGPlan:
    """The IGPlan of this tile, Cin tile and chunk, counted as the kernel
    counts its CTAs and shared memory: each stage a whole number of
    16-byte words of `itemsize`-byte elements."""
    kh, kw = spec.filter_shape
    hh, hw = halo_extent(spec, th, tw)
    stages = 2 if cout > chunk else 1
    word = 16 // itemsize
    stage = _cdiv(hh * hw * halo_pitch(chunk, itemsize)
                  + kh * kw * cin_t * chunk, word) * word
    smem = itemsize * stages * stage
    tiles = batch * _cdiv(n_out[0], th) * _cdiv(n_out[1], tw)
    return IGPlan(th, tw, cin_t, chunk, tiles * _cdiv(cin, cin_t), smem,
                  th * tw, tiles, (hh, hw), stages)


def plan(spec: ConvSpec, batch: int, n_out, in_hw, cin: int,
         cout: int, itemsize: int = 4) -> IGPlan:
    """The kernel's tile, Cin tile and Cout chunk for one launch.

    A tile holds cu x cv sites of each of the S_h * S_w residue classes
    (th = S_h * cu, tw = S_w * cv): one warp's sites per class, or
    CTA_SITES / classes where that is more; cv is the class's columns in
    the frame, rounded up to a power of two, between MIN_CLASS_COLS and
    MAX_CLASS_COLS.  At most MAX_THREADS sites (cu, then cv, halve).  The
    chunk is Cout rounded up to a power of two, at least 4 and at most
    MAX_CHUNK; it halves, then the tile, until the stages (of
    `itemsize`-byte elements: 4 fp32, 2 bf16) fit SMEM_BYTES.  Raises
    ValueError, naming the geometry, when nothing fits.  `batch`
    and `in_hw` (dy's size, implied by `n_out`) only count the CTAs."""
    (sh, sw) = spec.stride
    classes = sh * sw
    cin_t = cin if cin <= 4 else 8
    sites = max(WARP, _pow2_floor(CTA_SITES // classes))
    cv = min(sites, MAX_CLASS_COLS,
             max(MIN_CLASS_COLS, _pow2_ceil(_cdiv(n_out[1], sw))))
    cu = sites // cv
    while classes * cu * cv > MAX_THREADS and cu > 1:
        cu //= 2
    while classes * cu * cv > MAX_THREADS and cv > 1:
        cv //= 2
    chunk = min(MAX_CHUNK, max(4, _pow2_ceil(cout)))
    if classes * cu * cv <= MAX_THREADS:
        while True:
            p = counted(spec, batch, n_out, cin, cout, sh * cu, sw * cv,
                        cin_t, chunk, itemsize)
            if p.smem <= SMEM_BYTES:
                return p
            if chunk > 4:
                chunk //= 2
            elif cu > 1:
                cu //= 2
            elif cv > 1:
                cv //= 2
            else:
                break
    raise ValueError(
        f"implicit-GEMM tconv: no tile fits stride={spec.stride}, "
        f"dilation={spec.dilation}, filter={spec.filter_shape}, "
        f"padding={spec.padding}, dy {tuple(in_hw)} x {cout} -> n_out "
        f"{tuple(n_out)} x {cin} ({MAX_THREADS} threads, {SMEM_BYTES} "
        f"bytes of shared memory)")


SWEEP_SIDES = (1, 2, 4, 8, 16)   # sites per class along an axis, swept


def candidates(spec: ConvSpec, batch: int, n_out, in_hw, cin: int,
               cout: int, itemsize: int = 4) -> list:
    """The plans an autotune sweep times for one launch, `plan`'s own
    first (`scripts/implicit_gemm_sweep.py --sweep` walks the same set):
    cu x cv sites per residue class for cu, cv in SWEEP_SIDES, each class
    at least one warp and the tile at most MAX_THREADS sites, at every
    chunk up to Cout (at least 4) whose stages fit SMEM_BYTES, at
    `plan`'s Cin tile.  Raises ValueError, as `plan` does, when nothing
    fits."""
    own = plan(spec, batch, n_out, in_hw, cin, cout, itemsize)
    sh, sw = spec.stride
    out = [own]
    for cu in SWEEP_SIDES:
        for cv in SWEEP_SIDES:
            if cu * cv < WARP or sh * sw * cu * cv > MAX_THREADS:
                continue
            for chunk in CHUNKS:
                if chunk > max(4, cout):
                    continue
                p = counted(spec, batch, n_out, cin, cout, sh * cu, sw * cv,
                            own.cin_t, chunk, itemsize)
                if p.smem <= SMEM_BYTES and p not in out:
                    out.append(p)
    return out


def _upsample_pad(dy: torch.Tensor, sh: int, sw: int, gh: int,
                  gw: int) -> torch.Tensor:
    """Zero-interleave (B, Oh, Ow, C) by (sh, sw) and pad both sides by the
    tap reach (gh, gw): row r holds dy[(r - gh) // sh] when (r - gh) is a
    non-negative multiple of sh below Oh*sh, else zero -- the failed
    predicate lanes, materialized."""
    B, oh, ow, c = dy.shape
    up = dy.new_zeros((B, (oh - 1) * sh + 1 + 2 * gh,
                       (ow - 1) * sw + 1 + 2 * gw, c))
    up[:, gh:gh + (oh - 1) * sh + 1:sh, gw:gw + (ow - 1) * sw + 1:sw] = dy
    return up


def tconv_implicit_gemm_plain(dy: torch.Tensor, w: torch.Tensor,
                              spec: ConvSpec, *, n_out, bias=None,
                              epilogue: Epilogue | None = None
                              ) -> torch.Tensor:
    """dy (B,Oh,Ow,Cout), w (Kh,Kw,Cin,Cout) -> dx (B,Nh,Nw,Cin), in dy's
    dtype."""
    dtype = dy.dtype
    dy, w, bias = build.widened(dy, w, bias)
    B, Oh, Ow, _ = dy.shape
    Kh, Kw, Cin, _ = w.shape
    sh, sw = spec.stride
    ph, pw = spec.padding
    dh, dw = spec.dilation
    Nh, Nw = n_out
    Fh, Fw = spec.full_size((Oh, Ow))
    up = _upsample_pad(dy, sh, sw, dh * (Kh - 1), dw * (Kw - 1))
    acc = None
    for kx in range(Kh):
        for ky in range(Kw):
            # Tap (kx, ky)'s window offset (K-1-k)*D realizes the
            # transposed orientation: no flip, weights W[kx, ky]^T.
            sh0, sw0 = (Kh - 1 - kx) * dh, (Kw - 1 - ky) * dw
            win = up[:, sh0:sh0 + Fh, sw0:sw0 + Fw]
            prod = torch.matmul(win, w[kx, ky].T)
            acc = prod if acc is None else acc + prod
    out = acc if epilogue is None else epilogue.apply(acc, bias)
    # Non-exact-fit tails lie beyond the full frame: no tap reaches them,
    # so they take epilogue(0) = act(bias) (zero without a bias).
    eh, ew = max(0, ph + Nh - Fh), max(0, pw + Nw - Fw)
    if eh or ew:
        fv = out.new_zeros((Cin,))
        if epilogue is not None and epilogue.bias:
            fv = epilogue.apply(fv, bias)
        if eh:
            out = torch.cat([out, fv.expand(B, eh, out.shape[2], Cin)], dim=1)
        if ew:
            out = torch.cat([out, fv.expand(B, out.shape[1], ew, Cin)], dim=2)
    return out[:, ph:ph + Nh, pw:pw + Nw, :].to(dtype).contiguous()


def tconv_implicit_gemm_cuda(dy: torch.Tensor, w: torch.Tensor,
                             spec: ConvSpec, *, n_out, bias=None,
                             epilogue: Epilogue | None = None,
                             plan: IGPlan | None = None) -> torch.Tensor:
    """Launch the kernel on the current stream at `plan` (default: the
    planner's implicit-GEMM plan).  fp32 or bf16, one dtype, contiguous,
    one device -- the wrapper in `kernels/ops.py` checks all four."""
    B, Oh, Ow, Cout = dy.shape
    Kh, Kw, Cin, _ = w.shape
    Nh, Nw = n_out
    dx = torch.empty((B, Nh, Nw, Cin), dtype=dy.dtype, device=dy.device)
    p = plan or tiling.plan_strategy(
        "input_grad", spec, x_shape=dx.shape, dy_shape=dy.shape,
        epilogue=epilogue, strategy="implicit_gemm", dtype=dy.dtype)[1]
    fn = build.kernel_function("implicit_gemm",
                               build.symbol("tconv_implicit_gemm", dy.dtype),
                               _ARGTYPES)
    with torch.cuda.device(dy.device):
        err = fn(dy.data_ptr(), w.data_ptr(),
                 None if bias is None else bias.data_ptr(), dx.data_ptr(),
                 B, Oh, Ow, Cout, Kh, Kw, Cin, Nh, Nw,
                 *spec.stride, *spec.padding, *spec.dilation,
                 *build.epilogue_args(epilogue), p.th, p.tw, p.cin_t,
                 p.chunk, torch.cuda.current_stream().cuda_stream)
    build.check_launch("implicit_gemm", err)
    return dx


def _autotune_runner(spec: ConvSpec, x_shape, dy_shape, epilogue=None,
                     dtype=torch.float32):
    # tconv_phase imports nothing of this module.
    from repro_torch.kernels.tconv_phase import autotune_operands

    dy, w, bias = autotune_operands(spec, x_shape, dy_shape, epilogue,
                                    dtype)
    return lambda p: tconv_implicit_gemm_cuda(
        dy, w, spec, n_out=x_shape[1:3], bias=bias, epilogue=epilogue,
        plan=p)


tiling.register_autotune_runner("input_grad", _autotune_runner,
                                "implicit_gemm")
