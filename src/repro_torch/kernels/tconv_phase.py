"""Zero-free transposed convolution by residue class (phase), any
(stride S, dilation D): the CUDA kernel `csrc/tconv_phase.cu` and its
plain PyTorch version (port of `repro/kernels/tconv_phase.py`).

    dx[i*S + kx*D - P] += dy[i] . W[kx]^T

Tap kx lands in output residue class (kx*D) mod S.  Residues repeat with
period S/gcd(S, D) in kx, so taps group by kx mod period; within class
`a`, tap kx = a + u*period lands on phase row m = i + (a*D)//S +
u*(D/gcd).  Each class is a stride-1 correlation of dy with its own taps;
no stride or dilation zero is ever multiplied.

The plain version repeats the reference's arithmetic: packed rotated
sub-filters (`pack_phase_filters`), one padded dy, one window and matmul
per (phase, valid slot) into phase-major planes, the epilogue per plane,
then `assemble_phase_major` (bf16 operands widened to fp32 first, dx
rounded to bf16 once, as `repro`'s kernel casts back).  The kernel is the dx role of the tiled
implicit-GEMM engine (`csrc/conv_body.cuh`), its tiles and splits from
the planner (`kernels/tiling.py`: `dconv_backward.plan`, or an autotuned
plan); it folds the assembly and the epilogue into its store.  Public entry: `kernels/ops.py::tconv_phase`.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core import ecoflow
from repro_torch.core.spec import ConvSpec, Epilogue, _pair
from repro_torch.kernels import build, tiling

# dy, w, bias, dx; the geometry and tap phases; the epilogue; the plan's
# tile and splits, the workspace and its floats, the tickets and their
# count; the stream.
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 21
             + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_float]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int64]
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


def pack_phase_filters(w: torch.Tensor, stride,
                       dilation=(1, 1)) -> torch.Tensor:
    """Pack the rotated per-phase sub-filters into one uniform tensor.

    w: (Kh, Kw, Cin, Cout) -> (TPh*TPw, KP, KQ, Cout, Cin) with
    TP = min(K, period), KP = ceil(K/period), period = S/gcd(S, D) per
    axis.  The rotation (180deg flip + Cout->Cin transpose) comes from
    `ecoflow.phase_subfilters` at the period; each flipped sub-filter is
    zero-padded at the FRONT taps, so slot uf of phase `a` holds tap
    kx = a + (KP-1-uf)*period (zero when kx >= K).  Only non-empty phases
    are packed."""
    sh, sw = _pair(stride)
    dh, dw = _pair(dilation)
    Kh, Kw, _, _ = w.shape
    spec = ConvSpec.make(stride=(sh, sw), filter_shape=(Kh, Kw),
                         dilation=(dh, dw))
    per_h, per_w = spec.tap_phase_period
    KP, KQ = spec.taps_per_phase
    subs = ecoflow.phase_subfilters(w, (per_h, per_w))
    phases = []
    for a in range(min(per_h, Kh)):
        for b in range(min(per_w, Kw)):
            sub = subs[a][b]                         # (kp, kq, Cout, Cin)
            kp, kq = sub.shape[0], sub.shape[1]
            phases.append(F.pad(sub, (0, 0, 0, 0, KQ - kq, 0, KP - kp, 0)))
    return torch.stack(phases)


def assemble_phase_major(out: torch.Tensor, spec: ConvSpec, *, n_out,
                         full_size, fill: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Phase-major planes (B, T, ho, wo, Cin) -> dx (B, Nh, Nw, Cin):
    place each phase plane at its stride residue (residues no tap reaches
    take `fill`), interleave (rows r = m*S + p), crop the padding and
    fill the non-exact-fit tails.  `fill` ((Cin,)) is epilogue(0) =
    act(bias) under a bias epilogue; None means zero."""
    B, _, ho, wo, cin = out.shape
    sh, sw = spec.stride
    ph, pw = spec.padding
    nh, nw = n_out
    fh, fw = full_size
    tph, tpw = spec.n_tap_phases
    out = out.reshape(B, tph, tpw, ho, wo, cin)
    idx_h = [tph] * sh   # sentinel TPh/TPw -> the fill plane
    for a in range(tph):
        idx_h[spec.tap_phase_residue(a, 0)] = a
    idx_w = [tpw] * sw
    for b in range(tpw):
        idx_w[spec.tap_phase_residue(b, 1)] = b
    if (tph, tpw) != (sh, sw) or idx_h != list(range(sh)) \
            or idx_w != list(range(sw)):
        if fill is None:
            out = F.pad(out, (0, 0, 0, 0, 0, 0, 0, 1, 0, 1))
        else:
            fv = fill.to(out.dtype)
            out = torch.cat([out, fv.expand(B, 1, tpw, ho, wo, cin)], dim=1)
            out = torch.cat([out, fv.expand(B, tph + 1, 1, ho, wo, cin)],
                            dim=2)
        dev = out.device
        out = out[:, torch.tensor(idx_h, device=dev)]
        out = out[:, :, torch.tensor(idx_w, device=dev)]
    dx_full = out.permute(0, 3, 1, 4, 2, 5).reshape(
        B, ho * sh, wo * sw, cin)[:, :fh, :fw, :]
    eh, ew = max(0, ph + nh - fh), max(0, pw + nw - fw)
    if eh or ew:
        if fill is None:
            dx_full = F.pad(dx_full, (0, 0, 0, ew, 0, eh))
        else:
            fv = fill.to(dx_full.dtype)
            h = dx_full.shape[1]
            if eh:
                dx_full = torch.cat(
                    [dx_full, fv.expand(B, eh, dx_full.shape[2], cin)], dim=1)
            if ew:
                dx_full = torch.cat(
                    [dx_full, fv.expand(B, h + eh, ew, cin)], dim=2)
    return dx_full[:, ph:ph + nh, pw:pw + nw, :].contiguous()


def tconv_fused_plain(dy: torch.Tensor, w: torch.Tensor, spec: ConvSpec, *,
                      n_out, bias=None, epilogue: Epilogue | None = None
                      ) -> torch.Tensor:
    """dy (B,Oh,Ow,Cout), w (Kh,Kw,Cin,Cout) -> dx (B,Nh,Nw,Cin), in dy's
    dtype."""
    dtype = dy.dtype
    dy, w, bias = build.widened(dy, w, bias)
    B, Oh, Ow, _ = dy.shape
    Kh, Kw, Cin, _ = w.shape
    sh, sw = spec.stride
    dh, dw = spec.dilation
    Nh, Nw = n_out
    Fh, Fw = spec.full_size((Oh, Ow))
    step_h, step_w = spec.tap_phase_step
    per_h, per_w = spec.tap_phase_period
    TPh, TPw = spec.n_tap_phases
    KP, KQ = spec.taps_per_phase
    w_packed = pack_phase_filters(w, (sh, sw), (dh, dw))
    # Pad dy once: front by the largest tap offset, tail so every phase
    # window of ho rows fits.
    pad_h = spec.tap_phase_base(TPh - 1, 0) + (KP - 1) * step_h
    pad_w = spec.tap_phase_base(TPw - 1, 1) + (KQ - 1) * step_w
    ho, wo = -(-Fh // sh), -(-Fw // sw)
    dy_pad = F.pad(dy, (0, 0, pad_w, wo - Ow, pad_h, ho - Oh))
    planes = []
    for t in range(TPh * TPw):
        a, b = divmod(t, TPw)
        acc = dy.new_zeros((B, ho, wo, Cin))
        for uf in range(KP):
            if a + (KP - 1 - uf) * per_h >= Kh:
                continue                   # padding slot of a ragged phase
            start_h = pad_h - (a * dh) // sh - (KP - 1 - uf) * step_h
            for vf in range(KQ):
                if b + (KQ - 1 - vf) * per_w >= Kw:
                    continue
                start_w = pad_w - (b * dw) // sw - (KQ - 1 - vf) * step_w
                win = dy_pad[:, start_h:start_h + ho, start_w:start_w + wo]
                acc = acc + torch.matmul(win, w_packed[t, uf, vf])
        planes.append(acc if epilogue is None else epilogue.apply(acc, bias))
    fill = None
    if epilogue is not None and epilogue.bias:
        fill = epilogue.apply(dy.new_zeros((Cin,)), bias)
    return assemble_phase_major(torch.stack(planes, dim=1), spec,
                                n_out=(Nh, Nw), full_size=(Fh, Fw),
                                fill=fill).to(dtype)


def tconv_fused_cuda(dy: torch.Tensor, w: torch.Tensor, spec: ConvSpec, *,
                     n_out, bias=None, epilogue: Epilogue | None = None,
                     plan=None) -> torch.Tensor:
    """Launch the kernel on the current stream at `plan` (a
    `dconv_backward.BackwardPlan`; default: the planner's phase plan).
    fp32 or bf16, one dtype, contiguous, one device -- the wrapper in
    `kernels/ops.py` checks all four."""
    # dconv_backward imports this module's plain version.
    from repro_torch.kernels import dconv_backward

    B, Oh, Ow, Cout = dy.shape
    Kh, Kw, Cin, _ = w.shape
    Nh, Nw = n_out
    dev = dy.device
    dx = torch.empty((B, Nh, Nw, Cin), dtype=dy.dtype, device=dev)
    p = plan or tiling.plan_tiles("input_grad", spec, x_shape=dx.shape,
                                  dy_shape=dy.shape, epilogue=epilogue,
                                  dtype=dy.dtype)
    ws, bufs = dconv_backward.launch_buffers(p, dev)
    fn = build.kernel_function("tconv_phase",
                               build.symbol("tconv_phase", dy.dtype),
                               _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(dy.data_ptr(), w.data_ptr(),
                 None if bias is None else bias.data_ptr(), dx.data_ptr(),
                 B, Oh, Ow, Cout, Kh, Kw, Cin, Nh, Nw,
                 *spec.stride, *spec.padding, *spec.dilation,
                 *spec.tap_phase_period, *spec.tap_phase_step,
                 *spec.n_tap_phases,
                 *build.epilogue_args(epilogue), p.tile, p.splits, *bufs,
                 torch.cuda.current_stream().cuda_stream)
    build.check_launch("tconv_phase", err)
    return dx


def autotune_operands(spec: ConvSpec, x_shape, dy_shape, epilogue=None,
                      dtype=torch.float32):
    """(dy, w, bias) of a transposed conv's runner: fixed random inputs of
    `dtype` on the card, the weights scaled so each output is of order 1
    (both strategies' runners take these, so the race times one
    function)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    kh, kw = spec.filter_shape
    taps = max(1, -(-kh // spec.stride[0]) * -(-kw // spec.stride[1]))
    dy = torch.randn(dy_shape, generator=gen, device="cuda").to(dtype)
    w = (torch.randn((kh, kw, x_shape[3], dy_shape[3]), generator=gen,
                     device="cuda") / (taps * dy_shape[3]) ** 0.5).to(dtype)
    bias = torch.randn(x_shape[3], generator=gen, device="cuda").to(dtype) \
        if epilogue is not None and epilogue.bias else None
    return dy, w, bias


def _autotune_runner(spec: ConvSpec, x_shape, dy_shape, epilogue=None,
                     dtype=torch.float32):
    dy, w, bias = autotune_operands(spec, x_shape, dy_shape, epilogue,
                                    dtype)
    return lambda p: tconv_fused_cuda(dy, w, spec, n_out=x_shape[1:3],
                                      bias=bias, epilogue=epilogue, plan=p)


tiling.register_autotune_runner("input_grad", _autotune_runner)
