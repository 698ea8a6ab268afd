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
forward and filter-grad versions.  Each kernel computes all of its
outputs in ONE launch, as `repro` does in one `pallas_call`, and forms
the mask as it loads the cotangent.  Public entries:
`kernels/ops.py::conv_backward` / `tconv_backward`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.spec import ConvSpec, Epilogue
from repro_torch.kernels import build
from repro_torch.kernels.dconv_filtergrad import dconv_filter_grad_plain
from repro_torch.kernels.dconv_forward import dconv_forward_plain
from repro_torch.kernels.tconv_phase import tconv_fused_plain

_EP_ARGS = [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_float]
_BWD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 25 + _EP_ARGS
                 + [ctypes.c_void_p])
_CT_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 15 + _EP_ARGS
                + [ctypes.c_void_p])


def _masked(cot: torch.Tensor, out, epilogue: Epilogue | None):
    """(cot * act'(out), the same times the epilogue's scale)."""
    if epilogue is None:
        return cot, cot
    m = cot if out is None else epilogue.mask_cotangent(out, cot)
    return m, (m if epilogue.scale is None else m * epilogue.scale)


def conv_backward_plain(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor,
                        spec: ConvSpec, *, n_out, y=None,
                        epilogue: Epilogue | None = None):
    """(dx (B,Nh,Nw,Cin), dW (Kh,Kw,Cin,Cout), db (Cout,) or None)."""
    m, g = _masked(dy, y, epilogue)
    db = m.sum(dim=(0, 1, 2)) if epilogue is not None and epilogue.bias \
        else None
    dx = tconv_fused_plain(g, w, spec, n_out=n_out)
    return dx, dconv_filter_grad_plain(x, g, spec), db


def tconv_backward_plain(g: torch.Tensor, dy: torch.Tensor, w: torch.Tensor,
                         spec: ConvSpec, *, z=None,
                         epilogue: Epilogue | None = None):
    """(ddy (B,Oh,Ow,Cout), dW (Kh,Kw,Cin,Cout), db (Cin,) or None)."""
    gm, gs = _masked(g, z, epilogue)
    db = gm.sum(dim=(0, 1, 2)) if epilogue is not None and epilogue.bias \
        else None
    ddy = dconv_forward_plain(gs, w, spec)
    return ddy, dconv_filter_grad_plain(gs, dy, spec), db


def conv_backward_cuda(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor,
                       spec: ConvSpec, *, n_out, y=None,
                       epilogue: Epilogue | None = None):
    """Launch the kernel on the current stream.  fp32, contiguous, one
    device -- the wrapper in `kernels/ops.py` checks all three."""
    B, nh_x, nw_x, cin = x.shape
    _, oh, ow, cout = dy.shape
    kh, kw = spec.filter_shape
    nh, nw = n_out
    dev = x.device
    dx = torch.empty((B, nh, nw, cin), dtype=torch.float32, device=dev)
    dw = torch.empty((kh, kw, cin, cout), dtype=torch.float32, device=dev)
    has_db = epilogue is not None and epilogue.bias
    db = torch.empty((cout,), dtype=torch.float32, device=dev) \
        if has_db else None
    fn = build.kernel_function("conv_backward", "conv_backward_f32",
                               _BWD_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), dy.data_ptr(),
                 None if y is None else y.data_ptr(), w.data_ptr(),
                 dx.data_ptr(), dw.data_ptr(),
                 None if db is None else db.data_ptr(),
                 B, nh_x, nw_x, cin, oh, ow, cout, kh, kw, nh, nw,
                 *spec.stride, *spec.padding, *spec.dilation,
                 *spec.tap_phase_period, *spec.tap_phase_step,
                 *spec.taps_per_phase, *spec.n_tap_phases,
                 *build.epilogue_args(epilogue),
                 torch.cuda.current_stream().cuda_stream)
    build.check_launch("conv_backward", err)
    return dx, dw, db


def tconv_backward_cuda(g: torch.Tensor, dy: torch.Tensor, w: torch.Tensor,
                        spec: ConvSpec, *, z=None,
                        epilogue: Epilogue | None = None):
    """Launch the kernel on the current stream.  fp32, contiguous, one
    device -- the wrapper in `kernels/ops.py` checks all three."""
    B, nh, nw, cin = g.shape
    _, oh, ow, cout = dy.shape
    kh, kw = spec.filter_shape
    dev = g.device
    ddy = torch.empty((B, oh, ow, cout), dtype=torch.float32, device=dev)
    dw = torch.empty((kh, kw, cin, cout), dtype=torch.float32, device=dev)
    has_db = epilogue is not None and epilogue.bias
    db = torch.empty((cin,), dtype=torch.float32, device=dev) \
        if has_db else None
    fn = build.kernel_function("tconv_backward", "tconv_backward_f32",
                               _CT_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(g.data_ptr(), None if z is None else z.data_ptr(),
                 dy.data_ptr(), w.data_ptr(), ddy.data_ptr(), dw.data_ptr(),
                 None if db is None else db.data_ptr(),
                 B, nh, nw, cin, oh, ow, cout, kh, kw,
                 *spec.stride, *spec.padding, *spec.dilation,
                 *build.epilogue_args(epilogue),
                 torch.cuda.current_stream().cuda_stream)
    build.check_launch("tconv_backward", err)
    return ddy, dw, db
