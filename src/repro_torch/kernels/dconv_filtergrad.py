"""Zero-free filter gradient of a direct / dilated conv: the CUDA kernel
`csrc/dconv_filtergrad.cu` and its plain PyTorch version (port of
`repro/kernels/dconv_filtergrad.py`).

    dW[kx,ky,ci,co] = sum_{b,i,j} x[b, i*S+kx*D-P, j*S+ky*D-P, ci]
                                  * dy[b,i,j,co]

over the K*K real taps; the D-dilated filter never exists.  The plain
version repeats `_fg_kernel`'s arithmetic: pad x once, one strided tap
gather per (kx, ky), one (Cin x B*Oh*Ow) @ (B*Oh*Ow x Cout) matmul per
tap (bf16 operands widened to fp32 first, dW rounded to bf16 once, as
`repro`'s kernel casts back).  The kernel is the dW role of the two fused backwards
(`csrc/conv_body.cuh::dw_tile`, planned by `kernels/tiling.py`)
launched alone.
Public entry: `kernels/ops.py::dconv_filter_grad`.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.spec import ConvSpec
from repro_torch.kernels import build, tiling
from repro_torch.kernels.tap_gather import gather_tap, pad_to_tap_windows

# x, dy, dw; the geometry; dw_tile, dw_splits, chunk; the workspace and
# its floats, the tickets and their count; the stream.
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 18
             + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_void_p])


def dconv_filter_grad_plain(x: torch.Tensor, dy: torch.Tensor,
                            spec: ConvSpec) -> torch.Tensor:
    """x (B,Nh,Nw,Cin), dy (B,Oh,Ow,Cout) -> dW (Kh,Kw,Cin,Cout), in x's
    dtype."""
    dtype = x.dtype
    x, dy = build.widened(x, dy)
    B, _, _, cin = x.shape
    _, oh, ow, cout = dy.shape
    (sh, sw), (ph, pw), (dh, dw) = spec.stride, spec.padding, spec.dilation
    kh, kw = spec.filter_shape
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    xp = pad_to_tap_windows(xp, stride=(sh, sw), dilation=(dh, dw),
                            k=(kh, kw), out_size=(oh, ow))
    rhs = dy.reshape(B * oh * ow, cout)
    taps = []
    for kx in range(kh):
        for ky in range(kw):
            tap = gather_tap(xp, kx, ky, sh=sh, sw=sw, dh=dh, dw=dw,
                             oh=oh, ow=ow)              # (B, oh, ow, Cin)
            taps.append(torch.matmul(tap.reshape(B * oh * ow, cin).t(), rhs))
    return torch.stack(taps).reshape(kh, kw, cin, cout).to(dtype)


def dconv_filter_grad_cuda(x: torch.Tensor, dy: torch.Tensor,
                           spec: ConvSpec, *, plan=None) -> torch.Tensor:
    """Launch the kernel on the current stream at `plan` (a
    `dconv_backward.BackwardPlan`; default: the planner's).  fp32 or
    bf16, one dtype, contiguous, one device -- the wrapper in
    `kernels/ops.py` checks all four."""
    B, nh, nw, cin = x.shape
    _, oh, ow, cout = dy.shape
    kh, kw = spec.filter_shape
    dw = torch.empty((kh, kw, cin, cout), dtype=x.dtype, device=x.device)
    # Imported here: dconv_backward imports this module's plain version.
    from repro_torch.kernels.dconv_backward import launch_buffers
    p = plan or tiling.plan_tiles("filter_grad", spec, x_shape=x.shape,
                                  dy_shape=dy.shape, dtype=x.dtype)
    ws, bufs = launch_buffers(p, x.device)
    fn = build.kernel_function("dconv_filtergrad",
                               build.symbol("dconv_filter_grad", x.dtype),
                               _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dy.data_ptr(), dw.data_ptr(),
                 B, nh, nw, cin, oh, ow, cout, kh, kw,
                 *spec.stride, *spec.padding, *spec.dilation,
                 p.dw_tile, p.dw_splits, p.chunk, *bufs,
                 torch.cuda.current_stream().cuda_stream)
    build.check_launch("dconv_filtergrad", err)
    return dw


def _autotune_runner(spec: ConvSpec, x_shape, dy_shape, epilogue=None,
                     dtype=torch.float32):
    """The planner's runner: the kernel at a given plan on fixed random
    inputs of `dtype` on the card, dy at scale 1/sqrt(B*Oh*Ow) (each sum
    of order 1)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(x_shape, generator=gen, device="cuda").to(dtype)
    dy = (torch.randn(dy_shape, generator=gen, device="cuda")
          / (dy_shape[0] * dy_shape[1] * dy_shape[2]) ** 0.5).to(dtype)
    return lambda p: dconv_filter_grad_cuda(x, dy, spec, plan=p)


tiling.register_autotune_runner("filter_grad", _autotune_runner)
