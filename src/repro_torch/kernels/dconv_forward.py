"""Zero-free direct / dilated (atrous) forward convolution: the CUDA kernel
`csrc/dconv_forward.cu` and its plain PyTorch version (port of
`repro/kernels/dconv_forward.py`).

    y[b,i,j,co] = ep( sum_{kx,ky,ci} x[b, i*S+kx*D-P, j*S+ky*D-P, ci]
                                     * W[kx,ky,ci,co] )

over the K*K real taps; the D-dilated filter never exists.  The plain
version repeats the reference's arithmetic -- pad once, one strided window
per tap, one matmul per tap into an fp32 accumulator, then the epilogue --
and is what the CPU tests run and what the card's kernel is held against.
bf16 operands give a bf16 output, as `repro`'s kernel casts back: both
versions widen them to fp32, sum and apply the epilogue in fp32, and
round once.
The kernel is the ddy role of the tiled implicit-GEMM engine
(`csrc/conv_body.cuh`), its tiles and splits from the planner
(`kernels/tiling.py`: `dconv_backward.plan`, or an autotuned plan), with
the epilogue in its store.  Public entry:
`kernels/ops.py::dconv_forward`.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.spec import ConvSpec, Epilogue
from repro_torch.kernels import build, tiling
from repro_torch.kernels.tap_gather import gather_tap, pad_to_tap_windows

# x, w, bias, y; the geometry; the epilogue; the plan's tile and splits,
# the workspace and its floats, the tickets and their count; the stream.
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 15
             + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_float]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int64]
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


def _out_size(spec: ConvSpec, x: torch.Tensor) -> tuple[int, int]:
    oh, ow = spec.out_size((x.shape[1], x.shape[2]))
    if oh < 1 or ow < 1:
        raise ValueError(
            f"input {tuple(x.shape[1:3])} too small for effective filter "
            f"{spec.dilated_filter_shape} at padding {spec.padding}")
    return oh, ow


def dconv_forward_plain(x: torch.Tensor, w: torch.Tensor, spec: ConvSpec, *,
                        bias=None, epilogue: Epilogue | None = None
                        ) -> torch.Tensor:
    """x (B,Nh,Nw,Cin), w (Kh,Kw,Cin,Cout) -> y (B,Oh,Ow,Cout), in x's
    dtype."""
    dtype = x.dtype
    x, w, bias = build.widened(x, w, bias)
    oh, ow = _out_size(spec, x)
    (sh, sw), (ph, pw), (dh, dw) = spec.stride, spec.padding, spec.dilation
    kh, kw = spec.filter_shape
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    xp = pad_to_tap_windows(xp, stride=(sh, sw), dilation=(dh, dw),
                            k=(kh, kw), out_size=(oh, ow))
    acc = None
    for kx in range(kh):
        for ky in range(kw):
            tap = gather_tap(xp, kx, ky, sh=sh, sw=sw, dh=dh, dw=dw,
                             oh=oh, ow=ow)              # (B, oh, ow, Cin)
            prod = torch.matmul(tap, w[kx, ky])
            acc = prod if acc is None else acc + prod
    out = acc if epilogue is None else epilogue.apply(acc, bias)
    return out.to(dtype)


def dconv_forward_cuda(x: torch.Tensor, w: torch.Tensor, spec: ConvSpec, *,
                       bias=None, epilogue: Epilogue | None = None,
                       plan=None) -> torch.Tensor:
    """Launch the kernel on the current stream at `plan` (a
    `dconv_backward.BackwardPlan`; default: the planner's).  fp32 or
    bf16, one dtype, contiguous, one device -- the wrapper in
    `kernels/ops.py` checks all four."""
    # dconv_backward imports this module's plain version.
    from repro_torch.kernels import dconv_backward

    oh, ow = _out_size(spec, x)
    B, nh, nw, cin = x.shape
    kh, kw, _, cout = w.shape
    dev = x.device
    y = torch.empty((B, oh, ow, cout), dtype=x.dtype, device=dev)
    p = plan or tiling.plan_tiles("forward", spec, x_shape=x.shape,
                                  dy_shape=y.shape, epilogue=epilogue,
                                  dtype=x.dtype)
    ws, bufs = dconv_backward.launch_buffers(p, dev)
    fn = build.kernel_function("dconv_forward",
                               build.symbol("dconv_forward", x.dtype),
                               _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), w.data_ptr(),
                 None if bias is None else bias.data_ptr(), y.data_ptr(),
                 B, nh, nw, cin, kh, kw, cout, oh, ow,
                 *spec.stride, *spec.padding, *spec.dilation,
                 *build.epilogue_args(epilogue), p.tile, p.splits, *bufs,
                 torch.cuda.current_stream().cuda_stream)
    build.check_launch("dconv_forward", err)
    return y


def _autotune_runner(spec: ConvSpec, x_shape, dy_shape, epilogue=None,
                     dtype=torch.float32):
    """The planner's runner: the kernel at a given plan on fixed random
    inputs of `dtype` on the card (weights scaled so each output is of
    order 1)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    kh, kw = spec.filter_shape
    x = torch.randn(x_shape, generator=gen, device="cuda").to(dtype)
    w = (torch.randn((kh, kw, x_shape[3], dy_shape[3]), generator=gen,
                     device="cuda") / (kh * kw * x_shape[3]) ** 0.5).to(dtype)
    bias = torch.randn(dy_shape[3], generator=gen, device="cuda").to(dtype) \
        if epilogue is not None and epilogue.bias else None
    return lambda p: dconv_forward_cuda(x, w, spec, bias=bias,
                                        epilogue=epilogue, plan=p)


tiling.register_autotune_runner("forward", _autotune_runner)
