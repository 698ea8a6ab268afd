"""Predicated implicit-GEMM transposed convolution, any (stride S,
dilation D): the CUDA kernel `csrc/implicit_gemm.cu` and its plain
PyTorch version (port of `repro/kernels/implicit_gemm.py`).

The same function as `kernels/tconv_phase.py`, written as ONE flat GEMM
over the full (Fh, Fw) transposed frame and all Kh*Kw taps, where lane
(site r, tap kx) is in bound iff h = r - kx*D satisfies h >= 0,
h % S == 0 and h // S < Oh.  The masked fraction is exactly
`ecoflow.predicated_mac_fraction(spec, (Oh, Ow))`.

The plain version repeats the reference's arithmetic: dy zero-interleaved
and framed by the tap reach D*(K-1), one static window and matmul per
tap over the full frame, the epilogue, then the tail fill and padding
crop.  The kernel reads dy in place behind an address predicate instead.
Public entry: `kernels/ops.py::tconv_phase(strategy="implicit_gemm")`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.spec import ConvSpec, Epilogue
from repro_torch.kernels import build

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 15
             + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p])


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
    """dy (B,Oh,Ow,Cout), w (Kh,Kw,Cin,Cout) -> dx (B,Nh,Nw,Cin)."""
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
    return out[:, ph:ph + Nh, pw:pw + Nw, :].contiguous()


def tconv_implicit_gemm_cuda(dy: torch.Tensor, w: torch.Tensor,
                             spec: ConvSpec, *, n_out, bias=None,
                             epilogue: Epilogue | None = None
                             ) -> torch.Tensor:
    """Launch the kernel on the current stream.  fp32, contiguous, one
    device -- the wrapper in `kernels/ops.py` checks all three."""
    B, Oh, Ow, Cout = dy.shape
    Kh, Kw, Cin, _ = w.shape
    Nh, Nw = n_out
    dx = torch.empty((B, Nh, Nw, Cin), dtype=torch.float32, device=dy.device)
    fn = build.kernel_function("implicit_gemm", "tconv_implicit_gemm_f32",
                               _ARGTYPES)
    with torch.cuda.device(dy.device):
        err = fn(dy.data_ptr(), w.data_ptr(),
                 None if bias is None else bias.data_ptr(), dx.data_ptr(),
                 B, Oh, Ow, Cout, Kh, Kw, Cin, Nh, Nw,
                 *spec.stride, *spec.padding, *spec.dilation,
                 *build.epilogue_args(epilogue),
                 torch.cuda.current_stream().cuda_stream)
    build.check_launch("implicit_gemm", err)
    return dx
