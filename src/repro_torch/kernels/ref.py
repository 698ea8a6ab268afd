"""Oracles for the conv kernels (port of the conv half of
`repro/kernels/ref.py`): each is the mathematical specification of one
kernel, written with the dense zero-free or `F.conv2d` ops."""
from __future__ import annotations

from repro_torch.core import ecoflow


def tconv_phase_ref(dy, w, *, stride, padding, n_out, dilation=(1, 1)):
    """Oracle for the (phase, tap) and implicit-GEMM transposed-conv
    kernels (any stride x dilation pair)."""
    return ecoflow.transposed_conv_zero_free(
        dy, w, stride=stride, padding=padding, n_out=tuple(n_out),
        dilation=tuple(dilation))


def dconv_forward_ref(x, w, *, stride, padding, dilation):
    """Oracle for the dilated-forward kernel: `F.conv2d`'s own dilated
    conv."""
    return ecoflow.direct_conv(x, w, stride, padding, dilation=dilation)
