"""Naive (materialized-zero) baselines for transposed and dilated convs
(port of `repro/core/naive.py`).

What a CNN-inference accelerator does when handed a transposed or dilated
convolution (paper Sec. 3.1): insert `S-1` zero rows/cols into the error
map (inner padding), add `K-1` border zeros (outer padding), then run a
plain direct convolution.  Every function here really stores the zeros,
then makes one `F.conv2d` call (cuDNN on the card), so the zero
multiplications are real work.

They serve as correctness oracles for the zero-free paths and as the
materialized-zero arm of the quickstart's timing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.ecoflow import direct_conv
from repro_torch.core.spec import _pair


def dilate_insert_zeros(x: torch.Tensor, stride) -> torch.Tensor:
    """Insert (S-1) zeros between spatial elements of NHWC x."""
    sh, sw = _pair(stride)
    if sh == 1 and sw == 1:
        return x
    B, H, W, C = x.shape
    out = x.new_zeros((B, sh * (H - 1) + 1, sw * (W - 1) + 1, C))
    out[:, ::sh, ::sw, :] = x
    return out


def dilate_filter_insert_zeros(w: torch.Tensor, dilation) -> torch.Tensor:
    """Materialize an HWIO filter at its effective receptive field: insert
    (D-1) zeros between taps, yielding (D*(K-1)+1, ...) spatial extent."""
    dh, dw = _pair(dilation)
    if dh == 1 and dw == 1:
        return w
    Kh, Kw, Ci, Co = w.shape
    out = w.new_zeros((dh * (Kh - 1) + 1, dw * (Kw - 1) + 1, Ci, Co))
    out[::dh, ::dw] = w
    return out


def dilated_forward_naive(x: torch.Tensor, w: torch.Tensor, *, stride=1,
                          padding=0, dilation=2) -> torch.Tensor:
    """Dilated (atrous) forward conv via an explicitly materialized dilated
    filter + plain direct conv: every inserted filter zero is a MAC."""
    return direct_conv(x, dilate_filter_insert_zeros(w, dilation), stride,
                       padding)


def dilated_forward_zero_mac_fraction(k: int, dilation: int) -> float:
    """Fraction of MACs that touch an inserted filter zero in the naive
    dilated forward conv: K^2 of each window's K_eff^2 MACs are real."""
    k_eff = dilation * (k - 1) + 1
    return 1.0 - (k * k) / (k_eff * k_eff)


def transposed_conv_naive(dy: torch.Tensor, w: torch.Tensor, *, stride,
                          padding=0, n_out=None) -> torch.Tensor:
    """Transposed conv via explicit zero insertion + border padding + direct
    conv with the 180deg-rotated filter.  (B,O,O,Cout) -> (B,N,N,Cin)."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    _, Oh, Ow, _ = dy.shape
    Kh, Kw, _, _ = w.shape
    if n_out is None:
        n_out = (sh * (Oh - 1) + Kh - 2 * ph, sw * (Ow - 1) + Kw - 2 * pw)
    Nh, Nw = _pair(n_out)
    dy_dil = dilate_insert_zeros(dy, (sh, sw))
    # 180deg-rotated filter, channels swapped to map Cout -> Cin.
    w_rot = torch.flip(w, dims=(0, 1)).transpose(2, 3)
    full = direct_conv(dy_dil, w_rot, 1, (Kh - 1, Kw - 1))
    eh = max(0, ph + Nh - full.shape[1])
    ew = max(0, pw + Nw - full.shape[2])
    if eh or ew:
        full = F.pad(full, (0, 0, 0, ew, 0, eh))
    return full[:, ph:ph + Nh, pw:pw + Nw, :]


def dilated_conv_filter_grad_naive(x: torch.Tensor, dy: torch.Tensor, *,
                                   stride, padding=0, k=None) -> torch.Tensor:
    """Filter gradient via explicit zero-dilation of dy used as the filter
    of a direct convolution over (padded) x: x as Cin images of B
    channels, the dilated dy as a (Dh, Dw, B, Cout) filter, so the
    contraction runs over the batch."""
    if k is None:
        raise ValueError("filter size k=(Kh,Kw) is required")
    Kh, Kw = _pair(k)
    dy_dil = dilate_insert_zeros(dy, stride)             # (B, Dh, Dw, Cout)
    lhs = x.permute(3, 1, 2, 0)                          # Cin,H,W,B
    rhs = dy_dil.permute(1, 2, 0, 3)                     # Dh,Dw,B,Cout
    out = direct_conv(lhs, rhs, 1, padding)              # Cin,Kh',Kw',Cout
    return out.permute(1, 2, 0, 3)[:Kh, :Kw].contiguous()
