"""EcoFlow zero-free dataflows for transposed and dilated convolutions, in
dense PyTorch ops (port of `repro/core/ecoflow.py`).

  Transposed conv (stride S):
      dx[S*x+p, S*y+q] = sum_{a,b} dy[x-a, y-b] * W[a*S+p, b*S+q]
  -- S*S dense stride-1 correlations of the un-padded error with
  180deg-rotated sub-filters, interleaved by output residue.

  Dilated FORWARD conv (atrous rate D):
      y[i,j] = sum_{a,b} x[i*S + a*D - P, j*S + b*D - P] * W[a,b]
  -- one stride-strided gather of x per useful filter tap, contracted
  with the undilated tap as a (B*O*O x Cin) @ (Cin x Cout) matmul.

  Dilated conv (filter-gradient form):
      dW[kx,ky] = sum_{b,i,j} x[b, i*S+kx*D-P, j*S+ky*D-P] * dy[b,i,j]

Layouts: NHWC activations, HWIO filters (forward filter maps Cin->Cout).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.spec import ConvSpec, _pair


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """Accumulation type: fp32, or the input's own type when wider (fp64
    for gradcheck)."""
    return torch.promote_types(t.dtype, torch.float32)


def direct_conv(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0, *,
                dilation=1) -> torch.Tensor:
    """Plain direct (forward) convolution, NHWC x HWIO -> NHWC, through
    `F.conv2d` -- the ground truth the zero-free dataflows are held
    against.  `dilation` is the forward filter dilation."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=_pair(stride), padding=_pair(padding),
                 dilation=_pair(dilation))
    return y.permute(0, 2, 3, 1).contiguous()


# ---------------------------------------------------------------------------
# Zero-free transposed convolution (input gradients / GAN generator layers)
# ---------------------------------------------------------------------------

def phase_subfilters(w: torch.Tensor, stride) -> list[list[torch.Tensor]]:
    """Split filter (K,K,Cin,Cout) into S*S rotated sub-filters.

    Sub-filter (p,q) has entries W[a*S+p, b*S+q], spatially flipped so
    each phase becomes a stride-1 correlation of dy, with channels
    transposed to map Cout->Cin: (Kp, Kq, Cout, Cin)."""
    sh, sw = _pair(stride)
    out = []
    for p in range(sh):
        row = []
        for q in range(sw):
            sub = w[p::sh, q::sw]                       # (Kp, Kq, Cin, Cout)
            sub = torch.flip(sub, dims=(0, 1))          # rotate 180deg
            row.append(sub.transpose(2, 3))             # (Kp, Kq, Cout, Cin)
        out.append(row)
    return out


def transposed_conv_zero_free(dy: torch.Tensor, w: torch.Tensor, *, stride,
                              padding=0, n_out=None,
                              dilation=1) -> torch.Tensor:
    """Zero-free transposed convolution (EcoFlow dataflow, dense form).

    The gradient w.r.t. the input of `direct_conv(x, w, stride, padding,
    dilation)`: dy (B, Oh, Ow, Cout), w (Kh, Kw, Cin, Cout) -> dx (B, Nh,
    Nw, Cin) with (Nh, Nw) = n_out (default exact fit S*(O-1)+K_eff-2P).
    At D == 1 the stride-phase decomposition runs; at D > 1 the adjoint is
    per-tap strided scatter-adds (`_dilated_transposed_zero_free`)."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    B, Oh, Ow, Cout = dy.shape
    Kh, Kw, Cin, _ = w.shape
    if n_out is None:
        spec = ConvSpec.make(stride=(sh, sw), padding=(ph, pw),
                             filter_shape=(Kh, Kw), dilation=(dh, dw))
        n_out = spec.input_size((Oh, Ow))
    if (dh, dw) != (1, 1):
        return _dilated_transposed_zero_free(
            dy, w, stride=(sh, sw), padding=(ph, pw), dilation=(dh, dw),
            n_out=tuple(n_out))
    Nh, Nw = n_out
    Fh, Fw = sh * (Oh - 1) + Kh, sw * (Ow - 1) + Kw
    dy_nchw = dy.permute(0, 3, 1, 2)
    subs = phase_subfilters(w, (sh, sw))
    dx_full = dy.new_zeros((B, Fh, Fw, Cin))
    for p in range(sh):
        for q in range(sw):
            sub = subs[p][q]
            kp, kq = sub.shape[0], sub.shape[1]
            if kp == 0 or kq == 0:
                continue
            # Stride-1 "full" correlation of dy with the rotated sub-filter.
            part = F.conv2d(dy_nchw, sub.permute(3, 2, 0, 1),
                            padding=(kp - 1, kq - 1)).permute(0, 2, 3, 1)
            xp = -(-(Fh - p) // sh)   # rows congruent to p (mod S)
            xq = -(-(Fw - q) // sw)
            dx_full[:, p::sh, q::sw, :] = part[:, :xp, :xq, :]
    # Non-exact-fit inputs (forward ignored tail rows/cols): zero tail.
    eh = max(0, ph + Nh - Fh)
    ew = max(0, pw + Nw - Fw)
    if eh or ew:
        dx_full = F.pad(dx_full, (0, 0, 0, ew, 0, eh))
    return dx_full[:, ph:ph + Nh, pw:pw + Nw, :].contiguous()


# ---------------------------------------------------------------------------
# Zero-free dilated FORWARD convolution (atrous workloads) and its adjoint
# ---------------------------------------------------------------------------

def _tap_slice(xp: torch.Tensor, kx: int, ky: int, *, stride, dilation,
               out_size) -> torch.Tensor:
    """Per-tap strided gather x[b, i*S + kx*D, j*S + ky*D, c] for i < Oh,
    j < Ow out of a padded NHWC input."""
    sh, sw = stride
    dh, dw = dilation
    oh, ow = out_size
    return xp[:, kx * dh:kx * dh + (oh - 1) * sh + 1:sh,
              ky * dw:ky * dw + (ow - 1) * sw + 1:sw, :]


def dilated_forward_zero_free(x: torch.Tensor, w: torch.Tensor, *, stride=1,
                              padding=0, dilation=2) -> torch.Tensor:
    """Zero-free dilated (atrous) forward convolution: each of the K^2
    useful taps gathers one stride-strided slice of the once-padded input
    and contracts it with the undilated filter tap; the dilated filter is
    never materialized.  x (B, Nh, Nw, Cin), w (Kh, Kw, Cin, Cout) ->
    (B, Oh, Ow, Cout)."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    B, Nh, Nw, Cin = x.shape
    Kh, Kw, _, Cout = w.shape
    spec = ConvSpec.make(stride=(sh, sw), padding=(ph, pw),
                         filter_shape=(Kh, Kw), dilation=(dh, dw))
    Oh, Ow = spec.out_size((Nh, Nw))
    if Oh < 1 or Ow < 1:
        raise ValueError(
            f"input {(Nh, Nw)} too small for effective filter "
            f"{spec.dilated_filter_shape} at padding {(ph, pw)}")
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    acc_t = _acc_dtype(x)
    acc = x.new_zeros((B, Oh, Ow, Cout), dtype=acc_t)
    w32 = w.to(acc_t)
    for kx in range(Kh):
        for ky in range(Kw):
            xs = _tap_slice(xp, kx, ky, stride=(sh, sw),
                            dilation=(dh, dw), out_size=(Oh, Ow))
            acc = acc + torch.matmul(xs.to(acc_t), w32[kx, ky])
    return acc.to(x.dtype)


def _dilated_transposed_zero_free(dy: torch.Tensor, w: torch.Tensor, *,
                                  stride, padding, dilation,
                                  n_out) -> torch.Tensor:
    """Input gradient of the dilated forward conv: per-tap strided
    scatter-add dx[b, o*S + k*D - P] += dy[b, o] @ W[k]^T."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    B, Oh, Ow, Cout = dy.shape
    Kh, Kw, Cin, _ = w.shape
    Nh, Nw = n_out
    Fh = sh * (Oh - 1) + dh * (Kh - 1) + 1   # full (pre-slice) extent
    Fw = sw * (Ow - 1) + dw * (Kw - 1) + 1
    acc_t = _acc_dtype(dy)
    dy32 = dy.to(acc_t)
    w32 = w.to(acc_t)
    dx_full = dy.new_zeros((B, Fh, Fw, Cin), dtype=acc_t)
    for kx in range(Kh):
        for ky in range(Kw):
            contrib = torch.matmul(dy32, w32[kx, ky].T)
            dx_full[:, kx * dh:kx * dh + (Oh - 1) * sh + 1:sh,
                    ky * dw:ky * dw + (Ow - 1) * sw + 1:sw, :] += contrib
    eh = max(0, ph + Nh - Fh)
    ew = max(0, pw + Nw - Fw)
    if eh or ew:
        dx_full = F.pad(dx_full, (0, 0, 0, ew, 0, eh))
    return dx_full[:, ph:ph + Nh, pw:pw + Nw, :].to(dy.dtype).contiguous()


# ---------------------------------------------------------------------------
# Zero-free dilated convolution (filter gradients)
# ---------------------------------------------------------------------------

def dilated_conv_filter_grad_zero_free(x: torch.Tensor, dy: torch.Tensor, *,
                                       stride, padding=0, k=None,
                                       dilation=1) -> torch.Tensor:
    """Zero-free dilated convolution computing dW: per filter tap a
    strided slice of x is contracted with dy; the stride-dilated error is
    never materialized.  Returns (Kh, Kw, Cin, Cout)."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    Cin = x.shape[3]
    _, Oh, Ow, Cout = dy.shape
    if k is None:
        raise ValueError("filter size k=(Kh,Kw) is required")
    Kh, Kw = _pair(k)
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    acc_t = _acc_dtype(x)
    dy2 = dy.to(acc_t).reshape(-1, Cout)
    taps = []
    for kx in range(Kh):
        for ky in range(Kw):
            xs = _tap_slice(xp, kx, ky, stride=(sh, sw),
                            dilation=(dh, dw), out_size=(Oh, Ow))
            taps.append(xs.to(acc_t).reshape(-1, Cin).T @ dy2)
    return torch.stack(taps).reshape(Kh, Kw, Cin, Cout).to(x.dtype)


def transposed_conv_input_size(out_size: int, k: int, stride: int,
                               padding: int) -> int:
    """Forward-conv input length N given output length O (exact fit):
    `ConvSpec.input_size` for callers that think in scalars."""
    spec = ConvSpec.make(stride=stride, padding=padding, filter_shape=k)
    return spec.input_size((out_size, out_size))[0]


# ---------------------------------------------------------------------------
# Padding bookkeeping (paper Sec. 3.1 closed forms) -- used by the dataflow
# simulator and the quickstart.
# ---------------------------------------------------------------------------

def tconv_inner_padding(n: int, stride: int) -> int:
    """# of internal zeros inserted into an N x N error map at stride S."""
    return (stride * (n - 1) + 1) ** 2 - n ** 2


def tconv_outer_padding(n: int, k: int, stride: int) -> int:
    """# of border zeros for an N x N error map, K x K filter, stride S."""
    return 4 * (k - 1) * (stride * (n - 1) + 1) + 4 * (k - 1) ** 2


def dconv_inner_padding(n: int, stride: int) -> int:
    """# of internal zeros inserted into an N x N error map (dilated conv)."""
    return (stride * (n - 1) + 1) ** 2 - n ** 2


def tconv_zero_mac_fraction(n: int, k: int, stride: int) -> float:
    """Fraction of MACs that touch an inserted zero in the naive transposed
    conv: the zero density of the padded error map, which the K x K
    windows tile uniformly."""
    padded = stride * (n - 1) + 1 + 2 * (k - 1)
    return 1.0 - (n * n) / (padded * padded)


def dconv_zero_mac_fraction(n: int, stride: int) -> float:
    """Fraction of zero MACs in the naive dilated conv (zero-dilated error
    used as the filter)."""
    dil = stride * (n - 1) + 1
    return 1.0 - (n * n) / (dil * dil)


def predicated_mac_fraction(spec: ConvSpec, out_size) -> float:
    """Masked-lane fraction of the implicit-GEMM input-gradient lowering:
    exactly 1 - (Oh * Ow) / (Fh * Fw), tap-independent (every tap meets
    its in-bound predicate at Oh sites per row axis)."""
    oh, ow = out_size
    fh, fw = spec.full_size((oh, ow))
    return 1.0 - (oh * ow) / (fh * fw)
