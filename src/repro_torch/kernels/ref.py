"""Oracles for the kernels (port of `repro/kernels/ref.py`): each is the
mathematical specification of one kernel, written with the dense
zero-free or `F.conv2d` ops, or a dense softmax for attention."""
from __future__ import annotations

import torch

from repro_torch.core import ecoflow


def tconv_phase_ref(dy, w, *, stride, padding, n_out, dilation=(1, 1)):
    """Oracle for the (phase, tap) and implicit-GEMM transposed-conv
    kernels (any stride x dilation pair)."""
    return ecoflow.transposed_conv_zero_free(
        dy, w, stride=stride, padding=padding, n_out=tuple(n_out),
        dilation=tuple(dilation))


def dconv_filter_grad_ref(x, dy, *, stride, padding, k, dilation=(1, 1)):
    """Oracle for the zero-free filter-gradient kernel: one strided slice
    of x contracted with dy per tap."""
    return ecoflow.dilated_conv_filter_grad_zero_free(
        x, dy, stride=stride, padding=padding, k=tuple(k),
        dilation=tuple(dilation))


def dconv_forward_ref(x, w, *, stride, padding, dilation):
    """Oracle for the dilated-forward kernel: `F.conv2d`'s own dilated
    conv."""
    return ecoflow.direct_conv(x, w, stride, padding, dilation=dilation)


def flash_attention_ref(q, k, v, *, causal=True, scale=None):
    """Oracle for the flash-attention kernel: (B,S,H,D) GQA attention with
    the causal mask bottom-right aligned (query i sees keys up to
    i + Sk - Sq), as one dense softmax."""
    _, Sq, Hq, D = q.shape
    _, Sk, Hk, _ = k.shape
    rep = Hq // Hk
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = scale if scale is not None else D ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        ki = torch.arange(Sk, device=q.device)[None, :]
        logits = torch.where(ki <= qi, logits, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)
