"""Atrous segmentation head (ASPP-lite), the serving half of
`repro/models/vision.py`: parallel 3x3 convs at rates {1, 2, 4} with
same-padding, fused by a 1x1 conv into per-pixel class logits.  Every
branch routes through `ecoflow_dilated_conv` with its relu in the
epilogue slot, so the D-dilated filter is never materialized.  Patchify
comes with a later slice.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.conv import ecoflow_conv, ecoflow_dilated_conv
from repro_torch.core.spec import ConvSpec, Epilogue
from repro_torch.device import resolve_device

_RELU = Epilogue(activation="relu")


def atrous_head_init(generator: torch.Generator, *, in_ch=3, width=16,
                     n_classes=4, rates=(1, 2, 4), device=None) -> dict:
    """ASPP-lite params, `repro`'s shapes and scales: one 3x3 branch per
    atrous rate + a 1x1 fuse conv, normal draws on the CPU from
    `generator`."""
    dev = resolve_device(device)
    params = {}
    scale = 1.0 / math.sqrt(9 * in_ch)
    for r in rates:
        params[f"rate{r}"] = scale * torch.randn(
            (3, 3, in_ch, width), generator=generator)
    fuse_in = width * len(rates)
    params["fuse"] = (1.0 / math.sqrt(fuse_in)) * torch.randn(
        (1, 1, fuse_in, n_classes), generator=generator)
    return {k: v.to(dev) for k, v in params.items()}


def atrous_head_apply(params: dict, images: torch.Tensor, *,
                      rates=(1, 2, 4), backend=None) -> torch.Tensor:
    """images (B,H,W,C) -> per-pixel class logits (B,H,W,n_classes).
    Each 3x3 branch runs at stride 1 with padding == rate, so all
    branches stay at full resolution and concatenate channel-wise before
    the 1x1 fuse."""
    feats = [ecoflow_dilated_conv(images, params[f"rate{r}"], 1, r, r,
                                  backend, epilogue=_RELU)
             for r in rates]
    h = torch.cat(feats, dim=-1)
    return ecoflow_conv(h, params["fuse"], 1, 0, backend)


def atrous_plan_requests(params: dict, image_shape, *,
                         rates=(1, 2, 4)) -> list:
    """One `("forward", spec, x_shape, y_shape, epilogue)` entry per
    dilated 3x3 branch plus the 1x1 fuse conv, for one serving bucket of
    padded batch shape `image_shape` (B, H, W, C)."""
    b, h, w, c = (int(s) for s in image_shape)
    entries = []
    for r in rates:
        wt = params[f"rate{r}"]
        spec = ConvSpec.make(stride=1, padding=r,
                             filter_shape=tuple(wt.shape[:2]), dilation=r)
        entries.append(("forward", spec, (b, h, w, c),
                        (b, h, w, int(wt.shape[3])), _RELU))
    fuse = params["fuse"]
    spec = ConvSpec.make(stride=1, padding=0, filter_shape=1)
    entries.append(("forward", spec, (b, h, w, int(fuse.shape[2])),
                    (b, h, w, int(fuse.shape[3])), None))
    return entries
