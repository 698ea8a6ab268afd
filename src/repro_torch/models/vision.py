"""Vision modules on the EcoFlow conv dispatch (port of
`repro/models/vision.py`).

* Patchify frontend (InternViT's entry point): a stride-14 conv, K = S =
  14.  In training its backward is the paper's worst case: with the
  naive dataflow about 99.5 % of the input-gradient MACs multiply
  inserted zeros, and `ecoflow_conv` eliminates all of them.

* Atrous segmentation head (ASPP-lite), the dilated workload the paper
  motivates (Sec. 1): parallel 3x3 convs at rates {1, 2, 4} with
  same-padding, fused by a 1x1 conv into per-pixel class logits.  Every
  branch routes through `ecoflow_dilated_conv`, so neither the forward
  nor either gradient ever materializes the D-dilated filter; by default
  each branch's relu rides its conv's epilogue slot.  `atrous_seg_loss`
  is the head's training loss.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.conv import ecoflow_conv, ecoflow_dilated_conv
from repro_torch.core.spec import ConvSpec, Epilogue
from repro_torch.device import resolve_device
from repro_torch.models.layers import trunc_normal

_RELU = Epilogue(activation="relu")


def patchify_init(generator: torch.Generator, *, patch=14, in_ch=3,
                  d_model=1024, device=None) -> dict:
    """Patch-embedding params, `repro`'s shapes and scales: a (patch,
    patch, in_ch, d_model) projection and a (1, 1, d_model) position
    offset, drawn on the CPU from `generator`."""
    dev = resolve_device(device)
    params = {
        "proj": trunc_normal(generator, (patch, patch, in_ch, d_model),
                             1.0 / math.sqrt(patch * patch * in_ch)),
        "pos": 0.02 * torch.randn((1, 1, d_model), generator=generator),
    }
    return {k: v.to(dev) for k, v in params.items()}


def patchify_apply(params: dict, images: torch.Tensor, *, patch=14,
                   backend=None) -> torch.Tensor:
    """images (B,H,W,C) -> patch embeddings (B, H/p * W/p, D)."""
    x = ecoflow_conv(images, params["proj"], patch, 0, backend)
    B, hp, wp, D = x.shape
    return x.reshape(B, hp * wp, D) + params["pos"]


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
                      rates=(1, 2, 4), backend=None,
                      fuse_epilogue=True) -> torch.Tensor:
    """images (B,H,W,C) -> per-pixel class logits (B,H,W,n_classes).
    Each 3x3 branch runs at stride 1 with padding == rate, so all
    branches stay at full resolution and concatenate channel-wise before
    the 1x1 fuse.  `fuse_epilogue` requests each branch's relu through
    the dilated conv's epilogue slot; False runs it as a separate op
    after a plain dilated conv."""
    if fuse_epilogue:
        feats = [ecoflow_dilated_conv(images, params[f"rate{r}"], 1, r, r,
                                      backend, epilogue=_RELU)
                 for r in rates]
    else:
        feats = [torch.relu(ecoflow_dilated_conv(
            images, params[f"rate{r}"], 1, r, r, backend)) for r in rates]
    h = torch.cat(feats, dim=-1)
    return ecoflow_conv(h, params["fuse"], 1, 0, backend)


def atrous_plan_requests(params: dict, image_shape, *, rates=(1, 2, 4),
                         fuse_epilogue=True) -> list:
    """One `("forward", spec, x_shape, y_shape, epilogue)` entry per
    dilated 3x3 branch plus the 1x1 fuse conv, for one serving bucket of
    padded batch shape `image_shape` (B, H, W, C), in the form
    `kernels.tiling.warmup_plans` takes."""
    b, h, w, c = (int(s) for s in image_shape)
    entries = []
    for r in rates:
        wt = params[f"rate{r}"]
        spec = ConvSpec.make(stride=1, padding=r,
                             filter_shape=tuple(wt.shape[:2]), dilation=r)
        entries.append(("forward", spec, (b, h, w, c),
                        (b, h, w, int(wt.shape[3])),
                        _RELU if fuse_epilogue else None))
    fuse = params["fuse"]
    spec = ConvSpec.make(stride=1, padding=0, filter_shape=1)
    entries.append(("forward", spec, (b, h, w, int(fuse.shape[2])),
                    (b, h, w, int(fuse.shape[3])), None))
    return entries


def atrous_seg_loss(params: dict, images: torch.Tensor,
                    labels: torch.Tensor, *, rates=(1, 2, 4), backend=None,
                    fuse_epilogue=True) -> torch.Tensor:
    """Mean per-pixel cross entropy of the atrous head: logsumexp of the
    logits minus the gold logit, over every pixel."""
    logits = atrous_head_apply(params, images, rates=rates, backend=backend,
                               fuse_epilogue=fuse_epilogue)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()
