"""Per-tap gather helpers shared by the dilated-tap plain versions (port of
`repro/kernels/tap_gather.py`).

The CUDA kernels do not use them: there a bounds predicate on each load
takes the place of the host pad and of `pad_to_tap_windows`.  The plain
versions keep the reference's pad-then-gather arithmetic."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def tap_window_extent(o: int, s: int, d: int, k: int) -> int:
    """Padded-input extent needed so the tap window fits for every tap:
    (O-1)*S + D*(K-1) + 1 per axis."""
    return (o - 1) * s + d * (k - 1) + 1


def pad_to_tap_windows(xp: torch.Tensor, *, stride, dilation, k,
                       out_size) -> torch.Tensor:
    """Tail-pad an NHWC padded input so every (kx*D, ky*D) tap window
    fits."""
    sh, sw = stride
    dh, dw = dilation
    kh, kw = k
    oh, ow = out_size
    need_h = tap_window_extent(oh, sh, dh, kh)
    need_w = tap_window_extent(ow, sw, dw, kw)
    if xp.shape[1] < need_h or xp.shape[2] < need_w:
        xp = F.pad(xp, (0, 0, 0, max(0, need_w - xp.shape[2]),
                        0, max(0, need_h - xp.shape[1])))
    return xp


def gather_tap(x_hwc: torch.Tensor, kx: int, ky: int, *, sh: int, sw: int,
               dh: int, dw: int, oh: int, ow: int) -> torch.Tensor:
    """Per-tap multicast group: tap offset (kx*D, ky*D) into a (..., H, W,
    C) block, then stride subsample -- x[..., i*S + kx*D, j*S + ky*D, :]
    for i < oh, j < ow."""
    return x_hwc[..., kx * dh:kx * dh + (oh - 1) * sh + 1:sh,
                 ky * dw:ky * dw + (ow - 1) * sw + 1:sw, :]
