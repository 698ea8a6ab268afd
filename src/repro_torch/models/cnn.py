"""CNN for the paper's training evaluation domain (port of
`repro/models/cnn.py`).

Every convolution routes through `ecoflow_conv`, so the backward pass
runs the paper's zero-free transposed (input-grad) and dilated
(filter-grad) dataflows -- on the `cuda` backend, one fused kernel launch
per layer.  The steps are functional, as in `repro`: params in, new
params and loss out.

Mesh-aware, as `repro`'s: under `parallel.sharding.use_mesh` the params
may be DTensors laid out by `tree_pspecs` and the batch one laid out by
`batch_pspec`; each conv then runs per shard (`core.spec.
sharded_backend`), and the pool, the head and the loss run on the
global batch on every rank (`sharding.unshard`), as GSPMD's replicated
ops do.  Outside a mesh every sharding call is the identity.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.conv import ecoflow_conv
from repro_torch.core.spec import Epilogue
from repro_torch.device import resolve_device
from repro_torch.models.layers import (sgd_grads, sgd_update,
                                       tree_all_finite, trunc_normal)
from repro_torch.parallel.sharding import shard, unshard

_RELU = Epilogue(activation="relu")


def simple_cnn_init(generator: torch.Generator, *, in_ch=3,
                    widths=(32, 64, 128), n_classes=10, k=3,
                    device=None) -> dict:
    """AllConvNet-style CNN (stride-2 convs instead of pooling), `repro`'s
    shapes and scales, drawn on the CPU from `generator`."""
    dev = resolve_device(device)
    params = {"convs": []}
    c = in_ch
    for w in widths:
        params["convs"].append(
            trunc_normal(generator, (k, k, c, w), 1.0 / math.sqrt(k * k * c)))
        c = w
    params["head"] = trunc_normal(generator, (c, n_classes),
                                  1.0 / math.sqrt(c))
    return {"convs": [w.to(dev) for w in params["convs"]],
            "head": params["head"].to(dev)}


def simple_cnn_apply(params: dict, x: torch.Tensor, *, stride=2,
                     backend=None, fuse_epilogue=True) -> torch.Tensor:
    """x (B,H,W,Cin) -> logits (B,n_classes).  `fuse_epilogue` puts each
    layer's relu in the conv's epilogue slot (one fused launch per layer,
    forward and backward); False keeps a separate relu."""
    for w in params["convs"]:
        if fuse_epilogue:
            x = ecoflow_conv(x, w, stride, 1, backend, epilogue=_RELU)
        else:
            x = torch.relu(ecoflow_conv(x, w, stride, 1, backend))
    return torch.matmul(unshard(x).mean(dim=(1, 2)), unshard(params["head"]))


def cnn_loss(params: dict, x: torch.Tensor, labels: torch.Tensor, *,
             stride=2, backend=None, fuse_epilogue=True) -> torch.Tensor:
    logits = simple_cnn_apply(params, x, stride=stride, backend=backend,
                              fuse_epilogue=fuse_epilogue)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, unshard(labels).long()[:, None])[:, 0]
    return (logz - gold).mean()


def sgd_step(params: dict, x: torch.Tensor, labels: torch.Tensor, *,
             lr=0.05, stride=2, backend=None, fuse_epilogue=True):
    """One SGD step: (new_params, loss).  Under a mesh the batch is laid
    out over the data axes first, as `repro`'s step does."""
    x = shard(x, "dp", None, None, None)
    loss, grads = sgd_grads(
        lambda p: cnn_loss(p, x, labels, stride=stride, backend=backend,
                           fuse_epilogue=fuse_epilogue), params)
    return sgd_update(params, grads, lr), loss


def guarded_sgd_step(params: dict, x: torch.Tensor, labels: torch.Tensor,
                     *, lr=0.05, stride=2, backend=None,
                     fuse_epilogue=True):
    """`sgd_step` + the numerics guard: (new_params, loss, all_finite),
    `all_finite` a 0-d bool tensor over the UPDATED params and the loss,
    left on the device (no host read).  The guard adds no kernel launch
    of ours."""
    new, loss = sgd_step(params, x, labels, lr=lr, stride=stride,
                         backend=backend, fuse_epilogue=fuse_epilogue)
    return new, loss, tree_all_finite(new, loss)
