"""Optimizers from scratch (port of `repro/optim/optimizer.py`): AdamW,
global-norm clipping, a cosine schedule with linear warmup, and Lion.

Plain functions on dict (or list) trees of tensors, on the params'
device.  The step counter is a 0-d int32 tensor beside the moments, and
the schedule's lr is computed from it as a 0-d fp32 tensor on the same
device, so an update reads nothing back to the host and can be captured
in a CUDA graph.  `moment_dtype="bfloat16"` stores the moments in bf16;
every update computes in fp32.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.layers import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    moment_dtype: str = "float32"
    # bf16 working params, the fp32 master copy in the optimizer state.
    bf16_params: bool = False


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def cosine_schedule(cfg, step) -> torch.Tensor:
    """lr at `step` (an int or integer tensor): linear warmup over
    `warmup_steps`, then a half cosine to 0 at `total_steps`."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * t))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm, norm=None):
    """(grads scaled so their global norm is at most `max_norm`, the
    norm before scaling).  `norm` gives the global norm when the tree
    holds blocks of larger tensors (on a mesh: `parallel.sharding.
    tree_sumsq` over every rank's blocks)."""
    gn = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), gn


def _count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _part(params, out, i: int):
    """Element i of the tuple `out` holds at each of `params`' leaves."""
    return tree_map(lambda _, t: t[i], params, out)


def adamw_init(params, cfg: AdamWConfig) -> dict:
    mdt = _dtype(cfg.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    state = {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
             "count": _count(params)}
    if cfg.bf16_params:
        # fp32 master lives in the optimizer state; `params` are bf16.
        state["master"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
    return state


def cast_params_for_storage(params, cfg: AdamWConfig):
    """bf16 storage copy of fp32 init params (matrices only)."""
    if not cfg.bf16_params:
        return params
    return tree_map(lambda p: p.to(torch.bfloat16)
                    if p.dim() >= 2 and p.dtype == torch.float32 else p,
                    params)


def adamw_update(grads, opt_state: dict, params, cfg: AdamWConfig, *,
                 norm=None):
    """(new_params, new_opt_state, {"grad_norm", "lr"}).  Decoupled weight
    decay on matrices (dim >= 2) only.  With `bf16_params` the update
    reads and writes the fp32 master in opt_state["master"] (taken from
    the bf16 params at the first step) and emits bf16 working params.
    Every leaf is updated on its own, so the trees may hold one rank's
    blocks (a block has its tensor's rank); `norm` is then the
    gradients' global norm (`clip_by_global_norm`)."""
    grads, gn = clip_by_global_norm(grads, cfg.clip_norm, norm)
    count = opt_state["count"] + 1
    lr = cosine_schedule(cfg, count)
    b1, b2 = cfg.b1, cfg.b2
    c = count.to(torch.float32)
    bc1 = 1.0 - b1 ** c
    bc2 = 1.0 - b2 ** c
    mdt = _dtype(cfg.moment_dtype)

    if cfg.bf16_params:
        first = opt_state["count"] == 0
        base = tree_map(lambda mst, p: torch.where(
            first, p.to(torch.float32), mst), opt_state["master"], params)
    else:
        base = params

    def upd(p, g, m, v):
        g32 = g.to(torch.float32)
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g32
        v32 = b2 * v.to(torch.float32) + (1 - b2) * torch.square(g32)
        step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if p.dim() >= 2:
            step = step + cfg.weight_decay * p.to(torch.float32)
        return p.to(torch.float32) - lr * step, m32.to(mdt), v32.to(mdt)

    out = tree_map(upd, base, grads, opt_state["m"], opt_state["v"])
    master, new_m, new_v = (_part(params, out, i) for i in range(3))
    new_params = tree_map(lambda nm, p: nm.to(p.dtype), master, params)
    new_state = {"m": new_m, "v": new_v, "count": count}
    if cfg.bf16_params:
        new_state["master"] = master
    return new_params, new_state, {"grad_norm": gn, "lr": lr}


# ---------------------------------------------------------------------------
# Lion: one moment, sign updates.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LionConfig:
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.99
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    moment_dtype: str = "float32"


def lion_init(params, cfg: LionConfig) -> dict:
    mdt = _dtype(cfg.moment_dtype)
    return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt,
                                                device=p.device), params),
            "count": _count(params)}


def lion_update(grads, opt_state: dict, params, cfg: LionConfig):
    """(new_params, new_opt_state, {"grad_norm", "lr"})."""
    grads, gn = clip_by_global_norm(grads, cfg.clip_norm)
    count = opt_state["count"] + 1
    lr = cosine_schedule(cfg, count)
    b1, b2 = cfg.b1, cfg.b2
    mdt = _dtype(cfg.moment_dtype)

    def upd(p, g, m):
        g32 = g.to(torch.float32)
        m32 = m.to(torch.float32)
        update = torch.sign(b1 * m32 + (1 - b1) * g32)
        if p.dim() >= 2:
            update = update + cfg.weight_decay * p.to(torch.float32)
        newp = p.to(torch.float32) - lr * update
        return newp.to(p.dtype), (b2 * m32 + (1 - b2) * g32).to(mdt)

    out = tree_map(upd, params, grads, opt_state["m"])
    new_params, new_m = _part(params, out, 0), _part(params, out, 1)
    return new_params, {"m": new_m, "count": count}, \
        {"grad_norm": gn, "lr": lr}
