"""Mixture-of-Experts layer with capacity-based top-k dispatch (port of
`repro/models/moe.py`).

Each batch row is a dispatch group (n = S tokens), each expert has
C = `capacity(cfg, S)` slots per group, and a token's k-th choice takes
the next free slot of its expert in (token, k) order; a choice past the
capacity is dropped (the token passes through the residual).  Optional
shared experts run densely on every token.

`repro` dispatches and combines with one-hot (B, S, E, C) einsums.  Here
the same slots are gathered and scattered by index:
  * `route`: the router's softmax, the top-k (a stable descending sort,
    so a tie puts the lower expert first, as `jax.lax.top_k` does) and
    the renormalized gate values;
  * `aux_loss`: the Switch load-balancing loss (the assignment counts
    carry no gradient, the mean probabilities do);
  * `dispatch_combine`: each (token, k) choice's slot from the running
    count over the (S, K)-flattened choices, the expert products over
    the (E, B * C) slot rows, and the combine weighted in fp32.
Each index op's backward gathers, or scatters to rows that no two kept
choices share, so gradients are the same from run to run on the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import trunc_normal


def moe_init(generator: torch.Generator, cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.moe_dff, cfg.n_experts
    s_in, s_out = 1 / math.sqrt(d), 1 / math.sqrt(f)
    p = {
        "router": trunc_normal(generator, (d, e), s_in),
        "experts_wi": trunc_normal(generator, (e, d, f), s_in),
        "experts_wg": trunc_normal(generator, (e, d, f), s_in),
        "experts_wo": trunc_normal(generator, (e, f, d), s_out),
    }
    if cfg.n_shared_experts:
        fs = cfg.moe_dff * cfg.n_shared_experts
        p["shared_wi"] = trunc_normal(generator, (d, fs), s_in)
        p["shared_wg"] = trunc_normal(generator, (d, fs), s_in)
        p["shared_wo"] = trunc_normal(generator, (fs, d), s_out)
    return p


def capacity(cfg: ModelConfig, seq: int) -> int:
    c = int(math.ceil(seq * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(4, -(-c // 4) * 4)  # pad to a multiple of 4 lanes


def route(params, x, cfg: ModelConfig):
    """x (B,S,D) -> (probs (B,S,E) fp32, gate values (B,S,K) fp32
    renormalized over k, expert indices (B,S,K) int64).  Ties go to the
    lower expert index."""
    logits = (x @ params["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[..., :cfg.top_k]
    vals = torch.gather(probs, -1, idx)
    vals = vals / torch.clamp_min(vals.sum(-1, keepdim=True), 1e-9)
    return probs, vals, idx


def aux_loss(probs, idx, cfg: ModelConfig):
    """E * sum(mean prob * mean assignment) (Switch); the assignment
    counts carry no gradient."""
    E, K = cfg.n_experts, cfg.top_k
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(idx, E).sum(2).float().mean(dim=(0, 1)) / K
    return E * (me * ce).sum()


def slots(idx, cfg: ModelConfig, C: int):
    """Each (token, k) choice's row in the (B, E * C + 1, .) slot buffer:
    expert * C + its position among the choices of that expert in
    (S, K)-flattened order, or E * C (the dump row) past the capacity."""
    B, S, K = idx.shape
    E = cfg.n_experts
    onehot = F.one_hot(idx, E).reshape(B, S * K, E)
    pos = torch.cumsum(onehot, dim=1) - onehot
    pos = torch.gather(pos, -1, idx.reshape(B, S * K, 1)).reshape(B, S, K)
    return torch.where(pos < C, idx * C + pos, E * C)


def dispatch_combine(params, x, vals, idx, cfg: ModelConfig):
    """The routed experts' output (B,S,D) in x's dtype, from the gate
    values and indices of `route`: each kept choice's token copied to its
    slot, the gated expert MLP on every slot of every expert, and each
    token's kept slots summed in fp32, weighted by their gate values."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S)
    dt = x.dtype
    slot = slots(idx, cfg, C)
    rows = torch.arange(B, device=x.device)[:, None, None].expand(B, S, K)
    # A slot is taken by one choice at most; the dropped ones all write the
    # dump row, which is cut off.
    xe = x.new_zeros((B, E * C + 1, D)).index_put(
        (rows, slot), x[:, :, None].expand(B, S, K, D))
    xe = xe[:, :E * C].reshape(B, E, C, D).transpose(0, 1).reshape(
        E, B * C, D)
    h = F.silu(torch.bmm(xe, params["experts_wg"].to(dt)))
    h = h * torch.bmm(xe, params["experts_wi"].to(dt))
    ye = torch.bmm(h, params["experts_wo"].to(dt))             # (E, B*C, D)
    ye = ye.reshape(E, B, C, D).transpose(0, 1).reshape(B, E * C, D)
    ye = F.pad(ye.float(), (0, 0, 0, 1))                      # + dump row
    w = vals * (slot < E * C).float()                          # 0 if dropped
    return (w[..., None] * ye[rows, slot]).sum(2).to(dt)


def moe_block(params, x, cfg: ModelConfig):
    """x (B,S,D) -> (out (B,S,D), aux loss)."""
    probs, vals, idx = route(params, x, cfg)
    out = dispatch_combine(params, x, vals, idx, cfg)
    if cfg.n_shared_experts:
        dt = x.dtype
        hs = F.silu(x @ params["shared_wg"].to(dt)) * \
            (x @ params["shared_wi"].to(dt))
        out = out + hs @ params["shared_wo"].to(dt)
    return out, aux_loss(probs, idx, cfg)
