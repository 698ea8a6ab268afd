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

On a mesh (`moe_block(..., plan)`, `repro`'s shard points at
`repro/models/moe.py:84-92`) every rank routes its batch block with the
whole router, as one device does, and runs the gated MLP of its own
experts (E over `plan.ep`, each expert's hidden columns over `plan.eff`)
in `dispatch_combine`'s buffer: a choice routed to another rank's expert
writes the dump row.  Its partial combine, in fp32, is summed over the
expert axes by one all-reduce and rounded once (with the hidden columns
split, each expert's output is first summed over their axes).  The aux loss's two
means are the global batch's (one all-reduce each over the batch axes).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import trunc_normal
from repro_torch.parallel import sharding as sh


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


def aux_loss(probs, idx, cfg: ModelConfig, plan=None):
    """E * sum(mean prob * mean assignment) (Switch); the assignment
    counts carry no gradient.  With a `plan` the means are over the
    global batch: each rank's sums over its block, all-reduced over
    `plan.bp`, then multiplied (the mean of the ranks' aux values would
    be another number)."""
    E, K = cfg.n_experts, cfg.top_k
    counts = F.one_hot(idx, E).sum(2).float()
    if plan is None:
        me = probs.mean(dim=(0, 1))
        ce = counts.mean(dim=(0, 1)) / K
    else:
        n = probs.shape[0] * probs.shape[1] * sh._axis_size(plan.mesh,
                                                            plan.bp or None)
        me = sh.reduce_from(probs.sum(dim=(0, 1)), plan.mesh, plan.bp) / n
        ce = sh.psum(counts.sum(dim=(0, 1)), plan.mesh, plan.bp) / n / K
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


def dispatch_combine(params, x, vals, idx, cfg: ModelConfig, *,
                     mesh: bool = False, first: int = 0, finish=None):
    """The routed experts' output (B,S,D) in x's dtype, from the gate
    values and indices of `route`: each kept choice's token copied to its
    slot, the gated expert MLP on every slot of every expert, and each
    token's kept slots summed in fp32, weighted by their gate values.

    With `mesh` the params hold the experts [first, first + El) (El their
    leading dim): the choices of other experts write the dump row and
    weigh 0, and the fp32 sum over this rank's choices is returned, for
    the caller to sum over the ranks.  `finish`, where each expert's
    hidden columns are a block, takes the experts' partial outputs in
    fp32 to their sums in x's dtype."""
    B, S, D = x.shape
    El, K = params["experts_wi"].shape[0], cfg.top_k
    C = capacity(cfg, S)
    dt = x.dtype
    slot = slots(idx, cfg, C) - first * C
    kept = (slot >= 0) & (slot < El * C)
    slot = torch.where(kept, slot, El * C)
    rows = torch.arange(B, device=x.device)[:, None, None].expand(B, S, K)
    # A slot is taken by one choice at most; the dropped ones all write the
    # dump row, which is cut off.
    xe = x.new_zeros((B, El * C + 1, D)).index_put(
        (rows, slot), x[:, :, None].expand(B, S, K, D))
    xe = xe[:, :El * C].reshape(B, El, C, D).transpose(0, 1).reshape(
        El, B * C, D)
    h = F.silu(torch.bmm(xe, params["experts_wg"].to(dt)))
    h = h * torch.bmm(xe, params["experts_wi"].to(dt))
    if finish is not None:
        ye = finish(torch.bmm(h.float(), params["experts_wo"].float()))
    else:
        ye = torch.bmm(h, params["experts_wo"].to(dt))         # (El, B*C, D)
    ye = ye.reshape(El, B, C, D).transpose(0, 1).reshape(B, El * C, D)
    ye = F.pad(ye.float(), (0, 0, 0, 1))                      # + dump row
    w = vals * kept.float()                                   # 0 if dropped
    out = (w[..., None] * ye[rows, slot]).sum(2)
    return out if mesh else out.to(dt)


def moe_block(params, x, cfg: ModelConfig, plan=None):
    """x (B,S,D) -> (out (B,S,D), aux loss).  With a `plan` (the LM on a
    mesh: params `Sharded`, x this rank's batch block) `_moe_block_mesh`."""
    if plan is not None:
        return _moe_block_mesh(params, x, cfg, plan)
    probs, vals, idx = route(params, x, cfg)
    out = dispatch_combine(params, x, vals, idx, cfg)
    if cfg.n_shared_experts:
        dt = x.dtype
        hs = F.silu(x @ params["shared_wg"].to(dt)) * \
            (x @ params["shared_wi"].to(dt))
        out = out + hs @ params["shared_wo"].to(dt)
    return out, aux_loss(probs, idx, cfg)


def _moe_block_mesh(params, x, cfg: ModelConfig, plan):
    """`moe_block` on a mesh.  The router is whole on every rank (its
    gradient summed over the batch axes), so every rank of the expert
    axes routes its batch block as one device would; x and the gate
    values enter this rank's experts through `copy_to` (their gradients
    there are this rank's part); the experts' weights are fetched to E
    over `ep` and F over `eff` (gathering D, and F where it lies over the
    batch axes).  With F split, each expert's output is summed over
    `eff` in fp32 and rounded once, as one device's bmm rounds it; the
    partial combine in fp32 ends in one all-reduce over `ep`, rounded to
    x's dtype once.  The shared experts run as the dense MLP does, their
    hidden columns over `plan.mlp`."""
    m = plan.mesh
    probs, vals, idx = route({"router": plan.replicated(params["router"])},
                             x, cfg)
    aux = aux_loss(probs, idx, cfg, plan)
    ep, eff = plan.ep or None, plan.eff or None
    w = {"experts_wi": sh.fetch(params["experts_wi"], (ep, None, eff),
                                plan.bp),
         "experts_wg": sh.fetch(params["experts_wg"], (ep, None, eff),
                                plan.bp),
         "experts_wo": sh.fetch(params["experts_wo"], (ep, eff, None),
                                plan.bp)}
    first = sh.block_index(m, plan.ep) * w["experts_wi"].shape[0]
    finish = None
    if sh._real(m, plan.eff):
        def finish(ye):
            return sh.reduce_from(ye, m, plan.eff).to(x.dtype)
    out = dispatch_combine(w, sh.copy_to(x, m, plan.ep + plan.eff),
                           sh.copy_to(vals, m, plan.ep), idx, cfg, mesh=True,
                           first=first, finish=finish)
    out = sh.reduce_from(out, m, plan.ep).to(x.dtype)
    if cfg.n_shared_experts:
        out = out + _shared_mesh(params, x, plan)
    return out, aux


def _shared_mesh(params, x, plan):
    """The shared experts: wi / wg by column and wo by row over
    `plan.mlp` (`models/layers.py::mlp_block`'s scheme, silu-gated)."""
    wg = plan.column(params["shared_wg"], plan.mlp)
    wi = plan.column(params["shared_wi"], plan.mlp)
    x = sh.copy_to(x, plan.mesh, plan.mlp)
    dt = x.dtype
    hs = F.silu(x @ wg.to(dt)) * (x @ wi.to(dt))
    return plan.row_parallel(hs, params["shared_wo"], plan.mlp)
