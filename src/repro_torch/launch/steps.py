"""Train / prefill / decode steps, abstract inputs and their layouts on a
mesh (port of `repro/launch/steps.py`).

`make_train_step` is the LM's training step: the fp32 master weights cast
to the compute dtype inside the step (`precast`), the loss and its
gradients by autograd, gradient accumulation over `n_micro`
microbatches in `repro`'s order and division, and one AdamW update.  The
step reads nothing back to the host; its metrics stay on the device.

On a mesh (params and optimizer state DTensors or `Sharded`s laid out by
`parallel.sharding.tree_shardings`, the batch laid out by `batch_pspec`)
every rank runs the same step on its blocks.  The step gathers the
batch whole (one all-gather per input over the data axes) and splits
it into `repro`'s microbatches, each rank keeping its block of each;
the precast is applied to the blocks, before any gather (`repro`'s
`_precast` pins the bf16 copy to the param layout); the LM's ops on a
mesh issue their own collectives (`models/lm.py`); gradients come out
in each param's layout and accumulate in fp32 there; the global norm
sums each leaf's blocks over the axes that shard it (`tree_sumsq`: one
all-reduce per set of axes); AdamW updates each block on its rank.

`input_specs`, `abstract_state`, `cache_pspecs` and `batch_shardings`
are `repro`'s, with tensors on the meta device in place of
`ShapeDtypeStruct`s (no allocation).  `lower_cell` (XLA lowering for the
dry-run) is not ported: ROADMAP.md.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.lm import LM
from repro_torch.optim.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.parallel import sharding as sh


# ---------------------------------------------------------------------------
# Abstract inputs (meta tensors; no allocation)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The model inputs of one shape cell, as meta tensors."""
    B, S = shape.global_batch, shape.seq_len
    meta = torch.device("meta")

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=meta)

    if shape.kind == "train":
        inputs = sds((B, S, cfg.d_model), torch.bfloat16) \
            if cfg.embed_input else sds((B, S), torch.int32)
        return {"inputs": inputs, "labels": sds((B, S), torch.int32)}
    if shape.kind == "prefill":
        if cfg.embed_input:
            return {"inputs": sds((B, S, cfg.d_model), torch.bfloat16)}
        return {"inputs": sds((B, S), torch.int32)}
    # decode: one new token against a seq_len-deep cache
    cache = LM(cfg).init_cache(B, S, device="meta")
    return {"tokens": sds((B, 1), torch.int32), "cache": cache}


# ---------------------------------------------------------------------------
# Sharding trees
# ---------------------------------------------------------------------------

def cache_pspecs(cache_shapes, mesh):
    """The cache's layout: batch over the data axes, the SEQUENCE of the
    KV entries over "model" (a decode step then combines per-rank softmax
    statistics instead of gathering the cache); the SSM entries' heads or
    channels over "model".  Non-tensor leaves (the port's int "len") get
    ()."""
    return sh._map_with_path(lambda path, leaf: _cache_spec(path, leaf,
                                                            mesh),
                             cache_shapes)


def _cache_spec(path: str, leaf, mesh) -> tuple:
    la = sh.logical_axes(mesh)
    dp, tp = la["dp"], la["tp"]
    name = path.split("/")[-1]
    shp = tuple(getattr(leaf, "shape", ()))
    r = len(shp)
    if name in ("k", "v"):
        entries = [None] * (r - 4) + [dp, tp, None, None]
    elif name in ("k_scale", "v_scale"):
        entries = [None] * (r - 3) + [dp, tp, None]
    elif name == "conv":
        entries = [None] * (r - 3) + [dp, None, tp]
    elif name == "state":
        entries = [None] * (r - 4) + [dp, tp, None, None]
    elif name.startswith("x_prev"):
        entries = [None] * (r - 3) + [dp, None, None]
    else:
        entries = [None] * r
    return sh._guard(mesh, entries, shp)


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """{input name: NamedSharding} (the cache: a tree of them)."""
    out = {}
    for k, v in input_specs(cfg, shape).items():
        if k == "cache":
            out[k] = sh._map_with_path(
                lambda path, leaf: sh.NamedSharding(
                    mesh, _cache_spec(path, leaf, mesh)), v)
        else:
            out[k] = sh.NamedSharding(
                mesh, sh.batch_pspec(mesh, v.dim(), 0, v.shape[0]))
    return out


def abstract_state(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None):
    """(params, opt_state) as meta tensors -- no allocation."""
    with torch.device("meta"):
        params = LM(cfg).init_tree(torch.Generator())
        opt = None if opt_cfg is None else adamw_init(params, opt_cfg)
    return params, opt


def effective_microbatches(cfg: ModelConfig, global_batch: int,
                           mesh=None) -> int:
    """`cfg.microbatch`, lowered until each microbatch divides the batch
    and its share of the data axes (otherwise activations fall back to
    replicated)."""
    n = max(1, cfg.microbatch)
    dp = 1
    if mesh is not None:
        dp = sh._axis_size(mesh, sh.logical_axes(mesh)["dp"])
    while n > 1 and (global_batch % n or (global_batch // n) % dp):
        n -= 1
    return n


# ---------------------------------------------------------------------------
# Step factories
# ---------------------------------------------------------------------------

def precast(params, dtype: torch.dtype):
    """Every fp32 leaf with ndim >= 2 cast to `dtype` (`repro`'s
    `_precast`: the stacked blocks' norm scales are (L, d) and cast too),
    the rest as it is; a `Sharded` leaf's block is cast where it lies.
    The casts are in the autograd graph, so the gradients reach the fp32
    leaves in fp32."""
    def cast(a):
        t = a.local if isinstance(a, sh.Sharded) else a
        if t.dim() < 2 or t.dtype != torch.float32:
            return a
        if isinstance(a, sh.Sharded):
            return sh.Sharded(t.to(dtype), a.mesh, a.spec)
        return t.to(dtype)
    return tree_map(cast, params)


def loss_and_grads(lm: LM, params, inputs, labels):
    """((loss, {"nll", "aux"}), grads): `jax.value_and_grad(has_aux=True)`
    of `lm.loss` on the precast params, with respect to every leaf of
    `params`; nothing of the caller's params is mutated.  A leaf the loss
    does not read (the token table of an `embed_input` config, used only
    by decode) gets zeros, as jax gives it.  A `Sharded` leaf's gradient
    is its block's."""
    blocks = [p.local if isinstance(p, sh.Sharded) else p
              for p in tree_leaves(params)]
    leaves = [p.detach().requires_grad_() for p in blocks]
    it = iter(leaves)

    def live_leaf(p):
        t = next(it)
        return sh.Sharded(t, p.mesh, p.spec) if isinstance(p, sh.Sharded) \
            else t

    live = tree_map(live_leaf, params)
    loss, aux = lm.loss(precast(live, lm.cfg.compute_dtype), inputs, labels)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    it = iter(grads)
    aux = {k: torch.as_tensor(v, dtype=torch.float32,
                              device=loss.device).detach()
           for k, v in aux.items()}
    return (loss.detach(), aux), tree_map(lambda _: next(it), params)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    n_micro: int = 1):
    """`train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`, batch {"inputs", "labels"} as tensors on the params'
    device.  With `n_micro` > 1 the batch splits into that many
    microbatches along its first axis; their fp32 gradients and losses
    are summed in order and divided by `n_micro`, as `repro`'s scan
    does.  The inputs are not modified.  On a mesh (DTensor or `Sharded`
    params) the step runs on each rank's blocks and returns containers
    of the params' and state's kinds and layouts."""
    lm = LM(cfg)

    def grads_of(params, inputs, labels):
        if n_micro == 1:
            return loss_and_grads(lm, params, inputs, labels)

        def split(t):
            return t.reshape(n_micro, t.shape[0] // n_micro, *t.shape[1:])
        inputs, labels = split(inputs), split(labels)
        grads = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                               device=g.device),
                         tree_map(lambda p: p.local if isinstance(
                             p, sh.Sharded) else p, params))
        loss = None
        for i in range(n_micro):
            (l_i, _), g_i = loss_and_grads(lm, params, inputs[i], labels[i])
            grads = tree_map(lambda a, g: a + g.to(a.dtype), grads, g_i)
            loss = l_i if loss is None else loss + l_i
        grads = tree_map(lambda g: g / n_micro, grads)
        loss = loss / n_micro
        return (loss, {"nll": loss, "aux": torch.zeros_like(loss)}), grads

    def train_step(params, opt_state, batch):
        mesh = sh.tree_mesh(params)
        if mesh is None:
            (loss, aux), grads = grads_of(params, batch["inputs"],
                                          batch["labels"])
            params, opt_state, om = adamw_update(grads, opt_state, params,
                                                 opt_cfg)
            return params, opt_state, {"loss": loss, **aux, **om}
        P = tree_map(lambda t: sh.as_sharded(t, mesh), params)
        O = tree_map(lambda t: sh.as_sharded(t, mesh), opt_state)
        (loss, aux), grads = grads_of(P, sh.full_tensor(batch["inputs"]),
                                      sh.full_tensor(batch["labels"]))
        norm = torch.sqrt(sh.tree_sumsq(
            [sh.Sharded(g, p.mesh, p.spec)
             for g, p in zip(tree_leaves(grads), tree_leaves(P))]))

        def blocks(tree):
            return tree_map(lambda s: s.local, tree)

        new_p, new_o, om = adamw_update(grads, blocks(O), blocks(P),
                                        opt_cfg, norm=norm)
        return (tree_map(sh.rewrap, params, new_p),
                tree_map(sh.rewrap, opt_state, new_o),
                {"loss": loss, **aux, **om})

    return train_step


def make_prefill_step(cfg: ModelConfig, max_len: int):
    lm = LM(cfg)

    def prefill_step(params, inputs):
        return lm.prefill(params, inputs, max_len)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    lm = LM(cfg)

    def serve_step(params, cache, tokens):
        return lm.decode_step(params, cache, tokens)

    return serve_step
