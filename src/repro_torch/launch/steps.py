"""Train / prefill / decode steps (port of `repro/launch/steps.py`, as far
as one device needs it).

`make_train_step` is the LM's training step: the fp32 master weights cast
to the compute dtype inside the step (`precast`), the loss and its
gradients by autograd, gradient accumulation over `n_micro`
microbatches in `repro`'s order and division, and one AdamW update.  The
step reads nothing back to the host; its metrics stay on the device.

Not ported yet (ROADMAP A.12's LM half): `input_specs`, the sharding
trees (`cache_pspecs`, `batch_shardings`), `abstract_state` and
`lower_cell`; with no mesh `effective_microbatches` clamps by the batch
alone.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.lm import LM
from repro_torch.optim.optimizer import AdamWConfig, adamw_update


def effective_microbatches(cfg: ModelConfig, global_batch: int) -> int:
    """`cfg.microbatch`, lowered until each microbatch divides the batch
    (with no mesh: the data axes are ROADMAP A.12's)."""
    n = max(1, cfg.microbatch)
    while n > 1 and global_batch % n:
        n -= 1
    return n


def precast(params, dtype: torch.dtype):
    """Every fp32 leaf with ndim >= 2 cast to `dtype` (`repro`'s
    `_precast`: the stacked blocks' norm scales are (L, d) and cast too),
    the rest as it is.  The casts are in the autograd graph, so the
    gradients reach the fp32 leaves in fp32."""
    return tree_map(lambda a: a.to(dtype)
                    if a.dim() >= 2 and a.dtype == torch.float32 else a,
                    params)


def loss_and_grads(lm: LM, params, inputs, labels):
    """((loss, {"nll", "aux"}), grads): `jax.value_and_grad(has_aux=True)`
    of `lm.loss` on the precast params, with respect to every leaf of
    `params`; nothing of the caller's params is mutated.  A leaf the loss
    does not read (the token table of an `embed_input` config, used only
    by decode) gets zeros, as jax gives it."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
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
    does.  The inputs are not modified."""
    lm = LM(cfg)

    def train_step(params, opt_state, batch):
        if n_micro == 1:
            (loss, aux), grads = loss_and_grads(lm, params, batch["inputs"],
                                                batch["labels"])
        else:
            def split(t):
                return t.reshape(n_micro, t.shape[0] // n_micro,
                                 *t.shape[1:])
            inputs, labels = split(batch["inputs"]), split(batch["labels"])
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for i in range(n_micro):
                (l_i, _), g_i = loss_and_grads(lm, params, inputs[i],
                                               labels[i])
                grads = tree_map(lambda a, g: a + g.to(a.dtype), grads, g_i)
                loss = loss + l_i
            grads = tree_map(lambda g: g / n_micro, grads)
            loss = loss / n_micro
            aux = {"nll": loss, "aux": torch.zeros_like(loss)}
        params, opt_state, om = adamw_update(grads, opt_state, params,
                                             opt_cfg)
        return params, opt_state, {"loss": loss, **aux, **om}

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
