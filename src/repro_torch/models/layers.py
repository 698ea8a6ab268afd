"""Parameter-tree helpers shared by the conv models (port of
`repro/models/layers.py::tree_all_finite`, with the two tree walks the
functional training steps need in place of `jax.tree_util`).

A tree is nested dicts, lists and tuples with tensors at the leaves,
as the models' params are.
"""
from __future__ import annotations

from typing import Callable

import torch


def tree_leaves(tree) -> list:
    """The leaves in a fixed order: dict keys as stored, then sequences
    in order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the leaves of `tree` (and the matching leaves of each of
    `rest`), keeping keys and structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *vs) for vs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_all_finite(*trees) -> bool:
    """True when every floating leaf of every tree is finite.  Integer
    leaves (labels, counters) are skipped.  One device reduction per
    leaf and one read of the result."""
    flags = [torch.isfinite(leaf).all()
             for tree in trees for leaf in tree_leaves(tree)
             if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()]
    return bool(torch.stack(flags).all()) if flags else True


def trunc_normal(generator: torch.Generator, shape, scale: float):
    """`scale` * truncated standard normal on [-2, 2], drawn on the CPU
    from `generator`."""
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return scale * t


def sgd_grads(loss_fn: Callable, params):
    """(loss, grads) of `loss_fn(params)` with respect to every leaf of
    `params`, as `jax.value_and_grad` gives them: the step's leaves are
    fresh tensors that require grad, so nothing of the caller's params is
    mutated and no gradient lands on them."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    loss = loss_fn(tree_map(lambda _: next(it), params))
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def sgd_update(params, grads, lr):
    """p - lr * g over the tree, detached."""
    return tree_map(lambda p, g: (p - lr * g).detach(), params, grads)
