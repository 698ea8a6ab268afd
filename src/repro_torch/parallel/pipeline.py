"""Pipeline parallelism: a GPipe-schedule microbatch pipeline over a
"stage" mesh axis (port of `repro/parallel/pipeline.py`).

The production meshes for this paper's workloads are (data, model) --
EcoFlow's own technique has no pipeline dimension -- but at >=1000-node
scale a stage axis is how the 94-layer MoE would hide inter-pod latency,
so the substrate ships one, tested on the CPU with a small stage count.

Usage:
    y = gpipe(mesh, "stage", stage_fn, params_stacked, x, n_micro)

Every rank of the axis is one stage and runs the same tick loop on its
own params (SPMD).  `repro`'s `lax.ppermute` to the next stage is an
`all_gather` over the stage axis' group here, of which each rank keeps
the previous stage's block: `gloo`'s point-to-point send / recv do not
take card tensors, and the all-gather keeps every collective one of
`all_gather` / `all_reduce`.  The last stage's outputs reach every rank
by one all-reduce (`repro`'s `psum` of the masked outputs).  So a run
issues n_micro + n_stages - 1 all-gathers and one all-reduce.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.layers import tree_map
from repro_torch.parallel import sharding as sh


def gpipe(mesh, axis: str, stage_fn: Callable, stage_params, x, n_micro: int):
    """Run a GPipe pipeline of size |axis|.

    stage_fn(params_slice, x_micro) -> x_micro, applied in stage order
    with the microbatches flowing between ranks.  `stage_params` leaves
    have a leading stage dim: whole tensors on every rank (this rank
    takes its stage's slice) or DTensors / `Sharded`s split over `axis`
    on that dim.  x: (n_micro, mb, ...) whole on every rank.  Returns y,
    the same shape, whole on every rank."""
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    if x.shape[0] != n_micro:
        raise ValueError(f"x has {x.shape[0]} microbatches, not {n_micro}")
    stage = sh.block_index(mesh, axis)

    def mine(a):
        if sh.is_container(a):
            return sh.local(a, mesh, (axis,) + (None,) * (a.dim() - 1))[0]
        return a[stage]

    params = tree_map(mine, stage_params)
    buf = torch.zeros_like(x[0])
    ys = torch.zeros_like(x)
    for t in range(n_micro + n_stages - 1):
        # Stage 0 injects microbatch t (if any); the others take the
        # block the previous stage handed over at the previous tick.
        cur = x[min(t, n_micro - 1)] if stage == 0 else buf
        out = stage_fn(params, cur)
        # The hand-off to the next stage: the previous stage's block.
        handed = sh.gather(out[None], mesh, axis, 0)
        buf = handed[(stage - 1) % n_stages]
        # The last stage emits microbatch t - (n_stages - 1) at tick t.
        emit = t - (n_stages - 1)
        if stage == n_stages - 1 and 0 <= emit < n_micro:
            ys[emit] = out
    # Every rank gets the last stage's outputs.
    if stage != n_stages - 1:
        ys.zero_()
    return sh.psum(ys, mesh, axis)
