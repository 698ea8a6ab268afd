"""Device meshes over the ranks of `torch.distributed`'s default group
(port of `repro/launch/mesh.py`).

Single pod: 16 x 16 = 256 ranks, axes ("data", "model").
Multi-pod : 2 x 16 x 16 = 512 ranks, axes ("pod", "data", "model"); the
"pod" axis carries only data parallelism and the gradient all-reduce.

The process group is the caller's: `torch.distributed` must be
initialized (its backend, address, world size and rank all chosen by the
caller), and every rank of the group builds the same mesh, as the
sub-groups of its axes are collective to create.  A mesh of ranks `r`
puts rank r[i] at the i-th position of the row-major layout.  The device
type is `resolve_device`'s: the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device


def _world() -> int:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs torch.distributed initialized by the caller "
            "(init_process_group with its backend, world size and rank)")
    return dist.get_world_size()


def make_mesh(ranks: Sequence[int], shape, axes, *, device=None
              ) -> DeviceMesh:
    """A mesh of `shape` with axis names `axes` over `ranks`."""
    n = math.prod(shape)
    if len(ranks) != n:
        raise ValueError(f"{len(ranks)} ranks do not fill a {shape} mesh")
    return DeviceMesh(resolve_device(device).type,
                      torch.tensor(list(ranks)).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None
                         ) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = _world()
    if world < n:
        raise RuntimeError(f"need {n} ranks, found {world}")
    return make_mesh(range(n), shape, axes, device=device)


def make_debug_mesh(shape=(1, 1), axes=("data", "model"), *,
                    device: Optional[str] = None) -> DeviceMesh:
    """A small mesh over the first ranks of the group (tests)."""
    n = math.prod(shape)
    world = _world()
    if world < n:
        raise RuntimeError(f"need {n} ranks, found {world}")
    return make_mesh(range(n), shape, axes, device=device)
