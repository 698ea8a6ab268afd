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
`run_ranks` starts such a group of `gloo` ranks itself (the launchers'
`--mesh DxM`), or joins the one `torchrun` describes.
"""
from __future__ import annotations

import math
import os
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


def parse_mesh(text: str) -> tuple:
    """"2x2" -> (2, 2): a ("data", "model") mesh's sizes (three sizes:
    ("pod", "data", "model"))."""
    shape = tuple(int(n) for n in text.lower().split("x"))
    if len(shape) not in (2, 3) or min(shape) < 1:
        raise ValueError(f"--mesh takes DxM or PxDxM, got {text!r}")
    return shape


def mesh_axes(shape) -> tuple:
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _rank_main(rank: int, world: int, init: str, fn, shape, device,
               args, out_dir):
    import torch.distributed as dist
    if device is None or torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:       # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        mesh = make_debug_mesh(shape, mesh_axes(shape), device=device)
        out = fn(mesh, *args)
        if out_dir is not None and rank == 0:
            torch.save(out, f"{out_dir}/result.pt")
        dist.barrier()
        return out
    finally:
        dist.destroy_process_group()


def run_ranks(fn, shape, *, device=None, args=()):
    """`fn(mesh, *args)` on every rank of a `gloo` group over a `shape`
    mesh (`mesh_axes`); rank 0's result.  Under `torchrun` (RANK and
    WORLD_SIZE in the environment) this process is one of the ranks and
    the group comes from the environment; otherwise prod(shape) ranks are
    spawned here, joined through a `file://` store in a temporary
    directory, and all of them end before this returns.  On the card rank
    r uses card r % device_count (several ranks share one card when there
    are fewer cards; `gloo`, as NCCL takes one rank per card).  `fn`
    must be picklable (a module-level function)."""
    import tempfile

    import torch.multiprocessing as mp

    world = math.prod(shape)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"WORLD_SIZE {os.environ['WORLD_SIZE']} does "
                             f"not fill a {shape} mesh")
        return _rank_main(int(os.environ["RANK"]), world, "env://", fn,
                          shape, device, args, None)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(world, f"file://{tmp}/store", fn, shape,
                                   device, args, tmp), nprocs=world,
                 join=True)
        return torch.load(f"{tmp}/result.pt", weights_only=False)
