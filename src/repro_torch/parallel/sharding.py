"""Sharding rules and layouts on a `torch.distributed` device mesh (port
of `repro/parallel/sharding.py`).

Mesh axes, as `repro`'s:
  single-pod : ("data", "model")
  multi-pod  : ("pod", "data", "model")

Logical axes used by the model code:
  "fsdp"  -> ("pod", "data")   parameter sharding (ZeRO-3 storage)
  "tp"    -> "model"           tensor parallelism: heads, ffn hidden,
             vocab, conv output channels; also the MoE expert dim (EP)
  "dp"    -> ("pod", "data")   the batch dim of activations
  "sp"    -> "model"           sequence parallelism

A spec is a tuple with one entry per tensor dim -- None, a mesh axis
name, or a tuple of names -- exactly the entries of `repro`'s
`PartitionSpec`, so the two compare entry for entry.  Every axis
assignment is guarded by divisibility (`_guard`): a dim the axis size
does not divide stays unsharded.

The JAX pieces and their counterparts here:
  * a sharded `jax.Array`: a `DTensor` on a `DeviceMesh`
    (`to_placements` turns a spec into its placements, one per mesh dim);
  * `jax.device_put(tree, tree_shardings(...))`: `device_put`, which
    takes each rank's block of a tensor every rank holds whole (no
    communication);
  * `shard_map`'s block layout and `psum`: `local`, `from_local` and
    `psum` (`dist.all_reduce` on `mesh.get_group(axis)`);
  * GSPMD's resharding between ops: `relayout_local`, `shard`,
    `unshard` and `conform` (a gradient laid out as its input).

torch.distributed runs one process per rank, and every rank runs the
same step on its own blocks; so every rank issues the same collectives
in the same order.  Only `dist.all_gather` and `dist.all_reduce` move
data here (DTensor's own redistribution is never called): those two are
what every backend implements for tensors on the card.  The process
group and its backend are the caller's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
import sys
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist

_ctx = threading.local()


def _dt():
    """`torch.distributed.tensor`, imported at first use: it takes over a
    second to import, and a run with no mesh never needs it."""
    import torch.distributed.tensor as dt
    return dt


def is_dtensor(x) -> bool:
    """True for a DTensor.  Nothing is one until `torch.distributed.
    tensor` is imported, so the no-mesh path never imports it."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _state():
    if not hasattr(_ctx, "mesh"):
        _ctx.mesh = None
    return _ctx


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate a mesh for `shard()` and the conv dispatch."""
    st = _state()
    prev = st.mesh
    st.mesh = mesh
    try:
        yield
    finally:
        st.mesh = prev


def current_mesh():
    """The mesh of the innermost `use_mesh` (None outside).  Read by the
    conv dispatch (`core.spec.dispatch_backend`) at every op."""
    return _state().mesh


def axis_sizes(mesh) -> dict:
    """{axis name: size} (`Mesh.shape`)."""
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def mesh_size(mesh) -> int:
    return math.prod(axis_sizes(mesh).values())


def logical_axes(mesh, *, serve: bool = False) -> dict:
    """Logical -> mesh axis mapping.

    serve=False (training layout): weights 2D-sharded over (fsdp, tp).
    serve=True (inference layout): the data axes are folded into TP, so
    weights are fully sharded over all ranks and stay resident; "dp"
    still maps to the data axes for activations and caches."""
    names = mesh.mesh_dim_names
    fsdp = tuple(a for a in ("pod", "data") if a in names)
    fsdp_ax = fsdp if len(fsdp) > 1 else (fsdp[0] if fsdp else None)
    tp = "model" if "model" in names else None
    if serve and tp is not None and fsdp:
        tp_serve = ("model",) + fsdp
        return {"fsdp": None, "dp": fsdp_ax, "tp": tp_serve,
                "sp": tp_serve}
    return {"fsdp": fsdp_ax, "dp": fsdp_ax, "tp": tp, "sp": tp}


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def _guard(mesh, spec_entries, shape) -> tuple:
    """Drop axes whose size does not divide the corresponding dim."""
    return tuple(None if ax is None or dim % _axis_size(mesh, ax) else ax
                 for dim, ax in zip(shape, spec_entries))


# ---------------------------------------------------------------------------
# Parameter spec inference
# ---------------------------------------------------------------------------

# (leaf-name regex, spec for the *trailing* dims).  Leading dims (the
# stacked layer axis) default to None.
_NAME_RULES = [
    (r"^experts_w[ig]$", ("tp", "fsdp", None)),     # (E, D, F): EP + FSDP
    (r"^experts_wo$",    ("tp", None, "fsdp")),     # (E, F, D)
    (r"^tok$",           ("tp", "fsdp")),           # (V, D) vocab-sharded
    (r"^head$",          ("fsdp", "tp")),           # (D, V)
    (r"^(wq|wk|wv|wi|wg|w_in|in_proj|router)$", ("fsdp", "tp")),
    (r"^(wo|w_out|out_proj)$", ("tp", "fsdp")),
    (r"^conv_w$",        (None, "tp")),             # (K, C) depthwise conv
    (r".*",              (None,)),                  # norms, biases, scalars
]

# 4-D conv filters (KH, KW, Cin, Cout) are claimed by rank, not by name
# (CNN filters sit in a list, GAN layers have per-layer names): Cout over
# "tp" -- the non-contracted dim each forward launch produces locally --
# and Cin over "fsdp" for storage, gathered per use by the conv dispatch.
_CONV_FILTER_SPEC = (None, None, "fsdp", "tp")
_SERVE_CONV_FILTER_SPEC = (None, None, None, "tp")  # serve: stay resident

# Serve-time layout: weights fully sharded over ALL ranks ("tp" = model +
# data axes; experts keep E over model ("ep") and shard the ffn dim over
# the data axes ("dax")).
_SERVE_RULES = [
    (r"^experts_w[ig]$", ("ep", None, "dax")),      # (E, D, F)
    (r"^experts_wo$",    ("ep", "dax", None)),      # (E, F, D)
    (r"^tok$",           ("ep", "dax")),            # (V, D)
    (r"^head$",          ("dax", "ep")),            # (D, V)
    (r"^(wq|wk|wv|wi|wg|w_in|in_proj|router)$", (None, "tp")),
    (r"^(wo|w_out|out_proj)$", ("tp", None)),
    (r"^conv_w$",        (None, "tp")),
    (r".*",              (None,)),
]

# MoE-train variant: the experts' FFN dim over the data axis instead of D.
_MOE_FFN_RULES = [
    (r"^experts_w[ig]$", ("tp", None, "fsdp")),     # (E, D, F@data)
    (r"^experts_wo$",    ("tp", "fsdp", None)),     # (E, F@data, D)
]


def leaf_pspec(path: str, shape, mesh, *, serve: bool = False,
               moe_ffn_data: bool = False) -> tuple:
    """The spec of the leaf at `path` ("blocks/mlp/wi", "convs/1")."""
    la = logical_axes(mesh, serve=serve)
    if serve:
        names = mesh.mesh_dim_names
        dax = tuple(a for a in ("pod", "data") if a in names)
        la = dict(la, ep="model" if "model" in names else None,
                  dax=dax if len(dax) > 1 else (dax[0] if dax else None))
    rules = _SERVE_RULES if serve else _NAME_RULES
    if moe_ffn_data and not serve:
        rules = _MOE_FFN_RULES + rules
    name = path.split("/")[-1]
    for pat, spec in rules:
        if re.match(pat, name):
            if pat == r".*" and len(shape) == 4:
                spec = (_SERVE_CONV_FILTER_SPEC if serve
                        else _CONV_FILTER_SPEC)
            entries = [la.get(s) if isinstance(s, str) else s for s in spec]
            if len(entries) < len(shape):   # leading stack dims
                entries = [None] * (len(shape) - len(entries)) + entries
            elif len(entries) > len(shape):
                entries = entries[-len(shape):] if len(shape) else []
            return _guard(mesh, entries, shape)
    return ()


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def tree_pspecs(tree, mesh, *, serve: bool = False,
                moe_ffn_data: bool = False):
    """The spec tree of a tree of tensors (or anything with `.shape`)."""
    return _map_with_path(
        lambda path, leaf: leaf_pspec(path, tuple(leaf.shape), mesh,
                                      serve=serve,
                                      moe_ffn_data=moe_ffn_data), tree)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (`jax.sharding.NamedSharding`)."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return to_placements(self.mesh, self.spec)


def tree_shardings(tree, mesh, *, serve: bool = False,
                   moe_ffn_data: bool = False):
    """The `NamedSharding` tree of a tree of tensors (`device_put`'s
    layout)."""
    return _map_with_path(
        lambda path, leaf: NamedSharding(mesh, leaf_pspec(
            path, tuple(leaf.shape), mesh, serve=serve,
            moe_ffn_data=moe_ffn_data)), tree)


def batch_pspec(mesh, rank: int, batch_dim: int = 0,
                batch_size: Optional[int] = None) -> tuple:
    """The batch dim over ("pod", "data"), only when the batch size is
    given and divides the data axes (a ragged or unknown batch stays
    unsharded)."""
    dp = logical_axes(mesh)["dp"]
    entries = [None] * rank
    if (dp is not None and batch_size is not None
            and batch_size % _axis_size(mesh, dp) == 0):
        entries[batch_dim] = dp
    return tuple(entries)


# ---------------------------------------------------------------------------
# Layouts: specs as DTensor placements, and moving blocks between them
# ---------------------------------------------------------------------------

def to_placements(mesh, spec: Sequence) -> tuple:
    """One placement per mesh dim: `Shard(d)` where the axis shards
    tensor dim d, else `Replicate()`.  A dim over several axes is split
    in mesh-dim order (outer axis first), as `PartitionSpec` splits a
    tuple; an entry naming its axes in another order has no placement."""
    names = mesh.mesh_dim_names
    out = list(_replicated(mesh))
    for d, entry in enumerate(spec):
        axes = () if entry is None else \
            (entry if isinstance(entry, tuple) else (entry,))
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} names its axes out of "
                             f"the mesh's order {names}")
        for i in idx:
            out[i] = _dt().Shard(d)
    return tuple(out)


def _replicated(mesh) -> tuple:
    return (_dt().Replicate(),) * len(mesh.mesh_dim_names)


def _block(x, mesh) -> tuple:
    """(this rank's block, its placements): a plain tensor is whole on
    every rank."""
    if is_dtensor(x):
        return x.to_local(), x.placements
    return x, _replicated(mesh)


def _wrap(t: torch.Tensor, mesh, placements) -> "DTensor":
    return _dt().DTensor.from_local(t, mesh, placements, run_check=False)


def _chunk(t: torch.Tensor, mesh, i: int, d: int) -> torch.Tensor:
    n = mesh.size(i)
    return t.chunk(n, d)[mesh.get_local_rank(i)] if n > 1 else t


def _gather(t: torch.Tensor, mesh, i: int, d: int) -> torch.Tensor:
    if mesh.size(i) == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.size(i))]
    dist.all_gather(parts, t.contiguous(), group=mesh.get_group(i))
    return torch.cat(parts, d)


def _shard_dims(placements) -> dict:
    """{tensor dim: [mesh dims sharding it, in mesh order]}."""
    out = {}
    for i, p in enumerate(placements):
        if isinstance(p, _dt().Shard):
            out.setdefault(p.dim, []).append(i)
        elif not isinstance(p, _dt().Replicate):
            raise ValueError(f"unsupported placement {p}")
    return out


def relayout_local(t: torch.Tensor, src, dst, mesh) -> torch.Tensor:
    """This rank's block under placements `dst`, from its block `t` under
    `src` (not differentiable).  Every tensor dim whose sharding changes
    is first all-gathered over each mesh dim that shards it (inner
    first); only then are the dims chunked for `dst` (outer first), so
    no gather ever mixes blocks another dim was already cut into.  Dims
    that keep their sharding do not move."""
    s, d = _shard_dims(src), _shard_dims(dst)
    moved = [dim for dim in sorted(set(s) | set(d))
             if s.get(dim) != d.get(dim)]
    for dim in moved:
        for i in reversed(s.get(dim, [])):
            t = _gather(t, mesh, i, dim)
    for dim in moved:
        for i in d.get(dim, []):
            t = _chunk(t, mesh, i, dim)
    return t.contiguous()


def local(x, mesh, spec) -> torch.Tensor:
    """This rank's block of `x` (a DTensor, or a plain tensor whole on
    every rank) laid out by `spec`."""
    return relayout_local(*_block(x, mesh), to_placements(mesh, spec), mesh)


def from_local(t: torch.Tensor, mesh, spec) -> "DTensor":
    """A DTensor whose block on this rank is `t` (`shard_map`'s
    out_specs); the global shape is the blocks' even tiling."""
    return _wrap(t, mesh, to_placements(mesh, spec))


def device_put(tree, shardings):
    """`jax.device_put`: each tensor of `tree`, whole on every rank, laid
    out by the matching `NamedSharding` (this rank keeps its block; no
    communication)."""
    if isinstance(shardings, NamedSharding):
        return from_local(local(tree, shardings.mesh, shardings.spec),
                          shardings.mesh, shardings.spec)
    if isinstance(tree, dict):
        return {k: device_put(v, shardings[k]) for k, v in tree.items()}
    return type(tree)(device_put(v, s) for v, s in zip(tree, shardings))


def full_tensor(x) -> torch.Tensor:
    """The whole of `x` as a plain tensor on every rank (not
    differentiable); a plain tensor is returned as it is."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    return relayout_local(*_block(x, mesh), _replicated(mesh), mesh)


def psum(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """`lax.psum` over `axes` (a name, a tuple of names or None), in
    place on `t`."""
    if axes is None:
        return t
    names = mesh.mesh_dim_names
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        i = names.index(a)
        if mesh.size(i) > 1:
            dist.all_reduce(t, group=mesh.get_group(i))
    return t


def barrier(mesh) -> None:
    """Every rank of `mesh` has reached this point (an all-reduce over
    each of its axes in turn)."""
    t = torch.zeros(1, device=mesh.device_type)
    psum(t, mesh, tuple(mesh.mesh_dim_names))


class _Relayout(torch.autograd.Function):
    """x (a DTensor, or a plain tensor whole on every rank) laid out by
    `spec`; with `plain` the result is the whole tensor as a plain one.
    The backward lays the cotangent out as x was."""

    @staticmethod
    def forward(ctx, x, mesh, spec, plain):
        ctx.mesh = mesh
        ctx.src = x.placements if is_dtensor(x) else None
        t = local(x, mesh, spec)
        return t if plain else from_local(t, mesh, spec)

    @staticmethod
    def backward(ctx, g):
        mesh, src = ctx.mesh, ctx.src
        out = relayout_local(*_block(g, mesh), src or _replicated(mesh),
                             mesh)
        return (out if src is None else _wrap(out, mesh, src),
                None, None, None)


def shard(x: torch.Tensor, *logical) -> torch.Tensor:
    """Activation layout by logical axis names ("dp", "tp", "sp", None),
    differentiable.  Outside a `use_mesh` context, x itself."""
    mesh = current_mesh()
    if mesh is None:
        return x
    la = logical_axes(mesh)
    entries = [la.get(ax) if isinstance(ax, str) else ax for ax in logical]
    return _Relayout.apply(x, mesh, _guard(mesh, entries, x.shape), False)


def unshard(x: torch.Tensor) -> torch.Tensor:
    """The whole of `x` as a plain tensor on every rank, differentiable:
    the ops after it (a dense head, a loss) run on the global batch on
    every rank, and its gradient is each rank's block of the (identical)
    whole gradient.  A plain tensor is returned as it is."""
    if not is_dtensor(x):
        return x
    return _Relayout.apply(x, x.device_mesh, (None,) * x.dim(), True)


def conform(g, like):
    """A gradient laid out as the input it belongs to: a plain gradient
    of a DTensor input is chunked to its blocks, a DTensor gradient of a
    plain input is gathered whole.  Identity when both are plain."""
    if g is None or not (is_dtensor(g) or is_dtensor(like)):
        return g
    if not is_dtensor(like):
        return full_tensor(g)
    mesh = like.device_mesh
    return _wrap(relayout_local(*_block(g, mesh), like.placements, mesh),
                 mesh, like.placements)
