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

A dim over several axes is split with the block index in the entry's
order, outer axis first: the serve layout's ("model", "data") on a
("data", "model") mesh puts "model" outside "data".

The JAX pieces and their counterparts here:
  * a sharded `jax.Array`: a `DTensor` on a `DeviceMesh`
    (`to_placements` turns a spec into its placements, one per mesh
    dim), or, where a dim's axes run against the mesh's order (which
    placements cannot say), a `Sharded`: the rank's block with its spec;
  * `jax.device_put(tree, tree_shardings(...))`: `device_put`, which
    takes each rank's block of a tensor every rank holds whole (no
    communication);
  * `shard_map`'s block layout and `psum`: `local`, `from_local` and
    `psum` (`dist.all_reduce` on `mesh.get_group(axis)`, or on the whole
    group when the axes are all of a mesh that spans it);
  * GSPMD's resharding between ops: `relayout_local` (all-gathers, then
    chunks), `shard`, `unshard` and `conform` (a gradient laid out as its
    input) for the conv path; for the LM's ops (`models/layers.py::
    MeshPlan`) `fetch` (a weight's block at its use: all-gathers
    forward, an all-reduce then a chunk of its gradient backward),
    `copy_to` (identity forward, an all-reduce of the gradient) and
    `reduce_from` (an all-reduce forward, identity backward), Megatron's
    f and g.

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
# Layouts: specs, this rank's block, and moving blocks between layouts
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> tuple:
    """A spec entry's mesh axes in block order (outer first)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _spec_axes(spec) -> dict:
    """{tensor dim: its axes in block order} over the dims `spec` shards."""
    return {d: _entry_axes(e) for d, e in enumerate(spec) if _entry_axes(e)}


def spec_mesh_axes(mesh, spec) -> tuple:
    """Every mesh axis that shards some dim of `spec`, in mesh order."""
    used = {a for axes in _spec_axes(spec).values() for a in axes}
    return tuple(a for a in mesh.mesh_dim_names if a in used)


def in_mesh_order(mesh, spec) -> bool:
    """True when each entry of `spec` names its axes in the mesh's order:
    the layouts DTensor placements express (a DTensor splits a dim over
    its axes in mesh-dim order)."""
    names = mesh.mesh_dim_names
    return all([names.index(a) for a in axes] ==
               sorted(names.index(a) for a in axes)
               for axes in _spec_axes(spec).values())


def to_placements(mesh, spec: Sequence) -> tuple:
    """One placement per mesh dim: `Shard(d)` where the axis shards tensor
    dim d, else `Replicate()`.  A dim over several axes is split with the
    block index in the entry's order, outer axis first, as
    `PartitionSpec` splits a tuple.  Placements name the axes of a dim but
    not their order, and a DTensor takes them in mesh order: an entry in
    another order (the serve layout's ("model", "data") on a ("data",
    "model") mesh) has the same placements as its mesh-order twin, and
    `device_put` keeps such a leaf as a `Sharded`, whose spec carries the
    order."""
    names = mesh.mesh_dim_names
    out = list(_replicated(mesh))
    for d, axes in _spec_axes(spec).items():
        for a in axes:
            out[names.index(a)] = _dt().Shard(d)
    return tuple(out)


def _replicated(mesh) -> tuple:
    return (_dt().Replicate(),) * len(mesh.mesh_dim_names)


def _spec_of(mesh, placements, ndim: int) -> tuple:
    """The spec of DTensor placements: each dim's axes in mesh order."""
    names = mesh.mesh_dim_names
    axes = [[] for _ in range(ndim)]
    for i, p in enumerate(placements):
        if isinstance(p, _dt().Shard):
            axes[p.dim].append(names[i])
        elif not isinstance(p, _dt().Replicate):
            raise ValueError(f"unsupported placement {p}")
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in axes)


class Sharded:
    """This rank's block `local` (a plain tensor) of a tensor laid out by
    `spec` on `mesh`; the global shape is the blocks' even tiling.  The
    container of a layout DTensor placements cannot express (a dim split
    over its axes in another order than the mesh's), and the form in
    which the LM's ops on a mesh read their params and KV caches: the
    spec beside the block says which collectives an op needs."""

    __slots__ = ("local", "mesh", "spec")

    def __init__(self, local: torch.Tensor, mesh, spec):
        self.local, self.mesh, self.spec = local, mesh, tuple(spec)

    @property
    def shape(self) -> torch.Size:
        return torch.Size(n * _axis_size(self.mesh, e or None)
                          for n, e in zip(self.local.shape, self.spec))

    def dim(self) -> int:
        return self.local.dim()

    def __repr__(self) -> str:
        return (f"Sharded({tuple(self.shape)}, spec={self.spec}, "
                f"local={tuple(self.local.shape)}, {self.local.dtype})")


def is_container(x) -> bool:
    """A DTensor or a `Sharded`."""
    return isinstance(x, Sharded) or is_dtensor(x)


def _block(x) -> tuple:
    """(this rank's block, its spec): a plain tensor is whole on every
    rank."""
    if isinstance(x, Sharded):
        return x.local, x.spec
    if is_dtensor(x):
        return x.to_local(), _spec_of(x.device_mesh, x.placements, x.dim())
    return x, (None,) * x.dim()


def container_mesh(x):
    """The mesh of a DTensor or a `Sharded`, else None."""
    if isinstance(x, Sharded):
        return x.mesh
    return x.device_mesh if is_dtensor(x) else None


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def tree_mesh(tree):
    """The mesh of `tree`'s first DTensor or `Sharded` leaf, else the
    innermost `use_mesh`'s (None outside one)."""
    for leaf in _leaves(tree):
        if is_container(leaf):
            return container_mesh(leaf)
    return current_mesh()


def as_sharded(x, mesh) -> Sharded:
    """`x` (a DTensor, a `Sharded`, or a plain tensor whole on every rank)
    as a `Sharded` of the same layout; no data moves."""
    if isinstance(x, Sharded):
        return x
    t, spec = _block(x)
    return Sharded(t, mesh, spec)


def _group(mesh, axes: tuple):
    """The process group of one collective over `axes` (a name, or all
    the mesh's axes when the mesh spans the whole process group), else
    None: the caller then runs one collective per axis."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if set(axes) == set(mesh.mesh_dim_names) and \
            mesh_size(mesh) == dist.get_world_size():
        return dist.group.WORLD
    return None


def _block_order(mesh, axes: tuple) -> list:
    """For the whole-group gather over `axes`: the global rank of each
    block index (axes in block order, outer first)."""
    names = mesh.mesh_dim_names
    ranks = mesh.mesh.flatten().tolist()
    order = [0] * len(ranks)
    for pos, r in enumerate(ranks):
        coord, rest = [], pos
        for n in reversed(mesh.mesh.shape):
            coord.insert(0, rest % n)
            rest //= n
        idx = 0
        for a in axes:
            i = names.index(a)
            idx = idx * mesh.size(i) + coord[i]
        order[idx] = r
    return order


def _real(mesh, axes) -> tuple:
    """The axes of `axes` (a name, a tuple or None) with more than one
    rank."""
    return tuple(a for a in _entry_axes(axes) if _axis_size(mesh, a) > 1)


def gather(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The blocks of `t` over `axes` concatenated along `dim` in block
    order (not differentiable): one `all_gather` per axis, inner first,
    or one over the whole group when the axes are all of it."""
    axes = _real(mesh, axes)
    if not axes:
        return t
    t = t.contiguous()
    group = _group(mesh, axes)
    if group is not None:
        n = dist.get_world_size(group)
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        if len(axes) == 1:
            return torch.cat(parts, dim)
        return torch.cat([parts[r] for r in _block_order(mesh, axes)], dim)
    for a in reversed(axes):
        t = gather(t, mesh, a, dim)
    return t


def _chunk(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = _axis_size(mesh, axis)
    if n == 1:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, mesh.get_local_rank(axis) * size, size)


def block_index(mesh, axes) -> int:
    """This rank's block index over `axes` (block order, outer first)."""
    idx = 0
    for a in _entry_axes(axes):
        idx = idx * _axis_size(mesh, a) + (
            mesh.get_local_rank(a) if _axis_size(mesh, a) > 1 else 0)
    return idx


def chunk(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block of `t` (whole on the ranks of `axes`) along
    `dim`."""
    for a in _entry_axes(axes):
        t = _chunk(t, mesh, a, dim)
    return t


def relayout_local(t: torch.Tensor, src, dst, mesh) -> torch.Tensor:
    """This rank's block under spec `dst`, from its block `t` under spec
    `src` (not differentiable).  Per tensor dim whose axes change, the
    axes the two specs share as a leading prefix stay; the rest of
    `src`'s are all-gathered (inner first), and only then are the dims
    chunked for the rest of `dst`'s (outer first), so no gather ever
    mixes blocks another dim was already cut into.  Dims that keep their
    axes do not move."""
    s, d = _spec_axes(src), _spec_axes(dst)
    moves = []
    for dim in sorted(set(s) | set(d)):
        a, b = s.get(dim, ()), d.get(dim, ())
        if a == b:
            continue
        k = 0
        while k < min(len(a), len(b)) and a[k] == b[k]:
            k += 1
        moves.append((dim, a[k:], b[k:]))
    for dim, g, _ in moves:
        t = gather(t, mesh, g, dim)
    for dim, _, c in moves:
        t = chunk(t, mesh, c, dim)
    return t.contiguous()


def local(x, mesh, spec) -> torch.Tensor:
    """This rank's block of `x` (a DTensor, a `Sharded`, or a plain
    tensor whole on every rank) laid out by `spec`."""
    t, src = _block(x)
    return relayout_local(t, src, spec, mesh)


def from_local(t: torch.Tensor, mesh, spec):
    """The container whose block on this rank is `t` (`shard_map`'s
    out_specs): a DTensor, or a `Sharded` where the spec names a dim's
    axes out of the mesh's order."""
    if not in_mesh_order(mesh, spec):
        return Sharded(t, mesh, spec)
    return _wrap(t, mesh, to_placements(mesh, spec))


def _wrap(t: torch.Tensor, mesh, placements) -> "DTensor":
    return _dt().DTensor.from_local(t, mesh, placements, run_check=False)


def rewrap(like, t: torch.Tensor):
    """`t`, a block in the layout of the container `like`, in a container
    of the same kind (a plain `like` gives `t` itself)."""
    if not is_container(like):
        return t
    mesh = container_mesh(like)
    spec = _block(like)[1]
    if isinstance(like, Sharded):
        return Sharded(t, mesh, spec)
    return _wrap(t, mesh, like.placements)


def device_put(tree, shardings):
    """`jax.device_put`: each tensor of `tree`, whole on every rank, laid
    out by the matching `NamedSharding` (this rank keeps its block; no
    communication)."""
    if isinstance(shardings, NamedSharding):
        t = local(tree, shardings.mesh, shardings.spec)
        if t.untyped_storage().nbytes() > t.numel() * t.element_size():
            t = t.clone()     # a view would keep the whole tensor alive
        return from_local(t, shardings.mesh, shardings.spec)
    if isinstance(tree, dict):
        return {k: device_put(v, shardings[k]) for k, v in tree.items()}
    return type(tree)(device_put(v, s) for v, s in zip(tree, shardings))


def full_tensor(x) -> torch.Tensor:
    """The whole of `x` as a plain tensor on every rank (not
    differentiable); a plain tensor is returned as it is."""
    if not is_container(x):
        return x
    t, spec = _block(x)
    return relayout_local(t, spec, (None,) * t.dim(), container_mesh(x))


def psum(t: torch.Tensor, mesh, axes, op=None) -> torch.Tensor:
    """`lax.psum` over `axes` (a name, a tuple of names or None), in
    place on `t`; `op=dist.ReduceOp.MAX` gives `lax.pmax`.  One
    `all_reduce` per axis, or one over the whole group when the axes are
    all of it; a bf16 / fp16 tensor is reduced in fp32."""
    axes = _real(mesh, axes)
    if not axes:
        return t
    if t.dtype in (torch.bfloat16, torch.float16):
        # The sum in fp32, rounded once, as one device's matmul rounds.
        return t.copy_(psum(t.float(), mesh, axes, op))
    op = dist.ReduceOp.SUM if op is None else op
    group = _group(mesh, axes)
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
        return t
    for a in axes:
        dist.all_reduce(t, op=op, group=mesh.get_group(a))
    return t


def barrier(mesh) -> None:
    """Every rank of `mesh` has reached this point (an all-reduce over
    each of its axes in turn)."""
    t = torch.zeros(1, device=mesh.device_type)
    psum(t, mesh, tuple(mesh.mesh_dim_names))


def tree_sumsq(leaves) -> torch.Tensor:
    """The sum of squares of every element of the global tensors whose
    blocks are `leaves` (`Sharded`s), in fp32 and equal on every rank:
    each leaf's block sums are grouped by the axes that shard it, and
    each group is summed over those axes (a replicated axis holds copies,
    not parts)."""
    groups, mesh = {}, None
    for s in leaves:
        mesh = s.mesh
        key = spec_mesh_axes(s.mesh, s.spec)
        v = torch.sum(torch.square(s.local.float()))
        groups[key] = groups[key] + v if key in groups else v
    total = None
    for key in sorted(groups):
        v = psum(groups[key].clone(), mesh, key)
        total = v if total is None else total + v
    return total


# ---------------------------------------------------------------------------
# Differentiable moves between layouts
# ---------------------------------------------------------------------------

class _Relayout(torch.autograd.Function):
    """x (a DTensor, or a plain tensor whole on every rank) laid out by
    `spec`; with `plain` the result is the whole tensor as a plain one.
    The backward lays the cotangent out as x was."""

    @staticmethod
    def forward(ctx, x, mesh, spec, plain):
        ctx.mesh = mesh
        ctx.src = _block(x)[1] if is_dtensor(x) else None
        ctx.dtensor = is_dtensor(x)
        t = local(x, mesh, spec)
        return t if plain else from_local(t, mesh, spec)

    @staticmethod
    def backward(ctx, g):
        t, spec = _block(g)
        src = ctx.src or (None,) * t.dim()
        out = relayout_local(t, spec, src, ctx.mesh)
        if ctx.dtensor:
            out = _wrap(out, ctx.mesh, to_placements(ctx.mesh, src))
        return out, None, None, None


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
    t, spec = _block(g)
    return _wrap(relayout_local(t, spec, _block(like)[1], mesh), mesh,
                 like.placements)


class _Fetch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, src, dst, reduce):
        ctx.mesh, ctx.src, ctx.dst, ctx.reduce = mesh, src, dst, reduce
        out = relayout_local(t, src, dst, mesh)
        return out.view_as(out) if out is t else out

    @staticmethod
    def backward(ctx, g):
        g = psum(g.contiguous().clone(), ctx.mesh, ctx.reduce)
        return (relayout_local(g, ctx.dst, ctx.src, ctx.mesh), None, None,
                None, None)


def fetch(w: Sharded, want, reduce=()) -> torch.Tensor:
    """This rank's block of `w` under the spec `want`, moved by
    all-gathers (FSDP's gather at a weight's use), differentiable: the
    gradient of the block is summed over the axes `reduce` (the axes on
    whose ranks the same block met other data: the batch axes), then
    laid out as `w` (a chunk of the sum: a reduce-scatter)."""
    want, reduce = tuple(want), _real(w.mesh, reduce)
    if _spec_axes(want) == _spec_axes(w.spec) and not reduce:
        return w.local
    return _Fetch.apply(w.local, w.mesh, w.spec, want, reduce)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g.contiguous().clone(), ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return psum(x.contiguous().clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """x, the same on every rank of `axes`, entering ops split over them
    (Megatron's f): the identity forward, an all-reduce of the gradient
    over `axes` backward (each rank's part of it is partial)."""
    axes = _real(mesh, axes)
    return _CopyTo.apply(x, mesh, axes) if axes else x


def reduce_from(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum over `axes` of each rank's partial `x` (Megatron's g): an
    all-reduce forward; the gradient, the same on every rank of `axes`,
    passes through as it is."""
    axes = _real(mesh, axes)
    return _ReduceFrom.apply(x, mesh, axes) if axes else x
