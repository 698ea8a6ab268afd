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
`ShapeDtypeStruct`s (no allocation).

`lower_cell` is the dry-run's (`launch/dryrun.py`) counterpart of
`repro`'s XLA lowering: a `Cell` holding one (arch x shape) step and
rank 0's arguments on a mesh -- its blocks of the params, optimizer
state, inputs and cache, made at their block shapes (nothing is made
whole and then cut) as fake CPU tensors (shapes, no data), which stand
for the card's, or, with `fake=False`, as zeros on the card.
`Cell.trace()` runs the step once under `TraceCounters` (the bytes of
live storages, the collectives) and torch's `FlopCounterMode`: on fake
tensors the card's path runs with nothing launched (the attention
kernels' fake forms, `kernels/ops.py`), and the process group may be a
fake one whose collectives move nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

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


# ---------------------------------------------------------------------------
# The dry-run's cell: one step and rank 0's arguments, traced once
# ---------------------------------------------------------------------------

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# The c10d ops `parallel/sharding.py` issues (`dist.all_gather`,
# `dist.all_reduce`), by the kind `repro`'s HLO parse names.
_C10D_KINDS = {"allgather_": "all-gather", "allreduce_": "all-reduce",
               "reduce_scatter_": "reduce-scatter",
               "alltoall_": "all-to-all"}


def _tensors(tree) -> list:
    """The tensors of a tree of tensors, `Sharded`s (their blocks), ints
    and None."""
    out = []
    for leaf in tree_leaves(tree):
        t = leaf.local if isinstance(leaf, sh.Sharded) else leaf
        if isinstance(t, torch.Tensor):
            out.append(t)
    return out


def _storage_bytes(tensors) -> int:
    """The bytes of the distinct storages under `tensors`."""
    return sum({id(t.untyped_storage()): t.untyped_storage().nbytes()
                for t in tensors}.values())


class TraceCounters(TorchDispatchMode):
    """Counts what the ops it sees do: the bytes of the storages alive
    (each storage but a meta tensor's, from the first op that returns it
    until it is freed:
    `live` and its `peak`; each rounded up to a multiple of `granule`
    bytes -- 512 is the CUDA caching allocator's), and the collectives by
    kind -- count, the bytes of their results, the sizes of their
    groups."""

    def __init__(self, granule: int = 1):
        super().__init__()
        self.granule = granule
        from torch.utils.weak import WeakIdKeyDictionary
        self._seen = WeakIdKeyDictionary()
        self.live = self.peak = 0
        self.collectives = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
        self.group_sizes = set()

    def _free(self, n: int, _ref) -> None:
        self.live -= n

    def track(self, t: torch.Tensor) -> None:
        if t.device.type == "meta":     # shapes only, on every device
            return
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = -(-st.nbytes() // self.granule) * self.granule
        self._seen[st] = weakref.ref(st, lambda r, n=n: self._free(n, r))
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._schema.name
        if name.startswith("c10d::"):
            kind = _C10D_KINDS.get(name.split("::")[1])
            if kind is not None:
                res = args[0]
                res = res[0] if kind == "all-gather" else res
                c = self.collectives[kind]
                c["count"] += 1
                c["bytes"] += sum(t.numel() * t.element_size() for t in res)
                for a in args:
                    if isinstance(a, torch.ScriptObject):
                        with contextlib.suppress(RuntimeError):
                            self.group_sizes.add(
                                torch.distributed.ProcessGroup.unbox(a)
                                .size())
        for t in tree_leaves(out if isinstance(out, (tuple, list))
                             else [out]):
            if isinstance(t, torch.Tensor):
                self.track(t)
        return out

    def record(self) -> dict:
        out = {k: dict(v) for k, v in self.collectives.items()}
        out["group_sizes"] = sorted(self.group_sizes)
        return out


@dataclasses.dataclass
class Cell:
    """One (arch x shape) step on a mesh and rank 0's arguments:
    `step(*args)`.  `kind` is the shape's (train | prefill | decode);
    `mode` is the arguments' FakeTensorMode, None where they are real."""
    kind: str
    step: Callable
    args: tuple
    mode: Any = None
    n_micro: Optional[int] = None

    def trace(self, granule: int = 1) -> dict:
        """Run the step once under the counters: (per rank) the bytes of
        the arguments, the outputs, the peak less the arguments ("temp")
        and the outputs that are arguments written in place ("alias"),
        each storage rounded up to `granule` bytes; the FLOPs
        (`FlopCounterMode`, plus the attention kernels' fake forms'
        FAKE_FLOPS); the collectives; the kernel launches and attention
        forms (on fake arguments the fake forms' `attention.FAKE_CALLS` /
        FAKE_FORMS, which must launch nothing; on real ones `ops.
        LAUNCHES`, FLASH_FORMS, FLASH_BWD_FORMS); the seconds.  No
        gradient is recorded outside a training step."""
        from torch.utils.flop_counter import FlopCounterMode

        from repro_torch.kernels import attention, ops

        ops.reset_launches()
        arg_tensors = _tensors(self.args)
        counters = TraceCounters(granule)
        for t in arg_tensors:
            counters.track(t)
        args_bytes = counters.live
        flops = FlopCounterMode(display=False)
        with contextlib.ExitStack() as stack:
            if self.mode is not None:
                stack.enter_context(self.mode)
            stack.enter_context(counters)
            stack.enter_context(flops)
            if self.kind != "train":
                stack.enter_context(torch.no_grad())
            t0 = time.perf_counter()
            out = self.step(*self.args)
            seconds = time.perf_counter() - t0
            out_tensors = _tensors(out)
            arg_ids = {id(t.untyped_storage()) for t in arg_tensors}
            alias = _storage_bytes([t for t in out_tensors
                                   if id(t.untyped_storage()) in arg_ids])
            out_bytes = _storage_bytes(out_tensors)
        del out, out_tensors
        if self.mode is None:
            launches = ops.LAUNCHES
            forms = {"forward": ops.FLASH_FORMS,
                     "backward": ops.FLASH_BWD_FORMS}
        else:
            if any(ops.LAUNCHES.values()):
                raise RuntimeError(f"a fake trace launched kernels: "
                                   f"{ops.LAUNCHES}")
            launches, forms = attention.FAKE_CALLS, attention.FAKE_FORMS
        return {
            "argument_size_in_bytes": args_bytes,
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": counters.peak - args_bytes,
            "alias_size_in_bytes": alias,
            "cost": {"flops": float(flops.get_total_flops()
                                    + sum(attention.FAKE_FLOPS.values()))},
            "collectives": counters.record(),
            "launches": {k: v for k, v in launches.items() if v},
            "attention_forms": {
                way: {k: v for k, v in counts.items() if v}
                for way, counts in forms.items()},
            "compile_s": seconds,
        }


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               opt_cfg: Optional[AdamWConfig] = None, *,
               serve_sharding: str = "train",
               n_micro: Optional[int] = None,
               remat: Optional[str] = None,
               bf16_params: bool = False,
               moe_ffn_data: bool = False,
               fake: bool = True) -> Cell:
    """The step of one (arch x shape) cell on `mesh` and rank 0's
    arguments (`repro`'s knobs, with its rules):
      serve_sharding="tp" : the serve layout (weights folded over the data
        axes) for prefill / decode;
      n_micro : the config's gradient-accumulation count, overridden (and
        lowered by `effective_microbatches` as always);
      remat   : the config's remat policy, overridden ("none" | "full");
      bf16_params : matrices stored in bf16, the fp32 master in the
        optimizer state;
      moe_ffn_data : the experts' hidden dim over the data axes.
    The optimizer is AdamW with bf16 moments for qwen3-moe-235b-a22b.

    The arguments are rank 0's blocks in `tree_shardings` /
    `batch_shardings` / `cache_pspecs`' layouts, each a `Sharded`, made
    at the block's shape: fake CPU tensors, which take the card's path
    (the attention kernels' fake forms), or with `fake=False` zeros on
    the card.  A decode cell's cache is
    full to its last position (`len` = seq_len - 1), so the step reads
    all of it, as a step at that depth does."""
    if remat is not None:
        cfg = cfg.scaled(remat=remat)
    opt_cfg = opt_cfg or AdamWConfig(
        moment_dtype="bfloat16" if cfg.name == "qwen3-moe-235b-a22b"
        else "float32")
    if bf16_params:
        opt_cfg = dataclasses.replace(opt_cfg, bf16_params=True)
    serve = serve_sharding == "tp" and shape.kind != "train"
    train = shape.kind == "train"
    dev = torch.device("cpu" if fake else "cuda")
    specs = input_specs(cfg, shape)
    params_abs, opt_abs = abstract_state(cfg, opt_cfg if train else None)
    if bf16_params:
        params_abs = tree_map(
            lambda t: t.to(torch.bfloat16)
            if t.dtype == torch.float32 and t.dim() >= 2 else t, params_abs)
    mode = None
    if fake:
        from torch._subclasses.fake_tensor import FakeTensorMode
        mode = FakeTensorMode()

    def block(t, spec):
        shp = tuple(n // sh._axis_size(mesh, e or None)
                    for n, e in zip(t.shape, spec))
        with mode if fake else contextlib.nullcontext():
            local = torch.empty(shp, dtype=t.dtype, device=dev) if fake \
                else torch.zeros(shp, dtype=t.dtype, device=dev)
        return sh.Sharded(local, mesh, spec)

    params = tree_map(block, params_abs, sh.tree_pspecs(
        params_abs, mesh, serve=serve, moe_ffn_data=moe_ffn_data))
    b_sh = batch_shardings(cfg, shape, mesh)
    if train:
        opt = tree_map(block, opt_abs, sh.tree_pspecs(
            opt_abs, mesh, moe_ffn_data=moe_ffn_data))
        if n_micro is not None:
            cfg = cfg.scaled(microbatch=n_micro)
        n = effective_microbatches(cfg, shape.global_batch, mesh)
        batch = {k: block(specs[k], b_sh[k].spec)
                 for k in ("inputs", "labels")}
        return Cell("train", make_train_step(cfg, opt_cfg, n),
                    (params, opt, batch), mode, n)
    if shape.kind == "prefill":
        return Cell("prefill", make_prefill_step(cfg, shape.seq_len),
                    (params, block(specs["inputs"], b_sh["inputs"].spec)),
                    mode)
    cache = {k: block(t, b_sh["cache"][k].spec)
             for k, t in specs["cache"].items() if k != "len"}
    cache["len"] = shape.seq_len - 1
    return Cell("decode", make_decode_step(cfg),
                (params, cache, block(specs["tokens"], b_sh["tokens"].spec)),
                mode)
