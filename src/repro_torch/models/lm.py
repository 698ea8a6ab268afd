"""The decoder LM (port of `repro/models/lm.py`): one class for every
family of `repro`'s registry.

  dense / moe : a pre-norm transformer -- GQA attention and a gated (or
      plain gelu) MLP, or the MoE layer (`models/moe.py`), per block.
  audio / vlm : the dense transformer fed embeddings: with
      `cfg.embed_input`, `forward`, `loss` and `prefill` take (B, S, D)
      embeddings (the stub frontends' frames or patches) cast to the
      compute dtype, and `decode_step` embeds its tokens through
      `params["embed"]`, as `repro`'s does.
  ssm    : RWKV6 (time-mix + channel-mix blocks, `models/ssm.py`).
  hybrid : Zamba2 -- Mamba2 blocks, with one SHARED-weight attention
      block before each group of `attn_every` Mamba blocks.

Params are `repro`'s tree -- the blocks STACKED on a leading layer axis,
plus `shared_attn` for the hybrid -- so `repro`'s params copy across
unchanged (`convert.params_from_numpy`); `lax.scan` over the layers
becomes a Python loop over that axis.  The hybrid's shared block is the
same tensors in every group, so autograd sums its gradients over the
groups.

Training: `forward` runs each block (each attention block and each Mamba
block of the hybrid) under `torch.utils.checkpoint` when `cfg.remat ==
"full"`, and `loss` is `repro`'s: the chunked cross-entropy plus 0.01 *
the MoE aux loss summed over layers.

The cache: dense and moe {"k", "v": (L, B, max_len, Hk, D) in the compute
dtype}, or with `cfg.kv_quant` int8 codes and fp32 "k_scale", "v_scale"
(L, B, max_len, Hk); ssm {"x_prev_t", "x_prev_c": (L, B, 1, D), "state":
(L, B, H, dk, dk) fp32}; hybrid {"conv": (G, per, B, K-1, C), "state":
(G, per, B, H, n, dh) fp32, "k", "v": (G, B, max_len, Hk, D)}; each with
"len", the positions filled, a Python int.  `decode_step` writes every
entry IN PLACE; the cache it returns shares the buffers.

The graph form of the decode step: "len" may instead be a 0-d int32
tensor on the cache's device (`repro`'s own type), with a static
`extent` (a bucket of positions) given to `decode_step`.  The step then
reads the length on the device only -- RoPE positions, `index_copy_`
writes, the split attention over cache[:, :extent]
(`layers.attention_decode_len`) -- and advances it in place, so one
CUDA graph per bucket replays every step of it
(`serve/decode_graph.py`).  Off a mesh only.

On a mesh (params laid out by `parallel.sharding.tree_shardings`) every
family and the int8 cache run through `MeshPlan` (`models/layers.py`),
the MoE (`models/moe.py`) and the SSM blocks (`models/ssm.py`) on each
rank's blocks; the cache is `Sharded` in `launch.steps.cache_pspecs`'
layout.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding as sh


def _tf_block_init(generator: torch.Generator, cfg: ModelConfig):
    p = {"ln1": L.rmsnorm_init(cfg.d_model),
         "attn": L.attention_init(generator, cfg),
         "ln2": L.rmsnorm_init(cfg.d_model)}
    if cfg.n_experts:
        p["moe"] = M.moe_init(generator, cfg)
    else:
        p["mlp"] = L.mlp_init(generator, cfg)
    return p


def _norm(p, x, cfg: ModelConfig, plan=None):
    """rmsnorm by the block's scale (on a mesh, `plan.norm`'s whole
    scale)."""
    return L.rmsnorm(plan.norm(p) if plan else p, x, cfg.norm_eps)


def _ffn(p, hin, cfg: ModelConfig, plan=None):
    """The block's MLP or MoE on normed input -> (out, aux).  A decode
    step (S == 1) routes over the batch: its B tokens are one group (on a
    mesh gathered over the batch axes first, since they compete for the
    same slots, routed whole on every rank, each rank keeping its block
    of the output; no gradient)."""
    if not cfg.n_experts:
        return L.mlp_block(p["mlp"], hin, cfg, plan), 0.0
    if hin.shape[1] != 1:
        return M.moe_block(p["moe"], hin, cfg, plan)
    if plan is None:
        h2, aux = M.moe_block(p["moe"], hin.transpose(0, 1), cfg)
        return h2.transpose(0, 1), aux
    tokens = sh.gather(hin, plan.mesh, plan.bp, 0).transpose(0, 1)
    h2, aux = M.moe_block(p["moe"], tokens, cfg,
                          dataclasses.replace(plan, bp=()))
    return sh.chunk(h2.transpose(0, 1), plan.mesh, plan.bp, 0), aux


def _tf_block_apply(p, x, cfg: ModelConfig, positions, plan=None):
    h, _ = L.attention_block(p["attn"], _norm(p["ln1"], x, cfg, plan), cfg,
                             positions, plan)
    x = x + h
    h2, aux = _ffn(p, _norm(p["ln2"], x, cfg, plan), cfg, plan)
    return x + h2, aux


def _rwkv_block_init(generator: torch.Generator, cfg: ModelConfig):
    return {"ln1": L.rmsnorm_init(cfg.d_model),
            "ln2": L.rmsnorm_init(cfg.d_model),
            "mix": S.rwkv6_init(generator, cfg)}


def _rwkv_block_apply(p, x, cfg: ModelConfig, positions, plan=None):
    del positions
    h, _, _ = S.rwkv6_time_mix(p["mix"], _norm(p["ln1"], x, cfg, plan), cfg,
                               plan=plan)
    x = x + h
    h2, _ = S.rwkv6_channel_mix(p["mix"], _norm(p["ln2"], x, cfg, plan), cfg,
                                plan=plan)
    return x + h2, 0.0


def _mamba_block_init(generator: torch.Generator, cfg: ModelConfig):
    return {"ln": L.rmsnorm_init(cfg.d_model),
            "mamba": S.mamba2_init(generator, cfg)}


def _mamba_block_apply(p, x, cfg: ModelConfig, positions, plan=None):
    del positions
    return x + S.mamba2_block(p["mamba"], _norm(p["ln"], x, cfg, plan), cfg,
                              plan), 0.0


_BLOCKS = {"dense": (_tf_block_init, _tf_block_apply),
           "moe": (_tf_block_init, _tf_block_apply),
           "audio": (_tf_block_init, _tf_block_apply),
           "vlm": (_tf_block_init, _tf_block_apply),
           "ssm": (_rwkv_block_init, _rwkv_block_apply),
           "hybrid": (_mamba_block_init, _mamba_block_apply)}


def _unbind(a) -> list:
    """A stacked leaf's layers: views of a tensor, or of a `Sharded`'s
    block (the stacked axis is never sharded) with the spec's tail."""
    if isinstance(a, sh.Sharded):
        return [sh.Sharded(t, a.mesh, a.spec[1:]) for t in a.local.unbind(0)]
    return a.unbind(0)


def _layers(blocks, n: int) -> list:
    """Every layer's params as views of the stacked leaves, taken by one
    `unbind` per leaf: the backward then stacks the layers' gradients
    once, where indexing layer by layer would scatter each into a zeroed
    copy of the whole stack."""
    cols = [_unbind(a) for a in L.tree_leaves(blocks)]

    def layer(i):
        it = iter([c[i] for c in cols])
        return L.tree_map(lambda _: next(it), blocks)

    return [layer(i) for i in range(n)]


def _aux_sum(auxes: list):
    """The MoE aux losses summed over layers in order (0.0 without any)."""
    auxes = [a for a in auxes if isinstance(a, torch.Tensor)]
    return torch.stack(auxes).sum() if auxes else 0.0


def _entry(c, *index):
    """The cache entry `c` (a tensor, or a `Sharded`) at a leading index
    (a layer, or a group and a block of it)."""
    if isinstance(c, sh.Sharded):
        return sh.Sharded(c.local[index], c.mesh, c.spec[len(index):])
    return c[index]


def _local(c):
    """This rank's block of a cache entry (the tensor itself off a
    mesh)."""
    return c.local if isinstance(c, sh.Sharded) else c


def _pad_cache(t, max_len: int):
    """(B,S,...) -> (B,max_len,...) zero-padded cache buffer: k, v or their
    int8 codes (B,S,H,D), or the codes' scales (B,S,H)."""
    S = t.shape[1]
    if S == max_len:
        return t
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, max_len - S))


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ModelConfig

    def __post_init__(self):
        cfg = self.cfg
        if cfg.family not in _BLOCKS:
            raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
        if cfg.family == "hybrid" and (
                not cfg.attn_every or cfg.n_layers % cfg.attn_every):
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not "
                             f"groups of attn_every = {cfg.attn_every}")

    def _groups(self):
        """The hybrid's (groups, Mamba blocks per group)."""
        cfg = self.cfg
        return cfg.n_layers // cfg.attn_every, cfg.attn_every

    # -- init ---------------------------------------------------------------
    def init(self, generator: torch.Generator, device=None) -> Dict[str, Any]:
        """Random fp32 params of `repro`'s shapes and scales, drawn from
        `generator` on its own device (a CPU generator draws on the host,
        a CUDA one on the card), then moved to `device` (`None` = the
        card)."""
        dev = resolve_device(device)
        with torch.device(generator.device):
            tree = self.init_tree(generator)
        return L.tree_map(lambda t: t.to(dev), tree)

    def init_tree(self, generator: torch.Generator) -> Dict[str, Any]:
        """`init`'s params on the default device: under
        `with torch.device("meta")` the tree's shapes and dtypes alone,
        drawn and stored nowhere (`repro`'s `jax.eval_shape` of init)."""
        cfg = self.cfg
        params = {"embed": L.embedding_init(generator, cfg),
                  "final_norm": L.rmsnorm_init(cfg.d_model)}
        block_init = _BLOCKS[cfg.family][0]
        per_layer = [block_init(generator, cfg) for _ in range(cfg.n_layers)]
        params["blocks"] = L.tree_map(lambda *ls: torch.stack(ls),
                                      *per_layer)
        if cfg.family == "hybrid":
            params["shared_attn"] = _tf_block_init(generator, cfg)
        return params

    def _setup(self, params, batch: int):
        """(the params, the call's `MeshPlan`): off a mesh the params
        themselves and None."""
        mesh = sh.tree_mesh(params)
        if mesh is None:
            return params, None
        return self._mesh_setup(params, mesh, batch)

    def _embed(self, P, plan, inputs, embeddings: bool,
               whole_d: bool = False):
        """(tokens (B,S) through the table, or with `embeddings` the
        (B,S,D) embeddings themselves in the compute dtype -- on a mesh
        this rank's batch block --, the vocab block the head reads: None
        off a mesh)."""
        cfg = self.cfg
        if plan is not None:
            return self._embed_mesh(P, plan, inputs, embeddings, whole_d)
        if embeddings:
            return inputs.to(cfg.compute_dtype), None
        return L.embed(P["embed"], inputs, cfg), None

    def _logits(self, P, plan, vb, x):
        """The final norm and the head (fp32); on a mesh the whole logits
        on every rank."""
        x = _norm(P["final_norm"], x, self.cfg, plan)
        if plan is None:
            return L.logits_head(P["embed"], x, self.cfg)
        return L.logits_mesh(self._head_mesh(P, plan, vb), x, plan)

    # -- forward (training) --------------------------------------------------
    def forward(self, params, inputs, positions=None):
        """inputs: tokens (B,S) or, with `embed_input`, embeddings
        (B,S,D).  Returns (hidden (B,S,D), aux_loss); on a mesh, this
        rank's block of the batch (`MeshPlan.bp`) of the hidden states."""
        P, plan = self._setup(params, inputs.shape[0])
        x, _ = self._embed(P, plan, inputs, self.cfg.embed_input)
        return self._body(P, plan, x, positions)

    def _body(self, P, plan, x, positions=None):
        """(the blocks and the final norm, the aux losses summed).

        With `remat == "full"` each block -- and the hybrid's shared block
        before each group -- runs under `torch.utils.checkpoint`: only its
        input is kept, and the backward runs the block again.  (`repro`
        also fences the stashed input with `_diff_barrier`, an XLA
        optimization barrier against hoisting its bf16 -> f32 convert out
        of the layer scan; eager PyTorch hoists nothing, so it has no
        counterpart here.)"""
        cfg = self.cfg
        B, S_, _ = x.shape
        if positions is None:
            positions = torch.arange(S_, device=x.device)[None].expand(B, S_)
        elif plan is not None:
            positions = sh.local(positions, plan.mesh, (plan.bp or None, None))
        remat = cfg.remat == "full" and torch.is_grad_enabled()

        def run(apply, p, x):
            if remat:
                return checkpoint(apply, p, x, cfg, positions, plan,
                                  use_reentrant=False)
            return apply(p, x, cfg, positions, plan)

        apply = _BLOCKS[cfg.family][1]
        auxes = []
        for i, p in enumerate(_layers(P["blocks"], cfg.n_layers)):
            if cfg.family == "hybrid" and i % cfg.attn_every == 0:
                x, aux = run(_tf_block_apply, P["shared_attn"], x)
                auxes.append(aux)
            x, aux = run(apply, p, x)
            auxes.append(aux)
        return _norm(P["final_norm"], x, cfg, plan), _aux_sum(auxes)

    def loss(self, params, inputs, labels):
        """(nll + 0.01 * aux, {"nll", "aux"}); labels of -1 are masked."""
        cfg = self.cfg
        P, plan = self._setup(params, inputs.shape[0])
        x, vb = self._embed(P, plan, inputs, cfg.embed_input, whole_d=True)
        x, aux = self._body(P, plan, x)
        if plan is None:
            nll = L.chunked_xent(P["embed"], x, labels, cfg)
        else:
            labels = sh.local(labels, plan.mesh, (plan.bp or None, None))
            head = self._head_mesh(P, plan, vb, whole_d=True)
            nll = L.chunked_xent_mesh(head, x, labels, cfg, plan)
        return nll + 0.01 * aux, {"nll": nll, "aux": aux}

    # -- cache --------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=None, device=None,
                   mesh=None):
        """Zeros (`device="meta"`: shapes alone); with a `mesh`, each entry
        a `Sharded` in `cache_pspecs`' layout holding this rank's
        block."""
        cfg = self.cfg
        dt = dtype or cfg.compute_dtype
        dev = torch.device("meta") if device == "meta" else \
            resolve_device(device)
        if mesh is not None:
            like = self.init_cache(batch, max_len, dtype, device="meta")
            specs = self._cache_specs(mesh, batch, max_len, dtype)
            return {k: sh.Sharded(torch.zeros(
                tuple(n // sh._axis_size(mesh, e or None)
                      for n, e in zip(t.shape, specs[k])), dtype=t.dtype,
                device=dev), mesh, specs[k])
                for k, t in like.items() if k != "len"} | {"len": 0}
        if cfg.family == "ssm":
            H = cfg.d_model // cfg.ssm_head_dim
            prev = (cfg.n_layers, batch, 1, cfg.d_model)
            return {"x_prev_t": torch.zeros(prev, dtype=dt, device=dev),
                    "x_prev_c": torch.zeros(prev, dtype=dt, device=dev),
                    "state": torch.zeros((cfg.n_layers, batch, H,
                                          cfg.ssm_head_dim, cfg.ssm_head_dim),
                                         device=dev),
                    "len": 0}
        if cfg.family == "hybrid":
            G, per = self._groups()
            H = cfg.d_inner // cfg.ssm_head_dim
            C = cfg.d_inner + 2 * cfg.ssm_state
            kv = (G, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            return {"conv": torch.zeros((G, per, batch, cfg.ssm_conv - 1, C),
                                        dtype=dt, device=dev),
                    "state": torch.zeros((G, per, batch, H, cfg.ssm_state,
                                          cfg.ssm_head_dim), device=dev),
                    "k": torch.zeros(kv, dtype=dt, device=dev),
                    "v": torch.zeros(kv, dtype=dt, device=dev),
                    "len": 0}
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        if cfg.kv_quant:
            return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "k_scale": torch.zeros(shape[:-1], device=dev),
                    "v_scale": torch.zeros(shape[:-1], device=dev),
                    "len": 0}
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev),
                "len": 0}

    # -- prefill ------------------------------------------------------------
    def prefill(self, params, inputs, max_len: int):
        """Process a prompt (B,S) of tokens (or (B,S,D) embeddings with
        `embed_input`), return (last-token logits (B,1,V), cache holding
        positions 0..S-1).

        On a mesh every rank gets the whole logits, and the cache is
        `Sharded` blocks in `cache_pspecs`' layout: k / v (or their int8
        codes and scales) gathered over the head axes, cut to the cache's
        batch and sequence block; the SSM states of this rank's heads and
        the conv / token-shift inputs moved to the cache's batch block
        (the conv inputs' channels gathered, then cut to the cache's
        channel block)."""
        cfg = self.cfg
        P, plan = self._setup(params, inputs.shape[0])
        x, vb = self._embed(P, plan, inputs, cfg.embed_input)
        B, S_, _ = x.shape
        positions = torch.arange(S_, device=x.device)[None].expand(B, S_)
        if plan is not None:
            specs = self._cache_specs(plan.mesh, inputs.shape[0], max_len)
        ssm_heads = (plan.ssm or None) if plan is not None else None

        def put(name, t, heads=None):
            """t -- this rank's batch block, and `heads` on dim 1 -- in the
            cache entry's layout (itself off a mesh)."""
            if plan is None:
                return t
            src = (plan.bp or None, heads) + (None,) * (t.dim() - 2)
            return sh.relayout_local(t, src, specs[name][-t.dim():],
                                     plan.mesh)

        def kv(name, t):
            if plan is not None:
                t = sh.gather(t, plan.mesh, plan.att, 2)
            return put(name, _pad_cache(t, max_len))

        def tf(p, x):
            """A transformer block -> (x, its k, v)."""
            h, (kk, vv) = L.attention_block(
                p["attn"], _norm(p["ln1"], x, cfg, plan), cfg, positions,
                plan)
            x = x + h
            return x + _ffn(p, _norm(p["ln2"], x, cfg, plan), cfg,
                            plan)[0], kk, vv

        out = collections.defaultdict(list)
        layers = _layers(P["blocks"], cfg.n_layers)
        if cfg.family == "ssm":
            for p in layers:
                h, xt, st = S.rwkv6_time_mix(
                    p["mix"], _norm(p["ln1"], x, cfg, plan), cfg, plan=plan)
                x = x + h
                h2, xc = S.rwkv6_channel_mix(
                    p["mix"], _norm(p["ln2"], x, cfg, plan), cfg, plan=plan)
                x = x + h2
                out["x_prev_t"].append(put("x_prev_t", xt))
                out["x_prev_c"].append(put("x_prev_c", xc))
                out["state"].append(put("state", st, ssm_heads))
        elif cfg.family == "hybrid":
            G, per = self._groups()
            for g in range(G):
                x, kk, vv = tf(P["shared_attn"], x)
                out["k"].append(kv("k", kk))
                out["v"].append(kv("v", vv))
                for p in layers[g * per:(g + 1) * per]:
                    y, conv, st = S.mamba2_prefill(
                        p["mamba"], _norm(p["ln"], x, cfg, plan), cfg, plan)
                    x = x + y
                    out["conv"].append(put("conv", S.whole_channels(
                        conv, cfg, plan)))
                    out["state"].append(put("state", st, ssm_heads))
        else:
            for p in layers:
                x, kk, vv = tf(p, x)
                if cfg.kv_quant:
                    kk, k_scale = L.kv_quantize(kk)
                    vv, v_scale = L.kv_quantize(vv)
                out["k"].append(kv("k", kk))
                out["v"].append(kv("v", vv))
                if cfg.kv_quant:
                    out["k_scale"].append(kv("k_scale", k_scale))
                    out["v_scale"].append(kv("v_scale", v_scale))
        cache = {}
        for k, ts in out.items():
            t = torch.stack(ts)
            if k in ("conv", "state") and cfg.family == "hybrid":
                t = t.unflatten(0, self._groups())
            cache[k] = t if plan is None else \
                sh.Sharded(t.contiguous(), plan.mesh, specs[k])
        cache["len"] = S_
        return self._logits(P, plan, vb, x[:, -1:]), cache

    # -- decode -------------------------------------------------------------
    def decode_step(self, params, cache, tokens, extent: int | None = None):
        """tokens (B,1) -> (logits (B,1,V), cache with len + 1).  Every
        entry of `cache` is updated in place.  Tokens go through
        `params["embed"]` in every family, `embed_input` ones included.

        On a mesh the cache's `Sharded` blocks are written in place and
        every rank gets the whole logits.  The SSM blocks run on the
        cache's batch block (x moved there and back: a rank's heads meet
        their state where it lies, and no state moves).

        The graph form: with `cache["len"]` a 0-d int32 tensor, the
        attention reads the bucket cache[:, :extent] (`extent`, at least
        len + 1, defaults to the cache's max_len) and the length is
        advanced in place; the returned cache holds the same tensor."""
        cfg = self.cfg
        P, plan = self._setup(params, tokens.shape[0])
        clen = cache["len"]
        graph = isinstance(clen, torch.Tensor)
        if graph and plan is not None:
            raise ValueError("a device cache length runs off a mesh only "
                             "(the mesh's collectives are not captured)")
        if graph and extent is None and "k" in cache:
            extent = cache["k"].shape[-3]
        x, vb = self._embed(P, plan, tokens, False)
        layers = _layers(P["blocks"], cfg.n_layers)

        def attend(p, xin, *index):
            """The attention block's output for the cache entries at
            `index` (a layer, or a hybrid group)."""
            kv = (_entry(cache["k"], *index), _entry(cache["v"], *index))
            scales = (_entry(cache["k_scale"], *index),
                      _entry(cache["v_scale"], *index)) \
                if cfg.kv_quant and cfg.family != "hybrid" else None
            if graph:
                return L.attention_decode_len(p, xin, cfg, *kv, clen,
                                              extent, scales)
            if scales is not None:
                return L.attention_decode_quant(p, xin, cfg, *kv, *scales,
                                                clen, plan)[0]
            return L.attention_decode(p, xin, cfg, *kv, clen, plan)[0]
        splan = None
        if plan is not None and cfg.family in ("ssm", "hybrid"):
            # The SSM blocks' plan: x at the cache's batch block.
            splan = dataclasses.replace(
                plan, bp=sh._real(plan.mesh, cache["state"].spec[-4]))

        def to_cache(x, back=False):
            """x between the plan's batch block and the SSM cache's."""
            if plan is None:
                return x
            specs = ((plan.bp or None, None, None),
                     (cache["state"].spec[-4], None, None))
            return sh.relayout_local(x, *(specs[::-1] if back else specs),
                                     plan.mesh)

        def state(*index):
            """(this rank's heads of the state entry at `index`, a writer
            back)."""
            e = _entry(cache["state"], *index)
            if plan is None:
                return e, e.copy_
            mine = (e.spec[0], plan.ssm or None, None, None)

            def write(new):
                e.local.copy_(sh.relayout_local(new, mine, e.spec,
                                                plan.mesh))
            return sh.relayout_local(e.local, e.spec, mine, plan.mesh), write

        if cfg.family == "ssm":
            x = to_cache(x)
            xt_prev, xc_prev = _local(cache["x_prev_t"]), \
                _local(cache["x_prev_c"])
            for i, p in enumerate(layers):
                st, write = state(i)
                h, xt, st = S.rwkv6_time_mix_decode(
                    p["mix"], _norm(p["ln1"], x, cfg, plan), cfg,
                    xt_prev[i], st, plan=splan)
                x = x + h
                h2, xc = S.rwkv6_channel_mix(
                    p["mix"], _norm(p["ln2"], x, cfg, plan), cfg,
                    xc_prev[i], plan=splan)
                x = x + h2
                xt_prev[i] = xt
                xc_prev[i] = xc
                write(st)
            x = to_cache(x, back=True)
        elif cfg.family == "hybrid":
            sa = P["shared_attn"]
            G, per = self._groups()
            for g in range(G):
                x = x + attend(sa["attn"], _norm(sa["ln1"], x, cfg, plan), g)
                x = x + _ffn(sa, _norm(sa["ln2"], x, cfg, plan), cfg,
                             plan)[0]
                x = to_cache(x)
                for j, p in enumerate(layers[g * per:(g + 1) * per]):
                    st, write = state(g, j)
                    conv = _entry(cache["conv"], g, j)
                    y, new, st = S.mamba2_decode(
                        p["mamba"], _norm(p["ln"], x, cfg, plan), cfg, conv,
                        st, splan)
                    x = x + y
                    _local(conv).copy_(new)
                    write(st)
                x = to_cache(x, back=True)
        else:
            for i, p in enumerate(layers):
                x = x + attend(p["attn"], _norm(p["ln1"], x, cfg, plan), i)
                x = x + _ffn(p, _norm(p["ln2"], x, cfg, plan), cfg, plan)[0]
        if graph:
            clen.add_(1)
        return self._logits(P, plan, vb, x), \
            dict(cache, len=clen if graph else clen + 1)

    # -- on a mesh ------------------------------------------------------------
    # The params are DTensors or `Sharded`s (laid out by `tree_shardings`,
    # training or serve layout), the inputs DTensors over the batch or
    # plain tensors whole on every rank.  Every rank runs the same ops on
    # its blocks (`models/layers.py::MeshPlan`); per layer a forward
    # issues: the gathers of its weights over the axes they are stored on
    # but not split by (the FSDP axes of the training layout; none in the
    # serve layout), one all-reduce after wo and one after the MLP's wo
    # (over the head / hidden axes); the backward adds one all-reduce
    # before each (`copy_to`) and one per weight over the batch axes.  A
    # decode step adds one gather of q, k, v over the head axes and the
    # combine's MAX and SUM all-reduces over the cache's sequence axes.
    # A MoE layer issues the aux loss's two all-reduces over the batch
    # axes and its combine's over the expert axes (a decode step first
    # gathers its tokens over the batch axes); an SSM block its gated
    # norm's and wo's all-reduces over the head axes (a Mamba2 decode
    # step gathers its conv window and its new conv inputs too).
    # `repro`'s activation constraints hold as block layouts: its
    # `shard(x, "dp", None, None)` (`repro/models/lm.py:78,153,270`) is the
    # batch block `_embed_mesh` takes, its q / k / v and MLP hidden
    # `shard(.., "dp", None, "tp", ..)` (`repro/models/layers.py:159-161,
    # 281`) are this rank's heads and columns of that block, and its MoE
    # `disp`, `xe` and `h` over "tp" on E (`repro/models/moe.py:84-92`)
    # are this rank's experts.

    def _mesh_setup(self, params, mesh, batch: int):
        """(the params as `Sharded`s, the call's `MeshPlan`)."""
        P = L.tree_map(lambda t: sh.as_sharded(t, mesh), params)
        return P, self._mesh_plan(P, mesh, batch)

    def _mesh_plan(self, P, mesh, batch: int) -> L.MeshPlan:
        """Read from the params' layout: the heads over the leading axes
        of wq's columns that divide the kv heads; the MLP's (or the shared
        experts') hidden columns over wi's axes; the experts over
        experts_wi's E axes and their hidden columns over its F axes; the
        SSM heads over wo's / out_proj's row axes where they are
        `cache_pspecs`' state-head axes; the batch over the data axes none
        of those use, nor wq's columns or wo's / out_proj's rows (the
        serve layout folds the data axes into them: its weights stay
        where they lie and the batch is whole), and that divide
        `batch`."""
        cfg = self.cfg
        b = P["blocks"]
        tf = P["shared_attn"] if cfg.family == "hybrid" else b
        att = ()
        if "attn" in tf:
            cols = sh._real(mesh, tf["attn"]["wq"].spec[-1])
            att = next((cols[:i] for i in range(len(cols), 0, -1)
                        if cfg.n_kv_heads % sh._axis_size(mesh, cols[:i])
                        == 0), ())
        wi = tf["mlp"]["wi"] if "mlp" in tf else \
            b.get("moe", {}).get("shared_wi")
        mlp = sh._real(mesh, wi.spec[-1]) if wi is not None else ()
        ep = eff = ssm = tp = ()
        if "attn" in tf:
            tp = sh._real(mesh, tf["attn"]["wq"].spec[-1])
        if "moe" in b:
            ep = sh._real(mesh, b["moe"]["experts_wi"].spec[-3])
            eff = sh._real(mesh, b["moe"]["experts_wi"].spec[-1])
        if cfg.family in ("ssm", "hybrid"):
            wo, H = (b["mix"]["wo"], cfg.d_model // cfg.ssm_head_dim) \
                if cfg.family == "ssm" else \
                (b["mamba"]["out_proj"], cfg.d_inner // cfg.ssm_head_dim)
            heads = sh._real(mesh, sh.logical_axes(mesh)["tp"])
            tp += sh._real(mesh, wo.spec[-2])
            if tp[:len(heads)] == heads and \
                    H % sh._axis_size(mesh, heads or None) == 0:
                ssm = heads
        vocab = sh._real(mesh, P["embed"]["tok"].spec[0])
        dp = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
        bp = tuple(a for a in sh._real(mesh, dp)
                   if a not in tp + att + mlp + vocab + ssm)
        if batch % sh._axis_size(mesh, bp or None):
            bp = ()
        return L.MeshPlan(mesh, bp, att, mlp, ep,
                          tuple(a for a in eff if a not in bp), ssm)

    def _embed_mesh(self, P, plan, inputs, embeddings: bool = False,
                    whole_d: bool = False):
        """(this rank's batch block of the embedded tokens -- or, with
        `embeddings`, of the (B, S, D) embeddings themselves in the
        compute dtype (`repro`'s `shard(x, "dp", None, None)`) -- the
        vocab block the tied head reads, or None; `whole_d`: the loss's,
        its columns whole)."""
        cfg = self.cfg
        if embeddings:
            x = sh.local(inputs, plan.mesh, (plan.bp or None, None, None))
            vb = L.vocab_block(P["embed"]["tok"], plan, whole_d=whole_d) \
                if cfg.tie_embeddings else None
            return x.to(cfg.compute_dtype), vb
        tokens = sh.local(inputs, plan.mesh, (plan.bp or None, None))
        vb = L.vocab_block(P["embed"]["tok"], plan, whole_d=whole_d)
        return L.embed_mesh(vb, tokens, cfg, plan), vb

    def _head_mesh(self, P, plan, vb, whole_d: bool = False):
        if self.cfg.tie_embeddings:
            return vb
        return L.vocab_block(P["embed"]["head"], plan, vocab_dim=1,
                             whole_d=whole_d)

    def _cache_specs(self, mesh, batch: int, max_len: int,
                     dtype=None) -> dict:
        """`cache_pspecs` of the family's cache."""
        from repro_torch.launch.steps import cache_pspecs
        return cache_pspecs(self.init_cache(batch, max_len, dtype,
                                            device="meta"), mesh)
