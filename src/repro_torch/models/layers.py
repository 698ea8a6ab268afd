"""Shared layers (port of `repro/models/layers.py`): the parameter-tree
helpers the conv models' functional training steps need, and the dense
transformer's layers -- norms, rope, GQA attention (prefill and decode
over a KV cache), MLPs, embeddings and the chunked cross-entropy head.

A tree is nested dicts, lists and tuples with tensors at the leaves, as
the models' params are.  The transformer layers take params as dicts of
tensors (fp32) and compute in the input's dtype, as `repro` does.  On a
CUDA tensor attention runs `ops.flash_attention`, the hand-written
kernel; on a CPU tensor, the plain PyTorch mirror of `repro`'s code.
The int8 KV cache's quantize / dequantize and its decode attention
(`attention_decode_quant`) serve `LM` with `kv_quant`.  Both decode
attentions take the cache length as a Python int; `attention_decode_len`
is their graph form, which takes it as a 0-d int32 tensor on the cache's
device and reads nothing back to the host (`serve/decode_graph.py`
captures it in a CUDA graph).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.kernels.attention import NEG_INF
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import is_dtensor


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


def tree_paths(tree, prefix: str = "") -> list:
    """(path, leaf) pairs in `jax.tree_util.tree_flatten`'s order: dict
    keys SORTED, then sequences in order.  Each path is the string
    `jax.tree_util.keystr` gives the same leaf, e.g. "['convs'][0]"."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_all_finite(*trees) -> torch.Tensor:
    """0-d bool tensor: every floating leaf of every tree is finite.
    Integer leaves (labels, counters) are skipped.  One device reduction
    per leaf and none to the host: the flag stays on the leaves' device
    until the caller reads it, so a step that returns it can be captured
    in a CUDA graph (as `repro`'s stays inside its jit).  A tree with no
    floating leaf gives `torch.tensor(True)`."""
    leaves = [leaf for tree in trees for leaf in tree_leaves(tree)
              if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()]
    if any(is_dtensor(leaf) for leaf in leaves):
        return _mesh_all_finite(leaves)
    flags = [torch.isfinite(leaf).all() for leaf in leaves]
    return torch.stack(flags).all() if flags else torch.tensor(True)


def _mesh_all_finite(leaves) -> torch.Tensor:
    """`tree_all_finite` over DTensor leaves: each rank checks its own
    blocks, and the count of non-finite blocks is summed over every axis
    of each mesh, so every rank gets the same flag."""
    from repro_torch.parallel.sharding import psum
    bad = torch.stack([(~torch.isfinite(leaf.to_local() if is_dtensor(
        leaf) else leaf).all()).float() for leaf in leaves]).sum()
    meshes = {id(leaf.device_mesh): leaf.device_mesh for leaf in leaves
              if is_dtensor(leaf)}
    for mesh in meshes.values():
        psum(bad, mesh, tuple(mesh.mesh_dim_names))
    return bad == 0


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


# ---------------------------------------------------------------------------
# The dense transformer's layers
# ---------------------------------------------------------------------------

def _init(generator: torch.Generator, shape, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return trunc_normal(generator, shape, scale)


def rmsnorm_init(d):
    return {"scale": torch.zeros((d,), dtype=torch.float32)}


def rmsnorm(params, x, eps=1e-6):
    """The sum of squares in fp32; x keeps its dtype, scaled by
    rsqrt(mean + eps) * (1 + scale)."""
    xf = x.float()
    var = (xf * xf).sum(dim=-1, keepdim=True) / x.shape[-1]
    scale = torch.rsqrt(var + eps) * (1.0 + params["scale"])
    return x * scale.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x (B,S,H,D), positions (B,S) -> x rotated by split halves."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    ang = positions[..., None].float() * freqs           # (B,S,D/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention_init(generator: torch.Generator, cfg: ModelConfig):
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {
        "wq": _init(generator, (d, qd)),
        "wk": _init(generator, (d, kvd)),
        "wv": _init(generator, (d, kvd)),
        "wo": _init(generator, (qd, d), scale=1.0 / math.sqrt(qd)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((qd,), dtype=torch.float32)
        p["bk"] = torch.zeros((kvd,), dtype=torch.float32)
        p["bv"] = torch.zeros((kvd,), dtype=torch.float32)
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(cfg.head_dim)
        p["k_norm"] = rmsnorm_init(cfg.head_dim)
    return p


def _qkv(params, x, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    dt = x.dtype
    q = x @ params["wq"].to(dt)
    k = x @ params["wk"].to(dt)
    v = x @ params["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = q.reshape(B, S, -1, cfg.head_dim)      # the heads the weights hold
    k = k.reshape(B, S, -1, cfg.head_dim)
    v = v.reshape(B, S, -1, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def flash_attention(q, k, v, *, causal: bool = True, chunk: int = 1024,
                    q_offset: int = 0):
    """Online-softmax attention that never materializes S x S scores.

    q (B,Sq,Hq,D), k/v (B,Sk,Hk,D) with Hq % Hk == 0.  `q_offset` is the
    absolute position of q[0] relative to k[0].  On the card: one launch
    of the flash-attention kernel.  On the CPU: the recurrence over kv
    chunks of `chunk` keys."""
    return ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                               blk_k=chunk)


def attention_block(params, x, cfg: ModelConfig, positions,
                    plan: Optional["MeshPlan"] = None):
    """Training / prefill attention.  Returns (out, (k, v)) for caching.

    With a `plan` (the LM on a mesh: params are `Sharded`, x this rank's
    batch block) q, k and v are this rank's heads -- Hq / |att| and
    Hk / |att|, whole GQA groups -- and the attention is one kernel launch
    on them; (k, v) are the rank's heads."""
    if plan is not None:
        params = plan.attention_weights(params)
        x = sh.copy_to(x, plan.mesh, plan.att)
    q, k, v = _qkv(params, x, cfg, positions)
    out = flash_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    B, S, _, _ = out.shape
    out = out.reshape(B, S, -1)
    if plan is not None:
        return plan.row_parallel(out, params["wo"], plan.att), (k, v)
    return out @ params["wo"].to(x.dtype), (k, v)


def attention_decode(params, x, cfg: ModelConfig, cache_k, cache_v,
                     cache_len: int, plan: Optional["MeshPlan"] = None):
    """Decode against a KV cache: x (B,S,D) are the tokens at positions
    cache_len .. cache_len + S - 1; cache_k/v (B,Smax,Hk,D).

    Writes the new k and v into cache_k / cache_v IN PLACE (at
    cache_len) and returns (out, cache_k, cache_v).  On the card the
    attention is one kernel launch over the live prefix
    cache[:, :cache_len + S], a strided view of the cache, with q_offset
    = cache_len; on the CPU, `repro`'s masked softmax over the whole
    cache (the query rounded to the cache's dtype before the scores, the
    probabilities before the values).  With a `plan` the cache is
    `Sharded` in `cache_pspecs`' layout: `_attention_decode_mesh`."""
    B, S, _ = x.shape
    Smax = cache_k.shape[1]
    if cache_len + S > Smax:
        raise ValueError(f"cache of {Smax} positions cannot take positions "
                         f"{cache_len}..{cache_len + S - 1}")
    at = cache_len + torch.arange(S, device=x.device)
    if plan is not None:
        return _attention_decode_mesh(params, x, cfg, cache_k, cache_v,
                                      cache_len, at[None, :].expand(B, S),
                                      plan)
    q = _decode_write(params, x, cfg, cache_k, cache_v, None, at)
    if x.device.type == "cuda":
        out = _decode_attend(q, cache_k, cache_v, None, cache_len + S,
                             q_offset=cache_len)
    else:
        g = cfg.n_heads // cfg.n_kv_heads
        qf = (q.float() * cfg.head_dim ** -0.5).to(cache_k.dtype)
        qf = qf.reshape(B, S, cfg.n_kv_heads, g, cfg.head_dim)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf.float(), cache_k.float())
        k_pos = torch.arange(Smax, device=x.device)[None, :]
        q_pos = (cache_len + torch.arange(S, device=x.device))[:, None]
        s = torch.where((k_pos <= q_pos)[None, :, None, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bqhgk,bkhd->bqhgd", p.to(cache_v.dtype).float(),
                           cache_v.float())
    out = out.reshape(B, S, cfg.q_dim).to(x.dtype)
    return out @ params["wo"].to(x.dtype), cache_k, cache_v


def attention_decode_len(params, x, cfg: ModelConfig, cache_k, cache_v,
                         cache_len: torch.Tensor, extent: int, scales=None):
    """The graph form of `attention_decode` (and, with `scales` =
    (k_scale, v_scale), of `attention_decode_quant`): `cache_len` is a
    0-d int32 tensor on the cache's device -- `repro`'s traced scalar --
    and `extent` a static bucket of at least cache_len + S positions.

    RoPE positions come from the tensor, the cache is written at them
    (`_decode_write`: `index_copy_`, `repro`'s `dynamic_update_slice`),
    and the attention reads the device length over the fixed view
    cache[:, :extent] (`_decode_attend`).  Every shape is fixed by
    `extent`, and nothing is read back to the host, so the same call can
    be captured once and replayed at every length of its bucket.
    `cache_len` is not advanced here (`LM.decode_step` does it once per
    step).  Returns the output projection (B, S, D)."""
    B, S, _ = x.shape
    if extent > cache_k.shape[1]:
        raise ValueError(f"extent {extent} past the cache's "
                         f"{cache_k.shape[1]} positions")
    at = cache_len.to(torch.int64) + torch.arange(S, device=x.device)
    q = _decode_write(params, x, cfg, cache_k, cache_v, scales, at)
    out = _decode_attend(q, cache_k, cache_v, scales, extent,
                         length=cache_len)
    out = out.reshape(B, S, cfg.q_dim).to(x.dtype)
    return out @ params["wo"].to(x.dtype)


def _decode_write(params, x, cfg: ModelConfig, cache_k, cache_v, scales,
                  at: torch.Tensor) -> torch.Tensor:
    """The decode's q, k and v of x (B, S, D) at the positions `at` (S,)
    on x's device; k and v -- or, with `scales` = (k_scale, v_scale),
    their int8 codes and scales -- written into the cache IN PLACE at
    `at` by `index_copy_`.  Returns q."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg, at[None, :].expand(B, S))
    if scales is None:
        cache_k.index_copy_(1, at, k.to(cache_k.dtype))
        cache_v.index_copy_(1, at, v.to(cache_v.dtype))
    else:
        for codes, scale, new in ((cache_k, scales[0], k),
                                  (cache_v, scales[1], v)):
            new_codes, new_scale = kv_quantize(new)
            codes.index_copy_(1, at, new_codes)
            scale.index_copy_(1, at, new_scale)
    return q


def _decode_attend(q, cache_k, cache_v, scales, extent: int, **where):
    """The card's decode attention of q over the view cache[:, :extent]:
    q rounded to the cache's dtype, or, for an int8 cache (`scales`), the
    view dequantized to fp32 and q in fp32 (`repro` does not round it).
    `where` is the kernel's query position: `q_offset=` an int, or
    `length=` the device length."""
    if scales is None:
        q, kb, vb = q.to(cache_k.dtype), cache_k[:, :extent], \
            cache_v[:, :extent]
    else:
        q = q.float()
        kb, vb = (kv_dequantize(c[:, :extent], sc[:, :extent], torch.float32)
                  for c, sc in ((cache_k, scales[0]), (cache_v, scales[1])))
    return ops.flash_attention(q, kb, vb, causal=True, **where)


# ---------------------------------------------------------------------------
# int8 KV-cache quantization (serving)
# ---------------------------------------------------------------------------

def kv_quantize(k: torch.Tensor):
    """(.., S, H, D) -> (int8 codes (.., S, H, D), fp32 scales (.., S, H)).
    Per (position, head) max-abs scaling: scale = max(amax, 1e-6) / 127,
    codes round(k / scale) (half to even, as `jnp.round`) clipped to
    +-127."""
    kf = k.float()
    scale = torch.clamp_min(kf.abs().amax(dim=-1), 1e-6) / 127.0
    q = torch.clamp(torch.round(kf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """codes (.., S, H, D) times their scales (.., S, H), in fp32, cast to
    `dtype`."""
    return (q.float() * scale[..., None]).to(dtype)


def attention_decode_quant(params, x, cfg: ModelConfig, cache_k, cache_v,
                           k_scale, v_scale, cache_len: int,
                           plan: Optional["MeshPlan"] = None):
    """`attention_decode` against an int8 KV cache: cache_k/v (B,Smax,Hk,D)
    int8, k_scale/v_scale (B,Smax,Hk) fp32.  With a `plan` the four are
    `Sharded` in `cache_pspecs`' layout: `_attention_decode_mesh`.

    Quantizes the new k and v and writes codes and scales IN PLACE at
    cache_len; returns (out, cache_k, cache_v, k_scale, v_scale).  On the
    card the live prefix cache[:, :cache_len + S] is dequantized to fp32
    and the attention is one kernel launch on it with q_offset =
    cache_len (the query in fp32: `repro` does not round it to the
    cache's dtype).  On the CPU, `repro`'s arithmetic: scores on the
    codes cast to fp32, times k_scale; the probabilities times v_scale
    before P.V."""
    B, S, _ = x.shape
    Smax = cache_k.shape[1]
    if cache_len + S > Smax:
        raise ValueError(f"cache of {Smax} positions cannot take positions "
                         f"{cache_len}..{cache_len + S - 1}")
    at = cache_len + torch.arange(S, device=x.device)
    scales = (k_scale, v_scale)
    if plan is not None:
        return _attention_decode_mesh(params, x, cfg, cache_k, cache_v,
                                      cache_len, at[None, :].expand(B, S),
                                      plan, scales=scales)
    q = _decode_write(params, x, cfg, cache_k, cache_v, scales, at)
    if x.device.type == "cuda":
        out = _decode_attend(q, cache_k, cache_v, scales, cache_len + S,
                             q_offset=cache_len)
    else:
        g = cfg.n_heads // cfg.n_kv_heads
        qf = (q.float() * cfg.head_dim ** -0.5).reshape(
            B, S, cfg.n_kv_heads, g, cfg.head_dim)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, cache_k.float())
        s = s * k_scale.transpose(1, 2)[:, None, :, None, :]
        k_pos = torch.arange(Smax, device=x.device)[None, :]
        q_pos = (cache_len + torch.arange(S, device=x.device))[:, None]
        s = torch.where((k_pos <= q_pos)[None, :, None, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        pv = p * v_scale.transpose(1, 2)[:, None, :, None, :]
        out = torch.einsum("bqhgk,bkhd->bqhgd", pv, cache_v.float())
    out = out.reshape(B, S, cfg.q_dim).to(x.dtype)
    return out @ params["wo"].to(x.dtype), cache_k, cache_v, k_scale, v_scale


def mlp_init(generator: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "gelu":
        return {"wi": _init(generator, (d, f)), "wo": _init(generator, (f, d))}
    return {"wi": _init(generator, (d, f)), "wg": _init(generator, (d, f)),
            "wo": _init(generator, (f, d))}


def _gelu(t):
    """`jax.nn.gelu`'s default, the tanh approximation."""
    return F.gelu(t, approximate="tanh")


def mlp_block(params, x, cfg: ModelConfig,
              plan: Optional["MeshPlan"] = None):
    """The MLP.  With a `plan`: wi / wg split by column and wo by row over
    the plan's `mlp` axes, then one all-reduce over them."""
    if plan is not None:
        params = {k: plan.column(w, plan.mlp) if k != "wo" else w
                  for k, w in params.items()}
        x = sh.copy_to(x, plan.mesh, plan.mlp)
    dt = x.dtype
    if cfg.act == "gelu":
        h = _gelu(x @ params["wi"].to(dt))
    else:
        gate_fn = F.silu if cfg.act == "swiglu" else _gelu
        h = gate_fn(x @ params["wg"].to(dt)) * (x @ params["wi"].to(dt))
    if plan is not None:
        return plan.row_parallel(h, params["wo"], plan.mlp)
    return h @ params["wo"].to(dt)


def embedding_init(generator: torch.Generator, cfg: ModelConfig):
    p = {"tok": _init(generator, (cfg.vocab, cfg.d_model), scale=1.0)}
    if not cfg.tie_embeddings:
        p["head"] = _init(generator, (cfg.d_model, cfg.vocab))
    return p


def embed(params, tokens, cfg: ModelConfig):
    """The rows of `tokens`, cast after the gather (the same values as
    `repro`'s cast table, without casting the whole table)."""
    return params["tok"][tokens.long()].to(cfg.compute_dtype)


def logits_head(params, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return (x @ params["tok"].t().to(x.dtype)).float()
    return (x @ params["head"].to(x.dtype)).float()


def _chunk_loss(params, xb, lb, cfg: ModelConfig):
    """(sum of the chunk's nll, its count of labels >= 0)."""
    logits = logits_head(params, xb, cfg)                 # (B,c,V) fp32
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lb.clamp_min(0).long()[..., None])[..., 0]
    valid = (lb >= 0).float()
    return ((logz - gold) * valid).sum(), valid.sum()


def chunked_xent(params, x, labels, cfg: ModelConfig):
    """Mean cross-entropy over the labels >= 0 (-1 masks a position)
    without the (B,S,V) logits: chunks of `cfg.loss_chunk` positions,
    each under `torch.utils.checkpoint`, so one chunk's fp32 logits exist
    at a time and the backward recomputes them.  The sums run in chunk
    order, as `repro`'s scan carries them."""
    B, S, _ = x.shape
    c = min(cfg.loss_chunk, S)
    nc = -(-S // c)
    pad = nc * c - S
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(nc):
        nll, n = checkpoint(_chunk_loss, params, x[:, i * c:(i + 1) * c],
                            labels[:, i * c:(i + 1) * c], cfg,
                            use_reentrant=False)
        tot = tot + nll
        cnt = cnt + n
    return tot / torch.clamp_min(cnt, 1.0)


# ---------------------------------------------------------------------------
# The LM on a device mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """How one LM call lays its ops out on `mesh` (`LM._mesh_plan` makes
    it from the params' layout).  Every rank runs the same ops on its own
    blocks; the activations between ops are this rank's block of the
    batch over `bp`, whole over every other axis.

      bp    : the batch axes of the activations (the data axes in the
              training layout; none in the serve layout, whose weights
              fold the data axes into tensor parallelism);
      att   : the axes the attention heads split over (the leading axes
              of wq's columns whose size divides the kv heads, so each
              rank keeps whole GQA groups);
      mlp   : the axes the MLP's hidden columns split over (wi's; the MoE's
              shared experts');
      ep    : the axes the MoE's experts split over (experts_wi's E);
      eff   : the axes each expert's hidden columns split over (experts_wi's
              F, less the batch axes: where F shares an axis with the
              batch, as `moe_ffn_data`'s does, F is gathered at use);
      ssm   : the axes the SSM heads (RWKV6's, Mamba2's) split over: those
              of wo's / out_proj's rows that `cache_pspecs` splits the
              state's heads over, so a rank's heads meet its state block.

    A weight is moved to the block its op needs by `sharding.fetch`
    (all-gathers over its other axes: FSDP's gather at use), in the dtype
    it was cast to before; its gradient is summed over `bp` (a
    reduce-scatter).  Column-split ops take their input through
    `sharding.copy_to` and row-split ones end in `row_parallel`'s
    all-reduce (Megatron's f and g)."""
    mesh: object
    bp: tuple
    att: tuple
    mlp: tuple
    ep: tuple = ()
    eff: tuple = ()
    ssm: tuple = ()

    def column(self, w, axes):
        """w (.., d, n): every row, the columns over `axes`."""
        return sh.fetch(w, (None,) * (w.dim() - 1) + (axes or None,),
                        self.bp)

    def row(self, w, axes):
        """w (.., n, d): the rows over `axes`, every column."""
        return sh.fetch(w, (None,) * (w.dim() - 2) + (axes or None, None),
                        self.bp)

    def replicated(self, w, also=()):
        """w whole; its gradient also summed over `also` (the axes whose
        ranks used it on other parts, e.g. other heads)."""
        return sh.fetch(w, (None,) * w.dim(), self.bp + tuple(also))

    def norm(self, p):
        """A norm's params: the scale whole (its gradient over `bp`)."""
        return {"scale": self.replicated(p["scale"])}

    def attention_weights(self, params):
        """This rank's heads of every attention weight: wq / wk / wv by
        column and their biases over `att`, wo's rows (Sharded), the
        qk-norm scales whole (their gradient over `bp` and `att`)."""
        out = {}
        for k, w in params.items():
            if k in ("wq", "wk", "wv"):
                out[k] = self.column(w, self.att)
            elif k in ("bq", "bk", "bv"):
                out[k] = sh.fetch(w, (self.att or None,), self.bp)
            elif k in ("q_norm", "k_norm"):
                out[k] = {"scale": self.replicated(w["scale"], self.att)}
            else:
                out[k] = w
        return out

    def row_parallel(self, h, wo, axes):
        """h (this rank's columns) @ its rows of `wo`, summed over `axes`
        by one all-reduce.  Where the sum is real the partial products
        are fp32 and the sum is rounded to h's dtype once, as the one
        matmul of a single device rounds it."""
        w = self.row(wo, axes)
        if not sh._real(self.mesh, axes):
            return h @ w.to(h.dtype)
        return sh.reduce_from(h.float() @ w.float(), self.mesh,
                              axes).to(h.dtype)


@dataclasses.dataclass(frozen=True)
class VocabBlock:
    """This rank's part of the vocab matrix (the tied `tok`, or the
    untied head transposed): rows [lo, lo + w.shape[0]) of the vocab
    over the axes `vax`, and its columns over `dax` (none when they were
    gathered: the training layout's gradients) -- shared by the token
    lookup and the logits of one call.  `bx`: the batch axes among `dax`
    (the training layout with no gradient), over which the ops gather
    the activations rather than the block."""
    w: torch.Tensor
    lo: int
    vax: tuple
    dax: tuple
    bx: tuple = ()


def vocab_block(w, plan: MeshPlan, *, vocab_dim: int = 0,
                whole_d: bool = False) -> VocabBlock:
    """The vocab block of `w` (Sharded (V, d), or (d, V) with
    `vocab_dim=1`) for `plan`: its columns gathered with `whole_d` (the
    loss) or where their axes carry other batch blocks and a gradient
    will flow (FSDP), else left split (the ops then split d and
    all-reduce, gathering the few activations they need over the batch
    axes among the columns' axes); the vocab rows stay split over every
    axis that is not a batch axis."""
    d_dim = 1 - vocab_dim
    vax = tuple(a for a in sh._real(plan.mesh, w.spec[vocab_dim])
                if a not in plan.bp)
    dax = sh._real(plan.mesh, w.spec[d_dim])
    bx = tuple(a for a in dax if a in plan.bp)
    if whole_d or (bx and torch.is_grad_enabled()):
        dax = bx = ()
    want = [None, None]
    want[vocab_dim], want[d_dim] = vax or None, dax or None
    blk = sh.fetch(w, tuple(want), plan.bp)
    if vocab_dim == 1:
        blk = blk.t()
    return VocabBlock(blk, sh.block_index(plan.mesh, vax) * blk.shape[0],
                      vax, dax, bx)


def embed_mesh(vb: VocabBlock, tokens, cfg: ModelConfig, plan: MeshPlan):
    """`embed` on this rank's vocab rows: each token's row where this rank
    holds it, zeros elsewhere, summed over `vax` (one all-reduce; exact,
    one term is not zero), then the columns gathered over `dax` (with
    `bx`, for the tokens gathered over it, then cut to this rank's
    batch block)."""
    m = plan.mesh
    rows = sh.gather(tokens, m, vb.bx, 0).long() - vb.lo
    ok = (rows >= 0) & (rows < vb.w.shape[0])
    e = vb.w[rows.clamp(0, vb.w.shape[0] - 1)].to(cfg.compute_dtype)
    e = sh.reduce_from(torch.where(ok[..., None], e, 0), m, vb.vax)
    return sh.chunk(sh.gather(e, m, vb.dax, -1), m, vb.bx, 0)


def logits_mesh(vb: VocabBlock, x, plan: MeshPlan):
    """The whole logits (B, S, V) in fp32, the same on every rank, for x
    this rank's batch block (no gradient): this rank's vocab rows (with
    `dax`, its columns of x -- gathered over `bx` first -- against its
    columns of the block, fp32 sums over `dax`, rounded to x's dtype
    once as one matmul rounds), then gathered over `vax` and the batch
    over `bp`."""
    m = plan.mesh
    if vb.dax:
        xc = sh.chunk(sh.gather(x, m, vb.bx, 0), m, vb.dax, -1)
        part = sh.psum(xc.float() @ vb.w.t().float(), m, vb.dax)
        part = sh.chunk(part.to(x.dtype).float(), m, vb.bx, 0)
    else:
        part = (x @ vb.w.t().to(x.dtype)).float()
    logits = sh.gather(part, m, vb.vax, -1)
    return sh.gather(logits, m, plan.bp, 0)


def _chunk_loss_mesh(w, xb, lb, lo: int, mesh, vax):
    """`_chunk_loss` on this rank's vocab rows [lo, lo + V/|vax|): the
    logsumexp from a MAX and a SUM all-reduce over `vax`, the gold logit
    from the rank that holds it (a SUM)."""
    logits = (xb @ w.t().to(xb.dtype)).float()            # (B,c,V/|vax|)
    mx = sh.psum(logits.detach().amax(dim=-1), mesh, vax,
                 op=torch.distributed.ReduceOp.MAX)
    se = sh.reduce_from(torch.exp(logits - mx[..., None]).sum(dim=-1),
                        mesh, vax)
    logz = mx + torch.log(se)
    rows = lb.long() - lo
    ok = (rows >= 0) & (rows < w.shape[0])
    gold = torch.gather(logits, -1,
                        rows.clamp(0, w.shape[0] - 1)[..., None])[..., 0]
    gold = sh.reduce_from(torch.where(ok, gold, 0.0), mesh, vax)
    valid = (lb >= 0).float()
    return ((logz - gold) * valid).sum(), valid.sum()


def chunked_xent_mesh(vb: VocabBlock, x, labels, cfg: ModelConfig,
                      plan: MeshPlan):
    """`chunked_xent` for x / labels this rank's batch block: each chunk's
    logits on this rank's vocab rows (under `torch.utils.checkpoint`), the
    sums over the batch axes by one all-reduce each -- every rank returns
    the global mean."""
    if vb.dax:
        raise ValueError("the loss needs the vocab block's columns whole")
    x = sh.copy_to(x, plan.mesh, vb.vax)
    B, S, _ = x.shape
    c = min(cfg.loss_chunk, S)
    nc = -(-S // c)
    pad = nc * c - S
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(nc):
        nll, n = checkpoint(_chunk_loss_mesh, vb.w, x[:, i * c:(i + 1) * c],
                            labels[:, i * c:(i + 1) * c], vb.lo, plan.mesh,
                            vb.vax, use_reentrant=False)
        tot = tot + nll
        cnt = cnt + n
    tot = sh.reduce_from(tot, plan.mesh, plan.bp)
    cnt = sh.psum(cnt.detach().clone(), plan.mesh, plan.bp)
    return tot / torch.clamp_min(cnt, 1.0)


def _combine(o, lse, mesh, axes):
    """The flash-decoding combine over `axes`: each rank's o (B,1,Hq,D)
    and lse (B,Hq,1) over its keys (lse -inf and o 0 on a rank with
    none) -> the attention over all of them.  One MAX all-reduce of the
    lse, one SUM of the weighted outputs with their weights packed
    beside them."""
    mx = sh.psum(lse.clone(), mesh, axes, op=torch.distributed.ReduceOp.MAX)
    wgt = torch.exp(lse - mx).permute(0, 2, 1)[..., None]   # (B,1,Hq,1)
    n = o.numel()
    packed = sh.psum(torch.cat([(o.float() * wgt).flatten(),
                                wgt.flatten()]), mesh, axes)
    return (packed[:n].view(o.shape) / packed[n:].view(wgt.shape)) \
        .to(o.dtype)


def _attention_decode_mesh(params, x, cfg: ModelConfig, cache_k, cache_v,
                           cache_len: int, positions, plan: MeshPlan,
                           scales=None):
    """`attention_decode` of one token per sequence on a mesh.  x is this
    rank's batch block over `bp`; cache_k / cache_v are `Sharded`
    (B, Smax, Hk, D) in `cache_pspecs`' layout (batch over `cb`, the
    SEQUENCE over `cs`), each rank holding all heads of its block.  With
    `scales` (the int8 cache's `Sharded` k_scale, v_scale (B, Smax, Hk),
    laid out as the codes) the owner rank quantizes the new k / v, and
    each rank dequantizes its live block to fp32 for its launch (the
    query in fp32), as `attention_decode_quant` does on one device.

    q, k, v of this rank's heads, gathered over `att` (all heads), moved
    to the cache's batch block; the new k / v written only by the rank
    whose sequence block holds position `cache_len`; one kernel launch
    over this rank's live keys with their lse (none on a rank with no
    live key: the kernel takes no empty key set); the flash-decoding
    combine over `cs`; back to the batch over `bp` and this rank's heads
    for wo's rows (`row_parallel`)."""
    m = plan.mesh
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"the decode on a mesh takes one token, got {S}")
    w = plan.attention_weights(params)
    q, k, v = _qkv(w, x, cfg, positions)
    hq, hk = q.shape[2], k.shape[2]
    qkv = sh.gather(torch.cat([q, k, v], dim=2), m, plan.att, 2)
    qkv = qkv.reshape(B, 1, -1, hq + 2 * hk, cfg.head_dim)
    q, k, v = (t.reshape(B, 1, -1, cfg.head_dim)
               for t in qkv.split([hq, hk, hk], dim=3))
    cb, cs = cache_k.spec[0], cache_k.spec[1]
    bp = (plan.bp or None,) + (None,) * 3
    q, k, v = (sh.relayout_local(t, bp, (cb, None, None, None), m)
               for t in (q, k, v))
    kl, vl = cache_k.local, cache_v.local
    Sb = kl.shape[1]
    start = sh.block_index(m, cs) * Sb
    if start <= cache_len < start + Sb:
        at = cache_len - start
        if scales is None:
            kl[:, at] = k[:, 0].to(kl.dtype)
            vl[:, at] = v[:, 0].to(vl.dtype)
        else:
            kl[:, at], scales[0].local[:, at] = kv_quantize(k[:, 0])
            vl[:, at], scales[1].local[:, at] = kv_quantize(v[:, 0])
    live = min(max(cache_len + 1 - start, 0), Sb)
    odt = kl.dtype if scales is None else torch.float32
    if live:
        if scales is None:
            kd, vd = kl[:, :live], vl[:, :live]
        else:
            kd = kv_dequantize(kl[:, :live], scales[0].local[:, :live], odt)
            vd = kv_dequantize(vl[:, :live], scales[1].local[:, :live], odt)
        o, lse = ops.flash_attention(q.to(odt), kd, vd, causal=False,
                                     return_lse=True)
    else:
        o = torch.zeros(q.shape, dtype=odt, device=q.device)
        lse = torch.full((q.shape[0], q.shape[2], 1), float("-inf"),
                         device=q.device)
    o = _combine(o, lse, m, cs)
    o = sh.relayout_local(o, (cb, None, None, None), bp, m)
    o = sh.chunk(o, m, plan.att, 2).reshape(B, 1, -1).to(x.dtype)
    out = plan.row_parallel(o, w["wo"], plan.att)
    if scales is None:
        return out, cache_k, cache_v
    return (out, cache_k, cache_v) + tuple(scales)
