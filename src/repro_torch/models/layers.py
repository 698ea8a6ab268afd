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
(`attention_decode_quant`) serve `LM` with `kv_quant`.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.kernels.attention import NEG_INF
from repro_torch.models.config import ModelConfig
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
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
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


def attention_block(params, x, cfg: ModelConfig, positions):
    """Training / prefill attention.  Returns (out, (k, v)) for caching."""
    q, k, v = _qkv(params, x, cfg, positions)
    out = flash_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    B, S, _, _ = out.shape
    out = out.reshape(B, S, cfg.q_dim) @ params["wo"].to(x.dtype)
    return out, (k, v)


def attention_decode(params, x, cfg: ModelConfig, cache_k, cache_v,
                     cache_len: int):
    """Decode against a KV cache: x (B,S,D) are the tokens at positions
    cache_len .. cache_len + S - 1; cache_k/v (B,Smax,Hk,D).

    Writes the new k and v into cache_k / cache_v IN PLACE (at
    cache_len) and returns (out, cache_k, cache_v).  On the card the
    attention is one kernel launch over the live prefix
    cache[:, :cache_len + S], a strided view of the cache, with q_offset
    = cache_len; on the CPU, `repro`'s masked softmax over the whole
    cache (the query rounded to the cache's dtype before the scores, the
    probabilities before the values)."""
    B, S, _ = x.shape
    Smax = cache_k.shape[1]
    if cache_len + S > Smax:
        raise ValueError(f"cache of {Smax} positions cannot take positions "
                         f"{cache_len}..{cache_len + S - 1}")
    positions = (cache_len + torch.arange(S, device=x.device))[None, :]
    positions = positions.expand(B, S)
    q, k, v = _qkv(params, x, cfg, positions)
    cache_k[:, cache_len:cache_len + S] = k.to(cache_k.dtype)
    cache_v[:, cache_len:cache_len + S] = v.to(cache_v.dtype)
    if x.device.type == "cuda":
        out = ops.flash_attention(q.to(cache_k.dtype),
                                  cache_k[:, :cache_len + S],
                                  cache_v[:, :cache_len + S], causal=True,
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
                           k_scale, v_scale, cache_len: int):
    """`attention_decode` against an int8 KV cache: cache_k/v (B,Smax,Hk,D)
    int8, k_scale/v_scale (B,Smax,Hk) fp32.

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
    positions = (cache_len + torch.arange(S, device=x.device))[None, :]
    positions = positions.expand(B, S)
    q, k, v = _qkv(params, x, cfg, positions)
    live = cache_len + S
    cache_k[:, cache_len:live], k_scale[:, cache_len:live] = kv_quantize(k)
    cache_v[:, cache_len:live], v_scale[:, cache_len:live] = kv_quantize(v)
    if x.device.type == "cuda":
        kd = kv_dequantize(cache_k[:, :live], k_scale[:, :live],
                           torch.float32)
        vd = kv_dequantize(cache_v[:, :live], v_scale[:, :live],
                           torch.float32)
        out = ops.flash_attention(q.float(), kd, vd, causal=True,
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


def mlp_block(params, x, cfg: ModelConfig):
    dt = x.dtype
    if cfg.act == "gelu":
        h = _gelu(x @ params["wi"].to(dt))
    else:
        gate_fn = F.silu if cfg.act == "swiglu" else _gelu
        h = gate_fn(x @ params["wg"].to(dt)) * (x @ params["wi"].to(dt))
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
