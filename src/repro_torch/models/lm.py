"""The dense decoder LM (port of the dense family of `repro/models/lm.py`).

A pre-norm transformer: GQA attention and a gated (or plain gelu) MLP per
block, tied or separate logits head.  Params are `repro`'s tree -- the
blocks STACKED on a leading layer axis -- so `repro`'s params copy
across unchanged (`convert.params_from_numpy`); `lax.scan` over the
layers becomes a Python loop over that axis.

Training: `forward` runs the layers under `torch.utils.checkpoint` when
`cfg.remat == "full"` (`repro`'s `jax.checkpoint` of the layer body), and
`loss` is `repro`'s: the chunked cross-entropy plus 0.01 * aux.

The cache is {"k", "v": (L, B, max_len, Hk, D) in the compute dtype,
"len": the number of positions filled, a Python int}.  With
`cfg.kv_quant` (`repro`'s int8 KV cache) "k" and "v" hold int8 codes and
"k_scale", "v_scale" (L, B, max_len, Hk) their fp32 per-(position, head)
scales; the prefill attends to the unquantized k and v and caches their
quantization.  `decode_step` writes each new token's k and v (or codes
and scales) into the cache's buffers IN PLACE; the cache it returns
shares them.  The moe, ssm, hybrid, audio and vlm families are not
ported yet (ROADMAP.md A.14): `LM` refuses them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def _tf_block_init(generator: torch.Generator, cfg: ModelConfig):
    return {"ln1": L.rmsnorm_init(cfg.d_model),
            "attn": L.attention_init(generator, cfg),
            "ln2": L.rmsnorm_init(cfg.d_model),
            "mlp": L.mlp_init(generator, cfg)}


def _tf_block_apply(p, x, cfg: ModelConfig, positions):
    h, _ = L.attention_block(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                             cfg, positions)
    x = x + h
    hin = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + L.mlp_block(p["mlp"], hin, cfg), 0.0


def _layers(blocks, n: int) -> list:
    """Every layer's params as views of the stacked leaves, taken by one
    `unbind` per leaf: the backward then stacks the layers' gradients
    once, where indexing layer by layer would scatter each into a zeroed
    copy of the whole stack."""
    cols = [a.unbind(0) for a in L.tree_leaves(blocks)]

    def layer(i):
        it = iter([c[i] for c in cols])
        return L.tree_map(lambda _: next(it), blocks)

    return [layer(i) for i in range(n)]


def _block_out(p, x, cfg: ModelConfig, positions):
    return _tf_block_apply(p, x, cfg, positions)[0]


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
        if cfg.family != "dense" or cfg.n_experts or cfg.embed_input:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is not ported yet; "
                f"repro_torch runs the dense family (ROADMAP.md A.14)")

    # -- init ---------------------------------------------------------------
    def init(self, generator: torch.Generator, device=None) -> Dict[str, Any]:
        """Random fp32 params of `repro`'s shapes and scales, drawn on the
        CPU from `generator`, then moved to `device` (`None` = the card)."""
        dev = resolve_device(device)
        return L.tree_map(lambda t: t.to(dev), self.init_tree(generator))

    def init_tree(self, generator: torch.Generator) -> Dict[str, Any]:
        """`init`'s params on the default device: under
        `with torch.device("meta")` the tree's shapes and dtypes alone,
        drawn and stored nowhere (`repro`'s `jax.eval_shape` of init)."""
        cfg = self.cfg
        params = {"embed": L.embedding_init(generator, cfg),
                  "final_norm": L.rmsnorm_init(cfg.d_model)}
        per_layer = [_tf_block_init(generator, cfg)
                     for _ in range(cfg.n_layers)]
        params["blocks"] = L.tree_map(lambda *ls: torch.stack(ls),
                                      *per_layer)
        return params

    # -- forward (training) --------------------------------------------------
    def forward(self, params, inputs, positions=None):
        """inputs: tokens (B,S).  Returns (hidden (B,S,D), aux_loss).

        With `remat == "full"` each layer runs under
        `torch.utils.checkpoint`: only its input is kept, and the backward
        runs the layer again.  (`repro` also fences the stashed input with
        `_diff_barrier`, an XLA optimization barrier against hoisting its
        bf16 -> f32 convert out of the layer scan; eager PyTorch hoists
        nothing, so it has no counterpart here.)"""
        cfg = self.cfg
        x = L.embed(params["embed"], inputs, cfg)
        B, S, _ = x.shape
        if positions is None:
            positions = torch.arange(S, device=x.device)[None].expand(B, S)
        for p in _layers(params["blocks"], cfg.n_layers):
            if cfg.remat == "full" and torch.is_grad_enabled():
                x = checkpoint(_block_out, p, x, cfg, positions,
                               use_reentrant=False)
            else:
                x = _block_out(p, x, cfg, positions)
        return L.rmsnorm(params["final_norm"], x, cfg.norm_eps), 0.0

    def loss(self, params, inputs, labels):
        """(nll + 0.01 * aux, {"nll", "aux"}); labels of -1 are masked."""
        x, aux = self.forward(params, inputs)
        nll = L.chunked_xent(params["embed"], x, labels, self.cfg)
        return nll + 0.01 * aux, {"nll": nll, "aux": aux}

    # -- cache --------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=None, device=None):
        cfg = self.cfg
        dt = dtype or cfg.compute_dtype
        dev = resolve_device(device)
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
        """Process a prompt (B,S), return (last-token logits (B,1,V), cache
        holding positions 0..S-1)."""
        cfg = self.cfg
        x = L.embed(params["embed"], inputs, cfg)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        ks, vs, kss, vss = [], [], [], []
        for p in _layers(params["blocks"], cfg.n_layers):
            h, (kk, vv) = L.attention_block(
                p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                positions)
            x = x + h
            x = x + L.mlp_block(p["mlp"],
                                L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
            if cfg.kv_quant:
                kk, k_scale = L.kv_quantize(kk)
                vv, v_scale = L.kv_quantize(vv)
                kss.append(_pad_cache(k_scale, max_len))
                vss.append(_pad_cache(v_scale, max_len))
            ks.append(_pad_cache(kk, max_len))
            vs.append(_pad_cache(vv, max_len))
        cache = {"k": torch.stack(ks), "v": torch.stack(vs), "len": S}
        if cfg.kv_quant:
            cache.update(k_scale=torch.stack(kss), v_scale=torch.stack(vss))
        x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
        return L.logits_head(params["embed"], x, cfg), cache

    # -- decode -------------------------------------------------------------
    def decode_step(self, params, cache, tokens):
        """tokens (B,1) -> (logits (B,1,V), cache with len + 1).  The new
        k and v are written into `cache`'s buffers in place."""
        cfg = self.cfg
        x = L.embed(params["embed"], tokens, cfg)
        clen = cache["len"]
        for i, p in enumerate(_layers(params["blocks"], cfg.n_layers)):
            xin = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
            if cfg.kv_quant:
                h = L.attention_decode_quant(
                    p["attn"], xin, cfg, cache["k"][i], cache["v"][i],
                    cache["k_scale"][i], cache["v_scale"][i], clen)[0]
            else:
                h = L.attention_decode(p["attn"], xin, cfg, cache["k"][i],
                                       cache["v"][i], clen)[0]
            x = x + h
            x = x + L.mlp_block(p["mlp"],
                                L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return L.logits_head(params["embed"], x, cfg), dict(cache,
                                                             len=clen + 1)
