"""The dense decoder LM (port of the dense family of `repro/models/lm.py`).

A pre-norm transformer: GQA attention and a gated (or plain gelu) MLP per
block, tied or separate logits head.  Params are `repro`'s tree -- the
blocks STACKED on a leading layer axis -- so `repro`'s params copy
across unchanged (`convert.params_from_numpy`); `lax.scan` over the
layers becomes a Python loop over that axis.

The cache is {"k", "v": (L, B, max_len, Hk, D) in the compute dtype,
"len": the number of positions filled, a Python int}.  `decode_step`
writes each new token's k and v into the cache's buffers IN PLACE; the
cache it returns shares them.  The moe, ssm, hybrid, audio and vlm
families and the int8 KV cache are not ported yet (ROADMAP.md A.14):
`LM` refuses them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

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


def _layer(blocks, i: int):
    """Layer i's params: a view into each stacked leaf."""
    return L.tree_map(lambda a: a[i], blocks)


def _pad_cache(k, max_len: int):
    """(B,S,H,D) -> (B,max_len,H,D) zero-padded KV cache buffer."""
    S = k.shape[1]
    if S == max_len:
        return k
    return F.pad(k, (0, 0, 0, 0, 0, max_len - S))


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ModelConfig

    def __post_init__(self):
        cfg = self.cfg
        if cfg.family != "dense" or cfg.n_experts or cfg.embed_input:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is not ported yet; "
                f"repro_torch runs the dense family (ROADMAP.md A.14)")
        if cfg.kv_quant:
            raise NotImplementedError(
                f"{cfg.name}: the int8 KV cache (kv_quant) is not ported "
                f"yet (ROADMAP.md A.14)")

    # -- init ---------------------------------------------------------------
    def init(self, generator: torch.Generator, device=None) -> Dict[str, Any]:
        """Random fp32 params of `repro`'s shapes and scales, drawn on the
        CPU from `generator`, then moved to `device` (`None` = the card)."""
        cfg = self.cfg
        dev = resolve_device(device)
        params = {"embed": L.embedding_init(generator, cfg),
                  "final_norm": L.rmsnorm_init(cfg.d_model)}
        per_layer = [_tf_block_init(generator, cfg)
                     for _ in range(cfg.n_layers)]
        params["blocks"] = L.tree_map(lambda *ls: torch.stack(ls),
                                      *per_layer)
        return L.tree_map(lambda t: t.to(dev), params)

    # -- forward (training) --------------------------------------------------
    def forward(self, params, inputs, positions=None):
        """inputs: tokens (B,S).  Returns (hidden (B,S,D), aux_loss)."""
        cfg = self.cfg
        x = L.embed(params["embed"], inputs, cfg)
        B, S, _ = x.shape
        if positions is None:
            positions = torch.arange(S, device=x.device)[None].expand(B, S)
        for i in range(cfg.n_layers):
            x, _ = _tf_block_apply(_layer(params["blocks"], i), x, cfg,
                                   positions)
        return L.rmsnorm(params["final_norm"], x, cfg.norm_eps), 0.0

    # -- cache --------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=None, device=None):
        cfg = self.cfg
        dt = dtype or cfg.compute_dtype
        dev = resolve_device(device)
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
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
        ks, vs = [], []
        for i in range(cfg.n_layers):
            p = _layer(params["blocks"], i)
            h, (kk, vv) = L.attention_block(
                p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                positions)
            x = x + h
            x = x + L.mlp_block(p["mlp"],
                                L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
            ks.append(_pad_cache(kk, max_len))
            vs.append(_pad_cache(vv, max_len))
        cache = {"k": torch.stack(ks), "v": torch.stack(vs), "len": S}
        x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
        return L.logits_head(params["embed"], x, cfg), cache

    # -- decode -------------------------------------------------------------
    def decode_step(self, params, cache, tokens):
        """tokens (B,1) -> (logits (B,1,V), cache with len + 1).  The new
        k and v are written into `cache`'s buffers in place."""
        cfg = self.cfg
        x = L.embed(params["embed"], tokens, cfg)
        clen = cache["len"]
        for i in range(cfg.n_layers):
            p = _layer(params["blocks"], i)
            h, _, _ = L.attention_decode(
                p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                cache["k"][i], cache["v"][i], clen)
            x = x + h
            x = x + L.mlp_block(p["mlp"],
                                L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return L.logits_head(params["embed"], x, cfg), dict(cache,
                                                             len=clen + 1)
