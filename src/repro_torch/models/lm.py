"""The decoder LM (port of `repro/models/lm.py`): one class for the
dense, moe, ssm and hybrid families.

  dense / moe : a pre-norm transformer -- GQA attention and a gated (or
      plain gelu) MLP, or the MoE layer (`models/moe.py`), per block.
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
entry IN PLACE; the cache it returns shares the buffers.  The audio and
vlm families (inputs are embeddings) are not ported yet (ROADMAP.md
A.14.5): `LM` refuses them.
"""
from __future__ import annotations

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


def _tf_block_init(generator: torch.Generator, cfg: ModelConfig):
    p = {"ln1": L.rmsnorm_init(cfg.d_model),
         "attn": L.attention_init(generator, cfg),
         "ln2": L.rmsnorm_init(cfg.d_model)}
    if cfg.n_experts:
        p["moe"] = M.moe_init(generator, cfg)
    else:
        p["mlp"] = L.mlp_init(generator, cfg)
    return p


def _ffn(p, hin, cfg: ModelConfig):
    """The block's MLP or MoE on normed input -> (out, aux).  A decode
    step (S == 1) routes over the batch: its B tokens are one group."""
    if not cfg.n_experts:
        return L.mlp_block(p["mlp"], hin, cfg), 0.0
    if hin.shape[1] == 1:
        h2, aux = M.moe_block(p["moe"], hin.transpose(0, 1), cfg)
        return h2.transpose(0, 1), aux
    return M.moe_block(p["moe"], hin, cfg)


def _tf_block_apply(p, x, cfg: ModelConfig, positions):
    h, _ = L.attention_block(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                             cfg, positions)
    x = x + h
    h2, aux = _ffn(p, L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    return x + h2, aux


def _rwkv_block_init(generator: torch.Generator, cfg: ModelConfig):
    return {"ln1": L.rmsnorm_init(cfg.d_model),
            "ln2": L.rmsnorm_init(cfg.d_model),
            "mix": S.rwkv6_init(generator, cfg)}


def _rwkv_block_apply(p, x, cfg: ModelConfig, positions):
    del positions
    h, _, _ = S.rwkv6_time_mix(p["mix"], L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                               cfg)
    x = x + h
    h2, _ = S.rwkv6_channel_mix(p["mix"],
                                L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    return x + h2, 0.0


def _mamba_block_init(generator: torch.Generator, cfg: ModelConfig):
    return {"ln": L.rmsnorm_init(cfg.d_model),
            "mamba": S.mamba2_init(generator, cfg)}


def _mamba_block_apply(p, x, cfg: ModelConfig, positions):
    del positions
    return x + S.mamba2_block(p["mamba"], L.rmsnorm(p["ln"], x, cfg.norm_eps),
                              cfg), 0.0


_BLOCKS = {"dense": (_tf_block_init, _tf_block_apply),
           "moe": (_tf_block_init, _tf_block_apply),
           "ssm": (_rwkv_block_init, _rwkv_block_apply),
           "hybrid": (_mamba_block_init, _mamba_block_apply)}


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


def _aux_sum(auxes: list):
    """The MoE aux losses summed over layers in order (0.0 without any)."""
    auxes = [a for a in auxes if isinstance(a, torch.Tensor)]
    return torch.stack(auxes).sum() if auxes else 0.0


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
        if cfg.family not in _BLOCKS or cfg.embed_input:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family (inputs that are "
                f"embeddings) is not ported yet; repro_torch runs the dense, "
                f"moe, ssm and hybrid families (ROADMAP.md A.14.5)")
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

    # -- forward (training) --------------------------------------------------
    def forward(self, params, inputs, positions=None):
        """inputs: tokens (B,S).  Returns (hidden (B,S,D), aux_loss).

        With `remat == "full"` each block runs under
        `torch.utils.checkpoint`: only its input is kept, and the backward
        runs the block again.  (`repro` also fences the stashed input with
        `_diff_barrier`, an XLA optimization barrier against hoisting its
        bf16 -> f32 convert out of the layer scan; eager PyTorch hoists
        nothing, so it has no counterpart here.)"""
        cfg = self.cfg
        x = L.embed(params["embed"], inputs, cfg)
        B, S_, _ = x.shape
        if positions is None:
            positions = torch.arange(S_, device=x.device)[None].expand(B, S_)
        remat = cfg.remat == "full" and torch.is_grad_enabled()

        def run(apply, p, x):
            if remat:
                return checkpoint(apply, p, x, cfg, positions,
                                  use_reentrant=False)
            return apply(p, x, cfg, positions)

        apply = _BLOCKS[cfg.family][1]
        auxes = []
        for i, p in enumerate(_layers(params["blocks"], cfg.n_layers)):
            if cfg.family == "hybrid" and i % cfg.attn_every == 0:
                x, aux = run(_tf_block_apply, params["shared_attn"], x)
                auxes.append(aux)
            x, aux = run(apply, p, x)
            auxes.append(aux)
        return L.rmsnorm(params["final_norm"], x, cfg.norm_eps), \
            _aux_sum(auxes)

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
        """Process a prompt (B,S), return (last-token logits (B,1,V), cache
        holding positions 0..S-1)."""
        cfg = self.cfg
        x = L.embed(params["embed"], inputs, cfg)
        B, S_, _ = x.shape
        positions = torch.arange(S_, device=x.device)[None].expand(B, S_)
        layers = _layers(params["blocks"], cfg.n_layers)
        if cfg.family == "ssm":
            x, cache = self._prefill_rwkv(layers, x)
        elif cfg.family == "hybrid":
            x, cache = self._prefill_hybrid(params["shared_attn"], layers, x,
                                            positions, max_len)
        else:
            x, cache = self._prefill_tf(layers, x, positions, max_len)
        cache["len"] = S_
        x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
        return L.logits_head(params["embed"], x, cfg), cache

    def _prefill_tf(self, layers, x, positions, max_len):
        cfg = self.cfg
        ks, vs, kss, vss = [], [], [], []
        for p in layers:
            h, (kk, vv) = L.attention_block(
                p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                positions)
            x = x + h
            x = x + _ffn(p, L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)[0]
            if cfg.kv_quant:
                kk, k_scale = L.kv_quantize(kk)
                vv, v_scale = L.kv_quantize(vv)
                kss.append(_pad_cache(k_scale, max_len))
                vss.append(_pad_cache(v_scale, max_len))
            ks.append(_pad_cache(kk, max_len))
            vs.append(_pad_cache(vv, max_len))
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
        if cfg.kv_quant:
            cache.update(k_scale=torch.stack(kss), v_scale=torch.stack(vss))
        return x, cache

    def _prefill_rwkv(self, layers, x):
        cfg = self.cfg
        xts, xcs, sts = [], [], []
        for p in layers:
            h, xt, st = S.rwkv6_time_mix(
                p["mix"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg)
            x = x + h
            h2, xc = S.rwkv6_channel_mix(
                p["mix"], L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
            x = x + h2
            xts.append(xt)
            xcs.append(xc)
            sts.append(st)
        return x, {"x_prev_t": torch.stack(xts), "x_prev_c": torch.stack(xcs),
                   "state": torch.stack(sts)}

    def _prefill_hybrid(self, sa, layers, x, positions, max_len):
        cfg = self.cfg
        G, per = self._groups()
        convs, sts, ks, vs = [], [], [], []
        for g in range(G):
            h, (kk, vv) = L.attention_block(
                sa["attn"], L.rmsnorm(sa["ln1"], x, cfg.norm_eps), cfg,
                positions)
            x = x + h
            x = x + L.mlp_block(sa["mlp"],
                                L.rmsnorm(sa["ln2"], x, cfg.norm_eps), cfg)
            ks.append(_pad_cache(kk, max_len))
            vs.append(_pad_cache(vv, max_len))
            for p in layers[g * per:(g + 1) * per]:
                y, conv, st = S.mamba2_prefill(
                    p["mamba"], L.rmsnorm(p["ln"], x, cfg.norm_eps), cfg)
                x = x + y
                convs.append(conv)
                sts.append(st)
        return x, {"conv": torch.stack(convs).unflatten(0, (G, per)),
                   "state": torch.stack(sts).unflatten(0, (G, per)),
                   "k": torch.stack(ks), "v": torch.stack(vs)}

    # -- decode -------------------------------------------------------------
    def decode_step(self, params, cache, tokens):
        """tokens (B,1) -> (logits (B,1,V), cache with len + 1).  Every
        entry of `cache` is updated in place."""
        cfg = self.cfg
        x = L.embed(params["embed"], tokens, cfg)
        clen = cache["len"]
        layers = _layers(params["blocks"], cfg.n_layers)
        if cfg.family == "ssm":
            for i, p in enumerate(layers):
                h, xt, st = S.rwkv6_time_mix_decode(
                    p["mix"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                    cache["x_prev_t"][i], cache["state"][i])
                x = x + h
                h2, xc = S.rwkv6_channel_mix(
                    p["mix"], L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg,
                    cache["x_prev_c"][i])
                x = x + h2
                cache["x_prev_t"][i] = xt
                cache["x_prev_c"][i] = xc
                cache["state"][i] = st
        elif cfg.family == "hybrid":
            sa = params["shared_attn"]
            G, per = self._groups()
            for g in range(G):
                x = x + L.attention_decode(
                    sa["attn"], L.rmsnorm(sa["ln1"], x, cfg.norm_eps), cfg,
                    cache["k"][g], cache["v"][g], clen)[0]
                x = x + L.mlp_block(sa["mlp"],
                                    L.rmsnorm(sa["ln2"], x, cfg.norm_eps),
                                    cfg)
                for j, p in enumerate(layers[g * per:(g + 1) * per]):
                    y, conv, st = S.mamba2_decode(
                        p["mamba"], L.rmsnorm(p["ln"], x, cfg.norm_eps), cfg,
                        cache["conv"][g, j], cache["state"][g, j])
                    x = x + y
                    cache["conv"][g, j] = conv
                    cache["state"][g, j] = st
        else:
            for i, p in enumerate(layers):
                xin = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
                if cfg.kv_quant:
                    h = L.attention_decode_quant(
                        p["attn"], xin, cfg, cache["k"][i], cache["v"][i],
                        cache["k_scale"][i], cache["v_scale"][i], clen)[0]
                else:
                    h = L.attention_decode(p["attn"], xin, cfg,
                                           cache["k"][i], cache["v"][i],
                                           clen)[0]
                x = x + h
                x = x + _ffn(p, L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)[0]
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return L.logits_head(params["embed"], x, cfg), dict(cache,
                                                             len=clen + 1)
