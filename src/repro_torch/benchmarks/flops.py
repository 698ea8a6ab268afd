"""Analytic FLOP / byte / collective models per (arch x shape) cell (port
of `benchmarks/flops.py`).

The roofline terms (`benchmarks/roofline.py`) come from these models,
derived from the layer geometry; the dry-run (`launch/dryrun.py`) traces
rank 0's step and records what it actually runs, to hold them against.

Two FLOP numbers per cell:
  model_flops : useful work only -- 6*N_active*tokens for training,
                2*N_active*tokens for inference, with *causal* attention.
  impl_flops  : what an implementation schedules: full-remat recompute,
                full (masked) S x S chunked attention, MoE
                dispatch/combine einsums.
The ratio model/impl is the "useful compute" fraction.

Accounting convention: all byte quantities in CellCost are GLOBAL (summed
over the CHIPS=256 devices of the single-pod 16x16 mesh; per-device =
global / CHIPS under balanced sharding), so a roofline term is
``X / (chips * rate)``.  The mesh is (data=16, model=16): weights
2D-sharded (fsdp x tp), activations batch-sharded over data, TP/EP over
model.

`mode` selects the regime being modeled:
  "train"     : training layout.  Per-microbatch weight all-gathers over
                the data axis, fp32 grad reduce-scatter, per-layer TP
                all-reduces.  `precast=False` models fp32 gathers; True
                the bf16 cast-before-gather.
  "serve"     : inference with the KV cache converted to f32 and
                all-gathered every decode step; weights are not
                gathered (local shards are contracted and the small
                activations all-reduced instead).
  "serve_opt" : the cache stream stays local (bf16, sequence-sharded);
                per-step collectives are activation all-reduces only.
                ("serve_tp" is an alias.)

The device's rates are a parameter, `Hardware` (the roofline's); the
models here count FLOPs and bytes only.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.models.config import ModelConfig, SHAPES, ShapeConfig  # noqa: F401
from repro_torch.models.moe import capacity


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One device's peak rates: dense bf16 FLOP/s, device-memory bytes/s,
    and bytes/s over its links to the other devices (one direction)."""
    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float


# NVIDIA H100 SXM5 (NVIDIA H100 Tensor Core GPU datasheet): 989 TFLOP/s
# dense bf16, 3.35 TB/s HBM3, NVLink 4 at 900 GB/s per GPU counting both
# directions, so 450 GB/s each way.  Within one 8-GPU node; a mesh that
# spans nodes meets the network's rate on its outer axes.
H100_SXM = Hardware("NVIDIA H100 SXM", 989e12, 3.35e12, 450e9)

# Single-pod production mesh (launch/mesh.py).
DATA_AX = 16
MODEL_AX = 16
CHIPS = DATA_AX * MODEL_AX


def _attn_dims(cfg: ModelConfig):
    return cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim


def params_per_layer(cfg: ModelConfig) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    qd, kvd = _attn_dims(cfg)
    p = {}
    if cfg.family == "ssm":
        di = cfg.d_model
        p["tmix"] = 5 * D * D + D * 64 * 2
        p["cmix"] = 2 * D * F + D * D
        return p
    if cfg.family == "hybrid":
        di = cfg.d_inner
        n = cfg.ssm_state
        H = di // cfg.ssm_head_dim
        p["mamba"] = D * (2 * di + 2 * n + H) + di * D + \
            cfg.ssm_conv * (di + 2 * n)
        return p
    p["attn"] = 2 * D * qd + 2 * D * kvd
    if cfg.n_experts:
        p["router"] = D * cfg.n_experts
        p["experts"] = cfg.n_experts * 3 * D * cfg.moe_dff
        p["active_experts"] = cfg.top_k * 3 * D * cfg.moe_dff
        if cfg.n_shared_experts:
            sh = 3 * D * cfg.moe_dff * cfg.n_shared_experts
            p["experts"] += sh
            p["active_experts"] += sh
    else:
        p["mlp"] = (2 if cfg.act == "gelu" else 3) * D * F
    return p


def total_params(cfg: ModelConfig) -> int:
    per = params_per_layer(cfg)
    n_shared_attn = 0
    if cfg.family == "hybrid":
        D, F = cfg.d_model, cfg.d_ff
        qd, kvd = _attn_dims(cfg)
        n_shared_attn = 2 * D * qd + 2 * D * kvd + 3 * D * F
    emb = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    core = sum(v for k, v in per.items() if k != "active_experts")
    return cfg.n_layers * core + n_shared_attn + emb


def active_params(cfg: ModelConfig) -> int:
    per = dict(params_per_layer(cfg))
    if "experts" in per:
        per["experts"] = per.pop("active_experts")
    else:
        per.pop("active_experts", None)
    n_shared_attn = 0
    if cfg.family == "hybrid":
        D, F = cfg.d_model, cfg.d_ff
        qd, kvd = _attn_dims(cfg)
        n_shared_attn = 2 * D * qd + 2 * D * kvd + 3 * D * F
    emb = cfg.vocab * cfg.d_model  # head matmul is the active part
    return cfg.n_layers * sum(per.values()) + n_shared_attn + emb


@dataclasses.dataclass
class CellCost:
    model_flops: float
    impl_flops: float
    hbm_bytes: float          # implementation HBM traffic estimate
    coll_bytes_tp: float      # bytes over the model axis (per step, global)
    coll_bytes_dp: float      # bytes over the data/pod axes
    notes: str = ""


def _attention_flops(cfg, B, S, causal_ideal: bool):
    qd, _ = _attn_dims(cfg)
    if cfg.family == "ssm" or cfg.family == "hybrid":
        # chunked linear attention: att T^2 per chunk + state update
        if cfg.family == "ssm":
            H, dk, dv = cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim, \
                cfg.ssm_head_dim
            layers = cfg.n_layers
        else:
            di = cfg.d_inner
            H, dk, dv = di // cfg.ssm_head_dim, cfg.ssm_state, \
                cfg.ssm_head_dim
            layers = cfg.n_layers
        T = cfg.chunk_size
        per_tok = 2 * H * (T * dk + T * dv + 2 * dk * dv)
        f = B * S * per_tok * layers
        if cfg.family == "hybrid":
            n_attn = cfg.n_layers // cfg.attn_every
            ctx = S / 2 if causal_ideal else S
            f += n_attn * B * S * 2 * 2 * ctx * qd
        return f
    ctx = S / 2 if causal_ideal else S
    return cfg.n_layers * B * S * 2 * 2 * ctx * qd


def _moe_dispatch_flops(cfg, B, S):
    if not cfg.n_experts:
        return 0.0
    C = capacity(cfg, S)
    # dispatch + combine einsums: 2 * (B*S * E * C/S ... ) per group row
    return cfg.n_layers * 2 * 2 * B * S * cfg.n_experts * C * \
        cfg.d_model / S * (S / S)


def cell_cost(cfg: ModelConfig, shape: ShapeConfig, *,
              mode: str | None = None,
              remat: str | None = None,
              n_micro: int | None = None,
              precast: bool = False,
              kv_quant: bool = False,
              capacity_factor: float | None = None) -> CellCost:
    """Per-step cost for one cell.  Keyword overrides express variants
    without touching the configs (the module docstring names the `mode`
    regimes)."""
    B, S = shape.global_batch, shape.seq_len
    tokens = B * S
    if capacity_factor is not None:
        cfg = cfg.scaled(capacity_factor=capacity_factor)
    remat = remat if remat is not None else cfg.remat
    Na = active_params(cfg)
    Nt = total_params(cfg)
    act_bytes = 2                       # bf16 residual stream

    if shape.kind == "train":
        mode = mode or "train"
        model = 6 * Na * tokens + 3 * _attention_flops(cfg, B, S, True)
        # fwd + bwd = 3x matmul flops; full remat adds ~1 extra forward.
        fwd_eq = 4 if remat == "full" else 3
        impl = 2 * fwd_eq * Na * tokens + \
            fwd_eq * _attention_flops(cfg, B, S, False) + \
            fwd_eq * _moe_dispatch_flops(cfg, B, S)
        nm = n_micro if n_micro is not None else max(1, cfg.microbatch)
        # --- per-device accounting, then x CHIPS ---------------------------
        # weight traffic: each pass re-reads the gathered bf16 weights
        # (Na active / chip's tp shard), optimizer touches the fsdp-sharded
        # fp32 master + moments (p rw, m rw, v rw, g r = 28 B/param).
        w_read_pc = fwd_eq * nm * 2 * Na / MODEL_AX
        opt_pc = 28 * Nt / CHIPS
        # activation stash: with full remat only layer inputs are stashed;
        # without, ~6 intermediates per layer survive to the bwd.
        stash_mult = 2 if remat == "full" else 12
        act_pc = cfg.n_layers * (tokens / DATA_AX) * cfg.d_model * \
            act_bytes * stash_mult
        logits_pc = 2 * (tokens / DATA_AX) * cfg.vocab * 4 / MODEL_AX
        hbm = CHIPS * (w_read_pc + opt_pc + act_pc + logits_pc)
        # collectives, per chip: bf16 weight all-gather over the data axis
        # (a 1/MODEL_AX shard arrives) once per pass per microbatch; fp32
        # grad reduce-scatter + pod all-reduce ~ 2x shard size; TP
        # all-reduce of the (B_loc, S, D) activation block twice per layer
        # per pass (x2 ring factor).
        w_bytes_gathered = 2 if precast else 4   # bf16 vs fp32 master
        w_ag_pc = fwd_eq * nm * w_bytes_gathered * Nt / MODEL_AX
        g_rs_pc = 2 * 4 * Nt / MODEL_AX
        dp = CHIPS * (w_ag_pc + g_rs_pc)
        tp_pc = cfg.n_layers * fwd_eq * 2 * 2 * \
            (tokens / DATA_AX) * cfg.d_model * act_bytes
        tp = CHIPS * tp_pc + CHIPS * _moe_a2a_bytes_pc(cfg, tokens) * fwd_eq
        return CellCost(model, impl, hbm, tp, dp,
                        notes=f"n_micro={nm};remat={remat}")

    if shape.kind == "prefill":
        mode = mode or "serve"
        model = 2 * Na * tokens + _attention_flops(cfg, B, S, True)
        impl = 2 * Na * tokens + _attention_flops(cfg, B, S, False) + \
            _moe_dispatch_flops(cfg, B, S)
        # weights read once from local shards (no weight gathers in the
        # serve layout; activations are reduced instead)
        w_pc = 2 * Na / CHIPS
        act_pc = (tokens / DATA_AX) * cfg.d_model * act_bytes * \
            cfg.n_layers * 6
        hbm = CHIPS * (w_pc + act_pc)
        tp = CHIPS * cfg.n_layers * 2 * 2 * (tokens / DATA_AX) * \
            cfg.d_model * act_bytes + \
            CHIPS * _moe_a2a_bytes_pc(cfg, tokens)
        return CellCost(model, impl, hbm, tp, 0.0, notes=f"mode={mode}")

    # decode: one token per sequence, cache depth S
    mode = mode or "serve"
    if mode == "serve_tp":
        mode = "serve_opt"
    model = 2 * Na * B + _decode_attn_flops(cfg, B, S)
    impl = model + _moe_dispatch_flops(cfg, B, 1) * B
    kv_bytes = _cache_bytes(cfg, B, S)          # global cache, bf16
    w_pc = 2 * Nt / CHIPS                       # local weight shard read
    if mode == "serve":
        # The attention converts the cache to f32 and gathers the
        # converted copy within its replica groups every step: each
        # device re-materializes its batch shard of the cache in f32
        # (k+v, in and out of HBM) and gathers ~the same volume.
        cache_pc = 2 * 2 * kv_bytes / DATA_AX   # f32 copy, rw
        dp = CHIPS * (2 * kv_bytes / DATA_AX)   # f32 gather traffic
    else:
        # serve_opt: bf16 cache read once from the local (batch x seq)
        # shard; collectives are per-layer partial-softmax reductions.
        # The int8 KV cache halves the cache stream (+1/128 of scales).
        cache_pc = kv_bytes / CHIPS * (0.508 if kv_quant else 1.0)
        dp = CHIPS * cfg.n_layers * 2 * \
            max(1.0, B / DATA_AX) * cfg.q_dim * 4
    hbm = CHIPS * (w_pc + cache_pc) + \
        B * cfg.d_model * cfg.n_layers * act_bytes * 4
    tp = CHIPS * cfg.n_layers * 2 * 2 * \
        max(1.0, B / DATA_AX) * cfg.d_model * act_bytes
    return CellCost(model, impl, hbm, tp, dp,
                    notes=f"mode={mode};cache={kv_bytes/2**30:.1f}GiB")


def _moe_a2a_bytes_pc(cfg: ModelConfig, tokens: int) -> float:
    """Per-chip EP all-to-all bytes per pass: dispatched activations cross
    the model axis to their experts and back."""
    if not cfg.n_experts:
        return 0.0
    return cfg.n_layers * 2 * (tokens / CHIPS) * cfg.top_k * \
        cfg.d_model * 2


def _decode_attn_flops(cfg, B, L):
    qd, _ = _attn_dims(cfg)
    if cfg.family == "ssm":
        H, dk = cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim
        return cfg.n_layers * B * 2 * H * dk * dk * 2
    if cfg.family == "hybrid":
        di = cfg.d_inner
        H = di // cfg.ssm_head_dim
        f = cfg.n_layers * B * 2 * H * cfg.ssm_state * cfg.ssm_head_dim * 2
        f += (cfg.n_layers // cfg.attn_every) * B * 2 * 2 * L * qd
        return f
    return cfg.n_layers * B * 2 * 2 * L * qd


def _cache_bytes(cfg, B, L):
    if cfg.family == "ssm":
        H, dk = cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim
        return cfg.n_layers * B * H * dk * dk * 4
    if cfg.family == "hybrid":
        di = cfg.d_inner
        H = di // cfg.ssm_head_dim
        s = cfg.n_layers * B * H * cfg.ssm_state * cfg.ssm_head_dim * 4
        s += (cfg.n_layers // cfg.attn_every) * B * L * \
            cfg.n_kv_heads * cfg.head_dim * 2 * 2
        return s
    return cfg.n_layers * B * L * cfg.n_kv_heads * cfg.head_dim * 2 * 2
