"""Model configuration (port of `repro/models/config.py`).

The same fields and defaults as `repro`, so a config compares field for
field; `compute_dtype` is a `torch.dtype`.  The port runs the dense
family only (ROADMAP.md A.14 lists the rest).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    # attention (ignored for pure-SSM archs)
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    act: str = "swiglu"          # swiglu | geglu | gelu (non-gated)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # SSM / linear attention
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    chunk_size: int = 64         # linear-attention chunk length
    # hybrid: one shared attention block every attn_every mamba blocks
    attn_every: int = 0
    # io
    embed_input: bool = False    # audio/vlm stub: inputs are embeddings
    # int8 KV cache (serving)
    kv_quant: bool = False
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "full"          # none | full
    microbatch: int = 1
    attn_chunk: int = 1024       # flash-attention kv chunk (plain version)
    loss_chunk: int = 512        # vocab-logit sequence chunking

    @property
    def compute_dtype(self) -> torch.dtype:
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        return dt

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def scaled(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524288, 1, "decode"),
}
