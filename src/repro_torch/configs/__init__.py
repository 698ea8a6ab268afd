"""Architecture registry (port of `repro/configs/__init__.py`):
`get_config(arch_id)` / `get_smoke_config(arch_id)`.

The port carries every id of `repro`'s registry: the dense, moe, ssm
and hybrid configs and the audio / vlm ones (musicgen-medium,
internvl2-76b), whose inputs are embeddings.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, SHAPES  # noqa: F401

ARCH_IDS = [
    "qwen3_moe_235b_a22b",
    "moonshot_v1_16b_a3b",
    "rwkv6_7b",
    "qwen3_0_6b",
    "qwen2_1_5b",
    "gemma_2b",
    "gemma_7b",
    "musicgen_medium",
    "internvl2_76b",
    "zamba2_2_7b",
]

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
_ALIASES.update({
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "rwkv6-7b": "rwkv6_7b",
    "qwen3-0.6b": "qwen3_0_6b",
    "qwen2-1.5b": "qwen2_1_5b",
    "gemma-2b": "gemma_2b",
    "gemma-7b": "gemma_7b",
    "musicgen-medium": "musicgen_medium",
    "internvl2-76b": "internvl2_76b",
    "zamba2-2.7b": "zamba2_2_7b",
})


def _module(arch: str):
    arch_mod = _ALIASES.get(arch, arch)
    if arch_mod not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch!r}")
    return importlib.import_module(f"repro_torch.configs.{arch_mod}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE



def supported_shapes(cfg: ModelConfig) -> list[str]:
    """Which assigned shape cells apply to this arch (long_500k only for
    sub-quadratic families, per the assignment)."""
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        shapes.append("long_500k")
    return shapes
