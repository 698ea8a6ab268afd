"""Architecture registry (port of `repro/configs/__init__.py`):
`get_config(arch_id)` / `get_smoke_config(arch_id)`.

The port carries the four dense configs, which between them cover
qk_norm, QKV bias, GeGLU, MQA and head_dim 256 on one code path.  The
other ids of `repro`'s registry raise NotImplementedError: their
families are still to port (ROADMAP.md A.14).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

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
PORTED = ("qwen3_0_6b", "qwen2_1_5b", "gemma_2b", "gemma_7b")

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
    if arch_mod not in PORTED:
        raise NotImplementedError(
            f"{arch_mod} is not ported yet: repro_torch runs the dense "
            f"configs {', '.join(PORTED)} (ROADMAP.md A.14)")
    return importlib.import_module(f"repro_torch.configs.{arch_mod}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE

