"""Architecture/config registry of the port.

Only ``elasticbert12`` is ported; every other arch id of the reference
registry raises ``NotImplementedError``.
"""
from __future__ import annotations

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    EncoderConfig,
    ExitConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    smoke_variant,
)

PORTED_ARCHS = ("elasticbert12",)
NOT_PORTED_ARCHS = (
    "deepseek-coder-33b", "granite-3-2b", "qwen2-vl-2b", "qwen3-1.7b",
    "qwen1.5-32b", "rwkv6-3b", "zamba2-1.2b", "mixtral-8x22b",
    "phi3.5-moe-42b-a6.6b", "seamless-m4t-large-v2",
)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id == "elasticbert12":
        from repro_torch.configs.elasticbert12 import CONFIG
        return CONFIG
    if arch_id in NOT_PORTED_ARCHS:
        raise NotImplementedError(
            f"arch {arch_id!r}: not ported yet; ported: {PORTED_ARCHS}")
    raise KeyError(f"unknown arch {arch_id!r}; ported: {PORTED_ARCHS}")


def get_smoke_config(arch_id: str) -> ModelConfig:
    return smoke_variant(get_config(arch_id))
