"""Architecture/config registry of the port.

Only ``elasticbert12`` and ``qwen3-1.7b`` (dense) and ``rwkv6-3b`` (ssm)
are ported; every other arch id of the reference registry raises
``NotImplementedError``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    EncoderConfig,
    ExitConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    smoke_variant,
)

# arch id -> module name under repro_torch.configs
_MODULES = {"elasticbert12": "elasticbert12", "qwen3-1.7b": "qwen3_1_7b",
            "rwkv6-3b": "rwkv6_3b"}
PORTED_ARCHS = tuple(_MODULES)
NOT_PORTED_ARCHS = (
    "deepseek-coder-33b", "granite-3-2b", "qwen2-vl-2b", "qwen1.5-32b",
    "zamba2-1.2b", "mixtral-8x22b", "phi3.5-moe-42b-a6.6b",
    "seamless-m4t-large-v2",
)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in _MODULES:
        return importlib.import_module(
            f"repro_torch.configs.{_MODULES[arch_id]}").CONFIG
    if arch_id in NOT_PORTED_ARCHS:
        raise NotImplementedError(
            f"arch {arch_id!r}: not ported yet; ported: {PORTED_ARCHS}")
    raise KeyError(f"unknown arch {arch_id!r}; ported: {PORTED_ARCHS}")


def get_smoke_config(arch_id: str) -> ModelConfig:
    return smoke_variant(get_config(arch_id))
