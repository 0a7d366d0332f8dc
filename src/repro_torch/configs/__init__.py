"""Architecture/config registry of the port.

The dense (``elasticbert12``, ``qwen3-1.7b``, ``granite-3-2b``,
``qwen1.5-32b``, ``deepseek-coder-33b``), ssm (``rwkv6-3b``), hybrid
(``zamba2-1.2b``) and MoE (``phi3.5-moe-42b-a6.6b``, ``mixtral-8x22b``)
archs are ported; the VLM and enc-dec arch ids of the reference registry
raise ``NotImplementedError``.
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
            "granite-3-2b": "granite_3_2b", "qwen1.5-32b": "qwen1_5_32b",
            "deepseek-coder-33b": "deepseek_coder_33b",
            "rwkv6-3b": "rwkv6_3b", "zamba2-1.2b": "zamba2_1_2b",
            "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
            "mixtral-8x22b": "mixtral_8x22b"}
PORTED_ARCHS = tuple(_MODULES)
NOT_PORTED_ARCHS = ("qwen2-vl-2b", "seamless-m4t-large-v2")


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
