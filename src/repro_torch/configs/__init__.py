"""Architecture/config registry of the port: every arch id of the
reference registry. The dense (``elasticbert12``, ``qwen3-1.7b``,
``granite-3-2b``, ``qwen1.5-32b``, ``deepseek-coder-33b``), ssm
(``rwkv6-3b``), hybrid (``zamba2-1.2b``), MoE (``phi3.5-moe-42b-a6.6b``,
``mixtral-8x22b``), VLM (``qwen2-vl-2b``) and enc-dec
(``seamless-m4t-large-v2``) archs. ``ASSIGNED_ARCHS`` are the ten the
dry run covers (all but the paper's own testbed geometry), and
``INPUT_SHAPES`` the four steps it lowers each of them at.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    INPUT_SHAPES,
    EncoderConfig,
    ExitConfig,
    InputShape,
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
            "mixtral-8x22b": "mixtral_8x22b",
            "qwen2-vl-2b": "qwen2_vl_2b",
            "seamless-m4t-large-v2": "seamless_m4t_large_v2"}
PORTED_ARCHS = tuple(_MODULES)
ASSIGNED_ARCHS: List[str] = [
    "deepseek-coder-33b", "granite-3-2b", "qwen2-vl-2b", "qwen3-1.7b",
    "qwen1.5-32b", "rwkv6-3b", "zamba2-1.2b", "mixtral-8x22b",
    "phi3.5-moe-42b-a6.6b", "seamless-m4t-large-v2"]


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in _MODULES:
        return importlib.import_module(
            f"repro_torch.configs.{_MODULES[arch_id]}").CONFIG
    raise KeyError(f"unknown arch {arch_id!r}; ported: {PORTED_ARCHS}")


def get_smoke_config(arch_id: str) -> ModelConfig:
    return smoke_variant(get_config(arch_id))


def get_input_shape(name: str) -> InputShape:
    if name not in INPUT_SHAPES:
        raise KeyError(f"unknown input shape {name!r}; known: "
                       f"{sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]


def list_archs() -> List[str]:
    """Every arch id, in the reference registry's order."""
    return [*ASSIGNED_ARCHS, "elasticbert12"]
