"""Public block attention: GQA shapes, dispatch by device.

A CPU tensor runs the plain PyTorch version (`ref.gqa_ref`); a CUDA
tensor launches the hand-written kernel, which resolves GQA by index; any
other device raises. There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import gqa_ref


def attention(q, k, v, *, causal: bool = True, window: int = 0
              ) -> torch.Tensor:
    """GQA block attention.

    q: (B, Hq, Sq, d); k, v: (B, Hkv, Skv, d), Hq % Hkv == 0.
    ``window`` > 0 restricts each query to the previous ``window`` keys.
    """
    if q.device.type == "cpu":
        return gqa_ref(q, k, v, causal=causal, window=window)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    raise ValueError(f"attention: no kernel for device {q.device}")
