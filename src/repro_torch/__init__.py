"""PyTorch/CUDA port of the SplitEE serving stack.

Mirrors the layout of the JAX package beside it (``configs``, ``data``,
``models``, ``kernels``, ``core``, ``serving``) and imports nothing of it.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on a CPU tensor every kernel wrapper runs its plain PyTorch version, on a
CUDA tensor it launches the hand-written kernel.
"""
from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises when CUDA is asked for (explicitly or by default) and the
    process has none — an entry point never falls back to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev}: expected 'cuda' or 'cpu'")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"dtype {name!r}: expected one of {sorted(DTYPES)}")
    return DTYPES[name]
