"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each kernel lives in ``<name>/`` with ``ref.py`` (plain version),
``kernel.py`` (ctypes binding), ``ops.py`` (dispatch by device) and
``csrc/*.cu``; ``include/`` holds the device helpers the sources share.
Every wrapper counts the launches it makes on a CUDA tensor, per kernel
(`launch_counts`), per variant of the kernel (`variant_launch_counts`)
and, for a variant with several tiles, per tile (`tile_launch_counts`).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

from repro_torch.kernels import _build
from repro_torch.kernels.exit_confidence import kernel as _exit_kernel
from repro_torch.kernels.flash_attention import kernel as _attn_kernel
from repro_torch.kernels.wkv6 import kernel as _wkv6_kernel

SOURCES = (_attn_kernel.SOURCE, _attn_kernel.BACKWARD_SOURCE,
           _exit_kernel.SOURCE, _wkv6_kernel.SOURCE)


def launch_counts() -> Dict[str, int]:
    """{kernel name: launches since the last reset}, for every kernel."""
    return dict(_build.LAUNCHES)


def variant_launch_counts() -> Dict[str, int]:
    """{"<kernel>/<variant>": launches since the last reset}, for every
    variant of every kernel that has variants."""
    return dict(_build.VARIANT_LAUNCHES)


def tile_launch_counts() -> Dict[str, int]:
    """{"<kernel>/<variant>/<tile>": launches since the last reset}, for
    every tile of every variant that chooses among several (the exit
    kernels' `tensor_core` variant: ``mma_sync`` for M <= 32 rows,
    ``wgmma`` above)."""
    return dict(_build.TILE_LAUNCHES)


def reset_launch_counts() -> None:
    """Set every kernel's, variant's and tile's count to 0."""
    for counts in (_build.LAUNCHES, _build.VARIANT_LAUNCHES,
                   _build.TILE_LAUNCHES):
        for name in counts:
            counts[name] = 0


def build_all() -> Dict[str, str]:
    """Compile every kernel source not yet built (one nvcc per source, run
    in parallel); returns {source stem: ptxas log} of those built."""
    return _build.build(Path(s) for s in SOURCES)
