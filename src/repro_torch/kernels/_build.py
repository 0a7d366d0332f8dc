"""Build and load the port's CUDA kernels; keep their launch counts.

Each ``csrc/*.cu`` file exposes ``extern "C"`` launchers and is compiled
on first use with plain ``nvcc`` into a shared library, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). The sources
share the device helpers in ``include/*.cuh``. Libraries go under
``build/torch_kernels/`` at the repository root, one directory per
content hash of the source and the shared headers, so an edited source
or header rebuilds and an unchanged one is reused. Nothing here runs at
import time: importing the kernel modules on a machine without ``nvcc``
is fine, building is not.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

from repro_torch.shards import is_dtensor

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_ROOT = REPO_ROOT / "build" / "torch_kernels"
INCLUDE_DIR = Path(__file__).resolve().parent / "include"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v", "-I", str(INCLUDE_DIR))

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

# launches of each kernel's wrapper on a CUDA tensor, of each of its
# variants ("<kernel>/<variant>") and of each tile of a variant that has
# several ("<kernel>/<variant>/<tile>"); read through
# repro_torch.kernels.launch_counts(), variant_launch_counts() and
# tile_launch_counts()
LAUNCHES: Dict[str, int] = {}
VARIANT_LAUNCHES: Dict[str, int] = {}
TILE_LAUNCHES: Dict[str, int] = {}


def register_kernel(name: str, variants: Iterable[str] = (),
                    tiles: Dict[str, Iterable[str]] | None = None) -> None:
    """Register a kernel, its variants, and ``tiles``: {variant: its
    tiles} for the variants that choose among several."""
    LAUNCHES.setdefault(name, 0)
    for variant in variants:
        VARIANT_LAUNCHES.setdefault(f"{name}/{variant}", 0)
    for variant, names in (tiles or {}).items():
        for tile in names:
            TILE_LAUNCHES.setdefault(f"{name}/{variant}/{tile}", 0)


def count_launch(name: str, variant: str | None = None,
                 tile: str | None = None) -> None:
    LAUNCHES[name] += 1
    if variant is not None:
        VARIANT_LAUNCHES[f"{name}/{variant}"] += 1
    if tile is not None:
        TILE_LAUNCHES[f"{name}/{variant}/{tile}"] += 1


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels are built on a machine with the CUDA toolkit")


def lib_path(src: Path) -> Path:
    blob = Path(src).read_bytes() + " ".join(NVCC_FLAGS).encode()
    for header in sorted(INCLUDE_DIR.glob("*.cuh")):
        blob += header.read_bytes()
    digest = hashlib.sha256(blob).hexdigest()[:16]
    return BUILD_ROOT / f"{Path(src).stem}-{digest}" / f"lib{Path(src).stem}.so"


def build(sources: Iterable[Path]) -> Dict[str, str]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together. Returns {source stem: ptxas log} for
    the sources it built; raises with nvcc's output on a failed build."""
    nvcc = nvcc_path()
    running = []
    for src in map(Path, sources):
        out = lib_path(src)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((proc, src, out, tmp, cmd))
    logs: Dict[str, str] = {}
    failures = []
    for proc, src, out, tmp, cmd in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}) on {src}:\n"
                            f"{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, out)                # atomic: readers see whole files
        (out.parent / "ptxas.log").write_text(log)
        logs[src.stem] = log
    if failures:
        raise RuntimeError("\n".join(failures))
    return logs


def load(src: Path) -> ctypes.CDLL:
    """The loaded library of ``src``, built first if needed."""
    key = str(src)
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            build([src])
            lib = ctypes.CDLL(str(lib_path(src)))
            _LIBS[key] = lib
    return lib


def rows_aligned(*tensors) -> bool:
    """Every row (the contiguous last axis) of every tensor starts on 16
    bytes, as 16-byte loads and ``cp.async`` need: the data pointer and
    each stride of an axis longer than 1."""
    return all(t.data_ptr() % 16 == 0 and all(
        (st * t.element_size()) % 16 == 0
        for n, st in zip(t.shape[:-1], t.stride()[:-1]) if n > 1)
        for t in tensors)


def grad_wanted(*tensors) -> bool:
    """Autograd would record a call on these tensors: grad mode is on and
    one of them (None entries skipped) requires a gradient. A pure
    function of the tensors and the grad mode."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise when a gradient is wanted through a kernel that has no
    backward: its wrapper fills ``torch.empty`` outputs through ctypes,
    which autograd cannot see, so it would return a tensor silently cut
    from the graph. Called first in such a wrapper, before any device
    check."""
    if grad_wanted(*tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and a gradient is "
            f"wanted (grad mode on, an input requires grad); run it under "
            f"torch.no_grad() or detach the inputs")


def check(status: int, what: str) -> None:
    """Raise on a launcher's nonzero ``cudaGetLastError`` code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {status}")


def no_cuda_dtensor(op: str, *ts) -> None:
    """Raise for a CUDA ``DTensor`` among ``ts``: the kernel has no
    sharded form."""
    if any(is_dtensor(t) and t.device.type == "cuda" for t in ts):
        raise NotImplementedError(
            f"{op}: the CUDA kernel takes no DTensor (model-parallel "
            f"serving is not ported); run it on whole tensors")
