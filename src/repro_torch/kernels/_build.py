"""Build and load the port's CUDA kernels; keep their launch counts.

Each ``csrc/*.cu`` file exposes ``extern "C"`` launchers and is compiled
on first use with plain ``nvcc`` into a shared library, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). Libraries go
under ``build/torch_kernels/`` at the repository root, one directory per
source content hash, so an edited source rebuilds and an unchanged one
is reused. Nothing here runs at import time: importing the kernel
modules on a machine without ``nvcc`` is fine, building is not.
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

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_ROOT = REPO_ROOT / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

# launches of each kernel's wrapper on a CUDA tensor; read through
# repro_torch.kernels.launch_counts()
LAUNCHES: Dict[str, int] = {}


def register_kernel(name: str) -> None:
    LAUNCHES.setdefault(name, 0)


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


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
    digest = hashlib.sha256(Path(src).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
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


def check(status: int, what: str) -> None:
    """Raise on a launcher's nonzero ``cudaGetLastError`` code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {status}")
