#!/usr/bin/env python3
"""Registers, spills, shared memory and resident blocks per SM of every
kernel in a CUDA source, as the card's driver reports them.

    python3 tools/kernel_occupancy.py SOURCE.cu --threads N [--include DIR]

On a machine with a CUDA GPU and the toolkit: compiles SOURCE with the
port's nvcc flags into a cubin (``-Xptxas -v`` printed), loads it through
the driver API, and prints for each kernel its registers per thread,
local (spill) bytes per thread, static shared memory per block and the
blocks of N threads one SM holds (``cuOccupancyMaxActiveBlocksPerMultiprocessor``,
with the shared-memory carveout at its maximum). Works on any source,
so an older revision of a kernel can be read beside the current one.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CU_FUNC_ATTRIBUTE = {"shared_bytes": 1, "local_bytes": 3, "registers": 4}
CU_FUNC_ATTRIBUTE_PREFERRED_SHARED_MEMORY_CARVEOUT = 9
CARVEOUT_MAX_SHARED = 100


def _check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what}: CUresult {status}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source", type=Path)
    ap.add_argument("--threads", type=int, required=True,
                    help="threads per block the kernels are launched with")
    ap.add_argument("--include", type=Path, action="append", default=[],
                    help="extra include directory (the port's own is added)")
    args = ap.parse_args()

    import torch
    from repro_torch.kernels._build import INCLUDE_DIR, nvcc_path
    if not torch.cuda.is_available():
        print("kernel_occupancy.py: no CUDA GPU", file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda")      # the primary context, made current

    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "k.cubin"
        cmd = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-cubin", "-Xptxas", "-v",
               "-I", str(INCLUDE_DIR), *sum((["-I", str(d)] for d in
                                             args.include), []),
               "-o", str(cubin), str(args.source)]
        log = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if log.returncode != 0:
            print(log.stdout + log.stderr, file=sys.stderr)
            return 1
        for line in (log.stdout + log.stderr).splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                print(f"  ptxas: {line.strip()}")
        image = cubin.read_bytes()

    cu = ctypes.CDLL("libcuda.so.1")
    module = ctypes.c_void_p()
    _check(cu.cuModuleLoadData(ctypes.byref(module), image), "cuModuleLoadData")
    count = ctypes.c_uint()
    _check(cu.cuModuleGetFunctionCount(ctypes.byref(count), module),
           "cuModuleGetFunctionCount")
    funcs = (ctypes.c_void_p * count.value)()
    _check(cu.cuModuleEnumerateFunctions(funcs, count, module),
           "cuModuleEnumerateFunctions")
    print(f"{args.source} at {args.threads} threads per block, "
          f"{torch.cuda.get_device_name(0)}:")
    for fn in funcs:
        fn = ctypes.c_void_p(fn)
        name = ctypes.c_char_p()
        _check(cu.cuFuncGetName(ctypes.byref(name), fn), "cuFuncGetName")
        _check(cu.cuFuncSetAttribute(
            fn, CU_FUNC_ATTRIBUTE_PREFERRED_SHARED_MEMORY_CARVEOUT,
            CARVEOUT_MAX_SHARED), "cuFuncSetAttribute")
        attrs = {}
        for key, code in CU_FUNC_ATTRIBUTE.items():
            val = ctypes.c_int()
            _check(cu.cuFuncGetAttribute(ctypes.byref(val), code, fn),
                   "cuFuncGetAttribute")
            attrs[key] = val.value
        blocks = ctypes.c_int()
        _check(cu.cuOccupancyMaxActiveBlocksPerMultiprocessor(
            ctypes.byref(blocks), fn, args.threads, ctypes.c_size_t(0)),
            "cuOccupancyMaxActiveBlocksPerMultiprocessor")
        print(f"  {blocks.value:3d} blocks/SM  {attrs['registers']:3d} "
              f"registers  {attrs['local_bytes']:4d} B local  "
              f"{attrs['shared_bytes']:6d} B shared  {name.value.decode()}")
    _check(cu.cuModuleUnload(module), "cuModuleUnload")
    return 0


if __name__ == "__main__":
    sys.exit(main())
