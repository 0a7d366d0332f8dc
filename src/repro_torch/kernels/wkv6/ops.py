"""Public RWKV6 WKV recurrence: dispatch by device.

A CPU tensor runs the plain PyTorch version (`ref.wkv6_ref`); a CUDA
tensor launches the hand-written kernel; any other device raises. There
is no fallback from one to the other. ``DTensor`` inputs on the CPU (the
dry run's model-parallel steps: batch-sharded or replicated, whole heads
on every rank) run the plain version on each rank's shards; a CUDA
``DTensor`` raises, as model-parallel serving is not ported.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import no_cuda_dtensor
from repro_torch.kernels.wkv6.kernel import wkv6_cuda
from repro_torch.kernels.wkv6.ref import wkv6_ref
from repro_torch.shards import (check_rows_placed, from_local, to_local,
                                whole)

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _kernel_inputs(r, k, v, w, u):
    """The dtypes the kernel takes, by explicit casts: r, k, v stay in
    their dtype when all three are float32 or all bfloat16, else all go
    to float32; w and u go to float32. (Both paths compute in float32,
    so the casts change no result beyond the rounding of the inputs they
    name.)"""
    if not (r.dtype == k.dtype == v.dtype and r.dtype in _KERNEL_DTYPES):
        r, k, v = r.float(), k.float(), v.float()
    return r, k, v, w.float(), u.float()


def wkv6(r, k, v, w, u, *, chunk: int = 128):
    """RWKV6 token-mix recurrence from a zero state; see ref.py.

    r, k, w: (B, H, T, dk); v: (B, H, T, dv); u: (H, dk). Returns
    (y (B, H, T, dv) f32, final_state (B, H, dk, dv) f32). ``chunk`` is
    the reference's time tile; it is accepted for parity with the JAX
    wrapper and changes nothing here (the kernel loops over T itself).
    """
    del chunk
    no_cuda_dtensor("wkv6", r, k, v, w)
    if r.device.type == "cpu":
        # a DTensor's rows on each rank, k/v/w placed as r, u whole
        check_rows_placed(r, "wkv6")
        y, s = wkv6_ref(*(to_local(t, r) for t in (r, k, v, w)), whole(u, r))
        return from_local(y, r), from_local(s, r)
    if r.device.type == "cuda":
        return wkv6_cuda(*_kernel_inputs(r, k, v, w, u))
    raise ValueError(f"wkv6: no kernel for device {r.device}")

