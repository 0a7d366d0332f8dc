"""Public RWKV6 WKV recurrence: dispatch by device.

A CPU tensor runs the plain PyTorch version (`ref.wkv6_ref`, whose
gradient autograd takes); a CUDA tensor launches the hand-written kernel;
any other device raises. There is no fallback from one to the other.

On the card a gradient goes through `WKV6`: its forward is the kernel,
its backward the hand-written backward kernel (`wkv6_backward_cuda`).
The reference has no backward kernel (XLA differentiates its plain scan).

``DTensor`` inputs (model parallelism) run the same dispatch on each
rank's shards (`_wkv6_dtensor`): r, k, v and w split over the batch and
over heads (the "model" split of the ``wr``/``wk``/``wv`` projections) or
replicated, ``u`` sliced to the rank's heads; the result and the state
come back as ``DTensor``s placed as ``r``. Heads are independent, so a
head shard needs no communication; a split inside a head (over time or a
head's channels) raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import grad_wanted
from repro_torch.kernels.wkv6.kernel import wkv6_backward_cuda, wkv6_cuda
from repro_torch.kernels.wkv6.ref import wkv6_ref
from repro_torch.shards import (from_local, is_dtensor, shard_range,
                                to_local, whole)

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


class WKV6(torch.autograd.Function):
    """The CUDA kernel's forward with `wkv6_backward_cuda` as its backward:
    gradients for r, k, v, w and u, given y's cotangent and the final
    state's (None when the state is unused)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.set_materialize_grads(False)
        y, s = wkv6_cuda(r, k, v, w, u)
        ctx.save_for_backward(r, k, v, w, u)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        r, k, v, w, u = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        return wkv6_backward_cuda(r, k, v, w, u, dy, ds)


def wkv6(r, k, v, w, u, *, chunk: int = 128):
    """RWKV6 token-mix recurrence from a zero state; see ref.py.

    r, k, w: (B, H, T, dk); v: (B, H, T, dv); u: (H, dk). Returns
    (y (B, H, T, dv) f32, final_state (B, H, dk, dv) f32). ``chunk`` is
    the reference's time tile; it is accepted for parity with the JAX
    wrapper and changes nothing here (the kernel loops over T itself). On
    a CUDA tensor that wants a gradient (`_build.grad_wanted`) the call
    goes through `WKV6`, after the casts to the kernel's dtypes (so
    autograd carries them back), else straight to the kernel.
    """
    del chunk
    if is_dtensor(r):
        return _wkv6_dtensor(r, k, v, w, u)
    return _wkv6_local(r, k, v, w, u)


def _wkv6_local(r, k, v, w, u):
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u)
    if r.device.type == "cuda":
        if grad_wanted(r, k, v, w, u):
            return WKV6.apply(*_kernel_inputs(r, k, v, w, u))
        return wkv6_cuda(*_kernel_inputs(r, k, v, w, u))
    raise ValueError(f"wkv6: no kernel for device {r.device}")


def _wkv6_dtensor(r, k, v, w, u):
    """`wkv6` of ``DTensor`` r/k/v/w (B, H, T, ·) on each rank's batch
    and head shard: k, v and w placed as r, ``u`` (H, dk) whole and
    sliced to r's heads."""
    if not all(p.is_replicate() or p.is_shard(0) or p.is_shard(1)
               for p in r.placements):
        raise ValueError(
            f"wkv6: r placed {r.placements}; the recurrence takes whole "
            f"heads on each rank (Shard on the batch or head axis, or "
            f"Replicate), not a split over time or inside a head")
    lo, n = shard_range(r, 1)
    y, s = _wkv6_local(*(to_local(t, r) for t in (r, k, v, w)),
                       whole(u, r)[lo:lo + n])
    return from_local(y, r), from_local(s, r)
