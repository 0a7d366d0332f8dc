"""Public block attention: GQA shapes, dispatch by device, and its
gradient.

A CPU tensor runs the plain PyTorch version (`ref.gqa_ref`, whose
gradient autograd takes); a CUDA tensor launches the hand-written kernel,
which resolves GQA by index; any other device raises. There is no
fallback from one to the other.

On the card a gradient goes through `FlashAttention`: its forward is the
kernel, which also saves each row's log-sum-exp, and its backward the
hand-written backward kernel (`flash_attention_backward`: dQ, dK and dV
recomputed tile by tile from that log-sum-exp, with no (Sq, Skv) tensor
in device memory). The reference has no backward kernel (XLA
differentiates its plain attention outside any Pallas kernel); its plain
counterpart here is `ref.attention_backward`, the CPU path of
`flash_attention_backward` and the kernel's oracle on the card.

Model parallelism: ``DTensor`` q/k/v whose placements keep every head
whole on each rank (``Shard`` on the batch or head axis, or
``Replicate``) run the same dispatch on their local shards (the kernel on
the card, the plain version on the CPU, a gradient through
`FlashAttention` on the card), and the result is the ``DTensor`` of the
local outputs under q's placements. Any other placement raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import grad_wanted
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_backward_cuda, flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import (attention_backward,
                                                     gqa_ref)
from repro_torch.shards import is_dtensor


def flash_attention_backward(q, k, v, out, lse, dout, *, causal: bool,
                             window: int, scale: float):
    """(dq, dk, dv) of block attention from the forward's output and row
    log-sum-exp ``lse`` (float32 (B, Hq, Sq)). A CPU tensor runs the
    plain version (`ref.attention_backward` with ``lse``), a CUDA tensor
    the backward kernel (`kernel.flash_attention_backward_cuda`); any
    other device raises."""
    kw = dict(causal=causal, window=window, scale=scale)
    if q.device.type == "cpu":
        return attention_backward(q, k, v, out, dout, lse=lse, **kw)
    if q.device.type == "cuda":
        return flash_attention_backward_cuda(q, k, v, out, lse, dout, **kw)
    raise ValueError(f"flash_attention_backward: no kernel for device "
                     f"{q.device}")


class FlashAttention(torch.autograd.Function):
    """The CUDA kernel's forward, saving each row's log-sum-exp, with the
    backward kernel (`flash_attention_backward`) as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1:        # the kernel reads rows of head_dim
            dout = dout.contiguous()
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, dout, causal=ctx.causal, window=ctx.window,
            scale=q.shape[-1] ** -0.5)
        return dq, dk, dv, None, None


def attention(q, k, v, *, causal: bool = True, window: int = 0
              ) -> torch.Tensor:
    """GQA block attention.

    q: (B, Hq, Sq, d); k, v: (B, Hkv, Skv, d), Hq % Hkv == 0.
    ``window`` > 0 restricts each query to the previous ``window`` keys.
    On a CUDA tensor that wants a gradient (`_build.grad_wanted`) the
    call goes through `FlashAttention`, else straight to the kernel.
    ``DTensor`` inputs run on their local head shards
    (`_attention_dtensor`).
    """
    if is_dtensor(q):
        return _attention_dtensor(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return gqa_ref(q, k, v, causal=causal, window=window)
    if q.device.type == "cuda":
        if grad_wanted(q, k, v):
            return FlashAttention.apply(q, k, v, causal, window)
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    raise ValueError(f"attention: no kernel for device {q.device}")


def _head_whole(placements) -> bool:
    return all(pl.is_replicate() or pl.is_shard(0) or pl.is_shard(1)
               for pl in placements)


def _attention_dtensor(q, k, v, *, causal: bool, window: int):
    """`attention` of ``DTensor`` q (B, Hq, Sq, d) and k/v (B, Hkv, Skv,
    d) on one mesh: each rank runs its local shards. k and v are placed
    alike; on each mesh axis they are placed as q is, or replicated where
    q splits its heads (KV heads that do not divide the axis), and then
    the rank keeps the KV heads its query heads read."""
    from torch.distributed.tensor import DTensor
    mesh = q.device_mesh
    if not (_head_whole(q.placements) and k.placements == v.placements
            and _head_whole(k.placements)):
        raise ValueError(
            f"attention: q placed {q.placements}, k {k.placements}, v "
            f"{v.placements}; the kernel takes whole heads on each rank "
            f"(Shard on the batch or head axis, or Replicate)")
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    for t in (ql, kl, vl):
        if t.requires_grad:
            # the gradients go back into DTensor views (the head split),
            # which take a contiguous local tensor only
            t.register_hook(torch.Tensor.contiguous)
    rep = q.shape[1] // k.shape[1]
    for m, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        if pq == pk:
            continue
        if not (pq.is_shard(1) and pk.is_replicate()):
            raise ValueError(f"attention: q placed {pq} and k {pk} on mesh "
                             f"axis {m}; they must match, or k/v replicate "
                             f"where q splits its heads")
        # query heads [lo, lo + n) read KV heads lo // rep .. (lo+n-1) // rep
        n = ql.shape[1]
        if n % rep and rep % n:
            raise ValueError(f"attention: {n} local query heads do not "
                             f"tile the GQA groups of {rep}")
        lo = mesh.get_local_rank(m) * n
        kv = slice(lo // rep, (lo + n - 1) // rep + 1)
        kl, vl = kl[:, kv], vl[:, kv]
    out = attention(ql, kl, vl, causal=causal, window=window)
    return DTensor.from_local(out, mesh, q.placements, run_check=False)
