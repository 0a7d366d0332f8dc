"""Public block attention: GQA shapes, dispatch by device, and its
gradient.

A CPU tensor runs the plain PyTorch version (`ref.gqa_ref`, whose
gradient autograd takes); a CUDA tensor launches the hand-written kernel,
which resolves GQA by index; any other device raises. There is no
fallback from one to the other.

On the card a gradient goes through `FlashAttention`: its forward is the
kernel, its backward `attention_backward`. The reference has no backward
kernel either (XLA differentiates its plain attention outside any Pallas
kernel), so the backward's products are ``torch.matmul``; it is written
out here rather than taken from autograd of the plain version, which
stays off the card's path.

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
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_mask, gqa_ref
from repro_torch.shards import is_dtensor


# the float32 (Sq, Skv) temporaries `attention_backward` holds at once
# (P and dS) over the query heads of one slice; a call whose whole
# temporaries would exceed it runs over slices of (batch, KV group) that
# keep within it
BACKWARD_TEMP_BYTES = 2 << 30
BACKWARD_TEMPS = 2


def backward_slices(b: int, hkv: int, rep: int, sq: int, skv: int):
    """The (batch, KV-group) slices `attention_backward` runs: a list of
    (batch slice, group slice). One slice for the whole call when its
    BACKWARD_TEMPS float32 (Sq, Skv) temporaries over every query head
    fit BACKWARD_TEMP_BYTES; else, for each sample, runs of as many KV
    groups as fit (at least one, every query head of it). A pure function
    of the shapes."""
    group = BACKWARD_TEMPS * rep * sq * skv * 4     # bytes of one KV group
    groups = max(1, BACKWARD_TEMP_BYTES // group)
    if groups >= b * hkv:
        return [(slice(0, b), slice(0, hkv))]
    return [(slice(i, i + 1), slice(g, min(hkv, g + groups)))
            for i in range(b) for g in range(0, hkv, groups)]


def attention_backward(q, k, v, out, dout, *, causal: bool, window: int,
                       scale: float):
    """(dq, dk, dv) of ``out = softmax(q kᵀ · scale + mask) v`` for GQA.

    q, out, dout: (B, Hq, Sq, d); k, v: (B, Hkv, Skv, d), Hq % Hkv == 0.
    Recomputes the float32 logits and softmax from q and k, then
    dP = dO·Vᵀ, dS = P∘(dP − rowsum(dO∘O)), dQ = dS·K·scale,
    dK = dSᵀ·Q·scale, dV = Pᵀ·dO, each query head's dK and dV summed into
    its KV group. A query row with no key to attend (the kernel's output
    is exactly 0 there) gets P = 0 and so no gradient. Works in float32;
    the gradients come back in the inputs' dtypes.

    The call runs over the (batch, KV-group) slices of `backward_slices`,
    so its float32 (Sq, Skv) temporaries stay within BACKWARD_TEMP_BYTES:
    a slice holds every query head of its groups, so no sum crosses a
    slice and each slice's arithmetic is the whole call's.
    """
    b, hq, sq, _ = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep = hq // hkv
    mask = attention_mask(sq, skv, causal, window, q.device)
    slices = backward_slices(b, hkv, rep, sq, skv)
    if len(slices) == 1:
        return _backward_slice(q, k, v, out, dout, mask, scale)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    for bs, gs in slices:
        hs = slice(gs.start * rep, gs.stop * rep)
        dq[bs, hs], dk[bs, gs], dv[bs, gs] = _backward_slice(
            q[bs, hs], k[bs, gs], v[bs, gs], out[bs, hs], dout[bs, hs],
            mask, scale)
    return dq, dk, dv


def _backward_slice(q, k, v, out, dout, mask, scale: float):
    """`attention_backward` of one slice: its float32 (Sq, Skv)
    temporaries are P and dS, each made in place."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep = hq // hkv
    qf, of, gf = q.float(), out.float(), dout.float()
    kf = k.float().repeat_interleave(rep, dim=1)           # (B, Hq, Skv, d)
    vf = v.float().repeat_interleave(rep, dim=1)
    p = torch.matmul(qf, kf.transpose(-1, -2)).mul_(scale)  # the logits
    p.masked_fill_(~mask, -1e30)
    p.sub_(p.amax(-1, keepdim=True)).exp_().masked_fill_(~mask, 0.0)
    denom = p.sum(-1, keepdim=True)
    p.div_(torch.where(denom > 0, denom, torch.ones_like(denom)))
    ds = torch.matmul(gf, vf.transpose(-1, -2))        # dP (B, Hq, Sq, Skv)
    delta = torch.sum(gf * of, dim=-1, keepdim=True)        # rowsum(dO∘O)
    ds.sub_(delta).mul_(p)                             # dS = P∘(dP − δ)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale    # (B, Hq, Skv, d)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dk = dk.reshape(b, hkv, rep, skv, d).sum(2)
    dv = dv.reshape(b, hkv, rep, skv, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """The CUDA kernel's forward with `attention_backward` as its
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out = flash_attention_cuda(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = attention_backward(
            q, k, v, out, dout, causal=ctx.causal, window=ctx.window,
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
