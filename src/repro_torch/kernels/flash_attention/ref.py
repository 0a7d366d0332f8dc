"""Plain PyTorch versions of block attention (causal / sliding-window, GQA)
and of its gradient.

`gqa_ref` is the CPU path of `ops.attention` and the oracle the CUDA
kernel is held against on the card; `attention_backward` is the CPU path
of `ops.flash_attention_backward` and the backward kernel's oracle;
`attention_lse_ref` the oracle of the row log-sum-exp the forward kernel
saves. Each materializes the (Sq, Skv) logits in float32.
"""
from __future__ import annotations

import torch


def attention_mask(sq: int, skv: int, causal: bool, window: int, device):
    """(Sq, Skv) bool, True where a query may attend a key; the Sq queries
    are the last Sq positions of the Skv timeline."""
    q_pos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    k_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    return mask


def mha_ref(q, k, v, *, causal: bool = True, window: int = 0,
            scale: float | None = None):
    """q: (B, H, Sq, d); k, v: (B, H, Skv, d). Sq positions are the LAST
    Sq positions of the Skv timeline (decode: Sq=1, Skv=cache)."""
    _, _, sq, d = q.shape
    skv = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = attention_mask(sq, skv, causal, window, q.device)
    logits = logits.masked_fill(~mask, -1e30)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def gqa_ref(q, k, v, **kw):
    """q: (B, Hq, Sq, d); k, v: (B, Hkv, Skv, d) with Hq % Hkv == 0."""
    hq, hkv = q.shape[1], k.shape[1]
    if hq != hkv:
        rep = hq // hkv
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    return mha_ref(q, k, v, **kw)


def attention_lse_ref(q, k, *, causal: bool = True, window: int = 0,
                      scale: float | None = None):
    """Each query row's log-sum-exp of its visible scaled logits, float32
    (B, Hq, Sq); +inf for a row with no key to attend (so that exp(s -
    lse) is 0 for all of its keys). q: (B, Hq, Sq, d); k: (B, Hkv, Skv,
    d), Hq % Hkv == 0."""
    _, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    kf = k.float().repeat_interleave(hq // hkv, dim=1)
    logits = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    mask = attention_mask(sq, skv, causal, window, q.device)
    lse = torch.logsumexp(logits.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.where(mask.any(-1), lse, torch.full_like(lse, float("inf")))


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
                       scale: float, lse=None):
    """(dq, dk, dv) of ``out = softmax(q kᵀ · scale + mask) v`` for GQA.

    q, out, dout: (B, Hq, Sq, d); k, v: (B, Hkv, Skv, d), Hq % Hkv == 0.
    Recomputes the float32 logits from q and k and the probabilities P
    from them: given ``lse`` (the forward's float32 (B, Hq, Sq) row
    log-sum-exp, `attention_lse_ref`) as P = exp(S · scale − lse), else
    as the softmax. Then dP = dO·Vᵀ, dS = P∘(dP − rowsum(dO∘O)),
    dQ = dS·K·scale, dK = dSᵀ·Q·scale, dV = Pᵀ·dO, each query head's dK
    and dV summed into its KV group. A query row with no key to attend
    (the kernel's output is exactly 0 there, its lse +inf) gets P = 0 and
    so no gradient. Works in float32; the gradients come back in the
    inputs' dtypes.

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
        return _backward_slice(q, k, v, out, dout, mask, scale, lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    for bs, gs in slices:
        hs = slice(gs.start * rep, gs.stop * rep)
        dq[bs, hs], dk[bs, gs], dv[bs, gs] = _backward_slice(
            q[bs, hs], k[bs, gs], v[bs, gs], out[bs, hs], dout[bs, hs],
            mask, scale, None if lse is None else lse[bs, hs])
    return dq, dk, dv


def _backward_slice(q, k, v, out, dout, mask, scale: float, lse=None):
    """`attention_backward` of one slice: its float32 (Sq, Skv)
    temporaries are P and dS, each made in place."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep = hq // hkv
    qf, of, gf = q.float(), out.float(), dout.float()
    kf = k.float().repeat_interleave(rep, dim=1)           # (B, Hq, Skv, d)
    vf = v.float().repeat_interleave(rep, dim=1)
    p = torch.matmul(qf, kf.transpose(-1, -2)).mul_(scale)  # the logits
    if lse is None:
        p.masked_fill_(~mask, -1e30)
        p.sub_(p.amax(-1, keepdim=True)).exp_().masked_fill_(~mask, 0.0)
        denom = p.sum(-1, keepdim=True)
        p.div_(torch.where(denom > 0, denom, torch.ones_like(denom)))
    else:
        p.sub_(lse.float().unsqueeze(-1)).exp_().masked_fill_(~mask, 0.0)
    ds = torch.matmul(gf, vf.transpose(-1, -2))        # dP (B, Hq, Sq, Skv)
    delta = torch.sum(gf * of, dim=-1, keepdim=True)        # rowsum(dO∘O)
    ds.sub_(delta).mul_(p)                             # dS = P∘(dP − δ)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale    # (B, Hq, Skv, d)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dk = dk.reshape(b, hkv, rep, skv, d).sum(2)
    dv = dv.reshape(b, hkv, rep, skv, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
