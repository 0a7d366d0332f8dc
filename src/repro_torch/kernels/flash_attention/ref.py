"""Plain PyTorch version of block attention (causal / sliding-window, GQA).

The CPU path of `ops.attention` and the oracle the CUDA kernel is held
against on the card. Materializes the (Sq, Skv) logits in float32.
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
