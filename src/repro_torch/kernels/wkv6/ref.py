"""Plain PyTorch version of the RWKV6 (Finch) WKV recurrence.

The CPU path of `ops.wkv6` and the oracle the CUDA kernel is held against
on the card. Per head, with state S in R^{dk x dv}, data-dependent decay
w_t and bonus u:

    y_t[j] = sum_i r_t[i] * (S_{t-1}[i,j] + u[i] * k_t[i] * v_t[j])
    S_t    = diag(w_t) @ S_{t-1} + k_t v_t^T

All math in float32: a loop over T of batched (B, H, dk, dv) tensor ops.
"""
from __future__ import annotations

import torch


def wkv6_ref(r, k, v, w, u, initial_state=None):
    """r, k, w: (B, H, T, dk); v: (B, H, T, dv); u: (H, dk).

    Returns (y (B, H, T, dv) f32, final_state (B, H, dk, dv) f32)."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    r, k, v, w = (x.float() for x in (r, k, v, w))
    uk = u.float()[None, :, :, None]                       # (1, H, dk, 1)
    s = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
         if initial_state is None else initial_state.float())
    ys = []
    for i in range(t):
        kv = k[:, :, i, :, None] * v[:, :, i, None, :]     # (B, H, dk, dv)
        ys.append(((s + uk * kv) * r[:, :, i, :, None]).sum(dim=-2))
        s = w[:, :, i, :, None] * s + kv
    return torch.stack(ys, dim=2), s
