"""Plain PyTorch version of the RWKV6 (Finch) WKV recurrence.

The CPU path of `ops.wkv6` and the oracle the CUDA kernel is held against
on the card. Per head, with state S in R^{dk x dv}, data-dependent decay
w_t and bonus u:

    y_t[j] = sum_i r_t[i] * (S_{t-1}[i,j] + u[i] * k_t[i] * v_t[j])
    S_t    = diag(w_t) @ S_{t-1} + k_t v_t^T

All math in float32: a loop over T of batched (B, H, dk, dv) tensor ops.

`wkv6_backward_ref` is the plain backward of that recurrence, the CUDA
backward kernel's oracle on the card. With G_t = dL/dS_t (G_T the final
state's cotangent, zeros when there is none):

    G_{t-1} = diag(w_t) G_t + r_t dy_t^T
    dr_t    = (S_{t-1} + diag(u * k_t) 1 v_t^T) dy_t
    dk_t    = G_t v_t + r_t * u * (v_t . dy_t)
    dv_t    = G_t^T k_t + (sum_i r_t u k_t) dy_t
    dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
    du      = sum_{b,t} r_t * k_t * (v_t . dy_t)
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


def wkv6_backward_ref(r, k, v, w, u, dy, ds_final=None):
    """The gradients (dr, dk, dv, dw, du) of `wkv6_ref` from a zero state,
    given dy (B, H, T, dv), the cotangent of y, and ``ds_final`` (B, H,
    dk, dv), that of the final state (None: zeros).

    A forward loop keeps every S_{t-1}, then a loop over T in reverse
    carries G (the equations in the module docstring). Computes in
    float32, or in float64 when r is float64 (a reading to hold float32
    runs against). dr, dk and dv come back in the dtypes of r, k and v;
    dw (B, H, T, dk) and du (H, dk) in the compute dtype, as the kernel
    returns them."""
    ct = torch.float64 if r.dtype == torch.float64 else torch.float32
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    rf, kf, vf, wf, dyf = (x.to(ct) for x in (r, k, v, w, dy))
    uf = u.to(ct)[None]                                     # (1, H, dk)
    s = torch.zeros((b, h, dk, dv), dtype=ct, device=r.device)
    states = []
    for i in range(t):
        states.append(s)
        s = wf[:, :, i, :, None] * s + kf[:, :, i, :, None] * vf[:, :, i, None, :]
    g = (torch.zeros_like(s) if ds_final is None else ds_final.to(ct))
    vdy = (vf * dyf).sum(-1)                                # (B, H, T)
    dr, dk_, dv_, dw = (torch.empty_like(x) for x in (rf, kf, vf, wf))
    for i in reversed(range(t)):
        ri, ki, vi, di = rf[:, :, i], kf[:, :, i], vf[:, :, i], dyf[:, :, i]
        sp = states[i]
        bonus = vdy[:, :, i, None]
        dr[:, :, i] = (sp * di[:, :, None, :]).sum(-1) + uf * ki * bonus
        dk_[:, :, i] = (g * vi[:, :, None, :]).sum(-1) + ri * uf * bonus
        dv_[:, :, i] = (g * ki[..., None]).sum(-2) \
            + (ri * uf * ki).sum(-1, keepdim=True) * di
        dw[:, :, i] = (g * sp).sum(-1)
        g = wf[:, :, i, :, None] * g + ri[..., None] * di[:, :, None, :]
    du = (rf * kf * vdy[..., None]).sum((0, 2))
    return dr.to(r.dtype), dk_.to(k.dtype), dv_.to(v.dtype), dw, du
