"""Mamba2 (SSD) block of the Zamba2 hybrid architecture.

The twin of the reference's ``models/mamba2.py``: the chunked
state-space-duality form. Within a chunk the token mixing is an
attention-like masked contraction, between chunks a loop carries the
(H, P, N) state; a one-token pass is the exact one-step recurrence. All
decay exponents are differences of a non-increasing cumulative log-decay,
and the causal mask puts ``-inf`` into them before the ``exp``, so no
``exp`` overflows.

The reference computes SSD in plain ``jnp`` outside any Pallas kernel, so
this is plain PyTorch (``torch.einsum``, ``torch.cumsum``) on every
device. Its dtype steps are the reference's: the SSD interior runs in
float32 (``dt``, ``B``, ``C``, ``x`` and the state), the output is cast
back to the model dtype before the gated RMSNorm (eps 1e-6, reduced in
float32), and the conv state is kept in float32.

Streaming state per layer: {"conv": (B, K-1, conv_dim) f32, "ssm": (B, H,
P, N) f32}.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import NORM_EPS, dense_init
from repro_torch.sharding import constrain
from repro_torch.shards import check_rows_placed, from_local, to_local, whole

CONV_K = 4
HEAD_DIM = 64


def init_mamba2(gen: torch.Generator, d_model: int, state_size: int,
                expand: int, dtype: torch.dtype, device=None):
    d_inner = expand * d_model
    nheads = d_inner // HEAD_DIM
    conv_dim = d_inner + 2 * state_size          # x + B + C (one group)
    dev = device or gen.device
    return {
        # in_proj -> [z (d_inner), xBC (conv_dim), dt (nheads)]
        "w_in": dense_init(gen, d_model, d_inner + conv_dim + nheads, dtype,
                           dev),
        "conv_w": (torch.randn((CONV_K, conv_dim), generator=gen,
                               dtype=torch.float32, device=dev)
                   * 0.1).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "a_log": torch.zeros((nheads,), dtype=torch.float32, device=dev),
        "dt_bias": torch.full((nheads,), -2.0, dtype=torch.float32,
                              device=dev),
        "d_skip": torch.ones((nheads,), dtype=torch.float32, device=dev),
        "norm_scale": torch.ones((d_inner,), dtype=dtype, device=dev),
        "w_out": dense_init(gen, d_inner, d_model, dtype, dev),
    }


def _causal_conv(x, w, b, conv_state):
    """Depthwise causal conv of kernel K over x (B, S, C), continuing from
    ``conv_state`` (B, K-1, C). Returns (silu(conv + b), new state), the
    state the last K-1 inputs in x's dtype."""
    xpad = torch.cat([conv_state.to(x.dtype), x], dim=1)
    new_state = xpad[:, -(CONV_K - 1):, :]
    s = x.shape[1]
    out = xpad[:, 0:s, :] * w[0]
    for i in range(1, CONV_K):
        out = out + xpad[:, i:i + s, :] * w[i]
    return F.silu(out + b), new_state


def _ssd_chunked(xh, bmat, cmat, dt, a, h0, chunk: int):
    """Chunked SSD scan.

    xh: (B, S, H, P); bmat/cmat: (B, S, N); dt: (B, S, H) (post-softplus);
    a: (H,) negative; h0: (B, H, P, N); S a multiple of ``chunk``.
    Returns (y (B, S, H, P), the final state)."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    nc = s // chunk
    if nc * chunk != s:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    xh = xh.reshape(b, nc, chunk, h, p)
    bm = bmat.reshape(b, nc, chunk, n)
    cm = cmat.reshape(b, nc, chunk, n)
    dtc = dt.reshape(b, nc, chunk, h)
    cum = torch.cumsum(dtc * a, dim=2)                  # inclusive, <= 0
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=xh.device).tril()[None, :, :, None]
    hprev, ys = h0, []
    for c in range(nc):
        xc, bc, cc, dc, cumc = xh[:, c], bm[:, c], cm[:, c], dtc[:, c], \
            cum[:, c]
        # inter-chunk: y_t += (C_t . h_prev) exp(cum_t)
        y_inter = torch.einsum("bcn,bhpn,bch->bchp", cc, hprev,
                               torch.exp(cumc))
        # intra-chunk: M[t, s] = (C_t . B_s) exp(cum_t - cum_s) dt_s, s <= t
        qk = torch.einsum("btn,bsn->bts", cc, bc)
        dec = (cumc[:, :, None, :] - cumc[:, None, :, :]).masked_fill(
            ~causal, float("-inf"))
        m = qk[:, :, :, None] * torch.exp(dec) * dc[:, None, :, :]
        y_intra = torch.einsum("btsh,bshp->bthp", m, xc)
        # h' = exp(cum_C) h + sum_s exp(cum_C - cum_s) dt_s B_s x_s^T
        dec_last = torch.exp(cumc[:, -1:, :] - cumc)
        upd = torch.einsum("bch,bch,bcn,bchp->bhpn", dec_last, dc, bc, xc)
        hprev = torch.exp(cumc[:, -1])[:, :, None, None] * hprev + upd
        ys.append(y_inter + y_intra)
    return torch.stack(ys, dim=1).reshape(b, s, h, p), hprev


def mamba2_forward(p, x, state, *, state_size: int, expand: int,
                   chunk: int = 128):
    """x: (B, S, D); state: {"conv": (B, K-1, C), "ssm": (B, H, P, N)}.
    Returns (out (B, S, D), new state)."""
    b, s, d = x.shape
    d_inner = expand * d
    nheads = d_inner // HEAD_DIM
    n = state_size
    # under a bound mesh: the input whole over "model", the in-projection
    # gathered (its split into z, x, B, C, dt cuts across any shard) and
    # the out-projection's partial sums reduced
    x = constrain(x, "batch", None, None)
    zxbcdt = constrain(x @ p["w_in"], "batch", None, None)
    z, xbc, dt_raw = torch.split(zxbcdt, [d_inner, d_inner + 2 * n, nheads],
                                 dim=-1)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                 state["conv"])
    xs, bmat, cmat = torch.split(xbc, [d_inner, n, n], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])     # (B, S, H)
    a = -torch.exp(p["a_log"])                          # (H,) negative
    xh = xs.reshape(b, s, nheads, HEAD_DIM).float()
    if s == 1:
        # decode: the exact single recurrence step
        dec = torch.exp(dt[:, 0] * a[None])             # (B, H)
        upd = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0],
                           bmat[:, 0].float(), xh[:, 0])
        hnew = dec[:, :, None, None] * state["ssm"] + upd
        y = torch.einsum("bn,bhpn->bhp", cmat[:, 0].float(), hnew)[:, None]
    else:
        pad = (-s) % chunk
        xp, bp, cp, dtp = xh, bmat, cmat, dt
        if pad:
            xp = F.pad(xh, (0, 0, 0, 0, 0, pad))
            bp = F.pad(bmat, (0, 0, 0, pad))
            cp = F.pad(cmat, (0, 0, 0, pad))
            dtp = F.pad(dt, (0, 0, 0, pad))
        # on each rank's batch rows (every head whole); ``a`` whole, the
        # state at the rank's rows
        check_rows_placed(xp, "mamba2 SSD scan")
        y, hnew = _ssd_chunked(
            *(to_local(t, xp) for t in (xp, bp.float(), cp.float(), dtp)),
            whole(a, xp), to_local(state["ssm"], xp), chunk)
        y, hnew = from_local(y, xp), from_local(hnew, xp)
        y = y[:, :s]
    y = y + p["d_skip"][None, None, :, None] * xh
    y = y.reshape(b, s, d_inner).to(x.dtype)
    # gated RMSNorm (Mamba2 style)
    y = y * F.silu(z)
    y32 = y.float()
    var = torch.mean(torch.square(y32), dim=-1, keepdim=True)
    y = (y32 * torch.rsqrt(var + NORM_EPS)
         * p["norm_scale"].float()).to(x.dtype)
    return (constrain(y @ p["w_out"], "batch", None, None),
            {"conv": new_conv.float(), "ssm": hnew})


def init_mamba2_state(batch: int, d_model: int, state_size: int,
                      expand: int, device=None):
    d_inner = expand * d_model
    nheads = d_inner // HEAD_DIM
    conv_dim = d_inner + 2 * state_size
    return {
        "conv": torch.zeros((batch, CONV_K - 1, conv_dim),
                            dtype=torch.float32, device=device),
        "ssm": torch.zeros((batch, nheads, HEAD_DIM, state_size),
                           dtype=torch.float32, device=device),
    }
