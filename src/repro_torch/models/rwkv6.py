"""RWKV6 (Finch) block: time-mix with data-dependent decay + channel-mix.

The twin of the reference's ``models/rwkv6.py`` (arXiv:2404.05892): a
static per-projection lerp with a LoRA on the decay, the bonus term u, a
SiLU output gate and the squared-ReLU channel mix. Token mixing over a
multi-token pass runs through `kernels.wkv6.ops.wkv6` (plain version on a
CPU tensor, the CUDA kernel on a CUDA tensor); a single-token pass is the
exact one-step recurrence and needs no kernel.

The dtype steps are the reference's: the token-shift ``last`` state is
float32 and the shifted ``prev`` is cast back to the compute dtype; the
lerps run in the compute dtype; the decay's LoRA runs in the compute
dtype and its clip/exp/exp in float32, so ``w`` is float32; ``y`` comes
back float32 and is cast to the compute dtype before the output gate.
Under a bound mesh a full-sequence pass gathers the projections over
"model" once, flat, before the head split, as the reference constrains
them: the recurrence then runs on whole heads of each batch shard.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.models.attention import merge_heads, split_heads
from repro_torch.models.common import dense_init
from repro_torch.sharding import constrain

DECAY_LORA = 32


def _full(shape, val, dtype, dev):
    return torch.full(shape, val, dtype=dtype, device=dev)


def init_time_mix(gen: torch.Generator, d_model: int, num_heads: int,
                  dtype: torch.dtype, device=None):
    """The time-mix leaves of the reference's parameter dict."""
    head_dim = d_model // num_heads
    dev = device or gen.device
    return {
        # time-mix lerp coefficients for r/k/v/w/g
        "mu": _full((5, d_model), 0.5, dtype, dev),
        "wr": dense_init(gen, d_model, d_model, dtype, dev),
        "wk": dense_init(gen, d_model, d_model, dtype, dev),
        "wv": dense_init(gen, d_model, d_model, dtype, dev),
        "wg": dense_init(gen, d_model, d_model, dtype, dev),
        "wo": dense_init(gen, d_model, d_model, dtype, dev),
        # data-dependent decay: w = exp(-exp(decay_base + lora))
        "decay_base": _full((d_model,), -5.0, dtype, dev),
        "decay_a": dense_init(gen, d_model, DECAY_LORA, dtype, dev),
        "decay_b": dense_init(gen, DECAY_LORA, d_model, dtype, dev),
        "bonus": (torch.randn((num_heads, head_dim), generator=gen,
                              dtype=torch.float32, device=dev)
                  * 0.1).to(dtype),
    }


def init_channel_mix(gen: torch.Generator, d_model: int, d_ff: int,
                     dtype: torch.dtype, device=None):
    """The channel-mix leaves of the reference's parameter dict."""
    dev = device or gen.device
    return {
        "mu_cm": _full((2, d_model), 0.5, dtype, dev),
        "cm_wr": dense_init(gen, d_model, d_model, dtype, dev),
        "cm_wk": dense_init(gen, d_model, d_ff, dtype, dev),
        "cm_wv": dense_init(gen, d_ff, d_model, dtype, dev),
    }


def init_rwkv6(gen: torch.Generator, d_model: int, num_heads: int, d_ff: int,
               dtype: torch.dtype, device=None):
    """The reference's parameter dict (time mix and channel mix), drawn
    from ``gen``."""
    return {**init_time_mix(gen, d_model, num_heads, dtype, device),
            **init_channel_mix(gen, d_model, d_ff, dtype, device)}


def _token_shift(x, last):
    """x: (B, S, D); last: (B, D) = hidden before this chunk. Returns
    (shifted x, new last); the shift promotes as the reference's concat
    does (a float32 ``last`` makes it float32)."""
    prev = torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)
    return prev, x[:, -1, :]


def _decay(p, xw):
    lora = torch.tanh(xw @ p["decay_a"]) @ p["decay_b"]
    logw = -torch.exp(torch.clamp(
        p["decay_base"].float() + lora.float(), -10.0, 2.0))
    return torch.exp(logw)  # in (0, 1)


def time_mix(p, x, state, *, num_heads: int, chunk: int = 128):
    """x: (B, S, D); state: (last (B, D), s (B, H, dk, dv)).

    Returns (out (B, S, D), new_state). A multi-token pass starts the
    recurrence from a zero state, as the reference's kernel call does."""
    b, s, d = x.shape
    hd = d // num_heads
    x = constrain(x, "batch", None, None)
    last, wkv_state = state
    prev, new_last = _token_shift(x, last)
    prev = prev.to(x.dtype)         # `last` state is f32; avoid promotion
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xw, xg = (x + (prev - x) * mu[i] for i in range(5))

    def heads(t):                   # (B, S, D) -> (B, H, S, hd) view
        # gathered flat on full-sequence passes only: at decode (s == 1)
        # the gather costs more than it saves, and only whole heads are
        # needed there
        if s > 1:
            return constrain(t, "batch", None, None).reshape(
                b, s, num_heads, hd).transpose(1, 2)
        return split_heads(t, num_heads, hd).transpose(1, 2)

    r = heads(xr @ p["wr"])
    k = heads(xk @ p["wk"])
    v = heads(xv @ p["wv"])
    w = heads(_decay(p, xw))
    g = F.silu(xg @ p["wg"])

    if s == 1:
        # single-token decode: exact one-step recurrence, no kernel needed
        rt, kt, vt, wt = (t[:, :, 0] for t in (r, k, v, w))
        u = p["bonus"].float()[None]
        kv = kt[..., :, None] * vt[..., None, :]
        y = torch.sum((wkv_state + u[..., None] * kv)
                      * rt[..., :, None].float(), dim=-2)
        new_wkv = wt[..., :, None].float() * wkv_state + kv
        y = y[:, :, None, :]
    else:
        y, new_wkv = wkv6(r, k, v, w, p["bonus"], chunk=chunk)
    y = merge_heads(y.transpose(1, 2)).to(x.dtype)
    out = constrain((y * g) @ p["wo"], "batch", None, None)
    return out, (new_last, new_wkv)


def channel_mix(p, x, last):
    """Squared-ReLU channel mix. Returns (out, new_last). Under a bound
    mesh the input is whole over "model" and the hidden split over it."""
    x = constrain(x, "batch", None, None)
    prev, new_last = _token_shift(x, last)
    mu = p["mu_cm"].to(x.dtype)
    xr = x + (prev.to(x.dtype) - x) * mu[0]
    xk = x + (prev.to(x.dtype) - x) * mu[1]
    rcv = torch.sigmoid(xr @ p["cm_wr"])
    kk = constrain(torch.square(F.relu(xk @ p["cm_wk"])), "batch", None,
                   "model")
    return constrain(rcv * (kk @ p["cm_wv"]), "batch", None, None), new_last


def init_rwkv_state(batch: int, d_model: int, num_heads: int, device=None):
    hd = d_model // num_heads
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,  # noqa: E731
                                       device=device)
    return {
        "tm_last": zeros(batch, d_model),
        "cm_last": zeros(batch, d_model),
        "wkv": zeros(batch, num_heads, hd, hd),
    }
