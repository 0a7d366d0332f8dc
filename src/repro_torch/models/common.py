"""Shared building blocks: norms, RoPE / M-RoPE, init helpers,
cross-entropy.

Numerics follow the reference twin: norms reduce in float32 with eps 1e-6
and the population variance, and cast back to the input dtype; RoPE is
the half-split rotation, M-RoPE the same rotation with each frequency's
position taken from one of three (t, h, w) streams.
"""
from __future__ import annotations

import torch

NORM_EPS = 1e-6


# ---------------------------------------------------------------- init utils

def dense_init(gen: torch.Generator, fan_in: int, fan_out: int,
               dtype: torch.dtype, device=None) -> torch.Tensor:
    scale = fan_in ** -0.5
    w = torch.randn((fan_in, fan_out), generator=gen, dtype=torch.float32,
                    device=device or gen.device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype, device=None) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device or gen.device)
    return (w * 0.02).to(dtype)


# --------------------------------------------------------------------- norms

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = NORM_EPS) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = NORM_EPS) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def init_norm(d: int, kind: str, dtype: torch.dtype, device=None):
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def apply_norm(x: torch.Tensor, p, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


# ---------------------------------------------------------------------- RoPE

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)         # (hd/2,)
    ang = positions[..., None].float() * freqs              # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mrope_sections(head_dim: int):
    """Qwen2-VL style (t, h, w) sections over the half-dim: hd 128 ->
    (16, 24, 24), as in the Qwen2-VL config; proportionally smaller at
    smaller head dims."""
    half = head_dim // 2
    t = half // 4
    h = (half - t) // 2
    return (t, h, half - t - h)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                theta: float) -> torch.Tensor:
    """M-RoPE: x (B, S, H, hd); positions3 (3, B, S) int, the (t, h, w)
    streams. Frequency slot j of the half-dim takes its position from the
    stream of the section j falls in."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)         # (hd/2,)
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(mrope_sections(hd), device=x.device))  # (hd/2,)
    pos = positions3[sec_id].permute(1, 2, 0).float()       # (B, S, hd/2)
    ang = pos * freqs
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ losses

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """Mean CE in float32. logits (..., C); labels (...) int; ``valid``
    (...) an optional 0/1 weight per position: the mean is then over the
    valid positions (at least 1).

    The label logit is gathered; the reference contracts with a one-hot
    to keep a vocabulary-sharded layout, which gives the same value (the
    other terms are exact zeros) on one device."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    loss = lse - ll
    if valid is not None:
        valid = valid.float()
        return torch.sum(loss * valid) / torch.clamp(torch.sum(valid),
                                                     min=1.0)
    return torch.mean(loss)
