"""Shared building blocks: norms, RoPE / M-RoPE, init helpers,
cross-entropy.

Numerics follow the reference twin: norms reduce in float32 with eps 1e-6
and the population variance, and cast back to the input dtype; RoPE is
the half-split rotation, M-RoPE the same rotation with each frequency's
position taken from one of three (t, h, w) streams.
"""
from __future__ import annotations

import torch

from repro_torch.shards import is_dtensor, shard_range

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


def embed_lookup(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``emb[tokens]``. A ``DTensor`` table split over its vocabulary is
    looked up on each rank's rows (the counterpart of GSPMD's take on a
    vocabulary-sharded table): the table is gathered on its other split
    axes, the tokens on the vocabulary's axes; each rank gives the rows
    its shard holds (zeros elsewhere), and the partial sums over the
    vocabulary's axes are all-reduced."""
    if not is_dtensor(emb):
        return emb[tokens.long()]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = emb.device_mesh
    vocab = [p.is_shard(0) for p in emb.placements]
    tok_pl = tokens.placements if is_dtensor(tokens) \
        else [Replicate()] * mesh.ndim
    tok_pl = [Replicate() if v else p for v, p in zip(vocab, tok_pl)]
    # a rank's table gradient covers its own tokens: a partial sum over
    # the axes that split the tokens
    table = emb.redistribute(mesh, [Shard(0) if v else Replicate()
                                    for v in vocab]).to_local(
        grad_placements=[Shard(0) if v else Partial() if p.is_shard()
                         else Replicate() for v, p in zip(vocab, tok_pl)])
    tl = (tokens.redistribute(mesh, tok_pl).to_local()
          if is_dtensor(tokens) else tokens).long()
    lo, n = shard_range(emb, 0)      # this rank's vocabulary rows
    inside = (tl >= lo) & (tl < lo + n)
    rows = torch.where(inside[..., None], table[torch.where(inside, tl - lo,
                                                            0)], 0)
    rows = DTensor.from_local(rows, mesh, [Partial() if v else p for v, p in
                                           zip(vocab, tok_pl)],
                              run_check=False)
    return rows.redistribute(mesh, tok_pl)


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
    sec_id = torch.tensor([j for j, n in enumerate(mrope_sections(hd))
                           for _ in range(n)], device=x.device)  # (hd/2,)
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
    other terms are exact zeros) on one device. On a ``DTensor`` (model
    parallelism) the port contracts too, so a vocabulary shard stays
    where it is and only the (...) row sums are reduced. The two forms
    stay apart: the log-sum-exp written out has the same value as
    ``torch.logsumexp`` but another gradient in the last bits, and the
    contraction costs a pass over (..., C) that the gather does not."""
    logits = logits.float()
    if is_dtensor(logits):
        from torch.distributed.tensor import Replicate
        # max and sums reduced over a split vocabulary: only (...) rows
        # cross the mesh (DTensor's logsumexp would gather the logits)
        m = logits.detach().amax(dim=-1, keepdim=True)
        m = m.redistribute(m.device_mesh, [
            Replicate() if p.is_partial() else p for p in m.placements])
        lse = (m + torch.log(torch.sum(torch.exp(logits - m), dim=-1,
                                       keepdim=True))).squeeze(-1)
        classes = torch.arange(logits.shape[-1], device=logits.device)
        ll = torch.sum(logits * (labels.long().unsqueeze(-1) == classes),
                       dim=-1)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1,
                          labels.long().unsqueeze(-1)).squeeze(-1)
    loss = lse - ll
    if valid is not None:
        valid = valid.float()
        return torch.sum(loss * valid) / torch.clamp(torch.sum(valid),
                                                     min=1.0)
    return torch.mean(loss)


def next_token_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE of position t's logits (B, S, V) against token t + 1 of
    ``labels`` (B, S). On a ``DTensor`` the last position is masked out
    instead of sliced away: the gradient of a slice of split logits would
    be gathered whole."""
    if not is_dtensor(logits):
        return cross_entropy(logits[:, :-1], labels[:, 1:])
    s = logits.shape[1]
    valid = (torch.arange(s, device=logits.device) < s - 1).expand(
        labels.shape)
    nxt = torch.cat([labels[:, 1:], labels[:, :1]], dim=1)   # roll by -1
    return cross_entropy(logits, nxt, valid)
