"""GQA attention: prefill (full-sequence causal, sliding-window or
bidirectional), ring-buffer KV-cache decode, and cross-attention
(enc-dec).

Layout conventions (as in the reference twin):
  hidden x           : (B, S, D)
  q/k/v (internal)   : (B, S, H, hd)
  KV cache per layer : {"k": (B, W, Hkv, hd), "v": same, "pos": (B, W) i32}
where W is the cache window (the total sequence length, or the sliding
window). "pos" holds the absolute position in each ring slot (-1 =
empty), so the ring-buffer mask is exact from the first token. The
one-token decode is plain PyTorch, as the reference's is plain einsum
outside any Pallas kernel. Under M-RoPE (``mrope``) positions are the
(3, B, S) (t, h, w) streams.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import attention as flash_attention
from repro_torch.models.common import (apply_mrope, apply_rope, dense_init,
                                       rmsnorm)


def init_attention(gen: torch.Generator, d_model: int, num_heads: int,
                   num_kv_heads: int, head_dim: int, *, qkv_bias: bool,
                   qk_norm: bool, dtype: torch.dtype, device=None):
    p = {
        "wq": dense_init(gen, d_model, num_heads * head_dim, dtype, device),
        "wk": dense_init(gen, d_model, num_kv_heads * head_dim, dtype, device),
        "wv": dense_init(gen, d_model, num_kv_heads * head_dim, dtype, device),
        "wo": dense_init(gen, num_heads * head_dim, d_model, dtype, device),
    }
    dev = p["wq"].device
    if qkv_bias:
        p["bq"] = torch.zeros((num_heads * head_dim,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((num_kv_heads * head_dim,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((num_kv_heads * head_dim,), dtype=dtype, device=dev)
    if qk_norm:
        p["q_norm"] = torch.ones((head_dim,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((head_dim,), dtype=dtype, device=dev)
    return p


def _project_qkv(p, x, num_heads, num_kv_heads, head_dim, *,
                 qk_norm: bool, rope_theta: float, mrope: bool, positions):
    """Project and rotate. positions: (B, S), or (3, B, S) under M-RoPE."""
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, num_heads, head_dim)
    k = k.reshape(b, s, num_kv_heads, head_dim)
    v = v.reshape(b, s, num_kv_heads, head_dim)
    if qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if rope_theta and positions is not None:
        rotate = apply_mrope if mrope else apply_rope
        q = rotate(q, positions, rope_theta)
        k = rotate(k, positions, rope_theta)
    return q, k, v


def attn_prefill(p, x, positions, *, num_heads, num_kv_heads, head_dim,
                 causal: bool = True, window: int = 0,
                 rope_theta: float = 10000.0, qk_norm: bool = False,
                 mrope: bool = False, return_kv: bool = False):
    """Full-sequence self-attention (cross-attention is `cross_attn_kv`
    + `cross_attn_apply`). ``return_kv`` also returns the rotated (k, v),
    (B, S, Hkv, hd) each, that a prefill writes into the decode cache."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, num_heads, num_kv_heads, head_dim,
                           qk_norm=qk_norm, rope_theta=rope_theta,
                           mrope=mrope, positions=positions)
    # the kernel takes the (B, H, S, hd) views as strided tensors, and
    # lays its output out (B, S, H, hd), so both transposes are free there
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, window=window)
    out = out.transpose(1, 2).reshape(b, s, num_heads * head_dim)
    out = out @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


def init_cache(batch: int, window: int, num_kv_heads: int, head_dim: int,
               dtype: torch.dtype, device=None):
    zeros = torch.zeros((batch, window, num_kv_heads, head_dim), dtype=dtype,
                        device=device)
    return {"k": zeros, "v": zeros.clone(),
            "pos": torch.full((batch, window), -1, dtype=torch.int32,
                              device=device)}


def fill_cache(cache, k, v, start: int = 0):
    """Write a prefill's (B, S, Hkv, hd) keys/values into a copy of the
    cache at their ring slots (absolute position % window), so later
    ring-buffer decode writes stay aligned."""
    s = k.shape[1]
    w = cache["k"].shape[1]
    assert s <= w, "prefill longer than cache window"
    pos = torch.arange(s, dtype=torch.int32, device=k.device) + start
    slots = (pos % w).long()
    out = {name: t.clone() for name, t in cache.items()}
    out["k"][:, slots] = k.to(out["k"].dtype)
    out["v"][:, slots] = v.to(out["v"].dtype)
    out["pos"][:, slots] = pos[None]
    return out


def attn_decode(p, x, cache, cur_index: int, *, num_heads, num_kv_heads,
                head_dim, window: int = 0, rope_theta: float = 10000.0,
                qk_norm: bool = False, mrope: bool = False):
    """One-token decode. x: (B, 1, D); ``cur_index`` the position of the
    new token. Returns (out (B, 1, D), new_cache); the input cache is not
    written."""
    b = x.shape[0]
    w = cache["k"].shape[1]
    pos1 = torch.full((3, b, 1) if mrope else (b, 1), cur_index,
                      dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(
        p, x, num_heads, num_kv_heads, head_dim, qk_norm=qk_norm,
        rope_theta=rope_theta, mrope=mrope, positions=pos1)

    slot = cur_index % w
    new_cache = {name: t.clone() for name, t in cache.items()}
    new_cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    new_cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    new_cache["pos"][:, slot] = cur_index

    # grouped-query scores against the whole window, in float32
    g = num_heads // num_kv_heads
    qg = q.reshape(b, num_kv_heads, g, head_dim).float()
    kf = new_cache["k"].float()                       # (B, W, Hkv, hd)
    vf = new_cache["v"].float()
    scores = torch.einsum("bngd,bwnd->bngw", qg, kf) * (head_dim ** -0.5)
    pos = new_cache["pos"]                            # (B, W)
    valid = (pos >= 0) & (pos <= cur_index)
    if window:
        valid &= pos > cur_index - window
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngw,bwnd->bngd", probs, vf)
    out = out.reshape(b, 1, num_heads * head_dim).to(x.dtype)
    return out @ p["wo"], new_cache


def cross_attn_kv(p, enc_out, *, num_kv_heads, head_dim):
    """Cross-attention K/V from the encoder output, (B, S, Hkv, hd) each
    (no RoPE)."""
    b, s, _ = enc_out.shape
    k = (enc_out @ p["wk"]).reshape(b, s, num_kv_heads, head_dim)
    v = (enc_out @ p["wv"]).reshape(b, s, num_kv_heads, head_dim)
    return k, v


def cross_attn_apply(p, x, kv, *, num_heads, num_kv_heads, head_dim):
    """Decoder cross-attention of ``x`` (B, Sq, D) against precomputed
    encoder (k, v) (B, Skv, Hkv, hd), Hkv = ``num_kv_heads``: the block
    attention kernel, not causal."""
    b, s, _ = x.shape
    k, v = kv
    assert k.shape[2] == v.shape[2] == num_kv_heads, (k.shape, num_kv_heads)
    q = (x @ p["wq"]).reshape(b, s, num_heads, head_dim)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=False, window=0)
    out = out.transpose(1, 2).reshape(b, s, num_heads * head_dim)
    return out @ p["wo"]
