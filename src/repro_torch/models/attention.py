"""GQA attention, prefill side: full-sequence causal, sliding-window or
bidirectional attention over projected, rotated q/k/v.

Layout conventions (as in the reference twin):
  hidden x           : (B, S, D)
  q/k/v (internal)   : (B, S, H, hd)
Decode (KV caches) is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import attention as flash_attention
from repro_torch.models.common import apply_rope, dense_init, rmsnorm


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
    """Project and rotate. positions: (B, S)."""
    if mrope:
        raise NotImplementedError("M-RoPE: not ported yet")
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
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def attn_prefill(p, x, positions, *, num_heads, num_kv_heads, head_dim,
                 causal: bool = True, window: int = 0,
                 rope_theta: float = 10000.0, qk_norm: bool = False,
                 mrope: bool = False):
    """Full-sequence self-attention (cross-attention and the K/V return
    for decode caches are not ported yet)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, num_heads, num_kv_heads, head_dim,
                           qk_norm=qk_norm, rope_theta=rope_theta,
                           mrope=mrope, positions=positions)
    # the kernel takes the (B, H, S, hd) views as strided tensors, and
    # lays its output out (B, S, H, hd), so both transposes are free there
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, window=window)
    out = out.transpose(1, 2).reshape(b, s, num_heads * head_dim)
    return out @ p["wo"]
