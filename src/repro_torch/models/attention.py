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

Under a bound mesh (model parallelism) the block attention's q/k/v are
placed on whole heads, ("batch", None, "model", None): the kernel runs on
each rank's head shard (`kernels.flash_attention.ops.attention`). The
reference leaves that placement to GSPMD's propagation; here it is
stated, since the kernel cannot take a split head.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import attention as flash_attention
from repro_torch.models.common import (apply_mrope, apply_rope, dense_init,
                                       rmsnorm)
from repro_torch.sharding import constrain
from repro_torch.sharding.rules import logical_size
from repro_torch.shards import (batch_placements, from_local, is_dtensor,
                                shard_range, to_local)


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


def split_heads(t, heads: int, head_dim: int):
    """(B, S, H·hd) -> (B, S, H, hd). Under a bound mesh the flat axis is
    first placed on whole heads: split over "model" when H divides it,
    else gathered."""
    b, s, _ = t.shape
    t = constrain(t, "batch", None,
                  "model" if heads % logical_size("model") == 0 else None)
    return t.reshape(b, s, heads, head_dim)


def merge_heads(t):
    """(B, S, H, hd) -> (B, S, H·hd). A ``DTensor`` (whole heads on each
    rank) merges its local shards, so a gradient split over the flat axis
    is placed back on whole heads before it is split into them."""
    b, s = t.shape[:2]
    if not is_dtensor(t):
        return t.reshape(b, s, -1)
    from torch.distributed.tensor import DTensor
    local = t.to_local()
    return DTensor.from_local(local.reshape(*local.shape[:2], -1),
                              t.device_mesh, t.placements, run_check=False)


def _project_qkv(p, x, num_heads, num_kv_heads, head_dim, *,
                 qk_norm: bool, rope_theta: float, mrope: bool, positions):
    """Project and rotate. positions: (B, S), or (3, B, S) under M-RoPE.
    Under a bound mesh the input is whole over "model" first."""
    x = constrain(x, "batch", None, None)
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = split_heads(q, num_heads, head_dim)
    k = split_heads(k, num_kv_heads, head_dim)
    v = split_heads(v, num_kv_heads, head_dim)
    if qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if rope_theta and positions is not None:
        rotate = apply_mrope if mrope else apply_rope
        q = rotate(q, positions, rope_theta)
        k = rotate(k, positions, rope_theta)
    return q, k, v


def _block_attention(q, k, v, *, causal: bool, window: int):
    """The block attention kernel on (B, S, H, hd) q/k/v, each placed on
    whole heads under a bound mesh. Returns (B, S, Hq, hd)."""
    q, k, v = (constrain(t, "batch", None, "model", None) for t in (q, k, v))
    # the kernel takes the (B, H, S, hd) views as strided tensors, and
    # lays its output out (B, S, H, hd), so both transposes are free there
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, window=window)
    return out.transpose(1, 2)


def _out_proj(p, o):
    """The output projection (B, S, H·hd) @ wo; under a bound mesh its
    partial sums over "model" reduced."""
    return constrain(o @ p["wo"], "batch", None, None)


def attn_prefill(p, x, positions, *, num_heads, num_kv_heads, head_dim,
                 causal: bool = True, window: int = 0,
                 rope_theta: float = 10000.0, qk_norm: bool = False,
                 mrope: bool = False, return_kv: bool = False):
    """Full-sequence self-attention (cross-attention is `cross_attn_kv`
    + `cross_attn_apply`). ``return_kv`` also returns the rotated (k, v),
    (B, S, Hkv, hd) each, that a prefill writes into the decode cache."""
    q, k, v = _project_qkv(p, x, num_heads, num_kv_heads, head_dim,
                           qk_norm=qk_norm, rope_theta=rope_theta,
                           mrope=mrope, positions=positions)
    out = _out_proj(p, merge_heads(_block_attention(q, k, v, causal=causal,
                                                    window=window)))
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
    ring-buffer decode writes stay aligned. The window axis is only
    sliced and concatenated, never indexed: it may be split (model
    parallelism)."""
    s = k.shape[1]
    w = cache["k"].shape[1]
    assert s <= w, "prefill longer than cache window"
    # the positions (B, S), placed as k's rows
    pos = (torch.arange(s, dtype=torch.int32, device=k.device) + start
           ).expand(shard_range(k, 0)[1], s).contiguous()
    pos = from_local(pos, k, batch_placements(k))
    return {"k": _ring_write(cache["k"], k, start),
            "v": _ring_write(cache["v"], v, start),
            "pos": _ring_write(cache["pos"], pos, start)}


def _ring_write(c, t, start: int):
    """A copy of the cache leaf ``c`` (B, W, ...) with ``t`` (B, S, ...)
    at the ring slots (start + i) % W: ``t`` and the slots it leaves are
    laid out from slot ``start`` % W on, then rolled into place."""
    s, w = t.shape[1], c.shape[1]
    shift = start % w

    def roll(x, n):                 # torch.roll(x, n, 1), by slices
        return torch.cat([x[:, w - n:], x[:, :w - n]], dim=1) if n else x
    if s < w:
        t = torch.cat([t.to(c.dtype), roll(c, (w - shift) % w)[:, s:]],
                      dim=1)
    else:
        t = t.to(c.dtype, copy=True)
    return roll(t, shift)


def _write_slot(t, slot: int, row):
    """A copy of ``t`` (B, W, ...) with window slot ``slot`` set to
    ``row`` ((B, 1, ...) or a scalar) on every row, on each rank's shards
    (the window axis may be split: the rank that holds the slot writes
    it)."""
    if is_dtensor(row):
        from torch.distributed.tensor import Replicate
        row = row.redistribute(t.device_mesh, [
            Replicate() if p.is_shard(1) else p for p in t.placements])
    lo, n = shard_range(t, 1)
    local = to_local(t).clone()
    if lo <= slot < lo + n:
        local[:, slot - lo] = to_local(row)[:, 0] if torch.is_tensor(row) \
            else row
    return from_local(local, t)


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
    new_cache = {
        "k": _write_slot(cache["k"], slot, k_new.to(cache["k"].dtype)),
        "v": _write_slot(cache["v"], slot, v_new.to(cache["v"].dtype)),
        "pos": _write_slot(cache["pos"], slot, cur_index)}

    pos = new_cache["pos"]                            # (B, W)
    valid = (pos >= 0) & (pos <= cur_index)
    if window:
        valid &= pos > cur_index - window
    out = decode_attention(q, new_cache["k"], new_cache["v"], valid)
    return _out_proj(p, out.to(x.dtype)), new_cache


def decode_attention(q, k, v, valid=None):
    """One-token grouped-query attention of q (B, 1, Hq, hd) against the
    keys/values (B, W, Hkv, hd) in float32, ``valid`` (B, W) masking
    slots out. Returns (B, 1, Hq·hd) float32.

    On ``DTensor``s (split over batch, KV heads or the window,
    `launch.shardings.cache_shardings`) it runs on each rank's shards: q
    is placed as k on batch and heads (replicated where the window is
    split), and over a split window the softmax's max and sums are
    all-reduced; the result is batch- and head-split as k."""
    window_axes = []
    if is_dtensor(k):
        from torch.distributed.tensor import Replicate
        mesh = k.device_mesh
        q = q.redistribute(mesh, [pl if pl.is_shard(0) or pl.is_shard(2)
                                  else Replicate() for pl in k.placements])
        if valid is not None:
            valid = valid.redistribute(mesh, [
                pl if pl.is_shard(0) or pl.is_shard(1) else Replicate()
                for pl in k.placements])
        window_axes = [m for m, pl in enumerate(k.placements)
                       if pl.is_shard(1)]
    kl, vl = to_local(k), to_local(v)
    b, _, hkv, hd = kl.shape
    qg = to_local(q).reshape(b, hkv, -1, hd).float()
    scores = torch.einsum("bngd,bwnd->bngw", qg, kl.float()) * (hd ** -0.5)
    if valid is not None:
        scores = scores.masked_fill(~to_local(valid)[:, None, None, :], -1e30)
    if not window_axes:
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bngw,bwnd->bngd", probs, vl.float())
    else:
        from torch.distributed import _functional_collectives as fc

        def reduce(t, op):
            for m in window_axes:
                t = fc.wait_tensor(fc.all_reduce(t, op, (mesh, m)))
            return t
        mx = reduce(scores.amax(-1, keepdim=True), "max")
        e = torch.exp(scores - mx)
        out = reduce(torch.einsum("bngw,bwnd->bngd", e, vl.float()), "sum") \
            / reduce(e.sum(-1, keepdim=True), "sum")
    return from_local(out.reshape(b, 1, -1), q)


def cross_attn_kv(p, enc_out, *, num_kv_heads, head_dim):
    """Cross-attention K/V from the encoder output, (B, S, Hkv, hd) each
    (no RoPE)."""
    k = split_heads(enc_out @ p["wk"], num_kv_heads, head_dim)
    v = split_heads(enc_out @ p["wv"], num_kv_heads, head_dim)
    return k, v


def cross_attn_apply(p, x, kv, *, num_heads, num_kv_heads, head_dim):
    """Decoder cross-attention of ``x`` (B, Sq, D) against precomputed
    encoder (k, v) (B, Skv, Hkv, hd), Hkv = ``num_kv_heads``: the block
    attention kernel, not causal."""
    k, v = kv
    assert k.shape[2] == v.shape[2] == num_kv_heads, (k.shape, num_kv_heads)
    q = split_heads(x @ p["wq"], num_heads, head_dim)
    return _out_proj(p, merge_heads(_block_attention(q, k, v, causal=False,
                                                     window=0)))
