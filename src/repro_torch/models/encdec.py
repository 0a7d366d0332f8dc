"""Encoder-decoder backbone (SeamlessM4T v2 geometry).

The audio frontend (mel + conv codec) is the sanctioned stub: the encoder
consumes precomputed frame embeddings (B, S_src, D). Exits (the SplitEE
technique) attach to the *decoder* stack, so the split point indexes
decoder layers; the encoder always runs whole (it is the input
processing).

Decoder layer = self-attention (causal, cached) + cross-attention
(precomputed K/V) + MLP. Layers are stacked on a leading L axis, as in
`transformer.py`, and iterated with a Python loop. The encoder's
bidirectional attention, the decoder's causal self-attention and its
full-sequence cross-attention run the block attention kernel; a decode
step's one-token self- and cross-attention are plain float32 einsums, as
the reference's are, and its exits one exit-confidence launch.
"""
from __future__ import annotations

from typing import Any, Mapping

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device, torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.exit_confidence.ops import exit_confidence
from repro_torch.models import attention as attn
from repro_torch.models import mlp as ff
from repro_torch.models.common import (apply_norm, dense_init, embed_init,
                                       embed_lookup, init_norm, next_token_ce)
from repro_torch.models.transformer import (ParamTree, cache_slices,
                                            check_family, init_device,
                                            init_stacked, layer_params,
                                            map_tree, restack, stack_trees,
                                            unbind_layers)
from repro_torch.sharding import constrain
from repro_torch.sharding.rules import gather_fsdp


def _init_enc_layer(cfg: ModelConfig, gen: torch.Generator, dt, dev):
    e = cfg.encoder
    hd = e.d_model // e.num_heads
    return {
        "ln1": init_norm(e.d_model, cfg.norm, dt, dev),
        "attn": attn.init_attention(gen, e.d_model, e.num_heads,
                                    e.num_kv_heads, hd, qkv_bias=False,
                                    qk_norm=False, dtype=dt, device=dev),
        "ln2": init_norm(e.d_model, cfg.norm, dt, dev),
        "mlp": ff.init_mlp(gen, e.d_model, e.d_ff, cfg.activation, dt, dev),
    }


def _init_dec_layer(cfg: ModelConfig, gen: torch.Generator, dt, dev):
    d, hd = cfg.d_model, cfg.resolved_head_dim

    def block():
        return attn.init_attention(gen, d, cfg.num_heads, cfg.num_kv_heads,
                                   hd, qkv_bias=False, qk_norm=False,
                                   dtype=dt, device=dev)
    return {
        "ln1": init_norm(d, cfg.norm, dt, dev),
        "self_attn": block(),
        "ln_x": init_norm(d, cfg.norm, dt, dev),
        "cross_attn": block(),
        "ln2": init_norm(d, cfg.norm, dt, dev),
        "mlp": ff.init_mlp(gen, d, cfg.d_ff, cfg.activation, dt, dev),
        "exit_norm": init_norm(d, cfg.norm, dt, dev),
    }


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> ParamTree:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (default ``cuda``; ``"meta"``: shapes and dtypes only); parity with
    the reference goes through `repro_torch.bridge`."""
    check_family(cfg)
    dev, gen = init_device(device, seed)
    dt = torch_dtype(cfg.dtype)
    return ParamTree({
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt, dev),
        "enc_layers": init_stacked(
            lambda: _init_enc_layer(cfg, gen, dt, dev),
            cfg.encoder.num_layers),
        "enc_norm": init_norm(cfg.encoder.d_model, cfg.norm, dt, dev),
        "dec_layers": init_stacked(
            lambda: _init_dec_layer(cfg, gen, dt, dev), cfg.num_layers),
        "final_norm": init_norm(cfg.d_model, cfg.norm, dt, dev),
        "exit_w": dense_init(gen, cfg.d_model,
                             cfg.num_classes or cfg.vocab_size, dt, dev),
    })


def abstract_params(cfg: ModelConfig) -> ParamTree:
    """The parameter tree on the meta device (shapes and dtypes only)."""
    return init_params(cfg, device="meta")


def _arange(b: int, s: int, device):
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def encode(params, cfg: ModelConfig, frames):
    """frames (B, S_src, D) stub embeddings -> the encoder output: every
    layer's bidirectional attention (with RoPE) and MLP, then the
    encoder norm. The layers' views come from one `unbind_layers` of the
    stack (a gradient's backward is then one ``stack`` a leaf)."""
    e = cfg.encoder
    x = frames.to(device=params["embed"].device, dtype=torch_dtype(cfg.dtype))
    b, s, _ = x.shape
    pos = _arange(b, s, x.device)
    views = unbind_layers(params["enc_layers"])
    for i in range(e.num_layers):
        lp = layer_params(params["enc_layers"], i, views=views)
        x = x + attn.attn_prefill(
            lp["attn"], apply_norm(x, lp["ln1"], cfg.norm), pos,
            num_heads=e.num_heads, num_kv_heads=e.num_kv_heads,
            head_dim=e.d_model // e.num_heads, causal=False,
            rope_theta=cfg.rope_theta)
        x = constrain(x + ff.mlp_forward(
            lp["mlp"], apply_norm(x, lp["ln2"], cfg.norm), cfg.activation),
            "batch", None, None)
    return apply_norm(x, params["enc_norm"], cfg.norm)


def cross_kv(params, cfg: ModelConfig, enc_out):
    """Every decoder layer's cross-attention (k, v) of the encoder output,
    stacked: (L, B, S_src, Hkv, hd) each."""
    ks, vs = _cross_kv_layers(params, cfg, enc_out)
    return torch.stack(ks), torch.stack(vs)


def _cross_kv_layers(params, cfg: ModelConfig, enc_out, views=None):
    """`cross_kv` per layer, unstacked: (ks, vs), L tensors each; each
    layer's parameters from the decoder stack's `unbind_layers` ``views``
    when given (`layer_params`)."""
    return tuple(zip(*(attn.cross_attn_kv(
        layer_params(params["dec_layers"], i, views=views)["cross_attn"],
        enc_out,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim)
        for i in range(cfg.num_layers))))


def _dec_layer_full(cfg: ModelConfig, lp, x, positions, ckv, *,
                    window: int = 0):
    """One decoder layer over the full target sequence: causal
    self-attention, cross-attention against ``ckv`` (k, v), MLP. Returns
    (x, (k, v)), the self-attention's rotated keys and values."""
    hd = cfg.resolved_head_dim
    h, kv = attn.attn_prefill(
        lp["self_attn"], apply_norm(x, lp["ln1"], cfg.norm), positions,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads, head_dim=hd,
        causal=True, window=window, rope_theta=cfg.rope_theta,
        return_kv=True)
    x = x + h
    x = x + attn.cross_attn_apply(
        lp["cross_attn"], apply_norm(x, lp["ln_x"], cfg.norm), ckv,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads, head_dim=hd)
    h = ff.mlp_forward(lp["mlp"], apply_norm(x, lp["ln2"], cfg.norm),
                       cfg.activation)
    return constrain(x + h, "batch", None, None), kv


def _layer_kv(ckv, i: int):
    return ckv[0][i], ckv[1][i]


def train_loss(params, cfg: ModelConfig, batch: Mapping[str, Any], *,
               remat: bool = True):
    """Teacher-forced decoder CE (shifted labels) at every exit + the
    final layer. ``remat`` recomputes each decoder layer in the backward
    (``torch.utils.checkpoint``, non-reentrant)."""
    # one unbind of each decoder leaf, outside the checkpointed layers
    views = unbind_layers(params["dec_layers"])
    ckv = _cross_kv_layers(params, cfg, encode(params, cfg, batch["frames"]),
                           views)
    x = embed_lookup(params["embed"], batch["tokens"])
    b, s, _ = x.shape
    positions = _arange(b, s, x.device)
    labels = batch["labels"].to(x.device).long()

    def body(xx, i):
        lp = layer_params(params["dec_layers"], i, views=views)
        xx, _ = _dec_layer_full(cfg, lp, xx, positions, _layer_kv(ckv, i))
        hn = apply_norm(xx, lp["exit_norm"], cfg.norm)
        return xx, next_token_ce(_vocab_logits(hn, params), labels)

    exit_losses = []
    for i in range(cfg.num_layers):
        if remat:
            x, loss_i = checkpoint(body, x, i, use_reentrant=False)
        else:
            x, loss_i = body(x, i)
        exit_losses.append(loss_i)
    xf = apply_norm(x, params["final_norm"], cfg.norm)
    final = next_token_ce(_vocab_logits(xf, params), labels)
    return final + torch.stack(exit_losses).mean()


def _vocab_logits(hn, params):
    """(B, S, V) logits of the shared head, vocabulary-sharded under a
    bound mesh."""
    return constrain(hn @ gather_fsdp(params["exit_w"]), "batch", None,
                     "model")


def _final_logits(params, cfg: ModelConfig, x):
    return constrain(apply_norm(x, params["final_norm"], cfg.norm)[:, -1, :]
                     @ gather_fsdp(params["exit_w"]), "batch", "model")


def prefill(params, cfg: ModelConfig, batch: Mapping[str, Any], *,
            cache_seq_len: int = 0):
    """Encode the source ``frames``, precompute the cross K/V, and run the
    teacher-forced pass over the target prefix ``tokens`` (B, S),
    building ring self-attention caches for a total length
    ``cache_seq_len`` (default S). Returns (last-position logits,
    ``{"self": stacked caches, "cross_kv": (k, v)}``)."""
    ckv = cross_kv(params, cfg, encode(params, cfg, batch["frames"]))
    x = embed_lookup(params["embed"], batch["tokens"])
    b, s, _ = x.shape
    seq_total = cache_seq_len or s
    window = cfg.effective_window(seq_total)
    cache_window = window or seq_total
    positions = _arange(b, s, x.device)
    states = []
    for i in range(cfg.num_layers):
        x, (kk, vv) = _dec_layer_full(cfg, layer_params(params["dec_layers"],
                                                        i), x, positions,
                                      _layer_kv(ckv, i), window=window)
        states.append(attn.fill_cache(
            attn.init_cache(b, cache_window, cfg.num_kv_heads,
                            cfg.resolved_head_dim, torch_dtype(cfg.dtype),
                            device=x.device),
            kk[:, -cache_window:], vv[:, -cache_window:],
            start=max(0, s - cache_window)))
    return _final_logits(params, cfg, x), {"self": stack_trees(states),
                                           "cross_kv": ckv}


def init_caches(cfg: ModelConfig, batch: int, seq_len: int, *, device=None):
    """Stacked self-attention caches ``{"self": {k, v, pos}}`` (window-sized
    past ``sliding_window_override``) on ``device`` (default cuda;
    ``"meta"`` gives shapes and dtypes without allocating). The cross K/V
    come from `prefill` (or `cross_kv`)."""
    check_family(cfg)
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    window = cfg.effective_window(seq_len) or seq_len
    c = attn.init_cache(batch, window, cfg.num_kv_heads,
                        cfg.resolved_head_dim, torch_dtype(cfg.dtype),
                        device=dev)
    return {"self": map_tree(lambda a: a.expand(cfg.num_layers, *a.shape)
                         .contiguous(), c)}


def _cross_attn_one(cfg: ModelConfig, p, x, kv):
    """Cross-attention of one query token x (B, 1, D) against the encoder
    (k, v) (B, S_src, Hkv, hd): plain float32 einsums, as the
    reference's."""
    q = attn.split_heads(x @ p["wq"], cfg.num_heads, cfg.resolved_head_dim)
    return attn.decode_attention(q, *kv).to(x.dtype) @ p["wo"]


def decode_step(params, cfg: ModelConfig, caches, ckv, token, cur_index: int,
                *, split_layer=None, all_exits: bool = False,
                window_seq_len: int = 0):
    """One-token decode against the cached self-attention and the
    precomputed cross K/V ``ckv``. Exit confidence at ``split_layer``, or
    at every exit (``all_exits``: one launch over the (L·B, D) rows).
    ``caches`` needs only its ``"self"`` subtree. Returns (logits, conf, pred, new_caches) like
    ``transformer.decode_step``; conf/pred are None with neither."""
    hd = cfg.resolved_head_dim
    window = cfg.effective_window(window_seq_len)
    x = embed_lookup(params["embed"], token.reshape(-1, 1))
    slices, pooled = cache_slices({"self": caches["self"]}), []
    for i in range(cfg.num_layers):
        lp = layer_params(params["dec_layers"], i)
        h, slices["self"][i] = attn.attn_decode(
            lp["self_attn"], apply_norm(x, lp["ln1"], cfg.norm),
            slices["self"][i], cur_index, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=hd, window=window,
            rope_theta=cfg.rope_theta)
        x = x + h
        x = x + _cross_attn_one(cfg, lp["cross_attn"],
                                apply_norm(x, lp["ln_x"], cfg.norm),
                                _layer_kv(ckv, i))
        x = x + ff.mlp_forward(lp["mlp"], apply_norm(x, lp["ln2"], cfg.norm),
                               cfg.activation)
        pooled.append(apply_norm(x, lp["exit_norm"], cfg.norm)[:, -1, :])
    ew = gather_fsdp(params["exit_w"])
    if all_exits:
        rows = torch.stack(pooled)                      # (L, B, D)
        conf, pred = exit_confidence(rows.reshape(-1, cfg.d_model), ew)
        conf, pred = conf.reshape(rows.shape[:2]), pred.reshape(rows.shape[:2])
    elif split_layer is not None:
        conf, pred = exit_confidence(pooled[split_layer], ew)
    else:
        conf = pred = None
    return _final_logits(params, cfg, x), conf, pred, restack(slices)

