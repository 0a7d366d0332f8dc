"""Multi-exit decoder stack, dense, ssm (RWKV6), hybrid (Zamba2: a Mamba2
backbone with one shared attention + MLP block after every k-th layer),
MoE and VLM (Qwen2-VL: M-RoPE over a stub's ``embeds``) families: the
model the SplitEE policy runs on. The enc-dec family wraps it
(`repro_torch.models.encdec`).

Parameters live in a `ParamTree`, an ``nn.Module`` whose parameter names
are the reference pytree's paths (``layers.attn.wq`` is
``params["layers"]["attn"]["wq"]``). Layers are stacked on a leading L
axis, as in the reference's ``init_params``; per-layer views come from
`layer_params`. The layer loop is a Python loop. `train_loss` is the
joint multi-exit training loss; serving runs without gradient, the
classifier through `forward_exits*`, autoregressive decode through
`prefill` and the `decode_step*` functions over stacked cache trees.

Model parallelism: with ``DTensor`` parameters and inputs under a bound
mesh (`repro_torch.sharding.mesh_rules`), the `constrain` calls place the
activations at the reference's points (the residual stream batch-sharded,
logits vocabulary-sharded, the training carry sequence-sharded under
``seq_parallel``); unbound, every call is the identity.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device, torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.exit_confidence.ops import (exit_confidence,
                                                     exit_confidence_fused)
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import mlp as ff
from repro_torch.models import rwkv6 as rk
from repro_torch.models.common import (apply_norm, cross_entropy,
                                       dense_init, embed_init, embed_lookup,
                                       init_norm, next_token_ce)
from repro_torch.sharding import constrain
from repro_torch.sharding.rules import gather_fsdp
from repro_torch.shards import is_dtensor


class ParamTree(nn.Module):
    """Nested parameters, indexable like the reference's dict pytree.

    Every nested dict becomes a child module and every leaf an
    ``nn.Parameter``, so ``named_parameters()`` lists the pytree paths and
    ``.to(device)`` moves the whole tree. Leaves are made without
    gradient, as serving wants them; ``requires_grad_(True)`` (the
    ``nn.Module`` method, on the whole tree) makes them trainable and
    ``requires_grad_(False)`` freezes them again."""

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, (Mapping, ParamTree)):
                self.add_module(key, val if isinstance(val, ParamTree)
                                else ParamTree(val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        if key in self._modules:
            return self._modules[key]
        raise KeyError(key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def get(self, key: str, default=None):
        return self[key] if key in self else default

    def keys(self):
        return list(self._parameters) + list(self._modules)

    def items(self):
        return [(k, self[k]) for k in self.keys()]


def _is_tree(x) -> bool:
    return isinstance(x, (Mapping, ParamTree))


def layer_params(layers, i: int, gather: bool = True) -> Dict[str, Any]:
    """Views of layer ``i`` of a stacked-layer tree. Under a bound mesh a
    parameter's view is gathered over the data axes (`gather_fsdp`), but
    for the MoE's expert stacks, which stay split as the reference keeps
    them; a cache tree's views are left as they are."""
    return {k: layer_params(v, i, gather and k != "moe") if _is_tree(v)
            else gather_fsdp(v[i]) if gather and isinstance(v, nn.Parameter)
            else v[i] for k, v in layers.items()}


def weights(tree):
    """A parameter subtree with every leaf through `gather_fsdp`."""
    return {k: weights(v) if _is_tree(v) else gather_fsdp(v)
            for k, v in tree.items()}


def stack_trees(trees):
    first = trees[0]
    return {k: stack_trees([t[k] for t in trees]) if _is_tree(first[k])
            else _stack([t[k] for t in trees]) for k in first}


def _stack(ts):
    """``torch.stack``; ``DTensor``s stack their local shards (placed as
    the first entry, a partial sum reduced; each split moves one axis
    up), never gathered."""
    if not is_dtensor(ts[0]):
        return torch.stack(ts)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = ts[0].device_mesh
    pl = [Replicate() if p.is_partial() else p for p in ts[0].placements]
    return DTensor.from_local(
        torch.stack([t.redistribute(mesh, pl).to_local() for t in ts]), mesh,
        [Shard(p.dim + 1) if p.is_shard() else p for p in pl],
        run_check=False)


# "audio" is a decoder-only stack here, as the reference's transformer
# takes it; with an encoder it runs through models/encdec.py
PORTED_FAMILIES = ("dense", "ssm", "hybrid", "moe", "vlm", "audio")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.arch_id}) is unknown; the "
            f"families are {PORTED_FAMILIES}")


# ------------------------------------------------------------------- helpers

def _is_attn_layer(cfg: ModelConfig, i: int) -> bool:
    """Hybrid: the shared attention block runs after layers k, 2k, ...
    (0-indexed layer i with (i+1) % k == 0)."""
    k = cfg.hybrid_attn_every
    return bool(k) and (i + 1) % k == 0


def _occurrence(cfg: ModelConfig, i: int) -> int:
    """Hybrid: which shared-attention cache slot layer ``i`` uses."""
    return (i + 1) // cfg.hybrid_attn_every - 1


def head_out_dim(cfg: ModelConfig) -> int:
    return cfg.num_classes if cfg.num_classes else cfg.vocab_size


def pool_hidden(cfg: ModelConfig, x):
    """Exit-head pooling: CLS token for classification, last token for LM."""
    return x[:, 0, :] if cfg.num_classes else x[:, -1, :]


# ---------------------------------------------------------------------- init

def _ssm_heads(cfg: ModelConfig) -> int:
    return cfg.ssm.num_heads or cfg.d_model // cfg.ssm.state_size


def _init_layer(cfg: ModelConfig, gen: torch.Generator, dt, dev):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    if cfg.family == "ssm":
        heads = _ssm_heads(cfg)
        # the reference keeps the whole init_rwkv6 dict under "tm" (its
        # channel-mix leaves unused there) and the channel-mix part of a
        # second draw under "cm"; both are kept, leaf for leaf
        p: Dict[str, Any] = {
            "ln1": init_norm(d, cfg.norm, dt, dev),
            "tm": rk.init_rwkv6(gen, d, heads, cfg.d_ff, dt, dev),
            "ln2": init_norm(d, cfg.norm, dt, dev),
            "cm": rk.init_channel_mix(gen, d, cfg.d_ff, dt, dev),
        }
    elif cfg.family == "hybrid":
        p = {"ln1": init_norm(d, cfg.norm, dt, dev),
             "mamba": m2.init_mamba2(gen, d, cfg.ssm.state_size,
                                     cfg.ssm.expand, dt, dev)}
    else:
        p = {
            "ln1": init_norm(d, cfg.norm, dt, dev),
            "attn": attn.init_attention(
                gen, d, cfg.num_heads, cfg.num_kv_heads, hd,
                qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm, dtype=dt,
                device=dev),
            "ln2": init_norm(d, cfg.norm, dt, dev),
        }
        if cfg.family == "moe":
            p["moe"] = ff.init_moe(gen, d, cfg.d_ff, cfg.moe.num_experts, dt,
                                   dev)
        else:
            p["mlp"] = ff.init_mlp(gen, d, cfg.d_ff, cfg.activation, dt, dev)
    p["exit_norm"] = init_norm(d, cfg.norm, dt, dev)
    if cfg.exits.enabled and not cfg.exits.share_head:
        p["exit_w"] = dense_init(gen, d, head_out_dim(cfg), dt, dev)
    return p


def init_stacked(make, n: int):
    """``n`` draws of the tree ``make()`` stacked on a leading axis, each
    copied into its row as it is drawn (peak memory: the stack and one
    draw, not twice the stack). On the meta device the stack is made
    from the first tree's shapes and nothing is drawn again."""
    first = make()
    out = map_tree(lambda a: a.new_empty((n, *a.shape)), first)
    if next(iter(_leaves(first))).device.type == "meta":
        return out
    for i in range(n):
        map_tree(lambda o, a: o[i].copy_(a), out, first if i == 0 else make())
    return out


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if _is_tree(v) else (v,))


def init_device(device, seed: int):
    """(device, generator) of an ``init_params``: a ``torch.Generator``
    seeded on ``device`` (default cuda), or none on the meta device,
    where the init helpers' draws allocate and draw nothing."""
    if str(device) == "meta":
        return torch.device("meta"), None
    dev = resolve_device(device)
    return dev, torch.Generator(device=dev).manual_seed(seed)


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> ParamTree:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (default ``cuda``; ``"meta"`` gives shapes and dtypes only, see
    `abstract_params`). The draws differ from ``jax.random``'s; parity
    with the reference goes through `repro_torch.bridge`."""
    check_family(cfg)
    dev, gen = init_device(device, seed)
    dt = torch_dtype(cfg.dtype)
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, d, dt, dev),
        "layers": init_stacked(lambda: _init_layer(cfg, gen, dt, dev),
                                cfg.num_layers),
        "final_norm": init_norm(d, cfg.norm, dt, dev),
    }
    if cfg.exits.share_head or not cfg.exits.enabled:
        params["exit_w"] = dense_init(gen, d, head_out_dim(cfg), dt, dev)
    if cfg.family == "hybrid":
        params["shared_attn"] = {
            "ln1": init_norm(d, cfg.norm, dt, dev),
            "attn": attn.init_attention(
                gen, d, cfg.num_heads, cfg.num_kv_heads,
                cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias,
                qk_norm=cfg.qk_norm, dtype=dt, device=dev),
            "ln2": init_norm(d, cfg.norm, dt, dev),
            "mlp": ff.init_mlp(gen, d, cfg.d_ff, cfg.activation, dt, dev),
        }
    return ParamTree(params)


def abstract_params(cfg: ModelConfig) -> ParamTree:
    """The parameter tree on the meta device: every leaf's shape and
    dtype, nothing allocated (the reference's ``jax.eval_shape`` of its
    ``init_params``)."""
    return init_params(cfg, device="meta")


# -------------------------------------------------------------- embed inputs

def embed_inputs(params, cfg: ModelConfig, batch: Mapping[str, Any]):
    """tokens (B, S) int -> (B, S, D); a modality stub's batch passes its
    ``embeds`` (B, S, D) instead, cast to the model dtype on the
    parameters' device."""
    emb = params["embed"]
    if "embeds" in batch:
        x = batch["embeds"].to(device=emb.device, dtype=torch_dtype(cfg.dtype))
    else:
        x = embed_lookup(emb, batch["tokens"])
    return constrain(x, "batch", None, None)


def _positions(cfg: ModelConfig, b: int, s: int, device=None):
    """(B, S) positions 0..S-1; under M-RoPE the (3, B, S) text stream
    (t = h = w)."""
    pos = torch.arange(s, dtype=torch.int32, device=device)
    return pos.expand(3, b, s) if cfg.mrope else pos[None, :].expand(b, s)


# ------------------------------------------------------------ full-seq layer

def _shared_block(cfg: ModelConfig, sp, x, positions, *, window: int):
    """Hybrid: the shared attention + MLP block over the full sequence.
    Returns (x, (k, v)), the rotated keys/values (B, S, Hkv, hd)."""
    h, kv = attn.attn_prefill(
        sp["attn"], apply_norm(x, sp["ln1"], cfg.norm), positions,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, causal=cfg.causal, window=window,
        rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm, return_kv=True)
    x = x + h
    h = ff.mlp_forward(sp["mlp"], apply_norm(x, sp["ln2"], cfg.norm),
                       cfg.activation)
    return x + h, kv


def _layer_prefill(cfg: ModelConfig, params, lp, x, positions, i: int, *,
                   window: int):
    """Layer ``i`` over the full sequence from an empty state. Returns
    (x, state, aux): an ssm layer's final ``{tm_last, cm_last, wkv}`` (its
    token shift and recurrence start from a zero state, and it ignores
    ``positions`` and ``window``); a dense or MoE layer's rotated (k, v),
    (B, S, Hkv, hd) each; a hybrid layer's (Mamba2 state, the shared
    block's (k, v) at an attention layer, else None). ``aux`` is the MoE
    router's balance loss, 0.0 for the other families."""
    check_family(cfg)
    if cfg.family == "ssm":
        heads = _ssm_heads(cfg)
        st = rk.init_rwkv_state(x.shape[0], cfg.d_model, heads,
                                device=x.device)
        h, (tm_last, wkv) = rk.time_mix(
            lp["tm"], apply_norm(x, lp["ln1"], cfg.norm),
            (st["tm_last"], st["wkv"]), num_heads=heads,
            chunk=cfg.ssm.chunk_size)
        x = x + h
        h, cm_last = rk.channel_mix(
            lp["cm"], apply_norm(x, lp["ln2"], cfg.norm), st["cm_last"])
        return (constrain(x + h, "batch", None, None),
                {"tm_last": tm_last, "cm_last": cm_last, "wkv": wkv}, 0.0)
    if cfg.family == "hybrid":
        st = m2.init_mamba2_state(x.shape[0], cfg.d_model,
                                  cfg.ssm.state_size, cfg.ssm.expand,
                                  device=x.device)
        h, st = m2.mamba2_forward(
            lp["mamba"], apply_norm(x, lp["ln1"], cfg.norm), st,
            state_size=cfg.ssm.state_size, expand=cfg.ssm.expand,
            chunk=cfg.ssm.chunk_size)
        x, kv = x + h, None
        if _is_attn_layer(cfg, i):
            x, kv = _shared_block(cfg, weights(params["shared_attn"]), x,
                                  positions, window=window)
        return constrain(x, "batch", None, None), (st, kv), 0.0
    h, kv = attn.attn_prefill(
        lp["attn"], apply_norm(x, lp["ln1"], cfg.norm), positions,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, causal=cfg.causal,
        window=window, rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
        mrope=cfg.mrope, return_kv=True)
    x = x + h
    x2 = apply_norm(x, lp["ln2"], cfg.norm)
    aux = 0.0
    if cfg.family == "moe":
        h, aux = ff.moe_forward(lp["moe"], x2,
                                num_experts=cfg.moe.num_experts,
                                top_k=cfg.moe.top_k,
                                capacity_factor=cfg.moe.capacity_factor)
    else:
        h = ff.mlp_forward(lp["mlp"], x2, cfg.activation)
    return constrain(x + h, "batch", None, None), kv, aux


def _layer_full(cfg: ModelConfig, params, lp, x, positions, i: int, *,
                window: int):
    """Layer ``i`` over the full sequence (`_layer_prefill` without its
    state). Returns (x, aux)."""
    x, _, aux = _layer_prefill(cfg, params, lp, x, positions, i,
                               window=window)
    return x, aux


def _exit_w(params, lp):
    return lp["exit_w"] if "exit_w" in lp else gather_fsdp(params["exit_w"])


# -------------------------------------------------------------- train / eval

def train_loss(params, cfg: ModelConfig, batch: Mapping[str, Any], *,
               remat: bool = True, seq_parallel: bool = True):
    """Joint multi-exit loss (paper/ElasticBERT style): mean CE over the
    exits + final-layer CE + ``0.01 * aux / L`` (aux, the MoE balance
    loss summed over the layers, is 0 for the other families). LM
    (shifted labels) when ``cfg.num_classes == 0``, else classification
    on the pooled token.

    ``remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``, non-reentrant) instead of keeping its
    activations.

    ``seq_parallel``: Megatron-style sequence-parallel residual boundary
    under a bound mesh: the carry between layers (and so the saved
    activation stack) is sharded over "model" on the sequence dim,
    ("batch", "model", None), else ("batch", None, None). Unbound it
    changes nothing.
    """
    x = embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    positions = _positions(cfg, b, s, device=x.device)
    window = cfg.effective_window(s)
    labels = batch["labels"].to(x.device).long()
    carry_spec = ("batch", "model", None) if seq_parallel \
        else ("batch", None, None)

    def logits_of(hn, w):
        if cfg.num_classes:
            return pool_hidden(cfg, hn) @ w                # (B, C)
        # the sequence whole (gathered from a sequence split) before the
        # vocabulary-split head, as Megatron's sequence parallelism does
        hn = constrain(hn, "batch", None, None)
        return constrain(hn @ w, "batch", None, "model")   # (B, S, V)

    def ce(logits):
        if cfg.num_classes:
            return cross_entropy(logits, labels)
        return next_token_ce(logits, labels)

    def body(xx, i):
        lp = layer_params(params["layers"], i)
        xx, aux_i = _layer_full(cfg, params, lp, xx, positions, i,
                                window=window)
        if not cfg.exits.enabled:
            loss_i = xx.new_zeros((), dtype=torch.float32)
        else:
            # pooling precedes the exit norm for a classifier (they commute)
            src = xx[:, :1] if cfg.num_classes else xx
            hn = apply_norm(src, lp["exit_norm"], cfg.norm)
            loss_i = ce(logits_of(hn, _exit_w(params, lp)))
        return constrain(xx, *carry_spec), loss_i, aux_i

    exit_losses, aux = [], 0.0
    for i in range(cfg.num_layers):
        if remat:
            x, loss_i, aux_i = checkpoint(body, x, i, use_reentrant=False)
        else:
            x, loss_i, aux_i = body(x, i)
        exit_losses.append(loss_i)
        aux = aux + aux_i

    xf = apply_norm(x[:, :1] if cfg.num_classes else x,
                    params["final_norm"], cfg.norm)
    w = params.get("exit_w")
    if w is None:  # per-exit heads: the final exit is the last layer's head
        w = params["layers"]["exit_w"][-1]
    w = gather_fsdp(w)
    loss = ce(logits_of(xf, w)) + 0.01 * aux / cfg.num_layers
    if cfg.exits.enabled:
        loss = loss + torch.stack(exit_losses).mean()
    return loss


# ------------------------------------------------- streaming exit observables

def exit_hidden(params, cfg: ModelConfig, batch: Mapping[str, Any]):
    """Full forward: the normed pooled rows every exit head reads, (L, B,
    D) with layer i at row i-1, and the final hidden (B, S, D). Pooling
    precedes the exit norm (the norm is per token, so they commute)."""
    x = embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    positions = _positions(cfg, b, s, device=x.device)
    window = cfg.effective_window(s)
    pooled = []
    for i in range(cfg.num_layers):
        x, _ = _layer_full(cfg, params, layer_params(params["layers"], i), x,
                           positions, i, window=window)
        pooled.append(pool_hidden(cfg, x))
    exit_norm = params["layers"]["exit_norm"]
    pooled_n = apply_norm(torch.stack(pooled),
                          {k: v.unsqueeze(1) for k, v in exit_norm.items()},
                          cfg.norm)                        # (L, B, D)
    return pooled_n, x


def forward_exits(params, cfg: ModelConfig, batch: Mapping[str, Any]):
    """Full forward collecting per-exit (confidence, prediction).

    Returns dict with conf (L, B) f32, pred (L, B) i32 — layer i's exit
    observables at row i-1 — and the final hidden (B, S, D). One grouped
    confidence call covers every exit.
    """
    pooled_n, x = exit_hidden(params, cfg, batch)
    b = x.shape[0]
    if cfg.exits.share_head or not cfg.exits.enabled:
        conf, pred = exit_confidence(pooled_n.reshape(-1, cfg.d_model),
                                     params["exit_w"])
    else:
        conf, pred = exit_confidence(pooled_n, params["layers"]["exit_w"])
    return {"conf": conf.reshape(cfg.num_layers, b),
            "pred": pred.reshape(cfg.num_layers, b),
            "hidden": x}


def grouped_exits(params, cfg: ModelConfig, pooled, *, fused: bool = False):
    """conf (L, B) f32 and pred (L, B) i32 of every exit from the RAW
    pooled rows ``pooled`` (L, B, D) (layer i's at row i-1), in one
    confidence launch. A shared head scores the (L·B, D) rows at once (the
    fused form takes each layer's exit-norm parameters repeated per row);
    per-layer heads are the grouped (L, B, D) @ (L, D, C) form."""
    l, b, d = pooled.shape
    norm_p = params["layers"]["exit_norm"]                 # (L, D) entries
    share = cfg.exits.share_head or not cfg.exits.enabled
    if fused:
        if share:
            rows_p = {k: v.repeat_interleave(b, dim=0)
                      for k, v in norm_p.items()}
            conf, pred = exit_confidence_fused(
                pooled.reshape(l * b, d), rows_p, params["exit_w"],
                kind=cfg.norm)
        else:
            conf, pred = exit_confidence_fused(
                pooled, dict(norm_p.items()), params["layers"]["exit_w"],
                kind=cfg.norm)
    else:
        normed = apply_norm(pooled,
                            {k: v.unsqueeze(1) for k, v in norm_p.items()},
                            cfg.norm)
        if share:
            conf, pred = exit_confidence(normed.reshape(l * b, d),
                                         params["exit_w"])
        else:
            conf, pred = exit_confidence(normed, params["layers"]["exit_w"])
    return conf.reshape(l, b), pred.reshape(l, b)


def forward_exits_masked(params, cfg: ModelConfig, batch: Mapping[str, Any],
                         depths, *, window=None, fused_exit: bool = False):
    """Depth-masked forward: one launch sequence for every depth mix.

    ``depths`` is a (B,) integer tensor of 0-indexed split layers, one per
    sample. Every row runs through all L layers and is frozen once its own
    split layer has run (``torch.where(i <= depths)``), so the final
    hidden is each sample's activation at its own depth: the offload
    payload. Every layer's exit rows are pooled from the (frozen) carry
    and scored after the loop by one grouped confidence launch; rows past
    a sample's depth are unused by serving. As in the reference, a frozen
    row still routes its tokens through an MoE layer, where they compete
    for expert capacity. ``window`` overrides the attention window
    (serving passes 0); None derives it from the sequence length.

    Returns dict with conf (L, B) f32, pred (L, B) i32 and hidden (B, S,
    D) at per-sample depth.
    """
    x = embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    positions = _positions(cfg, b, s, device=x.device)
    if window is None:
        window = cfg.effective_window(s)
    live = depths.to(x.device).reshape(b, 1, 1)
    pooled = []
    for i in range(cfg.num_layers):
        x_new, _ = _layer_full(cfg, params, layer_params(params["layers"], i),
                               x, positions, i, window=window)
        x = torch.where(i <= live, x_new, x)
        pooled.append(pool_hidden(cfg, x))
    conf, pred = grouped_exits(params, cfg, torch.stack(pooled),
                               fused=fused_exit)
    return {"conf": conf, "pred": pred, "hidden": x}


# ----------------------------------------------------------- prefill / decode
#
# Cache trees are nested dicts of tensors with a leading layer axis:
# {"attn": {k, v, pos}} (dense, MoE: L layers), {"ssm": {tm_last, cm_last,
# wkv}} (ssm: L layers), or {"ssm": {conv, ssm}} (L Mamba2 layers) with
# {"attn": {k, v, pos}} (L // k shared-attention occurrences) (hybrid).
# Every function below returns a new tree and never writes into its input.

def _cache_key(cfg: ModelConfig) -> str:
    """The subtree that holds one entry per layer."""
    return "ssm" if cfg.family in ("ssm", "hybrid") else "attn"


def map_tree(fn, tree, *rest):
    return {k: map_tree(fn, v, *(r[k] for r in rest)) if _is_tree(v)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def init_caches(cfg: ModelConfig, batch: int, seq_len: int, *, device=None):
    """Stacked decode caches (window-sized for SWA archs) on ``device``
    (default cuda; ``"meta"`` gives shapes and dtypes without allocating).
    Recurrent states are float32, as ``init_rwkv_state`` and
    ``init_mamba2_state`` make them."""
    check_family(cfg)
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))

    def stacked(one, n):
        return map_tree(lambda a: a.expand(n, *a.shape).contiguous(), one)

    window = cfg.effective_window(seq_len) or seq_len
    kv = lambda: attn.init_cache(  # noqa: E731
        batch, window, cfg.num_kv_heads, cfg.resolved_head_dim,
        torch_dtype(cfg.dtype), device=dev)
    if cfg.family == "ssm":
        return {"ssm": stacked(rk.init_rwkv_state(
            batch, cfg.d_model, _ssm_heads(cfg), device=dev),
            cfg.num_layers)}
    if cfg.family == "hybrid":
        return {"ssm": stacked(m2.init_mamba2_state(
                    batch, cfg.d_model, cfg.ssm.state_size, cfg.ssm.expand,
                    device=dev), cfg.num_layers),
                "attn": stacked(kv(),
                                cfg.num_layers // cfg.hybrid_attn_every)}
    return {"attn": stacked(kv(), cfg.num_layers)}


def _layer_decode(cfg: ModelConfig, lp, x, st, cur_index: int, *,
                  window: int):
    """One-token decode through one layer's own block (a hybrid layer's
    Mamba2 block; its shared attention is `_shared_decode`). Returns (x,
    new_cache_slice)."""
    if cfg.family == "ssm":
        heads = _ssm_heads(cfg)
        h, (tm_last, wkv) = rk.time_mix(
            lp["tm"], apply_norm(x, lp["ln1"], cfg.norm),
            (st["tm_last"], st["wkv"]), num_heads=heads)
        x = x + h
        h, cm_last = rk.channel_mix(
            lp["cm"], apply_norm(x, lp["ln2"], cfg.norm), st["cm_last"])
        return x + h, {"tm_last": tm_last, "cm_last": cm_last, "wkv": wkv}
    if cfg.family == "hybrid":
        h, new_st = m2.mamba2_forward(
            lp["mamba"], apply_norm(x, lp["ln1"], cfg.norm), st,
            state_size=cfg.ssm.state_size, expand=cfg.ssm.expand)
        return x + h, new_st
    h, new_cache = attn.attn_decode(
        lp["attn"], apply_norm(x, lp["ln1"], cfg.norm), st, cur_index,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, window=window,
        rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm, mrope=cfg.mrope)
    x = x + h
    x2 = apply_norm(x, lp["ln2"], cfg.norm)
    if cfg.family == "moe":
        # decode is drop-free: the capacity covers every token on one
        # expert (a dropped token would corrupt the stream)
        h, _ = ff.moe_forward(lp["moe"], x2, num_experts=cfg.moe.num_experts,
                              top_k=cfg.moe.top_k,
                              capacity_factor=float(cfg.moe.num_experts))
    else:
        h = ff.mlp_forward(lp["mlp"], x2, cfg.activation)
    return x + h, new_cache


def _shared_decode(cfg: ModelConfig, sp, x, sl, cur_index: int, *,
                   window: int):
    """Hybrid: one-token decode through the shared attention + MLP block
    against its occurrence's cache slot ``sl``. Returns (x, new slot)."""
    h, new_sl = attn.attn_decode(
        sp["attn"], apply_norm(x, sp["ln1"], cfg.norm), sl, cur_index,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, window=window,
        rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm)
    x = x + h
    h = ff.mlp_forward(sp["mlp"], apply_norm(x, sp["ln2"], cfg.norm),
                       cfg.activation)
    return x + h, new_sl


def cache_slices(caches):
    """A cache tree as per-entry views ``{key: [slice, ...]}``, which the
    decode steps replace entry by entry and `restack` stacks again."""
    out = {}
    for key, tree in caches.items():
        leaf = tree
        while _is_tree(leaf):
            leaf = next(iter(leaf.values()))
        out[key] = [layer_params(tree, j) for j in range(leaf.shape[0])]
    return out


def restack(slices):
    return {key: stack_trees(entries) for key, entries in slices.items()}


def _decode_layer(cfg: ModelConfig, params, slices, i: int, x,
                  cur_index: int, *, window: int, mask=None):
    """Advance layer ``i`` one token: its own cache entry and, at a hybrid
    attention layer, the shared block's occurrence slot (both replaced in
    ``slices``). With ``mask`` (B,) bool, only its rows advance: the
    others keep their carry and cache entries bitwise. Returns x."""
    key = _cache_key(cfg)
    st = slices[key][i]
    x2, st2 = _layer_decode(cfg, layer_params(params["layers"], i), x, st,
                            cur_index, window=window)
    if _is_attn_layer(cfg, i):
        oi = _occurrence(cfg, i)
        sl = slices["attn"][oi]
        x2, sl2 = _shared_decode(cfg, weights(params["shared_attn"]), x2, sl,
                                 cur_index, window=window)
        slices["attn"][oi] = sl2 if mask is None else _mask_rows(mask, sl2,
                                                                 sl)
    if mask is None:
        slices[key][i] = st2
        return x2
    slices[key][i] = _mask_rows(mask, st2, st)
    return torch.where(mask[:, None, None], x2, x)


def _step_input(params, cfg: ModelConfig, token_or_embed):
    """Token ids (B,) -> (B, 1, D) embeddings; an embedding passes."""
    if token_or_embed.ndim <= 1 or not token_or_embed.is_floating_point():
        return embed_lookup(params["embed"], token_or_embed.reshape(-1, 1))
    return token_or_embed.to(torch_dtype(cfg.dtype))


def _final_logits(params, cfg: ModelConfig, x):
    """The final head on the last token: ``norm(x) @ ew`` (torch.matmul,
    as in the reference); ew is the shared head, else the last layer's."""
    ew = gather_fsdp(params["exit_w"]) if "exit_w" in params \
        else gather_fsdp(params["layers"]["exit_w"][-1])
    return constrain(apply_norm(x, params["final_norm"], cfg.norm)[:, -1, :]
                     @ ew, "batch", "model")


def _mask_rows(mask, new, old):
    """Per-sample cache merge: ``new`` where ``mask`` (B,) is set, else
    ``old``. Every cache leaf is batch-leading."""
    def sel(nw, od):
        return torch.where(mask.reshape(-1, *([1] * (nw.ndim - 1))), nw, od)
    return map_tree(sel, new, old)


def decode_step(params, cfg: ModelConfig, caches, token_or_embed,
                cur_index: int, *, split_layer=None, all_exits: bool = False,
                window_seq_len: int = 0):
    """SplitEE serve step: decode ONE token; exit confidence at
    ``split_layer`` (SplitEE) or at every exit (``all_exits``, SplitEE-S:
    one `grouped_exits` launch over the (L·B, D) rows). Returns (logits,
    conf, pred, new_caches); conf/pred are None with neither."""
    x = _step_input(params, cfg, token_or_embed)
    window = cfg.effective_window(window_seq_len)
    slices, pooled = cache_slices(caches), []
    for i in range(cfg.num_layers):
        x = _decode_layer(cfg, params, slices, i, x, cur_index,
                          window=window)
        pooled.append(pool_hidden(cfg, x))
    if all_exits:
        conf, pred = grouped_exits(params, cfg, torch.stack(pooled))
    elif split_layer is not None:
        lp = layer_params(params["layers"], split_layer)
        conf, pred = exit_confidence(
            apply_norm(pooled[split_layer], lp["exit_norm"], cfg.norm),
            _exit_w(params, lp))
    else:
        conf = pred = None
    return _final_logits(params, cfg, x), conf, pred, restack(slices)


def decode_step_masked(params, cfg: ModelConfig, caches, token_or_embed,
                       cur_index: int, depths, *, window_seq_len: int = 0):
    """Edge half of a decode-serving step: run layers ``0..depths[b]``
    per sample (``torch.where`` freezes the carry and the cache entries
    of a row above its depth, a hybrid's shared-attention slot included;
    a layer above every row's depth is not run, which leaves the same
    carry and cache). A skipped attention layer leaves its ring slot for
    this step unwritten; the ``pos`` mask excludes the hole at later
    reads, so ``cur_index`` stays global.

    Returns (logits, conf (L, B), pred (L, B), hidden (B, 1, D),
    new_caches): ``logits`` is the final head on the masked carry (it
    means something where depths[b] == L-1); conf/pred are every exit's,
    from one grouped confidence launch; ``hidden`` is the carry after
    each sample's own split layer, the offload payload.
    """
    x = _step_input(params, cfg, token_or_embed)
    window = cfg.effective_window(window_seq_len)
    live = depths.to(x.device)
    stop = int(depths.max()) + 1
    slices, pooled = cache_slices(caches), []
    for i in range(cfg.num_layers):
        if i < stop:
            x = _decode_layer(cfg, params, slices, i, x, cur_index,
                              window=window, mask=i <= live)
        pooled.append(pool_hidden(cfg, x))
    conf, pred = grouped_exits(params, cfg, torch.stack(pooled))
    return _final_logits(params, cfg, x), conf, pred, x, restack(slices)


def decode_step_resume(params, cfg: ModelConfig, caches, hidden,
                       cur_index: int, depths, active, *,
                       window_seq_len: int = 0):
    """Cloud half of a decode-serving step: resume from the shipped edge
    carry ``hidden`` (B, 1, D) and run layers ``depths[b]+1 .. L-1`` for
    the samples with ``active[b]`` set (a layer no active sample needs
    is not run). The returned cache tree equals the input bitwise
    wherever it did not advance (inactive samples, and layers <= depth),
    so committing it re-syncs the edge cache. No kernel runs here.
    Returns (logits, new_caches)."""
    x = hidden.to(torch_dtype(cfg.dtype))
    window = cfg.effective_window(window_seq_len)
    resumed = depths[active.to(depths.device)]
    start = int(resumed.min()) + 1 if resumed.numel() else cfg.num_layers
    depths, active = depths.to(x.device), active.to(x.device)
    slices = cache_slices(caches)
    for i in range(start, cfg.num_layers):
        x = _decode_layer(cfg, params, slices, i, x, cur_index,
                          window=window, mask=active & (i > depths))
    return _final_logits(params, cfg, x), restack(slices)


def prefill(params, cfg: ModelConfig, batch: Mapping[str, Any], *,
            cache_seq_len: int = 0):
    """Process the prompt (B, S), build the decode caches for a total
    length ``cache_seq_len`` (default S) and return the final logits.
    Attention layers (and a hybrid's shared-attention occurrences) write
    their rotated K/V into ring slots (the last window's worth when the
    window is shorter than the prompt); ssm layers keep their final
    token-shift rows (in the model dtype) and WKV state (float32), Mamba2
    layers their conv and SSD states (float32)."""
    x = embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    positions = _positions(cfg, b, s, device=x.device)
    seq_total = cache_seq_len or s
    window = cfg.effective_window(seq_total)
    cache_window = window or seq_total

    def kv_cache(kv):
        kk, vv = kv
        return attn.fill_cache(
            attn.init_cache(b, cache_window, cfg.num_kv_heads,
                            cfg.resolved_head_dim, torch_dtype(cfg.dtype),
                            device=x.device),
            kk[:, -cache_window:], vv[:, -cache_window:],
            start=max(0, s - cache_window))

    states, occ = [], []
    for i in range(cfg.num_layers):
        x, st, _ = _layer_prefill(cfg, params,
                                  layer_params(params["layers"], i), x,
                                  positions, i, window=window)
        if cfg.family == "hybrid":
            st, kv = st
            if kv is not None:
                occ.append(kv_cache(kv))
        elif cfg.family != "ssm":
            st = kv_cache(st)
        states.append(st)
    caches = {_cache_key(cfg): stack_trees(states)}
    if cfg.family == "hybrid":
        caches["attn"] = stack_trees(occ)
    return _final_logits(params, cfg, x), caches
