"""AdamW with decoupled weight decay and global-norm clipping, the
reference's arithmetic term for term (not ``torch.optim.AdamW``, whose
decay is applied in another order and which has no global-norm clip).

A tree is a `ParamTree` or a nested dict of tensors; the optimizer state
mirrors the parameters' paths: ``{"m": {path: f32}, "v": {path: f32},
"count": int}``. Unlike the reference, which returns new arrays, the
update writes the parameters and the state in place: on the card that
saves a second copy of each.

``DTensor`` parameters (model parallelism) get ``DTensor`` moments placed
as they are; the global norm is taken by ``DTensor`` reductions over the
whole mesh (each shard's partial sum of squares reduced, a replicated
leaf counted once), and each rank then updates its own shards.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple

import numpy as np
import torch

from repro_torch.shards import is_dtensor


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{dotted path: leaf} of a `ParamTree` or nested dict, in its order."""
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        if isinstance(val, Mapping) or hasattr(val, "items"):
            out.update(flatten(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def adamw_init(params) -> Dict[str, Any]:
    zeros = {path: torch.zeros_like(p, dtype=torch.float32)
             for path, p in flatten(params).items()}
    return {"m": zeros, "v": {k: torch.zeros_like(z) for k, z in zeros.items()},
            "count": 0}


def clip_by_global_norm(grads, max_norm: float):
    """({path: g · min(1, max_norm / max(‖g‖, 1e-12))}, ‖g‖ f32 tensor),
    ‖g‖ the norm over every leaf, taken in float32."""
    flat = flatten(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in flat.values()))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in flat.items()}, gnorm


@torch.no_grad()
def adamw_update(params, grads, state: Dict[str, Any], cfg: AdamWConfig,
                 lr_scale=1.0) -> torch.Tensor:
    """One AdamW step, in place: each parameter p becomes
    ``p − lr·(m̂/(√v̂ + eps) + wd·p)`` in float32, cast back to p's dtype,
    with m and v in float32 and the bias corrections from the step count.
    ``grads`` has the parameters' paths. Returns the global gradient norm
    before clipping."""
    clipped, gnorm = clip_by_global_norm(grads, cfg.max_grad_norm)
    state["count"] += 1
    count = np.float32(state["count"])
    b1c = float(np.float32(1.0) - np.float32(cfg.b1) ** count)
    b2c = float(np.float32(1.0) - np.float32(cfg.b2) ** count)
    lr = float(np.float32(cfg.lr) * np.float32(lr_scale))
    for path, p in flatten(params).items():
        g32 = clipped[path].float()
        m, v = state["m"][path], state["v"][path]
        if is_dtensor(p):           # each rank updates its own shards
            g32 = g32.redistribute(p.device_mesh, p.placements).to_local()
            p, m, v = p.to_local(), m.to_local(), v.to_local()
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g32))
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        p32 = p.float()
        p.copy_((p32 - lr * (step + cfg.weight_decay * p32)).to(p.dtype))
    return gnorm
