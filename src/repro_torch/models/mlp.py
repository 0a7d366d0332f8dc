"""Dense feed-forward blocks: SwiGLU and GELU MLP (MoE is not ported yet)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, activation: str,
             dtype: torch.dtype, device=None):
    if activation == "swiglu":
        return {
            "wi": dense_init(gen, d_model, d_ff, dtype, device),
            "wg": dense_init(gen, d_model, d_ff, dtype, device),
            "wo": dense_init(gen, d_ff, d_model, dtype, device),
        }
    return {
        "wi": dense_init(gen, d_model, d_ff, dtype, device),
        "wo": dense_init(gen, d_ff, d_model, dtype, device),
    }


def mlp_forward(p, x, activation: str):
    if activation == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    else:
        # jax.nn.gelu defaults to the tanh approximation; torch's to erf
        h = F.gelu(x @ p["wi"], approximate="tanh")
    return h @ p["wo"]
