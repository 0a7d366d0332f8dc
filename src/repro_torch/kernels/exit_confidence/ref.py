"""Plain PyTorch versions of the exit-confidence ops.

Given pooled hidden states ``h (B, D)`` and an exit head ``w (D, V)``
(+ optional bias), return the paper's confidence ``C_i = max_c
softmax(l)_c`` and the argmax class, materializing the full logits (what
the CUDA kernels avoid). A leading group axis — ``h (G, B, D)``, ``w (G,
D, V)``, bias ``(G, V)`` — evaluates G independent heads, the form in
which one call covers every exit of a layer stack.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import apply_norm


def exit_confidence_ref(h, w, bias=None):
    logits = h.float() @ w.float()
    if bias is not None:
        logits = logits + bias.float().unsqueeze(-2)
    return confidence_of(logits)


def confidence_of(logits):
    """(conf f32, pred i32) of float32 ``logits`` (..., V)."""
    m = logits.amax(dim=-1)
    s = torch.exp(logits - m.unsqueeze(-1)).sum(dim=-1)
    conf = 1.0 / s      # exp(m - logsumexp) = 1 / sum exp(l - m)
    # torch.argmax returns the FIRST maximal index on ties; the kernel's
    # tie-break is pinned to match (lowest index wins)
    pred = torch.argmax(logits, dim=-1).to(torch.int32)
    return conf, pred


def _norm_for(x, norm_params):
    """Broadcast stacked (G, D) norm entries over a (G, B, D) input."""
    if x.ndim == 3:
        return {k: (v.unsqueeze(1) if v.ndim == 2 else v)
                for k, v in norm_params.items()}
    return norm_params


def exit_confidence_fused_ref(x, norm_params, w, bias=None, *,
                              kind: str = "rmsnorm"):
    """Fused exit epilogue, unfused: ``apply_norm`` of the RAW pooled
    hidden ``x`` (cast back to its dtype), then `exit_confidence_ref`.
    ``norm_params`` entries are (D,) shared or (B, D) per row; with a
    group axis, (G, D) per group or (G, B, D) per row."""
    return exit_confidence_ref(apply_norm(x, _norm_for(x, norm_params), kind),
                               w, bias)
