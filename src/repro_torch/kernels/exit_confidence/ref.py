"""Plain PyTorch versions of the exit-confidence ops.

Given pooled hidden states ``h (B, D)`` and an exit head ``w (D, V)``
(+ optional bias), return the paper's confidence ``C_i = max_c
softmax(l)_c`` and the argmax class, materializing the full logits (what
the CUDA kernels avoid). A leading group axis — ``h (G, B, D)``, ``w (G,
D, V)``, bias ``(G, V)`` — evaluates G independent heads, the form in
which one call covers every exit of a layer stack.

A vocabulary-split head (model parallelism) takes the partials-and-combine
form the kernels run: each shard's (max logit, sum of exponentials,
argmax at a global column) triple (`exit_partials_ref`), then one combine
over the shards' triples (`combine_partials_ref`), which ties to the
lowest global column.
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


def exit_partials_ref(h, w, bias=None, *, col0: int = 0):
    """The triple of ``h @ w`` (+ ``bias``) over the columns of ``w``,
    columns ``col0 ..`` of a whole head: max logit f32, sum of
    exp(logit - max) f32 and the lowest argmax as a global column i32,
    each (…, 1, B) (one split, the kernels' (…, splits, B) layout)."""
    logits = h.float() @ w.float()
    if bias is not None:
        logits = logits + bias.float().unsqueeze(-2)
    m = logits.amax(dim=-1)
    s = torch.exp(logits - m.unsqueeze(-1)).sum(dim=-1)
    a = (torch.argmax(logits, dim=-1) + col0).to(torch.int32)
    return tuple(t.unsqueeze(-2) for t in (m, s, a))


def exit_partials_fused_ref(x, norm_params, w, bias=None, *,
                            kind: str = "rmsnorm", col0: int = 0):
    """`exit_partials_ref` after the exit norm of the RAW pooled rows, as
    `exit_confidence_fused_ref` normalises them."""
    return exit_partials_ref(apply_norm(x, _norm_for(x, norm_params), kind),
                             w, bias, col0=col0)


def combine_partials_ref(m, s, a):
    """(conf f32, pred i32) (…, B) from the triples (…, P, B) of P
    vocabulary splits: the largest max wins, each split's sum is rescaled
    to it, and among the splits that hold the max the lowest column
    wins."""
    top = m.amax(dim=-2)
    total = (s * torch.exp(m - top.unsqueeze(-2))).sum(dim=-2)
    tied = torch.where(m == top.unsqueeze(-2), a,
                       torch.iinfo(torch.int32).max)
    return 1.0 / total, tied.amin(dim=-2).to(torch.int32)


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
