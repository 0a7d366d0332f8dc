"""Exit-confidence ops: dispatch by device.

A CPU tensor runs the plain PyTorch version (`ref.py`); a CUDA tensor
launches the hand-written kernel; any other device raises. There is no
fallback from one to the other. A ``DTensor`` on the CPU (the dry run's
model-parallel steps) runs the plain version: the head product through
``DTensor``'s own ops, then the softmax and argmax on whole rows (the
logits gathered over a split vocabulary); a CUDA ``DTensor`` raises: the
kernels take no sharded head, and model-parallel serving is not ported.

Shapes: ``h (B, D)`` with ``w (D, V)``, or a leading group axis ``h (G, B,
D)`` with ``w (G, D, V)`` to evaluate G heads at once (what the JAX
package gets by ``vmap`` over the per-layer exit heads).
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import no_cuda_dtensor
from repro_torch.kernels.exit_confidence.kernel import (
    exit_confidence_cuda, exit_confidence_fused_cuda)
from repro_torch.kernels.exit_confidence.ref import (
    confidence_of, exit_confidence_fused_ref, exit_confidence_ref)
from repro_torch.shards import is_dtensor

NORM_KINDS = ("rmsnorm", "layernorm")


def _unknown_device(op: str, t: torch.Tensor):
    return ValueError(f"{op}: no kernel for device {t.device}")


def exit_confidence(h, w, bias=None):
    """Confidence + argmax of the exit head: h @ w [+ bias].

    Returns ``(conf f32, pred i32)`` of shape (B,) — (G, B) when grouped —
    where conf is the max softmax probability (the paper's C_i). The
    bias (V,) — (G, V) when grouped — is added to the logits in f32.
    """
    no_cuda_dtensor("exit_confidence", h, w)
    if is_dtensor(h):
        return _exit_confidence_dtensor(h, w, bias)
    if h.device.type == "cpu":
        return exit_confidence_ref(h, w, bias)
    if h.device.type == "cuda":
        return exit_confidence_cuda(h, w, bias)
    raise _unknown_device("exit_confidence", h)


def exit_confidence_fused(x, norm_params, w, bias=None, *,
                          kind: str = "rmsnorm"):
    """Fused exit epilogue: exit-norm + head product + online softmax.

    ``x`` is the RAW pooled hidden (pooling selects a token and the norm
    is per token, so the two commute); ``norm_params`` is the exit-norm
    dict ``{"scale"[, "bias"]}`` with entries (D,) shared or (B, D) per
    row — (G, D) or (G, B, D) when grouped; ``bias`` an optional head
    bias (V,) — (G, V) when grouped. One launch on the card.
    """
    if kind not in NORM_KINDS:
        raise ValueError(f"exit_confidence_fused kind={kind!r} is unknown; "
                         f"choose one of {NORM_KINDS}")
    no_cuda_dtensor("exit_confidence_fused", x, w)
    if x.device.type == "cpu":
        return exit_confidence_fused_ref(x, norm_params, w, bias, kind=kind)
    if x.device.type == "cuda":
        # rmsnorm has no shift: like apply_norm (the plain version), ignore
        # a "bias" entry (the reference's Pallas kernel would add it)
        nbias = norm_params.get("bias") if kind == "layernorm" else None
        return exit_confidence_fused_cuda(x, norm_params["scale"], nbias, w,
                                          bias, kind=kind)
    raise _unknown_device("exit_confidence_fused", x)


def _exit_confidence_dtensor(h, w, bias=None):
    """`exit_confidence_ref` of CPU ``DTensor``s: the logits by
    ``DTensor``'s product, then gathered to whole rows (an argmax has no
    split-vocabulary form), then the plain confidence on each rank's
    rows. Returns ``DTensor``s placed as the rows."""
    from torch.distributed.tensor import DTensor, Replicate
    logits = h.float() @ w.float()
    if bias is not None:
        logits = logits + bias.float().unsqueeze(-2)
    last = logits.ndim - 1
    rows = [Replicate() if pl.is_partial() or pl.is_shard(last) else pl
            for pl in logits.placements]
    conf, pred = confidence_of(logits.redistribute(logits.device_mesh,
                                                   rows).to_local())
    return tuple(DTensor.from_local(t, logits.device_mesh, rows,
                                    run_check=False) for t in (conf, pred))
