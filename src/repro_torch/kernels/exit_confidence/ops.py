"""Exit-confidence ops: dispatch by device.

A CPU tensor runs the plain PyTorch version (`ref.py`); a CUDA tensor
launches the hand-written kernel; any other device raises. There is no
fallback from one to the other.

``DTensor`` inputs (model parallelism: the head ``w`` split over its
vocabulary, the rows split over the batch or replicated) run the
partials-and-combine form on either device (`_exit_dtensor`): each rank
scores its rows against its vocabulary shard (the kernel in partials mode
on the card, `ref.exit_partials_ref` on the CPU), the ranks' (max, sum,
argmax) triples are gathered over the axes that split the vocabulary (a
few KB), and one combine (`exit_combine_cuda` / `combine_partials_ref`)
gives every rank the confidences and predictions of its rows. The logits
are never gathered.

Shapes: ``h (B, D)`` with ``w (D, V)``, or a leading group axis ``h (G, B,
D)`` with ``w (G, D, V)`` to evaluate G heads at once (what the JAX
package gets by ``vmap`` over the per-layer exit heads).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.exit_confidence.kernel import (
    exit_combine_cuda, exit_confidence_cuda, exit_confidence_fused_cuda,
    exit_partials_cuda, exit_partials_fused_cuda)
from repro_torch.kernels.exit_confidence.ref import (
    combine_partials_ref, exit_confidence_fused_ref, exit_confidence_ref,
    exit_partials_fused_ref, exit_partials_ref)
from repro_torch.shards import is_dtensor, placed, shard_range

NORM_KINDS = ("rmsnorm", "layernorm")


def _unknown_device(op: str, t: torch.Tensor):
    return ValueError(f"{op}: no kernel for device {t.device}")


def exit_confidence(h, w, bias=None):
    """Confidence + argmax of the exit head: h @ w [+ bias].

    Returns ``(conf f32, pred i32)`` of shape (B,) — (G, B) when grouped —
    where conf is the max softmax probability (the paper's C_i). The
    bias (V,) — (G, V) when grouped — is added to the logits in f32.
    """
    if is_dtensor(h) or is_dtensor(w):
        return _exit_dtensor(h, w, bias)
    if h.device.type == "cpu":
        return exit_confidence_ref(h, w, bias)
    if h.device.type == "cuda":
        return exit_confidence_cuda(h, w, bias)
    raise _unknown_device("exit_confidence", h)


def _norm_bias(norm_params, kind):
    # rmsnorm has no shift: like apply_norm (the plain version), ignore
    # a "bias" entry (the reference's Pallas kernel would add it)
    return norm_params.get("bias") if kind == "layernorm" else None


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
    if is_dtensor(x) or is_dtensor(w):
        return _exit_dtensor(x, w, bias, norm=(norm_params, kind))
    if x.device.type == "cpu":
        return exit_confidence_fused_ref(x, norm_params, w, bias, kind=kind)
    if x.device.type == "cuda":
        return exit_confidence_fused_cuda(x, norm_params["scale"],
                                          _norm_bias(norm_params, kind), w,
                                          bias, kind=kind)
    raise _unknown_device("exit_confidence_fused", x)


def exit_partials(h, w, bias=None, *, col0: int = 0):
    """The (max logit f32, sum of exponentials f32, argmax i32) triples
    (…, splits, B) of ``h @ w`` (+ ``bias``) over the columns of ``w``,
    columns ``col0 ..`` of a whole head (one split on the CPU, the
    kernel's vocabulary splits on the card); `exit_combine` of every
    shard's triples is the whole head's exit."""
    if h.device.type == "cpu":
        return exit_partials_ref(h, w, bias, col0=col0)
    if h.device.type == "cuda":
        return exit_partials_cuda(h, w, bias, col0=col0)
    raise _unknown_device("exit_partials", h)


def exit_partials_fused(x, norm_params, w, bias=None, *,
                        kind: str = "rmsnorm", col0: int = 0):
    """`exit_partials` of the fused form (the exit norm of the RAW pooled
    rows first, as `exit_confidence_fused`)."""
    if x.device.type == "cpu":
        return exit_partials_fused_ref(x, norm_params, w, bias, kind=kind,
                                       col0=col0)
    if x.device.type == "cuda":
        return exit_partials_fused_cuda(x, norm_params["scale"],
                                        _norm_bias(norm_params, kind), w,
                                        bias, kind=kind, col0=col0)
    raise _unknown_device("exit_partials_fused", x)


def exit_combine(part_m, part_s, part_a):
    """(conf f32, pred i32) (…, B) from the triples (…, P, B) of P
    vocabulary splits, the lowest global column winning ties: the combine
    kernel on the card, `combine_partials_ref` on the CPU."""
    if part_m.device.type == "cpu":
        return combine_partials_ref(part_m, part_s, part_a)
    if part_m.device.type == "cuda":
        return exit_combine_cuda(part_m, part_s, part_a)
    raise _unknown_device("exit_combine", part_m)


def _exit_dtensor(h, w, bias=None, norm=None):
    """The exit of ``DTensor`` rows ``h`` (…, B, D) against a head ``w``
    (…, D, V) split over its vocabulary, plain (``norm`` None) or fused
    (``norm`` = (norm parameters, kind)): partials on each rank's rows and
    vocabulary shard, the triples gathered over the axes that split the
    vocabulary, one combine. Any split of D is gathered first (an "fsdp"
    placement), the norm's shared parameters are taken whole and its
    per-row ones as the rows. Rows or a vocabulary that their axes do not
    divide evenly raise `ValueError`. Returns ``DTensor``s (…, B) split as the
    rows and replicated elsewhere."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = (w if is_dtensor(w) else h).device_mesh
    rows, vocab = h.ndim - 2, w.ndim - 1
    h_pl = [p if p.is_shard(rows) else Replicate()
            for p in _placements_of(h, mesh)]
    w_pl = [p if p.is_shard(vocab) else Replicate()
            for p in _placements_of(w, mesh)]
    both = [m for m in range(mesh.ndim)
            if h_pl[m].is_shard() and w_pl[m].is_shard()]
    if both:
        raise ValueError(f"exit: mesh axes {both} split both the rows "
                         f"(h placed {h.placements}) and the vocabulary "
                         f"(w placed {w_pl}); a row needs every column")
    _require_even(h, h_pl, rows, mesh, "rows")
    _require_even(w, w_pl, vocab, mesh, "vocabulary")
    hd, wd = placed(h, mesh, h_pl), placed(w, mesh, w_pl)
    col0, _ = shard_range(wd, vocab)
    hl, wl, bl = hd.to_local(), wd.to_local(), None
    if bias is not None:        # (…, V), split as the head's vocabulary
        bl = placed(bias, mesh, [Shard(bias.ndim - 1) if p.is_shard()
                                 else Replicate() for p in w_pl]).to_local()
    if norm is None:
        parts = exit_partials(hl, wl, bl, col0=col0)
    else:
        params, kind = norm
        local = {k: placed(v, mesh, h_pl if v.ndim == h.ndim
                           else [Replicate()] * mesh.ndim).to_local()
                 for k, v in params.items()}
        parts = exit_partials_fused(hl, local, wl, bl, kind=kind, col0=col0)
    # every rank's triples of its rows: split as the rows, the splits axis
    # split where the vocabulary is, gathered there in rank order
    nd = parts[0].ndim
    out_pl = [Shard(nd - 1) if p.is_shard() else Replicate() for p in h_pl]
    in_pl = [Shard(nd - 2) if q.is_shard() else p
             for p, q in zip(out_pl, w_pl)]
    m, s, a = (DTensor.from_local(t, mesh, in_pl, run_check=False)
               .redistribute(mesh, out_pl).to_local() for t in parts)
    conf, pred = exit_combine(m, s, a)
    res_pl = [Shard(conf.ndim - 1) if p.is_shard() else Replicate()
              for p in h_pl]
    return tuple(DTensor.from_local(t, mesh, res_pl, run_check=False)
                 for t in (conf, pred))


def _require_even(t, pl, dim, mesh, what: str):
    """Every rank's triples are gathered as blocks of one size, so the
    axes that split ``t``'s ``dim`` must divide it evenly."""
    n = 1
    for m, p in enumerate(pl):
        if p.is_shard():
            n *= mesh.size(m)
    if t.shape[dim] % n:
        raise ValueError(f"exit: {what} of {t.shape[dim]} split {n} ways "
                         f"unevenly; the shards' triples must be of one "
                         f"size (replicate a leaf that does not divide)")


def _placements_of(t, mesh):
    """``t``'s placements on ``mesh``; a plain tensor is replicated."""
    from torch.distributed.tensor import Replicate
    if is_dtensor(t):
        if t.device_mesh != mesh:
            raise ValueError("exit: h and w lie on different meshes")
        return list(t.placements)
    return [Replicate()] * mesh.ndim
