"""Local shards of ``DTensor``s.

Model-parallel code in the port is written once, over each rank's local
shards: a function takes its inputs' local tensors (`to_local`), computes
on them as one device would, and wraps its results back (`from_local`).
Where a rank needs more than its shard, it reads the whole tensor
(`whole`) or the offset of its slice (`shard_range`). On plain tensors
every helper is the identity (offset 0, the whole extent, no
collective), so the single-device paths run the same operations as
before.

``torch.distributed.tensor`` is imported only when a ``DTensor`` is met:
until it is imported nothing can be one (`is_dtensor`).
"""
from __future__ import annotations

import sys
from typing import Tuple


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor``. Until ``torch.distributed.tensor``
    is imported nothing can be one, so a process that never makes one
    (serving on one card) never imports it."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def check_rows_placed(x, what: str) -> None:
    """Raise unless ``x`` is plain, or on every mesh axis split on its
    first (batch) dimension or replicated."""
    if is_dtensor(x) and not all(p.is_replicate() or p.is_shard(0)
                                 for p in x.placements):
        raise ValueError(f"{what}: placed {x.placements}; it takes its "
                         f"inputs batch-sharded or replicated")


def shard_range(t, dim: int) -> Tuple[int, int]:
    """(offset, size) of this rank's slice of ``t``'s dimension ``dim``:
    the mesh axes that split it, major first (the whole extent for a
    plain tensor)."""
    offset, size = 0, t.shape[dim]
    if is_dtensor(t):
        mesh = t.device_mesh
        for m, p in enumerate(t.placements):
            if p.is_shard(dim):
                size //= mesh.size(m)
                offset += mesh.get_local_rank(m) * size
    return offset, size


def to_local(t, like=None):
    """This rank's shard of ``t`` as a plain tensor. A ``DTensor`` is
    first placed as ``like`` (default: as it is). A plain ``t`` beside a
    ``DTensor`` ``like`` is sliced to the rows ``like`` holds on its first
    dimension (a whole state beside batch-sharded inputs); otherwise it
    is returned as it is."""
    if is_dtensor(t):
        if like is not None and tuple(t.placements) != tuple(like.placements):
            t = t.redistribute(t.device_mesh, like.placements)
        return t.to_local()
    if is_dtensor(like):
        lo, n = shard_range(like, 0)
        scale = t.shape[0] // like.shape[0]
        return t[lo * scale:(lo + n) * scale]
    return t


def from_local(local, like, placements=None):
    """``local`` as a ``DTensor`` on ``like``'s mesh, placed as ``like``
    (or as ``placements``): the inverse of `to_local`. A plain ``like``
    gives ``local`` back."""
    if not is_dtensor(like):
        return local
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, like.device_mesh,
                              placements or like.placements, run_check=False)


def batch_placements(like):
    """Placements of a tensor that holds, on each rank, values for the
    rows ``like`` holds on its first (batch) dimension: split as ``like``
    there, replicated elsewhere (None for a plain ``like``)."""
    if not is_dtensor(like):
        return None
    from torch.distributed.tensor import Replicate
    return [p if p.is_shard(0) else Replicate() for p in like.placements]


def row_partials(like):
    """Placements of a tensor that each rank computed from its own rows
    of ``like``: a partial sum over the mesh axes that split ``like``,
    replicated over the others (None for a plain ``like``)."""
    if not is_dtensor(like):
        return None
    from torch.distributed.tensor import Partial, Replicate
    return [Partial() if p.is_shard() else Replicate()
            for p in like.placements]


def whole(t, rows_of=None):
    """``t`` gathered whole on every rank, as a plain tensor. What a rank
    computes from it reads only the rows it holds of ``rows_of`` (default
    ``t``), so its gradient comes back as a partial sum over the axes
    that split them. A plain ``t`` is returned as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    mesh = t.device_mesh
    return t.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=row_partials(t if rows_of is None else rows_of))
