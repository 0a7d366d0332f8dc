"""Masked scan edge phase — one launch sequence per batch shape.

`batched._edge_phase` buckets each micro-batch by chosen depth and makes
one pow2-padded `edge_fn` call per distinct depth. This is its twin: the
whole micro-batch goes through ONE `edge_scan_fn` call, a masked forward
through all L layers in which each row freezes at its own split depth
(`models.transformer.forward_exits_masked`). The final hidden is the
per-sample offload payload and the (L, B) confidence/prediction planes
hold every exit's observables; serving reads them back once per
micro-batch and slices per sample (`conf[:arm+1, s]` for SplitEE-S,
`conf[arm, s]` otherwise). Non-exiting rows are queued as device tensors
indexed from the hidden, on the same `OffloadQueue`, in the same [depth
ascending, slot ascending] order the bucketed phase produces, so cloud
flushes are the same launches.

The launch sequence depends only on the batch shape, never on the depth
values; the price is that every row runs (a masked no-op through) all L
layers.

Padding: rows are padded to a multiple of `replicas` (ceil, no pow2) by
repeating the last row, so the sharded runtime's calls divide its data
axis; with one replica a batch is launched as it is. The masked forward
keeps rows independent, so padded rows cannot change live ones.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.core.rewards import CostModel
from repro_torch.serving.batched import (OffloadQueue, _as_is, _edge_phase,
                                         _pad_rows)
from repro_torch.serving.simulator import EdgeCloudRuntime

EDGE_MODES = ("bucketed", "scan", "auto")


def _edge_phase_scan(runtime: EdgeCloudRuntime, params, tokens: np.ndarray,
                     arms: np.ndarray, cost: CostModel, queue: OffloadQueue,
                     *, side_info: bool, put=_as_is, replicas: int = 1):
    """One micro-batch's edge pass as a single masked forward.

    Twin of `batched._edge_phase`: the same (conf_paths, batch_preds)
    contract and the same queue insertion order; ``put`` and
    ``replicas`` as there."""
    B = len(arms)
    arms_np = np.asarray(arms, dtype=np.int64)
    cap = -(-B // replicas) * replicas
    conf_all, pred_all, hidden = runtime.edge_scan_fn(
        params, {"tokens": put(_pad_rows(tokens, cap))},
        put(_pad_rows(arms_np, cap)))
    conf_np = conf_all.cpu().numpy()                   # (L, cap)
    pred_np = pred_all.cpu().numpy()
    conf_paths: List[Optional[np.ndarray]] = [None] * B
    batch_preds = [0] * B
    for s in range(B):
        arm = int(arms_np[s])
        # SplitEE-S reads the whole exit path <= depth; plain SplitEE reads
        # one exit — the same per-sample views _edge_phase returns
        conf_paths[s] = (conf_np[: arm + 1, s] if side_info
                         else conf_np[arm:arm + 1, s])
        batch_preds[s] = int(pred_np[arm, s])
    keep = [s for s in range(B)
            if not (float(conf_paths[s][-1]) >= cost.alpha
                    or int(arms_np[s]) + 1 == cost.num_layers)]
    # depth ascending, slot ascending: the bucketed phase's np.unique walk
    for arm in np.unique(arms_np[keep]):
        rows = [s for s in keep if int(arms_np[s]) == int(arm)]
        queue.add_rows(int(arm), hidden[rows], rows)
    return conf_paths, batch_preds


def _edge_phase_auto(runtime: EdgeCloudRuntime, params, tokens: np.ndarray,
                     arms: np.ndarray, cost: CostModel, queue: OffloadQueue,
                     *, side_info: bool, put=_as_is, replicas: int = 1):
    """Per-micro-batch pick: a batch mixing >= 2 distinct depths takes the
    masked forward; a uniform-depth batch takes the bucketed phase (one
    call there too, without the scan's all-L layers)."""
    phase = (_edge_phase_scan if len(np.unique(np.asarray(arms))) >= 2
             else _edge_phase)
    return phase(runtime, params, tokens, arms, cost, queue,
                 side_info=side_info, put=put, replicas=replicas)


def select_edge_phase(edge_mode: str):
    """Resolve an ``edge_mode`` string to its phase function."""
    phases = {"bucketed": _edge_phase, "scan": _edge_phase_scan,
              "auto": _edge_phase_auto}
    if edge_mode not in phases:
        raise ValueError(
            f"unknown edge_mode {edge_mode!r}; expected one of {EDGE_MODES}")
    return phases[edge_mode]
