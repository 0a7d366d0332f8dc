"""Confidence-threshold (alpha) calibration, in numpy float32.

As the reference: alpha is picked on a grid to maximize the oracle
split's expected reward (eq. 2) subject to an accuracy constraint when
validation labels are given (the early-exit policy may cost at most
``max_acc_drop`` accuracy against the final exit on the labeled
validation split); without labels, pure reward maximization.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.rewards import CostModel, oracle_arm


def _policy_metrics(conf, correct, cost: CostModel, *, side_info: bool):
    """(accuracy, mean reward) of the oracle split under this cost model."""
    arm, mean_r = oracle_arm(cost, conf, side_info=side_info)
    conf_i = np.asarray(conf, np.float32)[:, arm]
    exits = (conf_i >= np.float32(cost.alpha)) | (arm == cost.num_layers - 1)
    acc = np.where(exits, correct[:, arm], correct[:, -1])
    return (float(np.mean(acc, dtype=np.float32)),
            float(np.max(mean_r)))


def calibrate_alpha(conf, cost: CostModel, correct=None, *,
                    side_info: bool = False, grid=None,
                    max_acc_drop: float = 0.01) -> float:
    """alpha from ``grid`` (default 13 points over [0.5, 0.98]) for the
    (N, L) confidences ``conf`` and, optionally, the (N, L) correctness
    ``correct`` of a labeled validation split."""
    grid = grid if grid is not None else np.linspace(0.5, 0.98, 13)
    if correct is None:
        best_alpha, best_val = float(grid[0]), -np.inf
        for a in grid:
            c = dataclasses.replace(cost, alpha=float(a))
            _, mean_r = oracle_arm(c, conf, side_info=side_info)
            val = float(np.max(mean_r))
            if val > best_val:
                best_val, best_alpha = val, float(a)
        return best_alpha

    correct = np.asarray(correct)
    final_acc = float(np.mean(correct[:, -1], dtype=np.float32))
    feasible = []
    for a in grid:
        c = dataclasses.replace(cost, alpha=float(a))
        acc, val = _policy_metrics(conf, correct, c, side_info=side_info)
        feasible.append((acc >= final_acc - max_acc_drop, val, float(a)))
    ok = [(v, a) for f, v, a in feasible if f]
    if ok:
        return max(ok)[1]
    # nothing satisfies the constraint: the reference then takes the alpha
    # of the best mean reward (its comment says "most accurate"); as here
    return float(grid[int(np.argmax([f[1] for f in feasible]))])
