"""Oracle and cumulative regret (paper eq. 3, Fig. 7), in numpy float32."""
from __future__ import annotations

import numpy as np

from repro_torch.core.rewards import CostModel, oracle_arm


def per_sample_rewards(conf, cost: CostModel, *, side_info: bool):
    """All-arm reward matrix r(i; x_t): (N, L) float32."""
    conf = np.asarray(conf, np.float32)
    layers = np.arange(1, conf.shape[1] + 1, dtype=np.float32)[None, :]
    r, _ = cost.reward(layers, conf, conf[:, -1:], side_info=side_info)
    return r


def cumulative_regret(conf_stream, arms, cost: CostModel, *,
                      side_info: bool):
    """Expected cumulative regret of the arm sequence ``arms`` played on
    ``conf_stream`` (already in play order): sum_t E[r(i*)] - E[r(i_t)],
    the expectations estimated by the empirical mean over the stream."""
    r = per_sample_rewards(conf_stream, cost, side_info=side_info)
    mean_r = np.mean(r, axis=0, dtype=np.float32)          # (L,) E[r(i)]
    inst = np.max(mean_r) - mean_r[np.asarray(arms)]       # (N,)
    return np.cumsum(inst, dtype=np.float32)


def oracle_policy_metrics(conf, correct, cost: CostModel, *,
                          side_info: bool):
    """Accuracy and total cost of always playing i* (upper reference)."""
    conf = np.asarray(conf, np.float32)
    correct = np.asarray(correct)
    arm, _ = oracle_arm(cost, conf, side_info=side_info)
    conf_i = conf[:, arm]
    exits = (conf_i >= np.float32(cost.alpha)) | (arm == cost.num_layers - 1)
    acc = np.where(exits, correct[:, arm], correct[:, -1])
    # the reference's gamma of a Python layer number is a double, rounded
    # to float32 as it meets the per-sample offload term
    c = np.float32(cost.gamma(arm + 1.0, side_info=side_info)) + np.where(
        exits, np.float32(0), np.float32(cost.offload))
    return {"arm": arm, "acc": np.mean(acc, dtype=np.float32),
            "cost": np.sum(c, dtype=np.float32)}
