"""Quickstart of the PyTorch port: SplitEE in 60 seconds. The twin of
``examples/quickstart.py``.

Runs the online UCB split/exit policy on a simulated 12-exit confidence
stream (the paper's ElasticBERT geometry) and prints what it learned:
the chosen splitting layer, the exit/offload mix, and cost vs always
running to the final layer. The port's controller, bandit simulator and
baselines are numpy on the host, so this runs no model and uses no
device (the reference's runs its bandit scan through XLA).

    PYTHONPATH=src python examples/quickstart_torch.py
"""
import dataclasses

import numpy as np

from repro_torch.core import (CostModel, calibrate_alpha, cumulative_regret,
                              final_exit, oracle_arm, run_stream)
from repro_torch.data.profiles import PROFILE_DATASETS, simulate_exit_profiles


def main():
    spec = PROFILE_DATASETS["imdb"]
    prof = simulate_exit_profiles(spec, seed=0)
    conf = np.asarray(prof["conf"])
    correct = np.asarray(prof["correct"])
    print(f"stream: {conf.shape[0]} samples x {conf.shape[1]} exits "
          f"(IMDb-calibrated profile)")

    cost = CostModel(num_layers=12, offload=5.0)
    alpha = calibrate_alpha(conf[:2000], cost, correct[:2000])
    cost = dataclasses.replace(cost, alpha=alpha)
    print(f"alpha (validation-calibrated): {alpha:.2f}")

    out = run_stream(conf, cost=cost)
    arms = np.asarray(out["arm"])
    exited = np.asarray(out["exited"])
    best, _ = oracle_arm(cost, conf, side_info=False)
    print(f"oracle splitting layer: {best + 1}; "
          f"bandit's modal choice over the last 1000 samples: "
          f"{np.bincount(arms[-1000:]).argmax() + 1}")

    acc = np.where(exited,
                   np.take_along_axis(correct, arms[:, None], 1)[:, 0],
                   correct[:, -1]).mean()
    total = float(np.asarray(out["cost"]).sum())
    fa, fc = final_exit(conf, correct, cost)
    print(f"SplitEE:    acc={acc:.3f}  cost={total/1e4:.1f}e4λ  "
          f"(exit on edge: {exited.mean():.0%}, offload: "
          f"{1 - exited.mean():.0%})")
    print(f"final-exit: acc={float(fa.mean()):.3f}  "
          f"cost={float(fc.sum())/1e4:.1f}e4λ")
    print(f"cost reduction: "
          f"{100 * (1 - total / float(fc.sum())):.1f}%  "
          f"accuracy delta: {100 * (acc - float(fa.mean())):+.1f} pts")
    reg = np.asarray(cumulative_regret(conf, out["arm"], cost,
                                       side_info=False))
    n = len(reg)
    print(f"regret: {reg[-1]:.0f} total; rate fell from "
          f"{reg[n//10]/(n//10):.3f} to {reg[-1]/n:.3f} per sample "
          f"(sub-linear)")


if __name__ == "__main__":
    main()
