"""Baselines from the paper §5.3, evaluated on (conf, correct) streams, in
numpy float32.

* final-exit      — every sample inferred at layer L (cost lambda*L).
* random-exit     — uniform random splitting layer; exit if confident else
                    offload (SplitEE cost accounting).
* DeeBERT-style   — sequential confidence cascade without offloading,
                    with separately trained (worse calibrated) exits
                    modelled by noise (``miscalib``).
* ElasticBERT-style — the same cascade with jointly trained exits.

The random baselines take a ``numpy.random.Generator`` and draw in one
place; the arithmetic lives in a function that takes the draws
(`random_exit_arms`, `deebert_cascade_draws`), so a test can hand the
port the reference's own ``jax.random`` draws. Every function returns
per-sample (acc, cost) float32 arrays.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.rewards import CostModel

_F32 = np.float32


def final_exit(conf, correct, cost: CostModel):
    n, num_layers = np.shape(conf)
    acc = np.asarray(correct)[:, -1].astype(np.float32)
    return acc, np.full((n,), cost.lam * num_layers, np.float32)


def random_exit_arms(conf, correct, cost: CostModel, arms):
    """SplitEE-style exit or offload at the given 0-indexed ``arms`` (N,)."""
    conf = np.asarray(conf, np.float32)
    correct = np.asarray(correct)
    arms = np.asarray(arms)
    num_layers = conf.shape[1]
    conf_i = np.take_along_axis(conf, arms[:, None], axis=1)[:, 0]
    exits = (conf_i >= _F32(cost.alpha)) | (arms == num_layers - 1)
    acc = np.where(exits,
                   np.take_along_axis(correct, arms[:, None], axis=1)[:, 0],
                   correct[:, -1]).astype(np.float32)
    layer = arms.astype(np.float32) + _F32(1)
    c = cost.gamma(layer, side_info=False) + np.where(
        exits, _F32(0), _F32(cost.offload))
    return acc, c


def random_exit(conf, correct, cost: CostModel, rng: np.random.Generator):
    """Uniform random splitting layer per sample, then `random_exit_arms`."""
    n, num_layers = np.shape(conf)
    return random_exit_arms(conf, correct, cost,
                            rng.integers(0, num_layers, n))


def confidence_cascade(conf, correct, cost: CostModel, *,
                       threshold: float | None = None):
    """ElasticBERT/DeeBERT-style: exit at the first layer whose confidence
    clears the threshold (no offload option); the final layer always
    exits. Cost = lambda * exit layer."""
    conf = np.asarray(conf, np.float32)
    thr = cost.alpha if threshold is None else threshold
    clears = conf >= _F32(thr)                            # (N, L)
    clears[:, -1] = True
    first = np.argmax(clears, axis=1)                     # first True
    acc = np.take_along_axis(np.asarray(correct), first[:, None], axis=1)[:, 0]
    c = _F32(cost.lam) * (first.astype(np.float32) + _F32(1))
    return acc.astype(np.float32), c


def deebert_cascade_draws(conf, correct, cost: CostModel, normal, uniform, *,
                          miscalib: float = 0.15,
                          threshold: float | None = None):
    """The DeeBERT cascade given its draws: ``normal`` (N, L) standard
    normal noise on the confidences, ``uniform`` (N, L) in [0, 1) for the
    correctness flips. Early exits get noisier confidences and flip to
    wrong with probability ``miscalib * (1 - depth)``."""
    conf = np.asarray(conf, np.float32)
    correct = np.asarray(correct, bool)
    num_layers = conf.shape[1]
    depth = np.arange(1, num_layers + 1, dtype=np.float32) / _F32(num_layers)
    noise = _F32(miscalib) * (_F32(1.2) - depth)[None, :] \
        * np.asarray(normal, np.float32)
    conf_d = np.clip(conf + noise, _F32(0), _F32(1))
    flip = np.asarray(uniform, np.float32) \
        < _F32(miscalib) * (_F32(1) - depth)[None, :]
    correct_d = np.where(flip, ~correct, correct)
    return confidence_cascade(conf_d, correct_d, cost, threshold=threshold)


def deebert_cascade(conf, correct, cost: CostModel, rng: np.random.Generator,
                    *, miscalib: float = 0.15,
                    threshold: float | None = None):
    """DeeBERT trains exits separately (frozen backbone): early exits are
    less calibrated. Models that as noise and flips before the cascade.

    A quirk kept from the reference: it draws the normal noise and the
    uniform flips from one and the same ``jax.random`` key, so the two
    arrays are correlated. Here both come from generators seeded alike
    with one seed drawn from ``rng``."""
    seed = int(rng.integers(2 ** 63))
    shape = np.shape(conf)
    normal = np.random.default_rng(seed).standard_normal(shape)
    uniform = np.random.default_rng(seed).random(shape)
    return deebert_cascade_draws(conf, correct, cost, normal, uniform,
                                 miscalib=miscalib, threshold=threshold)
