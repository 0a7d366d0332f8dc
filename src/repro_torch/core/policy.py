"""SplitEE bandit state and UCB1 arm selection (Algorithm 1), in numpy.

The host-side controller owns this O(L) state; the float32 arrays match
the reference's ``jnp.zeros`` state, so the controller's fold runs the
same float32 arithmetic. The per-sample ``bandit_step`` / ``run_stream``
/ ``run_many`` simulators are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class BanditState(NamedTuple):
    q: np.ndarray         # (L,) empirical mean reward, float32
    n: np.ndarray         # (L,) pull counts, float32
    t: int                # round counter


def init_state(num_layers: int) -> BanditState:
    return BanditState(np.zeros(num_layers, np.float32),
                       np.zeros(num_layers, np.float32), 0)


def ucb_index(state: BanditState, beta: float) -> np.ndarray:
    t = np.float32(max(int(state.t), 1))
    n = np.asarray(state.n)
    bonus = beta * np.sqrt(np.log(t) / np.maximum(n, np.float32(1e-9)))
    return np.where(n > 0, np.asarray(state.q) + bonus, np.inf)


def select_arm(state: BanditState, num_layers: int, beta: float) -> int:
    """Round-robin through the first L rounds, then UCB (first index wins
    a tie, as ``argmax`` does)."""
    if int(state.t) < num_layers:
        return int(state.t) % num_layers
    return int(np.argmax(ucb_index(state, beta)))
