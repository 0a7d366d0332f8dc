"""SplitEE / SplitEE-S: UCB1 bandit over splitting layers (Algorithm 1),
in numpy float32 on the host.

The host-side controller owns the O(L) `BanditState`; the float32 arrays
match the reference's ``jnp.zeros`` state, so the arithmetic is the
reference's. `bandit_step`, `run_stream` and `run_many` are the offline
simulators behind the paper's tables and regret curves: an O(L)-per-sample
recurrence, kept on the host (on the card a per-sample loop of tensor
ops would be bound by launches). `run_many` advances its runs together as
(R, L) arrays through the same step as `run_stream`, so each run equals
`run_stream` of its permuted stream bit for bit.

The simulators round as the reference's ``run_stream`` (the scanned
``bandit_step``) does on the CPU, so that a run's arms equal the
reference's exactly: a UCB race between two arms can be decided by one
float32 ulp, and a side-info run reaches such near-ties within a few
hundred samples. XLA evaluates log with Eigen's float32 polynomial
(`log_f32`), and its code generator fuses a product into the sum it
feeds (one rounding, `_fma`): in the mean update ``q·n + r``, in the UCB
``q + beta·bonus`` and, without side information, in eq. (1)'s
``C − mu·gamma``. With side information the rewards of every layer come
from constants ``mu·gamma_j`` folded first (two roundings, as numpy).

The algorithm is unsupervised: it sees only confidences. SplitEE-S side
observations: on the way to split layer i_t the edge computes every exit
j <= i_t, so all those arms update; when the sample exits on the edge (so
C_L is unobserved), the offload branch of r(j) uses the plug-in C_hat_L
= C_{i_t}, as the reference does.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np

from repro_torch.core.rewards import CostModel

_F32 = np.float32


class BanditState(NamedTuple):
    q: np.ndarray         # (L,) empirical mean reward, float32
    n: np.ndarray         # (L,) pull counts, float32
    t: int                # round counter


def init_state(num_layers: int) -> BanditState:
    return BanditState(np.zeros(num_layers, np.float32),
                       np.zeros(num_layers, np.float32), 0)


def _fma(a, b, c):
    """a·b + c rounded once to float32 (a float64 holds the product of two
    float32 exactly; its sum is rounded twice, which differs from one
    rounding only on a float32 tie, about 2^-29 of the time)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


# Eigen's float32 log polynomial (Cephes), which XLA's CPU code runs
_LOG_P = tuple(np.float32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = np.float32(-2.12194440e-4), np.float32(0.693359375)


def log_f32(x) -> np.ndarray:
    """float32 log of positive normal ``x``, bit for bit as XLA computes it
    on the CPU (Eigen's ``plog_float`` with its products fused as the code
    generator fuses them); numpy's float32 log differs from it in the
    last bit for about 3.5 % of the integers up to 600 000."""
    x = np.asarray(x, np.float32)
    bits = x.view(np.int32)
    m = ((bits & np.int32(-2139095041)) | np.int32(0x3F000000)).view(
        np.float32)                                   # mantissa in [0.5, 1)
    e = ((bits >> 23) - 127).astype(np.float32) + _F32(1)
    low = m < _F32(0.707106769)                       # sqrt(1/2)
    z = (m - _F32(1)) + np.where(low, m, _F32(0))
    e = e - np.where(low, _F32(1), _F32(0))
    z2 = z * z
    z3 = z2 * z
    p = _LOG_P
    y = _fma(_fma(z, p[0], p[1]), z, p[2])
    y1 = _fma(_fma(z, p[3], p[4]), z, p[5])
    y2 = _fma(_fma(z, p[6], p[7]), z, p[8])
    y = _fma(_fma(y, z3, y1), z3, y2)
    y = _fma(y, z3, e * _LOG_Q1)
    return _fma(e, _LOG_Q2, (z - _F32(0.5) * z2) + y)


def _bonus(n, t: int):
    """The UCB1 exploration term sqrt(log t / n), t >= 1 (n = 0 kept
    finite by 1e-9, as the reference)."""
    return np.sqrt(log_f32(max(int(t), 1)) / np.maximum(n, _F32(1e-9)))


def ucb_index(state: BanditState, beta: float) -> np.ndarray:
    """q + beta·bonus for pulled arms, inf for the others, rounded as the
    reference's eager ``ucb_index`` (XLA's log, each operation rounded)."""
    n = np.asarray(state.n)
    return np.where(n > 0, np.asarray(state.q) + beta * _bonus(n, state.t),
                    np.inf)


def select_arm(state: BanditState, num_layers: int, beta: float) -> int:
    """Round-robin through the first L rounds, then UCB (first index wins
    a tie, as ``argmax`` does)."""
    if int(state.t) < num_layers:
        return int(state.t) % num_layers
    return int(np.argmax(ucb_index(state, beta)))


def _step(q, n, t: int, conf_rows, cost: CostModel, beta: float,
          side_info: bool):
    """One round of R independent bandits that share the round counter
    ``t``: q, n (R, L) float32, conf_rows (R, L) float32. Returns the new
    (q, n) and the per-run arm, exited, reward, cost and conf at the
    arm."""
    num_layers = cost.num_layers
    rows = np.arange(conf_rows.shape[0])
    if t < num_layers:
        arm = np.full(rows.shape, t % num_layers, np.int32)
    else:
        ucb = np.where(n > 0, _fma(_F32(beta), _bonus(n, t), q),
                       _F32(np.inf))
        arm = np.argmax(ucb, axis=1).astype(np.int32)
    layer = arm.astype(np.float32) + _F32(1)
    conf_i = conf_rows[rows, arm]
    conf_last = conf_rows[:, num_layers - 1]
    exits = (conf_i >= _F32(cost.alpha)) | (arm == num_layers - 1)
    mu = _F32(-cost.mu)
    if not side_info:
        # eq. (1) as XLA compiles it: lam1·i rounded, then + lam2 (exit)
        # or + (lam2 + o) folded to one constant (offload); mu·gamma fused
        lam_i = _F32(cost.lam1) * layer
        r = np.where(exits, _fma(mu, lam_i + _F32(cost.lam2), conf_i),
                     _fma(mu, lam_i + (_F32(cost.lam2) + _F32(cost.offload)),
                          conf_last))
        delta_n = np.zeros_like(q)
        delta_n[rows, arm] = 1
        n_new = n + delta_n
        q_new = _fma(q, n, delta_n * r[:, None]) / np.maximum(n_new, _F32(1))
        gamma = lam_i + _F32(cost.lam2)
    else:
        layers = np.arange(1, num_layers + 1, dtype=np.float32)[None, :]
        seen = layers <= layer[:, None]                  # side obs j <= i_t
        # plug-in C_L when the sample never reaches the cloud
        chat_last = np.where(exits, conf_i, conf_last)
        r_all, _ = cost.reward(layers, conf_rows, chat_last[:, None],
                               side_info=True)
        n_new = n + seen.astype(np.float32)
        q_new = np.where(seen, _fma(q, n, r_all) / np.maximum(n_new, _F32(1)),
                         q)
        r = r_all[rows, arm]
        gamma = _F32(cost.lam) * layer
    c = np.where(exits, _F32(0), _F32(cost.offload)) + gamma
    return q_new, n_new, {"arm": arm, "exited": exits, "reward": r,
                          "cost": c, "conf": conf_i}


def bandit_step(state: BanditState, conf_row, *, cost: CostModel,
                beta: float = 1.0, side_info: bool = False):
    """One online round. conf_row: (L,) confidences of every exit for the
    current sample (the algorithm reads only entries <= the chosen arm;
    the full row is the simulator's convenience).

    Returns (new_state, info dict with arm (0-indexed), exited, reward,
    cost, conf)."""
    q, n, info = _step(np.asarray(state.q, np.float32)[None],
                       np.asarray(state.n, np.float32)[None], int(state.t),
                       np.asarray(conf_row, np.float32)[None], cost, beta,
                       side_info)
    return (BanditState(q[0], n[0], int(state.t) + 1),
            {k: v[0] for k, v in info.items()})


def _run_permuted(conf, perms, *, cost: CostModel, beta: float = 1.0,
                  side_info: bool = False) -> Dict[str, np.ndarray]:
    """The bandit over R streams at once: run r plays ``conf[perms[r]]``.
    conf (N, L); perms (R, N) integer. Returns {arm, exited, reward, cost,
    conf}, each (R, N)."""
    conf = np.asarray(conf, np.float32)
    perms = np.asarray(perms)
    runs, n_steps = perms.shape
    q = np.zeros((runs, cost.num_layers), np.float32)
    n = np.zeros_like(q)
    out = {"arm": np.empty((runs, n_steps), np.int32),
           "exited": np.empty((runs, n_steps), bool)}
    for key in ("reward", "cost", "conf"):
        out[key] = np.empty((runs, n_steps), np.float32)
    for t in range(n_steps):
        q, n, info = _step(q, n, t, conf[perms[:, t]], cost, beta, side_info)
        for key, val in info.items():
            out[key][:, t] = val
    return out


def run_stream(conf, *, cost: CostModel, beta: float = 1.0,
               side_info: bool = False) -> Dict[str, np.ndarray]:
    """The bandit over a (N, L) confidence stream in its order. Returns
    dict of per-step (N,) arrays: arm, exited, reward, cost, conf."""
    n = np.asarray(conf).shape[0]
    out = _run_permuted(conf, np.arange(n)[None], cost=cost, beta=beta,
                        side_info=side_info)
    return {k: v[0] for k, v in out.items()}


def run_many(conf, rng: np.random.Generator, *, cost: CostModel,
             beta: float = 1.0, side_info: bool = False,
             num_runs: int = 20) -> Dict[str, np.ndarray]:
    """Paper protocol: ``num_runs`` independent reshuffles of the stream,
    each a permutation drawn from ``rng``. conf: (N, L). Returns the
    stacked per-run outputs (R, N) plus ``perm`` (R, N), the permutations
    used (so accuracy can be joined against ``correct``)."""
    n = np.asarray(conf).shape[0]
    perms = np.stack([rng.permutation(n) for _ in range(num_runs)])
    out = _run_permuted(conf, perms, cost=cost, beta=beta,
                        side_info=side_info)
    out["perm"] = perms
    return out
