"""Cost model and reward function — paper eq. (1)/(2), in numpy.

Per-layer cost lambda = lambda1 (processing) + lambda2 (exit inference),
with lambda2 = lambda1 / 6. Arm i (1-indexed layer):

  SplitEE    gamma_i = lambda1 * i + lambda2     (one exit check, at i)
  SplitEE-S  gamma_i = lambda  * i               (exit check every layer)

Reward (eq. 1):  r(i) = C_i - mu*gamma_i                 if C_i >= alpha or i = L
                 r(i) = C_L - mu*(gamma_i + o)           otherwise.

`CostTrace` makes the offload term `o` a function of the stream round.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np

LAMBDA = 1.0
LAMBDA1 = 6.0 / 7.0
LAMBDA2 = 1.0 / 7.0


@dataclasses.dataclass(frozen=True)
class CostModel:
    num_layers: int
    alpha: float = 0.7          # confidence threshold
    mu: float = 0.1             # cost<->confidence conversion (paper: 0.1)
    offload: float = 5.0        # o, in lambda units (paper sweeps 1..5)
    lam: float = LAMBDA
    lam1: float = LAMBDA1
    lam2: float = LAMBDA2

    def gamma(self, layer, *, side_info: bool):
        """Computation cost of splitting at `layer` (1-indexed array ok)."""
        if side_info:
            return self.lam * layer
        return self.lam1 * layer + self.lam2

    def reward(self, layer, conf_i, conf_L, *, side_info: bool):
        """Vectorized eq. (1). `layer` 1-indexed; exit iff conf_i >= alpha
        or layer == L."""
        exits = (conf_i >= self.alpha) | (layer == self.num_layers)
        g = self.gamma(layer, side_info=side_info)
        r_exit = conf_i - self.mu * g
        r_off = conf_L - self.mu * (g + self.offload)
        return np.where(exits, r_exit, r_off), exits

    def sample_cost(self, layer, exits, *, side_info: bool):
        """Cost charged to the device for one sample (edge compute + exit
        inference + offload if any); cloud compute is not charged."""
        g = self.gamma(layer, side_info=side_info)
        return g + np.where(exits, 0.0, self.offload)


TRACE_KINDS = ("constant", "steps", "sinusoid")


@dataclasses.dataclass(frozen=True)
class CostTrace:
    """Time-varying offload cost ``o(round)``; ``round`` is the global
    stream position of a batch's first sample.

    * ``constant`` — ``o(t) = base``;
    * ``steps`` — ``values[k]`` on rounds ``[times[k-1], times[k])``;
    * ``sinusoid`` — ``base + amplitude * sin(2*pi*t/period)``.
    """
    kind: str = "constant"
    base: float = 5.0
    times: Tuple[int, ...] = ()
    values: Tuple[float, ...] = ()
    period: float = 0.0
    amplitude: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "times", tuple(int(t) for t in self.times))
        object.__setattr__(self, "values",
                           tuple(float(v) for v in self.values))
        if self.kind not in TRACE_KINDS:
            raise ValueError(f"CostTrace.kind={self.kind!r}: expected one "
                             f"of {TRACE_KINDS}")
        if self.kind == "steps":
            if len(self.values) != len(self.times) + 1:
                raise ValueError(
                    f"CostTrace(kind='steps') needs len(values) == "
                    f"len(times) + 1, got {len(self.values)} values for "
                    f"{len(self.times)} boundaries")
            if any(b <= a for a, b in zip(self.times, self.times[1:])):
                raise ValueError(f"CostTrace.times must be strictly "
                                 f"ascending, got {self.times}")
        if self.kind == "sinusoid" and self.period <= 0:
            raise ValueError(f"CostTrace(kind='sinusoid') needs period > 0, "
                             f"got {self.period}")

    def offload_at(self, round: int) -> float:
        """Offload cost in effect at global stream position ``round``."""
        if self.kind == "steps":
            return self.values[bisect.bisect_right(self.times, int(round))]
        if self.kind == "sinusoid":
            return self.base + self.amplitude * math.sin(
                2.0 * math.pi * int(round) / self.period)
        return self.base

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "base": self.base,
                "times": list(self.times), "values": list(self.values),
                "period": self.period, "amplitude": self.amplitude}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CostTrace":
        if not isinstance(d, dict):
            raise ValueError(f"cost trace must be a dict, got "
                             f"{type(d).__name__}")
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - fields)
        if unknown:
            raise ValueError(f"unknown cost-trace field(s) {unknown}; "
                             f"valid: {sorted(fields)}")
        return cls(**d)


def oracle_arm(cost: CostModel, conf, *, side_info: bool):
    """Empirical i* = argmax_i mean_t r(i; x_t) over an (N, L) confidence
    matrix (eq. 2 estimated on the stream), in float32 as the reference.
    Returns (arm0, mean_rewards)."""
    conf = np.asarray(conf, np.float32)
    _, L = conf.shape
    layers = np.arange(1, L + 1, dtype=np.float32)[None, :]
    r, _ = cost.reward(layers, conf, conf[:, -1:], side_info=side_info)
    mean_r = np.mean(r, axis=0, dtype=np.float32)
    return int(np.argmax(mean_r)), mean_r
