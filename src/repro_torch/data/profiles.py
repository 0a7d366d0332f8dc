"""Calibrated per-exit (confidence, correctness) profile simulator.

The paper evaluates SplitEE on five datasets streamed through a fine-tuned
12-exit ElasticBERT. Those weights/datasets are not available offline, so
the *paper-scale* benchmarks (Table 2, Figs 3-7) run the bandit on
synthetic per-exit profiles whose generative model preserves the empirical
structure reported in the paper:

* each sample has a latent **confidence-onset depth**: the exit from which
  the network is confidently (and, easy samples, correctly) decided —
  BERT-class models resolve most sentiment/NLI samples within the first
  third of the stack (paper §5.4: ElasticBERT exits 65 % of samples by
  layer 6);
* "hard" samples never clear the threshold on-device (the offload
  population), with accuracy that grows slowly with depth;
* monotone coupling: once confident/correct, a sample stays so deeper
  (modulo final-layer "overthinking", the paper's footnote 1);
* QQP regime: a 15-20 % slice is misclassified WITH high confidence at
  early exits (paper §5.6/§6), inverting the usual cost-vs-o trend.

The small-scale *real* path (train a multi-exit model on
repro_torch.data.synthetic and serve it) is `launch/train.py` and
`launch/serve.py:build_testbed`; this module is for paper-scale numbers
at tractable runtime. It is a numpy copy of the reference package's
module, draw for draw, so both give the same arrays for the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

L = 12  # ElasticBERT exits


@dataclasses.dataclass(frozen=True)
class ProfileSpec:
    name: str
    n: int                    # stream length (paper Table 1)
    final_acc: float          # paper Table 2 final-exit accuracy (x100)
    easy_frac: float          # samples with an on-device confidence onset
    onset_lo: float = 0.5     # onset depth range (layers) for easy samples
    onset_hi: float = 5.5
    easy_acc: float = 0.93    # accuracy of confidently-exited samples
    hard_floor: float = 0.45  # hard-sample accuracy at exit 1
    num_classes: int = 2
    overconf: float = 0.0     # wrong-but-confident fraction (QQP)
    overthink: float = 0.0    # final-layer accuracy dip on easy samples

    @property
    def hard_final(self) -> float:
        """Hard-sample final accuracy implied by the Table 2 target."""
        hf = (self.final_acc - self.easy_frac * self.easy_acc) \
            / max(1.0 - self.easy_frac, 1e-6)
        return float(np.clip(hf, 1.0 / self.num_classes, 0.99))


PROFILE_DATASETS: Dict[str, ProfileSpec] = {
    "imdb": ProfileSpec("imdb", 25_000, 0.834, easy_frac=0.70),
    "yelp": ProfileSpec("yelp", 560_000, 0.778, easy_frac=0.66,
                        easy_acc=0.90),
    "scitail": ProfileSpec("scitail", 24_000, 0.789, easy_frac=0.30,
                           onset_lo=3.0, onset_hi=9.0, easy_acc=0.96),
    "snli": ProfileSpec("snli", 550_000, 0.802, easy_frac=0.62,
                        num_classes=3, easy_acc=0.92),
    "qqp": ProfileSpec("qqp", 365_000, 0.710, easy_frac=0.72,
                       easy_acc=0.80, overconf=0.18, overthink=0.06),
}


def simulate_exit_profiles(spec: ProfileSpec, seed: int = 0,
                           subsample: int = 0):
    """Returns dict:
      conf    (N, L) f32 — C_i at each exit,
      correct (N, L) bool — whether exit i's argmax equals the label.
    """
    rng = np.random.default_rng(seed)
    n = spec.n if not subsample else min(spec.n, subsample)
    depth = np.arange(1, L + 1, dtype=np.float32)[None, :]   # (1, L)
    chance = 1.0 / spec.num_classes

    easy = rng.random(n) < spec.easy_frac
    # onsets skew early: BERT-class models resolve most "easy" samples in
    # the first third of the stack (paper §5.4)
    onset = np.where(
        easy,
        spec.onset_lo + (spec.onset_hi - spec.onset_lo)
        * rng.beta(1.2, 2.4, n),
        np.inf)[:, None]                                     # (N, 1)

    # --- confidence: low before onset, sharply saturating ~0.96 after;
    # the final layers are fairly confident even for hard samples (typical
    # of fine-tuned BERT), which is what makes offloading worthwhile.
    base = chance + 0.08 + 0.06 * rng.random((n, 1))
    rise = 1.0 / (1.0 + np.exp(-3.0 * (depth - onset)))
    drift = 0.45 * (depth / L) ** 2                          # late-layer drift
    conf = base + (0.96 - base) * rise + drift * (1.0 - rise) \
        + rng.normal(0, 0.025, (n, L))

    # --- correctness
    # easy: correct from onset on (confident => correct, up to easy_acc);
    # before onset they behave like hard samples.
    u = rng.random((n, 1))
    hard_acc = spec.hard_floor + (spec.hard_final - spec.hard_floor) \
        * (depth / L) ** 0.7
    pre_onset_correct = u < hard_acc                         # (N, L)
    confident = depth >= onset
    easy_correct = rng.random((n, 1)) < spec.easy_acc
    correct = np.where(confident, easy_correct, pre_onset_correct)

    # confidence of wrong-but-confident easy samples is damped (the model
    # "knows" less than it shows only for the overconf slice below)
    wrong_conf_damp = np.where(confident & ~correct,
                               rng.uniform(0.5, 0.8, (n, L)), 1.0)
    conf = np.where(confident & ~correct, conf * wrong_conf_damp, conf)

    # overthinking: small slice flips to WRONG at the final exit only
    if spec.overthink:
        flip = (rng.random(n) < spec.overthink) & correct[:, -1]
        correct[flip, -1] = False

    # QQP regime: wrong-but-confident from the FIRST exits. Drawn from the
    # already-wrong population so the final-exit accuracy target holds.
    if spec.overconf:
        wrong_final = ~correct[:, -1]
        oc = wrong_final & (rng.random(n) < spec.overconf
                            / max(wrong_final.mean(), 1e-6))
        conf[oc] = np.maximum(conf[oc], rng.uniform(
            0.88, 0.99, (int(oc.sum()), L)))
        correct[oc] = False

    conf = np.clip(conf, chance + 0.01, 0.995).astype(np.float32)
    return {"conf": conf, "correct": correct.astype(bool)}


@dataclasses.dataclass(frozen=True)
class DriftSpec:
    """A drifting stream: segment boundaries that switch `ProfileSpec`
    parameters mid-stream (I-SplitEE's domain-shift setting — e.g. an
    imdb-like regime sliding into qqp-like overconfidence).

    ``segments`` is a sequence of ``(n_samples, ProfileSpec)`` pairs
    served back to back; ``boundaries`` are the global stream positions
    where each later segment begins (what a trace-aware oracle — and a
    step `CostTrace` — keys on).
    """
    name: str
    segments: Tuple[Tuple[int, ProfileSpec], ...]

    def __post_init__(self):
        segs = tuple((int(m), ps) for m, ps in self.segments)
        object.__setattr__(self, "segments", segs)
        if not segs:
            raise ValueError("DriftSpec needs at least one segment")
        for m, ps in segs:
            if m <= 0:
                raise ValueError(f"segment length {m} for {ps.name!r}: "
                                 f"must be positive")

    @property
    def n(self) -> int:
        return sum(m for m, _ in self.segments)

    @property
    def boundaries(self) -> Tuple[int, ...]:
        """Stream positions where segments 1..k-1 begin (the shifts)."""
        out, pos = [], 0
        for m, _ in self.segments[:-1]:
            pos += m
            out.append(pos)
        return tuple(out)


def simulate_drift_profiles(spec: DriftSpec, seed: int = 0):
    """Concatenate per-segment `simulate_exit_profiles` draws (distinct
    seeds per segment) into one drifting stream.

    Returns dict:
      conf       (N, L) f32, correct (N, L) bool — as the stationary sim,
      boundaries (k-1,) int64 — global positions of the k-1 shifts,
      segments   list of the k segment names.
    """
    parts = []
    for i, (m, ps) in enumerate(spec.segments):
        seg = dataclasses.replace(ps, n=m)
        parts.append(simulate_exit_profiles(seg, seed=seed + 1000 * i))
    return {
        "conf": np.concatenate([p["conf"] for p in parts], axis=0),
        "correct": np.concatenate([p["correct"] for p in parts], axis=0),
        "boundaries": np.asarray(spec.boundaries, np.int64),
        "segments": [ps.name for _, ps in spec.segments],
    }
