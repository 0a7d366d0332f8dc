"""Synthetic difficulty-structured classification data (numpy).

A copy of the reference package's generator, call for call, so
``make_dataset(domain, n, seed)`` yields the same arrays in both packages:

* per-sample difficulty — "easy" samples carry many shallow signal
  tokens (recoverable by early exits); "hard" samples carry few signals
  plus a negation token that flips the label;
* domain shift between the fine-tune domain and the streaming domain
  (signal vocabulary partially rotated, distractors changed).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

VOCAB = 512
SEQ_LEN = 64
CLS = 1  # token 0 = PAD, token 1 = CLS (prepended; exits pool position 0)


@dataclasses.dataclass(frozen=True)
class Domain:
    name: str
    num_classes: int
    signal_base: int
    signal_rotate: int
    distractor_lo: int = 64
    distractor_hi: int = VOCAB
    easy_frac: float = 0.6
    num_signals: int = 8
    negation_token: int = 2


DOMAINS: Dict[str, Domain] = {
    "sst2_like": Domain("sst2_like", 2, signal_base=4, signal_rotate=0),
    "imdb_like": Domain("imdb_like", 2, signal_base=4, signal_rotate=2,
                        distractor_lo=128),
    "yelp_like": Domain("yelp_like", 2, signal_base=4, signal_rotate=3,
                        distractor_lo=96, easy_frac=0.65),
    "rte_like": Domain("rte_like", 2, signal_base=24, signal_rotate=0,
                       easy_frac=0.45),
    "scitail_like": Domain("scitail_like", 2, signal_base=24,
                           signal_rotate=3, easy_frac=0.35),
    "mnli_like": Domain("mnli_like", 3, signal_base=40, signal_rotate=0),
    "snli_like": Domain("snli_like", 3, signal_base=40, signal_rotate=2,
                        easy_frac=0.55),
    "mrpc_like": Domain("mrpc_like", 2, signal_base=56, signal_rotate=0),
    "qqp_like": Domain("qqp_like", 2, signal_base=56, signal_rotate=1,
                       easy_frac=0.8),
}


def make_dataset(domain: str, n: int, seed: int = 0,
                 seq_len: int = SEQ_LEN):
    """Returns {"tokens": (N, seq_len) i32, "labels": (N,) i32,
    "difficulty": (N,) i32 (0 easy / 1 hard)}."""
    d = DOMAINS[domain]
    rng = np.random.default_rng(seed)
    c = rng.integers(0, d.num_classes, size=n)
    easy = rng.random(n) < d.easy_frac
    toks = rng.integers(d.distractor_lo, d.distractor_hi,
                        size=(n, seq_len)).astype(np.int32)
    toks[:, 0] = CLS

    def signals(k):
        base = d.signal_base + k * d.num_signals
        return (base + (np.arange(d.num_signals) + d.signal_rotate)
                % d.num_signals)

    labels = c.copy()
    pos_pool = np.arange(1, seq_len)
    for i in range(n):
        sig = signals(c[i])
        if easy[i]:
            k = rng.integers(5, 9)
            pos = rng.choice(pos_pool, size=k, replace=False)
            toks[i, pos] = rng.choice(sig, size=k)
        else:
            k = rng.integers(2, 4)
            pos = rng.choice(pos_pool, size=k + 1, replace=False)
            toks[i, pos[:k]] = rng.choice(sig, size=k)
            if rng.random() < 0.5:
                toks[i, pos[k]] = d.negation_token
                labels[i] = (c[i] + 1) % d.num_classes
    return {
        "tokens": toks,
        "labels": labels.astype(np.int32),
        "difficulty": (~easy).astype(np.int32),
    }
