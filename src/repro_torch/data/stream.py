"""Streaming / batching utilities for the online-unsupervised phase."""
from __future__ import annotations

import numpy as np


class OnlineStream:
    """Reshuffled single-pass sample stream (the paper reshuffles per run)."""

    def __init__(self, data, seed: int = 0):
        self.data = data
        n = len(data["labels"])
        self.order = np.random.default_rng(seed).permutation(n)
        self.n = n

    def __iter__(self):
        for i in self.order:
            yield {k: v[i] for k, v in self.data.items()}

    def __len__(self):
        return self.n


def microbatches(stream, batch_size: int, max_samples: int = 0):
    """Group an iterable of per-sample dicts into lists of <= batch_size.

    The final partial batch is kept (ragged tail), so exactly
    ``min(len(stream), max_samples)`` samples are served.
    """
    buf = []
    n = 0
    for sample in stream:
        buf.append(sample)
        n += 1
        if len(buf) == batch_size:
            yield buf
            buf = []
        if max_samples and n >= max_samples:
            break
    if buf:
        yield buf


def batch_iterator(data, batch_size: int, seed: int = 0, *,
                   drop_remainder: bool = True, epochs: int = 1):
    """Shuffled mini-batches of ``data`` (a dict of equal-length arrays),
    a fresh permutation every epoch, the same batches as the reference's
    ``batch_iterator`` for the same seed."""
    n = len(data["labels"])
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = rng.permutation(n)
        stop = n - n % batch_size if drop_remainder else n
        for s in range(0, stop, batch_size):
            idx = order[s:s + batch_size]
            yield {k: v[idx] for k, v in data.items()}
