"""Deterministic synthetic token pipeline — the port's copy of
``repro/training/data.py``, numpy on the host, whose streams equal the
reference's bit for bit from the same seed.

An order-1 Markov chain with a low-rank transition structure (so a
language model has something to learn and its loss falls), packed into
fixed (batch, seq) examples. The table is the reference's arithmetic,
expression for expression, so numpy promotes it as it promotes the
reference's (float64 under numpy 2: a (V, V) table of 19.3 GB at
Granite's 49,155 tokens); its temporaries are updated in place, which
keeps the peak near two tables instead of three.

The reference draws each next token as the first index whose cumulative
probability exceeds a uniform draw, with a fresh ``cumsum`` of the
current rows at every step (O(V) a row a step). Here the row-wise
cumulative sums are built once (``np.cumsum`` along a row is the same
sequential sum whichever rows are gathered) and each draw is a binary
search of its row: ``u < cdf`` holds exactly where ``d < cdf`` for ``d``
the largest table-type value not above ``u``, and the first such index
is ``searchsorted(row, d, side="right")``, with the reference's
``argmax`` of an all-False row (index 0) where no index qualifies.
"""
from __future__ import annotations

import numpy as np


class SyntheticLM:
    """Order-1 Markov token source with a low-rank transition structure."""

    def __init__(self, vocab: int, seed: int = 0, rank: int = 16):
        rng = np.random.default_rng(seed)
        a = rng.standard_normal((vocab, rank)).astype(np.float32)
        b = rng.standard_normal((rank, vocab)).astype(np.float32)
        logits = (a @ b) / np.sqrt(rank)
        logits *= 2.0
        logits -= logits.max(1, keepdims=True)
        probs = np.exp(logits, out=logits)
        probs /= probs.sum(1, keepdims=True)
        # the rows' cumulative sums, in place a block of rows at a time
        for r0 in range(0, vocab, 1024):
            probs[r0:r0 + 1024] = np.cumsum(probs[r0:r0 + 1024], axis=1)
        self.cdf = probs
        self.vocab = vocab
        self.rng = rng

    def sample(self, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq), np.int32)
        cur = self.rng.integers(0, self.vocab, batch)
        for t in range(seq):
            out[:, t] = cur
            cur = next_tokens(self.cdf, cur, self.rng.random(batch))
        return out


def next_tokens(cdf, cur, u):
    """The reference's draw ``(u[:, None] < cumsum(probs[cur])).argmax(1)``
    from the cumulative rows ``cdf[cur]``: for each row the first index
    whose cumulative sum exceeds ``u`` (float64), 0 where none does."""
    d = u.astype(cdf.dtype)
    d = np.where(d > u, np.nextafter(d, -np.inf), d)   # largest <= u
    nxt = np.empty(len(cur), np.int64)
    for i, (row, x) in enumerate(zip(cur, d)):
        j = np.searchsorted(cdf[row], x, side="right")
        nxt[i] = j if j < cdf.shape[1] else 0
    return nxt


def batches(vocab: int, batch: int, seq: int, n_steps: int, seed: int = 0,
            extras=None):
    src = SyntheticLM(vocab, seed)
    for _ in range(n_steps):
        b = {"tokens": src.sample(batch, seq)}
        if extras:
            b.update({k: f(batch) for k, f in extras.items()})
        yield b
