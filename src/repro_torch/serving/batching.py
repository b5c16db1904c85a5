"""Request batching — a copy of ``repro/serving/batching.py`` (numpy
only): pad/pack incoming requests into fixed-shape batches, prompts
right-padded with token 0 to a shared bucket length."""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 16
    user: int = 0                   # originating end-node (orchestration)
    # host perf_counter stamp; the batcher sets it at submit() if unset,
    # so queue_time below is measurable without caller cooperation
    arrival_time: float = 0.0
    # SLO deadline stamped at submit (ms of end-to-end latency budget,
    # queue + compute); inf = no deadline
    deadline_ms: float = float("inf")
    # filled by the engine:
    output: Optional[np.ndarray] = None
    response_time: float = 0.0      # emulated batch wall (s, /compute_scale)
    queue_time: float = 0.0         # submit -> batch-drain wait (s)
    serve_time: float = 0.0         # raw host wall of the serve call (s)
    # scored at drain: e2e (queue_time + response_time) <= deadline_ms;
    # None until the engine serves the request
    deadline_met: Optional[bool] = None


class RequestBatcher:
    """Greedy fixed-size batcher with right-padding to a bucket length."""

    def __init__(self, batch_size: int, buckets=(32, 64, 128, 256)):
        self.batch_size = batch_size
        self.buckets = tuple(sorted(buckets))
        self.queue: List[Request] = []

    def submit(self, req: Request):
        if not req.arrival_time:
            req.arrival_time = time.perf_counter()
        self.queue.append(req)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _pad(self, reqs: List[Request]):
        max_len = self._bucket(max(len(r.prompt) for r in reqs))
        toks = np.zeros((len(reqs), max_len), np.int32)
        lens = np.zeros((len(reqs),), np.int32)
        for i, r in enumerate(reqs):
            p = r.prompt[-max_len:]
            toks[i, :len(p)] = p
            lens[i] = len(p)
        return reqs, toks, lens

    def next_batch(self):
        """Pop up to batch_size requests; returns (requests, tokens, lengths)
        with tokens right-padded to a shared bucket length. Draining an
        empty queue returns an empty batch ([], (0, bucket) tokens,
        (0,) lengths) — not None, not an error — so async drain loops can
        poll without a sentinel check."""
        if not self.queue:
            return ([], np.zeros((0, self.buckets[0]), np.int32),
                    np.zeros((0,), np.int32))
        reqs = self.queue[: self.batch_size]
        self.queue = self.queue[self.batch_size:]
        return self._pad(reqs)

    def pack(self, reqs: List[Request]):
        """Pad an explicit request list into fixed-shape batches. A list
        larger than batch_size splits into multiple batches instead of
        silently truncating — the async bridge's batch-formation path."""
        return [self._pad(reqs[lo:lo + self.batch_size])
                for lo in range(0, len(reqs), self.batch_size)]
