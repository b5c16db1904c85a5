"""Serving engine — the port of ``repro/serving/engine.py``: prefill plus a
greedy decode loop over a ``Model``.

This is the "Intelligent Service" of the paper (Fig. 4): each tier
(device / edge / cloud) hosts one engine per model variant, and the
orchestrator routes requests to (tier, variant). The engine runs where
its params live; on the card its prefill and decode steps go through the
hand-written attention, int8 and selective-scan kernels, on the
caller's current CUDA stream (the serving bridge gives each engine its
own).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.obs.spans import span as _span
from repro_torch.serving.batching import RequestBatcher


class ServingEngine:
    def __init__(self, model, params, *, max_len: int = 512,
                 compute_scale: float = 1.0, hop_ms: float = 0.0):
        """``compute_scale < 1`` emulates a slower tier in the
        end-edge-cloud setting (the wall time is divided by it after the
        fact); 1.0 measures raw.

        ``hop_ms > 0`` emulates the network hop to a physically separate
        tier as a real per-batch sleep before compute. It counts in both
        the raw batch wall and the stamped ``response_time`` (an
        orchestrator measuring a remote tier sees comm + compute) and is
        not scaled by ``compute_scale``."""
        self.model = model
        self.params = params
        self.max_len = max_len
        self.compute_scale = compute_scale
        self.hop_ms = hop_ms
        self.device = params["embed"]["w"].device

    def warmup(self, batch: int, prompt_len: int):
        """One prefill and one decode step at this shape (builds the
        kernels on first use and warms the allocator)."""
        with torch.inference_mode():
            toks = torch.zeros((batch, prompt_len), dtype=torch.int32,
                               device=self.device)
            _, cache = self.model.prefill(self.params, {"tokens": toks},
                                          max_len=self.max_len)
            self.model.decode(self.params, cache, toks[:, :1])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, tokens: np.ndarray, max_new_tokens: int = 16,
                 spans=None):
        """tokens: (B, S) int32 -> (out_tokens (B, N) int32 numpy,
        wall_seconds / compute_scale). Greedy: the first index of the
        largest logit over ``[:vocab_size]``; the wall ends once the
        tokens are on the host.

        ``spans`` (a ``repro_torch.obs.spans.SpanRecorder``) wraps the
        call in ``engine.generate`` / ``engine.prefill`` /
        ``engine.decode`` spans; the timed wall is unchanged. On the card
        the prefill and decode spans close once their kernels are
        enqueued; ``engine.generate`` closes after the tokens reached the
        host."""
        vocab = self.model.cfg.vocab_size
        with _span(spans, "engine.generate", batch=int(tokens.shape[0]),
                   prompt_len=int(tokens.shape[1]),
                   new_tokens=max_new_tokens,
                   compute_scale=self.compute_scale), \
                torch.inference_mode():
            t0 = time.perf_counter()
            toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int32,
                                   device=self.device)
            with _span(spans, "engine.prefill"):
                logits, cache = self.model.prefill(
                    self.params, {"tokens": toks}, max_len=self.max_len)
            cur = logits[:, -1:, :vocab].argmax(-1).to(torch.int32)
            outs = []
            with _span(spans, "engine.decode", steps=max_new_tokens):
                for _ in range(max_new_tokens):
                    outs.append(cur)
                    logits, cache = self.model.decode(self.params, cache,
                                                      cur)
                    cur = logits[:, -1:, :vocab].argmax(-1).to(torch.int32)
            out = torch.cat(outs, dim=1).cpu().numpy()
            wall = (time.perf_counter() - t0) / self.compute_scale
        return out, wall

    def serve_batch(self, reqs, toks, spans=None, t_drain=None):
        """Serve one already-formed batch (requests + padded tokens):
        fills ``output``/``response_time`` plus the queue/serve stamps,
        and scores the SLO deadline stamped at submit (``deadline_met``:
        end-to-end queue + emulated compute against ``deadline_ms``).
        ``t_drain`` is the batch-formation stamp (default: now)."""
        if not reqs:
            return []
        t_drain = time.perf_counter() if t_drain is None else t_drain
        if self.hop_ms:
            time.sleep(self.hop_ms / 1e3)   # the tier's network hop
        out, wall = self.generate(toks, max_new_tokens=reqs[0].max_new_tokens,
                                  spans=spans)
        wall += self.hop_ms / 1e3           # comm is not tier-speed-scaled
        raw = time.perf_counter() - t_drain
        for i, r in enumerate(reqs):
            r.output = out[i]
            r.response_time = wall
            r.queue_time = max(0.0, t_drain - r.arrival_time)
            r.serve_time = raw
            r.deadline_met = \
                (r.queue_time + r.response_time) * 1e3 <= r.deadline_ms
        return reqs

    def serve(self, batcher: RequestBatcher, spans=None):
        """Drain one batch from the batcher (an empty drain returns [])."""
        t_drain = time.perf_counter()
        reqs, toks, _lens = batcher.next_batch()
        if not reqs:
            return []
        return self.serve_batch(reqs, toks, spans=spans, t_drain=t_drain)
