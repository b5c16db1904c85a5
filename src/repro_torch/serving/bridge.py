"""Async serving bridge: continuous per-(tier, variant) request queues
over warmed ``ServingEngine``s — the port of ``repro/serving/bridge.py``.

``FleetOrchestrator._dispatch`` drains its batchers one (tier, variant)
queue at a time, so three tiers' engines never overlap even though they
model independent machines (the paper's end / edge / cloud). This
bridge is the continuous analogue: one worker thread per (tier, variant)
forms batches (up to ``max_batch``, waiting at most ``max_wait_ms`` for
stragglers) and drains them concurrently, so the S/E/C engines run
overlapped as the physically separate tiers of the paper's testbed
would.

On the card each (tier, variant) queue owns a ``torch.cuda.Stream``,
entered in the thread that calls its engine, so the tiers' kernels are
queued on separate streams and can overlap on the device; on one stream
they would run in launch order whatever the threads do. Nothing here
synchronizes the device: an engine's closing copy of its tokens to the
host waits for its own stream only. Each stream first waits for the
creating thread's current stream, so the engines' parameters, written
before the bridge starts, are complete before any tier reads them. CPU
engines (and engines without a ``device``) get no stream.

Robustness semantics (all counted, all conserved):

* **deadline-aware admission** — a request whose SLO budget is already
  exhausted at submit is shed instead of queued (``shed_deadline``);
* **bounded queues** — a full per-(tier, variant) queue sheds instead
  of growing without bound (``shed_overflow``);
* **per-queue timeout + retry-once reroute** — an engine call that
  exceeds ``engine_timeout_s`` (or raises) abandons the batch; each
  affected request is rerouted ONCE to the tier's fallback queue
  (deadline permitting) and otherwise shed (``shed_timeout``). The
  exception an engine raised is kept in ``stats()["engine_errors"]``
  and on its ``bridge.timeout`` instant; one raised by an engine on the
  card (a kernel that failed to build or launch, a CUDA error) is a
  fault, not a slow engine, so ``drain()`` raises it once the
  identities balance;
* **drain timeout** — ``drain()`` bounds total wait; leftovers are
  shed (``shed_drain``) so the loop always completes.

Conservation identities::

    submitted == admitted + shed_overflow + shed_deadline   (admission)
    admitted  == served + shed_timeout + shed_drain         (after drain)

so overall ``served + shed_total == submitted``. Every shed request is
reported with its reason in ``stats()["shed_requests"]``, and
sheds/reroutes/timeouts land in the span stream as ``bridge.shed`` /
``bridge.reroute`` / ``bridge.timeout`` instants next to per-batch
``bridge.batch.*`` spans.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.serving.batching import Request, RequestBatcher

#: default tier fallback for retry-once-on-reroute: device decisions
#: fall back to the edge, the edge to the cloud, the cloud to the edge
#: (offloaded tiers always serve d0, mirroring ``api._tier_variant``)
DEFAULT_REROUTE = {"S": "E", "E": "C", "C": "E"}


@dataclasses.dataclass(frozen=True)
class BridgeConfig:
    """Knobs of the async bridge (all per (tier, variant) queue)."""
    max_batch: int = 8            # engine batch size cap
    max_wait_ms: float = 2.0      # batch-formation window for stragglers
    max_queue: int = 256          # bounded queue depth (overflow sheds)
    engine_timeout_s: float = 30.0   # per-batch engine call budget
    drain_timeout_s: float = 120.0   # total drain() budget
    min_slack_ms: float = 0.0     # extra SLO slack required at admission
    #: tier -> fallback tier for retry-once-on-reroute (None = default);
    #: rerouted requests serve the fallback tier's d0 engine
    reroute: Optional[Dict[str, str]] = None


def _engine_stream(eng) -> Optional[torch.cuda.Stream]:
    """A new stream on the engine's card, ordered after everything the
    calling thread has queued so far; None for an engine off the card."""
    dev = getattr(eng, "device", None)
    if dev is None or torch.device(dev).type != "cuda":
        return None
    stream = torch.cuda.Stream(device=dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    return stream


def _serve_on(stream, eng, reqs, toks, spans, t_drain):
    """``eng.serve_batch`` with ``stream`` current in this thread."""
    ctx = contextlib.nullcontext() if stream is None \
        else torch.cuda.stream(stream)
    with ctx:
        return eng.serve_batch(reqs, toks, spans=spans, t_drain=t_drain)


class ServingBridge:
    """Overlapped batch formation + drain over ``{tier: {variant:
    ServingEngine}}``. One ``submit()`` per request, one ``drain()``
    to completion; ``stats()`` reports the conserved counters."""

    def __init__(self, engines, cfg: Optional[BridgeConfig] = None,
                 spans=None):
        self.engines = engines
        self.cfg = cfg or BridgeConfig()
        self.spans = spans
        self._reroute = (self.cfg.reroute if self.cfg.reroute is not None
                         else DEFAULT_REROUTE)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queues: Dict[Tuple[str, str], List[Request]] = {
            (t, v): [] for t, vs in engines.items() for v in vs}
        #: (tier, variant) -> the CUDA stream its engine runs on
        self.streams = {key: _engine_stream(engines[key[0]][key[1]])
                        for key in self._queues}
        self._stop = False
        self._pending = 0            # admitted, not yet terminal
        self._terminal: set = set()  # rids already served or shed
        self._rerouted: set = set()  # rids that used their one retry
        #: rid -> (req, tier, variant) for batches handed to an engine
        self._inflight: Dict[int, Tuple[Request, str, str]] = {}
        # outcomes
        self.results: List[Tuple[Request, str, str]] = []
        self.batch_log: List[dict] = []
        self.shed_requests: List[dict] = []
        self.submitted = self.admitted = self.served = 0
        self.rerouted = self.timeouts = 0
        #: exceptions engines raised: {tier, variant, requests, error}
        self.engine_errors: List[dict] = []
        self._fault: Optional[BaseException] = None  # first card fault
        self.shed = {"overflow": 0, "deadline": 0, "timeout": 0,
                     "drain": 0}
        self._threads = [
            threading.Thread(target=self._worker, args=(key,), daemon=True,
                             name=f"bridge-{key[0]}/{key[1]}")
            for key in self._queues]
        for th in self._threads:
            th.start()

    # -- lifecycle ------------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    def stop(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for th in self._threads:
            th.join(timeout=1.0)

    # -- submit-side admission -----------------------------------------
    def submit(self, req: Request, tier: str, variant: str) -> bool:
        """Admit one request into the (tier, variant) queue. Returns
        False (and counts the shed) when admission rejects it:
        exhausted SLO budget or a full bounded queue."""
        key = (tier, variant)
        if key not in self._queues:
            raise KeyError(
                f"no engine for tier {tier!r} variant {variant!r}; "
                "build_engines(...) must cover the routed decisions")
        now = time.perf_counter()
        if not req.arrival_time:
            req.arrival_time = now
        self.submitted += 1
        elapsed_ms = (now - req.arrival_time) * 1e3
        if (req.deadline_ms != float("inf")
                and elapsed_ms + self.cfg.min_slack_ms >= req.deadline_ms):
            self._shed(req, tier, variant, "deadline", admitted=False)
            return False
        with self._cv:
            if len(self._queues[key]) >= self.cfg.max_queue:
                self._shed(req, tier, variant, "overflow", admitted=False,
                           locked=True)
                return False
            self.admitted += 1
            self._pending += 1
            self._queues[key].append(req)
            self._cv.notify_all()
        return True

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Block until every admitted request is terminal (served or
        shed). On timeout, flush still-queued / in-flight requests as
        ``shed_drain`` so the identities still balance; returns True
        iff the drain completed without flushing. Raises RuntimeError,
        from the engine's exception, if an engine on the card raised
        since the last drain: its requests are rerouted or shed all the
        same, so ``stats()`` still balances."""
        budget = self.cfg.drain_timeout_s if timeout_s is None else timeout_s
        end = time.perf_counter() + budget
        with self._cv:
            while self._pending > 0:
                remaining = end - time.perf_counter()
                if remaining <= 0:
                    break
                self._cv.wait(min(remaining, 0.05))
            clean = self._pending == 0
            if not clean:
                for (tier, variant), q in self._queues.items():
                    for req in q:
                        self._shed(req, tier, variant, "drain",
                                   admitted=True, locked=True)
                    del q[:]
                # in-flight batches past the drain budget: shed them
                # terminally now; a late engine completion finds the
                # rids in _terminal and drops the stale result
                for rid, (req, tier, variant) in list(
                        self._inflight.items()):
                    self._shed(req, tier, variant, "drain",
                               admitted=True, locked=True)
            fault, self._fault = self._fault, None
        if fault is not None:
            raise RuntimeError(
                f"an engine on the card raised during the drain: "
                f"{fault!r}") from fault
        return clean

    # -- worker side ----------------------------------------------------
    def _worker(self, key):
        tier, variant = key
        eng = self.engines[tier][variant]
        batcher = RequestBatcher(self.cfg.max_batch)
        # the engine runs in this pool's thread: the current CUDA stream
        # is per thread, so that is where the queue's stream is entered
        pool = ThreadPoolExecutor(max_workers=1,
                                  thread_name_prefix=f"eng-{tier}/{variant}")
        try:
            while True:
                with self._cv:
                    while not self._queues[key] and not self._stop:
                        self._cv.wait(0.05)
                    if not self._queues[key]:
                        if self._stop:
                            return
                        continue
                    # batch formation: wait up to max_wait_ms to fill
                    # max_batch with stragglers
                    t_end = time.perf_counter() + self.cfg.max_wait_ms / 1e3
                    while (len(self._queues[key]) < self.cfg.max_batch
                           and not self._stop):
                        left = t_end - time.perf_counter()
                        if left <= 0:
                            break
                        self._cv.wait(left)
                    reqs = self._queues[key][: self.cfg.max_batch]
                    del self._queues[key][: len(reqs)]
                    for r in reqs:
                        self._inflight[r.rid] = (r, tier, variant)
                if reqs:
                    self._serve(pool, eng, batcher, reqs, tier, variant)
        finally:
            pool.shutdown(wait=False)

    def _serve(self, pool, eng, batcher, reqs, tier, variant):
        spans = self.spans
        stream = self.streams[(tier, variant)]
        for breqs, toks, _lens in batcher.pack(reqs):
            t_form = time.perf_counter()
            fut = pool.submit(_serve_on, stream, eng, breqs, toks, spans,
                              t_form)
            try:
                done = fut.result(timeout=self.cfg.engine_timeout_s)
            except _FutureTimeout:
                self._on_timeout(breqs, tier, variant)
                continue
            except Exception as exc:
                # engine failure == timeout for routing purposes (the
                # reference's semantics: reroute once, then shed), with
                # the cause kept
                self._on_timeout(breqs, tier, variant, error=exc)
                continue
            wall = time.perf_counter() - t_form
            if spans is not None:
                self.spans.complete(f"bridge.batch.{tier}/{variant}",
                                    t_form, wall, requests=len(breqs))
            with self._cv:
                fresh = [r for r in done if r.rid not in self._terminal]
                for r in fresh:
                    self._terminal.add(r.rid)
                    self._inflight.pop(r.rid, None)
                    self.results.append((r, tier, variant))
                self.served += len(fresh)
                self._pending -= len(fresh)
                if fresh:
                    self.batch_log.append({
                        "key": f"{tier}/{variant}",
                        "requests": len(fresh),
                        "serve_time": done[0].serve_time,
                        "response_time": done[0].response_time})
                self._cv.notify_all()

    def _on_timeout(self, breqs, tier, variant, error=None):
        """Engine call exceeded its budget (or raised ``error``): retry
        each request once on the fallback tier, shed the rest. The stuck
        call's eventual result is dropped — requests are re-enqueued as
        clones so the abandoned engine cannot race their stamps."""
        self.timeouts += 1
        cause = {}
        if error is not None:
            cause = {"error": repr(error)}
            with self._cv:
                self.engine_errors.append({"tier": tier, "variant": variant,
                                           "requests": len(breqs), **cause})
                if (self.streams[(tier, variant)] is not None
                        and self._fault is None):
                    self._fault = error
        if self.spans is not None:
            self.spans.instant("bridge.timeout", tier=tier, variant=variant,
                               requests=len(breqs), **cause)
        fb_tier = self._reroute.get(tier)
        fb_key = None
        if fb_tier is not None:
            cands = [k for k in self._queues if k[0] == fb_tier]
            pref = (fb_tier, "d0")
            fb_key = pref if pref in self._queues else \
                (cands[0] if cands else None)
        now = time.perf_counter()
        with self._cv:
            for r in breqs:
                if r.rid in self._terminal:
                    continue
                left_ms = (r.deadline_ms
                           - (now - r.arrival_time) * 1e3)
                can_retry = (r.rid not in self._rerouted
                             and fb_key is not None
                             and (r.deadline_ms == float("inf")
                                  or left_ms > self.cfg.min_slack_ms)
                             and len(self._queues[fb_key])
                             < self.cfg.max_queue)
                if can_retry:
                    self._rerouted.add(r.rid)
                    self.rerouted += 1
                    self._inflight.pop(r.rid, None)
                    clone = Request(r.rid, r.prompt,
                                    max_new_tokens=r.max_new_tokens,
                                    user=r.user,
                                    arrival_time=r.arrival_time,
                                    deadline_ms=r.deadline_ms)
                    self._queues[fb_key].append(clone)
                    if self.spans is not None:
                        self.spans.instant(
                            "bridge.reroute", rid=r.rid,
                            src=f"{tier}/{variant}",
                            dst=f"{fb_key[0]}/{fb_key[1]}")
                else:
                    self._shed(r, tier, variant, "timeout", admitted=True,
                               locked=True)
            self._cv.notify_all()

    def _shed(self, req, tier, variant, reason, admitted, locked=False):
        def _record():
            if req.rid in self._terminal:
                return
            self._terminal.add(req.rid)
            self._inflight.pop(req.rid, None)
            self.shed[reason] += 1
            self.shed_requests.append({
                "rid": req.rid, "tier": tier, "variant": variant,
                "reason": reason})
            if admitted:
                self._pending -= 1
            if self.spans is not None:
                self.spans.instant("bridge.shed", rid=req.rid, tier=tier,
                                   variant=variant, reason=reason)
        if locked:
            _record()
        else:
            with self._cv:
                _record()
                self._cv.notify_all()

    # -- reporting ------------------------------------------------------
    def stats(self) -> dict:
        """Conserved counters + per-shed detail. ``submitted ==
        admitted + shed(overflow) + shed(deadline)`` and ``served +
        shed(total) == submitted`` after a clean drain."""
        shed = dict(self.shed)
        shed["total"] = sum(shed.values())
        return {
            "submitted": self.submitted,
            "admitted": self.admitted,
            "served": self.served,
            "rerouted": self.rerouted,
            "timeouts": self.timeouts,
            "shed": shed,
            "shed_requests": list(self.shed_requests),
            "engine_errors": list(self.engine_errors),
            "max_batch": self.cfg.max_batch,
            "max_wait_ms": self.cfg.max_wait_ms,
            "max_queue": self.cfg.max_queue,
        }
