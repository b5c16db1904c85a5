"""Host-side spans emitting Chrome-trace/Perfetto-compatible JSON — the
port of ``repro/obs/spans.py``.

``SpanRecorder.span`` times a host-side region *and* enters a
``torch.profiler.record_function`` of the same name, so when a run is
also captured with ``torch.profiler.profile(...)`` the device work
nests under our spans in the profiler timeline. Independently of the
profiler, the recorder keeps its own event list and serialises it to the
Chrome trace-event format, which both ``chrome://tracing`` and
https://ui.perfetto.dev load directly.

Spans stamp the host clock only and never synchronize the device. On the
card, PyTorch returns from a launch before the kernel has run, so spans
around device work measure when the work was enqueued: the serving
engine's ``engine.prefill`` and ``engine.decode`` spans close once their
kernels are queued, as the reference's do under JAX's asynchronous
dispatch, and only ``engine.generate`` closes after the generated tokens
reached the host.

Every instrumentation point takes an optional ``spans=None`` argument
and calls the module-level :func:`span` helper, which is a no-op
``nullcontext`` when the recorder is ``None``.

Format reference: the Trace Event Format doc (Chromium). We emit "X"
(complete) events with microsecond ``ts``/``dur`` relative to the
recorder's creation, plus optional "i" (instant) and "C" (counter)
events; :func:`validate_chrome_trace` checks the subset we emit.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

_ALLOWED_PH = ("X", "i", "C", "B", "E", "M")


def _jsonable(args: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v if isinstance(v, (bool, int, float, str)) else str(v)
            for k, v in args.items()}


class SpanRecorder:
    """Collects timed spans; serialises to Chrome trace-event JSON."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self._pid = os.getpid()
        self.events: List[Dict[str, Any]] = []

    def _us(self, t: float) -> float:
        return (t - self._t0) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Time a region; nests device work via ``record_function``."""
        t_start = self._clock()
        with torch.profiler.record_function(name):
            try:
                yield self
            finally:
                t_end = self._clock()
                self.events.append({
                    "name": name,
                    "cat": "repro.obs",
                    "ph": "X",
                    "ts": self._us(t_start),
                    "dur": (t_end - t_start) * 1e6,
                    "pid": self._pid,
                    "tid": threading.get_ident() & 0x7FFFFFFF,
                    "args": _jsonable(args),
                })

    def complete(self, name: str, t_start: float, dur_s: float, **args):
        """Record a retrospective 'X' event from host clock stamps.

        ``t_start`` is a stamp on the recorder's own clock (default
        ``time.perf_counter`` — the clock the serving stack stamps
        ``Request.arrival_time`` with) and ``dur_s`` a duration in
        seconds. Used for per-request end-to-end latency events, whose
        interval (submit -> drain + emulated compute) is only known
        after the batch drains. ``ts`` clamps at the recorder's birth
        so traces stay schema-valid even for stamps predating it.
        """
        self.events.append({
            "name": name,
            "cat": "repro.obs",
            "ph": "X",
            "ts": max(0.0, self._us(t_start)),
            "dur": max(0.0, dur_s * 1e6),
            "pid": self._pid,
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "args": _jsonable(args),
        })

    def instant(self, name: str, **args):
        self.events.append({
            "name": name, "cat": "repro.obs", "ph": "i", "s": "t",
            "ts": self._us(self._clock()), "pid": self._pid,
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "args": _jsonable(args),
        })

    def counter(self, name: str, **values):
        self.events.append({
            "name": name, "cat": "repro.obs", "ph": "C",
            "ts": self._us(self._clock()), "pid": self._pid,
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "args": {k: float(v) for k, v in values.items()},
        })

    def durations_ms(self, name: str) -> List[float]:
        """Host durations (ms) of all complete spans with this name."""
        return [e["dur"] / 1e3 for e in self.events
                if e["ph"] == "X" and e["name"] == name]

    def chrome_trace(self, manifest: Optional[dict] = None) -> dict:
        trace = {
            "traceEvents": sorted(self.events, key=lambda e: e["ts"]),
            "displayTimeUnit": "ms",
        }
        if manifest is not None:
            trace["otherData"] = manifest
        return trace

    def save(self, path: str, manifest: Optional[dict] = None) -> str:
        """Validate and write the trace JSON; returns the path."""
        trace = validate_chrome_trace(self.chrome_trace(manifest))
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(trace, f, indent=1)
        return path


def span(recorder: Optional[SpanRecorder], name: str, **args):
    """None-safe span: a nullcontext when no recorder is attached."""
    if recorder is None:
        return contextlib.nullcontext()
    return recorder.span(name, **args)


def validate_chrome_trace(trace: dict) -> dict:
    """Check a trace dict against the Chrome trace-event schema subset
    we emit; raises ``ValueError`` on the first violation, returns the
    trace unchanged otherwise (so it chains into ``json.dump``)."""
    if not isinstance(trace, dict):
        raise ValueError(f"trace must be a dict, got {type(trace).__name__}")
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("trace['traceEvents'] must be a list")
    for i, e in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            raise ValueError(f"{where} must be a dict")
        if not isinstance(e.get("name"), str) or not e["name"]:
            raise ValueError(f"{where}: missing/empty 'name'")
        ph = e.get("ph")
        if ph not in _ALLOWED_PH:
            raise ValueError(f"{where}: bad phase {ph!r} (allowed {_ALLOWED_PH})")
        if not isinstance(e.get("ts"), (int, float)) or e["ts"] < 0:
            raise ValueError(f"{where}: 'ts' must be a non-negative number")
        for key in ("pid", "tid"):
            if not isinstance(e.get(key), int):
                raise ValueError(f"{where}: '{key}' must be an int")
        if ph == "X":
            if not isinstance(e.get("dur"), (int, float)) or e["dur"] < 0:
                raise ValueError(f"{where}: 'X' event needs non-negative 'dur'")
        if "args" in e and not isinstance(e["args"], dict):
            raise ValueError(f"{where}: 'args' must be a dict")
    try:
        json.dumps(trace)
    except TypeError as exc:
        raise ValueError(f"trace is not JSON-serialisable: {exc}") from exc
    return trace
