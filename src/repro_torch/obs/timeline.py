"""Time-resolved telemetry: quantiles with error bounds + SLO math — a
copy of ``repro/obs/timeline.py`` (numpy and the standard library only).

* :func:`exact_quantiles` — order statistics (``inverted_cdf``) over
  raw host-side values (e.g. the per-request e2e latencies of a
  ``fleet.api.RouteResult``).
* :func:`hist_quantiles` — the same order statistic located inside a
  fixed-bin integer histogram, reported as the bin midpoint: within one
  ``bin_width`` of the exact value unless the statistic was clipped into
  an edge bin (``clipped=True``, and a ``UserWarning`` unless
  ``warn=False``).

SLO scoring is one comparison per request — measured end-to-end
(queueing + compute) against the deadline stamped at submit — kept here
so ``RouteResult.slo()`` and any report cannot disagree about what
"attained" means.
"""
from __future__ import annotations

import warnings
from typing import Dict, Sequence, Tuple

import numpy as np

#: the standard report quantiles (P50/P90/P95/P99)
QUANTILES = (0.50, 0.90, 0.95, 0.99)


def quantile_key(q: float) -> str:
    """0.95 -> 'p95' (the key both quantile sources report under)."""
    return f"p{round(q * 100):g}"


def exact_quantiles(values, qs: Sequence[float] = QUANTILES
                    ) -> Dict[str, float]:
    """Exact order-statistic quantiles of raw host-side values.

    Uses the ``inverted_cdf`` method (the q-th quantile IS one of the
    samples, no interpolation) so the histogram bound of
    :func:`hist_quantiles` is exact: both sources report the same order
    statistic, one precisely and one to within its bin. Empty input
    returns ``{}``.
    """
    v = np.asarray(values, np.float64).ravel()
    if v.size == 0:
        return {}
    return {quantile_key(q): float(np.percentile(v, q * 100.0,
                                                 method="inverted_cdf"))
            for q in qs}


def hist_quantiles(hist, edges, qs: Sequence[float] = QUANTILES, *,
                   underflow: int = 0, overflow: int = 0,
                   warn: bool = True) -> Dict[str, object]:
    """Quantiles from a fixed-bin integer histogram, with error bound.

    ``hist`` is per-bin counts, ``edges`` the ``len(hist)+1`` bin
    edges. For each q the q-th order statistic's bin is located by
    cumulative count and reported as the bin midpoint, so
    ``|hist - exact| <= bin_width`` whenever that statistic landed
    in-range. ``underflow``/``overflow`` are the accumulator's explicit
    out-of-range counts: when nonzero the edge bins contain clipped
    mass, the bound no longer holds for quantiles landing there, and
    the result carries ``clipped=True`` (plus a ``UserWarning`` unless
    ``warn=False``).

    Returns ``{p50: .., ..., "bin_width": w, "n": total,
    "underflow": u, "overflow": o, "clipped": bool}`` — or just the
    bookkeeping keys when the histogram is empty.
    """
    h = np.asarray(hist, np.int64).ravel()
    e = np.asarray(edges, np.float64).ravel()
    if e.size != h.size + 1:
        raise ValueError(f"edges must have len(hist)+1 entries, got "
                         f"{e.size} for {h.size} bins")
    underflow, overflow = int(underflow), int(overflow)
    clipped = underflow > 0 or overflow > 0
    n = int(h.sum())
    out: Dict[str, object] = {
        "bin_width": float(e[1] - e[0]) if h.size else 0.0,
        "n": n, "underflow": underflow, "overflow": overflow,
        "clipped": clipped,
    }
    if clipped and warn:
        warnings.warn(
            f"histogram has {underflow} underflow / {overflow} overflow "
            "samples clipped into the edge bins; quantiles touching "
            "those bins are not bounded by bin_width", UserWarning,
            stacklevel=2)
    if n == 0:
        return out
    cum = np.cumsum(h)
    mids = (e[:-1] + e[1:]) / 2.0
    for q in qs:
        rank = max(1, int(np.ceil(q * n)))      # 1-based order statistic
        b = int(np.searchsorted(cum, rank))
        out[quantile_key(q)] = float(mids[b])
    return out


def attainment(measured_ms, deadline_ms: float) -> Tuple[int, int]:
    """(attained, violated) counts of measured latencies vs a deadline.

    A request attains its SLO iff its end-to-end latency is at or below
    the deadline — the exact complement split, so
    ``attained + violated == len(measured_ms)`` always (the identity
    ``tools/obs_smoke.py`` gates on).
    """
    v = np.asarray(measured_ms, np.float64).ravel()
    attained = int((v <= deadline_ms).sum())
    return attained, int(v.size) - attained


def window_series(entry: dict) -> list:
    """Flatten one ``summary()`` stream's ``windows`` block into render
    rows ``(slot, count, mean, min, max)`` — the shape
    ``tools/obsview.py --timeline`` prints. Slots are in ring order;
    ``entry["windows"]["wrapped"]`` says whether the run lapped it.
    """
    w = entry.get("windows")
    if not w:
        return []
    return [(i, int(c), m, lo, hi) for i, (c, m, lo, hi) in
            enumerate(zip(w["count"], w["mean"], w["min"], w["max"]))]
