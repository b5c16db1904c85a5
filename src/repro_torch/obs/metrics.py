"""In-loop metrics: an accumulator of count/sum/sumsq/min/max plus
fixed-bin histograms with exact merges — the port of
``repro/obs/metrics.py``.

``MetricsAccumulator`` rides along the fleet training loops
(``FleetQLearning``, ``FleetDQN``): every ``update`` folds one
observation per stream into tensors on the agent's device, in place,
and never waits for the device — nothing is fetched until
:meth:`MetricsAccumulator.summary` is called on the host.

The leaves and their dtypes are the reference's. Each metric carries a
``lanes`` axis (lanes = cells for per-cell signals): updates are
elementwise along lanes, histograms are integer scatter-adds, and the
only cross-lane reduction — the scalar mean/std/min/max — happens
host-side in float64 numpy at ``summary()`` time.

``merge`` is plain ``+`` on count/total/sumsq/hist and ``min``/``max``
on extrema — associative, and exact on the integer leaves and extrema;
float sums carry the usual reassociation ULPs across *different*
chunkings.

Values outside ``[lo, hi)`` clip into the edge bins of the histogram
(they still count exactly toward count/total/sumsq/min/max), and the
per-stream ``underflow``/``overflow`` integer counters record exactly
how many samples did so, so ``quantiles()`` can warn on clipped tails.

A ``MetricDef`` with ``n_windows > 0`` additionally carries a
``(n_windows, lanes)`` ring of per-window count/total/min/max leaves;
the window slot is ``step // window_len`` (mod ``n_windows``), and
``summary()`` reports a learning-curve time series.

The update counter ``step`` is a Python int, as the port keeps
``FleetScenario.t`` and the cache position.

``place`` readies an accumulator for a sharded fleet
(``repro_torch.fleet.shard``): each rank keeps its block of the
per-cell lanes, while histograms, under/overflow counters and
single-lane streams are replicated. A placed ``update`` all-reduces
its histogram and counter increments (integers, exact), and
``summary`` / ``lane_means`` assemble the lanes whole first, so every
number equals the unsharded accumulator's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.obs import timeline


@dataclasses.dataclass(frozen=True)
class MetricDef:
    """Static description of one metric stream.

    lo/hi  : histogram range (values outside clip into the edge bins
             and bump the per-stream underflow/overflow counters)
    bins   : number of fixed-width histogram bins
    lanes  : independent accumulation lanes (``lanes=cells`` for
             per-cell signals, ``lanes=1`` for scalars like epsilon)
    n_windows : > 0 adds a ``(n_windows, lanes)`` ring of per-window
             count/total/min/max leaves; update ``step`` lands in slot
             ``(step // window_len) % n_windows``. 0 (default) keeps
             the stream windowless (no extra leaves).
    window_len : updates per window slot
    """
    lo: float = 0.0
    hi: float = 1.0
    bins: int = 32
    lanes: int = 1
    n_windows: int = 0
    window_len: int = 1

    def __post_init__(self):
        if not self.hi > self.lo:
            raise ValueError(f"MetricDef needs hi > lo, got [{self.lo}, {self.hi})")
        if self.bins < 1 or self.lanes < 1:
            raise ValueError("MetricDef needs bins >= 1 and lanes >= 1")
        if self.n_windows < 0 or self.window_len < 1:
            raise ValueError(
                "MetricDef needs n_windows >= 0 and window_len >= 1")


def _f32(v: float) -> float:
    """``v`` rounded to float32: the value a float32 op sees for a
    Python scalar, in the reference (weak types) and here alike."""
    return float(np.float32(v))


class MetricsAccumulator:
    """A dict of named metric streams.

    Per metric the leaves are::

        count     : (lanes,) i32   samples per lane
        total     : (lanes,) f32   sum per lane
        sumsq     : (lanes,) f32   sum of squares per lane
        mn/mx     : (lanes,) f32   running extrema (+inf/-inf when empty)
        hist      : (bins,)  i32   fixed-bin histogram over all lanes
        underflow : ()       i32   samples below lo (clipped into bin 0)
        overflow  : ()       i32   samples at/above hi (clipped into
                                   bin bins-1)

    and, when the def declares ``n_windows > 0``, the per-window ring::

        wcount    : (n_windows, lanes) i32
        wtotal    : (n_windows, lanes) f32
        wmn/wmx   : (n_windows, lanes) f32

    ``data`` maps name -> leaf dict; ``defs`` maps name ->
    :class:`MetricDef`; ``step`` counts updates (it selects the window
    slot).
    """

    def __init__(self, data: Dict[str, Dict[str, torch.Tensor]],
                 defs: Dict[str, MetricDef], step: int = 0, mesh=None):
        self.data = data
        self.defs = defs
        self.step = int(step)
        #: the fleet mesh whose ranks hold the lane blocks (``place``)
        self.mesh = mesh

    def _split(self, name: str) -> bool:
        """Does this rank hold a block of the stream's lanes?"""
        return self.data[name]["count"].shape[0] != self.defs[name].lanes

    @property
    def device(self) -> torch.device:
        return next(iter(self.data.values()))["count"].device

    # -- construction ----------------------------------------------------
    @classmethod
    def create(cls, defs: Mapping[str, MetricDef],
               device=None) -> "MetricsAccumulator":
        """Empty streams on ``device`` (``cuda`` unless the caller asks
        for another)."""
        dev = resolve_device(device)
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        data = {}
        for name, df in defs.items():
            data[name] = {
                "count": torch.zeros((df.lanes,), **i32),
                "total": torch.zeros((df.lanes,), **f32),
                "sumsq": torch.zeros((df.lanes,), **f32),
                "mn": torch.full((df.lanes,), math.inf, **f32),
                "mx": torch.full((df.lanes,), -math.inf, **f32),
                "hist": torch.zeros((df.bins,), **i32),
                "underflow": torch.zeros((), **i32),
                "overflow": torch.zeros((), **i32),
            }
            if df.n_windows:
                shape = (df.n_windows, df.lanes)
                data[name].update(
                    wcount=torch.zeros(shape, **i32),
                    wtotal=torch.zeros(shape, **f32),
                    wmn=torch.full(shape, math.inf, **f32),
                    wmx=torch.full(shape, -math.inf, **f32))
        return cls(data, dict(defs), 0)

    # -- accumulation ----------------------------------------------------
    def _as_f32(self, val) -> torch.Tensor:
        """A float32 tensor on the accumulator's device. A Python number
        becomes a device fill (no host-to-device copy); host arrays are
        copied over."""
        if isinstance(val, torch.Tensor):
            return val.to(self.device, torch.float32)
        if isinstance(val, (int, float, np.floating, np.integer)):
            return torch.full((), _f32(val), dtype=torch.float32,
                              device=self.device)
        return torch.as_tensor(np.asarray(val, np.float32),
                               device=self.device)

    def update(self, values: Mapping[str, object]) -> "MetricsAccumulator":
        """Fold one observation per metric into the streams, in place;
        returns ``self``.

        Each value is reshaped to ``(lanes, k)``; the ``k`` samples per
        lane fold elementwise into that lane. Windowed streams also fold
        the same row into slot ``(step // window_len) % n_windows`` of
        their ring. Metrics not named in ``values`` pass through
        unchanged. The bin index is the reference's ``clip(((x - lo) *
        scale).astype(int32), 0, bins - 1)`` in float32, with the clip
        taken before the conversion (the same index for every finite
        value, and no out-of-range conversion); NaN counts in bin 0, as
        XLA converts it to 0."""
        for name, val in values.items():
            if name not in self.data:
                raise KeyError(
                    f"unknown metric {name!r}; have {sorted(self.data)}")
            df = self.defs[name]
            d = self.data[name]
            lanes = d["count"].shape[0]       # this rank's block when placed
            x = self._as_f32(val)
            if x.numel() % lanes:
                raise ValueError(
                    f"metric {name!r}: value of size {x.numel()} does not "
                    f"split into {lanes} lanes")
            x = x.reshape(lanes, -1)
            k = x.shape[1]
            if k == 1:        # one sample a lane: the fleet loops' case
                tot = x[:, 0]
                sq, mn, mx = tot * tot, tot, tot
            else:
                tot = x.sum(-1)
                sq, mn, mx = (x * x).sum(-1), x.amin(-1), x.amax(-1)
            lo, hi = _f32(df.lo), _f32(df.hi)
            scale = _f32(df.bins / (df.hi - df.lo))
            # NaN takes bin 0, where XLA's conversion puts it; an
            # integer conversion of NaN is undefined here
            idx = ((x - lo) * scale).nan_to_num_(nan=0.0) \
                .clamp_(0, df.bins - 1).long()
            d["count"] += k
            d["total"] += tot
            d["sumsq"] += sq
            torch.minimum(d["mn"], mn, out=d["mn"])
            torch.maximum(d["mx"], mx, out=d["mx"])
            ones = torch.ones((idx.numel(),), dtype=torch.int32,
                              device=x.device)
            under, over = (x < lo).sum(), (x >= hi).sum()
            if self._split(name):
                # the whole fleet's increments: integers, summed exactly
                inc = torch.zeros(df.bins + 2, dtype=torch.int32,
                                  device=x.device)
                inc[:df.bins].index_add_(0, idx.reshape(-1), ones)
                inc[df.bins], inc[df.bins + 1] = under, over
                inc = self.mesh.all_sum(inc)
                d["hist"] += inc[:df.bins]
                under, over = inc[df.bins], inc[df.bins + 1]
            else:
                d["hist"].index_add_(0, idx.reshape(-1), ones)
            d["underflow"] += under
            d["overflow"] += over
            if df.n_windows:
                slot = (self.step // df.window_len) % df.n_windows
                d["wcount"][slot] += k
                d["wtotal"][slot] += tot
                torch.minimum(d["wmn"][slot], mn, out=d["wmn"][slot])
                torch.maximum(d["wmx"][slot], mx, out=d["wmx"][slot])
        self.step += 1
        return self

    def merge(self, other: "MetricsAccumulator") -> "MetricsAccumulator":
        """Associative combine into a new accumulator: sum / sum / min /
        max / sum. Exact on the integer leaves and the extrema; the
        float total/sumsq agree with single-stream accumulation up to
        summation-reassociation ULPs."""
        if self.defs != other.defs:
            raise ValueError("cannot merge accumulators with different specs")
        data = {}
        for name, d in self.data.items():
            o = other.data[name]
            data[name] = {
                "count": d["count"] + o["count"],
                "total": d["total"] + o["total"],
                "sumsq": d["sumsq"] + o["sumsq"],
                "mn": torch.minimum(d["mn"], o["mn"]),
                "mx": torch.maximum(d["mx"], o["mx"]),
                "hist": d["hist"] + o["hist"],
                "underflow": d["underflow"] + o["underflow"],
                "overflow": d["overflow"] + o["overflow"],
            }
            if self.defs[name].n_windows:
                # window slots merge positionally: meaningful when both
                # halves cover the same time axis; sequential chunks
                # should share ONE accumulator instead
                data[name].update(
                    wcount=d["wcount"] + o["wcount"],
                    wtotal=d["wtotal"] + o["wtotal"],
                    wmn=torch.minimum(d["wmn"], o["wmn"]),
                    wmx=torch.maximum(d["wmx"], o["wmx"]))
        return MetricsAccumulator(data, dict(self.defs),
                                  max(self.step, other.step), self.mesh)

    # -- placement -------------------------------------------------------
    def place(self, shard_fn: Callable, replicate_fn: Callable,
              mesh=None) -> "MetricsAccumulator":
        """Place leaves for sharded training: lane leaves of multi-lane
        metrics (lanes = cells) go through ``shard_fn(x, axis)`` (axis 0
        of the base leaves, axis 1 of the ``(n_windows, lanes)`` ring);
        histograms, under/overflow counters and single-lane leaves
        through ``replicate_fn``. ``mesh`` is the fleet mesh whose ranks
        hold the lane blocks: a placed update all-reduces its histogram
        and counter increments over it."""
        replicated = ("hist", "underflow", "overflow")
        data = {}
        for name, d in self.data.items():
            sharded = self.defs[name].lanes > 1
            leaf = {}
            for k, v in d.items():
                if k in replicated or not sharded:
                    leaf[k] = replicate_fn(v)
                elif k in ("wcount", "wtotal", "wmn", "wmx"):
                    leaf[k] = shard_fn(v, 1)      # lanes are axis 1
                else:
                    leaf[k] = shard_fn(v, 0)
            data[name] = leaf
        return MetricsAccumulator(data, dict(self.defs), self.step, mesh)

    def _whole(self, name: str, key: str) -> torch.Tensor:
        """A leaf with its lanes assembled whole."""
        v = self.data[name][key]
        if key in ("hist", "underflow", "overflow") or not self._split(name):
            return v
        return self.mesh.gather(v, axis=1 if key.startswith("w") else 0)

    # -- host-side reporting ---------------------------------------------
    def summary(self) -> Dict[str, dict]:
        """Fetch + reduce on the host (the only device->host transfer).
        The cross-lane reduction happens here in float64 numpy."""
        out = {}
        for name, d in self.data.items():
            df = self.defs[name]
            h = {k: self._whole(name, k).detach().cpu().numpy() for k in d}
            count = h["count"].astype(np.int64)
            total = h["total"].astype(np.float64)
            sumsq = h["sumsq"].astype(np.float64)
            n = int(count.sum())
            entry = {
                "count": n,
                "lanes": df.lanes,
                "hist": [int(v) for v in h["hist"]],
                "edges": [float(v) for v in
                          np.linspace(df.lo, df.hi, df.bins + 1)],
                "underflow": int(h["underflow"]),
                "overflow": int(h["overflow"]),
            }
            if df.n_windows:
                wc = h["wcount"].astype(np.int64)          # (W, lanes)
                wt = h["wtotal"].astype(np.float64)
                wmn = h["wmn"].astype(np.float64)
                wmx = h["wmx"].astype(np.float64)
                cnt = wc.sum(-1)                            # (W,)
                with np.errstate(invalid="ignore", divide="ignore"):
                    mean = wt.sum(-1) / cnt
                filled = cnt > 0
                steps = self.step
                entry["windows"] = {
                    "n_windows": df.n_windows,
                    "window_len": df.window_len,
                    "count": [int(v) for v in cnt],
                    "mean": [float(m) if ok else None
                             for m, ok in zip(mean, filled)],
                    "min": [float(v.min()) if ok else None for v, ok in
                            zip(np.where(wc > 0, wmn, np.inf), filled)],
                    "max": [float(v.max()) if ok else None for v, ok in
                            zip(np.where(wc > 0, wmx, -np.inf), filled)],
                    "last_slot": ((steps - 1) // df.window_len)
                    % df.n_windows if steps else None,
                    "wrapped": steps > df.n_windows * df.window_len,
                }
            if n:
                mean = float(total.sum() / n)
                var = max(float(sumsq.sum() / n) - mean * mean, 0.0)
                valid = count > 0
                entry.update(
                    mean=mean,
                    std=math.sqrt(var),
                    min=float(h["mn"].astype(np.float64)[valid].min()),
                    max=float(h["mx"].astype(np.float64)[valid].max()),
                )
            else:
                entry.update(mean=None, std=None, min=None, max=None)
            out[name] = entry
        return out

    def quantiles(self, name: str,
                  qs: Sequence[float] = timeline.QUANTILES,
                  warn: bool = True) -> Dict[str, object]:
        """Histogram-derived quantiles of one stream (host-side): each
        quantile is the midpoint of the bin holding that order
        statistic, within one ``bin_width`` of the exact value unless
        the stream's underflow/overflow counts flag clipped tails
        (``clipped=True`` + a ``UserWarning`` unless ``warn=False``)."""
        d = self.data[name]
        df = self.defs[name]
        return timeline.hist_quantiles(
            d["hist"].cpu().numpy(), np.linspace(df.lo, df.hi, df.bins + 1),
            qs, underflow=int(d["underflow"]), overflow=int(d["overflow"]),
            warn=warn)

    def lane_means(self, name: str) -> np.ndarray:
        """Per-lane means (NaN for empty lanes) — e.g. per-cell reward."""
        count = self._whole(name, "count").cpu().numpy().astype(np.float64)
        total = self._whole(name, "total").cpu().numpy().astype(np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            return total / np.where(count > 0, count, np.nan)
