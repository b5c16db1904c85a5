"""Telemetry of the port — the counterpart of ``repro.obs``:

* :mod:`repro_torch.obs.metrics` — ``MetricsAccumulator``, count/sum/
  sumsq/min/max + fixed-bin histograms on the agent's device, updated
  in place with no host sync, read on the host by ``summary()``;
* :mod:`repro_torch.obs.spans` — ``SpanRecorder``, host-side spans as
  Chrome-trace/Perfetto JSON over ``torch.profiler.record_function``;
* :mod:`repro_torch.obs.report` — ``run_manifest``/``attach_manifest``
  (git SHA, torch and CUDA versions, devices, config hash) and the
  shared ``flatten``/``rel_diff`` helpers;
* :mod:`repro_torch.obs.timeline` — numpy-only quantiles with a
  one-bin-width bound, SLO attainment and windowed series.

The reference's ``obs.prof`` (compiled-cost profiling) is not ported
yet.
"""
from repro_torch.obs.metrics import MetricDef, MetricsAccumulator
from repro_torch.obs.report import (attach_manifest, config_hash, flatten,
                                    rel_diff, run_manifest)
from repro_torch.obs.spans import SpanRecorder, span, validate_chrome_trace
from repro_torch.obs.timeline import (QUANTILES, attainment, exact_quantiles,
                                      hist_quantiles, quantile_key,
                                      window_series)

__all__ = [
    "MetricDef",
    "MetricsAccumulator",
    "QUANTILES",
    "SpanRecorder",
    "attach_manifest",
    "attainment",
    "config_hash",
    "exact_quantiles",
    "flatten",
    "hist_quantiles",
    "quantile_key",
    "rel_diff",
    "run_manifest",
    "span",
    "validate_chrome_trace",
    "window_series",
]
