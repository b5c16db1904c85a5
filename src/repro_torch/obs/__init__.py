"""Telemetry of the port — the counterpart of ``repro.obs``:

* :mod:`repro_torch.obs.metrics` — ``MetricsAccumulator``, count/sum/
  sumsq/min/max + fixed-bin histograms on the agent's device, updated
  in place with no host sync, read on the host by ``summary()``;
* :mod:`repro_torch.obs.spans` — ``SpanRecorder``, host-side spans as
  Chrome-trace/Perfetto JSON over ``torch.profiler.record_function``;
* :mod:`repro_torch.obs.report` — ``run_manifest``/``attach_manifest``
  (git SHA, torch and CUDA versions, devices, config hash) and the
  shared ``flatten``/``rel_diff`` helpers;
* :mod:`repro_torch.obs.prof` — ``CostProfile``/``stage_costs``/
  ``scaling_sweep``: the flops and bytes of a fleet step counted under
  ``FakeTensorMode`` (nothing runs, no kernel launches), the RL loop's
  stage breakdown beside measured wall time, and the scaling-cliff
  classifier;
* :mod:`repro_torch.obs.timeline` — numpy-only quantiles with a
  one-bin-width bound, SLO attainment and windowed series.
"""
from repro_torch.obs.metrics import MetricDef, MetricsAccumulator
from repro_torch.obs.prof import (BackendPeaks, CostProfile, backend_peaks,
                                  profile_fn, scaling_sweep, stage_costs)
from repro_torch.obs.report import (attach_manifest, config_hash, flatten,
                                    rel_diff, run_manifest)
from repro_torch.obs.spans import SpanRecorder, span, validate_chrome_trace
from repro_torch.obs.timeline import (QUANTILES, attainment, exact_quantiles,
                                      hist_quantiles, quantile_key,
                                      window_series)

__all__ = [
    "BackendPeaks",
    "CostProfile",
    "MetricDef",
    "MetricsAccumulator",
    "QUANTILES",
    "SpanRecorder",
    "attach_manifest",
    "attainment",
    "backend_peaks",
    "config_hash",
    "exact_quantiles",
    "flatten",
    "hist_quantiles",
    "profile_fn",
    "quantile_key",
    "rel_diff",
    "run_manifest",
    "scaling_sweep",
    "span",
    "stage_costs",
    "validate_chrome_trace",
    "window_series",
]
