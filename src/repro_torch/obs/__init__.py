"""Telemetry of the port: the numpy-only timeline reductions (quantiles,
SLO attainment)."""
