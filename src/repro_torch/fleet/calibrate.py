"""Sim-to-real calibration loop: fit the latency model to measured
serving, retrain the policy on the calibrated model, report the gap
closing — the port of ``repro/fleet/calibrate.py``.

The paper's key real-setup result (Table 8) is that the orchestrator's
*predicted* latencies track *measured* end-edge-cloud wall time. The
latency model (``fleet.dynamics``) is calibrated to the paper's ARM/AWS
testbed, but the serving engines behind ``FleetOrchestrator.route(...,
dispatch=engines)`` run on another machine. This module turns the
measurement into a loop:

1. **fit** (`fit_calibration`) — split each served request's model
   prediction into (communication, compute) via
   ``dynamics.response_components`` under the routed decision, then
   least-squares ``measured_compute ≈ scale_tier * model_compute +
   offset_tier`` per tier, in float64 numpy (the measured compute is
   ``ServedRequest.measured_ms``, the engine wall).
2. **apply** (`apply_calibration` / `CalibratedDynamics`) — stamp the
   fitted ``dynamics.Calibration`` (float32, on the scenario's device)
   onto scenarios, so ``nominal_expected_response``, the oracles,
   ``holdout_reward_ratio`` and the orchestrator's predictions all
   switch to the calibrated model; `CalibratedDynamics` wraps any
   ``ScenarioSource`` the same way so ``FleetDQN`` / ``FleetQLearning``
   retrain on calibrated dynamics unchanged.
3. **report** (`calibrate_serving` / `calibration_report`) — route the
   same fleet before and after, retrain the policy, and emit one
   artifact: fitted coefficients, before/after ``gap_x`` + SLO
   attainment, and the retrained policy's block.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.fleet import dynamics, topology
from repro_torch.fleet.dynamics import CALIB_TIERS, Calibration
from repro_torch.fleet.scenarios import FleetScenario

__all__ = [
    "CalibrationFit", "fit_calibration", "apply_calibration",
    "CalibratedDynamics", "calibrate_serving", "calibration_report",
]


class CalibrationFit(NamedTuple):
    """A fitted ``Calibration`` plus its per-tier fit diagnostics."""
    calib: Calibration
    #: tier -> {requests, compute_scale, hop_offset_ms, resid_rms_ms}
    per_tier: Dict[str, dict]

    def coefficients(self) -> dict:
        """JSON-ready per-tier coefficient block."""
        scale = self.calib.compute_scale.cpu().numpy()
        off = self.calib.hop_offset_ms.cpu().numpy()
        return {t: {"compute_scale": float(scale[i]),
                    "hop_offset_ms": float(off[i]),
                    **{k: v for k, v in self.per_tier.get(t, {}).items()
                       if k in ("requests", "resid_rms_ms")}}
                for i, t in enumerate(CALIB_TIERS)}


def _model_components(dec, scen: FleetScenario):
    """(comm, comp) model components (ms, numpy) for a routed decision
    under the scenario's contention regime — uncalibrated by design:
    the fit always regresses against the BASE model."""
    dec = torch.as_tensor(dec, device=scen.device)
    if scen.topo is None:
        comm, comp = dynamics.response_components(
            dec, scen.end_b, scen.edge_b, active=scen.active)
    else:
        n_e, n_c, mult = topology.shared_contention(
            dec, scen.topo, active=scen.active)
        comm, comp = dynamics.response_components(
            dec, scen.end_b, scen.edge_b, counts=(n_e, n_c),
            active=scen.active, cloud_mult=mult)
    return comm.cpu().numpy(), comp.cpu().numpy()


def fit_calibration(result, scen: FleetScenario) -> CalibrationFit:
    """Fit per-tier (compute_scale, hop_offset_ms) from a dispatched
    ``RouteResult`` by least squares over the measured compute
    component.

    For every served request: the model splits into communication
    ``comm_i`` and compute ``comp_i`` under the routed decision; the
    measurement is ``measured_ms`` (the engine wall — queueing is
    excluded, as in ``gap_breakdown``'s per-request split). Per tier we
    solve ``measured_i - comm_i ~ scale * comp_i + offset`` so the
    calibrated total ``comm + offset + scale * comp`` lands on the
    measurement (the offset sits on the tier's communication hop and
    may be negative). Tiers with no served requests keep the identity
    calibration; rank-deficient tiers (constant model compute) take the
    minimum-norm solution.

    Two constraints keep the fitted model usable as training dynamics:
    ``compute_scale >= 0`` (a negative solution, from walls uncorrelated
    with the modeled compute, is clipped to 0 so a bigger model never
    predicts a faster response), and the offset is refit so that the
    CLAMPED prediction ``mean(max(comm + off + scale * comp, 0))`` equals
    ``mean(measured)`` (bisection; when nothing clamps this is the
    least-squares intercept).
    """
    comm, comp = _model_components(result.decisions, scen)
    rows = {t: [] for t in CALIB_TIERS}
    for r in result.served:
        tier = ("E" if r.action == dynamics.A_EDGE else
                "C" if r.action == dynamics.A_CLOUD else "S")
        rows[tier].append((float(comp[r.cell, r.user]),
                           float(comm[r.cell, r.user]),
                           float(r.measured_ms)))
    scale = np.ones(3)
    offset = np.zeros(3)
    per_tier = {}
    for i, t in enumerate(CALIB_TIERS):
        if not rows[t]:
            per_tier[t] = {"requests": 0}
            continue
        cp = np.array([c for c, _, _ in rows[t]])
        cm = np.array([c for _, c, _ in rows[t]])
        ms = np.array([m for _, _, m in rows[t]])
        a = np.stack([cp, np.ones_like(cp)], axis=1)
        sol, _res, _rank, _sv = np.linalg.lstsq(a, ms - cm, rcond=None)
        s = max(float(sol[0]), 0.0)
        offset[i] = _mean_match_offset(cm + s * cp, ms)
        scale[i] = s
        resid = np.maximum(cm + offset[i] + s * cp, 0.0) - ms
        per_tier[t] = {"requests": len(ms),
                       "compute_scale": scale[i],
                       "hop_offset_ms": offset[i],
                       "resid_rms_ms": float(np.sqrt(np.mean(resid ** 2)))}
    f32 = dict(dtype=torch.float32, device=scen.device)
    calib = Calibration(torch.tensor(scale, **f32),
                        torch.tensor(offset, **f32))
    return CalibrationFit(calib, per_tier)


def _mean_match_offset(base: np.ndarray, measured: np.ndarray,
                       iters: int = 60) -> float:
    """The offset making ``mean(max(base + off, 0)) == mean(measured)``
    — the intercept of the clamped model. ``base`` is the fixed part of
    the prediction (``comm + scale * comp``) per request. The mean is
    continuous and nondecreasing in ``off``, so bisection converges; the
    bracket is exact at both ends (all clamped vs. all above the
    measured mean)."""
    target = float(np.mean(measured))
    lo = -float(np.max(base))            # everything clamps -> mean 0
    hi = target                          # mean >= off + mean(base) ... >= target
    if float(np.mean(np.maximum(base + hi, 0.0))) < target:  # pragma: no cover
        hi = target + float(np.max(base))
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if float(np.mean(np.maximum(base + mid, 0.0))) < target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def apply_calibration(scen: FleetScenario,
                      calib: Optional[Calibration]) -> FleetScenario:
    """Stamp ``calib`` onto a scenario (None detaches — back to the
    uncalibrated paper model)."""
    return dataclasses.replace(scen, calib=calib)


class CalibratedDynamics:
    """`ScenarioSource` wrapper stamping a fitted ``Calibration`` onto
    every emitted scenario, so ``FleetDQN`` / ``FleetQLearning`` /
    ``nominal_expected_response`` switch to the calibrated latency path
    unchanged. A fleet mesh is the wrapped source's (``attach_mesh``
    passes it on); the calibration, per tier, is replicated."""

    state_is_scenario = True

    def __init__(self, source, calib: Calibration):
        from repro_torch.fleet.api import require_scenario_state
        require_scenario_state(source)
        self.source = source
        self.calib = calib

    def attach_mesh(self, mesh) -> None:
        attach = getattr(self.source, "attach_mesh", None)
        if attach is not None:
            attach(mesh)

    @property
    def mesh(self):
        return getattr(self.source, "mesh", None)

    @property
    def cells(self) -> int:
        return self.source.cells

    @property
    def users(self) -> int:
        return self.source.users

    @property
    def dynamic(self) -> bool:
        return self.source.dynamic

    def _stamp(self, scen: FleetScenario) -> FleetScenario:
        return dataclasses.replace(scen, calib=self.calib)

    def reset(self, draws):
        scen, _ = self.source.reset(draws)
        scen = self._stamp(scen)
        return scen, scen

    def step(self, draws, state):
        scen, _ = self.source.step(draws, state)
        scen = self._stamp(scen)
        return scen, scen


def _route_block(result) -> dict:
    """The before/after comparison block of one dispatched route."""
    slo = result.slo() or {}
    meas = slo.get("measured", {})
    pred = slo.get("predicted", {})
    return {
        "gap_x": result.gap_x,
        "predicted_mean_ms": float(result.predicted_ms.mean())
        if result.served else None,
        "measured_mean_ms": float(result.measured_ms.mean())
        if result.served else None,
        "requests": len(result.served),
        "attainment_measured": meas.get("attainment"),
        "attainment_predicted": pred.get("attainment"),
        "attainment_gap": slo.get("attainment_gap"),
    }


def calibration_report(fit: CalibrationFit, before, after,
                       retrained: Optional[dict] = None) -> dict:
    """One JSON artifact: fitted coefficients + before/after gap and
    attainment (+ optional retrained-policy block)."""
    report = {
        "coefficients": fit.coefficients(),
        "before": _route_block(before),
        "after": _route_block(after),
    }
    if retrained is not None:
        report["retrained"] = retrained
    return report


def calibrate_serving(orch, scen: FleetScenario, engines, *,
                      route_kw: Optional[dict] = None, retrain=None):
    """The full loop: route uncalibrated, fit, route calibrated,
    optionally retrain a policy on ``CalibratedDynamics``.

    orch     : a ``FleetOrchestrator`` (policy already trained)
    scen     : the fleet to dispatch (its ``calib`` is ignored — the
               'before' route always measures the base model)
    engines  : ``{tier: {variant: ServingEngine}}`` (warmed)
    route_kw : extra ``route()`` kwargs shared by both routes
    retrain  : optional callable ``retrain(calib) -> dict`` returning a
               JSON block for the report (e.g. train a ``FleetDQN`` on
               ``CalibratedDynamics`` and report its holdout ratio)

    Returns ``(report, fit, after_result)`` where ``report`` is
    ``calibration_report(...)``.
    """
    kw = dict(route_kw or {})
    base = apply_calibration(scen, None)
    before = orch.route(scen=base, dispatch=engines, **kw)
    fit = fit_calibration(before, base)
    after = orch.route(scen=apply_calibration(scen, fit.calib),
                       dispatch=engines, **kw)
    retrained = None
    if retrain is not None:
        retrained = retrain(fit.calib)
    return calibration_report(fit, before, after, retrained), fit, after
