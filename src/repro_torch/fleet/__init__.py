"""The fleet layer of the port: calibrated dynamics, topologies, scenario
sources, both fleet agents, the orchestrator's routing front door and
the sim-to-real calibration loop.

The names below are those of ``repro.fleet.__all__`` that the
calibration loop and the telemetry added; they load lazily (module
``__getattr__``), as the reference's do, so importing the package runs
none of its modules.
"""
_CALIBRATE = ("CalibratedDynamics", "CalibrationFit", "apply_calibration",
              "calibrate_serving", "calibration_report", "fit_calibration")
_POPULATION = ("fleet_metrics",)

__all__ = [*_CALIBRATE, *_POPULATION]


def __getattr__(name):
    import importlib
    if name in _CALIBRATE:
        mod = importlib.import_module("repro_torch.fleet.calibrate")
    elif name in _POPULATION:
        mod = importlib.import_module("repro_torch.fleet.population")
    else:
        raise AttributeError(
            f"module 'repro_torch.fleet' has no attribute {name!r}")
    return getattr(mod, name)
