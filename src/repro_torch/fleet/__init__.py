"""The fleet layer of the port: calibrated dynamics, topologies, scenario
sources, both fleet agents, the brute-force and coupled best-response
oracles, the orchestrator's routing front door and the sim-to-real
calibration loop.

``__all__`` holds the names of ``repro.fleet.__all__`` but those that
need a device mesh (the ``repro.fleet.shard`` seams, ``place_metrics``,
``topology.shard_blocks`` and ``is_shard_local``), which wait for the
port's fleet sharding. Every name loads lazily (module ``__getattr__``),
as the reference's do, so importing the package runs none of its
modules.
"""
_DYNAMICS = ("Calibration", "accuracies", "calibrated_response_times",
             "cell_response_times", "expected_response", "feasible",
             "fleet_actions_expected_response", "fleet_expected_response",
             "response_components", "response_times", "reward",
             "t_comp_device", "user_tier")
_SCENARIOS = ("FleetConfig", "FleetScenario", "arrivals_from_timestamps",
              "diurnal_rate", "heterogeneous_sizes", "init_fleet",
              "init_links", "make_topology", "mixed_table5_fleet",
              "poisson_active", "step_churn", "step_fleet", "step_links",
              "table5_fleet", "with_topology")
_POPULATION = ("FleetQConfig", "FleetQLearning", "FleetTrainResult",
               "check_pad_width", "default_actions", "fleet_bruteforce",
               "fleet_metrics", "make_fleet_env_step",
               "nominal_expected_response", "resolve_source",
               "simulate_responses", "topology_bruteforce",
               "train_against_oracle")
_API = ("FleetOrchestrator", "FleetPolicy", "FleetTrace", "OraclePolicy",
        "RouteResult", "ScenarioSource", "ServedRequest", "StatelessPolicy",
        "StaticPolicy", "SyntheticSource", "TraceSource", "load_trace",
        "make_env_step", "record_trace", "save_trace")
_TOPOLOGY = ("Topology", "cloud_load_multiplier", "edge_capacities",
             "edge_utilization", "fleet_topology_expected_response",
             "hot_edge_topology", "identity_topology", "random_topology",
             "shared_contention", "skewed_topology", "step_edge_failures",
             "topology_expected_response", "topology_response_times")
_REPLAY = ("FleetReplay", "replay_init", "replay_push", "replay_sample",
           "replay_size")
_POLICY = ("FleetDQN", "FleetDQNConfig", "HoldoutEval",
           "encode_fleet_state", "holdout_reward_ratio")
_CALIBRATE = ("CalibratedDynamics", "CalibrationFit", "apply_calibration",
              "calibrate_serving", "calibration_report", "fit_calibration")

__all__ = ["dynamics", *_DYNAMICS, *_SCENARIOS, *_POPULATION, *_API,
           *_REPLAY, *_POLICY, *_TOPOLOGY, *_CALIBRATE]

_MODULES = {"dynamics": _DYNAMICS, "scenarios": _SCENARIOS,
            "population": _POPULATION, "api": _API, "topology": _TOPOLOGY,
            "replay": _REPLAY, "policy": _POLICY, "calibrate": _CALIBRATE}


def __getattr__(name):
    import importlib
    for mod, names in _MODULES.items():
        if name == mod or name in names:
            m = importlib.import_module(f"repro_torch.fleet.{mod}")
            return m if name == mod else getattr(m, name)
    raise AttributeError(
        f"module 'repro_torch.fleet' has no attribute {name!r}")
