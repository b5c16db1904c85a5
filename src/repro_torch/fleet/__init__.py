"""The fleet layer of the port: calibrated dynamics, topologies, scenario
sources, both fleet agents and the orchestrator's routing front door."""
