"""Launchers of the port (serving engines)."""
