"""Launchers of the port (serving engines, LM training)."""
