"""Configuration data the port needs (a copy, never an import of repro)."""
