"""Action encoding, the shared MLP and the replay ring arithmetic."""
