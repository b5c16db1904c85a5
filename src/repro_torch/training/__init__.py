"""The RL agents' optimizer."""
