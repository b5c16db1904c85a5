"""The optimizer and training step of the RL agents and the language
models."""
from repro_torch.training.optimizer import (AdamWConfig, apply_updates,
                                            init_opt_state)
from repro_torch.training.train_step import init_state, make_train_step
