"""FIFO experience replay (paper Algorithm 2, §5.4: capacity 1000,
mini-batch 64) and the ring-buffer slot arithmetic of the fleet replay.

``ReplayBuffer`` is the host-side (numpy) buffer of the single-cell
``DQNAgent``'s Python training loop, a copy of the reference's: its
one-at-a-time ``push`` never wraps mid-write, and ``sample`` draws its
indices from a numpy generator seeded as the reference seeds it, so both
packages sample the same rows. The fleet agent keeps its pooled
experience on the device (``repro_torch.fleet.replay``) and pushes whole
batches through ``ring_slots``.
"""
from __future__ import annotations

import numpy as np
import torch


def ring_slots(ptr: int, n: int, capacity: int, device=None) -> torch.Tensor:
    """The ``n`` ring-buffer slots written by a push starting at ``ptr``
    (wraps modulo ``capacity``)."""
    return (ptr + torch.arange(n, device=device)) % capacity


class ReplayBuffer:
    def __init__(self, capacity: int, state_dim: int, seed: int = 0):
        self.capacity = capacity
        self.s = np.zeros((capacity, state_dim), np.float32)
        self.a = np.zeros((capacity,), np.int64)
        self.r = np.zeros((capacity,), np.float32)
        self.s2 = np.zeros((capacity, state_dim), np.float32)
        self.ptr = 0
        self.full = False
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.capacity if self.full else self.ptr

    def push(self, s, a, r, s2):
        i = self.ptr
        self.s[i], self.a[i], self.r[i], self.s2[i] = s, a, r, s2
        self.ptr = (self.ptr + 1) % self.capacity
        self.full = self.full or self.ptr == 0

    def sample(self, batch: int):
        n = len(self)
        if n == 0:
            raise ValueError(
                "cannot sample from an empty ReplayBuffer: push at least "
                "one transition before calling sample()")
        idx = self.rng.integers(0, n, size=batch)
        return self.s[idx], self.a[idx], self.r[idx], self.s2[idx]
