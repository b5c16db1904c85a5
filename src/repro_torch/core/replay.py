"""Ring-buffer slot arithmetic shared by the fleet replay."""
from __future__ import annotations

import torch


def ring_slots(ptr: int, n: int, capacity: int, device=None) -> torch.Tensor:
    """The ``n`` ring-buffer slots written by a push starting at ``ptr``
    (wraps modulo ``capacity``)."""
    return (ptr + torch.arange(n, device=device)) % capacity
