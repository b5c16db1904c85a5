"""On-device experience replay for fleet-scale training — the port of
``repro/fleet/replay.py``.

``FleetReplay`` keeps state/action/reward/next-state rows on the device
and the ring position on the host (``ptr``, ``full``), so neither push
nor sample waits for the device. Push writes a whole batch at the ring
position in place; sample draws uniform row indices at site
``"replay"``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.replay import ring_slots


@dataclasses.dataclass
class FleetReplay:
    """Ring buffer of transitions.

    s    : (capacity, state_dim) f32   states
    a    : (capacity, *action_shape) i32 actions (per-user ids for fleet)
    r    : (capacity,) f32             rewards
    s2   : (capacity, state_dim) f32   next states
    ptr  : int                         next write position
    full : bool                        True once the ring has wrapped
    """
    s: torch.Tensor
    a: torch.Tensor
    r: torch.Tensor
    s2: torch.Tensor
    ptr: int = 0
    full: bool = False

    @property
    def capacity(self) -> int:
        return self.s.shape[0]

    def __len__(self):
        return replay_size(self)


def replay_init(capacity: int, state_dim: int, action_shape=(),
                device=None) -> FleetReplay:
    """An empty buffer for ``capacity`` transitions on ``device``."""
    z = dict(device=device)
    return FleetReplay(
        s=torch.zeros((capacity, state_dim), **z),
        a=torch.zeros((capacity, *action_shape), dtype=torch.int32, **z),
        r=torch.zeros((capacity,), **z),
        s2=torch.zeros((capacity, state_dim), **z))


def replay_size(buf: FleetReplay) -> int:
    """Number of valid transitions."""
    return buf.capacity if buf.full else buf.ptr


def replay_push(buf: FleetReplay, s, a, r, s2) -> FleetReplay:
    """Write a ``(B, ...)`` batch of transitions at the ring position, in
    place; pushing more rows than the buffer holds is an error."""
    n = s.shape[0]
    if n > buf.capacity:
        raise ValueError(f"pushing {n} transitions into a capacity-"
                         f"{buf.capacity} FleetReplay would self-overwrite")
    idx = ring_slots(buf.ptr, n, buf.capacity, device=buf.s.device)
    buf.s[idx] = s
    buf.a[idx] = a.to(buf.a.dtype)
    buf.r[idx] = r
    buf.s2[idx] = s2
    buf.full = buf.full or buf.ptr + n >= buf.capacity
    buf.ptr = (buf.ptr + n) % buf.capacity
    return buf


def replay_sample(draws, buf: FleetReplay, batch: int):
    """Uniform mini-batch ``(s, a, r, s2)`` from the filled prefix (an
    empty buffer yields zero rows, as in the reference)."""
    n = max(replay_size(buf), 1)
    idx = draws.randint("replay", (batch,), n)
    return buf.s[idx], buf.a[idx], buf.r[idx], buf.s2[idx]
