"""On-device experience replay for fleet-scale training — the port of
``repro/fleet/replay.py``.

``FleetReplay`` keeps state/action/reward/next-state rows on the device
and the ring position on the host (``ptr``, ``full``), so neither push
nor sample waits for the device. Push writes a whole batch at the ring
position in place; sample draws uniform row indices at site
``"replay"``. A ring split over a fleet mesh (``fleet.shard.
shard_replay``) holds this rank's cells' rows and assembles each sample
whole on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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
    mesh : FleetMesh | None            the fleet mesh whose ranks each
                                       hold their cells' rows (None: the
                                       whole ring is here)
    push_rows : int                    rows of every push on a mesh
    """
    s: torch.Tensor
    a: torch.Tensor
    r: torch.Tensor
    s2: torch.Tensor
    ptr: int = 0
    full: bool = False
    mesh: Optional[object] = None
    push_rows: int = 0

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
    place; pushing more rows than the buffer holds is an error. On a
    mesh every push is one block of the fleet's cells, the same size
    each time, and the ring's capacity a multiple of the fleet's cells
    (so each push lands in this rank's rows)."""
    n = s.shape[0]
    if n > buf.capacity:
        raise ValueError(f"pushing {n} transitions into a capacity-"
                         f"{buf.capacity} FleetReplay would self-overwrite")
    if buf.mesh is not None:
        if buf.capacity % n or buf.push_rows not in (0, n):
            raise ValueError(
                f"a sharded FleetReplay takes pushes of one fleet's cells "
                f"into a capacity that is a multiple of them: capacity "
                f"{buf.capacity * buf.mesh.size}, push "
                f"{n * buf.mesh.size} (earlier pushes "
                f"{buf.push_rows * buf.mesh.size})")
        buf.push_rows = n
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
    if buf.mesh is not None:
        return _sample_sharded(draws, buf, batch)
    n = max(replay_size(buf), 1)
    idx = draws.randint("replay", (batch,), n)
    return buf.s[idx], buf.a[idx], buf.r[idx], buf.s2[idx]


def _sample_sharded(draws, buf: FleetReplay, batch: int):
    """The unsharded ring's sample from a ring split over a mesh: the
    same global slot indices, each row read by the rank that holds it
    (window ``slot // cells``, cell ``slot % cells``), zeros elsewhere,
    and one all-reduce over the rows' bit patterns."""
    mesh, rows = buf.mesh, max(buf.push_rows, 1)
    cells = rows * mesh.size
    idx = draws.randint("replay", (batch,),
                        max(replay_size(buf) * mesh.size, 1))
    cell = idx % cells
    mine = (cell // rows) == mesh.rank
    local = torch.where(mine, (idx // cells) * rows + cell % rows, 0)
    keep = mine[:, None]
    parts = [torch.where(keep, buf.s[local], 0.0).view(torch.int32),
             torch.where(keep, buf.a[local], 0),
             torch.where(mine, buf.r[local], 0.0)[:, None].view(torch.int32),
             torch.where(keep, buf.s2[local], 0.0).view(torch.int32)]
    out = mesh.sum_bits(torch.cat(parts, 1))
    d, u = buf.s.shape[1], buf.a.shape[1]
    s, a, r, s2 = out.split([d, u, 1, d], 1)
    return (s.contiguous().view(torch.float32), a.contiguous(),
            r.contiguous().view(torch.float32)[:, 0],
            s2.contiguous().view(torch.float32))
