"""The one seam every random draw of the port goes through.

JAX's threefry keys and torch's Philox give different numbers from the
same seed, so the port never tries to reproduce JAX's bits. Instead each
draw names its *site* — ``"explore"``, ``"explore_action"``,
``"noise"``, ``"replay"``, ``"scenario.*"`` — and asks a ``Draws``
object for it. By default that object is backed by one
``torch.Generator`` seeded from ``seed``; a test hands in a subclass
that returns the JAX package's own draws at the same sites.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device


class Draws:
    """``torch.Generator``-backed draws on ``device`` (``cuda`` unless the
    caller asks for another; without CUDA the default raises, as every
    entry point of the port does).

    Every method takes the site name first, so a subclass can route
    each site to recorded values; this class ignores it.
    """

    def __init__(self, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def uniform(self, site: str, shape) -> torch.Tensor:
        """float32 uniform in [0, 1)."""
        return torch.rand(shape, generator=self.gen, device=self.device)

    def normal(self, site: str, shape) -> torch.Tensor:
        """float32 standard normal."""
        return torch.randn(shape, generator=self.gen, device=self.device)

    def randint(self, site: str, shape, high: int, low: int = 0):
        """int64 uniform in [low, high)."""
        return torch.randint(low, high, shape, generator=self.gen,
                             device=self.device)

    def bernoulli(self, site: str, p, shape) -> torch.Tensor:
        """bool, True with probability ``p`` (a float or a tensor that
        broadcasts to ``shape``)."""
        return self.uniform(site, shape) < p


def as_draws(seed_or_draws, device=None) -> Draws:
    """A ``Draws`` as given, or a new one seeded from an int on
    ``device`` (``cuda`` unless the caller asks for another)."""
    if isinstance(seed_or_draws, Draws):
        return seed_or_draws
    return Draws(int(seed_or_draws), device)


#: the sites whose draws are shaped ``(cells, ...)`` once a scenario is
#: built: on a sharded fleet each rank draws the whole fleet's values and
#: keeps its own block (``BlockDraws``)
CELL_SITES = frozenset({"explore", "explore_action", "noise",
                        "scenario.links", "scenario.churn",
                        "scenario.arrivals", "scenario.edge_fail"})


class BlockDraws(Draws):
    """The draws of one rank of a sharded fleet: a draw at a per-cell
    site whose leading dimension is this rank's block of ``block`` cells
    is drawn for all ``block * n_blocks`` cells from ``base`` and cut to
    rows ``[rank * block, (rank + 1) * block)``, so every rank consumes
    ``base`` exactly as the unsharded fleet does and keeps the values
    the unsharded fleet gives its cells. Every other draw passes through
    unchanged."""

    def __init__(self, base: Draws, rank: int, n_blocks: int, block: int):
        self.base = base
        self.device = base.device
        self.gen = base.gen
        self.rank, self.n_blocks, self.block = rank, n_blocks, block

    def _cut(self, site, shape):
        shape = tuple(shape)
        if site in CELL_SITES and shape and shape[0] == self.block:
            return (self.block * self.n_blocks,) + shape[1:], True
        return shape, False

    def _keep(self, x, cut):
        return x[self.rank * self.block:(self.rank + 1) * self.block] \
            if cut else x

    def uniform(self, site: str, shape) -> torch.Tensor:
        shape, cut = self._cut(site, shape)
        return self._keep(self.base.uniform(site, shape), cut)

    def normal(self, site: str, shape) -> torch.Tensor:
        shape, cut = self._cut(site, shape)
        return self._keep(self.base.normal(site, shape), cut)

    def randint(self, site: str, shape, high: int, low: int = 0):
        shape, cut = self._cut(site, shape)
        return self._keep(self.base.randint(site, shape, high, low), cut)
