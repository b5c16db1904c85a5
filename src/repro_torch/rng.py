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
