"""Two scenario faults of the port, held against the JAX package on the
CPU: the arrival probability (``scenarios.diurnal_rate`` and
``poisson_active``) and the skewed cell-to-edge assignment
(``topology.skewed_topology``). The reference's own uniform draws are
injected into the port through the ``repro_torch.rng.Draws`` seam.

Both functions now compute in float32, as the reference does. The masks
and edges are compared bit for bit. One thing is not the port's to match:
XLA's float32 ``exp`` and ``sin`` on the CPU round differently from
PyTorch's in the last bit, which over the sweep below moves ``p = 1 -
exp(-rate)`` by up to 4 ulp at some steps. A draw within 4 ulp of ``p``
is therefore not held; the sweep holds the reference's own draws and
the draws 5 ulp below and 4 ulp above ``p``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fleet import api as japi
from repro.fleet import scenarios as jscen
from repro.fleet import topology as jtopo
from repro_torch.fleet import api, scenarios, topology
from repro_torch.rng import Draws

RATES = (0.3, 0.8, 1.2, 2.0)
PERIODS = (0, 96, 1440)
#: ulp of p by which XLA's float32 exp/sin and PyTorch's may differ
LIBM_ULP = 4


class Injected(Draws):
    """Draws that hand out given arrays site by site, in order."""

    def __init__(self, **sites):
        super().__init__(0, "cpu")
        self.sites = {k: list(v) for k, v in sites.items()}

    def uniform(self, site, shape):
        arr = np.asarray(self.sites[site].pop(0), np.float32)
        assert arr.shape == tuple(shape), (site, arr.shape, shape)
        return torch.tensor(arr)


def _ref_p(rate, period, t):
    """The reference's arrival probability at steps ``t`` (an int32
    array), by its own functions: ``poisson_active``'s expression on
    ``_arrivals``'s rate."""
    if period:
        rate = rate * jscen.diurnal_rate(jnp.asarray(t, jnp.int32), period,
                                         amplitude=0.4)
    return np.asarray(1.0 - jnp.exp(-jnp.asarray(rate)), np.float32)


def _ulps(p, k):
    """``p`` moved by ``k`` float32 ulp (p > 0)."""
    return (np.asarray(p, np.float32).view(np.int32) + np.int32(k)) \
        .view(np.float32)


# ------------------------------------------------------------ arrivals ----
def test_arrival_probability_smallest_diverging_case():
    """Rate 0.3, no diurnal curve, one user, ``u = 0.25918177``: the
    reference's float32 ``p`` is 0.2591818 and the user is active. In
    double precision ``p`` rounds to 0.25918177 and the user was not."""
    u = np.float32(0.25918177)
    p_ref = _ref_p(0.3, 0, 0)[()]
    assert p_ref == np.float32(0.2591818) and u < p_ref
    got = scenarios.poisson_active(Injected(**{"scenario.arrivals": [[u]]}),
                                   (1,), 0.3)
    assert got.dtype == torch.bool and bool(got[0])


@pytest.mark.parametrize("period", PERIODS)
@pytest.mark.parametrize("rate", RATES)
def test_arrival_masks_over_the_sweep(rate, period):
    """Every step of one diurnal period (one step without a curve): the
    port's ``_arrivals`` against the reference's under the reference's
    own draws (64 x 5 a step), bit for bit; and ``p`` within
    ``LIBM_ULP``: a draw ``LIBM_ULP + 1`` ulp below the reference's ``p``
    is active and one ``LIBM_ULP`` ulp above it is not."""
    cfg = scenarios.FleetConfig(cells=64, users=5, arrival_rate=rate,
                                diurnal_period=period)
    jcfg = jscen.FleetConfig(cells=64, users=5, arrival_rate=rate,
                             diurnal_period=period)
    steps = np.arange(period or 1, dtype=np.int32)
    keys = jax.random.split(jax.random.PRNGKey(period + int(rate * 10)),
                            len(steps))
    shape = (64, 5)
    ref_u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(
        keys))
    want = np.asarray(jax.vmap(lambda k, t: jscen._arrivals(
        k, jcfg, shape, t))(keys, jnp.asarray(steps)))
    p_ref = _ref_p(rate, period, steps)
    for t in steps.tolist():
        got = scenarios._arrivals(Injected(**{"scenario.arrivals":
                                              [ref_u[t]]}), cfg, shape, t)
        np.testing.assert_array_equal(got.numpy(), want[t],
                                      err_msg=f"rate {rate} t {t}")
        edge = _ulps(np.broadcast_to(p_ref, steps.shape)[t],
                     np.array([-LIBM_ULP - 1, LIBM_ULP]))
        got = scenarios._arrivals(Injected(**{"scenario.arrivals": [edge]}),
                                  cfg, (2,), t)
        assert got.tolist() == [True, False], (rate, t)


def test_synthetic_source_active_masks_match_the_reference():
    """``SyntheticSource`` reset and 40 steps at rate 1.2 on a 1,440-step
    day (the sweep's first diverging point was t = 5): the active masks
    bit for bit under the reference's draws of every step."""
    kw = dict(cells=128, users=5, arrival_rate=1.2, diurnal_period=1440)
    jsrc = japi.SyntheticSource(jscen.FleetConfig(**kw))
    src = api.SyntheticSource(scenarios.FleetConfig(**kw))
    key = jax.random.PRNGKey(3)
    key, k = jax.random.split(key)
    k_end, k_edge, _, k_arr = jax.random.split(k, 4)
    js, _ = jsrc.reset(k)
    uni = jax.random.uniform
    ps, _ = src.reset(Injected(**{
        "scenario.links": [uni(k_end, (128, 5)), uni(k_edge, (128,))],
        "scenario.arrivals": [uni(k_arr, (128, 5))]}))
    for step in range(41):
        np.testing.assert_array_equal(ps.active.numpy(),
                                      np.asarray(js.active),
                                      err_msg=f"t {step}")
        assert ps.t == int(js.t)
        key, k = jax.random.split(key)
        k_arr = jax.random.split(k, 4)[3]
        js, _ = jsrc.step(k, js)
        ps, _ = src.step(Injected(**{"scenario.arrivals":
                                     [uni(k_arr, (128, 5))]}), ps)


def test_diurnal_rate_is_float32():
    p = scenarios.diurnal_rate(5, 1440)
    assert p.dtype == torch.float32 and p.dim() == 0
    np.testing.assert_array_equal(
        p.numpy(), np.asarray(jscen.diurnal_rate(jnp.int32(5), 1440)))


# ------------------------------------------------------------ topology ----
def test_skewed_topology_smallest_diverging_case():
    """One cell, 4 edges, skew 1.5, ``u = 0.1``: ``jax.random.choice``
    takes the first edge whose cumulative weight reaches ``cdf[-1] * (1 -
    u)``, edge 2; a right-side search at ``u`` gave edge 0."""
    w = (1.0 / jnp.arange(1, 5, dtype=jnp.float32)) ** 1.5
    cdf = jnp.cumsum(w / w.sum())
    want = int(jnp.searchsorted(cdf, cdf[-1] * (1 - jnp.float32(0.1))))
    assert want == 2
    topo = topology.skewed_topology(
        Injected(**{"scenario.topology": [[0.1]]}), 1, 4)
    assert topo.cell_edge.tolist() == [want]


@pytest.mark.parametrize("cells,n_edges,skew,seed", [
    (8, 4, 1.5, 0), (1024, 16, 1.5, 0), (1024, 64, 1.0, 1),
    (1024, 8, 2.0, 2)])
def test_skewed_topology_matches_choice_under_its_uniforms(cells, n_edges,
                                                           skew, seed):
    """``cell_edge`` bit for bit against the reference, with the uniforms
    ``jax.random.choice`` draws from the same key injected."""
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jtopo.skewed_topology(key, cells, n_edges,
                                            skew=skew).cell_edge)
    u = np.asarray(jax.random.uniform(key, (cells,)))
    topo = topology.skewed_topology(Injected(**{"scenario.topology": [u]}),
                                    cells, n_edges, skew=skew)
    assert topo.cell_edge.dtype == torch.int32
    np.testing.assert_array_equal(topo.cell_edge.numpy(), want)
    if (cells, seed) == (8, 0):
        assert want.tolist() == [0, 0, 1, 0, 0, 2, 1, 0]


def test_init_fleet_skewed_cell_edge_matches_the_reference():
    """``init_fleet`` with a skewed 16-edge topology: the reference's
    topology key (the fifth of its split) drives the port's draw."""
    kw = dict(cells=512, users=3, n_edges=16, assignment="skewed",
              skew=1.5)
    key = jax.random.PRNGKey(9)
    js = jscen.init_fleet(key, jscen.FleetConfig(**kw))
    k_end, k_edge, _, _, k_topo = jax.random.split(key, 5)
    ps = scenarios.init_fleet(Injected(**{
        "scenario.topology": [jax.random.uniform(k_topo, (512,))],
        "scenario.links": [jax.random.uniform(k_end, (512, 3)),
                           jax.random.uniform(k_edge, (512,))]}),
        scenarios.FleetConfig(**kw))
    np.testing.assert_array_equal(ps.topo.cell_edge.numpy(),
                                  np.asarray(js.topo.cell_edge))
    np.testing.assert_array_equal(ps.end_b.numpy(), np.asarray(js.end_b))
