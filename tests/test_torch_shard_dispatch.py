"""``FleetOrchestrator.route(dispatch=)`` on a sharded fleet, on the CPU.

Two gloo ranks (spawned once for the module, ``tests/torch_mesh_ranks.py``)
each route the same 64-cell 3-user fleet to CPU edge-ladder engines, once
unsharded and once over the fleet mesh, synchronously and through the
serving bridge. The first rank alone dispatches the sharded route and
every rank returns its outcome, so on every rank the served requests
(cell, user, action, tier, variant and generated tokens), the batches,
the per-(tier, variant) counts and the decisions equal the unsharded
route's, and the ``RouteResult`` identities hold exactly (the wall's
decomposition, whose residual is a subtraction, to the float's last
bits), nothing shed by the bridge.
"""
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks

WORLD = 2
JOIN_S = 240
MODES = ("sync", "bridge")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return ranks.spawn(ranks.run_route_rank, WORLD, (),
                           str(tmp_path_factory.mktemp("route")), JOIN_S)
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("mode", MODES)
def test_sharded_route_serves_what_the_unsharded_one_does(runs, mode, rank):
    got = runs[rank][mode]
    plain, sharded = got["plain"], got["sharded"]
    assert len(plain["served"]) > 0
    assert sharded["served"] == plain["served"]
    assert all(s[5] is not None and len(s[5]) == ranks.ROUTE_KW[
        "max_new_tokens"] for s in sharded["served"])
    assert sharded["batches"] == plain["batches"]
    assert sharded["per_tv"] == plain["per_tv"]
    np.testing.assert_array_equal(sharded["decisions"], plain["decisions"])
    assert sharded["predicted"] == plain["predicted"]
    # the decisions reach more than one tier, so both drains are walked
    assert len({s[3] for s in plain["served"]}) > 1


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("mode", MODES)
def test_sharded_route_keeps_its_identities_exactly(runs, mode, rank):
    for side in ("plain", "sharded"):
        ids = runs[rank][mode][side]["ids"]
        assert all(ids.values()), (side, ids)
    assert ("bridge" in runs[rank][mode]["sharded"]["ids"]) == \
        (mode == "bridge")


@pytest.mark.parametrize("mode", MODES)
def test_every_rank_returns_the_first_ranks_outcome(runs, mode):
    first = runs[0][mode]["sharded"]
    for r in range(1, WORLD):
        other = runs[r][mode]["sharded"]
        assert other["served"] == first["served"]
        assert other["batches"] == first["batches"]
        assert other["lat_count"] == first["lat_count"] == \
            len(first["served"])
