"""``FleetDQN(net='cell')`` — the flat-state trunk through
``make_factored_q`` and the unfused constraint-aware greedy — against the
JAX package's, on the CPU, under the reference's own parameters carried
across by ``convert`` and replay indices injected through ``Draws``.

Decisions and joint ids must be equal; Q values within 1e-5 (float32
matmuls that sum in another order); the loss and one AdamW step within
1e-5 as in ``tests/test_torch_fleet.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.spaces import SpaceSpec as JSpaceSpec
from repro.core.spaces import restricted_actions as jrestricted
from repro.fleet import api as japi
from repro.fleet import policy as jpolicy
from repro.fleet import replay as jreplay
from repro.fleet import scenarios as jscen
from repro_torch import convert
from repro_torch.fleet import policy, replay, scenarios
from repro_torch.rng import Draws

USERS = 3


class Recorded(Draws):
    """Draws that replay recorded values site by site."""

    def __init__(self, **sites):
        super().__init__(0, "cpu")
        self.sites = {k: list(v) for k, v in sites.items()}

    def randint(self, site, shape, high, low=0):
        return torch.tensor(np.asarray(self.sites[site].pop(0)),
                            dtype=torch.int64)


def _carry(js):
    return convert.scenario(np.asarray(js.end_b), np.asarray(js.edge_b),
                            np.asarray(js.member), np.asarray(js.active),
                            np.asarray(js.t), device="cpu")


def _pair(threshold, restricted=False, hidden=32, seed=5):
    """A reference and a port cell-form agent on the same fleet, the
    port's params and optimizer state carried from the reference's."""
    cfg = jscen.FleetConfig(cells=16, users=USERS, arrival_rate=1.0,
                            p_r2w=0.05, p_w2r=0.1, min_users=1,
                            max_users=USERS)
    actions = jrestricted(JSpaceSpec(USERS)) if restricted else None
    kw = dict(replay_capacity=256, batch_size=32, hidden=hidden,
              accuracy_threshold=threshold, net="cell")
    jagent = jpolicy.FleetDQN(japi.SyntheticSource(cfg), actions=actions,
                              cfg=jpolicy.FleetDQNConfig(**kw), seed=seed,
                              metrics=False)
    pagent = policy.FleetDQN(
        _carry(jagent.scen), scenarios.FleetConfig(cells=16, users=USERS),
        actions=actions, cfg=policy.FleetDQNConfig(**kw), device="cpu")
    return jagent, pagent


def _carry_state(jagent, pagent):
    pagent.params = convert.mlp_params(
        jax.tree_util.tree_map(np.asarray, jagent.params), device="cpu")
    pagent.opt = convert.opt_state(
        jax.tree_util.tree_map(np.asarray, jagent.opt), device="cpu")


def _held():
    js = jscen.mixed_table5_fleet(jax.random.PRNGKey(7), 48, USERS,
                                  min_users=1, max_users=USERS)
    return js, _carry(js)


def test_cell_net_params_have_the_references_shapes():
    jagent, pagent = _pair(85.0)
    for p, j in zip(pagent.params, jagent.params):
        for k in ("w", "b"):
            assert tuple(p[k].shape) == np.asarray(j[k]).shape
    assert pagent.params[0]["w"].shape[0] == policy.state_dim(USERS)
    assert pagent.params[-1]["w"].shape[1] == USERS * 10


@pytest.mark.parametrize("threshold,restricted", [
    (0.0, False), (85.0, False), (85.0, True), (89.0, True)])
def test_greedy_decisions_equal_after_three_steps(threshold, restricted):
    """After 3 reference steps, the same params route a held-out fleet to
    the same decisions. Under the restricted candidate set (3 of 10
    actions a user) every top-5 row holds two -1e30-masked ids that tie;
    the reference's ``lax.top_k`` and the port's stable order may order
    them differently, and the invalid cull removes their combos."""
    jagent, pagent = _pair(threshold, restricted)
    jagent.run(3)
    _carry_state(jagent, pagent)
    js, ps = _held()
    np.testing.assert_array_equal(
        pagent.greedy_decisions(scen=ps).numpy(),
        np.asarray(jagent.greedy_decisions(scen=js)))
    counts = np.random.default_rng(1).integers(0, 3, (48, 2)).astype(
        np.int32)
    pdec, pids = pagent.policy_decisions(torch.tensor(counts), ps)
    jdec, jids = jagent.policy_decisions(jnp.asarray(counts), js)
    np.testing.assert_array_equal(pdec.numpy(), np.asarray(jdec))
    np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
    s = policy.encode_fleet_state(torch.tensor(counts), ps)
    with torch.no_grad():
        q = pagent._per_user_q(pagent.params, s)
    jq = jagent._per_user_q(jagent.params, jnp.asarray(s.numpy()))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-5,
                               atol=1e-5)
    if restricted:
        assert (q <= -1e29).sum(-1).eq(7).all()     # 7 masked ids a user


def test_cell_train_step_with_injected_replay_indices_matches_jax():
    jagent, pagent = _pair(85.0)
    _carry_state(jagent, pagent)
    sd = policy.state_dim(USERS)
    rng = np.random.default_rng(3)
    rows = 48
    s = (rng.random((rows, sd)) < 0.5).astype(np.float32)
    s2 = (rng.random((rows, sd)) < 0.5).astype(np.float32)
    a = rng.integers(0, 10, (rows, USERS)).astype(np.int32)
    r = -rng.random(rows).astype(np.float32) * 2
    jbuf = jreplay.replay_push(jagent.buffer, *[jnp.asarray(x)
                                                for x in (s, a, r, s2)])
    key = jax.random.PRNGKey(9)
    idx = jax.random.randint(key, (32,), 0, rows)
    batch_j = jreplay.replay_sample(key, jbuf, 32)
    replay.replay_push(pagent.buffer, *[torch.tensor(x)
                                        for x in (s, a, r, s2)])
    batch_p = replay.replay_sample(Recorded(replay=[idx]), pagent.buffer, 32)
    jp, _, jloss = jax.jit(jagent._make_train_step())(
        jagent.params, jagent.opt, *batch_j)
    ploss = pagent.train_step(*batch_p)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
    for g, w in zip(pagent.params, jp):
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k].detach().numpy(),
                                       np.asarray(w[k]), rtol=1e-5,
                                       atol=1e-5)


def test_cell_dqn_trains_and_scores_on_the_cpu():
    _, pagent = _pair(85.0)
    ms, _ = pagent.run(5)
    assert ms.shape == (5,) and np.isfinite(ms).all()
    assert pagent.opt["step"] == 5
    _, ps = _held()
    ev = policy.holdout_reward_ratio(pagent, ps)
    assert 0.0 < ev.ratio <= 1.05


def test_an_unknown_net_form_raises():
    scen = scenarios.table5_fleet("EXP-A", 4, 3, device="cpu")
    with pytest.raises(ValueError, match="net form"):
        policy.FleetDQN(scen, scenarios.FleetConfig(cells=4, users=3),
                        cfg=policy.FleetDQNConfig(net="tower"),
                        device="cpu")
