"""The port's kernels (``repro_torch.kernels``) against the JAX package's
oracles, on the CPU: the same inputs, made from a seeded numpy
generator, go through ``repro.kernels.ref`` and through the plain
PyTorch version a CPU tensor takes.

Integer outputs (argmax, decisions) must be bit-exact. Float outputs are
allclose: 1e-6 for the tabular update, 1e-5 for the head's values,
whose MLP sums in another order under XLA than under torch. The Pallas
tabular kernel is never the oracle here (it does not run under the
installed JAX); the fused jnp oracle and the naive composition are.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import dqn_head as k_dqn
from repro_torch.kernels import tabular_rl as k_tab

ALPHA, GAMMA = 0.9, 0.1


# ------------------------------------------------ fused tabular RL --------
def _tabular_case(cells, states=9, k=10, seed=0, ties=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((cells, states, k)).astype(np.float32)
    if ties:                       # rounded values force argmax tie-breaks
        q = np.round(q * 2.0) / 2.0
        q[0] = 1.0
    s = rng.integers(0, states, cells).astype(np.int32)
    a = rng.integers(0, k, cells).astype(np.int32)
    s2 = rng.integers(0, states, cells).astype(np.int32)
    # half the fleet lands on s2 == s: the freshly written entry takes
    # part in the next greedy
    s2 = np.where(np.arange(cells) % 2 == 0, s, s2).astype(np.int32)
    r = -rng.random(cells).astype(np.float32)
    return q, s, a, r, s2


def _naive_tabular(q, s, a, r, s2):
    """The reference's unfused composition (gather/max/scatter/argmax)."""
    cells = jnp.arange(q.shape[0])
    td = r + GAMMA * q[cells, s2].max(-1) - q[cells, s, a]
    q_new = q.at[cells, s, a].add(ALPHA * td)
    return q_new, q_new[cells, s2].argmax(-1).astype(jnp.int32), td


def _port_tabular(q, s, a, r, s2):
    t = [torch.tensor(x) for x in (q, s, a, r, s2)]
    q_new, g, td = ops.fused_tabular_update(*t, alpha=ALPHA, gamma=GAMMA)
    return q_new.numpy(), g.numpy(), td.numpy()


@pytest.mark.parametrize("oracle", ["fused_ref", "naive"])
@pytest.mark.parametrize("cells,ties", [(1, False), (13, True),
                                        (37, True), (64, False)])
def test_tabular_plain_matches_jax_oracles(cells, ties, oracle):
    q, s, a, r, s2 = _tabular_case(cells, seed=cells, ties=ties)
    j = [jnp.asarray(x) for x in (q, s, a, r, s2)]
    if oracle == "fused_ref":
        want = jref.fused_tabular_ref(*j, alpha=ALPHA, gamma=GAMMA)
    else:
        want = _naive_tabular(*j)
    want_q, want_g, want_td = (np.asarray(x) for x in want)
    got_q, got_g, got_td = _port_tabular(q, s, a, r, s2)
    np.testing.assert_array_equal(got_g, want_g)
    np.testing.assert_allclose(got_q, want_q, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_td, want_td, rtol=1e-6, atol=1e-6)


def test_tabular_plain_updates_in_place_and_only_the_target():
    q, s, a, r, s2 = _tabular_case(29, seed=4)
    qt = torch.tensor(q)
    q_new, _, _ = ops.fused_tabular_update(
        qt, *[torch.tensor(x) for x in (s, a, r, s2)], alpha=ALPHA,
        gamma=GAMMA)
    assert q_new.data_ptr() == qt.data_ptr()        # the aliased table
    touched = np.zeros(q.shape, bool)
    touched[np.arange(29), s, a] = True
    np.testing.assert_array_equal(q_new.numpy()[~touched], q[~touched])


def test_tabular_tie_break_first_index():
    q, s, a, r, s2 = _tabular_case(13, ties=True)
    q = np.zeros_like(q)            # every row fully tied
    _, want_g, _ = _naive_tabular(*[jnp.asarray(x) for x in (q, s, a, r,
                                                              s2)])
    _, got_g, _ = _port_tabular(q, s, a, r, s2)
    np.testing.assert_array_equal(got_g, np.asarray(want_g))


# ------------------------------------------------- fused DQN head ---------
def _dqn_params(hidden=16, seed=0, n_act=10):
    rng = np.random.default_rng(seed)
    dims = [11, hidden, hidden, n_act]
    return [{"w": (rng.standard_normal((dims[i], dims[i + 1])) * 0.3
                   ).astype(np.float32),
             "b": (rng.standard_normal(dims[i + 1]) * 0.1
                   ).astype(np.float32)} for i in range(3)]


def _dqn_case(cells, users, seed=0):
    from repro.fleet import dynamics
    rng = np.random.default_rng(seed + 100)
    mem = rng.random((cells, users)) < 0.8
    mem[:, 0] = True                     # never an empty cell
    act = mem & (rng.random((cells, users)) < 0.7)
    end_b = rng.random((cells, users)) < 0.5
    agg = rng.standard_normal((cells, 8)).astype(np.float32)
    acc_table = np.asarray(dynamics.accuracies(np.arange(10)), np.float32)
    return (act.astype(np.float32), mem.astype(np.float32),
            end_b.astype(np.float32), agg, acc_table)


def _heads(case, params, allowed, threshold, topk=3):
    act, mem, end_b, agg, acc_table = case
    want_d, want_q = jops.dqn_head(
        *[jnp.asarray(x) for x in (act, mem, end_b, agg)],
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params],
        jnp.asarray(allowed), jnp.asarray(acc_table), threshold=threshold,
        topk=topk, impl="ref")      # the jitted dqn_head_ref
    tparams = [{k: torch.tensor(v) for k, v in p.items()} for p in params]
    got_d, got_q = ops.dqn_head(
        *[torch.tensor(x) for x in (act, mem, end_b, agg)], tparams,
        torch.tensor(allowed > 0.5), torch.tensor(acc_table),
        threshold=threshold, topk=topk)
    return (np.asarray(want_d), np.asarray(want_q), got_d.numpy(),
            got_q.numpy())


@pytest.mark.parametrize("cells,users,threshold", [
    (1, 2, 0.0), (37, 3, 0.0), (1, 2, 85.0), (37, 3, 85.0), (64, 2, 85.0),
    (13, 3, 101.0),           # infeasible goal: every cell falls back
])
def test_dqn_head_plain_matches_jax_oracle(cells, users, threshold):
    case = _dqn_case(cells, users, seed=cells)
    allowed = np.ones((users, 10), np.float32)
    want_d, want_q, got_d, got_q = _heads(case, _dqn_params(seed=users),
                                          allowed, threshold)
    assert got_d.dtype == np.int32
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_allclose(got_q, want_q, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("threshold", [0.0, 85.0])
def test_dqn_head_masked_rows(threshold):
    """One user with fewer allowed actions than topk (exhausted top-k
    rows) and one all-masked user."""
    users = 3
    case = _dqn_case(29, users, seed=7)
    allowed = np.ones((users, 10), np.float32)
    allowed[0, 2:] = 0.0
    allowed[1, :] = 0.0
    want_d, want_q, got_d, got_q = _heads(case, _dqn_params(seed=3),
                                          allowed, threshold)
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_allclose(got_q, want_q, rtol=1e-5, atol=1e-5)


def test_dqn_head_infeasible_falls_back_to_plain_argmax():
    case = _dqn_case(17, 2, seed=5)
    _, _, got_d, got_q = _heads(case, _dqn_params(seed=5),
                                np.ones((2, 10), np.float32), 101.0)
    np.testing.assert_array_equal(
        got_d, ref.first_argmax_ref(torch.tensor(got_q)).numpy())


def test_property_dqn_head_respects_allowed_mask():
    """The head never emits an action outside a member user's allowed
    set, at any threshold (the reference's constraint-leak invariant)."""
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=20, deadline=None)
    @given(st.integers(0, 2**31 - 1), st.integers(1, 17),
           st.integers(2, 3), st.sampled_from([0.0, 85.0]))
    def prop(seed, cells, users, threshold):
        act, mem, end_b, agg, acc_table = _dqn_case(cells, users,
                                                    seed=seed % 10_000)
        rng = np.random.default_rng(seed)
        allowed = rng.random((users, 10)) < 0.6
        allowed[:, 0] = True          # every user keeps >= 1 action
        params = [{k: torch.tensor(v) for k, v in p.items()}
                  for p in _dqn_params(seed=seed % 97)]
        dec, _ = ops.dqn_head(
            *[torch.tensor(x) for x in (act, mem, end_b, agg)], params,
            torch.tensor(allowed), torch.tensor(acc_table),
            threshold=threshold, topk=3)
        member = mem > 0.5
        assert allowed[np.arange(users)[None, :], dec.numpy()][member].all()

    prop()


# ----------------------------------------------------- dispatch seam ------
def test_cpu_tensors_take_the_plain_version_without_launching():
    before = (k_tab.KERNEL.launches, k_dqn.KERNEL.launches)
    _port_tabular(*_tabular_case(5))
    _heads(_dqn_case(5, 2), _dqn_params(), np.ones((2, 10), np.float32),
           85.0)
    assert (k_tab.KERNEL.launches, k_dqn.KERNEL.launches) == before


def test_other_devices_raise_instead_of_falling_back():
    q = torch.zeros((2, 3, 4), device="meta")
    idx = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no fused op path"):
        ops.fused_tabular_update(q, idx, idx, torch.zeros(2, device="meta"),
                                 idx, alpha=ALPHA, gamma=GAMMA)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers refuse what the kernel does not take, before
    any build or launch."""
    q, s, a, r, s2 = [torch.tensor(x) for x in _tabular_case(3)]
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        k_tab.tabular_rl_cuda(q, s, a, r, s2, alpha=ALPHA, gamma=GAMMA)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        k_dqn.dqn_head_cuda(*[torch.zeros(3, 2)] * 3, torch.zeros(3, 8),
                            torch.zeros(11, 4), torch.zeros(4),
                            torch.zeros(4, 4), torch.zeros(4),
                            torch.zeros(4, 10), torch.zeros(10),
                            torch.ones(2, 10), torch.zeros(10),
                            threshold=0.0, topk=3)
