"""The port's single-cell agents, baselines, transfer protocol and
orchestrator (``repro_torch.core``) against the JAX package's
(``repro.core``), on the CPU.

Both packages draw exploration, replay indices and environment noise
from numpy generators with the same seeds, so trajectories are compared
step by step with nothing injected. Q-learning's Q rows must be
bit-equal; the DQN starts from the reference's parameters and optimizer
state carried across with ``repro_torch.convert``, and is held to 1e-5
on loss and parameters.
"""
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import spaces as jspaces
import repro_torch.core as P
from repro_torch import convert
from repro_torch.core import spaces as pspaces

MARGIN = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tests run many small products, and
    several test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _envs(n, exp="EXP-A", **kw):
    return (J.EndEdgeCloudEnv(n, J.EXPERIMENTS[exp], **kw),
            P.EndEdgeCloudEnv(n, P.EXPERIMENTS[exp], device="cpu", **kw))


def _bits(row):
    return np.asarray(row, np.float32).view(np.uint32)


# ---------------------------------------------------------- Q-learning ----
@pytest.mark.parametrize("goal", [0.0, 85.0, 89.0])
@pytest.mark.parametrize("n", [2, 3])
def test_qlearning_training_matches_the_reference(n, goal):
    """``train_agent`` on the same seeds: the same ``converged_at``,
    history and final greedy, and every Q row bit-equal."""
    je, pe = _envs(n, "EXP-B", accuracy_threshold=goal, seed=1)
    ja, pa = J.QLearningAgent(je.spec, seed=2), P.QLearningAgent(pe.spec,
                                                                 seed=2)
    jr, pr = J.train_agent(ja, je, 4000), P.train_agent(pa, pe, 4000)
    assert pr.converged_at == jr.converged_at and pr.steps == jr.steps
    assert pr.history == jr.history
    assert (pr.greedy_action, pr.greedy_ms, pr.greedy_acc, pr.best_ms) == \
        (jr.greedy_action, jr.greedy_ms, jr.greedy_acc, jr.best_ms)
    assert pr.prediction_accuracy == jr.prediction_accuracy
    assert list(pa.q) == list(ja.q)
    for s, row in ja.q.items():
        assert pa.q[s].dtype == np.float32
        np.testing.assert_array_equal(_bits(pa.q[s]), _bits(row))
    assert pa.eps == ja.eps and pa.table_entries == ja.table_entries


def test_qlearning_restricted_sota_agent_matches_the_reference():
    je, pe = _envs(3, "EXP-C", accuracy_threshold=0.0, seed=4)
    ja = J.make_sota_agent(je.spec, algo="q", seed=5)
    pa = P.make_sota_agent(pe.spec, algo="q", seed=5)
    np.testing.assert_array_equal(pa.actions, ja.actions)
    jr, pr = J.train_agent(ja, je, 2000), P.train_agent(pa, pe, 2000)
    assert pr.history == jr.history and pr.converged_at == jr.converged_at
    for s, row in ja.q.items():
        np.testing.assert_array_equal(_bits(pa.q[s]), _bits(row))


# ----------------------------------------------------------------- DQN ----
def _tree_np(tree):
    return [{k: np.asarray(v) for k, v in p.items()} for p in tree]


def _carry(ja, pa):
    """The reference agent's params and AdamW state into the port's."""
    pa.params = convert.mlp_params(_tree_np(ja.params), device="cpu")
    pa.opt = convert.opt_state({"m": _tree_np(ja.opt["m"]),
                                "v": _tree_np(ja.opt["v"]),
                                "step": ja.opt["step"]}, device="cpu")


def _agents(n, form, goal=None, actions=None, seed=3, **cfg):
    spec = jspaces.SpaceSpec(n)
    ja = J.DQNAgent(spec, J.DQNConfig(form=form, **cfg), actions=actions,
                    seed=seed, accuracy_threshold=goal)
    pa = P.DQNAgent(pspaces.SpaceSpec(n), P.DQNConfig(form=form, **cfg),
                    actions=actions, seed=seed, accuracy_threshold=goal,
                    device="cpu")
    _carry(ja, pa)
    return ja, pa


def _max_param_diff(ja, pa):
    return max(float(np.abs(np.asarray(p[k]) - q[k].detach().numpy()).max())
               for p, q in zip(ja.params, pa.params) for k in ("w", "b"))


@pytest.mark.parametrize("form,n", [("paper", 3), ("factored", 3),
                                    ("factored", 5)])
def test_dqn_update_matches_the_reference(form, n):
    """The same transitions pushed into both agents: both buffers sample
    the same batch (the same seed), and the first update's loss and the
    parameters after it agree within 1e-5."""
    ja, pa = _agents(n, form)
    assert vars(pa.cfg) == vars(ja.cfg)
    je, _ = _envs(n, seed=0)
    rng = np.random.default_rng(5)
    s = je.reset()
    for i in range(ja.cfg.batch_size):
        a = int(rng.integers(je.spec.n_joint_actions))
        s2, r, _ = je.step(a)
        jl, pl = ja.update(s, a, r, s2), pa.update(s, a, r, s2)
        s = s2
        assert (jl is None) == (pl is None) == (i < ja.cfg.batch_size - 1)
    assert abs(pl - jl) <= 1e-5, (pl, jl)
    assert _max_param_diff(ja, pa) <= 1e-5
    assert pa.opt["step"] == int(ja.opt["step"]) == 1


def _states(n, count, seed):
    je = J.EndEdgeCloudEnv(n, J.EXPERIMENTS["EXP-B"], seed=seed,
                           exogenous=True)
    rng = np.random.default_rng(seed)
    return [je.step(int(rng.integers(je.spec.n_joint_actions)))[0]
            for _ in range(count)]


@pytest.mark.parametrize("form,n,goal,restricted", [
    ("paper", 3, None, False), ("factored", 3, None, False),
    ("factored", 4, 85.0, False), ("factored", 5, 85.0, True),
    ("factored", 5, 89.0, False)])
def test_dqn_greedy_matches_the_reference(form, n, goal, restricted):
    """``greedy_action`` on 200 states, on the reference's parameters:
    equal wherever the greedy margin exceeds 1e-4, and on all but a few
    states at most."""
    acts = jspaces.restricted_actions(jspaces.SpaceSpec(n)) if restricted \
        else None
    ja, pa = _agents(n, form, goal, acts)
    held = unheld = 0
    for st in _states(n, 200, seed=n):
        q = pa._host_q(st)
        if form == "paper" or goal is None:
            top = np.sort(q.reshape(-1, q.shape[-1]), -1)[:, -2:]
            margin = float((top[:, 1] - top[:, 0]).min())
        else:
            margin = np.inf       # the combo search: compared everywhere
        got, want = pa.greedy_action(st), ja.greedy_action(st)
        if margin > MARGIN:
            assert got == want, (st, got, want, margin)
            held += 1
        else:
            unheld += 1
    assert held >= 190, (held, unheld)


@pytest.mark.parametrize("restricted", [False, True])
@pytest.mark.parametrize("goal", [None, 85.0])
def test_dqn_greedy_ties_fall_as_numpy_orders_them(goal, restricted):
    """q rows with exact ties: each user's values are the last layer's
    bias ``[1, 3, 3, 0, 3, 0, 0, 0, 0, 0]`` (its weights zero), masked to
    -1e30 outside the SOTA [36] set when ``restricted``. The
    constraint-aware top-4 takes ``np.argsort``'s order of the ties (the
    3s at 1, 2, 4 come out ``[2, 4, 1]``), on both sides."""
    n = 3
    acts = jspaces.restricted_actions(jspaces.SpaceSpec(n)) if restricted \
        else None
    ja, pa = _agents(n, "factored", goal, acts)
    row = np.array([1, 3, 3, 0, 3, 0, 0, 0, 0, 0], np.float32)
    last = ja.params[-1]
    ja.params[-1] = {"w": last["w"] * 0, "b": last["b"] * 0 + np.tile(row, n)}
    _carry(ja, pa)
    q = pa._host_q(_states(n, 1, seed=0)[0])
    want_q = np.where(pa._allowed, np.tile(row, (n, 1)), np.float32(-1e30))
    np.testing.assert_array_equal(q, want_q)
    if not restricted:
        assert list(np.argsort(q, axis=-1)[0, ::-1][:4]) == [2, 4, 1, 0]
    for st in _states(n, 20, seed=1):
        assert pa.greedy_action(st) == ja.greedy_action(st)


@pytest.mark.parametrize("form", ["paper", "factored"])
def test_dqn_300_step_run_matches_the_reference(form):
    """300 steps of act/update from eps 0.2 (so that most steps are
    greedy), both agents fed the reference's action and transition: the
    port's own action equals the reference's at every step whose greedy
    margin (on the port's q) exceeds 1e-4; the first step that is not
    held is reported."""
    n = 3
    ja, pa = _agents(n, form, seed=9, eps_start=0.2)
    je, _ = _envs(n, "EXP-C", accuracy_threshold=85.0, seed=2)
    s = je.reset()
    first_unheld, held, losses = None, 0, []
    for step in range(300):
        q = pa._host_q(s)
        top = np.sort(q.reshape(-1, q.shape[-1]), -1)[:, -2:]
        margin = float((top[:, 1] - top[:, 0]).min())
        a, pa_a = ja.act(s), pa.act(s)
        if margin > MARGIN:
            assert pa_a == a, (step, pa_a, a, margin)
            held += 1
        elif first_unheld is None:
            first_unheld = step
        s2, r, _ = je.step(a)
        jl, pl = ja.update(s, a, r, s2), pa.update(s, a, r, s2)
        if jl is not None:
            losses.append((jl, pl))
        s = s2
    print(f"{form}: {held} of 300 steps held; first step not held: "
          f"{first_unheld}")
    assert held >= 250
    assert len(losses) == 300 - ja.cfg.batch_size + 1
    np.testing.assert_allclose([p for _, p in losses],
                               [j for j, _ in losses], rtol=1e-3, atol=1e-5)
    assert _max_param_diff(ja, pa) <= 1e-4
    assert pa.eps == ja.eps


def test_dqn_init_draws_and_warm_start():
    """The port draws its own initial weights (site "init" of ``Draws``):
    seeded, the paper's hidden width, He-scaled; ``warm_start_from``
    copies the source's weights and resets the optimizer."""
    a = P.DQNAgent(pspaces.SpaceSpec(3), seed=1, device="cpu")
    b = P.DQNAgent(pspaces.SpaceSpec(3), seed=1, device="cpu")
    assert [tuple(p["w"].shape) for p in a.params] == [(45, 48), (48, 48),
                                                       (48, 1)]
    for p, q in zip(a.params, b.params):
        assert torch.equal(p["w"], q["w"]) and p["w"].requires_grad
    c = P.DQNAgent(pspaces.SpaceSpec(3), seed=2, device="cpu")
    c.opt["step"] = 7
    c.warm_start_from(a)
    for p, q in zip(a.params, c.params):
        assert torch.equal(p["w"], q["w"]) and p["w"] is not q["w"]
        assert q["w"].requires_grad
    assert c.opt["step"] == 0
    if not torch.cuda.is_available():       # the default device is cuda
        with pytest.raises(RuntimeError, match="CUDA"):
            P.DQNAgent(pspaces.SpaceSpec(3))


@pytest.mark.parametrize("restricted", [False, True])
def test_make_factored_q_matches_the_reference(restricted):
    """The factored head on the reference's parameters, its mask given as
    numpy or as a tensor: values within 1e-5, masked entries -1e30."""
    from repro.core.networks import make_factored_q as jmake
    from repro_torch.core.networks import make_factored_q as pmake
    n = 4
    acts = jspaces.restricted_actions(jspaces.SpaceSpec(n)) if restricted \
        else None
    ja, _ = _agents(n, "factored", actions=acts)
    params = convert.mlp_params(_tree_np(ja.params), device="cpu")
    s = np.random.default_rng(0).random((8, ja.spec.state_dim),
                                        dtype=np.float32)
    want = np.asarray(jmake(n, ja._allowed)(ja.params, s))
    for allowed in (ja._allowed, torch.tensor(ja._allowed)):
        got = pmake(n, allowed)(params, torch.tensor(s)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert np.array_equal(got == np.float32(-1e30),
                              ~np.broadcast_to(ja._allowed, got.shape))


# ---------------------------------------------- baselines and transfer ----
@pytest.mark.parametrize("exp", sorted(J.EXPERIMENTS))
def test_fixed_strategies_match_the_reference(exp):
    for n in (1, 3, 5):
        je, pe = _envs(n, exp, noise=0)
        for strategy in ("device", "edge", "cloud"):
            assert P.fixed_strategy_action(pe.spec, strategy) == \
                J.fixed_strategy_action(je.spec, strategy)
            np.testing.assert_allclose(
                P.fixed_strategy_response(pe, strategy),
                J.fixed_strategy_response(je, strategy), rtol=1e-12)


def test_sota_dqn_agent_action_set():
    for n in (2, 4):
        ja = J.make_sota_agent(jspaces.SpaceSpec(n), algo="dqn")
        pa = P.make_sota_agent(pspaces.SpaceSpec(n), algo="dqn",
                               device="cpu")
        np.testing.assert_array_equal(pa.actions, ja.actions)
        assert pa.cfg.form == "factored" and len(pa.actions) == 3 ** n
        np.testing.assert_array_equal(pa._allowed, ja._allowed)


def test_transfer_experiment_matches_the_reference():
    """Q-learning at N=3: Min -> 85%; the same ``converged_at`` for the
    scratch and the transferred agent."""
    def run(core, dev):
        def make_env(th):
            kw = {} if dev is None else {"device": dev}
            return core.EndEdgeCloudEnv(3, core.EXPERIMENTS["EXP-A"],
                                        accuracy_threshold=th, seed=3, **kw)
        return core.transfer_experiment(
            lambda: core.QLearningAgent(core.SpaceSpec(3), seed=4),
            make_env, 0.0, 85.0, 4000)
    (js, jt), (ps, pt) = run(J, None), run(P, "cpu")
    assert (ps.converged_at, pt.converged_at) == (js.converged_at,
                                                  jt.converged_at)
    assert ps.history == js.history and pt.history == jt.history


# --------------------------------------------------------- orchestrator ----
class StubEngine:
    def __init__(self, name):
        self.name, self.calls = name, []

    def generate(self, tokens, max_new_tokens=16):
        self.calls.append((tokens.shape, max_new_tokens))
        return np.zeros((tokens.shape[0], max_new_tokens), np.int32), 0.005


def test_orchestrator_decide_and_dispatch_match_the_reference():
    je, pe = _envs(3, "EXP-A", accuracy_threshold=85.0, seed=0)
    ja, pa = J.QLearningAgent(je.spec, seed=0), P.QLearningAgent(pe.spec,
                                                                 seed=0)
    J.train_agent(ja, je, 1000)
    P.train_agent(pa, pe, 1000)
    engines = {t: {f"d{i}": StubEngine(f"{t}/d{i}") for i in range(8)}
               for t in ("S", "E", "C")}
    jo = J.IntelligentOrchestrator(ja, je, engines)
    po = P.IntelligentOrchestrator(pa, pe, engines)
    for st in list(ja.q)[:50]:
        assert po.decide(st) == jo.decide(st)
    prompts = [np.arange(16, dtype=np.int32) + u for u in range(3)]
    for per_user in ((0, 8, 9), (5, 6, 7), (9, 9, 1)):
        got, want = po.dispatch(per_user, prompts), \
            jo.dispatch(per_user, prompts)
        assert got == want
        assert [g[:2] for g in got] == [
            ("d0" if a >= 8 else f"d{a}", {8: "E", 9: "C"}.get(a, "S"))
            for a in per_user]
    assert engines["S"]["d5"].calls == [((1, 16), 4)] * 2


def test_dispatch_names_a_missing_engine():
    pe = P.EndEdgeCloudEnv(2, device="cpu")
    po = P.IntelligentOrchestrator(P.QLearningAgent(pe.spec), pe,
                                   {"S": {"d0": StubEngine("S/d0")}})
    prompts = [np.zeros(16, np.int32)] * 2
    assert len(po.dispatch((0, 0), prompts)) == 2
    with pytest.raises(KeyError, match="tier 'S', variant 'd5'"):
        po.dispatch((0, 5), prompts)
    with pytest.raises(KeyError, match="tier 'C', variant 'd0'"):
        po.dispatch((9, 0), prompts)
