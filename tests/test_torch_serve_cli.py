"""The port's serving launcher (``python -m repro_torch.launch.serve``) on
the CPU: it trains the orchestration agent, serves every wave's decision
through the edge ladder's engines, and its decisions equal those of the
reference's agent trained and stepped the same way.

The reference's own command line cannot be run to its end for the
comparison: it builds engines for d0/d4/d7 only, and its agent decides
local d5/d6 at its defaults, so its ``dispatch`` raises ``KeyError``.
The test therefore replays the reference's loop without engines
(``decide`` then ``env.step``) and compares decisions.
"""
import re

import pytest
import torch

import repro.core as J
from repro_torch.core import QLearningAgent, SpaceSpec, restricted_actions
from repro_torch.launch import serve

ARGS = ["--device", "cpu", "--requests", "2", "--train-steps", "2000"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tests run many small products, and
    several test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_decisions(users=3, threshold=85.0, train_steps=2000,
                         requests=2):
    env = J.EndEdgeCloudEnv(users, J.EXPERIMENTS["EXP-A"],
                            accuracy_threshold=threshold, seed=0)
    agent = J.QLearningAgent(env.spec, seed=0)
    res = J.train_agent(agent, env, train_steps)
    orch = J.IntelligentOrchestrator(agent, env)
    state = env.reset()
    out = []
    for _ in range(requests):
        per_user = orch.decide(state)
        state, _, info = env.step(env.spec.encode_action(per_user))
        out.append((per_user, info["avg_response_ms"]))
    return res, out


def test_serve_main_matches_the_reference_decisions(capsys):
    res, waves = serve.main(ARGS)
    lines = capsys.readouterr().out.splitlines()
    wave_lines = [ln for ln in lines if ln.startswith("wave ")]
    assert len(wave_lines) == 2 and len(waves) == 2
    jres, want = _reference_decisions()
    assert (res.converged_at, res.greedy_action, res.best_ms) == \
        (jres.converged_at, jres.greedy_action, jres.best_ms)
    for ln, w, (per_user, avg) in zip(wave_lines, waves, want):
        assert w["decision"] == per_user
        assert f"decision={per_user}" in ln
        assert w["env_avg_ms"] == avg
        assert len(w["measured_ms"]) == 3 and all(
            m > 0 for m in w["measured_ms"])
        assert re.search(r"measured=\['\d+ms', '\d+ms', '\d+ms'\]", ln)


def test_serve_builds_every_variant_the_agent_can_decide():
    """The full action set reaches d0-d7 on the device tier; the SOTA
    [36] set only d0. (The reference builds d0/d4/d7 whatever the
    agent.)"""
    spec = SpaceSpec(3)
    assert serve.local_variants(QLearningAgent(spec)) == tuple(
        f"d{i}" for i in range(8))
    assert serve.local_variants(QLearningAgent(
        spec, actions=restricted_actions(spec))) == ("d0",)


def test_serve_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--requests", "1", "--train-steps", "10"])


def test_reference_cli_decides_a_variant_it_has_no_engine_for():
    """The reference fault the port's launcher repairs: at its defaults
    (EXP-A, 3 users, goal 85, 6,000 steps) the trained agent decides
    (5, 5, 6) on every wave, and ``repro.launch.serve.build_engines``
    builds only d0/d4/d7."""
    import inspect
    from repro.launch import serve as jserve
    _, want = _reference_decisions(train_steps=6000, requests=4)
    assert [p for p, _ in want] == [(5, 5, 6)] * 4
    built = inspect.signature(jserve.build_engines).parameters[
        "variants"].default
    assert built == ("d0", "d4", "d7")
    assert {f"d{a}" for p, _ in want for a in p} - set(built) == {"d5", "d6"}
