"""Population-scale tabular RL: thousands of independent cells per step —
the port of ``repro/fleet/population.py`` on its fused path.

A dense per-cell Q-table of shape ``(cells, states, actions)`` indexed
by ``(n_edge, n_cloud[, packed link bits])`` of the previous step, a
candidate set of joint actions shared by all cells, and one fused op per
step (``kernels.ops.fused_tabular_update``): the TD update of every cell
plus the next step's greedy action, which the loop carries instead of
re-gathering the row. On the card that op is the CUDA kernel
``csrc/tabular_rl.cu``. Both fleet agents record their per-step
telemetry into a ``repro_torch.obs`` accumulator (``fleet_metrics``).

``fleet_bruteforce`` evaluates every candidate action for every cell in
chunks, and ``train_against_oracle`` scores per-cell convergence
against it. Coupled fleets (an attached topology) need the reference's
best-response oracle, which is not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.spaces import (A_CLOUD, A_EDGE, SpaceSpec,
                                     restricted_actions)
from repro_torch.fleet import dynamics, topology
from repro_torch.fleet.scenarios import FleetConfig, FleetScenario
from repro_torch.kernels import ops
from repro_torch.kernels.ref import first_argmax_ref
from repro_torch.obs.metrics import MetricDef, MetricsAccumulator
from repro_torch.obs.report import run_manifest
from repro_torch.rng import Draws


def fleet_metrics(cells: int, kind: str = "tabular", n_windows: int = 0,
                  window_len: int = 1, device=None) -> MetricsAccumulator:
    """The standard telemetry pack of the fleet agents, on ``device``.

    Per-cell signals use ``lanes=cells``. Histogram ranges come from
    the dynamics invariants: rewards live in ``[-MAX_RESPONSE_MS/1000,
    0]`` and response times in ``[0, MAX_RESPONSE_MS]``; out-of-range
    values clip into edge bins without corrupting the exact moments
    (and bump the explicit underflow/overflow counters).

    ``n_windows > 0`` gives every stream a ``(n_windows, lanes)``
    per-window ring (``window_len`` steps per slot), so ``summary()``
    reports the learning curve.
    """
    r_floor = -dynamics.MAX_RESPONSE_MS / 1000.0
    w = dict(n_windows=n_windows, window_len=window_len)
    defs = {
        "reward": MetricDef(lo=r_floor, hi=0.0, lanes=cells, **w),
        "mean_ms": MetricDef(lo=0.0, hi=dynamics.MAX_RESPONSE_MS,
                             lanes=cells, **w),
        "epsilon": MetricDef(lo=0.0, hi=1.0, **w),
    }
    if kind == "tabular":
        defs["td_abs"] = MetricDef(lo=0.0, hi=-r_floor, lanes=cells, **w)
    elif kind == "dqn":
        defs["loss"] = MetricDef(lo=0.0, hi=25.0, **w)
        defs["replay_fill"] = MetricDef(lo=0.0, hi=1.0, **w)
    else:
        raise ValueError(f"unknown metrics kind {kind!r}")
    return MetricsAccumulator.create(defs, device=device)


def check_pad_width(n_users: int, scen: FleetScenario, who: str) -> None:
    """THE pad-width guard of the FleetPolicy protocol, shared by every
    policy: a scenario padded to another user width must raise this
    clear error instead of silently misreading feature blocks."""
    if scen.users != n_users:
        raise ValueError(
            f"{who} routes fleets padded to {n_users} users; got a "
            f"{scen.users}-wide scenario — regenerate it with "
            f"users={n_users} (smaller cells are expressed via the "
            "membership mask, not a narrower pad)")


def resolve_source(scen, fleet_cfg, draws):
    """Normalize an agent's scenario arguments onto the ScenarioSource
    seam: a source resets into its initial scenario; a ``(FleetScenario,
    FleetConfig)`` pair wraps into a ``SyntheticSource`` pinned to that
    scenario. Returns ``(scen0, source)``."""
    from repro_torch.fleet.api import (SyntheticSource, is_source,
                                       require_scenario_state)
    if is_source(scen):
        require_scenario_state(scen)
        scen0, _ = scen.reset(draws)
        return scen0, scen
    if fleet_cfg is None:
        raise TypeError(
            "pass a ScenarioSource (repro_torch.fleet.api), or a "
            "FleetScenario together with its FleetConfig")
    return scen, SyntheticSource(fleet_cfg, scen=scen)


def check_device(scen: FleetScenario, device: torch.device, who: str):
    if scen.device.type != device.type:
        raise ValueError(f"{who} runs on {device} but the scenario lives "
                         f"on {scen.device}; build it with device=")


def simulate_responses(draws, scen: FleetScenario, per_user, noise: float):
    """Noisy fleet-wide response simulation: (cells,) mean ms and mean
    accuracy over each cell's active users, plus next-step job counts.
    One per-cell normal draw (site ``"noise"``) scales the mean by
    ``clip(1 + noise / sqrt(n_active) * z, 0.8, 1.2)``. With an attached
    ``scen.topo`` responses couple across cells; the returned counts
    stay per-cell own-job counts either way."""
    if scen.topo is None:
        mean_ms, acc = dynamics.expected_response(
            per_user, scen.end_b, scen.edge_b, active=scen.active,
            calib=scen.calib)
    else:
        mean_ms, acc = topology.topology_expected_response(
            per_user, scen.end_b, scen.edge_b, scen.topo,
            active=scen.active, calib=scen.calib)
    if noise:
        n_act = torch.clamp(scen.active.sum(-1), min=1).to(torch.float32)
        z = draws.normal("noise", mean_ms.shape)
        # full_like: a true division, where `noise / tensor` would take
        # torch's reciprocal-then-multiply path
        scale = torch.full_like(mean_ms, noise) / torch.sqrt(n_act)
        mean_ms = mean_ms * torch.clamp(1.0 + scale * z, 0.8, 1.2)
    counts = torch.stack(
        [((per_user == A_EDGE) & scen.active).sum(-1),
         ((per_user == A_CLOUD) & scen.active).sum(-1)],
        dim=-1).to(torch.int32)
    return mean_ms, acc, counts


def nominal_expected_response(scen: FleetScenario, per_user):
    """Noise-free (cells,) mean ms / mean accuracy of ``per_user`` under
    nominal load (all member users requesting), shared- or isolated-
    contention depending on ``scen.topo``."""
    if scen.topo is None:
        return dynamics.fleet_expected_response(
            per_user, scen.end_b, scen.edge_b, scen.member,
            calib=scen.calib)
    return topology.fleet_topology_expected_response(
        per_user, scen.end_b, scen.edge_b, scen.topo, scen.member,
        calib=scen.calib)


def default_actions(spec: SpaceSpec) -> np.ndarray:
    """Full joint space for N <= 3, the SOTA-restricted offloading set
    above."""
    if spec.n_users <= 3:
        return spec.all_actions()
    return restricted_actions(spec)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


@dataclasses.dataclass
class FleetQConfig:
    alpha: float = 0.9               # paper Table 7
    gamma: float = 0.1
    eps_start: float = 1.0
    eps_decay: float = 1e-3          # multiplicative, per fleet step
    eps_min: float = 0.01
    noise: float = 0.02
    accuracy_threshold: float = 0.0
    track_links: bool = False        # index Q by link bits (Markov fleets)


class FleetQLearning:
    """Batched epsilon-greedy tabular Q-learning over a fleet of cells.

    One ``step()`` = one environment step for EVERY cell: eps-greedy
    action selection (site ``"explore"``), noisy response simulation
    (``"noise"``), the exogenous scenario transition (``"scenario.*"``)
    and the fused TD update, which updates the Q-table in place.
    """

    def __init__(self, scen, fleet_cfg: Optional[FleetConfig] = None,
                 cfg: Optional[FleetQConfig] = None,
                 actions: Optional[np.ndarray] = None, seed: int = 0,
                 device=None, draws: Optional[Draws] = None,
                 metrics: bool = True, n_windows: int = 0,
                 window_len: int = 1):
        """``scen`` is a ``ScenarioSource`` — or a ``FleetScenario`` plus
        its ``FleetConfig``. ``device`` defaults to ``cuda`` and raises
        without it; ``draws`` (default ``Draws(seed, device)``) is the
        random-draw seam.

        ``metrics`` (default on) records per-step reward / response
        time / |TD| (lanes = cells) / epsilon into a ``repro_torch.obs``
        accumulator on the device, with no host sync; read it via
        ``metrics_summary``. Recording consumes no draws and never feeds
        back into training, so trajectories are bit-identical with it on
        or off. ``n_windows > 0`` adds a per-window ring (``window_len``
        steps per slot) to every stream."""
        self.cfg = cfg or FleetQConfig()
        self.device = resolve_device(device)
        self.draws = draws if draws is not None else Draws(seed, self.device)
        scen, self.source = resolve_source(scen, fleet_cfg, self.draws)
        check_device(scen, self.device, "FleetQLearning")
        self.fleet_cfg = getattr(self.source, "cfg", None)
        self.spec = SpaceSpec(scen.users)
        self.actions = np.asarray(actions if actions is not None
                                  else default_actions(self.spec))
        self.pu_table = torch.tensor(
            self.spec.decode_actions_batch(self.actions),
            device=self.device)                                # (K, N)
        self.n_actions = len(self.actions)
        users = scen.users
        self._count_states = (users + 1) ** 2
        self._link_states = 2 ** (users + 1) if self.cfg.track_links else 1
        self.n_states = self._count_states * self._link_states
        self.q = torch.zeros((scen.cells, self.n_states, self.n_actions),
                             device=self.device)
        self.scen = scen
        self.counts = torch.zeros((scen.cells, 2), dtype=torch.int32,
                                  device=self.device)
        self.metrics = fleet_metrics(
            scen.cells, "tabular", n_windows=n_windows,
            window_len=window_len, device=self.device) if metrics else None
        self.eps = self.cfg.eps_start
        self.steps = 0

    # ------------------------------------------------------------------
    def _state_index(self, counts, scen: FleetScenario) -> torch.Tensor:
        users = scen.users
        s = counts[:, 0] * (users + 1) + counts[:, 1]
        if self.cfg.track_links:
            weights = 2 ** torch.arange(users, device=counts.device)
            packed = (scen.end_b * weights[None, :]).sum(-1) * 2 \
                + scen.edge_b
            s = s * self._link_states + packed
        return s.to(torch.int32)

    def _greedy_at(self, s) -> torch.Tensor:
        rows = self.q[torch.arange(self.q.shape[0], device=self.device),
                      s.long()]
        return first_argmax_ref(rows)

    def _explore(self, greedy, eps_t):
        """One uniform drives both the explore decision and, given
        ``u < eps``, the (still uniform) random action ``u / eps``."""
        u = self.draws.uniform("explore", greedy.shape)
        eps_b = eps_t.expand_as(u)      # elementwise true division below
        rand = torch.clamp((u / torch.clamp(eps_b, min=1e-9)
                            * self.n_actions).to(torch.int32),
                           max=self.n_actions - 1)
        return torch.where(u < eps_b, rand, greedy)

    def _core(self, s, greedy, eps_t):
        """env step + fused TD update from a precomputed ``(s, greedy)``
        pair; returns the next greedy action and the step's info."""
        cfg = self.cfg
        a = self._explore(greedy, eps_t)                      # (cells,)
        per_user = self.pu_table[a.long()]                    # (cells, N)
        mean_ms, acc, counts2 = simulate_responses(self.draws, self.scen,
                                                   per_user, cfg.noise)
        r = dynamics.reward(mean_ms, acc, cfg.accuracy_threshold)
        scen2, _ = self.source.step(self.draws, self.scen)
        s2 = self._state_index(counts2, scen2)
        self.q, greedy2, td = ops.fused_tabular_update(
            self.q, s, a, r, s2, alpha=cfg.alpha, gamma=cfg.gamma)
        if self.metrics is not None:
            self.metrics.update({"reward": r, "mean_ms": mean_ms,
                                 "td_abs": td.abs(), "epsilon": eps_t})
        self.counts, self.scen = counts2, scen2
        return greedy2, {"mean_ms": mean_ms, "mean_acc": acc, "reward": r,
                         "td": td}

    def _eps_tensor(self) -> torch.Tensor:
        return torch.tensor(self.eps, dtype=torch.float32,
                            device=self.device)

    def step(self):
        """Advance every cell by one environment step."""
        s = self._state_index(self.counts, self.scen)
        _, info = self._core(s, self._greedy_at(s), self._eps_tensor())
        self.eps = max(self.cfg.eps_min,
                       self.eps * (1.0 - self.cfg.eps_decay))
        self.steps += 1
        return info

    def run(self, n: int):
        """Advance every cell by ``n`` steps, carrying each step's greedy
        action into the next and epsilon as a float32 device scalar (the
        reference's scan carry). Returns per-step fleet-mean (ms,
        accuracy) traces of shape (n,)."""
        decay, eps_min = self.cfg.eps_decay, self.cfg.eps_min
        eps_t = self._eps_tensor()
        greedy = self._greedy_at(self._state_index(self.counts, self.scen))
        ms, acc = [], []
        for _ in range(n):
            s = self._state_index(self.counts, self.scen)
            greedy, info = self._core(s, greedy, eps_t)
            eps_t = torch.clamp(eps_t * (1.0 - decay), min=eps_min)
            ms.append(info["mean_ms"].mean())
            acc.append(info["mean_acc"].mean())
        self.eps = float(eps_t)
        self.steps += n
        if not n:
            return np.zeros(0, np.float32), np.zeros(0, np.float32)
        return _host(torch.stack(ms)), _host(torch.stack(acc))

    def metrics_summary(self):
        """Host-side summary of the recorded telemetry (``None`` when
        the agent was built with ``metrics=False``)."""
        return None if self.metrics is None else self.metrics.summary()

    # ------------------------------------------------------------------
    def _greedy(self, counts, scen):
        a = self._greedy_at(self._state_index(counts, scen))
        return self.pu_table[a.long()], a

    def greedy_decisions(self) -> torch.Tensor:
        """(cells, N) per-user decisions at each cell's current state."""
        return self._greedy(self.counts, self.scen)[0]

    @property
    def accuracy_threshold(self) -> float:
        return self.cfg.accuracy_threshold

    def policy_decisions(self, counts, scen):
        """(cells, N) per-user decisions + (cells,) action ids from one
        greedy pass. Each cell's table is tied to the fleet it trained
        on, so ``scen`` must have this agent's cells."""
        check_pad_width(self.spec.n_users, scen, "FleetQLearning")
        if scen.cells != self.q.shape[0]:
            raise ValueError(
                f"FleetQLearning holds one Q-table per trained cell "
                f"({self.q.shape[0]}); it cannot route a {scen.cells}-cell "
                "scenario — use the shared-policy fleet.policy.FleetDQN "
                "for held-out fleets")
        return self._greedy(counts, scen)

    def train(self, max_steps: int, check_every: int = 200,
              tol: float = 0.01, patience: int = 3) -> "FleetTrainResult":
        return train_against_oracle(self, max_steps, check_every=check_every,
                                    tol=tol, patience=patience)

    def greedy_expected(self, scen: Optional[FleetScenario] = None,
                        counts=None):
        """Noise-free (mean ms, mean acc) of each cell's greedy decision,
        as numpy arrays."""
        eval_scen = scen if scen is not None else self.scen
        if counts is None:
            counts = (self.counts if scen is None else
                      torch.zeros((eval_scen.cells, 2), dtype=torch.int32,
                                  device=self.device))
        per_user = self.policy_decisions(counts, eval_scen)[0]
        ms, acc = nominal_expected_response(eval_scen, per_user)
        return _host(ms), _host(acc)

    # ------------------------------------------------ FleetPolicy protocol
    def decisions(self, counts, scen: FleetScenario):
        return self.policy_decisions(counts, scen)

    def expected(self, scen: Optional[FleetScenario] = None, counts=None):
        return self.greedy_expected(scen=scen, counts=counts)


def train_against_oracle(agent, max_steps: int, check_every: int = 200,
                         tol: float = 0.01,
                         patience: int = 3) -> "FleetTrainResult":
    """THE fleet training loop, shared by both agents: per-cell
    convergence = greedy expected response within ``tol`` of that
    cell's brute-force optimum for ``patience`` consecutive checks. For
    a dynamic source the oracle is recomputed per check."""
    threshold = agent.accuracy_threshold
    dynamic = bool(agent.source.dynamic)
    opt_ms = None
    if not dynamic:
        opt_ms = _host(fleet_bruteforce(agent.scen, agent.pu_table,
                                        threshold)[0])
    cells = agent.scen.cells
    converged_at = np.full(cells, -1, np.int64)
    streak = np.zeros(cells, np.int64)
    t0 = time.perf_counter()
    history = []
    for step in range(check_every, max_steps + 1, check_every):
        agent.run(check_every)
        if dynamic:
            opt_ms = _host(fleet_bruteforce(agent.scen, agent.pu_table,
                                            threshold)[0])
        g_ms, g_acc = agent.greedy_expected()
        ok = dynamics.feasible(g_acc, threshold) & (g_ms <= opt_ms * (1 + tol))
        streak = np.where(ok, streak + 1, 0)
        newly = (streak >= patience) & (converged_at < 0)
        converged_at[newly] = step - (patience - 1) * check_every
        frac = float((converged_at >= 0).mean())
        history.append({"step": step, "frac_converged": frac,
                        "median_greedy_ms": float(np.median(g_ms))})
        if frac >= 1.0:
            break
    else:
        if max_steps < check_every:          # loop never ran
            g_ms, g_acc = agent.greedy_expected()
    if opt_ms is None:                       # dynamic fleet, loop never ran
        opt_ms = _host(fleet_bruteforce(agent.scen, agent.pu_table,
                                        threshold)[0])
    wall = time.perf_counter() - t0
    return FleetTrainResult(
        converged_at=converged_at, steps=agent.steps,
        frac_converged=float((converged_at >= 0).mean()),
        optimal_ms=np.asarray(opt_ms), greedy_ms=np.asarray(g_ms),
        greedy_acc=np.asarray(g_acc), history=history, wall_seconds=wall,
        manifest=run_manifest(config=agent.cfg, wall_seconds=wall,
                              steps=agent.steps))


@dataclasses.dataclass
class FleetTrainResult:
    converged_at: np.ndarray         # (cells,) step index, -1 = not yet
    steps: int
    frac_converged: float
    optimal_ms: np.ndarray           # (cells,)
    greedy_ms: np.ndarray            # (cells,)
    greedy_acc: np.ndarray           # (cells,)
    history: list
    wall_seconds: float
    #: provenance stamp (``repro_torch.obs.report.run_manifest``)
    manifest: Optional[dict] = None

    @property
    def cells_per_second(self) -> float:
        """Converged cells per wall-clock second of training."""
        n = int((self.converged_at >= 0).sum())
        return n / max(self.wall_seconds, 1e-9)


# ---------------------------------------------------------------------------
def fleet_bruteforce(scen: FleetScenario, pu_table: torch.Tensor,
                     threshold: float = 0.0, chunk: int = 4096):
    """Per-cell optimum over the candidate action table under nominal
    load. Returns ((cells,) best ms, (cells,) best index).

    Coupled fleets (an attached ``scen.topo``) need the reference's
    best-response ``topology_bruteforce``, which the port does not have
    yet: such a scenario raises instead of getting a wrong optimum."""
    if scen.topo is not None:
        raise NotImplementedError(
            "fleet_bruteforce on a scenario with a topology needs the "
            "coupled best-response oracle (topology_bruteforce), which "
            "repro_torch does not port yet; detach it with "
            "with_topology(scen, None) for the isolated optimum")
    return _isolated_bruteforce(scen, pu_table, threshold, chunk)


def _isolated_bruteforce(scen: FleetScenario, pu_table: torch.Tensor,
                         threshold: float = 0.0, chunk: int = 4096):
    """The exact per-cell brute force for uncoupled cells, chunked over
    the K candidates to bound the ``cells x chunk x N`` intermediate."""
    best_ms = torch.full((scen.cells,), torch.inf, device=scen.device)
    best_idx = torch.zeros((scen.cells,), dtype=torch.int32,
                           device=scen.device)
    for lo in range(0, pu_table.shape[0], chunk):
        pu = pu_table[lo:lo + chunk]                           # (k, N)
        ms, acc = dynamics.fleet_actions_expected_response(
            pu, scen.end_b, scen.edge_b, scen.member, calib=scen.calib)
        ms = torch.where(dynamics.feasible(acc, threshold), ms, torch.inf)
        i = ms.argmin(-1)                      # first index on ties
        m = ms.gather(1, i[:, None])[:, 0]
        better = m < best_ms
        best_idx = torch.where(better, (i + lo).to(torch.int32), best_idx)
        best_ms = torch.where(better, m, best_ms)
    n_inf = int(torch.isinf(best_ms).sum())
    if n_inf:
        raise ValueError("no feasible action for threshold %.2f in %d cells"
                         % (threshold, n_inf))
    return best_ms, best_idx
