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
against it. On a coupled fleet (an attached topology) it dispatches to
``topology_bruteforce``, best response by Gauss-Seidel rounds over the
cells, each round one op (``kernels.ops.best_response_round``: on the
card the CUDA kernel ``csrc/best_response.cu``).

On a fleet mesh (``repro_torch.fleet.shard``, ``mesh=``) each rank holds
its block of the Q-table, job counts, scenario and telemetry lanes, and
K1 updates that block; the coupled oracle assembles the fleet whole and
sweeps every cell in the reference's order on every rank.
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
from repro_torch.fleet.scenarios import (FleetConfig, FleetScenario,
                                         cell_draws)
from repro_torch.kernels import ops
from repro_torch.kernels.best_response import (BEST_RESPONSE_TOL,  # noqa: F401
                                                pack_actions)
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


def place_metrics(mets: Optional[MetricsAccumulator], mesh):
    """Place a telemetry pack for sharded training: per-cell lanes take
    this rank's block, histograms and scalars replicate (identity
    without a mesh)."""
    if mets is None or mesh is None:
        return mets
    from repro_torch.fleet import shard
    return mets.place(
        lambda x, axis=0: shard.shard_array(x, mesh, axis=axis),
        lambda x: shard.replicate(x, mesh), mesh=mesh)


def adopt_mesh(mesh, source, scen):
    """THE mesh-adoption step of both agent constructors: the fleet mesh
    (an explicit argument wins, else the source's own) is attached to
    the source and the initial scenario placed. Returns ``(mesh,
    scen)``."""
    mesh = mesh if mesh is not None else getattr(source, "mesh", None)
    if mesh is None:
        return None, scen
    from repro_torch.fleet import shard
    attach = getattr(source, "attach_mesh", None)
    if attach is not None:
        attach(mesh)
    return mesh, shard.shard_scenario(scen, mesh)


def fleet_cells(scen: FleetScenario) -> int:
    """The whole fleet's cell count (``scen`` may hold one rank's
    block)."""
    return scen.cells * (scen.mesh.size if scen.mesh is not None else 1)


def gather_cells(x: torch.Tensor, scen: FleetScenario) -> torch.Tensor:
    """A per-cell tensor of ``scen``'s cells assembled whole (``x``
    itself on an unsharded scenario)."""
    if scen.mesh is None:
        return x
    from repro_torch.fleet import shard
    return shard.gather_array(x, scen.mesh)


def _gather_host(x: np.ndarray, scen: FleetScenario) -> np.ndarray:
    if scen.mesh is None:
        return x
    t = torch.from_numpy(np.ascontiguousarray(x)).to(scen.mesh.device)
    return _host(gather_cells(t, scen))


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
    draws = cell_draws(draws, scen)
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


def make_fleet_env_step(source, threshold: float = 0.0,
                        noise: float = 0.02):
    """Per-step fleet environment transition over any ``ScenarioSource``:
    ``env_step(draws, scen, per_user) -> (scen2, counts2, mean_ms,
    mean_acc, reward)`` (``api.make_env_step``). A bare ``FleetConfig``
    raises, as in the reference: wrap it in a ``SyntheticSource``."""
    from repro_torch.fleet.api import make_env_step
    if isinstance(source, FleetConfig):
        raise TypeError(
            "make_fleet_env_step(FleetConfig) was removed; wrap the "
            "config: make_fleet_env_step(repro_torch.fleet.api."
            "SyntheticSource(cfg)) — bit-identical results")
    return make_env_step(source, threshold=threshold, noise=noise)


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
                 window_len: int = 1, mesh=None):
        """``scen`` is a ``ScenarioSource`` — or a ``FleetScenario`` plus
        its ``FleetConfig``. ``device`` defaults to ``cuda`` and raises
        without it; ``draws`` (default ``Draws(seed, device)``) is the
        random-draw seam.

        ``mesh`` (``fleet.shard.fleet_mesh``; default: the source's own,
        if any) shards the per-cell Q-table, job counts, scenario and
        telemetry lanes over its ranks: the update is per-cell, so
        training never leaves the rank (K1 runs on its block) and stays
        bit-identical to the unsharded fleet.

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
        self.mesh, scen = adopt_mesh(mesh, self.source, scen)
        self.draws = cell_draws(self.draws, scen)
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
        self.metrics = place_metrics(fleet_metrics(
            fleet_cells(scen), "tabular", n_windows=n_windows,
            window_len=window_len, device=self.device) if metrics else None,
            scen.mesh)
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

    def _explore(self, greedy, eps_t, draws=None):
        """One uniform (from ``draws``, default the agent's) drives both
        the explore decision and, given ``u < eps``, the (still uniform)
        random action ``u / eps``."""
        u = (draws or self.draws).uniform("explore", greedy.shape)
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
            step_ms, step_acc = fleet_means(info, self.scen)
            ms.append(step_ms)
            acc.append(step_acc)
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


def fleet_means(info: dict, scen: FleetScenario):
    """The step's fleet-mean response ms and accuracy: on a sharded
    fleet both are assembled whole (one all-reduce) and each reduced on a
    fresh contiguous tensor, as the unsharded step reduces it."""
    ms, acc = info["mean_ms"], info["mean_acc"]
    if scen.mesh is None:
        return ms.mean(), acc.mean()
    both = gather_cells(torch.stack([ms, acc], 1), scen)
    return both[:, 0].clone().mean(), both[:, 1].clone().mean()


def train_against_oracle(agent, max_steps: int, check_every: int = 200,
                         tol: float = 0.01,
                         patience: int = 3) -> "FleetTrainResult":
    """THE fleet training loop, shared by both agents: per-cell
    convergence = greedy expected response within ``tol`` of that
    cell's brute-force optimum for ``patience`` consecutive checks. For
    a dynamic source the oracle is recomputed per check. On a sharded
    fleet the per-cell arrays are assembled whole on every rank, so the
    result is the unsharded one."""
    threshold = agent.accuracy_threshold
    dynamic = bool(agent.source.dynamic)

    def oracle_ms():
        ms = fleet_bruteforce(agent.scen, agent.pu_table, threshold)[0]
        return _host(gather_cells(ms, agent.scen))

    def greedy():
        return [_gather_host(x, agent.scen) for x in agent.greedy_expected()]

    opt_ms = None
    if not dynamic:
        opt_ms = oracle_ms()
    cells = fleet_cells(agent.scen)
    converged_at = np.full(cells, -1, np.int64)
    streak = np.zeros(cells, np.int64)
    t0 = time.perf_counter()
    history = []
    for step in range(check_every, max_steps + 1, check_every):
        agent.run(check_every)
        if dynamic:
            opt_ms = oracle_ms()
        g_ms, g_acc = greedy()
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
            g_ms, g_acc = greedy()
    if opt_ms is None:                       # dynamic fleet, loop never ran
        opt_ms = oracle_ms()
    wall = time.perf_counter() - t0
    return FleetTrainResult(
        converged_at=converged_at, steps=agent.steps,
        frac_converged=float((converged_at >= 0).mean()),
        optimal_ms=np.asarray(opt_ms), greedy_ms=np.asarray(g_ms),
        greedy_acc=np.asarray(g_acc), history=history, wall_seconds=wall,
        manifest=run_manifest(config=agent.cfg,
                              mesh=getattr(agent, "mesh", None),
                              wall_seconds=wall, steps=agent.steps))


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

    Isolated fleets get the exact chunked brute force; with an attached
    ``scen.topo`` cells couple through shared edges and the cloud queue,
    so this dispatches to the best-response ``topology_bruteforce`` —
    same return contract, so ``train_against_oracle`` and
    ``holdout_reward_ratio`` work on either fleet kind. On a sharded
    fleet the isolated brute force runs on each rank's block and the
    results are that block's."""
    if scen.topo is not None:
        ms, idx, _, _ = topology_bruteforce(scen, pu_table, threshold,
                                            chunk=chunk)
        return ms, idx
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
    n_inf = int(topology.fleet_total(torch.isinf(best_ms).sum(), scen.mesh))
    if n_inf:
        raise ValueError("no feasible action for threshold %.2f in %d cells"
                         % (threshold, n_inf))
    return best_ms, best_idx


def _whole_scenario(scen: FleetScenario) -> FleetScenario:
    """A sharded scenario assembled whole (every rank gets every cell)."""
    whole = lambda x: gather_cells(x, scen)  # noqa: E731
    topo = dataclasses.replace(scen.topo, mesh=None,
                               cell_edge=whole(scen.topo.cell_edge))
    return FleetScenario(whole(scen.end_b), whole(scen.edge_b),
                         whole(scen.member), whole(scen.active), scen.t,
                         topo, scen.calib)


def _best_response_round(idx, pu_table, end_b, edge_b, member, feas,
                         cand_e, cand_c, cell_edge, edge_capacity,
                         cloud_servers, calib=None, packed=None):
    """One Gauss-Seidel sweep: each cell in turn picks its best feasible
    candidate given every other cell's current decision, with running
    per-edge / cloud totals updated as it goes. ``feas`` / ``cand_e`` /
    ``cand_c`` are the (cells, K) round-invariant tables built by
    ``topology_bruteforce``, ``packed`` the candidates in the kernel's
    form. Returns ``(new_idx, changed)``."""
    return ops.best_response_round(idx, pu_table, end_b, edge_b, member,
                                   feas, cand_e, cand_c, cell_edge,
                                   edge_capacity, cloud_servers, calib,
                                   packed)


def _candidate_tables(scen: FleetScenario, pu_table, threshold: float,
                      chunk: int):
    """The round-invariant (cells, K) tables on the scenario's device,
    built chunked over K: feasibility of each candidate's mean member
    accuracy (float64, the reference's numpy arithmetic, users summed
    left to right) and its edge / cloud offload counts among members."""
    member = scen.member
    cells, k = member.shape[0], pu_table.shape[0]
    dev = scen.device
    nm = torch.clamp(member.sum(-1), min=1).to(torch.float64)[:, None]
    any_m = member.any(-1)[:, None]
    feas = torch.empty((cells, k), dtype=torch.bool, device=dev)
    cand_e = torch.empty((cells, k), dtype=torch.int32, device=dev)
    cand_c = torch.empty((cells, k), dtype=torch.int32, device=dev)
    for lo in range(0, k, chunk):
        pu = pu_table[lo:lo + chunk].to(dev)                   # (k, N)
        acc = dynamics.accuracies(pu, dtype=torch.float64)
        m = member[:, None, :]
        macc = torch.where(any_m, dynamics.sum_users(
            torch.where(m, acc[None], 0.0)) / nm, 100.0)
        feas[:, lo:lo + chunk] = dynamics.feasible(macc, threshold)
        cand_e[:, lo:lo + chunk] = ((pu[None] == A_EDGE) & m).sum(-1)
        cand_c[:, lo:lo + chunk] = ((pu[None] == A_CLOUD) & m).sum(-1)
    return feas, cand_e, cand_c


def topology_bruteforce(scen: FleetScenario, pu_table: torch.Tensor,
                        threshold: float = 0.0, max_rounds: int = 50,
                        chunk: int = 4096):
    """Coupled-fleet oracle: coordinate descent by best response.

    Starting from the isolated optimum, sweeps the fleet in Gauss-Seidel
    rounds (each cell best-responds to every other cell's current
    decision; feasibility depends only on a cell's own action, so the
    filter is exact) until a full round changes nothing — a pure
    equilibrium of the congestion game — or ``max_rounds`` sweeps.

    Returns ``((cells,) ms, (cells,) index, converged, rounds)``: ``ms``
    each cell's nominal-load expected response under shared contention,
    ``converged`` the fixed-point check (False: a best-response cycle
    cut off at ``max_rounds``, the last sweep returned). Without a
    topology this is the isolated oracle (converged in 0 rounds).

    A sharded fleet is assembled whole on every rank and swept in the
    reference's order over all its cells (the Gauss-Seidel order is the
    result); each rank keeps its block of ``ms`` and ``index``."""
    if scen.mesh is not None and scen.topo is not None:
        ms, idx, converged, rounds = topology_bruteforce(
            _whole_scenario(scen), pu_table, threshold, max_rounds, chunk)
        lo, k = scen.mesh.block(fleet_cells(scen))
        return ms[lo:lo + k], idx[lo:lo + k], converged, rounds
    if scen.topo is None:
        ms, idx = _isolated_bruteforce(scen, pu_table, threshold, chunk)
        return ms, idx, True, 0
    # the isolated optimum starts the sweep (and raises on an infeasible
    # threshold: feasibility does not depend on contention)
    _, idx = _isolated_bruteforce(scen, pu_table, threshold, chunk)
    feas, cand_e, cand_c = _candidate_tables(scen, pu_table, threshold,
                                             chunk)
    topo = scen.topo
    pu = pu_table.to(scen.device)
    packed = pack_actions(pu)          # once for every round
    end_b, edge_b = scen.end_b.to(torch.int32), scen.edge_b.to(torch.int32)
    converged, rounds = False, 0
    for rounds in range(1, max_rounds + 1):
        new_idx, changed = _best_response_round(
            idx, pu, end_b, edge_b, scen.member, feas, cand_e, cand_c,
            topo.cell_edge, topo.edge_capacity, topo.cloud_servers,
            calib=scen.calib, packed=packed)
        if not bool(changed):
            converged = True
            break
        idx = new_idx
    ms, _ = topology.fleet_topology_expected_response(
        pu[idx.long()], scen.end_b, scen.edge_b, topo, scen.member,
        calib=scen.calib)
    return ms, idx, converged, rounds
