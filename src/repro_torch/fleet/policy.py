"""Fleet-scale shared-policy DQN: one network, pooled experience — the
port of ``repro/fleet/policy.py``, with the weight-shared per-user
encoder (``net='shared'``, the default) and the reference's ablation
form, one flat-state trunk through ``core.networks.make_factored_q``
(``net='cell'``).

One MLP maps each user's local view (own request bit, membership, link
state, plus eight cell aggregates) to that user's ten action values; the
fleet's pooled transitions feed one on-device replay ring and one AdamW
step per fleet step, the loss under torch autograd. Acting, greedy
routing and evaluation of the shared encoder go through the fused head
(``kernels.ops.dqn_head``): features, MLP, allowed mask and — with a QoS
goal — the top-k combination filter against the Table-4 accuracy
ladder, in one CUDA kernel on the card. The ``'cell'`` net takes the
unfused greedy, the same filter in torch ops, as the reference does.

The regression target is the summed (not mean) response over active
users, un-floored (see the reference's module docstring); the reported
``info["reward"]`` stays the paper's floored Eq.-4 reward.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.networks import make_factored_q, mlp_apply, mlp_init
from repro_torch.core.spaces import (N_PER_USER_ACTIONS, SpaceSpec,
                                     allowed_per_user)
from repro_torch.fleet import dynamics
from repro_torch.fleet.population import (FleetTrainResult, _host,
                                          check_device, check_pad_width,
                                          default_actions, fleet_bruteforce,
                                          fleet_metrics,
                                          nominal_expected_response,
                                          resolve_source, simulate_responses,
                                          train_against_oracle)
from repro_torch.fleet.replay import (replay_init, replay_push, replay_sample,
                                      replay_size)
from repro_torch.fleet.scenarios import FleetConfig, FleetScenario
from repro_torch.fleet.topology import _segment_totals
from repro_torch.kernels import ops, ref
from repro_torch.rng import Draws
from repro_torch.training.optimizer import (apply_updates, constant_lr_adamw,
                                            init_opt_state)


def state_dim(users: int) -> int:
    """Width of ``encode_fleet_state``: 3 per-user blocks + edge link +
    2 counts + cell size + 3 topology features."""
    return 3 * users + 7


def _topo_features(counts, scen: FleetScenario):
    """The three (cells, 1) topology features — own-edge shared load,
    own-edge capacity tier, fleet cloud utilization."""
    inv = 1.0 / scen.users
    counts_f = counts.to(torch.float32)
    if scen.topo is None:
        edge_load = counts_f[:, :1] * inv          # own jobs == shared jobs
        cap = torch.ones((scen.cells, 1), device=scen.device)
        util = torch.zeros((scen.cells, 1), device=scen.device)
    else:
        topo = scen.topo
        ce = topo.cell_edge.long()
        tot = _segment_totals(counts[:, 0], topo.cell_edge, topo.n_edges)
        cap_cell = topo.edge_capacity[ce]
        edge_load = (tot[ce] / cap_cell)[:, None] * inv
        cap = cap_cell[:, None]
        used = counts_f[:, 1].sum()
        util = (used / torch.full_like(used, topo.cloud_servers)).expand(
            scen.cells, 1)
    return edge_load.to(torch.float32), cap, util


def encode_fleet_state(counts, scen: FleetScenario) -> torch.Tensor:
    """(cells, state_dim) feature encoding of the fleet state (layout of
    the reference: active, member, end-link blocks, edge link, counts/N,
    size/N, shared edge load, edge capacity, cloud utilization). The
    loss slices the request bits back out, so the active block stays
    first."""
    inv = 1.0 / scen.users
    edge_load, cap, util = _topo_features(counts, scen)
    return torch.cat([
        scen.active.to(torch.float32),
        scen.member.to(torch.float32),
        scen.end_b.to(torch.float32),
        scen.edge_b[:, None].to(torch.float32),
        counts.to(torch.float32) * inv,
        scen.member.sum(-1, keepdim=True).to(torch.float32) * inv,
        edge_load, cap, util,
    ], dim=-1)


#: per-user input width of the shared encoder
N_USER_FEATURES = 11


def make_shared_per_user_q(users: int, allowed: torch.Tensor):
    """Weight-shared per-user Q head over flat ``encode_fleet_state``
    rows: ``per_user_q(params, s) -> (B, N, A)``, disallowed entries at
    -1e30."""

    def per_user_q(params, s):
        n = users
        act, mem, end = s[:, :n], s[:, n:2 * n], s[:, 2 * n:3 * n]
        cell = s[:, 3 * n:3 * n + 3]               # edge_b, n_e/N, n_c/N
        topo_f = s[:, 3 * n + 4:3 * n + 7]         # shared load, cap, util
        n_act = act.sum(-1, keepdim=True)
        weak = (end * act).sum(-1, keepdim=True) / torch.clamp(n_act,
                                                               min=1.0)
        agg = torch.cat([cell[:, :1], dynamics.div_const(n_act, n),
                         cell[:, 1:], weak, topo_f], -1)    # (B, 8)
        f = torch.cat([act[..., None], mem[..., None], end[..., None],
                       agg[:, None, :].expand(s.shape[0], n, 8)], -1)
        q = mlp_apply(params, f.reshape(-1, N_USER_FEATURES))
        return torch.where(allowed[None], q.reshape(s.shape[0], n, -1),
                           -1e30)

    return per_user_q


def fused_head_features(counts, scen: FleetScenario):
    """The fused head's inputs — per-user ``(active, member, end_b)``
    blocks plus the (cells, 8) cell aggregates — assembled directly from
    the scenario with the flat encoding's op sequence."""
    act = scen.active.to(torch.float32)
    end = scen.end_b.to(torch.float32)
    inv = 1.0 / scen.users
    counts_f = counts.to(torch.float32)
    edge_load, cap, util = _topo_features(counts, scen)
    n_act = act.sum(-1, keepdim=True)
    weak = (end * act).sum(-1, keepdim=True) / torch.clamp(n_act, min=1.0)
    agg = torch.cat(
        [scen.edge_b[:, None].to(torch.float32),
         dynamics.div_const(n_act, scen.users),
         counts_f * inv, weak, edge_load, cap, util], -1)  # (cells, 8)
    return act, scen.member.to(torch.float32), end, agg.contiguous()


class HoldoutEval(NamedTuple):
    """Result of ``holdout_reward_ratio``: ``ratio`` = optimal/achieved
    expected reward (1.0 at the per-cell brute-force optimum)."""
    ratio: float
    achieved: np.ndarray
    optimal: np.ndarray
    feasible: np.ndarray


def holdout_reward_ratio(agent, scen: FleetScenario,
                         threshold: Optional[float] = None) -> HoldoutEval:
    """Score ``agent``'s cold-start greedy decisions on a (held-out)
    ``scen`` against the per-cell brute-force oracle over the agent's
    candidate set."""
    th = agent.accuracy_threshold if threshold is None else threshold
    expected = getattr(agent, "expected", None)
    g_ms, g_acc = (expected(scen) if expected is not None
                   else agent.greedy_expected(scen=scen))
    feas = dynamics.feasible(g_acc, th)
    opt_ms = _host(fleet_bruteforce(scen, agent.pu_table, th)[0])
    achieved = np.where(feas, -g_ms, -dynamics.MAX_RESPONSE_MS)
    return HoldoutEval(float((-opt_ms).mean() / achieved.mean()),
                       achieved, -opt_ms, feas)


@dataclasses.dataclass
class FleetDQNConfig:
    lr: float = 1e-3                  # paper Table 7
    gamma: float = 0.1
    eps_start: float = 1.0
    eps_decay: float = 2e-3           # multiplicative, per fleet step
    eps_min: float = 0.02
    replay_capacity: int = 65536      # pooled transitions (rows)
    batch_size: int = 256
    hidden: int = 128                 # paper §5.4's widest rung
    noise: float = 0.02
    accuracy_threshold: float = 0.0   # QoS goal (paper Eq. 4)
    topk: int = 5                     # constraint head's per-user top-k
    net: str = "shared"               # 'shared' | 'cell' (module doc)


class FleetDQN:
    """Shared-policy factored DQN over a fleet of cells.

    One ``step()`` = one environment step for EVERY cell (eps-greedy
    over the fused head, sites ``"explore_action"`` and ``"explore"``),
    one push of the ``cells`` transitions into the replay ring, one
    sampled mini-batch (site ``"replay"``) and one AdamW step.
    """

    def __init__(self, scen, fleet_cfg: Optional[FleetConfig] = None,
                 cfg: Optional[FleetDQNConfig] = None,
                 actions: Optional[np.ndarray] = None, seed: int = 0,
                 device=None, draws: Optional[Draws] = None,
                 metrics: bool = True, n_windows: int = 0,
                 window_len: int = 1):
        """``scen`` is a ``ScenarioSource`` — or a ``FleetScenario`` plus
        its ``FleetConfig``. ``device`` defaults to ``cuda`` and raises
        without it; ``draws`` (default ``Draws(seed, device)``) is the
        random-draw seam, and also draws the initial weights.

        ``metrics`` (default on) records per-step reward / response time
        (lanes = cells) / loss / replay occupancy / epsilon into a
        ``repro_torch.obs`` accumulator on the device, with no host
        sync; read it via ``metrics_summary``. Recording consumes no
        draws and never feeds back into training, so trajectories are
        bit-identical with it on or off. ``n_windows > 0`` adds a
        per-window ring (``window_len`` steps per slot) to every
        stream."""
        self.cfg = cfg or FleetDQNConfig()
        if self.cfg.net not in ("shared", "cell"):
            raise ValueError(f"unknown net form {self.cfg.net!r} "
                             "(expected 'shared' or 'cell')")
        self.device = resolve_device(device)
        self.draws = draws if draws is not None else Draws(seed, self.device)
        scen, self.source = resolve_source(scen, fleet_cfg, self.draws)
        check_device(scen, self.device, "FleetDQN")
        self.fleet_cfg = getattr(self.source, "cfg", None)
        self.spec = SpaceSpec(scen.users)
        users = scen.users
        if actions is None:
            allowed = np.ones((users, N_PER_USER_ACTIONS), bool)
            oracle = default_actions(self.spec)
        else:
            oracle = np.asarray(actions)
            allowed = allowed_per_user(self.spec, oracle)
        dev = self.device
        self.allowed = torch.tensor(allowed, device=dev)
        self.pu_table = torch.tensor(self.spec.decode_actions_batch(oracle),
                                     device=dev)
        self.state_dim = state_dim(users)
        h = self.cfg.hidden
        if self.cfg.net == "shared":
            self.params = mlp_init(
                self.draws, [N_USER_FEATURES, h, h, N_PER_USER_ACTIONS])
            self._per_user_q = make_shared_per_user_q(users, self.allowed)
        else:
            self.params = mlp_init(
                self.draws, [self.state_dim, h, h,
                             users * N_PER_USER_ACTIONS])
            self._per_user_q = make_factored_q(users, self.allowed)
        for p in self.params:
            for t in p.values():
                t.requires_grad_(True)
        self.opt = init_opt_state(self.params)
        self.buffer = replay_init(self.cfg.replay_capacity, self.state_dim,
                                  action_shape=(users,), device=dev)
        self.scen = scen
        self.counts = torch.zeros((scen.cells, 2), dtype=torch.int32,
                                  device=dev)
        self.metrics = fleet_metrics(
            scen.cells, "dqn", n_windows=n_windows, window_len=window_len,
            device=dev) if metrics else None
        self.eps = self.cfg.eps_start
        self.steps = 0
        self._acc_table = dynamics.accuracies(
            torch.arange(N_PER_USER_ACTIONS, device=dev))
        self._powers = torch.tensor(
            [N_PER_USER_ACTIONS ** (users - 1 - u) for u in range(users)],
            device=dev)
        # padded per-user allowed-id table for uniform exploration draws
        n_allowed = allowed.sum(-1)
        ids = np.zeros((users, n_allowed.max()), np.int64)
        for u in range(users):
            ids[u, :n_allowed[u]] = np.flatnonzero(allowed[u])
        self._explore_ids = torch.tensor(ids, device=dev)
        self._n_allowed = torch.tensor(n_allowed, device=dev)
        self._opt_cfg = constant_lr_adamw(self.cfg.lr)

    @property
    def accuracy_threshold(self) -> float:
        return self.cfg.accuracy_threshold

    # ---------------------------------------------------------- policy ----
    def _greedy(self, counts, scen):
        """The greedy head: ((cells, N) decisions, (cells,) joint action
        ids). The shared encoder's is the fused encode/act head (K2 on
        the card); the ``'cell'`` net's is the reference's unfused
        constraint-aware greedy in torch ops on either device."""
        kw = dict(threshold=float(self.cfg.accuracy_threshold),
                  topk=min(self.cfg.topk, N_PER_USER_ACTIONS))
        with torch.no_grad():
            if self.cfg.net == "shared":
                act, mem, end, agg = fused_head_features(counts, scen)
                dec, _ = ops.dqn_head(act, mem, end, agg, self.params,
                                      self.allowed, self._acc_table, **kw)
            else:
                q = self._per_user_q(self.params,
                                     encode_fleet_state(counts, scen))
                # the per-user top-k in the stable order (values
                # descending, ties by ascending id), as the plain K2
                # takes it. lax.top_k orders tied ids otherwise, but they
                # tie only as -1e30-masked ids, whose combos the invalid
                # cull removes, so the decisions are the reference's
                dec = ref.greedy_head_ref(q, scen.member.to(torch.float32),
                                          self._acc_table, **kw)
        return dec, (dec.long() * self._powers[None, :]).sum(-1)

    def _act(self, counts, scen, eps_t, draws=None):
        """eps-greedy over the factored head: an exploring user draws a
        uniform allowed action (``draws``: default the agent's)."""
        draws = draws or self.draws
        users = self.spec.n_users
        dec, _ = self._greedy(counts, scen)
        shape = (scen.cells, users)
        j = (draws.uniform("explore_action", shape)
             * self._n_allowed[None, :]).to(torch.int64)
        rand = self._explore_ids[torch.arange(users, device=self.device)
                                 [None, :], j]
        explore = draws.uniform("explore", shape) < eps_t
        return torch.where(explore, rand, dec.long())

    # ------------------------------------------------------------ train ---
    def _loss(self, params, s, a, r, s2):
        """Per-user terms masked by the request bits stored in the state
        (inactive users' actions had no effect)."""
        users = self.spec.n_users
        act_m, act2_m = s[:, :users], s2[:, :users]
        q = self._per_user_q(params, s)                   # (B, N, A)
        qa = (q.gather(2, a.long()[..., None])[..., 0] * act_m).sum(-1)
        with torch.no_grad():
            q2 = (self._per_user_q(params, s2).max(-1).values
                  * act2_m).sum(-1)
        target = r + self.cfg.gamma * q2
        return torch.mean((qa - target) ** 2)

    def _update(self, params, opt, s, a, r, s2):
        """One AdamW step of ``params`` and ``opt`` (in place) on the
        mini-batch; returns the loss (a 0-d tensor)."""
        loss = self._loss(params, s, a, r, s2)
        leaves = [p[k] for p in params for k in ("w", "b")]
        grads = torch.autograd.grad(loss, leaves)
        grad_tree = [{"w": grads[2 * i], "b": grads[2 * i + 1]}
                     for i in range(len(params))]
        apply_updates(params, grad_tree, opt, self._opt_cfg)
        return loss.detach()

    def train_step(self, s, a, r, s2):
        """One mini-batch AdamW step of the agent on ``(s, a, r, s2)``;
        returns the loss (a 0-d tensor)."""
        return self._update(self.params, self.opt, s, a, r, s2)

    def _step(self, eps_t):
        cfg, scen = self.cfg, self.scen
        s = encode_fleet_state(self.counts, scen)
        a = self._act(self.counts, scen, eps_t)              # (cells, N)
        mean_ms, acc, counts2 = simulate_responses(self.draws, scen, a,
                                                   cfg.noise)
        # regression target: summed (not mean) response, no floor
        r_train = dynamics.ms_to_s(-(mean_ms * scen.active.sum(-1)))
        scen2, _ = self.source.step(self.draws, scen)
        s2 = encode_fleet_state(counts2, scen2)
        replay_push(self.buffer, s, a, r_train, s2)
        loss = self.train_step(*replay_sample(self.draws, self.buffer,
                                              cfg.batch_size))
        r = dynamics.reward(mean_ms, acc, cfg.accuracy_threshold)
        if self.metrics is not None:
            # the reference's float32 division of the ring occupancy
            fill = np.float32(replay_size(self.buffer)) \
                / np.float32(self.buffer.capacity)
            self.metrics.update({"reward": r, "mean_ms": mean_ms,
                                 "loss": loss, "replay_fill": fill,
                                 "epsilon": eps_t})
        self.counts, self.scen = counts2, scen2
        return {"mean_ms": mean_ms, "mean_acc": acc, "reward": r,
                "loss": loss}

    # -------------------------------------------------------- public API --
    def step(self):
        """Advance every cell by one step + one pooled-replay update."""
        info = self._step(torch.tensor(self.eps, dtype=torch.float32,
                                       device=self.device))
        self.eps = max(self.cfg.eps_min,
                       self.eps * (1.0 - self.cfg.eps_decay))
        self.steps += 1
        return info

    def run(self, n: int):
        """Advance every cell by ``n`` steps, epsilon carried as a
        float32 device scalar. Returns per-step fleet-mean (ms,
        accuracy) traces of shape (n,)."""
        decay, eps_min = self.cfg.eps_decay, self.cfg.eps_min
        eps_t = torch.tensor(self.eps, dtype=torch.float32,
                             device=self.device)
        ms, acc = [], []
        for _ in range(n):
            info = self._step(eps_t)
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

    def policy_decisions(self, counts, scen):
        """(cells, N) per-user decisions + (cells,) joint action ids from
        one greedy pass (the FleetOrchestrator entry point)."""
        check_pad_width(self.spec.n_users, scen, "FleetDQN")
        return self._greedy(counts, scen)

    def greedy_decisions(self, scen: Optional[FleetScenario] = None,
                         counts=None) -> torch.Tensor:
        """(cells, N) decisions at each cell's current state — or, given
        a (possibly held-out) ``scen``, cold-start decisions."""
        if scen is None:
            scen = self.scen
            if counts is None:
                counts = self.counts
        check_pad_width(self.spec.n_users, scen, "FleetDQN")
        if counts is None:
            counts = torch.zeros((scen.cells, 2), dtype=torch.int32,
                                 device=self.device)
        return self._greedy(counts, scen)[0]

    def greedy_expected(self, scen: Optional[FleetScenario] = None,
                        counts=None):
        """Noise-free (mean ms, mean acc) of each cell's greedy decision,
        as numpy arrays."""
        eval_scen = scen if scen is not None else self.scen
        per_user = self.greedy_decisions(scen=scen, counts=counts)
        ms, acc = nominal_expected_response(eval_scen, per_user)
        return _host(ms), _host(acc)

    # ------------------------------------------------ FleetPolicy protocol
    def decisions(self, counts, scen: FleetScenario):
        return self.policy_decisions(counts, scen)

    def expected(self, scen: Optional[FleetScenario] = None, counts=None):
        return self.greedy_expected(scen=scen, counts=counts)

    def train(self, max_steps: int, check_every: int = 200,
              tol: float = 0.01, patience: int = 3) -> FleetTrainResult:
        return train_against_oracle(self, max_steps, check_every=check_every,
                                    tol=tol, patience=patience)
