"""Deep Q-Learning agent with experience replay (paper Algorithm 2) — the
port of ``repro/core/dqn.py``.

Two network forms:

* ``form='paper'`` — the paper's architecture: the network takes
  (state, action) as INPUT and emits a scalar Q ("DQN inputs include
  current state and possible action, and outputs the corresponding
  Q-value"). Action selection scores every candidate joint action, so
  it is O(10^N) per argmax — used for N<=3 (as the paper's own Table 7
  starts DQL at 3 users).
* ``form='factored'`` — the beyond-paper fast variant: the net maps
  state -> per-user action values (N x 10) and the joint Q is their sum
  (VDN-style). Argmax and the replay-target max are O(N*10).

Hidden sizes follow paper §5.4: two fully-connected layers with 48/64/128
units for 3/4/5 users; replay capacity 1000, mini-batch 64, eps-greedy
with eps0=1 and per-N decay (Table 7).

The parameters live on ``device`` (``cuda`` unless the caller passes
``device="cpu"``), are drawn through ``repro_torch.rng.Draws`` at site
``"init"`` and train with autograd and the port's AdamW
(``training.optimizer.apply_updates``, the reference's rule, not
``torch.optim.AdamW``). Exploration and replay sampling draw from numpy
generators seeded with ``seed`` — two of them, the agent's and the
buffer's, as in the reference — so that both packages explore and
sample alike. The greedy pass copies q to the host, as the reference
does, and selects there with the reference's numpy calls: the
constraint-aware top-4 is ``np.argsort`` reversed, whose order among
tied values (masked -1e30 entries included) is numpy's, neither
ascending nor descending by index, and differs from the stable top-k of
the fleet's fused head.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.networks import make_factored_q, mlp_apply, mlp_init
from repro_torch.core.replay import ReplayBuffer
from repro_torch.core.spaces import (A_EDGE, N_PER_USER_ACTIONS, SpaceSpec,
                                     allowed_per_user)
from repro_torch.fleet.dynamics import TOP5, feasible
from repro_torch.rng import Draws
from repro_torch.training.optimizer import (apply_updates, constant_lr_adamw,
                                            init_opt_state)

PAPER_HIDDEN = {1: 32, 2: 32, 3: 48, 4: 64, 5: 128}
PAPER_EPS_DECAY = {3: 0.4, 4: 0.7, 5: 0.9}    # Table 7 (per 1000 steps here)


@dataclasses.dataclass
class DQNConfig:
    lr: float = 1e-3                  # paper Table 7
    gamma: float = 0.1
    eps_start: float = 1.0
    eps_decay_per_1k: Optional[float] = None   # None -> Table 7
    eps_min: float = 0.02
    replay_capacity: int = 1000       # paper §5.4
    batch_size: int = 64              # paper §5.4
    hidden: Optional[int] = None      # None -> paper §5.4 by n_users
    train_every: int = 1
    form: str = "paper"               # 'paper' | 'factored'


def _trainable(params):
    for p in params:
        for t in p.values():
            t.requires_grad_(True)
    return params


class DQNAgent:
    def __init__(self, spec: SpaceSpec, cfg: Optional[DQNConfig] = None,
                 actions: Optional[np.ndarray] = None, seed: int = 0,
                 accuracy_threshold: Optional[float] = None, device=None):
        """accuracy_threshold: the QoS goal (paper Fig. 4) — when given,
        the factored form's greedy pass enumerates per-user top-k combos
        and filters by the (known) model-accuracy table, restoring the
        global constraint the sum decomposition cannot represent."""
        self.device = resolve_device(device)
        self.accuracy_threshold = accuracy_threshold
        self.spec = spec
        self.cfg = cfg or DQNConfig()
        if self.cfg.eps_decay_per_1k is None:
            d = PAPER_EPS_DECAY.get(spec.n_users, 0.9)
            self.cfg = dataclasses.replace(self.cfg, eps_decay_per_1k=d)
        if self.cfg.hidden is None:
            self.cfg = dataclasses.replace(
                self.cfg, hidden=PAPER_HIDDEN.get(spec.n_users, 128))
        self.actions = (spec.all_actions() if actions is None
                        else np.asarray(actions))
        self.rng = np.random.default_rng(seed)
        self.eps = self.cfg.eps_start
        self.steps = 0
        self.buffer = ReplayBuffer(self.cfg.replay_capacity, spec.state_dim,
                                   seed=seed)
        h, dev = self.cfg.hidden, self.device
        draws = Draws(seed, dev)
        if self.cfg.form == "paper":
            in_dim = spec.state_dim + spec.n_users * N_PER_USER_ACTIONS
            self.params = mlp_init(draws, [in_dim, h, h, 1])
            self._avecs = torch.tensor(
                spec.action_vectors_batch(self.actions), device=dev)
        else:
            out = spec.n_users * N_PER_USER_ACTIONS
            self.params = mlp_init(draws, [spec.state_dim, h, h, out])
            # per-user local action ids implied by self.actions:
            self._allowed = allowed_per_user(spec, self.actions)
            self._per_user_q = make_factored_q(
                spec.n_users, torch.tensor(self._allowed, device=dev))
        _trainable(self.params)
        self.opt_cfg = constant_lr_adamw(self.cfg.lr)
        self.opt = init_opt_state(self.params)

    # ------------------------------------------------------------------
    def _q_all(self, svecs: torch.Tensor) -> torch.Tensor:
        """Paper form: Q(s, a) of every candidate action for each state,
        (B, state_dim) -> (B, K)."""
        b, k = svecs.shape[0], self._avecs.shape[0]
        inp = torch.cat([svecs[:, None, :].expand(b, k, svecs.shape[1]),
                         self._avecs[None].expand(b, k, -1)], dim=2)
        return mlp_apply(self.params, inp)[..., 0]

    def _loss(self, s, a, r, s2):
        gamma, dev = self.cfg.gamma, self.device
        if self.cfg.form == "paper":
            avec = torch.tensor(self.spec.action_vectors_batch(a), device=dev)
            qa = mlp_apply(self.params, torch.cat([s, avec], 1))[:, 0]
            with torch.no_grad():
                q2 = self._q_all(s2).max(-1).values
        else:
            aidx = torch.tensor(self.spec.decode_actions_batch(a), device=dev)
            q = self._per_user_q(self.params, s)                # (B,N,NA)
            qa = q.gather(2, aidx[..., None])[..., 0].sum(1)
            with torch.no_grad():
                q2 = self._per_user_q(self.params, s2).max(-1).values.sum(-1)
        target = r + gamma * q2
        return torch.mean((qa - target) ** 2)

    def _train(self, s, a, r, s2) -> float:
        """One AdamW step on a replay batch (numpy); returns the loss."""
        dev = self.device
        loss = self._loss(torch.tensor(s, device=dev), a,
                          torch.tensor(r, device=dev),
                          torch.tensor(s2, device=dev))
        leaves = [p[k] for p in self.params for k in ("w", "b")]
        grads = torch.autograd.grad(loss, leaves)
        apply_updates(self.params,
                      [{"w": grads[2 * i], "b": grads[2 * i + 1]}
                       for i in range(len(self.params))],
                      self.opt, self.opt_cfg)
        return float(loss.detach())

    # ------------------------------------------------------------------
    def _host_q(self, state: tuple) -> np.ndarray:
        """The greedy pass's q on the host: (K,) over ``self.actions`` in
        the paper form, (N, 10) per-user values in the factored form."""
        svec = torch.tensor(self.spec.state_vector(state), device=self.device)
        with torch.no_grad():
            if self.cfg.form == "paper":
                q = self._q_all(svec[None])[0]
            else:
                q = self._per_user_q(self.params, svec[None])[0]
        return q.cpu().numpy()

    def _greedy_from_q(self, q: np.ndarray) -> int:
        """The greedy joint action from ``_host_q``, by the reference's
        numpy selection (first-index argmax; the constraint-aware top-4
        in ``np.argsort``'s order)."""
        if self.cfg.form == "paper":
            return int(self.actions[int(np.argmax(q))])
        if self.accuracy_threshold is None:
            return self.spec.encode_action(q.argmax(-1))
        # constraint-aware greedy: per-user top-k -> feasible combos by the
        # known model-accuracy table (the agent's QoS-goal knowledge).
        n = self.spec.n_users
        k = min(4, q.shape[-1])
        topk = np.argsort(q, axis=-1)[:, ::-1][:, :k]           # (N, k)
        best, best_q = None, -np.inf
        th = self.accuracy_threshold
        for combo in itertools.product(range(k), repeat=n):
            per = topk[np.arange(n), list(combo)]
            acc = TOP5[np.where(per < A_EDGE, per, 0)].mean()
            if not feasible(acc, th):
                continue
            qs = q[np.arange(n), per].sum()
            if qs > best_q:
                best_q, best = qs, per
        if best is None:
            best = q.argmax(-1)
        return self.spec.encode_action(best)

    def greedy_action(self, state: tuple) -> int:
        return self._greedy_from_q(self._host_q(state))

    def act(self, state: tuple) -> int:
        if self.rng.random() < self.eps:
            return int(self.actions[self.rng.integers(len(self.actions))])
        return self.greedy_action(state)

    def update(self, state, action: int, reward: float, next_state):
        svec = self.spec.state_vector(state)
        s2vec = self.spec.state_vector(next_state)
        self.buffer.push(svec, action, reward, s2vec)
        self.steps += 1
        # eps decay: Table 7 value applied per 1000 invocations
        if self.steps % 1000 == 0:
            self.eps = max(self.cfg.eps_min,
                           self.eps * (1.0 - self.cfg.eps_decay_per_1k))
        if len(self.buffer) < self.cfg.batch_size:
            return None
        if self.steps % self.cfg.train_every:
            return None
        return self._train(*self.buffer.sample(self.cfg.batch_size))

    # transfer learning (paper Fig. 7)
    def warm_start_from(self, other: "DQNAgent"):
        self.params = _trainable([{k: v.detach().clone()
                                   for k, v in p.items()}
                                  for p in other.params])
        self.opt = init_opt_state(self.params)
