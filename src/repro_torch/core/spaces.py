"""State and action spaces (paper §4.2, Tables 2-3), numpy only.

State (Eq. 3): the edge's and the cloud's (P, M, B), then each end
node's; edge/cloud P has nine levels, every other entry is binary.

Per-user action ids: 0..7 run locally with model d0..d7, 8 offloads to
the edge and 9 to the cloud (both run d0). A joint action for N users is
the base-10 tuple, so the full space has 10^N ids.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Tuple

import numpy as np

N_MODELS = 8
N_PER_USER_ACTIONS = N_MODELS + 2          # 8 local + edge + cloud
A_EDGE, A_CLOUD = 8, 9

EDGE_CPU_LEVELS = 9
CLOUD_CPU_LEVELS = 9


@dataclasses.dataclass(frozen=True)
class SpaceSpec:
    n_users: int

    @property
    def n_joint_actions(self) -> int:
        return N_PER_USER_ACTIONS ** self.n_users

    @property
    def state_dim(self) -> int:
        return 3 * (self.n_users + 2)

    def encode_action(self, per_user) -> int:
        a = 0
        for u in per_user:
            a = a * N_PER_USER_ACTIONS + int(u)
        return a

    def decode_action(self, a: int) -> Tuple[int, ...]:
        out = []
        for _ in range(self.n_users):
            out.append(a % N_PER_USER_ACTIONS)
            a //= N_PER_USER_ACTIONS
        return tuple(reversed(out))

    def decode_actions_batch(self, actions: np.ndarray) -> np.ndarray:
        """(K,) joint ids -> (K, N) per-user ids."""
        a = np.asarray(actions).astype(np.int64).copy()
        out = np.empty((a.shape[0], self.n_users), np.int64)
        for i in range(self.n_users - 1, -1, -1):
            out[:, i] = a % N_PER_USER_ACTIONS
            a //= N_PER_USER_ACTIONS
        return out

    def encode_actions_batch(self, per_user: np.ndarray) -> np.ndarray:
        """(K, N) per-user ids -> (K,) joint ids."""
        per_user = np.asarray(per_user)
        a = np.zeros(per_user.shape[0], np.int64)
        for u in range(self.n_users):
            a = a * N_PER_USER_ACTIONS + per_user[:, u]
        return a

    def all_actions(self) -> np.ndarray:
        return np.arange(self.n_joint_actions, dtype=np.int64)

    def state_tuple(self, p_e, m_e, b_e, p_c, m_c, b_c, ends) -> tuple:
        """ends: sequence of (p, m, b) binaries per user."""
        flat = [int(p_e), int(m_e), int(b_e), int(p_c), int(m_c), int(b_c)]
        for (p, m, b) in ends:
            flat += [int(p), int(m), int(b)]
        return tuple(flat)

    def state_vector(self, state: tuple) -> np.ndarray:
        """Normalized float32 encoding for the DQN (CPU levels -> [0,1])."""
        v = np.asarray(state, np.float32).copy()
        v[0] /= EDGE_CPU_LEVELS - 1
        v[3] /= CLOUD_CPU_LEVELS - 1
        return v

    def action_vector(self, a: int) -> np.ndarray:
        """One-hot per-user encoding (N * 10) for the (s,a)->Q network."""
        v = np.zeros((self.n_users, N_PER_USER_ACTIONS), np.float32)
        v[np.arange(self.n_users), list(self.decode_action(a))] = 1.0
        return v.reshape(-1)

    def action_vectors_batch(self, actions: np.ndarray) -> np.ndarray:
        """(K,) joint ids -> (K, N * 10) one-hot rows."""
        per_user = self.decode_actions_batch(actions)           # (K, N)
        k = per_user.shape[0]
        v = np.zeros((k, self.n_users, N_PER_USER_ACTIONS), np.float32)
        v[np.arange(k)[:, None], np.arange(self.n_users)[None, :],
          per_user] = 1.0
        return v.reshape(k, -1)


def allowed_per_user(spec: SpaceSpec, actions) -> np.ndarray:
    """(n_users, N_PER_USER_ACTIONS) bool mask of the per-user ids that
    appear in a joint candidate set — the factored DQN's action mask."""
    pu = spec.decode_actions_batch(np.asarray(actions, np.int64))
    mask = np.zeros((spec.n_users, N_PER_USER_ACTIONS), bool)
    for u in range(spec.n_users):
        mask[u, np.unique(pu[:, u])] = True
    return mask


def restricted_actions(spec: SpaceSpec) -> np.ndarray:
    """The SOTA [36] baseline set: offloading only, always the most
    accurate model -> per-user {local d0, edge, cloud}, 3^N ids."""
    combos = itertools.product([0, A_EDGE, A_CLOUD], repeat=spec.n_users)
    return np.asarray([spec.encode_action(c) for c in combos], np.int64)
