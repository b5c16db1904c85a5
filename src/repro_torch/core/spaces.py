"""Joint action encoding (paper §4.2, Tables 2-3), numpy only.

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


@dataclasses.dataclass(frozen=True)
class SpaceSpec:
    n_users: int

    @property
    def n_joint_actions(self) -> int:
        return N_PER_USER_ACTIONS ** self.n_users

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
