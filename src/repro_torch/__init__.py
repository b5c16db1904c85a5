"""repro_torch — the PyTorch/CUDA port of ``repro``: the fleet
online-learning loop, the serving path of the served models (the edge
ladder, Falcon-Mamba, Hymba and the mixture-of-experts Granite), their
engines and the routed dispatch,
and the paper's single-cell layer (``core``: the environment, tabular
Q-learning, the DQN, the brute force, the baselines, the transfer
protocol and the orchestrator) with the serving launcher's
RL-orchestrated loop (``launch.serve``), and the language models'
training (``Model.loss``, ``training``, ``checkpoint``,
``launch.train``). The fleet spans the ranks of a
``torch.distributed`` group as a 1-D mesh (``fleet.shard``), each rank
on its block of cells, bit-identical to the unsharded fleet.

The package mirrors ``repro``'s layout (``fleet/dynamics.py`` here is the
counterpart of ``repro/fleet/dynamics.py``, and so on) but imports
neither JAX nor anything of ``repro``: it keeps its own copy of the data
it needs. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on a host without CUDA the default raises rather than
moving to the CPU on its own (``resolve_device``).

The six kernels of those paths — the fleet loop's ``kernels.tabular_rl``
and ``kernels.dqn_head``, the served models' ``flash_attention``,
``decode_attention``, ``int8_matmul`` and ``selective_scan`` — and the
coupled-fleet oracle's ``kernels.best_response`` (port-only: the
reference runs that round as a jitted loop) and flash attention's
backward (port-only: the reference differentiates its jnp attention
with ``jax.grad``) are hand-written CUDA C++
for Hopper (``csrc/*.cu``), built with ``nvcc`` at first use and bound
with ``ctypes``. Each has a plain PyTorch version
beside it, which is what a CPU tensor takes (``kernels.ops``).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, which
    raises when CUDA is missing — the port never falls back to the CPU
    unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
