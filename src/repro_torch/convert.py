"""Carry the JAX package's state across into the port's, from numpy.

The caller turns each JAX array into numpy (``np.asarray``) and hands
the result over, so this module never touches JAX. Layouts are kept as
they are: weights stay ``(in, out)``, the Q-table ``(cells, S, K)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.fleet.dynamics import Calibration
from repro_torch.fleet.scenarios import FleetScenario
from repro_torch.fleet.topology import Topology
from repro_torch.kernels.int8_matmul import k_major


def scenario(end_b, edge_b, member, active, t=0, topo=None, calib=None,
             device=None) -> FleetScenario:
    """A ``FleetScenario`` from its seven fields as numpy: ``topo`` is
    ``(cell_edge, edge_capacity, cloud_servers)`` or None, ``calib`` is
    ``(compute_scale, hop_offset_ms)`` or None."""
    dev = resolve_device(device)

    def arr(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

    if topo is not None:
        cell_edge, cap, servers = topo
        topo = Topology(arr(cell_edge, torch.int32), arr(cap, torch.float32),
                        float(np.asarray(servers)))
    if calib is not None:
        calib = Calibration(arr(calib[0], torch.float32),
                            arr(calib[1], torch.float32))
    return FleetScenario(arr(end_b, torch.int32), arr(edge_b, torch.int32),
                         arr(member, torch.bool), arr(active, torch.bool),
                         int(np.asarray(t)), topo, calib)


def q_table(q, device=None) -> torch.Tensor:
    """A ``(cells, S, K)`` float32 Q-table."""
    return torch.tensor(np.asarray(q), dtype=torch.float32,
                        device=resolve_device(device))


def mlp_params(params, device=None, requires_grad: bool = True):
    """The MLP param list ``[{"w", "b"}] * layers``, as float32 leaf
    tensors (trainable by default, as the agent's are)."""
    dev = resolve_device(device)
    return [{k: torch.tensor(np.asarray(p[k]), dtype=torch.float32,
                             device=dev).requires_grad_(requires_grad)
             for k in ("w", "b")} for p in params]


def model_params(params_np, cfg, device=None) -> dict:
    """The served model's params from the reference's, as nested dicts of
    numpy arrays (bfloat16 leaves upcast to float32 by the caller, which
    is exact; ``torch`` cannot take numpy's bfloat16).

    Each segment's stacked leaves (leading layer axis) become the port's
    list of per-layer dicts. A dense linear ``{"w"}`` and the embedding
    are cast back to ``cfg.dtype`` (exact again); an int8 linear
    ``{"w_q", "s"}`` keeps int8 weights, held K-major as
    ``layers.init_linear`` holds them (strides (1, in)), and float32
    scales; norm gains stay float32. A VLM's ``proj_img`` is a dense
    linear like the others. A Mamba block keeps the reference's types:
    ``conv_w`` in ``cfg.dtype``, ``conv_b``, ``dt_w``, ``dt_b``,
    ``A_log`` and ``D`` float32. A MoE block keeps its router's ``w``
    float32, and its experts' leaves ``w`` (E, in, out), ``w_q`` (K-major
    per expert) and ``s`` (E, 1, out) as a linear's. An encoder-decoder's
    ``encoder`` subtree comes across the same way: its stacked
    ``segments`` become per-layer lists, its ``final_norm`` a norm; the
    decoder layers' ``cross`` and ``ln_cross`` are linears and a norm
    like the others. Weights stay ``(in, out)``."""
    from repro_torch.models.layers import dt
    dev = resolve_device(device)
    wdtype = dt(cfg.dtype)
    f32 = torch.float32
    types = {"w": wdtype, "w_q": torch.int8, "s": f32, "g": f32,
             "conv_w": wdtype, "conv_b": f32, "dt_w": f32, "dt_b": f32,
             "A_log": f32, "D": f32}

    def leaves(tree, name=None, parent=None):
        if isinstance(tree, dict):
            return {k: leaves(v, k, name) for k, v in tree.items()}
        dtype = f32 if parent == "router" else types[name]
        t = torch.tensor(np.asarray(tree), dtype=dtype, device=dev)
        return k_major(t) if name == "w_q" else t

    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    def stack(tree):
        out = {k: leaves(v) for k, v in tree.items()
               if k not in ("segments", "encoder")}
        out["segments"] = []
        for seg in tree["segments"]:
            n = len(np.asarray(seg["ln1"]["g"]))
            out["segments"].append([leaves(layer(seg, i)) for i in range(n)])
        if "encoder" in tree:
            out["encoder"] = stack(tree["encoder"])
        return out

    return stack(params_np)


def opt_state(state, device=None) -> dict:
    """The AdamW state ``{"m", "v", "step"}`` (moments mirror the
    params)."""
    return {"m": mlp_params(state["m"], device, requires_grad=False),
            "v": mlp_params(state["v"], device, requires_grad=False),
            "step": int(np.asarray(state["step"]))}
