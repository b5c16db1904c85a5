"""Logical-axis sharding rules (MaxText-style) — the port of
``repro/distributed/sharding.py``.

Mesh axes:
  'pod'   - pods (multi-pod only), extra data-parallel dim
  'data'  - within-pod data parallel / FSDP axis
  'model' - tensor/expert parallel axis
  'fleet' - 1-D fleet data-parallel axis (``repro_torch.fleet.shard``):
            the cell population and per-edge arrays shard over it;
            absent from the model meshes, so the fleet rules are inert
            there (and the model rules are inert on a fleet mesh)

Logical activation/parameter axes map through ``RULES``. Every spec is
divisibility-checked per dimension: a dim its mapped mesh axes do not
divide falls back to replication, and a mesh axis is never assigned
twice within one spec (the first dim wins). A mesh is anything with
``shape`` (axis name -> size) and ``axis_names``; a spec is a
``PartitionSpec``, one entry per dimension (an axis name, a tuple of
names, or None for replicated).

The port runs the fleet mesh only (``fleet.shard.FleetMesh``, SPMD over
``torch.distributed``). Model-parallel execution — ``logical`` and
``shard_moe_dispatch`` under a mesh with ``data`` / ``model`` axes, and
placing parameters by ``param_shardings`` — waits for the other model
families and more than one card (ROADMAP); the specs themselves are
computed here exactly as the reference computes them.
"""
from __future__ import annotations

import math
from typing import Optional

# logical axis -> mesh axes (resolved against the mesh; mesh axes absent
# from it are dropped, so one table serves 2D and 3D meshes)
RULES = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),
    "seq": (),
    "kv_seq": ("pod", "data"),
    "cache_len": ("pod", "data", "model"),
    "model": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "embed": (),
    "mlp": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "d_inner": ("model",),
    "cells": ("fleet",),
    "edges": ("fleet",),
    None: (),
}

#: the mesh axes of model-parallel execution
MODEL_AXES = ("pod", "data", "model")


class PartitionSpec(tuple):
    """One entry per dimension: a mesh axis name, a tuple of names, or
    None (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


_STATE = {"mesh": None}


def activate_mesh(mesh) -> None:
    _STATE["mesh"] = mesh


def current_mesh():
    return _STATE["mesh"]


def _resolve(mesh, logical_axes):
    names = set(mesh.axis_names)
    return [tuple(a for a in RULES.get(ax, ()) if a in names)
            for ax in logical_axes]


def _checked_spec(mesh, shape, resolved) -> PartitionSpec:
    """Divisibility check + no-duplicate-axis guarantee (first dim
    wins)."""
    used = set()
    fixed = []
    resolved = list(resolved) + [()] * (len(shape) - len(resolved))
    for dim, axes in zip(shape, resolved):
        axes = tuple(a for a in axes if a not in used)
        size = math.prod(mesh.shape[a] for a in axes) if axes else 1
        if axes and dim % size == 0:
            used.update(axes)
            fixed.append(axes if len(axes) > 1 else axes[0])
        else:
            fixed.append(None)
    return PartitionSpec(*fixed)


def spec_for(shape, logical_axes, mesh=None) -> Optional[PartitionSpec]:
    """The spec of an array of ``shape`` with ``logical_axes`` on
    ``mesh`` (default: the active mesh; None without one)."""
    mesh = mesh or _STATE["mesh"]
    if mesh is None:
        return None
    return _checked_spec(mesh, shape, _resolve(mesh, logical_axes))


def _require_no_model_mesh(mesh, what: str) -> None:
    if any(a in MODEL_AXES for a in mesh.axis_names):
        raise NotImplementedError(
            f"{what} under a model mesh {tuple(mesh.axis_names)}: "
            "model-parallel execution waits for the port's other model "
            "families and more than one card (ROADMAP, queue 1)")


def logical(x, *logical_axes):
    """Annotate activation ``x`` with logical axes: the identity without
    a mesh and on a fleet mesh (the model rules are inert there)."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return x
    _require_no_model_mesh(mesh, "logical()")
    return x


def shard_moe_dispatch(x):
    """(B, E, C, D) dispatched MoE activations: experts to 'model'."""
    return logical(x, "batch", "expert", None, None)


# ---------------------------------------------------------------------------
# Parameter shardings, matched by (parent, leaf) names in the param tree.

_PARENT_RULES = {
    "embed": ("vocab", "embed"),
    "lm_head": ("fsdp", "vocab"),
    "proj_img": ("fsdp", "model"),
    "router": (None, None),
    "wq": ("fsdp", "model"),
    "wk": ("fsdp", "model"),
    "wv": ("fsdp", "model"),
    "wo": ("model", "fsdp"),
    "w_gate": ("fsdp", "mlp"),
    "w_up": ("fsdp", "mlp"),
    "w_down": ("mlp", "fsdp"),
    "in_proj": ("fsdp", "d_inner"),
    "x_proj": ("d_inner", None),
    "out_proj": ("d_inner", "fsdp"),
}
_MOE_PARENT_RULES = {
    "w_gate": ("expert", "fsdp", None),
    "w_up": ("expert", "fsdp", None),
    "w_down": ("expert", None, "fsdp"),
}
_LEAF_RULES = {
    "dt_w": (None, "d_inner"),
    "dt_b": ("d_inner",),
    "conv_w": (None, "d_inner"),
    "conv_b": ("d_inner",),
    "A_log": ("d_inner", None),
    "D": ("d_inner",),
}


def _path_parts(path):
    """Path entries as strings: plain keys and indices, or objects with
    a ``key`` / ``idx`` (the reference's tree paths)."""
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return parts


def logical_axes_for_param(path, ndim: int):
    parts = _path_parts(path)
    leaf = parts[-1]
    parent = parts[-2] if len(parts) >= 2 else ""
    in_moe = "moe" in parts
    if leaf in ("w", "w_q", "s"):
        if in_moe and parent in _MOE_PARENT_RULES:
            axes = _MOE_PARENT_RULES[parent]
        else:
            axes = _PARENT_RULES.get(parent, ())
        if leaf == "s" and axes:  # quant scales broadcast over the input dim
            head = ("expert",) if (in_moe and len(axes) == 3) else ()
            axes = head + (None,) * (ndim - len(head) - 1) + (axes[-1],)
    else:
        axes = _LEAF_RULES.get(leaf, ())
    axes = tuple(axes)
    if len(axes) < ndim:      # leading stacked-layer (or other) dims: None
        axes = (None,) * (ndim - len(axes)) + axes
    elif len(axes) > ndim:
        axes = axes[-ndim:]
    return axes


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_shardings(params_shapes, mesh=None):
    """The tree of ``PartitionSpec``s matching ``params_shapes`` (nested
    dicts and lists whose leaves have a ``shape``); a tree of None
    without a mesh."""
    mesh = mesh or _STATE["mesh"]
    if mesh is None:
        return _map_with_path(lambda _p, _x: None, params_shapes)

    def one(path, leaf):
        axes = logical_axes_for_param(path, len(leaf.shape))
        return _checked_spec(mesh, leaf.shape, _resolve(mesh, axes))

    return _map_with_path(one, params_shapes)
