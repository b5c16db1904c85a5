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

Two kinds of mesh run here. The fleet mesh (``fleet.shard.FleetMesh``)
is SPMD over ``torch.distributed`` ranks with explicit collectives. A
model mesh (``launch.mesh.Mesh``: ``data`` / ``model`` axes, and ``pod``)
is a ``DeviceMesh`` whose tensors are DTensors, the counterpart of the
reference's GSPMD: ``placements`` turns a spec into DTensor placements
(a mesh axis of size 1 replicates), ``distribute_params`` and
``distribute_inputs`` place the parameters by ``param_shardings`` and
the inputs and caches by ``batch_specs``, and ``logical`` redistributes
an activation to the placements of its logical axes, as the reference's
``with_sharding_constraint``. The hand-written kernels run on the local
shards (``kernels.ops``, through ``local_map``). ``model_mesh`` is the
context a sharded prefill or decode runs in: the mesh active, and plain
tensors (positions, masks: the same values on every rank) taken as
replicated.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

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


def is_model_mesh(mesh) -> bool:
    """Does ``mesh`` have a model-parallel axis (``pod``, ``data`` or
    ``model``)?"""
    return mesh is not None and any(a in MODEL_AXES for a in mesh.axis_names)


def is_dtensor(x) -> bool:
    """Is ``x`` a DTensor (placed on a model mesh)?"""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec, mesh) -> tuple:
    """THE conversion of a ``PartitionSpec`` to DTensor placements: one
    a mesh axis, in the mesh's axis order, ``Shard(d)`` for the dim
    ``d`` whose entry names the axis and ``Replicate()`` for an axis no
    entry names or whose size is 1 (a one-device shard is the whole
    tensor). A dim split over several axes is split in the mesh's axis
    order, outer first, as the entry's tuple (the rules list axes in
    that order)."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.axis_names)
    for d, entry in enumerate(spec or ()):
        for ax in _axes_of(entry):
            if mesh.shape[ax] > 1:
                out[mesh.axis_names.index(ax)] = Shard(d)
    return tuple(out)


def _local_block(t, where, mesh):
    """This rank's block of the whole tensor ``t`` under ``where`` (the
    placements on ``mesh``): a narrowed view, split in the mesh's axis
    order."""
    from torch.distributed.tensor import Shard
    coord = mesh.device_mesh.get_coordinate()
    for i, p in enumerate(where):
        if isinstance(p, Shard):
            n = mesh.device_mesh.size(i)
            k = t.shape[p.dim] // n
            t = t.narrow(p.dim, coord[i] * k, k)
    return t


def _k_major(t) -> bool:
    """Is ``t`` an (..., K, N) view of (..., N, K) storage (K5's int8
    weight layout, ``kernels.int8_matmul.k_major``)?"""
    return (t.dim() >= 2 and t.shape[-2] > 1 and t.shape[-1] > 1
            and t.stride(-2) == 1 and t.stride(-1) == t.shape[-2])


def distribute(t, spec, mesh):
    """The whole tensor ``t`` (the same values on every rank) placed on
    ``mesh`` at ``spec``: a DTensor whose local tensor is this rank's
    block, copied out, so that no collective runs and ``t`` itself may
    be freed. An int8 weight held K-major stays K-major."""
    from torch.distributed.tensor import DTensor
    where = placements(spec, mesh)
    block = _local_block(t, where, mesh)
    if _k_major(t):
        from repro_torch.kernels.int8_matmul import k_major
        local = k_major(block)
    else:
        local = block.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh.device_mesh, where,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def _gather_by_sum(x) -> bool:
    """Is a gather of DTensor ``x`` written out as an all-reduce
    (``_gathered_dims``)? On a gloo group holding CUDA tensors, yes;
    elsewhere DTensor's all-gather runs."""
    import torch.distributed as dist
    return x.device.type == "cuda" and dist.get_backend(
        x.device_mesh.get_group(0)) == "gloo"


def _gathered_dims(x, dims):
    """DTensor ``x`` whole along the tensor dims ``dims`` (every mesh dim
    that splits one of them now replicates it), written out as one
    all-reduce: each rank copies its block into a zero-filled buffer
    placed as a ``Partial`` sum, which is reduced. Exact: every element
    is its block's value plus zeros. The gather of a gloo group on CUDA
    tensors, whose functional all-gather fails (``tools/
    gloo_cuda_probe.py``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    local = x.to_local()
    buf = local.new_zeros(tuple(x.shape[d] if d in dims else n
                                for d, n in enumerate(local.shape)))
    block = buf
    for i, p in enumerate(x.placements):      # outer mesh dims first
        if isinstance(p, Shard) and p.dim in dims:
            k = block.shape[p.dim] // mesh.size(i)
            block = block.narrow(p.dim, coord[i] * k, k)
    block.copy_(local)
    part = tuple(Partial() if isinstance(p, Shard) and p.dim in dims
                 else p for p in x.placements)
    y = DTensor.from_local(buf, mesh, part, run_check=False)
    return y.redistribute(mesh, tuple(
        Replicate() if isinstance(p, Partial) else p for p in part))


def to_places(x, where, device_mesh):
    """``x`` redistributed to the placements ``where`` on
    ``device_mesh`` (a plain tensor taken as replicated). A split dim
    that ``where`` gathers is gathered by ``_gathered_dims`` where
    ``_gather_by_sum`` says so."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, device_mesh, [Replicate()] * len(where),
                               run_check=False)
    if tuple(x.placements) == tuple(where):
        return x
    dims = {p.dim for p, w in zip(x.placements, where)
            if isinstance(p, Shard) and w != p}
    if dims and _gather_by_sum(x):
        x = _gathered_dims(x, dims)
        if tuple(x.placements) == tuple(where):
            return x
    return x.redistribute(device_mesh, tuple(where))


def settled(x):
    """DTensor ``x`` with every ``Partial`` placement reduced (an
    all-reduce), its ``Shard`` placements kept."""
    from torch.distributed.tensor import Partial, Replicate
    where = tuple(Replicate() if isinstance(p, Partial) else p
                  for p in x.placements)
    return to_places(x, where, x.device_mesh)


def split_heads(x, n: int, hd: int):
    """``x`` (..., n * hd) as (..., n, hd). A DTensor whose last dim is
    split over more shards than ``n`` divides by (heads a model axis does
    not divide) is gathered along it first (``whole_last_dim``): its
    heads are then computed whole on every rank of those axes."""
    if is_dtensor(x):
        from torch.distributed.tensor import Shard
        last = x.dim() - 1
        shards = math.prod(x.device_mesh.size(i)
                           for i, p in enumerate(x.placements)
                           if isinstance(p, Shard) and p.dim == last)
        if n % shards:
            x = whole_last_dim(x)
    return x.reshape(*x.shape[:-1], n, hd)


def on_shards(fn, args, in_places, out_places):
    """``fn`` over the local shards of ``args`` (each tensor placed at its
    ``in_places`` entry by ``to_places``, so a plain tensor is taken as
    replicated and a gather of a gloo group on CUDA tensors is written
    out; None for an argument that is no tensor), its outputs wrapped at
    ``out_places`` (one tuple of placements, or a tuple of them an
    output): for the ops DTensor has no strategy for, and the kernels."""
    from torch.distributed.tensor import DTensor, Placement
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    if isinstance(out_places[0], Placement):      # one output
        out_places = list(out_places)
    args = tuple(to_places(a, p, mesh) if isinstance(a, torch.Tensor)
                 and p is not None else a
                 for a, p in zip(args, in_places))
    return local_map(fn, out_placements=out_places,
                     in_placements=tuple(in_places), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def shard_dims(t) -> dict:
    """{mesh dim: tensor dim} of DTensor ``t``'s ``Shard`` placements."""
    from torch.distributed.tensor import Shard
    return {i: p.dim for i, p in enumerate(t.placements)
            if isinstance(p, Shard)}


def places(ndim: int, shards: dict, partial=()) -> tuple:
    """Placements on a mesh of ``ndim`` dims: ``Shard(shards[i])`` on
    mesh dim i where given, ``Partial()`` on the dims of ``partial``,
    ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return tuple(Shard(shards[i]) if i in shards else
                 Partial() if i in partial else Replicate()
                 for i in range(ndim))


def whole_last_dim(x):
    """``x`` with its last dim gathered on every rank where a DTensor
    splits it (``to_places``), ``x`` itself otherwise."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    last = x.dim() - 1
    x = settled(x)
    return to_places(x, tuple(
        Replicate() if isinstance(p, Shard) and p.dim == last else p
        for p in x.placements), x.device_mesh)


def place(x, spec, mesh):
    """``x`` redistributed to ``spec`` on ``mesh`` (a plain tensor is
    taken as replicated: the same values on every rank); ``x`` itself
    where it is placed so already."""
    return to_places(x, placements(spec, mesh), mesh.device_mesh)


def logical(x, *logical_axes):
    """Annotate activation ``x`` with logical axes: the identity without
    a mesh and on a fleet mesh (the model rules are inert there); under
    a model mesh, ``x`` redistributed to the placements of
    ``spec_for(x.shape, logical_axes)``, as the reference's
    ``with_sharding_constraint``."""
    mesh = _STATE["mesh"]
    if not is_model_mesh(mesh):
        return x
    return place(x, spec_for(x.shape, logical_axes, mesh), mesh)


def shard_moe_dispatch(x):
    """(B, E, C, D) dispatched MoE activations: experts to 'model'."""
    return logical(x, "batch", "expert", None, None)


@contextlib.contextmanager
def model_mesh(mesh):
    """The context of a sharded prefill or decode: ``mesh`` active, and
    a plain tensor met beside a DTensor taken as replicated
    (``implicit_replication``): the model's positions, slot indices and
    masks hold the same values on every rank."""
    from torch.distributed.tensor.experimental import implicit_replication
    prev = _STATE["mesh"]
    activate_mesh(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        activate_mesh(prev)


def full(tree):
    """``tree`` with every DTensor assembled whole on every rank (through
    ``to_places``: replicated, then its local tensor)."""
    from torch.distributed.tensor import DTensor, Replicate

    def whole(t):
        if not isinstance(t, DTensor):
            return t
        return to_places(t, (Replicate(),) * t.device_mesh.ndim,
                         t.device_mesh).to_local()
    return _map_with_path(lambda _p, t: whole(t), tree)


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


def distribute_params(params, mesh):
    """Every leaf of the param tree placed on the model ``mesh`` at its
    ``param_shardings`` spec (``distribute``): the int8 ``w_q`` views
    stay K-major, their scales shard with their columns. Every rank must
    hold the same whole params (drawn from one seed)."""
    specs = param_shardings(params, mesh)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, s) for v, s in zip(tree, spec))
        return distribute(tree, spec, mesh)

    return walk(params, specs)


def batch_specs(batch, mesh):
    """The ``PartitionSpec`` of each input leaf (the reference's
    ``_batch_shardings`` rule table, ``repro/launch/dryrun.py``): tokens
    over the batch; stub embeddings over batch and embed; a K/V cache
    leaf (k, v, ck, cv, k_s, v_s) over its kv heads where they divide
    the ``model`` axis, else over its length; a Mamba cache over
    d_inner; ``pos`` and the rest replicated (None for a Python int)."""
    def one(name, leaf):
        nd = len(leaf.shape)
        if name == "tokens":
            axes = ("batch",) + (None,) * (nd - 1)
        elif name in ("img_embeds", "frames"):
            axes = ("batch", None, "embed")
        elif name in ("k", "v", "ck", "cv", "k_s", "v_s"):
            kv_heads = leaf.shape[3] if nd >= 4 else leaf.shape[-1]
            divisible = kv_heads % mesh.shape.get("model", 1) == 0
            seq_ax = "kv_seq" if divisible else "cache_len"
            axes = (None, "batch", seq_ax, "kv_heads", None)[:nd]
        elif name == "conv":
            axes = (None, "batch", None, "d_inner")
        elif name == "h":
            axes = (None, "batch", "d_inner", None)
        else:
            axes = (None,) * nd
        return spec_for(leaf.shape, axes, mesh)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, name) for v in tree]
        if not isinstance(tree, torch.Tensor):
            return None                    # a Python int position
        return one(name, tree)

    return walk(batch)


def distribute_inputs(batch, mesh):
    """A prefill's inputs or a decode's ``{"tokens", "cache"}`` placed on
    the model ``mesh`` at ``batch_specs``: every tensor leaf through
    ``distribute``, a Python int (the cache's ``pos``) as it is."""
    specs = batch_specs(batch, mesh)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, s) for v, s in zip(tree, spec)]
        if not isinstance(tree, torch.Tensor):
            return tree
        return distribute(tree, spec, mesh)

    return walk(batch, specs)
