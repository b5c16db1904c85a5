"""Dry run: every (arch x input shape) pair traced once, on the target
device, for the roofline — the port of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --both-meshes --out results/dryrun_torch.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
        --arch gemma3-4b --shape decode_32k --tune kv_cache_dtype=int8

The reference lowers and compiles each pair on 512 placeholder host
devices and reads XLA's cost and memory analyses. The port has no
compiler to ask: it traces the pair's call once under
``FakeTensorMode`` (``obs.prof.profile_fn``), with fake parameters and
inputs on the target device, so nothing is allocated and no kernel
launches (DBRX-132B needs no memory). The port runs its layers in a
Python loop, so the one trace counts every layer: the reference's
second, unrolled compile has no counterpart. The hand-written kernels
record their own costs and allocations in the trace (``kernels.ops``).

On a mesh of n devices (``launch.mesh``, built over a placeholder
process group of 512 ranks as the reference forces 512 host devices), a
prefill or decode row is one device's, from a trace of the pair on that
mesh: the params placed by ``distributed.sharding.distribute_params``,
the inputs and the cache by ``distribute_inputs``, the model run under
``sharding.model_mesh`` (DTensors, the reference's annotations, the
kernels on local shards), and ``obs.prof.profile_fn`` counting the local
ops (``"split": "sharded"``):

* ``arg_bytes_per_device``: exact, each leaf's local shard under
  ``param_shardings`` and ``batch_specs`` (the traced local shards' bytes
  are checked equal to it, ``arg_bytes_traced``);
* ``flops_per_device``, ``bytes_per_device``, ``out_bytes_per_device``
  and ``temp_bytes_per_device`` (peak live bytes less the arguments) from
  the local trace;
* ``collectives`` (wire bytes by kind, the reference's ring factors:
  all-reduce 2, the rest 1), ``collective_bytes_per_device`` and
  ``collective_s`` at one NVLink's rate (``launch.mesh``);
* the terms against the H100's data-sheet peaks (``launch.mesh``):
  ``compute_s``, ``memory_s``, ``useful_flops_ratio`` (model flops over
  traced flops) and ``dominant`` (of compute, memory and collective).

A train row still traces one device once for both meshes and splits its
totals ideally over n (``"split": "ideal"``, ``collective_s`` null, its
``note`` naming the slice that shards the training step).

A train pair is ``training.make_train_step(model, AdamWConfig(),
remat=True)`` over ``init_state``; a prefill pair ``Model.prefill``; a
decode pair ``Model.decode`` over ``input_specs``' cache, at position
``seq_len - 1`` (every slot of the cache written once).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW_PER_LINK,
                                     PEAK_BF16_FLOPS, make_production_mesh,
                                     placeholder_group)
from repro_torch.models import build_model
from repro_torch.obs.prof import profile_fn

# skip list: pure full-attention archs have no sub-quadratic path for a
# 524k decode
LONG_CTX_OK = {"gemma3-4b", "hymba-1.5b", "falcon-mamba-7b"}

NOTE = ("collectives: not counted; the training step runs on one "
        "device's trace split ideally until it runs under the model mesh "
        "(the next slice: Model.loss, P2 and P3 through local_map, AdamW "
        "on DTensors)")
SHARDED_NOTE = ("one device's trace on the mesh: local ops, the kernels' "
                "local costs, collectives at one NVLink's rate")


def model_flops(cfg, shape) -> tuple:
    """(tokens, model flops) of one call: 6 N tokens for a training step,
    2 N tokens for a prefill, 2 N per sequence for a decode step, N the
    active parameters (the reference's arithmetic)."""
    if shape.kind == "train":
        n_tok = shape.global_batch * shape.seq_len
        return n_tok, 6.0 * cfg.active_param_count() * n_tok
    if shape.kind == "prefill":
        n_tok = shape.global_batch * shape.seq_len
        return n_tok, 2.0 * cfg.active_param_count() * n_tok
    n_tok = shape.global_batch            # one token per sequence
    return n_tok, 2.0 * cfg.active_param_count() * n_tok


def _materialise(spec, device):
    """``input_specs``' meta tree as empty tensors on ``device`` (fakes
    under a fake mode)."""
    if isinstance(spec, dict):
        return {k: _materialise(v, device) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_materialise(v, device) for v in spec]
    return torch.empty(spec.shape, dtype=spec.dtype, device=device)


def build_lowerable(arch: str, shape, *, device=None):
    """Returns (fn, args, meta) of one pair: ``shape`` an ``INPUT_SHAPES``
    name or an ``InputShape``; ``args`` made under a new
    ``FakeTensorMode`` on ``device`` — fakes, so nothing is allocated;
    ``meta`` the reference's row head (arch, shape, kind, params, active
    params, tokens, model flops)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.training import (AdamWConfig, init_state,
                                      make_train_step)
    dev = resolve_device(device)
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    cfg = get_config(arch)
    model = build_model(cfg)
    with FakeTensorMode(allow_non_fake_inputs=True):
        spec = model.input_specs(shape)
        if shape.kind == "train":
            fn = make_train_step(model, AdamWConfig(), remat=True)
            args = (init_state(model, 0, device=dev),
                    _materialise(spec, dev))
        elif shape.kind == "prefill":
            def fn(params, batch):
                return model.prefill(params, batch)
            args = (model.init(0, device=dev), _materialise(spec, dev))
        else:
            def fn(params, batch):
                return model.decode(params, batch["cache"], batch["tokens"])
            batch = _materialise(spec, dev)
            batch["cache"]["pos"] = shape.seq_len - 1
            args = (model.init(0, device=dev), batch)
    n_tok, flops = model_flops(cfg, shape)
    meta = {"arch": arch, "shape": shape.name, "kind": shape.kind,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(), "tokens": n_tok,
            "model_flops": flops}
    return fn, args, meta


def arg_specs(args, kind: str, mesh):
    """The spec tree of a pair's arguments on ``mesh``: the params (and
    a train step's moments, which shard as their params) by
    ``param_shardings``, the inputs by ``batch_specs``."""
    if kind == "train":
        state, batch = args
        opt = state["opt"]
        return ({"params": sharding.param_shardings(state["params"], mesh),
                 "opt": {"m": sharding.param_shardings(opt["m"], mesh),
                         "v": sharding.param_shardings(opt["v"], mesh),
                         "step": None}},
                sharding.batch_specs(batch, mesh))
    params, batch = args
    return (sharding.param_shardings(params, mesh),
            sharding.batch_specs(batch, mesh))


def shard_bytes(shape, spec, mesh, itemsize: int) -> int:
    """Bytes of one device's shard of a ``shape`` leaf under ``spec``."""
    n = math.prod(shape)
    for entry in spec or ():
        for axis in (entry if isinstance(entry, tuple) else
                     (() if entry is None else (entry,))):
            n //= mesh.shape[axis]
    return n * itemsize


def arg_bytes_per_device(args, specs, mesh) -> int:
    """Bytes of one device's shards of every tensor leaf of ``args``."""
    if isinstance(args, dict):
        return sum(arg_bytes_per_device(args[k], specs[k], mesh)
                   for k in args)
    if isinstance(args, (list, tuple)):
        return sum(arg_bytes_per_device(a, s, mesh)
                   for a, s in zip(args, specs))
    if not isinstance(args, torch.Tensor):
        return 0
    return shard_bytes(tuple(args.shape), specs, mesh, args.element_size())


def roofline_row(prof, meta, args, mesh, label: str, seconds: float):
    """The reference's row of one pair on ``mesh`` from its trace."""
    n_dev = mesh.size
    flops_dev = prof.flops / n_dev
    bytes_dev = prof.bytes_accessed / n_dev
    row = dict(meta)
    row.update(
        mesh=label, n_devices=n_dev, ok=True, seconds=round(seconds, 1),
        flops_per_device=flops_dev, bytes_per_device=bytes_dev,
        collective_bytes_per_device=None, collectives=None,
        compute_s=flops_dev / PEAK_BF16_FLOPS, memory_s=bytes_dev / HBM_BW,
        collective_s=None,
        model_flops_per_device=meta["model_flops"] / n_dev,
        useful_flops_ratio=(meta["model_flops"] / n_dev)
        / max(flops_dev, 1.0),
        arg_bytes_per_device=arg_bytes_per_device(
            args, arg_specs(args, meta["kind"], mesh), mesh),
        temp_bytes_per_device=(prof.peak_live_bytes - prof.arg_bytes)
        / n_dev,
        out_bytes_per_device=prof.out_bytes / n_dev,
        split="ideal", note=NOTE, device=prof.backend,
        peak_live_bytes=prof.peak_live_bytes)
    terms = {"compute": row["compute_s"], "memory": row["memory_s"]}
    row["dominant"] = max(terms, key=terms.get)
    return row


def place_args(args, mesh):
    """A prefill or decode pair's (params, batch) placed on ``mesh``: the
    params at ``param_shardings``, the inputs and cache at
    ``batch_specs``, each leaf this device's shard (fakes stay fakes)."""
    from torch._guards import detect_fake_mode
    from torch.utils._pytree import tree_leaves
    params, batch = args
    with detect_fake_mode(tree_leaves(params)):
        return (sharding.distribute_params(params, mesh),
                sharding.distribute_inputs(batch, mesh))


def on_mesh(fn, mesh):
    """``fn`` run under ``sharding.model_mesh(mesh)``."""
    def call(*args):
        with sharding.model_mesh(mesh):
            return fn(*args)
    return call


def sharded_row(prof, meta, args, mesh, label: str, seconds: float):
    """The reference's row of a prefill or decode pair on ``mesh`` from
    one device's trace of it there (``place_args``, ``on_mesh``)."""
    n_dev = mesh.size
    coll = {k: float(v) for k, v in prof.collectives.items()}
    coll_dev = float(sum(coll.values()))
    row = dict(meta)
    row.update(
        mesh=label, n_devices=n_dev, ok=True, seconds=round(seconds, 1),
        flops_per_device=prof.flops, bytes_per_device=prof.bytes_accessed,
        collective_bytes_per_device=coll_dev, collectives=coll,
        compute_s=prof.flops / PEAK_BF16_FLOPS,
        memory_s=prof.bytes_accessed / HBM_BW,
        collective_s=coll_dev / NVLINK_BW_PER_LINK,
        model_flops_per_device=meta["model_flops"] / n_dev,
        useful_flops_ratio=(meta["model_flops"] / n_dev)
        / max(prof.flops, 1.0),
        arg_bytes_per_device=arg_bytes_per_device(
            args, arg_specs(args, meta["kind"], mesh), mesh),
        arg_bytes_traced=prof.arg_bytes,
        temp_bytes_per_device=prof.peak_live_bytes - prof.arg_bytes,
        out_bytes_per_device=prof.out_bytes,
        split="sharded", note=SHARDED_NOTE, device=prof.backend,
        peak_live_bytes=prof.peak_live_bytes)
    terms = {"compute": row["compute_s"], "memory": row["memory_s"],
             "collective": row["collective_s"]}
    row["dominant"] = max(terms, key=terms.get)
    return row


def _label(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_one(arch: str, shape_name: str, multi_pod=False, *, device=None,
            verbose: bool = True):
    """The pair's row on the 16 x 16 mesh, or the 2 x 16 x 16 one with
    ``multi_pod``; with a tuple of bools, a list of rows, one a mesh,
    from the one trace. A failed pair gives ``ok: False`` rows."""
    meshes = multi_pod if isinstance(multi_pod, tuple) else (multi_pod,)
    rows = []
    try:
        t0 = time.time()
        fn, args, meta = build_lowerable(arch, shape_name, device=device)
        name = f"{arch}/{shape_name}"
        dev_type = resolve_device(device).type
        if meta["kind"] == "train":
            prof = profile_fn(fn, *args, name=name)
            secs = time.time() - t0
        with placeholder_group():
            for mp in meshes:
                mesh = make_production_mesh(multi_pod=mp,
                                            device_type=dev_type)
                if meta["kind"] == "train":
                    rows.append(roofline_row(prof, meta, args, mesh,
                                             _label(mp), secs))
                    continue
                t1 = time.time()
                placed = place_args(args, mesh)
                prof = profile_fn(on_mesh(fn, mesh), *placed, name=name)
                rows.append(sharded_row(prof, meta, args, mesh, _label(mp),
                                        time.time() - t1))
    except Exception as e:  # noqa: BLE001 - a failed pair is a row
        if verbose:
            print(f"[FAIL] {arch} {shape_name}: {e}", flush=True)
            traceback.print_exc()
        rows = [{"arch": arch, "shape": shape_name, "mesh": _label(mp),
                 "ok": False, "error": str(e)[:2000]} for mp in meshes]
    if verbose:
        for r in rows:
            if r["ok"]:
                coll = r["collective_s"]
                print(f"[OK] {arch:22s} {shape_name:12s} {r['mesh']:7s} "
                      f"compute={r['compute_s'] * 1e3:9.2f}ms "
                      f"memory={r['memory_s'] * 1e3:9.2f}ms "
                      + ("coll=      n/a  " if coll is None else
                         f"coll={coll * 1e3:9.2f}ms ")
                      + f"dom={r['dominant']:10s} "
                      f"useful={r['useful_flops_ratio']:.2f} "
                      f"args={r['arg_bytes_per_device'] / 2**30:.2f}GiB "
                      f"temp={r['temp_bytes_per_device'] / 2**30:.2f}GiB "
                      f"({r['seconds']}s)", flush=True)
    return rows if isinstance(multi_pod, tuple) else rows[0]


def pairs(include_long_skips=False):
    for arch in ARCH_IDS:
        for shape in INPUT_SHAPES:
            if shape == "long_500k" and arch not in LONG_CTX_OK:
                if include_long_skips:
                    yield arch, shape, "skip"
                continue
            yield arch, shape, "run"


def apply_tune(spec: str) -> dict:
    """Set ``tuning.FLAGS`` from comma-separated ``k=v`` pairs, each
    value cast to the flag's type; a key the port has no flag for is
    refused."""
    from repro_torch.tuning import FLAGS
    for kv in spec.split(","):
        k, v = kv.split("=")
        if k not in FLAGS:
            raise SystemExit(
                f"--tune {k}: the port has no such flag (it has "
                f"{sorted(FLAGS)}); the reference's attn_chunk, "
                "donate_cache and mamba_chunk have no reader here "
                "(repro_torch/tuning.py says why)")
        cur = FLAGS[k]
        if isinstance(cur, bool):
            FLAGS[k] = v in ("1", "True", "true")
        elif isinstance(cur, int):
            FLAGS[k] = int(v)
        elif isinstance(cur, float):
            FLAGS[k] = float(v)
        else:
            FLAGS[k] = v
    return dict(FLAGS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="append jsonl results here")
    ap.add_argument("--tune", default=None,
                    help="comma k=v tuning flags (repro_torch.tuning.FLAGS)")
    ap.add_argument("--hlo-dir", default=None,
                    help="no counterpart: the port traces under "
                    "FakeTensorMode and compiles no HLO to save")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (default cuda)")
    args = ap.parse_args(argv)
    if args.hlo_dir:
        ap.error("--hlo-dir has no counterpart in the port: it traces "
                 "under FakeTensorMode and compiles no HLO")
    if args.tune:
        print("tuning:", apply_tune(args.tune), flush=True)
    if args.all:
        todo = [(a, s) for a, s, status in pairs() if status == "run"]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        todo = [(args.arch, args.shape)]
    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    results = []
    for arch, shape in todo:
        rows = run_one(arch, shape, meshes, device=args.device)
        results.extend(rows)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                for r in rows:
                    f.write(json.dumps(r) + "\n")
    n_ok = sum(bool(r.get("ok")) for r in results)
    print(f"\n{n_ok}/{len(results)} traced OK", flush=True)
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
