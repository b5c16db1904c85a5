"""The ranks of ``tests/test_torch_shard_dispatch.py`` and
``tests/test_torch_model_mesh.py``: each spawned process joins a gloo
group on the CPU, runs its cases and saves what it got for the test to
hold against the unsharded port (and, for one model, the reference).

This module imports only ``torch``, numpy and ``repro_torch``, so a
spawned rank starts without loading JAX.
"""
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def spawn(fn, world, args, out_dir, join_s):
    """Run ``fn(rank, world, init_file, *args, out_dir)`` on ``world``
    spawned ranks; the pickled results of each rank. A rank that raises,
    or outlasts ``join_s`` seconds (then killed), raises here."""
    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.start_processes(
        fn, args=(world, os.path.join(out_dir, "init")) + tuple(args)
        + (out_dir,), nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + join_s
    try:
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {world}-rank run outlasted "
                                   f"{join_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    got = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            got.append(pickle.load(f))
    return got


def _group(rank, world, init_file):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)


def _save(out_dir, rank, results):
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


# ---------------------------------------------------------------------------
# the sharded fleet routed to its engines


#: the routed fleet: 64 cells of 1-3 users over the Table-5 link mixes
ROUTE_CELLS, ROUTE_USERS = 64, 3
ROUTE_KW = dict(max_new_tokens=2, batch_size=8, prompt_len=12, seed=0)


def route_summary(res):
    """What a route must keep across the mesh: the served requests with
    their tokens, the batches, the per-(tier, variant) counts, the
    decisions, and whether each identity holds exactly."""
    t = res.timings
    slo = res.slo()
    # the wall's residual is computed by subtraction: its sum returns the
    # wall to the float's last bits
    ids = {
        "wall": abs(t["batching_ms"] + t["compute_ms"] + t["dispatch_ms"]
                    - t["wall_ms"]) <= 1e-9 * t["wall_ms"],
        "e2e": all(r.queue_ms + r.measured_ms == r.e2e_ms
                   for r in res.served),
        "slo": slo["measured"]["attained"] + slo["measured"]["violated"]
        == slo["requests"] == len(res.served),
        "slo_tv": all(tv["measured_attained"] + tv["measured_violated"]
                      == tv["dispatched"]
                      for tv in slo["per_tier_variant"].values()),
    }
    if res.bridge is not None:
        b = res.bridge
        ids["bridge"] = (b["served"] + b["shed"]["total"] == b["submitted"]
                         and b["served"] == len(res.served)
                         and b["shed"]["total"] == 0)
    return {
        "served": [(r.cell, r.user, r.action, r.tier, r.variant, r.tokens)
                   for r in res.served],
        "predicted": [r.predicted_ms for r in res.served],
        "batches": res.batches,
        "per_tv": {k: (v["requests"], v["batches"]) for k, v in
                   t["per_tier_variant"].items()},
        "decisions": res.decisions.cpu().numpy(),
        "ids": ids,
        "lat_count": float(res.lat_acc.summary()["e2e_ms"]["count"])
        if hasattr(res.lat_acc, "summary") else None,
    }


def _tiered(api):
    """The oracle whose second user is sent to the edge and third to the
    cloud, so that every tier's engines serve."""
    from repro_torch.fleet import dynamics

    class Tiered(api.OraclePolicy):
        def decisions(self, counts, scen):
            dec = super().decisions(counts, scen)[0].clone()
            dec[:, 1] = dynamics.A_EDGE
            dec[:, 2] = dynamics.A_CLOUD
            return dec, self._ids(dec)
    return Tiered


def route_cases(mesh, device="cpu", engines=None, cells=ROUTE_CELLS,
                seed=11):
    """The unsharded and the sharded route of one mixed Table-5 fleet of
    ``cells`` cells (the oracle at goal 85 for the first user, the edge
    and the cloud for the others), sync and through the
    bridge, on edge-ladder engines: their ``route_summary``s."""
    from repro_torch.configs.base import get_config
    from repro_torch.fleet import api, scenarios
    from repro_torch.launch.serve import build_engines
    from repro_torch.rng import Draws
    from repro_torch.serving.bridge import BridgeConfig
    if engines is None:
        engines = build_engines(get_config("edge-ladder"), max_len=16,
                                device=device)
    scen = scenarios.mixed_table5_fleet(Draws(seed, device), cells,
                                        ROUTE_USERS, min_users=1,
                                        max_users=ROUTE_USERS)
    pol = _tiered(api)(ROUTE_USERS, threshold=85.0)
    out = {}
    for mode in ("sync", "bridge"):
        # queues that hold the whole fleet (nothing shed) and a
        # batch-formation window far longer than the submit loop: the
        # batches (and so the tokens) do not depend on the threads' timing
        bridge = None if mode == "sync" else BridgeConfig(
            max_batch=ROUTE_KW["batch_size"], max_wait_ms=500.0,
            max_queue=cells * ROUTE_USERS, drain_timeout_s=5)
        plain = api.FleetOrchestrator(pol).route(
            scen=scen, dispatch=engines, bridge=bridge, **ROUTE_KW)
        sharded = api.FleetOrchestrator(pol, mesh=mesh).route(
            scen=scen, dispatch=engines, bridge=bridge, **ROUTE_KW)
        out[mode] = {"plain": route_summary(plain),
                     "sharded": route_summary(sharded)}
    return out


def run_route_rank(rank, world, init_file, out_dir):
    """One rank of the routed fleet: both routes, saved."""
    _group(rank, world, init_file)
    try:
        from repro_torch.fleet import shard
        mesh = shard.fleet_mesh(device="cpu")
        _save(out_dir, rank, route_cases(mesh))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the model mesh: sharded prefill and decode against the unsharded port


#: the mesh of the model cases: 4 ranks, (data 2, model 2)
MESH_SHAPE = (2, 2)
BATCH, PROMPT, STEPS = 2, 16, 4

#: name -> (arch, overrides of its reduced config, K/V cache dtype). Every
#: case runs in float32; ``kv_heads`` of PaliGemma (1) is no multiple of
#: the model axis, so its cache is split along its slots
MODEL_CASES = {
    "dense": ("internlm2-20b", {}, "bf16"),
    "dense_window": ("gemma3-4b", {}, "bf16"),
    "moe": ("granite-moe-1b-a400m", {}, "bf16"),
    "moe_int8": ("granite-moe-1b-a400m", {"quant": "int8"}, "bf16"),
    "dense_int8": ("internlm2-20b", {"quant": "int8"}, "bf16"),
    "ssm": ("falcon-mamba-7b", {}, "bf16"),
    "hybrid": ("hymba-1.5b", {}, "bf16"),
    "vlm": ("paligemma-3b", {}, "bf16"),
    "audio": ("whisper-medium", {}, "bf16"),
    "kv_int8": ("internlm2-20b", {}, "int8"),
    "kv_int8_length": ("paligemma-3b", {}, "int8"),
    "vlm_gather_by_sum": ("paligemma-3b", {}, "bf16"),
    "ssm_gather_by_sum": ("falcon-mamba-7b", {}, "bf16"),
}
#: the cases whose gathers are written out as all-reduces (what a gloo
#: group on CUDA tensors takes, ``sharding._gather_by_sum`` patched)
GATHER_BY_SUM_CASES = ("vlm_gather_by_sum", "ssm_gather_by_sum")

#: the sharded seams of ``kernels.ops`` a case is counted through
SEAMS = ("_sharded_flash", "_sharded_decode", "_sharded_int8",
         "_sharded_scan", "_merge_over")


def model_config(name):
    import dataclasses
    from repro_torch.configs.base import get_config, reduced
    arch, over, _ = MODEL_CASES[name]
    return dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                               **over)


def model_batch(cfg, seed=0):
    """The prompt (and a VLM's image / an encoder-decoder's frame stub
    embeddings) of every case, numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(
        np.int32)}
    if cfg.arch_type == "vlm":
        b["img_embeds"] = rng.standard_normal(
            (BATCH, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        b["frames"] = rng.standard_normal(
            (BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return b


def max_len(cfg):
    return PROMPT + STEPS + (cfg.n_img_tokens if cfg.arch_type == "vlm"
                             else 0)


def quantize_cache(cache):
    """A prefill's cache with every ``k``/``v`` quantized per (slot, kv
    head) by the reference decode's rule (``scale = (amax + 1e-8) /
    127``, half to even, clipped to +-127), as ``k``/``v`` int8 with
    float32 ``k_s``/``v_s``."""
    segs = []
    for seg in cache["segments"]:
        c = {}
        for name, leaf in seg.items():
            if name in ("k", "v"):
                kv = leaf.numpy()
                scale = (np.abs(kv).max(-1) + np.float32(1e-8)) \
                    / np.float32(127.0)
                q = np.clip(np.round(kv / scale[..., None]), -127, 127)
                c[name] = torch.from_numpy(q.astype(np.int8))
                c[name + "_s"] = torch.from_numpy(scale.astype(np.float32))
            else:
                c[name] = leaf.clone()
        segs.append(c)
    return {"pos": cache["pos"], "segments": segs}


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _placement_names(tree):
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: _placement_names(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_placement_names(v) for v in tree]
    if isinstance(tree, DTensor):
        return tuple(repr(p) for p in tree.placements)
    return None


def run_model_case(name, mesh, params=None):
    """One case: the prefill and ``STEPS`` greedy decode steps unsharded,
    then the same (the unsharded run's tokens fed) on ``mesh``. Returns
    the logits of both (float32 numpy, the sharded ones assembled
    whole), the placements of the decode cache and of the params, and
    how often each sharded seam of ``kernels.ops`` ran."""
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    cfg = model_config(name)
    kv = MODEL_CASES[name][2]
    model = build_model(cfg)
    if params is None:
        params = model.init(0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in model_batch(cfg).items()}
    n = max_len(cfg)
    lg, cache = model.prefill(params, batch, max_len=n)
    if kv == "int8":
        cache = quantize_cache(cache)
    start = _copy(cache)
    plain, toks = [lg.numpy().copy()], []
    for _ in range(STEPS):
        tok = lg[:, -1:, :cfg.vocab_size].argmax(-1).to(torch.int32)
        toks.append(tok)
        lg, cache = model.decode(params, cache, tok)
        plain.append(lg.numpy().copy())
    counts = dict.fromkeys(SEAMS, 0)
    saved = {k: getattr(ops, k) for k in SEAMS}

    def counted(k):
        def fn(*a, **kw):
            counts[k] += 1
            return saved[k](*a, **kw)
        return fn
    for k in SEAMS:
        setattr(ops, k, counted(k))
    gather_by_sum = sharding._gather_by_sum
    if name in GATHER_BY_SUM_CASES:
        sharding._gather_by_sum = lambda x: True
    try:
        with sharding.model_mesh(mesh):
            p = sharding.distribute_params(params, mesh)
            b = sharding.distribute_inputs(batch, mesh)
            lg, cache = model.prefill(p, b, max_len=n)
            sharded = [lg.full_tensor().numpy().copy()]
            if kv == "int8":
                cache = sharding.distribute_inputs(start, mesh)
            for tok in toks:
                t = sharding.distribute_inputs({"tokens": tok},
                                               mesh)["tokens"]
                lg, cache = model.decode(p, cache, t)
                sharded.append(lg.full_tensor().numpy().copy())
    finally:
        sharding._gather_by_sum = gather_by_sum
        for k in SEAMS:
            setattr(ops, k, saved[k])
    return {"plain": plain, "sharded": sharded, "counts": counts,
            "cache": _placement_names(cache["segments"]),
            "params": _placement_names(p),
            "tokens": [t.numpy() for t in toks]}


def run_model_rank(rank, world, init_file, payload, out_dir):
    """One rank of the model mesh: every case (params from the payload
    where it carries them), saved."""
    _group(rank, world, init_file)
    try:
        from repro_torch.launch.mesh import make_mesh
        with open(payload, "rb") as f:
            carried = pickle.load(f)
        mesh = make_mesh(MESH_SHAPE, device_type="cpu")
        out = {}
        for name in MODEL_CASES:
            params = carried.get(name)
            if params is not None:
                from repro_torch import convert
                params = convert.model_params(params, model_config(name),
                                              device="cpu")
            out[name] = run_model_case(name, mesh, params)
        _save(out_dir, rank, out)
    finally:
        dist.destroy_process_group()
