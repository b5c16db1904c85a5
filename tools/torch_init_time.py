#!/usr/bin/env python3
"""Time the PyTorch port's weight init of the served state-space models,
drawn on the host and drawn on the card.

    python3 tools/torch_init_time.py

For Falcon-Mamba-7B d0 (bf16) and d4 (int8 projections) and Hymba-1.5B
d0, each at its full published size and with the seed ``build_engines``
gives it, one JSON line with

* ``card_s``: ``Model.init(seed, device="cuda")``, every weight drawn by
  a generator on the card (what ``build_engines`` does);
* ``host_s``: ``Model.init(seed, device="cpu")``, every weight drawn by a
  CPU generator, and ``copy_s``: moving those params to the card (the
  two together are the draw-on-the-host-then-copy alternative);
* ``host_gb``: the bytes of params held on the host before the copy, and
  ``max_rss_gb``: the process's peak resident memory so far.

The card's name and power limit (``nvidia-smi``) come first. Needs a
CUDA device and the ``src/repro_torch`` package beside it.
"""
import gc
import json
import os
import resource
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = (("falcon-mamba-7b", "d0"), ("falcon-mamba-7b", "d4"),
         ("hymba-1.5b", "d0"))


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_bytes(tree):
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_init_time: no CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import variant_seed
    from repro_torch.models import build_model
    from repro_torch.models.variants import build_ladder

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    for arch, vid in CASES:
        cfg = build_ladder(get_config(arch))[vid].cfg
        model = build_model(cfg)
        seed = variant_seed(0, vid)
        params, card_s = timed(torch, lambda: model.init(seed, "cuda"))
        del params
        gc.collect()
        torch.cuda.empty_cache()
        params, host_s = timed(torch, lambda: model.init(seed, "cpu"))
        host_gb = tree_bytes(params) / 1e9
        moved, copy_s = timed(torch, lambda: tree_map(
            lambda t: t.to("cuda"), params))
        del params, moved
        gc.collect()
        torch.cuda.empty_cache()
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        print(json.dumps(dict(
            arch=arch, variant=vid, quant=cfg.quant,
            params=cfg.param_count(), card_s=card_s, host_s=host_s,
            copy_s=copy_s, host_gb=host_gb, max_rss_gb=rss / 1e9,
            host_threads=torch.get_num_threads())), flush=True)


if __name__ == "__main__":
    main()
