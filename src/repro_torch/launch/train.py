"""Training launcher — the port of ``repro/launch/train.py``: real steps
of a config's language model on one device (the card by default, the
CPU with ``--device cpu``), on the synthetic Markov token stream
(``training.data.batches``), printing the reference's lines.

    python -m repro_torch.launch.train --arch granite-moe-1b-a400m \\
        --steps 20 --batch 8 --seq 2048
    python -m repro_torch.launch.train --arch gemma-7b --reduced \\
        --steps 20 --batch 8 --seq 128 --device cpu

A ``vlm`` config's batches carry seeded stub image embeddings
(``img_embeds``) and an encoder-decoder's seeded stub frames
(``frames``), as the reference's do. The params start from ``seed`` 0
on the device (``Model.init``); ``--save PATH`` writes them with
``checkpoint.save_pytree`` (``PATH.npz`` and ``PATH.json``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import save_pytree
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import build_model
from repro_torch.training import AdamWConfig, init_state, make_train_step
from repro_torch.training.data import batches


def extras_of(cfg) -> dict:
    """The stub modality inputs a config's batches carry, as the
    reference's launcher makes them (each call the same seeded draw)."""
    extras = {}
    if cfg.arch_type == "vlm":
        extras["img_embeds"] = lambda b: np.random.default_rng(0) \
            .standard_normal((b, cfg.n_img_tokens, cfg.d_model),
                             dtype=np.float32)
    if cfg.is_encdec:
        extras["frames"] = lambda b: np.random.default_rng(0) \
            .standard_normal((b, cfg.enc_seq, cfg.d_model), dtype=np.float32)
    return extras


def to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device`` (tokens int32, embeddings
    float32, as the reference stages them)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def main(argv=None) -> dict:
    """Train and print the reference's lines. Returns what a script
    driving the launcher reads afterwards: ``state`` (params and
    optimizer state, trained), ``step_fn``, the last ``batch`` on the
    device, ``seconds`` (the loop's wall, data included) and the
    ``model``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="2-layer smoke config (CPU)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--save", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = build_model(cfg)
    state = init_state(model, 0, device=dev)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                          total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg)

    t0 = time.perf_counter()
    b = None
    for i, nb in enumerate(batches(cfg.vocab_size, args.batch, args.seq,
                                   args.steps, extras=extras_of(cfg))):
        b = to_device(nb, dev)
        state, metrics = step_fn(state, b)
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss {float(metrics['loss']):8.4f} "
                  f"gnorm {float(metrics['grad_norm']):8.3f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({args.steps * args.batch * args.seq / dt:.0f} tok/s)")
    if args.save:
        save_pytree(args.save, state["params"])
        print("saved", args.save)
    return {"state": state, "step_fn": step_fn, "batch": b, "seconds": dt,
            "model": model}


if __name__ == "__main__":
    main()
