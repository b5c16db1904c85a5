#!/usr/bin/env python3
"""Time the port's attention kernels (K3 flash attention, K4 decode
attention, P2 the attention backward) of one or more source trees, in
turns, on one card.

    python3 tools/attention_ab.py SRC [SRC ...]

Each ``SRC`` is a directory holding a ``repro_torch`` package (``src``
of this checkout, or of another commit unpacked with ``git archive``).
Each runs in its own process, in the order given, so a change and its
parent compare within one call as parent, change, change, parent:

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    python3 tools/attention_ab.py build/parent/src src src build/parent/src

For every bf16 case of ``chip_smoke.py``'s ``FLASH_CASES`` (causal, with
its window) and ``DECODE_CASES`` (a random 30% of slots masked by the
bias), and of its dense, VLM and encoder-decoder paths' cases without a
soft-cap (``DENSE_*``, ``VLM_*``, ``AUDIO_*``: head_dim 64-256, Sq and
Skv apart, no causal mask), one JSON line per tree: ``{"src": ...,
"<kernel> <layout> <S>": [warm ms, cold ms, max abs error against the
plain version]}``; warm and
cold as ``chip_smoke.timed`` and ``chip_smoke.cold_ms`` take them (CUDA
events with the launch hidden, ``hidden_ms``; cold with the L2 flushed
before each call).
For every bf16 case of ``BWD_CASES`` the line also holds
``"flash_attention_backward <layout>": [warm ms, cold ms, max abs error
against plain_backward, plain ms, library ms]``, the library being
SDPA's backward alone (a capped case compiled ``flex_attention``'s), as
``chip_smoke.attention_backward`` times them.
End to end, the same line holds ``"serving <variant> decode ms/token"``
and ``"serving <variant> prefill ms"`` for the edge ladder's d0 and d4,
each a list of ``REPS`` readings of ``chip_smoke.timed_generate`` (host
clock, batch 64, prompt 256, 16 new tokens, cache 512, as in the
``serving`` phase), and ``"lm_training_step ms"``: ``REPS`` training
steps of Granite-3.0-1B-A400M whole at 8 x 2,048 (host clock around
synchronised steps after one warm-up step, seed 0, one random batch),
as the ``lm_training_step`` phase takes them. The card's name and power
limit (``nvidia-smi``) come first. Needs a CUDA device; each tree's
kernels are built into its own ``build`` directory.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 5


def load_tree(src):
    """``chip_smoke`` and ``torch`` with the ``repro_torch`` package of
    ``src`` importable, after building that tree's serving kernels (K3,
    K4, K5) into its own ``build`` directory. Exits without a card."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(src))
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_matmul as im
    if not torch.cuda.is_available():
        sys.exit(f"{os.path.basename(sys.argv[0])}: no CUDA device "
                 "available")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build([fa.KERNEL, fa.BACKWARD, da.KERNEL, im.KERNEL])
    return torch, cs


def run_tree(src):
    torch, cs = load_tree(src)
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(0)

    def reading(f, want):
        err = float((f().float() - want.float()).abs().max())
        ms, _, _ = cs.timed(f)
        return [ms, cs.cold_ms(f), err]
    out = {"src": src}
    for case in (cs.FLASH_CASES + cs.DENSE_FLASH_CASES + cs.VLM_FLASH_CASES
                 + cs.AUDIO_FLASH_CASES):
        name, b, s, skv, h, kv, hd, w, causal, _ = case
        q, k, v = (torch.randn(shape, generator=g, device="cuda").bfloat16()
                   for shape in ((b, s, h, hd), (b, skv, kv, hd),
                                 (b, skv, kv, hd)))
        out[f"flash_attention {name} {s}"] = reading(
            lambda: fa.flash_attention_cuda(q, k, v, causal=causal,
                                            window=w),
            fa.plain(q, k, v, causal=causal, window=w))
    for name, b, sc, h, kv, hd, *_ in (
            cs.DECODE_CASES + cs.DENSE_DECODE_CASES + cs.VLM_DECODE_CASES
            + tuple(c for c in cs.AUDIO_DECODE_CASES if not c[-1])):
        q = torch.randn((b, h, hd), generator=g, device="cuda").bfloat16()
        kc, vc = (torch.randn((b, sc, kv, hd), generator=g, device="cuda")
                  .bfloat16() for _ in range(2))
        bias = torch.where(torch.rand((b, sc), generator=g, device="cuda")
                           < 0.3, -1e30, 0.0)
        out[f"decode_attention {name} {sc}"] = reading(
            lambda: da.decode_attention_cuda(q, kc, vc, bias),
            da.plain(q, kc, vc, bias))
    backward(torch, cs, fa, g, out)
    serving(torch, cs, out)
    lm_step(torch, cs, out)
    print(json.dumps(out), flush=True)


def backward(torch, cs, fa, g, out):
    """P2 at every ``BWD_CASES`` case in bf16: warm and cold ms, its
    error against ``plain_backward``, the plain version's ms and the
    library's backward ms."""
    for name, b, sq, skv, h, kv, hd, window, causal, cap in cs.BWD_CASES:
        kw = dict(causal=causal, window=window, softcap=cap)
        q, k, v, do = (torch.randn(shape, generator=g, device="cuda")
                       .bfloat16() for shape in ((b, sq, h, hd),
                                                 (b, skv, kv, hd),
                                                 (b, skv, kv, hd),
                                                 (b, sq, h, hd)))
        o, lse = fa.flash_attention_cuda(q, k, v, lse=True, **kw)

        def call():
            return fa.flash_attention_backward_cuda(q, k, v, o, lse, do,
                                                    **kw)

        def plain():
            return fa.plain_backward(q, k, v, o, lse, do, **kw)
        err = max(float((x.float() - y.float()).abs().max())
                  for x, y in zip(call(), plain()))
        lib = (cs.flex_backward(torch, q, k, v, do, cap, causal, window)
               if cap else cs.sdpa_backward(torch, q, k, v, do, causal,
                                            window))
        out[f"flash_attention_backward {name}"] = [
            cs.hidden_ms(call, reps=10), cs.cold_ms(call, reps=5), err,
            cs.hidden_ms(plain, reps=3), cs.hidden_ms(lib, reps=10)]
        del q, k, v, do, o, lse, lib
        cs.free_card(torch)


def lm_step(torch, cs, out):
    """``REPS`` training steps of ``chip_smoke.MOE_ARCH`` whole at
    ``LM_BATCH`` x ``LM_SEQ``, host clock around each synchronised step."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, init_state, make_train_step
    cfg = get_config(cs.MOE_ARCH)
    model = build_model(cfg)
    state = init_state(model, 0, device="cuda")
    step = make_train_step(model, AdamWConfig(lr=3e-4, warmup_steps=2,
                                              total_steps=20))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (cs.LM_BATCH, cs.LM_SEQ)).astype(np.int32)
    batch = {"tokens": torch.tensor(tokens, device="cuda")}
    state, _ = step(state, batch)
    walls = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["lm_training_step ms"] = walls
    del state, step, model
    cs.free_card(torch)


def serving(torch, cs, out, arch="edge-ladder", variants=("d0", "d4"),
            label="serving"):
    """Variants of ``arch`` at full size served end to end, ``REPS``
    times each (batch 64, prompt 256, 16 new tokens, cache 512)."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import build_engines
    engines = build_engines(get_config(arch), variants=variants,
                            max_len=cs.MAX_LEN, device="cuda")
    rng = np.random.default_rng(0)
    for vid in variants:
        eng = engines["S"][vid]
        toks = rng.integers(0, eng.model.cfg.vocab_size,
                            (cs.SERVE_BATCH, cs.PROMPT)).astype(np.int32)
        runs = [cs.timed_generate(torch, eng, toks, cs.MAX_LEN)
                for _ in range(REPS)]
        out[f"{label} {vid} prefill ms"] = [r[1] for r in runs]
        out[f"{label} {vid} decode ms/token"] = [r[2] for r in runs]


def turns(script, run, timeout=900):
    """The entry point of an A/B tool: ``script --tree SRC`` calls
    ``run(SRC)``; ``script SRC [SRC ...]`` prints the card's name and
    power limit, then runs each tree in its own process, in order."""
    if len(sys.argv) > 2 and sys.argv[1] == "--tree":
        run(sys.argv[2])
        return
    if len(sys.argv) < 2:
        sys.exit(sys.modules["__main__"].__doc__)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    for src in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(script), "--tree",
                        src], check=True, timeout=timeout)


if __name__ == "__main__":
    turns(__file__, run_tree)
