#!/usr/bin/env python3
"""Margins of the port's bf16 attention checks on several seeds, on one
card.

    python3 tools/attention_margin.py [SEED ...]        (default 5 6 7 8)

For each seed, two readings, one JSON line each:

- ``flash``: K3's max abs error against its plain version at every case
  of ``chip_smoke.py``'s ``FLASH_CASES``, in bf16 and float32, the inputs
  drawn as ``chip_smoke.flash_phase`` draws them from that seed (seed 5
  is ``flash_phase``'s own draw), beside ``ATTN_TOL``.
- ``hybrid_cut``: ``chip_smoke.hybrid_cut_agreement`` (Hymba-1.5B d0 cut
  to one global and one sliding layer at full width, the prompt past the
  window; card against CPU) on the weights of ``build_engines(...,
  seed=SEED - 5)``, so seed 5 gives ``chip_smoke``'s own weights. It
  reports the max abs logits error and ``logits_limit_share``, max |a -
  b| / (0.125 + 0.01 |b|): 1.0 is at the limit. A seed that fails the
  check prints its message instead.

The card's name and power limit (``nvidia-smi``) come first. Needs a CUDA
device.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flash_errors(torch, cs, fa, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, b, s, _, h, kv, hd, window, _, _ in cs.FLASH_CASES:
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q, k, v = (torch.randn(shape, generator=g, device="cuda")
                       .to(dt) for shape in ((b, s, h, hd), (b, s, kv, hd),
                                             (b, s, kv, hd)))
            got = fa.flash_attention_cuda(q, k, v, window=window)
            want = fa.plain(q, k, v, window=window)
            out[f"{name} {s} {dtype}"] = float(
                (got.float() - want.float()).abs().max())
    return out


def main():
    seeds = [int(a) for a in sys.argv[1:]] or [5, 6, 7, 8]
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, cs.SRC)
    import torch
    if not torch.cuda.is_available():
        sys.exit("attention_margin: no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.launch.serve import build_engines
    from repro_torch.models import build_model
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    _build.build([fa.KERNEL, da.KERNEL, ss.KERNEL])
    for seed in seeds:
        errs = flash_errors(torch, cs, fa, seed)
        print(json.dumps({"reading": "flash", "seed": seed,
                          "tolerance": cs.ATTN_TOL, "max_abs_err": errs}),
              flush=True)
    hymba = get_config(cs.HYBRID_ARCH)
    for seed in seeds:
        eng = build_engines(hymba, variants=("d0",), max_len=cs.HYBRID_MAX_LEN,
                            device="cuda", seed=seed - 5)["S"]["d0"]
        try:
            line = cs.hybrid_cut_agreement(torch, eng, build_model)
            line = {k: line[k] for k in ("logits_max_abs_err",
                                         "logits_limit_share",
                                         "clear_margin_tokens",
                                         "tokens_equal")}
        except AssertionError as e:
            line = {"failed": str(e)}
        print(json.dumps({"reading": "hybrid_cut", "seed": seed, **line}),
              flush=True)
        del eng
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
