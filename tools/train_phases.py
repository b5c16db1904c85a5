#!/usr/bin/env python3
"""The training phases of ``chip_smoke.py`` alone, on one card.

    python3 tools/train_phases.py [bwd] [scan] [agree] [ssm] [lm]
                                                     (default: all five)

Builds the kernels the training path and its checks run (K3 with its
``kLse`` instances, P2, K4, K5, K6 with its ``kStates`` instances, P3),
then runs, one JSON line each as the smoke prints them:

- ``bwd``: ``chip_smoke.attention_backward`` (K3's ``kLse`` instances and
  P2 against their plain versions at ``BWD_CASES``, bf16 timed beside
  SDPA's or compiled ``flex_attention``'s backward), then its kernels-line
  entry; then the registers and spills of every instance of P2's
  kernels that ``nvcc`` compiled (``p2_instances``: every head dim,
  capped or not, both dtypes, the D kernel too), and P2's device ms by
  kernel (D, dK/dV, dQ) at every bf16 ``BWD_CASES`` case from one
  ``torch.profiler`` window of 5 calls (``p2_by_kernel``);
- ``scan``: ``chip_smoke.scan_backward`` (K6's ``kStates`` instance and
  P3 against their plain versions at ``SCAN_BWD_CASES``, bf16 timed), then
  its kernels-line entry;
- ``agree``: ``chip_smoke.training_cpu_agreement`` (one training step
  card vs CPU on the edge ladder, a 2-layer Granite cut, Whisper's 2+2
  cut, a 2-layer Falcon-Mamba cut and Hymba's layers 0 and 1);
- ``ssm``: ``chip_smoke.ssm_training`` (``launch.train`` on Hymba-1.5B
  whole, 20 steps at 8 x 2,048, a step's profile), then its launches;
- ``lm``: ``chip_smoke.lm_training`` (``launch.train`` on
  Granite-3.0-1B-A400M whole, 20 steps at 8 x 2,048, a step's profile,
  the ``"dots"`` policy, ``--save`` read back), then its launches.

The card's name and power limit (``nvidia-smi``) come last. Needs a CUDA
device.
"""
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(which):
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch
    if not torch.cuda.is_available():
        sys.exit("train_phases: no CUDA device available")
    sys.path.insert(0, cs.SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import training, tuning
    from repro_torch.checkpoint import load_pytree
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import (_build, decode_attention,
                                     flash_attention, int8_matmul,
                                     selective_scan)
    from repro_torch.launch import train as train_cli
    from repro_torch.models import build_model
    kernels = [flash_attention.KERNEL, flash_attention.BACKWARD,
               decode_attention.KERNEL, int8_matmul.KERNEL,
               selective_scan.KERNEL, selective_scan.BACKWARD]
    cs.emit(phase="build", seconds=_build.build(kernels))
    if "bwd" in which:
        ptxas = cs.ptxas_summary(flash_attention.BACKWARD.ptxas_log)
        print(json.dumps(cs.attention_backward(torch, flash_attention,
                                               ptxas)), flush=True)
        cs.emit(phase="p2_instances", registers_spills=instances(ptxas))
        by_kernel(torch, cs, flash_attention)
    if "scan" in which:
        print(json.dumps(cs.scan_backward(
            torch, selective_scan,
            cs.ptxas_summary(selective_scan.BACKWARD.ptxas_log))),
            flush=True)
    if "agree" in which:
        cs.training_cpu_agreement(torch, get_config, build_model, training,
                                  flash_attention, selective_scan)
    if "ssm" in which:
        cs.emit(phase="launches", ssm_training=cs.ssm_training(
            torch, train_cli, kernels))
    if "lm" in which:
        cs.emit(phase="launches", lm_training=cs.lm_training(
            torch, train_cli, load_pytree, tuning, kernels))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


def instances(ptxas):
    """{"<kernel><<dtype>, <head dim>[, cap]>": [registers, spill store,
    spill load bytes]} of every P2 function in a ``ptxas_summary``."""
    out = {}
    for fn, v in ptxas.items():
        m = re.search(r"(flash_bwd_\w+?_kernel)I(f|13__nv_bfloat16)?Li(\d+)E"
                      r"(?:Lb(\d)E)?", fn)
        if m:
            kind, t, hd, cap = m.groups()
            out["%s<%s, %s%s>" % (kind, "f32" if t == "f" else "bf16", hd,
                                  ", cap" if cap == "1" else "")] = v
    return dict(sorted(out.items()))


def by_kernel(torch, cs, flash_attention):
    """P2's device ms a call by kernel at every bf16 ``BWD_CASES`` case:
    one ``torch.profiler`` window of 5 calls after one warm call."""
    g = torch.Generator(device="cuda").manual_seed(26)
    for name, b, sq, skv, h, kv, hd, window, causal, cap in cs.BWD_CASES:
        kw = dict(causal=causal, window=window, softcap=cap)
        q, k, v, do = (torch.randn(shape, generator=g, device="cuda")
                       .bfloat16() for shape in ((b, sq, h, hd),
                                                 (b, skv, kv, hd),
                                                 (b, skv, kv, hd),
                                                 (b, sq, h, hd)))
        o, lse = flash_attention.flash_attention_cuda(q, k, v, lse=True, **kw)

        def call():
            return flash_attention.flash_attention_backward_cuda(
                q, k, v, o, lse, do, **kw)
        call()
        _, names, _ = cs.profile_window(torch, lambda: [call()
                                                         for _ in range(5)])
        ms = {}
        for n, us in names.items():
            m = re.search(r"flash_bwd_\w+?_kernel", n)
            if m:
                ms[m.group(0)] = ms.get(m.group(0), 0.0) + us / 5 / 1e3
        cs.emit(phase="p2_by_kernel", layout=name, ms_a_call=ms)
        del q, k, v, do, o, lse
        cs.free_card(torch)


if __name__ == "__main__":
    main(sys.argv[1:] or ["bwd", "scan", "agree", "ssm", "lm"])
