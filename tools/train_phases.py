#!/usr/bin/env python3
"""The training phases of ``chip_smoke.py`` alone, on one card.

    python3 tools/train_phases.py [bwd] [agree] [lm]     (default: all three)

Builds the kernels the training path and its checks run (K3 with its
``kLse`` instances, P2, K4, K5, K6), then runs, one JSON line each as the
smoke prints them:

- ``bwd``: ``chip_smoke.attention_backward`` (K3's ``kLse`` instances and
  P2 against their plain versions at ``BWD_CASES``, bf16 timed beside
  SDPA's or compiled ``flex_attention``'s backward), then its kernels-line
  entry;
- ``agree``: ``chip_smoke.training_cpu_agreement`` (one training step
  card vs CPU on the edge ladder, a 2-layer Granite cut and Whisper's
  2+2 cut);
- ``lm``: ``chip_smoke.lm_training`` (``launch.train`` on
  Granite-3.0-1B-A400M whole, 20 steps at 8 x 2,048, a step's profile,
  the ``"dots"`` policy, ``--save`` read back), then its launches.

About 4 minutes for all three, ~190 s of it in the phases. The card's
name and power limit (``nvidia-smi``) come last. Needs a CUDA device.
"""
import json
import os
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
               selective_scan.KERNEL]
    cs.emit(phase="build", seconds=_build.build(kernels))
    if "bwd" in which:
        ptxas = cs.ptxas_summary(flash_attention.BACKWARD.ptxas_log)
        print(json.dumps(cs.attention_backward(torch, flash_attention,
                                               ptxas)), flush=True)
    if "agree" in which:
        cs.training_cpu_agreement(torch, get_config, build_model, training,
                                  flash_attention)
    if "lm" in which:
        cs.emit(phase="launches", lm_training=cs.lm_training(
            torch, train_cli, load_pytree, tuning, kernels))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["bwd", "agree", "lm"])
