#!/usr/bin/env python3
"""Time the port's selective scan (K6) and the prefills it serves, for
one or more source trees, in turns, on one card.

    python3 tools/scan_ab.py SRC [SRC ...]

Each ``SRC`` is a directory holding a ``repro_torch`` package (``src``
of this checkout, or of another commit unpacked with ``git archive``).
Each runs in its own process, in the order given, so a change and its
parent compare within one call as parent, change, change, parent:

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    python3 tools/scan_ab.py build/parent/src src src build/parent/src

One JSON line per tree. For every case of ``chip_smoke.py``'s
``SCAN_CASES``, ``"selective_scan <layout> <type>"``: [warm ms, cold ms,
max abs error of y, of h_last, lanes per channel], warm and cold as
``chip_smoke.timed`` and ``chip_smoke.cold_ms`` take them (lanes 1 for
a tree without ``selective_scan.plan``). ``"sass"``: for each kernel
function of the tree's built library, the innermost loop of its SASS
(``cuobjdump -sass``) that holds the exponentials: its instructions, its
``MUFU.EX2`` count, instructions per exponential (the issue slots of one
(state, step)) and its opcodes by count; ``"ptxas"``, each function's
registers and spill bytes. End to end, ``"falcon d0 prefill ms"``
(Falcon-Mamba-7B d0 at full size, batch 64 x 256 tokens) and ``"hymba
d0 prefill ms"`` (Hymba-1.5B d0, batch 8 x 2,048 tokens), each a list
of ``REPS`` readings of one ``Model.prefill`` (host clock around a
synchronised call, after a warm-up). The card's name and power limit
(``nvidia-smi``) come first. Needs a CUDA device; each tree's
kernels are built into its own ``build`` directory.
"""
import json
import os
import re
import subprocess
import time

from attention_ab import REPS, load_tree, turns


def sass_bodies(lib, cuobjdump):
    """{function: [(first address, branch address, opcodes), ...]}: every
    backward-branch loop of each kernel function in ``lib`` (``cuobjdump
    -sass``)."""
    text = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out, fn, ins = {}, None, []

    def close():
        loops = []
        for addr, op, args in ins:
            m = re.match(r"0x([0-9a-f]+)", args)
            if op.split(".")[0] == "BRA" and m and \
                    int(m.group(1), 16) <= addr:
                lo = int(m.group(1), 16)
                loops.append((lo, addr, [o for a, o, _ in ins
                                         if lo <= a <= addr]))
        if fn:
            out[fn] = loops
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            close()
            fn, ins = m.group(1), []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
        if m and fn:
            words = m.group(2).split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words:
                ins.append((int(m.group(1), 16), words[0],
                            " ".join(words[1:])))
    close()
    return out


def op_counts(body):
    ops = {}
    for o in body:
        ops[o] = ops.get(o, 0) + 1
    return dict(sorted(ops.items(), key=lambda kv: -kv[1]))


def sass_loops(lib, cuobjdump):
    """{function: {...}} for the innermost backward-branch loop of each
    function in ``lib`` that holds a ``MUFU.EX2``."""
    out = {}
    for fn, loops in sass_bodies(lib, cuobjdump).items():
        loops = [b for _, _, b in loops if "MUFU.EX2" in b]
        if loops:
            body = min(loops, key=len)
            ops = op_counts(body)
            ex2 = ops["MUFU.EX2"]
            out[fn] = {"loop_instructions": len(body), "loop_ex2": ex2,
                       "per_exp": len(body) / ex2, "ops": ops}
    return out


def prefill_ms(torch, cs, arch, batch, prompt, max_len):
    """``REPS`` host-clock readings of one prefill of ``arch`` d0 at full
    size, after a warm-up."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import build_engines
    eng = build_engines(get_config(arch), variants=("d0",), max_len=max_len,
                        device="cuda")["S"]["d0"]
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, eng.model.cfg.vocab_size, (batch, prompt)).astype(np.int32),
        device="cuda")
    runs = []
    with torch.inference_mode():
        for r in range(REPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.model.prefill(eng.params, {"tokens": toks}, max_len=max_len)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
    del eng
    torch.cuda.empty_cache()
    return runs[1:]


def run_tree(src):
    torch, cs = load_tree(src)
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import selective_scan as ss
    _build.build([ss.KERNEL])
    out = {"src": src, "ptxas": cs.ptxas_summary(ss.KERNEL.ptxas_log)}
    out["sass"] = sass_loops(ss.KERNEL.lib_path, os.path.join(
        os.path.dirname(_build._nvcc()), "cuobjdump"))
    g = torch.Generator(device="cuda").manual_seed(8)
    n = cs.SCAN_STATE
    for label, bt, s, di, dtype in cs.SCAN_CASES:
        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda")
        u = (rnd(bt, s, di) * 0.5).to(getattr(torch, dtype))
        dt = F.softplus(rnd(bt, s, di)) * 0.1
        args = (u, dt, -torch.exp(rnd(di, n) * 0.3), rnd(bt, s, n),
                rnd(bt, s, n), rnd(di))

        def f():
            return ss.selective_scan_cuda(*args)
        y, h = f()
        y2, h2 = ss.plain(*args)
        ms, _, _ = cs.timed(f)
        lanes = ss.plan(bt, di, n)[0] if hasattr(ss, "plan") else 1
        out[f"selective_scan {label} {dtype}"] = [
            ms, cs.cold_ms(f), float((y.float() - y2.float()).abs().max()),
            float((h - h2).abs().max()), lanes]
    out["falcon d0 prefill ms"] = prefill_ms(
        torch, cs, cs.SSM_ARCH, cs.SERVE_BATCH, cs.PROMPT, cs.MAX_LEN)
    out["hymba d0 prefill ms"] = prefill_ms(
        torch, cs, cs.HYBRID_ARCH, cs.HYBRID_BATCH, cs.HYBRID_PROMPT,
        cs.HYBRID_MAX_LEN)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    turns(__file__, run_tree, timeout=1200)
