#!/usr/bin/env python3
"""Time the port's selective scan (K6), its backward (P3) and the prefills
and the training step they serve, for one or more source trees, in turns,
on one card.

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
a tree without ``selective_scan.plan``). For every bfloat16 case of
``SCAN_BWD_CASES``, ``"scan_backward <layout> <type>"``: P3's warm and
cold ms, its ms by kernel (walk, sums; one ``torch.profiler`` window of
3 calls), the largest error of each gradient against ``plain_backward``
on the same inputs, and the forward's ``kStates`` instance (``states=
True``) and serving instance timed beside it (a tree without P3 skips
these, and the training step). ``"sass"`` / ``"sass_backward"``: for
each kernel function of the tree's built K6 / P3 library, the innermost
loop of its SASS (``cuobjdump -sass``) that holds the exponentials: its
instructions, its ``MUFU.EX2`` and ``SHFL`` counts, instructions per
exponential (the issue slots of one (state, step) element) and its
opcodes by count; ``"ptxas"`` / ``"ptxas_backward"``, each function's
registers and spill bytes (empty where a turn found its tree already
built). End to end, ``"falcon d0 prefill ms"`` (Falcon-Mamba-7B d0 at
full size, batch 64 x 256 tokens) and ``"hymba d0 prefill ms"``
(Hymba-1.5B d0, batch 8 x 2,048 tokens), each a list of ``REPS``
readings of one ``Model.prefill`` (host clock around a synchronised
call, after a warm-up); ``"hymba training step"``: three training steps
of Hymba-1.5B whole at 8 x 2,048 on random tokens (``make_train_step``
as ``launch.train`` builds it, after one warm-up step): their wall ms,
and one step's device ms, P3's and K6's ms in it from a ``torch.profiler``
window. The card's name and power limit (``nvidia-smi``) come first.
Needs a CUDA device; each tree's kernels are built into its own
``build`` directory.
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
                       "loop_shfl": sum(v for k, v in ops.items()
                                        if k.startswith("SHFL")),
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


def backward_readings(torch, cs, ss):
    """P3 and the ``kStates`` forward at every bfloat16 case of
    ``SCAN_BWD_CASES``, inputs drawn as ``chip_smoke.scan_backward``
    draws them."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(28)
    n = cs.SCAN_STATE
    out = {}
    for label, bt, s, di, dtype, with_dh in cs.SCAN_BWD_CASES:
        if dtype != "bfloat16":
            continue

        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda")
        u = (rnd(bt, s, di) * 0.5).bfloat16()
        dt = F.softplus(rnd(bt, s, di)) * 0.1
        args = (u, dt, -torch.exp(rnd(di, n) * 0.3), rnd(bt, s, n),
                rnd(bt, s, n), rnd(di))
        dy = rnd(bt, s, di).bfloat16()
        dh = rnd(bt, di, n) if with_dh else None
        _, _, states = ss.selective_scan_cuda(*args, states=True)

        def call():
            return ss.selective_scan_backward_cuda(*args, states, dy, dh)
        got = call()
        want = ss.plain_backward(*args, dy, dh)
        errs = {name: float((x.float() - w.float()).abs().max())
                for name, x, w in zip(cs.SCAN_GRADS, got, want)}
        del got, want
        _, by_kernel = cs.kernel_counts(torch, call, reps=3)
        out[f"scan_backward {label} {dtype}"] = {
            "ms": cs.hidden_ms(call, reps=10),
            "cold_ms": cs.cold_ms(call, reps=5),
            "by_kernel_ms": {k[:60]: us / 3e3 for k, us in by_kernel.items()},
            "max_abs_err": errs,
            "forward_states_ms": cs.hidden_ms(
                lambda: ss.selective_scan_cuda(*args, states=True), reps=10),
            "forward_ms": cs.hidden_ms(lambda: ss.selective_scan_cuda(*args),
                                       reps=10)}
        del args, dy, dh, states
        torch.cuda.empty_cache()
    return out


def training_step(torch, cs):
    """Wall ms of three training steps of Hymba-1.5B whole at ``LM_BATCH``
    x ``LM_SEQ`` on random tokens, after one warm-up step, and one step's
    device ms with P3's and K6's share (a profiler window)."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, init_state, make_train_step
    cfg = get_config(cs.HYBRID_ARCH)
    model = build_model(cfg)
    state = init_state(model, 0, device="cuda")
    step_fn = make_train_step(model, AdamWConfig(
        lr=3e-4, warmup_steps=2, total_steps=cs.LM_STEPS))
    batch = {"tokens": torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (cs.LM_BATCH, cs.LM_SEQ)).astype(np.int32),
        device="cuda")}

    def one_step():
        step_fn(state, batch)
    one_step()
    walls = cs.step_walls(torch, one_step)
    _, by_name, _ = cs.profile_window(torch, one_step)
    out = {"wall_ms": walls, "device_ms": sum(by_name.values()) / 1e3}
    for key, part in (("p3_ms", "selective_scan_bwd"),
                      ("k6_ms", "selective_scan_kernel")):
        out[key] = sum(us for name, us in by_name.items()
                       if part in name) / 1e3
    del state, step_fn, model, batch
    torch.cuda.empty_cache()
    return out


def run_tree(src):
    torch, cs = load_tree(src)
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import selective_scan as ss
    has_p3 = hasattr(ss, "selective_scan_backward_cuda")
    _build.build([ss.KERNEL] + ([ss.BACKWARD] if has_p3 else []))
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = {"src": src, "ptxas": cs.ptxas_summary(ss.KERNEL.ptxas_log),
           "sass": sass_loops(ss.KERNEL.lib_path, cuobjdump)}
    if has_p3:
        out["ptxas_backward"] = cs.ptxas_summary(ss.BACKWARD.ptxas_log)
        out["sass_backward"] = sass_loops(ss.BACKWARD.lib_path, cuobjdump)
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
    if has_p3:
        out.update(backward_readings(torch, cs, ss))
    out["falcon d0 prefill ms"] = prefill_ms(
        torch, cs, cs.SSM_ARCH, cs.SERVE_BATCH, cs.PROMPT, cs.MAX_LEN)
    out["hymba d0 prefill ms"] = prefill_ms(
        torch, cs, cs.HYBRID_ARCH, cs.HYBRID_BATCH, cs.HYBRID_PROMPT,
        cs.HYBRID_MAX_LEN)
    if has_p3:
        out["hymba training step"] = training_step(torch, cs)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    turns(__file__, run_tree, timeout=1200)
