#!/usr/bin/env python3
"""How many steps of rebuilt states the scan's backward (P3) should keep:
build copies of ``src/repro_torch/csrc/selective_scan_backward.cu`` with
another ``kSub`` and time each on one card.

    python3 tools/scan_bwd_ablate.py

P3 rebuilds each 32-step chunk's states from the state K6 kept at its
start and keeps ``kSub`` steps of them (each lane's h_{t-1}, 16 bytes a
lane a step) in shared memory, walking the chunk in ``32 / kSub`` parts
from the last. A smaller ``kSub`` takes less shared memory (more blocks
a SM) and more exponentials rebuilding: 1 + (32 / kSub - 1) / 2 an
element, plus 1 in the walk. Every variant computes the same values in
the same order, so its outputs must equal the kernel's bit for bit.

For every case of ``chip_smoke.py``'s ``SCAN_BWD_CASES`` in bfloat16,
one JSON line a variant: the ms (``chip_smoke.hidden_ms``, 20 calls,
the launch hidden), the walk's registers and spills from ptxas, the
shared memory a block, and whether its outputs equal the kernel's. The
card's name and power limit (``nvidia-smi``) come first. Needs a CUDA
device; the variants are built under ``build/scan_bwd_ablate``.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "csrc",
                      "selective_scan_backward.cu")
OUT = os.path.join(ROOT, "build", "scan_bwd_ablate")
SUB = "constexpr int kSub = 16;"
#: variant name -> kSub (16 is the kernel as it is)
VARIANTS = {"kSub 16 (kernel)": 16, "kSub 32": 32, "kSub 8": 8}


def build(name, k_sub, nvcc, flags):
    src = open(SOURCE).read()
    if SUB not in src:
        sys.exit(f"scan_bwd_ablate: {SUB!r} is not in the source")
    src = src.replace(SUB, f"constexpr int kSub = {k_sub};")
    stem = "".join(c if c.isalnum() else "_" for c in name)
    path = os.path.join(OUT, f"{stem}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(OUT, f"lib{stem}.so")
    return lib, subprocess.Popen([nvcc, *flags, "-o", lib, path],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def main():
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import selective_scan as ss
    if not torch.cuda.is_available():
        sys.exit("scan_bwd_ablate: no CUDA device available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    _build.build([ss.KERNEL])
    procs = {name: build(name, k, _build._nvcc(), _build.NVCC_FLAGS)
             for name, k in VARIANTS.items()}
    fns, regs = {}, {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"scan_bwd_ablate: {name!r} does not build:\n{log}")
        regs[name] = cs.instance_regs(cs.ptxas_summary(log),
                                      "selective_scan_bwd_kernelI13__nv_"
                                      "bfloat16EE")
        fn = ctypes.CDLL(lib).selective_scan_backward_launch
        fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    g = torch.Generator(device="cuda").manual_seed(28)
    n = cs.SCAN_STATE
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
        want = ss.selective_scan_backward_cuda(*args, states, dy, dh)
        nblk = -(-di // ss.BWD_CHANNELS)
        for name, fn in fns.items():
            outs = [torch.empty_like(t) for t in want]
            part_bc = torch.empty((2, bt, nblk, s, n), device="cuda")
            part_a = torch.empty((bt, di, n), device="cuda")
            part_d = torch.empty((bt, di), device="cuda")
            ptrs = [t.data_ptr() for t in (*args, states, dy)] + [
                dh.data_ptr() if dh is not None else None] + [
                t.data_ptr() for t in (*outs, part_bc[0], part_bc[1],
                                       part_a, part_d)]

            def f():
                code = fn(*ptrs, bt, s, di, n, 1,
                          torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"{name}: CUDA error {code}")
            f()
            torch.cuda.synchronize()
            k_sub = VARIANTS[name]
            print(json.dumps({
                "case": label, "shape": [bt, s, di, n], "variant": name,
                "ms": cs.hidden_ms(f, reps=20),
                "exponentials_an_element": 2 + (32 // k_sub - 1) / 2,
                "shared_bytes": 73728 - 32768 + 2048 * k_sub,
                "equal_to_kernel": all(torch.equal(a, b)
                                       for a, b in zip(outs, want)),
                "ptxas": regs[name]}), flush=True)


if __name__ == "__main__":
    main()
