#!/usr/bin/env python3
"""Where the scan's backward (P3) spends its cycles, on one card.

    python3 tools/scan_bwd_clocks.py

Copies ``src/repro_torch/csrc/selective_scan_backward.cu`` into
``build/scan_bwd_clocks/`` with phase clocks added (``STAMPS``: every
warp of the first 1,024 blocks adds the ``clock64()`` cycles of each
phase over the chunks it walks, and an entry point reads them back),
builds it, runs it at every bfloat16 case of ``chip_smoke.py``'s
``SCAN_BWD_CASES`` and prints one JSON line a case: the median over the
stamped blocks' warps of a warp's SM cycles a 32-step chunk, split into
staging (the chunk's barrier and the next chunk's loads issued),
rebuilding states, the walk and du / ddt out with the block's dB / dC
sums; the kernel's ms (one call after a warm-up, CUDA events; the clocks
slow it) and its blocks. The card's name and power limit come first. A
warp's cycles are its own wall time on a SM it shares with the other
warps there: they say where a warp waits, not that the SM idles. Needs a
CUDA device.
"""
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "csrc",
                      "selective_scan_backward.cu")
PHASES = ("staging", "rebuild", "walk", "out_and_sums")
#: blocks the instrumented kernel stamps
CLOCK_BLOCKS = 1024
#: warps a block of the walk
WARPS = 4


def phase(i):
    return (f"    {{ const long long now_ = clock64(); ck[{i}] += now_ - ck0;"
            " ck0 = now_; }\n")


#: (text of the source, the text put in its place): the clocks' store,
#: a phase mark after each phase, the read-back entry point
STAMPS = [
    ("struct Smem {\n",
     f"__device__ long long p3_clocks[{CLOCK_BLOCKS}][kWarps]"
     f"[{len(PHASES)}];\n\nstruct Smem {{\n"),
    ("  if (nc > 0) fetch(nc - 1);\n",
     f"  long long ck[{len(PHASES)}] = {{}}, ck0 = clock64();\n"
     "  if (nc > 0) fetch(nc - 1);\n"),
    ("    if (c > 0) fetch(c - 1);  // loads overlap the compute\n",
     "    if (c > 0) fetch(c - 1);  // loads overlap the compute\n"
     + phase(0)),
    ("      float4 hn = make_float4(h[0], h[1], h[2], h[3]);\n",
     phase(1) + "      float4 hn = make_float4(h[0], h[1], h[2], h[3]);\n"),
    ("        hn = hq;\n      }\n",
     "        hn = hq;\n      }\n" + phase(2)),
    ("    __syncthreads();\n  }\n  if (live) {\n",
     "    __syncthreads();\n" + phase(3) + "  }\n"
     "  {\n    const int blk = blockIdx.y * gridDim.x + blockIdx.x;\n"
     f"    if (lane == 0 && blk < {CLOCK_BLOCKS})\n"
     f"      for (int i = 0; i < {len(PHASES)}; ++i)"
     " p3_clocks[blk][warp][i] = ck[i];\n  }\n  if (live) {\n"),
    ('extern "C" const char* selective_scan_backward_error_string',
     'extern "C" int selective_scan_backward_clocks(void* out) {\n'
     "  return static_cast<int>(\n"
     "      cudaMemcpyFromSymbol(out, p3_clocks, sizeof(p3_clocks)));\n}\n\n"
     'extern "C" const char* selective_scan_backward_error_string'),
]


def stamped_source():
    """P3's source with ``STAMPS`` applied; each must match once."""
    src = open(SOURCE).read()
    for old, new in STAMPS:
        if src.count(old) != 1:
            sys.exit(f"scan_bwd_clocks.py: {old!r} is not once in the "
                     "source")
        src = src.replace(old, new)
    return src


def main():
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import selective_scan as ss
    if not torch.cuda.is_available():
        sys.exit("scan_bwd_clocks.py: no CUDA device available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    out_dir = os.path.join(ROOT, "build", "scan_bwd_clocks")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "selective_scan_backward_clocks.cu")
    with open(path, "w") as f:
        f.write(stamped_source())
    lib = os.path.join(out_dir, "libwalk.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, path],
                   check=True, capture_output=True)
    dll = ctypes.CDLL(lib)
    fn = dll.selective_scan_backward_launch
    fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dll.selective_scan_backward_clocks.argtypes = [ctypes.c_void_p]
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
        outs = [torch.empty_like(t) for t in args]
        nblk = -(-di // ss.BWD_CHANNELS)
        part_bc = torch.empty((2, bt, nblk, s * n), device="cuda")
        part_a = torch.empty((bt, di, n), device="cuda")
        part_d = torch.empty((bt, di), device="cuda")
        ptrs = [t.data_ptr() for t in (*args, states, dy)] + [
            dh.data_ptr() if dh is not None else None] + [
            t.data_ptr() for t in (*outs, part_bc[0], part_bc[1], part_a,
                                   part_d)]

        def call():
            code = fn(*ptrs, bt, s, di, n, 1,
                      torch.cuda.current_stream().cuda_stream)
            if code:
                sys.exit(f"scan_bwd_clocks.py: the walk failed ({code})")
        call()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        call()
        b.record()
        b.synchronize()
        clocks = np.zeros((CLOCK_BLOCKS, WARPS, len(PHASES)), np.int64)
        code = dll.selective_scan_backward_clocks(clocks.ctypes.data)
        if code:
            sys.exit(f"scan_bwd_clocks.py: reading the clocks failed "
                     f"({code})")
        blocks = min(CLOCK_BLOCKS, bt * nblk)
        chunks = -(-s // ss.CHUNK)
        c = clocks[:blocks].reshape(-1, len(PHASES)) / chunks
        med = {p: float(np.median(c[:, i])) for i, p in enumerate(PHASES)}
        print(json.dumps({
            "case": label, "shape": [bt, s, di, n], "chunks": chunks,
            "blocks_stamped": blocks, "cycles_a_chunk": med,
            "cycles_a_chunk_total": sum(med.values()),
            "ms": a.elapsed_time(b), "blocks": bt * nblk}), flush=True)
        del outs, part_bc, part_a, part_d, states, args, dy, dh
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
