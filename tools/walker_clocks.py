#!/usr/bin/env python3
"""Where a best-response round's walker spends its cycles, on one card.

    python3 tools/walker_clocks.py

Builds ``src/repro_torch/csrc/best_response.cu`` with ``-DBR_CLOCKS``
into ``build/walker_clocks/`` (its phase clocks: lane 0 of warps 0 and
31 stamps ``clock64()`` at each phase of the first 2,048 windows), runs
the changing round (from the isolated start) at ``tools/oracle_ab.py``'s
three shapes, and prints one JSON line a shape and warp: the median SM
cycles a window over the windows whose every phase was stamped, split
into the window's set-up to its first barrier, the cell's term rows,
its candidate loop, its warp argmin and switch rule, and the rest
(barriers, the window's reductions and its commit); with the windows
counted and the card's name and power limit first. Needs a CUDA device.
"""
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

from attention_ab import ROOT
from oracle_ab import shapes

#: phase stamps of a window (``BR_CLOCK`` in the source): start, after
#: its first barrier, before and after the term rows, after the
#: candidate loop, after the argmin, end
PHASES = 7


def main():
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("walker_clocks.py: no CUDA device available")
    from repro_torch.kernels import _build, best_response
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    out_dir = os.path.join(ROOT, "build", "walker_clocks")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libbest_response.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DBR_CLOCKS", "-o",
                    lib_path, str(best_response.KERNEL.source)], check=True,
                   capture_output=True)
    best_response.KERNEL.lib_path = type(best_response.KERNEL.lib_path)(
        lib_path)
    lib = ctypes.CDLL(lib_path)
    lib.best_response_clocks.argtypes = [ctypes.c_void_p]
    R = cs.fleet_namespace()
    pop = R.population
    for label, scen, pu, goal in shapes(torch, R, cs):
        topo = scen.topo
        feas, ce, cc = pop._candidate_tables(scen, pu, goal, 4096)
        _, idx0 = pop._isolated_bruteforce(scen, pu, goal)
        args = (scen.end_b.to(torch.int32), scen.edge_b.to(torch.int32),
                scen.member, feas, ce, cc, topo.cell_edge,
                topo.edge_capacity, topo.cloud_servers)
        packed = best_response.pack_actions(pu)
        for _ in range(2):
            best_response.best_response_cuda(idx0, packed, *args)
        torch.cuda.synchronize()
        clocks = np.zeros((2, 2048, 8), np.int64)
        code = lib.best_response_clocks(clocks.ctypes.data)
        if code:
            sys.exit(f"walker_clocks.py: reading the clocks failed ({code})")
        windows = -(-scen.cells // 32)
        for w, warp in enumerate((0, 31)):
            c = clocks[w, :min(windows, 2048), :PHASES]
            whole = c[(np.diff(c, axis=1) > 0).all(1)]
            d = np.diff(whole, axis=1)
            med = lambda x: float(np.median(x)) if len(x) else None  # noqa
            print(json.dumps({
                "shape": label, "warp": warp, "windows": int(windows),
                "windows_stamped": int(len(whole)),
                "cycles_a_window": med(whole[:, 6] - whole[:, 0]),
                "to_first_barrier": med(d[:, 0]),
                "term_rows": med(d[:, 2]), "candidate_loop": med(d[:, 3]),
                "argmin_and_rule": med(d[:, 4]),
                "rest": med(d[:, 1] + d[:, 5])}), flush=True)
        del feas, ce, cc
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
