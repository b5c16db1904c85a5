#!/usr/bin/env python3
"""Where the selective scan's (K6) time goes: build copies of
``src/repro_torch/csrc/selective_scan.cu`` with one piece of work taken
out or changed, and time each on one card.

    python3 tools/scan_ablate.py

Each variant is the kernel's source with textual substitutions (the tool
fails if one no longer applies). The variants that take work out compute
wrong values and are timed only, to see what that work costs:

* ``kernel``: the source as it is;
* ``no exponentials``: ``1 + dt a'`` (one FFMA) in place of each
  ``ex2.approx`` on the special function unit;
* ``no B/C reads``: the states' B_t and C_t from registers in place of
  the float4 reads of shared memory;
* ``no u/dt loads``: constants in place of the chunk's global loads;
* ``no y stores``: y computed and not written;
* ``poly exp2, k states``: the first k states of each lane through a
  float32 polynomial ``exp2`` on the FMA pipe (Cody-Waite split, degree 6,
  exponent added into the bits), the rest on the special function unit —
  right values, the work moved from one pipe to the other;
* ``one lane``: the kernel instantiated with one lane a channel (16 states
  a lane; chunks cut to 16 steps, as 32 steps of u and dt in flight take
  more shared memory than a block may hold), a split the plan does not
  choose.

For every case of ``chip_smoke.py``'s ``SCAN_CASES`` in bfloat16 and every
lane count (``selective_scan.LANES``, and 1 for ``one lane``), one JSON
line: the variant, the ms (``chip_smoke.time_ms``: the median of 20 CUDA
event pairs after 3 warm-ups), the max abs error of y and h_last against
the plain version, and the variant's registers and spills from ptxas. The
card's name and power limit (``nvidia-smi``) come first. Needs a CUDA
device; the variants are built under ``build/scan_ablate``.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "csrc",
                      "selective_scan.cu")
OUT = os.path.join(ROOT, "build", "scan_ablate")

EX2 = "h[n] = fmaf(h[n], ex2(dtv * a[n]), du * bn[j]);"
POLY = """
__device__ __forceinline__ float ex2_fma(float x) {
  const float xc = fmaxf(x, -127.f);
  const float t = xc + 12582912.f;  // 1.5 * 2^23: round to an integer
  const float f = xc - (t - 12582912.f);
  float p = 1.535336188319500e-4f;
  p = fmaf(p, f, 1.339887440266574e-3f);
  p = fmaf(p, f, 9.618437357674640e-3f);
  p = fmaf(p, f, 5.550332471162809e-2f);
  p = fmaf(p, f, 2.402264791363012e-1f);
  p = fmaf(p, f, 6.931472028550421e-1f);
  p = fmaf(p, f, 1.f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}
"""


def _poly(k):
    ex2 = "__device__ __forceinline__ float ex2(float x) {"
    return [(ex2, POLY + ex2),
            (EX2, f"h[n] = fmaf(h[n], n < {k} ? ex2_fma(dtv * a[n]) : "
                  "ex2(dtv * a[n]), du * bn[j]);")]


VARIANTS = {
    "kernel": [],
    "no exponentials": [(EX2, "h[n] = fmaf(h[n], 1.f + dtv * a[n], "
                              "du * bn[j]);")],
    "no B/C reads": [("const float4 bv = bq[q], cv = cq[q];",
                      "const float4 bv = make_float4(du, dtv, du, dtv), "
                      "cv = make_float4(dtv, du, dtv, du);")],
    "no u/dt loads": [("ur[k] = ok ? to_float(u[off]) : 0.f;",
                       "ur[k] = ok ? 0.5f : 0.f;"),
                      ("dr[k] = ok ? dt[off] : 0.f;",
                       "dr[k] = ok ? 0.01f * (k + 1) : 0.f;")],
    "no y stores": [("if (t < len && live_w)",
                     "if (t < len && live_w && yv == 12345.f)")],
    "poly exp2, 1 state": _poly(1),
    "poly exp2, 2 states": _poly(2),
    "one lane": [("constexpr int kChunk = 32;", "constexpr int kChunk = 16;"),
                 ("    case 2:\n",
                  "    case 1:\n      return launch<T, 1, kStates>(u, dt, A, "
                  "B, C, D, y, h_last, states, Bt, S, di, N, s);\n"
                  "    case 2:\n")],
}


def build(name, subs, nvcc, flags):
    src = open(SOURCE).read()
    for old, new in subs:
        if old not in src:
            sys.exit(f"scan_ablate: variant {name!r} no longer applies: "
                     f"{old!r} is not in the source")
        src = src.replace(old, new)
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
        sys.exit("scan_ablate: no CUDA device available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    procs = {name: build(name, subs, _build._nvcc(), _build.NVCC_FLAGS)
             for name, subs in VARIANTS.items()}
    fns, regs = {}, {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"scan_ablate: {name!r} does not build:\n{log}")
        regs[name] = cs.ptxas_summary(log)
        fn = ctypes.CDLL(lib).selective_scan_launch
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    g = torch.Generator(device="cuda").manual_seed(8)
    n = cs.SCAN_STATE
    for label, bt, s, di, dtype in cs.SCAN_CASES:
        if dtype != "bfloat16":
            continue

        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda")
        u = (rnd(bt, s, di) * 0.5).bfloat16()
        dt = F.softplus(rnd(bt, s, di)) * 0.1
        A, B, C, D = (-torch.exp(rnd(di, n) * 0.3), rnd(bt, s, n),
                      rnd(bt, s, n), rnd(di))
        y2, h2 = ss.plain(u, dt, A, B, C, D)
        for name, fn in fns.items():
            for lanes in ((1,) if name == "one lane" else ss.LANES):
                y = torch.empty_like(u)
                h = torch.empty((bt, di, n), device="cuda")
                args = [t.data_ptr() for t in (u, dt, A, B, C, D, y, h)]

                def f():
                    code = fn(*args, None, bt, s, di, n, 1, lanes,
                              torch.cuda.current_stream().cuda_stream)
                    if code:
                        raise RuntimeError(f"{name}: CUDA error {code}")
                f()
                torch.cuda.synchronize()
                inst = (f"selective_scan_kernelI13__nv_bfloat16Li{lanes}"
                        "ELb0EE")
                print(json.dumps({
                    "case": label, "shape": [bt, s, di, n], "lanes": lanes,
                    "variant": name, "ms": cs.time_ms(f),
                    "max_abs_err_y": float((y.float() - y2.float())
                                           .abs().max()),
                    "max_abs_err_h": float((h - h2).abs().max()),
                    "ptxas": [v for k, v in regs[name].items()
                              if inst in k]}), flush=True)


if __name__ == "__main__":
    main()
