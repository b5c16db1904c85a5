#!/usr/bin/env python3
"""The scan's backward (P3) and the levers measured against it: build
copies of its source with other values of its design constants or with
textual substitutions, and time each on one card.

    python3 tools/scan_bwd_ablate.py

P3 (``src/repro_torch/csrc/selective_scan_backward.cu``) walks each
32-step chunk in time: ``kSub`` steps of rebuilt states kept in shared
memory (2.5 exponentials an element at 16), ``kBlocksPerSM`` the blocks a
SM it is compiled for, ``kAdvanceUnroll`` the rebuild's unroll. Its
variants here: the walk as it was before those were tuned, h_t computed
again in the walk (in place of the step after's h_{t-1}), a quarter
chunk of states, the decays kept beside h_{t-1} (1.5 exponentials, 104 KB
of shared memory: 2 blocks a SM), dB / dC written out a step and summed
over the block's 32 channels after each half chunk in place of the
per-step shuffles (a 64 KB buffer: 1 block a SM), and four that take a
piece of work out (the dB / dC shuffles, the s1 / s2 shuffles, the
exponentials, the rebuild's second pass over a chunk's first half). A
grid sized to whole waves is not a variant: a block's channel count is
its 128 lanes / 4, and a persistent grid would leave the same 2.02 items
a slot at Hymba. Variants that ``remove`` a piece of work compute wrong
values and are timed only, to see what the work costs.

For every bfloat16 case of ``chip_smoke.py``'s ``SCAN_BWD_CASES``, one
JSON line a variant: the ms (``chip_smoke.hidden_ms``, 10 calls, the
launch hidden), the walk's registers, spill stores, spill loads and
stack frame from ptxas, the innermost loop of its SASS that holds the
exponentials (``tools/scan_ab.py``'s counts: instructions, exponentials,
shuffles, instructions an exponential), its shared memory a block, its
blocks and waves at its blocks a SM, the partial sums' bytes, and each
gradient's limit share against ``plain_backward`` (the tolerances of
``chip_smoke.scan_backward``). The card's name and power limit
(``nvidia-smi``) come first. Needs a CUDA device; the variants are built
under ``build/scan_bwd_ablate``.
"""
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "csrc",
                      "selective_scan_backward.cu")
OUT = os.path.join(ROOT, "build", "scan_bwd_ablate")
#: shared memory a block may take on the H100
SMEM_LIMIT = 232448

HINT = "__launch_bounds__(kThreads, kBlocksPerSM)"
KEEP_DECAYS = [
    ("  float4 hp[kSub][kThreads];  // each lane's h_{t-1} over a half chunk\n",
     "  float4 hp[kSub][kThreads];  // each lane's h_{t-1} over a half chunk\n"
     "  float4 ap[kSub][kThreads];  // and its decays a_t\n"),
    ("""        sm.hp[i - i0][tid] = make_float4(h[0], h[1], h[2], h[3]);
        advance(h, i);""",
     """        sm.hp[i - i0][tid] = make_float4(h[0], h[1], h[2], h[3]);
        const float dtv_ = sm.dt[i][ch], duv_ = dtv_ * sm.u[i][ch];
        const float4 bv_ = sm.b[i][l];
        const float bn_[4] = {bv_.x, bv_.y, bv_.z, bv_.w};
        float a_[4];
#pragma unroll
        for (int n = 0; n < kPerLane; ++n) {
          a_[n] = ex2(dtv_ * a2[n]);
          h[n] = fmaf(h[n], a_[n], duv_ * bn_[n]);
        }
        sm.ap[i - i0][tid] = make_float4(a_[0], a_[1], a_[2], a_[3]);"""),
    ("    const float4 bv = sm.b[i][l], cv = sm.c[i][l];",
     "    const float4 bv = sm.b[i][l], cv = sm.c[i][l], aq4 = sm.ap[j][tid];\n"
     "    const float aq[4] = {aq4.x, aq4.y, aq4.z, aq4.w};"),
    ("      const float a = ex2(dtv * a2[n]);", "      const float a = aq[n];"),
]
SUM_AFTER_HALF = [
    ("  float red[kWarps][kChunk][2 * kMaxState];  // a warp's dB_t, then dC_t",
     "  float red[kSub][kThreads][2 * kPerLane];  // each lane's dB_t, dC_t"),
    ("""    // dB_t / dC_t over the warp's 8 channels, halving the values each step
    float w[4], x[2];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = (hi2 ? v[k + 4] : v[k]) +
             __shfl_xor_sync(kFull, hi2 ? v[k] : v[k + 4], 16);
#pragma unroll
    for (int k = 0; k < 2; ++k)
      x[k] = (hi1 ? w[k + 2] : w[k]) +
             __shfl_xor_sync(kFull, hi1 ? w[k] : w[k + 2], 8);
    sm.red[warp][i][red_at] =
        (hi0 ? x[1] : x[0]) + __shfl_xor_sync(kFull, hi0 ? x[0] : x[1], 4);""",
     """#pragma unroll
    for (int k = 0; k < 2 * kPerLane; ++k) sm.red[j][tid][k] = v[k];"""),
    ("""        hn = hq;
      }
    }""",
     """        hn = hq;
      }
      __syncthreads();
      for (int e = tid; e < kSub * 2 * kMaxState; e += kThreads) {
        const int jj = e / (2 * kMaxState), v = e % (2 * kMaxState);
        const int st = v % kMaxState, i = i0 + jj;
        if (i < i1 && st < N) {
          float sum = 0.f;
          for (int cc = 0; cc < kCh; ++cc)
            sum += sm.red[jj][cc * kLanes + st / kPerLane]
                         [v / kMaxState * kPerLane + st % kPerLane];
          (v < kMaxState ? dB_part : dC_part)[
              (((long long)b * gridDim.x + blockIdx.x) * S + t0 + i) * N +
              st] = sum;
        }
      }
      __syncthreads();
    }"""),
    ("      if (i < len && n < N) {\n        float sum = sm.red[0][i][v];",
     "      if (false) {\n        float sum = 0.f;"),
    ("        for (int w = 1; w < kWarps; ++w) sum += sm.red[w][i][v];",
     "        for (int w = 1; w < kWarps; ++w) sum += 0.f;"),
]
#: the walk computing h_t again from h_{t-1} for dC_t's term, in place of
#: taking it from the step after (the same bits)
H_T = ("      v[kPerLane + n] = ht[n] * dyv;                     // dC_t's: h_t dy",
       "      v[kPerLane + n] = fmaf(hp[n], a, duv * bn[n]) * dyv;")
#: name -> (knobs it changes, textual substitutions, right values)
VARIANTS = {
    "kernel": ({}, [], True),
    "no min-blocks hint": ({}, [(HINT, "__launch_bounds__(kThreads)")],
                           True),
    "rebuild unrolled by 4": ({"kAdvanceUnroll": 4}, [], True),
    "as it was (no hint, unrolled by 4, h_t rebuilt)": (
        {"kAdvanceUnroll": 4},
        [(HINT, "__launch_bounds__(kThreads)"), H_T], True),
    "h_t rebuilt in the walk": ({}, [H_T], True),
    "quarter chunks of states (kSub 8)": ({"kSub": 8}, [], True),
    "decays kept beside h_{t-1}": ({"kBlocksPerSM": 2}, KEEP_DECAYS, True),
    "dB / dC summed after each half": ({"kBlocksPerSM": 1}, SUM_AFTER_HALF,
                                       True),
    "remove the dB / dC shuffles": ({}, [(
        """    sm.red[warp][i][red_at] =
        (hi0 ? x[1] : x[0]) + __shfl_xor_sync(kFull, hi0 ? x[0] : x[1], 4);""",
        "    sm.red[warp][i][red_at] = v[0] + v[7];"), (
        """      w[k] = (hi2 ? v[k + 4] : v[k]) +
             __shfl_xor_sync(kFull, hi2 ? v[k] : v[k + 4], 16);""",
        "      w[k] = v[k];"), (
        """      x[k] = (hi1 ? w[k + 2] : w[k]) +
             __shfl_xor_sync(kFull, hi1 ? w[k] : w[k + 2], 8);""",
        "      x[k] = w[k];")], False),
    "remove the s1 / s2 shuffles": ({}, [(
        """    keep += __shfl_xor_sync(kFull, odd ? s1 : s2, 1);
    keep += __shfl_xor_sync(kFull, keep, 2);""",
        "    keep += odd ? s1 : s2;")], False),
    "remove the exponentials": ({}, [
        ("      const float a = ex2(dtv * a2[n]);",
         "      const float a = fmaf(dtv, a2[n], 1.f);"),
        ("      h[n] = fmaf(h[n], ex2(dtv * a2[n]), duv * bn[n]);",
         "      h[n] = fmaf(h[n], fmaf(dtv, a2[n], 1.f), duv * bn[n]);")],
        False),
    "remove the rebuild's second pass over the first half": (
        {}, [("      for (int i = 0; i < i0; ++i) advance(h, i);",
              "      for (int i = 0; i < 0; ++i) advance(h, i);")],
        False),
}


def knob(src, name):
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    return int(m.group(1)) if m else None


def smem_bytes(src):
    """The bytes of ``struct Smem`` of a variant's source (bf16 u)."""
    sub = knob(src, "kSub")
    red = sub * 128 * 8 * 4 if "float red[kSub]" in src else 4 * 32 * 32 * 4
    return (5 * 32 * 32 + 2 * 32 * 16) * 4 + red + \
        sub * 128 * 16 * (2 if "float4 ap[" in src else 1)


def stack_frame(log):
    """Bytes of stack frame (local arrays and spills) of P3's bf16 walk in
    ``nvcc -Xptxas -v`` output."""
    fn = None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes stack frame", ln)
        if m and fn and "bwd_kernelI13__nv_bfloat16" in fn:
            return int(m.group(1))
    return None


def build(name, variant, nvcc, flags):
    changes, subs, _ = variant
    src = open(SOURCE).read()
    for old, new in subs:
        if old not in src:
            sys.exit(f"scan_bwd_ablate: variant {name!r} no longer applies: "
                     f"{old!r} is not in the source")
        src = src.replace(old, new)
    for k, v in changes.items():
        src, hits = re.subn(rf"constexpr int {k} = \d+;",
                            f"constexpr int {k} = {v};", src)
        if hits != 1:
            sys.exit(f"scan_bwd_ablate: {k} is not one constant of the "
                     "source")
    stem = re.sub(r"\W+", "_", name)
    path = os.path.join(OUT, f"{stem}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(OUT, f"lib{stem}.so")
    return lib, src, subprocess.Popen(
        [nvcc, *flags, "-o", lib, path], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def main():
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import selective_scan as ss
    from scan_ab import sass_loops
    if not torch.cuda.is_available():
        sys.exit("scan_bwd_ablate: no CUDA device available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    procs = {name: build(name, v, _build._nvcc(), _build.NVCC_FLAGS)
             for name, v in VARIANTS.items()}
    built = {}
    for name, (lib, src, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"scan_bwd_ablate: {name!r} does not build:\n{log}")
        loops = [v for f, v in sass_loops(lib, cuobjdump).items()
                 if "bwd_kernelI13__nv_bfloat16" in f]
        fn = ctypes.CDLL(lib).selective_scan_backward_launch
        fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        built[name] = dict(
            fn=fn, per_sm=knob(src, "kBlocksPerSM"), smem=smem_bytes(src),
            ptxas=cs.instance_regs(cs.ptxas_summary(log),
                                   "selective_scan_bwd_kernelI13__nv_"
                                   "bfloat16EE") + [stack_frame(log)],
            sass={k: loops[0][k] for k in (
                "loop_instructions", "loop_ex2", "loop_shfl", "per_exp")}
            if loops else None)
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
        want = ss.plain_backward(*args, dy, dh)
        _, _, states = ss.selective_scan_cuda(*args, states=True)
        nblk = -(-di // ss.BWD_CHANNELS)
        for name, v in built.items():
            line = {"case": label, "shape": [bt, s, di, n], "variant": name,
                    "right_values": VARIANTS[name][2],
                    "shared_bytes": v["smem"], "ptxas": v["ptxas"],
                    "sass": v["sass"]}
            if v["smem"] > SMEM_LIMIT:
                print(json.dumps({**line, "ms": None,
                                  "skipped": "shared memory"}), flush=True)
                continue
            outs = [torch.empty_like(t) for t in want]
            part_bc = torch.empty((2, bt, nblk, s * n), device="cuda")
            part_a = torch.empty((bt, di, n), device="cuda")
            part_d = torch.empty((bt, di), device="cuda")
            ptrs = [t.data_ptr() for t in (*args, states, dy)] + [
                dh.data_ptr() if dh is not None else None] + [
                t.data_ptr() for t in (*outs, part_bc[0], part_bc[1],
                                       part_a, part_d)]

            def f():
                code = v["fn"](*ptrs, bt, s, di, n, 1,
                               torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"{name}: CUDA error {code}")
            f()
            torch.cuda.synchronize()
            shares = {}
            for gname, x, w in zip(cs.SCAN_GRADS, outs, want):
                x, w = x.float(), w.float()
                if gname in ("du", "ddt"):
                    tol = cs.SCAN_BWD_TOL[dtype if gname == "du"
                                          else "float32"]
                    shares[gname] = cs.limit_share(x, w, tol, tol)
                else:
                    shares[gname] = float((x - w).abs().max()) / (
                        cs.SCAN_BWD_REDUCED * float(w.abs().max()))
            blocks = bt * nblk
            print(json.dumps({
                **line, "ms": cs.hidden_ms(f, reps=10),
                "blocks": blocks,
                "waves": blocks / (ss.SMS * v["per_sm"]),
                "partial_bytes": 2 * 4 * (2 * bt * nblk * s * n
                                          + bt * di * (n + 1)),
                "limit_shares": shares}), flush=True)
            del outs, part_bc, part_a, part_d
        del args, dy, dh, want, states
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
