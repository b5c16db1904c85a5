#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one
``nvcc`` per source, in parallel), holds each against its plain PyTorch
version on the card at the main paths' shapes, then drives the two main
paths through the entry points a user calls:

* the fleet online-learning loop: ``FleetQLearning`` on a 32,768-cell
  mixed Table-5 fleet of 5 users and ``FleetDQN`` (hidden 128, top-5
  constraint head at an 85% accuracy goal) on a dynamic 32,768-cell
  synthetic fleet, each scored against the brute-force oracle and
  routed through ``FleetOrchestrator`` (kernels K1, K2);
* the serving path: ``build_engines`` over the edge-ladder config (d0
  bf16, d4 int8, d7 int8 at width 0.25, full width), a 1,024-cell
  3-user fleet routed with ``FleetOrchestrator.route(dispatch=engines)``
  into batches of 64, and each variant's ``generate`` at batch 64,
  prompt bucket 256, 16 new tokens (kernels K3, K4, K5);
* the sim-to-real loop (phases ``metrics_overhead``, ``bridge_dispatch``,
  ``spans``, ``calibration``): both agents at 32,768 x 5 with their
  telemetry on and off (trained state held bit-identical); the 1,024-cell
  fleet spread over the S/E/C engines, routed synchronously and through
  the async bridge (one CUDA stream per queue), with network hops
  (E 25 ms, C 50 ms) and without, plus the oracle through the bridge and
  one overloaded bridge; a route recorded as Chrome-trace spans; and
  ``calibrate_serving`` on the hop engines, fitting the latency model to
  the card's walls and retraining a ``FleetDQN`` on the calibrated
  dynamics (kernels K1-K5);
* the state-space path: ``build_engines`` over Falcon-Mamba-7B at its
  published size (64 Mamba blocks, d_model 4096, d_inner 8192, vocab
  65,024; d0 bf16 and d4 int8), each variant's ``generate`` at batch 64,
  prompt 256, 16 new tokens, a ``serve`` drain and a 256-cell 3-user
  fleet routed into the engines; and Hymba-1.5B at full size (32 hybrid
  layers, d_model 1600) generating at batch 8 from a 2,048-token prompt,
  longer than its 1,024-token window (kernels K3, K4, K5, K6);
* the coupled fleet (phases ``coupled_oracle``, ``coupled_holdout``,
  ``cell_dqn``, ``prof``): ``topology_bruteforce`` through the
  best-response kernel on the reference benchmark's hot edge (64 cells of
  2 users over 4 edges) and on 1,024 cells of 3 users over 16 skewed
  edges, each held equal to the same loop with the kernel's plain round
  on the card, with the aware-vs-blind reward on the hot edge; a
  ``FleetDQN`` trained on 32,768 x 5 cells over 64 skewed edges and
  scored against that oracle, one round of which is held equal to the
  plain round at that shape; ``FleetDQN(net='cell')`` at the DQN
  phase's shape; ``obs.prof`` stage costs of both agents and a scaling
  sweep over 1,024 to 32,768 cells (kernels K1, K2 and the port-only
  best-response kernel);
* the single-cell layer (phase ``single_cell``): ``bruteforce_optimal``
  on the card against the CPU for every experiment x threshold, N =
  1..5; tabular Q-learning (N = 3, goal 85) converging, its Q rows equal
  to the CPU run's; both DQN forms (paper N = 3, factored N = 5 at goal
  85) 2,000 steps, greedy equal to the CPU's on the same parameters
  where the margin is clear; then ``python -m repro_torch.launch.serve``'s
  ``main`` with its defaults (the full-width edge ladder, d0-d7 on the
  device tier): 4 waves of the trained agent's decisions served through
  the engines (kernels K3, K4, K5), and K3-K5 held against their plain
  versions at its shapes (batch 1 x 16 tokens, 64 slots, d5's and d6's
  projections at 16 rows and 1).

The phase ``cpu_agreement`` also holds the float32 fleet env step on
the card bit-equal to the CPU on an isolated and a coupled fleet. Each
path's kernel launch counts are set to 0 just before it and read just
after; every route checks its identities (each active user served
once, or shed once where a bridge is overloaded; batching + compute +
dispatch = wall; queue + measured = e2e; attained + violated =
dispatched). Every phase prints one JSON line; any failed check raises
and the exit code is non-zero. The ``kernel_parity`` lines of K2, K3,
K4 and K5 also give each case's time with the L2 cache cold
(``cold_ms``, ``library_cold_ms``: a 256 MB read before each call) and
``bound_share`` (bound over time); K2's lines cover every action allowed
(goal 0 and 85%) and the fleet's own mask (85%), with the kernel's
registers and spills; K6's lines name the plan's split of a channel's
states over lanes and the registers and spills of the instance that ran;
the build line gives each kernel function's registers and spills, and
each decode ``step_profile`` the port's kernels' device ms per step. A
``step_profile`` of one prefill of Falcon-Mamba d0 and of Hymba d0
attributes their device time to kernels (K6's share among them). The
line before the card's name lists every kernel with its launches on its
path, its error against the plain version, its time beside the plain
version's, its bound and, where one PyTorch call computes the same
function, that call's time. The last line is ``{"ok": true, "device":
{...}}``. It needs a CUDA device and the ``src/repro_torch`` package
beside it, and imports nothing of JAX.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# published peaks of one H100 SXM (dense, 700 W): HBM bytes/s; FP32 FLOP/s
# on the CUDA cores (K1, K2 compute in FP32 outside the tensor cores); the
# tensor cores' dense bf16 FLOP/s and int8 OP/s (the bound of K3-K5 by the
# type of their data)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12
INT8_TC_OPS_PER_S = 1979e12

CELLS, USERS = 32768, 5
# the serving path: requests per engine batch, prompt bucket, new tokens,
# cache length; the routed fleet
SERVE_BATCH, PROMPT, NEW_TOKENS, MAX_LEN = 64, 256, 16, 512
ROUTE_CELLS, ROUTE_USERS = 1024, 3
# the state-space path: the two configs, Falcon-Mamba's served variants,
# Hymba's batch and prompt (longer than its 1,024-token window), the
# routed fleet
SSM_ARCH, HYBRID_ARCH = "falcon-mamba-7b", "hymba-1.5b"
SSM_VARIANTS = ("d0", "d4")
HYBRID_BATCH, HYBRID_PROMPT = 8, 2048
HYBRID_MAX_LEN = HYBRID_PROMPT + NEW_TOKENS
SSM_ROUTE_CELLS = 256
# the exponentials' own rate: 16 per clock on each SM's special function
# units x 132 SMs x the 1.98 GHz boost clock (NVIDIA's Hopper white paper)
SFU_OPS_PER_S = 16 * 132 * 1.98e9
# bytes read between two calls of a cold-L2 reading: five times the 50 MB
# L2 cache
FLUSH_BYTES = 256 << 20
# the port's kernel functions, whose device time a step profile reports
OUR_KERNELS = ("tabular_rl_kernel", "dqn_head_kernel",
               "best_response_kernel", "flash_attention_tc_kernel",
               "flash_attention_kernel", "decode_partial_kernel",
               "decode_merge_kernel", "int8_matmul_kernel",
               "selective_scan_kernel")


def emit(**kw):
    print(json.dumps(kw), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, warmup=3, reps=20):
    """Median device time of ``fn`` in ms, from a CUDA event pair around
    each of ``reps`` calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def burst_ms(fn, n=10):
    """Device time per call of ``n`` back-to-back calls of ``fn`` between
    one CUDA event pair, after one warm-up call: the launches queue up
    while the kernel runs, so the host's gaps between calls drop out for
    a kernel longer than its launch."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def device_ms(fn, warmup=3, reps=20):
    """Mean device time per call of every CUDA kernel ``fn`` launches,
    from a ``torch.profiler`` trace (the kernels' own time, without the
    host's launch overhead). None when the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(us for _, us in device_events(prof))
    return total_us / reps / 1e3 if total_us > 0 else None


def device_events(prof):
    """(name, microseconds) of every device-side event of a trace."""
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def cold_ms(fn, reps=20):
    """Mean device time per call of the kernels ``fn`` launches with the
    L2 cache cold: a sum over a ``FLUSH_BYTES`` buffer runs before each
    call (as the model's call finds its inputs after the layers between
    have streamed their weights through the L2), and only the kernels
    named in a trace of one call of ``fn`` are counted, never the
    flush's. None when the traces hold no time of those kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    buf = torch.ones(FLUSH_BYTES // 4, device="cuda")

    def names(f):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            f()
            torch.cuda.synchronize()
        return {n for n, _ in device_events(prof)}
    fn()
    own = names(fn) - names(buf.sum)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            buf.sum()
            fn()
        torch.cuda.synchronize()
    total_us = sum(us for n, us in device_events(prof) if n in own)
    return total_us / reps / 1e3 if total_us > 0 else None


def ptxas_summary(log):
    """Registers and spill bytes of each function in ``nvcc -Xptxas -v``
    output: {function: [registers, spill store bytes, spill load
    bytes]}."""
    import re
    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
            out.setdefault(fn, [None, 0, 0])
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and fn:
            out[fn][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            out[fn][0] = int(m.group(1))
    return out


def profile_window(torch, run):
    """One ``torch.profiler`` window around ``run()``: (host wall us, to
    the device's end; {kernel name: device us})."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for n, us in device_events(prof):
        by_name[n] = by_name.get(n, 0.0) + us
    return wall_us, by_name


def step_profile(torch, run, steps=5, top=5, **label):
    """Device busy share of ``run()`` (``steps`` steps of a path) and the
    ``top`` kernels with the most device time, from one ``torch.profiler``
    window."""
    wall_us, by_name = profile_window(torch, run)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    ours = {}
    for n, us in by_name.items():
        for k in OUR_KERNELS:
            if k + "<" in n or n.endswith(k) or k + "(" in n:
                ours[k] = ours.get(k, 0.0) + us / steps / 1e3
                break
    emit(phase="step_profile", **label, steps=steps,
         wall_ms_per_step=wall_us / steps / 1e3,
         device_ms_per_step=busy / steps / 1e3,
         device_busy_share=busy / wall_us if wall_us else None,
         top_kernels=[[n[:80], us / steps / 1e3] for n, us in top],
         our_kernels_ms_per_step=ours,
         our_kernels_share_of_device={k: v * steps * 1e3 / busy
                                      for k, v in ours.items()}
         if busy else None)


def timed(fn, warmup=3, reps=20):
    """(ms, wall_ms, source): the profiler's device time per call where
    the trace has it, else the CUDA-event time; and the CUDA-event time
    per call, which includes the host's launch overhead."""
    wall = time_ms(fn, warmup, reps)
    dev = device_ms(fn, warmup, reps)
    return (dev, wall, "profiler") if dev is not None else \
        (wall, wall, "events")


def bound(bytes_moved, ops, ops_per_s=FP32_OPS_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- K1 ----
def tabular_phase(torch, tabular_rl, ref):
    """K1 at 32,768 cells x 36 states x 243 actions, with forced ties and
    half the cells on s2 == s."""
    cells, n_states, k = CELLS, 36, 243
    g = torch.Generator(device="cuda").manual_seed(1)
    q0 = torch.randn((cells, n_states, k), generator=g, device="cuda")
    q0[: cells // 4] = torch.round(q0[: cells // 4] * 2) / 2   # ties
    q0[: 64] = 1.0                                             # all tied
    s = torch.randint(0, n_states, (cells,), generator=g,
                      device="cuda").int()
    a = torch.randint(0, k, (cells,), generator=g, device="cuda").int()
    s2 = torch.randint(0, n_states, (cells,), generator=g,
                       device="cuda").int()
    s2 = torch.where(torch.arange(cells, device="cuda") % 2 == 0, s, s2)
    r = -torch.rand(cells, generator=g, device="cuda")
    kw = dict(alpha=0.9, gamma=0.1)
    q_k, g_k, td_k = tabular_rl.tabular_rl_cuda(q0.clone(), s, a, r, s2,
                                                **kw)
    q_p, g_p, td_p = ref.fused_tabular_ref(q0.clone(), s, a, r, s2, **kw)
    torch.cuda.synchronize()
    check(torch.equal(g_k, g_p), "tabular_rl: greedy2 differs")
    err = max(float((q_k - q_p).abs().max()), float((td_k - td_p).abs().max()))
    check(err <= 1e-6, f"tabular_rl: q/td differ by {err}")
    qk, qp = q0.clone(), q0.clone()
    ms, wall_ms, src = timed(
        lambda: tabular_rl.tabular_rl_cuda(qk, s, a, r, s2, **kw))
    plain_ms, plain_wall_ms, _ = timed(
        lambda: ref.fused_tabular_ref(qp, s, a, r, s2, **kw))
    # what the function must move: row s2 and q[s, a] read, q[s, a]
    # written, s/a/r/s2 in, greedy2/td out; ~2 compares per row entry
    b_ms, b_by = bound(cells * (4 * k + 4 + 4 + 16 + 8), cells * 2 * k)
    entry = dict(name="tabular_rl", route="cuda",
                 source="src/repro_torch/csrc/tabular_rl.cu",
                 replaces="src/repro/kernels/tabular_rl.py:58",
                 max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                 bound_by=b_by, library_ms=None)
    emit(phase="kernel_parity", kernel="tabular_rl",
         shape=[cells, n_states, k], greedy2_equal=True, max_abs_err=err,
         tolerance=1e-6, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
         bound_by=b_by, timing=src, wall_ms=wall_ms,
         plain_wall_ms=plain_wall_ms)
    return entry


# ----------------------------------------------------------------- K2 ----
def head_margins(torch, ref, q, member, acc_table, threshold, topk):
    """Per cell, the smallest gap that a few-ulp change of q could flip:
    adjacent gaps among each member user's top-(k+1) values and, with a
    threshold, the gap between the two best distinct combo scores."""
    top = torch.sort(q, dim=-1, descending=True).values[..., :topk + 1]
    # masked entries (all -1e30) tie among themselves and are never picked
    gaps = torch.where(top[..., 1:] > -1e29, top[..., :-1] - top[..., 1:],
                       torch.inf).amin(-1)                  # (cells, N)
    gaps = torch.where(member > 0.5, gaps, torch.inf).amin(-1)
    if not threshold:
        return gaps
    score, _, combos = ref.combo_scores_ref(q, member, acc_table,
                                            threshold=threshold, topk=topk)
    # combos that differ only in a non-member's digit tie exactly and are
    # settled by index on both sides: compare each distinct score once
    dup = ((combos[None] != 0) & (member[:, None, :] < 0.5)).any(-1)
    score = torch.where(dup, -torch.inf, score)
    best2 = torch.topk(score, 2, dim=-1).values
    s_gap = torch.where(torch.isfinite(best2[:, 0]),
                        best2[:, 0] - best2[:, 1], torch.inf)
    return torch.minimum(gaps, torch.nan_to_num(s_gap, nan=torch.inf))


def head_inputs(torch, dynamics, spaces, hidden=128):
    """K2's inputs at the fleet's shape, drawn on the card from seed 2:
    ``(active, member, end_b, agg, w1, b1, w2, b2, w3, b3, acc_table)``
    and the allowed masks ``{"all": every action, "fleet": the
    restricted offloading set's 3 of 10}``."""
    cells, users = CELLS, USERS
    g = torch.Generator(device="cuda").manual_seed(2)
    member = (torch.rand((cells, users), generator=g, device="cuda") < 0.8)
    member[:, 0] = True
    active = (member & (torch.rand((cells, users), generator=g,
                                   device="cuda") < 0.7)).float()
    member = member.float()
    end_b = (torch.rand((cells, users), generator=g, device="cuda")
             < 0.5).float()
    agg = torch.rand((cells, 8), generator=g, device="cuda")
    dims = [11, hidden, hidden, 10]
    ws = [torch.randn((a, b), generator=g, device="cuda") * (2.0 / a) ** 0.5
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.randn(b, generator=g, device="cuda") * 0.05 for b in dims[1:]]
    spec = spaces.SpaceSpec(users)
    masks = {"all": torch.ones((users, 10), device="cuda"),
             "fleet": torch.tensor(spaces.allowed_per_user(
                 spec, spaces.restricted_actions(spec)),
                 device="cuda").float()}
    acc_table = dynamics.accuracies(torch.arange(10, device="cuda"))
    return (active, member, end_b, agg, ws[0], bs[0], ws[1], bs[1], ws[2],
            bs[2], acc_table), masks


def head_phase(torch, dqn_head, ref, dynamics, spaces, ptxas):
    """K2 at the fleet's shape (32,768 cells x 5 users, hidden 128,
    top-5): at goal 0 and at the 85% goal with every action allowed, and
    at 85% under the fleet's own mask (the restricted offloading set: 3 of
    10 actions a user). Each line gives the registers and spill bytes
    ptxas gave the kernel (``ptxas``: ``ptxas_summary`` of K2's build)."""
    cells, users, hidden, topk = CELLS, USERS, 128, 5
    inputs, masks = head_inputs(torch, dynamics, spaces)
    member, acc_table = inputs[1], inputs[-1]
    ws, bs = inputs[4:10:2], inputs[5:10:2]         # (w1, w2, w3), biases
    rows = cells * users
    mlp_ops = rows * 2 * (11 * hidden + hidden * hidden + hidden * 10)
    io_bytes = (rows * 3 * 4 + cells * 8 * 4
                + 4 * sum(w.numel() for w in ws + bs) + 4 * 10 * (users + 1)
                + rows * 4 + rows * 10 * 4)
    n_mem = member.sum(-1)
    regs = [v for f, v in ptxas.items() if "dqn_head_kernel" in f]
    out = {}
    for mask, threshold in (("all", 0.0), ("all", 85.0), ("fleet", 85.0)):
        allowed = masks[mask]
        args = inputs[:-1] + (allowed, acc_table)
        kw = dict(threshold=threshold, topk=topk)
        d_k, q_k = dqn_head.dqn_head_cuda(*args, **kw)
        d_p, q_p = ref.dqn_head_ref(*args, **kw)
        torch.cuda.synchronize()
        err = float((q_k - q_p).abs().max())
        check(err <= 1e-5, f"dqn_head: q differs by {err} at {threshold}, "
              f"{mask} allowed")
        margin = head_margins(torch, ref, q_p, member, acc_table, threshold,
                              topk)
        clear = margin > 1e-4
        differ = (d_k != d_p).any(-1)
        n_bad = int((differ & clear).sum())
        check(n_bad == 0, f"dqn_head: {n_bad} cells with clear margins "
              f"decide differently at threshold {threshold}, {mask} "
              "allowed")
        # and bit-exact on EVERY cell against the plain decision logic
        # applied to the kernel's own q (no product rounding in the way)
        d_own = ref.greedy_head_ref(q_k, member, acc_table, **kw)
        check(torch.equal(d_k, d_own), "dqn_head: decisions differ from "
              f"the plain logic on the kernel's q at {threshold}, {mask} "
              "allowed")
        ms, wall_ms, src = timed(lambda: dqn_head.dqn_head_cuda(*args, **kw))
        plain_ms, plain_wall_ms, _ = timed(
            lambda: ref.dqn_head_ref(*args, **kw))
        if not threshold:
            combo_ops = 0
        elif mask == "all":     # every cell's k^N combos, as first counted
            combo_ops = cells * topk ** users * users * 2
        else:                   # what the mask leaves: 3 digits a member
            kv = int(allowed[0].sum())
            combo_ops = int((n_mem * kv ** n_mem * 2).sum())
        b_ms, b_by = bound(io_bytes, mlp_ops + combo_ops)
        out[mask, threshold] = dict(max_abs_err=err, ms=ms,
                                    plain_ms=plain_ms, bound_ms=b_ms,
                                    bound_by=b_by)
        emit(phase="kernel_parity", kernel="dqn_head", threshold=threshold,
             allowed=mask, shape=[cells, users, hidden], q_tolerance=1e-5,
             max_abs_err=err, cells_under_margin=int((~clear).sum()),
             cells_differing=int(differ.sum()), ms=ms, plain_ms=plain_ms,
             bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms,
             cold_ms=cold_ms(lambda: dqn_head.dqn_head_cuda(*args, **kw)),
             timing=src, wall_ms=wall_ms, plain_wall_ms=plain_wall_ms,
             ptxas=regs[0] if regs else None)
    main = out["all", 85.0]           # the DQN phase's QoS operating point
    return dict(name="dqn_head", route="cuda",
                source="src/repro_torch/csrc/dqn_head.cu",
                replaces="src/repro/kernels/dqn_head.py:116",
                library_ms=None, **main)


# ------------------------------------------------------------ K3-K5 ----
#: (name, batch, sequence or cache slots, q heads, kv heads, head dim,
#: window): the edge ladder's d0/d4 and d7 layouts at prompt buckets 32
#: and 256 (caches of 64 and 512 slots), and Hymba's at its 2,048-token
#: prompt, global and sliding (window 1,024; at decode the global cache's
#: 2,064 slots and the sliding layers' 1,024-slot ring)
FLASH_CASES = tuple((name, SERVE_BATCH, s, h, kv, 32, 0)
                    for name, h, kv in (("d0/d4", 8, 4), ("d7", 2, 2))
                    for s in (32, PROMPT)) + (
    ("hymba global", HYBRID_BATCH, HYBRID_PROMPT, 25, 5, 64, 0),
    ("hymba sliding", HYBRID_BATCH, HYBRID_PROMPT, 25, 5, 64, 1024))
DECODE_CASES = tuple((name, SERVE_BATCH, sc, h, kv, 32, 0)
                     for name, h, kv in (("d0/d4", 8, 4), ("d7", 2, 2))
                     for sc in (64, MAX_LEN)) + (
    ("hymba global", HYBRID_BATCH, HYBRID_MAX_LEN, 25, 5, 64, 0),
    ("hymba sliding", HYBRID_BATCH, 1024, 25, 5, 64, 1024))
#: (M, K, N) of K5: M = 64 x 256 tokens for every projection of the edge
#: ladder's d4 (wq/wo, wk/wv, gate/up, down) and d7 (wq/wk/wv, wo,
#: gate/up/down); Falcon-Mamba d4's in_proj and out_proj at its prefill
#: (64 x 256 tokens) and at decode (64 tokens); the edge ladder d4's MLP
#: at decode (gate/up, down)
INT8_SHAPES = tuple((SERVE_BATCH * PROMPT, k, n) for k, n in (
    (256, 256), (256, 128), (256, 1024), (1024, 256), (256, 64),
    (64, 256))) + ((SERVE_BATCH * PROMPT, 4096, 16384),
                   (SERVE_BATCH * PROMPT, 8192, 4096),
                   (SERVE_BATCH, 4096, 16384), (SERVE_BATCH, 8192, 4096),
                   (SERVE_BATCH, 256, 1024), (SERVE_BATCH, 1024, 256))
ATTN_TOL = {"bfloat16": 2e-2, "float32": 2e-5}


def sdpa(torch, q, k, v, **kw):
    """``F.scaled_dot_product_attention`` on the model's (B, S, H, hd)
    layout (transposed views), GQA enabled — timed as the library's
    counterpart of K3/K4, never on the path."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        enable_gqa=True, **kw)


def flash_phase(torch, flash_attention, cases=FLASH_CASES, path="serving"):
    """K3, causal, at every case of ``cases``; bf16 (the path's type) and
    float32. Returns the kernels-line entry when ``cases`` hold the
    serving path's main shape, else None."""
    g = torch.Generator(device="cuda").manual_seed(5)
    errs, main = [], None
    for name, b, s, h, kv, hd, window in cases:
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q, k, v = (torch.randn(shape, generator=g, device="cuda")
                       .to(dt) for shape in ((b, s, h, hd), (b, s, kv, hd),
                                             (b, s, kv, hd)))
            got = flash_attention.flash_attention_cuda(q, k, v,
                                                       window=window)
            want = flash_attention.plain(q, k, v, window=window)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tol = ATTN_TOL[dtype]
            check(err <= tol, f"flash_attention {name} S={s} {dtype}: "
                  f"error {err} > {tol}")
            errs.append(err)
            if dtype != "bfloat16":
                continue
            ms, wall_ms, src = timed(lambda: flash_attention
                                     .flash_attention_cuda(q, k, v,
                                                           window=window))
            plain_ms, _, _ = timed(lambda: flash_attention.plain(
                q, k, v, window=window))
            qp = torch.arange(s, device="cuda")[:, None]
            kp = torch.arange(s, device="cuda")[None, :]
            band = (kp <= qp) & ((kp > qp - window) if window else True)

            def lib():
                return sdpa(torch, q, k, v, **(
                    {"attn_mask": band} if window else {"is_causal": True}))
            lib_ms, _, _ = timed(lib)
            # q, k, v read once, o written once (bf16); the products the
            # data needs: 2 * 2 * hd per (q, k) pair the mask keeps
            nbytes = 2 * b * s * hd * (2 * h + 2 * kv)
            pairs = int(band.sum())
            b_ms, b_by = bound(nbytes, 4 * hd * b * h * pairs,
                               BF16_TC_OPS_PER_S)
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=lib_ms,
                       cold_ms=cold_ms(lambda: flash_attention
                                       .flash_attention_cuda(
                                           q, k, v, window=window)),
                       library_cold_ms=cold_ms(lib),
                       bound_share=b_ms / ms)
            emit(phase="kernel_parity", kernel="flash_attention", path=path,
                 layout=name, shape=[b, s, h, kv, hd], window=window,
                 dtype=dtype, max_abs_err=err, tolerance=tol, timing=src,
                 wall_ms=wall_ms, **row)
            if name == "d0/d4" and s == PROMPT:
                main = row
    if main is None:
        return None
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:84",
                max_abs_err=max(errs), **main)


def decode_phase(torch, ops, decode_attention, cases=DECODE_CASES,
                 path="serving"):
    """K4 at every case of ``cases``: the edge ladder's caches written
    half way (the ring's unwritten slots masked by the bias), Hymba's
    full at its last position, the sliding ring wrapped. Returns the
    kernels-line entry when ``cases`` hold the serving path's main shape,
    else None."""
    g = torch.Generator(device="cuda").manual_seed(6)
    errs, main = [], None
    for name, b, sc, h, kv, hd, window in cases:
        idx = torch.arange(sc, device="cuda")[None].repeat(b, 1)
        if window or sc == HYBRID_MAX_LEN:
            cur = torch.full((b,), HYBRID_MAX_LEN - 1, device="cuda")
            kv_pos = cur[:, None] - (cur[:, None] - idx) % sc
        else:
            kv_pos = idx.masked_fill(idx >= sc // 2, -1)
            cur = torch.randint(sc // 4, sc // 2, (b,), generator=g,
                                device="cuda")
        valid = (kv_pos >= 0) & (kv_pos <= cur[:, None])
        if window:
            valid &= kv_pos > cur[:, None] - window
        bias = torch.where(valid, 0.0, -1e30)
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q = torch.randn((b, h, hd), generator=g, device="cuda").to(dt)
            kc, vc = (torch.randn((b, sc, kv, hd), generator=g,
                                  device="cuda").to(dt) for _ in range(2))
            got = ops.decode_attention(q, kc, vc, kv_pos, cur, window=window)
            want = decode_attention.plain(q, kc, vc, bias)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tol = ATTN_TOL[dtype]
            check(err <= tol, f"decode_attention {name} Sc={sc} "
                  f"{dtype}: error {err} > {tol}")
            errs.append(err)
            if dtype != "bfloat16":
                continue
            ms, wall_ms, src = timed(
                lambda: decode_attention.decode_attention_cuda(
                    q, kc, vc, bias))
            plain_ms, _, _ = timed(
                lambda: decode_attention.plain(q, kc, vc, bias))
            mask = bias.to(dt)[:, None, None, :]

            def lib():
                return sdpa(torch, q[:, None], kc, vc, attn_mask=mask)
            lib_ms, _, _ = timed(lib)
            # both caches read whole (bf16), q and o, the f32 bias row;
            # 2 * 2 * hd per (head, slot)
            nbytes = 2 * 2 * b * sc * kv * hd + 2 * 2 * b * h * hd \
                + 4 * b * sc
            b_ms, b_by = bound(nbytes, 4 * hd * b * h * sc,
                               BF16_TC_OPS_PER_S)
            splits, _ = decode_attention.split_plan(b, kv, sc, h // kv)
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=lib_ms,
                       cold_ms=cold_ms(lambda: decode_attention
                                       .decode_attention_cuda(
                                           q, kc, vc, bias)),
                       library_cold_ms=cold_ms(lib),
                       bound_share=b_ms / ms, blocks=b * kv * splits)
            emit(phase="kernel_parity", kernel="decode_attention",
                 path=path, layout=name, shape=[b, sc, h, kv, hd],
                 window=window, dtype=dtype, max_abs_err=err, tolerance=tol, timing=src,
                 wall_ms=wall_ms, **row)
            if name == "d0/d4" and sc == MAX_LEN:
                main = row
            if name.startswith("hymba"):
                check(row["blocks"] >= 2 * decode_attention.SMS,
                      f"decode_attention {name}: {row['blocks']} blocks < "
                      f"2 x {decode_attention.SMS} SMs")
    if main is None:
        return None
    return dict(name="decode_attention", route="cuda",
                source="src/repro_torch/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:72",
                max_abs_err=max(errs), **main)


def int8_phase(torch, ref, int8_matmul, shapes=INT8_SHAPES, path="serving"):
    """K5 at every shape of ``shapes`` on a K-major weight (the layout the
    model holds): bit-exact against the plain version in float32 and in
    bfloat16; timed in bfloat16, the path's output type, warm and with
    the L2 cold, beside ``torch._int_mm`` + dequant to the same type (a
    library call that takes no fewer than 17 rows, so at fewer it is
    timed on the rows padded to 17 with zeros). Returns the kernels-line
    entry when ``shapes`` hold the serving path's main shape, else
    None."""
    g = torch.Generator(device="cuda").manual_seed(7)
    main = None
    for m, k, n in shapes:
        xq, sx = ref.quantize_ref(torch.randn((m, k), generator=g,
                                              device="cuda"))
        wq, sw = ref.quantize_ref(torch.randn((k, n), generator=g,
                                              device="cuda"), dim=0)
        wq = int8_matmul.k_major(wq)
        for dt in (torch.float32, torch.bfloat16):
            got = int8_matmul.int8_matmul_cuda(xq, sx, wq, sw, dt)
            want = int8_matmul.plain(xq, sx, wq, sw, dt)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"int8_matmul {m}x{k}x{n} {dt}: "
                  f"not bit-exact (max err "
                  f"{float((got.float() - want.float()).abs().max())})")
        bf16 = torch.bfloat16

        def kern():
            return int8_matmul.int8_matmul_cuda(xq, sx, wq, sw, bf16)

        xl, sxl = xq, sx
        if m <= 16:
            xl = torch.cat([xq, xq.new_zeros((17 - m, k))])
            sxl = torch.cat([sx, sx.new_zeros((17 - m, 1))])

        def lib():
            return (torch._int_mm(xl, wq).to(torch.float32) * sxl * sw)[
                :m].to(bf16)
        ms, wall_ms, src = timed(kern)
        plain_ms, _, _ = timed(lambda: int8_matmul.plain(xq, sx, wq, sw,
                                                         bf16))
        lib_ms, _, _ = timed(lib)
        # x, w and both scales read once, the bf16 output written once
        nbytes = m * k + k * n + 4 * (m + n) + 2 * m * n
        b_ms, b_by = bound(nbytes, 2 * m * k * n, INT8_TC_OPS_PER_S)
        bm, bn = int8_matmul.plan(m, n, k)
        row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=lib_ms, cold_ms=cold_ms(kern),
                   library_cold_ms=cold_ms(lib), bound_share=b_ms / ms,
                   blocks=-(-m // bm) * -(-n // bn))
        emit(phase="kernel_parity", kernel="int8_matmul", path=path,
             shape=[m, k, n], library_rows=xl.shape[0],
             dtype="bfloat16", bit_exact=["float32", "bfloat16"],
             max_abs_err=0.0, tile=[bm, bn], timing=src, wall_ms=wall_ms,
             **row)
        if (m, k, n) == (SERVE_BATCH * PROMPT, 256, 1024):
            main = row
    if main is None:
        return None
    return dict(name="int8_matmul", route="cuda",
                source="src/repro_torch/csrc/int8_matmul.cu",
                replaces="src/repro/kernels/int8_matmul.py:40",
                max_abs_err=0.0, **main)


# ----------------------------------------------------------------- K6 ----
#: (label, Bt, S, di, u's type): the Falcon-Mamba d0/d4 prefill (batch 64
#: x 256 tokens), the Hymba prefill (batch 8 x 2,048 tokens, di = 3,200 no
#: multiple of the kernel's block), and Hymba's once with float32 u
SCAN_CASES = (("falcon", SERVE_BATCH, PROMPT, 8192, "bfloat16"),
              ("hymba", HYBRID_BATCH, HYBRID_PROMPT, 3200, "bfloat16"),
              ("hymba", HYBRID_BATCH, HYBRID_PROMPT, 3200, "float32"))
SCAN_STATE = 16
#: y: float32 within 1e-4 (tests/test_kernels.py); bf16 within one bf16
#: step, absolute and relative. h_last (float32 on both) within 1e-4
SCAN_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
#: u's type in the mangled names of K6's kernel instances
#: (``selective_scan_kernel<T, lanes>``), by the case's type
SCAN_TYPES = {"bfloat16": "13__nv_bfloat16", "float32": "f"}


def scan_phase(torch, selective_scan, ptxas):
    """K6 at the state-space path's prefill shapes, inputs drawn as the
    reference's scan tests draw them; each line names the plan's split of
    a channel's states over lanes and the registers and spill bytes ptxas
    gave the kernel instance that ran (``ptxas``: ``ptxas_summary`` of
    K6's build)."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(8)
    n = SCAN_STATE
    errs, main = [], None
    for label, bt, s, di, dtype in SCAN_CASES:
        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda")
        u = (rnd(bt, s, di) * 0.5).to(getattr(torch, dtype))
        dt = F.softplus(rnd(bt, s, di)) * 0.1
        args = (u, dt, -torch.exp(rnd(di, n) * 0.3), rnd(bt, s, n),
                rnd(bt, s, n), rnd(di))
        y, h = selective_scan.selective_scan_cuda(*args)
        y2, h2 = selective_scan.plain(*args)
        torch.cuda.synchronize()
        tol = SCAN_TOL[dtype]
        dy = (y.float() - y2.float()).abs()
        err_y, err_h = float(dy.max()), float((h - h2).abs().max())
        check(bool((dy <= tol + tol * y2.float().abs()).all()) and
              err_h <= 1e-4, f"selective_scan {label} {dtype}: y error "
              f"{err_y} (tolerance {tol} + {tol} relative), h_last error "
              f"{err_h} (tolerance 1e-4)")
        errs += [err_y, err_h]
        lanes, per_lane = selective_scan.plan(bt, di, n)
        inst = f"selective_scan_kernelI{SCAN_TYPES[dtype]}Li{lanes}EE"
        regs = [v for f, v in ptxas.items() if inst in f]
        line = dict(kernel="selective_scan", layout=label,
                    shape=[bt, s, di, n], dtype=dtype, max_abs_err_y=err_y,
                    max_abs_err_h=err_h, tolerance_y=tol, tolerance_h=1e-4,
                    lanes=lanes, states_per_lane=per_lane,
                    blocks=bt * -(-di // (selective_scan.THREADS // lanes)),
                    ptxas=regs[0] if regs else None)
        if dtype != "bfloat16":
            emit(phase="kernel_parity", **line)
            continue
        ms, wall_ms, src = timed(
            lambda: selective_scan.selective_scan_cuda(*args))
        plain_ms, _, _ = timed(lambda: selective_scan.plain(*args),
                               warmup=1, reps=5)
        # u, dt read and y written once per (batch, step, channel); A, D,
        # B, C read and h_last written once. Per state: dt*A, the
        # exponential (one operation here), h*dA + du*B, the C product and
        # its sum; per channel: dt*u, u*D and its add
        exps = bt * s * di * n
        nbytes = bt * s * di * (2 * u.element_size() + 4) \
            + 4 * (di * n + di + 2 * bt * s * n + bt * di * n)
        b_ms, b_by = bound(nbytes, 7 * exps + 3 * bt * s * di)
        row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=None)
        # the time the special function units alone need when every
        # exponential runs there, as this kernel's do
        emit(phase="kernel_parity", **line, timing=src, wall_ms=wall_ms,
             sfu_ms=exps / SFU_OPS_PER_S * 1e3, **row)
        if label == "falcon":
            main = row
    return dict(name="selective_scan", route="cuda",
                source="src/repro_torch/csrc/selective_scan.cu",
                replaces="src/repro/kernels/selective_scan.py:47",
                max_abs_err=max(errs), **main)


# -------------------------------------------------------------- paths ----
def tabular_agent(R, metrics):
    """The tabular phase's agent: ``FleetQLearning`` on a 32,768-cell
    mixed Table-5 fleet of 5 users."""
    scen = R.scenarios.mixed_table5_fleet(R.Draws(3, "cuda"), CELLS, USERS)
    return R.population.FleetQLearning(
        scen, R.scenarios.FleetConfig(cells=CELLS, users=USERS), seed=0,
        device="cuda", metrics=metrics)


def tabular_training(torch, R):
    # metrics off: the loop as earlier runs timed it (phase
    # metrics_overhead times the recording)
    agent = tabular_agent(R, metrics=False)
    check(tuple(agent.q.shape) == (CELLS, 36, 243), "Q-table shape")
    agent.run(5)                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms, acc = agent.run(500)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(bool((ms > 0).all()) and len(ms) == 500, "tabular ms trace")
    g_ms, g_acc = agent.greedy_expected()
    opt_ms, _ = R.population.fleet_bruteforce(agent.scen, agent.pu_table)
    opt_ms = opt_ms.cpu().numpy()
    check(bool((g_ms >= opt_ms * (1 - 1e-5)).all()),
          "a greedy decision beats the brute-force optimum")
    agree = float((g_ms <= opt_ms * 1.01).mean())
    dec, ids = R.api.FleetOrchestrator(agent).route()
    torch.cuda.synchronize()
    check(tuple(dec.shape) == (CELLS, USERS), "routed decision shape")
    check(bool(((dec == 0) | (dec == 8) | (dec == 9)).all()),
          "tabular decisions outside the restricted action set")
    emit(phase="tabular_training", cells=CELLS, users=USERS, steps=500,
         seconds=secs, cell_steps_per_s=CELLS * 500 / secs,
         frac_within_1pct_of_oracle=agree,
         mean_greedy_ms=float(g_ms.mean()), mean_optimal_ms=float(
             opt_ms.mean()), q_table_gb=agent.q.numel() * 4 / 1e9)
    return agent


def dqn_agent(R, metrics=False, calib=None):
    """The DQN phase's agent: ``FleetDQN`` (hidden 128, top-5 head at the
    85% goal) on a dynamic 32,768-cell synthetic fleet of 5 users, the
    fleet's latency model calibrated by ``calib`` when given."""
    cfg = R.scenarios.FleetConfig(cells=CELLS, users=USERS, arrival_rate=1.2,
                                  p_r2w=0.05, p_w2r=0.15, min_users=2,
                                  max_users=5)
    src = R.api.SyntheticSource(cfg)
    if calib is not None:
        src = R.calibrate.CalibratedDynamics(src, calib)
    # the policy spans the oracle's candidate set (the restricted 3^5
    # offloading actions), so the holdout ratio is bounded by 1: over the
    # full 10^5 space the greedy can beat that oracle
    return R.policy.FleetDQN(
        src, actions=R.population.default_actions(
            R.population.SpaceSpec(USERS)),
        cfg=R.policy.FleetDQNConfig(hidden=128, topk=5,
                                    accuracy_threshold=85.0),
        seed=0, device="cuda", metrics=metrics)


def dqn_training(torch, R):
    agent = dqn_agent(R)
    agent.run(3)                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms, acc = agent.run(300)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(bool(torch.isfinite(torch.tensor(ms)).all()), "DQN ms trace")
    held = R.scenarios.mixed_table5_fleet(R.Draws(7, "cuda"), CELLS, USERS,
                                          min_users=1, max_users=5)
    ev = R.policy.holdout_reward_ratio(agent, held)
    check(0.0 < ev.ratio <= 1.05, f"holdout ratio {ev.ratio}")
    res = R.api.FleetOrchestrator(agent).route(scen=held,
                                               with_edge_util=True,
                                               as_result=True)
    torch.cuda.synchronize()
    check(tuple(res.decisions.shape) == (CELLS, USERS), "routed shape")
    emit(phase="dqn_training", cells=CELLS, users=USERS, steps=300,
         seconds=secs, cell_steps_per_s=CELLS * 300 / secs,
         holdout_reward_ratio=ev.ratio,
         holdout_feasible_frac=float(ev.feasible.mean()),
         replay_rows=len(agent.buffer))
    return agent


def cpu_agreement(torch, R):
    """The loop on the card against the same loop on the CPU (plain
    versions) on a small fleet under the same recorded draws."""
    import numpy as np

    class Fixed(R.Draws):
        def __init__(self, device, arrays):
            super().__init__(0, device)
            self.arrays = list(arrays)

        def uniform(self, site, shape):
            return torch.tensor(self.arrays.pop(0), device=self.device)

        normal = uniform

    cells, n = 512, 40
    rng = np.random.default_rng(0)
    draws = [rng.random(cells, dtype=np.float32) if i % 2 == 0 else
             rng.standard_normal(cells, dtype=np.float32)
             for i in range(2 * n + 1)]
    out = []
    for dev in ("cuda", "cpu"):
        scen = R.scenarios.mixed_table5_fleet(R.Draws(4, "cpu"), cells, 3,
                                              min_users=1, max_users=3)
        scen = R.scenarios.FleetScenario(
            *(getattr(scen, f).to(dev) for f in ("end_b", "edge_b",
                                                 "member", "active")), 0)
        agent = R.population.FleetQLearning(
            scen, R.scenarios.FleetConfig(cells=cells, users=3),
            device=dev, draws=Fixed(dev, draws))
        agent.run(n)
        out.append((agent.q.cpu(), agent.greedy_decisions().cpu()))
    err = float((out[0][0] - out[1][0]).abs().max())
    same = float((out[0][1] == out[1][1]).all(-1).float().mean())
    check(err <= 1e-4 and same >= 0.99,
          f"card vs CPU loop: q err {err}, decisions agree {same}")
    emit(phase="cpu_agreement", cells=cells, steps=n, q_max_abs_err=err,
         decisions_agree=same)


def route_fleet(R, cells=ROUTE_CELLS, seed=11):
    """The routed fleet: ``cells`` cells of 1-3 users over the Table-5
    link mixes."""
    return R.scenarios.mixed_table5_fleet(R.Draws(seed, "cuda"), cells,
                                          ROUTE_USERS, min_users=1,
                                          max_users=ROUTE_USERS)


def active_users(scen):
    """The set of (cell, user) that send a request in ``scen``."""
    import numpy as np
    return set(zip(*(a.tolist() for a in np.nonzero(
        scen.active.cpu().numpy()))))


def check_route(res, want, label, overloaded=False):
    """The identities of a dispatched route: every active user of
    ``want`` served exactly once (through the bridge: served or shed,
    never both, and with no shed unless ``overloaded``), ``batching +
    compute + dispatch == wall`` (``dispatch >= 0`` on the synchronous
    path), ``queue + measured == e2e`` and ``attained + violated ==
    dispatched``."""
    keys = [(r.cell, r.user) for r in res.served]
    check(len(keys) == len(set(keys)), f"{label}: a request served twice")
    st = res.bridge
    if st is None:
        check(set(keys) == want,
              f"{label}: the active users were not served exactly once")
    else:
        shed = st["shed"]
        check(st["submitted"] == st["admitted"] + shed["overflow"]
              + shed["deadline"] == len(want),
              f"{label}: submitted != admitted + overflow + deadline")
        check(st["served"] + shed["total"] == st["submitted"]
              and st["served"] == len(keys),
              f"{label}: served + shed != submitted")
        lost = {(sr["cell"], sr["user"]) for sr in st["shed_requests"]}
        check(len(lost) == shed["total"] and not lost & set(keys)
              and lost | set(keys) == want,
              f"{label}: an active user neither served nor shed once")
        check(not st["engine_errors"],
              f"{label}: an engine raised: {st['engine_errors']}")
        if not overloaded:
            check(st["timeouts"] == st["rerouted"] == shed["total"] == 0,
                  f"{label}: timeouts {st['timeouts']}, rerouted "
                  f"{st['rerouted']}, shed {shed}")
    t = res.timings
    check(abs(t["batching_ms"] + t["compute_ms"] + t["dispatch_ms"]
              - t["wall_ms"]) <= 1e-6 * t["wall_ms"]
          and (st is not None or t["dispatch_ms"] >= 0),
          f"{label}: batching + compute + dispatch != wall")
    check(all(abs(r.queue_ms + r.measured_ms - r.e2e_ms) <= 1e-9
              for r in res.served), f"{label}: queue + measured != e2e")
    slo = res.slo()
    check(slo["measured"]["attained"] + slo["measured"]["violated"]
          == slo["requests"] == len(keys),
          f"{label}: attained + violated != dispatched")


def route_dispatch(torch, R, engines, cells=ROUTE_CELLS,
                   phase="route_dispatch", seed=11):
    """A ``cells``-cell 3-user mixed Table-5 fleet (the full 10^3 joint
    space) routed into the engines in batches of 64 by the oracle at
    goals 0 and 85; then, for each engine the oracle left idle, the
    fixed strategy that targets it (local dk, edge or cloud), so that
    every engine of ``build_engines`` serves."""
    scen = route_fleet(R, cells, seed)
    want = active_users(scen)
    served_by = {}

    def route(label, policy):
        res = R.api.FleetOrchestrator(policy).route(
            scen=scen, dispatch=engines, batch_size=SERVE_BATCH)
        check_route(res, want, label)
        t, slo = res.timings, res.slo()
        per = res.timings["per_tier_variant"]
        for key, tv in per.items():
            served_by[key] = served_by.get(key, 0) + tv["requests"]
        emit(phase=phase, policy=label, cells=cells,
             users=ROUTE_USERS, requests=len(res.served),
             batches=res.batches, gap_x=res.gap_x,
             wall_ms=t["wall_ms"], compute_ms=t["compute_ms"],
             per_tier_variant={k: {"requests": v["requests"],
                                   "batches": v["batches"],
                                   "compute_ms": v["compute_ms"]}
                               for k, v in per.items()},
             attainment=slo["measured"]["attainment"])

    for goal in (0.0, 85.0):
        route(f"oracle@{goal:g}",
              R.api.OraclePolicy(ROUTE_USERS, threshold=goal))
    target = {"E/d0": "edge", "C/d0": "cloud"}
    for key in sorted(f"{t}/{v}" for t, tier in engines.items()
                      for v in tier):
        if key not in served_by:
            strategy = target.get(key, int(key.split("/d")[1]))
            route(f"static {strategy}",
                  R.api.StaticPolicy(ROUTE_USERS, strategy))
    emit(phase=f"{phase}_coverage", served_by=served_by)


# ------------------------------------------------- the sim-to-real loop ----
#: per-batch network hop to the edge / cloud tiers (the reference's
#: benchmarks/bench_bridge.py HOP_MS)
HOP_MS = {"E": 25.0, "C": 50.0}
METRICS_STEPS, CALIB_STEPS = 100, 300
BRIDGE_TURNS = 3


class SpreadPolicy:
    """User slot u of every cell goes to (local d0, edge, cloud)[u % 3]:
    the S/E/C engines loaded evenly, as the reference's
    ``benchmarks/bench_bridge.py`` SpreadPolicy does."""

    def __init__(self, torch, dynamics):
        self.torch = torch
        self.acts = (0, dynamics.A_EDGE, dynamics.A_CLOUD)

    def decisions(self, counts, scen):
        torch, dev = self.torch, scen.device
        acts = torch.tensor(self.acts, dtype=torch.int32, device=dev)
        slot = torch.arange(scen.users, device=dev) % 3
        dec = acts[slot].expand(scen.cells, scen.users).contiguous()
        return dec, torch.zeros((scen.cells,), dtype=torch.int32, device=dev)


def spread_fleet(R):
    """ROUTE_CELLS cells of ROUTE_USERS users, every user a member and
    active (3,072 requests a route)."""
    return R.scenarios.init_fleet(
        R.Draws(17, "cuda"), R.scenarios.FleetConfig(cells=ROUTE_CELLS,
                                                     users=ROUTE_USERS))


def metrics_overhead(torch, R):
    """Each agent at 32,768 x 5 for METRICS_STEPS steps with metrics on
    and off, from the same seed and draws: wall ms per step (host clock
    around synchronised runs) and device ms per step (a 5-step profiler
    window) of each, the recorded counts, and the trained state held
    bit-identical; the DQN's against its own run-to-run spread, read from
    two runs with metrics off."""
    steps = 3 + METRICS_STEPS + 5

    def measure(agent):
        agent.run(3)                               # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agent.run(METRICS_STEPS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / METRICS_STEPS
        win_us, by_name = profile_window(torch, lambda: agent.run(5))
        dev = sum(by_name.values()) / 5 / 1e3
        return {"wall_ms_per_step": wall, "device_ms_per_step": dev,
                "device_busy_share": dev * 5e3 / win_us}

    tab = {on: tabular_agent(R, metrics=on) for on in (True, False)}
    times = {on: measure(a) for on, a in tab.items()}
    check(torch.equal(tab[True].q, tab[False].q),
          "the tabular Q-table differs with metrics on and off")
    summ = tab[True].metrics_summary()
    check(tab[False].metrics_summary() is None
          and all(summ[k]["count"] == steps * CELLS
                  for k in ("reward", "mean_ms", "td_abs"))
          and summ["epsilon"]["count"] == steps, "tabular metric counts")
    emit(phase="metrics_overhead", agent="tabular", cells=CELLS,
         users=USERS, steps=METRICS_STEPS, on=times[True], off=times[False],
         wall_overhead_ms_per_step=times[True]["wall_ms_per_step"]
         - times[False]["wall_ms_per_step"],
         counts={k: v["count"] for k, v in summ.items()},
         means={k: v["mean"] for k, v in summ.items()},
         q_bit_identical=True)
    del tab

    dqn = {label: dqn_agent(R, metrics=label == "on")
           for label in ("off", "off_again", "on")}
    times = {label: measure(a) for label, a in dqn.items()}

    def max_diff(a, b):
        return max(float((p[k] - q[k]).detach().abs().max())
                   for p, q in zip(a.params, b.params) for k in ("w", "b"))
    run_to_run = max_diff(dqn["off"], dqn["off_again"])
    on_off = max_diff(dqn["on"], dqn["off"])
    check(on_off <= run_to_run,
          f"DQN params with metrics on and off differ by {on_off}, "
          f"beyond the run-to-run spread {run_to_run}")
    summ = dqn["on"].metrics_summary()
    check(all(summ[k]["count"] == steps * CELLS
              for k in ("reward", "mean_ms"))
          and all(summ[k]["count"] == steps
                  for k in ("loss", "replay_fill", "epsilon")),
          "DQN metric counts")
    emit(phase="metrics_overhead", agent="dqn", cells=CELLS, users=USERS,
         steps=METRICS_STEPS, on=times["on"], off=times["off"],
         off_again=times["off_again"],
         wall_overhead_ms_per_step=times["on"]["wall_ms_per_step"]
         - times["off"]["wall_ms_per_step"],
         counts={k: v["count"] for k, v in summ.items()},
         means={k: v["mean"] for k, v in summ.items()},
         params_max_abs_diff_run_to_run=run_to_run,
         params_max_abs_diff_on_off=on_off)


def bridge_dispatch(torch, R, engines, hop_engines, serving_kernels):
    """The spread fleet routed synchronously and through the bridge,
    interleaved, BRIDGE_TURNS turns each, on the engines with network
    hops (HOP_MS) and without; the oracle at the 85% goal through the
    bridge (the int8 variants, so K5 too); and one overloaded route
    (queues of 16). Every identity of ``check_route`` on every route; on
    the others no timeout, reroute or shed, and K3 and K4 (K5 on the
    oracle's) launched during each bridge route."""
    scen = spread_fleet(R)
    want = active_users(scen)
    orch = R.api.FleetOrchestrator(SpreadPolicy(torch, R.dynamics))
    # queues that hold the whole burst: only the overloaded route sheds
    cfg = R.serving.BridgeConfig(max_batch=SERVE_BATCH, max_queue=len(want))

    def bridge_route(label, orch_, scen_, engs, want_, bcfg=cfg,
                     overloaded=False):
        before = {k.name: k.launches for k in serving_kernels}
        res = orch_.route(scen=scen_, dispatch=engs, batch_size=SERVE_BATCH,
                          bridge=bcfg)
        grew = {k.name: k.launches - before[k.name] for k in serving_kernels}
        check_route(res, want_, label, overloaded=overloaded)
        return res, grew

    def rps(res):
        return len(res.served) / (res.timings["wall_ms"] / 1e3)

    for label, engs in (("hops", hop_engines), ("no_hops", engines)):
        kw = dict(scen=scen, dispatch=engs, batch_size=SERVE_BATCH)
        orch.route(**kw)                           # warm both paths
        orch.route(bridge=cfg, **kw)
        syncs, bridges = [], []
        for turn in range(BRIDGE_TURNS):
            syncs.append(orch.route(**kw))
            check_route(syncs[-1], want, f"{label} sync {turn}")
            res, grew = bridge_route(f"{label} bridge {turn}", orch, scen,
                                     engs, want)
            check(grew["flash_attention"] > 0
                  and grew["decode_attention"] > 0,
                  f"{label} bridge {turn}: K3/K4 not launched: {grew}")
            bridges.append(res)
        sync_rps = max(rps(r) for r in syncs)
        bridge_rps = max(rps(r) for r in bridges)
        emit(phase="bridge_dispatch", engines=label,
             hop_ms=HOP_MS if label == "hops" else None, cells=ROUTE_CELLS,
             users=ROUTE_USERS, requests=len(want), turns=BRIDGE_TURNS,
             sync_rps=sync_rps, bridge_rps=bridge_rps,
             bridge_vs_sync_x=bridge_rps / sync_rps,
             overlap_x=max(r.bridge["overlap_x"] for r in bridges),
             sync_wall_ms=[r.timings["wall_ms"] for r in syncs],
             bridge_wall_ms=[r.timings["wall_ms"] for r in bridges],
             bridge_compute_ms=[r.timings["compute_ms"] for r in bridges],
             bridge_dispatch_ms=[r.timings["dispatch_ms"] for r in bridges],
             overlap_x_turns=[r.bridge["overlap_x"] for r in bridges],
             batches=[r.batches for r in bridges],
             gap_x=bridges[-1].gap_x)

    bridge_contention(torch, engines)

    mixed = route_fleet(R)
    mwant = active_users(mixed)
    oracle = R.api.FleetOrchestrator(
        R.api.OraclePolicy(ROUTE_USERS, threshold=85.0))
    sync = oracle.route(scen=mixed, dispatch=engines, batch_size=SERVE_BATCH)
    res, grew = bridge_route(
        "oracle@85 bridge", oracle, mixed, engines, mwant,
        R.serving.BridgeConfig(max_batch=SERVE_BATCH, max_queue=len(mwant)))
    check(all(n > 0 for n in grew.values()),
          f"oracle@85 bridge: a serving kernel was not launched: {grew}")
    check([(r.cell, r.user, r.tier, r.variant) for r in res.served]
          == [(r.cell, r.user, r.tier, r.variant) for r in sync.served],
          "oracle@85: the bridge served another request set than sync")
    emit(phase="bridge_dispatch", engines="no_hops", policy="oracle@85",
         requests=len(res.served), launches=grew,
         per_tier_variant={k: v["requests"] for k, v in
                           res.timings["per_tier_variant"].items()},
         sync_wall_ms=sync.timings["wall_ms"],
         bridge_wall_ms=res.timings["wall_ms"],
         overlap_x=res.bridge["overlap_x"])

    over = R.serving.BridgeConfig(max_batch=SERVE_BATCH, max_queue=16)
    res, _ = bridge_route("overloaded", orch, scen, engines, want, over,
                          overloaded=True)
    st = res.bridge
    check(st["shed"]["overflow"] > 0, "overloaded: no overflow shed")
    check(all({"cell", "user", "action"} <= set(sr)
              for sr in st["shed_requests"]),
          "overloaded: a shed record without its cell")
    emit(phase="bridge_dispatch", engines="no_hops", policy="overloaded",
         max_queue=16, submitted=st["submitted"], admitted=st["admitted"],
         served=st["served"], shed=st["shed"], timeouts=st["timeouts"],
         rerouted=st["rerouted"])


def bridge_contention(torch, engines, reps=5):
    """Where the bridge's time goes without hops: one batch of 64 on each
    of S/d0, E/d0 and C/d0 timed alone and then all three at once, each
    from its own thread on its own stream as the bridge runs them."""
    import threading
    import numpy as np
    engs = [engines[t]["d0"] for t in ("S", "E", "C")]
    toks = np.random.default_rng(5).integers(
        0, 8192, (SERVE_BATCH, 32)).astype(np.int32)
    streams = [torch.cuda.Stream() for _ in engs]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())

    def call(eng, st):
        with torch.cuda.stream(st):
            t0 = time.perf_counter()
            eng.generate(toks, 4)
            return (time.perf_counter() - t0) * 1e3

    out = [[] for _ in engs]
    start = threading.Barrier(len(engs))

    def run(i):
        start.wait()
        out[i] = [call(engs[i], streams[i]) for _ in range(reps)]

    alone = [float(np.median([call(e, st) for _ in range(reps)]))
             for e, st in zip(engs, streams)]
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(engs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    check(not any(th.is_alive() for th in threads), "contention hung")
    emit(phase="bridge_dispatch", engines="no_hops", policy="contention",
         batch=SERVE_BATCH, new_tokens=4, generate_ms_alone=alone,
         generate_ms_three_threads=[float(np.median(o)) for o in out])


def spans_phase(torch, R, engines):
    """One synchronous route of the spread fleet with a ``SpanRecorder``:
    the Chrome trace validates, the ``request.e2e`` durations reproduce
    the served e2e, and the histogram quantiles lie within one bin of
    the exact ones (unless flagged clipped); the same route without
    spans beside it."""
    scen = spread_fleet(R)
    want = active_users(scen)
    orch = R.api.FleetOrchestrator(SpreadPolicy(torch, R.dynamics))
    plain = orch.route(scen=scen, dispatch=engines, batch_size=SERVE_BATCH)
    rec = R.obs.SpanRecorder()
    res = orch.route(scen=scen, dispatch=engines, batch_size=SERVE_BATCH,
                     spans=rec)
    for r, label in ((plain, "spans off"), (res, "spans on")):
        check_route(r, want, label)
    trace = R.obs.validate_chrome_trace(rec.chrome_trace())
    got = sorted(rec.durations_ms("request.e2e"))
    exp = sorted(r.e2e_ms for r in res.served)
    check(len(got) == len(exp) and all(abs(a - b) <= 1e-9 * max(b, 1.0)
                                       for a, b in zip(got, exp)),
          "request.e2e spans do not reproduce the served e2e")
    q = res.slo()["quantiles"]
    hist, exact = q["hist_ms"], q["exact_ms"]
    check(hist["n"] == len(exp) and (hist["clipped"] or all(
        abs(hist[k] - exact[k]) <= hist["bin_width"] for k in exact)),
        f"hist quantiles {hist} beyond one bin of {exact}")
    by_name = {}
    for e in trace["traceEvents"]:
        key = e["name"].rsplit(".", 1)[0] if e["name"].startswith(
            "dispatch.drain.") else e["name"]
        by_name[key] = by_name.get(key, 0) + 1
    emit(phase="spans", events=len(trace["traceEvents"]), by_name=by_name,
         exact_ms=exact, hist_ms=hist,
         wall_ms_spans_off=plain.timings["wall_ms"],
         wall_ms_spans_on=res.timings["wall_ms"],
         engine_generate_ms_mean=sum(rec.durations_ms("engine.generate"))
         / max(len(rec.durations_ms("engine.generate")), 1))


def calibration_phase(torch, R, engines, hop_engines, head_kernel):
    """``calibrate_serving`` on the hop engines and the spread fleet: the
    routes before and after the fit checked as above, and a ``FleetDQN``
    retrained for CALIB_STEPS steps on ``CalibratedDynamics`` of the dqn
    phase's fleet, scored on a held-out calibrated 32,768-cell fleet.
    The spread fleet's model compute is constant within a tier, so it
    fits offsets only; the oracle at 85% on the mixed fleet, over the
    engines without hops, serves local d4 and d7, whose model compute
    differs, so the S tier's scale is identified: its fitted
    ``compute_scale`` must equal ``max(slope, 0)`` of a float64
    least-squares line through that route's (model compute, measured
    minus model communication) points, computed here."""
    import math
    import numpy as np
    routes = []

    def checked(policy, scen):
        want = active_users(scen)

        class Checked(R.api.FleetOrchestrator):
            def route(self, **kw):
                res = super().route(**kw)
                check_route(res, want, f"calibration route {len(routes)}")
                routes.append(res)
                return res
        return Checked(policy)

    def checked_fit(report, label):
        coeff = report["coefficients"]
        check(all(math.isfinite(c["compute_scale"])
                  and math.isfinite(c["hop_offset_ms"])
                  and c["compute_scale"] >= 0 for c in coeff.values()),
              f"{label}: calibration coefficients {coeff}")
        gb, ga = report["before"]["gap_x"], report["after"]["gap_x"]
        check(abs(math.log(ga)) < abs(math.log(gb)),
              f"{label}: gap_x {gb} -> {ga}: the fit did not close the gap")
        return dict(coefficients=coeff, gap_x_before=gb, gap_x_after=ga,
                    attainment_before=report["before"][
                        "attainment_measured"],
                    attainment_after=report["after"]["attainment_measured"],
                    predicted_mean_ms_before=report["before"][
                        "predicted_mean_ms"],
                    predicted_mean_ms_after=report["after"][
                        "predicted_mean_ms"],
                    measured_mean_ms_before=report["before"][
                        "measured_mean_ms"],
                    measured_mean_ms_after=report["after"][
                        "measured_mean_ms"])

    def retrain(calib):
        before = head_kernel.launches
        agent = dqn_agent(R, calib=calib)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agent.run(CALIB_STEPS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        held = R.calibrate.apply_calibration(
            R.scenarios.mixed_table5_fleet(R.Draws(7, "cuda"), CELLS, USERS,
                                           min_users=1, max_users=5), calib)
        ev = R.policy.holdout_reward_ratio(agent, held)
        return {"holdout_reward_ratio": ev.ratio,
                "holdout_feasible_frac": float(ev.feasible.mean()),
                "steps": CALIB_STEPS, "seconds": secs,
                "dqn_head_launches": head_kernel.launches - before}

    scen = spread_fleet(R)
    report, fit, after = R.calibrate.calibrate_serving(
        checked(SpreadPolicy(torch, R.dynamics), scen), scen, hop_engines,
        route_kw=dict(batch_size=SERVE_BATCH), retrain=retrain)
    check(len(routes) == 2 and routes[1] is after, "two calibration routes")
    line = checked_fit(report, "spread fleet")
    rt = report["retrained"]
    check(rt["dqn_head_launches"] > 0, "K2 was not launched in the retrain")
    check(0.0 < rt["holdout_reward_ratio"] <= 1.05,
          f"calibrated holdout ratio {rt['holdout_reward_ratio']}")
    emit(phase="calibration", fleet="spread", hop_ms=HOP_MS,
         requests=len(after.served), retrained=rt, **line)

    mixed = route_fleet(R)
    report, _, after = R.calibrate.calibrate_serving(
        checked(R.api.OraclePolicy(ROUTE_USERS, threshold=85.0), mixed),
        mixed, engines, route_kw=dict(batch_size=SERVE_BATCH))
    check(len(routes) == 4 and routes[3] is after, "four calibration routes")
    line = checked_fit(report, "mixed fleet")
    before = routes[2]
    comm, comp = R.calibrate._model_components(before.decisions, mixed)
    pts = {}
    for r in before.served:
        pts.setdefault(r.tier, []).append(
            (float(comp[r.cell, r.user]),
             r.measured_ms - float(comm[r.cell, r.user])))
    slopes = {}
    for tier, xy in pts.items():
        x, y = np.array(xy).T
        if np.ptp(x) > 0:            # the model compute varies: identified
            slopes[tier] = float(np.polyfit(x, y, 1)[0])
    check("S" in slopes, f"mixed fleet: the S tier's scale is not "
          f"identified (model compute constant): {sorted(pts)}")
    for tier, slope in slopes.items():
        got = line["coefficients"][tier]["compute_scale"]
        check(abs(got - max(slope, 0.0)) <= 1e-5 * max(abs(slope), 1e-3),
              f"mixed fleet: {tier} compute_scale {got} against the "
              f"least-squares slope {slope}")
    emit(phase="calibration", fleet="mixed", policy="oracle@85",
         hop_ms=None, requests=len(after.served), slopes=slopes,
         per_tier_variant_before={
             k: v["requests"] for k, v in
             routes[2].timings["per_tier_variant"].items()},
         per_tier_variant_after={
             k: v["requests"] for k, v in
             after.timings["per_tier_variant"].items()}, **line)


def timed_generate(torch, eng, toks, max_len):
    """One warm-up, then prefill and the greedy decode loop of ``toks``
    timed apart (host clock around synchronised calls), then the whole
    ``generate`` call, its output checked for shape and token range.
    Returns (cache after the decode loop, prefill ms, decode ms per
    token, generate wall seconds)."""
    cfg = eng.model.cfg
    eng.warmup(*toks.shape)
    with torch.inference_mode():
        t_in = torch.tensor(toks, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = eng.model.prefill(eng.params, {"tokens": t_in},
                                          max_len=max_len)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        check(bool(torch.isfinite(logits.float()).all()),
              f"{cfg.name}: non-finite prefill logits")
        cur = logits[:, -1:, :cfg.vocab_size].argmax(-1).int()
        for _ in range(NEW_TOKENS):
            logits, cache = eng.model.decode(eng.params, cache, cur)
            cur = logits[:, -1:, :cfg.vocab_size].argmax(-1).int()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(bool(torch.isfinite(logits.float()).all()),
              f"{cfg.name}: non-finite decode logits")
    gen, wall = eng.generate(toks, NEW_TOKENS)
    check(gen.shape == (toks.shape[0], NEW_TOKENS) and
          int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab_size,
          f"{cfg.name}: generated tokens out of range")
    return cache, (t1 - t0) * 1e3, (t2 - t1) * 1e3 / NEW_TOKENS, wall


def serving(torch, engines):
    """Each variant's ``generate`` at batch 64, prompt bucket 256, 16 new
    tokens, cache 512."""
    import numpy as np
    rng = np.random.default_rng(0)
    out = {}
    for vid in ("d0", "d4", "d7"):
        eng = engines["S"][vid]
        cfg = eng.model.cfg
        toks = rng.integers(0, cfg.vocab_size, (SERVE_BATCH, PROMPT)) \
            .astype(np.int32)
        out[vid], prefill_ms, decode_ms, wall = timed_generate(
            torch, eng, toks, MAX_LEN)
        emit(phase="serving", variant=vid, quant=cfg.quant,
             heads=[cfg.n_heads, cfg.n_kv_heads], d_ff=cfg.d_ff,
             batch=SERVE_BATCH, prompt=PROMPT, new_tokens=NEW_TOKENS,
             max_len=MAX_LEN, prefill_ms=prefill_ms,
             decode_ms_per_token=decode_ms, generate_ms=wall * 1e3,
             tokens_per_s=SERVE_BATCH * NEW_TOKENS / wall)
    return out


def decode_profile(torch, engines, caches, steps=5, path="serving",
                   batch=SERVE_BATCH):
    """Device busy share of ``steps`` decode steps of each variant in
    ``caches`` (the caches of ``serving`` continue)."""
    for vid, cache in caches.items():
        eng = engines["S"][vid]
        cur = torch.zeros((batch, 1), dtype=torch.int32, device="cuda")

        def run():
            nonlocal cache
            with torch.inference_mode():
                for _ in range(steps):
                    _, cache = eng.model.decode(eng.params, cache, cur)
        step_profile(torch, run, steps, path=path, variant=vid,
                     arch=eng.model.cfg.name, what="decode step")


def prefill_profile(torch, engines, batch, prompt, max_len, path):
    """The device time of one prefill of variant d0 at ``batch`` x
    ``prompt`` tokens: its busy share, the port's kernels' ms and share
    (K6's in every Mamba block) and the eight kernels with the most
    device time."""
    import numpy as np
    eng = engines["S"]["d0"]
    cfg = eng.model.cfg
    toks = torch.tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (batch, prompt)).astype(np.int32), device="cuda")

    def run():
        with torch.inference_mode():
            eng.model.prefill(eng.params, {"tokens": toks}, max_len=max_len)
    run()
    step_profile(torch, run, 1, top=8, path=path, variant="d0",
                 arch=cfg.name, what="prefill", batch=batch, prompt=prompt)


def serving_cpu_agreement(torch, engines, build_model, ServingEngine):
    """The card's engine and the CPU's plain path on the same weights at
    batch 4: prefill and decode logits within the bf16 tolerance, greedy
    tokens equal where the top-2 margin is clear."""
    import numpy as np
    toks = np.random.default_rng(2).integers(0, 8192, (4, 32)).astype(
        np.int32)
    for vid in ("d0", "d4", "d7"):
        eng = engines["S"][vid]
        p_cpu = _to_cpu(eng.params)
        m = build_model(eng.model.cfg)
        errs, shares = [], []
        with torch.inference_mode():
            lg, cg = eng.model.prefill(eng.params, {"tokens": torch.tensor(
                toks, device="cuda")}, max_len=48)
            lc, cc = m.prefill(p_cpu, {"tokens": torch.tensor(toks)},
                               max_len=48)
            for _ in range(3):
                a, b_ = lg.float().cpu(), lc.float()
                errs.append(float((a - b_).abs().max()))
                shares.append(limit_share(a, b_))
                check(bool(torch.allclose(a, b_, atol=0.125, rtol=1e-2)),
                      f"{vid}: card vs CPU logits differ by {errs[-1]}")
                cur = b_[:, -1:, :8192].argmax(-1).int()
                lg, cg = eng.model.decode(eng.params, cg, cur.cuda())
                lc, cc = m.decode(p_cpu, cc, cur)
        g_card, _ = eng.generate(toks, 8)
        g_cpu, _ = ServingEngine(m, p_cpu, max_len=eng.max_len).generate(
            toks, 8)
        top2 = torch.sort(lc[:, -1, :8192].float(), -1).values[:, -2:]
        clear = ((top2[:, 1] - top2[:, 0]) > 0.25).numpy()
        same = bool((g_card[clear] == g_cpu[clear]).all())
        check(same, f"{vid}: card and CPU generate different tokens")
        emit(phase="serving_cpu_agreement", variant=vid,
             logits_max_abs_err=max(errs), logits_limit_share=max(shares),
             rows_with_clear_margin=int(clear.sum()), tokens_equal=same)


def limit_share(a, b, atol=0.125, rtol=1e-2):
    """max |a - b| / (atol + rtol |b|): the share of ``torch.allclose``'s
    limit that the card's logits ``a`` use against the CPU's ``b`` (1.0
    is at the limit)."""
    return float(((a - b).abs() / (atol + rtol * b.abs())).max())


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


# ------------------------------------------------- state-space path ----
def build_family(torch, build_engines, cfg, variants, max_len):
    """``build_engines`` over ``cfg`` at its full size, one call per
    variant so that each variant's init is timed alone (a variant's
    weights come from its own seed, so they are those of one call)."""
    engines, init_s = {"S": {}, "E": {}, "C": {}}, {}
    for vid in variants:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = build_engines(cfg, variants=(vid,), max_len=max_len,
                            device="cuda")
        torch.cuda.synchronize()
        init_s[vid] = time.perf_counter() - t0
        for tier, e in one.items():
            engines[tier].update(e)
    return engines, init_s


def cut_layers(params, picks):
    """``params`` cut to the layers ``picks`` (one list of (segment,
    layer) pairs per segment of the cut model); the tensors are shared."""
    out = {k: v for k, v in params.items() if k != "segments"}
    out["segments"] = [[params["segments"][si][li] for si, li in seg]
                       for seg in picks]
    return out


def model_cpu_agreement(torch, cfg, params, build_model, batch, prompt,
                        variant, steps=3):
    """The card's model and the CPU's plain path on the same weights (a
    copy of the card's): prefill and ``steps`` decode steps fed the CPU's
    greedy tokens, logits within the bf16 tolerance (atol 0.125 + rtol
    1e-2), greedy tokens equal where the CPU's top-2 margin is > 0.25.
    Returns the phase's line."""
    import numpy as np
    m = build_model(cfg)
    p_cpu = _to_cpu(params)
    vocab = cfg.vocab_size
    toks = np.random.default_rng(2).integers(0, vocab, (batch, prompt)) \
        .astype(np.int32)
    max_len = prompt + steps + 1
    errs, shares, clear_rows, equal = [], [], 0, True
    with torch.inference_mode():
        lg, cg = m.prefill(params, {"tokens": torch.tensor(
            toks, device="cuda")}, max_len=max_len)
        lc, cc = m.prefill(p_cpu, {"tokens": torch.tensor(toks)},
                           max_len=max_len)
        for step in range(steps + 1):
            a, b_ = lg[:, -1, :vocab].float().cpu(), lc[:, -1, :vocab].float()
            errs.append(float((a - b_).abs().max()))
            shares.append(limit_share(a, b_))
            check(bool(torch.allclose(a, b_, atol=0.125, rtol=1e-2)),
                  f"{cfg.name} {variant}: card vs CPU logits differ by "
                  f"{errs[-1]} at step {step}")
            top2 = torch.sort(b_, -1).values[:, -2:]
            clear = (top2[:, 1] - top2[:, 0]) > 0.25
            same = a.argmax(-1) == b_.argmax(-1)
            clear_rows += int(clear.sum())
            equal &= bool(same[clear].all())
            if step == steps:
                break
            cur = b_.argmax(-1)[:, None].int()
            lg, cg = m.decode(params, cg, cur.cuda())
            lc, cc = m.decode(p_cpu, cc, cur)
    check(equal, f"{cfg.name} {variant}: card and CPU pick different "
          "greedy tokens where the margin is clear")
    line = dict(phase="ssm_cpu_agreement", arch=cfg.name, variant=variant,
                layers=cfg.n_layers, d_model=cfg.d_model,
                d_inner=cfg.d_inner, batch=batch, prompt=prompt,
                decode_steps=steps, logits_max_abs_err=max(errs),
                logits_tolerance=[0.125, 1e-2],
                logits_limit_share=max(shares),
                clear_margin_tokens=clear_rows, tokens_equal=equal)
    emit(**line)
    return line


def hybrid_cut_agreement(torch, eng, build_model):
    """``model_cpu_agreement`` on Hymba engine ``eng``'s weights cut to
    one global and one sliding layer at full width, the prompt 32 tokens
    past the window."""
    cfg = eng.model.cfg
    return model_cpu_agreement(
        torch, dataclasses.replace(cfg, n_layers=2, global_layers=(0,)),
        cut_layers(eng.params, [[(0, 0)], [(1, 0)]]), build_model,
        2, cfg.sliding_window + 32, "d0")


def _held(params):
    """(tensors' elements, bytes) of a param tree."""
    if isinstance(params, dict):
        params = list(params.values())
    if isinstance(params, list):
        parts = [_held(p) for p in params]
        return sum(p[0] for p in parts), sum(p[1] for p in parts)
    return params.numel(), params.numel() * params.element_size()


def family_line(cfg, params, init_s):
    n, nbytes = _held(params)
    return dict(arch=cfg.name, quant=cfg.quant, n_layers=cfg.n_layers,
                d_model=cfg.d_model, d_inner=cfg.d_inner,
                state=cfg.ssm.state_dim, vocab=cfg.vocab_size,
                params_analytic=cfg.param_count(), params_held=n,
                weight_gb=nbytes / 1e9, init_seconds=init_s)


def ssm_serving(torch, engines, init_s):
    """Falcon-Mamba-7B d0 and d4 at full size: ``generate`` at batch 64,
    prompt 256, 16 new tokens; each layer's state checked in the cache."""
    import numpy as np
    rng = np.random.default_rng(0)
    out = {}
    for vid in SSM_VARIANTS:
        eng = engines["S"][vid]
        cfg = eng.model.cfg
        toks = rng.integers(0, cfg.vocab_size, (SERVE_BATCH, PROMPT)) \
            .astype(np.int32)
        out[vid], prefill_ms, decode_ms, wall = timed_generate(
            torch, eng, toks, MAX_LEN)
        (seg,) = out[vid]["segments"]
        check(set(seg) == {"conv", "h"} and tuple(seg["h"].shape) ==
              (cfg.n_layers, SERVE_BATCH, cfg.d_inner, cfg.ssm.state_dim),
              f"{vid}: unexpected SSM cache")
        emit(phase="ssm_serving", variant=vid,
             **family_line(cfg, eng.params, init_s[vid]),
             batch=SERVE_BATCH, prompt=PROMPT, new_tokens=NEW_TOKENS,
             prefill_ms=prefill_ms, decode_ms_per_token=decode_ms,
             generate_ms=wall * 1e3,
             tokens_per_s=SERVE_BATCH * NEW_TOKENS / wall)
    return out


def ssm_serve_drain(engines, Request, RequestBatcher):
    """One queue of requests of mixed prompt lengths drained through
    ``ServingEngine.serve``: each served once, with its stamps."""
    import numpy as np
    eng = engines["S"]["d0"]
    vocab = eng.model.cfg.vocab_size
    rng = np.random.default_rng(3)
    lens = (5, 17, 32, 60, 100, 250)
    batcher = RequestBatcher(4)
    for i, n in enumerate(lens):
        batcher.submit(Request(i, rng.integers(0, vocab, n).astype(np.int32),
                               max_new_tokens=4))
    served, batches = [], 0
    while True:
        done = eng.serve(batcher)
        if not done:
            break
        served += done
        batches += 1
    check(sorted(r.rid for r in served) == list(range(len(lens))),
          "serve drain: requests not served exactly once")
    for r in served:
        check(r.output.shape == (4,) and 0 <= int(r.output.min())
              and int(r.output.max()) < vocab and r.response_time > 0
              and r.deadline_met is not None, f"serve drain: request "
              f"{r.rid} came back without its output or stamps")
    emit(phase="ssm_serve_drain", arch=eng.model.cfg.name, variant="d0",
         requests=len(served), batches=batches,
         serve_ms=[r.serve_time * 1e3 for r in served])


def hybrid_serving(torch, engines, init_s):
    """Hymba-1.5B d0 at full size: ``generate`` at batch 8 from a
    2,048-token prompt, 16 new tokens, cache 2,064; the sliding layers'
    1,024-slot rings have wrapped."""
    import numpy as np
    eng = engines["S"]["d0"]
    cfg = eng.model.cfg
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (HYBRID_BATCH, HYBRID_PROMPT)).astype(np.int32)
    cache, prefill_ms, decode_ms, wall = timed_generate(
        torch, eng, toks, HYBRID_MAX_LEN)
    slots = [(seg.is_global, c["k"].shape[2])
             for seg, c in zip(eng.model.segments, cache["segments"])]
    check(all(n == (HYBRID_MAX_LEN if g else cfg.sliding_window)
              for g, n in slots) and
          cache["pos"] == HYBRID_MAX_LEN > cfg.sliding_window,
          f"hymba: unexpected cache slots {slots} at {cache['pos']}")
    emit(phase="hybrid_serving", variant="d0",
         **family_line(cfg, eng.params, init_s["d0"]),
         heads=[cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim],
         d_ff=cfg.d_ff, window=cfg.sliding_window,
         global_layers=list(cfg.global_layers),
         segments=len(eng.model.segments), batch=HYBRID_BATCH,
         prompt=HYBRID_PROMPT, new_tokens=NEW_TOKENS,
         max_len=HYBRID_MAX_LEN, prefill_ms=prefill_ms,
         decode_ms_per_token=decode_ms, generate_ms=wall * 1e3,
         tokens_per_s=HYBRID_BATCH * NEW_TOKENS / wall)
    return {"d0": cache}


# ------------------------------------------------ the single-cell layer ----
#: the serving launcher's shapes: one request a call, a 16-token prompt,
#: a cache of 64 slots (``build_engines``' default ``max_len``)
CLI_PROMPT, CLI_MAX_LEN = 16, 64
SC_DQN_STEPS, SC_GREEDY_STATES, SC_MARGIN = 2000, 200, 1e-4


def single_cell_bruteforce(torch, C):
    """``bruteforce_optimal`` on the card against the port on the CPU
    (float64 on both) for every experiment x threshold, N = 1..5, over
    the full action set: the same action (or the same error where none
    is feasible), ms and accuracy within 1e-12. Then one call at N = 5
    (10^5 candidates) timed: its kernels' device ms, and the host ms to
    its answer."""
    cases = 0
    for exp in sorted(C.EXPERIMENTS):
        for n in range(1, 6):
            envs = [C.EndEdgeCloudEnv(n, C.EXPERIMENTS[exp], noise=0,
                                      device=d) for d in ("cuda", "cpu")]
            for th in C.THRESHOLDS.values():
                out = []
                for env in envs:
                    try:
                        out.append(C.bruteforce_optimal(env, th))
                    except ValueError:
                        out.append(None)
                card, cpu = out
                check((card is None) == (cpu is None) and (
                    card is None or (card[0] == cpu[0] and card[3] == cpu[3]
                                     and all(abs(a - b) <= 1e-12 * abs(b)
                                             for a, b in zip(card[1:3],
                                                             cpu[1:3])))),
                      f"bruteforce {exp} N={n} at {th}: card {card}, "
                      f"CPU {cpu}")
                cases += 1
    env = C.EndEdgeCloudEnv(5, C.EXPERIMENTS["EXP-A"], noise=0,
                            device="cuda")
    ms, _, src = timed(lambda: C.bruteforce_optimal(env, 85.0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        best = C.bruteforce_optimal(env, 85.0)
    host_ms = (time.perf_counter() - t0) * 1e3 / 20
    emit(phase="single_cell", part="bruteforce", cases=cases,
         n5_candidates=best[3], n5_best=list(env.spec.decode_action(best[0])),
         n5_best_ms=best[1], n5_device_ms=ms, n5_host_ms=host_ms,
         timing=src)


def single_cell_qlearning(torch, C):
    """``train_agent`` of tabular Q-learning on the card's environment
    (EXP-A, N = 3, goal 85, at most 6,000 steps): it converges with
    prediction accuracy 1.0, and its history and every Q row equal those
    of the same run on the CPU (float64 on both); host ms per step."""
    import numpy as np
    runs = []
    for dev in ("cuda", "cpu"):
        env = C.EndEdgeCloudEnv(3, C.EXPERIMENTS["EXP-A"],
                                accuracy_threshold=85.0, seed=0, device=dev)
        agent = C.QLearningAgent(env.spec, seed=0)
        t0 = time.perf_counter()
        res = C.train_agent(agent, env, 6000)
        runs.append((res, agent, time.perf_counter() - t0))
    (res, agent, secs), (res_c, agent_c, secs_c) = runs
    check(res.converged_at is not None and res.prediction_accuracy == 1.0,
          f"Q-learning on the card did not converge: {res.converged_at}, "
          f"prediction accuracy {res.prediction_accuracy}")
    check(res.history == res_c.history and list(agent.q) == list(agent_c.q)
          and all(np.array_equal(row.view(np.uint32),
                                 agent_c.q[st].view(np.uint32))
                  for st, row in agent.q.items()),
          "Q-learning: the card's run differs from the CPU's")
    emit(phase="single_cell", part="qlearning", users=3, goal=85.0,
         converged_at=res.converged_at, steps=res.steps,
         greedy_ms=res.greedy_ms, optimal_ms=res.best_ms,
         prediction_accuracy=res.prediction_accuracy,
         states_visited=len(agent.q),
         host_ms_per_step=secs * 1e3 / res.steps,
         cpu_host_ms_per_step=secs_c * 1e3 / res_c.steps)


def greedy_margin(agent, q, dynamics):
    """The smallest change of the host q that could change
    ``agent``'s greedy decision: the gap between each user's two best
    values (the plain argmax), or with the factored form's accuracy goal,
    the adjacent gaps among each user's five best values (the top-4's
    order) and the gap between the two best feasible combo scores."""
    import itertools
    import numpy as np
    if agent.cfg.form == "paper" or agent.accuracy_threshold is None:
        top = np.sort(q.reshape(-1, q.shape[-1]), -1)[:, -2:]
        return float((top[:, 1] - top[:, 0]).min())
    n, k = q.shape[0], 4
    srt = np.sort(q, -1)[:, ::-1][:, :k + 1]
    gaps = float((srt[:, :-1] - srt[:, 1:]).min())
    topk = np.argsort(q, axis=-1)[:, ::-1][:, :k]
    combos = np.array(list(itertools.product(range(k), repeat=n)))
    per = topk[np.arange(n)[None], combos]
    acc = dynamics.TOP5[np.where(per < dynamics.A_EDGE, per, 0)].mean(-1)
    score = np.where(dynamics.feasible(acc, agent.accuracy_threshold),
                     q[np.arange(n)[None], per].sum(-1), -np.inf)
    best2 = np.sort(score)[-2:]
    return min(gaps, float(best2[1] - best2[0])
               if np.isfinite(best2[0]) else np.inf)


def single_cell_dqn(torch, C, dynamics):
    """Both DQN forms for SC_DQN_STEPS act/update steps on the card's
    environment: the paper form at N = 3 (goal 0) and the factored form
    at N = 5 with the constraint-aware greedy at the 85% goal. Every loss
    finite; ``greedy_action`` on the card equals that of a CPU agent on a
    copy of the card's parameters on SC_GREEDY_STATES states wherever
    ``greedy_margin`` exceeds SC_MARGIN; host ms per step, and the
    device and host ms of one update on a fixed replay batch."""
    import math
    import numpy as np
    for form, n, goal in (("paper", 3, None), ("factored", 5, 85.0)):
        env = C.EndEdgeCloudEnv(n, C.EXPERIMENTS["EXP-A"],
                                accuracy_threshold=goal or 0.0, seed=0,
                                device="cuda")
        agent = C.DQNAgent(C.SpaceSpec(n), C.DQNConfig(form=form), seed=0,
                           accuracy_threshold=goal, device="cuda")
        s, losses = env.reset(), []
        t0 = time.perf_counter()
        for _ in range(SC_DQN_STEPS):
            a = agent.act(s)
            s2, r, _ = env.step(a)
            loss = agent.update(s, a, r, s2)
            if loss is not None:
                losses.append(loss)
            s = s2
        secs = time.perf_counter() - t0
        check(len(losses) == SC_DQN_STEPS - agent.cfg.batch_size + 1
              and all(math.isfinite(x) for x in losses),
              f"DQN {form}: {len(losses)} losses, finite: "
              f"{all(math.isfinite(x) for x in losses)}")
        cpu = C.DQNAgent(C.SpaceSpec(n), C.DQNConfig(form=form), seed=0,
                         accuracy_threshold=goal, device="cpu")
        cpu.params = [{k: v.detach().cpu() for k, v in p.items()}
                      for p in agent.params]
        probe = C.EndEdgeCloudEnv(n, C.EXPERIMENTS["EXP-B"], seed=1,
                                  exogenous=True, device="cpu")
        rng = np.random.default_rng(1)
        held = 0
        for _ in range(SC_GREEDY_STATES):
            st = probe.step(int(rng.integers(probe.spec.n_joint_actions)))[0]
            if greedy_margin(cpu, cpu._host_q(st), dynamics) > SC_MARGIN:
                got, want = agent.greedy_action(st), cpu.greedy_action(st)
                check(got == want, f"DQN {form}: greedy on the card {got}, "
                      f"on the CPU {want} at state {st}")
                held += 1
        check(held >= SC_GREEDY_STATES // 10,
              f"DQN {form}: only {held} states with a clear margin")
        batch = agent.buffer.sample(agent.cfg.batch_size)
        upd_ms, upd_wall_ms, src = timed(lambda: agent._train(*batch))
        emit(phase="single_cell", part="dqn", form=form, users=n, goal=goal,
             hidden=agent.cfg.hidden, steps=SC_DQN_STEPS,
             updates=len(losses), first_loss=losses[0], last_loss=losses[-1],
             eps=agent.eps, host_ms_per_step=secs * 1e3 / SC_DQN_STEPS,
             greedy_states=SC_GREEDY_STATES, greedy_held=held,
             update_device_ms=upd_ms, update_wall_ms=upd_wall_ms,
             timing=src)


def single_cell_serve(torch, serve, kernels):
    """``repro_torch.launch.serve.main`` with its defaults (the
    full-width edge ladder, 3 users, EXP-A, goal 85, 6,000 training
    steps, 4 waves; d0-d7 on S, d0 on E and C): per wave the decision and
    each request's measured ms. Returns the launches of ``kernels``
    (reset just before, read just after); each must have launched."""
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    res, waves = serve.main([])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    check(len(waves) == 4, f"the launcher served {len(waves)} waves")
    for i, w in enumerate(waves):
        check(len(w["measured_ms"]) == 3 and all(m > 0 for m in
                                                 w["measured_ms"]),
              f"wave {i}: measured {w['measured_ms']}")
        emit(phase="single_cell", part="serve", wave=i,
             decision=list(w["decision"]), env_avg_ms=w["env_avg_ms"],
             measured_ms=w["measured_ms"])
    emit(phase="single_cell", part="serve_summary",
         converged_at=res.converged_at, greedy_ms=res.greedy_ms,
         optimal_ms=res.best_ms, seconds=secs, launches=launches)
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched by the serving launcher")
    return launches


def cli_shapes(get_config, build_ladder):
    """K3's and K4's cases at the launcher's shapes (batch 1, 16-token
    prompt, 64 slots) for each head layout of the edge ladder, and K5's
    (M, K, N) at d5's and d6's projections for M = 16 (prefill) and 1
    (decode)."""
    layouts = {}
    for vid, v in build_ladder(get_config("edge-ladder")).items():
        c = v.cfg
        layouts.setdefault((c.n_heads, c.n_kv_heads, c.resolved_head_dim),
                           []).append(vid)
    flash, dec = [], []
    for (h, kv, hd), vids in sorted(layouts.items(), reverse=True):
        name = "/".join(vids)
        flash.append((name, 1, CLI_PROMPT, h, kv, hd, 0))
        dec.append((name, 1, CLI_MAX_LEN, h, kv, hd, 0))
    ladder = build_ladder(get_config("edge-ladder"))
    kn = []
    for vid in ("d5", "d6"):
        c = ladder[vid].cfg
        d, hd = c.d_model, c.resolved_head_dim
        q, kvd = c.n_heads * hd, c.n_kv_heads * hd
        for pair in ((d, q), (d, kvd), (q, d), (d, c.d_ff), (c.d_ff, d)):
            if pair not in kn:
                kn.append(pair)
    int8 = tuple((m, k, n) for m in (CLI_PROMPT, 1) for k, n in kn)
    return tuple(flash), tuple(dec), int8


# ------------------------------------------------- the coupled fleet ----
#: the coupled fleets of the reference's benchmarks/bench_topology.py:
#: its hot edge (64 cells of 2 users over 4 edges, 60% of them on edge 0,
#: 8 cloud servers) and its env configuration (1,024 cells of 3 users
#: over 16 skewed edges, 4 cloud servers a cell), both at its goal of 89
COUPLED_GOAL = 89.0
HOLDOUT_EDGES = 64
COUPLED_STEPS = 300


def step_agreement(torch, R):
    """The float32 fleet env step on the card against the CPU from the
    same inputs and injected noise, on an isolated and a coupled fleet:
    mean ms, mean accuracy, reward, next counts and the DQN's features
    (flat and fused) bit-equal. Also, on the card, the division the
    parent took for the link capacity against the quotient and the
    reference's reciprocal product at the smallest job count where they
    differ (33 jobs over 1.3)."""
    import numpy as np

    def step(dev, coupled):
        s = R.scenarios.mixed_table5_fleet(R.Draws(4, "cpu"), 512, 3,
                                           min_users=1, max_users=3)
        topo = None
        if coupled:
            t = R.topology.hot_edge_topology(
                512, 8, hot_fraction=0.6, capacity_tiers=(1.0, 2.0, 0.5),
                cloud_servers=37.0)
            topo = R.topology.Topology(t.cell_edge.to(dev),
                                       t.edge_capacity.to(dev),
                                       t.cloud_servers)
        s = R.scenarios.FleetScenario(*(getattr(s, f).to(dev) for f in (
            "end_b", "edge_b", "member", "active")), 0, topo)
        rng = np.random.default_rng(0)
        a = torch.tensor(rng.integers(0, 10, (512, 3)), device=dev)
        z = torch.tensor(rng.standard_normal(512, dtype=np.float32),
                         device=dev)

        class Noise(R.Draws):
            def normal(self, site, shape):
                return z
        ms, acc, counts = R.population.simulate_responses(
            Noise(0, dev), s, a, 0.02)
        r = R.dynamics.reward(ms, acc, 85.0)
        out = [ms, acc, r, counts, R.policy.encode_fleet_state(counts, s),
               *R.policy.fused_head_features(counts, s)]
        return [x.cpu() for x in out]

    equal = {}
    for coupled in (False, True):
        pairs = zip(step("cuda", coupled), step("cpu", coupled))
        names = ("mean_ms", "mean_acc", "reward", "counts2", "features",
                 "act", "member", "end_b", "agg")
        equal["coupled" if coupled else "isolated"] = {
            n: bool(torch.equal(g, w)) for n, (g, w) in zip(names, pairs)}
    n = torch.tensor([33.0], device="cuda")
    div = {"python_divisor_on_card": float((n / 1.3).cpu()),
           "true_quotient": float(torch.tensor([33.0]) / 1.3),
           "reciprocal_product": float(R.dynamics.div_const(n, 1.3).cpu())}
    emit(phase="cpu_agreement", case="env_step", bit_equal=equal,
         n33_over_1p3=div)
    for kind, eq in equal.items():
        check(all(eq.values()), f"the float32 env step on the card differs "
              f"from the CPU ({kind}): {eq}")


def coupled_fleets(torch, R):
    """(label, scenario, candidate table) of the two coupled fleets."""
    hot = R.scenarios.with_topology(
        R.scenarios.mixed_table5_fleet(R.Draws(0, "cuda"), 64, 2),
        R.topology.hot_edge_topology(64, 4, hot_fraction=0.6,
                                     cloud_servers=8.0, device="cuda"))
    cfg = R.scenarios.FleetConfig(cells=1024, users=3, n_edges=16,
                                  assignment="skewed", cloud_servers=4096.0)
    skewed, _ = R.api.SyntheticSource(cfg).reset(R.Draws(0, "cuda"))
    return [(label, scen, torch.tensor(
        R.population.SpaceSpec(scen.users).decode_actions_batch(
            R.population.SpaceSpec(scen.users).all_actions()),
        device="cuda"))
        for label, scen in (("hot_edge_64x4", hot), ("skewed_1024x16",
                                                     skewed))]


def coupled_oracle(torch, R, fleets):
    """The main path of the coupled oracle: ``topology_bruteforce`` (the
    kernel a round) on both fleets. Returns each run's result and host
    wall."""
    runs = []
    for label, scen, pu in fleets:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = R.population.topology_bruteforce(scen, pu, COUPLED_GOAL)
        torch.cuda.synchronize()
        runs.append((res, time.perf_counter() - t0))
    return runs


def coupled_oracle_parity(torch, R, fleets, runs, best_response):
    """The kernel's oracle against the same loop with the plain round on
    the card: indices, ``converged``, ``rounds`` and ms equal. Then one
    round from the isolated start timed: the kernel's device ms (and per
    call of 10 back-to-back launches, ``burst_ms``), the plain version's
    wall, the bound of the (cells, K) tables, and the sequential floor
    (the kernel at K = 1, read both ways); on the hot edge, the expected
    reward of aware (best-response) against blind (isolated-optimal)
    decisions under the same shared contention. Returns the kernels-line
    entry (the 1,024-cell fleet's round)."""
    pop, bound_row = R.population, None
    for (label, scen, pu), (got, k_wall) in zip(fleets, runs):
        saved = pop._best_response_round
        pop._best_response_round = (
            lambda *a, calib=None, packed=None: best_response.plain(
                *a, calib=calib))
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = pop.topology_bruteforce(scen, pu, COUPLED_GOAL)
            torch.cuda.synchronize()
            p_wall = time.perf_counter() - t0
        finally:
            pop._best_response_round = saved
        check(torch.equal(got[1], want[1]) and got[2:] == want[2:],
              f"coupled oracle {label}: the kernel's indices / converged "
              f"/ rounds differ from the plain version's")
        err = float((got[0] - want[0]).abs().max())
        check(err == 0.0, f"coupled oracle {label}: ms differ by {err}")
        feas, ce, cc = pop._candidate_tables(scen, pu, COUPLED_GOAL, 4096)
        _, idx0 = pop._isolated_bruteforce(scen, pu, COUPLED_GOAL)
        topo = scen.topo
        args = (scen.end_b, scen.edge_b, scen.member)
        tail = (topo.cell_edge, topo.edge_capacity, topo.cloud_servers)
        packed = best_response.pack_actions(pu)
        def kern():
            return best_response.best_response_cuda(idx0, packed, *args,
                                                    feas, ce, cc, *tail)
        ms, wall_ms, src = timed(kern, warmup=1, reps=5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        best_response.plain(idx0, pu, *args, feas, ce, cc, *tail)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        zeros = torch.zeros_like(idx0)
        one = [x[:, :1].contiguous() for x in (feas, ce, cc)]

        def floor():
            return best_response.best_response_cuda(
                zeros, packed[:1].contiguous(), *args, *one, *tail)
        floor_ms, _, floor_src = timed(floor, warmup=1, reps=5)
        burst, floor_burst = burst_ms(kern), burst_ms(floor)
        cells, k, users = scen.cells, pu.shape[0], scen.users
        ops, nbytes = best_response.cost(cells, k, users, topo.n_edges)
        b_ms, b_by = bound(nbytes, ops)
        line = dict(label=label, cells=cells, users=users, candidates=k,
                    edges=topo.n_edges, rounds=got[3],
                    converged=got[2], equal=True, ms_max_abs_err=err,
                    kernel_oracle_wall_s=k_wall,
                    plain_oracle_wall_s=p_wall, round_ms=ms,
                    round_wall_ms=wall_ms, round_burst_ms=burst,
                    plain_round_wall_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, sequential_floor_ms=floor_ms,
                    sequential_floor_burst_ms=floor_burst,
                    bound_share=b_ms / ms, floor_share=floor_burst / burst,
                    timing=src, floor_timing=floor_src)
        if label.startswith("hot_edge"):
            iso = R.scenarios.with_topology(scen, None)
            _, blind = pop.fleet_bruteforce(iso, pu, COUPLED_GOAL)
            rewards = {}
            for name, idx in (("blind", blind), ("aware", got[1])):
                ms_, acc_ = R.topology.fleet_topology_expected_response(
                    pu[idx.long()], scen.end_b, scen.edge_b, topo,
                    scen.member)
                rewards[name] = float(R.dynamics.reward(
                    ms_, acc_, COUPLED_GOAL).mean())
            line.update(blind_reward=rewards["blind"],
                        aware_reward=rewards["aware"],
                        uplift=rewards["aware"] - rewards["blind"])
            check(rewards["aware"] > rewards["blind"],
                  f"aware routing does not beat blind: {rewards}")
        emit(phase="coupled_oracle", **line)
        bound_row = dict(name="best_response", route="cuda",
                         source="src/repro_torch/csrc/best_response.cu",
                         replaces="none: port-only (the reference's "
                         "jitted fori_loop, src/repro/fleet/population.py"
                         ":717 _best_response_round)",
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return bound_row


def coupled_holdout(torch, R, best_response, kernels):
    """``FleetDQN`` (shared encoder, K2), 300 steps on a 32,768-cell x
    5-user synthetic fleet over 64 skewed edges, scored on a held-out
    coupled fleet of the same shape (1 to 5 members a cell) against
    ``topology_bruteforce`` through the kernel: the ratio in (0, 1.05];
    the oracle's wall and rounds. ``kernels`` (K2 and the best-response
    kernel) count their launches on this path alone, each at least once.
    Then, outside the count, one round from the isolated start through
    the kernel and through its plain version on the card: indices and
    changed flag equal. Returns the path's launch counts."""
    for k in kernels:
        k.launches = 0
    cfg = R.scenarios.FleetConfig(
        cells=CELLS, users=USERS, arrival_rate=1.2, p_r2w=0.05, p_w2r=0.15,
        min_users=2, max_users=5, n_edges=HOLDOUT_EDGES,
        assignment="skewed", cloud_servers=4.0 * CELLS)
    agent = R.policy.FleetDQN(
        R.api.SyntheticSource(cfg), actions=R.population.default_actions(
            R.population.SpaceSpec(USERS)),
        cfg=R.policy.FleetDQNConfig(hidden=128, topk=5,
                                    accuracy_threshold=85.0),
        seed=0, device="cuda", metrics=False)
    agent.run(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agent.run(COUPLED_STEPS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    held, _ = R.api.SyntheticSource(dataclasses.replace(
        cfg, min_users=1)).reset(R.Draws(7, "cuda"))
    pu, goal = agent.pu_table, agent.accuracy_threshold
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, converged, rounds = R.population.topology_bruteforce(held, pu,
                                                               goal)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    ev = R.policy.holdout_reward_ratio(agent, held)
    launched = {k.name: k.launches for k in kernels}
    check(0.0 < ev.ratio <= 1.05, f"coupled holdout ratio {ev.ratio}")
    for name, n in launched.items():
        check(n > 0, f"{name} was never launched on the coupled holdout")

    pop, topo = R.population, held.topo
    feas, ce, cc = pop._candidate_tables(held, pu, goal, 4096)
    _, idx0 = pop._isolated_bruteforce(held, pu, goal)
    args = (held.end_b, held.edge_b, held.member, feas, ce, cc,
            topo.cell_edge, topo.edge_capacity, topo.cloud_servers)
    got, got_changed = best_response.best_response_cuda(
        idx0, best_response.pack_actions(pu), *args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, want_changed = best_response.plain(idx0, pu, *args)
    torch.cuda.synchronize()
    plain_round_s = time.perf_counter() - t0
    moved = int((got != idx0).sum())
    check(torch.equal(got, want) and
          bool(got_changed.item()) == bool(want_changed),
          f"coupled holdout: the kernel's round differs from the plain "
          f"version's ({int((got != want).sum())} of {held.cells} cells, "
          f"changed {bool(got_changed.item())} / {bool(want_changed)})")
    emit(phase="coupled_holdout", cells=CELLS, users=USERS,
         edges=HOLDOUT_EDGES, steps=COUPLED_STEPS, seconds=secs,
         cell_steps_per_s=CELLS * COUPLED_STEPS / secs,
         holdout_reward_ratio=ev.ratio,
         holdout_feasible_frac=float(ev.feasible.mean()),
         oracle_wall_s=oracle_s, oracle_rounds=rounds,
         oracle_converged=converged, launches=launched,
         round_equal=True, round_cells_moved=moved,
         member_counts={n: int((held.member.sum(-1) == n).sum())
                        for n in range(1, USERS + 1)},
         plain_round_wall_s=plain_round_s)
    return launched


def cell_dqn(torch, R, head_kernel):
    """``FleetDQN(net='cell')`` at the DQN phase's shape, 300 steps: the
    holdout ratio in (0, 1.05], wall and device ms per step, and K2 never
    launched (the cell net's greedy is torch ops)."""
    before = head_kernel.launches
    cfg = R.scenarios.FleetConfig(cells=CELLS, users=USERS, arrival_rate=1.2,
                                  p_r2w=0.05, p_w2r=0.15, min_users=2,
                                  max_users=5)
    agent = R.policy.FleetDQN(
        R.api.SyntheticSource(cfg), actions=R.population.default_actions(
            R.population.SpaceSpec(USERS)),
        cfg=R.policy.FleetDQNConfig(hidden=128, topk=5,
                                    accuracy_threshold=85.0, net="cell"),
        seed=0, device="cuda", metrics=False)
    agent.run(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agent.run(COUPLED_STEPS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    win_us, by_name = profile_window(torch, lambda: agent.run(5))
    dev_ms = sum(by_name.values()) / 5 / 1e3
    held = R.scenarios.mixed_table5_fleet(R.Draws(7, "cuda"), CELLS, USERS,
                                          min_users=1, max_users=5)
    ev = R.policy.holdout_reward_ratio(agent, held)
    check(0.0 < ev.ratio <= 1.05, f"cell DQN holdout ratio {ev.ratio}")
    check(head_kernel.launches == before,
          f"the cell DQN launched K2 {head_kernel.launches - before} times")
    emit(phase="cell_dqn", cells=CELLS, users=USERS, steps=COUPLED_STEPS,
         seconds=secs, wall_ms_per_step=secs * 1e3 / COUPLED_STEPS,
         device_ms_per_step=dev_ms, device_busy_share=dev_ms * 5e3 / win_us,
         holdout_reward_ratio=ev.ratio,
         holdout_feasible_frac=float(ev.feasible.mean()),
         k2_launches=head_kernel.launches - before)


def agent_state(agent):
    """Copies of every tensor of an agent's state and its host scalars."""
    leaves = [agent.counts, agent.draws.gen.get_state(),
              *(getattr(agent.scen, f) for f in ("end_b", "edge_b",
                                                 "member", "active"))]
    host = [agent.eps, agent.steps]
    if hasattr(agent, "buffer"):
        b = agent.buffer
        leaves += [t for p in agent.params for t in p.values()]
        leaves += [t for part in ("m", "v") for p in agent.opt[part]
                   for t in p.values()]
        leaves += [b.s, b.a, b.r, b.s2]
        host += [agent.opt["step"], b.ptr, b.full]
    else:
        leaves.append(agent.q)
    return [t.detach().clone() for t in leaves], host


def prof_phase(torch, R, prof, agents, kernels):
    """``stage_costs`` of the tabular and DQN agents at 32,768 x 5 and
    ``scaling_sweep`` over 1,024 to 32,768 cells: fractions summing to 1,
    each agent's state unchanged, and no kernel launched while
    ``profile_fn`` counted each stage."""
    before = {k.name: k.launches for k in kernels}
    for agent in agents:
        fns = (prof._dqn_stage_fns if hasattr(agent, "buffer")
               else prof._tabular_stage_fns)(agent, R.Draws(0, "cuda"))
        for name, (fn, make_args) in fns.items():
            prof.profile_fn(fn, *make_args(), name=name)
    launched = {k.name: k.launches - before[k.name] for k in kernels}
    check(not any(launched.values()),
          f"profile_fn launched kernels: {launched}")
    for agent in agents:
        snap = agent_state(agent)
        rep = prof.stage_costs(agent, reps=5)
        after = agent_state(agent)
        check(after[1] == snap[1] and all(
            torch.equal(a, b) for a, b in zip(after[0], snap[0])),
            f"stage_costs changed the {rep['kind']} agent's state")
        for fr in ("flop_fracs", "byte_fracs", "wall_fracs"):
            check(abs(sum(rep[fr].values()) - 1.0) <= 1e-9,
                  f"{rep['kind']} {fr} sum to {sum(rep[fr].values())}")
        emit(phase="prof", kind=rep["kind"], cells=rep["cells"],
             users=rep["users"], flop_fracs=rep["flop_fracs"],
             byte_fracs=rep["byte_fracs"], wall_fracs=rep["wall_fracs"],
             wall_ms={n: s["wall_ms"] for n, s in rep["stages"].items()},
             flops={n: s["flops"] for n, s in rep["stages"].items()},
             bytes={n: s["bytes_accessed"]
                    for n, s in rep["stages"].items()},
             dominant_stage_flops=rep["dominant_stage_flops"],
             dominant_stage_wall=rep["dominant_stage_wall"],
             profile_fn_launches=launched)
    sweep = prof.scaling_sweep([1024, 4096, 16384, 32768], users=USERS,
                               device="cuda")
    emit(phase="prof", kind="scaling_sweep", **{
        k: sweep[k] for k in ("grid", "flops_per_cell",
                              "us_device_per_cell_step",
                              "per_device_cell_steps_per_s", "flatness",
                              "cliff_cells", "classification", "summary")})


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device available")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        sys.exit("chip_smoke: src/repro_torch is missing beside this script")
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import types
    from repro_torch.configs.base import get_config
    from repro_torch.core import spaces
    from repro_torch import obs, serving as serving_pkg
    from repro_torch.fleet import (api, calibrate, dynamics, policy,
                                   population, scenarios, topology)
    from repro_torch.kernels import (_build, best_response,
                                     decode_attention, dqn_head,
                                     flash_attention, int8_matmul, ops, ref,
                                     selective_scan, tabular_rl)
    from repro_torch.obs import prof
    from repro_torch import core
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.serve import build_engines
    from repro_torch.models import build_model
    from repro_torch.models.variants import build_ladder
    from repro_torch.rng import Draws
    from repro_torch.serving import Request, RequestBatcher, ServingEngine
    R = types.SimpleNamespace(api=api, policy=policy, population=population,
                              scenarios=scenarios, Draws=Draws,
                              calibrate=calibrate, dynamics=dynamics,
                              obs=obs, serving=serving_pkg,
                              topology=topology)
    fleet_kernels = [tabular_rl.KERNEL, dqn_head.KERNEL]
    serving_kernels = [flash_attention.KERNEL, decode_attention.KERNEL,
                       int8_matmul.KERNEL]
    ssm_kernels = serving_kernels + [selective_scan.KERNEL]
    kernels = fleet_kernels + ssm_kernels + [best_response.KERNEL]

    emit(phase="env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))
    secs = _build.build(kernels)
    ptxas = {k.name: ptxas_summary(k.ptxas_log) for k in kernels}
    emit(phase="build", seconds=secs, ptxas=ptxas,
         spills={k: [f for f, (_, st, ld) in fns.items() if st or ld]
                 for k, fns in ptxas.items()})

    entries = [tabular_phase(torch, tabular_rl, ref),
               head_phase(torch, dqn_head, ref, dynamics, spaces,
                          ptxas[dqn_head.KERNEL.name]),
               flash_phase(torch, flash_attention),
               decode_phase(torch, ops, decode_attention),
               int8_phase(torch, ref, int8_matmul),
               scan_phase(torch, selective_scan,
                          ptxas[selective_scan.KERNEL.name])]
    cpu_agreement(torch, R)
    step_agreement(torch, R)
    engines = build_engines(get_config("edge-ladder"), max_len=MAX_LEN,
                            device="cuda")
    serving_cpu_agreement(torch, engines, build_model, ServingEngine)

    for k in fleet_kernels:           # the fleet loop's launches only
        k.launches = 0
    tab_agent = tabular_training(torch, R)
    dqn_agent = dqn_training(torch, R)
    launches = {k.name: k.launches for k in fleet_kernels}
    for k in serving_kernels:         # the serving path's launches only
        k.launches = 0
    route_dispatch(torch, R, engines)
    caches = serving(torch, engines)
    launches.update({k.name: k.launches for k in serving_kernels})

    # the sim-to-real loop: the agents' telemetry, the async bridge,
    # spans and the calibration, its launches counted from here
    loop_kernels = fleet_kernels + serving_kernels
    hop_engines = build_engines(get_config("edge-ladder"), variants=("d0",),
                                max_len=MAX_LEN, hop_ms=HOP_MS,
                                device="cuda")
    for tier in hop_engines.values():
        for eng in tier.values():
            eng.warmup(SERVE_BATCH, 32)
    for k in loop_kernels:
        k.launches = 0
    metrics_overhead(torch, R)
    bridge_dispatch(torch, R, engines, hop_engines, serving_kernels)
    spans_phase(torch, R, engines)
    calibration_phase(torch, R, engines, hop_engines, dqn_head.KERNEL)
    loop_launches = {k.name: k.launches for k in loop_kernels}
    emit(phase="launches", sim_to_real_loop=loop_launches)
    for name, n in loop_launches.items():
        check(n > 0, f"{name} was never launched on the sim-to-real loop")
    del hop_engines
    step_profile(torch, lambda: tab_agent.run(5), agent="tabular")
    step_profile(torch, lambda: dqn_agent.run(5), agent="dqn")

    # the coupled fleet: the oracle through the best-response kernel on
    # both fleets and behind a coupled holdout, its launches counted from
    # here; then the kernel held against its plain version, the cell-form
    # DQN, and the cost profile of both agents
    fleets = coupled_fleets(torch, R)
    best_response.KERNEL.launches = 0
    runs = coupled_oracle(torch, R, fleets)
    launches["best_response"] = best_response.KERNEL.launches
    holdout_launches = coupled_holdout(
        torch, R, best_response, [dqn_head.KERNEL, best_response.KERNEL])
    emit(phase="launches", coupled_oracle={
        "best_response": launches["best_response"]},
        coupled_holdout=holdout_launches)
    entries.append(coupled_oracle_parity(torch, R, fleets, runs,
                                         best_response))
    cell_dqn(torch, R, dqn_head.KERNEL)
    prof_phase(torch, R, prof, [tab_agent, dqn_agent], kernels)
    del fleets, runs
    decode_profile(torch, engines, caches)
    del engines, caches

    # the single-cell layer: the brute force and both agents on the card,
    # then the serving launcher's RL-orchestrated loop, its launches
    # counted from here, and K3-K5 at its shapes
    single_cell_bruteforce(torch, core)
    single_cell_qlearning(torch, core)
    single_cell_dqn(torch, core, dynamics)
    cli_launches = single_cell_serve(torch, serve_cli, serving_kernels)
    emit(phase="launches", single_cell=cli_launches)
    cli_flash, cli_decode, cli_int8 = cli_shapes(get_config, build_ladder)
    flash_phase(torch, flash_attention, cli_flash, path="single_cell")
    decode_phase(torch, ops, decode_attention, cli_decode,
                 path="single_cell")
    int8_phase(torch, ref, int8_matmul, cli_int8, path="single_cell")

    # the state-space path: Falcon-Mamba-7B (d0, d4) and Hymba-1.5B (d0)
    # at full size
    falcon = get_config(SSM_ARCH)
    ssm_engines, ssm_init = build_family(torch, build_engines, falcon,
                                         SSM_VARIANTS, MAX_LEN)
    for vid in SSM_VARIANTS:          # 2 layers at full width
        eng = ssm_engines["S"][vid]
        model_cpu_agreement(
            torch, dataclasses.replace(eng.model.cfg, n_layers=2),
            cut_layers(eng.params, [[(0, 0), (0, 1)]]), build_model,
            2, 32, vid)
    hymba = get_config(HYBRID_ARCH)
    hyb_engines, hyb_init = build_family(torch, build_engines, hymba,
                                         ("d0",), HYBRID_MAX_LEN)
    hybrid_cut_agreement(torch, hyb_engines["S"]["d0"], build_model)
    for k in ssm_kernels:             # the state-space path's launches only
        k.launches = 0
    ssm_caches = ssm_serving(torch, ssm_engines, ssm_init)
    ssm_serve_drain(ssm_engines, Request, RequestBatcher)
    route_dispatch(torch, R, ssm_engines, cells=SSM_ROUTE_CELLS,
                   phase="route_dispatch_ssm", seed=13)
    hyb_caches = hybrid_serving(torch, hyb_engines, hyb_init)
    ssm_launches = {k.name: k.launches for k in ssm_kernels}
    launches["selective_scan"] = ssm_launches["selective_scan"]
    emit(phase="launches", fleet_loop={k.name: launches[k.name]
                                       for k in fleet_kernels},
         serving={k.name: launches[k.name] for k in serving_kernels},
         ssm_path=ssm_launches)
    for name, n in ssm_launches.items():
        check(n > 0, f"{name} was never launched on the state-space path")
    decode_profile(torch, ssm_engines, ssm_caches, path="ssm_serving")
    decode_profile(torch, hyb_engines, hyb_caches, path="hybrid_serving",
                   batch=HYBRID_BATCH)
    prefill_profile(torch, ssm_engines, SERVE_BATCH, PROMPT, MAX_LEN,
                    "ssm_serving")
    prefill_profile(torch, hyb_engines, HYBRID_BATCH, HYBRID_PROMPT,
                    HYBRID_MAX_LEN, "hybrid_serving")
    for e in entries:
        e["launches"] = launches[e["name"]]
        check(e["launches"] > 0,
              f"{e['name']} was never launched on its main path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys}
                                  for e in entries]}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi: {smi.stderr.strip()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
