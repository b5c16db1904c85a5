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
* the mixture-of-experts path: ``build_engines`` over
  Granite-3.0-1B-A400M at its published size (24 layers, d_model 1,024,
  16/8 heads of 64, 32 experts of d_ff 512, top-8; d0 bf16 and d4 with
  int8 attention and experts), a 2-layer full-width cut of each held
  against the CPU (phase ``moe_cpu_agreement``: every MoE block on the
  card against the CPU's on the CPU's own input, its choice of experts
  equal wherever the router's margin exceeds 1e-4; the logits, greedy
  tokens and router probabilities of the whole cut), each variant's
  ``generate`` at batch 64, prompt 256, 16 new tokens (``moe_serving``:
  the prefill's ``dropped_frac``, the K/V cache's shape, parameters
  held against ``param_count()``), and a 256-cell 3-user fleet routed
  into the engines (``route_dispatch_moe``); decode and prefill
  profiles of both (kernels K3, K4, and K5 on d4's projections and,
  batched over the 32 experts in one launch, on its expert products;
  their ``kernel_parity`` lines, K5's bit-exact beside the loop of 32
  ``torch._int_mm`` calls, follow the single-cell layer's);
* the dense and VLM path, last (K3 and K4 at head_dim 128 and 256): K3
  and K4 held against their plain versions at its layouts (InternLM2's
  48/8 heads of 128, Yi's 56/8, Gemma3-4B's 8/4 heads of 256 at 8 x
  2,048, global and windowed, Gemma-7B's 16/16, PaliGemma's 8/1; bf16,
  float32 at one layout of each head dim), each with the registers and
  spills of its instance; 2-layer full-width cuts of the five configs
  (Gemma3's a sliding and a global layer, its prompt past the window;
  PaliGemma behind 16 image tokens) on the card against the CPU (phase
  ``dense_cpu_agreement``); ``build_engines`` over Gemma3-4B (34
  layers, d_model 2,560, vocab 262,144, 5:1 sliding:global, window
  1,024; 3.88 B parameters) at batch 8 x 2,048 and InternLM2-20B (48
  layers, d_model 6,144, 48/8 heads of 128; 19.9 B parameters) at batch
  32 x 256, each d0 bf16 and d4 int8 at its published size, parameters
  held against ``param_count()``, peak memory printed (``dense_serving``),
  a 256-cell 3-user fleet routed into Gemma3's engines
  (``route_dispatch_dense``) and their decode and prefill profiles; then
  PaliGemma-3B whole through ``Model.prefill`` / ``decode`` (batch 16,
  256 stub image embeddings + 256 text tokens, 16 decode steps),
  Gemma-7B whole, Yi-34B at full width cut to 8 of its 60 layers and
  DBRX-132B to 2 of its 40 through ``build_engines`` d0 at batch 16 x
  256 (``vlm_and_cuts``), each model freed before the next (kernels
  K3, K4, and K5 on the d4 variants);
* the encoder-decoder path, after the dense and VLM path: K3 without a
  mask over Whisper-medium's 16 x 1,500 frames and from its 64-token
  prompt onto them, K4 over its 1,500-slot cross cache and its 448-slot
  self cache, K3 and K4 with a logit soft-cap of 50 (at Gemma3-4B's
  global and windowed layouts and at Whisper's cross layout; their
  library time a compiled ``flex_attention``, the cap its score_mod;
  each checked again at a cap of 2, which moves the plain version past
  the tolerance), K5 at d4's encoder
  rows (M = 24,000), each against its plain version; Whisper at full
  width cut to 2 encoder and 2 decoder layers over its 1,500 frames on
  the card against the CPU, d0 and d4 (``audio_cpu_agreement``); then
  Whisper-medium whole (24 + 24 layers, d_model 1,024, 16/16 heads of
  64; 0.81 B parameters) through ``Model.prefill`` / ``decode``, d0 then
  d4: batch 16, 1,500 seeded stub frames, a 64-token prompt, 16 greedy
  steps, a 448-slot self cache, its encoder's ms, its launches a prefill
  (K3 72) and a decode step (K4 48), parameters held against
  ``param_count()`` and a decode and a prefill profile
  (``audio_serving``; kernels K3, K4, and K5 in d4);
* the coupled fleet (phases ``coupled_oracle``, ``coupled_holdout``,
  ``cell_dqn``, ``prof``): ``topology_bruteforce`` through the
  best-response kernel on the reference benchmark's hot edge (64 cells of
  2 users over 4 edges) and on 1,024 cells of 3 users over 16 skewed
  edges, each held equal to the same loop with the kernel's plain round
  on the card, with the aware-vs-blind reward on the hot edge; a
  ``FleetDQN`` trained on 32,768 x 5 cells over 64 skewed edges and
  scored against that oracle, one round of which is held equal to the
  plain round at that shape (run on the CPU on copies of the card's
  inputs); at each shape a changing round and a round
  that changes nothing split by kernel (totals, pre-pass, walker), the
  walker's rescored cells and passes, and the oracle's wall split into
  its stages; ``FleetDQN(net='cell')`` at the DQN
  phase's shape; ``obs.prof`` stage costs of both agents and a scaling
  sweep over 1,024 to 32,768 cells (kernels K1, K2 and the port-only
  best-response kernel);
* the sharded fleet (phase ``fleet_sharded``): both agents with
  ``mesh=`` on 32,768 x 5 cells over 64 edges, one fleet shard-local
  and one all-to-all with edge failures, unsharded, on a one-rank NCCL
  mesh in this process, and on two gloo ranks sharing the card in their
  own processes (each rank runs K1 and K2 on its block; every join has a
  time limit): the Q-table, job counts, decisions and scenario blocks,
  the DQN's parameters, the per-step fleet means, the telemetry and the
  holdout ratios bit-equal to the unsharded run's, and
  ``local_contention`` equal to ``shared_contention``;
* the single-cell layer (phase ``single_cell``): ``bruteforce_optimal``
  on the card against the CPU for every experiment x threshold, N =
  1..5; tabular Q-learning (N = 3, goal 85) converging, its Q rows equal
  to the CPU run's; both DQN forms (paper N = 3, factored N = 5 at goal
  85) 250 steps, greedy equal to the CPU's on the same parameters
  where the margin is clear; then ``python -m repro_torch.launch.serve``'s
  ``main`` with its defaults (the full-width edge ladder, d0-d7 on the
  device tier): 4 waves of the trained agent's decisions served through
  the engines (kernels K3, K4, K5), and K3-K5 held against their plain
  versions at its shapes (batch 1 x 16 tokens, 64 slots, d5's and d6's
  projections at 16 rows and 1);
* the training path: K3's ``kLse`` instances and their backward P2
  against their plain versions at the training layouts
  (``attention_backward``), K6's ``kStates`` instance (bit-equal to the
  serving one) and the scan's backward P3 against ``plain_backward`` at
  Falcon-Mamba's 64 x 256 x 8,192 and Hymba's 8 x 2,048 x 3,200
  (``scan_backward``); one ``make_train_step`` step card vs CPU on five
  full-width cuts (``training_cpu_agreement``: the edge ladder, Granite
  2 layers, Whisper 2+2, Falcon-Mamba 1 of its 64 layers, Hymba's
  global layer 0 and windowed layer 1 over 1,152 tokens); then
  ``launch.train`` on Hymba-1.5B whole (``ssm_training``; K3, P2, K6,
  P3) and on Granite-3.0-1B-A400M whole (``lm_training``; K3, P2), 10
  steps at 8 x 2,048 each, their launches counted from the start of
  each.

(The dense and VLM path, the encoder-decoder path and then the training
path run last in the script, after the state-space path's profiles.) The phase
``cpu_agreement`` also holds the float32 fleet env step on the card
bit-equal to the CPU on an isolated and a coupled fleet. Each
path's kernel launch counts are set to 0 just before it and read just
after; every route checks its identities (each active user served
once, or shed once where a bridge is overloaded; batching + compute +
dispatch = wall; queue + measured = e2e; attained + violated =
dispatched). Every phase prints one JSON line; any failed check raises
and the exit code is non-zero. Every time a ``kernel_parity`` line
reports (the kernel's, its plain version's and the library call's, warm
and cold) comes from one method, CUDA events around a call queued behind
a spin kernel that hides its launch (``hidden_ms``); ``profiler_ms``
gives ``torch.profiler``'s reading of the kernel beside it, for the
offset between the two. The ``kernel_parity`` lines of K2, K3,
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
main path and on each path that launched it (``launches_by_path``), its
error against the plain version, its time beside the plain version's,
its bound and, where one PyTorch call computes the same function, that
call's time. The last line is ``{"ok": true, "device":
{...}}``. It needs a CUDA device and the ``src/repro_torch`` package
beside it, and imports nothing of JAX.
"""
import contextlib
import dataclasses
import gc
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
# the mixture-of-experts path: Granite-3.0-1B-A400M's served variants and
# its routed fleet's seed
MOE_ARCH, MOE_VARIANTS, MOE_ROUTE_SEED = "granite-moe-1b-a400m", \
    ("d0", "d4"), 17
# the exponentials' own rate: 16 per clock on each SM's special function
# units x 132 SMs x the 1.98 GHz boost clock (NVIDIA's Hopper white paper)
SFU_OPS_PER_S = 16 * 132 * 1.98e9
# bytes read between two calls of a cold-L2 reading: five times the 50 MB
# L2 cache
FLUSH_BYTES = 256 << 20
# clock cycles a second that size a spin kernel (``hidden_ms``): the boost
# clock, so a spin lasts at least as long as asked at any lower clock
SPIN_HZ = 1.98e9
# the port's kernel functions, whose device time a step profile reports
OUR_KERNELS = ("tabular_rl_kernel", "dqn_head_kernel",
               "best_response_totals_kernel",
               "best_response_prepass_kernel",
               "best_response_walker_kernel", "flash_attention_tc_kernel",
               "flash_attention_f32_kernel",
               "decode_partial_kernel",
               "decode_merge_kernel", "int8_matmul_kernel",
               "selective_scan_kernel", "flash_bwd_dot_kernel",
               "flash_bwd_dkdv_tc_kernel", "flash_bwd_dq_tc_kernel",
               "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel",
               "selective_scan_bwd_kernel", "selective_scan_bwd_sum_kernel")


#: decode steps in one profiler window of a served model (``step_profile``)
DECODE_PROFILE_STEPS = 3

#: the script's start; every line gives its seconds since (``t_s``)
T0 = time.perf_counter()


def emit(**kw):
    print(json.dumps(dict(kw, t_s=round(time.perf_counter() - T0, 1))),
          flush=True)


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


#: pairs of traces taken before a profiler reading is given up
TRACE_TRIES = 3


def kernel_counts(torch, fn, reps=1):
    """({kernel name: launches}, {kernel name: device us}) of a
    ``torch.profiler`` trace of ``reps`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    counts, us = {}, {}
    for n, t in device_events(prof):
        counts[n] = counts.get(n, 0) + 1
        us[n] = us.get(n, 0.0) + t
    return counts, us


def traced_ms(torch, fn, reps):
    """Mean device ms per call of the kernels ``fn`` launches: for each
    kernel, its mean time a launch in a trace of ``reps`` calls times its
    launches in a trace of one call. The profiler drops events at times
    (1-4 us kernels most, PERF.md §7) and a reading must not come out
    short for it, so the two traces must hold the same kernels, else both
    are taken again, up to ``TRACE_TRIES`` times; None if they never
    do."""
    for _ in range(TRACE_TRIES):
        one, _ = kernel_counts(torch, fn)
        counts, us = kernel_counts(torch, fn, reps)
        if one and set(one) == set(counts):
            return sum(one[n] * us[n] / counts[n] for n in one) / 1e3
    return None


def device_ms(fn, warmup=3, reps=20):
    """Mean device time per call of every CUDA kernel ``fn`` launches,
    from ``torch.profiler`` traces (the kernels' own time, without the
    host's launch overhead; ``traced_ms``). None when no two traces held
    the same kernels."""
    import torch
    for _ in range(warmup):
        fn()
    return traced_ms(torch, fn, reps)


def device_events(prof):
    """(name, microseconds) of every device-side event of a trace."""
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def hidden_ms(fn, reps=20, before=None):
    """Mean device time per call of ``fn`` in ms from a CUDA event pair
    around each call, with the host's launch of the call hidden: a spin
    kernel (``torch.cuda._sleep``) twice as long as the host takes to
    issue one call runs first (after ``before()`` where given), so the
    call's kernels are queued by the time the first event is reached and
    the pair times the device alone. Needs no profiler trace."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(2 * issue_s * SPIN_HZ) + int(50e-6 * SPIN_HZ)
    total = 0.0
    for _ in range(reps):
        if before is not None:
            before()
        torch.cuda._sleep(cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def cold_ms(fn, reps=20):
    """Mean device time per call of ``fn`` with the L2 cache cold: a sum
    over a ``FLUSH_BYTES`` buffer runs before each call (as the model's
    call finds its inputs after the layers between have streamed their
    weights through the L2), outside the event pair that times the call
    (``hidden_ms``)."""
    import torch
    buf = torch.ones(FLUSH_BYTES // 4, device="cuda")
    return hidden_ms(fn, reps, before=buf.sum)


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
    the device's end; {kernel name: device us}; device events)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, events = {}, device_events(prof)
    for n, us in events:
        by_name[n] = by_name.get(n, 0.0) + us
    return wall_us, by_name, len(events)


def step_profile(torch, run, steps=5, top=5, **label):
    """Device busy share of ``run()`` (``steps`` steps of a path) and the
    ``top`` kernels with the most device time, from one ``torch.profiler``
    window."""
    wall_us, by_name, n_events = profile_window(torch, run)
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
         device_events_per_step=n_events / steps,
         device_busy_share=busy / wall_us if wall_us else None,
         top_kernels=[[n[:80], us / steps / 1e3] for n, us in top],
         our_kernels_ms_per_step=ours,
         our_kernels_share_of_device={k: v * steps * 1e3 / busy
                                      for k, v in ours.items()}
         if busy else None)


def timed(fn, warmup=3, reps=20, profile=False):
    """(ms, wall_ms, profiler_ms): the device time per call from CUDA
    events with the launch hidden (``hidden_ms``), the one method of every
    time a kernel's line reports (the kernel's, its plain version's and
    the library call's, warm and cold); the CUDA-event time per call,
    which includes the host's launch overhead; and, with ``profile``,
    ``torch.profiler``'s reading of the same calls (``device_ms``: the
    kernels' own time, without the event pair's few microseconds), for
    the offset between the two methods, None where no two traces held the
    same kernels (or without ``profile``)."""
    wall = time_ms(fn, warmup, reps)
    prof = device_ms(fn, warmup, reps) if profile else None
    return hidden_ms(fn, reps), wall, prof


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
    ms, wall_ms, prof_ms = timed(
        lambda: tabular_rl.tabular_rl_cuda(qk, s, a, r, s2, **kw),
        profile=True)
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
         bound_by=b_by, profiler_ms=prof_ms, wall_ms=wall_ms,
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
        ms, wall_ms, prof_ms = timed(
            lambda: dqn_head.dqn_head_cuda(*args, **kw), profile=True)
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
             profiler_ms=prof_ms, wall_ms=wall_ms,
             plain_wall_ms=plain_wall_ms,
             ptxas=regs[0] if regs else None)
    main = out["all", 85.0]           # the DQN phase's QoS operating point
    return dict(name="dqn_head", route="cuda",
                source="src/repro_torch/csrc/dqn_head.cu",
                replaces="src/repro/kernels/dqn_head.py:116",
                library_ms=None, **main)


# ------------------------------------------------------------ K3-K5 ----
#: A K3 case is (name, batch, Sq, Skv, q heads, kv heads, head dim,
#: window, causal, softcap), a K4 case (name, batch, cache slots, q
#: heads, kv heads, head dim, window, cross cache, softcap). Here the
#: edge ladder's d0/d4 and d7 layouts at prompt buckets 32 and 256
#: (caches of 64 and 512 slots), and Hymba's at its 2,048-token prompt,
#: global and sliding (window 1,024; at decode the global cache's 2,064
#: slots and the sliding layers' 1,024-slot ring)
FLASH_CASES = tuple((name, SERVE_BATCH, s, s, h, kv, 32, 0, True, 0.0)
                    for name, h, kv in (("d0/d4", 8, 4), ("d7", 2, 2))
                    for s in (32, PROMPT)) + (
    ("hymba global", HYBRID_BATCH, HYBRID_PROMPT, HYBRID_PROMPT, 25, 5, 64,
     0, True, 0.0),
    ("hymba sliding", HYBRID_BATCH, HYBRID_PROMPT, HYBRID_PROMPT, 25, 5, 64,
     1024, True, 0.0))
DECODE_CASES = tuple((name, SERVE_BATCH, sc, h, kv, 32, 0, False, 0.0)
                     for name, h, kv in (("d0/d4", 8, 4), ("d7", 2, 2))
                     for sc in (64, MAX_LEN)) + (
    ("hymba global", HYBRID_BATCH, HYBRID_MAX_LEN, 25, 5, 64, 0, False, 0.0),
    ("hymba sliding", HYBRID_BATCH, 1024, 25, 5, 64, 1024, False, 0.0))
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
#: Granite-3.0-1B-A400M's attention (16 q / 8 kv heads of 64) at its
#: 64 x 256 prefill and 512-slot decode; K5 at its d4 attention
#: projections (wq/wo 1,024 -> 1,024, wk/wv 1,024 -> 512) at prefill and
#: decode rows; and K5 over its 32 int8 experts, (E, M, K, N): gate/up
#: (1,024 -> 512) and down (512 -> 1,024) at the prefill's 64 rows x 80
#: capacity slots and at decode's 64 x 1
MOE_FLASH_CASES = (("granite", SERVE_BATCH, PROMPT, PROMPT, 16, 8, 64, 0,
                    True, 0.0),)
MOE_DECODE_CASES = (("granite", SERVE_BATCH, MAX_LEN, 16, 8, 64, 0, False,
                     0.0),)
MOE_INT8_SHAPES = tuple((m, 1024, n) for m in (SERVE_BATCH * PROMPT,
                                                SERVE_BATCH)
                        for n in (1024, 512))
MOE_EXPERT_SHAPES = tuple((32, SERVE_BATCH * c, k, n) for c in (80, 1)
                          for k, n in ((1024, 512), (512, 1024)))


def sdpa(torch, q, k, v, **kw):
    """``F.scaled_dot_product_attention`` on the model's (B, S, H, hd)
    layout (transposed views), GQA enabled — timed as the library's
    counterpart of K3/K4, never on the path."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        enable_gqa=True, **kw)


def instance_regs(ptxas, *parts):
    """[registers, spill store bytes, spill load bytes] of the one kernel
    function of a ``ptxas_summary`` whose mangled name holds every one of
    ``parts`` (template arguments as the mangling writes them), else
    None."""
    hits = [v for fn, v in (ptxas or {}).items()
            if all(p in fn for p in parts)]
    return hits[0] if len(hits) == 1 else None


def flash_regs(ptxas, dtype, hd, cap=False, lse=False):
    """The ptxas line of K3's instance for ``dtype`` at head dim ``hd``,
    with or without the soft-cap, serving or writing the row log-sum-exp
    (``lse``, training)."""
    kind = "tc" if dtype == "bfloat16" else "f32"
    return instance_regs(ptxas, "flash_attention_%s_kernelILi%dELb%dELb%dE"
                         % (kind, hd, int(bool(cap)), int(bool(lse))))


def decode_regs(ptxas, dtype, hd, g, cap=False):
    """The ptxas line of K4's partial kernel for ``dtype``, head dim
    ``hd``, the compiled group (1, 2, 8 or 16 heads) that takes ``g`` q
    heads a kv head, with or without the soft-cap."""
    gb = 1 if g <= 1 else 2 if g <= 2 else 8 if g <= 8 else 16
    t = "I13__nv_bfloat16" if dtype == "bfloat16" else "If"
    return instance_regs(ptxas, "decode_partial_kernel%sLi%dELi%dELb%dE"
                         % (t, hd, gb, int(bool(cap))))


#: the cap of each capped case's second check: it bends most of the
#: unit-scale inputs' scaled scores (~N(0, 1)), where ``SOFTCAP`` moves
#: only their tails, so a kernel that left the cap out fails there
BENT_CAP = 2.0
_FLEX = []


def flex(torch):
    """``flex_attention`` under ``torch.compile``, as it is meant to be
    run: compiled once a process, recompiled for each new case."""
    if not _FLEX:
        from torch.nn.attention.flex_attention import flex_attention
        _FLEX.append(torch.compile(flex_attention, dynamic=False))
    return _FLEX[0]


def capped_library(torch, q, k, v, cap, *, causal=False, window=0,
                   bias=None):
    """The one PyTorch call that computes a capped K3 or K4 case:
    ``flex_attention`` with the cap as its ``score_mod`` (``tanh(s /
    cap) * cap`` on the scaled score, then ``+ bias[b, kv]``) and the
    case's mask (q right-aligned, causal, ``window``) as its block mask.
    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd), passed as transposed
    views as ``sdpa`` passes them. Returns the call, which gives (B, Sq,
    H, hd); timed beside the kernel, never on the path."""
    from torch.nn.attention.flex_attention import create_block_mask
    sq, h, skv, kv = q.shape[1], q.shape[2], k.shape[1], k.shape[2]
    off = skv - sq

    def score_mod(s, b, hh, qi, ki):
        s = torch.tanh(s / cap) * cap
        return s if bias is None else s + bias[b, ki]

    def band(b, hh, qi, ki):
        keep = ki <= qi + off if causal else ki >= 0
        return keep & (ki > qi + off - window) if window else keep
    mask = create_block_mask(band, None, None, sq, skv, device=q.device) \
        if causal or window else None
    fn = flex(torch)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: fn(qt, kt, vt, score_mod=score_mod, block_mask=mask,
                      enable_gqa=h != kv).transpose(1, 2)


def cap_checks(call, plain, args, kw, want, tol, what):
    """A capped case's proof that its check sees the cap: how far the
    plain version at the case's cap sits from the uncapped one
    (``cap_effect``, ``want`` the capped plain output); then the kernel
    (``call``) against the plain version at ``BENT_CAP``, within ``tol``,
    where that distance (``bent_cap_effect``) must pass ``tol``."""
    base = plain(*args, **dict(kw, softcap=0.0)).float()
    bent = dict(kw, softcap=BENT_CAP)
    ref_ = plain(*args, **bent).float()
    err = float((call(*args, **bent).float() - ref_).abs().max())
    effect = float((ref_ - base).abs().max())
    check(err <= tol, f"{what} at cap {BENT_CAP}: error {err} > {tol}")
    check(effect > tol, f"{what}: a cap of {BENT_CAP} moves the plain "
          f"version by {effect}, within the tolerance {tol}")
    return dict(cap_effect=float((want.float() - base).abs().max()),
                bent_cap=BENT_CAP, bent_max_abs_err=err,
                bent_cap_effect=effect)


def flash_phase(torch, flash_attention, cases=FLASH_CASES, path="serving",
                ptxas=None, f32=None):
    """K3 at every case of ``cases`` (``FLASH_CASES``: causal or not, Sq
    against Skv, a soft-cap); bf16 (the path's type; timed, beside the
    library: SDPA with the same mask, or ``capped_library`` where the
    case has a soft-cap) and float32 (at the cases named in ``f32``,
    default all; checked, not timed). A capped case adds ``cap_checks``.
    Each line gives the registers and spills of the instance that ran
    (``ptxas``: the ``ptxas_summary`` of K3's build). Returns the
    kernels-line entry when ``cases`` hold the serving path's main
    shape, else None."""
    g = torch.Generator(device="cuda").manual_seed(5)
    errs, main = [], None
    for name, b, sq, skv, h, kv, hd, window, causal, cap in cases:
        kw = dict(causal=causal, window=window, softcap=cap)
        for dtype in ("bfloat16", "float32"):
            if dtype == "float32" and f32 is not None and name not in f32:
                continue
            dt = getattr(torch, dtype)
            q, k, v = (torch.randn(shape, generator=g, device="cuda")
                       .to(dt) for shape in ((b, sq, h, hd),
                                             (b, skv, kv, hd),
                                             (b, skv, kv, hd)))
            got = flash_attention.flash_attention_cuda(q, k, v, **kw)
            want = flash_attention.plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tol = ATTN_TOL[dtype]
            what = f"flash_attention {name} Sq={sq} Skv={skv} {dtype}"
            check(err <= tol, f"{what}: error {err} > {tol}")
            errs.append(err)
            line = dict(phase="kernel_parity", kernel="flash_attention",
                        path=path, layout=name, shape=[b, sq, h, kv, hd],
                        window=window, dtype=dtype, max_abs_err=err,
                        tolerance=tol,
                        registers_spills=flash_regs(ptxas, dtype, hd, cap))
            if sq != skv:
                line["kv_len"] = skv
            if not causal or cap:
                line.update(causal=causal, softcap=cap)
            if cap:
                line.update(cap_checks(flash_attention.flash_attention_cuda,
                                       flash_attention.plain, (q, k, v), kw,
                                       want, tol, what))
            if dtype != "bfloat16":   # checked, not timed
                emit(**line)
                continue
            ms, wall_ms, prof_ms = timed(
                lambda: flash_attention.flash_attention_cuda(q, k, v, **kw),
                profile=True)
            plain_ms, _, _ = timed(lambda: flash_attention.plain(q, k, v,
                                                                 **kw))
            if cap:
                lib = capped_library(torch, q, k, v, cap, causal=causal,
                                     window=window)
                line.update(library="flex_attention", library_max_abs_err=(
                    float((lib().float() - want.float()).abs().max())))
            else:
                qp = torch.arange(sq, device="cuda")[:, None] + (skv - sq)
                kp = torch.arange(skv, device="cuda")[None, :]
                band = (kp <= qp) & ((kp > qp - window) if window else True)

                def lib():
                    return sdpa(torch, q, k, v, **(
                        {"attn_mask": band} if window else
                        {"is_causal": causal}))
            # q, k, v read once, o written once (bf16); the products the
            # data needs: 2 * 2 * hd per (q, k) pair the mask keeps (the
            # cap's one tanh a pair is not counted)
            ops_, nbytes = flash_attention.cost(b, sq, skv, h, kv, hd, 2,
                                                causal=causal, window=window)
            b_ms, b_by = bound(nbytes, ops_, BF16_TC_OPS_PER_S)
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=timed(lib)[0],
                       cold_ms=cold_ms(lambda: flash_attention
                                       .flash_attention_cuda(q, k, v, **kw)),
                       library_cold_ms=cold_ms(lib),
                       bound_share=b_ms / ms)
            emit(**line, profiler_ms=prof_ms, wall_ms=wall_ms, **row)
            if name == "d0/d4" and sq == PROMPT:
                main = row
    if main is None:
        return None
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:84",
                max_abs_err=max(errs), **main)


def decode_phase(torch, ops, decode_attention, cases=DECODE_CASES,
                 path="serving", ptxas=None, f32=None):
    """K4 at every case of ``cases`` (``DECODE_CASES``): caches of up to
    ``MAX_LEN`` slots written half way (the ring's unwritten slots
    masked by the bias), longer ones (Hymba's, Gemma3's and PaliGemma's)
    full at their last position, the sliding rings wrapped, a cross
    cache (an encoder's frames) every slot valid; bf16 (timed, beside
    the library: SDPA with the bias as its mask, or ``capped_library``
    where the case has a soft-cap) and float32 (at the cases named in
    ``f32``, default all). A capped case adds ``cap_checks``. Each line
    gives the registers and spills of the partial kernel's instance that
    ran (``ptxas``: the ``ptxas_summary`` of K4's build). Returns the
    kernels-line entry when ``cases`` hold the serving path's main
    shape, else None."""
    g = torch.Generator(device="cuda").manual_seed(6)
    errs, main = [], None
    for name, b, sc, h, kv, hd, window, cross, cap in cases:
        idx = torch.arange(sc, device="cuda")[None].repeat(b, 1)
        if cross:
            cur = torch.full((b,), sc, device="cuda")
            kv_pos = idx
        elif window or sc > MAX_LEN:
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
            if dtype == "float32" and f32 is not None and name not in f32:
                continue
            dt = getattr(torch, dtype)
            q = torch.randn((b, h, hd), generator=g, device="cuda").to(dt)
            kc, vc = (torch.randn((b, sc, kv, hd), generator=g,
                                  device="cuda").to(dt) for _ in range(2))
            got = ops.decode_attention(q, kc, vc, kv_pos, cur, window=window,
                                       softcap=cap)
            want = decode_attention.plain(q, kc, vc, bias, cap)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tol = ATTN_TOL[dtype]
            what = f"decode_attention {name} Sc={sc} {dtype}"
            check(err <= tol, f"{what}: error {err} > {tol}")
            errs.append(err)
            regs = decode_regs(ptxas, dtype, hd, h // kv, cap)
            line = dict(phase="kernel_parity", kernel="decode_attention",
                        path=path, layout=name, shape=[b, sc, h, kv, hd],
                        window=window, dtype=dtype, max_abs_err=err,
                        tolerance=tol, registers_spills=regs)
            if cross or cap:
                line.update(cross_cache=cross, softcap=cap)
            if cap:
                line.update(cap_checks(decode_attention.decode_attention_cuda,
                                       decode_attention.plain,
                                       (q, kc, vc, bias), {"softcap": cap},
                                       want, tol, what))
            if dtype != "bfloat16":   # checked, not timed
                emit(**line)
                continue
            ms, wall_ms, prof_ms = timed(
                lambda: decode_attention.decode_attention_cuda(
                    q, kc, vc, bias, cap), profile=True)
            plain_ms, _, _ = timed(
                lambda: decode_attention.plain(q, kc, vc, bias, cap))
            if cap:
                lib = capped_library(torch, q[:, None], kc, vc, cap,
                                     bias=bias)
                line.update(library="flex_attention", library_max_abs_err=(
                    float((lib()[:, 0].float() - want.float()).abs().max())))
            else:
                mask = bias.to(dt)[:, None, None, :]

                def lib():
                    return sdpa(torch, q[:, None], kc, vc, attn_mask=mask)
            # both caches read whole (bf16), q and o, the f32 bias row;
            # 2 * 2 * hd per (head, slot)
            ops_, nbytes = decode_attention.cost(b, h, kv, hd, sc, 2)
            b_ms, b_by = bound(nbytes, ops_, BF16_TC_OPS_PER_S)
            splits, _ = decode_attention.split_plan(b, kv, sc, h // kv)
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=timed(lib)[0],
                       cold_ms=cold_ms(lambda: decode_attention
                                       .decode_attention_cuda(
                                           q, kc, vc, bias, cap)),
                       library_cold_ms=cold_ms(lib),
                       bound_share=b_ms / ms, blocks=b * kv * splits)
            emit(**line, profiler_ms=prof_ms, wall_ms=wall_ms, **row)
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
        ms, wall_ms, prof_ms = timed(kern, profile=True)
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
             max_abs_err=0.0, tile=[bm, bn], profiler_ms=prof_ms,
             wall_ms=wall_ms,
             **row)
        if (m, k, n) == (SERVE_BATCH * PROMPT, 256, 1024):
            main = row
    if main is None:
        return None
    return dict(name="int8_matmul", route="cuda",
                source="src/repro_torch/csrc/int8_matmul.cu",
                replaces="src/repro/kernels/int8_matmul.py:40",
                max_abs_err=0.0, **main)


def int8_batched_phase(torch, ref, int8_matmul, shapes=MOE_EXPERT_SHAPES,
                       path="moe_serving"):
    """K5 over a batch of experts, (E, M, K) x (E, K, N) on K-major
    weights, one launch: bit-exact against the plain version in float32
    and bfloat16; timed in bfloat16 (the path's type), warm and with the
    L2 cold. No single PyTorch call computes a batched int8 product, so
    ``library_ms`` is null; the loop of E ``torch._int_mm`` calls with the
    dequantization to bf16 is timed beside it for information."""
    g = torch.Generator(device="cuda").manual_seed(9)
    bf16 = torch.bfloat16
    for e, m, k, n in shapes:
        xq, sx = ref.quantize_ref(torch.randn((e, m, k), generator=g,
                                              device="cuda"))
        wq, sw = ref.quantize_ref(torch.randn((e, k, n), generator=g,
                                              device="cuda"), dim=1)
        wq = int8_matmul.k_major(wq)
        for dt in (torch.float32, bf16):
            got = int8_matmul.int8_matmul_cuda(xq, sx, wq, sw, dt)
            want = int8_matmul.plain(xq, sx, wq, sw, dt)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"int8_matmul x {e} experts "
                  f"{m}x{k}x{n} {dt}: not bit-exact (max err "
                  f"{float((got.float() - want.float()).abs().max())})")
        del got, want

        def kern():
            return int8_matmul.int8_matmul_cuda(xq, sx, wq, sw, bf16)

        def loop():
            return [(torch._int_mm(xq[i], wq[i]).to(torch.float32) * sx[i]
                     * sw[i]).to(bf16) for i in range(e)]
        ms, wall_ms, prof_ms = timed(kern, profile=True)
        plain_ms, _, _ = timed(lambda: int8_matmul.plain(xq, sx, wq, sw,
                                                         bf16), 1, 3)
        loop_ms, _, _ = timed(loop)
        ops_, nbytes = int8_matmul.cost(m, k, n, 2, e)
        b_ms, b_by = bound(nbytes, ops_, INT8_TC_OPS_PER_S)
        bm, bn = int8_matmul.plan(m, n, k)
        emit(phase="kernel_parity", kernel="int8_matmul", path=path,
             experts=e, shape=[m, k, n], dtype="bfloat16",
             bit_exact=["float32", "bfloat16"], max_abs_err=0.0,
             tile=[bm, bn], blocks=e * -(-m // bm) * -(-n // bn),
             profiler_ms=prof_ms, wall_ms=wall_ms, ms=ms,
             cold_ms=cold_ms(kern),
             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             bound_share=b_ms / ms, library_ms=None,
             int_mm_loop_ms=loop_ms, launches_per_call=1)


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
        inst = f"selective_scan_kernelI{SCAN_TYPES[dtype]}Li{lanes}ELb0EE"
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
        ms, wall_ms, prof_ms = timed(
            lambda: selective_scan.selective_scan_cuda(*args), profile=True)
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
        emit(phase="kernel_parity", **line, profiler_ms=prof_ms,
             wall_ms=wall_ms,
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
BRIDGE_TURNS = 1


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
        win_us, by_name, _ = profile_window(torch, lambda: agent.run(5))
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


def decode_profile(torch, engines, caches, steps=DECODE_PROFILE_STEPS,
                   path="serving", batch=SERVE_BATCH):
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


def prefill_profile(torch, engines, batch, prompt, max_len, path,
                    variants=("d0",)):
    """The device time of one prefill of each of ``variants`` at
    ``batch`` x ``prompt`` tokens: its busy share, the port's kernels' ms
    and share (K6's in every Mamba block) and the eight kernels with the
    most device time."""
    import numpy as np
    for vid in variants:
        eng = engines["S"][vid]
        cfg = eng.model.cfg
        toks = torch.tensor(np.random.default_rng(4).integers(
            0, cfg.vocab_size, (batch, prompt)).astype(np.int32),
            device="cuda")

        def run():
            with torch.inference_mode():
                eng.model.prefill(eng.params, {"tokens": toks},
                                  max_len=max_len)
        run()
        step_profile(torch, run, 1, top=8, path=path, variant=vid,
                     arch=cfg.name, what="prefill", batch=batch,
                     prompt=prompt)


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


#: batch rows of ``moe_cpu_agreement``'s cuts
MOE_AGREE_BATCH = 16
#: the largest difference allowed between the card's and the CPU's router
#: probabilities on one input (the same float32 product on both)
MOE_BLOCK_PROB_LIMIT = 1e-5
#: and over a whole 2-layer cut, where each router's input carries the
#: card's bf16 attention and, in d4, its int8 rounding of activations:
#: 7.8e-4 (d0) and 1.5e-3 (d4) read at 8 and 16 rows (PERF.md §6), with
#: room above, and well below what a wrong block before a router moves
MOE_PROB_LIMIT = 5e-3


def _pairs(card, cpu, out=None):
    """{id of each dict of the CPU copy ``cpu`` of a param tree: the same
    dict of ``card``}."""
    out = {} if out is None else out
    if isinstance(cpu, dict):
        out[id(cpu)] = card
        for k in cpu:
            _pairs(card[k], cpu[k], out)
    elif isinstance(cpu, list):
        for g, c in zip(card, cpu):
            _pairs(g, c, out)
    return out


class MoEAgreement:
    """Within its ``with`` block, the MoE blocks of one model run on the
    card and on the CPU (``model_cpu_agreement``) are held two ways.

    Block by block, on one input: each CPU call of ``moe.moe_apply`` runs
    again on the card, with the card's copy of its weights (``card``, from
    ``_pairs``), on the CPU's own input. A token's set of experts must be
    the CPU's wherever the CPU router's k-th/(k+1)-th margin exceeds 1e-4,
    and the router probabilities agree within ``MOE_BLOCK_PROB_LIMIT``;
    at least half the batch rows must keep every choice, and on those
    rows the kept entries are equal and the outputs within the bf16
    tolerance (atol 0.125 + rtol 1e-2).

    End to end: every router call of the model is recorded by device
    (the i-th on the card against the i-th on the CPU) and the
    probabilities must agree within ``MOE_PROB_LIMIT``; a choice may flip
    there where the two routers' inputs differ and the margin is small,
    and the phase counts the flips, the margins where they fell, and the
    batch rows none of whose tokens ever flipped."""

    def __init__(self, torch, moe, card):
        self.torch, self.moe, self.card = torch, moe, card
        self.router, self.apply = moe.router, moe.moe_apply
        self.calls, self.recording = {"cuda": [], "cpu": []}, True
        self.equal = self.total = self.tokens_equal = self.tokens = 0
        self.margin_1e4_differ = 0
        self.margins_differ, self.prob_diff = [], 0.0
        self.diverged = None
        self.blocks = self.block_tokens = 0
        self.block_margins_differ, self.block_rows = [], []
        self.block_prob_diff = self.block_share = 0.0

    def __enter__(self):
        def router(params, x, cfg):
            out = self.router(params, x, cfg)
            if self.recording:
                self.calls[x.device.type].append((out[0], out[2],
                                                  cfg.moe.top_k))
            return out

        def apply(params, x, cfg):
            out = self.apply(params, x, cfg)
            if x.device.type == "cpu":
                self.hold_block(self.card[id(params)], x, cfg, out)
            return out
        self.moe.router, self.moe.moe_apply = router, apply
        return self

    def __exit__(self, *exc):
        self.moe.router, self.moe.moe_apply = self.router, self.apply

    def same_sets(self, probs, ids_g, ids_c, k):
        """(the tokens whose sets of experts are equal, the CPU router's
        k-th/(k+1)-th margin), both (B, S)."""
        torch = self.torch
        srt = torch.sort(probs, dim=-1, descending=True).values
        return ((torch.sort(ids_g, -1).values
                 == torch.sort(ids_c, -1).values).all(-1),
                srt[..., k - 1] - srt[..., k])

    def hold_block(self, params, x, cfg, out):
        torch, k = self.torch, cfg.moe.top_k
        y_c, probs_c, ids_c, keep_c = out
        self.recording = False
        y_g, probs_g, ids_g, keep_g = (t.cpu() for t in self.apply(
            params, x.cuda(), cfg))
        self.recording = True
        same, margin = self.same_sets(probs_c, ids_g, ids_c, k)
        n_bad = int((~same & (margin > 1e-4)).sum())
        check(n_bad == 0, f"{cfg.name}: {n_bad} tokens of an MoE block "
              "chose other experts on the card than on the CPU on the same "
              "input where the router's margin exceeds 1e-4")
        diff = float((probs_g - probs_c).abs().max())
        check(diff <= MOE_BLOCK_PROB_LIMIT, f"{cfg.name}: router "
              f"probabilities differ by {diff} on the same input")
        rows = same.all(-1)
        n_rows = int(rows.sum())
        check(2 * n_rows >= rows.numel(), f"{cfg.name}: only {n_rows} of "
              f"{rows.numel()} rows keep every choice of an MoE block")
        check(torch.equal(keep_g[rows], keep_c[rows]), f"{cfg.name}: an "
              "MoE block drops other entries on the card")
        yg, yc = y_g.float()[rows], y_c.float()[rows]
        check(bool(torch.allclose(yg, yc, atol=0.125, rtol=1e-2)),
              f"{cfg.name}: an MoE block's output on the card differs from "
              f"the CPU's by {float((yg - yc).abs().max())} on the same "
              "input")
        self.blocks += 1
        self.block_tokens += same.numel()
        self.block_margins_differ += margin[~same].tolist()
        self.block_rows.append(n_rows)
        self.block_prob_diff = max(self.block_prob_diff, diff)
        self.block_share = max(self.block_share, limit_share(yg, yc))

    def fold(self, batch):
        """Fold in the model's router calls since the last reading."""
        torch = self.torch
        if self.diverged is None:
            self.diverged = torch.zeros(batch, dtype=torch.bool)
        card, cpu = self.calls["cuda"], self.calls["cpu"]
        check(len(card) == len(cpu), "router: card and CPU calls differ")
        for (probs_g, ids_g, k), (probs, ids_c, _) in zip(card, cpu):
            ids_g = ids_g.cpu()
            same, margin = self.same_sets(probs, ids_g, ids_c, k)
            self.equal += int((ids_g == ids_c).sum())
            self.total += ids_c.numel()
            self.tokens_equal += int(same.sum())
            self.tokens += same.numel()
            self.prob_diff = max(self.prob_diff, float(
                (probs_g.cpu() - probs).abs().max()))
            self.margin_1e4_differ += int((~same & (margin > 1e-4)).sum())
            self.margins_differ += margin[~same].tolist()
            self.diverged |= (~same).any(-1)
        card.clear(), cpu.clear()
        check(self.prob_diff <= MOE_PROB_LIMIT, "router probabilities on "
              f"the card and the CPU differ by {self.prob_diff} > "
              f"{MOE_PROB_LIMIT}")

    def line(self):
        return dict(block_calls=self.blocks, block_tokens=self.block_tokens,
                    block_sets_differ=len(self.block_margins_differ),
                    block_min_margin_where_differ=min(
                        self.block_margins_differ, default=None),
                    block_prob_max_diff=self.block_prob_diff,
                    block_prob_limit=MOE_BLOCK_PROB_LIMIT,
                    block_rows_held_min=min(self.block_rows, default=None),
                    block_limit_share=self.block_share,
                    router_choices_equal_share=self.equal / self.total,
                    router_sets_equal_share=self.tokens_equal / self.tokens,
                    router_tokens=self.tokens,
                    router_sets_differ=len(self.margins_differ),
                    router_prob_max_diff=self.prob_diff,
                    router_prob_limit=MOE_PROB_LIMIT,
                    min_margin_where_differ=min(self.margins_differ,
                                                default=None),
                    max_margin_where_differ=max(self.margins_differ,
                                                default=None),
                    margin_1e4_differ=self.margin_1e4_differ,
                    rows_held=int((~self.diverged).sum()))


def model_cpu_agreement(torch, cfg, params, build_model, batch, prompt,
                        variant, steps=3, phase="ssm_cpu_agreement",
                        moe=None, img_tokens=0, frames=0):
    """The card's model and the CPU's plain path on the same weights (a
    copy of the card's): prefill and ``steps`` decode steps fed the CPU's
    greedy tokens, logits within the bf16 tolerance (atol 0.125 + rtol
    1e-2), greedy tokens equal where the CPU's top-2 margin is > 0.25.
    With ``moe`` (the module ``models.moe``) every MoE block is held on
    the CPU's input and the routers end to end (``MoEAgreement``); with
    ``img_tokens`` a VLM's prompt runs behind that many seeded stub image
    embeddings; with ``frames`` an encoder-decoder's prompt cross-attends
    that many seeded stub frames through the encoder. Returns the phase's
    line."""
    import contextlib
    import numpy as np
    m = build_model(cfg)
    p_cpu = _to_cpu(params)
    vocab = cfg.vocab_size
    toks = np.random.default_rng(2).integers(0, vocab, (batch, prompt)) \
        .astype(np.int32)
    max_len = img_tokens + prompt + steps + 1
    batch_cpu = {"tokens": torch.tensor(toks)}
    if img_tokens:
        batch_cpu["img_embeds"] = torch.tensor(
            np.random.default_rng(3).standard_normal(
                (batch, img_tokens, cfg.d_model)).astype(np.float32))
    if frames:
        batch_cpu["frames"] = torch.tensor(
            np.random.default_rng(3).standard_normal(
                (batch, frames, cfg.d_model)).astype(np.float32))
    errs, shares, clear_rows, equal = [], [], 0, True
    rec = MoEAgreement(torch, moe, _pairs(params, p_cpu)) \
        if moe is not None else None
    with torch.inference_mode(), (rec or contextlib.nullcontext()):
        lg, cg = m.prefill(params, {k: v.cuda() for k, v in
                                    batch_cpu.items()}, max_len=max_len)
        lc, cc = m.prefill(p_cpu, batch_cpu, max_len=max_len)
        for step in range(steps + 1):
            if rec is not None:
                rec.fold(batch)
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
            cur = lc[:, -1, :vocab].float().argmax(-1)[:, None].int()
            lg, cg = m.decode(params, cg, cur.cuda())
            lc, cc = m.decode(p_cpu, cc, cur)
    check(equal, f"{cfg.name} {variant}: card and CPU pick different "
          "greedy tokens where the margin is clear")
    line = dict(phase=phase, arch=cfg.name, variant=variant,
                layers=cfg.n_layers, d_model=cfg.d_model)
    if cfg.ssm is not None:
        line["d_inner"] = cfg.d_inner
    if cfg.is_encdec:
        line.update(enc_layers=cfg.n_enc_layers, frames=frames)
    line.update(batch=batch, prompt=prompt, image_tokens=img_tokens,
                peak_gb=peak_gb(torch),
                decode_steps=steps, logits_max_abs_err=max(errs),
                logits_tolerance=[0.125, 1e-2],
                logits_limit_share=max(shares),
                clear_margin_tokens=clear_rows, tokens_equal=equal)
    if rec is not None:
        line.update(rec.line())
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


def _scales(params):
    """Elements of a param tree's int8 scales (the ``s`` leaves)."""
    if isinstance(params, list):
        return sum(_scales(p) for p in params)
    if isinstance(params, dict):
        return sum(v.numel() if k == "s" else _scales(v)
                   for k, v in params.items())
    return 0


def family_line(cfg, params, init_s):
    """The served model's sizes: its SSM fields where it has Mamba
    blocks, its experts where it is a mixture of experts."""
    n, nbytes = _held(params)
    line = dict(arch=cfg.name, quant=cfg.quant, n_layers=cfg.n_layers,
                d_model=cfg.d_model, vocab=cfg.vocab_size)
    if cfg.ssm is not None:
        line.update(d_inner=cfg.d_inner, state=cfg.ssm.state_dim)
    if cfg.moe is not None:
        line.update(n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
                    capacity_factor=cfg.moe.capacity_factor, d_ff=cfg.d_ff)
    line.update(params_analytic=cfg.param_count(), params_held=n,
                weight_gb=nbytes / 1e9, init_seconds=init_s)
    return line


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


# ------------------------------------------------ mixture-of-experts ----
def prefill_drops(torch, eng, toks, moe):
    """``dropped_frac`` of each MoE block in one prefill of ``toks``
    (``moe.moe_aux`` of each ``moe.moe_apply``, whose aux statistics the
    served model never computes)."""
    fracs = []
    inner = moe.moe_apply

    def recording(params, x, cfg):
        out = inner(params, x, cfg)
        fracs.append(moe.moe_aux(*out[1:], cfg.moe.n_experts)
                     ["dropped_frac"])
        return out
    moe.moe_apply = recording
    try:
        with torch.inference_mode():
            eng.model.prefill(eng.params, {"tokens": torch.tensor(
                toks, device="cuda")}, max_len=MAX_LEN)
    finally:
        moe.moe_apply = inner
    return [float(f) for f in fracs]


def moe_serving(torch, engines, init_s, moe):
    """Granite-3.0-1B-A400M d0 and d4 at full size: ``generate`` at batch
    64, prompt 256, 16 new tokens, cache 512; the K/V cache checked at
    (24, 64, 512, 8, 64); the prefill's drops per layer; the parameters
    held against ``param_count()``."""
    import numpy as np
    rng = np.random.default_rng(0)
    out = {}
    for vid in MOE_VARIANTS:
        eng = engines["S"][vid]
        cfg = eng.model.cfg
        toks = rng.integers(0, cfg.vocab_size, (SERVE_BATCH, PROMPT)) \
            .astype(np.int32)
        out[vid], prefill_ms, decode_ms, wall = timed_generate(
            torch, eng, toks, MAX_LEN)
        (seg,) = out[vid]["segments"]
        kv = (cfg.n_layers, SERVE_BATCH, MAX_LEN, cfg.n_kv_heads,
              cfg.resolved_head_dim)
        check(set(seg) == {"k", "v"} and tuple(seg["k"].shape) == kv
              == tuple(seg["v"].shape) == (24, 64, 512, 8, 64),
              f"{vid}: unexpected K/V cache {tuple(seg['k'].shape)}")
        drops = prefill_drops(torch, eng, toks, moe)
        check(len(drops) == cfg.n_layers and
              all(0.0 <= f < 1.0 for f in drops),
              f"{vid}: prefill drops {drops}")
        line = family_line(cfg, eng.params, init_s[vid])
        if cfg.quant == "none":
            check(line["params_held"] == line["params_analytic"],
                  f"{vid}: {line['params_held']} parameters held, "
                  f"{line['params_analytic']} by param_count()")
        emit(phase="moe_serving", variant=vid, **line,
             active_params=cfg.active_param_count(),
             heads=[cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim],
             capacity_prefill=moe.capacity(PROMPT, cfg.moe.top_k,
                                           cfg.moe.n_experts,
                                           cfg.moe.capacity_factor),
             batch=SERVE_BATCH, prompt=PROMPT, new_tokens=NEW_TOKENS,
             max_len=MAX_LEN, kv_cache=list(kv), prefill_ms=prefill_ms,
             decode_ms_per_token=decode_ms, generate_ms=wall * 1e3,
             tokens_per_s=SERVE_BATCH * NEW_TOKENS / wall,
             prefill_dropped_frac_mean=sum(drops) / len(drops),
             prefill_dropped_frac_max=max(drops))
    return out


# ------------------------------------------------ dense and VLM path ----
#: the dense and VLM path: Gemma3-4B (batch 8 x 2,048, past its 1,024-token
#: window; cache 2,064) and InternLM2-20B (batch 32 x 256, cache 512)
#: served whole, d0 and d4; PaliGemma-3B whole (batch 16, 256 image + 256
#: text tokens); Gemma-7B whole, Yi-34B cut to 8 layers and DBRX to 2 (batch
#: 16 x 256, cache 512); the fleet routed into Gemma3's engines
GEMMA3_ARCH, INTERN_ARCH = "gemma3-4b", "internlm2-20b"
DENSE_ARCHS = (INTERN_ARCH, "yi-34b", "gemma-7b", GEMMA3_ARCH,
               "paligemma-3b")
DENSE_VARIANTS = ("d0", "d4")
GEMMA3_BATCH, GEMMA3_PROMPT = 8, 2048
GEMMA3_MAX_LEN = GEMMA3_PROMPT + NEW_TOKENS
INTERN_BATCH = 32
PALI_BATCH, PALI_IMG = 16, 256
PALI_MAX_LEN = PALI_IMG + PROMPT + NEW_TOKENS
CUT_BATCH, YI_LAYERS, DBRX_LAYERS = 16, 8, 2
DENSE_ROUTE_SEED = 19
#: K3 and K4 cases (``FLASH_CASES``, ``DECODE_CASES``) at the layouts of
#: each of ``dense_serving`` and of ``vlm_and_cuts``; float32 checked at
#: one layout of each head dim (``DENSE_F32``)
DENSE_FLASH_CASES = (
    ("internlm2", INTERN_BATCH, PROMPT, PROMPT, 48, 8, 128, 0, True, 0.0),
    ("gemma3 global", GEMMA3_BATCH, GEMMA3_PROMPT, GEMMA3_PROMPT, 8, 4, 256,
     0, True, 0.0),
    ("gemma3 sliding", GEMMA3_BATCH, GEMMA3_PROMPT, GEMMA3_PROMPT, 8, 4,
     256, 1024, True, 0.0))
DENSE_DECODE_CASES = (
    ("internlm2", INTERN_BATCH, MAX_LEN, 48, 8, 128, 0, False, 0.0),
    ("gemma3 global", GEMMA3_BATCH, GEMMA3_MAX_LEN, 8, 4, 256, 0, False,
     0.0),
    ("gemma3 sliding", GEMMA3_BATCH, 1024, 8, 4, 256, 1024, False, 0.0))
VLM_FLASH_CASES = (
    ("yi", CUT_BATCH, PROMPT, PROMPT, 56, 8, 128, 0, True, 0.0),
    ("gemma-7b", CUT_BATCH, PROMPT, PROMPT, 16, 16, 256, 0, True, 0.0),
    ("paligemma", PALI_BATCH, PALI_IMG + PROMPT, PALI_IMG + PROMPT, 8, 1,
     256, 0, True, 0.0))
VLM_DECODE_CASES = (
    ("yi", CUT_BATCH, MAX_LEN, 56, 8, 128, 0, False, 0.0),
    ("gemma-7b", CUT_BATCH, MAX_LEN, 16, 16, 256, 0, False, 0.0),
    ("paligemma", PALI_BATCH, PALI_MAX_LEN, 8, 1, 256, 0, False, 0.0))
DENSE_F32 = ("internlm2", "paligemma")


def free_card(torch):
    """Release the allocator's cached blocks and start a new peak."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def peak_gb(torch):
    """The card's peak allocated memory since the last reset, in GB."""
    return torch.cuda.max_memory_allocated() / 1e9


def dense_cut(cfg, n_layers):
    """``cfg`` at full width cut to its first ``n_layers`` layers; a
    Gemma3-style interleave keeps a sliding and a global layer (the
    global interval set to the cut's depth)."""
    upd = dict(n_layers=n_layers)
    if cfg.global_interval:
        upd["global_interval"] = n_layers
    return dataclasses.replace(cfg, **upd)


def dense_cpu_agreement(torch, get_config, build_model, variant_seed):
    """Each dense and VLM config at full width cut to 2 layers (Gemma3: a
    sliding and a global one, its prompt 32 tokens past the 1,024-token
    window; PaliGemma behind 16 image tokens), drawn on the card and run
    on the card and on the CPU with the same weights
    (``model_cpu_agreement``); InternLM2 also in d4."""
    from repro_torch.models.variants import build_ladder
    for arch in DENSE_ARCHS:
        cfg = dense_cut(get_config(arch), 2)
        prompt = cfg.sliding_window + 32 if cfg.global_interval else 32
        for vid in ("d0", "d4") if arch == INTERN_ARCH else ("d0",):
            vcfg = build_ladder(cfg)[vid].cfg
            params = build_model(vcfg).init(variant_seed(0, vid),
                                            device="cuda")
            model_cpu_agreement(
                torch, vcfg, params, build_model, 2, prompt, vid,
                phase="dense_cpu_agreement",
                img_tokens=16 if cfg.arch_type == "vlm" else 0)
            del params
            free_card(torch)


def dense_engines_line(torch, eng, init_s, batch, prompt, max_len, cache):
    """The checks and sizes of a served dense model: the K/V cache's
    slots (a ring of ``sliding_window`` slots in a sliding segment, else
    ``max_len``) and position, the weights held (an int8 variant's
    scales aside) against ``param_count()``, its heads and the peak
    memory so far."""
    cfg = eng.model.cfg
    slots = [(seg.is_global, tuple(c["k"].shape))
             for seg, c in zip(eng.model.segments, cache["segments"])]
    kv = (cfg.n_kv_heads, cfg.resolved_head_dim)
    check(all(shape == (seg.length, batch, max_len if g else min(
        cfg.sliding_window, max_len)) + kv for (g, shape), seg in
        zip(slots, eng.model.segments))
        and cache["pos"] == prompt + NEW_TOKENS,
        f"{cfg.name}: unexpected K/V cache {slots} at {cache['pos']}")
    line = family_line(cfg, eng.params, init_s)
    # an int8 linear also holds its per-column scales ("s"), which
    # param_count() leaves out
    weights = line["params_held"] - _scales(eng.params)
    check(weights == line["params_analytic"],
          f"{cfg.name}: {weights} weights held, "
          f"{line['params_analytic']} by param_count()")
    line.update(heads=[cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim],
                d_ff=cfg.d_ff, mlp=cfg.mlp_act,
                tied=cfg.tie_embeddings, batch=batch, prompt=prompt,
                new_tokens=NEW_TOKENS, max_len=max_len,
                kv_cache=[list(shape) for _, shape in slots],
                peak_gb=peak_gb(torch))
    if cfg.global_interval:
        line.update(window=cfg.sliding_window,
                    global_interval=cfg.global_interval,
                    segments=len(eng.model.segments))
    return line


def serve_dense(torch, build_engines, cfg, batch, prompt, max_len):
    """``build_engines`` over ``cfg`` (d0 and d4) at its full size, each
    variant's ``generate`` at ``batch`` x ``prompt`` with 16 new tokens;
    one ``dense_serving`` line a variant. Returns (engines, caches)."""
    import numpy as np
    engines, init_s = build_family(torch, build_engines, cfg,
                                   DENSE_VARIANTS, max_len)
    rng = np.random.default_rng(0)
    caches = {}
    for vid in DENSE_VARIANTS:
        eng = engines["S"][vid]
        toks = rng.integers(0, cfg.vocab_size, (batch, prompt)).astype(
            np.int32)
        caches[vid], prefill_ms, decode_ms, wall = timed_generate(
            torch, eng, toks, max_len)
        emit(phase="dense_serving", variant=vid,
             **dense_engines_line(torch, eng, init_s[vid], batch, prompt,
                                  max_len, caches[vid]),
             prefill_ms=prefill_ms, decode_ms_per_token=decode_ms,
             generate_ms=wall * 1e3,
             tokens_per_s=batch * NEW_TOKENS / wall)
    return engines, caches


def dense_serving(torch, R, build_engines, get_config, kernels,
                  with_gemma3=None):
    """Gemma3-4B and InternLM2-20B as published, d0 bf16 and d4 int8
    (``serve_dense``); a 256-cell 3-user fleet routed into Gemma3's
    engines (``route_dispatch_dense``); ``with_gemma3`` called on
    Gemma3's d0 engine (the int8 K/V cache's phase, its weights reused);
    the decode and prefill profiles of both. Returns (the path's
    launches of ``kernels``, counted from its start (the profiles and
    ``with_gemma3`` outside), what ``with_gemma3`` returned)."""
    for k in kernels:
        k.launches = 0
    free_card(torch)
    engines, caches = serve_dense(torch, build_engines,
                                  get_config(GEMMA3_ARCH), GEMMA3_BATCH,
                                  GEMMA3_PROMPT, GEMMA3_MAX_LEN)
    route_dispatch(torch, R, engines, cells=SSM_ROUTE_CELLS,
                   phase="route_dispatch_dense", seed=DENSE_ROUTE_SEED)
    launches = {k.name: k.launches for k in kernels}
    extra = with_gemma3(engines["S"]["d0"]) if with_gemma3 else None
    decode_profile(torch, engines, caches, path="dense_serving",
                   batch=GEMMA3_BATCH)
    prefill_profile(torch, engines, GEMMA3_BATCH, GEMMA3_PROMPT,
                    GEMMA3_MAX_LEN, "dense_serving", variants=DENSE_VARIANTS)
    del engines, caches
    free_card(torch)
    before = {k.name: k.launches for k in kernels}
    engines, caches = serve_dense(torch, build_engines,
                                  get_config(INTERN_ARCH), INTERN_BATCH,
                                  PROMPT, MAX_LEN)
    for k in kernels:
        launches[k.name] += k.launches - before[k.name]
    decode_profile(torch, engines, caches, path="dense_serving",
                   batch=INTERN_BATCH)
    prefill_profile(torch, engines, INTERN_BATCH, PROMPT, MAX_LEN,
                    "dense_serving", variants=DENSE_VARIANTS)
    del engines, caches
    free_card(torch)
    return launches, extra


# ---------------------------------------------- the int8 K/V cache ----
#: the int8 cache's decode on Gemma3-4B whole (8 x 2,048, 16 steps) and
#: its card-vs-CPU check on a 2-layer full-width cut (a sliding and a
#: global layer, the prompt 32 tokens past the 1,024-slot window). The
#: quantized write itself on one row is bit-equal on both. From one int8
#: cache the two decode in bf16, whose K/V rows differ by bf16 steps
#: (2^-7 relative at most): the logits within the bf16 serving
#: tolerance; the rows the decode wrote within 3 int8 steps (a bf16 step
#: of the value and one of the row's amax each move it by up to 127 x
#: 2^-7 = 1 step, and the rounding by one more), their scales within a
#: bf16 step of the amax
INT8_KV_STEPS = 16
INT8_KV_CUT_STEPS = 4
INT8_KV_STEP_TOL = 3
INT8_KV_SCALE_RTOL = 2 ** -7


def quantize_kv(torch, kv):
    """(int8 values, float32 scales) of a K or V (..., hd): the rule the
    int8 decode applies to each new row (``transformer.quantized_write``),
    ``scale = (amax + 1e-8) / 127``, rounded half to even, clipped."""
    kf = kv.float()
    amax = kf.abs().amax(-1) + 1e-8
    scale = amax / amax.new_full((), 127.0)
    q = torch.clamp(torch.round(kf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def int8_cache_of(torch, model, cache, tuning, ctx):
    """A bf16 prefill cache of ``ctx`` positions as ``model.cache_spec``
    lays out an int8 one (``FLAGS["kv_cache_dtype"] == "int8"``): each
    K/V slot quantized by ``quantize_kv``; ``pos`` kept."""
    tuning.FLAGS["kv_cache_dtype"] = "int8"
    try:
        spec = model.cache_spec(cache["segments"][0]["k"].shape[1], ctx)
    finally:
        tuning.FLAGS["kv_cache_dtype"] = "bf16"
    segs = []
    for seg, want in zip(cache["segments"], spec["segments"]):
        c = {}
        for name in ("k", "v"):
            c[name], c[name + "_s"] = quantize_kv(torch, seg[name])
        check({n: (tuple(t.shape), t.dtype) for n, t in c.items()} ==
              {n: (tuple(t.shape), t.dtype) for n, t in want.items()},
              "the int8 cache differs from cache_spec's")
        segs.append(c)
    return {"pos": cache["pos"], "segments": segs}


def cache_gb(cache):
    return sum(t.numel() * t.element_size() for seg in cache["segments"]
               for t in seg.values()) / 1e9


def decode_steps(torch, model, params, cache, cur, steps):
    """``steps`` greedy decode steps from ``cur``; returns (cache, ms a
    step, last logits), host clock around synchronised steps."""
    vocab = model.cfg.vocab_size
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = model.decode(params, cache, cur)
            cur = logits[:, -1:, :vocab].argmax(-1).int()
        torch.cuda.synchronize()
    return cache, (time.perf_counter() - t0) * 1e3 / steps, logits


def quantized_write_agreement(torch, T, cfg):
    """``transformer.quantized_write`` of one random bf16 K row of
    ``cfg``'s layout into a 64-slot int8 ring, on the card and on the
    CPU: the int8 values, the scales and the dequantized cache
    bit-equal."""
    g = torch.Generator(device="cpu").manual_seed(9)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    row = (torch.randn((GEMMA3_BATCH, 1, kv, hd), generator=g) * 4).to(
        torch.bfloat16)
    ring = torch.randint(-127, 128, (GEMMA3_BATCH, 64, kv, hd),
                         generator=g, dtype=torch.int8)
    scales = torch.rand((GEMMA3_BATCH, 64, kv), generator=g)
    card = [t.cuda() for t in (ring, scales, row)]
    out_g = T.quantized_write(card[0], card[1], card[2], 37)
    out_c = T.quantized_write(ring, scales, row, 37)
    same = all(bool(torch.equal(a.cpu(), b)) for a, b in
               ((card[0], ring), (card[1], scales), (out_g, out_c)))
    check(same, "quantized_write: card and CPU differ on the same row")
    return same


def int8_kv_cut(torch, cfg, build_model, tuning):
    """The int8 decode card vs CPU on ``cfg`` cut to 2 layers at full
    width: a card prefill's cache quantized on the card, then
    ``INT8_KV_CUT_STEPS`` decode steps on both from copies of that cache
    and weights, fed the CPU's greedy tokens."""
    import numpy as np
    from repro_torch.models import transformer as T
    write_equal = quantized_write_agreement(torch, T, cfg)
    cut = dense_cut(cfg, 2)
    m = build_model(cut)
    params = m.init(0, device="cuda")
    p_cpu = _to_cpu(params)
    prompt = cut.sliding_window + 32
    vocab = cut.vocab_size
    toks = torch.tensor(np.random.default_rng(4).integers(
        0, vocab, (2, prompt)).astype(np.int32))
    ctx = prompt + INT8_KV_CUT_STEPS + 1
    with torch.inference_mode():
        _, cache = m.prefill(params, {"tokens": toks.cuda()}, max_len=ctx)
        cg = int8_cache_of(torch, m, cache, tuning, ctx)
        cc = {"pos": cg["pos"], "segments": _to_cpu(cg["segments"])}
        cur = torch.zeros((2, 1), dtype=torch.int32)
        errs, shares = [], []
        for step in range(INT8_KV_CUT_STEPS):
            lg, cg = m.decode(params, cg, cur.cuda())
            lc, cc = m.decode(p_cpu, cc, cur)
            a, b_ = lg[:, -1, :vocab].float().cpu(), lc[:, -1, :vocab].float()
            errs.append(float((a - b_).abs().max()))
            shares.append(limit_share(a, b_))
            check(bool(torch.allclose(a, b_, atol=0.125, rtol=1e-2)),
                  f"int8 cache: card vs CPU logits differ by {errs[-1]} at "
                  f"step {step}")
            cur = b_.argmax(-1)[:, None].int()
    apart, max_steps, scale_err, entries = {}, 0, 0.0, 0
    for sg, sc in zip(cg["segments"], cc["segments"]):
        for name in ("k", "v"):
            dq = (sg[name].cpu().int() - sc[name].int()).abs()
            max_steps = max(max_steps, int(dq.max()))
            for n in range(1, int(dq.max()) + 1):
                apart[n] = apart.get(n, 0) + int((dq == n).sum())
            entries += dq.numel()
            rel = ((sg[name + "_s"].cpu() - sc[name + "_s"]).abs()
                   / sc[name + "_s"]).max()
            scale_err = max(scale_err, float(rel))
    check(max_steps <= INT8_KV_STEP_TOL,
          f"int8 cache: card and CPU entries {max_steps} steps apart")
    check(scale_err <= INT8_KV_SCALE_RTOL,
          f"int8 cache: card and CPU scales differ by {scale_err} relative")
    return dict(quantized_write_bit_equal=write_equal, cut_layers=2,
                cut_prompt=prompt, cut_decode_steps=INT8_KV_CUT_STEPS,
                logits_max_abs_err=max(errs), logits_tolerance=[0.125, 1e-2],
                logits_limit_share=max(shares), cache_entries=entries,
                entries_steps_apart=apart, max_steps_apart=max_steps,
                steps_tolerance=INT8_KV_STEP_TOL,
                scales_max_rel_err=scale_err,
                scales_tolerance=INT8_KV_SCALE_RTOL)


def int8_kv_decode(torch, eng, build_model, tuning, kernels):
    """Gemma3-4B whole (the served d0 engine's weights) at 8 x 2,048: its
    prefill's cache quantized into an int8 cache laid out by
    ``cache_spec``, then 16 greedy decode steps over it (K4 over the
    dequantized K/V, sliding and global segments at head_dim 256, G = 2),
    beside 16 steps over the bf16 cache from the same prefill; its ms a
    token and cache GB beside the bf16 cache's; then the card against
    the CPU on a 2-layer cut (``int8_kv_cut``). Returns the int8 path's
    launches of ``kernels``."""
    import numpy as np
    m, params = eng.model, eng.params
    vocab = m.cfg.vocab_size
    toks = torch.tensor(np.random.default_rng(8).integers(
        0, vocab, (GEMMA3_BATCH, GEMMA3_PROMPT)).astype(np.int32),
        device="cuda")
    with torch.inference_mode():
        logits, cache = m.prefill(params, {"tokens": toks},
                                  max_len=GEMMA3_MAX_LEN)
        q_cache = int8_cache_of(torch, m, cache, tuning, GEMMA3_MAX_LEN)
    cur = logits[:, -1:, :vocab].argmax(-1).int()
    cache, bf16_ms, _ = decode_steps(torch, m, params, cache, cur,
                                     INT8_KV_STEPS)
    for k in kernels:
        k.launches = 0
    q_cache, int8_ms, q_logits = decode_steps(torch, m, params, q_cache, cur,
                                              INT8_KV_STEPS)
    launches = {k.name: k.launches for k in kernels}
    check(bool(torch.isfinite(q_logits.float()).all()),
          "int8 cache: non-finite decode logits")
    check(q_cache["pos"] == GEMMA3_PROMPT + INT8_KV_STEPS,
          f"int8 cache: position {q_cache['pos']}")
    line = dict(phase="int8_kv_decode", arch=m.cfg.name,
                batch=GEMMA3_BATCH, prompt=GEMMA3_PROMPT,
                decode_steps=INT8_KV_STEPS, int8_ms_per_token=int8_ms,
                bf16_ms_per_token=bf16_ms, int8_cache_gb=cache_gb(q_cache),
                bf16_cache_gb=cache_gb(cache), launches=launches,
                kv_cache=[list(seg["k"].shape) for seg in
                          q_cache["segments"]])
    del cache, q_cache
    free_card(torch)
    line.update(int8_kv_cut(torch, m.cfg, build_model, tuning))
    emit(**line)
    return launches


# ------------------------------------------------------------ dry run ----
#: one full-size pair of each kind on the card's fakes (the last under
#: the int8 K/V cache), both production meshes from one trace
DRYRUN_PAIRS = (("granite-moe-1b-a400m", "train_4k", "bf16"),
                ("gemma3-4b", "prefill_32k", "bf16"),
                ("falcon-mamba-7b", "decode_32k", "bf16"),
                ("hymba-1.5b", "decode_32k", "int8"))
#: the trace against the card, at shapes one card holds (mesh 1 x 1):
#: Granite's training step and a Gemma3-4B prefill at 8 x 2,048
DRYRUN_CHECKS = (("granite-moe-1b-a400m", ("train_8x2k", 2048, 8, "train")),
                 ("gemma3-4b", ("prefill_8x2k", 2048, 8, "prefill")))
#: predicted peak against the card's ``max_memory_allocated``
DRYRUN_PEAK_RTOL = 0.10


def real_args(torch, cfg, shape, build_model, training):
    """A pair's arguments for real on the card: the params (and a train
    step's AdamW state) from seed 0, random tokens."""
    model = build_model(cfg)
    tokens = torch.randint(0, cfg.vocab_size,
                           (shape.global_batch, shape.seq_len),
                           dtype=torch.int32, device="cuda")
    if shape.kind == "train":
        return training.init_state(model, 0, device="cuda"), \
            {"tokens": tokens}
    return model.init(0, device="cuda"), {"tokens": tokens}


def dryrun_phase(torch, dryrun, tuning, mesh_mod, get_config, build_model,
                 training, kernels, InputShape):
    """``launch.dryrun.run_one`` on the card's fakes for ``DRYRUN_PAIRS``
    (no kernel launched), each row printed; then each ``DRYRUN_CHECKS``
    pair traced through the same ``build_lowerable`` on a one-device
    mesh and run for real: the predicted argument bytes equal to the
    real params', optimizer state's and batch's, the predicted peak
    within ``DRYRUN_PEAK_RTOL`` of ``max_memory_allocated`` over the
    same call (counted from the memory in use before its arguments)."""
    from repro_torch.obs.prof import profile_fn
    before = {k.name: k.launches for k in kernels}
    for arch, shape, kv in DRYRUN_PAIRS:
        tuning.FLAGS["kv_cache_dtype"] = kv
        try:
            rows = dryrun.run_one(arch, shape, (False, True), device="cuda",
                                  verbose=False)
        finally:
            tuning.FLAGS["kv_cache_dtype"] = "bf16"
        for r in rows:
            check(r["ok"], f"dryrun {arch} {shape}: {r.get('error')}")
            emit(phase="dryrun", part="pair", kv_cache_dtype=kv, **r)
    check(before == {k.name: k.launches for k in kernels},
          "the dry run's traces launched a kernel")
    one = mesh_mod.make_tier_mesh("S", device_type="cuda")
    for arch, (name, seq, batch, kind) in DRYRUN_CHECKS:
        shape = InputShape(name, seq, batch, kind)
        gc.collect()              # no earlier phase's cycle freed mid-call
        free_card(torch)
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        fn, fakes, meta = dryrun.build_lowerable(arch, shape, device="cuda")
        prof = profile_fn(fn, *fakes, name=f"{arch}/{name}")
        row = dryrun.roofline_row(prof, meta, fakes, one, "1x1",
                                  time.perf_counter() - t0)
        args = real_args(torch, get_config(arch), shape, build_model,
                         training)
        real_bytes = dryrun.arg_bytes_per_device(
            args, dryrun.arg_specs(args, kind, one), one)
        check(row["arg_bytes_per_device"] == prof.arg_bytes == real_bytes,
              f"dryrun {arch} {name}: predicted argument bytes "
              f"{row['arg_bytes_per_device']} / {prof.arg_bytes}, real "
              f"{real_bytes}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        with torch.no_grad() if kind != "train" else \
                contextlib.nullcontext():
            out = fn(*args)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        measured = torch.cuda.max_memory_allocated() - base
        after = torch.cuda.memory_allocated() - base
        err = prof.peak_live_bytes / measured - 1.0
        emit(phase="dryrun", part="against_the_card", arch=arch,
             shape=name, kind=kind, mesh="1x1",
             predicted_arg_bytes=row["arg_bytes_per_device"],
             real_arg_bytes=real_bytes,
             predicted_peak_bytes=prof.peak_live_bytes,
             measured_peak_bytes=measured, peak_rel_err=err,
             base_bytes=base, bytes_after_call=after,
             peak_tolerance=DRYRUN_PEAK_RTOL,
             predicted_temp_bytes=row["temp_bytes_per_device"],
             flops=prof.flops, bytes_accessed=prof.bytes_accessed,
             compute_s=row["compute_s"], memory_s=row["memory_s"],
             trace_s=row["seconds"], real_call_s=run_s)
        check(abs(err) <= DRYRUN_PEAK_RTOL,
              f"dryrun {arch} {name}: predicted peak {prof.peak_live_bytes}"
              f" against {measured} measured ({err:+.3f})")
        del fn, fakes, args, out
    free_card(torch)


def serve_paligemma(torch, get_config, build_model, variant_seed):
    """PaliGemma-3B as published (d0 bf16) through ``Model.prefill`` /
    ``decode``: batch 16, 256 seeded stub image embeddings + 256 text
    tokens, 16 greedy decode steps; the cache's position counts the
    image prefix."""
    import numpy as np
    cfg = get_config("paligemma-3b")
    model = build_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(variant_seed(0, "d0"), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(23)
    batch = {"tokens": torch.tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (PALI_BATCH, PROMPT)).astype(np.int32),
        device="cuda"),
        "img_embeds": torch.randn((PALI_BATCH, PALI_IMG, cfg.d_model),
                                  generator=g, device="cuda").to(
                                      torch.bfloat16)}

    def run():
        logits, cache = model.prefill(params, batch, max_len=PALI_MAX_LEN)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(NEW_TOKENS):
            cur = logits[:, -1:, :cfg.vocab_size].argmax(-1).int()
            logits, cache = model.decode(params, cache, cur)
        torch.cuda.synchronize()
        return logits, cache, t1
    with torch.inference_mode():
        run()                                     # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, t1 = run()
        t2 = time.perf_counter()
    check(bool(torch.isfinite(logits.float()).all()),
          "paligemma: non-finite logits")
    (seg,) = cache["segments"]
    kv = (cfg.n_layers, PALI_BATCH, PALI_MAX_LEN, 1, 256)
    check(cache["pos"] == PALI_MAX_LEN and tuple(seg["k"].shape) == kv,
          f"paligemma: cache {tuple(seg['k'].shape)} at {cache['pos']}")
    line = family_line(cfg, params, init_s)
    # param_count() leaves out the image projection (d_model^2)
    check(line["params_held"] == line["params_analytic"]
          + cfg.d_model ** 2, "paligemma: parameters held "
          f"{line['params_held']} != param_count() + d_model^2")
    emit(phase="vlm_and_cuts", part="paligemma", variant="d0", **line,
         heads=[cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim],
         batch=PALI_BATCH, image_tokens=PALI_IMG, prompt=PROMPT,
         new_tokens=NEW_TOKENS, kv_cache=list(kv),
         prefill_ms=(t1 - t0) * 1e3,
         decode_ms_per_token=(t2 - t1) * 1e3 / NEW_TOKENS,
         tokens_per_s=PALI_BATCH * NEW_TOKENS / (t2 - t0),
         peak_gb=peak_gb(torch))
    del params, cache, logits


def vlm_and_cuts(torch, build_engines, get_config, build_model,
                 variant_seed, kernels):
    """PaliGemma-3B whole (``serve_paligemma``); Gemma-7B whole, Yi-34B
    at full width cut to 8 of its 60 layers and DBRX-132B to 2 of its 40
    through ``build_engines`` d0 at batch 16 x 256; each freed before the
    next. Returns the path's launches of ``kernels``."""
    import numpy as np
    for k in kernels:
        k.launches = 0
    free_card(torch)
    serve_paligemma(torch, get_config, build_model, variant_seed)
    free_card(torch)
    rng = np.random.default_rng(6)
    for arch, layers in (("gemma-7b", None), ("yi-34b", YI_LAYERS),
                         ("dbrx-132b", DBRX_LAYERS)):
        full = get_config(arch)
        cfg = full if layers is None else dense_cut(full, layers)
        engines, init_s = build_family(torch, build_engines, cfg, ("d0",),
                                       MAX_LEN)
        eng = engines["S"]["d0"]
        toks = rng.integers(0, cfg.vocab_size, (CUT_BATCH, PROMPT)).astype(
            np.int32)
        cache, prefill_ms, decode_ms, wall = timed_generate(
            torch, eng, toks, MAX_LEN)
        line = dense_engines_line(torch, eng, init_s["d0"], CUT_BATCH,
                                  PROMPT, MAX_LEN, cache)
        emit(phase="vlm_and_cuts", part=arch, variant="d0",
             layers_of=full.n_layers, **line, prefill_ms=prefill_ms,
             decode_ms_per_token=decode_ms, generate_ms=wall * 1e3,
             tokens_per_s=CUT_BATCH * NEW_TOKENS / wall)
        del engines, eng, cache
        free_card(torch)
    return {k.name: k.launches for k in kernels}


# ------------------------------------------------ encoder-decoder path ----
#: the encoder-decoder path: Whisper-medium served whole through
#: ``Model.prefill`` / ``decode`` (an engine's requests carry tokens only,
#: so ``build_engines`` refuses it, as the reference's engine would fail
#: on it): batch 16, its 1,500 seeded stub frames, a 64-token prompt, 16
#: new tokens, a 448-slot self cache (Whisper's text context); d0 and d4
AUDIO_ARCH, AUDIO_VARIANTS = "whisper-medium", ("d0", "d4")
AUDIO_BATCH, AUDIO_PROMPT, AUDIO_MAX_LEN = 16, 64, 448
#: the soft-cap of the capped K3/K4 lines (Gemma-2's attention cap)
SOFTCAP = 50.0
#: K3 on the path (``FLASH_CASES``): the encoder's self-attention over
#: 16 x 1,500 frames and the cross-attention of the 64-token prompt onto
#: them (no mask, the last kv tile 28 rows), its decoder's causal
#: self-attention, float32 checked at the two uncapped Whisper layouts
#: (``AUDIO_F32``); then the soft-cap at Gemma3-4B's causal (global) and
#: windowed layouts and at the cross layout, float32 checked at the
#: cross layout (``SOFTCAP_F32``)
AUDIO_FLASH_CASES = (
    ("whisper encoder", AUDIO_BATCH, 1500, 1500, 16, 16, 64, 0, False, 0.0),
    ("whisper cross", AUDIO_BATCH, AUDIO_PROMPT, 1500, 16, 16, 64, 0, False,
     0.0),
    ("whisper decoder", AUDIO_BATCH, AUDIO_PROMPT, AUDIO_PROMPT, 16, 16, 64,
     0, True, 0.0))
SOFTCAP_FLASH_CASES = (
    ("gemma3 global capped", GEMMA3_BATCH, GEMMA3_PROMPT, GEMMA3_PROMPT, 8,
     4, 256, 0, True, SOFTCAP),
    ("gemma3 sliding capped", GEMMA3_BATCH, GEMMA3_PROMPT, GEMMA3_PROMPT, 8,
     4, 256, 1024, True, SOFTCAP),
    ("whisper cross capped", AUDIO_BATCH, AUDIO_PROMPT, 1500, 16, 16, 64, 0,
     False, SOFTCAP))
AUDIO_F32 = ("whisper encoder", "whisper cross")
SOFTCAP_F32 = ("whisper cross capped",)
#: K4 on the path (``DECODE_CASES``): the 1,500-slot cross cache (every
#: slot valid), the 448-slot self cache, and the cross cache capped,
#: float32 checked at both cross caches
AUDIO_DECODE_CASES = (
    ("whisper cross", AUDIO_BATCH, 1500, 16, 16, 64, 0, True, 0.0),
    ("whisper self", AUDIO_BATCH, AUDIO_MAX_LEN, 16, 16, 64, 0, False, 0.0),
    ("whisper cross capped", AUDIO_BATCH, 1500, 16, 16, 64, 0, True,
     SOFTCAP))
AUDIO_DECODE_F32 = ("whisper cross", "whisper cross capped")
#: K5 at d4's encoder: M = 16 x 1,500 rows (no multiple of the tile) for
#: wq/wk/wv/wo (1,024 -> 1,024), the MLP's up (1,024 -> 4,096) and down
#: (4,096 -> 1,024)
AUDIO_INT8_SHAPES = tuple((AUDIO_BATCH * 1500, k, n) for k, n in (
    (1024, 1024), (1024, 4096), (4096, 1024)))


def audio_cpu_agreement(torch, get_config, build_model, variant_seed):
    """Whisper at full width cut to 2 encoder and 2 decoder layers over
    its 1,500 frames, d0 and d4, drawn on the card and run on the card
    and on the CPU with the same weights (``model_cpu_agreement``)."""
    from repro_torch.models.variants import build_ladder
    cfg = dataclasses.replace(get_config(AUDIO_ARCH), n_layers=2,
                              n_enc_layers=2)
    for vid in AUDIO_VARIANTS:
        vcfg = build_ladder(cfg)[vid].cfg
        params = build_model(vcfg).init(variant_seed(0, vid), device="cuda")
        model_cpu_agreement(torch, vcfg, params, build_model, 2, 32, vid,
                            phase="audio_cpu_agreement",
                            frames=vcfg.enc_seq)
        del params
        free_card(torch)


def audio_serve_one(torch, cfg, vid, build_model, variant_seed, kernels):
    """One variant of Whisper-medium whole: the encoder alone, then the
    prefill (encoder included) and 16 greedy decode steps, each timed by
    the host clock around synchronised calls after a warm-up run; the
    caches' shapes, the weights held against ``param_count()``, the
    peak memory, the launches of ``kernels`` in the timed prefill and one
    decode step; then one decode and one prefill ``step_profile``."""
    import numpy as np
    model = build_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(variant_seed(0, vid), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(29)
    batch = {"tokens": torch.tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (AUDIO_BATCH, AUDIO_PROMPT)).astype(np.int32),
        device="cuda"),
        "frames": torch.randn((AUDIO_BATCH, cfg.enc_seq, cfg.d_model),
                              generator=g, device="cuda")}

    def prefill():
        return model.prefill(params, batch, max_len=AUDIO_MAX_LEN)

    def run():
        logits, cache = prefill()
        for _ in range(NEW_TOKENS):
            cur = logits[:, -1:, :cfg.vocab_size].argmax(-1).int()
            logits, cache = model.decode(params, cache, cur)
        return logits, cache
    with torch.inference_mode():
        run()                                     # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model._encode(params, batch["frames"])
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t0) * 1e3
        before = {k.name: k.launches for k in kernels}
        t0 = time.perf_counter()
        logits, cache = prefill()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        per_prefill = {k.name: k.launches - before[k.name] for k in kernels}
        for step in range(NEW_TOKENS):
            if step == 1:
                before = {k.name: k.launches for k in kernels}
            cur = logits[:, -1:, :cfg.vocab_size].argmax(-1).int()
            logits, cache = model.decode(params, cache, cur)
            if step == 1:
                per_step = {k.name: k.launches - before[k.name]
                            for k in kernels}
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    check(bool(torch.isfinite(logits.float()).all()),
          f"{cfg.name} {vid}: non-finite logits")
    n, hd = cfg.n_layers, cfg.resolved_head_dim
    check(per_prefill["flash_attention"] == cfg.n_enc_layers + 2 * n
          and per_step["decode_attention"] == 2 * n,
          f"{cfg.name} {vid}: {per_prefill} launches a prefill, "
          f"{per_step} a decode step")
    (seg,) = cache["segments"]
    kv = (n, AUDIO_BATCH, AUDIO_MAX_LEN, cfg.n_kv_heads, hd)
    cross = (n, AUDIO_BATCH, cfg.enc_seq, cfg.n_kv_heads, hd)
    check(cache["pos"] == AUDIO_PROMPT + NEW_TOKENS
          and tuple(seg["k"].shape) == kv and tuple(seg["ck"].shape) == cross,
          f"{cfg.name}: cache {tuple(seg['k'].shape)} / "
          f"{tuple(seg['ck'].shape)} at {cache['pos']}")
    line = family_line(cfg, params, init_s)
    # param_count() leaves out the encoder's final norm (d_model), and an
    # int8 linear also holds its per-column scales ("s")
    weights = line["params_held"] - _scales(params)
    check(weights == line["params_analytic"] + cfg.d_model,
          f"{cfg.name} {vid}: {weights} weights held, param_count() "
          f"{line['params_analytic']} + the encoder's final norm "
          f"{cfg.d_model}")
    emit(phase="audio_serving", variant=vid, **line,
         enc_layers=cfg.n_enc_layers,
         params_held_vs_analytic=[weights, line["params_analytic"]],
         params_gap_reason="param_count() leaves out the encoder's final "
                           "norm (d_model)",
         heads=[cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim],
         d_ff=cfg.d_ff, mlp=cfg.mlp_act, batch=AUDIO_BATCH,
         frames=cfg.enc_seq, prompt=AUDIO_PROMPT, new_tokens=NEW_TOKENS,
         max_len=AUDIO_MAX_LEN, kv_cache=list(kv), cross_cache=list(cross),
         encoder_ms=enc_ms, prefill_ms=(t1 - t0) * 1e3,
         decode_ms_per_token=(t2 - t1) * 1e3 / NEW_TOKENS,
         tokens_per_s=AUDIO_BATCH * NEW_TOKENS / (t2 - t0),
         launches_per_prefill=per_prefill, launches_per_decode_step=per_step,
         peak_gb=peak_gb(torch))
    cur = torch.zeros((AUDIO_BATCH, 1), dtype=torch.int32, device="cuda")

    def decode_steps(steps=DECODE_PROFILE_STEPS):
        nonlocal cache
        with torch.inference_mode():
            for _ in range(steps):
                _, cache = model.decode(params, cache, cur)
    step_profile(torch, decode_steps, DECODE_PROFILE_STEPS,
                 path="audio_serving", variant=vid,
                 arch=cfg.name, what="decode step")

    def one_prefill():
        with torch.inference_mode():
            prefill()
    step_profile(torch, one_prefill, 1, top=8, path="audio_serving",
                 variant=vid, arch=cfg.name, what="prefill",
                 batch=AUDIO_BATCH, prompt=AUDIO_PROMPT, frames=cfg.enc_seq)
    del params, cache, logits


def audio_serving(torch, get_config, build_model, variant_seed, kernels):
    """Whisper-medium as published, d0 bf16 then d4 int8, whole
    (``audio_serve_one``), each freed before the next. Returns the path's
    launches of ``kernels``, counted from its start (the profiles
    included)."""
    from repro_torch.models.variants import build_ladder
    for k in kernels:
        k.launches = 0
    ladder = build_ladder(get_config(AUDIO_ARCH))
    for vid in AUDIO_VARIANTS:
        free_card(torch)
        audio_serve_one(torch, ladder[vid].cfg, vid, build_model,
                        variant_seed, kernels)
    free_card(torch)
    return {k.name: k.launches for k in kernels}


# ------------------------------------------------ the single-cell layer ----
#: the serving launcher's shapes: one request a call, a 16-token prompt,
#: a cache of 64 slots (``build_engines``' default ``max_len``)
CLI_PROMPT, CLI_MAX_LEN = 16, 64
SC_DQN_STEPS, SC_GREEDY_STATES, SC_MARGIN = 250, 200, 1e-4


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
    ms, _, prof_ms = timed(lambda: C.bruteforce_optimal(env, 85.0),
                           profile=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        best = C.bruteforce_optimal(env, 85.0)
    host_ms = (time.perf_counter() - t0) * 1e3 / 20
    emit(phase="single_cell", part="bruteforce", cases=cases,
         n5_candidates=best[3], n5_best=list(env.spec.decode_action(best[0])),
         n5_best_ms=best[1], n5_device_ms=ms, n5_host_ms=host_ms,
         profiler_ms=prof_ms)


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
        upd_ms, upd_wall_ms, prof_ms = timed(lambda: agent._train(*batch),
                                             profile=True)
        emit(phase="single_cell", part="dqn", form=form, users=n, goal=goal,
             hidden=agent.cfg.hidden, steps=SC_DQN_STEPS,
             updates=len(losses), first_loss=losses[0], last_loss=losses[-1],
             eps=agent.eps, host_ms_per_step=secs * 1e3 / SC_DQN_STEPS,
             greedy_states=SC_GREEDY_STATES, greedy_held=held,
             update_device_ms=upd_ms, update_wall_ms=upd_wall_ms,
             profiler_ms=prof_ms)


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
        flash.append((name, 1, CLI_PROMPT, CLI_PROMPT, h, kv, hd, 0, True,
                      0.0))
        dec.append((name, 1, CLI_MAX_LEN, h, kv, hd, 0, False, 0.0))
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
COUPLED_STEPS = 150


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


#: the kernels of one best-response round, in launch order
ROUND_KERNELS = ("best_response_totals_kernel",
                 "best_response_prepass_kernel",
                 "best_response_walker_kernel")


def round_split(torch, best_response, idx, packed, args, reps=5):
    """One best-response round from ``idx`` through the kernels: its
    device ms (``hidden_ms``); the walker's statistics
    (``best_response.STATS``); the device ms of each of its kernels and
    of the memset from a profiler trace of ``reps`` rounds that holds
    every launch (the profiler drops events at times; None if no trace
    of ``TRACE_TRIES`` does)."""
    stats = torch.empty(len(best_response.STATS), dtype=torch.int32,
                        device="cuda")

    def kern():
        return best_response.best_response_cuda(idx, packed, *args,
                                                stats=stats)
    ms = hidden_ms(kern, reps=reps)
    split = None
    for _ in range(TRACE_TRIES):
        counts, us = kernel_counts(torch, kern, reps)
        by = {}
        for n, t in us.items():
            key = next((k for k in ROUND_KERNELS
                        if k + "<" in n or k + "(" in n), n[:40])
            by[key] = (by.get(key, (0, 0.0))[0] + counts[n],
                       by.get(key, (0, 0.0))[1] + t / reps / 1e3)
        if all(by.get(k, (0,))[0] == reps for k in ROUND_KERNELS):
            split = {k: t for k, (_, t) in by.items()}
            break
    return dict(round_ms=ms, **dict(zip(best_response.STATS,
                                        stats.tolist())),
                device_ms_by_kernel=split)


def round_pair(torch, best_response, idx0, fixed, packed, args):
    """The round from the isolated start ``idx0`` and the round from the
    fixed point ``fixed`` (``round_split``). The converged round is the
    start totals, the pre-pass and a walker that stops at once, the same
    work as in any round; so its ms over the changing round's is the
    pre-pass's share of that round, and the difference over the cells
    rescored the walker's ms a rescored cell."""
    chg = round_split(torch, best_response, idx0, packed, args)
    conv = round_split(torch, best_response, fixed, packed, args)
    walk = chg["round_ms"] - conv["round_ms"]
    return dict(changing_round=chg, converged_round=conv,
                prepass_share=conv["round_ms"] / chg["round_ms"],
                walker_ms_per_rescored_cell=(walk / chg["rescored"]
                                             if chg["rescored"] else None))


def coupled_oracle_parity(torch, R, fleets, runs, best_response,
                          ptxas=None):
    """The kernel's oracle against the same loop with the plain round on
    the card: indices, ``converged``, ``rounds`` and ms equal. Then one
    round from the isolated start timed: the kernel's device ms (and per
    call of 10 back-to-back calls, ``burst_ms``), the plain version's
    wall and the bound of the (cells, K) tables; on the hot edge, the
    expected reward of aware (best-response) against blind
    (isolated-optimal) decisions under the same shared contention. The
    round from the isolated start and the round from the fixed point
    split by kernel (``round_pair``), and the walker's registers and
    spills at each user count (``ptxas``: the ``ptxas_summary`` of the
    kernel's build). Returns the kernels-line entry (the 1,024-cell
    fleet's round)."""
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
        ms, wall_ms, prof_ms = timed(kern, warmup=1, reps=5, profile=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        best_response.plain(idx0, pu, *args, feas, ce, cc, *tail)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        burst = burst_ms(kern)
        cells, k, users = scen.cells, pu.shape[0], scen.users
        ops, nbytes = best_response.cost(cells, k, users, topo.n_edges)
        b_ms, b_by = bound(nbytes, ops)
        full = (*args, feas, ce, cc, *tail)
        line = dict(label=label, cells=cells, users=users, candidates=k,
                    edges=topo.n_edges, rounds=got[3],
                    converged=got[2], equal=True, ms_max_abs_err=err,
                    kernel_oracle_wall_s=k_wall,
                    plain_oracle_wall_s=p_wall, round_ms=ms,
                    round_wall_ms=wall_ms, round_burst_ms=burst,
                    plain_round_wall_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, bound_share=b_ms / ms,
                    profiler_ms=prof_ms,
                    **round_pair(torch, best_response, idx0, got[1],
                                 packed, full),
                    walker_registers_spills={
                        n: instance_regs(
                            ptxas, "best_response_walker_kernelILi%dE" % n)
                        for n in range(1, 9)})
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


def oracle_split(torch, R, best_response, scen, pu, goal):
    """Host seconds (each stage synchronised) of ``topology_bruteforce``'s
    stages on ``scen``: the isolated start, the candidate tables, the
    rounds through the kernel and the final expected response. Returns
    (the seconds and the rounds, the fixed point)."""
    pop, topo = R.population, scen.topo
    laps = [time.perf_counter()]

    def lap():
        torch.cuda.synchronize()
        laps.append(time.perf_counter())
    torch.cuda.synchronize()
    laps[0] = time.perf_counter()
    _, idx = pop._isolated_bruteforce(scen, pu, goal)
    lap()
    feas, ce, cc = pop._candidate_tables(scen, pu, goal, 4096)
    lap()
    packed = best_response.pack_actions(pu)
    end_b, edge_b = scen.end_b.to(torch.int32), scen.edge_b.to(torch.int32)
    rounds = 0
    for rounds in range(1, 51):
        new, changed = best_response.best_response_cuda(
            idx, packed, end_b, edge_b, scen.member, feas, ce, cc,
            topo.cell_edge, topo.edge_capacity, topo.cloud_servers,
            calib=scen.calib)
        if not bool(changed):
            break
        idx = new
    lap()
    R.topology.fleet_topology_expected_response(
        pu[idx.long()], scen.end_b, scen.edge_b, topo, scen.member,
        calib=scen.calib)
    lap()
    names = ("isolated_start_s", "candidate_tables_s", "rounds_s",
             "expected_response_s")
    out = {n: b - a for n, a, b in zip(names, laps, laps[1:])}
    out["rounds"] = rounds
    return out, idx


def coupled_holdout(torch, R, best_response, kernels):
    """``FleetDQN`` (shared encoder, K2), 150 steps on a 32,768-cell x
    5-user synthetic fleet over 64 skewed edges, scored on a held-out
    coupled fleet of the same shape (1 to 5 members a cell) against
    ``topology_bruteforce`` through the kernel: the ratio in (0, 1.05];
    the oracle's wall and rounds. ``kernels`` (K2 and the best-response
    kernel) count their launches on this path alone, each at least once.
    Then, outside the count: the oracle's wall split into its stages
    (``oracle_split``, its result equal to the oracle's); the round from
    the isolated start and the round from the fixed point split by kernel
    (``round_pair``) beside the round's bound; one round from the
    isolated start through the kernel on the card and through its plain
    version on the CPU, on copies of the same inputs (a sequential loop
    over the cells, 3x faster there than on the card, ~75 s a call on
    it): indices and changed flag equal. Returns the path's launch
    counts."""
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
    _, oracle_idx, converged, rounds = R.population.topology_bruteforce(
        held, pu, goal)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    ev = R.policy.holdout_reward_ratio(agent, held)
    launched = {k.name: k.launches for k in kernels}
    check(0.0 < ev.ratio <= 1.05, f"coupled holdout ratio {ev.ratio}")
    for name, n in launched.items():
        check(n > 0, f"{name} was never launched on the coupled holdout")

    split, fixed = oracle_split(torch, R, best_response, held, pu, goal)
    check(torch.equal(fixed, oracle_idx) and split["rounds"] == rounds,
          "coupled holdout: the oracle's stages, timed apart, disagree "
          "with topology_bruteforce")
    pop, topo = R.population, held.topo
    feas, ce, cc = pop._candidate_tables(held, pu, goal, 4096)
    _, idx0 = pop._isolated_bruteforce(held, pu, goal)
    args = (held.end_b, held.edge_b, held.member, feas, ce, cc,
            topo.cell_edge, topo.edge_capacity, topo.cloud_servers)
    packed = best_response.pack_actions(pu)
    rounds_read = round_pair(torch, best_response, idx0, fixed, packed, args)
    ops, nbytes = best_response.cost(CELLS, pu.shape[0], USERS, topo.n_edges)
    b_ms, b_by = bound(nbytes, ops)
    got, got_changed = best_response.best_response_cuda(idx0, packed, *args)
    got = got.cpu()
    host = [a.cpu() if torch.is_tensor(a) else a for a in (idx0, pu, *args)]
    t0 = time.perf_counter()
    want, want_changed = best_response.plain(*host)
    plain_round_s = time.perf_counter() - t0
    moved = int((got != host[0]).sum())
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
         plain_round_cpu_wall_s=plain_round_s, oracle_split=split,
         **rounds_read, round_bound_ms=b_ms, round_bound_by=b_by,
         converged_round_over_bound=(
             rounds_read["converged_round"]["round_ms"] / b_ms))
    return launched


def cell_dqn(torch, R, head_kernel):
    """``FleetDQN(net='cell')`` at the DQN phase's shape, 150 steps: the
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
    win_us, by_name, _ = profile_window(torch, lambda: agent.run(5))
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


# the sharded fleet (phase fleet_sharded): steps a run, the ranks sharing
# the card, and the time limit of their join
SHARD_STEPS = 40
SHARD_RANKS = 2
SHARD_JOIN_S = 300


def fleet_namespace():
    """The fleet modules of the port, as ``main`` passes them around."""
    import types
    from repro_torch import obs, serving as serving_pkg
    from repro_torch.fleet import (api, calibrate, dynamics, policy,
                                   population, scenarios, shard, topology)
    from repro_torch.rng import Draws
    return types.SimpleNamespace(api=api, policy=policy,
                                 population=population, scenarios=scenarios,
                                 Draws=Draws, calibrate=calibrate,
                                 dynamics=dynamics, obs=obs,
                                 serving=serving_pkg, topology=topology,
                                 shard=shard)


def shard_fleets(R):
    """The two 32,768 x 5 fleets of phase ``fleet_sharded``, over 64
    edges and a finite cloud queue: edges drawn within each rank's block
    of cells (shard-local over the phase's ranks), and edges drawn over
    all cells with edge failures (the all-to-all path)."""
    base = dict(cells=CELLS, users=USERS, arrival_rate=1.2, p_r2w=0.05,
                p_w2r=0.15, min_users=2, max_users=5,
                n_edges=HOLDOUT_EDGES, cloud_servers=4.0 * CELLS)
    return {"shard_local": R.scenarios.FleetConfig(
                shard_local=True, n_shards=SHARD_RANKS, **base),
            "all_to_all": R.scenarios.FleetConfig(p_edge_fail=0.05,
                                                  **base)}


def digest(torch, t, offset=0):
    """A 64-bit digest of ``t``'s bits that adds over blocks: each
    element's bit pattern times the odd weight ``2 i + 1`` of its flat
    index ``i`` (``offset`` is the block's first), summed modulo 2^64.
    One changed element always changes it."""
    x = t.detach().contiguous()
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    bits = {1: torch.uint8, 4: torch.int32, 8: torch.int64}[x.element_size()]
    v = x.view(bits).reshape(-1).to(torch.int64)
    i = torch.arange(offset, offset + v.numel(), device=v.device)
    return int((v * (2 * i + 1)).sum()) % 2 ** 64


def sharded_runs(torch, R, mesh, steps=SHARD_STEPS):
    """Both agents (mesh=``mesh``) on both fleets of ``shard_fleets``,
    ``steps`` steps after 2 of warm-up: digests of the rank's blocks of
    the Q-table, job counts and decisions at the block's offset, the DQN's
    parameters (replicated), the assembled per-step fleet means,
    telemetry and holdout ratios, and the wall per step. On a placed
    shard-local fleet, ``local_contention`` is held equal to
    ``shared_contention`` on the DQN's decisions."""
    out = {}
    for label, cfg in shard_fleets(R).items():
        res = {}
        for kind in ("tabular", "dqn"):
            src = R.api.SyntheticSource(cfg)
            if kind == "tabular":
                agent = R.population.FleetQLearning(src, seed=0,
                                                    device="cuda", mesh=mesh)
            else:
                agent = R.policy.FleetDQN(
                    src, actions=R.population.default_actions(
                        R.population.SpaceSpec(USERS)),
                    cfg=R.policy.FleetDQNConfig(hidden=128, topk=5,
                                                accuracy_threshold=85.0),
                    seed=0, device="cuda", mesh=mesh)
            agent.run(2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ms, acc = agent.run(steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            scen = agent.scen
            rank = scen.mesh.rank if scen.mesh is not None else 0
            per_cell = {"counts": agent.counts,
                        "decisions": agent.greedy_decisions(),
                        "end_b": scen.end_b, "active": scen.active}
            if kind == "tabular":
                per_cell["q"] = agent.q
            r = {f"{k}_digest": digest(torch, v, rank * v.numel())
                 for k, v in per_cell.items()}
            if kind == "dqn":
                r["params_digest"] = [digest(torch, p[k]) for p in
                                      agent.params for k in ("w", "b")]
            r.update(ms=ms.tolist(), acc=acc.tolist(),
                     summary=agent.metrics_summary(),
                     holdout=R.policy.holdout_reward_ratio(agent,
                                                           scen).ratio,
                     wall_ms_per_step=wall * 1e3 / steps)
            if kind == "dqn" and cfg.shard_local and mesh is not None:
                pu = agent.greedy_decisions()
                got = R.shard.local_contention(pu, scen.topo, mesh,
                                               active=scen.active)
                want = R.topology.shared_contention(pu, scen.topo,
                                                    active=scen.active)
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"local_contention differs from shared_contention "
                      f"(rank {rank})")
                r["local_contention_equal"] = True
            res[kind] = r
        out[label] = res
    return out


def sharded_rank(rank, world, init_file, out_dir):
    """One rank of phase ``fleet_sharded``: a gloo group of ``world``
    ranks on the one card, both agents on this rank's block of both
    fleets, K1 and K2 counted on that path alone; the results go to
    ``out_dir`` as JSON."""
    sys.path.insert(0, SRC)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)         # the ranks share the host's cores
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.kernels import dqn_head, tabular_rl
        R = fleet_namespace()
        mesh = R.shard.fleet_mesh(device="cuda")
        check(mesh.size == world and mesh.rank == rank, "gloo mesh")
        kernels = (tabular_rl.KERNEL, dqn_head.KERNEL)
        for k in kernels:
            k.launches = 0
        res = sharded_runs(torch, R, mesh)
        res["launches"] = {k.name: k.launches for k in kernels}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _same_runs(got, want, what, blocks=None):
    """Check two ``sharded_runs`` results equal; with ``blocks`` (the
    ranks' results), the per-cell digests of ``got`` are the sum of the
    ranks' block digests."""
    for label, kinds in want.items():
        for kind, w in kinds.items():
            g = got[label][kind]
            for key, v in w.items():
                if key == "wall_ms_per_step" or key == \
                        "local_contention_equal":
                    continue
                if blocks is not None and key.endswith("_digest") \
                        and key != "params_digest":
                    g_v = sum(b[label][kind][key] for b in blocks) % 2 ** 64
                else:
                    g_v = g[key]
                check(g_v == v, f"fleet_sharded: {what} {label} {kind} "
                                f"{key} differs from the unsharded run")


def fleet_sharded(torch, R, kernels):
    """Phase ``fleet_sharded``: both agents on both fleets of
    ``shard_fleets`` at 32,768 x 5, unsharded; on a one-rank NCCL mesh
    in this process (bit-equal to unsharded); then on two gloo ranks
    sharing the card, spawned processes each on its block (the kernels
    built here first): every block digest, fleet mean, telemetry summary
    and holdout ratio equal to the unsharded run's, K1 and K2 launched
    on every rank, every join under ``SHARD_JOIN_S``."""
    import tempfile
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.kernels import _build
    _build.build(kernels)
    work = os.path.join(ROOT, "build", "fleet_sharded")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    plain = sharded_runs(torch, R, None)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    init = tempfile.mkdtemp(dir=work)
    dist.init_process_group("nccl", init_method=f"file://{init}/nccl",
                            rank=0, world_size=1)
    try:
        mesh = R.shard.fleet_mesh(device="cuda")
        probe = torch.ones(4, device="cuda")
        dist.all_reduce(probe)                    # the NCCL group works
        check(bool((probe == 1).all()), "one-rank NCCL all_reduce")
        one = sharded_runs(torch, R, mesh)
    finally:
        dist.destroy_process_group()
    _same_runs(one, plain, "one NCCL rank")
    ctx = mp.start_processes(
        sharded_rank, args=(SHARD_RANKS, f"{init}/gloo", init),
        nprocs=SHARD_RANKS, join=False, start_method="spawn")
    deadline = time.monotonic() + SHARD_JOIN_S
    try:
        while not ctx.join(timeout=5):
            check(time.monotonic() < deadline,
                  f"fleet_sharded: the {SHARD_RANKS} ranks outlasted "
                  f"{SHARD_JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    blocks = []
    for r in range(SHARD_RANKS):
        with open(os.path.join(init, f"rank{r}.json")) as f:
            blocks.append(json.load(f))
    for r, b in enumerate(blocks):
        _same_runs(b, plain, f"gloo rank {r}", blocks=blocks)
        for name, n in b["launches"].items():
            check(n > 0, f"{name} was never launched on gloo rank {r}")
    walls = {label: {kind: {
        "unsharded": plain[label][kind]["wall_ms_per_step"],
        "nccl_1": one[label][kind]["wall_ms_per_step"],
        "gloo_2": [b[label][kind]["wall_ms_per_step"] for b in blocks]}
        for kind in ("tabular", "dqn")} for label in plain}
    emit(phase="fleet_sharded", cells=CELLS, users=USERS,
         steps=SHARD_STEPS, ranks=SHARD_RANKS, edges=HOLDOUT_EDGES,
         bit_equal=True, wall_ms_per_step=walls,
         holdout={label: {kind: plain[label][kind]["holdout"]
                          for kind in ("tabular", "dqn")}
                  for label in plain},
         local_contention_equal=all(
             b["shard_local"]["dqn"].get("local_contention_equal")
             for b in blocks),
         seconds=time.perf_counter() - t0)
    emit(phase="launches", fleet_sharded={
        f"rank{r}": b["launches"] for r, b in enumerate(blocks)})


# --------------------------------------------------------- training ----
#: K3's forward with the row log-sum-exp and its backward P2 at the
#: training shapes: (name, batch, Sq, Skv, heads, kv heads, head_dim,
#: window, causal, cap). Granite-3.0-1B-A400M at the lm_training phase's 8
#: x 2,048; the edge ladder at 8 x 256; Whisper's encoder over 1,500
#: frames and its decoder's cross-attention from 64 tokens onto them (no
#: mask); InternLM2-20B at 4 x 2,048 (48/8 heads of 128); Gemma3-4B's
#: sliding layers, window 1,024 over 2,048 at head_dim 256, with and
#: without a cap of 50; Hymba-1.5B's sliding layers at the ssm_training
#: phase's 8 x 2,048 (25/5 heads of 64, G 5, window 1,024)
BWD_CASES = (
    ("granite", 8, 2048, 2048, 16, 8, 64, 0, True, 0.0),
    ("edge ladder", 8, 256, 256, 8, 4, 32, 0, True, 0.0),
    ("whisper encoder", 8, 1500, 1500, 16, 16, 64, 0, False, 0.0),
    ("whisper cross", 8, 64, 1500, 16, 16, 64, 0, False, 0.0),
    ("internlm2", 4, 2048, 2048, 48, 8, 128, 0, True, 0.0),
    ("gemma3 window", 8, 2048, 2048, 8, 4, 256, 1024, True, 0.0),
    ("gemma3 window capped", 8, 2048, 2048, 8, 4, 256, 1024, True,
     SOFTCAP),
    ("hymba window", HYBRID_BATCH, HYBRID_PROMPT, HYBRID_PROMPT, 25, 5, 64,
     1024, True, 0.0),
)
#: (atol, rtol) of the backward against ``plain_backward`` on the same
#: forward output and lse: bf16, one rounding of each output (2^-8
#: relative) over sums of up to 2,048 terms taken in another order;
#: float32, the sums' order alone
BWD_TOL = {"bfloat16": (2e-2, 2e-2), "float32": (1e-4, 1e-4)}
#: the rows' log-sum-exp against ``plain_with_lse``: float32 sums of up
#: to 2,048 exponentials (``ex2.approx`` in the bf16 instance)
LSE_TOL = 1e-3
#: the training steps of ``training_cpu_agreement``: (what, batch, seq);
#: Hymba's 1,152 tokens run past its 1,024-token window
TRAIN_AGREE = (("edge ladder", 8, 256), ("granite 2 layers", 4, 256),
               ("whisper 2+2 layers", 2, 64),
               ("falcon-mamba 1 layer", 2, 256), ("hymba 2 layers", 1, 1152))
#: (atol, rtol) of the card's step against the CPU's, both bf16 from the
#: same params and batch: the loss (~ln V, a mean over every token), the
#: aux loss (a Switch balance term: one token whose top expert flips on a
#: bf16 tie moves its load share by 1 / (B S)), the gradients' global norm
#: (bf16 gradients summed in another order on each device)
TRAIN_TOL = {"loss": (0.0, 2e-3), "aux_loss": (0.0, 2e-2),
             "grad_norm": (0.0, 5e-2)}
LM_STEPS, LM_BATCH, LM_SEQ = 10, 8, 2048
#: P3 at Falcon-Mamba's 64 x 256 x 8,192 (the card check of the Falcon
#: cut) and at Hymba's 8 x 2,048 x 3,200 (its training step's shape), bf16
#: u, Hymba also with float32 u: (label, Bt, S, di, u's type, a non-zero
#: final-state gradient)
SCAN_BWD_CASES = (
    ("falcon", SERVE_BATCH, PROMPT, 8192, "bfloat16", False),
    ("hymba", HYBRID_BATCH, HYBRID_PROMPT, 3200, "bfloat16", True),
    ("hymba", HYBRID_BATCH, HYBRID_PROMPT, 3200, "float32", False))
#: P3 against ``plain_backward``: du within atol = rtol of u's type (one
#: rounding to bf16 on each side; float32 sums over 16 states, the decays
#: by ``ex2.approx``), ddt (float32) within the float32 one; dA, dD, dB,
#: dC (sums over rows and time, or over channels) within a share of the
#: leaf's largest magnitude
SCAN_BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
SCAN_BWD_REDUCED = 1e-3
SCAN_GRADS = ("du", "ddt", "dA", "dB", "dC", "dD")
#: exponentials an element P3 takes: 1.5 rebuilding a chunk's states in
#: two halves, 1 in the reverse walk
SCAN_BWD_EXPS = 2.5
#: u's type in the mangled names of P3's walk (``selective_scan_bwd_kernel
#: <T>``), by the case's type
SCAN_BWD_TYPES = {"bfloat16": "I13__nv_bfloat16EE", "float32": "IfEE"}


def bwd_regs(ptxas, dtype, hd, cap=False):
    """[[registers, spill store, spill load bytes] of P2's dK/dV kernel,
    the same of its dQ kernel] for ``dtype`` at head dim ``hd``: the
    tensor-core kernels in bf16, the CUDA-core ones in float32."""
    name = ("flash_bwd_%s_tc_kernelILi%dELb%dE" if dtype == "bfloat16"
            else "flash_bwd_%s_kernelIfLi%dELb%dE")
    return [instance_regs(ptxas, name % (kind, hd, int(bool(cap))))
            for kind in ("dkdv", "dq")]


def sdpa_backward(torch, q, k, v, do, causal, window):
    """SDPA's backward alone, timed as P2's library counterpart: one
    forward on leaf copies of q, k, v (the model's layout as transposed
    views, GQA enabled, the case's mask), its graph retained, and a call
    that runs ``torch.autograd.grad`` through it. Never on the path."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    sq, skv = q.shape[1], k.shape[1]
    if window:
        qp = torch.arange(sq, device="cuda")[:, None] + (skv - sq)
        kp = torch.arange(skv, device="cuda")[None, :]
        kw = {"attn_mask": (kp <= qp) & (kp > qp - window)}
    else:
        kw = {"is_causal": causal}
    out = sdpa(torch, *leaves, **kw).transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


def flex_backward(torch, q, k, v, do, cap, causal, window):
    """Compiled ``flex_attention``'s backward alone (the cap as its
    ``score_mod``, the mask as its block mask), timed as a capped case's
    library counterpart; never on the path."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = capped_library(torch, *leaves, cap, causal=causal,
                         window=window)()
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


def attention_backward(torch, flash_attention, ptxas):
    """K3's ``kLse`` instances and P2 at every case of ``BWD_CASES``, bf16
    and float32: the output bit-equal to the serving instance's, the rows'
    log-sum-exp against ``plain_with_lse``, dq / dk / dv against
    ``plain_backward`` on the same output and lse (``BWD_TOL``, reported
    as the limit share). bf16 timed: P2 warm and cold, its bound
    (``cost_backward`` at the bf16 tensor cores' peak), the plain
    version, and the library's backward alone (SDPA's; a capped case
    compiled ``flex_attention``'s); each line with the registers and
    spills of P2's two kernels. Returns the kernels-line entry
    (Granite's bf16 case)."""
    g = torch.Generator(device="cuda").manual_seed(25)
    errs, main = [], None
    for name, b, sq, skv, h, kv, hd, window, causal, cap in BWD_CASES:
        kw = dict(causal=causal, window=window, softcap=cap)
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q, k, v, do = (torch.randn(shape, generator=g, device="cuda")
                           .to(dt) for shape in ((b, sq, h, hd),
                                                 (b, skv, kv, hd),
                                                 (b, skv, kv, hd),
                                                 (b, sq, h, hd)))
            o, lse = flash_attention.flash_attention_cuda(q, k, v, lse=True,
                                                          **kw)
            serving = flash_attention.flash_attention_cuda(q, k, v, **kw)
            _, want_lse = flash_attention.plain_with_lse(q, k, v, **kw)
            got = flash_attention.flash_attention_backward_cuda(
                q, k, v, o, lse, do, **kw)
            want = flash_attention.plain_backward(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            what = f"attention backward {name} {dtype}"
            check(torch.equal(o, serving),
                  f"{what}: the lse instance's output is not the serving "
                  "instance's")
            lse_err = float((lse - want_lse).abs().max())
            check(lse_err <= LSE_TOL, f"{what}: lse error {lse_err}")
            atol, rtol = BWD_TOL[dtype]
            shares = {n: limit_share(x.float(), y.float(), atol, rtol)
                      for n, x, y in zip(("dq", "dk", "dv"), got, want)}
            grad_err = max(float((x.float() - y.float()).abs().max())
                           for x, y in zip(got, want))
            check(max(shares.values()) <= 1.0,
                  f"{what}: limit shares {shares}")
            errs.append(grad_err)
            del want
            line = dict(phase="attention_backward", layout=name,
                        shape=[b, sq, h, kv, hd], kv_len=skv, causal=causal,
                        window=window, softcap=cap, dtype=dtype,
                        o_equal_serving=True, lse_max_abs_err=lse_err,
                        lse_tolerance=LSE_TOL, max_abs_err=grad_err,
                        tolerance=[atol, rtol], limit_shares=shares,
                        registers_spills=bwd_regs(ptxas, dtype, hd, cap))
            if dtype != "bfloat16":         # checked, not timed
                emit(**line)
                continue

            def call():
                return flash_attention.flash_attention_backward_cuda(
                    q, k, v, o, lse, do, **kw)
            lib = (flex_backward(torch, q, k, v, do, cap, causal, window)
                   if cap else sdpa_backward(torch, q, k, v, do, causal,
                                             window))
            ops_, nbytes = flash_attention.cost_backward(
                b, sq, skv, h, kv, hd, 2, causal=causal, window=window)
            b_ms, b_by = bound(nbytes, ops_, BF16_TC_OPS_PER_S)
            ms = hidden_ms(call, reps=10)
            row = dict(ms=ms, plain_ms=hidden_ms(
                lambda: flash_attention.plain_backward(q, k, v, o, lse, do,
                                                       **kw), reps=3),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=hidden_ms(lib, reps=10),
                cold_ms=cold_ms(call, reps=5), library_cold_ms=cold_ms(
                    lib, reps=5), bound_share=b_ms / ms,
                forward_lse_ms=hidden_ms(
                    lambda: flash_attention.flash_attention_cuda(
                        q, k, v, lse=True, **kw), reps=10),
                forward_ms=hidden_ms(
                    lambda: flash_attention.flash_attention_cuda(
                        q, k, v, **kw), reps=10))
            emit(**line, library="flex_attention" if cap else "sdpa", **row)
            if name == "granite":
                main = row
            del lib
        del q, k, v, do, o, lse, serving, got
        free_card(torch)
    return dict(name="flash_attention_backward", route="cuda",
                source="src/repro_torch/csrc/flash_attention_backward.cu",
                replaces="none: port-only (the reference differentiates "
                "its jnp mirrors with jax.grad, src/repro/models/"
                "layers.py:107 chunked_attention, :164 "
                "local_banded_attention)",
                max_abs_err=max(errs), **{k: main[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")})


def scan_backward(torch, selective_scan, ptxas):
    """K6's ``kStates`` instance and P3 at every case of
    ``SCAN_BWD_CASES``, inputs drawn as ``scan_phase`` draws them and dy
    ~ N(0, 1) in u's type: y and h_last of the ``kStates`` instance
    bit-equal to the serving instance's, two P3 runs bit-equal, du, ddt,
    dA, dB, dC, dD against ``plain_backward`` on the same inputs
    (``SCAN_BWD_TOL``, ``SCAN_BWD_REDUCED``; reported as limit shares).
    bf16 timed: P3 warm and cold, split by kernel (walk, sums; one
    profiler window), its bound (``cost_backward`` at the FP32 peak), the
    bytes its partial sums add, the SFU floor of one exponential an
    element (``sfu_ms``) and of the design's 2.5 (``sfu_design_ms``), the
    plain version, the ``kStates`` forward beside the serving one; each
    line with the registers and spills of P3's walk and sums, its tile
    (the steps between two kept states), channels a block, blocks and
    waves (``selective_scan.backward_grid``). Returns the kernels-line
    entry (Hymba's bf16 case: the ssm_training path's shape)."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(28)
    n = SCAN_STATE
    errs, main = [], None
    for label, bt, s, di, dtype, with_dh in SCAN_BWD_CASES:
        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda")
        u = (rnd(bt, s, di) * 0.5).to(getattr(torch, dtype))
        dt = F.softplus(rnd(bt, s, di)) * 0.1
        args = (u, dt, -torch.exp(rnd(di, n) * 0.3), rnd(bt, s, n),
                rnd(bt, s, n), rnd(di))
        dy = rnd(bt, s, di).to(u.dtype)
        dh = rnd(bt, di, n) if with_dh else None
        y, h, states = selective_scan.selective_scan_cuda(*args, states=True)
        y0, h0 = selective_scan.selective_scan_cuda(*args)
        got = selective_scan.selective_scan_backward_cuda(*args, states, dy,
                                                          dh)
        again = selective_scan.selective_scan_backward_cuda(*args, states,
                                                            dy, dh)
        torch.cuda.synchronize()
        what = f"scan backward {label} {dtype}"
        check(torch.equal(y, y0) and torch.equal(h, h0),
              f"{what}: the kStates instance's y or h_last is not the "
              "serving instance's")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{what}: two runs differ")
        del y, h, y0, h0, again
        want = selective_scan.plain_backward(*args, dy, dh)
        shares, leaf_errs = {}, {}
        for name, x, w in zip(SCAN_GRADS, got, want):
            x, w = x.float(), w.float()
            leaf_errs[name] = float((x - w).abs().max())
            if name in ("du", "ddt"):
                tol = SCAN_BWD_TOL[dtype if name == "du" else "float32"]
                shares[name] = limit_share(x, w, tol, tol)
            else:
                shares[name] = leaf_errs[name] / (
                    SCAN_BWD_REDUCED * float(w.abs().max()))
        check(max(shares.values()) <= 1.0, f"{what}: limit shares {shares}")
        errs.append(max(leaf_errs.values()))
        del want, got
        regs = {k: instance_regs(ptxas, k) for k in (
            "selective_scan_bwd_kernel" + SCAN_BWD_TYPES[dtype],
            "selective_scan_bwd_sum_kernel")}
        line = dict(phase="scan_backward", layout=label, shape=[bt, s, di, n],
                    dtype=dtype, dh_last=with_dh, states_equal_serving=True,
                    runs_bit_equal=True, max_abs_err=leaf_errs,
                    tolerance_step=SCAN_BWD_TOL[dtype],
                    tolerance_reduced=SCAN_BWD_REDUCED, limit_shares=shares,
                    chunks=states.shape[1], tile=selective_scan.CHUNK,
                    channels_a_block=selective_scan.BWD_CHANNELS,
                    blocks=selective_scan.backward_grid(bt, di)[0],
                    waves=selective_scan.backward_grid(bt, di)[1],
                    registers_spills=regs)
        if dtype != "bfloat16":         # checked, not timed
            emit(**line)
            del args, dy, dh, states
            free_card(torch)
            continue

        def call():
            return selective_scan.selective_scan_backward_cuda(
                *args, states, dy, dh)
        ops_, nbytes = selective_scan.cost_backward(bt, s, di, n,
                                                    u.element_size())
        b_ms, b_by = bound(nbytes, ops_)
        exps = bt * s * di * n
        part = selective_scan.partial_bytes(bt, s, di, n)
        ms = hidden_ms(call, reps=10)
        _, by_kernel = kernel_counts(torch, call, reps=3)
        row = dict(ms=ms, plain_ms=hidden_ms(
            lambda: selective_scan.plain_backward(*args, dy, dh), reps=2),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            cold_ms=cold_ms(call, reps=5), bound_share=b_ms / ms,
            by_kernel_ms={k[:60]: us / 3e3 for k, us in by_kernel.items()},
            bytes=nbytes, partial_bytes=part,
            moved_ms=(nbytes + part) / HBM_BYTES_PER_S * 1e3,
            sfu_ms=exps / SFU_OPS_PER_S * 1e3,
            sfu_design_ms=SCAN_BWD_EXPS * exps / SFU_OPS_PER_S * 1e3,
            forward_states_ms=hidden_ms(
                lambda: selective_scan.selective_scan_cuda(*args,
                                                           states=True),
                reps=10),
            forward_ms=hidden_ms(
                lambda: selective_scan.selective_scan_cuda(*args), reps=10))
        emit(**line, **row)
        if label == "hymba":
            main = row
        del args, dy, dh, states
        free_card(torch)
    return dict(name="selective_scan_backward", route="cuda",
                source="src/repro_torch/csrc/selective_scan_backward.cu",
                replaces="none: port-only (the reference differentiates "
                "its jnp scan with jax.grad, src/repro/models/mamba.py:95 "
                "selective_scan_ref)",
                max_abs_err=max(errs), **{k: main[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")})


def training_cuts(get_config):
    """(what, config, batch, seq) of ``TRAIN_AGREE``: the edge ladder
    whole, Granite at full width cut to 2 layers, Whisper at full width
    cut to 2 encoder and 2 decoder layers over its 1,500 frames,
    Falcon-Mamba at full width cut to 1 of its 64 layers, Hymba at full
    width cut to its layers 0 (global) and 1 (window 1,024)."""
    edge = get_config("edge-ladder")
    granite = dataclasses.replace(get_config(MOE_ARCH), n_layers=2)
    whisper = dataclasses.replace(get_config(AUDIO_ARCH), n_layers=2,
                                  n_enc_layers=2)
    falcon = dataclasses.replace(get_config(SSM_ARCH), n_layers=1)
    hymba = dataclasses.replace(get_config(HYBRID_ARCH), n_layers=2,
                                global_layers=(0,))
    return [(what, cfg, b, s) for (what, b, s), cfg in
            zip(TRAIN_AGREE, (edge, granite, whisper, falcon, hymba))]


def training_cpu_agreement(torch, get_config, build_model, training,
                           flash_attention, selective_scan):
    """One ``make_train_step`` step on the card and on the CPU from the
    same params (drawn on the card, copied) and batch, bf16 on both, for
    each of ``training_cuts``: the loss, aux loss and gradient norm
    within ``TRAIN_TOL`` (with their limit shares), and the launches of
    the card's step: K3's forward and P2 where the cut has attention, K6's
    ``kStates`` forward and P3 where it has Mamba blocks (each forward
    twice a layer: the rematerialised layers run again)."""
    import numpy as np
    from repro_torch.training.optimizer import tree_leaves, tree_map
    opt = training.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=20)
    for what, cfg, b, s in training_cuts(get_config):
        model = build_model(cfg)
        params = model.init(3, device="cuda")
        p_cpu = tree_map(lambda t: t.to("cpu", copy=True), params)
        for tree in (params, p_cpu):
            for p in tree_leaves(tree):
                p.requires_grad_(p.is_floating_point())
        rng = np.random.default_rng(4)
        batch = {"tokens": torch.tensor(rng.integers(
            0, cfg.vocab_size, (b, s)).astype(np.int32))}
        if cfg.is_encdec:
            batch["frames"] = torch.tensor(rng.standard_normal(
                (b, cfg.enc_seq, cfg.d_model)).astype(np.float32))
        step = training.make_train_step(model, opt)
        counted = [flash_attention.KERNEL, flash_attention.BACKWARD,
                   selective_scan.KERNEL, selective_scan.BACKWARD]
        before = [k.launches for k in counted]
        t0 = time.perf_counter()
        _, card = step({"params": params,
                        "opt": training.init_opt_state(params)},
                       {k: v.cuda() for k, v in batch.items()})
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = {k.name: k.launches - b for k, b in zip(counted, before)}
        t0 = time.perf_counter()
        _, cpu = step({"params": p_cpu, "opt": training.init_opt_state(
            p_cpu)}, batch)
        cpu_s = time.perf_counter() - t0
        line = dict(phase="training_cpu_agreement", what=what,
                    arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
                    batch=b, seq=s, card_step_s=card_s, cpu_step_s=cpu_s,
                    launches_a_step=launches, peak_gb=peak_gb(torch))
        if cfg.is_encdec:
            line.update(enc_layers=cfg.n_enc_layers, frames=cfg.enc_seq)
        for key, (atol, rtol) in TRAIN_TOL.items():
            a, c = float(card[key]), float(cpu[key])
            share = abs(a - c) / (atol + rtol * abs(c)) if (atol or c) \
                else 0.0
            line[key] = [a, c]
            line[key + "_limit_share"] = share
            check(np.isfinite(a) and share <= 1.0,
                  f"training {what}: card {key} {a} vs CPU {c}")
        line["tolerance"] = {k: list(v) for k, v in TRAIN_TOL.items()}
        attn, scan = cfg.arch_type != "ssm", cfg.arch_type in ("ssm",
                                                               "hybrid")
        want = [k.name for k, on in zip(counted, (attn, attn, scan, scan))
                if on]
        check(all(launches[k] > 0 for k in want),
              f"training {what}: one of {want} never launched: {launches}")
        emit(**line)
        del params, p_cpu, card, cpu
        free_card(torch)


def train_main(torch, train_cli, arch, kernels, phase, *extra):
    """``launch.train.main`` on ``arch`` at full size, ``LM_STEPS`` steps
    at ``LM_BATCH`` x ``LM_SEQ`` (plus ``extra`` arguments), its output
    parsed: the last loss below the first and every loss and gradient norm
    finite, else it raises. Returns (main's result, its loss lines, the
    parsed steps, main's seconds, the launches of ``kernels`` in ``main``
    alone: their counts are set to 0 just before it and read just after,
    the card's peak GB)."""
    import contextlib
    import io
    import math
    import re
    free_card(torch)
    buf = io.StringIO()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        run = train_cli.main(["--arch", arch, "--steps", str(LM_STEPS),
                              "--batch", str(LM_BATCH), "--seq",
                              str(LM_SEQ), *extra])
    main_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels if k.launches}
    train_peak = peak_gb(torch)
    lines = buf.getvalue().strip().splitlines()
    steps = [re.match(r"step +(\d+) loss +(\S+) gnorm +(\S+) lr (\S+)", ln)
             for ln in lines]
    steps = [(int(m.group(1)), float(m.group(2)), float(m.group(3)),
              float(m.group(4))) for m in steps if m]
    check(len(steps) >= 2, f"{phase} printed no loss lines: {lines}")
    check(all(math.isfinite(x[1]) and math.isfinite(x[2]) for x in steps),
          f"{phase}: a loss or gradient norm is not finite: {steps}")
    check(steps[-1][1] < steps[0][1],
          f"{phase}: the last loss {steps[-1][1]} is not below the "
          f"first {steps[0][1]}")
    return run, lines, steps, main_s, launches, train_peak


def step_walls(torch, one_step, n=3):
    """Host ms of ``n`` synchronised calls of ``one_step``."""
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


class RssPeak:
    """The host's peak resident memory while the ``with`` block runs, in
    GB, from ``/proc/self/statm`` read every 50 ms on a thread (the
    process's ``ru_maxrss`` keeps the peak of every earlier phase)."""

    def __enter__(self):
        import threading
        self.gb, self._stop = 0.0, threading.Event()
        page = os.sysconf("SC_PAGE_SIZE")

        def poll():
            while True:
                with open("/proc/self/statm") as f:
                    self.gb = max(self.gb, int(f.read().split()[1]) * page
                                  / 1e9)
                if self._stop.wait(0.05):
                    return
        self._thread = threading.Thread(target=poll, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def ssm_training(torch, train_cli, kernels):
    """``launch.train.main`` on Hymba-1.5B at full size, 10 steps at 8 x
    2,048 (``train_main``): its loss lines, tokens/s, the card's peak
    memory (below the card's 80 GB) and the host's peak RSS over the
    phase; then, on the trained state, three steps' wall ms (tokens/s a
    step) and one step's profile (top kernels, K6's, P3's, K3's and P2's
    ms and shares, busy). Returns the launches of ``kernels`` in ``main``
    alone."""
    with RssPeak() as rss:
        run, lines, steps, main_s, launches, train_peak = train_main(
            torch, train_cli, HYBRID_ARCH, kernels, "ssm_training")
    check(train_peak < 80.0, f"ssm_training: peak {train_peak} GB")
    state, step_fn, batch = run["state"], run["step_fn"], run["batch"]
    from repro_torch.training.optimizer import tree_leaves_with_path
    n_params = sum(p.numel() for _, p in tree_leaves_with_path(
        state["params"]))
    emit(phase="ssm_training", arch=HYBRID_ARCH, steps=LM_STEPS,
         batch=LM_BATCH, seq=LM_SEQ, params=n_params, lines=lines,
         first_loss=steps[0][1], last_loss=steps[-1][1],
         loop_s=run["seconds"], tokens_per_s=LM_STEPS * LM_BATCH * LM_SEQ
         / run["seconds"], main_s=main_s, peak_gb=train_peak,
         host_peak_rss_gb=rss.gb, launches=launches)

    def one_step():
        step_fn(state, batch)
    walls = step_walls(torch, one_step)
    emit(phase="ssm_training_step", arch=HYBRID_ARCH, batch=LM_BATCH,
         seq=LM_SEQ, wall_ms=walls, tokens_per_s_step=LM_BATCH * LM_SEQ
         / (min(walls) / 1e3))
    step_profile(torch, one_step, steps=1, top=8, path="ssm_training",
                 what="train step")
    del run, state, step_fn, batch
    free_card(torch)
    return launches


def lm_training(torch, train_cli, load_pytree, tuning, kernels):
    """``launch.train.main`` on Granite-3.0-1B-A400M at full size, 10 steps
    at 8 x 2,048 with ``--save`` (``train_main``): its loss lines,
    tokens/s, the card's peak memory and the host's peak RSS, the saved
    params read back bit-equal; then, on the trained state, a step's wall
    and device ms, its profile (top kernels, the K3 forward's and P2's
    share, busy), and one step under ``remat_policy="dots"`` (ms, peak).
    Returns the launches of ``kernels`` in ``main`` alone."""
    import resource
    import shutil
    out_dir = os.path.join(ROOT, "build", "lm_training")
    path = os.path.join(out_dir, "params")
    run, lines, steps, main_s, launches, train_peak = train_main(
        torch, train_cli, MOE_ARCH, kernels, "lm_training", "--save", path)
    state, step_fn, batch = run["state"], run["step_fn"], run["batch"]
    params = state["params"]
    back = load_pytree(path, params)
    from repro_torch.training.optimizer import tree_leaves_with_path
    same = all(x.dtype == y.dtype and torch.equal(x, y.detach())
               for (_, x), (_, y) in zip(tree_leaves_with_path(back),
                                         tree_leaves_with_path(params)))
    check(same, "lm_training: the saved params do not read back equal")
    saved_gb = sum(os.path.getsize(path + ext) for ext in (".npz", ".json")) \
        / 1e9
    del back
    shutil.rmtree(out_dir, ignore_errors=True)
    n_params = sum(p.numel() for _, p in tree_leaves_with_path(params))
    tokens = LM_STEPS * LM_BATCH * LM_SEQ
    emit(phase="lm_training", arch=MOE_ARCH, steps=LM_STEPS,
         batch=LM_BATCH, seq=LM_SEQ, params=n_params, lines=lines,
         first_loss=steps[0][1], last_loss=steps[-1][1],
         loop_s=run["seconds"], tokens_per_s=tokens / run["seconds"],
         main_s=main_s, peak_gb=train_peak,
         host_peak_rss_gb=resource.getrusage(
             resource.RUSAGE_SELF).ru_maxrss / 1e6,
         saved_gb=saved_gb, saved_reads_back_equal=same)

    def one_step():
        step_fn(state, batch)
    walls = step_walls(torch, one_step)
    step_profile(torch, one_step, steps=1, top=8, path="lm_training",
                 what="train step")
    tuning.FLAGS["remat_policy"] = "dots"
    try:
        free_card(torch)
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        dots_ms = (time.perf_counter() - t0) * 1e3
        dots_peak = peak_gb(torch)
    finally:
        tuning.FLAGS["remat_policy"] = "full"
    emit(phase="lm_training_step", arch=MOE_ARCH, batch=LM_BATCH,
         seq=LM_SEQ, wall_ms=walls, tokens_per_s_step=LM_BATCH * LM_SEQ
         / (min(walls) / 1e3), remat_full_peak_gb=train_peak,
         remat_dots_ms=dots_ms, remat_dots_peak_gb=dots_peak)
    del run, state, step_fn, batch, params
    free_card(torch)
    return launches


def main():
    import torch
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device available")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        sys.exit("chip_smoke: src/repro_torch is missing beside this script")
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs.base import get_config
    from repro_torch.core import spaces
    from repro_torch.fleet import dynamics
    from repro_torch.kernels import (_build, best_response,
                                     decode_attention, dqn_head,
                                     flash_attention, int8_matmul, ops, ref,
                                     selective_scan, tabular_rl)
    from repro_torch.obs import prof
    from repro_torch import core
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.serve import build_engines
    from repro_torch.models import build_model, moe
    from repro_torch.models.variants import build_ladder
    from repro_torch.serving import Request, RequestBatcher, ServingEngine
    from repro_torch import training, tuning
    from repro_torch.checkpoint import load_pytree
    from repro_torch.launch import train as train_cli
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.configs.base import InputShape
    R = fleet_namespace()
    fleet_kernels = [tabular_rl.KERNEL, dqn_head.KERNEL]
    serving_kernels = [flash_attention.KERNEL, decode_attention.KERNEL,
                       int8_matmul.KERNEL]
    ssm_kernels = serving_kernels + [selective_scan.KERNEL]
    kernels = fleet_kernels + ssm_kernels + [best_response.KERNEL,
                                             flash_attention.BACKWARD,
                                             selective_scan.BACKWARD]

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
               flash_phase(torch, flash_attention,
                           ptxas=ptxas[flash_attention.KERNEL.name]),
               decode_phase(torch, ops, decode_attention,
                            ptxas=ptxas[decode_attention.KERNEL.name]),
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
                                         best_response,
                                         ptxas[best_response.KERNEL.name]))
    cell_dqn(torch, R, dqn_head.KERNEL)
    prof_phase(torch, R, prof, [tab_agent, dqn_agent], kernels)
    del fleets, runs, tab_agent, dqn_agent

    # the sharded fleet: one NCCL rank here, then two gloo ranks on the
    # card in their own processes, K1 and K2 counted on each rank
    fleet_sharded(torch, R, fleet_kernels)
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
    # the MoE path's kernels at Granite-3.0-1B-A400M's shapes: K3 and K4 at
    # its attention, K5 at d4's projections and over its 32 int8 experts
    # in one launch
    flash_phase(torch, flash_attention, MOE_FLASH_CASES, path="moe_serving")
    decode_phase(torch, ops, decode_attention, MOE_DECODE_CASES,
                 path="moe_serving")
    int8_phase(torch, ref, int8_matmul, MOE_INT8_SHAPES, path="moe_serving")
    int8_batched_phase(torch, ref, int8_matmul)

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

    # the mixture-of-experts path: Granite-3.0-1B-A400M (d0, d4) at full
    # size (its kernels at its shapes were held above)
    moe_engines, moe_init = build_family(torch, build_engines,
                                         get_config(MOE_ARCH), MOE_VARIANTS,
                                         MAX_LEN)
    for vid in MOE_VARIANTS:          # 2 layers at full width
        eng = moe_engines["S"][vid]
        model_cpu_agreement(
            torch, dataclasses.replace(eng.model.cfg, n_layers=2),
            cut_layers(eng.params, [[(0, 0), (0, 1)]]), build_model,
            MOE_AGREE_BATCH, 32, vid, phase="moe_cpu_agreement", moe=moe)
    for k in serving_kernels:         # the MoE path's launches only
        k.launches = 0
    moe_caches = moe_serving(torch, moe_engines, moe_init, moe)
    route_dispatch(torch, R, moe_engines, cells=SSM_ROUTE_CELLS,
                   phase="route_dispatch_moe", seed=MOE_ROUTE_SEED)
    moe_launches = {k.name: k.launches for k in serving_kernels}
    emit(phase="launches", moe_path=moe_launches)
    for name, n in moe_launches.items():
        check(n > 0, f"{name} was never launched on the MoE path")
    decode_profile(torch, moe_engines, moe_caches, path="moe_serving")
    prefill_profile(torch, moe_engines, SERVE_BATCH, PROMPT, MAX_LEN,
                    "moe_serving", variants=MOE_VARIANTS)
    del moe_engines, moe_caches

    # the state-space path's profiles
    decode_profile(torch, ssm_engines, ssm_caches, path="ssm_serving")
    decode_profile(torch, hyb_engines, hyb_caches, path="hybrid_serving",
                   batch=HYBRID_BATCH)
    prefill_profile(torch, hyb_engines, HYBRID_BATCH, HYBRID_PROMPT,
                    HYBRID_MAX_LEN, "hybrid_serving")
    prefill_profile(torch, ssm_engines, SERVE_BATCH, PROMPT, MAX_LEN,
                    "ssm_serving")
    del ssm_engines, hyb_engines, ssm_caches, hyb_caches

    # the dense and VLM path: K3 and K4 at head_dim 128 and 256 against
    # their plain versions at its layouts, the five configs' 2-layer cuts
    # against the CPU, Gemma3-4B and InternLM2-20B served whole (their
    # launches counted from here), then PaliGemma-3B and Gemma-7B whole
    # and the Yi-34B and DBRX cuts (counted apart)
    free_card(torch)
    attn_kernels = [flash_attention.KERNEL, decode_attention.KERNEL]
    for cases, dcases, path in ((DENSE_FLASH_CASES, DENSE_DECODE_CASES,
                                 "dense_serving"),
                                (VLM_FLASH_CASES, VLM_DECODE_CASES,
                                 "vlm_and_cuts")):
        flash_phase(torch, flash_attention, cases, path=path,
                    ptxas=ptxas[flash_attention.KERNEL.name], f32=DENSE_F32)
        decode_phase(torch, ops, decode_attention, dcases, path=path,
                     ptxas=ptxas[decode_attention.KERNEL.name],
                     f32=DENSE_F32)
    dense_cpu_agreement(torch, get_config, build_model,
                        serve_cli.variant_seed)
    dense_launches, int8_kv_launches = dense_serving(
        torch, R, build_engines, get_config, serving_kernels,
        with_gemma3=lambda eng: int8_kv_decode(
            torch, eng, build_model, tuning, [decode_attention.KERNEL]))
    vlm_launches = vlm_and_cuts(torch, build_engines, get_config,
                                build_model, serve_cli.variant_seed,
                                attn_kernels)
    emit(phase="launches", dense_serving=dense_launches,
         vlm_and_cuts=vlm_launches, int8_kv_decode=int8_kv_launches)
    for path, counts in (("dense", dense_launches), ("VLM and cuts",
                                                     vlm_launches),
                         ("int8 K/V cache", int8_kv_launches)):
        for name, n in counts.items():
            check(n > 0, f"{name} was never launched on the {path} path")

    # the encoder-decoder path: K3 without a mask over Whisper's 1,500
    # frames (and onto them from its prompt), K4 over its cross cache, K3
    # and K4 with a logit soft-cap, K5 at d4's encoder rows; Whisper's
    # 2-layer cut against the CPU; Whisper-medium whole, d0 and d4, its
    # launches counted from there
    free_card(torch)
    flash_phase(torch, flash_attention, AUDIO_FLASH_CASES,
                path="audio_serving",
                ptxas=ptxas[flash_attention.KERNEL.name], f32=AUDIO_F32)
    flash_phase(torch, flash_attention, SOFTCAP_FLASH_CASES,
                path="softcap", ptxas=ptxas[flash_attention.KERNEL.name],
                f32=SOFTCAP_F32)
    decode_phase(torch, ops, decode_attention, AUDIO_DECODE_CASES,
                 path="audio_serving",
                 ptxas=ptxas[decode_attention.KERNEL.name],
                 f32=AUDIO_DECODE_F32)
    int8_phase(torch, ref, int8_matmul, AUDIO_INT8_SHAPES,
               path="audio_serving")
    free_card(torch)
    audio_cpu_agreement(torch, get_config, build_model,
                        serve_cli.variant_seed)
    audio_launches = audio_serving(torch, get_config, build_model,
                                   serve_cli.variant_seed, serving_kernels)
    emit(phase="launches", audio_serving=audio_launches)
    for name, n in audio_launches.items():
        check(n > 0, f"{name} was never launched on the encoder-decoder "
              "path")

    # the dry run: four full-size pairs traced on the card's fakes, then
    # the trace held against the card at shapes one card holds
    free_card(torch)
    dryrun_phase(torch, dryrun, tuning, launch_mesh, get_config,
                 build_model, training, kernels, InputShape)

    # the training path: K3's lse instances and P2, K6's kStates instance
    # and P3 against their plain versions at the training shapes; one
    # step card vs CPU on five cuts; then launch.train's main on
    # Hymba-1.5B and on Granite-3.0-1B-A400M at full size, the launches of
    # each counted from its start
    free_card(torch)
    entries.append(attention_backward(
        torch, flash_attention, ptxas[flash_attention.BACKWARD.name]))
    entries.append(scan_backward(torch, selective_scan,
                                 ptxas[selective_scan.BACKWARD.name]))
    training_cpu_agreement(torch, get_config, build_model, training,
                           flash_attention, selective_scan)
    ssm_train_kernels = [flash_attention.KERNEL, flash_attention.BACKWARD,
                         selective_scan.KERNEL, selective_scan.BACKWARD]
    ssm_train_launches = ssm_training(torch, train_cli, kernels)
    emit(phase="launches", ssm_training=ssm_train_launches)
    for k in ssm_train_kernels:
        check(ssm_train_launches.get(k.name, 0) > 0,
              f"{k.name} was never launched on the ssm training path")
    launches[selective_scan.BACKWARD.name] = \
        ssm_train_launches[selective_scan.BACKWARD.name]
    train_kernels = [flash_attention.KERNEL, flash_attention.BACKWARD]
    train_launches = lm_training(torch, train_cli, load_pytree, tuning,
                                 kernels)
    emit(phase="launches", lm_training=train_launches)
    for k in train_kernels:
        check(train_launches.get(k.name, 0) > 0,
              f"{k.name} was never launched on the training path")
    launches[flash_attention.BACKWARD.name] = \
        train_launches[flash_attention.BACKWARD.name]

    by_path = {"fleet_loop": {k.name: launches[k.name]
                              for k in fleet_kernels},
               "serving": {k.name: launches[k.name]
                           for k in serving_kernels},
               "sim_to_real_loop": loop_launches,
               "coupled_oracle": {"best_response":
                                  launches["best_response"]},
               "single_cell": cli_launches, "ssm_path": ssm_launches,
               "moe_path": moe_launches, "dense_serving": dense_launches,
               "vlm_and_cuts": vlm_launches,
               "int8_kv_decode": int8_kv_launches,
               "audio_serving": audio_launches,
               "ssm_training": ssm_train_launches,
               "lm_training": train_launches}
    for e in entries:
        e["launches"] = launches[e["name"]]
        check(e["launches"] > 0,
              f"{e['name']} was never launched on its main path")
        e["launches_by_path"] = {p: c[e["name"]] for p, c in by_path.items()
                                 if c.get(e["name"])}
    emit(phase="elapsed", seconds=time.perf_counter() - t_start)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_by_path")
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
