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
  prompt bucket 256, 16 new tokens (kernels K3, K4, K5).

Each path's kernel launch counts are set to 0 just before it and read
just after. Every phase prints one JSON line; any failed check raises
and the exit code is non-zero. The line before the card's name lists
every kernel with its launches on its path, its error against the
plain version, its time beside the plain version's, its bound and, where
one PyTorch call computes the same function, that call's time. The
last line is ``{"ok": true, "device": {...}}``. It needs a CUDA device
and the ``src/repro_torch`` package beside it, and imports nothing of
JAX.
"""
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


def step_profile(torch, run, steps=5, **label):
    """Device busy share of ``run()`` (``steps`` steps of a path) and the
    five kernels with the most device time, from one ``torch.profiler``
    window."""
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
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    emit(phase="step_profile", **label, steps=steps,
         wall_ms_per_step=wall_us / steps / 1e3,
         device_ms_per_step=busy / steps / 1e3,
         device_busy_share=busy / wall_us if wall_us else None,
         top_kernels=[[n[:80], us / steps / 1e3] for n, us in top])


def timed(fn):
    """(ms, wall_ms, source): the profiler's device time per call where
    the trace has it, else the CUDA-event time; and the CUDA-event time
    per call, which includes the host's launch overhead."""
    wall = time_ms(fn)
    dev = device_ms(fn)
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
    gaps = (top[..., :-1] - top[..., 1:]).amin(-1)          # (cells, N)
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


def head_phase(torch, dqn_head, ref, dynamics):
    cells, users, hidden, topk = CELLS, USERS, 128, 5
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
    allowed = torch.ones((users, 10), device="cuda")
    acc_table = dynamics.accuracies(torch.arange(10, device="cuda"))
    args = (active, member, end_b, agg, ws[0], bs[0], ws[1], bs[1], ws[2],
            bs[2], allowed, acc_table)
    rows = cells * users
    mlp_ops = rows * 2 * (11 * hidden + hidden * hidden + hidden * 10)
    io_bytes = (rows * 3 * 4 + cells * 8 * 4
                + 4 * sum(w.numel() for w in ws + bs) + 4 * 10 * (users + 1)
                + rows * 4 + rows * 10 * 4)
    out = {}
    for threshold in (0.0, 85.0):
        kw = dict(threshold=threshold, topk=topk)
        d_k, q_k = dqn_head.dqn_head_cuda(*args, **kw)
        d_p, q_p = ref.dqn_head_ref(*args, **kw)
        torch.cuda.synchronize()
        err = float((q_k - q_p).abs().max())
        check(err <= 1e-5, f"dqn_head: q differs by {err} at {threshold}")
        margin = head_margins(torch, ref, q_p, member, acc_table, threshold,
                              topk)
        clear = margin > 1e-4
        differ = (d_k != d_p).any(-1)
        n_bad = int((differ & clear).sum())
        check(n_bad == 0, f"dqn_head: {n_bad} cells with clear margins "
              f"decide differently at threshold {threshold}")
        # and bit-exact on EVERY cell against the plain decision logic
        # applied to the kernel's own q (no product rounding in the way)
        d_own = ref.greedy_head_ref(q_k, member, acc_table, **kw)
        check(torch.equal(d_k, d_own), "dqn_head: decisions differ from "
              f"the plain logic on the kernel's q at {threshold}")
        ms, wall_ms, src = timed(lambda: dqn_head.dqn_head_cuda(*args, **kw))
        plain_ms, plain_wall_ms, _ = timed(
            lambda: ref.dqn_head_ref(*args, **kw))
        combo_ops = cells * topk ** users * users * 2 if threshold else 0
        b_ms, b_by = bound(io_bytes, mlp_ops + combo_ops)
        out[threshold] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=b_ms, bound_by=b_by)
        emit(phase="kernel_parity", kernel="dqn_head", threshold=threshold,
             shape=[cells, users, hidden], q_tolerance=1e-5, max_abs_err=err,
             cells_under_margin=int((~clear).sum()),
             cells_differing=int(differ.sum()), ms=ms, plain_ms=plain_ms,
             bound_ms=b_ms, bound_by=b_by, timing=src, wall_ms=wall_ms,
             plain_wall_ms=plain_wall_ms)
    main = out[85.0]                  # the DQN phase's QoS operating point
    return dict(name="dqn_head", route="cuda",
                source="src/repro_torch/csrc/dqn_head.cu",
                replaces="src/repro/kernels/dqn_head.py:116",
                library_ms=None, **main)


# ------------------------------------------------------------ K3-K5 ----
#: (name, q heads, kv heads) of the served layouts: d0/d4 and d7
HEAD_LAYOUTS = (("d0/d4", 8, 4), ("d7", 2, 2))
HEAD_DIM = 32
#: the (K, N) projections of d4 (wq/wo, wk/wv, gate/up, down) and d7
#: (wq/wk/wv, wo, gate/up/down)
INT8_SHAPES = ((256, 256), (256, 128), (256, 1024), (1024, 256),
               (256, 64), (64, 256))
ATTN_TOL = {"bfloat16": 2e-2, "float32": 2e-5}


def sdpa(torch, q, k, v, **kw):
    """``F.scaled_dot_product_attention`` on the model's (B, S, H, hd)
    layout (transposed views), GQA enabled — timed as the library's
    counterpart of K3/K4, never on the path."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        enable_gqa=True, **kw)


def flash_phase(torch, flash_attention):
    """K3 at batch 64, causal, prompt buckets 32 and 256, both head
    layouts; bf16 (the path's type) and float32."""
    b = SERVE_BATCH
    g = torch.Generator(device="cuda").manual_seed(5)
    errs, main = [], None
    for name, h, kv in HEAD_LAYOUTS:
        for s in (32, PROMPT):
            for dtype in ("bfloat16", "float32"):
                dt = getattr(torch, dtype)
                q, k, v = (torch.randn(shape, generator=g, device="cuda")
                           .to(dt) for shape in ((b, s, h, HEAD_DIM),
                                                 (b, s, kv, HEAD_DIM),
                                                 (b, s, kv, HEAD_DIM)))
                got = flash_attention.flash_attention_cuda(q, k, v)
                want = flash_attention.plain(q, k, v)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                tol = ATTN_TOL[dtype]
                check(err <= tol, f"flash_attention {name} S={s} {dtype}: "
                      f"error {err} > {tol}")
                errs.append(err)
                if dtype != "bfloat16":
                    continue
                ms, wall_ms, src = timed(
                    lambda: flash_attention.flash_attention_cuda(q, k, v))
                plain_ms, _, _ = timed(lambda: flash_attention.plain(q, k, v))
                lib_ms, _, _ = timed(lambda: sdpa(torch, q, k, v,
                                                  is_causal=True))
                # q, k, v read once, o written once (bf16); the causal
                # products the data needs: 2 * 2 * hd per kept (q, k) pair
                nbytes = 2 * b * s * HEAD_DIM * (2 * h + 2 * kv)
                ops = 4 * HEAD_DIM * b * h * s * (s + 1) // 2
                b_ms, b_by = bound(nbytes, ops, BF16_TC_OPS_PER_S)
                row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=lib_ms)
                emit(phase="kernel_parity", kernel="flash_attention",
                     layout=name, shape=[b, s, h, kv, HEAD_DIM],
                     dtype=dtype, max_abs_err=err, tolerance=tol, timing=src,
                     wall_ms=wall_ms, **row)
                if name == "d0/d4" and s == PROMPT:
                    main = row
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:84",
                max_abs_err=max(errs), **main)


def decode_phase(torch, ops, decode_attention):
    """K4 at batch 64, caches of 64 and 512 slots written half way (the
    ring's unwritten slots masked by the bias), both head layouts."""
    b = SERVE_BATCH
    g = torch.Generator(device="cuda").manual_seed(6)
    errs, main = [], None
    for name, h, kv in HEAD_LAYOUTS:
        for sc in (64, MAX_LEN):
            kv_pos = torch.arange(sc, device="cuda")[None].repeat(b, 1)
            kv_pos[:, sc // 2:] = -1
            cur = torch.randint(sc // 4, sc // 2, (b,), generator=g,
                                device="cuda")
            valid = (kv_pos >= 0) & (kv_pos <= cur[:, None])
            bias = torch.where(valid, 0.0, -1e30)
            for dtype in ("bfloat16", "float32"):
                dt = getattr(torch, dtype)
                q = torch.randn((b, h, HEAD_DIM), generator=g,
                                device="cuda").to(dt)
                kc, vc = (torch.randn((b, sc, kv, HEAD_DIM), generator=g,
                                      device="cuda").to(dt)
                          for _ in range(2))
                got = ops.decode_attention(q, kc, vc, kv_pos, cur)
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
                lib_ms, _, _ = timed(lambda: sdpa(
                    torch, q[:, None], kc, vc, attn_mask=mask))
                # both caches read whole (bf16), q and o, the f32 bias row;
                # 2 * 2 * hd per (head, slot)
                nbytes = 2 * 2 * b * sc * kv * HEAD_DIM \
                    + 2 * 2 * b * h * HEAD_DIM + 4 * b * sc
                ops_n = 4 * HEAD_DIM * b * h * sc
                b_ms, b_by = bound(nbytes, ops_n, BF16_TC_OPS_PER_S)
                row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=lib_ms)
                emit(phase="kernel_parity", kernel="decode_attention",
                     layout=name, shape=[b, sc, h, kv, HEAD_DIM],
                     dtype=dtype, max_abs_err=err, tolerance=tol, timing=src,
                     wall_ms=wall_ms, **row)
                if name == "d0/d4" and sc == MAX_LEN:
                    main = row
    return dict(name="decode_attention", route="cuda",
                source="src/repro_torch/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:72",
                max_abs_err=max(errs), **main)


def int8_library(torch, xq, wq):
    """The library's int8 product for ``torch._int_mm``: the row-major
    weight, or the column-major copy where the build wants one."""
    try:
        torch._int_mm(xq, wq)
        return wq
    except RuntimeError:
        return wq.t().contiguous().t()


def int8_phase(torch, ref, int8_matmul):
    """K5 at M = 64 x 256 tokens for every projection of d4 and d7:
    bit-exact against the plain version."""
    m = SERVE_BATCH * PROMPT
    g = torch.Generator(device="cuda").manual_seed(7)
    main = None
    for k, n in INT8_SHAPES:
        xq, sx = ref.quantize_ref(torch.randn((m, k), generator=g,
                                              device="cuda"))
        wq, sw = ref.quantize_ref(torch.randn((k, n), generator=g,
                                              device="cuda"), dim=0)
        got = int8_matmul.int8_matmul_cuda(xq, sx, wq, sw)
        want = int8_matmul.plain(xq, sx, wq, sw)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"int8_matmul {m}x{k}x{n}: not "
              f"bit-exact (max err {float((got - want).abs().max())})")
        ms, wall_ms, src = timed(
            lambda: int8_matmul.int8_matmul_cuda(xq, sx, wq, sw))
        plain_ms, _, _ = timed(lambda: int8_matmul.plain(xq, sx, wq, sw))
        wl = int8_library(torch, xq, wq)
        lib_ms, _, _ = timed(
            lambda: torch._int_mm(xq, wl).to(torch.float32) * sx * sw)
        nbytes = m * k + k * n + 4 * (m + n) + 4 * m * n
        b_ms, b_by = bound(nbytes, 2 * m * k * n, INT8_TC_OPS_PER_S)
        row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=lib_ms)
        emit(phase="kernel_parity", kernel="int8_matmul", shape=[m, k, n],
             bit_exact=True, max_abs_err=0.0, timing=src, wall_ms=wall_ms,
             **row)
        if (k, n) == (256, 1024):
            main = row
    return dict(name="int8_matmul", route="cuda",
                source="src/repro_torch/csrc/int8_matmul.cu",
                replaces="src/repro/kernels/int8_matmul.py:40",
                max_abs_err=0.0, **main)


# -------------------------------------------------------------- paths ----
def tabular_training(torch, R):
    scen = R.scenarios.mixed_table5_fleet(R.Draws(3, "cuda"), CELLS, USERS)
    agent = R.population.FleetQLearning(
        scen, R.scenarios.FleetConfig(cells=CELLS, users=USERS), seed=0,
        device="cuda")
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


def dqn_training(torch, R):
    cfg = R.scenarios.FleetConfig(cells=CELLS, users=USERS, arrival_rate=1.2,
                                  p_r2w=0.05, p_w2r=0.15, min_users=2,
                                  max_users=5)
    # the policy spans the oracle's candidate set (the restricted 3^5
    # offloading actions), so the holdout ratio is bounded by 1: over the
    # full 10^5 space the greedy can beat that oracle
    agent = R.policy.FleetDQN(
        R.api.SyntheticSource(cfg), actions=R.population.default_actions(
            R.population.SpaceSpec(USERS)),
        cfg=R.policy.FleetDQNConfig(hidden=128, topk=5,
                                    accuracy_threshold=85.0),
        seed=0, device="cuda")
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


def route_dispatch(torch, R, engines):
    """A 1,024-cell 3-user mixed Table-5 fleet (the full 10^3 joint
    space) routed into the engines in batches of 64 by the oracle at
    goals 0 and 85; then, for each engine the oracle left idle, the
    fixed strategy that targets it (local dk, edge or cloud), so that
    every engine of ``build_engines`` serves."""
    import numpy as np
    scen = R.scenarios.mixed_table5_fleet(R.Draws(11, "cuda"), ROUTE_CELLS,
                                          ROUTE_USERS, min_users=1,
                                          max_users=ROUTE_USERS)
    active = scen.active.cpu().numpy()
    want = set(zip(*(a.tolist() for a in np.nonzero(active))))
    served_by = {}

    def route(label, policy):
        res = R.api.FleetOrchestrator(policy).route(
            scen=scen, dispatch=engines, batch_size=SERVE_BATCH)
        keys = [(r.cell, r.user) for r in res.served]
        check(len(keys) == len(set(keys)) and set(keys) == want,
              f"{label}: the active users were not served exactly once")
        t = res.timings
        check(abs(t["batching_ms"] + t["compute_ms"] + t["dispatch_ms"]
                  - t["wall_ms"]) <= 1e-6 * t["wall_ms"]
              and t["dispatch_ms"] >= 0,
              f"{label}: batching + compute + dispatch != wall")
        check(all(abs(r.queue_ms + r.measured_ms - r.e2e_ms) <= 1e-9
                  for r in res.served), f"{label}: queue + measured != e2e")
        slo = res.slo()
        check(slo["measured"]["attained"] + slo["measured"]["violated"]
              == slo["requests"] == len(want),
              f"{label}: attained + violated != dispatched")
        per = res.timings["per_tier_variant"]
        for key, tv in per.items():
            served_by[key] = served_by.get(key, 0) + tv["requests"]
        emit(phase="route_dispatch", policy=label, cells=ROUTE_CELLS,
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
    emit(phase="route_coverage", served_by=served_by)


def serving(torch, engines):
    """Each variant's ``generate`` at batch 64, prompt bucket 256, 16 new
    tokens, cache 512: prefill and decode timed apart, then the whole
    call; the output checked for its shape and token range."""
    import numpy as np
    rng = np.random.default_rng(0)
    out = {}
    for vid in ("d0", "d4", "d7"):
        eng = engines["S"][vid]
        cfg = eng.model.cfg
        toks = rng.integers(0, cfg.vocab_size, (SERVE_BATCH, PROMPT)) \
            .astype(np.int32)
        eng.warmup(SERVE_BATCH, PROMPT)
        with torch.inference_mode():
            t_in = torch.tensor(toks, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = eng.model.prefill(eng.params, {"tokens": t_in},
                                              max_len=MAX_LEN)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            check(bool(torch.isfinite(logits.float()).all()),
                  f"{vid}: non-finite prefill logits")
            cur = logits[:, -1:, :cfg.vocab_size].argmax(-1).int()
            for _ in range(NEW_TOKENS):
                logits, cache = eng.model.decode(eng.params, cache, cur)
                cur = logits[:, -1:, :cfg.vocab_size].argmax(-1).int()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        gen, wall = eng.generate(toks, NEW_TOKENS)
        check(gen.shape == (SERVE_BATCH, NEW_TOKENS) and
              int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab_size,
              f"{vid}: generated tokens out of range")
        out[vid] = cache
        emit(phase="serving", variant=vid, quant=cfg.quant,
             heads=[cfg.n_heads, cfg.n_kv_heads], d_ff=cfg.d_ff,
             batch=SERVE_BATCH, prompt=PROMPT, new_tokens=NEW_TOKENS,
             max_len=MAX_LEN, prefill_ms=(t1 - t0) * 1e3,
             decode_ms_per_token=(t2 - t1) * 1e3 / NEW_TOKENS,
             generate_ms=wall * 1e3,
             tokens_per_s=SERVE_BATCH * NEW_TOKENS / wall)
    return out


def decode_profile(torch, engines, caches, steps=5):
    """Device busy share of ``steps`` decode steps of each variant (the
    caches of ``serving`` continue)."""
    for vid in ("d0", "d4", "d7"):
        eng = engines["S"][vid]
        cache = caches[vid]
        cur = torch.zeros((SERVE_BATCH, 1), dtype=torch.int32, device="cuda")

        def run():
            nonlocal cache
            with torch.inference_mode():
                for _ in range(steps):
                    _, cache = eng.model.decode(eng.params, cache, cur)
        step_profile(torch, run, steps, path="serving", variant=vid,
                     what="decode step")


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
        errs = []
        with torch.inference_mode():
            lg, cg = eng.model.prefill(eng.params, {"tokens": torch.tensor(
                toks, device="cuda")}, max_len=48)
            lc, cc = m.prefill(p_cpu, {"tokens": torch.tensor(toks)},
                               max_len=48)
            for _ in range(3):
                a, b_ = lg.float().cpu(), lc.float()
                errs.append(float((a - b_).abs().max()))
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
             logits_max_abs_err=max(errs), rows_with_clear_margin=int(
                 clear.sum()), tokens_equal=same)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


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
    from repro_torch.fleet import (api, dynamics, policy, population,
                                   scenarios)
    from repro_torch.kernels import (_build, decode_attention, dqn_head,
                                     flash_attention, int8_matmul, ops, ref,
                                     tabular_rl)
    from repro_torch.launch.serve import build_engines
    from repro_torch.models import build_model
    from repro_torch.rng import Draws
    from repro_torch.serving import ServingEngine
    R = types.SimpleNamespace(api=api, policy=policy, population=population,
                              scenarios=scenarios, Draws=Draws)
    fleet_kernels = [tabular_rl.KERNEL, dqn_head.KERNEL]
    serving_kernels = [flash_attention.KERNEL, decode_attention.KERNEL,
                       int8_matmul.KERNEL]
    kernels = fleet_kernels + serving_kernels

    emit(phase="env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))
    secs = _build.build(kernels)
    emit(phase="build", seconds=secs, ptxas={
        k.name: [ln.strip() for ln in k.ptxas_log.splitlines()
                 if "registers" in ln or "spill" in ln] for k in kernels})

    entries = [tabular_phase(torch, tabular_rl, ref),
               head_phase(torch, dqn_head, ref, dynamics),
               flash_phase(torch, flash_attention),
               decode_phase(torch, ops, decode_attention),
               int8_phase(torch, ref, int8_matmul)]
    cpu_agreement(torch, R)
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
    emit(phase="launches", fleet_loop={k.name: launches[k.name]
                                       for k in fleet_kernels},
         serving={k.name: launches[k.name] for k in serving_kernels})
    step_profile(torch, lambda: tab_agent.run(5), agent="tabular")
    step_profile(torch, lambda: dqn_agent.run(5), agent="dqn")
    decode_profile(torch, engines, caches)
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
