#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one
``nvcc`` per source, in parallel), holds each against its plain PyTorch
version on the card at the main path's shapes, then drives the fleet
online-learning loop through the entry points a user calls:
``FleetQLearning`` on a 32,768-cell mixed Table-5 fleet of 5 users and
``FleetDQN`` (hidden 128, top-5 constraint head at an 85% accuracy
goal) on a dynamic 32,768-cell synthetic fleet, each scored against
the brute-force oracle and routed through ``FleetOrchestrator``.

Every phase prints one JSON line; any failed check raises and the exit
code is non-zero. The line before the card's name lists every kernel
with its launches on the main path, its error against the plain
version, its time beside the plain version's and its bound. The last
line is ``{"ok": true, "device": {...}}``. It needs a CUDA device and
the ``src/repro_torch`` package beside it, and imports nothing of JAX.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# published peaks of one H100 SXM (dense, 700 W): HBM bytes/s, FP32 FLOP/s
# on the CUDA cores (the kernels compute in FP32 outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

CELLS, USERS = 32768, 5


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


def step_profile(torch, agent, name, steps=5):
    """Device busy share of ``steps`` fleet steps and the five kernels
    with the most device time, from one ``torch.profiler`` window."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        agent.run(steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for n, us in device_events(prof):
        by_name[n] = by_name.get(n, 0.0) + us
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    emit(phase="step_profile", agent=name, steps=steps,
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


def bound(bytes_moved, ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
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
    from repro_torch.fleet import (api, dynamics, policy, population,
                                   scenarios)
    from repro_torch.kernels import _build, dqn_head, ref, tabular_rl
    from repro_torch.rng import Draws
    R = types.SimpleNamespace(api=api, policy=policy, population=population,
                              scenarios=scenarios, Draws=Draws)
    kernels = [tabular_rl.KERNEL, dqn_head.KERNEL]

    emit(phase="env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))
    secs = _build.build(kernels)
    emit(phase="build", seconds=secs, ptxas={
        k.name: [ln.strip() for ln in k.ptxas_log.splitlines()
                 if "registers" in ln or "spill" in ln] for k in kernels})

    entries = [tabular_phase(torch, tabular_rl, ref),
               head_phase(torch, dqn_head, ref, dynamics)]
    cpu_agreement(torch, R)

    for k in kernels:                 # the main path's launches only
        k.launches = 0
    tab_agent = tabular_training(torch, R)
    dqn_agent = dqn_training(torch, R)
    launches = {k.name: k.launches for k in kernels}
    step_profile(torch, tab_agent, "tabular")
    step_profile(torch, dqn_agent, "dqn")
    for e in entries:
        e["launches"] = launches[e["name"]]
        check(e["launches"] > 0,
              f"{e['name']} was never launched on the main path")
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
