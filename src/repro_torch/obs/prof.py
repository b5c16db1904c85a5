"""Cost profiling of the port's fleet programs — the counterpart of
``repro.obs.prof``: what a step *costs* before it runs, where the RL
loop's cost lies, and where fleet scaling stops being flat.

PyTorch has no compiled program to ask for a ``cost_analysis()``, so the
count is taken by tracing one call under ``FakeTensorMode``: nothing
runs and no kernel launches, and a ``TorchDispatchMode`` sums every aten
op the call dispatches —

* **flops**: ``torch.utils.flop_counter``'s formulas for the matmul-like
  ops, one per output element for every other op (a view, and a query
  that returns no tensor, are free);
* **bytes_accessed**: each op's input and output bytes;
* the hand-written kernels launch through ``ctypes``, where no
  dispatcher sees them: given FakeTensors, ``kernels.ops`` records each
  kernel's own ``cost`` here instead of launching, and allocates what
  the launch allocates;
* **peak_live_bytes**: the most bytes of distinct storages alive at
  once, the arguments' included: each op's new output storages are
  added as they appear (a view shares its storage; an in-place op
  allocates nothing) and dropped when their storage is freed, which
  Python's reference counting decides as it does on the card.

On DTensors (a model mesh, ``distributed.sharding``) the count is one
device's: an op on DTensors is handed on to DTensor's own dispatch, whose
ops on the local shards come back to the counter at their local shapes;
DTensor's shape propagation (ops on fakes of its own mode) counts
nothing; and each collective's output bytes, times the ring factor of
its kind (all-reduce 2, the others 1, as the reference's
``collective_bytes``), go to ``collectives`` instead of the op counts.

The counts depend only on shapes, so they are deterministic. Stage
costs split the agents' steps into the reference's stages and put
measured wall time beside them; the scaling sweep classifies a per-cell
cliff as runtime overhead or algorithmic growth.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.obs.spans import SpanRecorder, span


@dataclasses.dataclass(frozen=True)
class BackendPeaks:
    """Peak rates the roofline terms are computed against."""
    flops_per_s: float
    bytes_per_s: float
    note: str = ""


#: Per-backend peak constants. The cuda row is the data sheet's NVIDIA
#: H100 SXM (dense bf16 on the tensor cores, HBM3), the figures behind
#: ``PERF.md``'s bounds; the cpu row is a rough reference point. The
#: roofline terms compare programs and stages; they do not predict wall
#: time.
PEAKS: Dict[str, BackendPeaks] = {
    "cuda": BackendPeaks(989e12, 3.35e12, "NVIDIA H100 SXM bf16 dense, "
                         "HBM3 (data sheet)"),
    "cpu": BackendPeaks(1e11, 5e10, "CI-class 2-core host, rough"),
}


def backend_peaks(backend: Optional[str] = None) -> BackendPeaks:
    """Peak constants for ``backend`` (default: ``cuda`` when a card is
    present, else ``cpu``); unknown backends fall back to the cpu row."""
    b = backend or ("cuda" if torch.cuda.is_available() else "cpu")
    return PEAKS.get(b, PEAKS["cpu"])


@dataclasses.dataclass
class CostProfile:
    """Traced cost of one call. ``temp_bytes`` sums the outputs of every
    op that is not a result of the call: an upper bound on the
    intermediates' memory, since no allocator runs and nothing is freed
    or reused. ``peak_live_bytes`` is the most bytes of storages alive at
    once during the call, its arguments' included: what an allocator
    that wastes nothing would need."""
    name: str
    flops: float
    bytes_accessed: float
    arg_bytes: int
    out_bytes: int
    temp_bytes: int
    backend: str
    peak_flops_per_s: float
    peak_bytes_per_s: float
    peak_live_bytes: int = 0
    #: wire bytes of one device's collectives by kind ("all-reduce",
    #: "all-gather", "reduce-scatter", "all-to-all"), ring factors in
    collectives: dict = dataclasses.field(default_factory=dict)

    @property
    def arithmetic_intensity(self) -> float:
        """flops per byte accessed (0 when the call moves nothing)."""
        return self.flops / self.bytes_accessed if self.bytes_accessed \
            else 0.0

    @property
    def ridge_intensity(self) -> float:
        """The roofline ridge point of this backend (flops/byte above
        which a program is compute-bound at peak)."""
        return self.peak_flops_per_s / self.peak_bytes_per_s

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops_per_s

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / self.peak_bytes_per_s

    @property
    def dominant(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"

    def as_dict(self) -> dict:
        """JSON-ready dict (fields + the derived roofline terms)."""
        d = dataclasses.asdict(self)
        d.update(arithmetic_intensity=self.arithmetic_intensity,
                 ridge_intensity=self.ridge_intensity,
                 compute_s=self.compute_s, memory_s=self.memory_s,
                 dominant=self.dominant)
        return d


#: allocations do no work
_FREE = {torch.ops.aten.empty.memory_format,
         torch.ops.aten.empty_strided.default,
         torch.ops.aten.empty_like.default,
         torch.ops.aten.new_empty.default}


def _map(fn, tree):
    """``tree`` with ``fn`` applied to every tensor: the same nest of
    lists, tuples, NamedTuples, dicts and dataclasses (dataclasses are
    copied)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def _nbytes(tree) -> int:
    """Bytes of the distinct tensors in ``tree``."""
    sizes = {}
    _map(lambda t: sizes.setdefault(id(t), t.numel() * t.element_size()),
         tree)
    return sum(sizes.values())


class _LiveBytes:
    """Bytes of the distinct storages alive, and their peak. Each storage
    is held by a weak reference, so its end is seen whatever keeps it
    alive (a Python name, a view, autograd's saved tensors). Freed
    storages are swept out only where the running total would pass the
    peak, so the total is an upper bound between sweeps and exact at
    every new peak."""

    def __init__(self):
        self.refs = {}          # storage key -> (weak reference, bytes)
        self.held = set()       # keys of the arguments: alive all along
        self.live = 0
        self.peak = 0
        self._swept_at = 0

    def add(self, t: torch.Tensor, held: bool = False) -> None:
        from torch.multiprocessing.reductions import StorageWeakRef
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self.refs or key in self.held:
            return
        nbytes = storage.nbytes()
        if held:
            self.held.add(key)
        else:
            self.refs[key] = (StorageWeakRef(storage), nbytes)
        self.live += nbytes
        if self.live > self.peak or len(self.refs) > 2 * self._swept_at \
                + 4096:
            self._sweep()
            self.peak = max(self.peak, self.live)

    def _sweep(self) -> None:
        for key, (ref, nbytes) in list(self.refs.items()):
            if ref.expired():
                del self.refs[key]
                self.live -= nbytes
        self._swept_at = len(self.refs)


#: collective ops (functional and in place) -> the reference's kind name
_COLLECTIVES = {"all_reduce": "all-reduce", "allreduce": "all-reduce",
                "all_gather": "all-gather", "allgather": "all-gather",
                "reduce_scatter": "reduce-scatter",
                "all_to_all": "all-to-all", "alltoall": "all-to-all"}
#: effective wire multiplier per collective (ring algorithms), the
#: reference's ``_WIRE_FACTOR``
WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0}


def _collective(func) -> Optional[str]:
    """The kind of a collective op, or None for any other op."""
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d"):
        return None
    name = func.overloadpacket.__name__
    return next((kind for key, kind in _COLLECTIVES.items()
                 if name.startswith(key)), "wait")


class _CostCounter(TorchDispatchMode):
    """Sums the flops and bytes of every aten op dispatched under it, and
    the kernels' own costs that ``kernels.ops`` records; follows the live
    bytes of the storages its ops make. Ops on fakes of another mode than
    ``fake_mode`` (DTensor's shape propagation) count nothing."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.op_out_bytes = 0
        self.live = _LiveBytes()
        self.fake_mode = fake_mode
        self.collectives = {}
        self.muted = 0

    def _foreign(self, tensors) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor
        return self.muted > 0 or self.fake_mode is not None and any(
            isinstance(t, FakeTensor) and t.fake_mode is not self.fake_mode
            for t in tensors)

    @contextlib.contextmanager
    def muting_propagation(self):
        """Count nothing while DTensor propagates an op's global shapes
        (it runs the op on global fakes, in the fake mode in place).
        Raises where this PyTorch names that step otherwise: a sharded
        trace would count the whole model's ops beside one device's."""
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        name = next((n for n in ("_propagate_tensor_meta_non_cached",
                                 "_propagate_tensor_meta")
                     if hasattr(SP, n)), None)
        if name is None:
            raise RuntimeError(
                f"torch {torch.__version__}: ShardingPropagator has no "
                "_propagate_tensor_meta[_non_cached]; DTensor's global "
                "shape propagation cannot be left out of the count")
        orig = getattr(SP, name)

        def muted(prop, *a, **kw):
            self.muted += 1
            try:
                return orig(prop, *a, **kw)
            finally:
                self.muted -= 1
        setattr(SP, name, muted)
        try:
            yield
        finally:
            setattr(SP, name, orig)

    def kernel(self, name: str, ops: int, nbytes: int) -> None:
        self.flops += ops
        self.bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented     # its local ops come back here
        kwargs = kwargs or {}
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if self._foreign(ins) or self._foreign(outs):
            return out
        kind = _collective(func)
        if kind is not None:
            if kind != "wait":
                self.collectives[kind] = self.collectives.get(kind, 0.0) + \
                    WIRE_FACTOR[kind] * sum(t.numel() * t.element_size()
                                            for t in outs)
            return out
        for t in outs:
            self.live.add(t)
        # a view, an allocation or a query of metadata (``prim.device``,
        # which indexing dispatches on the whole indexed tensor) moves
        # nothing
        if func in _FREE or func.is_view or not outs:
            return out
        out_b = sum(t.numel() * t.element_size() for t in outs)
        self.bytes += out_b + sum(t.numel() * t.element_size() for t in ins)
        self.op_out_bytes += out_b
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        else:
            self.flops += sum(t.numel() for t in outs)
        return out


def profile_fn(fn: Callable, *args, name: Optional[str] = None,
               peaks: Optional[BackendPeaks] = None) -> CostProfile:
    """Trace one call ``fn(*args)`` under ``FakeTensorMode`` and count
    its cost. Nothing executes and no kernel launches: the arguments are
    replaced by fakes, so in-place updates touch none of the caller's
    tensors. Arguments that are FakeTensors already (a model's params
    drawn under a fake mode, too large to hold) are traced as they are,
    in their own mode. A call that reads a value on the host (a host
    sync inside the step) cannot be traced and raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode, is_fake
    from repro_torch.kernels import _build
    tensors = []
    _map(tensors.append, args)
    backend = tensors[0].device.type if tensors else "cpu"
    fakes = [_local(t) for t in tensors if is_fake(_local(t))]
    peaks = peaks or backend_peaks(backend)
    mode = fakes[0].fake_mode if fakes else \
        FakeTensorMode(allow_non_fake_inputs=True)
    counter = _CostCounter(mode)
    with mode:
        fake_args = _map(lambda t: t if is_fake(_local(t))
                         else mode.from_tensor(t), args)
        _map(lambda t: counter.live.add(_local(t), held=True), fake_args)
        _build.COST_SINKS.append(counter.kernel)
        try:
            with counter.muting_propagation(), counter:
                out = fn(*fake_args)
        finally:
            _build.COST_SINKS.remove(counter.kernel)
    out_bytes = _nbytes(_map(_local, out))
    return CostProfile(
        name=name or getattr(fn, "__name__", "fn"),
        flops=float(counter.flops), bytes_accessed=float(counter.bytes),
        arg_bytes=_nbytes(_map(_local, args)), out_bytes=out_bytes,
        temp_bytes=max(counter.op_out_bytes - out_bytes, 0),
        backend=backend, peak_flops_per_s=peaks.flops_per_s,
        peak_bytes_per_s=peaks.bytes_per_s,
        peak_live_bytes=counter.live.peak,
        collectives=dict(counter.collectives))


def _local(t):
    """A DTensor's local shard (this device's bytes), any other tensor as
    it is."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


# ---------------------------------------------------------------------------
# Stage breakdown of the fleet RL loops
# ---------------------------------------------------------------------------


def _clone(tree):
    """A copy of ``tree`` whose tensors are fresh clones (trainable
    leaves stay trainable), so a stage's in-place updates leave the
    agent's own state alone."""
    return _map(lambda t: t.detach().clone().requires_grad_(
        t.requires_grad), tree)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_wall_ms(fn, make_args, name: str, reps: int, device,
                    spans: Optional[SpanRecorder]) -> float:
    """Median host wall of ``reps`` synchronised calls, each inside a
    ``prof.stage.{name}`` span on ``spans``; one warm-up call first.
    Every call gets fresh arguments from ``make_args`` (clones, for the
    stages that update in place)."""
    rec = spans if spans is not None else SpanRecorder()
    tag = f"prof.stage.{name}"
    fn(*make_args())
    _sync(device)
    for _ in range(reps):
        args = make_args()
        _sync(device)
        with span(rec, tag):
            fn(*args)
            _sync(device)
    return float(np.median(rec.durations_ms(tag)[-reps:]))


def _dqn_stage_fns(agent, draws):
    """(name -> (fn, make_args)) decomposition of ``FleetDQN``'s step:
    act, env step, replay push + sample, update. The arguments are
    copies of the agent's live state (clones where a stage updates in
    place), so shapes match the real loop."""
    from repro_torch.fleet.api import make_env_step
    from repro_torch.fleet.policy import encode_fleet_state
    from repro_torch.fleet.replay import replay_push, replay_sample

    cfg = agent.cfg
    env_step = make_env_step(agent.source, threshold=cfg.accuracy_threshold,
                             noise=cfg.noise)
    scen, counts, dev = agent.scen, agent.counts, agent.device
    eps = torch.tensor(agent.eps, dtype=torch.float32, device=dev)
    s = encode_fleet_state(counts, scen)
    a = torch.zeros((scen.cells, scen.users), dtype=torch.int32, device=dev)
    r = torch.zeros((scen.cells,), device=dev)
    bs = torch.zeros((cfg.batch_size, agent.state_dim), device=dev)
    ba = torch.zeros((cfg.batch_size, scen.users), dtype=torch.int32,
                     device=dev)
    br = torch.zeros((cfg.batch_size,), device=dev)

    def encode_act(counts, scen, eps):
        return agent._act(counts, scen, eps, draws=draws)

    def replay(buf, s, a, r, s2):
        buf = replay_push(buf, s, a, r, s2)
        return replay_sample(draws, buf, cfg.batch_size)

    def update(params, opt, s, a, r, s2):
        return agent._update(params, opt, s, a, r, s2)

    act_name = "fused_encode_act" if cfg.net == "shared" else "encode_act"
    return {
        act_name: (encode_act, lambda: (counts, scen, eps)),
        "env_step": (lambda scen, a: env_step(draws, scen, a),
                     lambda: (scen, a)),
        "replay": (replay, lambda: (_clone(agent.buffer), s, a, r, s)),
        "update": (update, lambda: (_clone(agent.params), _clone(agent.opt),
                                    bs, ba, br, bs)),
    }


def _tabular_stage_fns(agent, draws):
    """(name -> (fn, make_args)) decomposition of ``FleetQLearning``'s
    fused step: the state index and exploration draw, the env step, and
    ``fused_update_act`` — the one ``kernels.ops.fused_tabular_update``
    call that covers the TD update and the next step's greedy action
    (the loop carries its ``greedy2``). The update runs on a clone of
    the Q-table."""
    from repro_torch.fleet.api import make_env_step
    from repro_torch.kernels import ops

    cfg = agent.cfg
    env_step = make_env_step(agent.source, threshold=cfg.accuracy_threshold,
                             noise=cfg.noise)
    pu, dev = agent.pu_table, agent.device
    scen, counts = agent.scen, agent.counts
    eps = torch.tensor(agent.eps, dtype=torch.float32, device=dev)
    zeros = torch.zeros((scen.cells,), dtype=torch.int32, device=dev)
    r = torch.zeros((scen.cells,), device=dev)

    def encode_act(counts, scen, greedy, eps):
        s = agent._state_index(counts, scen)
        a = agent._explore(greedy, eps, draws=draws)
        return s, a, pu[a.long()]

    def fused_update_act(q, s, a, r, s2):
        return ops.fused_tabular_update(q, s, a, r, s2, alpha=cfg.alpha,
                                        gamma=cfg.gamma)

    return {
        "encode_act": (encode_act, lambda: (counts, scen, zeros, eps)),
        "env_step": (lambda scen, a: env_step(draws, scen, a),
                     lambda: (scen, torch.zeros(
                         (scen.cells, scen.users), dtype=torch.int32,
                         device=dev))),
        "fused_update_act": (fused_update_act,
                             lambda: (_clone(agent.q), zeros, zeros, r,
                                      zeros)),
    }


def stage_costs(agent, reps: int = 5,
                spans: Optional[SpanRecorder] = None,
                peaks: Optional[BackendPeaks] = None) -> dict:
    """Fractional cost breakdown of a fleet agent's RL loop.

    Splits the agent's step into the reference's stages (``FleetDQN``:
    ``fused_encode_act`` — ``encode_act`` for ``net='cell'`` —,
    ``env_step``, ``replay``, ``update``; ``FleetQLearning``:
    ``encode_act``, ``env_step``, ``fused_update_act``), counts each with
    ``profile_fn`` and measures ``reps`` synchronised runs of each
    (``prof.stage.{name}`` spans on ``spans`` when given). Stages run on
    copies of the agent's state and on their own draws, so the agent is
    left bit for bit as it was.

    Returns ``{"kind", "cells", "users", "backend", "stages": {name:
    profile-dict + wall_ms}, "flop_fracs", "byte_fracs", "wall_fracs",
    "dominant_stage_flops", "dominant_stage_wall"}``.
    """
    from repro_torch.rng import Draws
    kind = "dqn" if hasattr(agent, "buffer") else "tabular"
    draws = Draws(0, agent.device)
    stage_fns = (_dqn_stage_fns(agent, draws) if kind == "dqn"
                 else _tabular_stage_fns(agent, draws))
    peaks = peaks or backend_peaks(agent.device.type)
    stages = {}
    for name, (fn, make_args) in stage_fns.items():
        prof = profile_fn(fn, *make_args(), name=name, peaks=peaks)
        wall = _median_wall_ms(fn, make_args, name, reps, agent.device,
                               spans)
        stages[name] = {**prof.as_dict(), "wall_ms": wall}

    def fracs(key):
        tot = sum(s[key] for s in stages.values())
        return {n: s[key] / tot if tot else 0.0
                for n, s in stages.items()}

    flop_fracs = fracs("flops")
    wall_fracs = fracs("wall_ms")
    return {
        "kind": kind,
        "cells": int(agent.scen.cells),
        "users": int(agent.scen.users),
        "backend": agent.device.type,
        "stages": stages,
        "flop_fracs": flop_fracs,
        "byte_fracs": fracs("bytes_accessed"),
        "wall_fracs": wall_fracs,
        "dominant_stage_flops": max(flop_fracs, key=flop_fracs.get),
        "dominant_stage_wall": max(wall_fracs, key=wall_fracs.get),
    }


# ---------------------------------------------------------------------------
# Scaling sweep: localize and classify the per-cell flatness cliff
# ---------------------------------------------------------------------------


def scaling_sweep(cells_grid: Sequence[int], users: int = 3, mesh=None,
                  steps: int = 200, chunk: int = 20,
                  cliff_tol: float = 0.5, flop_tol: float = 0.15,
                  config_kwargs: Optional[Dict[str, Any]] = None,
                  device=None) -> dict:
    """Sweep the fleet env step over ``cells_grid`` and classify the
    per-cell scaling cliff.

    For each fleet size the flops of ONE env step come from
    ``profile_fn``, and ``steps // chunk`` synchronised loops of
    ``chunk`` env steps give the measured wall:

    * ``flops/cell`` flat but device-time/cell grows by more than
      ``cliff_tol`` over the grid's best → **runtime** overhead (launch,
      dispatch; the work is linear — fix the harness);
    * ``flops/cell`` grows by more than ``flop_tol`` → **algorithmic**
      growth (superlinear per-cell work — fix the program).

    ``cliff_cells`` names the first grid size whose time per cell-step
    exceeds ``(1 + cliff_tol) x`` the grid minimum (None when flat).
    With ``mesh`` (``fleet.shard.fleet_mesh``) the scenario and actions
    shard along the fleet axis and every number is per rank: the flops
    of the rank's block, and its time over its block of cells.
    """
    from repro_torch import resolve_device
    from repro_torch.fleet.api import SyntheticSource, make_env_step
    from repro_torch.fleet.scenarios import FleetConfig
    from repro_torch.rng import Draws

    dev = resolve_device(device)
    ndev = mesh.size if mesh is not None else 1
    cfg_kw = dict(arrival_rate=1.0, p_r2w=0.05, p_w2r=0.1)
    cfg_kw.update(config_kwargs or {})
    flops_per_cell: Dict[int, float] = {}
    us_dev_per_cell: Dict[int, float] = {}
    per_device_sps: Dict[int, float] = {}
    for cells in cells_grid:
        source = SyntheticSource(FleetConfig(cells=cells, users=users,
                                             **cfg_kw), mesh=mesh)
        env_step = make_env_step(source)
        draws = Draws(1, dev)
        scen, _ = source.reset(Draws(0, dev))
        a1 = torch.zeros((scen.cells, users), dtype=torch.int32, device=dev)
        prof = profile_fn(lambda s, a: env_step(draws, s, a), scen, a1,
                          name=f"env_step_{cells}")
        flops_per_cell[cells] = prof.flops / scen.cells

        def run_chunk(scen):
            for _ in range(chunk):
                scen, _, ms, _, _ = env_step(draws, scen, a1)
            return scen, ms.mean()
        scen, _ = run_chunk(scen)                              # warm-up
        _sync(dev)
        n_chunks = max(1, steps // chunk)
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            scen, ms = run_chunk(scen)
            _sync(dev)
        dt = time.perf_counter() - t0
        total = n_chunks * chunk * cells
        per_device_sps[cells] = total / dt / ndev
        us_dev_per_cell[cells] = dt * ndev / total * 1e6

    return {"grid": list(cells_grid), "users": users, "devices": ndev,
            "sharded": mesh is not None, "backend": dev.type,
            **_classify(list(cells_grid), flops_per_cell, us_dev_per_cell,
                        per_device_sps, cliff_tol, flop_tol)}


def _classify(grid, flops_per_cell, us_dev_per_cell, per_device_sps,
              cliff_tol: float, flop_tol: float) -> dict:
    """The sweep's per-size series, its flatness and the cliff's kind
    and summary (the reference's classifier)."""
    best = min(us_dev_per_cell.values())
    best_cells = min(us_dev_per_cell, key=us_dev_per_cell.get)
    flop_floor = min(flops_per_cell.values())
    offending = [c for c in grid
                 if us_dev_per_cell[c] > (1.0 + cliff_tol) * best]
    cliff = offending[0] if offending else None
    if cliff is None:
        classification = "flat"
        summary = (f"flat: device-time per cell-step within "
                   f"{cliff_tol:.0%} of the best ({best:.2f}us at "
                   f"{best_cells} cells) across the grid")
    else:
        algorithmic = (flops_per_cell[cliff]
                       > (1.0 + flop_tol) * flop_floor)
        classification = "algorithmic" if algorithmic else "runtime"
        ratio = us_dev_per_cell[cliff] / best
        summary = (
            f"cliff at {cliff} cells: device-time per cell-step "
            f"{us_dev_per_cell[cliff]:.2f}us is {ratio:.1f}x the best "
            f"({best:.2f}us at {best_cells} cells) while compiled "
            f"flops/cell "
            + (f"grows {flops_per_cell[cliff] / flop_floor:.2f}x — "
               f"algorithmic growth (the program does superlinear "
               f"per-cell work)" if algorithmic else
               f"stays flat ({flops_per_cell[cliff]:.0f} vs "
               f"{flop_floor:.0f}) — runtime overhead (dispatch/"
               f"partitioning, not the program)"))
    top2 = [per_device_sps[c] for c in grid[-2:]]
    return {
        "flops_per_cell": {str(c): flops_per_cell[c] for c in grid},
        "us_device_per_cell_step": {str(c): us_dev_per_cell[c]
                                    for c in grid},
        "per_device_cell_steps_per_s": {str(c): per_device_sps[c]
                                        for c in grid},
        "flatness": min(top2) / max(top2),
        "cliff_cells": cliff,
        "classification": classification,
        "summary": summary,
    }
