"""The selective scan's gradient in the port against the JAX package's, on
the CPU: ``kernels.selective_scan.plain_backward`` (P3's plain version,
the explicit reverse recurrence) against ``jax.vjp`` of the reference's
associative scan (``repro.models.mamba.selective_scan_ref``, what its
model trains through) and of its sequential oracle
(``repro.kernels.ref.selective_scan_ref``), at one step, chunk-ragged
lengths (31, 33, 70), channel counts that are no multiple of the
backward's 32-channel block, 8 and 16 states, float32 and bfloat16 ``u``,
with the final state's gradient zero and not; and ``ops.selective_scan``
under autograd (``_SelectiveScan``, what a CPU tensor takes) against
autograd through ``plain``, and without grad the serving call. The
wrapper's copies of the kernels' compile-time constants (the chunk, the
largest state, the threads and channels a block, the backward's blocks a
multiprocessor) are held equal to the CUDA sources they describe, and
``backward_grid`` / ``partial_bytes`` to the grid and partial sums the
backward's launcher makes at the training shapes.

Inputs come from a seeded numpy generator and reach both packages as the
same values; the cotangents ``dy`` are rounded to y's type first, as
autograd hands them over. Tolerances: the per-step leaves (du, ddt)
within 1e-4 absolute + 1e-4 relative (float32 sums over up to 70 steps
in another order; the associative scan combines the decays in a tree),
du with bfloat16 ``u`` within 2e-2 + 2e-2 (one rounding to bfloat16 on
each side, 2^-8 relative); the reduced leaves (dA, dD summed over batch
and time, dB, dC over channels) within 1e-4 of the leaf's largest
magnitude. Against autograd through ``plain`` (the same float32 formulas
differentiated by PyTorch), 1e-5 + 1e-5 relative.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import mamba as jmamba
from repro_torch.kernels import ops
from repro_torch.kernels import selective_scan as K6
from test_torch_training import one_cpu_thread  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
STEP_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
            "bfloat16": dict(atol=2e-2, rtol=2e-2)}
REDUCED_TOL = 1e-4
NAMES = ("du", "ddt", "dA", "dB", "dC", "dD")
SCANS = {"associative": jmamba.selective_scan_ref,
         "sequential": jref.selective_scan_ref}
#: (bt, s, di, n, u's type, a non-zero dh_last): every length with each
#: type, state size and dh_last at least once
CASES = [(2, 1, 40, 8, "float32", False),
         (1, 1, 36, 16, "bfloat16", True),
         (2, 31, 72, 16, "float32", True),
         (1, 31, 40, 8, "bfloat16", False),
         (2, 33, 40, 16, "bfloat16", True),
         (1, 33, 72, 8, "float32", False),
         (1, 70, 36, 16, "float32", False),
         (2, 70, 40, 8, "bfloat16", True)]


def _ids(c):
    return "b{}_s{}_d{}_n{}_{}_{}".format(*c[:5], "dh" if c[5] else "nodh")


def _inputs(bt, s, di, n, dtype, with_dh, seed):
    """(the reference's inputs and cotangents, the port's), the same
    values: u, dt, A, B, C, D drawn as the reference's scan tests draw
    them, dy in y's type, dh_last float32 or zero."""
    rng = np.random.default_rng(seed)
    f = np.float32
    u = (rng.standard_normal((bt, s, di)) * 0.5).astype(f)
    dt = (np.log1p(np.exp(rng.standard_normal((bt, s, di)))) * 0.1).astype(f)
    A = (-np.exp(rng.standard_normal((di, n)) * 0.3)).astype(f)
    B, C = (rng.standard_normal((bt, s, n)).astype(f) for _ in range(2))
    D = (1.0 + 0.1 * rng.standard_normal(di)).astype(f)
    dy = rng.standard_normal((bt, s, di)).astype(f)
    dh = (rng.standard_normal((bt, di, n)) if with_dh
          else np.zeros((bt, di, n))).astype(f)
    jdt, tdt = DTYPES[dtype]
    j = [jnp.asarray(u).astype(jdt)] + [jnp.asarray(a)
                                        for a in (dt, A, B, C, D)]
    t = [torch.tensor(u).to(tdt)] + [torch.tensor(a)
                                     for a in (dt, A, B, C, D)]
    return ((j, (jnp.asarray(dy).astype(jdt), jnp.asarray(dh))),
            (t, (torch.tensor(dy).to(tdt), torch.tensor(dh) if with_dh
                 else None)))


def _reference_vjp(scan, jx, jcot):
    """``jax.vjp`` of ``scan`` at ``jx`` applied to ``jcot``, jitted (the
    associative scan's tree runs op by op otherwise)."""
    @jax.jit
    def f(args, cot):
        return jax.vjp(scan, *args)[1](cot)
    return f(tuple(jx), jcot)


def _check(got, want, dtype):
    for name, x, w in zip(NAMES, got, want):
        w = np.asarray(jnp.asarray(w, jnp.float32)) \
            if not isinstance(w, torch.Tensor) else w.float().numpy()
        x = x.float().numpy()
        assert x.shape == w.shape, name
        if name in ("du", "ddt"):
            tol = STEP_TOL[dtype if name == "du" else "float32"]
            np.testing.assert_allclose(x, w, **tol, err_msg=name)
        else:
            limit = REDUCED_TOL * max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(x - w).max()) <= limit, name


@pytest.mark.parametrize("scan", list(SCANS))
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_backward_matches_the_reference_vjp(case, scan):
    bt, s, di, n, dtype, with_dh = case
    (jx, jcot), (tx, (dy, dh)) = _inputs(*case, seed=bt * s + di + n)
    want = _reference_vjp(SCANS[scan], jx, jcot)
    got = K6.plain_backward(*tx, dy, dh)
    assert got[0].dtype == tx[0].dtype
    assert all(g.dtype == torch.float32 for g in got[1:])
    _check(got, want, dtype)


@pytest.mark.parametrize("use_h_last", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_op_under_autograd_matches_autograd_through_plain(dtype, use_h_last):
    (_, _), (tx, (dy, dh)) = _inputs(2, 37, 40, 16, dtype, True, seed=11)
    leaves = [t.clone().requires_grad_() for t in tx]
    y, h = ops.selective_scan(*leaves)
    assert type(y.grad_fn).__name__ == "_SelectiveScanBackward"
    want_y, want_h = K6.plain(*tx)
    assert torch.equal(y.detach(), want_y) and torch.equal(h.detach(), want_h)
    outs, cots = ((y, h), (dy, dh)) if use_h_last else ((y,), (dy,))
    got = torch.autograd.grad(outs, leaves, cots)
    ref_leaves = [t.clone().requires_grad_() for t in tx]
    ry, rh = K6.plain(*ref_leaves)
    want = torch.autograd.grad((ry, rh) if use_h_last else (ry,),
                               ref_leaves, cots)
    for name, x, w in zip(NAMES, got, want):
        assert x.dtype == w.dtype, name
        torch.testing.assert_close(x.float(), w.float(), atol=1e-5,
                                   rtol=1e-5, msg=lambda m: f"{name}: {m}")


def test_op_without_grad_is_the_serving_call():
    (_, _), (tx, _) = _inputs(1, 9, 24, 8, "float32", False, seed=5)
    want = K6.plain(*tx)
    leaves = [t.clone().requires_grad_() for t in tx]
    got_plain = ops.selective_scan(*tx)          # no input requires grad
    with torch.no_grad():                        # grad mode off
        got_no_grad = ops.selective_scan(*leaves)
    for got in (got_plain, got_no_grad):
        assert all(g.grad_fn is None and not g.requires_grad for g in got)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


CSRC = os.path.join(os.path.dirname(os.path.dirname(K6.__file__)), "csrc")


def _constants(source):
    """The integer literals of a CUDA source's ``constexpr int``s."""
    with open(os.path.join(CSRC, source)) as f:
        return {k: int(v) for k, v in re.findall(
            r"constexpr int (\w+) = (\d+);", f.read())}


@pytest.mark.parametrize("value, source, name", [
    (K6.CHUNK, "selective_scan.cu", "kChunk"),
    (K6.MAX_STATE, "selective_scan.cu", "kMaxState"),
    (K6.THREADS, "selective_scan.cu", "kThreads"),
    (K6.CHUNK, "selective_scan_backward.cu", "kChunk"),
    (K6.MAX_STATE, "selective_scan_backward.cu", "kMaxState"),
    (K6.BWD_BLOCKS_PER_SM, "selective_scan_backward.cu", "kBlocksPerSM"),
], ids=lambda v: str(v))
def test_wrapper_constants_match_the_sources(value, source, name):
    assert _constants(source)[name] == value


def test_backward_channels_match_the_source():
    k = _constants("selective_scan_backward.cu")
    assert K6.BWD_CHANNELS == k["kThreads"] // k["kLanes"]


@pytest.mark.parametrize("bt, s, di, blocks, partial", [
    (8, 2048, 3200, 800, 422_912_000),       # Hymba-1.5B's training shape
    (64, 256, 8192, 16_384, 1_145_044_992),  # Falcon-Mamba-7B's
    (1, 300, 40, 2, 2 * 4 * (2 * 2 * 300 * 16 + 40 * 17)),  # ragged di
])
def test_backward_grid_and_partial_bytes(bt, s, di, blocks, partial):
    got, waves = K6.backward_grid(bt, di)
    assert got == blocks
    assert waves == blocks / (K6.SMS * K6.BWD_BLOCKS_PER_SM)
    assert K6.partial_bytes(bt, s, di, 16) == partial
