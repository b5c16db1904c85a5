"""The state-space path's kernels and blocks in the port against the JAX
package, on the CPU: K6's plain version (what a CPU tensor takes through
``repro_torch.kernels.ops.selective_scan``) against the reference's
Pallas selective-scan kernel in interpret mode (``repro.kernels.ops``),
its sequential oracle (``repro.kernels.ref``) and the associative scan
the reference's model runs (``repro.models.mamba``); the Mamba block
(prefill, then recurrent decode steps) against ``repro.models.mamba``;
and the sliding-window banded attention against
``repro.models.layers.local_banded_attention``.

Inputs come from a seeded numpy generator and reach both packages as the
same values. Tolerances: the scan in float32 within 1e-4 absolute (that
of ``tests/test_kernels.py``'s scan tests; the two sum the state in
another order); with bfloat16 ``u``, ``y`` within one bfloat16 step
(2e-2 absolute and relative, as ``tests/test_kernels.py`` holds bf16
kernels) and the float32 state within 1e-4. The float32 Mamba block
within 1e-4 absolute / 1e-5 relative; in bfloat16, where the reference's
conv sum and ``x_proj`` product round at other places than eager
PyTorch, within 0.125 absolute + 1e-2 relative (the served models'
tolerance in ``tests/test_torch_models.py``). Attention: 2e-5 in
float32, 2e-2 in bfloat16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models import mamba as jmamba
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.kernels import selective_scan as K6
from repro_torch.models import layers
from repro_torch.models import mamba

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SCAN_TOL = {"float32": dict(atol=1e-4, rtol=0),
            "bfloat16": dict(atol=2e-2, rtol=2e-2)}
BLOCK_TOL = {"float32": dict(atol=1e-4, rtol=1e-5),
             "bfloat16": dict(atol=0.125, rtol=1e-2)}


def _scan_inputs(bt, s, di, n, dtype, seed):
    """u (in ``dtype``), dt, A, B, C, D as the reference's scan tests draw
    them, once as numpy float32."""
    rng = np.random.default_rng(seed)
    f = np.float32
    u = (rng.standard_normal((bt, s, di)) * 0.5).astype(f)
    dt = (np.log1p(np.exp(rng.standard_normal((bt, s, di)))) * 0.1).astype(f)
    A = (-np.exp(rng.standard_normal((di, n)) * 0.3)).astype(f)
    B = rng.standard_normal((bt, s, n)).astype(f)
    C = rng.standard_normal((bt, s, n)).astype(f)
    D = (1.0 + 0.1 * rng.standard_normal(di)).astype(f)
    jdt, tdt = DTYPES[dtype]
    jx = [jnp.asarray(u).astype(jdt)] + [jnp.asarray(a)
                                         for a in (dt, A, B, C, D)]
    tx = [torch.tensor(u).to(tdt)] + [torch.tensor(a)
                                      for a in (dt, A, B, C, D)]
    return jx, tx


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


# (bt, s, di, n, Pallas block): the three of tests/test_kernels.py, a di
# that is no multiple of anything, one step
SCAN_SHAPES = [(2, 64, 96, 16, 32), (1, 128, 64, 8, 64), (3, 37, 48, 16, 16),
               (2, 40, 50, 16, 256), (3, 1, 48, 8, 16)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bt,s,di,n,bd", SCAN_SHAPES)
def test_selective_scan_plain_matches_the_reference_scans(bt, s, di, n, bd,
                                                          dtype):
    jx, tx = _scan_inputs(bt, s, di, n, dtype, seed=bt * s + di)
    y, h = ops.selective_scan(*tx)
    assert y.dtype == tx[0].dtype and h.dtype == torch.float32
    assert tuple(y.shape) == (bt, s, di) and tuple(h.shape) == (bt, di, n)
    kernel = jops.selective_scan(*jx, bd=bd)
    for name, (jy, jh) in (("pallas", kernel),
                           ("ref", jref.selective_scan_ref(*jx)),
                           ("assoc", jmamba.selective_scan_ref(*jx))):
        assert jy.dtype == jx[0].dtype, name
        _close(y, jy, SCAN_TOL[dtype])
        _close(h, jh, SCAN_TOL["float32"])


def test_selective_scan_takes_slices_of_a_projection():
    """B and C come from ``x_proj``'s output as strided slices; the op
    gives what it gives on contiguous copies."""
    _, (u, dt, A, B, C, D) = _scan_inputs(2, 9, 24, 8, "float32", seed=3)
    proj = torch.cat([torch.randn(2, 9, 5), B, C], -1)
    b_, c_ = proj[..., 5:13], proj[..., 13:]
    assert not b_.is_contiguous()
    y, h = ops.selective_scan(u, dt, A, b_, c_, D)
    y2, h2 = K6.plain(u, dt, A, B, C, D)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert K6.plain is ref.selective_scan_ref


# ------------------------------------------------------- Mamba block ----
def _host(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
        else np.asarray(a), tree)


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba_block_prefill_and_decode_match_reference(dtype, quant):
    """``mamba_block`` at ``reduced(falcon-mamba-7b)``: the prefill output
    with its ``conv``/``h`` cache, then three recurrent decode steps
    that update the cache in place."""
    jcfg = dataclasses.replace(jreduced(jget_config("falcon-mamba-7b")),
                               dtype=dtype, quant=quant)
    cfg = dataclasses.replace(reduced(get_config("falcon-mamba-7b")),
                              dtype=dtype, quant=quant)
    jp = jmamba.init_mamba(jax.random.PRNGKey(2), jcfg)
    p = convert.model_params({"segments": [], "ssm": _host(jp)}, cfg,
                             device="cpu")["ssm"]
    rng = np.random.default_rng(4)
    jdt, tdt = DTYPES[dtype]
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    jy, jc = jmamba.mamba_block(jp, jnp.asarray(x).astype(jdt), jcfg)
    with torch.inference_mode():
        y, c = mamba.mamba_block(p, torch.tensor(x).to(tdt), cfg)
        c = {k: v.clone() for k, v in c.items()}
    tol = BLOCK_TOL[dtype]
    _close(y, jy, tol)
    _close(c["conv"], jc["conv"], tol)
    _close(c["h"], jc["h"], tol)
    assert c["h"].dtype == torch.float32 and c["conv"].dtype == tdt
    jstep = jax.jit(lambda pp, xx, cc: jmamba.mamba_block(pp, xx, jcfg,
                                                          cache=cc))
    for i in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jc = jstep(jp, jnp.asarray(xt).astype(jdt), jc)
        with torch.inference_mode():
            h_buf = c["h"]
            y, c2 = mamba.mamba_block(p, torch.tensor(xt).to(tdt), cfg,
                                      cache=c)
        assert c2 is c and c["h"] is h_buf          # updated in place
        _close(y, jy, tol)
        _close(c["conv"], jc["conv"], tol)
        _close(c["h"], jc["h"], tol)


def test_causal_conv1d_carries_its_window():
    """The conv over a whole sequence equals the conv over two halves with
    the first half's window carried (float32: exact)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 11, 6), generator=g)
    w, b = torch.randn((4, 6), generator=g), torch.randn(6, generator=g)
    y, st = mamba.causal_conv1d(x, w, b)
    y1, st1 = mamba.causal_conv1d(x[:, :7], w, b)
    y2, st2 = mamba.causal_conv1d(x[:, 7:], w, b, state=st1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(st2, st)
    assert torch.equal(st, x[:, -3:])


# ------------------------------------------ sliding-window attention ----
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s,h,kv,hd,window", [
    (2, 100, 4, 2, 64, 64),          # the reduced Hymba layout
    (1, 3 * 16 + 5, 5, 5, 16, 16),   # S = 3 windows + 5
    (2, 40, 6, 3, 32, 40),           # S == window: one block
])
def test_local_banded_attention_matches_reference(dtype, b, s, h, kv, hd,
                                                  window):
    rng = np.random.default_rng(s + h)
    jdt, tdt = DTYPES[dtype]
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))]
    got = layers.local_banded_attention(*(torch.tensor(a).to(tdt)
                                          for a in arrs), window=window)
    want = jlayers.local_banded_attention(*(jnp.asarray(a).astype(jdt)
                                            for a in arrs), window=window)
    tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]
    _close(got, want, dict(atol=tol, rtol=tol))
    # with a logit soft-cap (the reference's jnp band at the same cap)
    got = layers.local_banded_attention(*(torch.tensor(a).to(tdt)
                                          for a in arrs), window=window,
                                        softcap=30.0)
    want = jlayers.local_banded_attention(*(jnp.asarray(a).astype(jdt)
                                            for a in arrs), window=window,
                                          softcap=30.0)
    _close(got, want, dict(atol=tol, rtol=tol))
