"""The served model's kernels (K3 flash attention, K4 decode attention,
K5 int8 matmul) in the port against the JAX package, on the CPU: the
port's plain versions (what a CPU tensor takes through
``repro_torch.kernels.ops``) against the reference's Pallas kernels in
interpret mode (``repro.kernels.ops``) and its jnp oracles
(``repro.kernels.ref``), at the shape sweep of ``tests/test_kernels.py``.

Inputs come from a seeded numpy generator and reach both packages as the
same values (bfloat16 inputs are the same float32 values rounded the
same way). Tolerances are those of ``tests/test_kernels.py``: 2e-5 in
float32, 2e-2 in bfloat16; the int8 product is exact on both sides, so
it is compared bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels import ops, ref
from repro_torch.models import layers

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(rng, shapes, dtype):
    """The same normal draws as a JAX array and a torch tensor of
    ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.tensor(a).to(tdt) for a in arrs])


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,sq,skv,h,kv,hd,causal,window", [
    (2, 128, 128, 8, 2, 64, True, 0),
    (1, 100, 100, 4, 4, 32, True, 48),     # ragged + sliding window
    (2, 64, 192, 6, 3, 128, False, 0),     # cross attention
    (1, 256, 256, 2, 1, 256, True, 0),     # MQA, big head
    (3, 33, 65, 5, 5, 16, True, 0),        # odd everything
])
def test_flash_attention_plain_matches_reference(dtype, b, sq, skv, h, kv,
                                                 hd, causal, window):
    rng = np.random.default_rng(sq * 7 + skv)
    (jq, jk, jv), (q, k, v) = _inputs(
        rng, [(b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd)], dtype)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, jops.flash_attention(jq, jk, jv, causal=causal,
                                     window=window, bq=32, bk=32), dtype)
    _close(got, jref.attention_ref(jq, jk, jv, causal=causal,
                                   window=window), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,h,kv,hd,s,window,bk", [
    (3, 8, 2, 64, 300, 64, 128),
    (1, 16, 16, 128, 1024, 0, 256),
    (2, 4, 1, 32, 96, 0, 32),
])
def test_decode_attention_plain_matches_reference(dtype, b, h, kv, hd, s,
                                                  window, bk):
    rng = np.random.default_rng(s + h)
    (jq, jkc, jvc), (q, kc, vc) = _inputs(
        rng, [(b, h, hd), (b, s, kv, hd), (b, s, kv, hd)], dtype)
    kv_pos = np.tile(np.arange(s)[None], (b, 1))
    kv_pos[:, s // 2:] = -1                          # a half-written ring
    cur = rng.integers(1, s // 2, b)
    got = ops.decode_attention(q, kc, vc, torch.tensor(kv_pos),
                               torch.tensor(cur), window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, jops.decode_attention(jq, jkc, jvc, jnp.asarray(kv_pos),
                                      jnp.asarray(cur), window=window,
                                      bk=bk), dtype)
    valid = (kv_pos >= 0) & (kv_pos <= cur[:, None])
    if window:
        valid &= kv_pos > cur[:, None] - window
    bias = np.where(valid, 0.0, -1e30).astype(np.float32)
    _close(got, jref.decode_attention_ref(jq, jkc, jvc, jnp.asarray(bias)),
           dtype)


@pytest.mark.parametrize("m,k,n,bm", [(100, 200, 300, 64),
                                      (128, 128, 128, 128),
                                      (17, 333, 65, 32)])
def test_int8_matmul_plain_is_bit_exact(m, k, n, bm):
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    jxq, jsx = jref.quantize_ref(jnp.asarray(x))
    jwq, jsw = jref.quantize_ref(jnp.asarray(w), axis=0)
    xq, sx = ref.quantize_ref(torch.tensor(x))
    wq, sw = ref.quantize_ref(torch.tensor(w), dim=0)
    for a, b_ in ((xq, jxq), (sx, jsx), (wq, jwq), (sw, jsw)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))
    got = ops.int8_matmul(xq, sx, wq, sw)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jref.int8_matmul_ref(jxq, jsx, jwq, jsw)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jops.int8_matmul(jxq, jsx, jwq, jsw, bm=bm, bn=64, bk=64)))


@pytest.mark.parametrize("shape,quant", [((3, 5, 256), "int8"),
                                         ((2, 7, 64), "int8"),
                                         ((4, 256), "none")])
def test_linear_matches_reference_in_float32(shape, quant):
    """``layers.linear`` on the reference's own weights: the int8 branch
    (per-token quantization, K5, dequant) bit for bit in float32."""
    import jax
    d_in, d_out = shape[-1], 96
    jp = jlayers.init_linear(jax.random.PRNGKey(d_in), d_in, d_out,
                             jnp.float32, quant)
    p = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    x[..., 0] = 0.0                       # ties at zero round the same way
    got = layers.linear(p, torch.tensor(x))
    want = np.asarray(jlayers.linear(jp, jnp.asarray(x)))
    assert got.dtype == torch.float32
    if quant == "int8":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_ops_refuse_a_device_without_a_path():
    """A tensor on neither the CPU nor a CUDA device has no kernel and no
    plain version to fall back to: every serving op raises."""
    meta = dict(device="meta")
    q = torch.empty((1, 4, 2, 32), **meta)
    with pytest.raises(ValueError, match="no fused op path"):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no fused op path"):
        ops.decode_attention(q[:, 0], q, q,
                             torch.zeros((1, 4), dtype=torch.long, **meta),
                             torch.zeros(1, dtype=torch.long, **meta))
    with pytest.raises(ValueError, match="no fused op path"):
        ops.int8_matmul(torch.empty((2, 3), dtype=torch.int8, **meta),
                        torch.empty((2, 1), **meta),
                        torch.empty((3, 4), dtype=torch.int8, **meta),
                        torch.empty((1, 4), **meta))
