"""K3 (flash attention) and K4 (decode attention) at head_dim 128 and 256,
the head dims of InternLM2, Yi, DBRX, Gemma, Gemma3 and PaliGemma: the
port's plain versions (what a CPU tensor takes through
``repro_torch.kernels.ops``) against the reference's Pallas kernels in
interpret mode (``repro.kernels.ops``) and its jnp oracles
(``repro.kernels.ref``), causal, windowed and with GQA groups of 1, 2
and 6-8; and the wrappers' limits on the head dims and groups they
launch.

Inputs come from a seeded numpy generator and reach both packages as the
same values. Tolerances are those of ``tests/test_kernels.py``: 2e-5 in
float32, 2e-2 in bfloat16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention, flash_attention, ops

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
@pytest.mark.parametrize("b,s,h,kv,hd,window", [
    (2, 96, 6, 1, 128, 0),       # InternLM2 / DBRX: G = 6
    (1, 80, 7, 1, 128, 0),       # Yi: G = 7, a partial block
    (1, 130, 4, 2, 128, 48),     # window < one block
    (2, 64, 2, 2, 256, 0),       # Gemma-7B: MHA
    (1, 160, 4, 2, 256, 64),     # Gemma3's sliding layers: G = 2, window
    (1, 96, 8, 1, 256, 0),       # PaliGemma: G = 8
])
def test_flash_attention_plain_matches_reference(dtype, b, s, h, kv, hd,
                                                 window):
    rng = np.random.default_rng(s * 3 + hd + h)
    (jq, jk, jv), (q, k, v) = _inputs(
        rng, [(b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)], dtype)
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, jops.flash_attention(jq, jk, jv, causal=True,
                                     window=window, bq=32, bk=32), dtype)
    _close(got, jref.attention_ref(jq, jk, jv, causal=True,
                                   window=window), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,h,kv,hd,s,window,bk", [
    (2, 12, 2, 128, 200, 0, 64),     # G = 6
    (1, 7, 1, 128, 130, 0, 64),      # G = 7
    (2, 4, 2, 256, 160, 64, 32),     # Gemma3's ring: G = 2, window
    (2, 2, 2, 256, 96, 0, 32),       # G = 1
    (1, 8, 1, 256, 128, 0, 64),      # G = 8 x 256 = 2,048
])
def test_decode_attention_plain_matches_reference(dtype, b, h, kv, hd, s,
                                                  window, bk):
    rng = np.random.default_rng(s + h + hd)
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


@pytest.mark.parametrize("hd", [48, 96, 512])
def test_the_wrappers_refuse_head_dims_without_an_instance(hd):
    """16, 32, 64, 128 and 256 have instances; any other head_dim raises
    in the wrapper before it reaches the card (the check comes before
    the device check, so a CPU tensor shows it)."""
    assert flash_attention.HEAD_DIMS == decode_attention.HEAD_DIMS == \
        (16, 32, 64, 128, 256)
    q = torch.zeros((1, 4, 2, hd))
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention.decode_attention_cuda(q[:, 0], q, q,
                                               torch.zeros((1, 4)))


@pytest.mark.parametrize("g,hd,ok", [(8, 256, True), (16, 128, True),
                                     (16, 256, False), (17, 64, False)])
def test_decode_group_limits(g, hd, ok):
    """K4 holds G q heads of a kv head in one block: G <= 16 and G x
    head_dim <= 2,048 (PaliGemma's 8 x 256 fits, 16 x 256 does not);
    the shared memory of the plan's span stays within 48 KB."""
    q = torch.zeros((1, g, hd))
    kc = torch.zeros((1, 64, 1, hd))
    if ok:
        # the limits pass: only the device check is left
        with pytest.raises(ValueError, match="CUDA"):
            decode_attention.decode_attention_cuda(q, kc, kc,
                                                   torch.zeros((1, 64)))
        _, span = decode_attention.split_plan(1, 1, 2064, g)
        floats = max(g * span, 4 * g * hd) + 2 * g
        assert 4 * floats <= 48 * 1024
    else:
        with pytest.raises(ValueError, match="G\\*hd"):
            decode_attention.decode_attention_cuda(q, kc, kc,
                                                   torch.zeros((1, 64)))
