"""Logit soft-capping in the port's attention (``cfg.logit_softcap``):
each scaled score s becomes ``tanh(s / softcap) * softcap`` before the
mask and the bias, as ``repro/models/layers.py`` applies it in its jnp
attention cores. The Pallas kernels have no soft-cap, so the reference
here is the JAX package's jnp mirrors (``chunked_attention``,
``local_banded_attention``, ``decode_attention``), against the port's
layers on the CPU (the plain K3/K4 versions, ``ref.attention_ref``);
then a Gemma3 cut with the cap set against ``repro.models`` on the
same weights.

The inputs are drawn at 3x unit scale, so that the scores reach the
cap's bend: at a cap of 2 most scores are squeezed, at 50 (Gemma-2's
attention cap) the largest move by ~1e-2. Tolerances: float32 within
2e-5 and bfloat16 within 2e-2, absolute and relative (those of the
kernel tests, ``tests/test_kernels.py``); the model's those of
``tests/test_torch_dense_models.py`` (``TOL``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import decode_attention, flash_attention, ops, ref
from repro_torch.models import build_model, layers

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
TOL = {"float32": dict(atol=1e-4, rtol=1e-5),
       "bfloat16": dict(atol=0.125, rtol=1e-2)}
CAPS = (2.0, 50.0)


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [3.0 * rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrs, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.tensor(a).to(tdt) for a in arrs])


def _close(got, want, dtype):
    tol = ATOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# ------------------------------------------------------ attention cores ----
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("softcap", CAPS)
@pytest.mark.parametrize("b,sq,skv,h,kv,hd,causal,window", [
    (2, 33, 33, 4, 2, 64, True, 0),        # causal, S no tile multiple
    (2, 70, 70, 4, 4, 32, True, 24),       # a window
    (1, 19, 37, 4, 4, 64, False, 0),       # cross: Sq < Skv, no mask
    (2, 37, 37, 8, 2, 16, False, 0),       # an encoder's self-attention
])
def test_chunked_attention_matches_reference(dtype, softcap, b, sq, skv, h,
                                             kv, hd, causal, window):
    """The port's full-sequence core (K3's plain version) with the cap
    against the reference's ``chunked_attention`` at the same cap
    (causal cases at Sq = Skv, where the port's right-aligned q and the
    reference's q_offset 0 agree)."""
    jarrs, tarrs = _both(_draw(sq + skv, (b, sq, h, hd), (b, skv, kv, hd),
                               (b, skv, kv, hd)), dtype)
    got = layers.chunked_attention(*tarrs, causal=causal, window=window,
                                   softcap=softcap)
    want = jlayers.chunked_attention(*jarrs, causal=causal, window=window,
                                     chunk=16, softcap=softcap)
    _close(got, want, dtype)
    uncapped = jlayers.chunked_attention(*jarrs, causal=causal,
                                         window=window, chunk=16)
    assert np.abs(np.asarray(uncapped, np.float32)
                  - np.asarray(want, np.float32)).max() > 2 * ATOL[dtype]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("softcap", CAPS)
@pytest.mark.parametrize("b,s,h,kv,hd,window", [
    (2, 100, 4, 2, 64, 64),
    (1, 3 * 16 + 5, 5, 5, 16, 16),
])
def test_local_banded_attention_matches_reference(dtype, softcap, b, s, h,
                                                  kv, hd, window):
    jarrs, tarrs = _both(_draw(s + h, (b, s, h, hd), (b, s, kv, hd),
                               (b, s, kv, hd)), dtype)
    got = layers.local_banded_attention(*tarrs, window=window,
                                        softcap=softcap)
    want = jlayers.local_banded_attention(*jarrs, window=window,
                                          softcap=softcap)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("softcap", CAPS)
@pytest.mark.parametrize("b,h,kv,hd,s,window,ring", [
    (3, 8, 2, 64, 97, 0, False),           # a half-written cache
    (2, 4, 2, 32, 64, 40, True),           # a wrapped ring with a window
    (2, 16, 16, 64, 150, 0, False),        # a cross cache: every slot
])
def test_decode_attention_matches_reference(dtype, softcap, b, h, kv, hd, s,
                                            window, ring):
    """The port's decode core (K4's plain version, the cap before the
    bias) against the reference's ``decode_attention``."""
    q, kc, vc = _draw(s + h, (b, 1, h, hd), (b, s, kv, hd), (b, s, kv, hd))
    idx = np.arange(s)[None].repeat(b, 0)
    if ring:
        cur = np.full((b,), 3 * s + 5)
        kv_pos = cur[:, None] - (cur[:, None] - idx) % s
    elif kv == h:                                  # the cross cache
        cur = np.full((b,), s)
        kv_pos = idx
    else:
        cur = np.array([s // 2 - 1 - i for i in range(b)])
        kv_pos = np.where(idx < s // 2, idx, -1)
    (jq, jk, jv), (tq, tk, tv) = _both((q, kc, vc), dtype)
    got = layers.decode_attention(tq, tk, tv, torch.tensor(kv_pos),
                                  torch.tensor(cur), window=window,
                                  softcap=softcap)
    want = jlayers.decode_attention(jq, jk, jv, jnp.asarray(kv_pos),
                                    jnp.asarray(cur), window=window,
                                    softcap=softcap)
    _close(got, want, dtype)


def test_plain_versions_take_the_cap_before_the_bias():
    """K3's and K4's plain versions equal the uncapped ones at cap 0, and
    with a cap equal the scores capped by hand before the bias."""
    g = torch.Generator().manual_seed(0)
    q = 3 * torch.randn((2, 6, 4, 32), generator=g)
    k, v = (3 * torch.randn((2, 9, 2, 32), generator=g) for _ in range(2))
    assert torch.equal(flash_attention.plain(q, k, v, causal=False,
                                             softcap=0.0),
                       flash_attention.plain(q, k, v, causal=False))
    bias = torch.where(torch.rand((2, 9), generator=g) < 0.3, -1e30, 0.0)
    got = decode_attention.plain(q[:, 0], k, v, bias, 5.0)
    s = torch.einsum("bkgh,bskh->bkgs", q[:, 0].reshape(2, 2, 2, 32), k)
    s = torch.tanh(s / 32 ** 0.5 / 5.0) * 5.0 + bias[:, None, None]
    want = torch.einsum("bkgs,bskh->bkgh", torch.softmax(s, -1), v)
    torch.testing.assert_close(got, want.reshape(2, 4, 32), atol=2e-5,
                               rtol=2e-5)
    assert torch.equal(ops.flash_attention(q, k, v, causal=False,
                                           softcap=5.0),
                       ref.attention_ref(q, k, v, causal=False,
                                         softcap=5.0))


def test_kernel_wrappers_refuse_a_negative_cap():
    """A negative cap is no cap: the card's wrappers refuse it before a
    launch (their checks run first, so the CPU sees them too)."""
    q = torch.zeros((1, 4, 2, 64))
    with pytest.raises(ValueError, match="softcap"):
        flash_attention.flash_attention_cuda(q, q, q, softcap=-1.0)
    with pytest.raises(ValueError, match="softcap"):
        decode_attention.decode_attention_cuda(q[:, 0], q, q,
                                               torch.zeros((1, 4)),
                                               softcap=-1.0)


# --------------------------------------------------- a capped model ----
def _gemma3_pair(dtype, softcap, seed=1):
    """Gemma3's 6-layer cut (five sliding layers, window 64, and a global
    one; 4/2 heads of 256) with ``logit_softcap`` set: (JAX model, JAX
    params, port model, port params)."""
    def cut(c):
        return dataclasses.replace(c, n_heads=4, n_kv_heads=2, head_dim=256,
                                   logit_softcap=softcap, dtype=dtype)
    jcfg = cut(jreduced(jget_config("gemma3-4b"), n_layers=6))
    cfg = cut(reduced(get_config("gemma3-4b"), n_layers=6))
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    host = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
        else np.asarray(a), jp)
    return jm, jp, build_model(cfg), convert.model_params(host, cfg,
                                                          device="cpu")


def _capped_run(dtype, softcap, s=100, steps=3, max_len=108):
    """Prefill ``s`` tokens (past the 64-token window: the banded prefill
    and the global layer) and ``steps`` decode steps (the wrapped rings)
    on both packages; returns the logits of each step, port and
    reference."""
    jm, jp, m, p = _gemma3_pair(dtype, softcap)
    vocab = m.cfg.vocab_size
    toks = np.random.default_rng(s).integers(0, vocab, (2, s)).astype(
        np.int32)
    jlog, jcache = jax.jit(lambda pp, t: jm.prefill(
        pp, {"tokens": t}, max_len=max_len))(jp, jnp.asarray(toks))
    with torch.inference_mode():
        log, cache = m.prefill(p, {"tokens": torch.tensor(toks)},
                               max_len=max_len)
    jdecode = jax.jit(jm.decode)
    out = [(log.float().numpy(), np.asarray(jlog, np.float32))]
    for _ in range(steps):
        cur = np.asarray(jnp.argmax(jlog[:, -1:, :vocab], -1), np.int32)
        jlog, jcache = jdecode(jp, jcache, jnp.asarray(cur))
        with torch.inference_mode():
            log, cache = m.decode(p, cache, torch.tensor(cur))
        out.append((log.float().numpy(), np.asarray(jlog, np.float32)))
    assert [seg.is_global for seg in m.segments] == [False, True]
    assert cache["pos"] == s + steps
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma3_with_a_soft_cap_matches_reference(dtype):
    """Gemma3's cut with ``logit_softcap`` 50: prefill (banded and global
    K3 paths, capped) and three decode steps (K4 over the wrapped rings
    and the global cache, capped) against ``repro.models``; in float32
    the cap moves the logits by more than the tolerance, so a cap left
    out would fail."""
    for step, (got, want) in enumerate(_capped_run(dtype, 50.0)):
        np.testing.assert_allclose(got, want, **TOL[dtype],
                                   err_msg=f"logits, step {step}")
    if dtype == "float32":
        capped = _capped_run(dtype, 50.0, steps=0)[0][0]
        uncapped = _capped_run(dtype, 0.0, steps=0)[0][0]
        assert not np.allclose(capped, uncapped, **TOL[dtype])
