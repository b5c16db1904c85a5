"""The int8 K/V cache at decode (``transformer.quantized_write``, read by
``layer_decode``) against the reference's ``Model.decode`` over the same
int8 cache (``repro/models/transformer.py`` ``layer_decode``), on the
CPU, at ``reduced`` cuts of a dense config with a sliding window
(Gemma3: a windowed and a global layer, the prompt past the 64-slot
window so the ring wraps), the hybrid (Hymba) and the encoder-decoder
(Whisper). Both packages run the reference's own weights
(``convert.model_params``) in float32 from one int8 cache: a prefill's
K/V quantized per (slot, kv head) by ``quantize``, the rule the
reference's decode applies to each new row (the reference builds no
int8 cache from a prefill). Then 8 greedy decode steps, compared after
each: the int8 entries equal (one step apart at most, where a row sits
on a rounding tie: the two packages' K and V differ in their last
float32 bits), the scales within rtol 1e-6, the logits within
``tests/test_torch_models.py``'s float32 tolerance (atol 1e-4, rtol
1e-5) and every other cache entry with them.
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
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import build_model
from repro_torch.models import transformer as T

TOL = dict(atol=1e-4, rtol=1e-5)
STEPS = 8
#: arch: (batch, prompt, cache length)
CASES = {"gemma3-4b": (2, 70, 80),       # window 64: the ring wraps
         "hymba-1.5b": (2, 20, 32),
         "whisper-medium": (2, 12, 24)}


def _host(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
        else np.asarray(a), tree)


def quantize(kv):
    """(int8 values, float32 scales) of a float32 K or V (..., hd): the
    reference decode's per-row rule, ``scale = (amax + 1e-8) / 127``,
    rounded half to even, clipped to +-127."""
    kv = np.asarray(kv, np.float32)
    scale = (np.abs(kv).max(-1) + np.float32(1e-8)) / np.float32(127.0)
    q = np.clip(np.round(kv / scale[..., None]), -127, 127)
    return q.astype(np.int8), scale.astype(np.float32)


def _int8_cache(jcache):
    """The prefill's cache with every ``k``/``v`` quantized: numpy leaves
    (k, v int8; k_s, v_s float32), the rest as they are."""
    segs = []
    for seg in jcache["segments"]:
        c = {}
        for name, leaf in seg.items():
            if name in ("k", "v"):
                c[name], c[name + "_s"] = quantize(leaf)
            else:
                c[name] = np.asarray(leaf)
        segs.append(c)
    return segs


def _batch(cfg, toks):
    b = {"tokens": toks}
    if cfg.is_encdec:
        b["frames"] = np.random.default_rng(5).standard_normal(
            (toks.shape[0], cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return b


@pytest.mark.parametrize("arch", list(CASES))
def test_int8_cache_decode_matches_the_reference(arch):
    batch, prompt, max_len = CASES[arch]
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), dtype="float32")
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    jm, m = jbuild_model(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(1))
    p = convert.model_params(_host(jp), cfg, device="cpu")
    toks = np.random.default_rng(prompt).integers(
        0, cfg.vocab_size, (batch, prompt)).astype(np.int32)
    nb = _batch(cfg, toks)
    jlog, jcache = jax.jit(lambda pp, bb: jm.prefill(pp, bb,
                                                     max_len=max_len))(
        jp, {k: jnp.asarray(v) for k, v in nb.items()})
    segs = _int8_cache(jcache)
    assert any("k_s" in s for s in segs)
    jcache = {"pos": jcache["pos"],
              "segments": [{k: jnp.asarray(v) for k, v in s.items()}
                           for s in segs]}
    cache = {"pos": prompt,
             "segments": [{k: torch.tensor(v) for k, v in s.items()}
                          for s in segs]}
    jdecode = jax.jit(jm.decode)
    flips = 0
    for step in range(STEPS):
        cur = np.asarray(jnp.argmax(jlog[:, -1:, :cfg.vocab_size], -1),
                         np.int32)
        jlog, jcache = jdecode(jp, jcache, jnp.asarray(cur))
        with torch.inference_mode():
            log, cache = m.decode(p, cache, torch.tensor(cur))
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL,
                                   err_msg=f"logits, step {step}")
        for i, (seg, jseg) in enumerate(zip(cache["segments"],
                                            jcache["segments"])):
            assert set(seg) == set(jseg)
            for name, leaf in seg.items():
                want = np.asarray(jseg[name])
                got = leaf.numpy()
                msg = f"segment {i} {name}, step {step}"
                if leaf.dtype == torch.int8:
                    diff = np.abs(got.astype(np.int32) - want)
                    assert diff.max() <= 1, msg
                    flips += int((diff > 0).sum())
                elif name in ("k_s", "v_s"):
                    np.testing.assert_allclose(got, want, rtol=1e-6,
                                               atol=0, err_msg=msg)
                else:
                    np.testing.assert_allclose(got, want, **TOL,
                                               err_msg=msg)
    assert cache["pos"] == int(jcache["pos"]) == prompt + STEPS
    # a rounding tie is rare: at most a few entries of the rows written
    assert flips <= 4


def test_quantized_write_is_the_reference_rule_in_place():
    """One row into an int8 ring: the values ``quantize`` gives, written
    at the slot with their scale, the rest untouched, and the whole
    cache read back dequantized in the row's dtype."""
    g = torch.Generator().manual_seed(0)
    cache = torch.randint(-127, 128, (2, 5, 3, 8), generator=g,
                          dtype=torch.int8)
    scales = torch.rand((2, 5, 3), generator=g)
    row = torch.randn((2, 1, 3, 8), generator=g, dtype=torch.float32) * 3
    before_c, before_s = cache.clone(), scales.clone()
    out = T.quantized_write(cache, scales, row, 4)
    want_q, want_s = quantize(row[:, 0].numpy())
    np.testing.assert_array_equal(cache[:, 4].numpy(), want_q)
    np.testing.assert_array_equal(scales[:, 4].numpy(), want_s)
    assert torch.equal(cache[:, :4], before_c[:, :4])
    assert torch.equal(scales[:, :4], before_s[:, :4])
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, cache.float() * scales[..., None],
                               rtol=0, atol=0)
    bf = T.quantized_write(cache, scales, row.bfloat16(), 0)
    assert bf.dtype == torch.bfloat16
