"""The port's served model (``repro_torch.models``) against the JAX
package's (``repro.models``), on the CPU, at the edge-ladder config the
system serves (4 layers, d_model 256, 8/4 heads of 32, vocab 8192): the
variant ladder, then prefill and three decode steps of d0 (bf16), d4
(int8) and d7 (int8 at width 0.25) on the reference's own weights,
carried across with ``convert.model_params``.

Tolerances: in float32 models (``dtype="float32"``) logits and caches
within 1e-4 absolute / 1e-5 relative (the two packages sum in another
order; the int8 branch is bit-exact, see
``tests/test_torch_serving_kernels.py``). In bfloat16, where the
reference rounds the attention probabilities to bfloat16 before the PV
product and the port's kernel does not, within one bfloat16 step of
the logits' scale (0.125 at |logit| <= 16) plus 1e-2 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models.variants import build_ladder as jbuild_ladder
from repro_torch import convert
from repro_torch.configs.base import get_config, scale_width
from repro_torch.configs.edge_ladder import ladder
from repro_torch.models import build_model
from repro_torch.models.variants import build_ladder

TOL = {"float32": dict(atol=1e-4, rtol=1e-5),
       "bfloat16": dict(atol=0.125, rtol=1e-2)}


def host(tree):
    """A JAX pytree as numpy, bfloat16 leaves upcast to float32 (exact)."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
        else np.asarray(a), tree)


def _pair(vid, dtype, seed=1):
    """(JAX model, JAX params, port model, port params) of one variant."""
    jcfg = dataclasses.replace(
        jbuild_ladder(jget_config("edge-ladder"))[vid].cfg, dtype=dtype)
    cfg = dataclasses.replace(
        build_ladder(get_config("edge-ladder"))[vid].cfg, dtype=dtype)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, build_model(cfg), convert.model_params(host(jp), cfg,
                                                          device="cpu")


# ------------------------------------------------------------- configs ----
def test_d7_is_a_quarter_width_int8_ladder_point():
    d7 = ladder()["d7"]
    assert (d7.n_heads, d7.n_kv_heads, d7.resolved_head_dim, d7.d_ff,
            d7.d_model, d7.quant) == (2, 2, 32, 256, 256, "int8")
    assert scale_width(get_config("edge-ladder"), 0.25, "int8") == d7


@pytest.mark.parametrize("vid", [f"d{i}" for i in range(8)])
def test_build_ladder_matches_reference(vid):
    got = build_ladder(get_config("edge-ladder"))[vid]
    want = jbuild_ladder(jget_config("edge-ladder"))[vid]
    for f in dataclasses.fields(want.cfg):
        assert getattr(got.cfg, f.name) == getattr(want.cfg, f.name), f.name
    assert got.million_macs == want.million_macs
    assert (got.top1, got.top5, got.dtype_tag) == \
        (want.top1, want.top5, want.dtype_tag)
    assert got.cfg.param_count() == want.cfg.param_count()


@pytest.mark.parametrize("vid", ["d0", "d4", "d7"])
def test_converted_params_have_the_reference_shapes(vid):
    jm, jp, m, p = _pair(vid, "bfloat16")
    cfg = m.cfg
    assert len(p["segments"]) == 1 and len(p["segments"][0]) == \
        cfg.n_layers
    layer = p["segments"][0][2]
    want = host(jp)["segments"][0]
    if cfg.quant == "int8":
        assert layer["attn"]["wq"]["w_q"].dtype == torch.int8
        np.testing.assert_array_equal(layer["attn"]["wq"]["w_q"].numpy(),
                                      want["attn"]["wq"]["w_q"][2])
        assert tuple(layer["mlp"]["w_down"]["s"].shape) == (1, cfg.d_model)
    else:
        assert layer["attn"]["wq"]["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            layer["attn"]["wq"]["w"].float().numpy(),
            want["attn"]["wq"]["w"][2])
    assert tuple(p["embed"]["w"].shape) == (cfg.padded_vocab, cfg.d_model)
    # the port's own init has the same layout
    own = m.init(0, device="cpu")
    assert jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype),
                                  own["segments"][0][0]) == \
        jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype),
                               layer)


# -------------------------------------------------- prefill and decode ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vid", ["d0", "d4", "d7"])
def test_prefill_and_decode_match_reference(vid, dtype):
    """Prefill logits and cache, then three greedy decode steps, the
    prompt longer than the cache (12 tokens into 8 ring slots) so the
    decode writes wrap."""
    jm, jp, m, p = _pair(vid, dtype)
    toks = np.random.default_rng(0).integers(0, 8192, (2, 12)).astype(
        np.int32)
    jlog, jcache = jax.jit(lambda pp, b: jm.prefill(pp, b, max_len=8))(
        jp, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        log, cache = m.prefill(p, {"tokens": torch.tensor(toks)}, max_len=8)
    assert cache["pos"] == int(jcache["pos"]) == 12
    jdecode = jax.jit(jm.decode)
    for step in range(4):
        np.testing.assert_allclose(log.float().numpy(),
                                   np.asarray(jlog, np.float32),
                                   **TOL[dtype], err_msg=f"step {step}")
        for name in ("k", "v"):
            np.testing.assert_allclose(
                cache["segments"][0][name].float().numpy(),
                np.asarray(jcache["segments"][0][name], np.float32),
                **TOL[dtype], err_msg=f"{name} cache, step {step}")
        if step == 3:
            break
        cur = np.asarray(jnp.argmax(jlog[:, -1:, :8192], -1), np.int32)
        jlog, jcache = jdecode(jp, jcache, jnp.asarray(cur))
        with torch.inference_mode():
            log, cache = m.decode(p, cache, torch.tensor(cur))
    assert cache["pos"] == int(jcache["pos"]) == 15


def test_ring_cache_slot_positions():
    """``_cache_from_prefill`` keeps the last min(S, Sc) positions in
    slots ``pos % Sc``; decode writes slot ``pos % Sc``; the rest of the
    buffer stays zero."""
    m = build_model(dataclasses.replace(ladder()["d0"], n_layers=1,
                                        dtype="float32"))
    lseg, b, s, kvh, hd = 1, 2, 11, 4, 32
    kv = torch.arange(s, dtype=torch.float32)[None, None, :, None, None] \
        .expand(lseg, b, s, kvh, hd)
    ring = m._cache_from_prefill([{"k": kv, "v": kv + 100}], s, 8)
    assert ring["pos"] == 11
    held = ring["segments"][0]["k"][0, 0, :, 0, 0]
    assert held.tolist() == [8, 9, 10, 3, 4, 5, 6, 7]       # pos % 8
    lin = m._cache_from_prefill([{"k": kv, "v": kv + 100}], s, 16)
    assert lin["segments"][0]["v"][0, 1, :, 0, 0].tolist() == \
        [100 + i for i in range(11)] + [0] * 5
    p = m.init(0, device="cpu")
    with torch.inference_mode():
        _, c2 = m.decode(p, ring, torch.zeros((b, 1), dtype=torch.int32))
    assert c2["pos"] == 12
    # slot 11 % 8 = 3 now holds position 11's key, not position 3's
    assert not torch.equal(c2["segments"][0]["k"][0, :, 3],
                           torch.full((b, kvh, hd), 3.0))
    assert torch.equal(c2["segments"][0]["k"][0, :, 4],
                       torch.full((b, kvh, hd), 4.0))


def test_other_families_name_the_roadmap_item():
    """Every family and config of the reference builds (Whisper's
    encoder-decoder too), its int8 KV cache decodes (the new row
    quantized into its slot; ``tests/test_torch_kv_int8.py`` holds it
    against the reference), and a family or a config the reference
    lacks raises naming what the port has."""
    with pytest.raises(NotImplementedError, match="families"):
        build_model(dataclasses.replace(get_config("edge-ladder"),
                                        arch_type="retnet"))
    with pytest.raises(KeyError, match="edge-ladder"):
        get_config("llama-3-8b")
    assert get_config("whisper-medium").arch_type == "audio"
    cfg = dataclasses.replace(get_config("edge-ladder"), n_layers=1,
                              dtype="float32")
    m = build_model(cfg)
    p = m.init(0, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with torch.inference_mode():
        _, cache = m.prefill(p, {"tokens": toks}, max_len=8)
        seg = cache["segments"][0]
        for name in ("k", "v"):
            seg[name + "_s"] = seg[name].new_ones(seg[name].shape[:-1])
            seg[name] = seg[name].to(torch.int8)
        _, cache = m.decode(p, cache, toks[:, :1])
    seg = cache["segments"][0]
    assert seg["k"].dtype == torch.int8 and cache["pos"] == 5
    assert seg["k"][:, :, 4].abs().amax(-1).eq(127).all()
