"""The port's encoder-decoder served model (``repro_torch.models`` at
``whisper-medium``) against the JAX package's (``repro.models``), on
the CPU: the config field for field, the variant ladder, the encoder
alone, prefill (tokens cross-attending the encoded stub frames) and
three decode steps on the reference's own weights
(``convert.model_params``), every cache entry (the self K/V and the
cross K/V ``ck``/``cv``) at every step, and decode after a prefill
against the full prefill.

The cut is ``reduced(..., n_layers=2)`` (2 encoder + 2 decoder layers,
d_model 256, enc_seq 32) with Whisper's MHA restored: 4 q and 4 kv
heads of 64 (``reduced`` halves the kv heads). One case runs 37 frames
and a 19-token prompt, so neither length is a multiple of a tile, of a
chunk or of the other.

Tolerances: those of ``tests/test_torch_dense_models.py`` (``TOL``):
float32 within 1e-4 absolute / 1e-5 relative, bfloat16 within 0.125
absolute + 1e-2 relative. The int8 variant (d4) quantizes each
token's activations before every linear, so in float32 a value within
an ulp of an int8 rounding boundary may round to the next step in one
package and not in the other (the two agree to ~1e-6 in float32 before
the rounding); one such step moves the logits by ~1e-2. The d4 cut's
prefill meets one (at seed 1: one row of the second layer's self K/V
5e-3 apart, the cross K/V within 1e-6; seeds 2-4 miss the float32
tolerance too), so the d4 prefill and decode are held in bfloat16,
whose tolerance covers one step, as the dense tests hold Gemma3's and
PaliGemma's d4; d4's encoder alone is held in both types.
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
from repro.models.variants import build_ladder as jbuild_ladder
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch.serve import build_engines
from repro_torch.models import build_model
from repro_torch.models import transformer as T
from repro_torch.models.variants import build_ladder

ARCH = "whisper-medium"
TOL = {"float32": dict(atol=1e-4, rtol=1e-5),
       "bfloat16": dict(atol=0.125, rtol=1e-2)}


def _mha(cfg):
    """Whisper's MHA restored on a ``reduced`` cut: as many kv heads as
    q heads, head_dim 64."""
    return dataclasses.replace(cfg, n_kv_heads=cfg.n_heads, head_dim=64)


def _cuts(enc_seq=32):
    """(reference cut, port cut): 2 encoder + 2 decoder layers."""
    return (dataclasses.replace(_mha(jreduced(jget_config(ARCH))),
                                enc_seq=enc_seq),
            dataclasses.replace(_mha(reduced(get_config(ARCH))),
                                enc_seq=enc_seq))


def _host(tree):
    """A JAX pytree as numpy, bfloat16 leaves upcast to float32 (exact)."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
        else np.asarray(a), tree)


def _pair(vid, dtype, enc_seq=32, seed=1):
    """(JAX model, JAX params, port model, port params) of one variant of
    the cut."""
    jcut, cut = _cuts(enc_seq)
    jcfg = dataclasses.replace(jbuild_ladder(jcut)[vid].cfg, dtype=dtype)
    cfg = dataclasses.replace(build_ladder(cut)[vid].cfg, dtype=dtype)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, build_model(cfg), convert.model_params(_host(jp), cfg,
                                                          device="cpu")


def _batches(cfg, toks, seed=3):
    """The same batch for both packages: the tokens and the stub
    frontend's frame embeddings (B, enc_seq, d_model) drawn from
    ``seed``."""
    frames = np.random.default_rng(seed).standard_normal(
        (toks.shape[0], cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
            {"tokens": torch.tensor(toks), "frames": torch.tensor(frames)})


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol,
                               err_msg=msg)


# ------------------------------------------------------------- configs ----
def test_config_equals_the_reference_field_for_field():
    got, want = get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert dataclasses.asdict(reduced(got)) == \
        dataclasses.asdict(jreduced(want))
    T.check_supported(got)
    T.check_kernel_shapes(got)


def test_published_sizes():
    """Whisper-medium as configured: 24 + 24 layers, d_model 1,024, 16/16
    heads of 64, d_ff 4,096 GELU, vocab 51,865 padded to 51,968, untied;
    811,197,440 parameters by ``param_count()``."""
    c = get_config(ARCH)
    assert (c.arch_type, c.n_layers, c.n_enc_layers, c.d_model, c.n_heads,
            c.n_kv_heads, c.resolved_head_dim, c.d_ff, c.mlp_act,
            c.vocab_size, c.padded_vocab, c.tie_embeddings, c.enc_seq) == \
        ("audio", 24, 24, 1024, 16, 16, 64, 4096, "gelu", 51_865, 51_968,
         False, 1500)
    assert c.is_encdec and c.param_count() == 811_197_440


@pytest.mark.parametrize("vid", ["d0", "d4"])
def test_held_params_are_param_count_and_the_encoders_final_norm(vid):
    """The model holds ``param_count()`` weights plus d_model: the
    count leaves out the encoder's final norm (an int8 variant's
    per-column scales aside), as the reference's does."""
    _, cut = _cuts()
    cfg = build_ladder(dataclasses.replace(cut, n_layers=3,
                                           n_enc_layers=4))[vid].cfg
    p = build_model(cfg).init(0, device="cpu")
    leaves = []

    def walk(t, name=None):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, k)
        elif isinstance(t, list):
            for v in t:
                walk(v, name)
        elif name != "s":
            leaves.append(t.numel())
    walk(p)
    assert sum(leaves) == cfg.param_count() + cfg.d_model
    assert len(p["encoder"]["segments"][0]) == 4
    assert len(p["segments"][0]) == 3
    assert all({"cross", "ln_cross"} <= set(layer)
               for layer in p["segments"][0])
    assert not any("cross" in layer for layer in p["encoder"]["segments"][0])


@pytest.mark.parametrize("vid", [f"d{i}" for i in range(8)])
def test_build_ladder_matches_reference(vid):
    got = build_ladder(get_config(ARCH))[vid]
    want = jbuild_ladder(jget_config(ARCH))[vid]
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)
    assert got.million_macs == want.million_macs
    assert (got.top1, got.top5, got.dtype_tag) == \
        (want.top1, want.top5, want.dtype_tag)


@pytest.mark.parametrize("vid", ["d0", "d4"])
def test_converted_params_keep_the_reference_layout(vid):
    """The encoder's layers, its final norm and the decoder's cross
    blocks come across with the reference's values; the port's own init
    has the same layout, types and strides."""
    jm, jp, m, p = _pair(vid, "bfloat16")
    want = _host(jp)
    np.testing.assert_array_equal(p["encoder"]["final_norm"]["g"].numpy(),
                                  want["encoder"]["final_norm"]["g"])
    key = "w_q" if m.cfg.quant == "int8" else "w"
    for i in range(2):
        np.testing.assert_array_equal(
            p["encoder"]["segments"][0][i]["attn"]["wq"][key].float()
            .numpy(), want["encoder"]["segments"][0]["attn"]["wq"][key][i])
        np.testing.assert_array_equal(
            p["segments"][0][i]["cross"]["wk"][key].float().numpy(),
            want["segments"][0]["cross"]["wk"][key][i])
        np.testing.assert_array_equal(
            p["segments"][0][i]["ln_cross"]["g"].numpy(),
            want["segments"][0]["ln_cross"]["g"][i])
    own = m.init(0, device="cpu")
    spec = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: (tuple(x.shape), x.dtype, x.stride()), t)
    assert spec(own) == spec(p)


# ------------------------------------------------------------- encoder ----
@pytest.mark.parametrize("vid", ["d0", "d4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("enc_seq", [32, 37])
def test_encoder_matches_reference(vid, dtype, enc_seq):
    """``_encode`` alone: the frames cast to the model's type, two
    non-causal layers and the final norm."""
    jm, jp, m, p = _pair(vid, dtype, enc_seq)
    frames = np.random.default_rng(enc_seq).standard_normal(
        (2, enc_seq, m.cfg.d_model)).astype(np.float32)
    want = jax.jit(jm._encode)(jp, jnp.asarray(frames))
    with torch.inference_mode():
        got = m._encode(p, torch.tensor(frames))
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (2, enc_seq, m.cfg.d_model)
    _close(got, want, TOL[dtype])


# -------------------------------------------------- prefill and decode ----
def _run_both(vid, dtype, s, steps, max_len, enc_seq=32):
    """Prefill ``s`` tokens against ``enc_seq`` frames and ``steps``
    greedy decode steps on both packages, comparing the logits and every
    cache entry at each step. Returns the port's model and cache."""
    jm, jp, m, p = _pair(vid, dtype, enc_seq)
    vocab = m.cfg.vocab_size
    toks = np.random.default_rng(s).integers(0, vocab, (2, s)).astype(
        np.int32)
    jb, b = _batches(m.cfg, toks)
    jlog, jcache = jax.jit(lambda pp, bb: jm.prefill(pp, bb,
                                                     max_len=max_len))(jp, jb)
    with torch.inference_mode():
        log, cache = m.prefill(p, b, max_len=max_len)
    jdecode = jax.jit(jm.decode)
    tol = TOL[dtype]
    for step in range(steps + 1):
        _close(log, jlog, tol, f"logits, step {step}")
        for i, (seg, jseg) in enumerate(zip(cache["segments"],
                                            jcache["segments"])):
            assert set(seg) == set(jseg) == {"k", "v", "ck", "cv"}
            for name in seg:
                _close(seg[name], jseg[name], tol,
                       f"segment {i} {name}, step {step}")
        if step == steps:
            break
        cur = np.asarray(jnp.argmax(jlog[:, -1:, :vocab], -1), np.int32)
        jlog, jcache = jdecode(jp, jcache, jnp.asarray(cur))
        with torch.inference_mode():
            log, cache = m.decode(p, cache, torch.tensor(cur))
    assert cache["pos"] == int(jcache["pos"])
    return m, cache


@pytest.mark.parametrize("vid,dtype", [("d0", "float32"), ("d0", "bfloat16"),
                                       ("d4", "bfloat16")])
def test_prefill_and_decode_match_reference(vid, dtype):
    """A 20-token prompt against 32 frames into 32 slots, then three
    decode steps: the self cache written at slots 20-22, the cross cache
    (2 layers x 2 x 32 frames x 4 heads x 64) read and left as it
    was."""
    m, cache = _run_both(vid, dtype, 20, 3, 32)
    assert cache["pos"] == 23
    (seg,) = cache["segments"]
    assert tuple(seg["k"].shape) == (2, 2, 32, 4, 64)
    assert tuple(seg["ck"].shape) == (2, 2, 32, 4, 64)


@pytest.mark.parametrize("vid,dtype", [("d0", "float32"), ("d4", "bfloat16")])
def test_ragged_frames_and_prompt_match_reference(vid, dtype):
    """37 frames and a 19-token prompt into 29 slots: no length a
    multiple of a tile, a chunk or another."""
    m, cache = _run_both(vid, dtype, 19, 3, 29, enc_seq=37)
    assert tuple(cache["segments"][0]["cv"].shape) == (2, 2, 37, 4, 64)


def test_decode_after_prefill_equals_the_full_prefill():
    """decode(t | prefill(t[:-1])) == prefill(t) within 2e-3 relative, as
    ``tests/test_archs_smoke.py`` holds the reference (float32, 2 x 40
    tokens, the same frames)."""
    _, cut = _cuts()
    cfg = dataclasses.replace(cut, dtype="float32")
    m = build_model(cfg)
    p = m.init(0, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (2, 40)).astype(np.int32)
    _, full_b = _batches(cfg, toks)
    _, part_b = _batches(cfg, toks[:, :-1])
    with torch.inference_mode():
        full, _ = m.prefill(p, full_b, max_len=48)
        _, cache = m.prefill(p, part_b, max_len=48)
        dec, _ = m.decode(p, cache, torch.tensor(toks[:, -1:]))
    rel = float((full - dec).abs().max()) / float(full.abs().max())
    assert rel < 2e-3, rel


def test_prefill_needs_its_frames_and_engines_refuse_it():
    """An encoder-decoder's prefill reads ``batch["frames"]``, as the
    reference's does; a tokens-only batch raises, and so does
    ``build_engines``, whose requests carry tokens only (the reference's
    engine passes tokens only too)."""
    _, cut = _cuts()
    m = build_model(cut)
    p = m.init(0, device="cpu")
    with pytest.raises(KeyError, match="frames"):
        m.prefill(p, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    with pytest.raises(ValueError, match="encoder-decoder"):
        build_engines(cut, device="cpu")
    with pytest.raises(ValueError, match="Model.prefill"):
        build_engines(get_config(ARCH), device="cpu")
