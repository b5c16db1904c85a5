"""The port's dense and VLM served models (``repro_torch.models`` at
``internlm2-20b``, ``yi-34b``, ``gemma-7b``, ``gemma3-4b`` and
``paligemma-3b``) against the JAX package's (``repro.models``), on the
CPU: the configs field for field, the variant ladders, prefill and
three decode steps on the reference's own weights
(``convert.model_params``), PaliGemma's image prefix, and decode after
a prefill against the full prefill.

The cuts keep each family's head dim and GQA group: ``reduced`` gives
2 layers at d_model 256 and head_dim d_model / n_heads = 64, so each
cut restores its head dim (128 or 256) and heads (``CUTS``) with
``dataclasses.replace``. Gemma3's cut keeps 6 layers, five sliding
(window 64) and the sixth global, and its prompts run past the window,
so both the banded prefill and the ring cache run. PaliGemma's keeps 8
image tokens.

Tolerances: those of ``tests/test_torch_models.py`` (``TOL``): float32
within 1e-4 absolute / 1e-5 relative, bfloat16 within 0.125 absolute +
1e-2 relative. An int8 variant (d4) quantizes each token's activations
before every linear, so in float32 a value that sits within an ulp of
an int8 rounding boundary may round to the next step in one package
and not in the other (the two agree to ~2e-6 in float32 before the
rounding); one such step moves the logits by ~1e-2. The d4 variants of
Gemma3's 6-layer cut and of PaliGemma's 8-head cut meet such a boundary
(logits 8e-3 / 1.4e-2 apart, against 2e-6 with the rounding left out,
in d0), so they are held in bfloat16, whose tolerance covers one step;
InternLM2's d4 is held in both types.
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

ARCHS = ("internlm2-20b", "yi-34b", "gemma-7b", "gemma3-4b", "paligemma-3b")
#: arch: (n_layers, n_heads, n_kv_heads, head_dim) of its cut
CUTS = {"internlm2-20b": (2, 6, 1, 128),      # G = 6, as 48 / 8
        "yi-34b": (2, 7, 1, 128),             # G = 7, as 56 / 8
        "gemma-7b": (2, 2, 2, 256),           # MHA, as 16 / 16
        "gemma3-4b": (6, 4, 2, 256),          # G = 2, as 8 / 4
        "paligemma-3b": (2, 8, 1, 256)}       # G = 8, as 8 / 1
TOL = {"float32": dict(atol=1e-4, rtol=1e-5),
       "bfloat16": dict(atol=0.125, rtol=1e-2)}


def _cut(cfg, arch):
    layers, h, kv, hd = CUTS[arch]
    return dataclasses.replace(cfg, n_heads=h, n_kv_heads=kv, head_dim=hd)


def _cuts(arch):
    """(reference cut, port cut) of ``arch``."""
    n = CUTS[arch][0]
    return (_cut(jreduced(jget_config(arch), n_layers=n), arch),
            _cut(reduced(get_config(arch), n_layers=n), arch))


def _host(tree):
    """A JAX pytree as numpy, bfloat16 leaves upcast to float32 (exact)."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
        else np.asarray(a), tree)


def _pair(arch, vid, dtype, seed=1):
    """(JAX model, JAX params, port model, port params) of one variant of
    ``arch``'s cut."""
    jcut, cut = _cuts(arch)
    jcfg = dataclasses.replace(jbuild_ladder(jcut)[vid].cfg, dtype=dtype)
    cfg = dataclasses.replace(build_ladder(cut)[vid].cfg, dtype=dtype)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, build_model(cfg), convert.model_params(_host(jp), cfg,
                                                          device="cpu")


def _batches(cfg, toks, seed=3):
    """The same batch for both packages: the tokens and, in a VLM, the
    stub frontend's image embeddings drawn from ``seed``."""
    jb, b = {"tokens": jnp.asarray(toks)}, {"tokens": torch.tensor(toks)}
    if cfg.arch_type == "vlm":
        img = np.random.default_rng(seed).standard_normal(
            (toks.shape[0], cfg.n_img_tokens, cfg.d_model)).astype(
                np.float32)
        jb["img_embeds"] = jnp.asarray(img)
        b["img_embeds"] = torch.tensor(img)
    return jb, b


# ------------------------------------------------------------- configs ----
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference_field_for_field(arch):
    got, want = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert dataclasses.asdict(reduced(got)) == \
        dataclasses.asdict(jreduced(want))
    T.check_supported(got)
    T.check_kernel_shapes(got)


def test_published_sizes():
    """The two configs the card serves whole, and the head dims of all
    five."""
    g3, il = get_config("gemma3-4b"), get_config("internlm2-20b")
    assert (g3.n_layers, g3.d_model, g3.n_heads, g3.n_kv_heads,
            g3.resolved_head_dim, g3.vocab_size, g3.sliding_window,
            g3.global_interval) == (34, 2560, 8, 4, 256, 262_144, 1024, 6)
    assert 3.85e9 < g3.param_count() < 3.9e9
    assert (il.n_layers, il.d_model, il.n_heads, il.n_kv_heads,
            il.resolved_head_dim, il.d_ff) == (48, 6144, 48, 8, 128, 16384)
    assert 19.8e9 < il.param_count() < 19.9e9
    assert [get_config(a).resolved_head_dim for a in ARCHS] == \
        [128, 128, 256, 256, 256]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("vid", [f"d{i}" for i in range(8)])
def test_build_ladder_matches_reference(arch, vid):
    got = build_ladder(get_config(arch))[vid]
    want = jbuild_ladder(jget_config(arch))[vid]
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)
    assert got.million_macs == want.million_macs
    assert (got.top1, got.top5, got.dtype_tag) == \
        (want.top1, want.top5, want.dtype_tag)


@pytest.mark.parametrize("arch,vid", [("internlm2-20b", "d4"),
                                      ("paligemma-3b", "d0")])
def test_converted_params_keep_the_reference_layout(arch, vid):
    """The untied head, the int8 linears (K-major) and PaliGemma's
    ``proj_img`` come across with the reference's values; the port's own
    init has the same layout, types and strides."""
    jm, jp, m, p = _pair(arch, vid, "bfloat16")
    want = _host(jp)
    if m.cfg.arch_type == "vlm":
        assert p["proj_img"]["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(p["proj_img"]["w"].float().numpy(),
                                      want["proj_img"]["w"])
    if not m.cfg.tie_embeddings:
        assert p["lm_head"]["w"].dtype == torch.bfloat16
    if m.cfg.quant == "int8":
        w_q = p["segments"][0][1]["attn"]["wq"]["w_q"]
        d, qd = m.cfg.d_model, m.cfg.q_dim
        assert w_q.dtype == torch.int8 and w_q.stride() == (1, d)
        assert tuple(w_q.shape) == (d, qd)
        np.testing.assert_array_equal(
            w_q.numpy(), want["segments"][0]["attn"]["wq"]["w_q"][1])
    own = m.init(0, device="cpu")
    spec = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: (tuple(x.shape), x.dtype, x.stride()), t)
    assert spec(own) == spec(p)


# -------------------------------------------------- prefill and decode ----
def _run_both(arch, vid, dtype, s, steps, max_len):
    """Prefill ``s`` tokens (behind the image prefix in a VLM) and
    ``steps`` greedy decode steps on both packages, comparing the logits
    and every cache entry at each step. Returns the port's model and
    cache."""
    jm, jp, m, p = _pair(arch, vid, dtype)
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
        np.testing.assert_allclose(log.float().numpy(),
                                   np.asarray(jlog, np.float32), **tol,
                                   err_msg=f"logits, step {step}")
        for i, (seg, jseg) in enumerate(zip(cache["segments"],
                                            jcache["segments"])):
            assert set(seg) == set(jseg) == {"k", "v"}
            for name in seg:
                np.testing.assert_allclose(
                    seg[name].float().numpy(),
                    np.asarray(jseg[name], np.float32), **tol,
                    err_msg=f"segment {i} {name}, step {step}")
        if step == steps:
            break
        cur = np.asarray(jnp.argmax(jlog[:, -1:, :vocab], -1), np.int32)
        jlog, jcache = jdecode(jp, jcache, jnp.asarray(cur))
        with torch.inference_mode():
            log, cache = m.decode(p, cache, torch.tensor(cur))
    assert cache["pos"] == int(jcache["pos"])
    return m, cache


@pytest.mark.parametrize("arch,vid,dtype", [
    (arch, vid, dtype) for arch, vid in (("internlm2-20b", "d0"),
                                         ("internlm2-20b", "d4"),
                                         ("yi-34b", "d0"),
                                         ("gemma-7b", "d0"),
                                         ("gemma3-4b", "d0"))
    for dtype in ("float32", "bfloat16")] + [("gemma3-4b", "d4", "bfloat16")])
def test_prefill_and_decode_match_reference(arch, vid, dtype):
    """A 20-token prompt into 32 slots and three decode steps: untied
    SwiGLU heads of 128 (InternLM2 d0 and d4, int8 through K5's plain
    path; Yi), tied GeGLU heads of 256 (Gemma-7B; Gemma3 d0 and d4, its
    five sliding layers' rings of 64 slots)."""
    m, cache = _run_both(arch, vid, dtype, 20, 3, 32)
    assert cache["pos"] == 23
    hd = m.cfg.resolved_head_dim
    assert [tuple(c["k"].shape[2:]) for c in cache["segments"]] == [
        (32 if seg.is_global else min(32, m.cfg.sliding_window),
         m.cfg.n_kv_heads, hd) for seg in m.segments]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma3_past_its_window_matches_reference(dtype):
    """Gemma3's cut with a 100-token prompt, past its 64-token window:
    the five sliding layers prefill through the banded path and their
    64-slot rings have wrapped; the global layer holds every position."""
    m, cache = _run_both("gemma3-4b", "d0", dtype, 100, 3, 108)
    assert cache["pos"] == 103
    assert [(seg.is_global, c["k"].shape[2]) for seg, c in
            zip(m.segments, cache["segments"])] == [(False, 64), (True, 108)]


@pytest.mark.parametrize("vid,dtype", [("d0", "float32"), ("d0", "bfloat16"),
                                       ("d4", "bfloat16")])
def test_paligemma_with_its_image_prefix_matches_reference(vid, dtype):
    """PaliGemma: 8 projected image embeddings in front of 20 text tokens,
    then three decode steps; positions and the cache count the prefix."""
    m, cache = _run_both("paligemma-3b", vid, dtype, 20, 3, 40)
    assert m.cfg.n_img_tokens == 8
    assert cache["pos"] == 8 + 20 + 3
    assert tuple(cache["segments"][0]["k"].shape) == (2, 2, 40, 1, 256)


def test_paligemma_prefill_needs_its_image_embeddings():
    """A VLM's prefill reads ``batch["img_embeds"]``, as the reference's
    does; a tokens-only batch raises, and so does ``build_engines``,
    whose requests carry tokens only."""
    _, cut = _cuts("paligemma-3b")
    m = build_model(cut)
    p = m.init(0, device="cpu")
    with pytest.raises(KeyError, match="img_embeds"):
        m.prefill(p, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    with pytest.raises(ValueError, match="Model.prefill"):
        build_engines(cut, device="cpu")


@pytest.mark.parametrize("arch", ["gemma3-4b", "paligemma-3b"])
def test_decode_after_prefill_equals_the_full_prefill(arch):
    """decode(t | prefill(t[:-1])) == prefill(t) within 2e-3 relative, as
    ``tests/test_archs_smoke.py`` holds the reference (float32, 2 x 100
    tokens, past Gemma3's window; PaliGemma behind its image prefix)."""
    _, cut = _cuts(arch)
    cfg = dataclasses.replace(cut, dtype="float32")
    m = build_model(cfg)
    p = m.init(0, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (2, 100)).astype(np.int32)
    _, full_b = _batches(cfg, toks)
    _, part_b = _batches(cfg, toks[:, :-1])
    with torch.inference_mode():
        full, _ = m.prefill(p, full_b, max_len=120)
        _, cache = m.prefill(p, part_b, max_len=120)
        dec, _ = m.decode(p, cache, torch.tensor(toks[:, -1:]))
    rel = float((full - dec).abs().max()) / float(full.abs().max())
    assert rel < 2e-3, rel


# ------------------------------------------------------------- serving ----
def test_engines_serve_gemma3_on_the_cpu():
    """``build_engines`` over Gemma3's cut (d0 bf16, d4 int8) generates
    greedy tokens in range past the window."""
    _, cut = _cuts("gemma3-4b")
    engines = build_engines(cut, variants=("d0", "d4"), max_len=80,
                            device="cpu")
    assert {t: sorted(v) for t, v in engines.items()} == \
        {"S": ["d0", "d4"], "E": ["d0"], "C": ["d0"]}
    toks = np.random.default_rng(0).integers(0, cut.vocab_size,
                                             (2, 70)).astype(np.int32)
    for vid in ("d0", "d4"):
        out, wall = engines["S"][vid].generate(toks, 4)
        assert out.shape == (2, 4) and wall > 0
        assert 0 <= int(out.min()) and int(out.max()) < cut.vocab_size
