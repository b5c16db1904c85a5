"""The port's state-space and hybrid served models (``repro_torch.models``
at ``falcon-mamba-7b`` and ``hymba-1.5b``) against the JAX package's
(``repro.models``), on the CPU, at the reduced configs of
``tests/test_archs_smoke.py`` (2 layers, d_model 256, vocab 512; Hymba
keeps one global and one sliding segment with a 64-token window): the
configs and their variant ladders, the converted params, then prefill
and decode steps of Falcon-Mamba d0 (bf16 or float32) and d4 (int8
through K5's plain path), and of Hymba at a prompt shorter and one
longer than its window, decoding until the sliding ring wraps. The
reference's own weights are carried across with ``convert.model_params``.

Tolerances: in float32 models logits and caches within 1e-4 absolute /
1e-5 relative (the two packages sum in another order). In bfloat16,
where the reference's conv sum, ``x_proj`` product and attention
probabilities round at other places than eager PyTorch, within 0.125
absolute + 1e-2 relative, one bfloat16 step at the logits' scale (as
``tests/test_torch_models.py`` holds the edge ladder). The port-only consistency check holds decode after a
prefill to the full prefill within 2e-3 relative, as
``tests/test_archs_smoke.py`` holds the reference.
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
from repro_torch.fleet import api, scenarios
from repro_torch.launch.serve import build_engines
from repro_torch.models import build_model
from repro_torch.models.variants import build_ladder
from repro_torch.rng import Draws

ARCHS = ("falcon-mamba-7b", "hymba-1.5b")
TOL = {"float32": dict(atol=1e-4, rtol=1e-5),
       "bfloat16": dict(atol=0.125, rtol=1e-2)}


def _host(tree):
    """A JAX pytree as numpy, bfloat16 leaves upcast to float32 (exact)."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
        else np.asarray(a), tree)


def _pair(arch, vid, dtype, seed=1):
    """(JAX model, JAX params, port model, port params) of one variant of
    the reduced config."""
    jcfg = dataclasses.replace(
        jbuild_ladder(jreduced(jget_config(arch)))[vid].cfg, dtype=dtype)
    cfg = dataclasses.replace(
        build_ladder(reduced(get_config(arch)))[vid].cfg, dtype=dtype)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, build_model(cfg), convert.model_params(_host(jp), cfg,
                                                          device="cpu")


# ------------------------------------------------------------- configs ----
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference_field_for_field(arch):
    got, want = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.d_inner == want.d_inner
    assert dataclasses.asdict(reduced(got)) == \
        dataclasses.asdict(jreduced(want))


def test_falcon_mamba_is_served_at_its_published_size():
    cfg = get_config("falcon-mamba-7b")
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm.state_dim,
            cfg.vocab_size, cfg.tie_embeddings) == \
        (64, 4096, 8192, 16, 65_024, False)
    assert 7.2e9 < cfg.param_count() < 7.3e9


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("vid", [f"d{i}" for i in range(8)])
def test_build_ladder_matches_reference(arch, vid):
    got = build_ladder(get_config(arch))[vid]
    want = jbuild_ladder(jget_config(arch))[vid]
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)
    assert got.million_macs == want.million_macs
    assert (got.top1, got.top5, got.dtype_tag) == \
        (want.top1, want.top5, want.dtype_tag)


def test_falcon_ladder_is_shape_degenerate_like_the_reference():
    """``scale_width`` scales heads and d_ff only, both 0 in Falcon-Mamba:
    d1..d3 have d0's shapes, d5..d7 d4's (a property of the reference)."""
    lad = build_ladder(get_config("falcon-mamba-7b"))
    shape = lambda v: dataclasses.asdict(dataclasses.replace(  # noqa: E731
        v.cfg, name="", width_mult=1.0))
    assert all(shape(lad[f"d{i}"]) == shape(lad["d0"]) for i in (1, 2, 3))
    assert all(shape(lad[f"d{i}"]) == shape(lad["d4"]) for i in (5, 6, 7))
    assert lad["d3"].million_macs == lad["d0"].million_macs
    jlad = jbuild_ladder(jget_config("falcon-mamba-7b"))
    assert [v.million_macs for v in lad.values()] == \
        [v.million_macs for v in jlad.values()]


# ---------------------------------------------------------- conversion ----
@pytest.mark.parametrize("arch,vid", [("falcon-mamba-7b", "d0"),
                                      ("falcon-mamba-7b", "d4"),
                                      ("hymba-1.5b", "d0")])
def test_converted_mamba_leaves_keep_the_reference_types(arch, vid):
    jm, jp, m, p = _pair(arch, vid, "bfloat16")
    want = _host(jp)["segments"][-1]["ssm"]
    got = p["segments"][-1][0]["ssm"]
    types = {"conv_w": torch.bfloat16, "conv_b": torch.float32,
             "dt_w": torch.float32, "dt_b": torch.float32,
             "A_log": torch.float32, "D": torch.float32}
    for name, dtype in types.items():
        assert got[name].dtype == dtype, name
        np.testing.assert_array_equal(got[name].float().numpy(),
                                      want[name][0])
    assert got["x_proj"]["w"].dtype == torch.bfloat16
    if m.cfg.quant == "int8":
        for proj in ("in_proj", "out_proj"):
            assert got[proj]["w_q"].dtype == torch.int8
            assert got[proj]["s"].dtype == torch.float32
            np.testing.assert_array_equal(got[proj]["w_q"].numpy(),
                                          want[proj]["w_q"][0])
    else:
        assert got["in_proj"]["w"].dtype == torch.bfloat16
    # the port's own init has the same layout and types
    own = m.init(0, device="cpu")
    spec = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: (tuple(x.shape), x.dtype), t)
    assert spec(own["segments"][-1][0]) == spec(p["segments"][-1][0])
    assert spec({k: v for k, v in own.items() if k != "segments"}) == \
        spec({k: v for k, v in p.items() if k != "segments"})


# -------------------------------------------------- prefill and decode ----
def _run_both(arch, vid, dtype, s, steps, max_len):
    """Prefill ``s`` tokens and ``steps`` greedy decode steps on both
    packages, comparing the logits and every cache entry at each step."""
    jm, jp, m, p = _pair(arch, vid, dtype)
    vocab = m.cfg.vocab_size
    toks = np.random.default_rng(s).integers(0, vocab, (2, s)).astype(
        np.int32)
    jlog, jcache = jax.jit(lambda pp, b: jm.prefill(pp, b, max_len=max_len))(
        jp, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        log, cache = m.prefill(p, {"tokens": torch.tensor(toks)},
                               max_len=max_len)
    jdecode = jax.jit(jm.decode)
    tol = TOL[dtype]
    for step in range(steps + 1):
        np.testing.assert_allclose(log.float().numpy(),
                                   np.asarray(jlog, np.float32), **tol,
                                   err_msg=f"logits, step {step}")
        for i, (seg, jseg) in enumerate(zip(cache["segments"],
                                            jcache["segments"])):
            assert set(seg) == set(jseg)
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
    assert cache["pos"] == int(jcache["pos"]) == s + steps
    return cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vid", ["d0", "d4"])
def test_falcon_mamba_prefill_and_decode_match_reference(vid, dtype):
    cache = _run_both("falcon-mamba-7b", vid, dtype, 24, 3, 32)
    assert [set(c) for c in cache["segments"]] == [{"conv", "h"}]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,steps", [(48, 20), (100, 3)])
def test_hymba_prefill_and_decode_match_reference(s, steps, dtype):
    """A prompt of 48 (< the window of 64) decoded past the window, and
    one of 100 (> window: the banded prefill) whose ring has wrapped."""
    cache = _run_both("hymba-1.5b", "d0", dtype, s, steps, s + steps + 8)
    segs = cache["segments"]
    assert [set(c) for c in segs] == [{"k", "v", "conv", "h"}] * 2
    assert segs[0]["k"].shape[2] == s + steps + 8       # layer 0: global
    assert segs[1]["k"].shape[2] == 64                  # the sliding ring


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prefill_equals_the_full_prefill(arch):
    """decode(t | prefill(t[:-1])) == prefill(t), as
    ``tests/test_archs_smoke.py`` holds the reference (float32)."""
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    m = build_model(cfg)
    p = m.init(0, device="cpu")
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 100)).astype(np.int32))
    with torch.inference_mode():
        full, _ = m.prefill(p, {"tokens": toks}, max_len=104)
        _, cache = m.prefill(p, {"tokens": toks[:, :-1]}, max_len=104)
        dec, _ = m.decode(p, cache, toks[:, -1:])
    rel = float((full - dec).abs().max()) / float(full.abs().max())
    assert rel < 2e-3, rel


# ------------------------------------------------------------- routing ----
def test_route_dispatch_serves_every_active_user_on_the_ssm_engines():
    engines = build_engines(reduced(get_config("falcon-mamba-7b")),
                            variants=("d0", "d4"), max_len=24, device="cpu")
    assert {t: sorted(v) for t, v in engines.items()} == \
        {"S": ["d0", "d4"], "E": ["d0"], "C": ["d0"]}
    assert engines["E"]["d0"].params is engines["S"]["d0"].params
    scen = scenarios.mixed_table5_fleet(Draws(5, "cpu"), 12, 3,
                                        min_users=1, max_users=3)
    want = set(zip(*(a.tolist() for a in np.nonzero(
        scen.active.cpu().numpy()))))
    served = {}
    for goal in (0.0, 85.0):
        res = api.FleetOrchestrator(api.OraclePolicy(3, threshold=goal)) \
            .route(scen=scen, dispatch=engines, batch_size=8)
        keys = [(r.cell, r.user) for r in res.served]
        assert len(keys) == len(set(keys)) and set(keys) == want
        t = res.timings
        assert t["batching_ms"] + t["compute_ms"] + t["dispatch_ms"] == \
            pytest.approx(t["wall_ms"])
        slo = res.slo()
        assert slo["measured"]["attained"] + \
            slo["measured"]["violated"] == len(want)
        for r in res.served:
            assert r.queue_ms + r.measured_ms == pytest.approx(r.e2e_ms)
            served[f"{r.tier}/{r.variant}"] = 1
    # local decisions snap to the variants that exist (d0 or d4)
    assert set(served) <= {"S/d0", "S/d4", "E/d0", "C/d0"}


# --------------------------------------------------------- unsupported ----
@pytest.mark.parametrize("change", [
    dict(arch_type="retnet"),
    dict(arch_type="encoder", n_enc_layers=2, enc_seq=32),
])
def test_other_families_still_raise(change):
    """The port builds the reference's six families (the encoder-decoder
    too); a family the reference lacks raises,
    with or without an encoder."""
    with pytest.raises(NotImplementedError, match="families"):
        build_model(dataclasses.replace(get_config("edge-ladder"), **change))
