"""The port's mixture-of-experts served models (``repro_torch.models`` at
``granite-moe-1b-a400m`` and ``dbrx-132b``) against the JAX package's
(``repro.models``), on the CPU, at the reduced configs of
``tests/test_archs_smoke.py`` (2 layers, d_model 256, 4/2 heads of 64, 4
experts, top-2, vocab 512): the variant ladders, the converted params,
prefill and three decode steps of Granite d0 (bf16 or float32) and d4
(int8 attention and experts through K5's plain path) and of DBRX d0 on
the reference's own weights (``convert.model_params``), decode after a
prefill against the full prefill, the engines of ``build_engines`` with
``route(dispatch=)``, and the card's head_dim check, which DBRX's 128
now passes.

Tolerances: those of ``tests/test_torch_models.py`` (``TOL``): float32
within 1e-4 absolute / 1e-5 relative, bfloat16 within 0.125 absolute +
1e-2 relative. Every model test records the router probabilities of
each MoE block the port runs and asserts that none has two of its first
k + 1 choices within 1e-6 (``jax.lax.top_k`` and the port's stable sort
order only exact ties otherwise).
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
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.models.variants import build_ladder
from repro_torch.rng import Draws

ARCHS = ("granite-moe-1b-a400m", "dbrx-132b")
TOL = {"float32": dict(atol=1e-4, rtol=1e-5),
       "bfloat16": dict(atol=0.125, rtol=1e-2)}
MARGIN = 1e-6


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


@pytest.fixture
def router_margins(monkeypatch):
    """The smallest gap between two of the first k + 1 sorted router
    probabilities of every token of every MoE block run, one entry a
    block call."""
    gaps = []
    inner = MOE.router

    def recording(params, x, cfg):
        probs, gates, ids = inner(params, x, cfg)
        srt = torch.sort(probs, dim=-1, descending=True).values
        srt = srt[..., :cfg.moe.top_k + 1]
        gaps.append(float((srt[..., :-1] - srt[..., 1:]).min()))
        return probs, gates, ids
    monkeypatch.setattr(MOE, "router", recording)
    return gaps


# ------------------------------------------------------------- configs ----
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("vid", [f"d{i}" for i in range(8)])
def test_build_ladder_matches_reference(arch, vid):
    got = build_ladder(get_config(arch))[vid]
    want = jbuild_ladder(jget_config(arch))[vid]
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)
    assert got.million_macs == want.million_macs
    assert (got.top1, got.top5, got.dtype_tag) == \
        (want.top1, want.top5, want.dtype_tag)


def test_a_layer_takes_the_moe_block_wherever_the_config_has_experts():
    """As the reference's ``_init_layer``: the MoE block replaces the MLP
    wherever ``cfg.moe`` is set."""
    assert "moe" in T.FAMILIES
    moe_cfg = reduced(get_config("granite-moe-1b-a400m"))
    layer = build_model(moe_cfg).init(0, device="cpu")["segments"][0][0]
    assert "moe" in layer and "mlp" not in layer
    dense = dataclasses.replace(get_config("edge-ladder"), moe=moe_cfg.moe)
    layer = build_model(dense).init(0, device="cpu")["segments"][0][0]
    assert "moe" in layer and "mlp" not in layer
    assert tuple(layer["moe"]["w_up"]["w"].shape) == \
        (4, dense.d_model, dense.d_ff)


def test_dbrx_head_dim_keeps_it_off_the_card():
    """K3/K4 have head_dim 16, 32, 64, 128 and 256: DBRX's 128 passes the
    card's check (so does a head_dim of 256), a head_dim without an
    instance (48, 512) raises before a weight is drawn; Granite's 64,
    the reduced DBRX's 64 and a model without attention pass."""
    dbrx = get_config("dbrx-132b")
    T.check_kernel_shapes(dbrx)
    T.check_kernel_shapes(dataclasses.replace(dbrx, head_dim=256))
    for hd in (48, 512):
        with pytest.raises(NotImplementedError, match=f"head_dim {hd}"):
            T.check_kernel_shapes(dataclasses.replace(dbrx, head_dim=hd))
    T.check_kernel_shapes(get_config("granite-moe-1b-a400m"))
    T.check_kernel_shapes(reduced(dbrx))
    T.check_kernel_shapes(get_config("falcon-mamba-7b"))   # no attention


# ---------------------------------------------------------- conversion ----
@pytest.mark.parametrize("arch,vid", [("granite-moe-1b-a400m", "d0"),
                                      ("granite-moe-1b-a400m", "d4"),
                                      ("dbrx-132b", "d0")])
def test_converted_moe_layers_keep_the_reference_types(arch, vid):
    jm, jp, m, p = _pair(arch, vid, "bfloat16")
    cfg = m.cfg
    want = _host(jp)["segments"][0]["moe"]
    got = p["segments"][0][1]["moe"]
    assert got["router"]["w"].dtype == torch.float32
    np.testing.assert_array_equal(got["router"]["w"].numpy(),
                                  want["router"]["w"][1])
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    if cfg.quant == "int8":
        w_q = got["w_down"]["w_q"]
        assert w_q.dtype == torch.int8 and w_q.stride() == (f * d, 1, f)
        np.testing.assert_array_equal(w_q.numpy(),
                                      want["w_down"]["w_q"][1])
        assert tuple(got["w_down"]["s"].shape) == (e, 1, d)
        assert p["segments"][0][1]["attn"]["wq"]["w_q"].dtype == torch.int8
    else:
        assert got["w_gate"]["w"].dtype == torch.bfloat16
        assert tuple(got["w_gate"]["w"].shape) == (e, d, f)
    if not cfg.tie_embeddings:
        assert p["lm_head"]["w"].dtype == torch.bfloat16
    # the port's own init has the same layout, types and strides
    own = m.init(0, device="cpu")
    spec = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: (tuple(x.shape), x.dtype, x.stride()), t)
    assert spec(own) == spec(p)


# -------------------------------------------------- prefill and decode ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,vid", [("granite-moe-1b-a400m", "d0"),
                                      ("granite-moe-1b-a400m", "d4"),
                                      ("dbrx-132b", "d0")])
def test_prefill_and_decode_match_reference(arch, vid, dtype,
                                            router_margins):
    """Prefill logits and cache of a 20-token prompt (capacity binding at
    the config's factor 1.25), then three greedy decode steps, the prompt
    longer than the cache (20 tokens into 16 slots) so the writes wrap."""
    jm, jp, m, p = _pair(arch, vid, dtype)
    vocab = m.cfg.vocab_size
    toks = np.random.default_rng(0).integers(0, vocab, (2, 20)).astype(
        np.int32)
    jlog, jcache = jax.jit(lambda pp, b: jm.prefill(pp, b, max_len=16))(
        jp, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        log, cache = m.prefill(p, {"tokens": torch.tensor(toks)}, max_len=16)
    jdecode = jax.jit(jm.decode)
    tol = TOL[dtype]
    for step in range(4):
        np.testing.assert_allclose(log.float().numpy(),
                                   np.asarray(jlog, np.float32), **tol,
                                   err_msg=f"logits, step {step}")
        for name in ("k", "v"):
            np.testing.assert_allclose(
                cache["segments"][0][name].float().numpy(),
                np.asarray(jcache["segments"][0][name], np.float32), **tol,
                err_msg=f"{name} cache, step {step}")
        if step == 3:
            break
        cur = np.asarray(jnp.argmax(jlog[:, -1:, :vocab], -1), np.int32)
        jlog, jcache = jdecode(jp, jcache, jnp.asarray(cur))
        with torch.inference_mode():
            log, cache = m.decode(p, cache, torch.tensor(cur))
    assert cache["pos"] == int(jcache["pos"]) == 23
    assert len(router_margins) == m.cfg.n_layers * 4
    assert min(router_margins) > MARGIN, min(router_margins)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prefill_equals_the_full_prefill(arch, router_margins):
    """decode(t | prefill(t[:-1])) == prefill(t) within 2e-3 relative, on
    the weights and tokens with which ``tests/test_archs_smoke.py`` holds
    the reference (float32, 2 x 100 tokens). Capacity depends on the
    prompt's length (63 slots at 100 tokens, 62 at 99), so the check
    holds where those weights drop no token, as the reference's does."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), dtype="float32")
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    m = build_model(cfg)
    p = convert.model_params(_host(jp), cfg, device="cpu")
    toks = torch.tensor(np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (2, 100), 0, cfg.vocab_size)))
    with torch.inference_mode():
        full, _ = m.prefill(p, {"tokens": toks}, max_len=104)
        _, cache = m.prefill(p, {"tokens": toks[:, :-1]}, max_len=104)
        dec, _ = m.decode(p, cache, toks[:, -1:])
    rel = float((full - dec).abs().max()) / float(full.abs().max())
    assert rel < 2e-3, rel
    assert min(router_margins) > MARGIN, min(router_margins)


# ------------------------------------------------------------- routing ----
def test_route_dispatch_serves_every_active_user_on_the_moe_engines():
    engines = build_engines(reduced(get_config("granite-moe-1b-a400m")),
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
    assert "S/d4" in served or "S/d0" in served
