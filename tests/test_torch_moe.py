"""The port's mixture-of-experts layer (``repro_torch.models.moe``)
against the JAX package's (``repro.models.moe``), on the CPU, at the
reduced Granite-3.0-1B-A400M and DBRX configs of
``tests/test_archs_smoke.py`` (d_model 256, d_ff 512, 4 experts, top-2):
the configs, ``moe_block`` in float32, bfloat16 and with int8 experts
(through K5's plain path) at the config's capacity factor, at 8.0 (no
drops) and at 0.5 (drops forced), the dense oracle, the ``moe_cf`` flag,
the batched int8 product and the converted params. The reference's own
weights are carried across with ``convert.model_params``.

Tolerances: float32 within 1e-4 absolute / 1e-5 relative (the two
packages sum in another order); bfloat16 and int8 experts (bf16
activations) within 0.125 absolute + 1e-2 relative, one bfloat16 step at
the outputs' scale. ``dropped_frac`` is equal, ``aux_loss`` within 1e-6.

Top-k: the port takes descending probability, ties by ascending index;
``jax.lax.top_k`` orders exact ties otherwise, so every test asserts
that its router probabilities keep each of the first k choices (and the
k-th against the (k+1)-th) more than 1e-6 apart, where the two orders
agree.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import tuning as jtuning
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import moe as JMOE
from repro_torch import convert, tuning
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import _build, int8_matmul, ops, ref
from repro_torch.models import moe as MOE

ARCHS = ("granite-moe-1b-a400m", "dbrx-132b")
TOL = {"float32": dict(atol=1e-4, rtol=1e-5),
       "bfloat16": dict(atol=0.125, rtol=1e-2)}
MARGIN = 1e-6


def _host(tree):
    """A JAX pytree as numpy, bfloat16 leaves upcast to float32 (exact)."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
        else np.asarray(a), tree)


def _cfgs(arch, dtype, quant="none", cf=None):
    """(reference config, port config) of the reduced ``arch``."""
    out = []
    for get, red in ((jget_config, jreduced), (get_config, reduced)):
        cfg = dataclasses.replace(red(get(arch)), dtype=dtype, quant=quant)
        if cf is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cf))
        out.append(cfg)
    return out


def _block_pair(arch, dtype, quant="none", cf=None, seed=0):
    """(reference cfg, reference params, port cfg, port params) of one MoE
    block; the port's params converted from the reference's."""
    jcfg, cfg = _cfgs(arch, dtype, quant, cf)
    jp = JMOE.init_moe(jax.random.PRNGKey(seed), jcfg)
    p = convert.model_params({"segments": [], "moe": _host(jp)}, cfg,
                             device="cpu")["moe"]
    return jcfg, jp, cfg, p


def _x(cfg, b=2, s=24, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def assert_clear_router_margin(probs, k):
    """No two of the first k + 1 sorted probabilities of a token within
    ``MARGIN``: the reference's ``top_k`` and the port's stable sort pick
    the same experts in the same order."""
    srt = torch.sort(torch.tensor(np.asarray(probs)), dim=-1,
                     descending=True).values[..., :k + 1]
    gap = float((srt[..., :-1] - srt[..., 1:]).min())
    assert gap > MARGIN, f"router margin {gap} <= {MARGIN}"


def _ref_probs(jp, x, jcfg):
    """The reference router's probabilities of ``x`` as its block sees it
    (in the config's type, then float32)."""
    from repro.models import layers as JL
    xr = jnp.asarray(x, jnp.dtype(jcfg.dtype)).astype(jnp.float32)
    logits = JL.linear(jp["router"], xr)
    return jax.nn.softmax(logits, axis=-1)


# ------------------------------------------------------------- configs ----
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference_field_for_field(arch):
    got, want = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert dataclasses.asdict(reduced(got)) == \
        dataclasses.asdict(jreduced(want))


def test_granite_is_served_at_its_published_size():
    cfg = get_config("granite-moe-1b-a400m")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.moe.n_experts,
            cfg.moe.top_k, cfg.vocab_size) == \
        (24, 1024, 16, 8, 64, 512, 32, 8, 49_155)
    assert cfg.param_count() == 1_334_887_424
    assert cfg.active_param_count() == 428_917_760


@pytest.mark.parametrize("seq,k,e,cf", [
    (256, 8, 32, 1.25), (1, 8, 32, 1.25), (16, 2, 4, 0.5), (24, 2, 4, 8.0),
    (7, 3, 5, 1.1), (100, 4, 16, 1.0), (3, 1, 64, 0.01)])
def test_capacity_is_the_reference_formula(seq, k, e, cf):
    assert MOE.capacity(seq, k, e, cf) == JMOE.capacity(seq, k, e, cf)


def test_granite_capacity_at_the_served_shapes():
    """80 slots a batch row at a 256-token prefill, 1 at decode."""
    m = get_config("granite-moe-1b-a400m").moe
    assert MOE.capacity(256, m.top_k, m.n_experts, m.capacity_factor) == 80
    assert MOE.capacity(1, m.top_k, m.n_experts, m.capacity_factor) == 1


# --------------------------------------------------------- moe_block ----
@pytest.mark.parametrize("cf", [None, 8.0, 0.5])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, kind, cf):
    dtype = "float32" if kind == "float32" else "bfloat16"
    quant = "int8" if kind == "int8" else "none"
    jcfg, jp, cfg, p = _block_pair(arch, dtype, quant, cf)
    x = _x(cfg)
    assert_clear_router_margin(_ref_probs(jp, x, jcfg), cfg.moe.top_k)
    jy, jaux = JMOE.moe_block(jp, jnp.asarray(x, jnp.dtype(dtype)), jcfg)
    y, aux = MOE.moe_block(p, torch.tensor(x).to(getattr(torch, dtype)),
                           cfg)
    assert y.dtype == getattr(torch, dtype) and y.shape == x.shape
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32),
                               **TOL[dtype])
    assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"])
    assert abs(float(aux["aux_loss"]) - float(jaux["aux_loss"])) <= 1e-6
    if cf == 0.5:
        assert float(aux["dropped_frac"]) > 0.2        # drops forced
    if cf == 8.0:
        assert float(aux["dropped_frac"]) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_router_matches_the_reference_choice_and_gates(arch):
    jcfg, jp, cfg, p = _block_pair(arch, "float32")
    x = _x(cfg, s=40)
    probs_ref = _ref_probs(jp, x, jcfg)
    k = cfg.moe.top_k
    assert_clear_router_margin(probs_ref, k)
    jg, ji = jax.lax.top_k(probs_ref, k)
    jg = jg / (jnp.sum(jg, axis=-1, keepdims=True) + 1e-9)
    probs, gates, ids = MOE.router(p, torch.tensor(x), cfg)
    assert ids.dtype == torch.int64
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), atol=1e-6)
    np.testing.assert_allclose(probs.numpy(), np.asarray(probs_ref),
                               atol=1e-6)


def test_router_orders_exact_ties_by_ascending_index():
    """A zero router gives every expert the same probability: the choice
    is the first k experts, in ``ref.stable_topk_ref``'s order."""
    _, _, cfg, p = _block_pair("granite-moe-1b-a400m", "float32")
    p["router"]["w"].zero_()
    probs, gates, ids = MOE.router(p, torch.tensor(_x(cfg)), cfg)
    _, want = ref.stable_topk_ref(probs, cfg.moe.top_k)
    assert torch.equal(ids, want.long())
    assert ids[0, 0].tolist() == list(range(cfg.moe.top_k))
    assert torch.allclose(gates, torch.full_like(gates, 1 / cfg.moe.top_k))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_without_drops_equals_the_dense_oracle(arch):
    """Capacity-based scatter dispatch == the dense all-experts oracle when
    capacity does not bind, as ``tests/test_archs_smoke.py`` holds the
    reference; and the port's oracle equals the reference's."""
    jcfg, jp, cfg, p = _block_pair(arch, "float32", cf=8.0)
    x = _x(cfg, s=16)
    assert_clear_router_margin(_ref_probs(jp, x, jcfg), cfg.moe.top_k)
    y, aux = MOE.moe_block(p, torch.tensor(x), cfg)
    dense = MOE.moe_block_dense_ref(p, torch.tensor(x), cfg)
    np.testing.assert_allclose(y.numpy(), dense.numpy(), atol=2e-4,
                               rtol=1e-3)
    assert float(aux["dropped_frac"]) == 0.0
    jdense = JMOE.moe_block_dense_ref(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense),
                               **TOL["float32"])


@pytest.mark.parametrize("cf", [0.5, 3.0])
def test_moe_cf_flag_moves_capacity_as_the_reference_does(cf):
    """The flag overrides the config's factor in both packages: the same
    output as a config carrying that factor."""
    jcfg, jp, cfg, p = _block_pair("granite-moe-1b-a400m", "float32")
    x = _x(cfg)
    assert_clear_router_margin(_ref_probs(jp, x, jcfg), cfg.moe.top_k)
    as_cfg, as_aux = MOE.moe_block(p, torch.tensor(x), dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf)))
    assert tuning.FLAGS["moe_cf"] == jtuning.FLAGS["moe_cf"] == 0.0
    tuning.FLAGS["moe_cf"] = jtuning.FLAGS["moe_cf"] = cf
    try:
        y, aux = MOE.moe_block(p, torch.tensor(x), cfg)
        jy, jaux = JMOE.moe_block(jp, jnp.asarray(x), jcfg)
    finally:
        tuning.FLAGS["moe_cf"] = jtuning.FLAGS["moe_cf"] = 0.0
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL["float32"])
    assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"])
    assert torch.equal(y, as_cfg)
    assert float(aux["dropped_frac"]) == float(as_aux["dropped_frac"])
    # 0.5 drops, 3.0 drops nothing
    assert (float(aux["dropped_frac"]) > 0) == (cf < 1.0)


def test_dispatch_keeps_earlier_tokens_within_capacity():
    """Every token routed to expert 0 at capacity 1 a row of 4 tokens:
    only the first token of each row keeps its slot, on both packages."""
    jcfg, jp, cfg, p = _block_pair("granite-moe-1b-a400m", "float32",
                                   cf=0.5)
    bias = np.zeros((cfg.d_model, cfg.moe.n_experts), np.float32)
    x = np.ones((2, 4, cfg.d_model), np.float32) + _x(cfg, s=4) * 1e-3
    bias[:, 0], bias[:, 1] = 1.0, 0.5          # experts 0 then 1 for all
    jp["router"]["w"] = jnp.asarray(bias)
    p["router"]["w"] = torch.tensor(bias)
    y, aux = MOE.moe_block(p, torch.tensor(x), cfg)
    jy, jaux = JMOE.moe_block(jp, jnp.asarray(x), jcfg)
    # capacity ceil(4 * 2 * 0.5 / 4) = 1: one of four entries per expert
    assert MOE.capacity(4, 2, 4, 0.5) == 1
    assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"]) == 0.75
    assert torch.equal(y[:, 1:], torch.zeros_like(y[:, 1:]))
    assert bool((y[:, 0] != 0).any())
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL["float32"])


@pytest.mark.parametrize("cf", [None, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_and_moe_aux_make_up_moe_block(arch, cf):
    """The served model's ``moe_apply`` returns ``moe_block``'s output and
    the router's probabilities, choices and kept entries, from which
    ``moe_aux`` gives ``moe_block``'s aux statistics, the reference's."""
    jcfg, jp, cfg, p = _block_pair(arch, "float32", cf=cf)
    x = _x(cfg)
    assert_clear_router_margin(_ref_probs(jp, x, jcfg), cfg.moe.top_k)
    y, aux = MOE.moe_block(p, torch.tensor(x), cfg)
    ya, probs, ids, keep = MOE.moe_apply(p, torch.tensor(x), cfg)
    assert torch.equal(y, ya)
    want_probs, _, want_ids = MOE.router(p, torch.tensor(x), cfg)
    assert torch.equal(probs, want_probs) and torch.equal(ids, want_ids)
    assert keep.dtype == torch.bool and keep.shape == \
        (x.shape[0], x.shape[1] * cfg.moe.top_k)
    got = MOE.moe_aux(probs, ids, keep, cfg.moe.n_experts)
    assert torch.equal(got["aux_loss"], aux["aux_loss"])
    assert torch.equal(got["dropped_frac"], aux["dropped_frac"])
    _, jaux = JMOE.moe_block(jp, jnp.asarray(x), jcfg)
    assert float(got["dropped_frac"]) == float(jaux["dropped_frac"])
    assert abs(float(got["aux_loss"]) - float(jaux["aux_loss"])) <= 1e-6


def test_served_prefill_and_decode_compute_no_aux_statistics(monkeypatch):
    """Prefill and decode take each block's output alone: ``moe_aux``,
    the aux loss and drops they would throw away, is never called."""
    from repro_torch.models import build_model

    def refuse(*a, **k):
        raise AssertionError("moe_aux called on the served path")
    monkeypatch.setattr(MOE, "moe_aux", refuse)
    cfg = reduced(get_config("granite-moe-1b-a400m"))
    m = build_model(cfg)
    params = m.init(0, device="cpu")
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32))
    with torch.inference_mode():
        logits, cache = m.prefill(params, {"tokens": toks}, max_len=12)
        out, _ = m.decode(params, cache, toks[:, -1:])
    assert bool(torch.isfinite(logits.float()).all())
    assert bool(torch.isfinite(out.float()).all())


# --------------------------------------------------- the batched K5 ----
def _batched_operands(e, m, k, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    xs, sxs, ws, sws = [], [], [], []
    for _ in range(e):
        xq, sx = ref.quantize_ref(torch.randn((m, k), generator=g))
        wq, sw = ref.quantize_ref(torch.randn((k, n), generator=g), dim=0)
        xs.append(xq), sxs.append(sx), ws.append(wq), sws.append(sw)
    return (torch.stack(xs), torch.stack(sxs),
            int8_matmul.k_major(torch.stack(ws)), torch.stack(sws))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,m,k,n", [(4, 48, 256, 512), (32, 5, 64, 16),
                                     (3, 1, 33, 7)])
def test_batched_plain_int8_matmul_equals_the_per_expert_product(
        e, m, k, n, dtype):
    xq, sx, wq, sw = _batched_operands(e, m, k, n)
    assert wq.stride() == (n * k, 1, k)          # K-major per expert
    got = int8_matmul.plain(xq, sx, wq, sw, dtype)
    via_ops = ops.int8_matmul(xq, sx, wq, sw, out_dtype=dtype)
    assert got.shape == (e, m, n) and got.dtype == dtype
    for i in range(e):
        one = int8_matmul.plain(xq[i], sx[i], wq[i], sw[i], dtype)
        assert torch.equal(got[i], one)
        assert torch.equal(via_ops[i], one)


def test_int8_experts_quantize_rows_as_linear_does():
    """Int8 experts: each projection is the per-expert product of rows
    quantized as ``layers.linear`` quantizes them; empty capacity rows
    stay zero."""
    from repro_torch.models import layers as L
    _, _, cfg, p = _block_pair("granite-moe-1b-a400m", "bfloat16", "int8")
    g = torch.Generator().manual_seed(3)
    x = torch.randn((cfg.moe.n_experts, 6, cfg.d_model),
                    generator=g).to(torch.bfloat16)
    x[:, 4:] = 0                                  # empty capacity rows
    got = MOE._experts(p["w_gate"], x)
    for i in range(cfg.moe.n_experts):
        want = L.linear({"w_q": p["w_gate"]["w_q"][i],
                         "s": p["w_gate"]["s"][i]}, x[i])
        assert torch.equal(got[i], want)
    assert torch.equal(got[:, 4:], torch.zeros_like(got[:, 4:]))


def test_batched_int8_cost_counts_every_expert():
    """On FakeTensors (``obs.prof``) the batched op launches nothing and
    records E times one expert's cost."""
    seen = []
    _build.COST_SINKS.append(lambda *a: seen.append(a))
    try:
        with FakeTensorMode():
            xq = torch.empty((32, 64, 1024), dtype=torch.int8)
            sx = torch.empty((32, 64, 1))
            wq = torch.empty((32, 1024, 512), dtype=torch.int8)
            sw = torch.empty((32, 1, 512))
            out = ops.int8_matmul(xq, sx, wq, sw, out_dtype=torch.bfloat16)
            assert tuple(out.shape) == (32, 64, 512)
    finally:
        _build.COST_SINKS.pop()
    one_ops, one_bytes = int8_matmul.cost(64, 1024, 512, 2)
    assert seen == [("int8_matmul", 32 * one_ops, 32 * one_bytes)]


# ---------------------------------------------------------- conversion ----
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_converted_moe_params_keep_the_router_float32(quant):
    jcfg, jp, cfg, p = _block_pair("granite-moe-1b-a400m", "bfloat16", quant)
    want = _host(jp)
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    assert p["router"]["w"].dtype == torch.float32
    assert tuple(p["router"]["w"].shape) == (d, e)
    np.testing.assert_array_equal(p["router"]["w"].numpy(),
                                  want["router"]["w"])
    for name, (din, dout) in (("w_gate", (d, f)), ("w_up", (d, f)),
                              ("w_down", (f, d))):
        leaf = p[name]
        if quant == "int8":
            assert leaf["w_q"].dtype == torch.int8
            assert tuple(leaf["w_q"].shape) == (e, din, dout)
            assert leaf["w_q"].stride() == (din * dout, 1, din)
            np.testing.assert_array_equal(leaf["w_q"].numpy(),
                                          want[name]["w_q"])
            assert leaf["s"].dtype == torch.float32
            assert tuple(leaf["s"].shape) == (e, 1, dout)
        else:
            assert leaf["w"].dtype == torch.bfloat16
            assert tuple(leaf["w"].shape) == (e, din, dout)
            np.testing.assert_array_equal(leaf["w"].float().numpy(),
                                          want[name]["w"])
    # the port's own init has the same layout, types and strides
    own = MOE.init_moe(torch.Generator().manual_seed(0), cfg)
    spec = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: (tuple(x.shape), x.dtype, x.stride()), t)
    assert spec(own) == spec(p)
