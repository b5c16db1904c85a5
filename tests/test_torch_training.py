"""The port's training path (``Model.loss``, ``training.make_train_step``)
against the JAX package's (``repro.models`` ``loss`` under ``jax.grad``,
``repro.training``), on the CPU, float32, on the reference's own weights
carried across with ``convert.model_params``: the loss, the aux loss and
every gradient of reduced configs (2 layers, d_model 256, 4 heads of 64,
vocab 512, ``tests/test_archs_smoke.py``'s cut) of the edge ladder
(whole) and Granite-MoE here, the other ids of ``ARCH_IDS`` in
``test_torch_training_{archs,dense,ssm_audio}.py``; the training step in
``test_torch_train_step.py`` and ``test_torch_train_remat.py``; and
``FLAGS["loss_chunk"]`` as the default chunk. Each batch is 2 x 81
tokens (past the cut's 64-token window, so a sliding layer takes the
banded path), 2 x 33 where no layer slides.

Tolerances, float32 throughout: the loss and aux loss within 2e-5
relative (the two packages sum the cross-entropy, the softmax and the
attention in another order); the gradients within 1e-5 absolute + 2e-3
relative of each leaf (``_GRAD_TOL``; the largest leaves reach ~1, the
smallest ~1e-6, summed over 2 x 80 tokens in another order); after one
AdamW step the params within 1e-6 absolute + 1e-5 relative (the first
update of a leaf is lr g / (|g| + eps); these steps take eps 1e-6, not
the default 1e-8, since for a gradient within a few eps of 0 the
update's slope 1 / eps would turn float32 noise of ~1e-9 in g into a
visible move; at 1e-6 it stays below 1e-6 of lr); ``grad_norm`` within
1e-5 relative (the port sums its per-layer leaves, the reference its
stacked ones, in another order); ``lr`` equal. Where a model has MoE
blocks, every test asserts that no router's top-k + 1 probabilities lie
within 1e-6 of each other (``jax.lax.top_k`` and the port's stable sort
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
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import build_model
from repro_torch.models import moe as MOE
from repro_torch.training.optimizer import tree_leaves, tree_leaves_with_path
from repro_torch.tuning import FLAGS

ARCHS = ("edge-ladder", "granite-moe-1b-a400m")
LOSS_RTOL = 2e-5
_GRAD_TOL = dict(atol=1e-5, rtol=2e-3)
MARGIN = 1e-6
BATCH, SEQ = 2, 81


@pytest.fixture(autouse=True)
def one_cpu_thread():
    """Each test's torch ops on one CPU thread: the suite runs its files in
    parallel worker processes, and these small ops gain nothing from
    threads they would only contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(tree):
    """A JAX pytree as numpy, bfloat16 leaves upcast to float32 (exact)."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
        else np.asarray(a), tree)


def cfgs(arch):
    """(JAX config, port config): the reduced cut in float32 (the edge
    ladder whole, it is small)."""
    if arch == "edge-ladder":
        jc, c = jget_config(arch), get_config(arch)
    else:
        jc, c = jreduced(jget_config(arch)), reduced(get_config(arch))
    return (dataclasses.replace(jc, dtype="float32"),
            dataclasses.replace(c, dtype="float32"))


def pair(arch, seed=1):
    """(JAX model, JAX params, port model, port params requiring grad)."""
    jcfg, cfg = cfgs(arch)
    jm = jbuild_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    params = convert.model_params(_host(jp), cfg, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(p.is_floating_point())
    return jm, jp, build_model(cfg), params


def batch_np(cfg, seed=2, b=BATCH, s=SEQ):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.arch_type == "vlm":
        out["img_embeds"] = rng.standard_normal(
            (b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def port_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture
def router_margins(monkeypatch):
    """The smallest gap between two of the first k + 1 sorted router
    probabilities of each MoE block the port runs."""
    gaps = []
    inner = MOE.router

    def recording(params, x, cfg):
        probs, gates, ids = inner(params, x, cfg)
        srt = torch.sort(probs, dim=-1, descending=True).values
        srt = srt[..., :cfg.moe.top_k + 1]
        gaps.append(float((srt[..., :-1] - srt[..., 1:]).min().detach()))
        return probs, gates, ids
    monkeypatch.setattr(MOE, "router", recording)
    return gaps


def reference_loss_and_grads(jm, jp, b, **kw):
    fn = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, b, **kw),
                                    has_aux=True))
    (loss, metrics), grads = fn(jp)
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def port_loss_and_grads(model, params, b, **kw):
    loss, metrics = model.loss(params, b, **kw)
    leaves = [p for p in tree_leaves(params) if p.requires_grad]
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), metrics, grads


def check_loss_and_grads(arch, router_margins):
    jm, jp, model, params = pair(arch)
    slides = model.cfg.attn_pattern != "full" and model.cfg.has_attention
    b = batch_np(model.cfg, s=SEQ if slides else 33)
    jloss, jmet, jgrads = reference_loss_and_grads(
        jm, jp, {k: jnp.asarray(v) for k, v in b.items()}, loss_chunk=32)
    loss, met, grads = port_loss_and_grads(model, params, port_batch(b),
                                           loss_chunk=32)
    if model.cfg.moe is not None:
        assert min(router_margins) > MARGIN
        assert float(met["aux_loss"].detach()) == pytest.approx(
            jmet["aux_loss"], rel=LOSS_RTOL)
    else:
        assert float(met["aux_loss"]) == 0.0
    assert float(loss) == pytest.approx(jloss, rel=LOSS_RTOL)
    assert float(met["loss"].detach()) == pytest.approx(jmet["loss"],
                                                        rel=LOSS_RTOL)
    want = convert.model_params(_host(jgrads), model.cfg, device="cpu")
    wpaths = dict(tree_leaves_with_path(want))
    trained = [(p, x) for p, x in tree_leaves_with_path(params)
               if x.requires_grad]
    assert len(trained) == len(grads) == len(wpaths)
    for (path, _), g in zip(trained, grads):
        torch.testing.assert_close(g, wpaths[path], **_GRAD_TOL,
                                   msg=lambda m: f"{path}: {m}")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_every_gradient_match_the_reference(arch,
                                                         router_margins):
    check_loss_and_grads(arch, router_margins)


def test_loss_chunk_defaults_to_the_flag(monkeypatch):
    _, _, model, params = pair("edge-ladder")
    b = port_batch(batch_np(model.cfg))
    with torch.no_grad():
        monkeypatch.setitem(FLAGS, "loss_chunk", 7)
        flagged = model.loss(params, b)[0]
        assert float(model.loss(params, b, loss_chunk=512)[0]) == \
            pytest.approx(float(flagged), rel=1e-6)
    assert FLAGS["loss_chunk"] == 7
