"""One training step of the port (``training.make_train_step``) against
the JAX package's (``repro.training``), on the CPU, float32, on the
reference's weights at the reduced cut (``test_torch_training.py``'s
``pair``): the params after one AdamW step, ``lr``, ``grad_norm`` and
the loss; and three steps on the synthetic stream
(``test_torch_train_remat.py`` holds the decayed leaves and the remat
policies).

Tolerances: after one step the params within 1e-6 absolute + 1e-5
relative (the first update of a leaf is lr g / (|g| + eps); these steps
take eps 1e-6, not the default 1e-8, since for a gradient within a few
eps of 0 the update's slope 1 / eps would turn float32 noise of ~1e-9 in
g into a visible move; at 1e-6 it stays below 1e-6 of lr);
``grad_norm`` within 1e-5 relative (the port sums its per-layer leaves,
the reference its stacked ones, in another order); ``lr`` equal; the
loss within ``LOSS_RTOL``; three steps' losses within 1e-5
relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jbuild_model
from repro.training import AdamWConfig as JAdamW
from repro.training import init_opt_state as jinit_opt
from repro.training import make_train_step as jmake_step
from repro.training.data import batches as jbatches
from repro_torch import convert
from repro_torch.training import AdamWConfig, make_train_step
from repro_torch.training.data import batches
from repro_torch.training.optimizer import (init_opt_state,
                                            tree_leaves_with_path)
from repro_torch.tuning import FLAGS
from test_torch_training import (LOSS_RTOL, MARGIN, _host, batch_np, cfgs,
                                 pair, port_batch, port_loss_and_grads,
                                 one_cpu_thread, router_margins)  # noqa: F401


def _opt_cfg():
    return dict(lr=1e-3, warmup_steps=2, total_steps=10, eps=1e-6)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m"])
def test_one_train_step_matches_the_reference(arch, router_margins):
    """Params after one step, ``lr``, ``grad_norm`` and the loss; and the
    leaves the reference decays (weight decay 0.1 on leaves of its
    stacked rank >= 2: all of ``segments``, not ``final_norm``) are the
    port's: with a zero gradient a decayed leaf moves by lr * 0.1 * p."""
    jm, jp, model, params = pair(arch)
    b = batch_np(model.cfg)
    jstep = jax.jit(jmake_step(jm, JAdamW(**_opt_cfg())))
    jstate, jmet = jstep({"params": jp, "opt": jinit_opt(jp)},
                         {k: jnp.asarray(v) for k, v in b.items()})
    step = make_train_step(model, AdamWConfig(**_opt_cfg()))
    state, met = step({"params": params, "opt": init_opt_state(params)},
                      port_batch(b))
    assert met["lr"] == float(jmet["lr"])
    assert float(met["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]),
                                                    rel=1e-5)
    assert float(met["total_loss"]) == pytest.approx(
        float(jmet["total_loss"]), rel=LOSS_RTOL)
    want = dict(tree_leaves_with_path(convert.model_params(
        _host(jstate["params"]), model.cfg, device="cpu")))
    for path, p in tree_leaves_with_path(state["params"]):
        torch.testing.assert_close(p.detach(), want[path], atol=1e-6,
                                   rtol=1e-5, msg=lambda m: f"{path}: {m}")
    assert state["opt"]["step"] == 1
    if model.cfg.moe is not None:
        assert min(router_margins) > MARGIN


def test_three_steps_on_the_stream_give_the_reference_losses(
        router_margins):
    jm, jp, model, params = pair("granite-moe-1b-a400m")
    opt = dict(lr=3e-3, warmup_steps=1, total_steps=3)
    jstep = jax.jit(jmake_step(jm, JAdamW(**opt)))
    step = make_train_step(model, AdamWConfig(**opt))
    jstate = {"params": jp, "opt": jinit_opt(jp)}
    state = {"params": params, "opt": init_opt_state(params)}
    got, want = [], []
    for jb, b in zip(jbatches(model.cfg.vocab_size, 2, 33, 3, seed=4),
                     batches(model.cfg.vocab_size, 2, 33, 3, seed=4)):
        assert np.array_equal(jb["tokens"], b["tokens"])
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(jb["tokens"])})
        state, met = step(state, port_batch(b))
        want.append(float(jmet["loss"]))
        got.append(float(met["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    assert min(router_margins) > MARGIN
