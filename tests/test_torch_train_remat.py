"""The training forward's rematerialisation and the optimizer's weight
decay, on the CPU: remat off, ``"full"`` and ``"dots"``
(``FLAGS["remat_policy"]``) with chunks of 32 and of 7 (S - 1 = 80 is
no multiple of 7) give the same loss, aux loss and gradients (within
1e-6 relative on the loss, 1e-7 absolute + 1e-5 relative on the
gradients: the same sums, chunked otherwise); and ``apply_updates``
decays the leaves the JAX package's decays (its stacked rank), equal
to its step within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import build_model as jbuild_model
from repro.training import AdamWConfig as JAdamW
from repro.training import init_opt_state as jinit_opt
from repro_torch import convert
from repro_torch.training import AdamWConfig
from repro_torch.training.optimizer import (init_opt_state,
                                            tree_leaves_with_path)
from repro_torch.tuning import FLAGS
from test_torch_training import (MARGIN, _host, batch_np, cfgs, pair,
                                 port_batch, port_loss_and_grads,
                                 one_cpu_thread, router_margins)  # noqa: F401


def test_remat_dots_and_a_ragged_loss_chunk_give_the_same_loss(
        monkeypatch, router_margins):
    """Remat off, ``"full"`` and ``"dots"``, and chunks of 32 and of 7
    (S - 1 = 80 is no multiple of 7): the same loss, aux loss and
    gradients, to float32 rounding (the chunks' sums in another
    order)."""
    _, _, model, params = pair("granite-moe-1b-a400m")
    b = port_batch(batch_np(model.cfg))
    want = port_loss_and_grads(model, params, b, remat=False, loss_chunk=32)
    for policy, chunk in (("full", 32), ("full", 7), ("dots", 7)):
        monkeypatch.setitem(FLAGS, "remat_policy", policy)
        got = port_loss_and_grads(model, params, b, remat=True,
                                  loss_chunk=chunk)
        assert float(got[0]) == pytest.approx(float(want[0]), rel=1e-6)
        assert float(got[1]["aux_loss"]) == float(want[1]["aux_loss"])
        for g, w in zip(got[2], want[2]):
            torch.testing.assert_close(g, w, atol=1e-7, rtol=1e-5)
    assert min(router_margins) > MARGIN


def test_decayed_leaves_follow_the_reference_stacked_rank():
    """With a zero gradient AdamW's update is the decay alone: a leaf the
    reference decays moves by -lr * wd * p, the others stay. The
    reference stacks a segment's layers, so every leaf under
    ``segments`` (norm gains included) is decayed there; ``final_norm``
    is not; an encoder's segments are decayed too."""
    from repro.training.optimizer import apply_updates as japply
    japply = jax.jit(japply, static_argnums=3)
    _, cfg = cfgs("whisper-medium")
    jcfg, _ = cfgs("whisper-medium")
    jm = jbuild_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(3))
    jp = jax.tree_util.tree_map(lambda a: a + 0.5, jp)    # gains nonzero
    opt = AdamWConfig(lr=0.5, warmup_steps=0, total_steps=10**6,
                      min_lr_frac=1.0)
    jnew, _, _ = japply(jp, jax.tree_util.tree_map(jnp.zeros_like, jp),
                        jinit_opt(jp), JAdamW(**dataclasses.asdict(opt)))
    from repro_torch.training.optimizer import apply_updates
    params = convert.model_params(_host(jp), cfg, device="cpu")
    before = {p: x.clone() for p, x in tree_leaves_with_path(params)}
    zeros = convert.model_params(_host(jax.tree_util.tree_map(
        jnp.zeros_like, jp)), cfg, device="cpu")
    apply_updates(params, zeros, init_opt_state(params), opt)
    want = dict(tree_leaves_with_path(convert.model_params(
        _host(jnew), cfg, device="cpu")))
    moved = set()
    for path, p in tree_leaves_with_path(params):
        torch.testing.assert_close(p, want[path], atol=1e-6, rtol=1e-6)
        if not torch.equal(p, before[path]):
            moved.add(path)
    assert ("final_norm", "g") not in moved
    assert ("encoder", "final_norm", "g") not in moved
    assert ("segments", 0, 0, "ln1", "g") in moved
    assert ("encoder", "segments", 0, 1, "ln1", "g") in moved
    assert ("embed", "w") in moved
