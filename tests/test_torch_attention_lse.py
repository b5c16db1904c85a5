"""The forward half of the attention's training path in the port against
the JAX package's, on the CPU, float32: ``plain_with_lse``'s rows'
log-sum-exp (what P2 recomputes P from) against the log-sum-exp of the
reference's masked scores (``repro.models.layers._gqa_scores``, scaled,
capped, masked as its jnp mirrors mask) under each mask kind and cap of
``test_torch_attention_grad.py``; and with grad off (or no input needing
grad) ``ops.flash_attention``'s output and path those of the serving
call, with grad on the differentiable call's. The log-sum-exp within
1e-5 absolute (float32 sums over up to 56 keys in another order).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import flash_attention, ops
from test_torch_attention_grad import CAPS, KV, MASKS, _inputs, _shapes
from test_torch_training import one_cpu_thread  # noqa: F401


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("cap", CAPS)
def test_lse_matches_the_reference_masked_scores(mask, cap):
    b, sq, skv, call, kw = _shapes(mask)
    hd, g = 32, 2
    q, k, v, _ = _inputs(b, sq, skv, g * KV, hd, seed=5)

    @jax.jit
    def reference_lse(q, k):
        s = JL._gqa_scores(JL._split_groups(q, KV), k) / math.sqrt(hd)
        if cap:                                      # (B, KV, G, Sq, Skv)
            s = jnp.tanh(s / cap) * cap
        q_pos = jnp.arange(sq)[:, None] + (skv - sq)
        kv_pos = jnp.arange(skv)[None, :]
        keep = jnp.ones((sq, skv), bool)
        if kw["causal"]:
            keep &= kv_pos <= q_pos
        if kw["window"]:
            keep &= kv_pos > q_pos - kw["window"]
        return jax.nn.logsumexp(jnp.where(keep, s, JL.NEG_INF), axis=-1)
    want = np.asarray(reference_lse(jnp.asarray(q), jnp.asarray(k)))
    want = want.reshape(b, g * KV, sq)
    _, lse = flash_attention.plain_with_lse(
        *map(torch.from_numpy, (q, k, v)), softcap=cap, **kw)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("mask", MASKS)
def test_without_grad_the_op_is_the_serving_call(mask):
    b, sq, skv, _, kw = _shapes(mask)
    q, k, v, _ = map(torch.from_numpy, _inputs(b, sq, skv, 4, 32, seed=6))
    want = flash_attention.plain(q, k, v, **kw)
    out = ops.flash_attention(q, k, v, **kw)          # no input needs grad
    assert out.grad_fn is None and torch.equal(out, want)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    with torch.no_grad():
        out = ops.flash_attention(*leaves, **kw)
    assert out.grad_fn is None and torch.equal(out, want)
    out = ops.flash_attention(*leaves, **kw)          # the training call
    assert out.grad_fn is not None and torch.equal(out.detach(), want)
