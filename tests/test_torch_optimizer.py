"""The port's AdamW step (``repro_torch.training.optimizer``) against the
reference's as ``jax.jit`` compiles it, bit for bit on the CPU, with the
gradient norm above the clip.

XLA keeps the clip scale ``clip / (norm + 1e-9)`` and ``v / b2c`` as
divisions, rewrites ``(m / b1c) / (sqrt(v / b2c) + eps)`` as one division
by a product and fuses the moment and parameter updates into
multiply-adds; the port computes the same, so every leaf is equal.
Gradients are multiples of 1/4 or 1/512, whose squares sum exactly in
any order, so the global norm does not depend on how the two libraries
order their sums.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optimizer as jopt
from repro_torch.training import optimizer


def _leaves(tree):
    return [np.asarray(p[k]) for p in tree for k in sorted(p)]


def _assert_bits(got, want):
    for g, w in zip(_leaves(got), _leaves(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


def _pair(shapes, seed):
    rng = np.random.default_rng(seed)
    jp = [{k: jnp.asarray(rng.standard_normal(s).astype(np.float32))
           for k, s in layer.items()} for layer in shapes]
    pp = [{k: torch.tensor(np.asarray(v)) for k, v in layer.items()}
          for layer in jp]
    return jp, pp, rng


def test_the_smallest_clipped_step_equals_the_reference():
    """Clip 10 at a norm of 25.3: the reference's scale is the quotient
    0.39525694; a reciprocal product gives 0.3952569."""
    cfg_j, cfg_p = jopt.constant_lr_adamw(1e-3), \
        optimizer.constant_lr_adamw(1e-3)
    jp, pp, _ = _pair([{"w": (1,)}], 0)
    g = np.asarray([25.3], np.float32)
    jp2, js, jm = jax.jit(lambda p, gr, s: jopt.apply_updates(
        p, gr, s, cfg_j))(jp, [{"w": jnp.asarray(g)}],
                          jopt.init_opt_state(jp))
    ps = optimizer.init_opt_state(pp)
    pp2, ps, pm = optimizer.apply_updates(pp, [{"w": torch.tensor(g)}], ps,
                                          cfg_p)
    assert float(pm["grad_norm"]) == float(jm["grad_norm"]) == \
        np.float32(25.3)
    scale = np.float32(10.0) / (np.float32(25.3) + np.float32(1e-9))
    assert scale == np.float32(0.39525694)
    assert ps["m"][0]["w"].numpy()[0] == np.float32(0.1) * (g[0] * scale)
    _assert_bits(ps["m"], js["m"])
    _assert_bits(ps["v"], js["v"])
    _assert_bits(pp2, jp2)


@pytest.mark.parametrize("clip", [10.0, 1.0])
def test_forty_steps_equal_the_jitted_reference(clip):
    """An MLP's leaves over 40 steps, two in three clipped."""
    cfg_j = jopt.constant_lr_adamw(1e-3, grad_clip=clip)
    cfg_p = optimizer.constant_lr_adamw(1e-3, grad_clip=clip)
    shapes = [{"w": (11, 64), "b": (64,)}, {"w": (64, 10), "b": (10,)}]
    jp, pp, rng = _pair(shapes, 1)
    js, ps = jopt.init_opt_state(jp), optimizer.init_opt_state(pp)
    step = jax.jit(lambda p, g, s: jopt.apply_updates(p, g, s, cfg_j))
    clipped = 0
    for i in range(40):
        denom = 4.0 if i % 3 != 2 else 512.0
        g = [{k: (rng.integers(-8, 9, s) / denom).astype(np.float32)
              for k, s in layer.items()} for layer in shapes]
        jp, js, jm = step(jp, [{k: jnp.asarray(v) for k, v in layer.items()}
                               for layer in g], js)
        pp, ps, pm = optimizer.apply_updates(
            pp, [{k: torch.tensor(v) for k, v in layer.items()}
                 for layer in g], ps, cfg_p)
        assert float(pm["grad_norm"]) == float(jm["grad_norm"])
        clipped += float(jm["grad_norm"]) > clip
        _assert_bits(pp, jp)
        _assert_bits(ps["m"], js["m"])
        _assert_bits(ps["v"], js["v"])
    assert clipped >= 20
