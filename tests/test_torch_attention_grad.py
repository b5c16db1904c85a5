"""The attention's gradient in the port against the JAX package's, on the
CPU, float32: ``kernels.flash_attention.plain_backward`` (P2's plain
version, the explicit formulas from the forward's output and row
log-sum-exp) and ``ops.flash_attention`` under autograd (the
``torch.autograd.Function`` a CPU tensor takes) against ``jax.vjp`` of
the reference's jnp mirrors ``repro.models.layers.chunked_attention``
(causal with Sq = Skv, and right-aligned onto a longer kv sequence by its
``q_offset``; no mask with Sq != Skv) and ``local_banded_attention``
(S > window), at every head_dim of K3 (16-256), GQA groups of 1, 2 and 6
and caps of 0, 50 and 2 (``test_torch_attention_lse.py`` holds the
rows' log-sum-exp and the op without grad).

Tolerances: the gradients within 2e-5 absolute + 1e-4 relative, the
outputs within 1e-5 (float32 sums over up to 56 keys in another order:
the reference runs an online softmax over kv chunks, the port an exact
softmax).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import flash_attention, ops
from test_torch_training import one_cpu_thread  # noqa: F401

GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
OUT_TOL = dict(atol=1e-5, rtol=1e-5)
HEAD_DIMS = (16, 32, 64, 128, 256)
MASKS = ("causal", "offset", "full", "banded")
GROUPS = (1, 2, 6)
CAPS = (0.0, 50.0, 2.0)
KV = 2


def _case_list():
    """Every head_dim with every mask kind; the groups and caps in turn,
    so each mask kind meets every group and every cap."""
    out = []
    for i, (hd, mask) in enumerate(itertools.product(HEAD_DIMS, MASKS)):
        out.append((hd, mask, GROUPS[i % 3], CAPS[(i // 3 + i) % 3]))
    return out


CASES = _case_list()


def _shapes(mask):
    """(b, sq, skv, the reference's call, the port's mask kwargs)."""
    if mask == "causal":
        return 2, 40, 40, dict(fn="chunked", causal=True), \
            dict(causal=True, window=0)
    if mask == "offset":         # q right-aligned by the reference's q_offset
        return 1, 24, 56, dict(fn="chunked", causal=True, q_offset=32), \
            dict(causal=True, window=0)
    if mask == "full":
        return 2, 24, 56, dict(fn="chunked", causal=False), \
            dict(causal=False, window=0)
    return 2, 50, 50, dict(fn="banded", window=16), \
        dict(causal=True, window=16)


def _inputs(b, sq, skv, h, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, hd), (b, skv, KV, hd), (b, skv, KV, hd),
                      (b, sq, h, hd))]


def _reference(call, cap):
    kw = dict(call)
    fn = kw.pop("fn")
    if fn == "banded":
        return lambda q, k, v: JL.local_banded_attention(q, k, v,
                                                         softcap=cap, **kw)
    return lambda q, k, v: JL.chunked_attention(q, k, v, chunk=16,
                                                softcap=cap, **kw)


def _ids(c):
    return f"hd{c[0]}-{c[1]}-G{c[2]}-cap{c[3]:g}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_backward_matches_jax_vjp(case):
    hd, mask, g, cap = case
    b, sq, skv, call, kw = _shapes(mask)
    q, k, v, do = _inputs(b, sq, skv, g * KV, hd, seed=hd + g)
    fn = _reference(call, cap)

    def forward_and_vjp(q, k, v, do):
        o, vjp = jax.vjp(fn, q, k, v)
        return o, vjp(do)
    want_o, want = jax.jit(forward_and_vjp)(*map(jnp.asarray, (q, k, v, do)))
    want = [np.asarray(x) for x in want]

    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention.plain_with_lse(tq, tk, tv, softcap=cap, **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **OUT_TOL)
    got = flash_attention.plain_backward(tq, tk, tv, o, lse, tdo,
                                         softcap=cap, **kw)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x.numpy(), y, **GRAD_TOL, err_msg=name)

    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = ops.flash_attention(*leaves, softcap=cap, **kw)
    assert torch.equal(out.detach(), o)
    for name, x, y in zip(("dq", "dk", "dv"),
                          torch.autograd.grad(out, leaves, tdo), got):
        assert torch.equal(x, y), name


def test_the_cases_cover_every_group_and_cap_under_every_mask():
    for mask in MASKS:
        seen = [c for c in CASES if c[1] == mask]
        assert {c[2] for c in seen} == set(GROUPS)
        assert {c[3] for c in seen} == set(CAPS)
    assert {c[0] for c in CASES} == set(HEAD_DIMS)
