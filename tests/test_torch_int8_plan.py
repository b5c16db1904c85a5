"""K5 (the int8 matmul) around its kernel, on the CPU: the plan
(``repro_torch.kernels.int8_matmul.plan``), the bfloat16 output through
the dispatch seam and ``layers.linear``, and the K-major int8 weight that
``layers.init_linear`` and ``convert.model_params`` hold
(``int8_matmul.k_major``).

The plan is held at every ``INT8_SHAPES`` shape of ``chip_smoke.py``, the
edge ladder's decode shapes and ragged ones: rows of at most 64 take the
decode instance, the others the prefill one, and the tiles cover M x N.
The int8 product is exact on both packages, and its bfloat16 output is one
round to nearest even of the same float32 value, so the port's plain
path and the reference (its jnp oracle and its Pallas kernel in
interpret mode) are compared bit for bit, as float32. The kernel itself
is held on the card by ``tests/test_torch_cuda.py``.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro.models.variants import build_ladder as jbuild_ladder
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import int8_matmul as im
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model, layers
from repro_torch.models.variants import build_ladder

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (constants only; main() needs a card)

RAGGED = ((1, 1, 1), (1, 256, 64), (17, 333, 65), (65, 48, 257),
          (300, 64, 256), (4096, 1024, 256), (64, 16384, 256),
          (1, 33408, 64), (129, 100000, 7), (64, 2048, 100))


def _check_plan(m, k, n):
    bm, bn = im.plan(m, n, k)
    assert (bm, bn) == ((64, 64) if m <= im.DECODE_ROWS else (128, 256))
    tiles_m, tiles_n = -(-m // bm), -(-n // bn)
    assert tiles_m * bm >= m > (tiles_m - 1) * bm              # M covered
    assert tiles_n * bn >= n > (tiles_n - 1) * bn              # N covered
    return bm, bn


@pytest.mark.parametrize("m,k,n", chip_smoke.INT8_SHAPES)
def test_int8_plan_at_the_served_shapes_splits_nothing(m, k, n):
    """The path's shapes: one block per output tile sweeps all of K;
    the decode rows take the 64-row instance."""
    assert len(im.plan(m, n, k)) == 2                # (bm, bn): no split
    bm, _ = _check_plan(m, k, n)
    assert (bm == 64) == (m <= 64)


@pytest.mark.parametrize("m,k,n", RAGGED)
def test_int8_plan_covers_ragged_shapes(m, k, n):
    _check_plan(m, k, n)


@pytest.mark.parametrize("shape", [(7, 5), (256, 1024), (3, 48, 80)])
def test_k_major_keeps_the_values_in_k_major_storage(shape):
    """``k_major`` holds the (..., K, N) weight's values in (..., N, K)
    row-major storage, and leaves a K-major weight as it is."""
    g = torch.Generator().manual_seed(shape[-1])
    w = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
    kw = im.k_major(w)
    assert torch.equal(kw, w) and kw.shape == w.shape
    assert kw.transpose(-1, -2).is_contiguous()
    assert kw.stride()[-2:] == (1, shape[-2])
    assert torch.equal(im.k_major(kw), w)


def test_int8_decode_shapes_of_the_edge_ladder_are_in_the_smoke():
    shapes = set(chip_smoke.INT8_SHAPES)
    assert {(64, 256, 1024), (64, 1024, 256)} <= shapes
    assert {(64, 4096, 16384), (64, 8192, 4096)} <= shapes


def _quantized(rng, m, k, n):
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    jxq, jsx = jref.quantize_ref(jnp.asarray(x))
    jwq, jsw = jref.quantize_ref(jnp.asarray(w), axis=0)
    xq, sx = ref.quantize_ref(torch.tensor(x))
    wq, sw = ref.quantize_ref(torch.tensor(w), dim=0)
    return (jxq, jsx, jwq, jsw), (xq, sx, im.k_major(wq), sw)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("m,k,n", [(100, 200, 300), (17, 333, 65),
                                   (64, 256, 128)])
def test_int8_matmul_bf16_out_is_bit_exact(impl, m, k, n):
    """``ops.int8_matmul(..., out_dtype=bfloat16)`` on a K-major weight
    against ``repro.kernels.ops.int8_matmul(..., out_dtype=bfloat16)``."""
    rng = np.random.default_rng(m * k + n)
    jargs, args = _quantized(rng, m, k, n)
    got = ops.int8_matmul(*args, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    want = jops.int8_matmul(*jargs, impl=impl, bm=64, bn=64, bk=64,
                            out_dtype=jnp.bfloat16)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    # and one rounding of the float32 product
    f32 = ops.int8_matmul(*args)
    assert torch.equal(got, f32.to(torch.bfloat16))


@pytest.mark.parametrize("shape", [(3, 5, 256), (2, 7, 64)])
def test_linear_matches_reference_in_bfloat16(shape):
    """``layers.linear`` on the reference's int8 weights with bfloat16
    input: quantization, K5 with a bfloat16 output, bit for bit."""
    d_in, d_out = shape[-1], 96
    jp = jlayers.init_linear(jax.random.PRNGKey(d_in), d_in, d_out,
                             jnp.float32, "int8")
    p = {"w_q": im.k_major(torch.tensor(np.asarray(jp["w_q"]))),
         "s": torch.tensor(np.asarray(jp["s"]))}
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    x[..., 0] = 0.0
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.tensor(x).to(torch.bfloat16)
    np.testing.assert_array_equal(tx.float().numpy(),
                                  np.asarray(jx, np.float32))
    got = layers.linear(p, tx)
    want = jlayers.linear(jp, jx)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert got.shape == shape[:-1] + (d_out,)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def _k_major(t):
    return t.dim() == 2 and t.stride() == (1, t.shape[0])


def test_init_linear_holds_the_int8_weight_k_major():
    d_in, d_out = 48, 80
    p = layers.init_linear(torch.Generator().manual_seed(0), d_in, d_out,
                           quant="int8")
    assert p["w_q"].dtype == torch.int8 and _k_major(p["w_q"])
    # the values of the row-major quantization of the same draw
    w = torch.randn((d_in, d_out), generator=torch.Generator()
                    .manual_seed(0)) * (1.0 / d_in ** 0.5)
    s = w.abs().amax(0, keepdim=True) / 127.0 + 1e-8
    assert torch.equal(p["w_q"], torch.clamp(torch.round(w / s), -127, 127)
                       .to(torch.int8))
    assert torch.equal(p["s"], s)


def _int8_leaves(tree, path=()):
    if isinstance(tree, dict):
        if "w_q" in tree:
            yield path, tree
            return
        for k, v in tree.items():
            yield from _int8_leaves(v, path + (k,))


@pytest.mark.parametrize("arch,vid", [("edge-ladder", "d4"),
                                      ("edge-ladder", "d7"),
                                      ("falcon-mamba-7b", "d4")])
def test_converted_int8_weights_are_k_major_with_the_reference_values(
        arch, vid):
    jcfg, cfg = jget_config(arch), get_config(arch)
    if arch != "edge-ladder":
        jcfg, cfg = jreduced(jcfg), reduced(cfg)
    jcfg = jbuild_ladder(jcfg)[vid].cfg
    cfg = dataclasses.replace(build_ladder(cfg)[vid].cfg, dtype="float32")
    jp = jbuild_model(dataclasses.replace(jcfg, dtype="float32")).init(
        jax.random.PRNGKey(2))
    host = jax.tree_util.tree_map(np.asarray, jp)
    p = convert.model_params(host, cfg, device="cpu")
    n = 0
    for li, layer in enumerate(p["segments"][0]):
        want = jax.tree_util.tree_map(lambda a: a[li],
                                      host["segments"][0])
        for path, lin in _int8_leaves(layer):
            ref_lin = want
            for key in path:
                ref_lin = ref_lin[key]
            assert lin["w_q"].dtype == torch.int8 and _k_major(lin["w_q"])
            np.testing.assert_array_equal(lin["w_q"].numpy(),
                                          ref_lin["w_q"])
            n += 1
    assert n > 0
    # the port's own init holds them so too
    own = build_model(cfg).init(0, device="cpu")
    assert all(_k_major(lin["w_q"])
               for _, lin in _int8_leaves(own["segments"][0][0]))
