"""The port's synthetic token stream and checkpoints against the JAX
package's, on the CPU: ``training.data.SyntheticLM`` / ``batches``
bit-equal to ``repro.training.data``'s at vocab 64 and 512, with
extras (the row-wise cumulative table equal to the reference's per-step
``cumsum``, and the binary-search draw equal to its ``argmax`` rule at
draws that sit exactly on, just beside and past the table's values);
``checkpoint.save_pytree`` / ``load_pytree`` round-tripping a tree of
dicts and lists of mixed dtypes with bfloat16, a file written by either
package read equal by the other, and the same sidecar. Everything is
compared bit for bit.
"""
import json

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jload
from repro.checkpoint import save_pytree as jsave
from repro.training.data import SyntheticLM as JSyntheticLM
from repro.training.data import batches as jbatches
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.training.data import SyntheticLM, batches, next_tokens
from repro_torch.training.optimizer import tree_leaves_with_path


@pytest.mark.parametrize("vocab", [64, 512])
def test_stream_is_the_reference_bit_for_bit(vocab):
    extras = {"frames": lambda b: np.random.default_rng(0).standard_normal(
        (b, 3, 8), dtype=np.float32)}
    got = list(batches(vocab, 4, 40, 3, seed=7, extras=extras))
    want = list(jbatches(vocab, 4, 40, 3, seed=7, extras=extras))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])


@pytest.mark.parametrize("vocab", [64, 512])
def test_cumulative_table_is_the_reference_per_step_cumsum(vocab):
    src, ref = SyntheticLM(vocab, seed=3), JSyntheticLM(vocab, seed=3)
    assert src.cdf.dtype == ref.probs.dtype
    assert np.array_equal(src.cdf, np.cumsum(ref.probs, axis=1))
    rows = np.array([0, vocab - 1, 5])
    assert np.array_equal(src.cdf[rows], np.cumsum(ref.probs[rows], axis=1))


def test_draw_equals_the_reference_rule_at_the_table_values():
    cdf = np.cumsum(np.random.default_rng(0).dirichlet(np.ones(9), 4)
                    .astype(np.float32), axis=1)
    cur = np.array([0, 1, 2, 3, 0, 1, 2, 3])
    rows = cdf[cur].astype(np.float64)
    u = np.concatenate([rows[:4, 3],                        # exactly on
                        np.nextafter(rows[4:, 5], 0.0)])    # just below
    us = [u, np.nextafter(u, 1.0), np.full(8, 0.0),
          np.maximum(rows[:, -1], np.nextafter(1.0, 0.0))]  # past the last
    for x in us:
        want = (x[:, None] < cdf[cur]).argmax(axis=1)
        assert np.array_equal(next_tokens(cdf, cur, x), want)


def _trees():
    """The same tree of dicts and lists for the port (torch) and the
    reference (jnp): bf16, float32, int32 (a 0-d step among them) and
    int8 leaves."""
    rng = np.random.default_rng(1)
    bf = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)) \
        .to(torch.bfloat16)
    f32 = rng.standard_normal((4,)).astype(np.float32)
    i32 = rng.integers(-9, 9, (2, 2)).astype(np.int32)
    i8 = rng.integers(-127, 127, (6,)).astype(np.int8)
    port = {"segments": [{"w": bf, "g": torch.from_numpy(f32)},
                         {"q": torch.from_numpy(i8)}],
            "embed": {"idx": torch.from_numpy(i32)},
            "step": torch.tensor(3, dtype=torch.int32)}
    ref = {"segments": [{"w": jnp.asarray(bf.float().numpy(), jnp.bfloat16),
                         "g": jnp.asarray(f32)}, {"q": jnp.asarray(i8)}],
           "embed": {"idx": jnp.asarray(i32)},
           "step": jnp.asarray(3, jnp.int32)}
    return port, ref


def _same(port, ref_tree):
    """Every leaf of a port tree equal, dtype included, to the reference
    tree's leaf at the same path."""
    want = dict(tree_leaves_with_path(ref_tree))
    for path, x in tree_leaves_with_path(port):
        w = want[path]
        if x.dtype == torch.bfloat16:
            assert w.dtype == jnp.bfloat16
            assert np.array_equal(x.view(torch.int16).numpy(),
                                  np.asarray(w).view(np.int16)), path
        else:
            assert np.array_equal(x.numpy(), np.asarray(w)), path
            assert x.numpy().dtype == np.asarray(w).dtype, path


def test_round_trip_of_mixed_dtypes(tmp_path):
    """bf16, float32, int32 and int8 tensors and a Python int (an
    optimizer state's step) come back equal, in ``like``'s types."""
    port, _ = _trees()
    port["n"] = 7
    save_pytree(str(tmp_path / "ck" / "t"), port)
    like = {"segments": [{"w": torch.zeros(3, 5, dtype=torch.bfloat16),
                          "g": torch.zeros(4)},
                         {"q": torch.zeros(6, dtype=torch.int8)}],
            "embed": {"idx": torch.zeros(2, 2, dtype=torch.int32)},
            "step": torch.zeros((), dtype=torch.int32), "n": 0}
    back = load_pytree(str(tmp_path / "ck" / "t"), like)
    for (p, x), (q, y) in zip(tree_leaves_with_path(back),
                              tree_leaves_with_path(port)):
        assert p == q
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), p
        else:
            assert x == y, p


def test_either_package_reads_the_other_file(tmp_path):
    port, ref = _trees()
    jsave(str(tmp_path / "ref"), ref)
    save_pytree(str(tmp_path / "port"), port)
    _same(load_pytree(str(tmp_path / "ref"), port), ref)
    _same(port, jload(str(tmp_path / "port"), ref))
    assert np.asarray(jload(str(tmp_path / "port"), ref)["segments"][0]["w"]
                      ).dtype == ml_dtypes.bfloat16


def test_the_same_sidecar_and_stored_arrays(tmp_path):
    port, ref = _trees()
    jsave(str(tmp_path / "ref"), ref)
    save_pytree(str(tmp_path / "port"), port)
    with open(tmp_path / "ref.json") as f, open(tmp_path / "port.json") as g:
        assert json.load(f) == json.load(g)
    assert (tmp_path / "ref.json").read_text() == \
        (tmp_path / "port.json").read_text()
    a, b = np.load(tmp_path / "ref.npz"), np.load(tmp_path / "port.npz")
    assert list(a.keys()) == list(b.keys())
    assert "segments/0/w" in a and a["segments/0/w"].dtype == np.uint16
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
