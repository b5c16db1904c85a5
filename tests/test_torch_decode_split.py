"""K4's split plan (``repro_torch.kernels.decode_attention.split_plan``)
on the CPU.

The plan is held at every ``DECODE_CASES`` shape of ``chip_smoke.py``
and at a sweep of small ones: the splits cover every slot exactly once,
none is empty, each is a whole number of 64-slot tiles except the last,
the grid reaches two blocks per SM wherever the cache has the tiles for
it, and the scores of a split fit the block's shared memory. The
kernels' split-and-merge itself is held on the card by
``tests/test_torch_cuda.py``.
"""
import itertools
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels import decode_attention as da

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (constants only; main() needs a card)


def _check_plan(b, kv, s, g):
    splits, span = da.split_plan(b, kv, s, g)
    assert span > 0 and span % da.TILE == 0
    ranges = [(i * span, min(s, (i + 1) * span)) for i in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == s
    covered = np.zeros(s, np.int64)
    for lo, hi in ranges:
        assert hi > lo                               # no split is empty
        covered[lo:hi] += 1
    assert (covered == 1).all()                      # each slot once
    for lo, hi in ranges[:-1]:
        assert (hi - lo) % da.TILE == 0              # whole tiles
    tiles = -(-s // da.TILE)
    want = -(-2 * da.SMS // (b * kv))
    if tiles >= want:
        assert b * kv * splits >= 2 * da.SMS
    assert 4 * g * span <= da.SCORE_BYTES
    return splits, span


@pytest.mark.parametrize("case", chip_smoke.DECODE_CASES,
                         ids=[f"{c[0]}-{c[2]}" for c in
                              chip_smoke.DECODE_CASES])
def test_split_plan_at_the_smoke_shapes(case):
    _, b, s, h, kv, *_ = case
    splits, span = _check_plan(b, kv, s, h // kv)
    if case[0].startswith("hymba"):                  # 40 pairs, 132 SMs
        assert b * kv * splits >= 264


@pytest.mark.parametrize("b,kv", [(1, 1), (1, 4), (3, 2), (8, 5), (64, 4),
                                  (300, 1)])
def test_split_plan_sweep(b, kv):
    for s, g in itertools.product(
            [1, 2, 63, 64, 65, 127, 128, 129, 500, 1024, 2064, 5000,
             33000], [1, 2, 5, 8, 16]):
        _check_plan(b, kv, s, g)

