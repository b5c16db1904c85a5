"""K6's lane plan (``repro_torch.kernels.selective_scan.plan``) and the
arithmetic of its kernel, on the CPU.

The plan is held at ``chip_smoke.py``'s ``SCAN_CASES`` and at every card
case of ``tests/test_torch_cuda.py``: the lanes of a channel hold all N
states between them, the blocks cover every channel and batch row, a
lane count is the fewest that reach the plan's block goal, and the
served shapes land where the kernel's design puts them (Falcon-Mamba two
lanes, Hymba four). A plain PyTorch mirror of the kernel's arithmetic
(``exp2`` of ``dt`` times ``A log2(e)``, the states split over the
plan's lanes and their ``y`` summed as the lanes' shuffles sum it) is
held against the reference's sequential oracle at the tolerance of
``tests/test_kernels.py``'s scan tests: 1e-4 in float32. The kernel
itself is held on the card by ``tests/test_torch_cuda.py``.
"""
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import selective_scan as K6

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke  # noqa: E402  (constants only; main() needs a card)
import test_torch_cuda as card  # noqa: E402  (shapes only)

SHAPES = sorted({(bt, di, chip_smoke.SCAN_STATE)
                 for _, bt, _, di, _ in chip_smoke.SCAN_CASES}
                | {(bt, di, n) for bt, _, di, n in card.SCAN_SHAPES}
                | {(bt, di, n) for bt, _, di, n, _ in card.SCAN_SPLIT_SHAPES})


def _blocks(bt, di, lanes):
    return bt * -(-di // (K6.THREADS // lanes))


@pytest.mark.parametrize("bt,di,n", SHAPES)
def test_plan_covers_states_channels_and_batches(bt, di, n):
    lanes, per_lane = K6.plan(bt, di, n)
    assert lanes in K6.LANES and K6.THREADS % lanes == 0
    assert 32 % lanes == 0                   # a channel's lanes in one warp
    assert lanes * per_lane == K6.MAX_STATE >= n
    assert per_lane % 4 == 0                 # float4 reads of B and C
    ch = K6.THREADS // lanes
    blocks_x = -(-di // ch)
    assert blocks_x * ch >= di > (blocks_x - 1) * ch        # channels
    assert bt <= 65535                                      # grid rows
    # the fewest lanes that reach the goal, else the most
    if lanes < max(K6.LANES):
        assert _blocks(bt, di, lanes) >= K6.WANT_BLOCKS
    for fewer in K6.LANES[:K6.LANES.index(lanes)]:
        assert _blocks(bt, di, fewer) < K6.WANT_BLOCKS


@pytest.mark.parametrize("bt,s,di,n,lanes", card.SCAN_SPLIT_SHAPES)
def test_card_split_cases_land_on_their_lane_counts(bt, s, di, n, lanes):
    assert K6.plan(bt, di, n)[0] == lanes
    assert s % 32                            # a partial last time chunk


def test_served_shapes_take_the_designed_split():
    """Falcon-Mamba's prefill (64 x 8,192 channels) fills the card with
    two lanes a channel, 8,192 blocks; Hymba's (8 x 3,200) takes four,
    800 blocks in place of 400."""
    assert K6.plan(64, 8192, 16) == (2, 8)
    assert _blocks(64, 8192, 2) == 8192
    assert K6.plan(8, 3200, 16) == (4, 4)
    assert (_blocks(8, 3200, 2), _blocks(8, 3200, 4)) == (400, 800)
    assert {K6.plan(bt, di, 16)[0]
            for _, bt, _, di, _ in chip_smoke.SCAN_CASES} == set(K6.LANES)


@pytest.mark.parametrize("n", [0, 17])
def test_plan_refuses_state_sizes_the_kernel_does_not_hold(n):
    with pytest.raises(ValueError, match="state sizes"):
        K6.plan(8, 3200, n)


def _kernel_mirror(u, dt, A, B, C, D, lanes):
    """The kernel's arithmetic in plain float32 PyTorch: A scaled by
    log2(e) once, each decay ``exp2(dt * a')``, the states padded to 16
    and split into ``lanes`` groups, each group's C product summed on its
    own and the groups' sums combined pairwise (the xor shuffles)."""
    bt, s, di = u.shape
    n = A.shape[1]
    pad = K6.MAX_STATE - n
    a2 = torch.nn.functional.pad(A * math.log2(math.e), (0, pad))
    Bp = torch.nn.functional.pad(B, (0, pad))
    Cp = torch.nn.functional.pad(C, (0, pad))
    h = torch.zeros((bt, di, K6.MAX_STATE))
    ys = []
    for t in range(s):
        du = dt[:, t] * u[:, t]
        h = h * torch.exp2(dt[:, t, :, None] * a2) + du[..., None] \
            * Bp[:, t, None, :]
        part = (h * Cp[:, t, None, :]).reshape(bt, di, lanes, -1).sum(-1)
        while part.shape[-1] > 1:
            part = part[..., 0::2] + part[..., 1::2]
        ys.append(part[..., 0] + u[:, t] * D)
    return torch.stack(ys, 1), h[..., :n]


@pytest.mark.parametrize("lanes", K6.LANES)
@pytest.mark.parametrize("n", [5, 16])
def test_kernel_arithmetic_matches_the_reference(lanes, n):
    rng = np.random.default_rng(lanes * 100 + n)
    bt, s, di = 2, 40, 24
    u = (rng.standard_normal((bt, s, di)) * 0.5).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((bt, s, di)))) * 0.1) \
        .astype(np.float32)
    A = (-np.exp(rng.standard_normal((di, n)) * 0.3)).astype(np.float32)
    B, C = (rng.standard_normal((bt, s, n)).astype(np.float32)
            for _ in range(2))
    D = rng.standard_normal(di).astype(np.float32)
    y, h = _kernel_mirror(*(torch.tensor(x) for x in (u, dt, A, B, C, D)),
                          lanes)
    jy, jh = jref.selective_scan_ref(*(jnp.asarray(x)
                                       for x in (u, dt, A, B, C, D)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4, rtol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-4, rtol=0)
