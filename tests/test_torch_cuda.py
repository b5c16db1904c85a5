"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at shapes ``chip_smoke.py`` does not reach: rows wider than the
tabular kernel's register path, odd hidden widths, masked rows and the
infeasible fallback of the head, and the head's combo search at the
fleet's width under both masks, at a threshold met exactly, with cells
of no member, a member with every top-k entry masked, every q tied, one
user and the most users; attention with sequences that are no
tile multiple, one kv head and a window, the bf16 tensor-core instance of
flash attention at the edges of its tiles and masks, and decode attention
split over many slot ranges with wholly masked splits and rows; the int8
product on the K-major weight at ragged M, N and K (K zero-padded to a
multiple of 32), M = 1, in float32 and bfloat16, and a row-major weight
refused; the
selective scan at one step, 4,096 steps, state sizes 5, 8 and 16,
channel counts that are no block multiple and both splits of a channel's
states, over 2 and over 4 lanes; the banded sliding-window
attention against the CPU's plain path; the coupled oracle's
best-response round against its plain version (one cell, every cell on
one edge, an infinite cloud, a calibration, one-user cells, tied
candidates, one feasible candidate) and the float32 fleet env step
against the CPU, bit for bit.
Every test here needs a CUDA device
and skips without one; run them on the GPU with

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.kernels import (decode_attention, dqn_head,
                                 flash_attention, int8_matmul, ops, ref,
                                 selective_scan, tabular_rl)
from repro_torch.core import spaces
from repro_torch.models import layers


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("cells,states,k", [(1, 4, 5), (37, 9, 256),
                                            (64, 16, 1000), (1000, 36, 243)])
def test_tabular_kernel_matches_plain(cuda, cells, states, k):
    g = torch.Generator(device=cuda).manual_seed(cells)
    q = torch.round(torch.randn((cells, states, k), generator=g,
                                device=cuda) * 2) / 2         # ties
    s = torch.randint(0, states, (cells,), generator=g, device=cuda).int()
    a = torch.randint(0, k, (cells,), generator=g, device=cuda).int()
    s2 = torch.where(torch.arange(cells, device=cuda) % 2 == 0, s,
                     torch.randint(0, states, (cells,), generator=g,
                                   device=cuda).int())
    r = -torch.rand(cells, generator=g, device=cuda)
    before = tabular_rl.KERNEL.launches
    got = tabular_rl.tabular_rl_cuda(q.clone(), s, a, r, s2, alpha=0.9,
                                     gamma=0.1)
    want = ref.fused_tabular_ref(q.clone(), s, a, r, s2, alpha=0.9,
                                 gamma=0.1)
    assert tabular_rl.KERNEL.launches == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def _head_args(cuda, cells, users, hidden, seed, allowed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    member = torch.rand((cells, users), generator=g, device=cuda) < 0.8
    member[:, 0] = True
    active = (member & (torch.rand((cells, users), generator=g,
                                   device=cuda) < 0.7)).float()
    end_b = (torch.rand((cells, users), generator=g, device=cuda)
             < 0.5).float()
    agg = torch.randn((cells, 8), generator=g, device=cuda)
    dims = [11, hidden, hidden, 10]
    ws = [torch.randn((a, b), generator=g, device=cuda) * 0.3
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.randn(b, generator=g, device=cuda) * 0.1 for b in dims[1:]]
    acc = torch.tensor([89.9, 88.2, 84.9, 74.2, 88.9, 87.0, 83.2, 72.8,
                        89.9, 89.9], device=cuda)
    return (active, member.float(), end_b, agg, ws[0], bs[0], ws[1], bs[1],
            ws[2], bs[2], torch.tensor(allowed, device=cuda), acc)


def _check_head(args, threshold, topk=3):
    """q within 1e-5 of the plain version (cuBLAS sums in another order);
    decisions bit-exact against the plain decision logic applied to the
    kernel's own q, so rounding of the products cannot flip a tie."""
    before = dqn_head.KERNEL.launches
    d_k, q_k = dqn_head.dqn_head_cuda(*args, threshold=threshold, topk=topk)
    _, q_p = ref.dqn_head_ref(*args, threshold=threshold, topk=topk)
    torch.cuda.synchronize()
    assert dqn_head.KERNEL.launches == before + 1
    torch.testing.assert_close(q_k, q_p, rtol=1e-5, atol=1e-5)
    assert torch.equal(d_k, ref.greedy_head_ref(q_k, args[1], args[-1],
                                                threshold=threshold,
                                                topk=topk))
    return d_k, q_k


@pytest.mark.parametrize("cells,users,hidden,threshold", [
    (1, 2, 16, 0.0), (37, 3, 30, 85.0), (64, 2, 32, 85.0),
    (29, 5, 128, 85.0), (13, 3, 16, 101.0)])
def test_head_kernel_matches_plain(cuda, cells, users, hidden, threshold):
    args = _head_args(cuda, cells, users, hidden, cells,
                      np.ones((users, 10), np.float32))
    _check_head(args, threshold)


@pytest.mark.parametrize("threshold", [0.0, 85.0])
def test_head_kernel_masked_rows(cuda, threshold):
    allowed = np.ones((3, 10), np.float32)
    allowed[0, 2:] = 0.0          # fewer allowed actions than topk
    allowed[1, :] = 0.0           # an all-masked user
    args = _head_args(cuda, 29, 3, 16, 7, allowed)
    _check_head(args, threshold)


def _fleet_mask(users):
    """The fleet's own mask: the restricted offloading set's per-user
    actions, 3 of 10 allowed."""
    spec = spaces.SpaceSpec(users)
    return spaces.allowed_per_user(
        spec, spaces.restricted_actions(spec)).astype(np.float32)


def _exact_threshold(q, member, acc, topk):
    """A threshold that a cell's best combo meets exactly: the float32 mean
    accuracy of the member users' top-1 actions in the first cell with
    two members or more, summed in user order as the reference sums it."""
    _, idx = ref.stable_topk_ref(q, topk)
    c = int(torch.nonzero((member > 0.5).sum(-1) >= 2)[0])
    macc = torch.zeros((), dtype=torch.float32, device=q.device)
    users = member[c] > 0.5
    for u in range(q.shape[1]):
        if users[u]:
            macc = macc + acc[idx[c, u, 0]]
    return float(macc / users.sum().float())


#: (cells, users, hidden, topk, threshold, mask, change): K2's combo
#: search at the fleet's width (top-5 of 5 users, hidden 128) with all
#: actions allowed and with the fleet's mask, at a threshold the best
#: combo of a cell meets exactly, with cells of no member, a member whose
#: every top-k entry is masked, every q tied, cell counts that are no
#: multiple of the 25-cell tile, one user and the most users
HEAD_SEARCH_CASES = {
    "85% all allowed": (1001, 5, 128, 5, 85.0, "all", None),
    "85% fleet mask": (1001, 5, 128, 5, 85.0, "fleet", None),
    "goal 0 fleet mask": (1001, 5, 128, 5, 0.0, "fleet", None),
    "exact threshold": (1001, 5, 128, 5, "exact", "all", None),
    "exact threshold fleet mask": (1001, 5, 128, 5, "exact", "fleet", None),
    "zero members": (777, 5, 128, 5, 85.0, "all", "no members"),
    "member with kv 0": (777, 5, 128, 5, 85.0, "user 1 masked", None),
    "every q tied": (333, 5, 128, 5, 88.5, "all", "tied q"),
    "one user": (301, 1, 128, 5, 85.0, "all", None),
    "12 users top-2": (101, 12, 64, 2, 88.0, "all", None),
    "most users top-1": (203, dqn_head.MAX_USERS, 128, 1, 85.0, "all",
                         None),
}


@pytest.mark.parametrize("case", list(HEAD_SEARCH_CASES))
def test_head_kernel_search_cases(cuda, case):
    cells, users, hidden, topk, threshold, mask, change = \
        HEAD_SEARCH_CASES[case]
    allowed = (_fleet_mask(users) if mask == "fleet"
               else np.ones((users, 10), np.float32))
    if mask == "user 1 masked":
        allowed[1] = 0.0
    args = list(_head_args(cuda, cells, users, hidden, cells + users,
                           allowed))
    if change == "no members":
        args[1][::3] = 0.0                 # every third cell: no member
    elif change == "tied q":
        args[8].zero_()                    # w3 = 0 and b3 constant: every
        args[9].fill_(0.25)                # combo of a cell scores the same
    if threshold == "exact":
        _, q_p = ref.dqn_head_ref(*args, threshold=0.0, topk=topk)
        threshold = _exact_threshold(q_p, args[1], args[-1], topk)
        score, _, _ = ref.combo_scores_ref(q_p, args[1], args[-1],
                                           threshold=threshold, topk=topk)
        on_edge, _, _ = ref.combo_scores_ref(
            q_p, args[1], args[-1], threshold=float(np.nextafter(
                np.float32(threshold), np.float32(np.inf))), topk=topk)
        # the threshold decides some combos exactly at their mean
        assert bool((torch.isfinite(score) & ~torch.isfinite(on_edge))
                    .any())
    d_k, q_k = _check_head(tuple(args), threshold, topk)
    if change == "no members":
        assert torch.equal(d_k[::3], ref.first_argmax_ref(q_k)[::3])


# ------------------------------------------- served model: K3, K4, K5 ----
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kv,hd,causal,window", [
    (3, 33, 33, 5, 5, 16, True, 0),        # S not a tile multiple
    (2, 100, 100, 8, 1, 32, True, 48),     # KV = 1, sliding window
    (1, 70, 130, 4, 2, 64, False, 0),      # cross attention, Sq < Skv
    (2, 256, 256, 2, 2, 32, True, 0),      # the d7 prefill layout
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, b, sq, skv, h,
                                              kv, hd, causal, window):
    g = torch.Generator(device=cuda).manual_seed(sq + h)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((b, sq, h, hd), (b, skv, kv, hd),
                             (b, skv, kv, hd)))
    before = flash_attention.KERNEL.launches
    got = flash_attention.flash_attention_cuda(q, k, v, causal=causal,
                                               window=window)
    want = flash_attention.plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.KERNEL.launches == before + 1
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,hd,s,window", [
    (3, 8, 1, 32, 97, 0),                  # KV = 1, S not a tile multiple
    (2, 4, 2, 64, 130, 40),                # window
    (5, 2, 2, 32, 64, 0),                  # the d7 decode layout
])
def test_decode_attention_kernel_matches_plain(cuda, dtype, b, h, kv, hd,
                                               s, window):
    g = torch.Generator(device=cuda).manual_seed(s + h)
    q = torch.randn((b, h, hd), generator=g, device=cuda).to(dtype)
    kc, vc = (torch.randn((b, s, kv, hd), generator=g, device=cuda)
              .to(dtype) for _ in range(2))
    kv_pos = torch.arange(s, device=cuda)[None].repeat(b, 1)
    kv_pos[:, s // 2:] = -1                         # a half-written ring
    cur = torch.randint(1, s // 2, (b,), generator=g, device=cuda)
    before = decode_attention.KERNEL.launches
    got = ops.decode_attention(q, kc, vc, kv_pos, cur, window=window)
    valid = (kv_pos >= 0) & (kv_pos <= cur[:, None])
    if window:
        valid &= kv_pos > cur[:, None] - window
    bias = torch.where(valid, 0.0, -1e30)
    want = decode_attention.plain(q, kc, vc, bias)
    torch.cuda.synchronize()
    assert decode_attention.KERNEL.launches == before + 1
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,sq,skv,h,kv,hd,causal,window", [
    (2, 128, 128, 25, 5, 64, True, 0),     # Hymba's heads, head dim 64
    (2, 100, 100, 4, 2, 64, True, 0),      # Sq not a multiple of 64
    (2, 70, 200, 4, 2, 32, False, 0),      # Sq < Skv, not causal
    (2, 150, 150, 4, 2, 64, True, 40),     # window < one tile: diagonal
                                           # tiles partly masked both ways
    (1, 64, 64, 2, 1, 16, True, 0),        # head dim 16, one tile
])
def test_flash_attention_tensor_core_cases(cuda, dtype, b, sq, skv, h, kv,
                                           hd, causal, window):
    """The bf16 instance (wgmma) at the boundaries of its tiles and masks,
    and the float32 instance (CUDA cores) at the same shapes, each at
    its tolerance."""
    g = torch.Generator(device=cuda).manual_seed(7 * sq + skv + hd)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((b, sq, h, hd), (b, skv, kv, hd),
                             (b, skv, kv, hd)))
    before = flash_attention.KERNEL.launches
    got = flash_attention.flash_attention_cuda(q, k, v, causal=causal,
                                               window=window)
    want = flash_attention.plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.KERNEL.launches == before + 1
    assert torch.isfinite(got.float()).all()
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,kv,hd,s,masked", [
    (2, 8, 2, 32, 1000, None),             # 16 splits, the last partial
    (2, 4, 1, 64, 640, "split"),           # splits 2..7 wholly masked
    (3, 4, 2, 32, 300, "row"),             # batch row 1 wholly masked
    (1, 5, 1, 64, 2064, None),             # batch 1, KV 1: 33 splits
    (72, 8, 4, 32, 100, None),             # one split (288 pairs)
])
def test_decode_attention_split_cases(cuda, dtype, b, h, kv, hd, s, masked):
    """K4's split over slot ranges and its merge: several splits, S no
    multiple of the span, a split with every slot masked, a row with
    every slot masked (the uniform average), the most splits."""
    splits, span = decode_attention.split_plan(b, kv, s, h // kv)
    assert (splits > 1) == (b * kv < 2 * decode_attention.SMS)
    g = torch.Generator(device=cuda).manual_seed(s + 3 * h)
    q = torch.randn((b, h, hd), generator=g, device=cuda).to(dtype)
    kc, vc = (torch.randn((b, s, kv, hd), generator=g, device=cuda)
              .to(dtype) for _ in range(2))
    bias = torch.where(torch.rand((b, s), generator=g, device=cuda) < 0.2,
                       -1e30, 0.0)
    if masked == "split":
        bias[:, 128:512] = -1e30
    elif masked == "row":
        bias[1] = -1e30
    before = decode_attention.KERNEL.launches
    got = decode_attention.decode_attention_cuda(q, kc, vc, bias)
    want = decode_attention.plain(q, kc, vc, bias)
    torch.cuda.synchronize()
    assert decode_attention.KERNEL.launches == before + 1
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if masked == "row":               # the uniform average over all slots
        mean = vc[1].float().mean(0).repeat_interleave(h // kv, 0)
        torch.testing.assert_close(got[1].float(), mean, atol=tol, rtol=tol)


def _int8_args(cuda, m, k, n):
    """Quantized operands, the weight K-major as the model holds it."""
    g = torch.Generator(device=cuda).manual_seed(m + k)
    xq, sx = ref.quantize_ref(torch.randn((m, k), generator=g, device=cuda))
    wq, sw = ref.quantize_ref(torch.randn((k, n), generator=g, device=cuda),
                              dim=0)
    return xq, sx, int8_matmul.k_major(wq), sw


@pytest.mark.parametrize("m,k,n", [(17, 333, 65), (1, 256, 64),
                                   (300, 64, 256), (4096, 1024, 256)])
def test_int8_matmul_kernel_is_bit_exact(cuda, m, k, n):
    xq, sx, wq, sw = _int8_args(cuda, m, k, n)
    before = int8_matmul.KERNEL.launches
    got = int8_matmul.int8_matmul_cuda(xq, sx, wq, sw)
    want = int8_matmul.plain(xq, sx, wq, sw)
    torch.cuda.synchronize()
    assert int8_matmul.KERNEL.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [
    (1, 333, 65),                   # one row, K padded to 352
    (64, 40, 300),                  # K no multiple of 16, N of 8
    (65, 4096, 257),                # one row past the decode tile
    (129, 1000, 513),               # ragged prefill tiles, odd N
    (64, 16384, 256),               # 128 steps over 4 tiles
    (3, 33408, 64),                 # 261 steps in one tile
    (64, 4096, 16384),              # Falcon d4's decode in_proj
    (64, 8192, 4096),               # and out_proj
])
def test_int8_matmul_kernel_ragged_and_bf16_out(cuda, m, k, n, dtype):
    xq, sx, wq, sw = _int8_args(cuda, m, k, n)
    got = int8_matmul.int8_matmul_cuda(xq, sx, wq, sw, dtype)
    want = int8_matmul.plain(xq, sx, wq, sw, dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert torch.equal(got, want)


def test_serving_kernels_refuse_wrong_types_on_the_card(cuda):
    """A CUDA tensor the kernel does not take raises: nothing falls back
    to the plain version."""
    half = torch.zeros((1, 8, 2, 32), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        ops.flash_attention(half, half, half)
    with pytest.raises(TypeError):
        ops.decode_attention(half[:, 0], half, half,
                             torch.zeros((1, 8), dtype=torch.long,
                                         device=cuda),
                             torch.zeros(1, dtype=torch.long, device=cuda))
    x = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        ops.int8_matmul(x, torch.ones((4, 1), device=cuda),
                        torch.zeros((8, 2), dtype=torch.int8, device=cuda),
                        torch.ones((1, 2), device=cuda))
    # a row-major (K, N) int8 weight: the kernel reads K-major storage
    # only, and nothing copies it quietly
    xq = torch.zeros((4, 32), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="K-major"):
        ops.int8_matmul(xq, torch.ones((4, 1), device=cuda),
                        torch.zeros((32, 16), dtype=torch.int8, device=cuda),
                        torch.ones((1, 16), device=cuda))
    q = torch.zeros((1, 8, 2, 48), device=cuda)          # head_dim 48
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q, q)


#: the scan: float32 within 1e-4 (tests/test_kernels.py); bf16 y within
#: one bf16 step, absolute and relative
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: (Bt, S, di, N) of the scan's card cases
SCAN_SHAPES = (
    (4, 1, 48, 16),                        # one step (a one-token prompt)
    (2, 37, 3200, 16),                     # Hymba's di, no block multiple
    (3, 70, 48, 8),                        # N = 8 (states 8..15 zero),
                                           # a partial time chunk
    (1, 4096, 64, 16),                     # a long prompt at small di
    (2, 5, 130, 5),                        # N = 5, zero-padded to 16
)
#: (Bt, S, di, N, lanes the plan splits a channel's states over): each N
#: class on each lane count, every one with a partial last time chunk
SCAN_SPLIT_SHAPES = (
    (66, 45, 1024, 16, 2),                 # 1,056 blocks of 64 channels
    (8, 50, 4200, 16, 2),                  # 528 blocks: the plan's least
    (5, 33, 13600, 5, 2),                  # N = 5, di no block multiple
    (33, 40, 1000, 8, 2),                  # N = 8
    (8, 33, 4100, 16, 4),                  # 520 blocks at two lanes
    (8, 70, 3200, 16, 4),                  # Hymba's di at a thin grid
    (3, 36, 200, 5, 4),                    # N = 5
    (2, 40, 640, 8, 4),                    # N = 8
)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bt,s,di,n", SCAN_SHAPES)
def test_selective_scan_kernel_matches_plain(cuda, dtype, bt, s, di, n):
    _check_scan(cuda, dtype, bt, s, di, n)


def _check_scan(cuda, dtype, bt, s, di, n):
    g = torch.Generator(device=cuda).manual_seed(s + di)
    u = (torch.randn((bt, s, di), generator=g, device=cuda) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((bt, s, di), generator=g, device=cuda)) * 0.1
    A = -torch.exp(torch.randn((di, n), generator=g, device=cuda) * 0.3)
    B, C = (torch.randn((bt, s, n), generator=g, device=cuda)
            for _ in range(2))
    D = torch.randn(di, generator=g, device=cuda)
    before = selective_scan.KERNEL.launches
    y, h = ops.selective_scan(u, dt, A, B, C, D)
    y2, h2 = selective_scan.plain(u, dt, A, B, C, D)
    torch.cuda.synchronize()
    assert selective_scan.KERNEL.launches == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    tol = SCAN_TOL[dtype]
    torch.testing.assert_close(y.float(), y2.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, h2, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bt,s,di,n,lanes", SCAN_SPLIT_SHAPES)
def test_selective_scan_each_lane_split_matches_plain(cuda, dtype, bt, s, di,
                                                      n, lanes):
    assert selective_scan.plan(bt, di, n)[0] == lanes
    _check_scan(cuda, dtype, bt, s, di, n)


def test_selective_scan_refuses_what_the_kernel_does_not_take(cuda):
    u = torch.zeros((1, 4, 8), device=cuda)
    A = torch.zeros((8, 17), device=cuda)                # N = 17 > 16
    bc = torch.zeros((1, 4, 17), device=cuda)
    with pytest.raises(ValueError, match="state sizes"):
        ops.selective_scan(u, u, A, bc, bc, torch.zeros(8, device=cuda))
    with pytest.raises(TypeError):
        ops.selective_scan(u.half(), u, A[:, :4], bc[..., :4], bc[..., :4],
                           torch.zeros(8, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_local_banded_attention_on_the_card_matches_the_cpu(cuda, dtype):
    """S = 3 windows + 5, Hymba's head layout (5 q heads per kv head, head
    dim 64): the card's K3 with its window against the CPU's plain
    version."""
    window = 64
    b, s, h, kv, hd = 2, 3 * window + 5, 10, 2, 64
    g = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn(shape, generator=g).to(dtype)
               for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    before = flash_attention.KERNEL.launches
    got = layers.local_banded_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                                        window=window)
    want = layers.local_banded_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_attention.KERNEL.launches == before + 1
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float().cpu(), want.float(), atol=tol,
                               rtol=tol)


# ------------------------------------------------ threads and streams ----
def _in_threads(fns, timeout=300):
    """Run each callable in its own thread, started together; return
    their results in order (a thread's exception is raised here)."""
    out, errs = [None] * len(fns), []
    start = threading.Barrier(len(fns))

    def run(i):
        try:
            start.wait()
            out[i] = fns[i]()
        except Exception as exc:          # reported in the caller
            errs.append(exc)
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(fns))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=timeout)
    assert not any(th.is_alive() for th in threads)
    if errs:
        raise errs[0]
    return out


def test_engines_on_two_streams_give_the_serial_tokens(cuda):
    """d0 (bf16: K3, K4) and d4 (int8: K5 too) generating at once, each
    from its own thread on its own stream, as the serving bridge runs the
    tiers, give the tokens they give one after the other."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import build_engines
    engines = build_engines(get_config("edge-ladder"), variants=("d0", "d4"),
                            max_len=64, device=cuda)
    pair = [engines["S"]["d0"], engines["S"]["d4"]]
    rng = np.random.default_rng(0)
    toks = [rng.integers(0, 8192, (16, 32)).astype(np.int32)
            for _ in pair]
    for eng, t in zip(pair, toks):
        eng.warmup(*t.shape)
    serial = [eng.generate(t, 8)[0] for eng, t in zip(pair, toks)]
    streams = [torch.cuda.Stream(device=cuda) for _ in pair]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(cuda))

    def on_stream(eng, t, st):
        def fn():
            with torch.cuda.stream(st):
                return [eng.generate(t, 8)[0] for _ in range(3)]
        return fn
    outs = _in_threads([on_stream(e, t, st)
                        for e, t, st in zip(pair, toks, streams)])
    for want, got in zip(serial, outs):
        for g in got:
            np.testing.assert_array_equal(g, want)


def test_int8_launches_from_four_threads_are_all_counted(cuda):
    xq, sx, wq, sw = _int8_args(cuda, 64, 256, 128)
    want = int8_matmul.plain(xq, sx, wq, sw)
    n = 200
    before = int8_matmul.KERNEL.launches

    def work():
        st = torch.cuda.Stream(device=cuda)
        with torch.cuda.stream(st):
            outs = [int8_matmul.int8_matmul_cuda(xq, sx, wq, sw)
                    for _ in range(n)]
            st.synchronize()
        return outs
    torch.cuda.synchronize()
    results = _in_threads([work] * 4)
    assert int8_matmul.KERNEL.launches == before + 4 * n
    for outs in results:
        assert all(torch.equal(o, want) for o in outs[:: n // 4])


def test_single_cell_env_on_the_card_matches_the_cpu(cuda):
    """The single-cell environment's float64 model on the card against
    the CPU's, bit for bit: every joint action of N = 4 in every
    experiment (the link capacities and the user mean divide as device
    tensors, so the card's quotients are numpy's)."""
    from repro_torch.core import EXPERIMENTS, EndEdgeCloudEnv
    for name, scen in EXPERIMENTS.items():
        card = EndEdgeCloudEnv(4, scen, noise=0, device=cuda)
        cpu = EndEdgeCloudEnv(4, scen, noise=0, device="cpu")
        acts = cpu.spec.all_actions()
        for got, want in zip(card.expected_response_batch(acts),
                             cpu.expected_response_batch(acts)):
            assert torch.equal(got.cpu(), want), name


# ------------------------------------------------ the coupled oracle ----
def _coupled(cuda, cells, users, cell_edge, capacity, cloud_servers,
             calib=None, seed=0):
    """A mixed Table-5 fleet of 1..users-user cells on the card with the
    given deployment map."""
    from repro_torch.fleet import dynamics, scenarios, topology
    from repro_torch.rng import Draws
    scen = scenarios.mixed_table5_fleet(Draws(seed, cuda), cells, users,
                                        min_users=1, max_users=users)
    topo = topology.Topology(
        torch.tensor(cell_edge, dtype=torch.int32, device=cuda),
        torch.tensor(capacity, dtype=torch.float32, device=cuda),
        float(cloud_servers))
    if calib is not None:
        calib = dynamics.Calibration(*(torch.tensor(x, device=cuda)
                                       for x in calib))
    return scenarios.FleetScenario(scen.end_b, scen.edge_b, scen.member,
                                   scen.active, 0, topo, calib)


def _check_best_response(scen, pu, threshold, max_rounds=8):
    """Every round of the sweep: the kernel's indices and changed flag
    equal the plain version's on the card, bit for bit, from the same
    start; then the whole oracle through the kernel."""
    from repro_torch.fleet import population
    from repro_torch.kernels import best_response
    feas, ce, cc = population._candidate_tables(scen, pu, threshold, 4096)
    _, idx = population._isolated_bruteforce(scen, pu, threshold)
    topo = scen.topo
    args = (scen.end_b, scen.edge_b, scen.member, feas, ce, cc,
            topo.cell_edge, topo.edge_capacity, topo.cloud_servers)
    for _ in range(max_rounds):
        before = best_response.KERNEL.launches
        got, changed = best_response.best_response_cuda(
            idx, best_response.pack_actions(pu), *args, calib=scen.calib)
        want, want_changed = best_response.plain(idx, pu, *args,
                                                 calib=scen.calib)
        torch.cuda.synchronize()
        assert best_response.KERNEL.launches == before + 1
        assert torch.equal(got, want)
        assert bool(changed.item()) == bool(want_changed)
        if not bool(want_changed):
            break
        idx = want
    return population.topology_bruteforce(scen, pu, threshold)


def _full_table(users, cuda):
    spec = spaces.SpaceSpec(users)
    return torch.tensor(spec.decode_actions_batch(spec.all_actions()),
                        device=cuda)


@pytest.mark.parametrize("case", ["one_cell", "one_edge", "infinite_cloud",
                                  "calibrated", "one_user", "four_users",
                                  "five_users"])
def test_best_response_kernel_matches_plain(cuda, case):
    """Cells of 1..users members; four users take every joint action
    (10^4 candidates, 40 per thread), five the holdout's restricted 3^5
    (the packed ids' bits 16-19)."""
    from repro_torch.fleet import population
    rng = np.random.default_rng(3)
    users, cells, threshold = 3, 96, 89.0
    kw = dict(cell_edge=rng.integers(0, 6, cells), capacity=[1.0, 2.0, 0.5,
                                                             1.0, 3.0, 1.0],
              cloud_servers=3.0 * cells)
    if case == "one_cell":
        cells = 1
        kw.update(cell_edge=[0], capacity=[1.0], cloud_servers=2.0)
    elif case == "one_edge":
        kw.update(cell_edge=np.zeros(cells), capacity=[1.0])
    elif case == "infinite_cloud":
        kw.update(cloud_servers=float("inf"))
    elif case == "calibrated":
        kw.update(calib=([1.3, 0.8, 1.1], [5.0, -20.0, 12.5]))
    elif case == "one_user":
        users, threshold = 1, 80.0
    elif case == "four_users":
        users = 4
    elif case == "five_users":
        users, threshold = 5, 85.0
    scen = _coupled(cuda, cells, users, **kw)
    spec = spaces.SpaceSpec(users)
    pu = _full_table(users, cuda) if users < 5 else torch.tensor(
        spec.decode_actions_batch(population.default_actions(spec)),
        device=cuda)
    _check_best_response(scen, pu, threshold)


def test_best_response_kernel_all_tied_candidates_keep_the_first(cuda):
    """Seven copies of one joint action: every score ties, so the first
    index wins everywhere and nothing ever switches."""
    rng = np.random.default_rng(4)
    scen = _coupled(cuda, 40, 2, rng.integers(0, 3, 40), [1.0, 1.0, 2.0],
                    60.0)
    pu = torch.tensor([[8, 9]] * 7, device=cuda)
    ms, idx, converged, rounds = _check_best_response(scen, pu, 0.0)
    assert converged and rounds == 1 and not idx.any()


def test_best_response_kernel_one_feasible_candidate(cuda):
    """A goal only one candidate meets (both users on d0, the only rung
    at 89.9 here): every cell keeps it."""
    rng = np.random.default_rng(5)
    scen = _coupled(cuda, 40, 2, rng.integers(0, 4, 40), [1.0] * 4, 30.0)
    pu = torch.tensor([[k, k] for k in range(8)], device=cuda)
    ms, idx, converged, rounds = _check_best_response(scen, pu, 89.0)
    assert converged and not idx.any()


def test_best_response_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels import best_response
    scen = _coupled(cuda, 4, 2, [0, 0, 1, 1], [1.0, 1.0], 8.0)
    pu = _full_table(2, cuda)
    z = torch.zeros((4, 100), dtype=torch.int32, device=cuda)
    args = [torch.zeros(4, dtype=torch.int32, device=cuda),
            best_response.pack_actions(pu), scen.end_b, scen.edge_b,
            scen.member, z.bool(), z, z, scen.topo.cell_edge,
            scen.topo.edge_capacity, 8.0]
    bad = list(args)
    bad[5] = z                                 # feas must be bool
    with pytest.raises(TypeError):
        best_response.best_response_cuda(*bad)
    bad = list(args)
    bad[0] = args[0].cpu()
    with pytest.raises(ValueError, match="CUDA"):
        best_response.best_response_cuda(*bad)


def _env_step_on(dev, coupled):
    """One float32 fleet env step on ``dev`` from the same inputs (the
    noise injected), with the DQN's features of its outcome."""
    from repro_torch.fleet import dynamics, policy, population, scenarios
    from repro_torch.fleet import topology
    from repro_torch.rng import Draws
    s = scenarios.mixed_table5_fleet(Draws(4, "cpu"), 512, 3, min_users=1,
                                     max_users=3)
    topo = None
    if coupled:
        t = topology.hot_edge_topology(512, 8, hot_fraction=0.6,
                                       capacity_tiers=(1.0, 2.0, 0.5),
                                       cloud_servers=37.0)
        topo = topology.Topology(t.cell_edge.to(dev), t.edge_capacity.to(dev),
                                 t.cloud_servers)
    s = scenarios.FleetScenario(*(getattr(s, f).to(dev) for f in (
        "end_b", "edge_b", "member", "active")), 0, topo)
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.integers(0, 10, (512, 3)), device=dev)
    z = torch.tensor(rng.standard_normal(512, dtype=np.float32), device=dev)

    class Noise(Draws):
        def normal(self, site, shape):
            return z
    ms, acc, counts = population.simulate_responses(Noise(0, dev), s, a,
                                                    0.02)
    r = dynamics.reward(ms, acc, 85.0)
    feats = policy.encode_fleet_state(counts, s)
    head = policy.fused_head_features(counts, s)
    return [x.cpu() for x in (ms, acc, r, counts, feats, *head)]


@pytest.mark.parametrize("coupled", [False, True])
def test_float32_fleet_env_step_on_the_card_matches_the_cpu(cuda, coupled):
    """The float32 fleet step on the card equals the CPU's bit for bit:
    the link capacities, the ms-to-s scale and the user count are taken
    as the reference rounds them on every device (``dynamics.div_const``,
    ``dynamics.fma``), the queue size divides as a tensor, and users sum
    left to right."""
    for got, want in zip(_env_step_on(cuda, coupled),
                         _env_step_on("cpu", coupled)):
        assert torch.equal(got, want)
