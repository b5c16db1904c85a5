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
refused, also batched over experts in one launch (Granite d4's shapes);
the mixture-of-experts block card vs CPU; K3 and K4 at head_dim 128 and
256 (bf16 and float32, every compiled group, the 161 KB launch, also
on a second card where there is one); K3 without a mask over Whisper's
1,500 frames (the float32 instance also at 3x scale against float64),
K4 over its 1,500-slot cross cache, both with a logit soft-cap, and
Whisper's 2-layer full-width cut card vs CPU; and
DBRX's 2-layer full-width cut generating on the card; the
selective scan at one step, 4,096 steps, state sizes 5, 8 and 16,
channel counts that are no block multiple and both splits of a channel's
states, over 2 and over 4 lanes; the banded sliding-window
attention against the CPU's plain path; the coupled oracle's
best-response round against its plain version (one cell, every cell on
one edge, an infinite cloud, a calibration, one-user cells, tied
candidates, one feasible candidate; the walker's statistics against the
plain sweep's; a round that changes nothing, a switch that keeps both
counts, the first and the last cell the only ones to change, a cloud
total that leaves its start and comes back over 1,536 edges, one tight
edge, 10^5 candidates, two runs bit-equal), the float32 fleet env step
and the AdamW
step against the CPU, bit for bit, and a short ``FleetDQN`` run's
parameters against the CPU's.
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


#: (b, sq, skv, h, kv, hd, causal, window) of K3 at head_dim 128 and 256:
#: partial q and kv tiles, GQA groups of 1-8, a window shorter than a
#: tile (diagonal tiles masked both ways), a window that skips whole
#: tiles, Sq < Skv without a mask, one tile
WIDE_FLASH_CASES = (
    (2, 100, 100, 6, 1, 128, True, 0),     # InternLM2's G = 6, partial tile
    (2, 70, 200, 4, 2, 128, False, 0),     # Sq < Skv, not causal
    (1, 300, 300, 14, 2, 128, True, 128),  # Yi's G = 7, tiles skipped
    (1, 200, 200, 8, 4, 256, True, 48),    # window < one tile
    (2, 130, 130, 8, 1, 256, True, 0),     # PaliGemma's MQA, partial tile
    (1, 64, 64, 2, 2, 256, True, 0),       # one tile, MHA
    (1, 333, 333, 4, 2, 256, True, 100),   # tiles skipped, ragged end
)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,sq,skv,h,kv,hd,causal,window", WIDE_FLASH_CASES)
def test_flash_attention_wide_heads_match_plain(cuda, dtype, b, sq, skv, h,
                                                kv, hd, causal, window):
    """K3 at head_dim 128 and 256: the bf16 instance (64-column atoms,
    81 / 161 KB of shared memory) and the float32 one (eight lanes a q
    row) against the plain version, with masks that keep a whole tile,
    part of one and none."""
    g = torch.Generator(device=cuda).manual_seed(3 * sq + skv + hd)
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


def test_flash_attention_hd256_launch_takes_161_kb(cuda):
    """The bf16 instance at head_dim 256 asks for the q tile and two
    stages of K and V (5 x 64 rows x 512 bytes + 1 KB of alignment
    slack = 161 KB), above the 48 KB a launch gets without
    ``cudaFuncSetAttribute``: the launch is accepted, runs, and agrees
    with the plain version, twice (the grant is made once a device)."""
    assert 5 * 64 * 256 * 2 + 1024 == 164_864 > 48 * 1024
    g = torch.Generator(device=cuda).manual_seed(161)
    q, k, v = (torch.randn((1, 128, 2, 256), generator=g, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    want = flash_attention.plain(q, k, v)
    before = flash_attention.KERNEL.launches
    for _ in range(2):
        got = flash_attention.flash_attention_cuda(q, k, v)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
    assert flash_attention.KERNEL.launches == before + 2


def test_flash_attention_hd256_launch_on_a_second_card(cuda):
    """The 161 KB grant is an attribute of a device's context, so each
    card gets its own: the bf16 instance at head_dim 256 launches and
    agrees with the plain version on card 0, then card 1, then card 0
    again. Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device")
    before = flash_attention.KERNEL.launches
    for idx in (0, 1, 0):
        dev = torch.device("cuda", idx)
        with torch.cuda.device(dev):
            g = torch.Generator(device=dev).manual_seed(256 + idx)
            q, k, v = (torch.randn((2, 130, 4, 256), generator=g,
                                   device=dev).to(torch.bfloat16)
                       for _ in range(3))
            got = flash_attention.flash_attention_cuda(q, k, v)
            want = flash_attention.plain(q, k, v)
            torch.cuda.synchronize(dev)
        assert got.device == dev
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
    assert flash_attention.KERNEL.launches == before + 3


#: (b, h, kv, hd, s, window) of K4 at head_dim 128 and 256: every
#: compiled group at its widths (G = 1, 2, 6, 7 and 8 in GB 1, 2 and 8,
#: 16 at 128), rings written part way and wrapped, many splits
WIDE_DECODE_CASES = (
    (2, 56, 8, 128, 300, 0),               # Yi: G = 7, one head skipped
    (3, 48, 8, 128, 1000, 100),            # InternLM2 / DBRX: G = 6, window
    (1, 16, 1, 128, 200, 0),               # G = 16 x 128 = 2,048 dims
    (2, 8, 1, 256, 528, 0),                # PaliGemma: G = 8 x 256
    (2, 16, 16, 256, 97, 0),               # Gemma-7B: G = 1
    (2, 8, 4, 256, 1024, 1024),            # Gemma3's sliding ring
    (1, 8, 4, 256, 2064, 0),               # Gemma3's global cache, splits
)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,kv,hd,s,window", WIDE_DECODE_CASES)
def test_decode_attention_wide_heads_match_plain(cuda, dtype, b, h, kv, hd,
                                                 s, window):
    """K4 at head_dim 128 and 256 (a float32 lane takes two 16-byte
    chunks of a 256-wide row) against the plain version; the cache's
    slots hold positions of a ring that has wrapped where ``s`` is the
    window, else of one written up to ``cur``."""
    g = torch.Generator(device=cuda).manual_seed(s + h + hd)
    q = torch.randn((b, h, hd), generator=g, device=cuda).to(dtype)
    kc, vc = (torch.randn((b, s, kv, hd), generator=g, device=cuda)
              .to(dtype) for _ in range(2))
    idx = torch.arange(s, device=cuda)[None].repeat(b, 1)
    if window == s:
        cur = torch.full((b,), 3 * s + 5, device=cuda)
        kv_pos = cur[:, None] - (cur[:, None] - idx) % s
    else:
        cur = torch.randint(s // 2, s, (b,), generator=g, device=cuda)
        kv_pos = idx.masked_fill(idx > cur[:, None], -1)
    before = decode_attention.KERNEL.launches
    got = ops.decode_attention(q, kc, vc, kv_pos, cur, window=window)
    valid = (kv_pos >= 0) & (kv_pos <= cur[:, None])
    if window:
        valid &= kv_pos > cur[:, None] - window
    want = decode_attention.plain(q, kc, vc, torch.where(valid, 0.0, -1e30))
    torch.cuda.synchronize()
    assert decode_attention.KERNEL.launches == before + 1
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_decode_attention_refuses_16_heads_of_256(cuda):
    """G x head_dim above 2,048 (16 q heads of 256 per kv head) has no
    compiled group: the wrapper raises before a launch."""
    q = torch.zeros((1, 16, 256), device=cuda, dtype=torch.bfloat16)
    kc = torch.zeros((1, 64, 1, 256), device=cuda, dtype=torch.bfloat16)
    bias = torch.zeros((1, 64), device=cuda)
    before = decode_attention.KERNEL.launches
    with pytest.raises(ValueError, match="G\\*hd"):
        decode_attention.decode_attention_cuda(q, kc, kc, bias)
    assert decode_attention.KERNEL.launches == before


#: (b, sq, skv, h, kv, hd, causal, window, softcap) of K3 on the
#: encoder-decoder path and with a logit soft-cap: Whisper's encoder
#: (1,500 frames, the last kv tile 28 rows) and its cross-attention (a
#: 64-token prompt onto the 1,500 frames), no mask; soft-capped causal,
#: windowed (Gemma3's 8/4 heads of 256 past a window that skips whole
#: tiles), non-causal with Sq < Skv, and head dims 16-128
ENCDEC_FLASH_CASES = (
    (2, 1500, 1500, 16, 16, 64, False, 0, 0.0),   # Whisper's encoder
    (2, 64, 1500, 16, 16, 64, False, 0, 0.0),     # its cross-attention
    (1, 37, 1500, 4, 4, 64, False, 0, 0.0),       # a ragged prompt
    (2, 100, 100, 4, 2, 64, True, 0, 50.0),       # capped, causal
    (1, 300, 300, 8, 4, 256, True, 128, 50.0),    # capped, a window
    (2, 70, 200, 4, 2, 128, False, 0, 5.0),       # capped, Sq < Skv
    (3, 33, 33, 5, 5, 16, True, 0, 2.0),          # capped, head dim 16
    (2, 64, 150, 8, 8, 32, False, 0, 2.0),        # capped, head dim 32
)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,sq,skv,h,kv,hd,causal,window,softcap",
                         ENCDEC_FLASH_CASES)
def test_flash_attention_encdec_and_softcap_match_plain(
        cuda, dtype, b, sq, skv, h, kv, hd, causal, window, softcap):
    """K3 without a mask over Whisper's 1,500 frames (Sq = Skv and Sq <
    Skv) and with a soft-cap (its own instances: tanhf before the mask)
    against the plain version. Unit-scale inputs, as every K3 card test
    draws (the float32 tolerance holds for them; scaled-up inputs scale
    the float32 rounding with them): scaled scores ~N(0, 1), so a cap
    of 2 bends most of them and one of 50 the tails."""
    g = torch.Generator(device=cuda).manual_seed(sq + skv + hd)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((b, sq, h, hd), (b, skv, kv, hd),
                             (b, skv, kv, hd)))
    before = flash_attention.KERNEL.launches
    got = flash_attention.flash_attention_cuda(
        q, k, v, causal=causal, window=window, softcap=softcap)
    want = flash_attention.plain(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    torch.cuda.synchronize()
    assert flash_attention.KERNEL.launches == before + 1
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("sq", [1500, 64])
def test_flash_attention_f32_long_kv_at_3x_scale_against_float64(cuda, sq):
    """The float32 K3 over Whisper's 1,500 frames (its encoder, Sq =
    1,500, and its cross-attention, Sq = 64; no mask, 24 kv tiles, the
    last of 28 rows) on inputs drawn at 3x scale (scaled scores ~N(0,
    81)), where the float32 rounding of the scores grows with them: the
    kernel and the plain version are both held against exact attention
    taken in float64 from the same float32 inputs, and the kernel's
    error may be no more than 4 times the plain version's, so that its
    online softmax over the long kv loses no accuracy of its own."""
    g = torch.Generator(device=cuda).manual_seed(sq)
    b, h, hd, skv = 2, 16, 64, 1500
    q, k, v = (3 * torch.randn(shape, generator=g, device=cuda)
               for shape in ((b, sq, h, hd), (b, skv, h, hd),
                             (b, skv, h, hd)))
    s = torch.einsum("bqhd,bshd->bhqs", q.double(), k.double()) / hd ** 0.5
    exact = torch.einsum("bhqs,bshd->bqhd", torch.softmax(s, -1),
                         v.double())
    got = flash_attention.flash_attention_cuda(q, k, v, causal=False)
    want = flash_attention.plain(q, k, v, causal=False)
    kernel_err = float((got.double() - exact).abs().max())
    plain_err = float((want.double() - exact).abs().max())
    print(f"K3 float32 3x, Sq={sq} Skv={skv}: kernel {kernel_err:.3e}, "
          f"plain {plain_err:.3e} from float64")
    assert kernel_err <= 4 * plain_err


#: (b, h, kv, hd, s, softcap) of K4 over Whisper's cross cache (1,500
#: frames, every slot valid: 24 tiles, the last partial) and with a
#: soft-cap over a half-written cache, at every compiled group
ENCDEC_DECODE_CASES = (
    (16, 16, 16, 64, 1500, 0.0),                  # Whisper's cross cache
    (2, 16, 16, 64, 1500, 0.0),                   # ... at batch 2: splits
    (4, 8, 2, 64, 300, 50.0),                     # capped, G = 2
    (2, 16, 16, 64, 1500, 5.0),                   # capped cross cache
    (2, 48, 8, 128, 1000, 2.0),                   # capped, G = 6
    (1, 16, 1, 128, 200, 2.0),                    # capped, G = 16
    (2, 8, 4, 256, 528, 50.0),                    # capped, head dim 256
)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,kv,hd,s,softcap", ENCDEC_DECODE_CASES)
def test_decode_attention_cross_cache_and_softcap_match_plain(
        cuda, dtype, b, h, kv, hd, s, softcap):
    """K4 over a cross cache (every slot valid, ``cur_pos`` = S, as the
    decoder reads its encoder's frames) and with a soft-cap (after the
    scaled dot product, before the bias) against the plain version, on
    unit-scale inputs as every K4 card test."""
    g = torch.Generator(device=cuda).manual_seed(s + h + hd)
    q = torch.randn((b, h, hd), generator=g, device=cuda).to(dtype)
    kc, vc = (torch.randn((b, s, kv, hd), generator=g, device=cuda)
              .to(dtype) for _ in range(2))
    idx = torch.arange(s, device=cuda)[None].repeat(b, 1)
    if h == kv:                                   # the cross cache
        cur = torch.full((b,), s, device=cuda)
        kv_pos = idx
    else:
        cur = torch.randint(s // 2, s, (b,), generator=g, device=cuda)
        kv_pos = idx.masked_fill(idx > cur[:, None], -1)
    before = decode_attention.KERNEL.launches
    got = ops.decode_attention(q, kc, vc, kv_pos, cur, softcap=softcap)
    valid = (kv_pos >= 0) & (kv_pos <= cur[:, None])
    want = decode_attention.plain(q, kc, vc, torch.where(valid, 0.0, -1e30),
                                  softcap)
    torch.cuda.synchronize()
    assert decode_attention.KERNEL.launches == before + 1
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("vid", ["d0", "d4"])
def test_whisper_cut_on_the_card_matches_the_cpu(cuda, vid):
    """Whisper at full width (16/16 heads of 64, d_model 1,024) cut to 2
    encoder and 2 decoder layers over 300 frames: the card's prefill
    (K3 non-causal in the encoder and the cross blocks, causal in the
    decoder; K5 in d4) and two decode steps (K4 over the self and the
    cross cache) against the CPU's plain path on the same weights,
    within the bf16 tolerance of the smoke's agreement phases."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models import build_model
    from repro_torch.models.variants import build_ladder
    cfg = build_ladder(dataclasses.replace(
        get_config("whisper-medium"), n_layers=2, n_enc_layers=2,
        enc_seq=300))[vid].cfg
    m = build_model(cfg)
    p = m.init(0, device=cuda)
    p_cpu = _tree_cpu(p)
    rng = np.random.default_rng(1)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 24)).astype(
        np.int32))
    frames = torch.tensor(rng.standard_normal(
        (2, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    k3, k4 = flash_attention.KERNEL.launches, decode_attention.KERNEL.launches
    with torch.inference_mode():
        lg, cg = m.prefill(p, {"tokens": toks.to(cuda),
                               "frames": frames.to(cuda)}, max_len=32)
        lc, cc = m.prefill(p_cpu, {"tokens": toks, "frames": frames},
                           max_len=32)
        assert flash_attention.KERNEL.launches == k3 + 2 + 2 * 2
        for _ in range(2):
            torch.testing.assert_close(lg.float().cpu(), lc.float(),
                                       atol=0.125, rtol=1e-2)
            cur = lc[:, -1:, :cfg.vocab_size].float().argmax(-1).int()
            lg, cg = m.decode(p, cg, cur.to(cuda))
            lc, cc = m.decode(p_cpu, cc, cur)
    torch.testing.assert_close(lg.float().cpu(), lc.float(), atol=0.125,
                               rtol=1e-2)
    assert decode_attention.KERNEL.launches == k4 + 2 * 2 * 2
    torch.testing.assert_close(cg["segments"][0]["ck"].float().cpu(),
                               cc["segments"][0]["ck"].float(), atol=0.125,
                               rtol=1e-2)


def _tree_cpu(tree):
    if isinstance(tree, dict):
        return {k: _tree_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_cpu(v) for v in tree]
    return tree.cpu()


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


def _batched_int8_args(cuda, e, m, k, n):
    """E experts' quantized operands, each weight K-major."""
    g = torch.Generator(device=cuda).manual_seed(e + m + k)
    xq, sx = ref.quantize_ref(torch.randn((e, m, k), generator=g,
                                          device=cuda))
    wq, sw = ref.quantize_ref(torch.randn((e, k, n), generator=g,
                                          device=cuda), dim=1)
    return xq, sx, int8_matmul.k_major(wq), sw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,m,k,n", [
    (32, 64, 1024, 512),            # Granite d4's decode gate/up
    (32, 64, 512, 1024),            # and down
    (32, 640, 1024, 512),           # a prefill of 8 rows x 80 slots
    (4, 300, 333, 65),              # ragged, K padded to 352
    (3, 1, 256, 64),                # one row an expert
    (2, 129, 64, 257),              # ragged prefill tiles
])
def test_batched_int8_matmul_is_one_bit_exact_launch(cuda, e, m, k, n,
                                                     dtype):
    xq, sx, wq, sw = _batched_int8_args(cuda, e, m, k, n)
    before = int8_matmul.KERNEL.launches
    got = int8_matmul.int8_matmul_cuda(xq, sx, wq, sw, dtype)
    torch.cuda.synchronize()
    assert int8_matmul.KERNEL.launches == before + 1
    want = int8_matmul.plain(xq, sx, wq, sw, dtype)
    assert got.shape == (e, m, n) and torch.equal(got, want)
    for i in (0, e - 1):            # and each expert's own product
        assert torch.equal(got[i], int8_matmul.int8_matmul_cuda(
            xq[i], sx[i], wq[i], sw[i], dtype))


def test_batched_int8_matmul_refuses_a_row_major_expert_weight(cuda):
    xq, sx, wq, sw = _batched_int8_args(cuda, 4, 64, 128, 64)
    with pytest.raises(ValueError, match="K-major"):
        ops.int8_matmul(xq, sx, wq.contiguous(), sw)
    with pytest.raises(ValueError, match="shape"):
        ops.int8_matmul(xq, sx[:3], wq, sw)


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


def _round_args(scen, pu, threshold):
    """(isolated start, the round's arguments after idx and pu)."""
    from repro_torch.fleet import population
    feas, ce, cc = population._candidate_tables(scen, pu, threshold, 4096)
    _, idx = population._isolated_bruteforce(scen, pu, threshold)
    topo = scen.topo
    return idx, (scen.end_b, scen.edge_b, scen.member, feas, ce, cc,
                 topo.cell_edge, topo.edge_capacity, topo.cloud_servers)


def _checked_round(idx, pu, args, calib):
    """One round through the kernel and through its plain version on the
    card: indices and changed flag bit-equal, one launch counted, and the
    walker's statistics those of the plain sweep (the first cell whose
    choice moves a count, the first that switches, the cells rescored)
    and within the bounds of its windows (scorings, passes).
    Returns (new idx, (first, first switch, rescored))."""
    from repro_torch.kernels import best_response
    before = best_response.KERNEL.launches
    stats = torch.full((len(best_response.STATS),), -1, dtype=torch.int32,
                       device=idx.device)
    got, changed = best_response.best_response_cuda(
        idx, best_response.pack_actions(pu), *args, calib=calib,
        stats=stats)
    want, want_changed = best_response.plain(idx, pu, *args, calib=calib)
    torch.cuda.synchronize()
    assert best_response.KERNEL.launches == before + 1
    assert torch.equal(got, want)
    assert bool(changed.item()) == bool(want_changed)
    ce, cc, cell_edge = args[4], args[5], args[6]
    rows = torch.arange(idx.shape[0], device=idx.device)
    moved = ((ce[rows, want.long()] != ce[rows, idx.long()])
             | (cc[rows, want.long()] != cc[rows, idx.long()]))
    cells = idx.shape[0]
    first = int(moved.nonzero()[0]) if moved.any() else cells
    switch = want != idx
    first_switch = int(switch.nonzero()[0]) if switch.any() else cells
    rescored = best_response.rescored_cells(idx, want, ce, cc, cell_edge)
    got = stats.tolist()
    assert got[:3] == [first, first_switch, rescored]
    scorings, passes = got[3:]
    if first < cells:       # a window of 32 cells takes 1 to 33 passes
        windows = -(-(cells - first) // 32)
        assert windows <= passes <= 33 * windows
        assert rescored <= scorings <= 32 * passes
    else:
        assert scorings == passes == 0
    return want, (first, first_switch, rescored)


def _check_best_response(scen, pu, threshold, max_rounds=8):
    """Every round of the sweep: the kernel's indices and changed flag
    equal the plain version's on the card, bit for bit, from the same
    start (``_checked_round``); then the whole oracle through the
    kernel."""
    from repro_torch.fleet import population
    idx, args = _round_args(scen, pu, threshold)
    for _ in range(max_rounds):
        want, (_, first_switch, _) = _checked_round(idx, pu, args,
                                                    scen.calib)
        if first_switch == idx.shape[0]:
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


def _converge(idx, pu, args, calib, max_rounds=12):
    """Checked rounds from ``idx`` until one switches nothing; returns
    the fixed point and the statistics of the round that found it."""
    for _ in range(max_rounds):
        new, stats = _checked_round(idx, pu, args, calib)
        if stats[1] == idx.shape[0]:
            return idx, stats
        idx = new
    raise AssertionError("the sweep did not converge")


def _other_candidate(rng, idx, args, i, d_c):
    """A feasible candidate of cell i other than idx[i]: of the same edge
    and cloud counts (``d_c`` 0), of another cloud count (None), or of
    the cloud count ``idx[i]``'s + ``d_c``."""
    feas, ce, cc = (x[i].cpu().numpy() for x in args[3:6])
    cur = int(idx[i])
    if d_c == 0:
        ok = (ce == ce[cur]) & (cc == cc[cur])
    else:
        ok = cc != cc[cur] if d_c is None else cc == cc[cur] + d_c
    ok = feas & ok
    ok[cur] = False
    return int(rng.choice(np.flatnonzero(ok)))


def _rows_changed(a, b):
    return (a != b).nonzero().flatten().tolist()


def _np_coupled(dev, rng, cells, users, cell_edge, capacity,
                cloud_servers):
    """A fleet drawn with numpy, every user a member, on ``dev``."""
    from repro_torch.fleet import scenarios, topology

    def t(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=dev)
    member = t(np.ones((cells, users), bool), torch.bool)
    topo = topology.Topology(t(cell_edge, torch.int32),
                             t(capacity, torch.float32),
                             float(cloud_servers))
    return scenarios.FleetScenario(
        t(rng.integers(0, 2, (cells, users)), torch.int32),
        t(rng.integers(0, 2, cells), torch.int32), member, member, 0, topo,
        None)


@pytest.mark.parametrize("case", ["converged", "switch_keeps_counts",
                                  "first_and_last", "cloud_returns",
                                  "one_tight_edge"])
def test_best_response_walker_cases(cuda, case):
    """The pre-pass and the walker at the rounds that decide their
    paths, each round checked bit-equal to the plain version with the
    walker's statistics (``_checked_round``):

    * converged: a round from the fixed point moves nothing and walks
      nothing;
    * switch_keeps_counts: cells 0 and the last moved, at the fixed
      point, to another candidate of the same counts switch back in a
      round whose totals never move (no cell rescored);
    * first_and_last: on a fleet whose cells share nothing (an edge
      each, an infinite cloud), cells 0 and the last moved to another
      cloud count are the only ones to change, and every cell after the
      first is rescored (the cloud total has moved);
    * cloud_returns: 1,536 cells, an edge each (the walker's edge totals
      past shared memory), a finite cloud: from the fixed point with
      one more cloud job at cell 100 and one fewer at cell 900, the cloud
      total leaves its start and comes back, so the cells after 900 are
      taken unscored;
    * one_tight_edge: every cell on one edge of capacity 0.5, so every
      change moves the total that all the later cells see."""
    rng = np.random.default_rng(11)
    users, cells, goal = 2, 96, 89.0
    pu = _full_table(users, cuda)
    if case == "one_tight_edge":
        scen = _np_coupled(cuda, rng, cells, users, np.zeros(cells, int),
                           [0.5], 2.0 * cells)
        idx, args = _round_args(scen, pu, goal)
        new, (first, _, rescored) = _checked_round(idx, pu, args, None)
        assert first < cells and rescored > 0
        _converge(new, pu, args, None)
        return
    if case == "cloud_returns":
        cells = 1536
    finite = case in ("converged", "switch_keeps_counts", "cloud_returns")
    scen = _np_coupled(cuda, rng, cells, users, np.arange(cells),
                       rng.choice([0.5, 1.0, 2.0], cells),
                       cells / 4.0 if finite else float("inf"))
    idx, args = _round_args(scen, pu, goal)
    fixed, stats = _converge(idx, pu, args, None)
    if case == "cloud_returns":
        # a cell from 100 on holds one cloud job more than its fixed
        # point, one from 900 on one fewer: the round takes the cloud
        # total below its start from the first and back to it later
        ce, cc = args[4].cpu().numpy(), args[5].cpu().numpy()
        feas, at = args[3].cpu().numpy(), fixed.cpu().numpy()
        start, moved = fixed.clone(), []
        for lo, d_c in ((100, 1), (900, -1)):
            i = next(i for i in range(lo, cells)
                     if (feas[i] & (cc[i] == cc[i, at[i]] + d_c)).any())
            start[i] = _other_candidate(rng, fixed, args, i, d_c)
            moved.append(i)
        new, (first, _, rescored) = _checked_round(start, pu, args, None)
        rows = torch.arange(cells, device=cuda)
        d_c = args[5][rows, new.long()] - args[5][rows, start.long()]
        seen = (torch.cumsum(d_c, 0) - d_c)[first + 1:]
        back = (seen == 0) & (torch.cumsum(seen != 0, 0) > 0)
        assert first == moved[0] and bool(back.any())
        assert 0 < rescored < cells - first - 1
        return
    if case == "converged":
        assert stats == (cells, cells, 0)
        return
    start = fixed.clone()
    for i in (0, cells - 1):
        start[i] = _other_candidate(
            rng, fixed, args, i, 0 if case == "switch_keeps_counts" else None)
    new, (first, first_switch, rescored) = _checked_round(start, pu, args,
                                                          None)
    assert _rows_changed(new, start) == [0, cells - 1]
    assert first_switch == 0
    if case == "switch_keeps_counts":
        assert (first, rescored) == (cells, 0)
    else:
        assert (first, rescored) == (0, cells - 1)


@pytest.mark.parametrize("case", ["five_users_all_actions", "two_runs"])
def test_best_response_walker_rows_and_repeat(cuda, case):
    """five_users_all_actions: 10^5 candidates a cell, past the walker's
    ring, so it reads the candidate bytes from device memory;
    two_runs: one changing round of 1,024 cells x 3 users over 16 edges
    run twice gives the same bits, statistics included."""
    from repro_torch.kernels import best_response
    rng = np.random.default_rng(12)
    if case == "five_users_all_actions":
        scen = _np_coupled(cuda, rng, 32, 5, rng.integers(0, 3, 32),
                           [1.0, 0.5, 2.0], 8.0)
        pu = _full_table(5, cuda)
        idx, args = _round_args(scen, pu, 89.0)
        new, (first, _, rescored) = _checked_round(idx, pu, args, None)
        assert first < 32 and rescored > 0
        _converge(new, pu, args, None)
        return
    cells = 1024
    scen = _np_coupled(cuda, rng, cells, 3, rng.integers(0, 16, cells),
                       rng.choice([0.5, 1.0, 2.0], 16), cells / 2.0)
    pu = _full_table(3, cuda)
    idx, args = _round_args(scen, pu, 89.0)
    packed = best_response.pack_actions(pu)
    runs = []
    for _ in range(2):
        stats = torch.empty(len(best_response.STATS), dtype=torch.int32,
                            device=cuda)
        new, changed = best_response.best_response_cuda(idx, packed, *args,
                                                        stats=stats)
        runs.append((new, changed, stats))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert int(runs[0][2][0]) < cells and int(runs[0][2][2]) > 0
    _checked_round(idx, pu, args, None)


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


def test_adamw_step_on_the_card_matches_the_cpu(cuda):
    """The AdamW step on the card equals the CPU's bit for bit, clipped
    and not: the clip scale and ``v / b2c`` divide by device tensors
    (a Python divisor is a reciprocal product on the card), the update's
    multiply-adds are one rounding on both devices, and the square roots
    are correctly rounded."""
    from repro_torch.training import optimizer
    cfg = optimizer.constant_lr_adamw(1e-3)
    rng = np.random.default_rng(0)
    shapes = [{"w": (11, 128), "b": (128,)}, {"w": (128, 10), "b": (10,)}]
    init = [{k: rng.standard_normal(s).astype(np.float32)
             for k, s in layer.items()} for layer in shapes]
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        params = [{k: torch.tensor(v, device=dev) for k, v in layer.items()}
                  for layer in init]
        state = optimizer.init_opt_state(params)
        g_rng = np.random.default_rng(1)
        for i in range(12):
            # multiples of 1/4 (clipped) or 1/512 (not): their squares
            # sum exactly in any order, so both norms are the same
            denom = 4.0 if i % 2 == 0 else 512.0
            grads = [{k: torch.tensor(
                (g_rng.integers(-8, 9, s) / denom).astype(np.float32),
                device=dev) for k, s in layer.items()} for layer in shapes]
            optimizer.apply_updates(params, grads, state, cfg)
        runs[dev.type] = [params, state["m"], state["v"]]
    for got, want in zip(runs["cuda"], runs["cpu"]):
        for g, w in zip(got, want):
            for k in g:
                assert torch.equal(g[k].cpu(), w[k]), k


def test_short_fleet_dqn_run_on_the_card_matches_the_cpu(cuda):
    """Five FleetDQN steps from the same draws (taken on the host, so
    both devices see the same values) at full exploration: the
    environment, the replay and the AdamW step are bit-equal on both
    devices, the loss's float32 matmuls sum in another order (cuBLAS
    against the CPU's), so the parameters agree within 1e-5 abs +
    1e-4 rel."""
    from repro_torch.fleet import api, policy, scenarios
    from repro_torch.rng import Draws

    class HostDraws(Draws):
        """Draws from a CPU generator, moved to ``device``."""

        def __init__(self, seed, device):
            super().__init__(seed, "cpu")
            self.device = torch.device(device)

        def uniform(self, site, shape):
            return torch.rand(shape, generator=self.gen).to(self.device)

        def normal(self, site, shape):
            return torch.randn(shape, generator=self.gen).to(self.device)

        def randint(self, site, shape, high, low=0):
            return torch.randint(low, high, shape,
                                 generator=self.gen).to(self.device)

    cfg = scenarios.FleetConfig(cells=256, users=3, arrival_rate=1.0,
                                p_r2w=0.05, p_w2r=0.1, n_edges=8,
                                cloud_servers=64.0)
    kw = dict(hidden=32, replay_capacity=1024, batch_size=64,
              eps_start=1.0, eps_min=1.0, accuracy_threshold=85.0)
    params = {}
    for dev in (cuda, torch.device("cpu")):
        agent = policy.FleetDQN(api.SyntheticSource(cfg), device=dev,
                                draws=HostDraws(3, dev),
                                cfg=policy.FleetDQNConfig(**kw))
        agent.run(5)
        params[dev.type] = agent.params
        counts = agent.counts.cpu()
    for g, w in zip(params["cuda"], params["cpu"]):
        for k in ("w", "b"):
            torch.testing.assert_close(g[k].detach().cpu(), w[k].detach(),
                                       atol=1e-5, rtol=1e-4)
    assert counts.sum() > 0


def _moe_pair(quant):
    """A reduced Granite layer's MoE block at full width (d_model 1024,
    d_ff 512, 32 experts, top-8) and its params on the card and on the
    CPU (the same values)."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                              n_layers=2, quant=quant)
    p = moe.init_moe(torch.Generator(device="cuda").manual_seed(0), cfg)
    cpu = {k: {n: t.cpu() for n, t in v.items()} for k, v in p.items()}
    return cfg, p, cpu


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("s", [1, 96])
def test_moe_block_on_the_card_matches_the_cpu(cuda, quant, s):
    """``moe_block`` (bmm or the batched K5) on the card against the CPU's
    plain path on the same weights: the router's choices equal wherever
    its k-th/(k+1)-th margin exceeds 1e-4; where every choice agrees, the
    same drops and outputs within the bf16 tolerance (otherwise the rows
    whose choices all agree)."""
    from repro_torch.models import moe
    cfg, p, cpu = _moe_pair(quant)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((8, s, cfg.d_model), generator=g,
                    device=cuda).to(torch.bfloat16)
    before = int8_matmul.KERNEL.launches
    y, aux = moe.moe_block(p, x, cfg)
    torch.cuda.synchronize()
    assert int8_matmul.KERNEL.launches == before + (3 if quant == "int8"
                                                    else 0)
    yc, auxc = moe.moe_block(cpu, x.cpu(), cfg)
    _, _, ids = moe.router(p, x, cfg)
    probs, _, idc = moe.router(cpu, x.cpu(), cfg)
    srt = torch.sort(probs, dim=-1, descending=True).values
    clear = (srt[..., cfg.moe.top_k - 1] - srt[..., cfg.moe.top_k]) > 1e-4
    same = (ids.cpu() == idc).all(-1)
    assert bool(same[clear].all())
    rows = same.all(-1)
    if bool(rows.all()):
        assert float(aux["dropped_frac"]) == float(auxc["dropped_frac"])
    torch.testing.assert_close(y.float().cpu()[rows], yc.float()[rows],
                               atol=0.125, rtol=1e-2)


def test_dbrx_cut_to_two_layers_generates_on_the_card(cuda):
    """DBRX at full width (48/8 heads of 128, 16 experts of d_ff 10,752,
    vocab 100,352), cut to 2 of its 40 layers (~13 GB in bf16): built by
    ``build_engines`` on the card, its K3 and K4 launched at head_dim 128,
    greedy tokens in range."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import build_engines
    cfg = dataclasses.replace(get_config("dbrx-132b"), n_layers=2)
    engines = build_engines(cfg, variants=("d0",), max_len=48, device=cuda)
    eng = engines["S"]["d0"]
    assert eng.model.cfg.resolved_head_dim == 128
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (2, 32)).astype(np.int32)
    k3, k4 = flash_attention.KERNEL.launches, decode_attention.KERNEL.launches
    out, _ = eng.generate(toks, 4)
    assert flash_attention.KERNEL.launches == k3 + 2
    assert decode_attention.KERNEL.launches == k4 + 2 * 4
    assert out.shape == (2, 4)
    assert 0 <= int(out.min()) and int(out.max()) < cfg.vocab_size
    del engines, eng
    torch.cuda.empty_cache()
