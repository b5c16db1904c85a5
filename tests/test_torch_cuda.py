"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at shapes ``chip_smoke.py`` does not reach: rows wider than the
tabular kernel's register path, odd hidden widths, masked rows and the
infeasible fallback of the head. Every test here needs a CUDA device
and skips without one; run them on the GPU with

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import dqn_head, ref, tabular_rl


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


def _check_head(args, threshold):
    """q within 1e-5 of the plain version (cuBLAS sums in another order);
    decisions bit-exact against the plain decision logic applied to the
    kernel's own q, so rounding of the products cannot flip a tie."""
    d_k, q_k = dqn_head.dqn_head_cuda(*args, threshold=threshold, topk=3)
    _, q_p = ref.dqn_head_ref(*args, threshold=threshold, topk=3)
    torch.testing.assert_close(q_k, q_p, rtol=1e-5, atol=1e-5)
    assert torch.equal(d_k, ref.greedy_head_ref(q_k, args[1], args[-1],
                                                threshold=threshold,
                                                topk=3))


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
