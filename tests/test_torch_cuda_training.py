"""The training path's kernels on the card against their plain PyTorch
versions: K3's ``kLse`` instances (the output bit-equal to the serving
instance's, the rows' log-sum-exp against ``plain_with_lse``), the
attention backward P2 against ``plain_backward`` on the same forward
output at every head_dim, GQA groups of 1, 2, 4 and 6, causal, windowed
and unmasked rows, sequences that are no tile multiple and span several
64-row tiles, caps of 0, 50 and 2, in float32 and bfloat16
(bit-identical over two runs: no atomics),
``ops.flash_attention`` under autograd launching both; K6's ``kStates``
instance (y and h_last bit-equal to the serving instance's, the chunk
states equal to the plain scan's state at each chunk start), the scan's
backward P3 against ``plain_backward`` at both of K6's lane plans,
ragged lengths, lengths around 256 and 512 steps, ragged channel counts,
a grid of two blocks, 5, 8 and 16 states, float32 and bfloat16
``u``, with and without a final-state gradient (bit-identical over two
runs: no atomics), and ``ops.selective_scan`` under autograd launching
both and never the plain versions. Every test here needs a CUDA device
and skips without one; run them on the GPU with

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_training.py

Tolerances: the log-sum-exp within 1e-4 (float32 sums of ~N(0, 1)
scores over up to 517 keys); the gradients in float32 within 1e-4
absolute + 1e-4 relative (float32 sums in another order), in bfloat16
within 2e-2 + 2e-2 (one rounding of each output to bfloat16, 2^-8
relative, where the plain version rounds its float32 result once too).
The scan's backward: du and ddt within 1e-4 + 1e-4 relative (float32
sums over a channel's 16 states and each decay an ``ex2.approx``,
relative error ~2^-22, where the plain version takes ``exp``), du with
bfloat16 ``u`` within 2e-2 + 2e-2 (one rounding to bfloat16 on each
side); dA, dD, dB and dC, sums over batch rows and time or over
channels, within 1e-3 of the leaf's largest magnitude; the chunk states
within 1e-4 of the plain scan's.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention, ops, selective_scan

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
LSE_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(cuda, dtype, b, sq, skv, h, kv, hd, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=cuda).to(dtype)
            for shape in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd),
                          (b, sq, h, hd))]


#: (b, sq, skv, h, kv, hd, causal, window, cap): every head_dim, G 1, 2
#: and 6, lengths that are no multiple of the 16-, 32- or 64-row tiles,
#: a window shorter than the sequence, q onto a longer kv sequence
#: without a mask and with a causal mask (right-aligned), caps 50 and 2
CASES = [
    (2, 37, 37, 4, 2, 16, True, 0, 0.0),
    (2, 70, 70, 8, 4, 32, True, 0, 0.0),
    (1, 129, 129, 6, 1, 64, True, 0, 0.0),
    (2, 100, 100, 12, 2, 64, True, 24, 0.0),
    (1, 80, 80, 4, 4, 128, True, 0, 50.0),
    (1, 96, 96, 4, 2, 256, True, 32, 2.0),
    (2, 33, 300, 4, 4, 64, False, 0, 0.0),
    (1, 40, 75, 6, 3, 32, True, 0, 0.0),
    (2, 64, 64, 4, 1, 128, False, 0, 2.0),
    (1, 50, 50, 2, 2, 256, False, 0, 0.0),
    # several 64-row q and kv tiles of the bf16 kernels, with ragged ends:
    # the causal diagonal across tiles, a window that starts and ends
    # inside tiles (and a cap at 256), Sq and Skv apart without a mask,
    # and exactly one tile
    (1, 300, 300, 8, 2, 64, True, 0, 0.0),
    (1, 400, 400, 4, 4, 128, True, 100, 0.0),
    (1, 200, 200, 4, 2, 256, True, 64, 50.0),
    (2, 130, 517, 6, 3, 32, False, 0, 0.0),
    (1, 64, 64, 2, 1, 16, True, 0, 0.0),
]


def _ids(c):
    return "b{}_q{}_kv{}_h{}-{}_hd{}_{}_w{}_cap{}".format(
        *c[:6], "causal" if c[6] else "full", *c[7:])


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lse_instance_keeps_the_output_and_writes_the_lse(cuda, case, dtype):
    b, sq, skv, h, kv, hd, causal, window, cap = case
    q, k, v, _ = _qkv(cuda, dtype, b, sq, skv, h, kv, hd, seed=sq + hd)
    kw = dict(causal=causal, window=window, softcap=cap)
    before = flash_attention.KERNEL.launches
    o, lse = flash_attention.flash_attention_cuda(q, k, v, lse=True, **kw)
    serving = flash_attention.flash_attention_cuda(q, k, v, **kw)
    _, want = flash_attention.plain_with_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.KERNEL.launches == before + 2
    assert torch.equal(o, serving)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    assert float((lse - want).abs().max()) <= LSE_TOL


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_matches_plain(cuda, case, dtype):
    b, sq, skv, h, kv, hd, causal, window, cap = case
    q, k, v, do = _qkv(cuda, dtype, b, sq, skv, h, kv, hd, seed=3 * sq + hd)
    kw = dict(causal=causal, window=window, softcap=cap)
    o, lse = flash_attention.flash_attention_cuda(q, k, v, lse=True, **kw)
    before = flash_attention.BACKWARD.launches
    got = flash_attention.flash_attention_backward_cuda(q, k, v, o, lse, do,
                                                        **kw)
    again = flash_attention.flash_attention_backward_cuda(q, k, v, o, lse,
                                                          do, **kw)
    want = flash_attention.plain_backward(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert flash_attention.BACKWARD.launches == before + 2
    for name, x, y, z in zip(("dq", "dk", "dv"), got, again, want):
        assert x.dtype == dtype and x.shape == z.shape, name
        assert torch.equal(x, y), f"{name} differs between two runs"
        torch.testing.assert_close(x.float(), z.float(), **TOL[dtype],
                                   msg=lambda m: f"{name}: {m}")


def test_autograd_launches_the_lse_forward_and_the_backward(cuda):
    q, k, v, do = _qkv(cuda, torch.bfloat16, 2, 96, 96, 8, 4, 64, seed=7)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    f0 = flash_attention.KERNEL.launches
    b0 = flash_attention.BACKWARD.launches
    o = ops.flash_attention(*leaves, causal=True, window=0, softcap=0.0)
    assert flash_attention.KERNEL.launches == f0 + 1
    assert flash_attention.BACKWARD.launches == b0
    grads = torch.autograd.grad(o, leaves, do)
    assert flash_attention.BACKWARD.launches == b0 + 1
    o2, lse = flash_attention.flash_attention_cuda(q, k, v, lse=True)
    assert torch.equal(o.detach(), o2)
    want = flash_attention.flash_attention_backward_cuda(q, k, v, o2, lse,
                                                         do)
    for x, y in zip(grads, want):
        assert torch.equal(x, y)
    with torch.no_grad():              # the serving call, no lse
        assert torch.equal(ops.flash_attention(*leaves), o2)


def test_backward_refuses_a_mask_with_more_q_rows_than_kv(cuda):
    q, k, v, do = _qkv(cuda, torch.float32, 1, 40, 20, 2, 2, 32, seed=1)
    o, lse = flash_attention.flash_attention_cuda(q, k, v, causal=False,
                                                  lse=True)
    with pytest.raises(ValueError, match="Sq <= Skv"):
        flash_attention.flash_attention_backward_cuda(q, k, v, o, lse, do)
    dq, _, _ = flash_attention.flash_attention_backward_cuda(
        q, k, v, o, lse, do, causal=False)
    want = flash_attention.plain_backward(q, k, v, o, lse, do, causal=False)
    torch.testing.assert_close(dq, want[0], **TOL[torch.float32])


#: (Bt, S, di, N, lanes of K6's plan): each of K6's lane plans, lengths
#: that are no multiple of the 32-step chunk (one step; several chunks),
#: lengths around 8 and 16 chunks (255, 256, 257, 513, 515 steps),
#: channel counts that are no multiple of the backward's 32-channel block,
#: a thin grid (one batch row, two blocks, the second mostly past di), 5,
#: 8 and 16 states
SCAN_GRAD_SHAPES = (
    (66, 45, 1024, 16, 2),
    (33, 40, 1000, 8, 2),
    (5, 70, 13600, 5, 2),
    (8, 70, 3200, 16, 4),
    (3, 100, 200, 5, 4),
    (2, 1, 40, 16, 4),
    (1, 129, 72, 8, 4),
    (2, 255, 1000, 16, 4),
    (1, 256, 72, 8, 4),
    (3, 257, 200, 5, 4),
    (12, 513, 3200, 16, 2),
    (2, 515, 3200, 16, 4),
    (1, 300, 40, 16, 4),
)
SCAN_STEP_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SCAN_REDUCED_TOL = 1e-3
SCAN_GRADS = ("du", "ddt", "dA", "dB", "dC", "dD")


def _scan_args(cuda, dtype, bt, s, di, n, seed):
    """u, dt, A, B, C, D as the kernel tests draw them, dy in u's type
    and a float32 dh_last."""
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    args = ((rnd(bt, s, di) * 0.5).to(dtype),
            torch.nn.functional.softplus(rnd(bt, s, di)) * 0.1,
            -torch.exp(rnd(di, n) * 0.3), rnd(bt, s, n), rnd(bt, s, n),
            rnd(di))
    return args, rnd(bt, s, di).to(dtype), rnd(bt, di, n)


def _check_scan_grads(got, want, dtype):
    for name, x, w in zip(SCAN_GRADS, got, want):
        assert x.dtype == w.dtype and x.shape == w.shape, name
        x, w = x.float(), w.float()
        if name in ("du", "ddt"):
            tol = SCAN_STEP_TOL[dtype if name == "du" else torch.float32]
            torch.testing.assert_close(x, w, atol=tol, rtol=tol,
                                       msg=lambda m: f"{name}: {m}")
        else:
            limit = SCAN_REDUCED_TOL * float(w.abs().max())
            assert float((x - w).abs().max()) <= limit, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bt,s,di,n,lanes", SCAN_GRAD_SHAPES)
def test_states_instance_keeps_the_output_and_writes_the_chunk_states(
        cuda, dtype, bt, s, di, n, lanes):
    assert selective_scan.plan(bt, di, n)[0] == lanes
    args, _, _ = _scan_args(cuda, dtype, bt, s, di, n, seed=s + di)
    before = selective_scan.KERNEL.launches
    y, h, states = selective_scan.selective_scan_cuda(*args, states=True)
    y0, h0 = selective_scan.selective_scan_cuda(*args)
    torch.cuda.synchronize()
    assert selective_scan.KERNEL.launches == before + 2
    assert torch.equal(y, y0) and torch.equal(h, h0)
    chunk = selective_scan.CHUNK
    assert states.shape == (bt, -(-s // chunk), di, n)
    assert not states[:, 0].any()
    u, dt, A, B, C, D = args
    for c in range(1, states.shape[1]):
        t = c * chunk
        _, want = selective_scan.plain(u[:, :t], dt[:, :t], A, B[:, :t],
                                       C[:, :t], D)
        torch.testing.assert_close(states[:, c], want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bt,s,di,n,lanes", SCAN_GRAD_SHAPES)
def test_scan_backward_kernel_matches_plain(cuda, dtype, bt, s, di, n,
                                            lanes):
    assert selective_scan.plan(bt, di, n)[0] == lanes
    args, dy, dh = _scan_args(cuda, dtype, bt, s, di, n, seed=3 * s + di)
    dh = dh if (s + n) % 2 else None     # a final-state gradient or none
    _, _, states = selective_scan.selective_scan_cuda(*args, states=True)
    before = selective_scan.BACKWARD.launches
    got = selective_scan.selective_scan_backward_cuda(*args, states, dy, dh)
    again = selective_scan.selective_scan_backward_cuda(*args, states, dy,
                                                        dh)
    want = selective_scan.plain_backward(*args, dy, dh)
    torch.cuda.synchronize()
    assert selective_scan.BACKWARD.launches == before + 2
    for name, x, y in zip(SCAN_GRADS, got, again):
        assert torch.equal(x, y), f"{name} differs between two runs"
    _check_scan_grads(got, want, dtype)


def test_scan_autograd_launches_the_states_forward_and_the_backward(
        cuda, monkeypatch):
    args, dy, dh = _scan_args(cuda, torch.bfloat16, 4, 77, 3200, 16, seed=9)
    leaves = [t.clone().requires_grad_() for t in args]

    def refused(*a, **k):
        raise AssertionError("a plain version ran on the card")
    monkeypatch.setattr(selective_scan, "plain", refused)
    monkeypatch.setattr(selective_scan, "plain_backward", refused)
    f0 = selective_scan.KERNEL.launches
    b0 = selective_scan.BACKWARD.launches
    y, h = ops.selective_scan(*leaves)
    assert selective_scan.KERNEL.launches == f0 + 1
    assert selective_scan.BACKWARD.launches == b0
    grads = torch.autograd.grad((y, h), leaves, (dy, dh))
    assert selective_scan.KERNEL.launches == f0 + 1
    assert selective_scan.BACKWARD.launches == b0 + 1
    y2, h2, states = selective_scan.selective_scan_cuda(*args, states=True)
    assert torch.equal(y.detach(), y2) and torch.equal(h.detach(), h2)
    want = selective_scan.selective_scan_backward_cuda(*args, states, dy, dh)
    for name, x, w in zip(SCAN_GRADS, grads, want):
        assert torch.equal(x, w), name
    (gy,) = torch.autograd.grad(ops.selective_scan(*leaves)[0], leaves[0],
                                dy)               # h_last's gradient: none
    want_du = selective_scan.selective_scan_backward_cuda(*args, states, dy)
    assert torch.equal(gy, want_du[0])
    with torch.no_grad():              # the serving call, no states
        assert torch.equal(ops.selective_scan(*leaves)[0], y2)
