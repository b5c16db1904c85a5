"""The fake-tensor trace (``obs.prof.profile_fn``) of the served models
and their training step, which the dry run stands on, on the CPU:

* K3's cost is counted on the host, so a model's prefill traces
  (it read a torch sum back under ``FakeTensorMode`` and raised);
* under grad mode the attention and the scan go through their autograd
  functions on fakes too: a traced training step gives every parameter
  that the real step gives a gradient one, and records K3's and K6's
  training instances (twice a layer under full remat) and their
  backwards P2 and P3 (once a layer);
* each fake op allocates what its launch allocates, and the trace's
  peak of live bytes follows storages: a view or an in-place op adds
  nothing, a freed temporary leaves the count;
* a query of metadata (``prim.device``, dispatched by indexing on the
  whole indexed tensor) moves no bytes: a decode's slot write counted
  the whole cache.
"""
import collections
import dataclasses

import pytest
import torch

from repro_torch import training
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import (_build, best_response, decode_attention,
                                 flash_attention, int8_matmul, ops,
                                 selective_scan)
from repro_torch.models import build_model
from repro_torch.obs.prof import profile_fn


class Recorded:
    """The kernels' cost records of a trace, by name."""

    def __enter__(self):
        self.counts = collections.Counter()
        self.ops = collections.Counter()
        _build.COST_SINKS.append(self.sink)
        return self

    def sink(self, name, ops_, nbytes):
        self.counts[name] += 1
        self.ops[name] += ops_

    def __exit__(self, *exc):
        _build.COST_SINKS.remove(self.sink)


def test_a_fake_prefill_traces_and_counts_k3_on_the_host():
    cfg = reduced(get_config("gemma3-4b"))
    m = build_model(cfg)
    p = m.init(0, device="cpu")
    toks = torch.zeros((2, 96), dtype=torch.int32)
    with Recorded() as rec:
        prof = profile_fn(lambda p, b: m.prefill(p, b), p, {"tokens": toks})
    # a sliding layer (window 64 over 96 tokens) and a global one
    hd = cfg.resolved_head_dim
    want = sum(flash_attention.cost(2, 96, 96, cfg.n_heads, cfg.n_kv_heads,
                                    hd, 2, causal=True, window=w)[0]
               for w in (cfg.sliding_window, 0))
    assert rec.counts["flash_attention"] == 2
    assert rec.ops["flash_attention"] == want
    assert prof.flops > want and prof.peak_live_bytes > prof.arg_bytes


def _batch(cfg, b=2, s=48):
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=torch.Generator()
                                     .manual_seed(0), dtype=torch.int32)}
    if cfg.is_encdec:
        batch["frames"] = torch.randn((b, cfg.enc_seq, cfg.d_model))
    return batch


def _grads_of(step, state, batch, trace, monkeypatch):
    """Which trained leaves the step's ``torch.autograd.grad`` gives a
    gradient, real or traced."""
    got = []
    real = torch.autograd.grad

    def grad(*args, **kwargs):
        out = real(*args, **kwargs)
        got.append([g is not None for g in out])
        return out
    monkeypatch.setattr(torch.autograd, "grad", grad)
    if trace:
        with Recorded() as rec:
            profile_fn(step, state, batch)
    else:
        rec = None
        step(state, batch)
    monkeypatch.setattr(torch.autograd, "grad", real)
    return got[0], rec


@pytest.mark.parametrize("arch,attn,scan", [("gemma3-4b", 2, 0),
                                            ("hymba-1.5b", 2, 2)])
def test_a_fake_training_step_keeps_every_gradient(arch, attn, scan,
                                                   monkeypatch):
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    m = build_model(cfg)
    step = training.make_train_step(m, training.AdamWConfig(), remat=True)
    state = training.init_state(m, 0, device="cpu")
    batch = _batch(cfg)
    traced, rec = _grads_of(step, state, batch, True, monkeypatch)
    real, _ = _grads_of(step, state, batch, False, monkeypatch)
    assert traced == real and all(real)
    # one layer each; full remat runs each forward twice
    assert rec.counts == collections.Counter(
        {k: n for k, n in (("flash_attention", 2 * attn),
                           ("flash_attention_backward", attn),
                           ("selective_scan", 2 * scan),
                           ("selective_scan_backward", scan)) if n})


def _extra(fn, *args):
    """A fake call's peak live bytes less its arguments'."""
    prof = profile_fn(fn, *args)
    return prof.peak_live_bytes - prof.arg_bytes


def test_a_metadata_query_moves_no_bytes():
    """Indexing dispatches ``prim.device`` on the whole indexed tensor; a
    query that returns no tensor reads nothing, so a slot write into a
    cache moves the slot's bytes, not the cache's."""
    cache, row = torch.zeros((4, 100, 8)), torch.ones((4, 8))

    def write(c, r):
        c[:, 7] = r
        return c
    prof = profile_fn(write, cache, row)
    assert prof.bytes_accessed == 3 * row.numel() * 4     # copy_ in, out
    x = torch.ones((1000, 10))
    assert profile_fn(lambda x: x[:, 2:5].sum(), x).bytes_accessed == \
        3000 * 4 + 4


def test_live_bytes_follow_storages():
    x = torch.ones(1000)
    assert _extra(lambda x: x.view(10, 100).add_(1.0).t(), x) == 0
    # three temporaries in a row, each freed once the next is made
    assert _extra(lambda x: ((x * 2.0 + 1.0) * 3.0).sum(), x) == 2 * 4000
    prof = profile_fn(lambda x: ((x * 2.0 + 1.0) * 3.0).sum(), x)
    assert prof.temp_bytes == 3 * 4000


def test_fake_attention_allocates_what_its_launches_allocate():
    b, s, h, kv, hd = 2, 64, 4, 2, 32
    q = torch.zeros((b, s, h, hd))
    k = torch.zeros((b, s, kv, hd))
    o_bytes = q.numel() * 4
    assert _extra(lambda q, k, v: ops.flash_attention(q, k, v), q, k, k) \
        == o_bytes
    # training: the kLse row stays beside o until the backward
    qg = q.clone().requires_grad_(True)
    with Recorded() as rec:
        extra = _extra(lambda q, k, v: ops.flash_attention(q, k, v), qg, k,
                       k)
    assert extra == o_bytes + 4 * b * h * s
    assert rec.counts == {"flash_attention": 1}
    # decode: the bias row (and the bool mask it came from), the output
    # and the split workspace
    slots = 4096
    qd = torch.zeros((b, h, hd))
    cache = torch.zeros((b, slots, kv, hd))
    pos = torch.arange(slots)[None].expand(b, slots).contiguous()
    splits, _ = decode_attention.split_plan(b, kv, slots, h // kv)
    assert splits > 1
    want = b * slots * (1 + 4) + qd.numel() * 4 + \
        b * h * splits * (hd + 2) * 4
    assert _extra(lambda *a: ops.decode_attention(*a), qd, cache, cache,
                  pos, torch.full((b,), slots - 1)) == want


def test_fake_int8_matmul_allocates_the_padded_operands():
    e, m_, k, n = 3, 8, 40, 24                   # K no multiple of 16
    x = torch.zeros((e, m_, k), dtype=torch.int8)
    w = int8_matmul.k_major(torch.zeros((e, k, n), dtype=torch.int8))
    sx, sw = torch.ones((e, m_, 1)), torch.ones((e, 1, n))
    kp = 64
    assert _extra(lambda *a: ops.int8_matmul(*a, out_dtype=torch.bfloat16),
                  x, sx, w, sw) == e * (m_ * kp + n * kp + 2 * m_ * n)


def test_fake_scan_training_allocates_states_and_partials():
    bt, s, di, n = 2, 40, 48, 8
    g = torch.Generator().manual_seed(0)
    u = torch.randn((bt, s, di), generator=g).requires_grad_(True)
    dt = torch.rand((bt, s, di), generator=g)
    A, D = -torch.rand((di, n), generator=g), torch.ones(di)
    B, C = torch.randn((bt, s, n), generator=g), torch.randn((bt, s, n),
                                                             generator=g)

    def step(u, dt, A, B, C, D):
        y, _ = ops.selective_scan(u, dt, A, B, C, D)
        return torch.autograd.grad(y.sum(), u)[0]
    with Recorded() as rec:
        extra = _extra(step, u, dt, A, B, C, D)
    assert rec.counts == {"selective_scan": 1, "selective_scan_backward": 1}
    states = bt * -(-s // selective_scan.CHUNK) * di * n * 4
    partials = 4 * (2 * bt * -(-di // selective_scan.BWD_CHANNELS) * s * n
                    + bt * di * (n + 1))
    assert extra >= states + partials + 2 * u.numel() * 4


def test_fake_best_response_allocates_its_scratch():
    cells, users, k, edges = 32, 2, 20, 3
    i32 = dict(dtype=torch.int32)
    args = (torch.zeros(cells, **i32), torch.zeros((k, users), **i32),
            torch.zeros((cells, users), **i32), torch.zeros(cells, **i32),
            torch.zeros((cells, users), dtype=torch.bool),
            torch.zeros((cells, k), dtype=torch.bool),
            torch.zeros((cells, k), **i32), torch.zeros((cells, k), **i32),
            torch.zeros(cells, **i32), torch.ones(edges))
    packed = best_response.pack_actions(args[1])
    scratch = 4 * (cells + 1 + edges + 3 + 8 * cells + edges) + cells * 32
    assert _extra(lambda *a: ops.best_response_round(
        *a, cloud_servers=4.0, packed=packed), *args) == scratch
