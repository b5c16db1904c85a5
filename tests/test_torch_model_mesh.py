"""The model mesh (``distributed.sharding``: DTensor placement, the
reference's annotations, K3-K6 on local shards) against the unsharded
port, on the CPU.

Four gloo ranks on a (``data`` 2, ``model`` 2) mesh, spawned once for the
module (``tests/torch_mesh_ranks.py``), run a prefill and 4 greedy decode
steps of reduced float32 configs of all six families, the int8 weights of
a dense and a MoE model (K5 column- and row-parallel, and its expert
batch), the int8 K/V cache, and PaliGemma, whose single kv head the
``model`` axis does not divide, so that its cache is split along its
slots (K4's ``kLse`` instance on each rank's slots and the merge over
ranks); PaliGemma and Falcon-Mamba again with every gather written out
as an all-reduce (``sharding._gather_by_sum`` patched to say so, what a
gloo group on CUDA tensors takes). On every rank the sharded logits equal
the unsharded port's (float32, atol 1e-4 + rtol 1e-4), and so do the
greedy tokens wherever the top-2 margin exceeds 1e-3. The dense case
runs on the JAX package's weights carried across by
``convert.model_params`` and is also held against the reference's logits.

In-process, over a placeholder group: ``sharding.placements`` on the
duck meshes of ``tests/test_torch_sharding_rules.py``, and ``logical``,
``distribute_params`` and the cost counter (``obs.prof.profile_fn``) on a
real DeviceMesh of fake ranks: a matmul's counted flops are the local
shard's.
"""
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild_model

WORLD = 4
JOIN_S = 300
TOL = dict(atol=1e-4, rtol=1e-4)
MARGIN = 1e-3


def _host(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
        else np.asarray(a), tree)


def _reference_dense():
    """The dense case's weights from the JAX package (seed 3) and its
    reference logits under the tokens the port's unsharded run chose."""
    arch, over, _ = ranks.MODEL_CASES["dense"]
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), dtype="float32",
                               **over)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    return jm, jp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    jm, jp = _reference_dense()
    payload = tmp / "payload.pkl"
    with open(payload, "wb") as f:
        pickle.dump({"dense": _host(jp)}, f)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = ranks.spawn(ranks.run_model_rank, WORLD, (str(payload),),
                          str(tmp / "ranks"), JOIN_S)
    finally:
        torch.set_num_threads(n)
    return got, (jm, jp)


CASES = list(ranks.MODEL_CASES)


@pytest.mark.parametrize("name", CASES)
def test_sharded_logits_equal_the_unsharded_ports(runs, name):
    got, _ = runs
    for r in range(WORLD):
        case = got[r][name]
        assert len(case["sharded"]) == ranks.STEPS + 1
        for step, (a, b) in enumerate(zip(case["plain"], case["sharded"])):
            assert a.shape == b.shape and np.isfinite(b).all()
            np.testing.assert_allclose(b, a, err_msg=f"rank {r} step {step}",
                                       **TOL)


@pytest.mark.parametrize("name", CASES)
def test_sharded_greedy_tokens_equal_where_the_margin_is_clear(runs, name):
    got, _ = runs
    cfg = ranks.model_config(name)
    for r in range(WORLD):
        case = got[r][name]
        for a, b in zip(case["plain"], case["sharded"]):
            a, b = a[:, -1, :cfg.vocab_size], b[:, -1, :cfg.vocab_size]
            top2 = np.sort(a, -1)[:, -2:]
            clear = top2[:, 1] - top2[:, 0] > MARGIN
            np.testing.assert_array_equal(a.argmax(-1)[clear],
                                          b.argmax(-1)[clear])


@pytest.mark.parametrize("name", CASES)
def test_each_kernel_of_the_family_ran_on_local_shards(runs, name):
    """Every kernel the family runs went through its sharded seam; the
    length-split cache through the ``kLse`` merge, and only it."""
    got, _ = runs
    cfg = ranks.model_config(name)
    c = got[0][name]["counts"]
    assert (c["_sharded_flash"] > 0) == cfg.has_attention
    assert (c["_sharded_decode"] > 0) == cfg.has_attention
    assert (c["_sharded_scan"] > 0) == (cfg.ssm is not None)
    assert (c["_sharded_int8"] > 0) == (cfg.quant == "int8")
    split = cfg.has_attention and cfg.n_kv_heads % ranks.MESH_SHAPE[1] != 0
    assert (c["_merge_over"] > 0) == split
    assert all(got[r][name]["counts"] == c for r in range(WORLD))


def test_a_length_split_cache_is_split_along_its_slots(runs):
    got, _ = runs
    for name in ("vlm", "kv_int8_length"):
        seg = got[0][name]["cache"][0]
        assert seg["k"] == ("Shard(dim=1)", "Shard(dim=2)"), name
    assert got[0]["kv_int8_length"]["cache"][0]["k_s"] == \
        ("Shard(dim=1)", "Shard(dim=2)")
    # kv heads the model axis divides: heads split, slots whole
    assert got[0]["dense"]["cache"][0]["k"] == \
        ("Shard(dim=1)", "Shard(dim=3)")
    assert got[0]["ssm"]["cache"][0]["h"] == \
        ("Shard(dim=1)", "Shard(dim=2)")


def test_params_are_placed_at_their_shardings(runs):
    got, _ = runs
    p = got[0]["dense"]["params"]
    layer = p["segments"][0][0]
    assert layer["attn"]["wq"]["w"] == ("Shard(dim=0)", "Shard(dim=1)")
    assert layer["attn"]["wo"]["w"] == ("Shard(dim=1)", "Shard(dim=0)")
    assert p["embed"]["w"] == ("Replicate()", "Shard(dim=0)")
    q = got[0]["dense_int8"]["params"]["segments"][0][0]
    assert q["mlp"]["w_down"]["w_q"] == ("Shard(dim=1)", "Shard(dim=0)")
    assert q["mlp"]["w_down"]["s"] == ("Shard(dim=1)", "Replicate()")
    e = got[0]["moe_int8"]["params"]["segments"][0][0]["moe"]
    assert e["w_gate"]["w_q"] == ("Shard(dim=1)", "Shard(dim=0)")


def test_the_dense_case_equals_the_reference_on_its_weights(runs):
    """The dense case ran on the JAX package's weights: its sharded
    logits hold against the reference's prefill and decode, fed the
    same tokens."""
    got, (jm, jp) = runs
    cfg = ranks.model_config("dense")
    batch = {k: jnp.asarray(v) for k, v in ranks.model_batch(cfg).items()}
    lg, cache = jm.prefill(jp, batch, max_len=ranks.max_len(cfg))
    want = [np.asarray(lg, np.float32)]
    for tok in got[0]["dense"]["tokens"]:
        lg, cache = jm.decode(jp, cache, jnp.asarray(tok))
        want.append(np.asarray(lg, np.float32))
    for r in range(WORLD):
        for step, (w, b) in enumerate(zip(want, got[r]["dense"]["sharded"])):
            np.testing.assert_allclose(b, w, atol=1e-4, rtol=1e-5,
                                       err_msg=f"rank {r} step {step}")


# ------------------------------------------------------------ in-process ----
class DuckMesh:
    """The two attributes the spec code reads (as in
    ``tests/test_torch_sharding_rules.py``)."""

    def __init__(self, sizes, names):
        self.shape = dict(zip(names, sizes))
        self.axis_names = tuple(names)


def test_placements_of_specs_on_duck_meshes():
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed import sharding
    from repro_torch.distributed.sharding import PartitionSpec as P
    two = DuckMesh((16, 16), ("data", "model"))
    three = DuckMesh((2, 16, 16), ("pod", "data", "model"))
    thin = DuckMesh((1, 2), ("data", "model"))
    R = Replicate()
    assert sharding.placements(P("data", None, "model", None), two) == \
        (Shard(0), Shard(2))
    assert sharding.placements(P(None, ("data", "model")), two) == \
        (Shard(1), Shard(1))
    assert sharding.placements(P(("pod", "data"), None, "model"), three) \
        == (Shard(0), Shard(0), Shard(2))
    assert sharding.placements(P(None, None), two) == (R, R)
    assert sharding.placements(None, three) == (R, R, R)
    # an axis of size 1 replicates: its one shard is the whole tensor
    assert sharding.placements(P("data", "model"), thin) == (R, Shard(1))
    for shape, axes in (((8, 128, 32, 64), ("batch", "seq", "heads", None)),
                        ((1, 4096, 1, 64),
                         ("batch", "cache_len", "kv_heads", None))):
        spec = sharding.spec_for(shape, axes, two)
        got = sharding.placements(spec, two)
        for i, ax in enumerate(two.axis_names):
            dims = [d for d, e in enumerate(spec)
                    if ax in sharding._axes_of(e)]
            assert got[i] == (Shard(dims[0]) if dims else R)


@pytest.fixture
def fake_mesh():
    """A (data 2, model 2) DeviceMesh over a placeholder group of 4 fake
    ranks (this process rank 0)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_mesh
    hook = __import__("sys").excepthook
    dist.init_process_group("fake", store=FakeStore(), world_size=4, rank=0)
    try:
        yield make_mesh((2, 2), device_type="cpu")
    finally:
        dist.destroy_process_group()
        __import__("sys").excepthook = hook


def test_logical_and_distribute_params_place_at_the_specs(fake_mesh):
    from repro_torch.distributed import sharding
    mesh = fake_mesh
    x = torch.arange(8 * 6 * 4 * 2, dtype=torch.float32).reshape(8, 6, 4, 2)
    assert sharding.logical(x, "batch", "seq", "heads", None) is x
    with sharding.model_mesh(mesh):
        y = sharding.logical(x, "batch", "seq", "heads", None)
        assert tuple(map(repr, y.placements)) == \
            ("Shard(dim=0)", "Shard(dim=2)")
        assert torch.equal(y.to_local(), x[:4, :, :2])
        # a dim its axes do not divide stays replicated
        odd = sharding.logical(x[:3], "batch", "seq", "heads", None)
        assert tuple(map(repr, odd.placements)) == \
            ("Replicate()", "Shard(dim=2)")
        d = sharding.shard_moe_dispatch(torch.zeros(4, 6, 3, 2))
        assert tuple(map(repr, d.placements)) == \
            ("Shard(dim=0)", "Shard(dim=1)")
    assert sharding.current_mesh() is None
    from repro_torch.kernels.int8_matmul import k_major
    w_q = k_major(torch.arange(12 * 8, dtype=torch.int8).reshape(12, 8))
    params = {"mlp": {"w_down": {"w_q": w_q, "s": torch.ones(1, 8)}},
              "attn": {"wq": {"w": torch.ones(12, 8)}}}
    placed = sharding.distribute_params(params, mesh)
    local = placed["mlp"]["w_down"]["w_q"].to_local()
    assert local.shape == (6, 4) and local.stride() == (1, 6)
    assert torch.equal(local, w_q[:6, :4])
    assert placed["attn"]["wq"]["w"].to_local().shape == (6, 4)


def test_the_cost_counter_counts_the_local_matmul(fake_mesh):
    """A column-parallel then row-parallel product on DTensors: the
    counted flops are one device's shards', and the row-parallel
    product's all-reduce is counted at its local bytes, times 2."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed import sharding
    from repro_torch.obs.prof import profile_fn
    mesh = fake_mesh
    dm = mesh.device_mesh
    x = sharding.to_places(torch.randn(8, 64), (Shard(0), Replicate()), dm)
    w1 = sharding.to_places(torch.randn(64, 32), (Replicate(), Shard(1)), dm)
    w2 = sharding.to_places(torch.randn(32, 16), (Replicate(), Shard(0)), dm)

    def fn(x, w1, w2):
        return (x @ w1 @ w2).redistribute(dm, (Shard(0), Replicate()))
    prof = profile_fn(fn, x, w1, w2)
    # (4, 64) x (64, 16) then (4, 16) x (16, 16), two flops a MAC
    assert prof.flops == 2 * 4 * 64 * 16 + 2 * 4 * 16 * 16
    assert prof.collectives == {"all-reduce": 2.0 * 4 * 16 * 4}
    whole = profile_fn(lambda a, b, c: a @ b @ c, torch.randn(8, 64),
                       torch.randn(64, 32), torch.randn(32, 16))
    assert whole.flops == 2 * 8 * 64 * 32 + 2 * 8 * 32 * 16


def test_a_row_parallel_partial_is_a_bf16_product_in_the_trace(
        fake_mesh, monkeypatch):
    """A row-parallel dense product in bf16 (``ops.sharded_matmul``) is
    traced as one bf16 x bf16 product with a float32 output, the card's
    path, counted at the local shard's flops; on real CPU tensors its
    float32 product is taken."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.obs.prof import profile_fn
    dm = fake_mesh.device_mesh
    x = sharding.to_places(torch.randn(8, 64).bfloat16(),
                           (Replicate(), Shard(1)), dm)
    w = sharding.to_places(torch.randn(64, 16).bfloat16(),
                           (Replicate(), Shard(0)), dm)
    calls, mm = [], torch.mm

    def seen(a, b, *rest, **kw):
        calls.append((a.dtype, b.dtype, kw.get("out_dtype")))
        return mm(a, b, *rest, **kw)
    monkeypatch.setattr(torch, "mm", seen)
    prof = profile_fn(ops.sharded_matmul, x, w)
    assert calls == [(torch.bfloat16, torch.bfloat16, torch.float32)]
    # the local (8, 32) x (32, 16) product, then the reduced (8, 16)
    # rounded to bf16 (one op an element); no float32 copy of a shard
    assert prof.flops == 2 * 8 * 32 * 16 + 8 * 16
    calls.clear()
    ops.sharded_matmul(x, w)
    assert calls == []


# ------------------------------------------------------------- dry run ----
def _rule_bytes(args, kind, mesh):
    """One device's argument bytes from the rules alone: each leaf's
    elements over the sizes of the mesh axes its spec names."""
    import math
    from repro_torch.distributed import sharding
    params, batch = args
    specs = (sharding.param_shardings(params, mesh),
             sharding.batch_specs(batch, mesh))
    total = 0

    def walk(t, s):
        nonlocal total
        if isinstance(t, dict):
            for k in t:
                walk(t[k], s[k])
        elif isinstance(t, (list, tuple)):
            for a, b in zip(t, s):
                walk(a, b)
        elif isinstance(t, torch.Tensor):
            n = math.prod(mesh.shape[a] for e in (s or ())
                          for a in sharding._axes_of(e))
            total += t.numel() // n * t.element_size()
    walk((params, batch), specs)
    return total


@pytest.mark.parametrize("shape", [("prefill_small", 128, 32, "prefill"),
                                   ("decode_small", 256, 32, "decode")])
def test_a_sharded_dry_run_row_counts_one_device(monkeypatch, shape):
    """A reduced Gemma3 pair on the 16 x 16 placeholder mesh: the traced
    local shards' bytes equal the rule-derived bytes exactly; the mesh's
    devices do at least the one-device trace's flops between them; the
    collective term is counted."""
    from repro_torch.configs import InputShape, get_config, reduced
    from repro_torch.launch import dryrun, mesh as tmesh
    from repro_torch.obs.prof import profile_fn
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: reduced(get_config(arch)))
    shape = InputShape(*shape)
    row = dryrun.run_one("gemma3-4b", shape, False, device="cpu",
                         verbose=False)
    assert row["ok"], row.get("error")
    fn, args, _ = dryrun.build_lowerable("gemma3-4b", shape, device="cpu")
    one = profile_fn(fn, *args)
    with tmesh.placeholder_group():
        mesh = tmesh.make_production_mesh(device_type="cpu")
        want = _rule_bytes(args, shape.kind, mesh)
    assert row["split"] == "sharded"
    assert row["arg_bytes_per_device"] == row["arg_bytes_traced"] == want
    assert row["n_devices"] * row["flops_per_device"] >= one.flops
    assert row["flops_per_device"] < one.flops
    assert row["collective_s"] > 0 and row["collectives"]


def test_a_train_row_stays_ideal_with_its_note(monkeypatch):
    from repro_torch.configs import InputShape, get_config, reduced
    from repro_torch.launch import dryrun
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: reduced(get_config(arch)))
    row = dryrun.run_one("granite-moe-1b-a400m",
                         InputShape("train_small", 64, 32, "train"), False,
                         device="cpu", verbose=False)
    assert row["ok"] and row["split"] == "ideal"
    assert row["collective_s"] is None and "next slice" in row["note"]
