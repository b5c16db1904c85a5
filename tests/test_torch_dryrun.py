"""The port's dry run (``repro_torch.launch.dryrun``, ``launch.mesh``)
and the spec methods it stands on, against the reference's, on the CPU:
``pairs()`` and ``LONG_CTX_OK``; ``model_flops`` of all 40 pairs at
published size against the reference's ``build_lowerable`` under an
abstract mesh; the shapes and dtypes of ``input_specs`` /
``cache_spec`` / ``mamba_cache_spec`` for every arch x shape under both
``kv_cache_dtype`` values; the per-device argument bytes of every pair
the dry run runs, on 16 x 16 and 2 x 16 x 16, against the bytes of the
reference's shardings; the meshes over a placeholder process group;
and one CLI run on the CPU.

``repro.launch.dryrun`` appends a 512-device count to ``XLA_FLAGS`` when
imported, so it is imported after ``jax.devices()`` has started the
backend: the flag then changes nothing in this process.
"""
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import mamba as jmamba
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, InputShape,
                                 get_config, list_archs, reduced)
from repro_torch.launch import dryrun, mesh as tmesh
from repro_torch.models import build_model
from repro_torch.models.mamba import mamba_cache_spec
from repro_torch.obs.prof import profile_fn
from repro_torch.tuning import FLAGS


def _reference_dryrun():
    jax.devices()
    import repro.launch.dryrun as jd
    return jd


class Mesh:
    """The two attributes the spec code reads (as in
    ``tests/test_torch_sharding_rules.py``)."""

    def __init__(self, sizes, names):
        self.shape = dict(zip(names, sizes))
        self.axis_names = tuple(names)
        self.size = math.prod(sizes)


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}

#: the keys of a reference row (``repro/launch/dryrun.py`` ``run_one``)
REFERENCE_ROW_KEYS = (
    "arch", "shape", "kind", "params", "active_params", "tokens",
    "model_flops", "mesh", "n_devices", "ok", "seconds", "flops_per_device",
    "bytes_per_device", "collective_bytes_per_device", "collectives",
    "compute_s", "memory_s", "collective_s", "model_flops_per_device",
    "useful_flops_ratio", "arg_bytes_per_device", "temp_bytes_per_device",
    "out_bytes_per_device", "dominant")


def test_config_names_equal_the_references():
    from repro.configs import ARCH_IDS as JARCH, list_archs as jlist
    assert ARCH_IDS == JARCH and list_archs() == jlist()
    assert list(INPUT_SHAPES) == list(JSHAPES)
    for name, shape in INPUT_SHAPES.items():
        assert isinstance(shape, InputShape)
        assert (shape.name, shape.seq_len, shape.global_batch,
                shape.kind) == (JSHAPES[name].name, JSHAPES[name].seq_len,
                                JSHAPES[name].global_batch,
                                JSHAPES[name].kind)


def test_pairs_and_the_skip_list_equal_the_references():
    jd = _reference_dryrun()
    assert dryrun.LONG_CTX_OK == jd.LONG_CTX_OK
    for skips in (False, True):
        assert list(dryrun.pairs(skips)) == list(jd.pairs(skips))
    all_pairs = list(dryrun.pairs(True))
    assert len(all_pairs) == 40
    assert sum(s == "skip" for *_, s in all_pairs) == 7


def test_model_flops_of_all_40_pairs_equal_the_references():
    jd = _reference_dryrun()
    from jax.sharding import AbstractMesh
    from repro.distributed import sharding as jsharding
    jsharding.activate_mesh(AbstractMesh((16, 16), ("data", "model")))
    try:
        for arch, shape, _ in dryrun.pairs(include_long_skips=True):
            meta = jd.build_lowerable(arch, shape, unroll=False)[4]
            tokens, flops = dryrun.model_flops(get_config(arch),
                                               INPUT_SHAPES[shape])
            assert (tokens, flops) == (meta["tokens"],
                                       meta["model_flops"]), (arch, shape)
    finally:
        jsharding.activate_mesh(None)


def _dtype_name(d) -> str:
    return str(d).split(".")[-1] if isinstance(d, torch.dtype) else \
        np.dtype(d).name


def _spec_tree(tree):
    """{path: (shape, dtype name)} of a spec tree of either package."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, (list, tuple)) and not (
                len(t) == 2 and isinstance(t[0], tuple)):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        elif isinstance(t, tuple):                  # (shape, dtype)
            out[path] = (tuple(t[0]), _dtype_name(t[1]))
        else:
            out[path] = (tuple(t.shape), _dtype_name(t.dtype))
    walk(tree, ())
    return out


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_specs_equal_the_references(kv, monkeypatch):
    from repro.tuning import FLAGS as JFLAGS
    monkeypatch.setitem(JFLAGS, "kv_cache_dtype", kv)
    monkeypatch.setitem(FLAGS, "kv_cache_dtype", kv)
    dtypes = {"bfloat16", "float32", "int32", "int8"}
    for arch in ARCH_IDS:
        jm, m = jbuild_model(jget_config(arch)), build_model(get_config(arch))
        for name, shape in INPUT_SHAPES.items():
            got = _spec_tree(m.input_specs(shape))
            want = _spec_tree(jm.input_specs(JSHAPES[name]))
            assert got == want, (arch, name)
            assert {d for _, d in got.values()} <= dtypes
            leaves = [t for t in jax.tree_util.tree_leaves(
                m.input_specs(shape))]
            assert all(t.device.type == "meta" for t in leaves)
        assert _spec_tree(m.cache_spec(3, 100)) == \
            _spec_tree(jm.cache_spec(3, 100)), arch
        if m.cfg.ssm is not None:
            assert _spec_tree(mamba_cache_spec(m.cfg, 5)) == _spec_tree(
                jmamba.mamba_cache_spec(jm.cfg, 5)), arch
    if kv == "int8":
        seg = build_model(get_config("gemma3-4b")).cache_spec(2, 8)[
            "segments"][0]
        assert seg["k"].dtype == torch.int8 and \
            seg["k_s"].dtype == torch.float32


def _reference_arg_bytes(jd, arch, shape, sizes, names):
    """Bytes of one device's shards of the reference's arguments of a
    pair, each leaf's shard shape under its own sharding."""
    from jax.sharding import AbstractMesh
    from repro.distributed import sharding as jsharding
    jsharding.activate_mesh(AbstractMesh(sizes, names))
    try:
        _, args, in_sh, _, _ = jd.build_lowerable(arch, shape, unroll=False)
    finally:
        jsharding.activate_mesh(None)
    total = 0
    for leaf, sh in zip(jax.tree_util.tree_leaves(args),
                        jax.tree_util.tree_leaves(in_sh)):
        total += math.prod(sh.shard_shape(leaf.shape)) * \
            np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arg_bytes_per_device_equal_the_references_shardings(arch):
    """Every pair the dry run runs. The reference's arguments hold one
    int32 scalar the port keeps as a Python int: the optimizer's step
    (train) or the cache's position (decode), 4 bytes on every device."""
    jd = _reference_dryrun()
    for a, shape, status in dryrun.pairs():
        if a != arch:
            continue
        fn, args, meta = dryrun.build_lowerable(arch, shape, device="cpu")
        for label, (sizes, names) in MESHES.items():
            m = Mesh(sizes, names)
            got = dryrun.arg_bytes_per_device(
                args, dryrun.arg_specs(args, meta["kind"], m), m)
            scalar = 0 if meta["kind"] == "prefill" else 4
            want = _reference_arg_bytes(jd, arch, shape, sizes, names)
            assert got + scalar == want, (arch, shape, label)


def test_meshes_over_a_placeholder_group():
    import torch.distributed as dist
    one = tmesh.make_tier_mesh("C", device_type="cpu")
    assert (one.shape, one.size) == ({"data": 1, "model": 1}, 1)
    with pytest.raises(RuntimeError, match="placeholder_group"):
        tmesh.make_production_mesh(device_type="cpu")
    with tmesh.placeholder_group():
        assert dist.get_world_size() == tmesh.PLACEHOLDER_WORLD
        pod = tmesh.make_production_mesh(device_type="cpu")
        two = tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
        assert (pod.shape, pod.axis_names, pod.size) == \
            ({"data": 16, "model": 16}, ("data", "model"), 256)
        assert (two.shape, two.size) == \
            ({"pod": 2, "data": 16, "model": 16}, 512)
        assert [tmesh.make_tier_mesh(t, device_type="cpu").shape["model"]
                for t in "SEC"] == [1, 8, 512]
        duck = Mesh((2, 16, 16), ("pod", "data", "model"))
        from repro_torch.distributed import sharding
        for shape, axes in (((256, 4096, 8, 128),
                             ("batch", "cache_len", "kv_heads", None)),
                            ((8, 2048, 4096), ("batch", "seq", "embed"))):
            assert sharding.spec_for(shape, axes, two) == \
                sharding.spec_for(shape, axes, duck)
    assert not dist.is_initialized()
    assert tmesh.PEAK_BF16_FLOPS == 989e12 and tmesh.HBM_BW == 3.35e12


def test_cli_writes_a_row_with_the_references_keys(tmp_path, monkeypatch,
                                                   capsys):
    """A reduced Hymba decode pair on CPU fakes through ``main``, under
    ``--tune kv_cache_dtype=int8``: one JSONL row a mesh, appended."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: reduced(get_config(arch)))
    monkeypatch.setitem(FLAGS, "kv_cache_dtype", "bf16")
    out = tmp_path / "rows.jsonl"
    argv = ["--device", "cpu", "--arch", "hymba-1.5b", "--shape",
            "decode_32k", "--both-meshes", "--out", str(out), "--tune",
            "kv_cache_dtype=int8"]
    assert dryrun.main(argv) == 0
    assert dryrun.main(argv[:6] + ["--out", str(out)]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["mesh"] for r in rows] == ["16x16", "2x16x16", "16x16"]
    for r in rows:
        assert set(REFERENCE_ROW_KEYS) <= set(r)
        assert r["ok"] and r["split"] == "ideal" and r["note"]
        assert r["collective_s"] is None and r["dominant"] in (
            "compute", "memory")
        assert 0 < r["useful_flops_ratio"] and r["temp_bytes_per_device"] \
            >= 0 and r["device"] == "cpu"
    assert rows[0]["n_devices"] * rows[0]["flops_per_device"] == \
        pytest.approx(rows[1]["n_devices"] * rows[1]["flops_per_device"])
    assert "kv_cache_dtype" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="attn_chunk"):
        dryrun.main(argv[:6] + ["--tune", "attn_chunk=512"])
    with pytest.raises(SystemExit):
        dryrun.main(argv[:6] + ["--hlo-dir", str(tmp_path)])


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.build_lowerable("gemma3-4b", "prefill_32k")


def test_a_decode_pair_traces_the_int8_cache(monkeypatch):
    """Under ``kv_cache_dtype=int8`` the decode pair's cache is int8 with
    its scales; the step traces through the quantized write and K4 (one
    record a layer), as the bf16 cache's does."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: reduced(get_config(arch)))
    shape = InputShape("decode_small", 256, 4, "decode")
    seen = []
    sink = lambda name, ops, nbytes: seen.append(name)  # noqa: E731
    for kv in ("bf16", "int8"):
        monkeypatch.setitem(FLAGS, "kv_cache_dtype", kv)
        fn, args, meta = dryrun.build_lowerable("gemma3-4b", shape,
                                                device="cpu")
        seg = args[1]["cache"]["segments"][0]
        assert (seg["k"].dtype == torch.int8) == (kv == "int8")
        assert ("k_s" in seg) == (kv == "int8")
        _build.COST_SINKS.append(sink)
        try:
            prof = profile_fn(fn, *args)
        finally:
            _build.COST_SINKS.remove(sink)
        assert seen.count("decode_attention") == 2
        seen.clear()
        assert prof.peak_live_bytes >= prof.arg_bytes
