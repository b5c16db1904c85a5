"""The port's logical-axis sharding rules
(``repro_torch.distributed.sharding``) and fleet specs against the
reference's, bit for bit, on duck-typed meshes: the reference's spec code
reads only a mesh's ``shape`` and ``axis_names``. The parameter specs
cover every architecture's parameter tree at its published size (shapes
only, from ``jax.eval_shape``)."""
import jax
import pytest

from repro.configs import ARCH_IDS, get_config
from repro.distributed import sharding as jsharding
from repro.fleet import shard as jshard
from repro.models import build_model
from repro_torch.distributed import sharding
from repro_torch.fleet import shard


class Mesh:
    """The two attributes the spec code reads."""

    def __init__(self, sizes, names):
        self.shape = dict(zip(names, sizes))
        self.axis_names = tuple(names)


MESHES = {"data16x16": Mesh((16, 16), ("data", "model")),
          "pod2x16x16": Mesh((2, 16, 16), ("pod", "data", "model")),
          "fleet2": Mesh((2,), ("fleet",)),
          "fleet8": Mesh((8,), ("fleet",))}

ACTIVATIONS = [
    ((8, 128, 25, 64), ("batch", "seq", "heads", None)),
    ((1, 128, 32, 128), ("batch", "seq", "heads", None)),
    ((64, 4096, 8, 128), ("batch", "cache_len", "kv_heads", None)),
    ((1, 32768, 5, 128), ("batch", "cache_len", "kv_heads", None)),
    ((8, 2048, 4096), ("batch", "seq", "embed")),
    ((8, 2048, 14336), ("batch", "seq", "mlp")),
    ((4, 16, 64, 4096), ("batch", "expert", None, None)),
    ((2, 8192, 256000), ("batch", "seq", "vocab")),
    ((1024, 5), ("cells", None)),
    ((1023, 5), ("cells", None)),
    ((64,), ("edges",)),
    ((3, 7), ()),
]


@pytest.mark.parametrize("mesh", MESHES, ids=list(MESHES))
def test_spec_for_equals_the_references(mesh):
    m = MESHES[mesh]
    for shape, axes in ACTIVATIONS:
        want = jsharding.spec_for(shape, axes, m)
        got = sharding.spec_for(shape, axes, m)
        assert tuple(got) == tuple(want), (shape, axes)
    assert sharding.spec_for((4, 4), ("batch", None)) is None


@pytest.mark.parametrize("mesh", ["fleet2", "fleet8"])
def test_fleet_spec_equals_the_references(mesh):
    m = MESHES[mesh]
    for shape in ((16, 3), (17, 3), (8, 16, 2), (24,), (7,)):
        for axis in range(len(shape)):
            for logical in ("cells", "edges"):
                want = jshard.fleet_spec(m, shape, axis, logical)
                got = shard.fleet_spec(m, shape, axis, logical)
                assert tuple(got) == tuple(want), (shape, axis, logical)


def _specs_by_path(tree, path=()):
    """{path: spec} of the port's nested dicts and lists of specs."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_specs_by_path(v, path + (str(k),)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_specs_by_path(v, path + (str(i),)))
        return out
    return {path: tree}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_references(arch):
    shapes = jax.eval_shape(build_model(get_config(arch)).init,
                            jax.random.PRNGKey(0))
    leaves, _ = jax.tree_util.tree_flatten_with_path(shapes)
    for name, m in MESHES.items():
        got = _specs_by_path(sharding.param_shardings(shapes, m))
        assert len(got) == len(leaves), name
        for path, leaf in leaves:
            axes = jsharding.logical_axes_for_param(path, len(leaf.shape))
            want = jsharding._checked_spec(m, leaf.shape,
                                           jsharding._resolve(m, axes))
            key = tuple(jsharding._path_parts(path))
            assert sharding.logical_axes_for_param(key, len(leaf.shape)) \
                == axes, (name, key)
            assert tuple(got[key]) == tuple(want), (name, key)
    none = _specs_by_path(sharding.param_shardings(shapes))
    assert set(none.values()) == {None}


def test_logical_is_the_identity_but_under_a_model_mesh():
    x = object()
    assert sharding.current_mesh() is None
    assert sharding.logical(x, "batch", "seq") is x
    try:
        sharding.activate_mesh(MESHES["fleet8"])
        assert sharding.current_mesh() is MESHES["fleet8"]
        assert sharding.logical(x, "batch") is x
        assert sharding.shard_moe_dispatch(x) is x
        for name in ("data16x16", "pod2x16x16"):
            sharding.activate_mesh(MESHES[name])
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                sharding.logical(x, "batch")
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                sharding.shard_moe_dispatch(x)
    finally:
        sharding.activate_mesh(None)


def test_rules_equal_the_references():
    assert sharding.RULES == jsharding.RULES
