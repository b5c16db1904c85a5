"""The production meshes — the port of ``repro/launch/mesh.py``.

Functions, not module-level constants, so importing this module touches
no process group. A mesh is a ``torch.distributed`` ``DeviceMesh`` over
the process group in place, wrapped in ``Mesh``, the one place where
its tuple ``shape`` and ``mesh_dim_names`` become the dict ``shape``
and ``axis_names`` that the spec code (``distributed.sharding``) reads.

The dry run (``launch.dryrun``) needs 512 devices it does not have: as
the reference forces 512 placeholder host devices through ``XLA_FLAGS``,
it builds its meshes over a placeholder process group of 512 ranks
(``placeholder_group``, PyTorch's ``fake`` backend: this process is
rank 0 and no collective runs). With one rank on one card the tier
meshes collapse to one device, as the reference's do on the CPU.
"""
from __future__ import annotations

import contextlib
import sys

import torch

from repro_torch.obs.prof import PEAKS

#: ranks of the dry run's placeholder process group: two 16 x 16 pods
PLACEHOLDER_WORLD = 512


class Mesh:
    """A ``DeviceMesh`` as the spec code reads a mesh: ``shape`` (axis
    name -> size), ``axis_names``, ``size``; the mesh itself is
    ``device_mesh``."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.shape))
        self.size = device_mesh.size()


def _device_mesh(device_type: str, shape, axes):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    if dist.is_available() and dist.is_initialized():
        return init_device_mesh(device_type, shape, mesh_dim_names=axes)
    if any(n != 1 for n in shape):
        raise RuntimeError(f"a {shape} mesh needs a process group of at "
                           f"least {torch.Size(shape).numel()} ranks; none "
                           "is initialised (placeholder_group)")
    # one rank, no group: the single device, no backend to start
    return DeviceMesh(device_type, torch.zeros(shape, dtype=torch.int64),
                      mesh_dim_names=axes, _init_backend=False, _rank=0)


def _world() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> Mesh:
    """16 x 16 = 256 devices per pod over ``("data", "model")``;
    ``multi_pod`` adds a 2-pod axis, (2, 16, 16) over ``("pod", "data",
    "model")``. Needs a process group of at least that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(_device_mesh(device_type, shape, axes))


def make_tier_mesh(tier: str, *, device_type: str = "cuda") -> Mesh:
    """End-edge-cloud tiers as submesh sizes over ``("data", "model")``:
    the orchestrator's device ``S`` one device (1, 1), the edge ``E`` an
    8-device slice (1, min(8, n)), the cloud ``C`` every device (1, n),
    n the process group's ranks (1 without a group)."""
    n = _world()
    shapes = {"S": (1, 1), "E": (1, min(8, n)), "C": (1, n)}
    return Mesh(_device_mesh(device_type, shapes[tier], ("data", "model")))


@contextlib.contextmanager
def placeholder_group():
    """A placeholder process group of ``PLACEHOLDER_WORLD`` ranks, this
    process rank 0, for the life of the ``with`` block: PyTorch's ``fake`` backend,
    which starts nothing and answers every collective at once. Where a
    group is in place already it is used as it is."""
    import torch.distributed as dist
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    hook = sys.excepthook         # a group's start wraps it in a rank tag
    dist.init_process_group("fake", store=FakeStore(),
                            world_size=PLACEHOLDER_WORLD, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()
        sys.excepthook = hook


# NVIDIA H100 SXM constants for the roofline (per device), the data
# sheet's: dense bf16 on the tensor cores and HBM3, from obs.prof.PEAKS
PEAK_BF16_FLOPS = PEAKS["cuda"].flops_per_s       # FLOP/s
HBM_BW = PEAKS["cuda"].bytes_per_s                # B/s
# one NVLink 4 link: 25 GB/s each way (the H100 SXM data sheet's 900 GB/s
# over its 18 links, both directions)
NVLINK_BW_PER_LINK = 25e9                         # B/s
