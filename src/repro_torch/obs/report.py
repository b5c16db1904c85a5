"""Run manifests: provenance stamped onto train results — the port of
``repro/obs/report.py``.

A manifest answers "what produced this number?" — git SHA (+dirty
flag), the torch and CUDA versions, backend and device count, mesh
shape, a stable hash of the config, and wall-clock context. It is
attached to ``FleetTrainResult``. The shared :func:`flatten` /
:func:`rel_diff` helpers read nested run JSONs under one dotted path.

Everything here is fault-tolerant: a missing git binary or a non-repo
checkout yields ``None`` fields, never an exception — provenance must
not take down a run. ``torch`` is imported lazily (only
``run_manifest`` needs it) so the standard-library helpers stay cheap
to import.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import numbers
import os
import platform
import subprocess
import sys
from datetime import datetime, timezone
from typing import Any, Optional

MANIFEST_SCHEMA = "repro.obs/manifest-v1"


def flatten(obj: Any, prefix: str = "") -> dict:
    """Flat dict of dotted-path -> scalar, skipping the manifest."""
    out = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            if k == "manifest":
                continue
            out.update(flatten(v, f"{prefix}{k}."))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            out.update(flatten(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = obj
    return out


def is_number(v: Any) -> bool:
    """True for real numerics that compare as metrics (bools excluded —
    a flipped flag is a structural change, not a relative move)."""
    return isinstance(v, numbers.Real) and not isinstance(v, bool)


def rel_diff(a: float, b: float) -> float:
    """Signed relative move from ``a`` to ``b``; a zero base falls back
    to an absolute difference (base 1.0) so dividing never explodes."""
    base = abs(a) if a else 1.0
    return (b - a) / base


_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))


def config_hash(config: Any) -> str:
    """Stable short hash of a config (dataclass, dict, or anything with
    a deterministic repr via ``default=str``)."""
    if dataclasses.is_dataclass(config) and not isinstance(config, type):
        config = dataclasses.asdict(config)
    blob = json.dumps(config, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _git(*args: str) -> Optional[str]:
    try:
        out = subprocess.run(
            ("git", "-C", _REPO_ROOT) + args,
            capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def git_info() -> dict:
    sha = _git("rev-parse", "HEAD")
    status = _git("status", "--porcelain")
    return {
        "sha": sha,
        "branch": _git("rev-parse", "--abbrev-ref", "HEAD"),
        "dirty": bool(status) if status is not None else None,
    }


def run_manifest(config: Any = None, mesh=None, **extra) -> dict:
    """The provenance stamp. ``mesh`` (a ``fleet.shard.FleetMesh``) is
    recorded by its axis sizes, ``{"fleet": ranks}``, and as None when
    not given; ``extra`` keys (e.g.
    ``wall_seconds=...``) merge in last. ``backend`` is PyTorch's
    default device kind here: ``"cuda"`` when a card is visible, else
    ``"cpu"``."""
    import torch
    cuda = torch.cuda.is_available()
    n = torch.cuda.device_count() if cuda else 1
    kinds = ({torch.cuda.get_device_name(i) for i in range(n)} if cuda
             else {"cpu"})
    m = {
        "schema": MANIFEST_SCHEMA,
        "created_utc": datetime.now(timezone.utc).isoformat(
            timespec="seconds"),
        "git": git_info(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_count": n,
        "device_kinds": sorted(kinds),
        "mesh_shape": ({str(k): int(v) for k, v in dict(mesh.shape).items()}
                       if mesh is not None else None),
        "config_hash": config_hash(config) if config is not None else None,
        "python": platform.python_version(),
        "platform": platform.platform(),
        "argv": list(sys.argv),
    }
    m.update(extra)
    return m


def attach_manifest(payload: dict, config: Any = None, mesh=None,
                    **extra) -> dict:
    """Return a copy of ``payload`` with a ``manifest`` key added; the
    input dict is not mutated."""
    out = dict(payload)
    out["manifest"] = run_manifest(config=config, mesh=mesh, **extra)
    return out
