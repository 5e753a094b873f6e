"""The production and smoke meshes (the JAX package's
``repro/launch/mesh.py``) as functions that make a ``DeviceMesh``.

Functions, so that importing this module touches no process group.  Each
mesh's shape and axis names are data (``PRODUCTION``, ``SMOKE``, keyed by
``multi_pod``); ``chip_smoke.py`` reads the production shapes from here
for its sharding tables, which it computes from meta tensors, since 256
and 512 ranks exist nowhere the port runs.  Each mesh goes through
``runtime.mesh_utils.make_mesh``, which raises unless the caller's process
group holds that many ranks: each of 8 ranks started by
``launch.ranks.run`` calls ``make_smoke_mesh(device="cpu")`` to build the
smoke mesh on the CPU.
"""
from __future__ import annotations

from repro_torch.runtime import mesh_utils

POD_AXES = ("pod", "data", "model")
PRODUCTION = {False: ((16, 16), POD_AXES[1:]), True: ((2, 16, 16), POD_AXES)}
SMOKE = {False: ((2, 4), POD_AXES[1:]), True: ((2, 2, 4), POD_AXES)}


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """(data 16, model 16), or (pod 2, data 16, model 16)."""
    return mesh_utils.make_mesh(*PRODUCTION[multi_pod], device=device)


def make_smoke_mesh(*, multi_pod: bool = False, device="cuda"):
    """The reduced mesh: (data 2, model 4), or (pod 2, data 2, model 4)."""
    return mesh_utils.make_mesh(*SMOKE[multi_pod], device=device)
