"""Production and host device meshes.

Counterpart of ``repro.launch.mesh``.  Defined as functions (never
module-level constants) so importing this module touches no process
group.  A ``DeviceMesh`` needs a default process group, and which one
backs it is the caller's choice: a real NCCL group over the cards, a gloo
group over CPU ranks (tests), or the dry run's fake group of 256 or 512
ranks (``launch.dryrun``), all opened with
``torch.distributed.init_process_group`` before the mesh is built.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 (data, model) single pod; 2x16x16 (pod, data, model) for two
    pods (512 devices).  The default process group must have that many
    ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device: str = "cuda") -> DeviceMesh:
    """Whatever this host offers: (1, n) (data, model) over the visible
    cards, or over the CPU ranks of the default process group when
    ``device="cpu"``."""
    if device == "cuda":
        n = torch.cuda.device_count()
    else:
        n = torch.distributed.get_world_size()
    return init_device_mesh(device, (1, n), mesh_dim_names=("data", "model"))
