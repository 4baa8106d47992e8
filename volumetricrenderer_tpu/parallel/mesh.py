"""Device-mesh construction — the distributed layer the reference lacks
(it is single-process/single-GPU; its closest analogue is the three Vulkan
queues, VulkanDevice.h:24-26). Scaling here rides jax.sharding over a Mesh:
rays/pixels shard over the "data" axis (DP), the density volume shards
spatially over the "slab" axis (the TP-analogue — the voxels are the
"weights" of this framework), per SURVEY.md section 5.9.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "ray_sharding", "grid_sharding", "replicated"]

DATA_AXIS = "data"
SLAB_AXIS = "slab"


def make_mesh(data: Optional[int] = None, slab: int = 1,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Create a (data, slab) mesh. Defaults to all devices on the data axis.

    The mesh is a plain reshape of the device list: on a host whose
    cards are joined all to all (NVLink) every pairing costs the same,
    so the axis sizes follow the algorithm alone. Across hosts, pass
    jax.devices() after jax.distributed.initialize() and keep "slab"
    within a host, where the slab composite's ppermute exchanges run on
    the fastest links; ray work over "data" is embarrassingly parallel
    and tolerates the slower network between hosts."""
    devs = list(devices) if devices is not None else jax.devices()
    if data is None:
        data = len(devs) // slab
    if data * slab != len(devs):
        raise ValueError(f"mesh {data}x{slab} != {len(devs)} devices")
    arr = np.asarray(devs).reshape(data, slab)
    return Mesh(arr, (DATA_AXIS, SLAB_AXIS))


def ray_sharding(mesh: Mesh) -> NamedSharding:
    """Shard image rows (leading axis) over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def grid_sharding(mesh: Mesh, spatial: bool = False) -> NamedSharding:
    """Volume sharding: replicated by default (small grids, the common
    case, like the reference's 8 MiB 128^3 texture); spatial=True shards
    the leading (z) axis over the slab axis (512^3 multi-host, config 5)."""
    if spatial:
        return NamedSharding(mesh, P(SLAB_AXIS))
    return NamedSharding(mesh, P())


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
