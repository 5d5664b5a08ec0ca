"""Device-mesh helpers — shard the stream batch across devices.

The reference is single-process with no distributed layer (SURVEY.md §2.7);
scaling out is dual-camera examples run by hand. Here the stream/batch axis
is the data-parallel axis. A 1-D mesh over all devices with inputs sharded
``P('stream')`` makes every pipeline stage embarrassingly parallel (no
collectives — stencils never cross stream boundaries), so XLA executes the
same fused program per device over its shard; the interconnect is only
touched if a reduction over streams is requested (e.g. fleet-wide corner
counts via ``psum``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def stream_mesh(devices: Optional[Sequence] = None, axis: str = "stream") -> Mesh:
    """A 1-D mesh over ``devices`` (default: all) named for the stream axis."""
    devs = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devs, (axis,))


def grid_mesh(
    n_streams: int,
    n_rows: int,
    devices: Optional[Sequence] = None,
    axes: Sequence[str] = ("stream", "rows"),
) -> Mesh:
    """A 2-D (streams × rows) mesh: the outer axis data-parallels stream
    groups, the inner axis shards each frame's rows (spatial parallelism
    with ppermute halos — parallel/spatial.py). The inner axis varies
    fastest over the device list. Every GPU of a host reaches every other
    over NVLink at the same rate, so the shape follows the algorithm
    alone."""
    devs = np.asarray(devices if devices is not None else jax.devices())
    if devs.size != n_streams * n_rows:
        raise ValueError(
            f"grid_mesh: {n_streams}x{n_rows} needs {n_streams * n_rows} "
            f"devices, got {devs.size}"
        )
    return Mesh(devs.reshape(n_streams, n_rows), tuple(axes))


def stream_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a [N, ...] batch over the mesh's first axis."""
    return NamedSharding(mesh, P(mesh.axis_names[0]))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(x, mesh: Mesh):
    """Place a host batch on the mesh, split along axis 0."""
    return jax.device_put(x, stream_sharding(mesh))


def corner_counts_psum(corner_mask, mesh: Mesh):
    """Example cross-device reduction: total corners across all streams.

    Runs under ``shard_map`` so the per-device partial sums reduce with a
    single ``psum`` (an all-reduce over NVLink on GPUs).
    """
    axis = mesh.axis_names[0]

    def local(m):
        return jax.lax.psum(m.sum().astype(jax.numpy.int32), axis)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=P(axis), out_specs=P(),
    )
    return fn(corner_mask)
