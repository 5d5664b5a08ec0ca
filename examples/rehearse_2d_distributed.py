"""Cross-process 2-D (streams x rows) rehearsal worker.

The two-process rehearsal (tests/test_distributed_rehearsal.py) proved the
fleet psum crosses OS processes, but the compute there was still local:
each process ran its own engine over its own devices, and only a 1-D
metric reduction touched the global mesh. This worker runs the 2-D
spatially-sharded program (parallel/spatial.py::blur_sobel_mag_spatial_2d)
over the GLOBAL mesh of a multi-process fleet, with the device grid
deliberately TRANSPOSED so that every row-band neighbor lives in a
DIFFERENT process: each of the program's ppermute halo exchanges must
cross a process boundary or the result cannot be bit-exact (the 3 edge
rows of every band depend on neighbor-process pixels through the
Gaussian5+Sobel stencil chain).

Launched by tests/test_distributed_rehearsal.py as N processes x 4 virtual
CPU devices (default rehearsal: 4 x 4 = a 16-device virtual fleet). On GPU
hosts the same script runs minus --platform; processes that share a host
take disjoint cards with --local-device-ids.

Scale-out seam rehearsed: SURVEY.md SS2.7 (cross-device DP+SP row).
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--width", type=int, default=96)
    p.add_argument("--platform", default=None)
    p.add_argument("--local-device-ids", default=None,
                   help="comma-separated GPU ids this process owns")
    args = p.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    jax.distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        local_device_ids=(None if args.local_device_ids is None else
                          [int(i) for i in args.local_device_ids.split(",")]),
    )

    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from rustcv_tpu.ops import golden
    from rustcv_tpu.parallel import blur_sobel_mag_spatial_2d

    devs = np.asarray(jax.devices())
    n_local = len(jax.local_devices())
    n_proc = args.num_processes
    # jax.devices() is process-major; TRANSPOSE so the rows axis strides
    # across processes: mesh[s, r] lives on process r. Every halo edge
    # (r <-> r+1) is then a cross-process ppermute.
    grid = devs.reshape(n_proc, n_local).T
    n_streams, n_rows = grid.shape
    mesh = Mesh(grid, ("stream", "rows"))

    # Deterministic global input, identical in every process.
    rng = np.random.default_rng(20260820)
    g_full = rng.integers(
        0, 256, (n_streams, args.height, args.width), np.uint8)
    assert args.height % n_rows == 0

    sharding = NamedSharding(mesh, P("stream", "rows", None))
    g_arr = jax.make_array_from_callback(
        g_full.shape, sharding, lambda idx: g_full[idx])

    out = blur_sobel_mag_spatial_2d(g_arr, mesh)
    jax.block_until_ready(out)

    # Golden oracle on the host (exact integer chain), then compare the
    # shards THIS process can address. Bit-exactness of a band's edge rows
    # proves its halo arrived from the neighbor process.
    want = np.stack([
        golden.gradient_magnitude_u8(
            *golden.sobel3_gray(golden.gaussian5_u8(x)))
        for x in g_full
    ])
    n_checked = 0
    cross_edges = 0
    band = args.height // n_rows
    for sh in out.addressable_shards:
        got = np.asarray(sh.data)
        sl = sh.index
        if not np.array_equal(got, want[sl]):
            raise SystemExit(
                f"process {args.process_id}: shard {sl} mismatch "
                f"(max |d| = "
                f"{int(np.abs(got.astype(int) - want[sl].astype(int)).max())})")
        n_checked += 1
        # count halo edges this shard consumed from OTHER processes
        r0 = sl[1].start or 0
        r_idx = r0 // band
        cross_edges += (r_idx > 0) + (r_idx < n_rows - 1)

    print(json.dumps({
        "process": args.process_id,
        "processes": n_proc,
        "chips": int(devs.size),
        "mesh": [int(n_streams), int(n_rows)],
        "bit_exact": True,
        "shards_checked": n_checked,
        "cross_process_halo_edges": cross_edges,
    }))


if __name__ == "__main__":
    main()
