"""Multi-host / multi-device launch — turnkey fleet script.

Architecture: camera streams are embarrassingly parallel, so the scaling
layout is stream-DP — each process runs the fused engine over its LOCAL
devices with the stream axis sharded across them; collectives are only
touched for fleet-wide metrics (a psum over the global mesh). No frame data
ever crosses hosts.

Run one process per host, each driving all of its GPUs:

    python examples/launch_distributed.py \
        --coordinator 10.0.0.2:8476 --num-processes 4 --process-id $ID \
        --streams-per-chip 8 --ticks 300

Several processes on ONE GPU host must not open the same cards: give each
its own with ``--local-device-ids`` (e.g. process 0 ``--local-device-ids
0,1``, process 1 ``--local-device-ids 2,3``).

Single-process smoke (no coordinator; also what CI exercises):

    python examples/launch_distributed.py --ticks 20

Sizing (streams per device at which aggregate throughput peaks) has not been
measured on the GPU yet; 8 per device is the default. The fleet psum costs
one i32 all-reduce per reporting interval. Numbers assume the
device-resident simulation source (device_sim=True, zero H2D steady state);
live-camera ingest is bounded by each host's capture hardware instead.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def _device_ids(spec):
    """``"0,1"`` → [0, 1]; None keeps JAX's default (every local device)."""
    return None if spec is None else [int(i) for i in spec.split(",")]


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", default=None,
                   help="coordinator address host:port (omit for single-process)")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--streams-per-chip", type=int, default=8)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--ticks", type=int, default=300)
    p.add_argument("--filter", default="blur_sobel")
    p.add_argument("--platform", default=None,
                   help="force a jax platform (e.g. 'cpu' for the virtual-"
                        "device rehearsal)")
    p.add_argument("--local-device-ids", default=None,
                   help="comma-separated GPU ids this process owns (several "
                        "processes on one host)")
    args = p.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    if args.num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
            local_device_ids=_device_ids(args.local_device_ids),
        )

    from rustcv_tpu.capture import SimulationDriver
    from rustcv_tpu.core import PixelFormat, SimpleConfig
    from rustcv_tpu.parallel import stream_mesh
    from rustcv_tpu.runtime import MultiStreamEngine

    local = jax.local_devices()
    n_streams = args.streams_per_chip * len(local)
    mesh = stream_mesh(local)

    eng = MultiStreamEngine(
        SimulationDriver(device_count=n_streams, paced=False), n_streams,
        SimpleConfig(width=args.width, height=args.height, fps=60,
                     pixel_format=PixelFormat.YUYV),
        filter=args.filter, overlay=True, device_sim=True, mesh=mesh,
    )
    rects = np.tile(np.array([[100, 100, 400, 300]], np.int32), (n_streams, 1))
    colors = np.tile(np.array([[0, 255, 0]], np.uint8), (n_streams, 1))

    stats = eng.run(args.ticks, warmup=5, measure_latency=False,
                    rects=rects, rect_colors=colors)
    local_fps = stats.fps_total

    # Fleet aggregate: one psum over the GLOBAL mesh (every process
    # contributes its local rate). In single-process mode this is a no-op
    # reduction over the local mesh.
    if args.num_processes > 1:
        gmesh = stream_mesh(jax.devices(), axis="fleet")
        from jax.sharding import NamedSharding, PartitionSpec as P

        x = jax.make_array_from_callback(
            (len(jax.devices()),),
            NamedSharding(gmesh, P("fleet")),
            lambda idx: np.full(
                (1,), local_fps / len(local), np.float32
            ),
        )
        total_fps = float(jax.jit(lambda v: v.sum())(x))
    else:
        total_fps = local_fps

    eng.close()
    if args.process_id == 0:
        print(
            {
                "processes": args.num_processes,
                "chips": len(jax.devices()),
                "streams": n_streams * args.num_processes,
                "resolution": f"{args.width}x{args.height}",
                "local_fps": round(local_fps, 1),
                "fleet_fps": round(total_fps, 1),
                "fps_per_stream": round(stats.fps_per_stream, 2),
            }
        )


if __name__ == "__main__":
    main()
