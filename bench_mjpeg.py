"""MJPEG budget benchmark — isolates each stage of BASELINE config 2
(8× 1080p MJPEG → BGR → bilinear resize to 640×480).

Measures whether the on-device half of the hybrid path (dequant +
IDCT-as-matmuls + fancy upsample + color + resize) can sustain >60
fps/stream, separately from the host half:

- ``device_ms_per_tick`` / ``device_fps_per_stream``: coefficients
  pre-staged in device memory, N dispatches then a wait on the last. Dense
  and packed input variants.
- ``h2d_*``: upload+reconstruct per tick for dense int16 grids vs packed
  nonzero (pos, val) pairs (~10× fewer bytes).
- ``host_entropy_ms_per_frame``: the C++ sequential half, per core.
- ``e2e_fps_per_stream``: the full hybrid engine on this host (bound by
  the host entropy decode — reported as such, not as the device ceiling).

The simulated MJPEG source encodes frames with PIL. Prints ONE JSON line.
"""

from __future__ import annotations

import json
import time
from dataclasses import replace

import numpy as np


def main() -> None:
    from rustcv_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax

    from rustcv_tpu import native
    from rustcv_tpu.capture.simulation import encode_mjpeg, synth_bgr
    from rustcv_tpu.core import PixelFormat
    from rustcv_tpu.runtime.pipeline import PipelineSpec, get_pipeline, make_dummy_overlay

    N, W, H = 8, 1920, 1080
    RW, RH = 640, 480
    jpgs = [bytes(encode_mjpeg(synth_bgr(W, H, s), quality=85)) for s in range(N)]

    # --- host entropy decode (sequential C++ half), per frame one core ----
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        for j in jpgs:
            native.jpeg_entropy_decode_packed(j, capacity=400_000)
    host_entropy_ms = (time.perf_counter() - t0) / (reps * N) * 1e3

    # --- build staged inputs ----------------------------------------------
    dense = [native.jpeg_entropy_decode(j) for j in jpgs]
    info = dense[0][0]
    qts = dense[0][2]
    coeffs = [
        np.stack([d[1][c] for d in dense]) for c in range(3)
    ]  # [N, bh, bw, 8, 8] i16
    geom = tuple((c.shape[1], c.shape[2]) for c in coeffs)
    total = sum(bh * bw * 64 for bh, bw in geom)
    packed = [
        native.jpeg_entropy_decode_packed(j, capacity=total // 3)
        or native.jpeg_entropy_decode_packed(j, capacity=total)
        for j in jpgs
    ]
    nnz = [p[3] for p in packed]

    # Block-packed (the production packed path): K slots/block + overflow,
    # sized exactly as the engine sizes it (shared policy).
    from rustcv_tpu.ops.jpeg_tpu import choose_block_packing

    nblocks = sum(bh * bw for bh, bw in geom)
    nnzb = np.concatenate(
        [(dense[0][1][c] != 0).sum(axis=(2, 3)).reshape(-1) for c in range(3)]
    )
    K, DCAP = choose_block_packing(nnzb)
    bp = [native.jpeg_entropy_decode_blockpacked(j, K, DCAP) for j in jpgs]
    idx = np.stack([b[1] for b in bp])
    bval = np.stack([b[2] for b in bp])
    dense_ids = np.stack([b[3] for b in bp])
    dense_rows = np.stack([b[4] for b in bp])
    dense_n = [b[5] for b in bp]

    spec_d = PipelineSpec(
        PixelFormat.MJPEG, W, H, resize_to=(RW, RH), mjpeg_hybrid=True,
    )
    spec_p = replace(spec_d, mjpeg_packed=True, coeff_geometry=geom)
    fn_d = get_pipeline(spec_d)
    fn_p = get_pipeline(spec_p)
    qty = jax.device_put(qts[0].astype(np.int32))
    qtc = jax.device_put(qts[1].astype(np.int32))
    dummy = make_dummy_overlay(N)

    x_d = tuple(jax.device_put(c) for c in coeffs) + (qty, qtc)
    x_p = tuple(jax.device_put(a) for a in (idx, bval, dense_ids, dense_rows)) + (qty, qtc)

    # Warm up both programs (compile) + sanity parity.
    out_d = jax.block_until_ready(fn_d(x_d, *dummy))
    out_p = jax.block_until_ready(fn_p(x_p, *dummy))
    parity = bool(np.array_equal(np.asarray(out_d["bgr"]), np.asarray(out_p["bgr"])))

    def device_ms(fn, x, iters=64):
        # programs execute in dispatch order, so waiting on the last one
        # bounds the whole burst.
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = fn(x, *dummy)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / iters * 1e3

    dev_d = device_ms(fn_d, x_d)
    dev_p = device_ms(fn_p, x_p)

    def upload_tick_ms(fn, arrays, tail, iters=8):
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            staged = tuple(jax.device_put(a) for a in arrays) + tail
            out = fn(staged, *dummy)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / iters * 1e3

    h2d_d = upload_tick_ms(fn_d, coeffs, (qty, qtc))
    h2d_p = upload_tick_ms(fn_p, (idx, bval, dense_ids, dense_rows), (qty, qtc))

    # End-to-end hybrid engine on this host (bound by host entropy decode).
    from rustcv_tpu.capture import SimulationDriver
    from rustcv_tpu.core import SimpleConfig
    from rustcv_tpu.runtime import MultiStreamEngine

    eng = MultiStreamEngine(
        SimulationDriver(device_count=N, paced=False, n_unique_frames=8), N,
        SimpleConfig(width=W, height=H, fps=30, pixel_format=PixelFormat.MJPEG),
        resize_to=(RW, RH), mjpeg_backend="hybrid",
    )
    st = eng.run(12, warmup=2, measure_latency=False)
    eng.close()

    print(json.dumps({
        "metric": "config2_mjpeg_budget",
        "resolution": f"{W}x{H}->{RW}x{RH}",
        "n_streams": N,
        "device_ms_per_tick_dense": round(dev_d, 3),
        "device_ms_per_tick_packed": round(dev_p, 3),
        "device_fps_per_stream_dense": round(1e3 / dev_d, 1) if dev_d else None,
        "device_fps_per_stream_packed": round(1e3 / dev_p, 1) if dev_p else None,
        "upload_plus_device_ms_dense": round(h2d_d, 3),
        "upload_plus_device_ms_packed": round(h2d_p, 3),
        "h2d_mb_dense": round(sum(c.nbytes for c in coeffs) / 1e6, 2),
        "h2d_mb_packed": round(
            (idx.nbytes + bval.nbytes + dense_ids.nbytes + dense_rows.nbytes) / 1e6, 2
        ),
        "packed_k": K,
        "dense_rows_mean": int(np.mean(dense_n)),
        "nnz_mean": int(np.mean(nnz)),
        "packed_matches_dense": parity,
        "host_entropy_ms_per_frame": round(host_entropy_ms, 2),
        "e2e_fps_per_stream": round(st.fps_per_stream, 2),
        "backend": jax.default_backend(),
        "device_kind": jax.devices()[0].device_kind,
        "device_count": len(jax.devices()),
    }))


if __name__ == "__main__":
    main()
