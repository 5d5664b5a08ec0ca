"""Spatial parallelism demo — one tall frame split across the device mesh.

The stream axis is the usual scale-out axis (one camera group per device,
see ``multi_stream_pipeline.py``); this demo shows the OTHER axis: a single
frame too tall for one device's comfort (panorama stitch, line-scan capture)
has its rows sharded across the mesh, and the fused Gaussian+Sobel stencil
exchanges 3-row halos with neighbor devices (``lax.ppermute``) — bit-exact
with the single-device result.

Runs anywhere: by default on a virtual 8-device CPU mesh;
``RUSTCV_SPATIAL_REAL=1`` uses the machine's devices (e.g. four GPUs,
whose halos then cross NVLink).
"""

from __future__ import annotations

import os

if __name__ == "__main__" and os.environ.get("RUSTCV_SPATIAL_REAL") != "1":
    # Default: virtual 8-device CPU mesh (set BEFORE any jax import; one
    # device makes a boring demo). RUSTCV_SPATIAL_REAL=1 uses the
    # machine's devices instead.
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax

    if os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
        jax.config.update("jax_platforms", "cpu")

    from rustcv_tpu.capture import synth_raw
    from rustcv_tpu.core import PixelFormat
    from rustcv_tpu.ops import golden
    from rustcv_tpu.parallel import blur_sobel_mag_spatial, stream_mesh

    mesh = stream_mesh(axis="rows")
    n_dev = mesh.devices.size
    w, h = 1024, 128 * n_dev  # one tall stitched frame
    print(f"mesh: {n_dev} devices; frame: {w}x{h} ({h // n_dev} rows/chip)")

    bgr = golden.yuyv_to_bgr(synth_raw(w, h, PixelFormat.YUYV, 7), w, h)
    gray = golden.bgr_to_gray(bgr)

    out = blur_sobel_mag_spatial(jax.numpy.asarray(gray[None]), mesh)
    print(
        f"output: {out.shape}, sharded over {len(out.sharding.device_set)} devices"
    )

    want = golden.gradient_magnitude_u8(*golden.sobel3_gray(golden.gaussian5_u8(gray)))
    exact = np.array_equal(np.asarray(out)[0], want)
    print(f"bit-exact vs single-device golden chain: {exact}")
    assert exact


if __name__ == "__main__":
    main()
