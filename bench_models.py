"""Run all five BASELINE configs (the models zoo) and print a results table.

``bench.py`` is the driver-facing headline (one JSON line); this script is
the full coverage sweep. Sizes can be scaled down with --scale for smoke
runs on CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from rustcv_tpu.models import MODELS


def run_model(name: str, ticks: int, scale: int):
    from rustcv_tpu.capture import SimulationDriver
    from rustcv_tpu.core import PixelFormat, SimpleConfig
    from rustcv_tpu.runtime import MultiStreamEngine

    m = MODELS[name]
    w, h = max(64, m.width // scale), max(48, m.height // scale)
    w -= w % 4
    h -= h % 2
    n = m.n_streams
    # MJPEG sources synthesize + JPEG-encode on the host; cache a frame pool
    # so the measured cost is the decode pipeline, not pattern synthesis
    # (a real camera "synthesizes" at zero host cost).
    uniq = 8 if m.pixel_format == PixelFormat.MJPEG else 0
    driver = SimulationDriver(device_count=n, paced=False, n_unique_frames=uniq)
    resize_to = None
    if m.resize_to:
        resize_to = (max(16, m.resize_to[0] // scale), max(12, m.resize_to[1] // scale))
    kwargs = {}
    if m.pixel_format == PixelFormat.MJPEG:
        # Same backend policy as the zoo: block-packed hybrid when the
        # native entropy coder is available.
        from rustcv_tpu.models.zoo import default_mjpeg_backend

        kwargs["mjpeg_backend"] = default_mjpeg_backend()
    eng = MultiStreamEngine(
        driver, n,
        SimpleConfig(width=w, height=h, fps=m.fps, pixel_format=m.pixel_format),
        filter=m.filter, resize_to=resize_to, overlay=m.overlay,
        device_sim=(m.pixel_format != PixelFormat.MJPEG),
        encode_jpeg_quality=m.encode_jpeg_quality,
        **kwargs,
    )
    rects = np.tile(np.array([[w // 8, h // 8, w // 3, h // 3]], np.int32), (n, 1))
    colors = np.tile(np.array([[0, 255, 0]], np.uint8), (n, 1))
    stats = eng.run(ticks, warmup=min(3, ticks), measure_latency=False,
                    rects=rects, rect_colors=colors)
    row = {
        "model": name,
        "streams": n,
        "resolution": f"{w}x{h}",
        "fps_total": round(stats.fps_total, 1),
        "fps_per_stream": round(stats.fps_per_stream, 1),
        "ms_per_tick": round(stats.wall_s / max(1, stats.ticks) * 1e3, 3),
    }
    if n == 1 and m.pixel_format != PixelFormat.MJPEG:
        # Single-stream programs can be dispatch-bound: the in-program
        # lax.scan chain amortizes dispatch over 32 ticks and reports the
        # device's own rate beside the unchained one.
        cst = eng.run_chained(max(ticks * 8, 512), chain=32, warmup=1,
                              rects=rects, rect_colors=colors)
        row["fps_chained"] = round(cst.fps_total, 1)
        row["ms_per_tick_chained"] = round(cst.wall_s / max(1, cst.ticks) * 1e3, 3)
    eng.close()
    return row


def main(ticks: int, scale: int, models=None) -> None:
    rows = []
    for name in models or MODELS:
        try:
            rows.append(run_model(name, ticks, scale))
        except Exception as e:  # noqa: BLE001 — report and continue
            rows.append({"model": name, "error": f"{type(e).__name__}: {str(e)[:120]}"})
    for r in rows:
        print(json.dumps(r))


if __name__ == "__main__":
    from rustcv_tpu.utils import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--ticks", type=int, default=30)
    p.add_argument("--scale", type=int, default=1, help="divide resolutions by N")
    p.add_argument("--models", nargs="*", default=None)
    a = p.parse_args()
    main(a.ticks, a.scale, a.models)
