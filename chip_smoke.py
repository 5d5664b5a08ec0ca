"""Smoke test of the capture engine on NVIDIA GPUs.

Drives the engine's own entry points (``MultiStreamEngine`` and
``models.zoo.get_model(...).engine()``) at the shapes deployments run,
checks every output against the frozen NumPy spec (``rustcv_tpu/ops/
golden.py``), times the headline tick on both ingest paths, and runs the
card-only tests (``pytest -m gpu``) in this process. Any failed phase
exits non-zero. Only when every phase passed does the last line of stdout
carry the result: one JSON object naming the device.

    python chip_smoke.py               # one GPU
    python chip_smoke.py --four-cards  # stream and row sharding over 4 GPUs

There is no CPU fallback: without a GPU the script exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

W1080, H1080 = 1920, 1080
RECT_THICKNESS = 2


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def phase_device(n_cards: int):
    """Phase 1: a GPU backend with enough cards; card name and power limit."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX platform is {backend!r}")
    devs = jax.devices()
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} GPUs, found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    for line in smi.splitlines():
        log(line)
    log(f"device_kind: {devs[0].device_kind}  count: {len(devs)}")
    return devs


# -- reference outputs ---------------------------------------------------


def stream_overlays(n: int, w: int, h: int):
    """One distinct rectangle and colour per stream (some clipped)."""
    i = np.arange(n)
    rects = np.stack(
        [(37 * i) % (w // 2) - 20, (53 * i) % (h // 2), w // 4 + 11 * i, h // 5 + 7 * i],
        axis=1,
    ).astype(np.int32)
    colors = np.stack([(40 * i) % 256, 255 - (30 * i) % 256, (90 * i) % 256], axis=1)
    return rects, colors.astype(np.uint8)


def golden_frame(raw, w, h, rect, color, resize_to=None):
    """(bgr after resize and overlay, blur+Sobel |∇| of the pre-overlay luma)."""
    from rustcv_tpu.ops import golden

    bgr = golden.yuyv_to_bgr(raw, w, h)
    if resize_to is not None:
        bgr = golden.resize_bilinear(bgr, *resize_to)
    gx, gy = golden.sobel3_gray(golden.gaussian5_u8(golden.bgr_to_gray(bgr)))
    filtered = golden.gradient_magnitude_u8(gx, gy)
    if rect is not None:
        bgr = np.ascontiguousarray(bgr)
        hh, ww = bgr.shape[:2]
        golden.rectangle(bgr, hh, ww, ww * 3, tuple(int(v) for v in rect),
                         tuple(int(v) for v in color), RECT_THICKNESS)
    return bgr, filtered


def check_tick(label, res, w, h, *, pool=0, streams=None, rects=None,
               colors=None, filtered=True, resize_to=None):
    """Bit-exact check of one tick's bgr (and filtered) outputs per stream."""
    from rustcv_tpu.capture.simulation import synth_raw
    from rustcv_tpu.core import PixelFormat

    n = len(res.sequences)
    streams = range(n) if streams is None else streams
    bgr_dev = res.outputs["bgr"]
    filt_dev = res.outputs.get("filtered")
    cache = {}
    for i in streams:
        seq = int(res.sequences[i])
        check(seq >= 0, f"{label}: stream {i} reported a capture fault")
        frame = seq % pool if pool else seq
        rect = None if rects is None else tuple(rects[i])
        key = (frame, rect, None if colors is None else tuple(colors[i]))
        if key not in cache:
            raw = synth_raw(w, h, PixelFormat.YUYV, frame)
            cache[key] = golden_frame(
                raw, w, h, rect, None if colors is None else colors[i], resize_to)
        want_bgr, want_filt = cache[key]
        got_bgr = np.asarray(bgr_dev[i]).reshape(want_bgr.shape)
        check(np.array_equal(got_bgr, want_bgr),
              f"{label}: stream {i} bgr differs from golden in "
              f"{int((got_bgr != want_bgr).sum())} bytes")
        if filtered:
            got = np.asarray(filt_dev[i])
            check(np.array_equal(got, want_filt),
                  f"{label}: stream {i} filtered differs from golden in "
                  f"{int((got != want_filt).sum())} pixels")
    log(f"{label}: bit-exact with golden on {len(streams)} stream(s)")


def timed_ticks(eng, n_ticks, rects=None, colors=None, warm=3):
    """Seconds per tick over ``n_ticks`` dispatched back to back."""
    import jax

    for _ in range(warm):
        jax.block_until_ready(eng.tick(rects=rects, rect_colors=colors).outputs)
    t0 = time.perf_counter()
    for _ in range(n_ticks):
        res = eng.tick(rects=rects, rect_colors=colors)
    jax.block_until_ready(res.outputs)
    return (time.perf_counter() - t0) / n_ticks


def headline_engine(n_streams=8, *, device_sim=True, mesh=None):
    """bench.py's shape: N×1080p YUYV, blur_sobel + overlay, frame pool of 8."""
    from rustcv_tpu.capture import SimulationDriver
    from rustcv_tpu.core import PixelFormat, SimpleConfig
    from rustcv_tpu.runtime import MultiStreamEngine

    return MultiStreamEngine(
        SimulationDriver(device_count=n_streams, paced=False, n_unique_frames=8),
        n_streams,
        SimpleConfig(width=W1080, height=H1080, fps=60, pixel_format=PixelFormat.YUYV),
        filter="blur_sobel", overlay=True, device_sim=device_sim, mesh=mesh,
    )


# -- phases ---------------------------------------------------------------


def phase_headline(device_sim: bool, n_ticks: int = 100):
    """Phases 2 and 3: headline tick, device-resident or host-staged source."""
    label = "headline_device_sim" if device_sim else "headline_host_staged"
    eng = headline_engine(device_sim=device_sim)
    try:
        w, h = eng.resolved_config.width, eng.resolved_config.height
        rects, colors = stream_overlays(eng.n, w, h)
        dt = timed_ticks(eng, n_ticks, rects, colors)
        log(f"{label}: {dt * 1e3:.4f} ms/tick  {eng.n / dt:.2f} frames/s "
            f"({eng.n}x{w}x{h} YUYV, blur_sobel+overlay, {n_ticks} ticks)")
        check_tick(label, eng.tick(rects=rects, rect_colors=colors), w, h,
                   pool=8, rects=rects, colors=colors)
    finally:
        eng.close()


def phase_zoo():
    """Phase 4: zoo cells 1, 3, 4, 5 and 6 through ``get_model().engine()``."""
    from rustcv_tpu import native
    from rustcv_tpu.capture.simulation import synth_raw
    from rustcv_tpu.core import PixelFormat
    from rustcv_tpu.models.zoo import get_model
    from rustcv_tpu.ops import golden
    from rustcv_tpu.ops.jpeg_encode import encode_coeffs_numpy

    for name in ("config1_convert_overlay", "config3_blur_sobel_4k",
                 "config4_harris_1080p", "config5_end_to_end_4k",
                 "config6_transcode"):
        model = get_model(name)
        w, h, n = model.width, model.height, model.n_streams
        eng = model.engine()
        try:
            rects = colors = None
            if model.overlay:
                rects, colors = stream_overlays(n, w, h)
                if model.resize_to is not None:
                    rects, colors = stream_overlays(n, *model.resize_to)
            dt = timed_ticks(eng, 5, rects, colors, warm=2)
            log(f"{name}: {dt * 1e3:.4f} ms/tick over 5 ticks ({n}x{w}x{h})")
            res = eng.tick(rects=rects, rect_colors=colors)
            if model.filter == "harris":
                seq = int(res.sequences[0])
                gray = golden.bgr_to_gray(
                    golden.yuyv_to_bgr(synth_raw(w, h, PixelFormat.YUYV, seq), w, h))
                want = golden.harris_corners(gray)
                got = np.asarray(res.outputs["filtered"][0])
                check(np.array_equal(got, want),
                      f"{name}: corner mask differs in {int((got != want).sum())} px")
                check_tick(name, res, w, h, filtered=False)
                log(f"{name}: corner mask bit-exact ({int(want.sum())} corners)")
                continue
            check_tick(name, res, w, h, rects=rects, colors=colors,
                       filtered=model.filter == "blur_sobel",
                       resize_to=model.resize_to)
            if model.encode_jpeg_quality:
                check_encode(name, eng, res, model, encode_coeffs_numpy, native)
        finally:
            eng.close()


# Quantised coefficients may differ by one where the float transform lands
# on a .5 rounding boundary in a different order of operations; the same
# bound as the CPU tests (tests/test_jpeg_encode.py).
COEFF_MAX_DIFF = 1
COEFF_MAX_FRACTION = 5e-3


def check_encode(name, eng, res, model, encode_coeffs_numpy, native):
    """Config 6: device DCT coefficients vs the float64 NumPy encoder, and
    the JFIF payloads of the native coder."""
    check(native.available(), f"{name}: native coder did not build: {native.build_error()}")
    q = model.encode_jpeg_quality
    bgr = res.numpy("bgr")
    worst, frac = 0, 0.0
    for i in range(eng.n):
        want, _, _ = encode_coeffs_numpy(bgr[i], q, "4:2:0")
        for key, c in (("enc_y", 0), ("enc_cb", 1), ("enc_cr", 2)):
            got = np.asarray(res.outputs[key][i]).astype(np.int32)
            diff = np.abs(got - want[c].reshape(-1, 64).astype(np.int32))
            worst = max(worst, int(diff.max()))
            frac = max(frac, float((diff > 0).mean()))
    log(f"{name}: coefficients vs float64 encoder: max |diff| {worst}, "
        f"worst share of differing coefficients {frac:.6f}")
    check(worst <= COEFF_MAX_DIFF and frac <= COEFF_MAX_FRACTION,
          f"{name}: coefficients outside tolerance")
    payloads = eng.encode_payloads(res)
    check(len(payloads) == eng.n, f"{name}: {len(payloads)} payloads for {eng.n} streams")
    for i, p in enumerate(payloads):
        check(p[:2] == b"\xff\xd8" and p[-2:] == b"\xff\xd9",
              f"{name}: stream {i} payload is not a complete JFIF stream")
    log(f"{name}: {eng.n} JFIF payloads, {sum(map(len, payloads))} bytes")


def phase_card_tests():
    """Phase 5: the card-only tests, in this process (one process per card).
    Only the test files that hold ``gpu`` tests are collected."""
    import glob

    import pytest

    files = sorted(
        p for p in glob.glob(os.path.join(ROOT, "tests", "test_*.py"))
        if "mark.gpu" in open(p, encoding="utf-8").read()
    )
    check(bool(files), "no card-only tests found")
    os.environ["RUSTCV_TEST_DEVICE"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", *files])
    check(rc == 0, f"card-only tests failed (pytest exit code {int(rc)})")


def phase_four_cards(devs):
    """Stream sharding, an all-reduce and row sharding over four cards, each
    compared with one card or with golden."""
    import jax

    from rustcv_tpu.ops import golden
    from rustcv_tpu.parallel import (
        blur_sobel_mag_spatial, corner_counts_psum, shard_batch, stream_mesh,
    )

    mesh = stream_mesh(devs[:4])
    n = 32
    sharded = headline_engine(n, mesh=mesh)
    single = headline_engine(n)
    w, h = single.resolved_config.width, single.resolved_config.height
    rects, colors = stream_overlays(n, w, h)
    try:
        for eng, label in ((sharded, "4 cards"), (single, "1 card")):
            dt = timed_ticks(eng, 20, rects, colors)
            log(f"four_cards {label}: {dt * 1e3:.4f} ms/tick  {n / dt:.2f} frames/s "
                f"({n}x{w}x{h} YUYV, blur_sobel+overlay)")
        a = sharded.tick(rects=rects, rect_colors=colors)
        b = single.tick(rects=rects, rect_colors=colors)
        check(np.array_equal(a.sequences, b.sequences), "four_cards: tick clocks differ")
        for key in ("bgr", "filtered"):
            check(len(a.outputs[key].sharding.device_set) == 4,
                  f"four_cards: {key} spans {len(a.outputs[key].sharding.device_set)} devices")
            check(np.array_equal(np.asarray(a.outputs[key]), np.asarray(b.outputs[key])),
                  f"four_cards: sharded {key} differs from the one-card run")
        log(f"four_cards: {n} streams over 4 cards bit-exact with one card")
        check_tick("four_cards", a, w, h, pool=8, rects=rects, colors=colors,
                   streams=[0, n - 1])

        mask = np.asarray(a.outputs["filtered"]) > 64
        total = int(corner_counts_psum(shard_batch(mask, mesh), mesh))
        check(total == int(mask.sum()), f"four_cards: psum {total} != host {int(mask.sum())}")
        log(f"four_cards: all-reduce count {total} equals the host sum")
    finally:
        sharded.close()
        single.close()

    gray = np.random.default_rng(7).integers(0, 256, (1, 4320, 1920), dtype=np.uint8)
    out = blur_sobel_mag_spatial(jax.numpy.asarray(gray), mesh)
    check(len(out.sharding.device_set) == 4, "four_cards: spatial output not on 4 cards")
    want = golden.gradient_magnitude_u8(*golden.sobel3_gray(golden.gaussian5_u8(gray[0])))
    check(np.array_equal(np.asarray(out)[0], want),
          "four_cards: row-sharded blur+Sobel differs from golden")
    log("four_cards: 4320x1920 frame row-sharded over 4 cards bit-exact with golden")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharding path and its checks")
    args = ap.parse_args(argv)

    from rustcv_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax

    devs = phase_device(4 if args.four_cards else 1)
    t0 = time.perf_counter()
    try:
        if args.four_cards:
            phase_four_cards(devs)
        else:
            phase_headline(device_sim=True)
            phase_headline(device_sim=False)
            phase_zoo()
            phase_card_tests()
    except PhaseError as e:
        log(f"FAILED: {e}")
        return 1
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
