"""Dual-camera view — port of ``rustcv-backend-v4l2/examples/dual_camera_view.rs``.

Two ways to run two cameras:
1. ``--mode independent``: two VideoCapture facades, each with its own
   worker (the reference's architecture).
2. ``--mode batched`` (default): one MultiStreamEngine ticks both streams
   in a single fused device program — the accelerator-native shape.
"""

import argparse

import numpy as np

from rustcv_tpu import highgui
from rustcv_tpu.capture import SimulationDriver
from rustcv_tpu.core import Mat, PixelFormat, SimpleConfig
from rustcv_tpu.prelude import VideoCapture
from rustcv_tpu.runtime import MultiStreamEngine


def run_independent(frames: int) -> None:
    from rustcv_tpu.core import CameraConfig, PixelFormat as PF, Priority

    drv = SimulationDriver(paced=False)
    cfg = CameraConfig().resolution(640, 480, Priority.REQUIRED).format(PF.YUYV, Priority.REQUIRED)
    cap0, cap1 = VideoCapture(0, drv, cfg), VideoCapture(1, drv, CameraConfig().resolution(640, 480, Priority.REQUIRED).format(PF.YUYV, Priority.REQUIRED))
    m0, m1 = Mat(), Mat()
    for _ in range(frames):
        ok0, ok1 = cap0.read(m0), cap1.read(m1)
        if not (ok0 and ok1):
            break
        highgui.imshow("cam0", m0)
        highgui.imshow("cam1", m1)
        if highgui.wait_key(1) == highgui.KEY_ESC:
            break
    cap0.release()
    cap1.release()
    print(f"independent mode: {m0.cols}x{m0.rows} + {m1.cols}x{m1.rows}")


def run_batched(frames: int) -> None:
    eng = MultiStreamEngine(
        SimulationDriver(device_count=2, paced=False), 2,
        SimpleConfig(width=640, height=480, pixel_format=PixelFormat.YUYV),
        device_sim=True,
    )
    res = None
    for _ in range(frames):
        res = eng.tick(block=True)
    bgr = res.numpy("bgr")
    for i in range(2):
        highgui.imshow(f"cam{i}", Mat.from_array(bgr[i]))
    eng.close()
    print(f"batched mode: 2x {bgr.shape[2]}x{bgr.shape[1]}, seqs {list(res.sequences)}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--mode", choices=["batched", "independent"], default="batched")
    a = p.parse_args()
    (run_batched if a.mode == "batched" else run_independent)(a.frames)
