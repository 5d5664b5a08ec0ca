"""Video file I/O: record an MJPEG-AVI clip, then process it back through
the batched device engine.

The reference stops at live cameras; OpenCV users also expect
``VideoWriter`` and ``VideoCapture("clip.avi")``. Both halves reuse the device
JPEG codec: writing can route each frame through the device FDCT encoder
(``encoder="tpu"``); reading feeds the stored JPEG bytes into the standard
MJPEG paths — including the batched engine's hybrid decode (host entropy →
device IDCT) — exactly like a camera stream.
"""

import os
import tempfile

import numpy as np

from rustcv_tpu.capture import FileDriver, VideoCapture, VideoWriter
from rustcv_tpu.capture import simulation as sim
from rustcv_tpu.core import PixelFormat, SimpleConfig
from rustcv_tpu.core.mat import Mat
from rustcv_tpu.runtime import MultiStreamEngine


def main(n_frames: int = 30, width: int = 320, height: int = 240) -> str:
    path = os.path.join(tempfile.mkdtemp(), "clip.avi")

    # 1. Record: synthetic camera → MJPEG-AVI.
    with VideoWriter(path, "MJPG", fps=30, frame_size=(width, height)) as w:
        for s in range(n_frames):
            w.write(sim.synth_bgr(width, height, s))
    print(f"wrote {n_frames} frames to {path} ({os.path.getsize(path)//1024} KiB)")

    # 2. Play back through the OpenCV-style facade.
    cap = VideoCapture(path)
    mat = Mat.empty()
    count = 0
    while cap.read(mat):
        count += 1
    cap.release()
    print(f"VideoCapture read {count} frames of {mat.cols}x{mat.rows}")

    # 3. Batch-process the file on the device engine (2 parallel readers,
    #    Sobel magnitude), hybrid MJPEG decode.
    eng = MultiStreamEngine(
        FileDriver(path=path, loop=True), 2,
        SimpleConfig(width=width, height=height, fps=30, pixel_format=PixelFormat.MJPEG),
        filter="sobel_mag",
    )
    try:
        res = eng.tick(block=True)
        mag = res.numpy("filtered")
        print(f"engine tick from file: filtered {mag.shape}, mean |grad| {np.mean(mag):.1f}")
    finally:
        eng.close()
    return path


if __name__ == "__main__":
    main()
