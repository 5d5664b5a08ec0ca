"""Offline video transcoding on the device: MJPEG-AVI in → processed MJPEG-AVI out.

The full round trip of the hybrid JPEG split, in both directions, in ONE
device program per batch-tick:

  host: entropy decode (C++ Huffman → coefficients)
  device: dequant + IDCT (matrix unit) → BGR → filter → overlay → FDCT (matrix unit) + quant
  host: entropy encode (C++ Huffman → JFIF) → AVI chunks

Only quantized coefficients (mostly zeros) cross the host↔device boundary.
Batching: N engine streams read the same file at offsets i, i+N, … so one
fused program processes N frames per tick.
"""

import argparse
import os
import tempfile

import numpy as np

from rustcv_tpu.capture import FileDriver, VideoWriter
from rustcv_tpu.capture import simulation as sim
from rustcv_tpu.capture.avi import AviMjpegReader, FileSource
from rustcv_tpu.core import PixelFormat, SimpleConfig
from rustcv_tpu.runtime import MultiStreamEngine


def make_test_clip(path: str, n_frames: int = 24, width: int = 320, height: int = 240):
    with VideoWriter(path, "MJPG", fps=30, frame_size=(width, height)) as w:
        for s in range(n_frames):
            w.write(sim.synth_bgr(width, height, s))


def transcode(
    src: str,
    dst: str,
    batch: int = 4,
    quality: int = 88,
    overlay: bool = True,
) -> int:
    """Transcode ``src`` → ``dst`` with a rectangle overlay burned in.

    Returns the number of frames written. Frame order is preserved by
    striding the file across the batch streams.
    """
    info = AviMjpegReader(src)
    n_frames = len(info)
    # Stream i reads frames i, i+batch, ... — strided views of ONE shared
    # reader (no duplicated file bytes).
    sources = [FileSource(src, reader=info) for _ in range(batch)]

    class _StridedDriver(FileDriver):
        def __init__(self):
            super().__init__(path=src)
            self._next = 0

        def open(self, device_id, config):
            s = sources[self._next]
            s.seek(self._next)  # starting offset
            self._next += 1
            from rustcv_tpu.capture.source import DeviceControls

            return s, DeviceControls()

    eng = MultiStreamEngine(
        _StridedDriver(), batch,
        SimpleConfig(
            width=info.width, height=info.height, fps=int(info.fps) or 30,
            pixel_format=PixelFormat.MJPEG,
        ),
        overlay=overlay, encode_jpeg_quality=quality,
        mjpeg_backend="hybrid",
    )
    rects = np.tile(
        np.array([[16, 16, info.width // 3, info.height // 3]], np.int32),
        (batch, 1),
    )
    colors = np.tile(np.array([[0, 255, 0]], np.uint8), (batch, 1))

    written = 0
    try:
        with VideoWriter(
            dst, "MJPG", fps=info.fps, frame_size=(info.width, info.height)
        ) as out:
            ticks = -(-n_frames // batch)
            for t in range(ticks):
                for i, s in enumerate(sources):  # stride past the other streams
                    s.seek(t * batch + i)
                res = eng.tick(block=True, rects=rects, rect_colors=colors)
                payloads = eng.encode_payloads(res)
                for i, p in enumerate(payloads):
                    if t * batch + i < n_frames:
                        out.write_encoded(p)
                        written += 1
    finally:
        eng.close()
    return written


def main(batch: int = 4) -> None:
    tmp = tempfile.mkdtemp()
    src = os.path.join(tmp, "in.avi")
    dst = os.path.join(tmp, "out.avi")
    make_test_clip(src)
    n = transcode(src, dst, batch=batch)
    out = AviMjpegReader(dst)
    print(
        f"transcoded {n} frames: {src} ({os.path.getsize(src)//1024} KiB) -> "
        f"{dst} ({os.path.getsize(dst)//1024} KiB), {out.width}x{out.height}"
    )


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=4)
    a = p.parse_args()
    main(a.batch)
