"""MJPEG-AVI video file I/O: VideoWriter container correctness, reader
robustness, VideoCapture("file.avi") routing, and batched engine
consumption (host + device hybrid decode)."""

import io
import os

import numpy as np
import pytest

from rustcv_tpu.capture import (
    AviMjpegReader,
    FileDriver,
    VideoCapture,
    VideoWriter,
)
from rustcv_tpu.capture import simulation as sim
from rustcv_tpu.capture.avi import FileSource, is_video_file
from rustcv_tpu.core import PixelFormat, SimpleConfig
from rustcv_tpu.core.errors import CameraError, DecodeError, DeviceNotFound, EndOfStream
from rustcv_tpu.core.mat import Mat


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0**2 / max(mse, 1e-12))


@pytest.fixture()
def clip(tmp_path):
    """10-frame 128x96 MJPG AVI + its source frames."""
    path = str(tmp_path / "clip.avi")
    frames = [sim.synth_bgr(128, 96, s) for s in range(10)]
    with VideoWriter(path, "MJPG", fps=25, frame_size=(128, 96), quality=92) as w:
        for f in frames:
            w.write(f)
    return path, frames


class TestWriterReader:
    def test_roundtrip_geometry(self, clip):
        path, frames = clip
        r = AviMjpegReader(path)
        assert (r.width, r.height) == (128, 96)
        assert r.fps == pytest.approx(25.0)
        assert len(r) == 10 == r.declared_frames

    def test_frames_are_decodable_jpeg(self, clip):
        from PIL import Image

        path, frames = clip
        r = AviMjpegReader(path)
        for i in (0, 5, 9):
            data = r.frame_bytes(i)
            assert bytes(data[:2]) == b"\xff\xd8"
            img = np.asarray(
                Image.open(io.BytesIO(data.tobytes())).convert("RGB")
            )[..., ::-1]
            assert _psnr(img, frames[i]) > 24.0

    def test_tpu_encoder_variant(self, jax_cpu, tmp_path):
        pytest.importorskip("rustcv_tpu.native")
        from rustcv_tpu import native

        if not native.available():
            pytest.skip("native lib unavailable")
        path = str(tmp_path / "tpu.avi")
        frames = [sim.synth_bgr(64, 48, s) for s in range(3)]
        with VideoWriter(path, fps=30, frame_size=(64, 48), encoder="tpu") as w:
            for f in frames:
                w.write(f)
        r = AviMjpegReader(path)
        assert len(r) == 3

    def test_write_encoded_passthrough(self, tmp_path):
        path = str(tmp_path / "pre.avi")
        payload = bytes(sim.encode_mjpeg(sim.synth_bgr(64, 48, 1), quality=85))
        with VideoWriter(path, fps=30, frame_size=(64, 48)) as w:
            w.write_encoded(payload)
            w.write_encoded(payload)
        r = AviMjpegReader(path)
        assert len(r) == 2
        assert r.frame_bytes(0).tobytes() == payload

    def test_writer_errors(self, tmp_path):
        with pytest.raises(CameraError):
            VideoWriter(str(tmp_path / "x.avi"), fourcc="H264")
        with pytest.raises(CameraError):
            VideoWriter(str(tmp_path / "x.avi"), fps=0)
        w = VideoWriter(str(tmp_path / "y.avi"), frame_size=(64, 48))
        with pytest.raises(CameraError):
            w.write(sim.synth_bgr(32, 32, 0))  # wrong geometry
        w.release()
        with pytest.raises(CameraError):
            w.write_encoded(b"\xff\xd8")  # after release
        w.release()  # idempotent

    def test_gray_frames_not_mirrored(self, tmp_path):
        """2-D grayscale frames must encode as-is (a naive bgr[..., ::-1]
        would mirror the WIDTH axis)."""
        from PIL import Image

        path = str(tmp_path / "gray.avi")
        gray = np.tile((np.arange(64, dtype=np.uint8) * 4), (48, 1))
        with VideoWriter(path, frame_size=(64, 48), quality=95) as w:
            w.write(gray)
        r = AviMjpegReader(path)
        out = np.asarray(
            Image.open(io.BytesIO(r.frame_bytes(0).tobytes())).convert("L")
        ).astype(np.int64)
        assert np.mean(np.abs(out - gray)) < 3.0  # matches, not mirrored
        assert np.mean(np.abs(out - gray[:, ::-1])) > 50.0

    def test_empty_clip(self, tmp_path):
        path = str(tmp_path / "empty.avi")
        VideoWriter(path, frame_size=(64, 48)).release()
        r = AviMjpegReader(path)
        assert len(r) == 0
        with pytest.raises(DecodeError):
            FileSource(path)

    def test_reader_rejects_garbage(self, tmp_path):
        p = tmp_path / "bad.avi"
        p.write_bytes(b"not an avi at all")
        with pytest.raises(DecodeError):
            AviMjpegReader(str(p))
        with pytest.raises(DeviceNotFound):
            AviMjpegReader(str(tmp_path / "missing.avi"))

    def test_reader_tolerates_truncation(self, clip, tmp_path):
        """A truncated final chunk must not crash the parser (frames up to
        the cut still read)."""
        path, _ = clip
        data = open(path, "rb").read()
        cut = tmp_path / "cut.avi"
        cut.write_bytes(data[: len(data) * 2 // 3])
        r = AviMjpegReader(str(cut))
        assert 0 < len(r) <= 10


class TestFileSource:
    def test_end_of_stream(self, clip):
        path, _ = clip
        src = FileSource(path)
        src.start()
        for _ in range(10):
            src.next_frame()
        with pytest.raises(EndOfStream):
            src.next_frame()

    def test_loop_wraps(self, clip):
        path, _ = clip
        src = FileSource(path, loop=True)
        src.start()
        seqs = [src.next_frame().sequence for _ in range(15)]
        assert seqs == list(range(15))  # sequence keeps counting across wraps

    def test_previous_frame_invalidated(self, clip):
        path, _ = clip
        src = FileSource(path)
        src.start()
        f0 = src.next_frame()
        _ = f0.data
        src.next_frame()
        with pytest.raises(RuntimeError):
            _ = f0.data

    def test_paced_restart_does_not_stall(self, clip):
        """stop()/start() must restart pacing from the current position —
        not sleep ~_seq/fps (regression)."""
        import time

        path, _ = clip
        src = FileSource(path, paced=True, loop=True)
        src.start()
        for _ in range(5):
            src.next_frame()
        src.stop()
        src.start()
        t0 = time.monotonic()
        src.next_frame()
        assert time.monotonic() - t0 < 0.15  # 25 fps → ≤1 frame period

    def test_shared_reader(self, clip):
        """FileDriver shares ONE AviMjpegReader per path across sources."""
        path, _ = clip
        drv = FileDriver(path=path)
        s1, _ = drv.open("sim:0", None)
        s2, _ = drv.open("sim:1", None)
        assert s1._reader is s2._reader

    def test_resolved_config(self, clip):
        path, _ = clip
        rc = FileSource(path).resolved_config()
        assert (rc.width, rc.height, rc.pixel_format) == (128, 96, PixelFormat.MJPEG)
        assert rc.fps == 25


class TestVideoCaptureRouting:
    def test_is_video_file(self, clip, tmp_path):
        path, _ = clip
        assert is_video_file(path)
        assert not is_video_file(str(tmp_path / "missing.avi"))
        assert not is_video_file(0)
        assert not is_video_file("sim:0")

    def test_read_all_then_false(self, clip):
        path, frames = clip
        cap = VideoCapture(path)
        mat = Mat.empty()
        got = 0
        while cap.read(mat):
            if got == 4:
                assert _psnr(mat.to_numpy(), frames[4]) > 24.0
            got += 1
        assert got == 10
        assert cap.last_error is None  # EOF is not an error
        cap.release()


class TestEngineFromFile:
    @pytest.mark.parametrize("backend", ["host", "hybrid"])
    def test_batched_engine(self, jax_cpu, clip, backend):
        pytest.importorskip("rustcv_tpu.native")
        from rustcv_tpu import native

        if backend == "hybrid" and not native.available():
            pytest.skip("native lib unavailable")
        path, frames = clip
        from rustcv_tpu.runtime import MultiStreamEngine

        eng = MultiStreamEngine(
            FileDriver(path=path, loop=True), 2,
            SimpleConfig(width=128, height=96, fps=25, pixel_format=PixelFormat.MJPEG),
            mjpeg_backend=backend,
        )
        try:
            res = eng.tick(block=True)
            bgr = res.numpy("bgr")
            assert bgr.shape == (2, 96, 128, 3)
            assert _psnr(bgr[0], frames[0]) > 24.0
        finally:
            eng.close()
