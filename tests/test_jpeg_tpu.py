"""Hybrid MJPEG path tests: C++ entropy decode + device reconstruction vs PIL
(libjpeg) and vs the frozen NumPy oracle."""

import io

import numpy as np
import pytest

from rustcv_tpu import native
from rustcv_tpu.capture import simulation as sim

pytestmark = pytest.mark.skipif(
    not native.available(), reason=f"native lib unavailable: {native.build_error()}"
)


def _encode(bgr: np.ndarray, quality: int = 90, subsampling=None) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    kw = {"quality": quality}
    if subsampling is not None:
        kw["subsampling"] = subsampling
    Image.fromarray(bgr[..., ::-1]).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _encode_pil(bgr: np.ndarray, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(bgr[..., ::-1]).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil_decode_bgr(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))[..., ::-1]


class TestEntropyDecoder:
    @pytest.mark.parametrize("subsampling,name", [(0, "4:4:4"), (1, "4:2:2"), (2, "4:2:0")])
    def test_info_all_subsamplings(self, subsampling, name):
        bgr = sim.synth_bgr(64, 48, 1)
        data = _encode(bgr, subsampling=subsampling)
        info, coeffs, qts = native.jpeg_entropy_decode(data)
        assert (info["width"], info["height"]) == (64, 48)
        assert info["ncomp"] == 3

    def test_rejects_garbage(self):
        with pytest.raises(ValueError):
            native.jpeg_entropy_decode(b"\xff\xd8\x00\x01garbage")

    @pytest.mark.parametrize("subsampling", [0, 2])
    @pytest.mark.parametrize("rst", [1, 4, 16])
    def test_restart_markers(self, subsampling, rst):
        """DRI/RSTn streams: the accumulator reader must byte-align and
        reset DC predictors at every marker (refill() stops AT markers so
        align() only ever discards pad bits)."""
        from rustcv_tpu.ops.jpeg_tpu import decode_jpeg_numpy

        bgr = sim.synth_bgr(130, 54, 5)
        data = _encode_pil(bgr, quality=90, subsampling=subsampling,
                           restart_marker_blocks=rst)
        assert any(
            data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7
            for i in range(2, len(data) - 1)
        )
        ours = decode_jpeg_numpy(data).astype(np.int32)
        pil = _pil_decode_bgr(data).astype(np.int32)
        assert np.abs(ours - pil).max() <= 4  # usual IDCT tolerance

    def test_oversubscribed_dht_no_crash(self):
        """counts[1]=255 over-subscribes the 1-bit code space: the LUT
        build must not index past 255 (ASan-verified); decode either
        errors or returns bounded garbage, never crashes."""
        def u16(v):
            return bytes([v >> 8, v & 255])

        dqt = b"\xff\xdb" + u16(67) + b"\x00" + bytes([1] * 64)
        sof = b"\xff\xc0" + u16(11) + b"\x08" + u16(8) + u16(8) + b"\x01" + b"\x01\x11\x00"
        counts = bytes([255] + [0] * 15)
        vals = bytes(range(255))
        dht0 = b"\xff\xc4" + u16(2 + 1 + 16 + 255) + b"\x00" + counts + vals
        dht1 = b"\xff\xc4" + u16(2 + 1 + 16 + 255) + b"\x10" + counts + vals
        sos = b"\xff\xda" + u16(8) + b"\x01" + b"\x01\x00" + b"\x00\x3f\x00"
        data = b"\xff\xd8" + dqt + sof + dht0 + dht1 + sos + b"\x12\x34\x56\x78\xff\xd9"
        try:
            native.jpeg_entropy_decode(data)
        except ValueError:
            pass  # rejecting is equally fine

    def test_truncated_entropy_raises(self):
        """Mid-entropy truncation must fail loudly (no silent zero-pad):
        the fast reader's tail falls back to per-bit legacy semantics."""
        bgr = sim.synth_bgr(64, 48, 3)
        data = _encode(bgr, quality=90)
        for frac in (0.5, 0.9):
            cut = data[: int(len(data) * frac)]
            with pytest.raises(ValueError):
                native.jpeg_entropy_decode(cut)


class TestHybridReconstruction:
    @pytest.mark.parametrize("subsampling", [0, 1, 2])
    @pytest.mark.parametrize("w,h", [(64, 48), (130, 54)])  # non-MCU-aligned too
    def test_close_to_pil(self, jax_cpu, subsampling, w, h):
        """Our float-IDCT reconstruction vs libjpeg's fixed-point islow:
        must agree within small tolerances on every pixel."""
        from rustcv_tpu.ops.jpeg_tpu import decode_jpeg_tpu

        bgr = sim.synth_bgr(w, h, 5)
        data = _encode(bgr, quality=90, subsampling=subsampling)
        want = _pil_decode_bgr(data).astype(np.int32)
        got = np.asarray(decode_jpeg_tpu(data)).astype(np.int32)
        assert got.shape == want.shape
        diff = np.abs(got - want)
        assert diff.mean() < 1.0, f"mean {diff.mean()}"
        assert np.percentile(diff, 99) <= 2, f"p99 {np.percentile(diff, 99)}"
        assert diff.max() <= 16, f"max {diff.max()}"  # isolated edge pixels

    def test_device_matches_numpy_oracle(self, jax_cpu):
        from rustcv_tpu.ops.jpeg_tpu import decode_jpeg_numpy, decode_jpeg_tpu

        bgr = sim.synth_bgr(64, 48, 9)
        data = _encode(bgr, quality=85, subsampling=2)
        want = decode_jpeg_numpy(data).astype(np.int32)
        got = np.asarray(decode_jpeg_tpu(data)).astype(np.int32)
        # float64 vs float32 IDCT: ±1 at rounding boundaries only
        diff = np.abs(got - want)
        assert diff.max() <= 1
        assert (diff > 0).mean() < 0.01

    def test_grayscale(self, jax_cpu):
        from PIL import Image

        from rustcv_tpu.ops.jpeg_tpu import decode_jpeg_tpu

        gray = sim.synth_bgr(64, 48, 2)[..., 0]
        buf = io.BytesIO()
        Image.fromarray(gray, mode="L").save(buf, "JPEG", quality=90)
        got = np.asarray(decode_jpeg_tpu(buf.getvalue()))
        want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("L"))
        assert got.shape == (48, 64, 3)
        assert np.abs(got[..., 0].astype(int) - want.astype(int)).mean() < 1.0

    def test_quality_sweep_roundtrip(self, jax_cpu):
        """Reconstruction error vs the original must shrink as quality rises
        and match PIL's own reconstruction error closely."""
        from rustcv_tpu.ops.jpeg_tpu import decode_jpeg_tpu

        bgr = sim.synth_bgr(64, 48, 3).astype(np.int32)
        errs = []
        for q in (50, 75, 95):
            data = _encode(sim.synth_bgr(64, 48, 3), quality=q, subsampling=2)
            got = np.asarray(decode_jpeg_tpu(data)).astype(np.int32)
            errs.append(np.abs(got - bgr).mean())
        assert errs[0] >= errs[1] >= errs[2]


class TestChromaSubsamplings:
    """Real UVC cameras commonly emit 4:2:2 MJPEG (the simulation encodes
    4:2:0); the hybrid reconstruction must handle 4:2:2 (h2v1 fancy) and
    4:4:4 (no upsampling) too."""

    @pytest.mark.parametrize("subsampling,name", [(0, "444"), (1, "422"), (2, "420")])
    def test_hybrid_matches_oracle(self, jax_cpu, subsampling, name):
        import io

        from PIL import Image

        from rustcv_tpu.capture.simulation import synth_bgr
        from rustcv_tpu.ops.jpeg_tpu import decode_jpeg_numpy, decode_jpeg_tpu

        bgr = synth_bgr(96, 64, 3)
        buf = io.BytesIO()
        Image.fromarray(bgr[..., ::-1]).save(
            buf, format="JPEG", quality=88, subsampling=subsampling
        )
        data = buf.getvalue()
        got = np.asarray(decode_jpeg_tpu(data))
        want = decode_jpeg_numpy(data)
        # f32-vs-f64 IDCT rounding is ≤1 LSB per sample, but an off-by-one
        # Y can amplify to 2 through the color round — rare (<1% of
        # pixels), all subsamplings. Documented device-vs-oracle tolerance.
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 2, name
        assert (d > 1).mean() < 0.01, name
        # and the device path tracks the full-host libjpeg decode closely
        pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))[..., ::-1]
        diff = np.abs(got.astype(int) - pil.astype(int))
        assert np.percentile(diff, 99) <= 2 and diff.mean() < 1.0, name
