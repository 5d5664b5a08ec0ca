"""device JPEG encode path: device FDCT/quant vs the float64 oracle, the
native entropy coder's exact invertibility, and end-to-end decodability by
an independent decoder (PIL/libjpeg)."""

import io

import numpy as np
import pytest

from rustcv_tpu import native
from rustcv_tpu.capture import simulation as sim

pytestmark = pytest.mark.skipif(
    not native.available(), reason=f"native lib unavailable: {native.build_error()}"
)


def _pil_decode_bgr(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))[..., ::-1]


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0**2 / max(mse, 1e-12)))


class TestEntropyEncoder:
    """The host Huffman coder must invert bit-exactly through our decoder —
    independent of any DCT numerics."""

    @pytest.mark.parametrize("subsampling", ["4:2:0", "4:2:2", "4:4:4"])
    @pytest.mark.parametrize("w,h", [(64, 48), (130, 54), (8, 8)])
    def test_roundtrip_exact(self, rng, subsampling, w, h):
        from rustcv_tpu.ops import jpeg_encode as je

        bgr = sim.synth_bgr(w, h, 7)
        coeffs, qts, g = je.encode_coeffs_numpy(bgr, 90, subsampling)
        data = native.jpeg_entropy_encode(
            coeffs, qts, w, h, g["h_samp"], g["v_samp"]
        )
        info, co2, qt2 = native.jpeg_entropy_decode(data)
        assert (info["width"], info["height"]) == (w, h)
        assert info["h_samp"] == g["h_samp"] and info["v_samp"] == g["v_samp"]
        for c in range(3):
            got = co2[c].reshape(co2[c].shape[0], co2[c].shape[1], 64)
            assert np.array_equal(coeffs[c], got)
            assert np.array_equal(qts[c].reshape(8, 8), qt2[c])

    def test_roundtrip_random_coeffs(self, rng):
        """Adversarial coefficients (dense, large, negative) round-trip."""
        from rustcv_tpu.ops import jpeg_encode as je

        qy, qc = je.quant_tables(90)
        coeffs = [
            rng.integers(-1023, 1024, size=(4, 6, 64)).astype(np.int16),
            rng.integers(-1023, 1024, size=(2, 3, 64)).astype(np.int16),
            rng.integers(-1023, 1024, size=(2, 3, 64)).astype(np.int16),
        ]
        data = native.jpeg_entropy_encode(
            coeffs, [qy, qc, qc], 48, 32, [2, 1, 1], [2, 1, 1]
        )
        _, co2, _ = native.jpeg_entropy_decode(data)
        for c in range(3):
            got = co2[c].reshape(co2[c].shape[0], co2[c].shape[1], 64)
            assert np.array_equal(coeffs[c], got)

    def test_dense_max_magnitude_fits_capacity(self):
        """Worst-case in-contract grids (every coefficient ±1023) must not
        overflow the output buffer (the old 4 B/coeff bound did)."""
        from rustcv_tpu.ops import jpeg_encode as je

        qy, qc = je.quant_tables(90)
        coeffs = [
            np.full((4, 6, 64), 1023, np.int16),
            np.full((2, 3, 64), 1023, np.int16),
            np.full((2, 3, 64), -1023, np.int16),
        ]
        data = native.jpeg_entropy_encode(
            coeffs, [qy, qc, qc], 48, 32, [2, 1, 1], [2, 1, 1]
        )
        _, co2, _ = native.jpeg_entropy_decode(data)
        for c in range(3):
            got = co2[c].reshape(co2[c].shape[0], co2[c].shape[1], 64)
            assert np.array_equal(coeffs[c], got)

    def test_out_of_category_coefficient_errors(self):
        """A coefficient beyond the Huffman categories must raise, not emit
        a silently undecodable stream."""
        from rustcv_tpu.ops import jpeg_encode as je

        qy, qc = je.quant_tables(90)
        bad = [np.zeros((2, 2, 64), np.int16) for _ in range(3)]
        bad[0][0, 0, 5] = 2000  # AC magnitude needs 11 bits (max is 10)
        with pytest.raises(ValueError):
            native.jpeg_entropy_encode(
                bad, [qy, qc, qc], 16, 16, [1, 1, 1], [1, 1, 1]
            )

    def test_rejects_bad_geometry(self):
        from rustcv_tpu.ops import jpeg_encode as je

        qy, qc = je.quant_tables(90)
        coeffs = [np.zeros((3, 3, 64), np.int16)] * 3  # not MCU-consistent
        with pytest.raises(ValueError):
            native.jpeg_entropy_encode(
                coeffs, [qy, qc, qc], 48, 32, [2, 1, 1], [2, 1, 1]
            )


class TestDeviceVsOracle:
    @pytest.mark.parametrize("subsampling", ["4:2:0", "4:2:2", "4:4:4"])
    def test_coeffs_close(self, jax_cpu, subsampling):
        """Device float32 FDCT vs float64 oracle: off-by-one on a tiny
        fraction of quantization-boundary coefficients at most (documented
        tolerance, same discipline as the decode path)."""
        from rustcv_tpu.ops import jpeg_encode as je

        bgr = sim.synth_bgr(130, 54, 3)
        want, _, _ = je.encode_coeffs_numpy(bgr, 90, subsampling)
        got = je.encode_coeffs_tpu(np.asarray(bgr), 90, subsampling)
        for c in range(3):
            w = want[c].reshape(-1, 64).astype(np.int32)
            g = np.asarray(got[c]).astype(np.int32)
            diff = np.abs(w - g)
            assert diff.max() <= 1
            assert (diff > 0).mean() < 5e-3

    def test_quality_tables_ijg(self):
        from rustcv_tpu.ops import jpeg_encode as je

        qy50, _ = je.quant_tables(50)
        assert np.array_equal(qy50, je.BASE_QT_LUMA.astype(np.uint16))
        qy100, qc100 = je.quant_tables(100)
        assert qy100.min() == 1 and qy100.max() == 1
        qy1, _ = je.quant_tables(1)
        assert qy1.max() == 255


class TestEndToEnd:
    @pytest.mark.parametrize("subsampling", ["4:2:0", "4:2:2", "4:4:4"])
    @pytest.mark.parametrize("w,h", [(64, 48), (130, 54)])
    def test_pil_decodable_and_matches_pil_quality(
        self, jax_cpu, subsampling, w, h
    ):
        """PIL must decode our stream, and our encoder's rate/distortion
        must match PIL's own libjpeg encode at identical settings."""
        from PIL import Image

        from rustcv_tpu.ops import jpeg_encode as je

        bgr = sim.synth_bgr(w, h, 5)
        data = je.encode_jpeg_tpu(bgr, quality=90, subsampling=subsampling)
        out = _pil_decode_bgr(data)
        assert out.shape == bgr.shape
        ours = _psnr(out, bgr)

        buf = io.BytesIO()
        pil_sub = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}[subsampling]
        Image.fromarray(bgr[..., ::-1]).save(
            buf, "JPEG", quality=90, subsampling=pil_sub
        )
        theirs = _psnr(_pil_decode_bgr(buf.getvalue()), bgr)
        assert ours >= theirs - 0.5  # match libjpeg-class quality

    def test_own_hybrid_decoder_roundtrip(self, jax_cpu):
        """encode_jpeg_tpu → decode_jpeg_tpu closes the loop on-device."""
        from rustcv_tpu.ops.jpeg_encode import encode_jpeg_tpu
        from rustcv_tpu.ops.jpeg_tpu import decode_jpeg_tpu

        bgr = sim.synth_bgr(96, 64, 9)
        out = np.asarray(decode_jpeg_tpu(encode_jpeg_tpu(bgr, quality=95, subsampling="4:4:4")))
        assert _psnr(out, bgr) > 38.0

    def test_gray(self, jax_cpu):
        from rustcv_tpu.ops.jpeg_encode import encode_jpeg_tpu
        from PIL import Image

        gray = sim.synth_bgr(130, 54, 2)[..., 1]
        data = encode_jpeg_tpu(gray, quality=90)
        out = np.asarray(Image.open(io.BytesIO(data)).convert("L"))
        assert out.shape == gray.shape
        assert _psnr(out, gray) > 40.0

    def test_batch_matches_single(self, jax_cpu):
        from rustcv_tpu.ops.jpeg_encode import (
            encode_jpeg_batch_tpu,
            encode_jpeg_tpu,
        )

        batch = np.stack([sim.synth_bgr(64, 48, s) for s in range(3)])
        outs = encode_jpeg_batch_tpu(batch, quality=88)
        assert len(outs) == 3
        for i, d in enumerate(outs):
            assert d == encode_jpeg_tpu(batch[i], quality=88)

    def test_quality_monotonic_size(self, jax_cpu):
        from rustcv_tpu.ops.jpeg_encode import encode_jpeg_tpu

        bgr = sim.synth_bgr(128, 96, 4)
        sizes = [len(encode_jpeg_tpu(bgr, quality=q)) for q in (30, 60, 90)]
        assert sizes[0] < sizes[1] < sizes[2]


class TestFusedTranscode:
    """encode_jpeg fused into the tick program (the MJPEG transcode shape:
    decode → process → overlay → encode coefficients, one device program)."""

    def test_pipeline_outputs_match_standalone(self, jax_cpu):
        from PIL import Image

        from rustcv_tpu.capture import synth_raw
        from rustcv_tpu.core import PixelFormat
        from rustcv_tpu.ops import golden
        from rustcv_tpu.ops.jpeg_encode import encode_coeffs_numpy
        from rustcv_tpu.runtime.pipeline import (
            PipelineSpec,
            get_pipeline,
            make_dummy_overlay,
        )

        spec = PipelineSpec(
            PixelFormat.YUYV, 64, 48, overlay=False, encode_jpeg=90,
        )
        fn = get_pipeline(spec)
        raw = np.stack([synth_raw(64, 48, PixelFormat.YUYV, s) for s in range(2)])
        out = fn(raw, *make_dummy_overlay(2))
        assert {"enc_y", "enc_cb", "enc_cr"} <= set(out)
        # fused coefficients ≈ float64 oracle on the decoded BGR (≤1 off on
        # quantization boundaries, same tolerance as the standalone path)
        for i in range(2):
            bgr = golden.yuyv_to_bgr(raw[i], 64, 48)
            want, _, _ = encode_coeffs_numpy(bgr, 90, "4:2:0")
            for key, c in (("enc_y", 0), ("enc_cb", 1), ("enc_cr", 2)):
                got = np.asarray(out[key][i]).astype(np.int32)
                w = want[c].reshape(-1, 64).astype(np.int32)
                diff = np.abs(got - w)
                assert diff.max() <= 1 and (diff > 0).mean() < 5e-3

    def test_engine_transcode_end_to_end(self, jax_cpu):
        from PIL import Image

        from rustcv_tpu.capture import SimulationDriver
        from rustcv_tpu.core import PixelFormat, SimpleConfig
        from rustcv_tpu.runtime import MultiStreamEngine

        eng = MultiStreamEngine(
            SimulationDriver(device_count=2, paced=False), 2,
            SimpleConfig(width=128, height=96, fps=30, pixel_format=PixelFormat.YUYV),
            overlay=True, device_sim=True, encode_jpeg_quality=90,
        )
        try:
            rects = np.array([[8, 8, 40, 30]] * 2, np.int32)
            cols = np.array([[0, 255, 0]] * 2, np.uint8)
            res = eng.tick(block=True, rects=rects, rect_colors=cols)
            payloads = eng.encode_payloads(res)
            bgr = res.numpy("bgr")
            assert len(payloads) == 2
            for i, p in enumerate(payloads):
                img = np.asarray(Image.open(io.BytesIO(p)).convert("RGB"))[..., ::-1]
                assert img.shape == bgr[i].shape
                assert _psnr(img, bgr[i]) > 23.0  # 4:2:0 on the synth pattern
        finally:
            eng.close()

    def test_engine_without_encode_raises(self, jax_cpu):
        from rustcv_tpu.capture import SimulationDriver
        from rustcv_tpu.core import PixelFormat, SimpleConfig
        from rustcv_tpu.core.errors import CameraError
        from rustcv_tpu.runtime import MultiStreamEngine

        eng = MultiStreamEngine(
            SimulationDriver(device_count=1, paced=False), 1,
            SimpleConfig(width=64, height=48, fps=30, pixel_format=PixelFormat.YUYV),
            device_sim=True,
        )
        try:
            res = eng.tick(block=True)
            with pytest.raises(CameraError):
                eng.encode_payloads(res)
        finally:
            eng.close()


class TestImencode:
    def test_imencode_imdecode_roundtrip(self, jax_cpu, tmp_path):
        from rustcv_tpu.core.mat import Mat
        from rustcv_tpu.imgcodecs import imdecode, imencode

        bgr = sim.synth_bgr(96, 64, 11)
        mat = Mat.from_array(bgr)
        for backend in ("host", "tpu"):
            data = imencode(".jpg", mat, quality=95, backend=backend)
            assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
            out = imdecode(data, backend=backend)
            # 4:2:0 on the chroma-rich synth pattern costs fidelity for any
            # encoder (PIL measures ~25 dB at the same settings).
            assert _psnr(out.to_numpy(), bgr) > 24.0

    def test_imencode_png_lossless(self, jax_cpu):
        from rustcv_tpu.core.mat import Mat
        from rustcv_tpu.imgcodecs import imdecode, imencode

        bgr = sim.synth_bgr(40, 30, 1)
        data = imencode(".png", Mat.from_array(bgr))
        assert np.array_equal(imdecode(data).to_numpy(), bgr)

    def test_imencode_errors(self):
        from rustcv_tpu.core.errors import CameraError
        from rustcv_tpu.core.mat import Mat
        from rustcv_tpu.imgcodecs import imencode

        with pytest.raises(CameraError):
            imencode(".jpg", Mat.empty())
        with pytest.raises(ValueError):
            imencode(".jpg", Mat.from_array(sim.synth_bgr(16, 16, 0)), backend="gpu")
