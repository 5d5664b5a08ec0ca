"""Device-side block-pack of JPEG encode coefficients + packed entropy coder.

The encode-direction twin of the hybrid decode path's block-packed upload:
pack_coeff_rows emits (position, value) slot pairs per light block and whole
dense rows for busy blocks; native.jpeg_entropy_encode_packed finishes them
to JFIF bytes IDENTICAL to the dense coder's output.
"""

import numpy as np
import pytest

from rustcv_tpu import native
from rustcv_tpu.ops import jpeg_encode as jenc

needs_native = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)


def _coeffs(rng, nblocks=96, busy_every=17, k=10):
    """Synthetic quantized rows: mostly sparse, every ``busy_every``-th
    block busier than K slots."""
    c = np.zeros((nblocks, 64), np.int16)
    for b in range(nblocks):
        nnz = rng.integers(0, k) if b % busy_every else k + rng.integers(5, 30)
        pos = rng.choice(64, size=min(64, nnz), replace=False)
        c[b, pos] = rng.integers(-1023, 1024, size=len(pos)).astype(np.int16)
        c[b, 0] = rng.integers(-1023, 1024)  # DC usually nonzero
    return c


class TestPackCoeffRows:
    def test_roundtrip_vs_oracle(self, jax_cpu):
        rng = np.random.default_rng(7)
        c = _coeffs(rng)
        k, dcap = 10, 32
        idx, val, ids, rows, nd = (
            np.asarray(a)
            for a in jenc.pack_coeff_rows(jax_cpu.numpy.asarray(c), k, dcap)
        )
        assert int(nd) <= dcap
        dense = jenc.unpack_coeff_rows_numpy(idx, val, ids, rows, c.shape[0])
        np.testing.assert_array_equal(dense, c)

    @pytest.mark.parametrize("k", [4, 10])
    def test_full_int16_range_exact(self, jax_cpu, k):
        """The one-hot selection matmul is exact for any int16 value, not
        only the ±1023 of baseline JPEG (no reduced-precision matmul)."""
        rng = np.random.default_rng(k)
        c = np.zeros((64, 64), np.int16)
        for b in range(64):
            pos = rng.choice(64, size=rng.integers(1, k + 1), replace=False)
            c[b, pos] = rng.integers(-32768, 32768, size=len(pos))
        idx, val, ids, rows, nd = (
            np.asarray(a)
            for a in jenc.pack_coeff_rows(jax_cpu.numpy.asarray(c), k, 8)
        )
        assert int(nd) == 0
        dense = jenc.unpack_coeff_rows_numpy(idx, val, ids, rows, c.shape[0])
        np.testing.assert_array_equal(dense, c)

    def test_overflow_reported(self, jax_cpu):
        rng = np.random.default_rng(3)
        c = _coeffs(rng, nblocks=64, busy_every=2)  # half the blocks busy
        _, _, _, _, nd = jenc.pack_coeff_rows(jax_cpu.numpy.asarray(c), 10, 8)
        assert int(np.asarray(nd)) > 8  # caller must fall back to dense

    def test_batched(self, jax_cpu):
        rng = np.random.default_rng(11)
        c = np.stack([_coeffs(rng), _coeffs(rng)])
        idx, val, ids, rows, nd = (
            np.asarray(a)
            for a in jenc.pack_coeff_rows(jax_cpu.numpy.asarray(c), 10, 32)
        )
        for i in range(2):
            dense = jenc.unpack_coeff_rows_numpy(
                idx[i], val[i], ids[i], rows[i], c.shape[1]
            )
            np.testing.assert_array_equal(dense, c[i])


@needs_native
class TestPackedEntropyEncode:
    def test_bytes_identical_to_dense(self, jax_cpu):
        from rustcv_tpu.capture.simulation import synth_bgr

        bgr = synth_bgr(96, 64, 5)
        coeffs, qts, g = jenc.encode_coeffs_numpy(bgr, 85)
        dense_bytes = native.jpeg_entropy_encode(
            coeffs, qts, 96, 64, g["h_samp"], g["v_samp"]
        )
        allc = np.concatenate([c.reshape(-1, 64) for c in coeffs])
        idx, val, ids, rows, nd = (
            np.asarray(a)
            for a in jenc.pack_coeff_rows(
                jax_cpu.numpy.asarray(allc), 10, max(8, allc.shape[0] // 4)
            )
        )
        assert int(nd) <= rows.shape[0]
        blocks = [c.shape[:2] for c in coeffs]
        packed_bytes = native.jpeg_entropy_encode_packed(
            idx, val, ids, rows, blocks, qts, 96, 64, g["h_samp"], g["v_samp"]
        )
        assert packed_bytes == dense_bytes

    def test_engine_stream_encoded(self, jax_cpu):
        """Pipelined encoded delivery end-to-end on the CPU backend."""
        from PIL import Image
        import io

        from rustcv_tpu.capture import SimulationDriver
        from rustcv_tpu.core import PixelFormat, SimpleConfig
        from rustcv_tpu.runtime import MultiStreamEngine

        n = 2
        eng = MultiStreamEngine(
            SimulationDriver(device_count=n, paced=False), n,
            SimpleConfig(width=96, height=64, fps=30, pixel_format=PixelFormat.YUYV),
            device_sim=True, encode_jpeg_quality=85,
        )
        assert eng.spec.encode_packed > 0  # packed delivery is the default
        stats, payload_mb = eng.run_encoded(6, warmup=1)
        eng.close()
        assert stats.ticks == 6
        assert payload_mb > 0
        # Payloads decode and have the right geometry
        eng2 = MultiStreamEngine(
            SimulationDriver(device_count=n, paced=False), n,
            SimpleConfig(width=96, height=64, fps=30, pixel_format=PixelFormat.YUYV),
            device_sim=True, encode_jpeg_quality=85,
        )
        rc = eng2.resolved_config  # sim negotiates to its nearest mode
        for _res, payloads in eng2.stream_encoded(max_ticks=2):
            assert len(payloads) == n
            for p in payloads:
                img = Image.open(io.BytesIO(p))
                assert img.size == (rc.width, rc.height)
        eng2.close()

    def test_packed_payloads_match_dense_engine(self, jax_cpu):
        """encode_payloads (packed default) == the dense coder's bytes."""
        from rustcv_tpu.capture import SimulationDriver
        from rustcv_tpu.core import PixelFormat, SimpleConfig
        from rustcv_tpu.runtime import MultiStreamEngine

        n = 2
        mk = lambda packed: MultiStreamEngine(  # noqa: E731
            SimulationDriver(device_count=n, paced=False), n,
            SimpleConfig(width=96, height=64, fps=30, pixel_format=PixelFormat.YUYV),
            device_sim=True, encode_jpeg_quality=85, encode_packed=packed,
        )
        a, b = mk(True), mk(False)
        pa = a.encode_payloads(a.tick(block=True))
        pb = b.encode_payloads(b.tick(block=True))
        a.close()
        b.close()
        assert pa == pb
