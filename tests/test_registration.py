"""Phase correlation — shift recovery (integer, sub-pixel, wrapped
negative), oracle parity, and the no-correlation response floor."""

import numpy as np
import pytest

from rustcv_tpu.ops import golden, registration


def _tex(seed, h, w):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (h, w), np.uint8)
    return golden.gaussian5_u8(a)


class TestPhaseCorrelate:
    def test_integer_shift(self, jax_cpu):
        base = _tex(0, 128, 160)
        nxt = np.roll(np.roll(base, 5, axis=1), -3, axis=0)
        d, resp = registration.phase_correlate(base, nxt)
        d = np.asarray(d)
        assert abs(d[0] - 5) < 0.05 and abs(d[1] + 3) < 0.05
        assert float(resp) > 0.5

    def test_device_matches_oracle(self, jax_cpu):
        base = _tex(1, 96, 128)
        nxt = np.roll(base, 7, axis=1)
        d_d, r_d = registration.phase_correlate(base, nxt)
        d_n, r_n = registration.phase_correlate_numpy(base, nxt)
        np.testing.assert_allclose(np.asarray(d_d), d_n, atol=1e-3)
        assert abs(float(r_d) - r_n) < 1e-3

    def test_subpixel_shift(self, jax_cpu):
        """A true 2.5-px shift built in the Fourier domain recovers to
        ~0.1 px via the centroid."""
        base = _tex(2, 128, 128).astype(np.float64)
        F = np.fft.rfft2(base)
        kx = np.fft.rfftfreq(128)
        shifted = np.fft.irfft2(F * np.exp(-2j * np.pi * kx[None, :] * 2.5),
                                s=(128, 128))
        nxt = np.clip(np.round(shifted), 0, 255).astype(np.uint8)
        d, _ = registration.phase_correlate(base.astype(np.uint8), nxt)
        assert abs(float(np.asarray(d)[0]) - 2.5) < 0.15

    def test_zero_shift(self, jax_cpu):
        base = _tex(3, 64, 64)
        d, resp = registration.phase_correlate(base, base)
        assert np.abs(np.asarray(d)).max() < 1e-3
        assert float(resp) > 0.9

    def test_uncorrelated_low_response(self, jax_cpu):
        a = _tex(4, 64, 64)
        b = _tex(5, 64, 64)
        _, resp = registration.phase_correlate(a, b)
        assert float(resp) < 0.2

    def test_window_off(self, jax_cpu):
        base = _tex(6, 96, 96)
        nxt = np.roll(base, 4, axis=0)
        d, _ = registration.phase_correlate(base, nxt, window=False)
        assert abs(float(np.asarray(d)[1]) - 4) < 0.05

    def test_facade(self, jax_cpu):
        import jax.numpy as jnp

        from rustcv_tpu import imgproc
        from rustcv_tpu.core.mat import Mat

        base = _tex(7, 80, 96)
        nxt = np.roll(base, 2, axis=1)
        d_h, r_h = imgproc.phase_correlate(Mat.from_array(base), Mat.from_array(nxt))
        d_d, r_d = imgproc.phase_correlate(
            Mat.from_device(jnp.asarray(base)), Mat.from_device(jnp.asarray(nxt)))
        np.testing.assert_allclose(d_h, d_d, atol=1e-3)
        assert abs(d_d[0] - 2) < 0.05


class TestMatmulDFT:
    """FFT-free twins: matmul-form DFT planes (ops/transform.dft2_planes —
    4 real matmuls per 2-D transform, no complex dtype), as the device
    trackers use. Pin them against numpy's FFT and the FFT-based twins."""

    def test_dft2_planes_matches_numpy_fft(self, jax_cpu):
        from rustcv_tpu.ops import transform as TR

        rng = np.random.default_rng(2)
        x = rng.random((48, 64)).astype(np.float32) * 255
        re, im = TR.dft2_planes(jax_cpu.numpy.asarray(x))
        F = np.fft.fft2(x.astype(np.float64))
        scale = np.abs(F).max()
        np.testing.assert_allclose(np.asarray(re), F.real,
                                   atol=2e-5 * scale)
        np.testing.assert_allclose(np.asarray(im), F.imag,
                                   atol=2e-5 * scale)

    def test_idft2_roundtrip(self, jax_cpu):
        from rustcv_tpu.ops import transform as TR

        rng = np.random.default_rng(3)
        x = rng.random((40, 56)).astype(np.float32) * 100
        re, im = TR.dft2_planes(jax_cpu.numpy.asarray(x))
        rr, ri = TR.idft2_planes(re, im)
        np.testing.assert_allclose(np.asarray(rr), x, atol=1e-3)
        assert float(np.abs(np.asarray(ri)).max()) < 1e-3

    def test_mul_spectrums_planes(self, jax_cpu):
        from rustcv_tpu.ops import transform as TR

        rng = np.random.default_rng(4)
        a = rng.random((24, 32)) + 1j * rng.random((24, 32))
        b = rng.random((24, 32)) + 1j * rng.random((24, 32))
        for conj_b in (False, True):
            want = TR.mul_spectrums(a, b, conj_b=conj_b)
            re, im = TR.mul_spectrums_planes(
                (a.real, a.imag), (b.real, b.imag), conj_b=conj_b)
            np.testing.assert_allclose(re, want.real, atol=1e-12)
            np.testing.assert_allclose(im, want.imag, atol=1e-12)

    def test_phase_correlate_matmul_matches_fft_twin(self, jax_cpu):
        for seed, (dy, dx) in [(5, (3, -7)), (6, (0, 0)), (7, (-4, 9))]:
            base = _tex(seed, 96, 128)
            nxt = np.roll(np.roll(base, dx, axis=1), dy, axis=0)
            d_m, r_m = registration.phase_correlate_matmul(base, nxt)
            d_f, r_f = registration.phase_correlate(base, nxt)
            np.testing.assert_allclose(np.asarray(d_m), np.asarray(d_f),
                                       atol=1e-3)
            assert abs(float(r_m) - float(r_f)) < 1e-3
            d_n, _ = registration.phase_correlate_numpy(base, nxt)
            np.testing.assert_allclose(np.asarray(d_m), d_n, atol=1e-3)
