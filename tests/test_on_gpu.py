"""Card-only checks: what only a GPU compile can show.

Each test takes the ``gpu`` fixture, so it skips on the CPU;
``python chip_smoke.py`` runs them on the card in its own process. They
cover the numbers that can differ there: integer stages at full width
(XLA's GPU fusion), f32 matmuls that must not fall to TF32, and the
float-then-round JPEG transform.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rustcv_tpu.ops import golden

pytestmark = pytest.mark.gpu


def test_blur_sobel_chain_full_width(rng, gpu):
    from rustcv_tpu.ops import filters as F

    g = rng.integers(0, 256, (2, 1080, 1920), dtype=np.uint8)
    gx, gy = F.sobel3_gray(F.gaussian5_u8(jnp.asarray(g), has_channels=False))
    got = np.asarray(F.gradient_magnitude_u8(gx, gy))
    for i in range(2):
        want = golden.gradient_magnitude_u8(
            *golden.sobel3_gray(golden.gaussian5_u8(g[i])))
        np.testing.assert_array_equal(got[i], want)


def test_yuyv_decode_and_overlay_full_width(rng, gpu):
    from rustcv_tpu.ops import color as C
    from rustcv_tpu.ops import draw as D

    w, h = 1920, 1080
    src = rng.integers(0, 256, (2, h * w * 2), dtype=np.uint8)
    rects = np.array([[-30, 40, 700, 500], [1500, 900, 600, 400]], np.int32)
    colors = np.array([[0, 255, 0], [255, 0, 128]], np.uint8)
    got = np.asarray(D.rectangle_packed(
        C.yuyv_to_bgr_packed(jnp.asarray(src), w, h), jnp.asarray(rects),
        jnp.asarray(colors), jnp.int32(3)))
    for i in range(2):
        want = golden.yuyv_to_bgr(src[i], w, h)
        golden.rectangle(want, h, w, w * 3, tuple(int(v) for v in rects[i]),
                         tuple(int(v) for v in colors[i]), 3)
        np.testing.assert_array_equal(got[i], want.reshape(h, w * 3))


def test_pack_coeff_rows_exact_on_gpu(gpu):
    """A TF32 matmul would round int16 values past its 11-bit significand."""
    from rustcv_tpu.ops import jpeg_encode as jenc

    rng = np.random.default_rng(5)
    c = np.zeros((512, 64), np.int16)
    for b in range(512):
        pos = rng.choice(64, size=rng.integers(1, 11), replace=False)
        c[b, pos] = rng.integers(-32768, 32768, size=len(pos))
    idx, val, ids, rows, nd = (
        np.asarray(a) for a in jenc.pack_coeff_rows(jnp.asarray(c), 10, 32))
    dense = jenc.unpack_coeff_rows_numpy(idx, val, ids, rows, c.shape[0])
    np.testing.assert_array_equal(dense, c)


def test_jpeg_encode_coefficients_within_tolerance(gpu):
    """Float FDCT + rounding: ±1 at .5 boundaries, on at most 0.5% of the
    coefficients, against the float64 encoder (same bound as the CPU)."""
    from rustcv_tpu.capture.simulation import synth_bgr
    from rustcv_tpu.ops import jpeg_encode as jenc

    bgr = synth_bgr(640, 480, 11)
    want, _, _ = jenc.encode_coeffs_numpy(bgr, 85, "4:2:0")
    got = jenc.encode_coeffs_tpu(bgr, 85, "4:2:0")
    for c in range(3):
        diff = np.abs(np.asarray(got[c]).astype(np.int32)
                      - want[c].reshape(-1, 64).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 5e-3
