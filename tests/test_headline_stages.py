"""Headline-path stages (YUYV decode, packed-rows overlay, blur+Sobel,
Harris) against the frozen NumPy spec, at the shapes the removed fused
kernels were tested on."""

import numpy as np
import pytest

import jax.numpy as jnp

from rustcv_tpu.ops import color as C
from rustcv_tpu.ops import draw as D
from rustcv_tpu.ops import golden

SHAPES = [(96, 48), (128, 40), (256, 96), (130, 64)]  # (w, h)
STENCIL_SHAPES = [(2, 48, 64), (1, 100, 130), (1, 135, 256), (1, 6, 128),
                  (3, 64, 200), (40, 56), (1, 24, 300), (2, 48, 200)]


def golden_blur_sobel(g):
    if g.ndim == 3:
        return np.stack([golden_blur_sobel(x) for x in g])
    return golden.gradient_magnitude_u8(*golden.sobel3_gray(golden.gaussian5_u8(g)))


def xla_blur_sobel(g):
    """The engine's blur_sobel stage: Gaussian5 → Sobel3 → |∇| in XLA."""
    from rustcv_tpu.ops import filters as F

    gx, gy = F.sobel3_gray(F.gaussian5_u8(g, has_channels=False))
    return F.gradient_magnitude_u8(gx, gy)


def _golden_overlay(src, w, h, rects, colors, t):
    out = []
    for i in range(src.shape[0]):
        bgr = golden.yuyv_to_bgr(src[i], w, h)
        golden.rectangle(bgr, h, w, w * 3, tuple(int(v) for v in rects[i]),
                         tuple(int(v) for v in colors[i]), t)
        out.append(bgr.reshape(h, w * 3))
    return np.stack(out)


def _inputs(w, h, n=4, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (n, h * w * 2), dtype=np.uint8)
    # off-canvas, degenerate and ordinary rectangles (x, y, w, h)
    rects = np.array([[w // 5, h // 5, w // 2, h // 2], [-15, -8, w // 2, h // 2],
                      [w // 2, h // 2, 0, 10], [w - 20, h - 10, 100, 100]],
                     np.int32)[:n]
    colors = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    return src, rects, colors


@pytest.mark.parametrize("shape", SHAPES)
def test_yuyv_decode_packed_and_gray_match_golden(jax_cpu, shape):
    w, h = shape
    src, _, _ = _inputs(w, h, seed=w * h)
    bgr = np.asarray(C.yuyv_to_bgr_packed(jnp.asarray(src), w, h))
    gray = np.asarray(C.yuyv_to_gray(jnp.asarray(src), w, h))
    for i in range(src.shape[0]):
        want = golden.yuyv_to_bgr(src[i], w, h)
        np.testing.assert_array_equal(bgr[i], want.reshape(h, w * 3))
        np.testing.assert_array_equal(gray[i], golden.bgr_to_gray(want))


@pytest.mark.parametrize("thickness", [1, 3])
@pytest.mark.parametrize("shape", SHAPES)
def test_rectangle_packed_matches_golden(jax_cpu, shape, thickness):
    w, h = shape
    src, rects, colors = _inputs(w, h, seed=7)
    got = D.rectangle_packed(C.yuyv_to_bgr_packed(jnp.asarray(src), w, h),
                             jnp.asarray(rects), jnp.asarray(colors),
                             jnp.int32(thickness))
    np.testing.assert_array_equal(
        np.asarray(got), _golden_overlay(src, w, h, rects, colors, thickness))


@pytest.mark.parametrize("thickness", [1, 3])
def test_word_domain_overlay_matches_golden(jax_cpu, thickness):
    """``yuyv_to_bgr_packed_overlay`` composites before the interleave."""
    w, h = 192, 96
    src, rects, colors = _inputs(w, h, seed=3)
    got = C.yuyv_to_bgr_packed_overlay(jnp.asarray(src), w, h, jnp.asarray(rects),
                                       jnp.asarray(colors), jnp.int32(thickness))
    np.testing.assert_array_equal(
        np.asarray(got), _golden_overlay(src, w, h, rects, colors, thickness))


@pytest.mark.parametrize("shape", STENCIL_SHAPES)
def test_blur_sobel_chain_matches_golden(rng, jax_cpu, shape):
    """Incl. heights and widths that are not powers of two, tiny frames and
    a 2-D input; the replicate borders follow the two-stage rule."""
    g = rng.integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(xla_blur_sobel(jnp.asarray(g))),
                                  golden_blur_sobel(g))


@pytest.mark.parametrize("shape", [(2, 48, 64), (1, 100, 130), (1, 135, 256),
                                   (1, 6, 128)])
def test_harris_corners_match_golden(rng, jax_cpu, shape):
    from rustcv_tpu.ops import features

    g = rng.integers(0, 256, shape, dtype=np.uint8)
    got = np.asarray(features.harris_corners(jnp.asarray(g)))
    want = np.stack([golden.harris_corners(x) for x in g])
    np.testing.assert_array_equal(got, want)
