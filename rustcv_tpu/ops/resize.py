"""Device bilinear resize — fixed-point, bit-exact vs golden.resize_bilinear.

Coefficient tables (source indices + 11-bit weights) are computed on the host
in float64 (:func:`golden.resize_coeffs`) and baked into the jitted program as
constants per (src, dst) shape pair; the device does pure int32 gather+lerp.
Separable: horizontal gathers keep unshifted 11-bit sums, vertical pass
rounds once with ``(Σ + 2²¹) >> 22``. Gathers along an axis lower to XLA
``gather``/``take`` which device handles well for contiguous lanes.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from . import golden


@lru_cache(maxsize=128)
def _tables(src: int, dst: int):
    # NumPy (not jnp): these are jit-trace constants; device arrays created
    # inside a trace are tracers and caching them across traces leaks.
    lo, w_hi = golden.resize_coeffs(src, dst)
    hi = np.minimum(lo + 1, src - 1)
    return (
        lo.astype(np.int32),
        hi.astype(np.int32),
        w_hi.astype(np.int32),
    )


@partial(jax.jit, static_argnames=("dst_w", "dst_h"))
def resize_bilinear(img: jax.Array, dst_w: int, dst_h: int) -> jax.Array:
    """Resize (..., H, W, C) u8 → (..., dst_h, dst_w, C) u8."""
    src_h, src_w = img.shape[-3], img.shape[-2]
    x_lo, x_hi, x_whi = _tables(src_w, dst_w)
    y_lo, y_hi, y_whi = _tables(src_h, dst_h)
    one = golden.RESIZE_ONE

    a = img.astype(jnp.int32)
    # Horizontal (axis -2)
    lo = jnp.take(a, x_lo, axis=-2)
    hi = jnp.take(a, x_hi, axis=-2)
    wx = x_whi[:, None]
    tmp = lo * (one - wx) + hi * wx
    # Vertical (axis -3)
    lo = jnp.take(tmp, y_lo, axis=-3)
    hi = jnp.take(tmp, y_hi, axis=-3)
    wy = y_whi[:, None, None]
    acc = lo * (one - wy) + hi * wy
    out = (acc + (1 << (2 * golden.RESIZE_SHIFT - 1))) >> (2 * golden.RESIZE_SHIFT)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("dst_w", "dst_h"))
def resize_bicubic(img: jax.Array, dst_w: int, dst_h: int) -> jax.Array:
    """INTER_CUBIC resize (..., H, W, C) u8 → (..., dst_h, dst_w, C) u8 —
    bit-exact vs golden.resize_bicubic (a = −0.75, 11-bit fixed point,
    single final rounding; i32-safe, bound in the golden docstring).
    2-D input resizes a gray plane."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    src_h, src_w = img.shape[-3], img.shape[-2]
    xt, xw = golden.resize_bicubic_coeffs(src_w, dst_w)
    yt, yw = golden.resize_bicubic_coeffs(src_h, dst_h)
    xt_j = [jnp.asarray(xt[:, j]) for j in range(4)]
    yt_j = [jnp.asarray(yt[:, j]) for j in range(4)]
    xw_j = [jnp.asarray(xw[:, j])[:, None] for j in range(4)]
    yw_j = [jnp.asarray(yw[:, j])[:, None, None] for j in range(4)]

    a = img.astype(jnp.int32)
    tmp = sum(jnp.take(a, xt_j[j], axis=-2) * xw_j[j] for j in range(4))
    acc = sum(jnp.take(tmp, yt_j[j], axis=-3) * yw_j[j] for j in range(4))
    out = (acc + (1 << (2 * golden.RESIZE_SHIFT - 1))) >> (2 * golden.RESIZE_SHIFT)
    out = jnp.clip(out, 0, 255).astype(jnp.uint8)
    return out[..., 0] if squeeze else out


@partial(jax.jit, static_argnames=("dst_w", "dst_h"))
def resize_bilinear_plane(plane: jax.Array, dst_w: int, dst_h: int) -> jax.Array:
    """Resize single-channel planes (..., H, W) int → (..., dst_h, dst_w) u8.

    Same frozen fixed-point spec as :func:`resize_bilinear` (resize is
    per-channel independent, so the plane form is bit-identical to the HWC
    form) with a dense layout: W sits on the lane dim instead of
    a trailing channel dim of 3."""
    src_h, src_w = plane.shape[-2], plane.shape[-1]
    x_lo, x_hi, x_whi = _tables(src_w, dst_w)
    y_lo, y_hi, y_whi = _tables(src_h, dst_h)
    one = golden.RESIZE_ONE

    a = plane.astype(jnp.int32)
    st = _hstride(x_lo, x_whi, src_w, dst_w)
    if st is not None:
        # Integer-factor downscale: taps from a free reshape + static slice
        # instead of a lane gather (see resize_bilinear_packed).
        k, o, w = st
        g = a.reshape(*a.shape[:-1], dst_w, k)
        tmp = g[..., o] * one if w == 0 else g[..., o] * (one - w) + g[..., o + 1] * w
    else:
        lo = jnp.take(a, x_lo, axis=-1)
        hi = jnp.take(a, x_hi, axis=-1)
        tmp = lo * (one - x_whi) + hi * x_whi
    lo = jnp.take(tmp, y_lo, axis=-2)
    hi = jnp.take(tmp, y_hi, axis=-2)
    wy = y_whi[:, None]
    acc = lo * (one - wy) + hi * wy
    out = (acc + (1 << (2 * golden.RESIZE_SHIFT - 1))) >> (2 * golden.RESIZE_SHIFT)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("dst_w", "dst_h"))
def resize_nearest(img: jax.Array, dst_w: int, dst_h: int) -> jax.Array:
    """Nearest-neighbor resize (..., H, W, C) u8 — bit-exact vs
    golden.resize_nearest (tap tables are host float64 constants)."""
    sx = golden.resize_nearest_coeffs(img.shape[-2], dst_w)
    sy = golden.resize_nearest_coeffs(img.shape[-3], dst_h)
    return jnp.take(jnp.take(img, sy, axis=-3), sx, axis=-2)


@partial(jax.jit, static_argnames=("dst_w", "dst_h"))
def resize_area(img: jax.Array, dst_w: int, dst_h: int) -> jax.Array:
    """Area (box-mean) resize (..., H, W, C) u8 — integer factors only
    (exact k×k mean, round-half-up); other ratios take the bilinear spec
    (same distinction as golden.resize_area / OpenCV INTER_AREA)."""
    src_h, src_w = img.shape[-3], img.shape[-2]
    if not (
        dst_w <= src_w and dst_h <= src_h
        and src_w % dst_w == 0 and src_h % dst_h == 0
    ):
        return resize_bilinear(img, dst_w, dst_h)
    ky, kx = src_h // dst_h, src_w // dst_w
    batch = img.shape[:-3]
    c = img.shape[-1]
    a = img.astype(jnp.int32).reshape(*batch, dst_h, ky, dst_w, kx, c)
    s = a.sum(axis=(-4, -2))
    n = kx * ky
    return ((s + n // 2) // n).astype(jnp.uint8)


def _hstride(lo: np.ndarray, whi: np.ndarray, src: int, dst: int):
    """Detect an affine integer-stride horizontal pattern: lo[x] = k·x + o
    with constant weight w, group-local taps (src == k·dst, hi tap inside
    the k-pixel group). Half-pixel-center downscaling by an integer factor
    always has this shape (e.g. 1920→640: k=3, o=1, w=0 — pure subsample).
    Returns (k, o, w) or None."""
    if dst < 2 or src % dst != 0:
        return None
    k = int(lo[1] - lo[0])
    o = int(lo[0])
    if k < 1 or src != k * dst or not np.all(np.diff(lo) == k):
        return None
    if not np.all(whi == whi[0]):
        return None
    w = int(whi[0])
    if w > 0 and o + 1 >= k:
        return None  # hi tap would cross the group boundary
    return k, o, w


@partial(jax.jit, static_argnames=("src_w", "src_h", "dst_w", "dst_h"))
def resize_bilinear_packed(
    src: jax.Array, src_w: int, src_h: int, dst_w: int, dst_h: int
) -> jax.Array:
    """Packed BGR rows (…, H, W*3) u8 → (…, dst_h, dst_w*3) u8 —
    bit-identical bytes to ``resize_bilinear`` on the HWC view.

    Horizontal pass: when the coefficient table is an integer-stride
    affine pattern (any integer-factor downscale), the taps come from a
    free reshape + static slice instead of a lane gather. Falls back to a
    per-lane gather otherwise.
    Vertical pass is a row gather (cheap). Requires dst_w % 4 == 0
    only for downstream word-trick consumers, not for this op itself."""
    one = golden.RESIZE_ONE
    x_lo, x_hi, x_whi = _tables(src_w, dst_w)
    y_lo, y_hi, y_whi = _tables(src_h, dst_h)
    batch = src.shape[:-2]
    a = src.reshape(*batch, src_h, src_w * 3).astype(jnp.int32)

    st = _hstride(x_lo, x_whi, src_w, dst_w)
    if st is not None:
        k, o, w = st
        g = a.reshape(*batch, src_h, dst_w, 3 * k)
        lo = g[..., 3 * o : 3 * o + 3]
        if w == 0:
            tmp = lo * one  # keep the unshifted-sum form (single rounding)
        else:
            hi = g[..., 3 * o + 3 : 3 * o + 6]
            tmp = lo * (one - w) + hi * w
        tmp = tmp.reshape(*batch, src_h, dst_w * 3)
    else:
        ix = (np.repeat(x_lo * 3, 3) + np.tile(np.arange(3), dst_w)).astype(np.int32)
        ixh = (np.repeat(x_hi * 3, 3) + np.tile(np.arange(3), dst_w)).astype(np.int32)
        wx = np.repeat(x_whi, 3).astype(np.int32)
        lo = jnp.take(a, ix, axis=-1)
        hi = jnp.take(a, ixh, axis=-1)
        tmp = lo * (one - wx) + hi * wx

    lo = jnp.take(tmp, y_lo, axis=-2)
    hi = jnp.take(tmp, y_hi, axis=-2)
    wy = y_whi[:, None]
    acc = lo * (one - wy) + hi * wy
    out = (acc + (1 << (2 * golden.RESIZE_SHIFT - 1))) >> (2 * golden.RESIZE_SHIFT)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)
