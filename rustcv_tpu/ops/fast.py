"""FAST corner detector (features2d parity) — pure elementwise on the device.

FAST-N segment test on a Bresenham ring: a pixel is a corner when ≥ N
contiguous ring pixels are all brighter than center+t or all darker
than center−t. All three OpenCV pattern types are supported:
``9_16`` (the classic radius-3/16-pixel ring), ``7_12`` (radius-2/12)
and ``5_8`` (radius-1/8). The Device formulation has no per-pixel loops:
the K ring views are static shifts of the image, the two K-bit ring
masks live as int32 lanes, and "N contiguous (circularly)" reduces by
the rotate-AND trick — AND of N−1 successive rotations is nonzero iff
some run of length N exists. Score = Σ|ring − center| over the passing
arc's direction (a simple frozen spec; OpenCV's score differs), NMS
3×3 like Harris.

Frozen spec (exact integer): brighter = ring > c + t, darker = ring <
c − t; a border of ring-radius pixels never fires; non-max suppression
on the score. Cross-validation vs cv2 5.0 (tests/test_fast.py):
``9_16`` detections are SET-EQUAL to cv2's (nonmax off). cv2 5.0's
``7_12`` drops wrap-around arcs (black-box probe: only runs inside its
first 10 ring positions fire) and its ``5_8`` degenerates to requiring
ALL 8 ring pixels — both deviations from the published segment test;
we implement the published (properly circular) test, so our 7_12/5_8
detections are a strict superset of cv2 5.0's.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

# Bresenham circle radius 3, clockwise from 12 o'clock: (dy, dx).
RING = [
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
]

# Bresenham circle radius 2 (12 pixels) and the unit ring (8 pixels).
RING12 = [
    (-2, 0), (-2, 1), (-1, 2), (0, 2), (1, 2), (2, 1), (2, 0), (2, -1),
    (1, -2), (0, -2), (-1, -2), (-2, -1),
]
RING8 = [
    (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1),
]

# pattern → (ring, default n, border radius)
PATTERNS = {
    "9_16": (RING, 9, 3),
    "7_12": (RING12, 7, 2),
    "5_8": (RING8, 5, 1),
}


def _resolve(pattern: str, n: Optional[int]):
    if pattern not in PATTERNS:
        raise ValueError(f"unknown pattern {pattern!r} "
                         f"(one of {sorted(PATTERNS)})")
    ring, default_n, border = PATTERNS[pattern]
    return ring, (default_n if n is None else n), border


def _rot(m, k, size):
    """Circular left-rotation of a size-bit lane mask by k."""
    return ((m << k) | (m >> (size - k))) & ((1 << size) - 1)


def _has_run(mask, n, size):
    """True where the size-bit circular mask contains a run of n ones."""
    acc = mask
    for k in range(1, n):
        acc = acc & _rot(mask, k, size)
    return acc != 0


def _shift(img, dy, dx):
    """Image shifted so out[y, x] = img[y+dy, x+dx] (zero-pad borders —
    the ring-radius border is masked off anyway)."""
    h, w = img.shape[-2], img.shape[-1]
    out = jnp.zeros_like(img)
    ys = slice(max(dy, 0), h + min(dy, 0))
    xs = slice(max(dx, 0), w + min(dx, 0))
    yd = slice(max(-dy, 0), h + min(-dy, 0))
    xd = slice(max(-dx, 0), w + min(-dx, 0))
    return out.at[..., yd, xd].set(img[..., ys, xs])


@partial(jax.jit, static_argnames=("threshold", "n", "nms", "pattern"))
def fast_response(gray_u8: jax.Array, threshold: int = 20,
                  n: Optional[int] = None, nms: bool = True,
                  pattern: str = "9_16"):
    """u8 gray (H, W) → (corner mask bool, score int32) — FAST-n."""
    ring, n, border = _resolve(pattern, n)
    size = len(ring)
    c = gray_u8.astype(jnp.int32)
    rings = [_shift(c, dy, dx) for dy, dx in ring]
    bright = jnp.zeros_like(c)
    dark = jnp.zeros_like(c)
    score_b = jnp.zeros_like(c)
    score_d = jnp.zeros_like(c)
    for i, r in enumerate(rings):
        bright = bright | ((r > c + threshold).astype(jnp.int32) << i)
        dark = dark | ((r < c - threshold).astype(jnp.int32) << i)
        score_b = score_b + jnp.maximum(r - c - threshold, 0)
        score_d = score_d + jnp.maximum(c - threshold - r, 0)
    is_b = _has_run(bright, n, size)
    is_d = _has_run(dark, n, size)
    score = jnp.where(is_b, score_b, 0) + jnp.where(is_d, score_d, 0)
    corner = is_b | is_d
    # ring-radius border never fires (incomplete rings read zero-padding)
    h, w = c.shape[-2], c.shape[-1]
    yy = jax.lax.broadcasted_iota(jnp.int32, c.shape, c.ndim - 2)
    xx = jax.lax.broadcasted_iota(jnp.int32, c.shape, c.ndim - 1)
    inb = ((yy >= border) & (yy < h - border)
           & (xx >= border) & (xx < w - border))
    corner = corner & inb
    score = jnp.where(corner, score, 0)
    if nms:
        neigh = score
        best = score
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                best = jnp.maximum(best, _shift(neigh, dy, dx))
        corner = corner & (score >= best) & (score > 0)
    return corner, score


@partial(jax.jit, static_argnames=("threshold", "n", "max_corners",
                                   "nms", "pattern"))
def fast_corner_list(
    gray_u8: jax.Array,
    threshold: int = 20,
    n: Optional[int] = None,
    max_corners: int = 1024,
    nms: bool = True,
    pattern: str = "9_16",
):
    """Top-K FAST corners: ([K, 2] (y, x) int32, valid bool[K]) — the same
    static-shape contract as harris_corner_list."""
    corner, score = fast_response(gray_u8, threshold, n, nms, pattern)
    h, w = gray_u8.shape[-2], gray_u8.shape[-1]
    flat = jnp.where(corner, score, -1).reshape(h * w)
    top, idx = jax.lax.top_k(flat, max_corners)
    return jnp.stack([idx // w, idx % w], axis=-1), top > 0


# ---------------------------------------------------------------------------
# NumPy oracle (same frozen spec)
# ---------------------------------------------------------------------------


def fast_corners_numpy(gray: np.ndarray, threshold: int = 20,
                       n: Optional[int] = None, nms: bool = True,
                       pattern: str = "9_16"):
    ring, n, border = _resolve(pattern, n)
    size = len(ring)
    c = gray.astype(np.int64)
    h, w = c.shape
    bright = np.zeros((h, w), np.int64)
    dark = np.zeros((h, w), np.int64)
    sb = np.zeros((h, w), np.int64)
    sd = np.zeros((h, w), np.int64)
    for i, (dy, dx) in enumerate(ring):
        r = np.zeros_like(c)
        ys = slice(max(dy, 0), h + min(dy, 0))
        xs = slice(max(dx, 0), w + min(dx, 0))
        yd = slice(max(-dy, 0), h + min(-dy, 0))
        xd = slice(max(-dx, 0), w + min(-dx, 0))
        r[yd, xd] = c[ys, xs]
        bright |= (r > c + threshold).astype(np.int64) << i
        dark |= (r < c - threshold).astype(np.int64) << i
        sb += np.maximum(r - c - threshold, 0)
        sd += np.maximum(c - threshold - r, 0)

    def run(mask):
        acc = mask.copy()
        for k in range(1, n):
            rot = ((mask << k) | (mask >> (size - k))) & ((1 << size) - 1)
            acc &= rot
        return acc != 0

    is_b = run(bright)
    is_d = run(dark)
    score = np.where(is_b, sb, 0) + np.where(is_d, sd, 0)
    corner = is_b | is_d
    corner[:border] = corner[-border:] = False
    corner[:, :border] = corner[:, -border:] = False
    score = np.where(corner, score, 0)
    if nms:
        best = score.copy()
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                shifted = np.zeros_like(score)
                ys = slice(max(dy, 0), h + min(dy, 0))
                xs = slice(max(dx, 0), w + min(dx, 0))
                yd = slice(max(-dy, 0), h + min(-dy, 0))
                xd = slice(max(-dx, 0), w + min(-dx, 0))
                shifted[yd, xd] = score[ys, xs]
                best = np.maximum(best, shifted)
        corner = corner & (score >= best) & (score > 0)
    return corner, score
