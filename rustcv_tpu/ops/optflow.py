"""Pyramidal Lucas–Kanade sparse optical flow (calcOpticalFlowPyrLK).

accelerator-native formulation: tracking is vectorized over the POINT axis with
``vmap`` — every level runs all points' gauss-newton iterations as one
fused program (patch sampling = bilinear gathers, the 2×2 normal system is
closed-form); the level loop is Python (per-level image shapes are
static). Pyramids use :func:`rustcv_tpu.ops.filters.pyr_down` (the frozen
5×5 Gaussian + decimate spec).

Float spec (float32 device / float64 oracle, tolerance-tested):
- patch gradients: central differences on the prev-image patch sampled at
  integer-offset grid around the (sub-pixel) point;
- iteration: v ← v + G⁻¹·b with G the gradient normal matrix and
  b = Σ δI·∇I over the window; level-to-level: g ← 2(g + v);
- status 0 when the point (window) leaves the image at any level or
  det(G)/win² falls under ``min_eig``-style threshold (1e-4 · win²·255²).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .filters import pyr_down


def _build_pyramid(img: jax.Array, levels: int):
    pyr = [img.astype(jnp.float32)]
    cur = img
    for _ in range(levels):
        cur = pyr_down(cur, has_channels=False)
        pyr.append(cur.astype(jnp.float32))
    return pyr


def _patch_lerp(img: jax.Array, top_left_y, top_left_x, win: int):
    """Bilinear win×win patch at a FLOAT top-left corner via ONE
    origin-clamped dynamic_slice + scalar-weight lerp.

    Every coordinate of an LK patch shares the same fractional offset, so
    instead of a 441-point gather per sample one (win+1)² contiguous
    slice and four shifted views
    suffice. dynamic_slice clamps the ORIGIN when the patch would overhang
    the image (the patch shifts inward rather than edge-replicating) —
    part of the frozen spec; the oracle does the same."""
    y0 = jnp.floor(top_left_y)
    x0 = jnp.floor(top_left_x)
    fy = top_left_y - y0
    fx = top_left_x - x0
    p = jax.lax.dynamic_slice(
        img,
        (y0.astype(jnp.int32), x0.astype(jnp.int32)),
        (win + 1, win + 1),
    )
    top = p[:win, :win] * (1 - fx) + p[:win, 1:] * fx
    bot = p[1:, :win] * (1 - fx) + p[1:, 1:] * fx
    return top * (1 - fy) + bot * fy


def _track_level(prev_l, next_l, pts_l, guess, half: int, iters: int):
    """One pyramid level for ALL points: returns (v, ok_texture, in_bounds)."""
    h, w = prev_l.shape
    win = 2 * half + 1

    def one(pt, g):
        cy = pt[1]
        cx = pt[0]
        # One (win+3)² slice gives the template AND its ±1-shifted views
        # for central-difference gradients.
        big = _patch_lerp(prev_l, cy - half - 1.0, cx - half - 1.0, win + 2)
        t = big[1:-1, 1:-1]
        ix = (big[1:-1, 2:] - big[1:-1, :-2]) * 0.5
        iy = (big[2:, 1:-1] - big[:-2, 1:-1]) * 0.5
        gxx = jnp.sum(ix * ix)
        gxy = jnp.sum(ix * iy)
        gyy = jnp.sum(iy * iy)
        det = gxx * gyy - gxy * gxy
        n = win * win
        ok_g = det / n > 1e-4 * n  # texture threshold
        inv = jnp.where(det != 0, 1.0 / jnp.maximum(jnp.abs(det), 1e-20), 0.0)
        inv = inv * jnp.sign(det)

        def body(_, v):
            di = (
                _patch_lerp(
                    next_l, cy + g[1] + v[1] - half, cx + g[0] + v[0] - half, win
                )
                - t
            )
            bx = jnp.sum(di * ix)
            by = jnp.sum(di * iy)
            dx = -(gyy * bx - gxy * by) * inv
            dy = -(-gxy * bx + gxx * by) * inv
            return v + jnp.array([dx, dy], jnp.float32)

        v = jax.lax.fori_loop(0, iters, body, jnp.zeros(2, jnp.float32))
        # A window (incl. the gradient halo) overhanging THIS level's image
        # would iterate on origin-shifted patches — skip the level instead
        # (v = 0); finer levels refine. OpenCV's maxLevel clamp plays the
        # same role.
        fits = (
            (cy - half - 1 >= 0) & (cy + half + 1 <= h - 1)
            & (cx - half - 1 >= 0) & (cx + half + 1 <= w - 1)
        )
        v = jnp.where(fits, v, 0.0)
        fin = jnp.array([cx + g[0] + v[0], cy + g[1] + v[1]])
        inb = (
            (cx - half >= 0) & (cx + half <= w - 1)
            & (cy - half >= 0) & (cy + half <= h - 1)
            & (fin[0] >= 0) & (fin[0] <= w - 1)
            & (fin[1] >= 0) & (fin[1] <= h - 1)
        )
        return v, ok_g, inb

    return jax.vmap(one)(pts_l, guess)


@partial(jax.jit, static_argnames=("win", "levels", "iters"))
def calc_optical_flow_pyr_lk(
    prev_gray: jax.Array,
    next_gray: jax.Array,
    pts: jax.Array,
    win: int = 21,
    levels: int = 3,
    iters: int = 10,
) -> Tuple[jax.Array, jax.Array]:
    """Track ``pts`` [N, 2] float32 (x, y) from ``prev_gray`` to
    ``next_gray`` (u8 [H, W]). Returns (next_pts [N, 2] float32,
    status [N] bool). ``win`` must be odd."""
    half = win // 2
    # Clamp the pyramid depth so the coarsest level still fits one
    # window + gradient halo (dynamic_slice needs the size in-bounds).
    h0, w0 = prev_gray.shape[-2], prev_gray.shape[-1]
    if min(h0, w0) < win + 3:
        raise ValueError(
            f"calc_optical_flow_pyr_lk: image {w0}x{h0} smaller than "
            f"win+3 = {win + 3}; use a smaller win"
        )
    while levels > 0 and min(h0 >> levels, w0 >> levels) < win + 3:
        levels -= 1
    pp = _build_pyramid(prev_gray, levels)
    np_ = _build_pyramid(next_gray, levels)
    n = pts.shape[0]
    g = jnp.zeros((n, 2), jnp.float32)
    ok_all = jnp.ones(n, bool)
    for lvl in range(levels, -1, -1):
        scale = float(2**lvl)
        pts_l = pts / scale
        v, ok_tex, inb = _track_level(pp[lvl], np_[lvl], pts_l, g, half, iters)
        # Texture gates at every level; the window-in-bounds test only at
        # the FINEST level — coarse-level windows legitimately overhang
        # small pyramid images (samples clamp), as in OpenCV.
        ok_all = ok_all & ok_tex
        if lvl == 0:
            ok_all = ok_all & inb
        if lvl > 0:
            g = 2.0 * (g + v)
        else:
            g = g + v
    next_pts = pts + g
    return next_pts, ok_all


# ---------------------------------------------------------------------------
# NumPy oracle (float64, same algorithm)
# ---------------------------------------------------------------------------


def _pyr_down_np(img: np.ndarray) -> np.ndarray:
    from . import golden

    return golden.pyr_down(img)


def _patch_lerp_np(img, top_left_y, top_left_x, win):
    """Oracle twin of :func:`_patch_lerp` (same origin-clamp semantics:
    weights from the UNCLAMPED floor, slice origin clamped in-bounds)."""
    h, w = img.shape
    y0 = int(np.floor(top_left_y))
    x0 = int(np.floor(top_left_x))
    fy = top_left_y - y0
    fx = top_left_x - x0
    y0 = min(max(y0, 0), h - (win + 1))
    x0 = min(max(x0, 0), w - (win + 1))
    p = img[y0 : y0 + win + 1, x0 : x0 + win + 1]
    top = p[:win, :win] * (1 - fx) + p[:win, 1:] * fx
    bot = p[1:, :win] * (1 - fx) + p[1:, 1:] * fx
    return top * (1 - fy) + bot * fy


def calc_optical_flow_pyr_lk_numpy(
    prev_gray: np.ndarray,
    next_gray: np.ndarray,
    pts: np.ndarray,
    win: int = 21,
    levels: int = 3,
    iters: int = 10,
):
    half = win // 2
    h0, w0 = prev_gray.shape
    if min(h0, w0) < win + 3:
        raise ValueError(
            f"calc_optical_flow_pyr_lk: image {w0}x{h0} smaller than "
            f"win+3 = {win + 3}; use a smaller win"
        )
    while levels > 0 and min(h0 >> levels, w0 >> levels) < win + 3:
        levels -= 1
    pp = [prev_gray.astype(np.float64)]
    nn = [next_gray.astype(np.float64)]
    cp, cn = prev_gray, next_gray
    for _ in range(levels):
        cp = _pyr_down_np(cp)
        cn = _pyr_down_np(cn)
        pp.append(cp.astype(np.float64))
        nn.append(cn.astype(np.float64))
    n_pts = pts.shape[0]
    g = np.zeros((n_pts, 2))
    ok_all = np.ones(n_pts, bool)
    n = win * win
    for lvl in range(levels, -1, -1):
        prev_l, next_l = pp[lvl], nn[lvl]
        h, w = prev_l.shape
        for i in range(n_pts):
            cx, cy = pts[i] / (2.0**lvl)
            big = _patch_lerp_np(prev_l, cy - half - 1.0, cx - half - 1.0, win + 2)
            t = big[1:-1, 1:-1]
            ix = (big[1:-1, 2:] - big[1:-1, :-2]) * 0.5
            iy = (big[2:, 1:-1] - big[:-2, 1:-1]) * 0.5
            gxx, gxy, gyy = (ix * ix).sum(), (ix * iy).sum(), (iy * iy).sum()
            det = gxx * gyy - gxy * gxy
            ok = det / n > 1e-4 * n
            v = np.zeros(2)
            fits = (
                cy - half - 1 >= 0 and cy + half + 1 <= h - 1
                and cx - half - 1 >= 0 and cx + half + 1 <= w - 1
            )
            if det != 0 and fits:
                for _ in range(iters):
                    di = _patch_lerp_np(
                        next_l, cy + g[i, 1] + v[1] - half, cx + g[i, 0] + v[0] - half, win
                    ) - t
                    bx, by = (di * ix).sum(), (di * iy).sum()
                    v += np.array([-(gyy * bx - gxy * by), -(-gxy * bx + gxx * by)]) / det
            fx_, fy_ = cx + g[i, 0] + v[0], cy + g[i, 1] + v[1]
            inb = (
                cx - half >= 0 and cx + half <= w - 1
                and cy - half >= 0 and cy + half <= h - 1
                and 0 <= fx_ <= w - 1 and 0 <= fy_ <= h - 1
            )
            ok_all[i] &= bool(ok) and (bool(inb) or lvl > 0)
            g[i] = 2.0 * (g[i] + v) if lvl > 0 else g[i] + v
    return (pts + g).astype(np.float64), ok_all


def build_optical_flow_pyramid(gray: np.ndarray, levels: int = 3):
    """OpenCV ``buildOpticalFlowPyramid`` role: the Gaussian pyramid
    the LK tracker consumes → list of (H/2^l, W/2^l) u8 images."""
    from .golden import pyr_down

    out = [np.asarray(gray)]
    for _ in range(levels - 1):
        out.append(pyr_down(out[-1]))
    return out
