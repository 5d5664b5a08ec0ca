"""Dense optical flow via polynomial expansion (Farnebäck 2003; the
OpenCV ``calcOpticalFlowFarneback`` role — complements the sparse LK
tracker in ops/optflow.py with a per-pixel flow field).

Device formulation: every stage is dense elementwise / separable-correlation
work. The polynomial expansion is six separable Gaussian-basis
correlations (`_taps` shifted views — no conv gather) followed by a
constant 6x6 normal-equation inverse applied as per-pixel linear
combinations; the window aggregation is a separable box filter; the 2x2
solve is closed-form elementwise. The only gather is the bilinear
sampling of the second image's five coefficient planes at flow-displaced
positions — all five planes share one set of indices/weights (stacked
[5, H*W] takes). Pyramid levels are half-resolution (frozen pyr_scale =
0.5) so the decimation is a strided view, not a resize gather.

Frozen spec (ours; float32 device == float64 oracle within tolerance):
- applicability w(t) = exp(-t^2 / (2*poly_sigma^2)), t in [-n, n], no
  normalization (it cancels in the normal equations); basis
  {1, x, y, x^2, y^2, xy}; correlations use replicate border;
- f(p) ~ c + b.p + p'Ap with A = [[axx, axy/2], [axy/2, ayy]]; dual
  coefficients are G^{-1} @ projections, G[i,j] = sum w(x)w(y) phi_i phi_j
  (computed and inverted in float64 on host — a compile-time constant);
- update: sample plane set of image 2 at q = clip(p + flow, borders)
  bilinearly; A~ = (A1 + A2(q))/2, rhs = -0.5*(b2(q) - b1) + A~ @ flow;
  accumulate M = sum_box(A~'A~), v = sum_box(A~' rhs) over
  winsize x winsize (uniform box, replicate border); flow' = M^{-1} v
  where det(M) > 1e-9, else the prior flow;
- pyramid: 5-tap [1,4,6,4,1]/16 separable smooth + ::2 decimation
  (float); flow upsampled by pixel duplication x2 and scaled x2; levels
  clamped so the coarsest level is at least max(winsize, 2*poly_n+1) on
  both sides.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .filters import _taps


@lru_cache(maxsize=None)
def _poly_inv(n: int, sigma: float) -> Tuple[Tuple[float, ...], np.ndarray]:
    """Gaussian applicability taps and the 6x6 normal-equation inverse.

    Returns (g taps as python floats, G^{-1} float64 [6, 6]). Basis order:
    1, x, y, x^2, y^2, xy (x = column offset, y = row offset)."""
    t = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(t * t) / (2.0 * sigma * sigma))
    xx, yy = np.meshgrid(t, t)  # [2n+1, 2n+1]
    w = np.outer(g, g)
    basis = np.stack([
        np.ones_like(xx), xx, yy, xx * xx, yy * yy, xx * yy,
    ]).reshape(6, -1)
    G = (basis * w.reshape(1, -1)) @ basis.T
    return tuple(float(v) for v in g), np.linalg.inv(G)


def _sep(f: jax.Array, kx, ky, n: int) -> jax.Array:
    """Separable correlation with replicate border (float)."""
    return _taps(_taps(f, -1, kx, n), -2, ky, n)


def _poly_exp(f: jax.Array, n: int, sigma: float) -> jax.Array:
    """float32 plane (H, W) -> [5, H, W]: bx, by, axx, ayy, axy."""
    g, ginv = _poly_inv(n, sigma)
    t = np.arange(-n, n + 1, dtype=np.float64)
    gx = tuple(float(v) for v in np.asarray(g) * t)
    gxx = tuple(float(v) for v in np.asarray(g) * t * t)
    p = jnp.stack([
        _sep(f, g, g, n),      # <w f, 1>
        _sep(f, gx, g, n),     # <w f, x>
        _sep(f, g, gx, n),     # <w f, y>
        _sep(f, gxx, g, n),    # <w f, x^2>
        _sep(f, g, gxx, n),    # <w f, y^2>
        _sep(f, gx, gx, n),    # <w f, xy>
    ])
    inv = jnp.asarray(ginv[1:], dtype=jnp.float32)  # drop the constant row
    # HIGHEST: the device matrix unit's default bf16 einsum breaks f64-oracle
    # parity; this [5, 6] contraction is negligible either way
    return jnp.einsum("cp,phw->chw", inv, p,
                      precision=jax.lax.Precision.HIGHEST)


def _box(a: jax.Array, win: int) -> jax.Array:
    r = win // 2
    ones = (1.0,) * (2 * r + 1)
    return _taps(_taps(a, -1, ones, r), -2, ones, r)


def _sample_planes(planes: jax.Array, fx: jax.Array, fy: jax.Array) -> jax.Array:
    """Bilinear-sample [5, H, W] coefficient planes at (x + fx, y + fy),
    coordinates clamped to the image; one shared index set for all 5."""
    _, h, w = planes.shape
    xg = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    yg = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    cx = jnp.clip(xg + fx, 0.0, w - 1.0)
    cy = jnp.clip(yg + fy, 0.0, h - 1.0)
    x0 = jnp.clip(jnp.floor(cx).astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(jnp.floor(cy).astype(jnp.int32), 0, h - 2)
    ax = cx - x0.astype(jnp.float32)
    ay = cy - y0.astype(jnp.float32)
    flat = planes.reshape(5, h * w)
    base = (y0 * w + x0).reshape(-1)

    def take(off):
        return jnp.take(flat, base + off, axis=1).reshape(5, h, w)

    w00 = ((1 - ax) * (1 - ay))[None]
    w01 = (ax * (1 - ay))[None]
    w10 = ((1 - ax) * ay)[None]
    w11 = (ax * ay)[None]
    return (take(0) * w00 + take(1) * w01 +
            take(w) * w10 + take(w + 1) * w11)


def _flow_iter(p1: jax.Array, p2: jax.Array, fx: jax.Array, fy: jax.Array,
               win: int) -> Tuple[jax.Array, jax.Array]:
    s = _sample_planes(p2, fx, fy)
    a11 = 0.5 * (p1[2] + s[2])
    a22 = 0.5 * (p1[3] + s[3])
    a12 = 0.25 * (p1[4] + s[4])  # off-diagonal = axy/2, averaged
    r1 = -0.5 * (s[0] - p1[0]) + a11 * fx + a12 * fy
    r2 = -0.5 * (s[1] - p1[1]) + a12 * fx + a22 * fy
    g11 = _box(a11 * a11 + a12 * a12, win)
    g12 = _box(a12 * (a11 + a22), win)
    g22 = _box(a22 * a22 + a12 * a12, win)
    h1 = _box(a11 * r1 + a12 * r2, win)
    h2 = _box(a12 * r1 + a22 * r2, win)
    det = g11 * g22 - g12 * g12
    ok = jnp.abs(det) > 1e-9
    inv = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    nfx = (g22 * h1 - g12 * h2) * inv
    nfy = (g11 * h2 - g12 * h1) * inv
    return jnp.where(ok, nfx, fx), jnp.where(ok, nfy, fy)


def _down(f: jax.Array) -> jax.Array:
    k = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)
    return _sep(f, k, k, 2)[::2, ::2]


def _levels_for(h: int, w: int, levels: int, win: int, n: int) -> int:
    floor = max(win, 2 * n + 1)
    lv = 1
    while lv < levels and min(h, w) // (1 << lv) >= floor:
        lv += 1
    return lv


@partial(jax.jit, static_argnames=("levels", "winsize", "iterations",
                                   "poly_n", "poly_sigma"))
def farneback_flow(
    prev: jax.Array,
    next: jax.Array,
    levels: int = 3,
    winsize: int = 13,
    iterations: int = 3,
    poly_n: int = 5,
    poly_sigma: float = 1.1,
) -> jax.Array:
    """u8 gray pair (H, W) -> dense flow float32 (H, W, 2) [fx, fy]
    mapping prev -> next (prev(p) ~ next(p + flow(p)))."""
    h, w = prev.shape
    lv = _levels_for(h, w, levels, winsize, poly_n)
    f1 = prev.astype(jnp.float32)
    f2 = next.astype(jnp.float32)
    pyr = [(f1, f2)]
    for _ in range(lv - 1):
        f1, f2 = _down(f1), _down(f2)
        pyr.append((f1, f2))
    fx = fy = None
    for f1, f2 in reversed(pyr):
        lh, lw = f1.shape
        if fx is None:
            fx = jnp.zeros((lh, lw), jnp.float32)
            fy = jnp.zeros((lh, lw), jnp.float32)
        else:
            fx = (2.0 * jnp.repeat(jnp.repeat(fx, 2, 0), 2, 1))[:lh, :lw]
            fy = (2.0 * jnp.repeat(jnp.repeat(fy, 2, 0), 2, 1))[:lh, :lw]
            if fx.shape != (lh, lw):  # odd parent dims: replicate last row/col
                fx = jnp.pad(fx, ((0, lh - fx.shape[0]), (0, lw - fx.shape[1])),
                             mode="edge")
                fy = jnp.pad(fy, ((0, lh - fy.shape[0]), (0, lw - fy.shape[1])),
                             mode="edge")
        p1 = _poly_exp(f1, poly_n, poly_sigma)
        p2 = _poly_exp(f2, poly_n, poly_sigma)
        fx, fy = jax.lax.fori_loop(
            0, iterations,
            lambda _, c: _flow_iter(p1, p2, c[0], c[1], winsize),
            (fx, fy),
        )
    return jnp.stack([fx, fy], axis=-1)


# ---------------------------------------------------------------- oracle

def _poly_exp_np(f: np.ndarray, n: int, sigma: float) -> np.ndarray:
    g, ginv = _poly_inv(n, sigma)
    t = np.arange(-n, n + 1, dtype=np.float64)
    g = np.asarray(g)
    kern = {"g": g, "gx": g * t, "gxx": g * t * t}

    def corr(a, kx, ky):
        h, w = a.shape
        p = np.pad(a, n, mode="edge")
        acc = np.zeros((h, w))
        for dy in range(2 * n + 1):
            for dx in range(2 * n + 1):
                acc += ky[dy] * kx[dx] * p[dy:dy + h, dx:dx + w]
        return acc

    p = np.stack([
        corr(f, kern["g"], kern["g"]), corr(f, kern["gx"], kern["g"]),
        corr(f, kern["g"], kern["gx"]), corr(f, kern["gxx"], kern["g"]),
        corr(f, kern["g"], kern["gxx"]), corr(f, kern["gx"], kern["gx"]),
    ])
    return np.einsum("cp,phw->chw", ginv[1:], p.reshape(6, *f.shape))


def _box_np(a: np.ndarray, win: int) -> np.ndarray:
    r = win // 2
    h, w = a.shape
    p = np.pad(a, r, mode="edge")
    acc = np.zeros((h, w))
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            acc += p[dy:dy + h, dx:dx + w]
    return acc


def farneback_flow_numpy(
    prev: np.ndarray,
    next: np.ndarray,
    levels: int = 3,
    winsize: int = 13,
    iterations: int = 3,
    poly_n: int = 5,
    poly_sigma: float = 1.1,
) -> np.ndarray:
    """Oracle — same frozen spec in float64."""
    h, w = prev.shape
    lv = _levels_for(h, w, levels, winsize, poly_n)
    k = np.array([1, 4, 6, 4, 1], np.float64) / 16.0

    def down(f):
        hh, ww = f.shape
        p = np.pad(f, 2, mode="edge")
        acc = np.zeros((hh, ww))
        for dy in range(5):
            for dx in range(5):
                acc += k[dy] * k[dx] * p[dy:dy + hh, dx:dx + ww]
        return acc[::2, ::2]

    pyr = [(prev.astype(np.float64), next.astype(np.float64))]
    for _ in range(lv - 1):
        pyr.append((down(pyr[-1][0]), down(pyr[-1][1])))
    fx = fy = None
    for f1, f2 in reversed(pyr):
        lh, lw = f1.shape
        if fx is None:
            fx = np.zeros((lh, lw))
            fy = np.zeros((lh, lw))
        else:
            fx = (2.0 * np.repeat(np.repeat(fx, 2, 0), 2, 1))[:lh, :lw]
            fy = (2.0 * np.repeat(np.repeat(fy, 2, 0), 2, 1))[:lh, :lw]
            py, px = lh - fx.shape[0], lw - fx.shape[1]
            if py or px:
                fx = np.pad(fx, ((0, py), (0, px)), mode="edge")
                fy = np.pad(fy, ((0, py), (0, px)), mode="edge")
        p1 = _poly_exp_np(f1, poly_n, poly_sigma)
        p2 = _poly_exp_np(f2, poly_n, poly_sigma)
        for _ in range(iterations):
            xg, yg = np.meshgrid(np.arange(lw), np.arange(lh))
            cx = np.clip(xg + fx, 0.0, lw - 1.0)
            cy = np.clip(yg + fy, 0.0, lh - 1.0)
            x0 = np.clip(np.floor(cx).astype(np.int64), 0, lw - 2)
            y0 = np.clip(np.floor(cy).astype(np.int64), 0, lh - 2)
            ax, ay = cx - x0, cy - y0
            s = (p1 * 0.0)
            for c in range(5):
                pl = p2[c]
                s[c] = (pl[y0, x0] * (1 - ax) * (1 - ay)
                        + pl[y0, x0 + 1] * ax * (1 - ay)
                        + pl[y0 + 1, x0] * (1 - ax) * ay
                        + pl[y0 + 1, x0 + 1] * ax * ay)
            a11 = 0.5 * (p1[2] + s[2])
            a22 = 0.5 * (p1[3] + s[3])
            a12 = 0.25 * (p1[4] + s[4])
            r1 = -0.5 * (s[0] - p1[0]) + a11 * fx + a12 * fy
            r2 = -0.5 * (s[1] - p1[1]) + a12 * fx + a22 * fy
            g11 = _box_np(a11 * a11 + a12 * a12, winsize)
            g12 = _box_np(a12 * (a11 + a22), winsize)
            g22 = _box_np(a22 * a22 + a12 * a12, winsize)
            h1 = _box_np(a11 * r1 + a12 * r2, winsize)
            h2 = _box_np(a12 * r1 + a22 * r2, winsize)
            det = g11 * g22 - g12 * g12
            ok = np.abs(det) > 1e-9
            inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
            fx = np.where(ok, (g22 * h1 - g12 * h2) * inv, fx)
            fy = np.where(ok, (g11 * h2 - g12 * h1) * inv, fy)
    return np.stack([fx, fy], axis=-1).astype(np.float32)
