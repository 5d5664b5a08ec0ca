"""Semi-global stereo matching (OpenCV ``StereoSGBM`` role) — disparity
from a rectified L/R pair with smoothness-aware path aggregation.

The reference has no SGBM (its vision surface stops at capture); this is
an OpenCV-parity addition in the StereoBM family (ops/stereo.py), spec
frozen here with a float64/int64 NumPy oracle (:func:`stereo_sgbm_numpy`).

Device formulation
---------------
- Matching cost: Birchfield–Tomasi sampling-insensitive absolute
  difference on the clipped x-Sobel prefiltered images, box-summed over
  ``block_size`` — all elementwise/stacked, no gathers (the d-shift is a
  pad+slice like StereoBM's).
- Path aggregation is the SGM recurrence
  ``L_r(p,d) = C(p,d) + min(L_r(q,d), L_r(q,d±1)+P1, min_d' L_r(q)+P2)
  − min_d' L_r(q)`` run as a ``lax.scan`` along the scan axis,
  vectorized over the perpendicular axis AND the full disparity axis —
  one scan step touches an [M, D] slab, so the matrix unit-free inner loop is
  D-wide elementwise work, not a per-pixel Python loop. Horizontal/vertical
  paths scan columns/rows; the four diagonal paths are row scans whose
  carry is shifted one column per step (zero-filled — a zero carry IS
  the SGM border condition, since ``cand − minL`` vanishes).
- Winner-take-all, uniqueness, sub-pixel parabola and the left↔right
  consistency check are the same masked elementwise forms as StereoBM
  (dispR comes from the SAME aggregated volume: S(y, x+d, d), a
  pad+diagonal-slice, no second aggregation pass).

Frozen spec (oracle = :func:`stereo_sgbm_numpy`, int64/float64):
- prefilter: 3×3 Sobel-x (replicate border), ``tab = clip(g, ±cap) + cap``;
- cost: BT min-over-half-samples on the prefiltered pair, d-columns with
  ``x − d < 0`` sample the clamped column 0; box window ``block_size``;
- aggregation: ``num_dirs`` ∈ {4, 8} paths (H±, V± [+ 4 diagonals]),
  integer P1/P2, paths starting outside the image contribute ``C`` alone;
- disparity: argmin over D of the path sum (ties → smallest d);
- validity: uniqueness ``min2·100 ≥ min·(100+uniq)`` over ``|d−best|>1``,
  left-band columns ``x < D−1`` invalid, and (when ``disp12_max_diff ≥
  0``) ``|dL(x) − dR(x−dL)| ≤ disp12_max_diff`` with
  ``dR(x) = argmin_d S(y, x+d, d)``;
- sub-pixel: the BM parabola on S, clamped to ±0.5.

Defaults follow OpenCV: ``P1 = 8·block_size²``, ``P2 = 32·block_size²``
(single-channel), ``prefilter_cap = 63``. Invalid pixels carry 0/False.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

_BIG = 1 << 28


# ---------------------------------------------------------------------------
# shared spec pieces (numpy, int64) — the device twin mirrors each exactly
# ---------------------------------------------------------------------------

def _prefilter_numpy(img: np.ndarray, cap: int) -> np.ndarray:
    p = np.pad(img.astype(np.int64), 1, mode="edge")
    g = (p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:]
         - p[:-2, :-2] - 2 * p[1:-1, :-2] - p[2:, :-2])
    return np.clip(g, -cap, cap) + cap


def _bt_cost_numpy(lf: np.ndarray, rt: np.ndarray, d: int) -> np.ndarray:
    """BT cost of L(x) vs R(x−d), clamped sampling (int64)."""
    h, w = lf.shape
    rs = np.pad(rt, ((0, 0), (d, 0)), mode="edge")[:, :w]
    # half-sample neighbourhoods (replicate border)
    def half(a):
        pa = np.pad(a, ((0, 0), (1, 1)), mode="edge")
        lo = (pa[:, :-2] + a) // 2     # midpoint toward x−1 (floor)
        hi = (pa[:, 2:] + a) // 2      # midpoint toward x+1
        return np.minimum(np.minimum(lo, hi), a), np.maximum(np.maximum(lo, hi), a)
    lmin, lmax = half(lf)
    rmin, rmax = half(rs)
    a = np.maximum(0, np.maximum(lf - rmax, rmin - lf))
    b = np.maximum(0, np.maximum(rs - lmax, lmin - rs))
    return np.minimum(a, b)


def _box_numpy(a: np.ndarray, r: int) -> np.ndarray:
    h, w = a.shape
    p = np.pad(a, r, mode="edge")
    acc = np.zeros_like(a)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            acc = acc + p[dy:dy + h, dx:dx + w]
    return acc


def _cand_numpy(lp: np.ndarray, p1: int, p2: int) -> np.ndarray:
    """SGM transition term ``min(...) − minL`` for carry ``lp [..., D]``."""
    minl = lp.min(axis=-1, keepdims=True)
    up = np.concatenate([lp[..., 1:], np.full_like(lp[..., :1], _BIG)], -1)
    dn = np.concatenate([np.full_like(lp[..., :1], _BIG), lp[..., :-1]], -1)
    cand = np.minimum(np.minimum(lp, np.minimum(up, dn) + p1), minl + p2)
    return cand - minl


_DIRS4 = ((0, 1), (0, -1), (1, 0), (-1, 0))
_DIRS8 = _DIRS4 + ((1, 1), (1, -1), (-1, 1), (-1, -1))


def _aggregate_numpy(c: np.ndarray, p1: int, p2: int, dirs) -> np.ndarray:
    hh, ww, dd = c.shape
    s = np.zeros_like(c)
    for dy, dx in dirs:
        l = np.zeros_like(c)
        if dy == 0:
            xs = range(ww) if dx > 0 else range(ww - 1, -1, -1)
            for x in xs:
                px = x - dx
                if 0 <= px < ww:
                    l[:, x] = c[:, x] + _cand_numpy(l[:, px], p1, p2)
                else:
                    l[:, x] = c[:, x]
        else:
            ys = range(hh) if dy > 0 else range(hh - 1, -1, -1)
            for y in ys:
                py = y - dy
                if not (0 <= py < hh):
                    l[y] = c[y]
                    continue
                lp = l[py]
                if dx:
                    z = np.zeros_like(lp[:1])
                    lp = (np.concatenate([z, lp[:-1]], 0) if dx > 0
                          else np.concatenate([lp[1:], z], 0))
                l[y] = c[y] + _cand_numpy(lp, p1, p2)
        s += l
    return s


def stereo_sgbm_numpy(
    left: np.ndarray,
    right: np.ndarray,
    num_disparities: int = 64,
    block_size: int = 5,
    p1: int | None = None,
    p2: int | None = None,
    uniqueness: int = 10,
    disp12_max_diff: int = 1,
    num_dirs: int = 8,
    prefilter_cap: int = 63,
) -> Tuple[np.ndarray, np.ndarray]:
    """Oracle — the frozen spec above in int64/float64 NumPy."""
    if p1 is None:
        p1 = 8 * block_size * block_size
    if p2 is None:
        p2 = 32 * block_size * block_size
    h, w = left.shape
    r = block_size // 2
    lf = _prefilter_numpy(np.asarray(left), prefilter_cap)
    rt = _prefilter_numpy(np.asarray(right), prefilter_cap)
    c = np.stack([_box_numpy(_bt_cost_numpy(lf, rt, d), r)
                  for d in range(num_disparities)], axis=-1)  # [H,W,D]
    s = _aggregate_numpy(c, p1, p2, _DIRS8 if num_dirs == 8 else _DIRS4)

    best = s.argmin(axis=-1)
    smin = s.min(axis=-1)
    d_axis = np.arange(num_disparities)[None, None, :]
    masked = np.where(np.abs(d_axis - best[..., None]) <= 1, _BIG, s)
    second = masked.min(axis=-1)
    unique = second * 100 >= smin * (100 + uniqueness)
    xcol = np.arange(w)[None, :]
    valid = unique & (xcol >= num_disparities - 1)

    if disp12_max_diff >= 0:
        # dispR(y, x) = argmin_d S(y, x + d, d)
        sp = np.pad(s, ((0, 0), (0, num_disparities), (0, 0)),
                    constant_values=_BIG)
        ii, jj, kk = np.ogrid[0:h, 0:w, 0:num_disparities]
        sr = sp[ii, jj + kk, kk]
        disp_r = sr.argmin(axis=-1)
        xr = np.clip(xcol - best, 0, w - 1)
        dr_at = disp_r[np.arange(h)[:, None], xr]
        valid &= np.abs(best - dr_at) <= disp12_max_diff

    dm1 = np.clip(best - 1, 0, num_disparities - 1)
    dp1c = np.clip(best + 1, 0, num_disparities - 1)
    ii, jj = np.mgrid[0:h, 0:w]
    cm = s[ii, jj, dm1].astype(np.float64)
    cp = s[ii, jj, dp1c].astype(np.float64)
    c0 = smin.astype(np.float64)
    denom = cm - 2.0 * c0 + cp
    frac = np.where(
        (best > 0) & (best < num_disparities - 1) & (denom > 0),
        np.clip((cm - cp) / (2.0 * np.maximum(denom, 1e-9)), -0.5, 0.5),
        0.0,
    )
    disp = np.where(valid, best + frac, 0.0).astype(np.float32)
    return disp, valid


# ---------------------------------------------------------------------------
# device twin (int32 costs, float32 sub-pixel)
# ---------------------------------------------------------------------------

def _prefilter(img: jax.Array, cap: int) -> jax.Array:
    p = jnp.pad(img.astype(jnp.int32), 1, mode="edge")
    g = (p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:]
         - p[:-2, :-2] - 2 * p[1:-1, :-2] - p[2:, :-2])
    return jnp.clip(g, -cap, cap) + cap


def _bt_cost(lf: jax.Array, rt: jax.Array, d: int) -> jax.Array:
    h, w = lf.shape
    rs = jnp.pad(rt, ((0, 0), (d, 0)), mode="edge")[:, :w]

    def half(a):
        pa = jnp.pad(a, ((0, 0), (1, 1)), mode="edge")
        lo = (pa[:, :-2] + a) // 2
        hi = (pa[:, 2:] + a) // 2
        return (jnp.minimum(jnp.minimum(lo, hi), a),
                jnp.maximum(jnp.maximum(lo, hi), a))

    lmin, lmax = half(lf)
    rmin, rmax = half(rs)
    a = jnp.maximum(0, jnp.maximum(lf - rmax, rmin - lf))
    b = jnp.maximum(0, jnp.maximum(rs - lmax, lmin - rs))
    return jnp.minimum(a, b)


def _box(a: jax.Array, r: int) -> jax.Array:
    from .filters import _taps
    ones = (1,) * (2 * r + 1)
    return _taps(_taps(a, -1, ones, r), -2, ones, r)


def _cand(lp: jax.Array, p1: int, p2: int) -> jax.Array:
    minl = lp.min(axis=-1, keepdims=True)
    big = jnp.full_like(lp[..., :1], _BIG)
    up = jnp.concatenate([lp[..., 1:], big], -1)
    dn = jnp.concatenate([big, lp[..., :-1]], -1)
    cand = jnp.minimum(jnp.minimum(lp, jnp.minimum(up, dn) + p1), minl + p2)
    return cand - minl


def _scan_dir(c: jax.Array, axis: int, reverse: bool, shift: int,
              p1: int, p2: int) -> jax.Array:
    """One SGM path over cost volume ``c [H, W, D]``.

    ``axis`` is the scan axis (0 rows / 1 cols); ``shift`` (row scans
    only) rolls the carry one column per step for the diagonal paths —
    the zero-filled entering column is exactly the SGM border condition.
    """
    a = jnp.flip(c, axis) if reverse else c
    a = jnp.moveaxis(a, axis, 0)  # [N, M, D]

    def step(lp, cx):
        if shift:
            z = jnp.zeros_like(lp[:1])
            lp = (jnp.concatenate([z, lp[:-1]], 0) if shift > 0
                  else jnp.concatenate([lp[1:], z], 0))
        ln = cx + _cand(lp, p1, p2)
        return ln, ln

    # first step must see a zero carry (border → L = C): zeros init works
    # because cand(0) − minL(0) ≡ 0.
    _, ls = lax.scan(step, jnp.zeros_like(a[0]), a)
    out = jnp.moveaxis(ls, 0, axis)
    return jnp.flip(out, axis) if reverse else out


# (axis, reverse, carry-shift): H±, V±, then the four diagonals
_DEV_DIRS4 = ((1, False, 0), (1, True, 0), (0, False, 0), (0, True, 0))
_DEV_DIRS8 = _DEV_DIRS4 + ((0, False, 1), (0, False, -1),
                           (0, True, 1), (0, True, -1))


@partial(jax.jit, static_argnames=("num_disparities", "block_size", "p1",
                                   "p2", "uniqueness", "disp12_max_diff",
                                   "num_dirs", "prefilter_cap"))
def stereo_sgbm(
    left: jax.Array,
    right: jax.Array,
    num_disparities: int = 64,
    block_size: int = 5,
    p1: int | None = None,
    p2: int | None = None,
    uniqueness: int = 10,
    disp12_max_diff: int = 1,
    num_dirs: int = 8,
    prefilter_cap: int = 63,
):
    """u8 rectified pair (H, W) → (disparity float32 (H, W), valid bool).

    Device twin of :func:`stereo_sgbm_numpy` — integer pipeline is exact,
    sub-pixel fraction is float32 vs the oracle's float64.
    """
    if p1 is None:
        p1 = 8 * block_size * block_size
    if p2 is None:
        p2 = 32 * block_size * block_size
    h, w = left.shape
    r = block_size // 2
    lf = _prefilter(left, prefilter_cap)
    rt = _prefilter(right, prefilter_cap)
    c = jnp.stack([_box(_bt_cost(lf, rt, d), r)
                   for d in range(num_disparities)], axis=-1)  # [H,W,D]

    dirs = _DEV_DIRS8 if num_dirs == 8 else _DEV_DIRS4
    s = c - c  # zeros_like, keeps dtype
    for axis, rev, shift in dirs:
        s = s + _scan_dir(c, axis, rev, shift, p1, p2)

    best = jnp.argmin(s, axis=-1).astype(jnp.int32)
    smin = jnp.min(s, axis=-1)
    d_axis = jnp.arange(num_disparities)[None, None, :]
    masked = jnp.where(jnp.abs(d_axis - best[..., None]) <= 1, _BIG, s)
    second = jnp.min(masked, axis=-1)
    unique = second * 100 >= smin * (100 + uniqueness)
    xcol = jnp.arange(w)[None, :]
    valid = unique & (xcol >= num_disparities - 1)

    if disp12_max_diff >= 0:
        sp = jnp.pad(s, ((0, 0), (0, num_disparities), (0, 0)),
                     constant_values=_BIG)
        # S(y, x+d, d) without a gather: d static slices along W
        sr = jnp.stack([lax.dynamic_slice_in_dim(sp[..., d], d, w, axis=1)
                        for d in range(num_disparities)], axis=-1)
        disp_r = jnp.argmin(sr, axis=-1).astype(jnp.int32)
        # dR at x − dL: one-hot row matmul would be D-wide; the shift is
        # per-pixel so use take_along_axis on the W axis (bounded, small)
        xr = jnp.clip(xcol - best, 0, w - 1)
        dr_at = jnp.take_along_axis(disp_r, xr, axis=1)
        valid = valid & (jnp.abs(best - dr_at) <= disp12_max_diff)

    pm = (d_axis == jnp.clip(best - 1, 0, num_disparities - 1)[..., None])
    pp = (d_axis == jnp.clip(best + 1, 0, num_disparities - 1)[..., None])
    cm = jnp.sum(jnp.where(pm, s, 0), axis=-1).astype(jnp.float32)
    cp = jnp.sum(jnp.where(pp, s, 0), axis=-1).astype(jnp.float32)
    c0 = smin.astype(jnp.float32)
    denom = cm - 2.0 * c0 + cp
    frac = jnp.where(
        (best > 0) & (best < num_disparities - 1) & (denom > 0),
        jnp.clip((cm - cp) / (2.0 * jnp.maximum(denom, 1e-9)), -0.5, 0.5),
        0.0,
    )
    disp = jnp.where(valid, best.astype(jnp.float32) + frac, 0.0)
    return disp, valid
