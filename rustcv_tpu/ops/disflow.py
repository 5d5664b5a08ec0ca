"""DIS dense optical flow (OpenCV ``DISOpticalFlow`` role, Kroeger et
al. 2016: Dense Inverse Search) — the modern default dense flow,
complementing Farneback (ops/farneback.py) and pyramidal LK
(ops/optflow.py).

Device formulation:
- Inverse search is per-PATCH, and every pixel of a patch shares the
  patch's translation — so the warped-patch sample is ONE
  ``dynamic_slice`` at the integer part + four static-offset slices
  lerped by the shared fraction (the LK shared-fraction lesson: no
  gather tables). Patches vmap over the grid; the Gauss-Newton loop is
  a ``lax.fori_loop`` with the inverse-compositional Hessian
  precomputed per patch.
- Densification samples I1 at per-pixel displaced coordinates — a true
  per-pixel gather (like remap); each pixel blends the ≤4 covering
  patches' flows by inverse residual weight.

Frozen spec (float64 oracle :func:`dis_flow_numpy`):
- images → [0,1] floats; pyramid = 5-tap binomial blur + ``[::2]``
  decimation, coarsest level has min dim ≥ 16, processing stops at
  ``finest_scale`` (default 1 = half resolution; the last flow
  upsamples ×2 per remaining level with values ×2);
- per level: patches ``patch_size`` = 8 on a ``stride`` = 4 grid
  (grid positions clamped so patches stay inside); per patch
  ``iters`` = 8 inverse-compositional Gauss-Newton steps on
  ``Σ (I1(x+u) − I0(x))²`` with H from I0 central-difference
  gradients (+1e-6 diagonal), u clamped to ±patch_size drift from its
  init; out-of-image samples clamp (edge);
- densification: pixel flow = Σ_p w_p·u_p / Σ w_p over covering
  patches, ``w_p = 1 / max(1e-4, (I1(x+u_p) − I0(x))²)``;
- no variational refinement (OpenCV's is optional; documented
  divergence — compose with Farneback for smoothness-regularized
  fields).

Returns flow [H, W, 2] float32 (u = x-displacement, v = y) mapping
I0 → I1: ``I1(x + u(x)) ≈ I0(x)``.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

PATCH = 8
STRIDE = 4


def _blur_dec(a, xp):
    t = np.array([1, 4, 6, 4, 1], np.float64) / 16.0
    if xp is not np:
        t = t.astype(np.float32)
    p = xp.pad(a, ((0, 0), (2, 2)), mode="edge")
    out = sum(t[k] * p[:, k:k + a.shape[1]] for k in range(5))
    p = xp.pad(out, ((2, 2), (0, 0)), mode="edge")
    out = sum(t[k] * p[k:k + a.shape[0], :] for k in range(5))
    return out[::2, ::2]


def _grad(a, xp):
    p = xp.pad(a, 1, mode="edge")
    gx = (p[1:-1, 2:] - p[1:-1, :-2]) * 0.5
    gy = (p[2:, 1:-1] - p[:-2, 1:-1]) * 0.5
    return gx, gy


def _grid(h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    ys = np.arange(0, max(h - PATCH, 0) + 1, STRIDE)
    xs = np.arange(0, max(w - PATCH, 0) + 1, STRIDE)
    if ys[-1] != h - PATCH:
        ys = np.append(ys, h - PATCH)
    if xs[-1] != w - PATCH:
        xs = np.append(xs, w - PATCH)
    return ys, xs


def _sample_patch_np(img, oy, ox):
    """8×8 bilinear window at float origin (edge clamp)."""
    h, w = img.shape
    y0 = int(np.floor(oy))
    x0 = int(np.floor(ox))
    fy = oy - y0
    fx = ox - x0

    def win(dy, dx):
        yy = np.clip(y0 + dy + np.arange(PATCH), 0, h - 1)
        xx = np.clip(x0 + dx + np.arange(PATCH), 0, w - 1)
        return img[np.ix_(yy, xx)]

    return (win(0, 0) * (1 - fy) * (1 - fx) + win(0, 1) * (1 - fy) * fx
            + win(1, 0) * fy * (1 - fx) + win(1, 1) * fy * fx)


def _bilinear_np(img, ys, xs):
    h, w = img.shape
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)
    fx = np.clip(xs - x0, 0.0, 1.0)
    return (img[y0, x0] * (1 - fy) * (1 - fx) + img[y0, x1] * (1 - fy) * fx
            + img[y1, x0] * fy * (1 - fx) + img[y1, x1] * fy * fx)


def _level_np(i0, i1, flow_init, iters):
    h, w = i0.shape
    gx, gy = _grad(i0, np)
    ys, xs = _grid(h, w)
    n_py, n_px = len(ys), len(xs)
    u = np.zeros((n_py, n_px, 2))
    for a, oy in enumerate(ys):
        for b, ox in enumerate(xs):
            p0 = i0[oy:oy + PATCH, ox:ox + PATCH]
            jx = gx[oy:oy + PATCH, ox:ox + PATCH]
            jy = gy[oy:oy + PATCH, ox:ox + PATCH]
            hxx = (jx * jx).sum() + 1e-6
            hyy = (jy * jy).sum() + 1e-6
            hxy = (jx * jy).sum()
            det = hxx * hyy - hxy * hxy
            cy, cx = oy + PATCH // 2, ox + PATCH // 2
            u0 = flow_init[cy, cx].copy()
            uv = u0.copy()
            for _ in range(iters):
                wp = _sample_patch_np(i1, oy + uv[1], ox + uv[0])
                r = wp - p0
                bx = (jx * r).sum()
                by = (jy * r).sum()
                du = np.array([(hyy * bx - hxy * by) / det,
                               (hxx * by - hxy * bx) / det])
                uv = uv - du
                drift = uv - u0
                uv = u0 + np.clip(drift, -PATCH, PATCH)
            u[a, b] = uv
    # densification
    ygrid, xgrid = np.mgrid[0:h, 0:w].astype(np.float64)
    num = np.zeros((h, w, 2))
    den = np.zeros((h, w))
    for a, oy in enumerate(ys):
        for b, ox in enumerate(xs):
            sl = np.s_[oy:oy + PATCH, ox:ox + PATCH]
            uv = u[a, b]
            samp = _bilinear_np(i1, ygrid[sl] + uv[1], xgrid[sl] + uv[0])
            wgt = 1.0 / np.maximum((samp - i0[sl]) ** 2, 1e-4)
            num[sl] += wgt[..., None] * uv
            den[sl] += wgt
    return num / den[..., None]


def dis_flow_numpy(img0: np.ndarray, img1: np.ndarray,
                   finest_scale: int = 1, iters: int = 8) -> np.ndarray:
    """Oracle — float64. u8 gray pair → flow float32 [H, W, 2]."""
    i0 = np.asarray(img0, np.float64) / 255.0
    i1 = np.asarray(img1, np.float64) / 255.0
    h, w = i0.shape
    p0s, p1s = [i0], [i1]
    while min(p0s[-1].shape) >= 32:
        p0s.append(_blur_dec(p0s[-1], np))
        p1s.append(_blur_dec(p1s[-1], np))
    flow = np.zeros(p0s[-1].shape + (2,))
    for lv in range(len(p0s) - 1, finest_scale - 1, -1):
        flow = _level_np(p0s[lv], p1s[lv], flow, iters)
        if lv > finest_scale:
            hh, ww = p0s[lv - 1].shape
            up = np.repeat(np.repeat(flow, 2, 0), 2, 1)[:hh, :ww] * 2.0
            flow = up
    for _ in range(finest_scale):
        hh = min(flow.shape[0] * 2, h)
        ww = min(flow.shape[1] * 2, w)
        flow = np.repeat(np.repeat(flow, 2, 0), 2, 1)[:h, :w] * 2.0
    return flow[:h, :w].astype(np.float32)


# ---------------------------------------------------------------------------
# device twin
# ---------------------------------------------------------------------------

def _level_j(i0, i1, flow_init, iters):
    h, w = i0.shape
    p = jnp.pad(i0, 1, mode="edge")
    gx = (p[1:-1, 2:] - p[1:-1, :-2]) * 0.5
    gy = (p[2:, 1:-1] - p[:-2, 1:-1]) * 0.5
    # edge-pad I1 so the shared-fraction patch sample reads replicate
    # values out of range — EXACTLY the oracle's per-index clamp; the
    # pad must exceed init-flow + drift excursions (init can carry
    # multi-patch motion down from the pyramid top)
    _PAD1 = 4 * PATCH
    i1p = jnp.pad(i1, _PAD1, mode="edge")
    ys, xs = _grid(h, w)
    oys, oxs = np.meshgrid(ys, xs, indexing="ij")
    oys_f = jnp.asarray(oys.ravel())
    oxs_f = jnp.asarray(oxs.ravel())

    def solve_patch(oy, ox):
        p0 = lax.dynamic_slice(i0, (oy, ox), (PATCH, PATCH))
        jx = lax.dynamic_slice(gx, (oy, ox), (PATCH, PATCH))
        jy = lax.dynamic_slice(gy, (oy, ox), (PATCH, PATCH))
        hxx = (jx * jx).sum() + 1e-6
        hyy = (jy * jy).sum() + 1e-6
        hxy = (jx * jy).sum()
        det = hxx * hyy - hxy * hxy
        u0 = flow_init[oy + PATCH // 2, ox + PATCH // 2]

        def sample(uy, ux):
            fy0 = jnp.floor(oy + uy)
            fx0 = jnp.floor(ox + ux)
            iy = jnp.clip(fy0 + _PAD1, 0,
                          h + 2 * _PAD1 - PATCH - 1).astype(jnp.int32)
            ix = jnp.clip(fx0 + _PAD1, 0,
                          w + 2 * _PAD1 - PATCH - 1).astype(jnp.int32)
            fy = jnp.clip(oy + uy - fy0, 0.0, 1.0)
            fx = jnp.clip(ox + ux - fx0, 0.0, 1.0)
            big = lax.dynamic_slice(i1p, (iy, ix), (PATCH + 1, PATCH + 1))
            return (big[:-1, :-1] * (1 - fy) * (1 - fx)
                    + big[:-1, 1:] * (1 - fy) * fx
                    + big[1:, :-1] * fy * (1 - fx)
                    + big[1:, 1:] * fy * fx)

        def body(_, uv):
            wp = sample(uv[1], uv[0])
            r = wp - p0
            bx = (jx * r).sum()
            by = (jy * r).sum()
            du = jnp.stack([(hyy * bx - hxy * by) / det,
                            (hxx * by - hxy * bx) / det])
            uv2 = uv - du
            return u0 + jnp.clip(uv2 - u0, -PATCH, PATCH)

        return lax.fori_loop(0, iters, body, u0)

    u = jax.vmap(solve_patch)(oys_f, oxs_f)            # [P, 2]

    # densification — per-pixel gathers of I1 at displaced coords
    ygrid, xgrid = jnp.mgrid[0:h, 0:w]
    ygrid = ygrid.astype(jnp.float32)
    xgrid = xgrid.astype(jnp.float32)

    def bilinear(imf, yy, xx):
        y0 = jnp.clip(jnp.floor(yy), 0, h - 1).astype(jnp.int32)
        x0 = jnp.clip(jnp.floor(xx), 0, w - 1).astype(jnp.int32)
        y1 = jnp.minimum(y0 + 1, h - 1)
        x1 = jnp.minimum(x0 + 1, w - 1)
        fy = jnp.clip(yy - y0, 0.0, 1.0)
        fx = jnp.clip(xx - x0, 0.0, 1.0)
        flat = imf.reshape(-1)
        g = lambda a, b: jnp.take(flat, a * w + b)
        return (g(y0, x0) * (1 - fy) * (1 - fx) + g(y0, x1) * (1 - fy) * fx
                + g(y1, x0) * fy * (1 - fx) + g(y1, x1) * fy * fx)

    # lax.scan over patches, NOT a Python unroll: the unrolled form
    # emitted ~2 300 scatter-adds per pyramid level and took XLA >5 min
    # to compile (same trap as meanshift);
    # the scan accumulates in the identical (a, b) order, so results
    # are bit-identical, and compiles in seconds.
    num = jnp.zeros((h, w, 2), jnp.float32)
    den = jnp.zeros((h, w), jnp.float32)
    n_px = len(xs)
    oy_all = jnp.asarray(np.repeat(np.asarray(ys, np.int32), n_px))
    ox_all = jnp.asarray(np.tile(np.asarray(xs, np.int32), len(ys)))

    def dens_step(carry, inp):
        nm, dn = carry
        oy, ox, uv = inp
        yy = lax.dynamic_slice(ygrid, (oy, ox), (PATCH, PATCH)) + uv[1]
        xx = lax.dynamic_slice(xgrid, (oy, ox), (PATCH, PATCH)) + uv[0]
        samp = bilinear(i1, yy, xx)
        p0sl = lax.dynamic_slice(i0, (oy, ox), (PATCH, PATCH))
        wgt = 1.0 / jnp.maximum((samp - p0sl) ** 2, 1e-4)
        cur_n = lax.dynamic_slice(nm, (oy, ox, 0), (PATCH, PATCH, 2))
        nm = lax.dynamic_update_slice(
            nm, cur_n + wgt[..., None] * uv, (oy, ox, jnp.int32(0)))
        cur_d = lax.dynamic_slice(dn, (oy, ox), (PATCH, PATCH))
        dn = lax.dynamic_update_slice(dn, cur_d + wgt, (oy, ox))
        return (nm, dn), None

    (num, den), _ = lax.scan(dens_step, (num, den), (oy_all, ox_all, u))
    return num / den[..., None]


@partial(jax.jit, static_argnames=("finest_scale", "iters"))
def dis_flow(img0: jax.Array, img1: jax.Array, finest_scale: int = 1,
             iters: int = 8) -> jax.Array:
    """Device twin — f32; flows match the oracle to ~1e-2 px on
    well-conditioned scenes."""
    i0 = img0.astype(jnp.float32) / 255.0
    i1 = img1.astype(jnp.float32) / 255.0
    h, w = i0.shape
    p0s, p1s = [i0], [i1]
    while min(p0s[-1].shape) >= 32:
        p0s.append(_blur_dec(p0s[-1], jnp))
        p1s.append(_blur_dec(p1s[-1], jnp))
    flow = jnp.zeros(p0s[-1].shape + (2,), jnp.float32)
    for lv in range(len(p0s) - 1, finest_scale - 1, -1):
        flow = _level_j(p0s[lv], p1s[lv], flow, iters)
        if lv > finest_scale:
            hh, ww = p0s[lv - 1].shape
            flow = jnp.repeat(jnp.repeat(flow, 2, 0), 2, 1)[:hh, :ww] * 2.0
    for _ in range(finest_scale):
        flow = jnp.repeat(jnp.repeat(flow, 2, 0), 2, 1)[:h, :w] * 2.0
    return flow[:h, :w]
