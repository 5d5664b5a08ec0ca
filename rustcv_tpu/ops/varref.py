"""Variational flow refinement (OpenCV ``VariationalRefinement`` role,
Brox et al. 2004 energy): polish an initial dense flow field with a
robust brightness-constancy data term + gradient-constancy term and
Charbonnier-smoothed total-variation regularization.

Frozen spec (float64 oracle):
- warp I1 by the current flow (bilinear, border clamp) once per outer
  (fixed-point) iteration; linearize brightness constancy around it:
  ``ρ(du, dv) = I_t + I_x·du + I_y·dv`` with I_x/I_y the averaged
  central-difference gradients of warped I1 and I0;
- gradient constancy: same linearization per gradient channel;
- robust weights ``ψ'(s²) = 1/√(s² + ε²)`` (ε = 1e-3) recomputed each
  inner iteration for the data term and for the smoothness term (edges
  between 4-neighbors);
- the Euler-Lagrange system is solved by ``sor_iterations`` red-black
  SOR sweeps (ω = 1.6) for the flow INCREMENT (du, dv), which is added
  to the flow after each of ``fixed_point_iterations`` outer rounds;
- intensities scaled to [0,1]; delta (brightness) and gamma (gradient)
  weigh the data terms, alpha the smoothness — defaults 5/10/20 as in
  OpenCV.

cv2's implementation differs in discretization details, so outputs are
not bit-equal; tests pin (a) end-point-error reduction of a noisy flow
on ground-truth scenes and (b) EPE within 1.5× of
cv2.VariationalRefinement on the same inputs.

Device formulation: the whole refinement is ONE jitted program — outer
fori_loop over fixed-point rounds, inner fori_loop over SOR sweeps,
red-black via checkerboard masks (pure elementwise), warp via the
shared-fraction bilinear gather used by DIS/Farneback.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

EPS2 = 1e-6
OMEGA = 1.6


def _warp_np(img: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    h, w = img.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    x = np.clip(xs + u, 0.0, w - 1.0)
    y = np.clip(ys + v, 0.0, h - 1.0)
    x0 = np.clip(np.floor(x).astype(np.int64), 0, w - 2)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, h - 2)
    fx = x - x0
    fy = y - y0
    a = img[y0, x0]
    b = img[y0, x0 + 1]
    c = img[y0 + 1, x0]
    d = img[y0 + 1, x0 + 1]
    return (a * (1 - fx) * (1 - fy) + b * fx * (1 - fy)
            + c * (1 - fx) * fy + d * fx * fy)


def _cgrad_np(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    gx = np.zeros_like(img)
    gy = np.zeros_like(img)
    gx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    gy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    return gx, gy


def variational_refine_numpy(i0: np.ndarray, i1: np.ndarray,
                             flow: np.ndarray, alpha: float = 20.0,
                             delta: float = 5.0, gamma: float = 10.0,
                             fixed_point_iterations: int = 5,
                             sor_iterations: int = 5) -> np.ndarray:
    """Oracle — flow (H, W, 2) float refined against u8/float frames."""
    f0 = np.asarray(i0, np.float64) / 255.0
    f1 = np.asarray(i1, np.float64) / 255.0
    u = np.asarray(flow[..., 0], np.float64).copy()
    v = np.asarray(flow[..., 1], np.float64).copy()
    h, w = f0.shape
    g0x, g0y = _cgrad_np(f0)

    for _ in range(fixed_point_iterations):
        wrp = _warp_np(f1, u, v)
        w1x, w1y = _cgrad_np(wrp)
        ix = 0.5 * (g0x + w1x)
        iy = 0.5 * (g0y + w1y)
        it = wrp - f0
        # gradient-constancy channels (linearized with second derivs)
        ixx, ixy = _cgrad_np(ix)
        iyx, iyy = _cgrad_np(iy)
        itx = w1x - g0x
        ity = w1y - g0y

        du = np.zeros((h, w))
        dv = np.zeros((h, w))
        yy, xx = np.mgrid[0:h, 0:w]
        red = ((yy + xx) % 2) == 0
        for _ in range(sor_iterations):
            # robust data weight
            r = it + ix * du + iy * dv
            rgx = itx + ixx * du + ixy * dv
            rgy = ity + iyx * du + iyy * dv
            psi_d = delta / np.sqrt(r * r + EPS2)
            psi_g = gamma / np.sqrt(rgx * rgx + rgy * rgy + EPS2)
            # smoothness weights on the CURRENT total flow
            uu = u + du
            vv = v + dv
            ugx, ugy = _cgrad_np(uu)
            vgx, vgy = _cgrad_np(vv)
            psi_s = alpha / np.sqrt(ugx ** 2 + ugy ** 2 + vgx ** 2
                                    + vgy ** 2 + EPS2)

            a11 = psi_d * ix * ix + psi_g * (ixx ** 2 + iyx ** 2)
            a12 = psi_d * ix * iy + psi_g * (ixx * ixy + iyx * iyy)
            a22 = psi_d * iy * iy + psi_g * (ixy ** 2 + iyy ** 2)
            b1 = -(psi_d * ix * it + psi_g * (ixx * itx + iyx * ity))
            b2 = -(psi_d * iy * it + psi_g * (ixy * itx + iyy * ity))

            for phase in (red, ~red):
                ngh_w = np.zeros((h, w))
                su = np.zeros((h, w))
                sv = np.zeros((h, w))
                for dy_, dx_ in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                    wgt = np.zeros((h, w))
                    nu = np.zeros((h, w))
                    nv = np.zeros((h, w))
                    ys0 = slice(max(dy_, 0), h + min(dy_, 0))
                    xs0 = slice(max(dx_, 0), w + min(dx_, 0))
                    yd = slice(max(-dy_, 0), h + min(-dy_, 0))
                    xd = slice(max(-dx_, 0), w + min(-dx_, 0))
                    wgt[yd, xd] = psi_s[ys0, xs0] + psi_s[yd, xd]
                    nu[yd, xd] = (u + du)[ys0, xs0]
                    nv[yd, xd] = (v + dv)[ys0, xs0]
                    ngh_w += 0.5 * wgt
                    su += 0.5 * wgt * nu
                    sv += 0.5 * wgt * nv
                diag_u = a11 + ngh_w
                diag_v = a22 + ngh_w
                new_du = (b1 + su - ngh_w * u - a12 * dv) / diag_u
                new_dv = (b2 + sv - ngh_w * v - a12 * new_du) / diag_v
                du = np.where(phase, (1 - OMEGA) * du + OMEGA * new_du,
                              du)
                dv = np.where(phase, (1 - OMEGA) * dv + OMEGA * new_dv,
                              dv)
        u = u + du
        v = v + dv
    return np.stack([u, v], axis=-1)


def _warp_jx(img, u, v):
    h, w = img.shape
    ys, xs = jnp.mgrid[0:h, 0:w]
    x = jnp.clip(xs + u, 0.0, w - 1.0)
    y = jnp.clip(ys + v, 0.0, h - 1.0)
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, h - 2)
    fx = x - x0
    fy = y - y0
    flat = img.ravel()

    def at(yy, xx):
        return flat[yy * w + xx]

    a = at(y0, x0)
    b = at(y0, x0 + 1)
    c = at(y0 + 1, x0)
    d = at(y0 + 1, x0 + 1)
    return (a * (1 - fx) * (1 - fy) + b * fx * (1 - fy)
            + c * (1 - fx) * fy + d * fx * fy)


def _cgrad_jx(img):
    gx = jnp.pad(0.5 * (img[:, 2:] - img[:, :-2]), ((0, 0), (1, 1)))
    gy = jnp.pad(0.5 * (img[2:, :] - img[:-2, :]), ((1, 1), (0, 0)))
    return gx, gy


@partial(jax.jit, static_argnames=("alpha", "delta", "gamma",
                                   "fixed_point_iterations",
                                   "sor_iterations"))
def variational_refine(i0: jax.Array, i1: jax.Array, flow: jax.Array,
                       alpha: float = 20.0, delta: float = 5.0,
                       gamma: float = 10.0,
                       fixed_point_iterations: int = 5,
                       sor_iterations: int = 5) -> jax.Array:
    """Device twin — one jitted program (same spec, f32)."""
    f0 = i0.astype(jnp.float32) / 255.0
    f1 = i1.astype(jnp.float32) / 255.0
    u0 = flow[..., 0].astype(jnp.float32)
    v0 = flow[..., 1].astype(jnp.float32)
    h, w = f0.shape
    g0x, g0y = _cgrad_jx(f0)
    yy, xx = jnp.mgrid[0:h, 0:w]
    red = ((yy + xx) % 2) == 0

    def shift(a, dy_, dx_):
        p = jnp.pad(a, ((1, 1), (1, 1)))
        return jax.lax.dynamic_slice(p, (1 + dy_, 1 + dx_), (h, w))

    def outer(_, uv):
        u, v = uv
        wrp = _warp_jx(f1, u, v)
        w1x, w1y = _cgrad_jx(wrp)
        ix = 0.5 * (g0x + w1x)
        iy = 0.5 * (g0y + w1y)
        it = wrp - f0
        ixx, ixy = _cgrad_jx(ix)
        iyx, iyy = _cgrad_jx(iy)
        itx = w1x - g0x
        ity = w1y - g0y

        def inner(_, d):
            du, dv = d
            r = it + ix * du + iy * dv
            rgx = itx + ixx * du + ixy * dv
            rgy = ity + iyx * du + iyy * dv
            psi_d = delta / jnp.sqrt(r * r + EPS2)
            psi_g = gamma / jnp.sqrt(rgx * rgx + rgy * rgy + EPS2)
            uu = u + du
            vv = v + dv
            ugx, ugy = _cgrad_jx(uu)
            vgx, vgy = _cgrad_jx(vv)
            psi_s = alpha / jnp.sqrt(ugx ** 2 + ugy ** 2 + vgx ** 2
                                     + vgy ** 2 + EPS2)
            a11 = psi_d * ix * ix + psi_g * (ixx ** 2 + iyx ** 2)
            a12 = psi_d * ix * iy + psi_g * (ixx * ixy + iyx * iyy)
            a22 = psi_d * iy * iy + psi_g * (ixy ** 2 + iyy ** 2)
            b1 = -(psi_d * ix * it + psi_g * (ixx * itx + iyx * ity))
            b2 = -(psi_d * iy * it + psi_g * (ixy * itx + iyy * ity))

            def sweep(d2, phase):
                du_, dv_ = d2
                ngh_w = jnp.zeros((h, w), jnp.float32)
                su = jnp.zeros((h, w), jnp.float32)
                sv = jnp.zeros((h, w), jnp.float32)
                for dy_, dx_ in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                    wgt = shift(psi_s, dy_, dx_) + psi_s
                    inside = shift(jnp.ones((h, w), jnp.float32),
                                   dy_, dx_)
                    wgt = wgt * inside
                    ngh_w = ngh_w + 0.5 * wgt
                    su = su + 0.5 * wgt * shift(u + du_, dy_, dx_)
                    sv = sv + 0.5 * wgt * shift(v + dv_, dy_, dx_)
                diag_u = a11 + ngh_w
                diag_v = a22 + ngh_w
                new_du = (b1 + su - ngh_w * u - a12 * dv_) / diag_u
                new_dv = (b2 + sv - ngh_w * v - a12 * new_du) / diag_v
                du_ = jnp.where(phase, (1 - OMEGA) * du_
                                + OMEGA * new_du, du_)
                dv_ = jnp.where(phase, (1 - OMEGA) * dv_
                                + OMEGA * new_dv, dv_)
                return du_, dv_

            d = sweep((du, dv), red)
            d = sweep(d, ~red)
            return d

        z = jnp.zeros((h, w), jnp.float32)
        du, dv = jax.lax.fori_loop(0, sor_iterations, inner, (z, z))
        return u + du, v + dv

    u, v = jax.lax.fori_loop(0, fixed_point_iterations, outer, (u0, v0))
    return jnp.stack([u, v], axis=-1)
