"""Corner-response family (OpenCV ``spatialGradient`` /
``cornerMinEigenVal`` / ``cornerEigenValsAndVecs`` /
``preCornerDetect`` roles).

Complements the Harris machinery in ops/features.py (which carries the
integer-exact fixed-point spec); these are the float response surfaces
with OpenCV's exact scaling conventions, cross-validated against real
cv2 5.0 full-frame (tests/test_corner.py):

- gradients are the separable binomial⊛difference kernels
  (ops/filters.deriv_kernels) with BORDER_REFLECT_101 — OpenCV's
  default border, so edges match too (the existing sobel_xy uses
  replicate, interior-exact only);
- cornerEigenValsAndVecs / cornerMinEigenVal scale each gradient by
  1/(2^(ksize-1) · 255 · blockSize) and window-sum the products with an
  UNNORMALIZED blockSize box (measured: response ratio pinned to
  1/1020² at ksize=3, blockSize=3);
- preCornerDetect = (Dxx·Dy² + Dyy·Dx² − 2·Dxy·Dx·Dy) / (2^(ksize-1)·255)³
  (measured: 1/1020³ at ksize=3).

Device formulation: everything is shifted-view taps + elementwise algebra
— XLA fuses the whole response into one device-memory pass; the 2×2 eigen system
is solved in closed form (no per-pixel iteration).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .filters import deriv_kernels


def _sep_filter_np(a: np.ndarray, kx: np.ndarray, ky: np.ndarray
                   ) -> np.ndarray:
    """Separable correlation, reflect-101 border, float64."""
    rx, ry = len(kx) // 2, len(ky) // 2
    h, w = a.shape
    p = np.pad(a, ((0, 0), (rx, rx)), mode="reflect")
    out = np.zeros((h, w), np.float64)
    for k, wgt in enumerate(kx):
        if wgt:
            out += wgt * p[:, k:k + w]
    p = np.pad(out, ((ry, ry), (0, 0)), mode="reflect")
    out2 = np.zeros((h, w), np.float64)
    for k, wgt in enumerate(ky):
        if wgt:
            out2 += wgt * p[k:k + h, :]
    return out2


def _sep_filter_jx(a: jax.Array, kx, ky) -> jax.Array:
    rx, ry = len(kx) // 2, len(ky) // 2
    h, w = a.shape
    p = jnp.pad(a, ((0, 0), (rx, rx)), mode="reflect")
    out = sum(float(wgt) * jax.lax.dynamic_slice_in_dim(p, k, w, 1)
              for k, wgt in enumerate(kx) if wgt)
    p = jnp.pad(out, ((ry, ry), (0, 0)), mode="reflect")
    return sum(float(wgt) * jax.lax.dynamic_slice_in_dim(p, k, h, 0)
               for k, wgt in enumerate(ky) if wgt)


def _box_sum_np(a: np.ndarray, block: int) -> np.ndarray:
    r = block // 2
    h, w = a.shape
    p = np.pad(a, r, mode="reflect")
    out = np.zeros((h, w), np.float64)
    for dy in range(block):
        for dx in range(block):
            out += p[dy:dy + h, dx:dx + w]
    return out


def _box_sum_jx(a: jax.Array, block: int) -> jax.Array:
    r = block // 2
    h, w = a.shape
    p = jnp.pad(a, r, mode="reflect")
    return sum(jax.lax.dynamic_slice(p, (dy, dx), (h, w))
               for dy in range(block) for dx in range(block))


# ---------------------------------------------------------------------------
# spatialGradient


def spatial_gradient_numpy(gray: np.ndarray, ksize: int = 3
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Oracle — int results (the kernels are integral)."""
    a = np.asarray(gray, np.float64)
    kx1, ky1 = deriv_kernels(1, 0, ksize)
    dx = _sep_filter_np(a, kx1, ky1)
    kx2, ky2 = deriv_kernels(0, 1, ksize)
    dy = _sep_filter_np(a, kx2, ky2)
    return dx.astype(np.int32), dy.astype(np.int32)


@partial(jax.jit, static_argnames=("ksize",))
def spatial_gradient(gray: jax.Array, ksize: int = 3
                     ) -> Tuple[jax.Array, jax.Array]:
    """Device twin — int32 exact."""
    a = gray.astype(jnp.int32)
    kx1, ky1 = deriv_kernels(1, 0, ksize)
    kx2, ky2 = deriv_kernels(0, 1, ksize)
    return (_sep_filter_jx(a, kx1, ky1).astype(jnp.int32),
            _sep_filter_jx(a, kx2, ky2).astype(jnp.int32))


# ---------------------------------------------------------------------------
# covariance products (shared)


def _cov_np(gray: np.ndarray, block: int, ksize: int):
    a = np.asarray(gray, np.float64)
    scale = 1.0 / ((1 << (ksize - 1)) * 255.0 * block)
    kx1, ky1 = deriv_kernels(1, 0, ksize)
    kx2, ky2 = deriv_kernels(0, 1, ksize)
    dx = _sep_filter_np(a, kx1, ky1) * scale
    dy = _sep_filter_np(a, kx2, ky2) * scale
    return (_box_sum_np(dx * dx, block), _box_sum_np(dy * dy, block),
            _box_sum_np(dx * dy, block))


def _cov_jx(gray: jax.Array, block: int, ksize: int):
    a = gray.astype(jnp.float32)
    scale = 1.0 / ((1 << (ksize - 1)) * 255.0 * block)
    kx1, ky1 = deriv_kernels(1, 0, ksize)
    kx2, ky2 = deriv_kernels(0, 1, ksize)
    dx = _sep_filter_jx(a, kx1, ky1) * scale
    dy = _sep_filter_jx(a, kx2, ky2) * scale
    return (_box_sum_jx(dx * dx, block), _box_sum_jx(dy * dy, block),
            _box_sum_jx(dx * dy, block))


# ---------------------------------------------------------------------------
# cornerMinEigenVal


def corner_min_eigen_val_numpy(gray: np.ndarray, block_size: int = 3,
                               ksize: int = 3) -> np.ndarray:
    sxx, syy, sxy = _cov_np(gray, block_size, ksize)
    half_tr = (sxx + syy) * 0.5
    disc = np.sqrt(((sxx - syy) * 0.5) ** 2 + sxy * sxy)
    return (half_tr - disc).astype(np.float32)


@partial(jax.jit, static_argnames=("block_size", "ksize"))
def corner_min_eigen_val(gray: jax.Array, block_size: int = 3,
                         ksize: int = 3) -> jax.Array:
    sxx, syy, sxy = _cov_jx(gray, block_size, ksize)
    half_tr = (sxx + syy) * 0.5
    disc = jnp.sqrt(((sxx - syy) * 0.5) ** 2 + sxy * sxy)
    return half_tr - disc


# ---------------------------------------------------------------------------
# cornerEigenValsAndVecs


def corner_eigen_vals_and_vecs_numpy(gray: np.ndarray, block_size: int = 3,
                                     ksize: int = 3) -> np.ndarray:
    """(H, W, 6): λ1, λ2 (descending), x1, y1, x2, y2 — unit
    eigenvectors of the scaled covariance (sign is arbitrary; tests
    compare collinearity)."""
    sxx, syy, sxy = _cov_np(gray, block_size, ksize)
    half_tr = (sxx + syy) * 0.5
    disc = np.sqrt(((sxx - syy) * 0.5) ** 2 + sxy * sxy)
    l1, l2 = half_tr + disc, half_tr - disc

    def unit_vec(lam):
        # eigenvector of [[a,b],[b,c]] for λ: (b, λ-a), with the
        # degenerate isotropic fallback (1, 0)
        vx, vy = sxy, lam - sxx
        n = np.sqrt(vx * vx + vy * vy)
        bad = n < 1e-12
        vx = np.where(bad, 1.0, vx)
        vy = np.where(bad, 0.0, vy)
        n = np.where(bad, 1.0, n)
        return vx / n, vy / n

    x1, y1 = unit_vec(l1)
    x2, y2 = unit_vec(l2)
    return np.stack([l1, l2, x1, y1, x2, y2], axis=-1).astype(np.float32)


@partial(jax.jit, static_argnames=("block_size", "ksize"))
def corner_eigen_vals_and_vecs(gray: jax.Array, block_size: int = 3,
                               ksize: int = 3) -> jax.Array:
    sxx, syy, sxy = _cov_jx(gray, block_size, ksize)
    half_tr = (sxx + syy) * 0.5
    disc = jnp.sqrt(((sxx - syy) * 0.5) ** 2 + sxy * sxy)
    l1, l2 = half_tr + disc, half_tr - disc

    def unit_vec(lam):
        vx, vy = sxy, lam - sxx
        n = jnp.sqrt(vx * vx + vy * vy)
        bad = n < 1e-12
        vx = jnp.where(bad, 1.0, vx)
        vy = jnp.where(bad, 0.0, vy)
        n = jnp.where(bad, 1.0, n)
        return vx / n, vy / n

    x1, y1 = unit_vec(l1)
    x2, y2 = unit_vec(l2)
    return jnp.stack([l1, l2, x1, y1, x2, y2], axis=-1)


# ---------------------------------------------------------------------------
# preCornerDetect


def pre_corner_detect_numpy(gray: np.ndarray, ksize: int = 3) -> np.ndarray:
    a = np.asarray(gray, np.float64)
    f = (1 << (ksize - 1)) * 255.0
    factor = 1.0 / (f * f * f)
    dx = _sep_filter_np(a, *deriv_kernels(1, 0, ksize))
    dy = _sep_filter_np(a, *deriv_kernels(0, 1, ksize))
    dxx = _sep_filter_np(a, *deriv_kernels(2, 0, ksize))
    dyy = _sep_filter_np(a, *deriv_kernels(0, 2, ksize))
    dxy = _sep_filter_np(a, *deriv_kernels(1, 1, ksize))
    out = factor * (dxx * dy * dy + dyy * dx * dx - 2.0 * dxy * dx * dy)
    return out.astype(np.float32)


@partial(jax.jit, static_argnames=("ksize",))
def pre_corner_detect(gray: jax.Array, ksize: int = 3) -> jax.Array:
    a = gray.astype(jnp.float32)
    f = (1 << (ksize - 1)) * 255.0
    factor = 1.0 / (f * f * f)
    dx = _sep_filter_jx(a, *deriv_kernels(1, 0, ksize))
    dy = _sep_filter_jx(a, *deriv_kernels(0, 1, ksize))
    dxx = _sep_filter_jx(a, *deriv_kernels(2, 0, ksize))
    dyy = _sep_filter_jx(a, *deriv_kernels(0, 2, ksize))
    dxy = _sep_filter_jx(a, *deriv_kernels(1, 1, ksize))
    return factor * (dxx * dy * dy + dyy * dx * dx - 2.0 * dxy * dx * dy)
