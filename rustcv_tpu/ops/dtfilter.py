"""Domain-transform edge-preserving filtering and the OpenCV photo ops
built on it (``edgePreservingFilter`` / ``detailEnhance`` /
``stylization`` / ``pencilSketch`` roles; Gastal & Oliveira 2011, the
recursive RF filter OpenCV's photo module uses).

Device formulation: the recursive filter is a ``lax.scan`` along the scan
axis carrying one [M, C] slab — identical in shape to the SGBM path
scans. Per iteration: horizontal left→right, right→left, then the
transposed vertical pair; the per-pixel feedback weight ``a^d`` is
precomputed elementwise (no gathers anywhere).

Frozen spec (float64 oracle :func:`dt_filter_numpy`):
- domain derivative along an axis:
  ``d(x) = 1 + (σ_s/σ_r)·Σ_c |I_c(x) − I_c(x−1)|`` on [0,1] floats of
  the GUIDE image (first column d = ∞ ⇒ weight 0);
- ``N = 3`` iterations; at iteration i (0-based):
  ``σ_H(i) = σ_s·√3·2^(N−i−1)/√(4^N − 1)``, ``a = exp(−√2/σ_H)``,
  feedback weight ``w = a^d``;
- recursion ``J(x) = (1 − w(x))·J(x) + w(x)·J(x−1)`` applied L→R then
  R→L (on the result), then the same pair vertically — per iteration;
- derived ops (documented divergence from OpenCV's exact recipes; the
  API roles and qualitative behavior match):
  ``edge_preserving_filter`` = the filter itself (σ_s 60, σ_r 0.4);
  ``detail_enhance`` = base + 3·(src − base) (σ_s 10, σ_r 0.15);
  ``stylization`` = filtered image darkened by its own edge magnitude
  (σ_s 60, σ_r 0.45; edge term = clip(1 − 4·‖∇base‖, 0.25, 1));
  ``pencil_sketch`` = dodge of luma by its DT-smoothed base
  (``255·min(g/(b+1), 1)²``, σ_s 60, σ_r 2.0 — the LARGE σ_r makes the
  base blur across edges, which is what draws the stroke on the dark
  side), color variant = sketch × (src blended toward white by
  ``shade_factor``).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

_N_ITERS = 3


def _sigma_h(sigma_s: float, i: int) -> float:
    return sigma_s * np.sqrt(3.0) * (2.0 ** (_N_ITERS - i - 1)) \
        / np.sqrt(4.0 ** _N_ITERS - 1.0)


# ---------------------------------------------------------------------------
# oracle
# ---------------------------------------------------------------------------

def _domain_d(guide: np.ndarray, sigma_s: float, sigma_r: float,
              axis: int) -> np.ndarray:
    g = guide
    diff = np.abs(np.diff(g, axis=axis)).sum(axis=-1)
    pad = [(0, 0), (0, 0)]
    pad[axis] = (1, 0)
    d = 1.0 + (sigma_s / sigma_r) * np.pad(diff, pad)
    # first sample has no predecessor: infinite domain distance
    idx = [slice(None)] * 2
    idx[axis] = 0
    d[tuple(idx)] = np.inf
    return d


def _rf_pass_np(img: np.ndarray, w: np.ndarray, axis: int) -> np.ndarray:
    """One L→R + R→L recursive pair along ``axis`` (w = a^d)."""
    out = img.copy()
    n = img.shape[axis]
    sl = lambda i: tuple(
        [slice(None)] * axis + [i] + [slice(None)] * (img.ndim - axis - 1))
    wsl = lambda i: tuple(
        [slice(None)] * axis + [i] + [slice(None)] * (2 - axis - 1))
    for x in range(1, n):
        ww = w[wsl(x)][..., None]
        out[sl(x)] = (1 - ww) * out[sl(x)] + ww * out[sl(x - 1)]
    for x in range(n - 2, -1, -1):
        ww = w[wsl(x + 1)][..., None]
        out[sl(x)] = (1 - ww) * out[sl(x)] + ww * out[sl(x + 1)]
    return out


def dt_filter_numpy(guide: np.ndarray, src: np.ndarray,
                    sigma_s: float = 60.0,
                    sigma_r: float = 0.4) -> np.ndarray:
    """Oracle — guide/src u8 (H, W, C) → filtered float64 [0,1]·255 u8."""
    g = np.asarray(guide, np.float64) / 255.0
    j = np.asarray(src, np.float64) / 255.0
    dh = _domain_d(g, sigma_s, sigma_r, 1)
    dv = _domain_d(g, sigma_s, sigma_r, 0)
    for i in range(_N_ITERS):
        a = np.exp(-np.sqrt(2.0) / _sigma_h(sigma_s, i))
        wh = np.where(np.isinf(dh), 0.0, a ** np.minimum(dh, 700))
        wv = np.where(np.isinf(dv), 0.0, a ** np.minimum(dv, 700))
        j = _rf_pass_np(j, wh, 1)
        j = _rf_pass_np(j, wv, 0)
    return np.clip(np.floor(j * 255.0 + 0.5), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# device twin
# ---------------------------------------------------------------------------

def _rf_pass_j(img: jax.Array, w: jax.Array, axis: int) -> jax.Array:
    """Same recursive pair as the oracle, as two lax.scans."""
    a = jnp.moveaxis(img, axis, 0)          # [N, M, C]
    ww = jnp.moveaxis(w, axis, 0)[..., None]  # [N, M, 1]

    def fwd(carry, inp):
        x, wx = inp
        out = (1 - wx) * x + wx * carry
        return out, out

    _, f = lax.scan(fwd, a[0], (a[1:], ww[1:]))
    f = jnp.concatenate([a[:1], f], axis=0)

    fr = jnp.flip(f, 0)
    wr = jnp.flip(ww, 0)

    def bwd(carry, inp):
        x, wx = inp
        out = (1 - wx) * x + wx * carry
        return out, out

    _, b = lax.scan(bwd, fr[0], (fr[1:], wr[:-1]))
    out = jnp.concatenate([fr[:1], b], axis=0)
    return jnp.moveaxis(jnp.flip(out, 0), 0, axis)


@partial(jax.jit, static_argnames=("sigma_s", "sigma_r"))
def dt_filter(guide: jax.Array, src: jax.Array, sigma_s: float = 60.0,
              sigma_r: float = 0.4) -> jax.Array:
    """Device twin (f32; ±1 LSB vs the oracle)."""
    g = guide.astype(jnp.float32) / 255.0
    j = src.astype(jnp.float32) / 255.0
    dh = 1.0 + (sigma_s / sigma_r) * jnp.pad(
        jnp.abs(jnp.diff(g, axis=1)).sum(-1), ((0, 0), (1, 0)))
    dv = 1.0 + (sigma_s / sigma_r) * jnp.pad(
        jnp.abs(jnp.diff(g, axis=0)).sum(-1), ((1, 0), (0, 0)))
    first_h = jnp.arange(g.shape[1]) == 0
    first_v = (jnp.arange(g.shape[0]) == 0)[:, None]
    for i in range(_N_ITERS):
        a = float(np.exp(-np.sqrt(2.0) / _sigma_h(sigma_s, i)))
        wh = jnp.where(first_h[None, :], 0.0,
                       jnp.exp(jnp.minimum(dh, 700) * np.log(a)))
        wv = jnp.where(first_v, 0.0,
                       jnp.exp(jnp.minimum(dv, 700) * np.log(a)))
        j = _rf_pass_j(j, wh, 1)
        j = _rf_pass_j(j, wv, 0)
    return jnp.clip(jnp.floor(j * 255.0 + 0.5), 0, 255).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# derived photo ops (work on numpy or jax arrays)
# ---------------------------------------------------------------------------

def _filt(img, sigma_s, sigma_r):
    if isinstance(img, np.ndarray):
        return dt_filter_numpy(img, img, sigma_s, sigma_r)
    return dt_filter(img, img, sigma_s, sigma_r)


def edge_preserving_filter(img, sigma_s: float = 60.0,
                           sigma_r: float = 0.4):
    """OpenCV ``edgePreservingFilter`` (RECURS_FILTER) role."""
    return _filt(img, sigma_s, sigma_r)


def detail_enhance(img, sigma_s: float = 10.0, sigma_r: float = 0.15):
    """OpenCV ``detailEnhance`` role: base + 3·detail."""
    xp = np if isinstance(img, np.ndarray) else jnp
    base = _filt(img, sigma_s, sigma_r).astype(xp.float32)
    src = img.astype(xp.float32)
    out = base + 3.0 * (src - base)
    return xp.clip(xp.floor(out + 0.5), 0, 255).astype(xp.uint8)


def stylization(img, sigma_s: float = 60.0, sigma_r: float = 0.45):
    """OpenCV ``stylization`` role: flat regions + darkened edges."""
    xp = np if isinstance(img, np.ndarray) else jnp
    base = _filt(img, sigma_s, sigma_r).astype(xp.float32) / 255.0
    gray = base.mean(axis=-1)
    pad_y = xp.pad(gray, ((1, 0), (0, 0)), mode="edge")
    pad_x = xp.pad(gray, ((0, 0), (1, 0)), mode="edge")
    gy = gray - pad_y[:-1]
    gx = gray - pad_x[:, :-1]
    edge = xp.clip(1.0 - 4.0 * xp.sqrt(gx * gx + gy * gy), 0.25, 1.0)
    out = base * edge[..., None] * 255.0
    return xp.clip(xp.floor(out + 0.5), 0, 255).astype(xp.uint8)


def pencil_sketch(img, sigma_s: float = 60.0, sigma_r: float = 2.0,
                  shade_factor: float = 0.05):
    """OpenCV ``pencilSketch`` role → (gray sketch u8 (H, W), color
    pencil u8 (H, W, C))."""
    xp = np if isinstance(img, np.ndarray) else jnp
    src = img.astype(xp.float32)
    gray = src.mean(axis=-1)
    gimg = xp.stack([gray, gray, gray], axis=-1).astype(xp.uint8)
    base = _filt(gimg, sigma_s, sigma_r).astype(xp.float32)[..., 0]
    ratio = xp.minimum(gray / (base + 1.0), 1.0)
    sketch = xp.clip(xp.floor(255.0 * ratio * ratio + 0.5), 0, 255)
    # color pencil: sketch shading modulating the source colors
    color = xp.clip(xp.floor((sketch[..., None] / 255.0)
                             * (src * (1 - shade_factor)
                                + 255.0 * shade_factor) + 0.5), 0, 255)
    return sketch.astype(xp.uint8), color.astype(xp.uint8)


# ---------------------------------------------------------------------------
# Guided filter (He et al. 2010; OpenCV ximgproc.guidedFilter role)
# ---------------------------------------------------------------------------
# Frozen spec (f64 oracle): gray guide I, filter input p (any channels),
# box means of radius r (replicate border):
#   a = cov(I, p) / (var(I) + eps),  b = mean(p) − a·mean(I)
#   q = mean(a)·I + mean(b)
# Output dtype follows the input (u8 rounds half-up). Pure box filters +
# elementwise — the most accelerator-friendly edge-preserving filter there is.

def _box_mean(a, r, xp):
    n = (2 * r + 1)
    pad = [(r, r), (r, r)] + [(0, 0)] * (a.ndim - 2)
    p = xp.pad(a, pad, mode="edge")
    out = sum(p[k:k + a.shape[0]] for k in range(n)) / n
    p2 = xp.pad(out, [(0, 0), (r, r)] + [(0, 0)] * (a.ndim - 2),
                mode="edge")
    return sum(p2[:, k:k + a.shape[1]] for k in range(n)) / n


def guided_filter(guide, src, radius: int = 8, eps: float = 1e-3):
    """Edge-preserving smoothing of ``src`` steered by gray ``guide``
    (both u8 or float; u8 scales to [0,1]). Works on numpy (f64 oracle)
    or jax (f32 device) arrays."""
    xp = np if isinstance(guide, np.ndarray) else jnp
    dt = np.float64 if xp is np else jnp.float32
    g = guide.astype(dt)
    p = src.astype(dt)
    was_u8 = src.dtype == np.uint8
    if guide.dtype == np.uint8:
        g = g / 255.0
    if was_u8:
        p = p / 255.0
    if p.ndim == 3:
        gg = g[..., None]
    else:
        gg = g
    mean_i = _box_mean(g, radius, xp)
    mean_p = _box_mean(p, radius, xp)
    mean_ip = _box_mean((gg * p) if p.ndim == 3 else g * p, radius, xp)
    mean_ii = _box_mean(g * g, radius, xp)
    var_i = mean_ii - mean_i * mean_i
    mi = mean_i[..., None] if p.ndim == 3 else mean_i
    vi = var_i[..., None] if p.ndim == 3 else var_i
    a = (mean_ip - mi * mean_p) / (vi + eps)
    b = mean_p - a * mi
    q = _box_mean(a, radius, xp) * gg + _box_mean(b, radius, xp)
    if was_u8:
        return xp.clip(xp.floor(q * 255.0 + 0.5), 0, 255).astype(xp.uint8)
    return q
