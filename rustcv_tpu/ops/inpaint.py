"""Image inpainting (OpenCV ``inpaint`` role: INPAINT_TELEA and a
diffusion method standing in the INPAINT_NS slot).

The reference has no photo restoration; OpenCV-parity addition.

device split:
- ``telea``: Bertalmío/Telea Fast Marching — an inherently sequential
  priority-queue march (each pixel depends on the just-solved narrow
  band), so it runs on the host like the GrabCut Dinic / CCL union-find
  escapes. Masked regions are O(hole), not O(image).
- ``diffusion``: harmonic fill — Jacobi relaxation of the Laplace
  equation over the hole with known pixels as boundary conditions. Pure
  elementwise averaging, so the device twin is a ``lax.fori_loop`` of
  fused 4-neighbor means (``inpaint_diffusion``); this is the
  smooth-propagation role OpenCV's INPAINT_NS fills (the full
  Navier–Stokes isophote transport is not reproduced — documented
  divergence, same API slot).

Frozen spec:
- telea: FMM from the hole boundary (T = 0 at known boundary pixels),
  4-neighbor Eikonal update ``T = min over axis pairs`` of the standard
  quadratic solve; pixels processed in increasing T; each filled as the
  weighted mean of KNOWN neighbors within ``radius``:
  ``w = dir·dst·lev`` with dir = max(cos between (p−q) and ∇T, 0.01)…
  simplified to the Telea paper's product using ∇T from the solved
  T-field (central differences where available), dst = 1/‖p−q‖²,
  lev = 1/(1+|T(q)−T(p)|);
- diffusion: float64 Jacobi, hole pixels ← mean of 4 neighbors
  (replicate border), iterated until max update < ``tol`` (or
  ``max_iters``); known pixels never move; output rounded half-up u8.
"""

from __future__ import annotations

import heapq
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax


# ---------------------------------------------------------------------------
# Telea FMM (host)
# ---------------------------------------------------------------------------

def _solve_eikonal(t: np.ndarray, known: np.ndarray, y: int, x: int) -> float:
    h, w = t.shape
    vals = []
    for dy, dx in ((0, 1), (1, 0)):
        best = np.inf
        for sgn in (-1, 1):
            ny, nx = y + sgn * dy, x + sgn * dx
            if 0 <= ny < h and 0 <= nx < w and known[ny, nx]:
                best = min(best, t[ny, nx])
        vals.append(best)
    a, b = sorted(vals)
    if np.isinf(a):
        return np.inf
    if np.isinf(b) or b - a >= 1.0:
        return a + 1.0
    return 0.5 * (a + b + np.sqrt(max(2.0 - (a - b) ** 2, 0.0)))


def inpaint_telea(img: np.ndarray, mask: np.ndarray,
                  radius: int = 3) -> np.ndarray:
    """u8 (H, W[, C]) + hole mask (H, W) bool/u8 → inpainted u8."""
    img = np.asarray(img)
    single = img.ndim == 2
    a = (img[..., None] if single else img).astype(np.float64)
    hole = np.asarray(mask).astype(bool)
    h, w = hole.shape
    known = ~hole
    t = np.where(known, 0.0, np.inf)

    # narrow band: hole pixels adjacent to known
    heap = []
    in_band = np.zeros_like(hole)
    for y, x in np.argwhere(hole):
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            ny, nx = y + dy, x + dx
            if 0 <= ny < h and 0 <= nx < w and known[ny, nx]:
                tt = _solve_eikonal(t, known, y, x)
                t[y, x] = tt
                heapq.heappush(heap, (tt, y, x))
                in_band[y, x] = True
                break

    offs = [(dy, dx) for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)
            if (dy or dx) and dy * dy + dx * dx <= radius * radius]

    def grad_t(y, x):
        gy = gx = 0.0
        if 0 < y < h - 1 and np.isfinite(t[y + 1, x]) and np.isfinite(t[y - 1, x]):
            gy = (t[y + 1, x] - t[y - 1, x]) * 0.5
        if 0 < x < w - 1 and np.isfinite(t[y, x + 1]) and np.isfinite(t[y, x - 1]):
            gx = (t[y, x + 1] - t[y, x - 1]) * 0.5
        return gy, gx

    filled = known.copy()
    while heap:
        tt, y, x = heapq.heappop(heap)
        if filled[y, x] or tt > t[y, x]:
            continue
        gy, gx = grad_t(y, x)
        num = np.zeros(a.shape[-1])
        den = 0.0
        for dy, dx in offs:
            ny, nx = y + dy, x + dx
            if not (0 <= ny < h and 0 <= nx < w) or not filled[ny, nx]:
                continue
            d2 = dy * dy + dx * dx
            direc = abs(dy * gy + dx * gx) / np.sqrt(d2)
            direc = max(direc, 1e-2)
            dst = 1.0 / d2
            lev = 1.0 / (1.0 + abs(t[ny, nx] - tt))
            wgt = direc * dst * lev
            num += wgt * a[ny, nx]
            den += wgt
        if den > 0:
            a[y, x] = num / den
        filled[y, x] = True
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            ny, nx = y + dy, x + dx
            if 0 <= ny < h and 0 <= nx < w and hole[ny, nx] \
                    and not filled[ny, nx]:
                nt = _solve_eikonal(t, filled, ny, nx)
                if nt < t[ny, nx]:
                    t[ny, nx] = nt
                    heapq.heappush(heap, (nt, ny, nx))
    out = np.clip(np.floor(a + 0.5), 0, 255).astype(np.uint8)
    return out[..., 0] if single else out


# ---------------------------------------------------------------------------
# harmonic diffusion (oracle + device twin)
# ---------------------------------------------------------------------------

def inpaint_diffusion_numpy(img: np.ndarray, mask: np.ndarray,
                            max_iters: int = 2000,
                            tol: float = 0.01) -> np.ndarray:
    """Oracle — float64 Jacobi until max update < tol."""
    img = np.asarray(img)
    single = img.ndim == 2
    a = (img[..., None] if single else img).astype(np.float64)
    hole = np.asarray(mask).astype(bool)
    cur = a.copy()
    cur[hole] = cur[~hole].mean(axis=0) if (~hole).any() else 128.0
    hm = hole[..., None]
    for _ in range(max_iters):
        p = np.pad(cur, ((1, 1), (1, 1), (0, 0)), mode="edge")
        avg = (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]) / 4.0
        new = np.where(hm, avg, a)
        # index with the 2-D mask: boolean masks don't broadcast, so
        # [hm] breaks on multi-channel images (r5 call-coverage fix)
        delta = np.abs(new - cur)[hole].max() if hole.any() else 0.0
        cur = new
        if delta < tol:
            break
    out = np.clip(np.floor(cur + 0.5), 0, 255).astype(np.uint8)
    return out[..., 0] if single else out


@partial(jax.jit, static_argnames=("max_iters",))
def inpaint_diffusion(img: jax.Array, mask: jax.Array,
                      max_iters: int = 2000) -> jax.Array:
    """Device twin — fixed ``max_iters`` fused Jacobi sweeps (static
    shape; the tolerance early-out is the oracle's, convergence beyond
    it only changes sub-LSB values). u8 (H, W[, C]) + bool mask → u8."""
    single = img.ndim == 2
    a = (img[..., None] if single else img).astype(jnp.float32)
    hole = mask.astype(bool)
    hm = hole[..., None]
    n_known = jnp.maximum((~hole).sum(), 1)
    fill = (a * (~hm)).sum(axis=(0, 1)) / n_known
    cur = jnp.where(hm, fill[None, None, :], a)

    def body(_, c):
        p = jnp.pad(c, ((1, 1), (1, 1), (0, 0)), mode="edge")
        avg = (p[:-2, 1:-1] + p[2:, 1:-1]
               + p[1:-1, :-2] + p[1:-1, 2:]) * 0.25
        return jnp.where(hm, avg, a)

    cur = lax.fori_loop(0, max_iters, body, cur)
    out = jnp.clip(jnp.floor(cur + 0.5), 0, 255).astype(jnp.uint8)
    return out[..., 0] if single else out


def inpaint(img, mask, radius: int = 3, method: str = "telea"):
    """OpenCV ``inpaint`` facade: ``method`` = "telea" | "diffusion"
    (the INPAINT_NS slot). jax inputs route diffusion to the device."""
    if method == "telea":
        return inpaint_telea(np.asarray(img), np.asarray(mask), radius)
    if method != "diffusion":
        raise ValueError(f"unknown method {method!r}")
    if isinstance(img, np.ndarray):
        return inpaint_diffusion_numpy(img, np.asarray(mask))
    return inpaint_diffusion(img, jnp.asarray(mask))
