"""Sector-based chessboard detection (OpenCV ``findChessboardCornersSB``
role; Duda & Frese, "Accurate Detection and Localization of Checkerboard
Corners for Calibration", BMVC 2018).

The reference (RustCV) has no calibration; OpenCV-parity addition
closing the last named gap next to ops/chessboard.py (the quad-ladder
``findChessboardCorners`` twin). device-first split: the dense per-pixel
corner-likelihood field — where the FLOPs are — is ONE batched jax
convolution program (16 sector-mean prototype kernels in a single
``lax.conv_general_dilated`` call, static shapes, matmul/elementwise friendly);
the sparse structure recovery (point graph → lattice BFS → canonical
grid) is host code over tens of points, like the quad pipeline.

Frozen spec (deterministic; oracle ``_likelihood_numpy`` below):
1. Likelihood. For prototypes (radius r ∈ {4, 7}) × (orientation 0°,
   45°): sector means A, B (one opposite quadrant pair) and C, D (the
   other) of the image under a Gaussian window (σ = r/2, support
   ‖p‖ ≤ r, center pixel excluded), quadrants split by the rotated
   axes. With μ = (A+B+C+D)/4 the prototype response is
   ``max(min(min(A,B)−μ, μ−max(C,D)), min(μ−max(A,B), min(C,D)−μ), 0)``
   (both checker polarities); the likelihood is the max over the four
   prototypes. Input scaled to [0, 1].
2. Candidates. 5×5 non-max suppression; threshold ladder
   t ∈ {0.35, 0.25, 0.15, 0.08} × max-likelihood, first t that yields a
   complete board wins; at most 3 × cols × rows strongest candidates
   per attempt (sorted by −likelihood, then y, then x).
3. Sub-pixel BEFORE structure recovery (the SB localize-then-grow
   order, unlike the quad pipeline): features.corner_sub_pix, win 11.
4. Structure. Mutual nearest-neighbor graph: edge (i, j) iff
   ‖pᵢ−pⱼ‖ < 1.35 × min(dᵢ, dⱼ) where dᵢ = i's nearest-candidate
   distance, each node keeping at most its 4 nearest such edges (the
   1.35 cap excludes lattice diagonals at ≈1.41 d). BFS from each
   degree-2 node (lowest index first) whose two edges are near-
   orthogonal (|cos| < 0.5); each traversed edge must match the
   CURRENT node's local axes with dot > 0.7 (else the edge is skipped),
   and the matched axis is re-seeded with the edge's actual direction —
   per-node axis propagation tolerates strong perspective where a
   global frame would shear out. Revisits must agree on the integer
   coordinate (else the start fails).
5. The BFS component must fill pattern_size exactly; canonical order is
   ops/chessboard._order_grid — the same contract as
   find_chessboard_corners (row-major, corner (0,0) at min-(x+y),
   row 0 running left→right).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .chessboard import _order_grid

_RADII = (4, 7)
_THETAS = (0.0, np.pi / 4)
_LADDER = (0.35, 0.25, 0.15, 0.08)


@functools.lru_cache()
def _kernels_np() -> np.ndarray:
    """(16, K, K) float32 sector-mean prototype kernels, K = 2·max(r)+1.
    Order: (r, θ) major, sectors A, B, C, D minor; A/B are the (+,+) and
    (−,−) rotated quadrants, C/D the (+,−) and (−,+)."""
    K = max(_RADII)
    yy, xx = np.mgrid[-K:K + 1, -K:K + 1].astype(np.float64)
    d2 = xx * xx + yy * yy
    ks = []
    for r in _RADII:
        w = np.exp(-d2 / (2.0 * (r / 2.0) ** 2))
        w[d2 > r * r] = 0.0
        w[K, K] = 0.0
        for theta in _THETAS:
            c, s = np.cos(theta), np.sin(theta)
            u = c * xx + s * yy
            v = -s * xx + c * yy
            for su, sv in ((1, 1), (-1, -1), (1, -1), (-1, 1)):
                m = (np.sign(u) == su) & (np.sign(v) == sv)
                k = w * m
                ks.append(k / k.sum())
    return np.stack(ks).astype(np.float32)


@jax.jit
def _likelihood(img: jax.Array) -> jax.Array:
    """Corner likelihood field for a (H, W) float32 image in [0, 1]:
    one 16-channel correlation + the min/max prototype combine."""
    k = jnp.asarray(_kernels_np())                     # (16, K, K)
    y = jax.lax.conv_general_dilated(
        img[None, None], k[:, None], (1, 1), "SAME")   # (1, 16, H, W)
    y = y[0].reshape(4, 4, *img.shape)                 # (proto, sector, ·)
    a, b, c, d = y[:, 0], y[:, 1], y[:, 2], y[:, 3]
    mu = (a + b + c + d) * 0.25
    r1 = jnp.minimum(jnp.minimum(a, b) - mu, mu - jnp.maximum(c, d))
    r2 = jnp.minimum(mu - jnp.maximum(a, b), jnp.minimum(c, d) - mu)
    return jnp.maximum(jnp.maximum(r1, r2), 0.0).max(axis=0)


def _likelihood_numpy(img: np.ndarray) -> np.ndarray:
    """Float64 oracle for :func:`_likelihood` (direct correlation, same
    zero padding and no kernel flip — XLA conv semantics)."""
    from numpy.lib.stride_tricks import sliding_window_view

    k = _kernels_np().astype(np.float64)
    K = max(_RADII)
    p = np.pad(img.astype(np.float64), K)
    win = sliding_window_view(p, (2 * K + 1, 2 * K + 1))
    y = np.einsum("hwij,cij->chw", win, k).reshape(4, 4, *img.shape)
    a, b, c, d = y[:, 0], y[:, 1], y[:, 2], y[:, 3]
    mu = (a + b + c + d) * 0.25
    r1 = np.minimum(np.minimum(a, b) - mu, mu - np.maximum(c, d))
    r2 = np.minimum(mu - np.maximum(a, b), np.minimum(c, d) - mu)
    return np.maximum(np.maximum(r1, r2), 0.0).max(axis=0)


def _nms_candidates(like: np.ndarray, thresh: float,
                    cap: int) -> np.ndarray:
    """5×5 NMS peaks above ``thresh`` → (N, 2) float64 (x, y), sorted by
    (−likelihood, y, x), at most ``cap`` rows."""
    h, w = like.shape
    p = np.pad(like, 2, constant_values=-1.0)
    mx = like.copy()
    for dy in range(5):
        for dx in range(5):
            np.maximum(mx, p[dy:dy + h, dx:dx + w], out=mx)
    ys, xs = np.nonzero((like >= mx) & (like > thresh))
    if len(ys) == 0:
        return np.zeros((0, 2), np.float64)
    order = np.lexsort((xs, ys, -like[ys, xs]))[:cap]
    return np.stack([xs[order], ys[order]], axis=1).astype(np.float64)


def _mutual_graph(pts: np.ndarray):
    """Mutual nearest-neighbor lattice graph (spec step 4)."""
    n = len(pts)
    d = np.linalg.norm(pts[:, None, :] - pts[None, :, :], axis=2)
    np.fill_diagonal(d, np.inf)
    dmin = d.min(axis=1)
    want = [set() for _ in range(n)]
    for i in range(n):
        cap = 1.35 * dmin[i]
        kept = 0
        for j in np.argsort(d[i], kind="stable"):
            if d[i, j] >= cap or kept >= 4:
                break
            if d[i, j] < 1.35 * dmin[j]:
                want[i].add(int(j))
                kept += 1
    return [ {j for j in want[i] if i in want[j]} for i in range(n) ]


def _unit(v: np.ndarray) -> np.ndarray:
    return v / max(float(np.linalg.norm(v)), 1e-12)


def _grow_from(pts: np.ndarray, adj, s0: int
               ) -> Optional[Dict[int, Tuple[int, int]]]:
    """BFS lattice growth with per-node axis propagation (spec step 4)."""
    nb = sorted(adj[s0])
    e1 = _unit(pts[nb[0]] - pts[s0])
    e2 = _unit(pts[nb[1]] - pts[s0])
    if abs(float(e1 @ e2)) > 0.5:
        return None
    coords: Dict[int, Tuple[int, int]] = {s0: (0, 0)}
    axes = {s0: (e1, e2)}
    queue = [s0]
    while queue:
        u = queue.pop(0)
        a1, a2 = axes[u]
        cu = coords[u]
        for v in sorted(adj[u]):
            dv = _unit(pts[v] - pts[u])
            dots = (float(dv @ a1), float(-(dv @ a1)),
                    float(dv @ a2), float(-(dv @ a2)))
            best = int(np.argmax(dots))
            if dots[best] < 0.7:
                continue                     # not a lattice step; skip
            step = ((1, 0), (-1, 0), (0, 1), (0, -1))[best]
            cv = (cu[0] + step[0], cu[1] + step[1])
            if v in coords:
                if coords[v] != cv:
                    return None              # inconsistent lattice
                continue
            coords[v] = cv
            na1 = dv if best == 0 else (-dv if best == 1 else a1)
            na2 = dv if best == 2 else (-dv if best == 3 else a2)
            axes[v] = (na1, na2)
            queue.append(v)
    return coords


def _recover_grid(pts: np.ndarray,
                  pattern_size: Tuple[int, int]) -> Optional[np.ndarray]:
    cols, rows = pattern_size
    if len(pts) < cols * rows:
        return None
    adj = _mutual_graph(pts)
    for s0 in range(len(pts)):
        if len(adj[s0]) != 2:
            continue
        coords = _grow_from(pts, adj, s0)
        if coords is None or len(coords) != cols * rows:
            continue
        ids = sorted(coords)
        uv = np.array([coords[i] for i in ids], np.int64)
        uv -= uv.min(axis=0)
        grid = _order_grid(pts[ids], uv, pattern_size)
        if grid is not None:
            return grid
    return None


def find_chessboard_corners_sb(
    gray,
    pattern_size: Tuple[int, int],
    normalize: bool = False,
    refine: bool = True,
) -> Tuple[bool, np.ndarray]:
    """Sector-based chessboard detection (OpenCV
    ``findChessboardCornersSB`` role). ``gray``: (H, W) u8;
    ``pattern_size`` = (cols, rows) of INNER corners; ``normalize``
    equalizes the histogram first (CALIB_CB_NORMALIZE_IMAGE role).
    Returns (found, corners float64 (rows·cols, 2)) in the same
    canonical row-major order as :func:`find_chessboard_corners` —
    drop-in for the ``calibrate_camera`` loop. More robust than the
    quad ladder under blur/low contrast (no binarization stage)."""
    gray = np.asarray(gray)
    if gray.ndim == 3:
        raise ValueError("find_chessboard_corners_sb expects a gray image")
    cols, rows = pattern_size
    if cols < 2 or rows < 2:
        raise ValueError("pattern_size must be >= 2x2 inner corners")
    u8 = np.clip(gray, 0, 255).astype(np.uint8)
    attempts = [u8]
    if normalize:
        from .hist import equalize_hist_numpy

        # equalized first; raw fallback (equalization can amplify noise
        # past what it recovers in contrast — the ladder tries both)
        attempts.insert(0, equalize_hist_numpy(u8))
    need = cols * rows
    for img in attempts:
        like = np.asarray(
            _likelihood(jnp.asarray(img / np.float64(255.0), jnp.float32)),
            np.float64)
        peak = float(like.max())
        if peak <= 0.0:
            continue
        for t in _LADDER:
            cand = _nms_candidates(like, t * peak, cap=3 * need)
            if len(cand) < need:
                continue
            if refine:
                from .features import corner_sub_pix

                cand = np.asarray(corner_sub_pix(
                    jnp.asarray(u8), jnp.asarray(cand, jnp.float32),
                    win=11), np.float64)
            grid = _recover_grid(cand, pattern_size)
            if grid is not None:
                return True, grid.reshape(-1, 2)
    return False, np.zeros((0, 2), np.float64)
