"""Generalized Hough transform, Ballard variant (OpenCV
``createGeneralizedHoughBallard`` role): detect translated instances
of an arbitrary edge template.

Frozen spec (float-free voting, int32 accumulator):
- template: edge pixels from our Canny spec; gradient orientation from
  the 3×3 Sobel pair, quantized to ``levels`` bins over [0, 2π);
  R-table bin b holds the displacements (centre − edge pixel) of all
  template edges with orientation b (deduplicated);
- detect: image edges + orientations the same way; every edge pixel
  with orientation b casts one vote at p + r for each r in bin b;
  peaks = local 3×3 maxima ≥ votes_threshold, sorted by votes.

Device formulation (the calcHist lesson — NO scatter): the accumulator is
``Σ over (bin, r) of shift(edge_mask_bin, r)``. Each (bin, r) entry
shifts a per-bin edge mask by a constant displacement — a
``dynamic_slice`` of the zero-padded mask — and adds. The device twin
runs one ``lax.scan`` over the R-table entries (bin id + displacement
as scan inputs over a static-shape padded table) and is BIT-EXACT vs
the numpy oracle: integer votes either way.
"""

from __future__ import annotations

from functools import partial
from typing import List, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .golden import canny, sobel3_gray


def _orientations(gray: np.ndarray, levels: int) -> np.ndarray:
    gx, gy = sobel3_gray(np.asarray(gray))
    ang = np.arctan2(gy.astype(np.float64), gx.astype(np.float64))
    b = np.round(ang / (2.0 * np.pi / levels)).astype(np.int64) % levels
    return b


def build_r_table(template_gray: np.ndarray, levels: int = 64,
                  canny_low: int = 40, canny_high: int = 90
                  ) -> np.ndarray:
    """→ (K, 3) int32 rows (bin, dy, dx): displacements from edge
    pixels to the template centre, grouped by quantized orientation."""
    t = np.asarray(template_gray)
    edges = canny(t, canny_low, canny_high) > 0
    bins = _orientations(t, levels)
    cy, cx = (t.shape[0] - 1) / 2.0, (t.shape[1] - 1) / 2.0
    ys, xs = np.nonzero(edges)
    rows = np.stack([bins[ys, xs],
                     np.round(cy - ys).astype(np.int64),
                     np.round(cx - xs).astype(np.int64)], axis=1)
    return np.unique(rows, axis=0).astype(np.int32)


def ghough_accumulate_numpy(gray: np.ndarray, r_table: np.ndarray,
                            levels: int = 64, canny_low: int = 40,
                            canny_high: int = 90) -> np.ndarray:
    """Oracle — int32 vote accumulator (H, W)."""
    g = np.asarray(gray)
    h, w = g.shape
    edges = canny(g, canny_low, canny_high) > 0
    bins = _orientations(g, levels)
    acc = np.zeros((h, w), np.int32)
    ys, xs = np.nonzero(edges)
    bs = bins[ys, xs]
    for b, dy, dx in r_table:
        sel = bs == b
        vy = ys[sel] + dy
        vx = xs[sel] + dx
        ok = (vy >= 0) & (vy < h) & (vx >= 0) & (vx < w)
        np.add.at(acc, (vy[ok], vx[ok]), 1)
    return acc


@partial(jax.jit, static_argnames=("levels", "canny_low", "canny_high",
                                   "n_entries"))
def _accumulate_device(gray: jax.Array, table: jax.Array,
                       n_entries: int, levels: int = 64,
                       canny_low: int = 40, canny_high: int = 90
                       ) -> jax.Array:
    """Device twin: per-bin edge masks shifted by each R-table entry
    via dynamic_slice of the zero-padded mask, scanned — no scatter."""
    from . import filters as _filters

    h, w = gray.shape
    edges = _filters.canny_u8(gray, canny_low, canny_high) > 0
    gx, gy = _filters.sobel3_gray(gray)
    ang = jnp.arctan2(gy.astype(jnp.float32), gx.astype(jnp.float32))
    bins = jnp.round(ang / (2.0 * np.pi / levels)).astype(
        jnp.int32) % levels

    # displacement magnitudes are bounded by the image size, so a
    # static h/w pad always contains the slide window
    pmax_y, pmax_x = int(h), int(w)

    def entry_votes(carry, row):
        b, dy, dx = row[0], row[1], row[2]
        mask = (edges & (bins == b)).astype(jnp.int32)
        p = jnp.pad(mask, ((pmax_y, pmax_y), (pmax_x, pmax_x)))
        shifted = jax.lax.dynamic_slice(
            p, (pmax_y - dy, pmax_x - dx), (h, w))
        return carry + shifted, 0

    acc0 = jnp.zeros((h, w), jnp.int32)
    acc, _ = jax.lax.scan(entry_votes, acc0, table[:n_entries])
    return acc


def ghough_accumulate(gray, r_table: np.ndarray, levels: int = 64,
                      canny_low: int = 40, canny_high: int = 90):
    """Dispatch: numpy oracle or jitted device scan (bit-exact)."""
    if isinstance(gray, np.ndarray):
        return ghough_accumulate_numpy(gray, r_table, levels,
                                       canny_low, canny_high)
    table = jnp.asarray(np.asarray(r_table, np.int32))
    return _accumulate_device(gray, table, int(len(r_table)), levels,
                              canny_low, canny_high)


def ghough_detect(gray, r_table: np.ndarray, votes_threshold: int,
                  levels: int = 64, canny_low: int = 40,
                  canny_high: int = 90
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """→ (positions (N, 2) float32 (x, y), votes (N,) int32), strongest
    first — OpenCV ``GeneralizedHoughBallard.detect`` role."""
    acc = np.asarray(ghough_accumulate(gray, r_table, levels,
                                       canny_low, canny_high))
    h, w = acc.shape
    p = np.pad(acc, 1)
    is_peak = np.ones((h, w), bool)
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            neigh = p[dy:dy + h, dx:dx + w]
            # strict on the lexicographically earlier side breaks ties
            if (dy, dx) < (1, 1):
                is_peak &= acc >= neigh
            else:
                is_peak &= acc > neigh
    is_peak &= acc >= votes_threshold
    ys, xs = np.nonzero(is_peak)
    votes = acc[ys, xs]
    order = np.argsort(-votes, kind="stable")
    pos = np.stack([xs[order], ys[order]], axis=1).astype(np.float32)
    return pos, votes[order].astype(np.int32)


def ghough_detect_guil(gray, r_table: np.ndarray, votes_threshold: int,
                       angles=np.deg2rad(np.arange(-40, 41, 10)),
                       scales=(0.8, 1.0, 1.25), levels: int = 64,
                       canny_low: int = 40, canny_high: int = 90
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
    """Rotation/scale-aware variant (OpenCV
    ``createGeneralizedHoughGuil`` role): vote each (angle, scale)
    hypothesis with the transformed R-table (displacements rotated and
    scaled, orientation bins shifted by the same angle), keep the
    best-scoring hypothesis per accumulator peak → (positions (N, 2)
    float32 (x, y), votes (N,), angles_rad (N,), scales (N,)),
    strongest first."""
    g = np.asarray(gray)
    h, w = g.shape
    edges = canny(g, canny_low, canny_high) > 0
    bins = _orientations(g, levels)
    ys, xs = np.nonzero(edges)
    bs = bins[ys, xs]

    best_votes = np.zeros((h, w), np.int32)
    best_ang = np.zeros((h, w), np.float64)
    best_scl = np.ones((h, w), np.float64)
    tbl = np.asarray(r_table, np.int64)
    for ang in np.atleast_1d(angles):
        ca, sa = np.cos(ang), np.sin(ang)
        bshift = int(np.round(ang / (2.0 * np.pi / levels)))
        for scl in scales:
            acc = np.zeros((h, w), np.int32)
            for b, dy, dx in tbl:
                # rotate the displacement by ang, scale by scl
                rdx = scl * (ca * dx - sa * dy)
                rdy = scl * (sa * dx + ca * dy)
                # ±1 orientation-bin tolerance absorbs the angle-grid
                # quantization (10° grid vs 5.6° bins)
                dbin = (bs - (b + bshift)) % levels
                sel = (dbin <= 1) | (dbin >= levels - 1)
                vy = ys[sel] + int(np.round(rdy))
                vx = xs[sel] + int(np.round(rdx))
                ok = (vy >= 0) & (vy < h) & (vx >= 0) & (vx < w)
                np.add.at(acc, (vy[ok], vx[ok]), 1)
            # 3×3 vote smoothing before hypothesis competition
            pa = np.pad(acc, 1)
            sm = sum(pa[dy:dy + h, dx:dx + w]
                     for dy in range(3) for dx in range(3))
            better = sm > best_votes
            best_votes = np.where(better, sm, best_votes)
            best_ang = np.where(better, ang, best_ang)
            best_scl = np.where(better, scl, best_scl)

    # peak extraction (same tie-safe 3×3 NMS as the Ballard path)
    p = np.pad(best_votes, 1)
    is_peak = np.ones((h, w), bool)
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            neigh = p[dy:dy + h, dx:dx + w]
            if (dy, dx) < (1, 1):
                is_peak &= best_votes >= neigh
            else:
                is_peak &= best_votes > neigh
    is_peak &= best_votes >= votes_threshold
    py, px = np.nonzero(is_peak)
    votes = best_votes[py, px]
    order = np.argsort(-votes, kind="stable")
    return (np.stack([px[order], py[order]], 1).astype(np.float32),
            votes[order].astype(np.int32),
            best_ang[py, px][order], best_scl[py, px][order])
