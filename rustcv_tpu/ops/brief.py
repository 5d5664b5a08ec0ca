"""BRIEF-256 descriptors + Hamming matching — the describe/match half of
the feature pipeline (FAST/Harris detect → BRIEF describe → match).

Device formulation:
- one 5×5 Gaussian over the whole image (the frozen blur spec), then each
  keypoint's 33×33 patch comes from ONE dynamic_slice (the LK trick) and
  256 fixed point-pair compares pack into 8 u32 words — all vmapped over
  keypoints;
- matching is a MATMUL: descriptors as ±1 float32 [N, 256] × [256, M] on
  the matrix unit gives dot = 256 − 2·hamming, so nearest-by-hamming =
  argmax-by-dot; Lowe ratio test on the top-2.

Frozen spec: upright BRIEF (no orientation steering — fine for tracking /
stereo baselines), pair pattern drawn once from a fixed RNG seed
(gaussian-ish, clipped to the patch), compare strictly-greater on the
blurred image. Device == oracle bit-for-bit.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .filters import gaussian5_u8

PATCH = 33  # sampling patch (half = 16)
NBITS = 256


@lru_cache(maxsize=1)
def brief_pattern() -> np.ndarray:
    """[256, 4] int32 (y1, x1, y2, x2) offsets in [-16, 16], frozen
    (seeded normal pattern, the classic BRIEF G-II choice)."""
    rng = np.random.default_rng(20240131)
    pts = np.clip(
        np.round(rng.normal(0.0, PATCH / 5.0, size=(NBITS, 4))), -16, 16
    ).astype(np.int32)
    return pts


@partial(jax.jit, static_argnames=())
def brief_descriptors(gray: jax.Array, pts: jax.Array):
    """u8 gray (H, W) × [K, 2] float32 (x, y) keypoints → (desc u32 [K, 8],
    valid bool [K]). Keypoints whose 33×33 patch leaves the image are
    invalid (descriptor zeroed)."""
    h, w = gray.shape
    half = PATCH // 2
    blurred = gaussian5_u8(gray, has_channels=False).astype(jnp.int32)
    pat = jnp.asarray(brief_pattern())
    o1 = (pat[:, 0] + half) * PATCH + (pat[:, 1] + half)
    o2 = (pat[:, 2] + half) * PATCH + (pat[:, 3] + half)
    word = jnp.arange(NBITS, dtype=jnp.int32) // 32
    bit = jnp.arange(NBITS, dtype=jnp.int32) % 32

    def one(pt):
        x = jnp.round(pt[0]).astype(jnp.int32)
        y = jnp.round(pt[1]).astype(jnp.int32)
        ok = (x >= half) & (x <= w - 1 - half) & (y >= half) & (y <= h - 1 - half)
        patch = jax.lax.dynamic_slice(
            blurred,
            (jnp.clip(y - half, 0, h - PATCH), jnp.clip(x - half, 0, w - PATCH)),
            (PATCH, PATCH),
        ).reshape(-1)
        bits = (jnp.take(patch, o1) > jnp.take(patch, o2)).astype(jnp.uint32)
        desc = jnp.zeros(8, jnp.uint32)
        desc = desc.at[word].add(bits << bit.astype(jnp.uint32))
        return jnp.where(ok, desc, 0), ok

    return jax.vmap(one)(pts)


def match_descriptors(
    d1, d2, valid1=None, valid2=None, ratio: float = 0.8
) -> np.ndarray:
    """Hamming matching with Lowe ratio test → int32 [M, 2] (i1, i2).

    dist = 256 − popcount(XNOR) computed as a ±1 matmul (dot =
    256 − 2·hamming); a match survives when best < ratio·second-best and
    it wins the mutual cross-check."""
    b1 = _bits_pm1(np.asarray(d1))
    b2 = _bits_pm1(np.asarray(d2))
    dot = jnp.asarray(b1) @ jnp.asarray(b2).T  # [N, M] f32, exact (≤256)
    ham = np.array((NBITS - dot) / 2.0)  # writable host copy
    if valid1 is not None:
        ham[~np.asarray(valid1)] = NBITS + 1
    if valid2 is not None:
        ham[:, ~np.asarray(valid2)] = NBITS + 1
    if ham.size == 0:
        return np.zeros((0, 2), np.int32)
    best2 = np.partition(ham, 1, axis=1)[:, :2] if ham.shape[1] > 1 else None
    j = np.argmin(ham, axis=1)
    i = np.arange(ham.shape[0])
    d_best = ham[i, j]
    keep = d_best <= NBITS
    if best2 is not None:
        # Strict inequality: an exact tie (ambiguous top-2) must reject —
        # at best == second == 0 any epsilon slack would wrongly keep it.
        keep &= d_best < ratio * best2[:, 1]
    # mutual cross-check
    back = np.argmin(ham, axis=0)
    keep &= back[j] == i
    return np.stack([i[keep], j[keep]], axis=-1).astype(np.int32)


def _bits_pm1(desc: np.ndarray) -> np.ndarray:
    """u32 [K, 8] → ±1 float32 [K, 256] (one vectorized shift)."""
    shifts = np.arange(32, dtype=np.uint32)
    bits = ((desc[:, :, None] >> shifts) & 1).reshape(desc.shape[0], NBITS)
    return bits.astype(np.float32) * 2.0 - 1.0


# ---------------------------------------------------------------------------
# NumPy oracle
# ---------------------------------------------------------------------------


def brief_descriptors_numpy(
    gray: np.ndarray, pts: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    from . import golden

    h, w = gray.shape
    half = PATCH // 2
    blurred = golden.gaussian5_u8(gray).astype(np.int64)
    pat = brief_pattern()
    descs = np.zeros((len(pts), 8), np.uint32)
    valid = np.zeros(len(pts), bool)
    for k, (px, py) in enumerate(np.asarray(pts, np.float64)):
        x = int(np.round(px))
        y = int(np.round(py))
        if not (half <= x <= w - 1 - half and half <= y <= h - 1 - half):
            continue
        valid[k] = True
        patch = blurred[y - half : y + half + 1, x - half : x + half + 1]
        for b in range(NBITS):
            y1, x1, y2, x2 = pat[b]
            if patch[y1 + half, x1 + half] > patch[y2 + half, x2 + half]:
                descs[k, b // 32] |= np.uint32(1) << np.uint32(b % 32)
    return descs, valid


# ---------------------------------------------------------------------------
# ORB: intensity-centroid orientation + steered (rotated) BRIEF
# ---------------------------------------------------------------------------

ORB_RADIUS = 15  # orientation patch half-side (31x31, circular mask)
ORB_NBINS = 30  # angle discretization for the steered pattern (12 deg)


@lru_cache(maxsize=1)
def _centroid_masks() -> Tuple[np.ndarray, np.ndarray]:
    """x- and y-coordinate planes over the 31x31 circular patch."""
    r = ORB_RADIUS
    t = np.arange(-r, r + 1, dtype=np.float32)
    xx, yy = np.meshgrid(t, t)
    circ = (xx * xx + yy * yy <= r * r).astype(np.float32)
    return (xx * circ), (yy * circ)


@lru_cache(maxsize=1)
def _steered_offsets() -> Tuple[np.ndarray, np.ndarray]:
    """Flat patch indices of both pattern points for every angle bin:
    ([NBINS, 256] o1, [NBINS, 256] o2) int32. Rotated offsets are rounded
    then clipped to the 33x33 patch (same clip rule as the base pattern)."""
    half = PATCH // 2
    pat = brief_pattern().astype(np.float64)  # [256, 4] (y1, x1, y2, x2)
    o1 = np.zeros((ORB_NBINS, NBITS), np.int32)
    o2 = np.zeros((ORB_NBINS, NBITS), np.int32)
    for b in range(ORB_NBINS):
        th = 2.0 * np.pi * b / ORB_NBINS
        c, s = np.cos(th), np.sin(th)

        def rot(y, x):
            rx = np.clip(np.round(x * c - y * s), -half, half).astype(np.int32)
            ry = np.clip(np.round(x * s + y * c), -half, half).astype(np.int32)
            return (ry + half) * PATCH + (rx + half)

        o1[b] = rot(pat[:, 0], pat[:, 1])
        o2[b] = rot(pat[:, 2], pat[:, 3])
    return o1, o2


@jax.jit
def orb_orientations(gray: jax.Array, pts: jax.Array) -> jax.Array:
    """Intensity-centroid angle (radians, [0, 2pi)) per keypoint: m10/m01
    moments over the circular 31x31 patch (ORB's orientation). Patches are
    ONE dynamic_slice each (origin clamped at borders — the angle near an
    edge uses the shifted patch, matching the oracle)."""
    h, w = gray.shape
    r = ORB_RADIUS
    side = 2 * r + 1
    g = gray.astype(jnp.float32)
    mx, my = _centroid_masks()
    mxj, myj = jnp.asarray(mx), jnp.asarray(my)

    def one(pt):
        x = jnp.round(pt[0]).astype(jnp.int32)
        y = jnp.round(pt[1]).astype(jnp.int32)
        patch = jax.lax.dynamic_slice(
            g,
            (jnp.clip(y - r, 0, h - side), jnp.clip(x - r, 0, w - side)),
            (side, side),
        )
        m10 = jnp.sum(patch * mxj)
        m01 = jnp.sum(patch * myj)
        th = jnp.arctan2(m01, m10)
        return jnp.where(th < 0, th + 2 * jnp.pi, th)

    return jax.vmap(one)(pts)


@jax.jit
def orb_descriptors(gray: jax.Array, pts: jax.Array, angles: jax.Array):
    """Steered BRIEF-256: like brief_descriptors but the pair pattern is
    rotated by each keypoint's angle, discretized to ORB_NBINS bins (the
    OpenCV ORB scheme, orb.cpp role). Returns (desc u32 [K, 8], valid)."""
    h, w = gray.shape
    half = PATCH // 2
    blurred = gaussian5_u8(gray, has_channels=False).astype(jnp.int32)
    o1t, o2t = _steered_offsets()
    o1t, o2t = jnp.asarray(o1t), jnp.asarray(o2t)
    word = jnp.arange(NBITS, dtype=jnp.int32) // 32
    bit = jnp.arange(NBITS, dtype=jnp.int32) % 32
    two_pi = 2.0 * np.pi

    def one(pt, th):
        x = jnp.round(pt[0]).astype(jnp.int32)
        y = jnp.round(pt[1]).astype(jnp.int32)
        ok = (x >= half) & (x <= w - 1 - half) & (y >= half) & (y <= h - 1 - half)
        b = jnp.floor(jnp.mod(th, two_pi) / two_pi * ORB_NBINS).astype(jnp.int32)
        b = jnp.clip(b, 0, ORB_NBINS - 1)
        patch = jax.lax.dynamic_slice(
            blurred,
            (jnp.clip(y - half, 0, h - PATCH), jnp.clip(x - half, 0, w - PATCH)),
            (PATCH, PATCH),
        ).reshape(-1)
        bits = (jnp.take(patch, o1t[b]) > jnp.take(patch, o2t[b])).astype(jnp.uint32)
        desc = jnp.zeros(8, jnp.uint32)
        desc = desc.at[word].add(bits << bit.astype(jnp.uint32))
        return jnp.where(ok, desc, 0), ok

    return jax.vmap(one)(pts, angles)


def orb_orientations_numpy(gray: np.ndarray, pts: np.ndarray) -> np.ndarray:
    h, w = gray.shape
    r = ORB_RADIUS
    side = 2 * r + 1
    mx, my = _centroid_masks()
    out = np.zeros(len(pts), np.float64)
    g = gray.astype(np.float64)
    for k, (px, py) in enumerate(np.asarray(pts, np.float64)):
        x = int(np.round(px))
        y = int(np.round(py))
        y0 = min(max(y - r, 0), h - side)
        x0 = min(max(x - r, 0), w - side)
        patch = g[y0 : y0 + side, x0 : x0 + side]
        th = np.arctan2(np.sum(patch * my), np.sum(patch * mx))
        out[k] = th + 2 * np.pi if th < 0 else th
    return out


def orb_descriptors_numpy(
    gray: np.ndarray, pts: np.ndarray, angles: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    from . import golden

    h, w = gray.shape
    half = PATCH // 2
    blurred = golden.gaussian5_u8(gray).astype(np.int64)
    o1t, o2t = _steered_offsets()
    descs = np.zeros((len(pts), 8), np.uint32)
    valid = np.zeros(len(pts), bool)
    for k, (px, py) in enumerate(np.asarray(pts, np.float64)):
        x = int(np.round(px))
        y = int(np.round(py))
        if not (half <= x <= w - 1 - half and half <= y <= h - 1 - half):
            continue
        valid[k] = True
        b = int(np.floor(np.mod(angles[k], 2 * np.pi) / (2 * np.pi) * ORB_NBINS))
        b = min(max(b, 0), ORB_NBINS - 1)
        patch = blurred[y - half : y + half + 1, x - half : x + half + 1].reshape(-1)
        for i in range(NBITS):
            if patch[o1t[b, i]] > patch[o2t[b, i]]:
                descs[k, i // 32] |= np.uint32(1) << np.uint32(i % 32)
    return descs, valid
