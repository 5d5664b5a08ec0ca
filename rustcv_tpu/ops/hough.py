"""Standard Hough line transform — accumulator as one-hot matmuls.

The classical accumulator is a scatter (hostile on the device); here each theta's
rho-histogram is an matrix unit contraction instead:

1. edge pixels compact to a static-size coordinate list (top_k over the
   edge mask — the jit-friendly contract, like harris_corner_list);
2. for every theta, rho = x·cosθ + y·sinθ quantizes to ``rho_bins``; the
   12-bit bin splits into two 64-wide one-hots and a batched einsum
   ``[T, N, 64] × [T, N, 64] → [T, 64, 64]`` accumulates all votes —
   exact integer counts in f32 (N < 2^24);
3. peaks: threshold + 3×3 NMS on the (theta, rho) accumulator, top-K.

Returns OpenCV-style (rho, theta) pairs. Frozen spec: float32 cos/sin
tables from float64, round-half-even bin quantization.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp


@partial(
    jax.jit,
    static_argnames=("n_thetas", "rho_bins", "max_points", "max_lines"),
)
def hough_lines(
    edges: jax.Array,
    n_thetas: int = 180,
    rho_bins: int = 2048,
    max_points: int = 65536,
    max_lines: int = 32,
    threshold: int = 50,
):
    """Binary edge mask (H, W) u8 → (lines [max_lines, 2] float32
    (rho, theta-radians), valid bool, votes int32).

    ``rho`` spans [−D, D] (D = image diagonal) over ``rho_bins`` bins;
    thetas cover [0, π). Edge points beyond ``max_points`` are dropped
    (strongest-first is meaningless for a binary mask — raster order)."""
    h, w = edges.shape
    diag = float(np.hypot(h, w))
    # 1. compact edge coordinates (static size; padding votes weight 0)
    flat = (edges.reshape(-1) != 0).astype(jnp.float32)
    score = flat - jnp.arange(h * w, dtype=jnp.float32) * 1e-9  # stable raster order
    top, idx = jax.lax.top_k(score, min(max_points, h * w))
    weight = (top > 0.5).astype(jnp.float32)
    ys = (idx // w).astype(jnp.float32)
    xs = (idx % w).astype(jnp.float32)

    thetas = np.arange(n_thetas, dtype=np.float64) * (np.pi / n_thetas)
    cos_t = jnp.asarray(np.cos(thetas).astype(np.float32))
    sin_t = jnp.asarray(np.sin(thetas).astype(np.float32))

    # 2. rho bins per theta: [T, N]
    rho = cos_t[:, None] * xs[None, :] + sin_t[:, None] * ys[None, :]
    binf = (rho + diag) * (rho_bins - 1) / (2.0 * diag)
    b = jnp.clip(jnp.round(binf), 0, rho_bins - 1).astype(jnp.int32)
    hi = b >> 6  # rho_bins must be <= 4096 (64*64)
    lo = b & 63
    lanes = jnp.arange(64, dtype=jnp.int32)
    oh_hi = (hi[..., None] == lanes).astype(jnp.float32) * weight[None, :, None]
    oh_lo = (lo[..., None] == lanes).astype(jnp.float32)
    acc = jnp.einsum(
        "tnh,tnl->thl", oh_hi, oh_lo, precision=jax.lax.Precision.HIGHEST
    ).reshape(n_thetas, 64 * 64)[:, :rho_bins].astype(jnp.int32)

    # 3. peaks: threshold + 3×3 NMS on (theta, rho)
    votes = acc
    best = votes
    for dt in (-1, 0, 1):
        for dr in (-1, 0, 1):
            if dt == 0 and dr == 0:
                continue
            best = jnp.maximum(best, jnp.roll(jnp.roll(votes, dt, 0), dr, 1))
    peak = (votes >= best) & (votes >= threshold)
    flat_v = jnp.where(peak, votes, 0).reshape(-1)
    topv, pidx = jax.lax.top_k(flat_v, max_lines)
    t_idx = pidx // rho_bins
    r_idx = pidx % rho_bins
    rho_val = r_idx.astype(jnp.float32) * (2.0 * diag) / (rho_bins - 1) - diag
    theta_val = t_idx.astype(jnp.float32) * float(np.pi / n_thetas)
    return (
        jnp.stack([rho_val, theta_val], axis=-1),
        topv > 0,
        topv,
    )


# ---------------------------------------------------------------------------
# NumPy oracle (classical accumulator, same quantization)
# ---------------------------------------------------------------------------


def hough_lines_numpy(
    edges: np.ndarray,
    n_thetas: int = 180,
    rho_bins: int = 2048,
    threshold: int = 50,
    max_lines: int = 32,
) -> Tuple[np.ndarray, np.ndarray]:
    h, w = edges.shape
    diag = float(np.hypot(h, w))
    ys, xs = np.nonzero(edges)
    thetas = np.arange(n_thetas, dtype=np.float64) * (np.pi / n_thetas)
    cos_t = np.cos(thetas).astype(np.float32)
    sin_t = np.sin(thetas).astype(np.float32)
    acc = np.zeros((n_thetas, rho_bins), np.int64)
    xf = xs.astype(np.float32)
    yf = ys.astype(np.float32)
    for t in range(n_thetas):
        rho = cos_t[t] * xf + sin_t[t] * yf
        # mirror the device's f32 op order exactly: (+) then (×) then (÷)
        binf = (
            (rho + np.float32(diag)) * np.float32(rho_bins - 1)
        ) / np.float32(2.0 * diag)
        b = np.clip(np.round(binf), 0, rho_bins - 1).astype(np.int64)
        np.add.at(acc[t], b, 1)
    best = acc.copy()
    for dt in (-1, 0, 1):
        for dr in (-1, 0, 1):
            if dt == 0 and dr == 0:
                continue
            best = np.maximum(best, np.roll(np.roll(acc, dt, 0), dr, 1))
    peak = (acc >= best) & (acc >= threshold)
    flat = np.where(peak, acc, 0).reshape(-1)
    order = np.argsort(-flat, kind="stable")[:max_lines]
    keep = flat[order] > 0
    order = order[keep]
    t_idx = order // rho_bins
    r_idx = order % rho_bins
    rho_val = r_idx * (2.0 * diag) / (rho_bins - 1) - diag
    theta_val = t_idx * (np.pi / n_thetas)
    return np.stack([rho_val, theta_val], axis=-1), flat[order]


# ---------------------------------------------------------------------------
# HoughCircles — 2-D center accumulator as a hi/lo one-hot OUTER-PRODUCT
# ---------------------------------------------------------------------------


@partial(
    jax.jit,
    static_argnames=("dp", "min_radius", "max_radius", "max_points",
                     "max_circles", "edge_threshold", "vote_threshold"),
)
def hough_circles(
    gray: jax.Array,
    dp: int = 4,
    min_radius: int = 10,
    max_radius: int = 60,
    edge_threshold: int = 60,
    vote_threshold: int = 20,
    max_points: int = 4096,
    max_circles: int = 16,
):
    """Gradient (2-1) Hough circle transform (OpenCV ``HoughCircles``
    HOUGH_GRADIENT role) on u8 gray (H, W) → (circles [K, 3] float32
    (cx, cy, r), valid bool, votes int32). Callers apply min-dist dedup
    (the facade does greedy suppression on the returned top-K).

    Device formulation: the classical 2-D center accumulator is a scatter;
    here the flat center bin splits hi/lo (9 bits each) and each radius
    step accumulates votes as ONE [512, 2N]×[2N, 512] matmul inside a
    lax.scan over radii (center grid ≤ 512² bins ⇒ H/dp·W/dp ≤ 262144).
    Both gradient directions vote (bright-on-dark and dark-on-bright).
    Radius recovery: per peak center, an [N, R] one-hot distance
    histogram → argmax, again a matmul. Frozen spec: f32 arithmetic,
    round-half-even bin quantization, Sobel-3 gradients (golden spec).
    """
    from .filters import sobel3_gray

    h, w = gray.shape
    hq, wq = (h + dp - 1) // dp, (w + dp - 1) // dp
    if hq * wq > 512 * 512:
        raise ValueError("H/dp * W/dp must be <= 262144 (raise dp)")
    n_r = max_radius - min_radius + 1

    gx, gy = sobel3_gray(gray)
    mag2 = gx * gx + gy * gy
    edge = mag2 > edge_threshold * edge_threshold
    # compact edges (static size, raster order)
    flat = edge.reshape(-1).astype(jnp.float32)
    score = flat - jnp.arange(h * w, dtype=jnp.float32) * 1e-9
    top, idx = jax.lax.top_k(score, min(max_points, h * w))
    weight = (top > 0.5).astype(jnp.float32)
    ys = (idx // w).astype(jnp.float32)
    xs = (idx % w).astype(jnp.float32)
    gxe = jnp.take(gx.reshape(-1), idx).astype(jnp.float32)
    gye = jnp.take(gy.reshape(-1), idx).astype(jnp.float32)
    inv = 1.0 / jnp.sqrt(jnp.maximum(gxe * gxe + gye * gye, 1.0))
    nx = gxe * inv
    ny = gye * inv

    lanes = jnp.arange(512, dtype=jnp.int32)

    def vote(acc, r):
        # both directions: center = p -/+ r*n
        cx = jnp.concatenate([xs - r * nx, xs + r * nx])
        cy = jnp.concatenate([ys - r * ny, ys + r * ny])
        wgt = jnp.concatenate([weight, weight])
        qx = jnp.round(cx / dp).astype(jnp.int32)
        qy = jnp.round(cy / dp).astype(jnp.int32)
        ok = (qx >= 0) & (qx < wq) & (qy >= 0) & (qy < hq)
        b = jnp.where(ok, qy * wq + qx, 0)
        wgt = wgt * ok.astype(jnp.float32)
        hi = b >> 9
        lo = b & 511
        oh_hi = (hi[:, None] == lanes).astype(jnp.float32) * wgt[:, None]
        oh_lo = (lo[:, None] == lanes).astype(jnp.float32)
        acc = acc + jnp.einsum(
            "nh,nl->hl", oh_hi, oh_lo, precision=jax.lax.Precision.HIGHEST
        )
        return acc, 0.0

    radii = jnp.arange(min_radius, max_radius + 1, dtype=jnp.float32)
    acc, _ = jax.lax.scan(vote, jnp.zeros((512, 512), jnp.float32), radii)
    acc = acc.reshape(512 * 512)[: hq * wq].reshape(hq, wq)

    # center peaks: 3x3 NMS + top-K
    best = acc
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            best = jnp.maximum(best, jnp.roll(jnp.roll(acc, dy, 0), dx, 1))
    peak = (acc >= best) & (acc >= jnp.float32(vote_threshold))
    flat_v = jnp.where(peak, acc, 0.0).reshape(-1)
    topv, pidx = jax.lax.top_k(flat_v, max_circles)
    pcy = (pidx // wq).astype(jnp.float32) * dp
    pcx = (pidx % wq).astype(jnp.float32) * dp

    # radius per center: [K, N] distances -> [K, R] one-hot histogram
    dx = xs[None, :] - pcx[:, None]
    dy = ys[None, :] - pcy[:, None]
    dist = jnp.sqrt(dx * dx + dy * dy)
    rbin = jnp.round(dist).astype(jnp.int32) - min_radius
    okr = (rbin >= 0) & (rbin < n_r)
    oh_r = (rbin[..., None] == jnp.arange(n_r)).astype(jnp.float32)
    oh_r = oh_r * (okr & (weight[None, :] > 0.5))[..., None].astype(jnp.float32)
    rhist = jnp.sum(oh_r, axis=1)  # [K, R]
    r_best = jnp.argmax(rhist, axis=1)
    r_votes = jnp.max(rhist, axis=1)
    radius = (r_best + min_radius).astype(jnp.float32)

    circ = jnp.stack([pcx, pcy, radius], axis=-1)
    valid = (topv > 0) & (r_votes >= jnp.float32(vote_threshold))
    # order by FINAL (radius-histogram) votes — satellite center bins of a
    # strong circle out-vote it on the center grid but not on the radius
    rank = jnp.where(valid, r_votes, -1.0)
    _, order = jax.lax.top_k(rank, max_circles)
    return circ[order], valid[order], r_votes[order].astype(jnp.int32)


def hough_circles_numpy(
    gray: np.ndarray,
    dp: int = 4,
    min_radius: int = 10,
    max_radius: int = 60,
    edge_threshold: int = 60,
    vote_threshold: int = 20,
    max_points: int = 4096,
    max_circles: int = 16,
):
    """Oracle — classical scatter accumulator, same f32 quantization."""
    from . import golden

    h, w = gray.shape
    hq, wq = (h + dp - 1) // dp, (w + dp - 1) // dp
    n_r = max_radius - min_radius + 1
    gx, gy = golden.sobel3_gray(gray)
    edge = (gx.astype(np.int64) ** 2 + gy.astype(np.int64) ** 2
            > edge_threshold * edge_threshold)
    ys_a, xs_a = np.nonzero(edge)
    order = np.arange(len(ys_a))[:max_points]  # raster order, same cap
    ys = ys_a[order].astype(np.float32)
    xs = xs_a[order].astype(np.float32)
    gxe = gx[ys_a[order], xs_a[order]].astype(np.float32)
    gye = gy[ys_a[order], xs_a[order]].astype(np.float32)
    inv = np.float32(1.0) / np.sqrt(np.maximum(gxe * gxe + gye * gye,
                                               np.float32(1.0)))
    nx, ny = gxe * inv, gye * inv
    acc = np.zeros((hq, wq), np.float64)
    for r in np.arange(min_radius, max_radius + 1, dtype=np.float32):
        for sgn in (-1.0, 1.0):
            cx = xs + np.float32(sgn) * (r * nx)
            cy = ys + np.float32(sgn) * (r * ny)
            qx = np.round(cx / np.float32(dp)).astype(np.int64)
            qy = np.round(cy / np.float32(dp)).astype(np.int64)
            ok = (qx >= 0) & (qx < wq) & (qy >= 0) & (qy < hq)
            np.add.at(acc, (qy[ok], qx[ok]), 1.0)
    best = acc.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            best = np.maximum(best, np.roll(np.roll(acc, dy, 0), dx, 1))
    peak = (acc >= best) & (acc >= vote_threshold)
    flat = np.where(peak, acc, 0.0).reshape(-1)
    order2 = np.argsort(-flat, kind="stable")[:max_circles]
    out, votes = [], []
    for p in order2:
        if flat[p] <= 0:
            continue
        pcy = (p // wq) * dp
        pcx = (p % wq) * dp
        dist = np.sqrt((xs - np.float32(pcx)) ** 2 + (ys - np.float32(pcy)) ** 2)
        rbin = np.round(dist).astype(np.int64) - min_radius
        okr = (rbin >= 0) & (rbin < n_r)
        rhist = np.bincount(rbin[okr], minlength=n_r)
        rb = int(np.argmax(rhist))
        if rhist[rb] >= vote_threshold:
            out.append((float(pcx), float(pcy), float(rb + min_radius)))
            votes.append(int(rhist[rb]))
    out = np.array(out, np.float32).reshape(-1, 3)
    votes = np.array(votes, np.int32)
    order = np.argsort(-votes, kind="stable")  # final-vote order (device match)
    return out[order], votes[order]


def hough_lines_p(
    edges,
    n_thetas: int = 180,
    rho_bins: int = 2048,
    threshold: int = 50,
    min_line_length: float = 30.0,
    max_line_gap: float = 5.0,
    max_lines: int = 32,
    max_segments: int = 64,
    tol: float = 1.0,
):
    """Line SEGMENTS (OpenCV ``HoughLinesP`` role) — deterministic spec.

    OpenCV's probabilistic variant randomly samples points and mutates the
    accumulator as it goes — inherently sequential AND nondeterministic.
    The accelerator-native reformulation is deterministic: the batched device
    accumulator (:func:`hough_lines`) finds the top peak lines, then a
    vectorized host pass walks each line's inlier points (|x·cosθ +
    y·sinθ − rho| ≤ ``tol``), sorts them by projection along the line,
    splits where consecutive-point spacing exceeds ``max_line_gap``, and
    keeps spans of at least ``min_line_length``. Returns int32
    [M, 4] (x1, y1, x2, y2), M ≤ max_segments, ordered by line strength
    then position along the line.
    """
    import numpy as np

    e = np.asarray(edges)
    lines, valid, _votes = hough_lines(
        jnp.asarray(e), n_thetas=n_thetas, rho_bins=rho_bins,
        max_lines=max_lines, threshold=threshold,
    )
    lines = np.asarray(lines)[np.asarray(valid)]
    ys, xs = np.nonzero(e)
    segs = []
    used = np.zeros(xs.shape[0], bool)
    for rho_v, theta_v in lines:
        if len(segs) >= max_segments:
            break
        c, s = np.cos(theta_v), np.sin(theta_v)
        d = np.abs(xs * c + ys * s - rho_v)
        on = (d <= tol) & ~used
        if not on.any():
            continue
        px, py = xs[on], ys[on]
        proj = -px * s + py * c
        order = np.argsort(proj, kind="stable")
        px, py, proj = px[order], py[order], proj[order]
        breaks = np.flatnonzero(np.diff(proj) > max_line_gap)
        starts = np.concatenate([[0], breaks + 1])
        ends = np.concatenate([breaks, [proj.size - 1]])
        hit = np.flatnonzero(on)[order]
        for a, b in zip(starts, ends):
            if proj[b] - proj[a] >= min_line_length:
                segs.append((px[a], py[a], px[b], py[b]))
                used[hit[a : b + 1]] = True  # points consumed, like OpenCV
                if len(segs) >= max_segments:
                    break
    if not segs:
        return np.zeros((0, 4), np.int32)
    return np.asarray(segs, np.int32)
