"""Two-view epipolar geometry (OpenCV ``findFundamentalMat`` /
``computeCorrespondEpilines`` / ``triangulatePoints`` roles).

The reference has no multi-view geometry; OpenCV-parity addition in the
findHomography family (ops/geometry.py). Host float64 point math by the
same device split as ops/calib.py: correspondence counts are tiny (tens to
thousands), far below device break-even — the per-pixel consumers
(stereo remap, disparity reprojection) are the device side.

Frozen specs (all float64, deterministic):
- 8-point fit: Hartley-normalized (centroid → 0, RMS → √2) linear
  system, rank-2 enforcement by zeroing the smallest singular value,
  denormalized as T2ᵀ F T1, scaled so ‖F‖_F = 1 with a sign convention
  (largest-|entry| positive);
- RANSAC: seeded `default_rng`, 8-point minimal samples, Sampson
  distance gating, best-consensus refit on inliers (the exact protocol
  of geometry.find_homography);
- Sampson distance: (x₂ᵀFx₁)² / ((Fx₁)₀² + (Fx₁)₁² + (Fᵀx₂)₀² +
  (Fᵀx₂)₁²), thresholded at ``thresh²``;
- triangulation: per-point 4×4 DLT (two rows per view from P), smallest
  right singular vector, returned as (N, 4) homogeneous (callers divide
  by w — OpenCV's ``triangulatePoints`` convention transposed).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _normalize(pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Hartley normalization → (T 3×3, normalized (N, 2))."""
    c = pts.mean(axis=0)
    d = np.sqrt(((pts - c) ** 2).sum(axis=1)).mean()
    s = np.sqrt(2.0) / max(d, 1e-12)
    t = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1.0]])
    return t, (pts - c) * s


def fit_fundamental_8point(src: np.ndarray,
                           dst: np.ndarray) -> Optional[np.ndarray]:
    """Normalized 8-point fit → F 3×3 with ``dstᵀ F src = 0`` (needs
    ≥ 8 correspondences; rank-2 enforced)."""
    src = np.asarray(src, np.float64).reshape(-1, 2)
    dst = np.asarray(dst, np.float64).reshape(-1, 2)
    if len(src) < 8 or len(src) != len(dst):
        return None
    t1, p1 = _normalize(src)
    t2, p2 = _normalize(dst)
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    a = np.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                  np.ones_like(x1)], axis=1)
    try:
        _, _, vt = np.linalg.svd(a)
    except np.linalg.LinAlgError:
        return None
    f = vt[-1].reshape(3, 3)
    u, s, vtf = np.linalg.svd(f)
    f = u @ np.diag([s[0], s[1], 0.0]) @ vtf
    f = t2.T @ f @ t1
    n = np.linalg.norm(f)
    if n < 1e-12:
        return None
    f = f / n
    ij = np.unravel_index(np.argmax(np.abs(f)), f.shape)
    return f if f[ij] >= 0 else -f


def sampson_distance(f: np.ndarray, src: np.ndarray,
                     dst: np.ndarray) -> np.ndarray:
    """First-order geometric (Sampson) distance per correspondence."""
    src = np.asarray(src, np.float64).reshape(-1, 2)
    dst = np.asarray(dst, np.float64).reshape(-1, 2)
    h1 = np.concatenate([src, np.ones((len(src), 1))], axis=1)
    h2 = np.concatenate([dst, np.ones((len(dst), 1))], axis=1)
    fx1 = h1 @ f.T        # F x1  (N, 3)
    ftx2 = h2 @ f         # Fᵀ x2 (N, 3)
    num = np.sum(h2 * fx1, axis=1) ** 2
    den = fx1[:, 0] ** 2 + fx1[:, 1] ** 2 + ftx2[:, 0] ** 2 + ftx2[:, 1] ** 2
    return num / np.maximum(den, 1e-12)


def find_fundamental_mat(
    src_pts,
    dst_pts,
    ransac_thresh: float = 3.0,
    iters: int = 200,
    seed: int = 7,
    method: str = "ransac",
) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """Fundamental matrix (OpenCV ``findFundamentalMat`` role) →
    (F float64 3×3 or None, inlier mask). ``method`` = "ransac" |
    "8point" (all points, mask all-True). Deterministic per seed."""
    src = np.asarray(src_pts, np.float64).reshape(-1, 2)
    dst = np.asarray(dst_pts, np.float64).reshape(-1, 2)
    n = len(src)
    if n != len(dst) or n < 8:
        return None, np.zeros(n, bool)
    if method == "8point":
        f = fit_fundamental_8point(src, dst)
        return f, np.ones(n, bool) if f is not None else np.zeros(n, bool)
    if method != "ransac":
        raise ValueError(f"unknown method {method!r}")
    rng = np.random.default_rng(seed)
    t2 = ransac_thresh * ransac_thresh
    best_mask = np.zeros(n, bool)
    best_f = None
    for _ in range(iters):
        idx = rng.choice(n, size=8, replace=False)
        f = fit_fundamental_8point(src[idx], dst[idx])
        if f is None:
            continue
        mask = sampson_distance(f, src, dst) < t2
        if mask.sum() > best_mask.sum():
            best_mask = mask
            best_f = f
    if best_f is None or best_mask.sum() < 8:
        return None, np.zeros(n, bool)
    refined = fit_fundamental_8point(src[best_mask], dst[best_mask])
    if refined is not None:
        best_mask = sampson_distance(refined, src, dst) < t2
        best_f = refined
    return best_f, best_mask


def compute_correspond_epilines(points, which_image: int,
                                f: np.ndarray) -> np.ndarray:
    """Epipolar lines in the OTHER image for ``points`` from image
    ``which_image`` ∈ {1, 2} → (N, 3) lines (a, b, c), a²+b² = 1
    (OpenCV ``computeCorrespondEpilines`` role)."""
    pts = np.asarray(points, np.float64).reshape(-1, 2)
    h = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
    if which_image == 1:
        lines = h @ np.asarray(f, np.float64).T   # l2 = F x1
    elif which_image == 2:
        lines = h @ np.asarray(f, np.float64)     # l1 = Fᵀ x2
    else:
        raise ValueError("which_image must be 1 or 2")
    nrm = np.sqrt(lines[:, 0] ** 2 + lines[:, 1] ** 2)
    return lines / np.maximum(nrm, 1e-12)[:, None]


def _normalize_by_k(pts: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Pixel points → normalized camera coordinates (K⁻¹ x)."""
    k = np.asarray(k, np.float64)
    x = (pts[:, 0] - k[0, 2]) / k[0, 0]
    y = (pts[:, 1] - k[1, 2]) / k[1, 1]
    return np.stack([x, y], axis=1)


def _project_to_essential(f: np.ndarray) -> np.ndarray:
    """Nearest essential matrix: singular values → (σ, σ, 0),
    σ = (s₀+s₁)/2, then ‖E‖_F = √2 with the 8-point sign convention."""
    u, s, vt = np.linalg.svd(f)
    sig = 0.5 * (s[0] + s[1])
    if sig < 1e-12:
        return f
    e = u @ np.diag([sig, sig, 0.0]) @ vt
    e = e * (np.sqrt(2.0) / np.linalg.norm(e))
    ij = np.unravel_index(np.argmax(np.abs(e)), e.shape)
    return e if e[ij] >= 0 else -e


def find_essential_mat(
    src_pts,
    dst_pts,
    k1: np.ndarray,
    k2: Optional[np.ndarray] = None,
    ransac_thresh: float = 1.0,
    iters: int = 200,
    seed: int = 7,
    method: str = "ransac",
) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """Essential matrix (OpenCV ``findEssentialMat`` role) →
    (E float64 3×3 or None, inlier mask), with ``x̂₂ᵀ E x̂₁ = 0`` on
    K-normalized points. ``ransac_thresh`` is in PIXELS (internally
    scaled by the mean focal length, OpenCV's convention).

    Frozen spec (documented divergence from OpenCV): the minimal solver
    is the normalized 8-point fit projected onto the essential manifold
    (σ, σ, 0) — not Nistér's 5-point — with seeded-RANSAC Sampson gating
    in normalized coordinates and a final inlier refit. Same role, same
    return contract, deterministic per seed."""
    src = np.asarray(src_pts, np.float64).reshape(-1, 2)
    dst = np.asarray(dst_pts, np.float64).reshape(-1, 2)
    n = len(src)
    if n != len(dst) or n < 8:
        return None, np.zeros(n, bool)
    k1 = np.asarray(k1, np.float64)
    k2 = k1 if k2 is None else np.asarray(k2, np.float64)
    p1 = _normalize_by_k(src, k1)
    p2 = _normalize_by_k(dst, k2)
    focal = 0.25 * (k1[0, 0] + k1[1, 1] + k2[0, 0] + k2[1, 1])
    t2 = (ransac_thresh / focal) ** 2

    def fit(a, b):
        f = fit_fundamental_8point(a, b)
        return None if f is None else _project_to_essential(f)

    if method == "8point":
        e = fit(p1, p2)
        return e, np.ones(n, bool) if e is not None else np.zeros(n, bool)
    if method != "ransac":
        raise ValueError(f"unknown method {method!r}")
    rng = np.random.default_rng(seed)
    best_mask = np.zeros(n, bool)
    best_e = None
    for _ in range(iters):
        idx = rng.choice(n, size=8, replace=False)
        e = fit(p1[idx], p2[idx])
        if e is None:
            continue
        mask = sampson_distance(e, p1, p2) < t2
        if mask.sum() > best_mask.sum():
            best_mask = mask
            best_e = e
    if best_e is None or best_mask.sum() < 8:
        return None, np.zeros(n, bool)
    refined = fit(p1[best_mask], p2[best_mask])
    if refined is not None:
        best_mask = sampson_distance(refined, p1, p2) < t2
        best_e = refined
    return best_e, best_mask


def decompose_essential_mat(
        e: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """E → (R1, R2, t) — the two rotations and the unit baseline of the
    four-fold ambiguity (OpenCV ``decomposeEssentialMat`` role; the four
    poses are (R1, ±t), (R2, ±t)). Hartley-Zisserman result 9.19:
    R = U W Vᵀ / U Wᵀ Vᵀ with det > 0 enforced, t = u₃."""
    e = np.asarray(e, np.float64)
    u, _, vt = np.linalg.svd(e)
    # cv2 five-point.cpp convention: W = [[0,1,0],[-1,0,0],[0,0,1]],
    # whole-R negation when det < 0 (NOT U/Vt sign fixing), t = u3 raw
    w = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    r1 = u @ w @ vt
    if np.linalg.det(r1) < 0:
        r1 = -r1
    r2 = u @ w.T @ vt
    if np.linalg.det(r2) < 0:
        r2 = -r2
    t = u[:, 2].copy()
    return r1, r2, t


def recover_pose(
    e: np.ndarray,
    src_pts,
    dst_pts,
    k: np.ndarray,
    mask: Optional[np.ndarray] = None,
) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """Cheirality-tested relative pose from E (OpenCV ``recoverPose``
    role) → (n_good, R, t, pose_mask). Each of the four (R, t)
    candidates triangulates the correspondences with P1 = [I|0],
    P2 = [R|t] on normalized points; the winner maximizes points with
    positive, finite depth in BOTH views (depth clamped at 50/‖t‖ like
    OpenCV's distance gate). ``t`` is unit length (scale is
    unobservable)."""
    src = np.asarray(src_pts, np.float64).reshape(-1, 2)
    dst = np.asarray(dst_pts, np.float64).reshape(-1, 2)
    n = len(src)
    k = np.asarray(k, np.float64)
    p1n = _normalize_by_k(src, k)
    p2n = _normalize_by_k(dst, k)
    sel = np.ones(n, bool) if mask is None else np.asarray(mask, bool)
    r1, r2, t = decompose_essential_mat(e)
    pid = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    best = (-1, None, None, None)
    for r, tv in ((r1, t), (r1, -t), (r2, t), (r2, -t)):
        p2 = np.concatenate([r, tv[:, None]], axis=1)
        x = triangulate_points(pid, p2, p1n, p2n)
        w = x[:, 3]
        w = np.where(np.abs(w) < 1e-12, 1e-12, w)
        xyz = x[:, :3] / w[:, None]
        z1 = xyz[:, 2]
        z2 = xyz @ r[2] + tv[2]
        good = sel & (z1 > 0) & (z2 > 0) & (z1 < 50.0) & (z2 < 50.0)
        score = int(good.sum())
        if score > best[0]:
            best = (score, r, tv, good)
    return best[0], best[1], best[2], best[3]


def correct_matches(f: np.ndarray, pts1,
                    pts2) -> Tuple[np.ndarray, np.ndarray]:
    """Optimal triangulation correction (OpenCV ``correctMatches`` role,
    Hartley-Zisserman algorithm 12.1): per pair, the corrected points
    (x̂₁, x̂₂) minimize geometric error subject to x̂₂ᵀ F x̂₁ = 0 EXACTLY
    — found by minimizing the 6-degree polynomial over epipolar-pencil
    parameter t (real roots + t→∞ candidate), then projecting each point
    onto its chosen epipolar line. Returns ((N, 2), (N, 2)) float64."""
    f = np.asarray(f, np.float64)
    a1 = np.asarray(pts1, np.float64).reshape(-1, 2)
    a2 = np.asarray(pts2, np.float64).reshape(-1, 2)
    if len(a1) != len(a2):
        raise ValueError("point lists must match")
    out1 = np.empty_like(a1)
    out2 = np.empty_like(a2)
    for i in range(len(a1)):
        # translate both points to the origin: with T = (origin → point),
        # x'ᵀ F x = x'_newᵀ (T2ᵀ F T1) x_new
        t1 = np.array([[1.0, 0, a1[i, 0]], [0, 1.0, a1[i, 1]], [0, 0, 1.0]])
        t2 = np.array([[1.0, 0, a2[i, 0]], [0, 1.0, a2[i, 1]], [0, 0, 1.0]])
        fi = t2.T @ f @ t1
        # epipoles (right/left null vectors), normalized e₁²+e₂² = 1
        _, _, vt = np.linalg.svd(fi)
        e1 = vt[-1]
        u, _, _ = np.linalg.svd(fi)
        e2 = u[:, -1]
        e1 = e1 / max(np.hypot(e1[0], e1[1]), 1e-300)
        e2 = e2 / max(np.hypot(e2[0], e2[1]), 1e-300)
        # rotations putting epipoles on the x-axis
        r1 = np.array([[e1[0], e1[1], 0], [-e1[1], e1[0], 0], [0, 0, 1.0]])
        r2 = np.array([[e2[0], e2[1], 0], [-e2[1], e2[0], 0], [0, 0, 1.0]])
        fr = r2 @ fi @ r1.T
        fc1, fc2 = e1[2], e2[2]
        a, b, c, d = fr[1, 1], fr[1, 2], fr[2, 1], fr[2, 2]
        # g(t) = t((at+b)² + f₂²(ct+d)²)² − (ad−bc)(1+f₁²t²)²(at+b)(ct+d):
        # the derivative numerator of the HZ cost (degree ≤ 6)
        p_t = np.poly1d([1.0, 0.0])
        atb = np.poly1d([a, b])
        ctd = np.poly1d([c, d])
        one_f1t = np.poly1d([fc1 * fc1, 0.0, 1.0])
        inner = atb * atb + (fc2 * fc2) * (ctd * ctd)
        g = p_t * inner * inner \
            - np.poly1d([a * d - b * c]) * one_f1t * one_f1t * atb * ctd
        coeffs = np.trim_zeros(g.coeffs, "f")
        cands = []
        if len(coeffs) > 1:
            roots = np.roots(coeffs)
            cands = [float(r.real) for r in roots if abs(r.imag) < 1e-9]

        def cost(t):
            return (t * t) / (1.0 + fc1 * fc1 * t * t) + (
                (c * t + d) ** 2
                / max((a * t + b) ** 2 + fc2 * fc2 * (c * t + d) ** 2, 1e-300)
            )

        best_t, best_cost = None, 1.0 / max(fc1 * fc1, 1e-300) + (
            c * c / max(a * a + fc2 * fc2 * c * c, 1e-300))  # t → ∞
        for t in cands:
            ct = cost(t)
            if ct < best_cost:
                best_cost, best_t = ct, t
        if best_t is None:
            l1 = np.array([fc1, 0.0, -1.0])       # t → ∞ epipolar lines
            l2 = np.array([-fc2 * c, a, c])
        else:
            t = best_t
            l1 = np.array([t * fc1, 1.0, -t])
            l2 = np.array([-fc2 * (c * t + d), a * t + b, c * t + d])

        def closest(l):
            # closest point on line (λ, μ, ν) to the origin, homogeneous
            return np.array([-l[0] * l[2], -l[1] * l[2],
                             l[0] * l[0] + l[1] * l[1]])

        x1 = t1 @ r1.T @ closest(l1)
        x2 = t2 @ r2.T @ closest(l2)
        out1[i] = x1[:2] / x1[2]
        out2[i] = x2[:2] / x2[2]
    return out1, out2


def triangulate_points(p1: np.ndarray, p2: np.ndarray, pts1,
                       pts2) -> np.ndarray:
    """DLT triangulation (OpenCV ``triangulatePoints`` role):
    3×4 projections P1/P2 + (N, 2) pixel points → (N, 4) homogeneous."""
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    a1 = np.asarray(pts1, np.float64).reshape(-1, 2)
    a2 = np.asarray(pts2, np.float64).reshape(-1, 2)
    if len(a1) != len(a2):
        raise ValueError("point lists must match")
    out = np.empty((len(a1), 4))
    for i in range(len(a1)):
        a = np.stack([
            a1[i, 0] * p1[2] - p1[0],
            a1[i, 1] * p1[2] - p1[1],
            a2[i, 0] * p2[2] - p2[0],
            a2[i, 1] * p2[2] - p2[1],
        ])
        _, _, vt = np.linalg.svd(a)
        out[i] = vt[-1]
    return out
