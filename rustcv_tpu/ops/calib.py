"""Camera model: projection, distortion, undistortion (OpenCV
``projectPoints`` / ``Rodrigues`` / ``undistort`` /
``initUndistortRectifyMap`` / ``undistortPoints`` /
``getOptimalNewCameraMatrix`` roles).

Model: pinhole K = [[fx, 0, cx], [0, fy, cy], [0, 0, 1]] with the
standard 5-coefficient radial-tangential distortion (k1, k2, p1, p2,
k3):

    x' = x(1 + k1 r² + k2 r⁴ + k3 r⁶) + 2 p1 x y + p2 (r² + 2x²)
    y' = y(1 + k1 r² + k2 r⁴ + k3 r⁶) + p1 (r² + 2y²) + 2 p2 x y

device split: table builds and point math are host float64 (tiny,
per-camera, done once); the per-pixel image resampling is the device
``remap`` packed-quad gather (ops/warp.py) with TRACED maps — changing
cameras never recompiles. This mirrors how warpPerspective builds its
tables host-side.

Frozen specs: float64 host math; undistort_points runs the fixed-count
(10) compensate iteration; get_optimal_new_camera_matrix blends the
inner (all-source-visible) and outer (bounding) rectangles of the
undistorted border grid by alpha, OpenCV-style.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def rodrigues(r: np.ndarray) -> np.ndarray:
    """Rotation vector (3,) → matrix (3, 3) (or back for (3, 3) input)."""
    r = np.asarray(r, np.float64)
    if r.shape == (3, 3):
        # matrix → vector
        a = (np.trace(r) - 1.0) / 2.0
        theta = np.arccos(np.clip(a, -1.0, 1.0))
        if theta < 1e-12:
            return np.zeros(3)
        v = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
        return theta / (2.0 * np.sin(theta)) * v
    r = r.reshape(3)
    theta = float(np.linalg.norm(r))
    if theta < 1e-12:
        return np.eye(3)
    k = r / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def _distort(x: np.ndarray, y: np.ndarray, dist) -> Tuple[np.ndarray, np.ndarray]:
    k1, k2, p1, p2, k3 = (list(np.asarray(dist, np.float64).reshape(-1)) + [0.0] * 5)[:5]
    r2 = x * x + y * y
    rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * rad + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def project_points(obj_pts: np.ndarray, rvec, tvec, K: np.ndarray,
                   dist=(0, 0, 0, 0, 0)) -> np.ndarray:
    """3-D points [N, 3] → pixel coordinates [N, 2] float64 (OpenCV
    ``projectPoints``)."""
    K = np.asarray(K, np.float64)
    R = rodrigues(np.asarray(rvec, np.float64))
    t = np.asarray(tvec, np.float64).reshape(3)
    p = np.asarray(obj_pts, np.float64).reshape(-1, 3) @ R.T + t
    x = p[:, 0] / p[:, 2]
    y = p[:, 1] / p[:, 2]
    xd, yd = _distort(x, y, dist)
    return np.stack([K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]], axis=-1)


def undistort_points(pts: np.ndarray, K: np.ndarray, dist,
                     new_K: Optional[np.ndarray] = None,
                     iters: int = 10) -> np.ndarray:
    """Distorted pixels [N, 2] → undistorted pixels [N, 2] under new_K
    (default K). Fixed 10-iteration compensation (frozen spec); cv2's
    own loop is 5 iterations — pass iters=5 where cv2-identical
    rounding matters (icvGetRectangles)."""
    K = np.asarray(K, np.float64)
    nk = K if new_K is None else np.asarray(new_K, np.float64)
    p = np.asarray(pts, np.float64).reshape(-1, 2)
    x = (p[:, 0] - K[0, 2]) / K[0, 0]
    y = (p[:, 1] - K[1, 2]) / K[1, 1]
    x0, y0 = x.copy(), y.copy()
    for _ in range(int(iters)):
        xd, yd = _distort(x, y, dist)
        x = x + (x0 - xd)
        y = y + (y0 - yd)
    return np.stack([nk[0, 0] * x + nk[0, 2], nk[1, 1] * y + nk[1, 2]], axis=-1)


def undistort_points_cv(pts: np.ndarray, K: np.ndarray, dist,
                        r: Optional[np.ndarray] = None,
                        p: Optional[np.ndarray] = None,
                        iters: int = 5) -> np.ndarray:
    """cv2's EXACT undistortPoints iteration (cvUndistortPointsInternal):
    5 rounds of the multiplicative form x = (x0 − Δ(x,y))·icdist with
    icdist = 1/(1 + k1 r² + k2 r⁴ + k3 r⁶), then optional R and P."""
    K = np.asarray(K, np.float64)
    k1, k2, p1, p2, k3 = (list(np.asarray(dist, np.float64).reshape(-1))
                          + [0.0] * 5)[:5]
    q = np.asarray(pts, np.float64).reshape(-1, 2)
    x0 = (q[:, 0] - K[0, 2]) / K[0, 0]
    y0 = (q[:, 1] - K[1, 2]) / K[1, 1]
    x, y = x0.copy(), y0.copy()
    for _ in range(int(iters)):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    h = np.stack([x, y, np.ones_like(x)], axis=0)
    if r is not None:
        h = np.asarray(r, np.float64).reshape(3, 3) @ h
    if p is not None:
        h = np.asarray(p, np.float64)[:3, :3] @ h
    return (h[:2] / h[2]).T


def init_undistort_rectify_map(K: np.ndarray, dist, new_K: Optional[np.ndarray],
                               size: Tuple[int, int],
                               r: Optional[np.ndarray] = None,
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """(w, h) → (map_x, map_y) float32 [h, w] for :func:`ops.warp.remap`
    (OpenCV ``initUndistortRectifyMap``): for every undistorted output
    pixel, the distorted source position. ``r`` is the rectification
    rotation: each output pixel is mapped through (new_K·R)⁻¹ before
    distortion, matching cv2's iR = (newK·R).inv() pipeline."""
    w, h = size
    K = np.asarray(K, np.float64)
    nk = K if new_K is None else np.asarray(new_K, np.float64)
    rm = np.eye(3) if r is None else np.asarray(r, np.float64).reshape(3, 3)
    ir = np.linalg.inv(nk @ rm)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    X = ir[0, 0] * xs + ir[0, 1] * ys + ir[0, 2]
    Y = ir[1, 0] * xs + ir[1, 1] * ys + ir[1, 2]
    W = ir[2, 0] * xs + ir[2, 1] * ys + ir[2, 2]
    x = X / W
    y = Y / W
    xd, yd = _distort(x, y, dist)
    return ((K[0, 0] * xd + K[0, 2]).astype(np.float32),
            (K[1, 1] * yd + K[1, 2]).astype(np.float32))


def _get_rectangles(K: np.ndarray, dist, size: Tuple[int, int],
                    p: Optional[np.ndarray] = None):
    """cv2's icvGetRectangles: undistort a 9×9 grid (optionally
    reprojected through P); outer = bounding box of all points, inner =
    largest axis-aligned box inside the undistorted border (grid border
    rows/cols only). Returns ((ix, iy, iw, ih), (ox, oy, ow, oh))."""
    w, h = size
    n = 9
    pts = np.array([(x * (w - 1) / (n - 1), y * (h - 1) / (n - 1))
                    for y in range(n) for x in range(n)], np.float64)
    # P=None ⇒ normalized coordinates (cv2 calls cvUndistortPoints
    # without P here); cv2's exact 5-round multiplicative iteration
    up = undistort_points_cv(pts, K, dist, p=p)
    ox0, oy0 = up[:, 0].min(), up[:, 1].min()
    ox1, oy1 = up[:, 0].max(), up[:, 1].max()
    gx = np.tile(np.arange(n), n)
    gy = np.repeat(np.arange(n), n)
    ix0 = up[gx == 0, 0].max()
    ix1 = up[gx == n - 1, 0].min()
    iy0 = up[gy == 0, 1].max()
    iy1 = up[gy == n - 1, 1].min()
    return ((ix0, iy0, ix1 - ix0, iy1 - iy0),
            (ox0, oy0, ox1 - ox0, oy1 - oy0))


def get_optimal_new_camera_matrix(K: np.ndarray, dist, size: Tuple[int, int],
                                  alpha: float = 0.0,
                                  new_size: Optional[Tuple[int, int]] = None,
                                  center_principal_point: bool = False):
    """cv2's exact construction (calibration.cpp getOptimalNewCameraMatrix):
    focal/centre candidates derived from the inner (alpha=0) and outer
    (alpha=1) undistorted rectangles in NORMALIZED coords, blended by
    alpha; validPixROI = ceil/floor of the inner rectangle reprojected
    through the new matrix, clipped to the image. Returns (newK, roi)."""
    w, h = size
    nw, nh = new_size if new_size else (w, h)
    K = np.asarray(K, np.float64)
    if center_principal_point:
        # cv2: pixel-coord rects (P = K), focals scaled by the blend of
        # the coverage ratios about the CENTRED principal point
        inner, outer = _get_rectangles(K, dist, size, p=K)
        cx0, cy0 = K[0, 2], K[1, 2]
        cx = (nw - 1) * 0.5
        cy = (nh - 1) * 0.5
        ix, iy, iw, ih = inner
        ox, oy, ow, oh = outer
        s0 = max(cx / (cx0 - ix), cy / (cy0 - iy),
                 cx / (ix + iw - cx0), cy / (iy + ih - cy0))
        s1 = min(cx / (cx0 - ox), cy / (cy0 - oy),
                 cx / (ox + ow - cx0), cy / (oy + oh - cy0))
        a = float(np.clip(alpha, 0.0, 1.0))
        s = s0 * (1 - a) + s1 * a
        nk = K.copy()
        nk[0, 0] *= s
        nk[1, 1] *= s
        nk[0, 2] = cx
        nk[1, 2] = cy
    else:
        inner, outer = _get_rectangles(K, dist, size)
        ix, iy, iw, ih = inner
        ox, oy, ow, oh = outer
        fx0 = (nw - 1) / iw
        fy0 = (nh - 1) / ih
        cx0 = -fx0 * ix
        cy0 = -fy0 * iy
        fx1 = (nw - 1) / ow
        fy1 = (nh - 1) / oh
        cx1 = -fx1 * ox
        cy1 = -fy1 * oy
        a = float(np.clip(alpha, 0.0, 1.0))
        nk = np.array([
            [fx0 * (1 - a) + fx1 * a, 0.0, cx0 * (1 - a) + cx1 * a],
            [0.0, fy0 * (1 - a) + fy1 * a, cy0 * (1 - a) + cy1 * a],
            [0.0, 0.0, 1.0]])
    inner2, _ = _get_rectangles(K, dist, size, nk)
    rx = int(np.ceil(inner2[0]))
    ry = int(np.ceil(inner2[1]))
    rw = int(np.floor(inner2[2]))
    rh = int(np.floor(inner2[3]))
    # clip to the new image
    rx2 = min(rx + rw, nw)
    ry2 = min(ry + rh, nh)
    rx = max(rx, 0)
    ry = max(ry, 0)
    roi = (rx, ry, max(rx2 - rx, 0), max(ry2 - ry, 0))
    return nk, roi


def undistort(img, K: np.ndarray, dist, new_K: Optional[np.ndarray] = None):
    """Undistort a u8 image on device via the packed-quad remap
    (OpenCV ``undistort``). ``img`` may be (H, W) or (H, W, C)."""
    import jax.numpy as jnp

    from .warp import remap

    h, w = img.shape[0], img.shape[1]
    mx, my = init_undistort_rectify_map(K, dist, new_K, (w, h))
    return remap(img, jnp.asarray(mx), jnp.asarray(my), border="constant")


def solve_pnp(
    obj_pts: np.ndarray,
    img_pts: np.ndarray,
    K: np.ndarray,
    dist=(0, 0, 0, 0, 0),
    iterations: int = 20,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pose from 3D↔2D correspondences (OpenCV ``solvePnP`` ITERATIVE
    role): DLT initialization (planar targets: homography init — the
    12-dof DLT is rank-deficient on coplanar points, so a Zhang r1/r2
    extraction in the plane's own frame is composed with the plane
    basis, exactly OpenCV's ITERATIVE split) + Gauss-Newton refinement
    of (rvec, tvec) minimizing reprojection error through the FULL
    distortion model (numeric Jacobian — 6 params, deterministic).
    Needs ≥ 6 points (≥ 4 when coplanar). Returns (rvec (3,),
    tvec (3,))."""
    obj = np.asarray(obj_pts, np.float64).reshape(-1, 3)
    img = np.asarray(img_pts, np.float64).reshape(-1, 2)
    n = len(obj)
    if n != len(img) or n < 4:
        raise ValueError("solve_pnp needs >= 4 point correspondences")
    K = np.asarray(K, np.float64)
    und = undistort_points(img, K, dist)
    centered = obj - obj.mean(axis=0)
    _, sv, vtp = np.linalg.svd(centered)
    planar = sv[2] < 1e-9 * max(sv[0], 1e-12)
    if not planar and n < 6:
        raise ValueError("solve_pnp needs >= 6 non-coplanar points")
    if planar:
        # --- homography init in the plane's frame -----------------------
        from .geometry import _fit_homography

        b1, b2 = vtp[0], vtp[1]
        b3 = np.cross(b1, b2)
        B = np.stack([b1, b2, b3], axis=1)          # plane basis, det +1
        uv = centered @ np.stack([b1, b2], axis=1)  # (N, 2) plane coords
        h = _fit_homography(uv, und)
        if h is None:
            raise ValueError("degenerate planar configuration")
        Kinv = np.linalg.inv(K)
        lam = 1.0 / max(np.linalg.norm(Kinv @ h[:, 0]), 1e-12)
        r1 = lam * (Kinv @ h[:, 0])
        r2 = lam * (Kinv @ h[:, 1])
        tp = lam * (Kinv @ h[:, 2])
        if tp[2] < 0:
            r1, r2, tp = -r1, -r2, -tp
        Rp = np.stack([r1, r2, np.cross(r1, r2)], axis=1)
        u, _, vtr = np.linalg.svd(Rp)
        Rp = u @ vtr
        if np.linalg.det(Rp) < 0:
            Rp = u @ np.diag([1.0, 1.0, -1.0]) @ vtr
        R = Rp @ B.T
        t = tp - R @ obj.mean(axis=0)
    else:
        # --- DLT init on UNDISTORTED normalized points ------------------
        xn = (und[:, 0] - K[0, 2]) / K[0, 0]
        yn = (und[:, 1] - K[1, 2]) / K[1, 1]
        A = np.zeros((2 * n, 12))
        for i in range(n):
            X = np.append(obj[i], 1.0)
            A[2 * i, 0:4] = X
            A[2 * i, 8:12] = -xn[i] * X
            A[2 * i + 1, 4:8] = X
            A[2 * i + 1, 8:12] = -yn[i] * X
        _, _, vt = np.linalg.svd(A)
        P = vt[-1].reshape(3, 4)
        R_raw = P[:, :3]
        # orthogonalize + scale; fix sign so points sit in front (z > 0)
        u, s, vtr = np.linalg.svd(R_raw)
        R = u @ vtr
        scale = s.mean()
        if scale < 1e-12:
            raise ValueError("degenerate point configuration")
        t = P[:, 3] / scale
        if np.linalg.det(R) < 0:
            R, t = -R, -t
        z = obj @ R.T + t
        if np.median(z[:, 2]) < 0:
            R = u @ np.diag([1.0, 1.0, -1.0]) @ vtr
            if np.linalg.det(R) < 0:
                R = -R
            t = -t
    rvec = rodrigues(R)
    tvec = t.copy()
    return refine_pose(obj, img, K, dist, rvec, tvec, iterations)


def refine_pose(obj: np.ndarray, img: np.ndarray, K: np.ndarray, dist,
                rvec: np.ndarray, tvec: np.ndarray,
                iterations: int = 20) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss-Newton pose refinement through the full distortion model
    (OpenCV ``solvePnPRefineLM`` role; the minimizer solve_pnp ends
    with, factored for standalone use)."""
    obj = np.asarray(obj, np.float64).reshape(-1, 3)
    img = np.asarray(img, np.float64).reshape(-1, 2)
    n = len(obj)

    def residual(r, tv):
        return (project_points(obj, r, tv, K, dist) - img).reshape(-1)

    params = np.concatenate([np.asarray(rvec, np.float64).ravel(),
                             np.asarray(tvec, np.float64).ravel()])
    eps = 1e-6
    for _ in range(iterations):
        r0 = residual(params[:3], params[3:])
        J = np.zeros((2 * n, 6))
        for j in range(6):
            p2 = params.copy()
            p2[j] += eps
            J[:, j] = (residual(p2[:3], p2[3:]) - r0) / eps
        try:
            step = np.linalg.solve(J.T @ J + 1e-9 * np.eye(6), -J.T @ r0)
        except np.linalg.LinAlgError:
            break
        params = params + step
        if np.linalg.norm(step) < 1e-10:
            break
    return params[:3].copy(), params[3:].copy()


def calibrate_camera(
    obj_points,
    img_points,
    image_size: Tuple[int, int],
    iterations: int = 30,
):
    """Planar-target camera calibration (OpenCV ``calibrateCamera`` role,
    Zhang's method): per-view homographies → absolute-conic closed-form
    K init (zero skew) → per-view extrinsics → joint Gauss-Newton over
    (fx, fy, cx, cy, k1, k2, p1, p2, k3, rvec_i, tvec_i) minimizing total
    reprojection error (numeric Jacobian; deterministic).

    ``obj_points``: list of [N_i, 3] planar targets (Z = 0);
    ``img_points``: list of [N_i, 2] detected pixels. Needs >= 3 views.
    Returns (rms, K, dist (5,), rvecs, tvecs)."""
    from .geometry import _fit_homography

    views = len(obj_points)
    if views != len(img_points) or views < 3:
        raise ValueError("calibrate_camera needs >= 3 views")
    objs = [np.asarray(o, np.float64).reshape(-1, 3) for o in obj_points]
    imgs = [np.asarray(p, np.float64).reshape(-1, 2) for p in img_points]
    for o in objs:
        if np.abs(o[:, 2]).max() > 1e-9:
            raise ValueError("planar calibration requires Z == 0 targets")

    # --- Zhang init: V b = 0 over homography constraints ----------------
    hs = []
    for o, p in zip(objs, imgs):
        h = _fit_homography(o[:, :2], p)
        if h is None:
            raise ValueError("degenerate view (homography failed)")
        hs.append(h)

    def vij(h, i, j):
        return np.array([
            h[0, i] * h[0, j],
            h[0, i] * h[1, j] + h[1, i] * h[0, j],
            h[1, i] * h[1, j],
            h[2, i] * h[0, j] + h[0, i] * h[2, j],
            h[2, i] * h[1, j] + h[1, i] * h[2, j],
            h[2, i] * h[2, j],
        ])

    V = []
    for h in hs:
        V.append(vij(h, 0, 1))
        V.append(vij(h, 0, 0) - vij(h, 1, 1))
    _, _, vt = np.linalg.svd(np.asarray(V))
    b11, b12, b22, b13, b23, b33 = vt[-1]
    # closed-form intrinsics (Zhang appendix B)
    den = b11 * b22 - b12 * b12
    if abs(den) < 1e-15:
        raise ValueError("degenerate view geometry (parallel planes?)")
    v0 = (b12 * b13 - b11 * b23) / den
    lam = b33 - (b13 * b13 + v0 * (b12 * b13 - b11 * b23)) / b11
    if lam / b11 <= 0 or lam <= 0 and b11 <= 0:
        lam, b11, b12, b22, b13, b23 = (-lam, -b11, -b12, -b22, -b13, -b23)
    fx = np.sqrt(abs(lam / b11))
    fy = np.sqrt(abs(lam * b11 / den))
    u0 = -b13 * fx * fx / lam
    K0 = np.array([[fx, 0, u0], [0, fy, v0], [0, 0, 1.0]])

    # --- extrinsics per view -------------------------------------------
    rvecs, tvecs = [], []
    Kinv = np.linalg.inv(K0)
    for h in hs:
        lam_i = 1.0 / max(np.linalg.norm(Kinv @ h[:, 0]), 1e-12)
        r1 = lam_i * (Kinv @ h[:, 0])
        r2 = lam_i * (Kinv @ h[:, 1])
        t = lam_i * (Kinv @ h[:, 2])
        if t[2] < 0:
            r1, r2, t = -r1, -r2, -t
        r3 = np.cross(r1, r2)
        R = np.stack([r1, r2, r3], axis=1)
        u, _, vtr = np.linalg.svd(R)
        R = u @ vtr
        if np.linalg.det(R) < 0:
            R = u @ np.diag([1.0, 1.0, -1.0]) @ vtr
        rvecs.append(rodrigues(R))
        tvecs.append(t)

    # --- joint Gauss-Newton refinement ---------------------------------
    p0 = np.concatenate(
        [[K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2]], np.zeros(5)]
        + [np.concatenate([r, t]) for r, t in zip(rvecs, tvecs)])

    def unpack(p):
        Km = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1.0]])
        dist = p[4:9]
        ext = p[9:].reshape(views, 6)
        return Km, dist, ext

    def residual(p):
        Km, dist, ext = unpack(p)
        out = []
        for o, ip, e in zip(objs, imgs, ext):
            out.append((project_points(o, e[:3], e[3:], Km, dist) - ip).reshape(-1))
        return np.concatenate(out)

    params = p0
    eps = 1e-6
    nres = sum(2 * len(o) for o in objs)
    for _ in range(iterations):
        r0 = residual(params)
        J = np.zeros((nres, len(params)))
        for j in range(len(params)):
            p2 = params.copy()
            p2[j] += eps
            J[:, j] = (residual(p2) - r0) / eps
        try:
            step = np.linalg.solve(J.T @ J + 1e-9 * np.eye(len(params)),
                                   -J.T @ r0)
        except np.linalg.LinAlgError:
            break
        params = params + step
        if np.linalg.norm(step) < 1e-11:
            break
    Kf, dist, ext = unpack(params)
    rms = float(np.sqrt(np.mean(residual(params) ** 2)))
    return (rms, Kf, dist.copy(),
            [e[:3].copy() for e in ext], [e[3:].copy() for e in ext])


def solve_pnp_ransac(
    obj_pts: np.ndarray,
    img_pts: np.ndarray,
    K: np.ndarray,
    dist=(0, 0, 0, 0, 0),
    iters: int = 100,
    reproj_threshold: float = 8.0,
    seed: int = 7,
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], np.ndarray]:
    """Outlier-robust pose (OpenCV ``solvePnPRansac`` role): seeded
    6-point minimal :func:`solve_pnp` samples (DLT-only, 0 GN iters),
    reprojection-error consensus, final :func:`solve_pnp` refit on the
    inliers → (rvec, tvec, inlier mask) or (None, None, zeros)."""
    obj = np.asarray(obj_pts, np.float64).reshape(-1, 3)
    img = np.asarray(img_pts, np.float64).reshape(-1, 2)
    n = len(obj)
    if n != len(img) or n < 6:
        return None, None, np.zeros(n, bool)
    rng = np.random.default_rng(seed)
    best_mask = np.zeros(n, bool)
    best = None
    for _ in range(iters):
        idx = rng.choice(n, size=6, replace=False)
        try:
            r, t = solve_pnp(obj[idx], img[idx], K, dist, iterations=0)
        except (ValueError, np.linalg.LinAlgError):
            continue
        err = np.linalg.norm(project_points(obj, r, t, K, dist) - img,
                             axis=1)
        mask = err < reproj_threshold
        if mask.sum() > best_mask.sum():
            best_mask = mask
            best = (r, t)
    if best is None or best_mask.sum() < 6:
        return None, None, np.zeros(n, bool)
    r, t = solve_pnp(obj[best_mask], img[best_mask], K, dist)
    err = np.linalg.norm(project_points(obj, r, t, K, dist) - img, axis=1)
    return r, t, err < reproj_threshold


def stereo_rectify(
    K1: np.ndarray, d1, K2: np.ndarray, d2,
    size: Tuple[int, int], R: np.ndarray, T: np.ndarray,
):
    """Bouguet stereo rectification (OpenCV ``stereoRectify``
    CALIB_ZERO_DISPARITY role). ``size`` = (width, height);
    ``x₂ = R x₁ + T``. Returns (R1, R2, P1, P2, Q).

    Frozen spec: each camera turns half the inter-camera rotation
    (``rodrigues(∓om/2)``), then both are spun so the baseline becomes
    the rectified x-axis (dominant-axis convention as OpenCV's ``idx``);
    the new focal is the mean of the y-focals, and the shared principal
    point is the mean over both cameras of the undistorted, rectified
    image-corner centroid — zero disparity at infinity."""
    K1 = np.asarray(K1, np.float64)
    K2 = np.asarray(K2, np.float64)
    R = np.asarray(R, np.float64)
    t = np.asarray(T, np.float64).reshape(3)
    w, h = size

    om = rodrigues(R)
    r_half = rodrigues(-0.5 * om)          # rotates cam2 halfway back
    t_r = r_half @ t
    idx = 0 if abs(t_r[0]) >= abs(t_r[1]) else 1
    uu = np.zeros(3)
    uu[idx] = 1.0 if t_r[idx] > 0 else -1.0
    ww = np.cross(t_r, uu)
    nw = np.linalg.norm(ww)
    if nw > 1e-12:
        ww *= np.arccos(np.clip(abs(t_r[idx]) / np.linalg.norm(t_r),
                                -1.0, 1.0)) / nw
    w_r = rodrigues(ww)
    r1 = w_r @ r_half.T
    r2 = w_r @ r_half
    t_new = r2 @ t

    fc_new = 0.5 * (K1[1, 1] + K2[1, 1])

    # shared principal point: centroid of the rectified corner grid
    corners = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]],
                       np.float64)
    cc = np.zeros(2)
    for Kk, dk, rk in ((K1, d1, r1), (K2, d2, r2)):
        und = undistort_points(corners, Kk, dk)
        xn = (und[:, 0] - Kk[0, 2]) / Kk[0, 0]
        yn = (und[:, 1] - Kk[1, 2]) / Kk[1, 1]
        ray = np.stack([xn, yn, np.ones(4)], axis=1) @ rk.T
        px = ray[:, :2] / ray[:, 2:]
        cc += np.array([(w - 1) / 2, (h - 1) / 2]) - fc_new * px.mean(axis=0)
    cc *= 0.5

    p1 = np.array([[fc_new, 0, cc[0], 0],
                   [0, fc_new, cc[1], 0],
                   [0, 0, 1, 0]])
    p2 = p1.copy()
    p2[idx, 3] = fc_new * t_new[idx]

    tx = t_new[idx]
    q = np.array([
        [1, 0, 0, -cc[0]],
        [0, 1, 0, -cc[1]],
        [0, 0, 0, fc_new],
        [0, 0, -1.0 / tx, 0],
    ])
    return r1, r2, p1, p2, q


def reproject_image_to_3d(disparity: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Disparity (H, W) float + 4×4 Q → (H, W, 3) float32 XYZ (OpenCV
    ``reprojectImageTo3D`` role). Pure elementwise — callers on the hot
    path should fold it into their device program; this host form is the
    oracle."""
    d = np.asarray(disparity, np.float64)
    hh, ww = d.shape
    ys, xs = np.mgrid[0:hh, 0:ww].astype(np.float64)
    vec = np.stack([xs, ys, d, np.ones_like(d)], axis=-1)
    out = vec @ np.asarray(q, np.float64).T
    w_ = out[..., 3:]
    w_ = np.where(np.abs(w_) < 1e-12, 1e-12, w_)
    return (out[..., :3] / w_).astype(np.float32)


def stereo_calibrate(
    obj_points,
    img_points1,
    img_points2,
    K1: np.ndarray, d1,
    K2: np.ndarray, d2,
    iterations: int = 30,
):
    """Stereo extrinsic calibration (OpenCV ``stereoCalibrate`` with
    CALIB_FIX_INTRINSIC role): per-view ``solve_pnp`` in each camera →
    relative pose candidates R_i = R2_i R1_iᵀ, T_i = t2_i − R_i t1_i →
    chordal-mean rotation (SVD projection of ΣR_i onto SO(3)) + mean
    translation init → joint Gauss-Newton over (om, T, rvec1_i, tvec1_i)
    minimizing reprojection error in BOTH cameras (numeric Jacobian,
    deterministic). Returns (rms, R, T, E, F) with ``x₂ = R x₁ + T``,
    E = [T]× R, F = K2⁻ᵀ E K1⁻¹."""
    views = len(obj_points)
    if views != len(img_points1) or views != len(img_points2) or views < 1:
        raise ValueError("stereo_calibrate needs matched per-view lists")
    objs = [np.asarray(o, np.float64).reshape(-1, 3) for o in obj_points]
    im1 = [np.asarray(p, np.float64).reshape(-1, 2) for p in img_points1]
    im2 = [np.asarray(p, np.float64).reshape(-1, 2) for p in img_points2]
    K1 = np.asarray(K1, np.float64)
    K2 = np.asarray(K2, np.float64)

    # --- init: per-view poses → relative pose mean ----------------------
    poses1, rel_rs, rel_ts = [], [], []
    for o, p1, p2 in zip(objs, im1, im2):
        r1v, t1v = solve_pnp(o, p1, K1, d1)
        r2v, t2v = solve_pnp(o, p2, K2, d2)
        if not (np.isfinite(r1v).all() and np.isfinite(t1v).all()):
            raise ValueError("camera-1 pose failed for a view")
        poses1.append((r1v, t1v))
        if not (np.isfinite(r2v).all() and np.isfinite(t2v).all()):
            continue  # camera-2 view diverged; init from the others
        R1m, R2m = rodrigues(r1v), rodrigues(r2v)
        Rrel = R2m @ R1m.T
        rel_rs.append(Rrel)
        rel_ts.append(t2v - Rrel @ t1v)
    if not rel_rs:
        raise ValueError("no view yielded a finite relative pose")
    u, _, vt = np.linalg.svd(np.sum(rel_rs, axis=0))
    Rm = u @ np.diag([1.0, 1.0, np.linalg.det(u @ vt)]) @ vt
    om = rodrigues(Rm)
    T = np.mean(rel_ts, axis=0)

    # --- joint GN over (om, T) + per-view camera-1 poses ----------------
    params = np.concatenate([om, T] + [np.concatenate([r, t])
                                       for r, t in poses1])
    n_res = 2 * sum(2 * len(o) for o in objs)

    def residual(p):
        omc, tc = p[:3], p[3:6]
        Rc = rodrigues(omc)
        res = []
        for i, (o, pa, pb) in enumerate(zip(objs, im1, im2)):
            r1v = p[6 + 6 * i: 9 + 6 * i]
            t1v = p[9 + 6 * i: 12 + 6 * i]
            res.append((project_points(o, r1v, t1v, K1, d1) - pa).ravel())
            R1m = rodrigues(r1v)
            r2v = rodrigues(Rc @ R1m)
            t2v = Rc @ t1v + tc
            res.append((project_points(o, r2v, t2v, K2, d2) - pb).ravel())
        return np.concatenate(res)

    eps = 1e-6
    for _ in range(iterations):
        r0 = residual(params)
        J = np.zeros((n_res, len(params)))
        for j in range(len(params)):
            p2 = params.copy()
            p2[j] += eps
            J[:, j] = (residual(p2) - r0) / eps
        try:
            step = np.linalg.solve(J.T @ J + 1e-9 * np.eye(len(params)),
                                   -J.T @ r0)
        except np.linalg.LinAlgError:
            break
        params = params + step
        if np.linalg.norm(step) < 1e-10:
            break

    om, T = params[:3].copy(), params[3:6].copy()
    R = rodrigues(om)
    rms = float(np.sqrt(np.mean(residual(params) ** 2)))
    tx = np.array([[0, -T[2], T[1]], [T[2], 0, -T[0]], [-T[1], T[0], 0]])
    E = tx @ R
    F = np.linalg.inv(K2).T @ E @ np.linalg.inv(K1)
    nf = np.linalg.norm(F)
    if nf > 1e-12:
        F = F / nf
    return rms, R, T, E, F


def decompose_homography_mat(h: np.ndarray, K: np.ndarray):
    """Planar homography decomposition (OpenCV ``decomposeHomographyMat``
    role) → (num, rotations, translations, normals) with
    H ∝ K (R + t nᵀ) K⁻¹ (t carries the 1/d plane-distance scale, n unit,
    n in the FIRST camera frame).

    Frozen spec: Faugeras-Lustman SVD method. H' = K⁻¹HK / σ₂(K⁻¹HK);
    with singular values d1 ≥ 1 ≥ d3 the four sign choices
    (ε1, ε3) ∈ {±1}² give n' = (ε1·x1, 0, ε3·x3),
    R' = Ry(θ(ε1ε3)), t' = (d1−d3)(ε1·x1, 0, −ε3·x3), mapped back by
    R = s·U R' Vᵀ, t = U t', n = V n' (s = det U · det V). Degenerate
    d1≈d3 (pure rotation) returns the single solution (H', t=0, n=ẑ).
    Solutions with n_z < 0 are sign-flipped (t, n) → (−t, −n) so the
    plane faces camera 1, then deduplicated."""
    h = np.asarray(h, np.float64)
    K = np.asarray(K, np.float64)
    Kinv = np.linalg.inv(K)
    hn = Kinv @ h @ K
    u, s, vt = np.linalg.svd(hn)
    if s[1] < 1e-12:
        raise ValueError("degenerate homography")
    hn = hn / s[1]
    d1, d2, d3 = s / s[1]
    sgn = np.linalg.det(u) * np.linalg.det(vt)

    sols = []
    if d1 - d3 < 1e-9:  # pure rotation: H' itself is (close to) R
        uu, _, vvt = np.linalg.svd(hn)
        r = uu @ vvt
        if np.linalg.det(r) < 0:
            r = -r
        sols.append((r, np.zeros(3), np.array([0.0, 0.0, 1.0])))
    else:
        x1m = np.sqrt(max((d1 * d1 - 1.0) / (d1 * d1 - d3 * d3), 0.0))
        x3m = np.sqrt(max((1.0 - d3 * d3) / (d1 * d1 - d3 * d3), 0.0))
        sin_m = np.sqrt(max(
            (d1 * d1 - 1.0) * (1.0 - d3 * d3), 0.0)) / ((d1 + d3) * d2)
        cos_t = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2)
        v = vt.T
        for e1 in (1.0, -1.0):
            for e3 in (1.0, -1.0):
                st = e1 * e3 * sin_m
                rp = np.array([[cos_t, 0.0, -st],
                               [0.0, 1.0, 0.0],
                               [st, 0.0, cos_t]])
                npr = np.array([e1 * x1m, 0.0, e3 * x3m])
                tp = (d1 - d3) * np.array([e1 * x1m, 0.0, -e3 * x3m])
                r = sgn * (u @ rp @ vt)
                t = u @ tp
                nrm = v @ npr
                if nrm[2] < 0:
                    t, nrm = -t, -nrm
                if not any(np.abs(r - r2).max() < 1e-9
                           and np.abs(t - t2).max() < 1e-9
                           for r2, t2, _ in sols):
                    sols.append((r, t, nrm))
    rs = [s_[0] for s_ in sols]
    ts = [s_[1] for s_ in sols]
    ns = [s_[2] for s_ in sols]
    return len(sols), rs, ts, ns


def estimate_affine_3d(
    src,
    dst,
    ransac_thresh: float = 3.0,
    confidence: float = 0.99,
    iters: int = 200,
    seed: int = 7,
) -> Tuple[int, np.ndarray, np.ndarray]:
    """3-D affine transform between point sets (OpenCV
    ``estimateAffine3D`` role) → (retval 0/1, A 3×4 float64, inlier
    mask). Seeded RANSAC over 4-point minimal least-squares fits
    ([X|1] Aᵀ = Y), L2 gating at ``ransac_thresh``, best-consensus
    inlier refit (the find_homography protocol). ``confidence``
    early-exits the loop with the standard (1−w⁴) bound."""
    s = np.asarray(src, np.float64).reshape(-1, 3)
    d = np.asarray(dst, np.float64).reshape(-1, 3)
    n = len(s)
    if n != len(d) or n < 4:
        return 0, np.zeros((3, 4)), np.zeros(n, bool)

    def fit(a, b):
        X = np.concatenate([a, np.ones((len(a), 1))], axis=1)
        try:
            sol, *_ = np.linalg.lstsq(X, b, rcond=None)
        except np.linalg.LinAlgError:
            return None
        return sol.T  # 3×4

    Xall = np.concatenate([s, np.ones((n, 1))], axis=1)
    rng = np.random.default_rng(seed)
    best_mask = np.zeros(n, bool)
    best_a = None
    needed = iters
    done = 0
    while done < min(needed, iters):
        idx = rng.choice(n, size=4, replace=False)
        a = fit(s[idx], d[idx])
        done += 1
        if a is None:
            continue
        err = np.linalg.norm(Xall @ a.T - d, axis=1)
        mask = err < ransac_thresh
        if mask.sum() > best_mask.sum():
            best_mask = mask
            best_a = a
            w = mask.sum() / n
            if w > 0:
                denom = np.log(max(1e-12, 1.0 - w ** 4))
                if denom < 0:
                    needed = int(np.ceil(np.log(1 - confidence) / denom))
    if best_a is None or best_mask.sum() < 4:
        return 0, np.zeros((3, 4)), np.zeros(n, bool)
    refined = fit(s[best_mask], d[best_mask])
    if refined is not None:
        err = np.linalg.norm(Xall @ refined.T - d, axis=1)
        best_mask = err < ransac_thresh
        best_a = refined
    return 1, best_a, best_mask


# ---------------------------------------------------------------------------
# Fisheye (equidistant) camera model — OpenCV ``cv::fisheye`` role
# ---------------------------------------------------------------------------
# Frozen spec (float64 host, same device split as the pinhole model above:
# host table builds, device packed-quad remap):
#   θ = atan(r), θ_d = θ·(1 + k1·θ² + k2·θ⁴ + k3·θ⁶ + k4·θ⁸)
#   distorted normalized = (θ_d/r)·(x, y)   (r = √(x²+y²); r→0 ⇒ scale 1)
#   pixel = K @ [xd, yd, 1]
# Undistortion inverts θ_d → θ by 10 Newton iterations (the pinhole
# model's fixed-iteration convention).

def _fisheye_theta_d(theta: np.ndarray, dist) -> np.ndarray:
    k1, k2, k3, k4 = (list(np.asarray(dist, np.float64).reshape(-1))
                      + [0.0] * 4)[:4]
    t2 = theta * theta
    return theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))


def fisheye_project_points(obj_pts, rvec, tvec, K, dist) -> np.ndarray:
    """3D points (N, 3) → fisheye pixels (N, 2)."""
    obj = np.asarray(obj_pts, np.float64).reshape(-1, 3)
    R = rodrigues(np.asarray(rvec, np.float64))
    cam = obj @ R.T + np.asarray(tvec, np.float64).reshape(3)
    x = cam[:, 0] / cam[:, 2]
    y = cam[:, 1] / cam[:, 2]
    r = np.sqrt(x * x + y * y)
    theta = np.arctan(r)
    td = _fisheye_theta_d(theta, dist)
    scale = np.where(r > 1e-12, td / np.maximum(r, 1e-12), 1.0)
    K = np.asarray(K, np.float64)
    xd = x * scale
    yd = y * scale
    return np.stack([K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]],
                    axis=1)


def fisheye_undistort_points(pts, K, dist, iterations: int = 10):
    """Fisheye pixels (N, 2) → undistorted NORMALIZED points (N, 2)
    (multiply by K to get pinhole pixels)."""
    K = np.asarray(K, np.float64)
    p = np.asarray(pts, np.float64).reshape(-1, 2)
    xd = (p[:, 0] - K[0, 2]) / K[0, 0]
    yd = (p[:, 1] - K[1, 2]) / K[1, 1]
    td = np.sqrt(xd * xd + yd * yd)
    theta = td.copy()
    for _ in range(iterations):
        f = _fisheye_theta_d(theta, dist) - td
        eps = 1e-7
        df = (_fisheye_theta_d(theta + eps, dist)
              - _fisheye_theta_d(theta - eps, dist)) / (2 * eps)
        theta = theta - f / np.maximum(df, 1e-9)
    r = np.tan(theta)
    scale = np.where(td > 1e-12, r / np.maximum(td, 1e-12), 1.0)
    return np.stack([xd * scale, yd * scale], axis=1)


def fisheye_init_undistort_rectify_map(K, dist, new_K, size):
    """(map_x, map_y) float32 for the device remap: for each output
    pixel of the ``new_K`` pinhole view, the fisheye source pixel."""
    w, h = size
    K = np.asarray(K, np.float64)
    nK = np.asarray(new_K if new_K is not None else K, np.float64)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    x = (xs - nK[0, 2]) / nK[0, 0]
    y = (ys - nK[1, 2]) / nK[1, 1]
    r = np.sqrt(x * x + y * y)
    theta = np.arctan(r)
    td = _fisheye_theta_d(theta, dist)
    scale = np.where(r > 1e-12, td / np.maximum(r, 1e-12), 1.0)
    mx = K[0, 0] * x * scale + K[0, 2]
    my = K[1, 1] * y * scale + K[1, 2]
    return mx.astype(np.float32), my.astype(np.float32)


def fisheye_undistort(img, K, dist, new_K=None):
    """Undistort a fisheye u8 image via the packed-quad device remap
    (jax input) or the remap oracle (numpy input)."""
    from . import warp as _warp

    h, w = img.shape[:2]
    mx, my = fisheye_init_undistort_rectify_map(K, dist, new_K, (w, h))
    if isinstance(img, np.ndarray):
        return _warp.remap_numpy(img, mx, my, "constant")
    import jax.numpy as jnp

    return _warp.remap(img, jnp.asarray(mx), jnp.asarray(my), "constant")
