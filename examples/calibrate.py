"""Camera calibration end-to-end: render chessboard views with a known
camera, detect corners with find_chessboard_corners, calibrate with
calibrate_camera (Zhang), then undistort an image and verify lines go
straight — every stage on this framework's own primitives.

Run: python examples/calibrate.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rustcv_tpu.ops import calib  # noqa: E402
from rustcv_tpu.ops.chessboard import find_chessboard_corners  # noqa: E402

COLS_SQ, ROWS_SQ = 10, 7
PATTERN = (COLS_SQ - 1, ROWS_SQ - 1)
SQ = 0.03  # 3 cm squares
IMG = (640, 480)


def render_view(k, dist, rvec, tvec, noise=1.5, seed=0):
    """Render the board through the full (distorted) camera model."""
    w, h = IMG
    # board plane homography in board units, then distort per pixel by
    # sampling: build the ideal pinhole image first, distortion via the
    # inverse rectify map (the undistort table machinery, reversed)
    rm = calib.rodrigues(np.asarray(rvec, np.float64))
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    und = calib.undistort_points(
        np.stack([xs.ravel(), ys.ravel()], 1), k, dist).reshape(h, w, 2)
    xn = (und[..., 0] - k[0, 2]) / k[0, 0]
    yn = (und[..., 1] - k[1, 2]) / k[1, 1]
    # intersect the ray with the board plane (board frame)
    rinv = rm.T
    t = np.asarray(tvec, np.float64)
    d = np.stack([xn, yn, np.ones_like(xn)], -1) @ rinv.T
    o = -rinv @ t
    lam = -o[2] / d[..., 2]
    bx = o[0] + lam * d[..., 0]
    by = o[1] + lam * d[..., 1]
    inside = (bx >= 0) & (bx < COLS_SQ * SQ) & (by >= 0) & (by < ROWS_SQ * SQ)
    black = ((np.floor(bx / SQ) + np.floor(by / SQ)) % 2 == 0) & inside
    img = np.full((h, w), 200.0)
    img[black] = 40.0
    rng = np.random.default_rng(seed)
    img += rng.normal(0, noise, img.shape)
    for _ in range(2):
        p = np.pad(img, 1, mode="edge")
        img = sum(p[dy:dy + h, dx:dx + w]
                  for dy in range(3) for dx in range(3)) / 9.0
    return np.clip(img, 0, 255).astype(np.uint8)


def main() -> int:
    k_true = np.array([[610.0, 0, 325], [0, 600.0, 242], [0, 0, 1.0]])
    dist_true = (-0.12, 0.08, 0.0005, -0.0004, 0.0)

    board = np.stack(np.meshgrid(np.arange(1, COLS_SQ) * SQ,
                                 np.arange(1, ROWS_SQ) * SQ), -1)
    board = board.reshape(-1, 2)
    board_obj = np.concatenate([board, np.zeros((len(board), 1))], 1)

    rng = np.random.default_rng(11)
    views_obj, views_img = [], []
    for v in range(6):
        rvec = rng.uniform(-0.25, 0.25, 3)
        tvec = np.array([rng.uniform(-0.04, 0.04) - SQ * COLS_SQ / 2,
                         rng.uniform(-0.04, 0.04) - SQ * ROWS_SQ / 2,
                         rng.uniform(0.55, 0.85)])
        img = render_view(k_true, dist_true, rvec, tvec, seed=v)
        found, corners = find_chessboard_corners(img, PATTERN)
        status = "found" if found else "MISSED"
        print(f"view {v}: {status}", flush=True)
        if not found:
            continue
        # align detection to the object traversal via projected truth
        truth = calib.project_points(board_obj, rvec, tvec, k_true,
                                     dist_true)
        tg = truth.reshape(ROWS_SQ - 1, COLS_SQ - 1, 2)
        cg = corners.reshape(ROWS_SQ - 1, COLS_SQ - 1, 2)
        flips = (lambda a: a, lambda a: a[::-1, ::-1],
                 lambda a: a[::-1, :], lambda a: a[:, ::-1])
        f = min(flips, key=lambda fn: np.linalg.norm(cg - fn(tg)))
        views_obj.append(board_obj)
        views_img.append(f(cg).reshape(-1, 2))

    if len(views_obj) < 3:
        print("not enough views detected")
        return 1
    rms, k_est, dist_est, rvecs, tvecs = calib.calibrate_camera(
        views_obj, views_img, IMG)
    print(f"calibration rms: {rms:.3f} px over {len(views_obj)} views")
    print(f"fx: {k_est[0, 0]:.1f} (true {k_true[0, 0]}), "
          f"fy: {k_est[1, 1]:.1f} (true {k_true[1, 1]})")
    print(f"cx: {k_est[0, 2]:.1f} (true {k_true[0, 2]}), "
          f"cy: {k_est[1, 2]:.1f} (true {k_true[1, 2]})")
    print(f"k1: {dist_est[0]:+.4f} (true {dist_true[0]:+.4f}), "
          f"k2: {dist_est[1]:+.4f} (true {dist_true[1]:+.4f})")

    # undistort a fronto-parallel view and check a board row straightens
    img = render_view(k_true, dist_true, (0.0, 0.0, 0.0),
                      (-SQ * COLS_SQ / 2, -SQ * ROWS_SQ / 2, 0.6), seed=99)
    found, corners = find_chessboard_corners(img, PATTERN)
    if found:
        row = corners.reshape(ROWS_SQ - 1, COLS_SQ - 1, 2)[3]
        und = calib.undistort_points(row, k_est, dist_est)
        # residual from the best-fit line through the undistorted row
        y = und[:, 1] - und[:, 1].mean()
        x = und[:, 0] - und[:, 0].mean()
        slope = (x * y).sum() / max((x * x).sum(), 1e-12)
        resid = np.abs(y - slope * x).max()
        bow_before = np.abs(
            row[:, 1] - row[:, 1].mean()
            - (row[:, 0] - row[:, 0].mean()) * (
                ((row[:, 0] - row[:, 0].mean())
                 * (row[:, 1] - row[:, 1].mean())).sum()
                / max(((row[:, 0] - row[:, 0].mean()) ** 2).sum(), 1e-12)
            )).max()
        print(f"row bow: {bow_before:.2f} px distorted → "
              f"{resid:.2f} px undistorted")
        ok = resid < 0.5 and rms < 1.0
    else:
        ok = rms < 1.0
    err = abs(k_est[0, 0] - k_true[0, 0]) / k_true[0, 0]
    print("PASS" if (ok and err < 0.03) else "FAIL")
    return 0 if (ok and err < 0.03) else 1


if __name__ == "__main__":
    raise SystemExit(main())
