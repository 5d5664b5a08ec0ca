"""RGB-D fusion end-to-end on this framework's own primitives: render
synthetic depth frames from a moving camera, track the motion with
point-to-plane ICP odometry, fuse everything into a TSDF volume,
raycast a synthetic view and save the extracted surface as a PLY
point cloud.

Run: python examples/rgbd_fusion.py
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rustcv_tpu.ops import odometry, threed  # noqa: E402
from rustcv_tpu.ops.calib import rodrigues  # noqa: E402
from rustcv_tpu.ops.tsdf import TsdfVolume  # noqa: E402

K = np.array([[150.0, 0, 80], [0, 150.0, 60], [0, 0, 1.0]])


def render_depth(rvec, tvec, shape=(120, 160)):
    h, w = shape
    vs, us = np.mgrid[0:h, 0:w].astype(np.float64)
    rays = np.stack([(us - K[0, 2]) / K[0, 0],
                     (vs - K[1, 2]) / K[1, 1],
                     np.ones_like(us)], -1)
    r = rodrigues(np.asarray(rvec, np.float64))
    dirs = rays @ r.T
    origin = np.asarray(tvec, np.float64)
    planes = [(np.array([0.0, 0, -1]), -1.6),
              (np.array([-1.0, 0, -0.3]), -1.8),
              (np.array([0.0, -1, -0.15]), -1.0)]
    depth = np.full((h, w), np.inf)
    for n, d in planes:
        denom = dirs @ n
        t = (d - origin @ n) / np.where(np.abs(denom) > 1e-9, denom, 1e-9)
        hit = (t > 0.1) & (np.abs(denom) > 1e-9)
        depth = np.where(hit & (t < depth), t, depth)
    return np.where(np.isinf(depth), 0.0, depth)


def main() -> int:
    # camera trajectory: small rotations + translations
    poses = [(np.zeros(3), np.zeros(3))]
    for i in range(1, 4):
        poses.append((np.array([0.0, 0.01 * i, 0.0]),
                      np.array([0.015 * i, 0.0, -0.01 * i])))
    frames = [render_depth(rodrigues(rodrigues(rv).T),
                           -rodrigues(rv).T @ tv)
              for rv, tv in poses]

    vol = TsdfVolume(resolution=96, voxel_size=0.025,
                     origin=(-1.2, -0.9, 0.2))
    pose_r = np.eye(3)
    pose_t = np.zeros(3)
    vol.integrate(frames[0], K, pose_r, pose_t)
    for i in range(1, len(frames)):
        ok, rv, tv = odometry.rgbd_odometry(frames[i - 1], frames[i], K,
                                            levels=2, iters=12)
        true_rv, true_tv = poses[i]
        # compose: p_i = R·p_{i-1} + t
        pose_r = rodrigues(rv) @ pose_r
        pose_t = rodrigues(rv) @ pose_t + tv
        err_r = np.abs(rodrigues(pose_r) - true_rv).max()
        print(f"frame {i}: odometry ok={ok} rot err {err_r:.5f} rad",
              flush=True)
        vol.integrate(frames[i], K, pose_r, pose_t)

    ray = vol.raycast(K, np.eye(3), np.zeros(3), frames[0].shape,
                      max_depth=3.0)
    hit = ray > 0
    err = np.abs(ray[hit] - frames[0][hit])
    print(f"raycast: {hit.mean() * 100:.0f}% coverage, median err "
          f"{np.median(err) * 1000:.1f} mm")

    cloud = vol.extract_cloud()
    out = os.path.join(tempfile.gettempdir(), "rustcv_tpu_fusion.ply")
    threed.save_point_cloud(out, cloud)
    print(f"surface: {len(cloud)} points → {out}")
    ok = hit.mean() > 0.8 and np.median(err) < 0.02 and len(cloud) > 1000
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
