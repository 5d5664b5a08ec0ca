"""Point tracking across a simulated camera stream: Harris corner seeds +
pyramidal Lucas–Kanade flow, frame to frame.

The vision-pipeline companion to camera_demo: capture → corner detection →
LK tracking → overlay, all hot math on the device (corner scoring, patch
gauss-newton iterations vectorized over the point set).
"""

import numpy as np

from rustcv_tpu import imgproc
from rustcv_tpu.core.mat import Mat
from rustcv_tpu.ops import golden, warp
from rustcv_tpu.capture import simulation as sim


def main(n_frames: int = 8, width: int = 320, height: int = 240) -> None:
    # Simulated pan: the same textured scene translated a little per frame.
    rng = np.random.default_rng(7)
    base = golden.bgr_to_gray(sim.synth_bgr(width, height, 3))
    base = np.clip(
        base.astype(np.int32) + rng.integers(0, 20, base.shape), 0, 255
    ).astype(np.uint8)
    vel = np.array([2.3, 1.1])  # px/frame

    def frame(i: int) -> np.ndarray:
        m = np.array([[1.0, 0.0, vel[0] * i], [0.0, 1.0, vel[1] * i]])
        return warp.warp_affine_numpy(base, m, (width, height), border="replicate")

    prev = Mat.from_array(frame(0))
    pts = imgproc.good_features_to_track(prev, max_corners=64)
    print(f"seeded {len(pts)} corners")
    alive = np.ones(len(pts), bool)
    for i in range(1, n_frames):
        nxt = Mat.from_array(frame(i))
        new_pts, st = imgproc.calc_optical_flow_pyr_lk(prev, nxt, pts, win=21, levels=2)
        alive &= st
        flow = np.median((new_pts - pts)[alive], axis=0)
        print(
            f"frame {i}: {int(alive.sum())}/{len(pts)} tracked, "
            f"median flow ({flow[0]:+.2f}, {flow[1]:+.2f}) px "
            f"(truth ({vel[0]:+.2f}, {vel[1]:+.2f}))"
        )
        pts, prev = new_pts, nxt
    err = np.abs(flow - vel).max()
    assert err < 0.25, f"median flow off by {err:.2f} px"
    print("tracking locked on the true motion")


if __name__ == "__main__":
    main()
