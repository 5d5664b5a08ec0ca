"""Video stabilization: the full feature-pipeline loop on a shaky clip.

Per frame: FAST corners → BRIEF descriptors → Hamming matching (matrix unit
matmul) → RANSAC similarity → inverse warp (packed-quad gather). Writes a
stabilized MJPEG-AVI next to the input. Demonstrates every stage of the
beyond-reference vision stack working together.
"""

import os
import tempfile

import numpy as np

from rustcv_tpu import imgproc
from rustcv_tpu.capture import VideoWriter
from rustcv_tpu.capture import simulation as sim
from rustcv_tpu.core.mat import Mat
from rustcv_tpu.ops import golden, warp


def make_shaky_clip(n_frames: int = 12, width: int = 320, height: int = 240):
    """A textured scene with random per-frame jitter; returns frames and
    the true offsets."""
    rng = np.random.default_rng(11)
    base = golden.bgr_to_gray(sim.synth_bgr(width, height, 3))
    base = np.clip(
        base.astype(np.int32) + rng.integers(0, 22, base.shape), 0, 255
    ).astype(np.uint8)
    offsets = np.cumsum(rng.uniform(-3, 3, (n_frames, 2)), axis=0)
    offsets[0] = 0
    frames = []
    for ox, oy in offsets:
        m = np.array([[1.0, 0.0, ox], [0.0, 1.0, oy]])
        frames.append(warp.warp_affine_numpy(base, m, (width, height), border="replicate"))
    return frames, offsets


def stabilize(frames):
    """Register every frame to the first; returns stabilized frames and
    the estimated per-frame offsets."""
    ref = Mat.from_array(frames[0])
    p_ref = imgproc.fast_corners(ref, threshold=15, max_corners=128)
    d_ref, v_ref = imgproc.compute_brief(ref, p_ref)
    out = [frames[0]]
    est = [np.zeros(2)]
    for f in frames[1:]:
        cur = Mat.from_array(f)
        p = imgproc.fast_corners(cur, threshold=15, max_corners=128)
        d, v = imgproc.compute_brief(cur, p)
        matches = imgproc.match_descriptors(d_ref, d, v_ref, v)
        m_est, inliers = imgproc.estimate_affine_partial_2d(
            p_ref[matches[:, 0]], p[matches[:, 1]]
        )
        if m_est is None:
            out.append(f)
            est.append(est[-1])
            continue
        # m_est maps ref→cur; to bring cur back onto ref, warp with the
        # INVERSE (warp_affine treats its M as src→dst and resolves the
        # sampling map itself).
        m_inv = warp._invert_affine(m_est)
        stab = imgproc.warp_affine(
            Mat.from_array(f), m_inv, (f.shape[1], f.shape[0]), border="replicate"
        )
        out.append(stab.to_numpy().squeeze())
        est.append(np.array(m_est[:, 2]))
    return out, np.array(est)


def main(n_frames: int = 12) -> None:
    frames, truth = make_shaky_clip(n_frames)
    stab, est = stabilize(frames)
    err = np.abs(est - truth).max()
    print(f"estimated motion vs truth: max err {err:.2f} px over {n_frames} frames")
    # residual shake: mean |frame - ref| before/after
    ref = frames[0].astype(np.int64)
    before = np.mean([np.abs(f.astype(np.int64) - ref).mean() for f in frames[1:]])
    after = np.mean([np.abs(f.astype(np.int64) - ref).mean() for f in stab[1:]])
    print(f"mean |frame - ref|: {before:.1f} -> {after:.1f} (lower = steadier)")
    path = os.path.join(tempfile.mkdtemp(), "stabilized.avi")
    with VideoWriter(path, "MJPG", fps=30, frame_size=(frames[0].shape[1], frames[0].shape[0])) as w:
        for f in stab:
            w.write(f.astype(np.uint8))
    print(f"wrote {path} ({os.path.getsize(path)//1024} KiB)")
    # Residual floor is the warp's resampling blur (~4 px mean diff on this
    # texture), so short/small-jitter clips can't reach large ratios.
    assert err < 1.0 and after < before * 0.8
    print("stabilization locked")


if __name__ == "__main__":
    main()
