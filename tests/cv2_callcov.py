"""Argument synthesis for the cv2-facade call-coverage harness.

Every public callable in ``rustcv_tpu.cv2`` must be CALLED once by
tests/test_cv2_call_coverage.py (to make the raise-on-call bug class
structurally extinct).  This module holds the
machinery: a parameter-name -> value synthesizer and a per-callable
override table for signatures the synthesizer cannot infer.

Inputs are tiny (<=64 px) so the whole sweep stays fast on one core.
"""
from __future__ import annotations

import inspect
import numpy as np

H, W = 32, 40


def _rng():
    return np.random.RandomState(7)


def img_u8(c=3, h=H, w=W):
    r = _rng()
    base = r.randint(0, 2, (h // 8, w // 8)).repeat(8, 0).repeat(8, 1)
    img = (base * 150 + r.randint(0, 90, (h, w))).astype(np.uint8)
    if c == 0:
        return img
    return np.stack([img] * c, -1) if c > 1 else img[..., None]


def gray_u8(h=H, w=W):
    return img_u8(0, h, w)


def img_f32(c=3, h=H, w=W):
    return img_u8(c, h, w).astype(np.float32) / 255.0


def mask_u8(h=H, w=W):
    m = np.zeros((h, w), np.uint8)
    m[h // 4: 3 * h // 4, w // 4: 3 * w // 4] = 255
    return m


def pts2f(n=12):
    r = _rng()
    return (r.rand(n, 1, 2) * [W - 1, H - 1]).astype(np.float32)


def pts3f(n=12):
    r = _rng()
    return (r.rand(n, 1, 3) * 2 - 1).astype(np.float32)


def contour():
    return np.array([[[5, 5]], [[30, 6]], [[32, 25]], [[8, 24]]],
                    np.int32)


def camK():
    return np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]],
                    np.float64)


def dist5():
    return np.array([0.05, -0.02, 0.001, 0.001, 0.01], np.float64)


def term_criteria():
    return (3, 10, 0.01)   # COUNT|EPS, 10 iters, eps


# --------------------------------------------------------------------
# Parameter-name -> value factories.  Order matters: first match wins.
# Each entry: (predicate(name), factory()).
# --------------------------------------------------------------------

def _by_name(name: str):
    n = name
    table = {
        # images
        "src": lambda: img_u8(), "src1": lambda: img_u8(),
        "src2": lambda: img_u8(), "image": lambda: img_u8(),
        "img": lambda: img_u8(), "img1": lambda: img_u8(),
        "img2": lambda: img_u8(), "frame": lambda: img_u8(),
        "templateImage": lambda: gray_u8(), "inputImage": lambda: img_u8(),
        "probImage": lambda: gray_u8(),
        "mhi": lambda: img_f32(1)[..., 0],
        "silhouette": lambda: mask_u8(),
        "edges": lambda: mask_u8(),
        "mask": lambda: mask_u8(),
        "inpaintMask": lambda: mask_u8(),
        "gray": lambda: gray_u8(),
        "patch": lambda: img_u8(3, 8, 8),
        "templ": lambda: img_u8(3, 8, 8),
        "template": lambda: gray_u8(8, 8),
        "dst": lambda: img_u8(),
        "arr": lambda: img_u8(), "a": lambda: img_u8(),
        "b": lambda: img_u8(), "array": lambda: img_u8(),
        "m1": lambda: img_u8(), "m2": lambda: img_u8(),
        "data": lambda: img_f32(0).astype(np.float32),
        "samples": lambda: _rng().rand(20, 3).astype(np.float32),
        # geometry / points
        "points": lambda: pts2f(),
        "pts": lambda: pts2f(),
        "curve": lambda: contour(),
        "contour": lambda: contour(),
        "points1": lambda: pts2f(), "points2": lambda: pts2f(),
        "imagePoints": lambda: pts2f(),
        "imagePoints1": lambda: pts2f(), "imagePoints2": lambda: pts2f(),
        "objectPoints": lambda: pts3f(),
        "prevPts": lambda: pts2f(8), "nextPts": lambda: pts2f(8),
        "corners": lambda: pts2f(8),
        "vertices": lambda: contour().reshape(-1, 2).astype(np.float32),
        "center": lambda: (W // 2, H // 2),
        "pt1": lambda: (4, 5), "pt2": lambda: (30, 25),
        "pt": lambda: (10, 10), "p": lambda: (W // 2, H // 2),
        "org": lambda: (5, 20),
        "position": lambda: (5, 20),
        "anchor": lambda: (-1, -1),
        "offset": lambda: (0, 0),
        "shift": lambda: 0,
        "rect": lambda: (4, 4, 16, 12),
        "roi": lambda: (4, 4, 16, 12),
        "window": lambda: (4, 4, 16, 12),
        "box": lambda: ((16.0, 12.0), (10.0, 8.0), 15.0),
        "rect1": lambda: (2, 2, 10, 10), "rect2": lambda: (6, 6, 10, 10),
        # matrices
        "M": lambda: np.array([[1.0, 0, 2], [0, 1.0, 3]]),
        "m": lambda: np.array([[1.0, 0, 2], [0, 1.0, 3]]),
        "H": lambda: np.eye(3),
        "K": lambda: camK(),
        "R": lambda: np.eye(3),
        "Q": lambda: np.eye(4),
        "T": lambda: np.array([1.0, 0.0, 0.0]),
        "E": lambda: _e_mat(),
        "F": lambda: _e_mat(),
        "rvec": lambda: np.array([0.01, 0.02, 0.03]),
        "tvec": lambda: np.array([0.1, 0.2, 1.0]),
        "rvec1": lambda: np.array([0.01, 0.02, 0.03]),
        "tvec1": lambda: np.array([0.1, 0.2, 1.0]),
        "rvec2": lambda: np.array([0.02, 0.01, 0.04]),
        "tvec2": lambda: np.array([0.2, 0.1, 1.1]),
        "rvecs": lambda: [np.array([0.01, 0.02, 0.03])],
        "tvecs": lambda: [np.array([0.1, 0.2, 1.0])],
        "cameraMatrix": lambda: camK(),
        "cameraMatrix1": lambda: camK(), "cameraMatrix2": lambda: camK(),
        "newCameraMatrix": lambda: camK(),
        "distCoeffs": lambda: dist5(),
        "distCoeffs1": lambda: dist5(), "distCoeffs2": lambda: dist5(),
        "projMatr1": lambda: camK() @ np.eye(3, 4),
        "projMatr2": lambda: camK() @ np.hstack(
            [np.eye(3), [[0.1], [0], [0]]]),
        "projPoints1": lambda: pts2f().reshape(-1, 2).T.astype(np.float64),
        "projPoints2": lambda: pts2f().reshape(-1, 2).T.astype(np.float64),
        "kernel": lambda: np.ones((3, 3), np.uint8),
        "kernelX": lambda: np.array([1.0, 2, 1]) / 4,
        "kernelY": lambda: np.array([1.0, 2, 1]) / 4,
        "lut": lambda: np.arange(256, dtype=np.uint8),
        "mean": lambda: np.zeros(3),
        "eigenvectors": lambda: np.eye(3),
        "window_fn": lambda: None,
        # scalars
        "ksize": lambda: 3, "d": lambda: 3,
        "blockSize": lambda: 2, "apertureSize": lambda: 3,
        "aperture_size": lambda: 3,
        "ddepth": lambda: -1, "dtype": lambda: -1, "depth": lambda: 0,
        "dx": lambda: 1, "dy": lambda: 0,
        "x": lambda: 1.0, "y": lambda: 1.0,
        "n": lambda: 4,
        "thresh": lambda: 128.0, "maxval": lambda: 255.0,
        "threshold": lambda: 50.0,
        "threshold1": lambda: 50.0, "threshold2": lambda: 150.0,
        "alpha": lambda: 0.5, "beta": lambda: 0.5, "gamma": lambda: 0.0,
        "angle": lambda: 30.0, "scale": lambda: 1.0,
        "delta": lambda: 0.0,
        "rho": lambda: 1.0, "theta": lambda: np.pi / 180,
        "sigma": lambda: 1.5,
        "sigmaX": lambda: 1.5, "sigmaY": lambda: 0.0,
        "sigmaColor": lambda: 25.0, "sigmaSpace": lambda: 5.0,
        "sigma_s": lambda: 10.0, "sigma_r": lambda: 0.15,
        "sp": lambda: 5.0, "sr": lambda: 20.0,
        "h": lambda: 3.0,
        "hColor": lambda: 3.0,
        "radius": lambda: 5, "maxRadius": lambda: 10.0,
        "minRadius": lambda: 0,
        "thickness": lambda: 1, "lineType": lambda: 8,
        "line_type": lambda: 8,
        "fontFace": lambda: 0, "fontScale": lambda: 0.5,
        "fontHeight": lambda: 10,
        "pixelSize": lambda: 1,
        "color": lambda: (0, 255, 0),
        "text": lambda: "ok",
        "flags": lambda: 0, "method": lambda: 0, "mode": lambda: 0,
        "op": lambda: 0, "rotateCode": lambda: 0, "code": lambda: 0,
        "flipCode": lambda: 0,
        "borderType": lambda: 4, "borderMode": lambda: 4,
        "border_type": lambda: 4,
        "borderValue": lambda: 0,
        "normType": lambda: 4, "norm_type": lambda: 4,
        "interpolation": lambda: 1,
        "distanceType": lambda: 2, "maskSize": lambda: 3,
        "dsize": lambda: (W // 2, H // 2),
        "size": lambda: (W, H),
        "imageSize": lambda: (W, H),
        "patternSize": lambda: (4, 3),
        "winSize": lambda: (5, 5),
        "zeroZone": lambda: (-1, -1),
        "blockStride": lambda: (8, 8),
        "cellSize": lambda: (8, 8),
        "criteria": lambda: term_criteria(),
        "termCriteria": lambda: term_criteria(),
        "maxCount": lambda: 5, "maxIters": lambda: 20,
        "iterations": lambda: 1, "maxLevel": lambda: 2,
        "niters": lambda: 3,
        "K": lambda: camK(),
        "k": lambda: 0.04,
        "fx": lambda: 0.5, "fy": lambda: 0.5,
        "m00": lambda: 1.0,
        "qualityLevel": lambda: 0.01, "minDistance": lambda: 5.0,
        "maxCorners": lambda: 10,
        "maxArea": lambda: 100.0, "minArea": lambda: 1.0,
        "winStride": lambda: (8, 8), "padding": lambda: (0, 0),
        "histSize": lambda: [16], "ranges": lambda: [0, 256],
        "channels": lambda: [0],
        "channel": lambda: 0,
        "images": lambda: [img_u8()],
        "hist": lambda: np.ones((16, 1), np.float32),
        "signature1": lambda: np.array(
            [[1.0, 0, 0], [1.0, 5, 5]], np.float32),
        "signature2": lambda: np.array(
            [[1.0, 1, 1], [1.0, 4, 4]], np.float32),
        "H1": lambda: np.ones((16,), np.float32),
        "H2": lambda: np.ones((16,), np.float32),
        "lowerb": lambda: (10, 10, 10), "upperb": lambda: (200, 200, 200),
        "markers": lambda: np.zeros((H, W), np.int32),
        "bestLabels": lambda: None,
        "labels": lambda: None,
        "attempts": lambda: 1,
        "centers": lambda: None,
        "distance": lambda: 10.0,
        "fs": lambda: None,
        "buf": lambda: np.zeros(16, np.uint8),
        "ext": lambda: ".png",
        "winname": lambda: "callcov", "windowName": lambda: "callcov",
        "window_name": lambda: "callcov",
        "trackbarName": lambda: "tb", "trackbarname": lambda: "tb",
        "prop_id": lambda: 0, "propId": lambda: 0,
        "delay": lambda: 1,
        "value": lambda: 1.0, "val": lambda: 1.0,
        "count": lambda: 2,
        "times": lambda: np.array([0.01, 0.04, 0.1], np.float32),
        "exposure_times": lambda: np.array([0.01, 0.04, 0.1], np.float32),
        "response": lambda: None,
        "dist": lambda: 10.0,
        "maxDist": lambda: 10.0,
        "stdDev": lambda: None,
        "seed": lambda: 1,
        "low": lambda: 0.0, "high": lambda: 1.0,
        "idx": lambda: 0, "index": lambda: 0,
        "cn": lambda: 3,
        "rows": lambda: H, "cols": lambda: W,
        "nimages": lambda: 1,
        "distType": lambda: 2, "param": lambda: 0.0,
        "reps": lambda: 0.01, "aeps": lambda: 0.01,
        "coi": lambda: 0,
        "order": lambda: 2,
        "onChange": lambda: (lambda *_: None),
        "userdata": lambda: None,
        "pos": lambda: 0,
        "key": lambda: "k",
        "obj": lambda: 0,
        "name": lambda: "k",
        "node": lambda: None,
        "fn": lambda: (lambda *_: None),
        "state": lambda: 0,
        # --- r5 sweep batch 2
        "maxValue": lambda: 255.0,
        "colormap": lambda: 2,
        "epsilon": lambda: 1.0,
        "nsides": lambda: 4,
        "closed": lambda: True,
        "isClosed": lambda: True,
        "patternWasFound": lambda: True,
        "measureDist": lambda: False,
        "cmpop": lambda: 0,
        "connectivity": lambda: 8,
        "dp": lambda: 1.0,
        "minDist": lambda: 8.0,
        "top": lambda: 2, "bottom": lambda: 2,
        "left": lambda: 2, "right": lambda: 2,
        "len_": lambda: 10,
        "numNodes": lambda: 4,
        "prev": lambda: gray_u8(), "next": lambda: gray_u8(),
        "iFixedPoint": lambda: -1,
        "apertureWidth": lambda: 4.0, "apertureHeight": lambda: 3.0,
        "feature": lambda: 0,
        "imgRect": lambda: (0, 0, W, H),
        "map1": lambda: np.tile(np.arange(W, dtype=np.float32),
                                (H, 1)),
        "map2": lambda: np.tile(np.arange(H, dtype=np.float32)[:, None],
                                (1, W)),
        "convexhull": lambda: np.array([0, 1, 2, 3], np.int32),
        "coefficients": lambda: np.zeros((2, 3)),
        "projMatrix": lambda: camK() @ np.eye(3, 4),
        "observations": lambda: [img_u8()],
        "in_K": lambda: camK(),
        "in_": lambda: img_f32(1)[..., 0],
        "points3d": lambda: _rng().rand(H, W, 3).astype(np.float32),
        "weights1": lambda: img_f32(1)[..., 0],
        "weights2": lambda: img_f32(1)[..., 0],
        "weight": lambda: img_f32(1)[..., 0],
        "newVal": lambda: 0,
        "maxSpeckleSize": lambda: 10,
        "maxDiff": lambda: 2,
        "from_": lambda: pts2f(8).reshape(-1, 2),
        "to": lambda: pts2f(8).reshape(-1, 2),
        "srcPoints": lambda: pts2f(8),
        "dstPoints": lambda: pts2f(8),
        "length": lambda: 1.0,
        "axes": lambda: (8, 5),
        "seedPoint": lambda: (W // 2, H // 2),
        "src3": lambda: None,
        "ellipse_params": lambda: (16.0, 12.0, 8.0, 6.0, 0.3),
        "pixelHeight": lambda: 12,
        "lambd": lambda: 10.0,
        "psi": lambda: 0.0,
        "roi1": lambda: (0, 0, W, H), "roi2": lambda: (0, 0, W, H),
        "minDisparity": lambda: 0, "numberOfDisparities": lambda: 16,
        "blockSize_": lambda: 5, "SADWindowSize": lambda: 5,
        "disparity": lambda: np.zeros((H, W), np.int16),
        "disp": lambda: np.zeros((H, W), np.int16),
        "cost": lambda: np.zeros((H, W), np.int16),
        "Rt": lambda: np.eye(4),
        "flow": lambda: np.zeros((H, W, 2), np.float32),
        "v": lambda: 1.0,
        "s": lambda: "x",
        "api": lambda: 0,
        "inpaintRadius": lambda: 3.0,
        "mv": lambda: [gray_u8(), gray_u8(), gray_u8()],
        "fromTo": lambda: [0, 0],
        "aTa": lambda: True,
        "magnitude": lambda: img_f32(1)[..., 0],
        "power": lambda: 2.0,
        "stddev": lambda: 1.0,
        "axis": lambda: 0,
        "dim": lambda: 0,
        "contours": lambda: [contour()],
        "contourIdx": lambda: -1,
        "contour1": lambda: contour(), "contour2": lambda: contour(),
        "p1": lambda: contour().reshape(-1, 2).astype(np.float32),
        "p2": lambda: (contour().reshape(-1, 2)
                       + np.int32(2)).astype(np.float32),
        "A": lambda: np.eye(3), "B": lambda: np.eye(3),
        "subdir": lambda: "x",
        "relative_path": lambda: "/tmp/rcv_callcov_missing.nope",
        "indices": lambda: np.array([[0, 1, 2]], np.int32),
        "onMouse": lambda: (lambda *_: None),
        "nthreads": lambda: 1,
        "minval": lambda: 0,
        "onoff": lambda: True,
        "prop_value": lambda: 0,
        "title": lambda: "t",
        "coeffs": lambda: np.array([1.0, -3.0, 2.0]),
        "Func": lambda: np.array([1.0, 1.0]),
        "Constr": lambda: np.array([[1.0, 1.0, 2.0]]),
        "z": lambda: np.zeros(2),
        "blob_": lambda: _rng().rand(1, 3, 8, 8).astype(np.float32),
        "bboxes": lambda: [(2, 2, 10, 10), (3, 3, 10, 10)],
        "scores": lambda: [0.9, 0.8],
        "score_threshold": lambda: 0.5,
        "nms_threshold": lambda: 0.4,
        "class_ids": lambda: [0, 0],
        "rotations": lambda: [np.eye(3)],
        "normals": lambda: None,
        "translations": lambda: [np.zeros(3)],
        "pointsMask": lambda: None,
        "srcImgs": lambda: [img_u8(), img_u8(), img_u8()],
        "imgToDenoiseIndex": lambda: 1,
        "temporalWindowSize": lambda: 1,
        "keypoints": lambda: [],
        "keypoints1": lambda: [], "keypoints2": lambda: [],
        "matches1to2": lambda: [],
        "outImg": lambda: img_u8(),
        "outImage": lambda: img_u8(),
        "charucoCorners": lambda: pts2f(4),
        "charucoIds": lambda: np.array([[0], [1], [2], [3]], np.int32),
        "markerLength": lambda: 0.05,
        "squareLength": lambda: 0.08,
        "unregisteredCameraMatrix": lambda: camK(),
        "registeredCameraMatrix": lambda: camK(),
        "registeredDistCoeffs": lambda: dist5(),
        "unregisteredDepth": lambda: (
            _rng().rand(H, W).astype(np.float32) + 1),
        "outputImagePlaneSize": lambda: (W, H),
        "objectPoints1": lambda: [pts3f(8)],
        "objectPoints2": lambda: [pts3f(8)],
        "pyr": lambda: None,
        "rmats": lambda: [np.eye(3), np.eye(3)],
        "tl1": lambda: (0, 0), "tl2": lambda: (4, 4),
        "sz1": lambda: (W, H), "sz2": lambda: (W, H),
        "animation": lambda: None,
        "imgs": lambda: [img_u8()],
        "mat": lambda: img_u8(),
        "win_size": lambda: (5, 5),
        "D": lambda: np.array([0.01, 0.001, 0.0, 0.0]),
        "Knew": lambda: camK(),
        "new_size": lambda: (W, H),
        "undistorted": lambda: pts2f(6),
        "distorted": lambda: pts2f(6),
        "balance": lambda: 0.0,
        "fov_scale": lambda: 1.0,
        "streams": lambda: [],
        "timeoutNs": lambda: 0,
        "w": lambda: np.array([3.0, 2.0, 1.0]),
        "u": lambda: np.eye(3),
        "vt": lambda: np.eye(3),
        "rhs": lambda: np.ones(3),
        "v1": lambda: np.array([1.0, 0.0, 0.0]),
        "v2": lambda: np.array([0.0, 1.0, 0.0]),
        "icovar": lambda: np.eye(3),
        "kp1": lambda: None, "kp2": lambda: None,
        "dictionary": lambda: 0,
        "dict_id": lambda: 0,
        "ids": lambda: np.array([[0], [1], [2], [3]], np.int32),
        "markerCorners": lambda: [pts2f(4).reshape(1, 4, 2)],
        "markerIds": lambda: np.array([[0]], np.int32),
        "point": lambda: (10.0, 10.0),
        "points_": lambda: pts2f(),
        "lines": lambda: None,
        "shape": lambda: (H, W),
        "ndims": lambda: 2,
        "c1": lambda: "M", "c2": lambda: "J",
        "c3": lambda: "P", "c4": lambda: "G",
    }
    return table.get(n)


def _e_mat():
    # a valid essential matrix from (R=I rotated slightly, t)
    t = np.array([0.1, 0.2, 1.0])
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    import numpy.linalg as la  # noqa
    th = 0.05
    Rz = np.array([[np.cos(th), -np.sin(th), 0],
                   [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    return tx @ Rz


_MISS = object()


_WRITE_EXT = {
    "savepointcloud": ".ply", "savemesh": ".ply", "imwrite": ".png",
    "imwritemulti": ".png", "writeopticalflow": ".flo",
}


def _filename_for(func_name: str) -> str:
    """Write-style callables get a writable tmp path with the right
    extension; read-style ones get a MISSING path (FileNotFoundError
    proves the wrapper reached its real implementation — the bug class
    hunted here is TypeError/AttributeError/NotImplementedError).
    Never reuse one path for both: r4's sweep hang came from imwrite
    creating the file a later PLY loader then parsed forever."""
    base = func_name.rsplit(".", 1)[-1].lower()
    for key, ext in _WRITE_EXT.items():
        if base.startswith(key):
            return f"/tmp/rcv_callcov_out{ext}"
    if base.startswith(("save", "write", "imwrite", "dump", "imencode")):
        return "/tmp/rcv_callcov_out.bin"
    return "/tmp/rcv_callcov_missing.nope"


def synth_arg(pname: str, func_name: str):
    if pname in ("filename", "filename_or_buf", "file", "path",
                 "fileName"):
        return _filename_for(func_name)
    f = _by_name(pname)
    if f is not None:
        return f()
    # suffix/substring heuristics
    ln = pname.lower()
    if ln.endswith(("img", "image", "frame")):
        return img_u8()
    if "mask" in ln:
        return mask_u8()
    if ln.endswith(("x", "y")) and len(pname) <= 3:
        return 1
    if "size" in ln:
        return 3
    if "thresh" in ln:
        return 50.0
    if "flag" in ln or "type" in ln or "method" in ln or "mode" in ln:
        return 0
    if "scale" in ln or "factor" in ln:
        return 1.0
    if "iter" in ln or "count" in ln or "level" in ln:
        return 2
    if "name" in ln or "win" in ln:
        return "callcov"
    return _MISS


# ---------------------------------------------------------------------------
# Per-callable overrides (args factories or "skip:<reason>")
# ---------------------------------------------------------------------------

def _aruco_dict():
    import rustcv_tpu.cv2 as R
    return R.aruco.getPredefinedDictionary(0)


def _aruco_board():
    import rustcv_tpu.cv2 as R
    return R.aruco.CharucoBoard((4, 3), 0.08, 0.05,
                                _aruco_dict())


def _marker_img():
    import rustcv_tpu.cv2 as R
    img = R.aruco.generateImageMarker(_aruco_dict(), 0, 64)
    out = np.full((96, 96), 255, np.uint8)
    out[16:80, 16:80] = np.asarray(img)
    return out


OVERRIDES = {
    "ANNIndex_create": lambda: ((3,), {}),
    "Octree_createWithDepth": lambda: ((pts3f(16).reshape(-1, 3), 3), {}),
    "Octree_createWithResolution": lambda: (
        (pts3f(16).reshape(-1, 3), 0.1), {}),
    "VideoCapture_waitAny": lambda: (([],), {}),
    "VideoWriter_fourcc": lambda: (("M", "J", "P", "G"), {}),
    "adaptiveThreshold": lambda: ((gray_u8(), 255.0, 0, 0, 3, 2.0), {}),
    "HoughCircles": lambda: ((gray_u8(), 3, 1.0, 8.0), {}),
    "HoughCirclesWithAccumulator": lambda: (
        (gray_u8(), 3, 1.0, 8.0), {}),
    "HoughLinesPointSet": lambda: (
        (pts2f(10).reshape(-1, 1, 2), 5, 1, 0.0, 40.0, 1.0,
         0.0, np.pi, np.pi / 90), {}),
    "KeyPoint_convert": lambda: (([],), {}),
    "KeyPoint_overlap": "skip:needs two KeyPoint objects (class harness)",
    "Mahalanobis": lambda: ((np.array([1.0, 0, 0]),
                             np.array([0.0, 1, 0]), np.eye(3)), {}),
    "SVBackSubst": lambda: ((np.array([3.0, 2.0, 1.0]), np.eye(3),
                             np.eye(3), np.ones(3)), {}),
    "approxPolyDP": lambda: ((contour(), 2.0, True), {}),
    "arcLength": lambda: ((contour(), True), {}),
    "applyColorMap": lambda: ((gray_u8(), 2), {}),
    "blur": lambda: ((img_u8(), (3, 3)), {}),
    "boxFilter": lambda: ((img_u8(), -1, (3, 3)), {}),
    "sqrBoxFilter": lambda: ((img_u8(), -1, (3, 3)), {}),
    "stackBlur": lambda: ((img_u8(), (3, 3)), {}),
    "GaussianBlur": lambda: ((img_u8(), (3, 3), 1.5), {}),
    "borderInterpolate": lambda: ((5, 10, 4), {}),
    "buildMST": lambda: ((4, np.array([[0, 1, 1.0], [1, 2, 2.0],
                                       [2, 3, 1.5]])), {}),
    "calcOpticalFlowFarneback": lambda: (
        (gray_u8(), gray_u8(), None, 0.5, 2, 5, 2, 5, 1.1, 0), {}),
    "calibrateCameraRO": lambda: (
        ([pts3f(8)], [pts2f(8)], (W, H), -1, camK(), dist5()), {}),
    "calibrateCameraROExtended": lambda: (
        ([pts3f(8)], [pts2f(8)], (W, H), -1, camK(), dist5()), {}),
    "calibrationMatrixValues": lambda: (
        (camK(), (W, H), 4.0, 3.0), {}),
    "checkHardwareSupport": lambda: ((0,), {}),
    "getHardwareFeatureName": lambda: ((0,), {}),
    "clipLine": lambda: (((0, 0, W, H), (2, 2), (50, 50)), {}),
    "compare": lambda: ((img_u8(), img_u8(), 0), {}),
    "connectedComponentsWithAlgorithm": lambda: (
        (mask_u8(), 8, 4, 0), {}),
    "connectedComponentsWithStatsWithAlgorithm": lambda: (
        (mask_u8(), 8, 4, 0), {}),
    "convertMaps": lambda: (
        (np.tile(np.arange(W, dtype=np.float32), (H, 1)),
         np.tile(np.arange(H, dtype=np.float32)[:, None], (1, W)),
         11), {}),
    "convexityDefects": lambda: (
        (contour(), np.array([0, 1, 2, 3], np.int32)), {}),
    "copyMakeBorder": lambda: ((img_u8(), 2, 2, 2, 2, 0), {}),
    "correctChromaticAberration": lambda: (
        (img_u8(), np.zeros((4, 3)), (W, H), 1), {}),
    "accumulateWeighted": lambda: (
        (img_u8(), img_u8().astype(np.float32), 0.5), {}),
    "rectangle": lambda: (
        (img_u8(), (4, 5), (30, 25), (0, 255, 0)), {}),
    "findTransformECCMultiScale": lambda: (
        (gray_u8(), gray_u8()), {}),
    "decomposeProjectionMatrix": lambda: (
        (camK() @ np.eye(3, 4),), {}),
    "demosaicing": lambda: ((gray_u8(), 46), {}),   # BayerBG2BGR
    "denoise_TVL1": lambda: (([gray_u8()],), {}),
    "depthTo3dSparse": lambda: (
        (np.random.RandomState(0).rand(H, W).astype(np.float32) + 1,
         camK(), pts2f(6)), {}),
    "ellipse": lambda: ((img_u8(), (16, 12), (8, 5), 0.0, 0.0, 360.0,
                         (0, 255, 0)), {}),
    "ellipse2Poly": lambda: (((16, 12), (8, 5), 0, 0, 360, 10), {}),
    "estimateAffine2D": lambda: ((pts2f(8), pts2f(8)), {}),
    "estimateAffinePartial2D": lambda: ((pts2f(8), pts2f(8)), {}),
    "fastNlMeansDenoisingColoredMulti": lambda: (
        ([img_u8(), img_u8(), img_u8()], 1, 1), {}),
    "fastNlMeansDenoisingMulti": lambda: (
        ([gray_u8(), gray_u8(), gray_u8()], 1, 1), {}),
    "filterHomographyDecompByVisibleRefpoints": lambda: (
        ([np.eye(3)], [np.zeros((3, 1))], pts2f(6), pts2f(6)), {}),
    "filterSpeckles": lambda: (
        (np.zeros((H, W), np.int16), 0, 10, 2), {}),
    "find4QuadCornerSubpix": lambda: (
        (gray_u8(), pts2f(4), (3, 3)), {}),
    "findHomography": lambda: ((pts2f(8), pts2f(8)), {}),
    "findPlanes": lambda: (
        (np.random.RandomState(0).rand(H, W, 3).astype(np.float32),),
        {}),
    "findTransformECCMultiScale": lambda: (
        (gray_u8(), gray_u8(),
         np.eye(2, 3, dtype=np.float32)), {}),
    "fisheye.distortPoints": lambda: (
        (pts2f(6), camK(), np.array([0.01, 0.001, 0.0, 0.0])), {}),
    "fisheye.undistortPoints": lambda: (
        (pts2f(6), camK(), np.array([0.01, 0.001, 0.0, 0.0])), {}),
    "fisheye.undistortImage": lambda: (
        (img_u8(), camK(), np.array([0.01, 0.001, 0.0, 0.0])),
        {"Knew": camK()}),
    "fisheye.initUndistortRectifyMap": lambda: (
        (camK(), np.array([0.01, 0.001, 0.0, 0.0]), np.eye(3), camK(),
         (W, H), 5), {}),
    "fisheye.estimateNewCameraMatrixForUndistortRectify": lambda: (
        (camK(), np.array([0.01, 0.001, 0.0, 0.0]), (W, H),
         np.eye(3)), {}),
    "fisheye.projectPoints": lambda: (
        (pts3f(6), np.zeros(3), np.array([0.0, 0, 1.0]), camK(),
         np.array([0.01, 0.001, 0.0, 0.0])), {}),
    "flipND": lambda: ((img_u8(), 0), {}),
    "floodFill": lambda: (
        (img_u8(), np.zeros((H + 2, W + 2), np.uint8),
         (W // 2, H // 2), (255, 0, 0)), {}),
    "gemm": lambda: ((np.eye(3), np.eye(3), 1.0, np.eye(3), 0.0), {}),
    "getClosestEllipsePoints": lambda: (
        ((16.0, 12.0, 8.0, 6.0, 0.3),
         pts2f(6).reshape(-1, 2)), {}),
    "getFontScaleFromHeight": lambda: ((0, 12, 1), {}),
    "getGaborKernel": lambda: (((5, 5), 1.5, 0.3, 10.0, 0.5), {}),
    "getRectSubPix": lambda: ((gray_u8(), (8, 8), (16.0, 12.0)), {}),
    "getStructuringElement": lambda: ((0, (3, 3)), {}),
    "getValidDisparityROI": lambda: (
        ((0, 0, W, H), (0, 0, W, H), 0, 16, 5), {}),
    "imencodemulti": lambda: ((".png", [img_u8()]), {}),
    "imshow": lambda: (("callcov", img_u8()), {}),
    "inpaint": lambda: ((img_u8(), mask_u8(), 3.0, 0), {}),
    "intersectConvexConvex": lambda: (
        (contour().reshape(-1, 2).astype(np.float32),
         (contour().reshape(-1, 2) + 2).astype(np.float32)), {}),
    "kmeans": lambda: (
        (np.random.RandomState(0).rand(20, 3).astype(np.float32), 3,
         None, (3, 10, 0.01), 1, 0), {}),
    "matMulDeriv": lambda: ((np.eye(3), np.eye(3)), {}),
    "matchShapes": lambda: ((contour(), contour(), 1, 0.0), {}),
    "merge": lambda: (([gray_u8(), gray_u8(), gray_u8()],), {}),
    "mixChannels": lambda: (
        ([img_u8()], [np.zeros((H, W, 3), np.uint8)],
         [0, 2, 1, 1, 2, 0]), {}),
    "mulTransposed": lambda: ((gray_u8().astype(np.float32), True), {}),
    "pointPolygonTest": lambda: ((contour(), (10.0, 10.0), False), {}),
    "polarToCart": lambda: (
        (np.random.RandomState(0).rand(H, W).astype(np.float32),
         np.random.RandomState(1).rand(H, W).astype(np.float32)), {}),
    "polylines": lambda: ((img_u8(), [contour()], True,
                           (0, 255, 0)), {}),
    "pow": lambda: ((img_u8().astype(np.float32), 2.0), {}),
    "randn": lambda: ((np.zeros((H, W), np.float32), 0.0, 1.0), {}),
    "randu": lambda: ((np.zeros((H, W), np.float32), 0.0, 1.0), {}),
    "reduce": lambda: ((gray_u8(), 0, 0, -1), {}),
    "reduceArgMax": lambda: ((gray_u8(), 0), {}),
    "reduceArgMin": lambda: ((gray_u8(), 0), {}),
    "remap": lambda: (
        (img_u8(), np.tile(np.arange(W, dtype=np.float32), (H, 1)),
         np.tile(np.arange(H, dtype=np.float32)[:, None], (1, W)),
         1), {}),
    "reprojectImageTo3D": lambda: (
        (np.zeros((H, W), np.int16), np.eye(4)), {}),
    "rescaleDepth": lambda: (
        (np.random.RandomState(0).rand(H, W).astype(np.float32), 5),
        {}),
    "resizeWindow": lambda: (("callcov", 64, 48), {}),
    "rgbdNormals": lambda: (
        (np.random.RandomState(0).rand(H, W, 3).astype(np.float32),),
        {}),
    "saveMesh": lambda: (
        ("/tmp/rcv_callcov_out.ply", pts3f(4).reshape(-1, 3),
         np.array([[0, 1, 2]], np.int32)), {}),
    "setMouseCallback": lambda: (
        ("callcov", (lambda *a: None)), {}),
    "setNumThreads": lambda: ((1,), {}),
    "setTrackbarMin": lambda: (("tb", "callcov", 0), {}),
    "setTrackbarMax": lambda: (("tb", "callcov", 10), {}),
    "setTrackbarPos": lambda: (("tb", "callcov", 1), {}),
    "setUseOptimized": lambda: ((True,), {}),
    "setWindowProperty": lambda: (("callcov", 0, 0), {}),
    "setWindowTitle": lambda: (("callcov", "t"), {}),
    "solveCubic": lambda: ((np.array([1.0, -6.0, 11.0, -6.0]),), {}),
    "solveLP": lambda: ((np.array([1.0, 1.0]),
                         np.array([[1.0, 1.0, 2.0]])), {}),
    "solvePoly": lambda: ((np.array([-6.0, 11.0, -6.0, 1.0]),), {}),
    "stereoRectifyUncalibrated": lambda: (
        (pts2f(8) * 30, pts2f(8) * 30 + 1, np.eye(3), (W, H)), {}),
    "triangleRasterize": lambda: (
        (pts3f(3).reshape(-1, 3) + [0, 0, 3],
         np.array([[0, 1, 2]], np.int32),
         np.random.RandomState(0).rand(3, 3).astype(np.float32),
         img_u8().astype(np.float32),
         np.full((H, W), 100.0, np.float32),
         np.eye(4), 60.0, 0.1, 100.0), {}),
    "triangleRasterizeColor": lambda: (
        (pts3f(3).reshape(-1, 3) + [0, 0, 3],
         np.array([[0, 1, 2]], np.int32),
         np.random.RandomState(0).rand(3, 3).astype(np.float32),
         img_u8().astype(np.float32),
         np.eye(4), 60.0, 0.1, 100.0), {}),
    "triangleRasterizeDepth": lambda: (
        (pts3f(3).reshape(-1, 3) + [0, 0, 3],
         np.array([[0, 1, 2]], np.int32),
         np.full((H, W), 100.0, np.float32),
         np.eye(4), 60.0, 0.1, 100.0), {}),
    "validateDisparity": lambda: (
        (np.zeros((H, W), np.int16), np.zeros((H, W), np.int16),
         0, 16), {}),
    "warpFrame": lambda: (
        (np.random.RandomState(0).rand(H, W).astype(np.float32) + 1,
         img_u8(), mask_u8(), np.eye(4), camK()), {}),
    "writeOpticalFlow": lambda: (
        ("/tmp/rcv_callcov_out.flo",
         np.zeros((H, W, 2), np.float32)), {}),
    "registerDepth": lambda: (
        (camK(), camK(), dist5(), np.eye(4),
         np.random.RandomState(0).rand(H, W).astype(np.float32) + 1,
         (W, H)), {}),
    # aruco
    "aruco.detectMarkers": lambda: ((_marker_img(), _aruco_dict()), {}),
    "aruco.drawDetectedCornersCharuco": lambda: (
        (img_u8(), pts2f(4)), {}),
    "aruco.estimatePoseBoard": lambda: (
        ([pts2f(4).reshape(1, 4, 2)], np.array([[0]], np.int32),
         _grid_board(), camK(), dist5(), np.zeros(3), np.zeros(3)), {}),
    "aruco.estimatePoseSingleMarkers": lambda: (
        ([pts2f(4).reshape(1, 4, 2)], 0.05, camK(), dist5()), {}),
    "aruco.generateImageMarker": lambda: ((_aruco_dict(), 0, 64), {}),
    "aruco.getPredefinedDictionary": lambda: ((0,), {}),
    "aruco.interpolateCornersCharuco": lambda: (
        ([pts2f(4).reshape(1, 4, 2)], np.array([[0]], np.int32),
         _marker_img(), _aruco_board()), {}),
    "aruco_ArucoDetector": lambda: ((_aruco_dict(),), {}),
    "aruco_Board": lambda: (
        ([pts3f(4).reshape(4, 3)], _aruco_dict(),
         np.array([[0]], np.int32)), {}),
    "aruco_CharucoBoard": lambda: (
        ((4, 3), 0.08, 0.05, _aruco_dict()), {}),
    "aruco_CharucoDetector": lambda: ((_aruco_board(),), {}),
    "aruco_Dictionary": lambda: ((0,), {}),
    "aruco_GridBoard": lambda: (
        ((2, 2), 0.05, 0.01, _aruco_dict()), {}),
    # detail / dnn / misc submodules
    "detail.computeImageFeatures": "skip:needs a FeaturesFinder instance"
                                   " (class harness)",
    "detail.computeImageFeatures2": "skip:needs a FeaturesFinder instance"
                                    " (class harness)",
    "detail.leaveBiggestComponent": "skip:needs ImageFeatures/MatchesInfo"
                                    " graph objects (class harness)",
    "detail.matchesGraphAsString": "skip:needs MatchesInfo objects"
                                   " (class harness)",
    "detail.normalizeUsingWeightMap": lambda: (
        (img_f32(1)[..., 0], img_u8().astype(np.int16)), {}),
    "detail.overlapRoi": lambda: (
        ((0, 0), (4, 4), (W, H), (W, H)), {}),
    "detail.restoreImageFromLaplacePyr": lambda: (
        ([img_u8().astype(np.float32) for _ in range(3)],), {}),
    "detail.selectRandomSubset": lambda: ((3, 10), {}),
    "detail.waveCorrect": lambda: (([np.eye(3), np.eye(3)], 0), {}),
    "dnn.NMSBoxes": lambda: (
        ([(2, 2, 10, 10), (3, 3, 10, 10)], [0.9, 0.8], 0.5, 0.4), {}),
    "dnn.NMSBoxesBatched": lambda: (
        ([(2, 2, 10, 10), (3, 3, 10, 10)], [0.9, 0.8], [0, 1],
         0.5, 0.4), {}),
    "dnn.NMSBoxesRotated": lambda: (
        ([((5.0, 5.0), (4.0, 3.0), 10.0),
          ((6.0, 6.0), (4.0, 3.0), 15.0)], [0.9, 0.8], 0.5, 0.4), {}),
    "dnn.softNMSBoxes": lambda: (
        ([(2, 2, 10, 10), (3, 3, 10, 10)], [0.9, 0.8], 0.5, 0.4), {}),
    "dnn.imagesFromBlob": lambda: (
        (np.random.RandomState(0).rand(1, 3, 8, 8).astype(np.float32),),
        {}),
    "samples.addSamplesDataSearchSubDirectory": lambda: (("x",), {}),
    "samples.findFile": lambda: (("nope.png", False), {}),
    "samples.findFileOrKeep": lambda: (("nope.png",), {}),
    "utils.dumpBool": lambda: ((True,), {}),
    "utils.dumpCString": lambda: (("x",), {}),
    "utils.dumpDouble": lambda: ((1.0,), {}),
    "utils.dumpFloat": lambda: ((1.0,), {}),
    "utils.dumpInt": lambda: ((1,), {}),
    "videoio_registry.getBackendName": lambda: ((0,), {}),
    "videoio_registry.hasBackend": lambda: ((0,), {}),
    "videoio_registry.isBackendBuiltIn": lambda: ((0,), {}),
    "imencodeanimation": "skip:needs a cv2.Animation object (class"
                         " harness)",
    "imwriteanimation": "skip:needs a cv2.Animation object (class"
                        " harness)",
    "loadChromaticAberrationParams": "skip:needs a FileStorage node"
                                     " (exercised in"
                                     " tests/test_cv2_filestorage.py)",
    "blendLinear": lambda: (
        (img_u8(), img_u8(), img_f32(1)[..., 0],
         1 - img_f32(1)[..., 0]), {}),
    "broadcast": lambda: ((gray_u8(), (2, H, W)), {}),
    "computeCorrespondEpilines": lambda: (
        (pts2f(6), 1, _e_mat()), {}),
    "drawChessboardCorners": lambda: (
        (img_u8(), (4, 3), pts2f(12), True), {}),
    "drawContours": lambda: (
        (img_u8(), [contour()], -1, (0, 255, 0)), {}),
    "drawFrameAxes": lambda: (
        (img_u8(), camK(), dist5(), np.array([0.01, 0.02, 0.03]),
         np.array([0.1, 0.2, 1.0]), 0.1), {}),
    "drawKeypoints": lambda: ((img_u8(), [], None), {}),
    # gray-input / shape-specific ops (convert reached:ValueError into
    # real coverage)
    "HuMoments": lambda: ((__import__("rustcv_tpu.cv2", fromlist=["x"])
                           .moments(gray_u8()),), {}),
    "PCACompute": lambda: (
        (_rng().rand(20, 3).astype(np.float32), None), {}),
    "PCACompute2": lambda: (
        (_rng().rand(20, 3).astype(np.float32), None), {}),
    "PCAProject": lambda: (
        (_rng().rand(5, 3).astype(np.float32), np.zeros(3),
         np.eye(3)), {}),
    "PCABackProject": lambda: (
        (_rng().rand(5, 3).astype(np.float32), np.zeros(3),
         np.eye(3)), {}),
    "RQDecomp3x3": lambda: ((np.eye(3) + 0.1,), {}),
    "Rodrigues": lambda: ((np.array([0.01, 0.02, 0.03]),), {}),
    "bilateralFilter": lambda: ((gray_u8(), 3, 25.0, 5.0), {}),
    "equalizeHist": lambda: ((gray_u8(),), {}),
    "findTransformECC": lambda: ((gray_u8(), gray_u8()), {}),
    "computeECC": lambda: ((gray_u8(), gray_u8()), {}),
    "dct": lambda: ((gray_u8().astype(np.float32),), {}),
    "idct": lambda: ((gray_u8().astype(np.float32),), {}),
    "dft": lambda: ((gray_u8().astype(np.float32),), {}),
    "idft": lambda: ((gray_u8().astype(np.float32),), {}),
    "divSpectrums": lambda: (
        (_rng().rand(H, W, 2).astype(np.float32),
         _rng().rand(H, W, 2).astype(np.float32) + 1, 0), {}),
    "mulSpectrums": lambda: (
        (_rng().rand(H, W, 2).astype(np.float32),
         _rng().rand(H, W, 2).astype(np.float32), 0), {}),
    "findNonZero": lambda: ((mask_u8(),), {}),
    "distanceTransform": lambda: ((mask_u8(), 2, 3), {}),
    "distanceTransformWithLabels": lambda: ((mask_u8(), 2, 3), {}),
    "cornerEigenValsAndVecs": lambda: ((gray_u8(), 3, 3), {}),
    "cornerMinEigenVal": lambda: ((gray_u8(), 3), {}),
    "calibrateCamera": lambda: (
        (_planar_views()[0], _planar_views()[1], (W, H), None, None),
        {}),
    "calibrateCameraExtended": lambda: (
        (_planar_views()[0], _planar_views()[1], (W, H), None, None),
        {}),
    "calibrateCameraRO": lambda: (
        (_planar_views()[0], _planar_views()[1], (W, H), -1, None,
         None), {}),
    "calibrateCameraROExtended": lambda: (
        (_planar_views()[0], _planar_views()[1], (W, H), -1, None,
         None), {}),
    "estimateChessboardSharpness": lambda: (
        (gray_u8(), (4, 3), pts2f(12)), {}),
    "depthTo3d": lambda: (
        (_rng().rand(H, W).astype(np.float32) + 1, camK()), {}),
    "detail.resultRoi": lambda: (
        ([(0, 0), (4, 4)], [(W, H), (W, H)]), {}),
    "detail.resultTl": lambda: (([(0, 0), (4, 4)],), {}),
    "aruco.drawDetectedMarkers": lambda: (
        (img_u8(), [pts2f(4).reshape(1, 4, 2)]), {}),
    "inpaint": lambda: ((img_u8(), mask_u8(), 3.0, 0), {}),
    "DescriptorMatcher_create": lambda: (("BruteForce",), {}),
    "registerCameras": lambda: (
        (_planar_views()[0], _planar_views()[0], _planar_views()[1],
         _planar_views()[1], camK(), dist5(), camK(), dist5()), {}),
    "registerCamerasExtended": lambda: (
        (_planar_views()[0], _planar_views()[0], _planar_views()[1],
         _planar_views()[1], camK(), dist5(), camK(), dist5()), {}),
    "cvtColorTwoPlane": lambda: (
        (gray_u8(), _rng().randint(0, 256, (H // 2, W // 2, 2)
                                   ).astype(np.uint8), 91), {}),
    "detail.restoreImageFromLaplacePyr": lambda: (
        ([_rng().rand(H // (2 ** k), W // (2 ** k), 3
                      ).astype(np.float32) for k in range(3)],), {}),
    # final batch: square matrices / gray inputs / valid point sets
    "PCACompute": lambda: (
        (_rng().rand(20, 3).astype(np.float32), None, None, 2), {}),
    "aruco.estimatePoseSingleMarkers": lambda: (
        (np.asarray(pts2f(4), np.float32).reshape(1, 1, 4, 2), 0.05,
         camK(), dist5()), {}),
    "determinant": lambda: ((np.eye(3) * 2,), {}),
    "eigen": lambda: ((np.eye(3) + 0.1,), {}),
    "eigenNonSymmetric": lambda: ((np.eye(3) + 0.1,), {}),
    "invert": lambda: ((np.eye(3) * 2,), {}),
    "solve": lambda: ((np.eye(3) * 2, np.ones(3)), {}),
    "setIdentity": lambda: ((np.zeros((3, 3), np.float32),), {}),
    "trace": lambda: ((np.eye(3),), {}),
    "transposeND": lambda: ((img_u8(), [1, 0, 2]), {}),
    "findTransformECCWithMask": lambda: ((gray_u8(), gray_u8()), {}),
    "fisheye.calibrate": lambda: (
        (_planar_views()[0], _planar_views()[1], (W, H), None, None),
        {}),
    "getAffineTransform": lambda: (
        (pts2f(3).reshape(3, 2), pts2f(3).reshape(3, 2) + 1), {}),
    "getPerspectiveTransform": lambda: (
        (np.array([[0, 0], [30, 0], [30, 25], [0, 25]], np.float32),
         np.array([[1, 1], [29, 2], [28, 24], [2, 23]], np.float32)),
        {}),
    "getClosestEllipsePoints": lambda: (
        (((16.0, 12.0), (8.0, 6.0), 15.0),
         pts2f(6).reshape(-1, 2)), {}),
    "goodFeaturesToTrackWithQuality": lambda: (
        (gray_u8(), 10, 0.01, 5.0, None), {}),
    "distanceTransformWithLabels": lambda: (
        (255 - mask_u8(), 2, 3), {}),
    "initCameraMatrix2D": lambda: (
        (_planar_views()[0], _planar_views()[1], (W, H)), {}),
    "insertChannel": lambda: ((gray_u8(), img_u8(), 1), {}),
    "integral2": lambda: ((gray_u8(),), {}),
    "integral3": lambda: ((gray_u8(),), {}),
    "integral": lambda: ((gray_u8(),), {}),
    "perspectiveTransform": lambda: ((pts2f(6), np.eye(3)), {}),
    "phaseCorrelate": lambda: (
        (gray_u8().astype(np.float32),
         gray_u8().astype(np.float32)), {}),
    "phaseCorrelateIterative": lambda: (
        (gray_u8().astype(np.float32),
         gray_u8().astype(np.float32)), {}),
    "preCornerDetect": lambda: ((gray_u8(), 3), {}),
    "spatialGradient": lambda: ((gray_u8(),), {}),
    "rectangleIntersectionArea": lambda: (
        ((2.0, 2.0, 10.0, 10.0), (6.0, 6.0, 10.0, 10.0)), {}),
    "rotatedRectangleIntersection": lambda: (
        (((16.0, 12.0), (10.0, 8.0), 15.0),
         ((18.0, 13.0), (10.0, 8.0), 40.0)), {}),
    "sampsonDistance": lambda: (
        (np.array([1.0, 2.0, 1.0]), np.array([1.5, 2.5, 1.0]),
         _e_mat()), {}),
    "savePointCloud": lambda: (
        ("/tmp/rcv_callcov_out.ply", pts3f(4).reshape(-1, 3)), {}),
    "solveP3P": lambda: (
        (pts3f(3), pts2f(3), camK(), dist5(), 0), {}),
    "stereoCalibrate": lambda: (
        (_planar_views()[0], _planar_views()[1], _planar_views()[1],
         camK(), dist5(), camK(), dist5(), (W, H)), {}),
    "stereoCalibrateExtended": lambda: (
        (_planar_views()[0], _planar_views()[1], _planar_views()[1],
         camK(), dist5(), camK(), dist5(), (W, H), np.eye(3),
         np.zeros(3)), {}),
    "thresholdWithMask": lambda: (
        (gray_u8(), gray_u8().copy(), mask_u8(), 128.0, 255.0, 0), {}),
    "warpPerspective": lambda: ((img_u8(), np.eye(3), (W, H)), {}),
    "imdecode": lambda: ((_png_bytes(), 1), {}),
    "imdecodeWithMetadata": lambda: ((_png_bytes(), 1), {}),
    "imread": lambda: ((_png_file(), 1), {}),
    "imreadWithMetadata": lambda: ((_png_file(), 1), {}),
    "readOpticalFlow": lambda: ((_flo_file(),), {}),
    "loadMesh": lambda: ((_ply_mesh_file(),), {}),
    "loadPointCloud": lambda: ((_ply_cloud_file(),), {}),
    "getTrackbarPos": lambda: (_trackbar_args(), {}),
    "setTrackbarPos": lambda: (_trackbar_args(1), {}),
    "setTrackbarMin": lambda: (_trackbar_args(0), {}),
    "setTrackbarMax": lambda: (_trackbar_args(10), {}),
    "drawMatches": lambda: (
        (img_u8(), [], img_u8(), [], [], None), {}),
    "drawMatchesKnn": lambda: (
        (img_u8(), [], img_u8(), [], [], None), {}),
}

EXPECTED_FAIL_NAMES = {
    # honest documented guards: no bundled DNN weights / interactive
    # window / FileStorage-only constructors
    "ALIKED_create", "DISK_create", "DISK_createFromMemory",
    "FaceDetectorYN_create", "FaceRecognizerSF_create",
    "LightGlueMatcher_create", "LightGlueMatcher_createFromMemory",
    "TrackerDaSiamRPN_create", "TrackerNano_create", "TrackerVit_create",
    "dnn.readNet", "dnn.readNetFromCaffe", "dnn.readNetFromDarknet",
    "dnn.readNetFromONNX", "dnn.readNetFromTensorflow",
    "dnn.readNetFromTorch", "dnn.readNetFromTFLite",
    "dnn.readNetFromModelOptimizer",
    "selectROI", "selectROIs", "mcc_CChecker",
    "calibrateMultiview", "calibrateMultiviewExtended",
}


def _grid_board():
    import rustcv_tpu.cv2 as R
    return R.aruco.GridBoard((2, 2), 0.05, 0.01, _aruco_dict())


def _png_bytes():
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img_u8()[..., ::-1]).save(buf, "PNG")
    return np.frombuffer(buf.getvalue(), np.uint8)


def _png_file():
    path = "/tmp/rcv_callcov_in.png"
    from PIL import Image
    Image.fromarray(img_u8()[..., ::-1]).save(path, "PNG")
    return path


def _flo_file():
    import rustcv_tpu.cv2 as R
    path = "/tmp/rcv_callcov_in.flo"
    R.writeOpticalFlow(path, np.zeros((H, W, 2), np.float32))
    return path


def _ply_mesh_file():
    import rustcv_tpu.cv2 as R
    path = "/tmp/rcv_callcov_in_mesh.ply"
    R.saveMesh(path, pts3f(4).reshape(-1, 3),
               np.array([[0, 1, 2]], np.int32))
    return path


def _ply_cloud_file():
    import rustcv_tpu.cv2 as R
    path = "/tmp/rcv_callcov_in_cloud.ply"
    R.savePointCloud(path, pts3f(4).reshape(-1, 3))
    return path


def _trackbar_args(*extra):
    import rustcv_tpu.cv2 as R
    R.namedWindow("callcov")
    R.createTrackbar("tb", "callcov", 0, 10, lambda *_: None)
    return ("tb", "callcov") + tuple(extra)


def _planar_views(n_views=3):
    """Z=0 chessboard-like targets + noisy projections for calibrate."""
    r = _rng()
    obj = np.zeros((12, 3), np.float32)
    obj[:, :2] = np.mgrid[0:4, 0:3].T.reshape(-1, 2)
    k = camK()
    objs, imgs = [], []
    for v in range(n_views):
        rvec = np.array([0.05 * v, -0.03 * v, 0.02])
        tvec = np.array([0.1 * v, 0.05, 5.0 + v])
        th = np.linalg.norm(rvec)
        kx = rvec / max(th, 1e-12)
        K_ = np.array([[0, -kx[2], kx[1]], [kx[2], 0, -kx[0]],
                       [-kx[1], kx[0], 0]])
        R_ = np.eye(3) + np.sin(th) * K_ + (1 - np.cos(th)) * (K_ @ K_)
        cam = obj @ R_.T + tvec
        uv = (cam @ k.T)
        uv = uv[:, :2] / uv[:, 2:3]
        objs.append(obj.reshape(-1, 1, 3))
        imgs.append((uv + r.rand(12, 2) * 0.01
                     ).astype(np.float32).reshape(-1, 1, 2))
    return objs, imgs


def build_call(func, qualname: str, overrides: dict):
    """Return (args, kwargs) for func, or a string reason to skip."""
    if qualname in overrides:
        ov = overrides[qualname]
        if isinstance(ov, str):
            return ov          # skip reason
        return ov() if callable(ov) else ov
    try:
        sig = inspect.signature(func)
    except (TypeError, ValueError):
        return "no-signature"
    args = []
    for p in sig.parameters.values():
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        if p.default is not inspect.Parameter.empty:
            continue           # rely on defaults
        if p.name in ("self",):
            continue
        v = synth_arg(p.name, qualname)
        if v is _MISS:
            return f"unsynthesized-param:{p.name}"
        args.append(v)
    return (tuple(args), {})
