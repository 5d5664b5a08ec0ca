"""cv2 class-style APIs for the drop-in shim: features2d, video, calib3d,
photo factories, objdetect, stereo, and the io/highgui surface.

Everything delegates to the accelerator-native implementations (ops/, imgproc/,
capture/); only calling conventions are adapted here. Descriptor bit
layouts (ORB/BRIEF) are internally consistent but not cv2's byte order —
matching works within the framework, cross-matching against cv2-produced
descriptors does not (documented delta)."""
from __future__ import annotations

import numpy as np

from ..core.mat import Mat
from .. import imgproc as _ip
from .. import imgcodecs as _icodec
from .. import highgui as _hg
from . import _constants as _C


def _m(a):
    if isinstance(a, Mat):
        return a
    return Mat.from_array(np.ascontiguousarray(a))


def _o(x):
    if isinstance(x, Mat):
        x = x.to_numpy()
    x = np.asarray(x)
    if x.ndim == 3 and x.shape[2] == 1:
        x = x[:, :, 0]
    return x


# ------------------------------------------------------------ features2d

class KeyPoint:
    __slots__ = ("pt", "size", "angle", "response", "octave", "class_id")

    def __init__(self, x=0.0, y=0.0, size=0.0, angle=-1.0, response=0.0,
                 octave=0, class_id=-1):
        self.pt = (float(x), float(y))
        self.size = float(size)
        self.angle = float(angle)
        self.response = float(response)
        self.octave = int(octave)
        self.class_id = int(class_id)

    def __repr__(self):
        return f"KeyPoint(pt={self.pt}, size={self.size})"


class DMatch:
    __slots__ = ("queryIdx", "trainIdx", "imgIdx", "distance")

    def __init__(self, queryIdx=0, trainIdx=0, distance=0.0, imgIdx=0):
        self.queryIdx = int(queryIdx)
        self.trainIdx = int(trainIdx)
        self.imgIdx = int(imgIdx)
        self.distance = float(distance)

    def __lt__(self, other):
        return self.distance < other.distance


class SIFT:
    """cv2.SIFT over ops/sift.py (descriptors float32, cv2 layout)."""

    def __init__(self, nfeatures=0, contrastThreshold=0.04,
                 edgeThreshold=10.0, sigma=1.6):
        self._kw = dict(n_features=int(nfeatures),
                        contrast_threshold=float(contrastThreshold),
                        edge_threshold=float(edgeThreshold),
                        sigma=float(sigma))

    @staticmethod
    def create(*a, **k):
        return SIFT(*a, **k)

    def detectAndCompute(self, image, mask=None):
        kps, desc = _ip.sift_features(_m(image), **self._kw)
        keypoints = tuple(
            KeyPoint(x, y, size, angle, response, int(octave))
            for x, y, size, angle, response, octave in np.asarray(kps))
        return keypoints, np.asarray(desc, np.float32)

    def detect(self, image, mask=None):
        return self.detectAndCompute(image, mask)[0]

    def compute(self, image, keypoints):
        kps, desc = self.detectAndCompute(image)
        return kps, desc


class ORB:
    def __init__(self, nfeatures=500, fastThreshold=20):
        self._n = int(nfeatures)
        self._t = int(fastThreshold)

    @staticmethod
    def create(nfeatures=500, **kw):
        return ORB(nfeatures, kw.get("fastThreshold", 20))

    def detectAndCompute(self, image, mask=None):
        pts, angles, desc, valid = _ip.orb_features(_m(image), self._n,
                                                    self._t)
        pts, angles = np.asarray(pts), np.asarray(angles)
        desc = np.asarray(desc)
        sel = np.asarray(valid)
        keypoints = tuple(
            KeyPoint(p[0], p[1], 31.0, np.degrees(a) % 360.0)
            for p, a in zip(pts[sel], angles[sel]))
        d8 = desc[sel].astype(np.uint32).view(np.uint8).reshape(-1, 32)
        return keypoints, d8

    def detect(self, image, mask=None):
        return self.detectAndCompute(image, mask)[0]


class AKAZE:
    def __init__(self, threshold=0.001):
        self._t = float(threshold)

    @staticmethod
    def create(threshold=0.001, **kw):
        return AKAZE(threshold)

    def detectAndCompute(self, image, mask=None):
        out = _ip.akaze_features(_m(image), threshold=self._t)
        kps, desc = out[0], out[1]
        kps = np.asarray(kps)
        keypoints = tuple(KeyPoint(p[0], p[1], float(p[2]) if
                                   kps.shape[1] > 2 else 4.8)
                          for p in kps)
        d = np.asarray(desc)
        if d.dtype != np.uint8:
            d = d.astype(np.uint32).view(np.uint8).reshape(len(d), -1)
        return keypoints, d


class FastFeatureDetector:
    def __init__(self, threshold=20, nonmaxSuppression=True):
        self._t = int(threshold)
        self._nms = bool(nonmaxSuppression)

    @staticmethod
    def create(threshold=20, nonmaxSuppression=True, **kw):
        return FastFeatureDetector(threshold, nonmaxSuppression)

    def detect(self, image, mask=None):
        pts = np.asarray(_ip.fast_corners(_m(image), self._t,
                                          nms=self._nms))
        return tuple(KeyPoint(p[0], p[1], 7.0) for p in pts)


def SIFT_create(*a, **k):
    return SIFT(*a, **k)


def ORB_create(*a, **k):
    return ORB.create(*a, **k)


def AKAZE_create(*a, **k):
    return AKAZE.create(*a, **k)


def FastFeatureDetector_create(*a, **k):
    return FastFeatureDetector.create(*a, **k)


class BFMatcher:
    """Brute-force matcher with cv2's exact NN / crossCheck / knn
    semantics (plain numpy distance matrices)."""

    def __init__(self, normType=4, crossCheck=False):
        self._norm = int(normType)
        self._cross = bool(crossCheck)

    @staticmethod
    def create(normType=4, crossCheck=False):
        return BFMatcher(normType, crossCheck)

    def _dists(self, q, t):
        q = np.asarray(q)
        t = np.asarray(t)
        if self._norm == _C.NORM_HAMMING:
            x = np.unpackbits(q[:, None, :], axis=2)
            y = np.unpackbits(t[None, :, :], axis=2)
            return (x != y).sum(axis=2).astype(np.float64)
        qf = q.astype(np.float64)
        tf = t.astype(np.float64)
        d2 = ((qf * qf).sum(1)[:, None] + (tf * tf).sum(1)[None, :]
              - 2.0 * qf @ tf.T)
        d2 = np.maximum(d2, 0)
        return d2 if self._norm == _C.NORM_L2SQR else np.sqrt(d2)

    def match(self, queryDescriptors, trainDescriptors):
        d = self._dists(queryDescriptors, trainDescriptors)
        nn = d.argmin(axis=1)
        out = []
        if self._cross:
            rnn = d.argmin(axis=0)
            for qi, ti in enumerate(nn):
                if rnn[ti] == qi:
                    out.append(DMatch(qi, ti, d[qi, ti]))
        else:
            out = [DMatch(qi, ti, d[qi, ti]) for qi, ti in enumerate(nn)]
        return out

    def knnMatch(self, queryDescriptors, trainDescriptors, k=2):
        d = self._dists(queryDescriptors, trainDescriptors)
        idx = np.argsort(d, axis=1, kind="stable")[:, :k]
        return [[DMatch(qi, int(ti), d[qi, int(ti)]) for ti in row]
                for qi, row in enumerate(idx)]


def drawKeypoints(image, keypoints, outImage, color=(0, 255, 0), flags=0):
    out = np.asarray(image).copy()
    if out.ndim == 2:
        out = np.repeat(out[:, :, None], 3, axis=2)
    from . import circle as _circle
    for kp in keypoints:
        _circle(out, (int(round(kp.pt[0])), int(round(kp.pt[1]))), 3,
                color, 1)
    return out


def drawMatches(img1, keypoints1, img2, keypoints2, matches1to2,
                outImg=None, matchColor=(0, 255, 0),
                singlePointColor=(255, 0, 0), matchesMask=None, flags=0):
    a = np.asarray(img1)
    b = np.asarray(img2)
    if a.ndim == 2:
        a = np.repeat(a[:, :, None], 3, axis=2)
    if b.ndim == 2:
        b = np.repeat(b[:, :, None], 3, axis=2)
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[:a.shape[0], :a.shape[1]] = a
    canvas[:b.shape[0], a.shape[1]:] = b
    from . import line as _line
    for i, mm in enumerate(matches1to2):
        if matchesMask is not None and not matchesMask[i]:
            continue
        p1 = keypoints1[mm.queryIdx].pt
        p2 = keypoints2[mm.trainIdx].pt
        _line(canvas, (int(p1[0]), int(p1[1])),
              (int(p2[0]) + a.shape[1], int(p2[1])), matchColor, 1)
    return canvas


# ------------------------------------------------------------ video

def calcOpticalFlowFarneback(prev, next, flow, pyr_scale, levels, winsize,
                             iterations, poly_n, poly_sigma, flags):
    out = _ip.calc_optical_flow_farneback(_m(prev), _m(next),
                                          levels=int(levels),
                                          winsize=int(winsize),
                                          iterations=int(iterations),
                                          poly_n=int(poly_n),
                                          poly_sigma=float(poly_sigma))
    return np.asarray(out, np.float32)


def calcOpticalFlowPyrLK(prevImg, nextImg, prevPts, nextPts,
                         winSize=(21, 21), maxLevel=3, criteria=None,
                         **kw):
    pts = np.asarray(prevPts, np.float32).reshape(-1, 2)
    nxt, status = _ip.calc_optical_flow_pyr_lk(
        _m(prevImg), _m(nextImg), pts, win=int(winSize[0]),
        levels=int(maxLevel) + 1)
    nxt = np.asarray(nxt, np.float32).reshape(-1, 1, 2)
    st = np.asarray(status).astype(np.uint8).reshape(-1, 1)
    err = np.zeros((len(pts), 1), np.float32)
    return nxt, st, err


class BackgroundSubtractorMOG2:
    def __init__(self, history=500, varThreshold=16, detectShadows=True):
        self._bs = _ip.create_background_subtractor_mog2(
            detect_shadows=bool(detectShadows))

    def apply(self, image, fgmask=None, learningRate=-1):
        return np.asarray(self._bs.apply(np.asarray(image)))

    def getBackgroundImage(self):
        return np.asarray(self._bs.background)


class BackgroundSubtractorKNN:
    def __init__(self, history=500, dist2Threshold=400.0,
                 detectShadows=True):
        self._bs = _ip.create_background_subtractor_knn()

    def apply(self, image, fgmask=None, learningRate=-1):
        return np.asarray(self._bs.apply(np.asarray(image)))


def createBackgroundSubtractorMOG2(history=500, varThreshold=16,
                                   detectShadows=True):
    return BackgroundSubtractorMOG2(history, varThreshold, detectShadows)


def createBackgroundSubtractorKNN(history=500, dist2Threshold=400.0,
                                  detectShadows=True):
    return BackgroundSubtractorKNN(history, dist2Threshold, detectShadows)


def meanShift(probImage, window, criteria):
    # cv2 accepts any single-channel weight image (float back-projections
    # included) — go straight to the ops layer, no u8 Mat round trip.
    from ..ops import hist as _hist
    iters, win = _hist.mean_shift(np.asarray(probImage, np.float64),
                                  tuple(window), max_iter=int(criteria[1]))
    return int(iters), tuple(int(v) for v in win)


def CamShift(probImage, window, criteria):
    from ..ops import hist as _hist
    box, win = _hist.cam_shift(np.asarray(probImage, np.float64),
                               tuple(window), max_iter=int(criteria[1]))
    cx, cy, w, h = box
    rot = ((float(cx), float(cy)), (float(w), float(h)), 0.0)
    return rot, tuple(int(v) for v in win)


class KalmanFilter:
    """cv2.KalmanFilter attribute surface over ops/kalman.py.

    Matrix properties return float32 COPIES (the filter's state lives in
    float64 inside ops/kalman.py): in-place edits like
    ``kf.transitionMatrix[0, 2] = dt`` are discarded — read, modify, and
    assign back (``m = kf.transitionMatrix; m[0, 2] = dt;
    kf.transitionMatrix = m``)."""

    def __init__(self, dynamParams, measureParams, controlParams=0,
                 type=5):
        from ..ops.kalman import KalmanFilter as _KF
        self._kf = _KF(int(dynamParams), int(measureParams),
                       int(controlParams))

    # cv2 attribute names <-> ours
    def _get(name):  # noqa: N805 - descriptor factory
        def g(self):
            v = getattr(self._kf, name)
            return None if v is None else np.asarray(v, np.float32)

        def s(self, val):
            setattr(self._kf, name, np.asarray(val, np.float64))
        return property(g, s)

    transitionMatrix = _get("transition_matrix")
    measurementMatrix = _get("measurement_matrix")
    processNoiseCov = _get("process_noise_cov")
    measurementNoiseCov = _get("measurement_noise_cov")
    controlMatrix = _get("control_matrix")
    errorCovPost = _get("error_cov_post")
    errorCovPre = _get("error_cov_pre")
    statePost = _get("state_post")
    statePre = _get("state_pre")
    del _get

    def predict(self, control=None):
        return np.asarray(self._kf.predict(control),
                          np.float32).reshape(-1, 1)

    def correct(self, measurement):
        return np.asarray(
            self._kf.correct(np.asarray(measurement, np.float64).ravel()),
            np.float32).reshape(-1, 1)


class _TrackerShim:
    _impl = None

    def __init__(self, *a, **k):
        self._t = self._impl(*a, **k)

    @classmethod
    def create(cls, *a, **k):
        return cls(*a, **k)

    def init(self, image, boundingBox):
        # ops trackers take ndarrays, not Mats (r5 call-coverage fix)
        self._t.init(np.asarray(_o(_m(image))), tuple(boundingBox))

    def update(self, image):
        ok, bbox = self._t.update(np.asarray(_o(_m(image))))
        return bool(ok), tuple(float(v) for v in bbox)


def _tracker_class(name, impl):
    return type(name, (_TrackerShim,), {"_impl": staticmethod(impl),
                                        "_impl_cls": impl})


def _make_trackers():
    from ..ops.kcf import TrackerKCF as _KCF
    from ..ops.csrt import TrackerCSRT as _CSRT
    from ..ops.mil import TrackerMIL as _MIL
    from ..ops.tracker import TrackerMOSSE as _MOSSE
    out = {}
    for name, impl in [("TrackerKCF", _KCF), ("TrackerCSRT", _CSRT),
                       ("TrackerMIL", _MIL), ("TrackerMOSSE", _MOSSE)]:
        cls = type(name, (_TrackerShim,), {})
        cls._impl = impl
        out[name] = cls
        out[name + "_create"] = cls.create
    return out


globals().update(_make_trackers())


# ------------------------------------------------------------ calib3d

def Rodrigues(src, dst=None, jacobian=None):
    src = np.asarray(src, np.float64)
    out = np.asarray(_ip.rodrigues(src.reshape(3, 3) if src.size == 9
                                   else src.ravel()))
    if out.size == 3:
        out = out.reshape(3, 1)
    return out, None


def solvePnP(objectPoints, imagePoints, cameraMatrix, distCoeffs,
             rvec=None, tvec=None, useExtrinsicGuess=False, flags=0):
    dist = np.zeros(5) if distCoeffs is None else \
        np.asarray(distCoeffs, np.float64).ravel()
    obj = np.asarray(objectPoints, np.float64).reshape(-1, 3)
    img = np.asarray(imagePoints, np.float64).reshape(-1, 2)
    if flags == _C.SOLVEPNP_EPNP:
        r, t = _ip.solve_pnp_epnp(obj, img, np.asarray(cameraMatrix),
                                  dist)
    else:
        r, t = _ip.solve_pnp(obj, img, np.asarray(cameraMatrix), dist)
    return True, np.asarray(r).reshape(3, 1), np.asarray(t).reshape(3, 1)


def solvePnPRansac(objectPoints, imagePoints, cameraMatrix, distCoeffs,
                   rvec=None, tvec=None, useExtrinsicGuess=False,
                   iterationsCount=100, reprojectionError=8.0,
                   confidence=0.99, inliers=None, flags=0):
    dist = np.zeros(5) if distCoeffs is None else \
        np.asarray(distCoeffs, np.float64).ravel()
    r, t, inl = _ip.solve_pnp_ransac(
        np.asarray(objectPoints, np.float64).reshape(-1, 3),
        np.asarray(imagePoints, np.float64).reshape(-1, 2),
        np.asarray(cameraMatrix), dist,
        iters=int(iterationsCount),
        reproj_threshold=float(reprojectionError))
    ok = r is not None
    inliers = None if inl is None else \
        np.flatnonzero(np.asarray(inl)).reshape(-1, 1).astype(np.int32)
    return ok, (None if r is None else np.asarray(r).reshape(3, 1)), \
        (None if t is None else np.asarray(t).reshape(3, 1)), inliers


def projectPoints(objectPoints, rvec, tvec, cameraMatrix, distCoeffs,
                  imagePoints=None, jacobian=None, aspectRatio=0):
    dist = np.zeros(5) if distCoeffs is None else \
        np.asarray(distCoeffs, np.float64).ravel()
    uv = _ip.project_points(
        np.asarray(objectPoints, np.float64).reshape(-1, 3),
        np.asarray(rvec, np.float64).ravel(),
        np.asarray(tvec, np.float64).ravel(),
        np.asarray(cameraMatrix), dist)
    return np.asarray(uv, np.float64).reshape(-1, 1, 2), None


def findHomography(srcPoints, dstPoints, method=0,
                   ransacReprojThreshold=3.0, mask=None, maxIters=2000,
                   confidence=0.995):
    H, inl = _ip.find_homography(
        np.asarray(srcPoints, np.float64).reshape(-1, 2),
        np.asarray(dstPoints, np.float64).reshape(-1, 2),
        ransac_thresh=float(ransacReprojThreshold),
        iters=min(int(maxIters), 2000))
    m = np.asarray(inl).astype(np.uint8).reshape(-1, 1)
    return (None if H is None else np.asarray(H)), m


def findFundamentalMat(points1, points2, method=0, ransacReprojThreshold=3,
                       confidence=0.99, maxIters=1000, mask=None):
    F, inl = _ip.find_fundamental_mat(
        np.asarray(points1, np.float64).reshape(-1, 2),
        np.asarray(points2, np.float64).reshape(-1, 2))
    m = np.asarray(inl).astype(np.uint8).reshape(-1, 1)
    return (None if F is None else np.asarray(F)), m


def findEssentialMat(points1, points2, cameraMatrix=None, method=0,
                     prob=0.999, threshold=1.0, maxIters=1000, mask=None):
    K = np.eye(3) if cameraMatrix is None else np.asarray(cameraMatrix)
    E, inl = _ip.find_essential_mat(
        np.asarray(points1, np.float64).reshape(-1, 2),
        np.asarray(points2, np.float64).reshape(-1, 2), K)
    m = np.asarray(inl).astype(np.uint8).reshape(-1, 1)
    return (None if E is None else np.asarray(E)), m


def recoverPose(E, points1, points2, cameraMatrix=None, distanceThresh=50,
                mask=None):
    K = np.eye(3) if cameraMatrix is None else np.asarray(cameraMatrix)
    n, R, t, good = _ip.recover_pose(
        np.asarray(E),
        np.asarray(points1, np.float64).reshape(-1, 2),
        np.asarray(points2, np.float64).reshape(-1, 2), K)
    m = None if good is None else \
        (np.asarray(good).astype(np.uint8) * 255).reshape(-1, 1)
    return int(n), np.asarray(R), np.asarray(t).reshape(3, 1), m


def calibrateCamera(objectPoints, imagePoints, imageSize, cameraMatrix,
                    distCoeffs, rvecs=None, tvecs=None, flags=0,
                    criteria=None):
    objs = [np.asarray(o, np.float64).reshape(-1, 3) for o in objectPoints]
    imgs = [np.asarray(i, np.float64).reshape(-1, 2) for i in imagePoints]
    rms, K, dist, rv, tv = _ip.calibrate_camera(objs, imgs,
                                                tuple(imageSize))
    return float(rms), np.asarray(K), \
        np.asarray(dist, np.float64).reshape(1, -1), \
        tuple(np.asarray(r).reshape(3, 1) for r in rv), \
        tuple(np.asarray(t).reshape(3, 1) for t in tv)


def undistort(src, cameraMatrix, distCoeffs, dst=None, newCameraMatrix=None):
    out = _ip.undistort(_m(src), np.asarray(cameraMatrix),
                        np.asarray(distCoeffs, np.float64).ravel(),
                        newCameraMatrix)
    return _o(out)


def undistortPoints(src, cameraMatrix, distCoeffs, dst=None, R=None, P=None):
    pts = np.asarray(src, np.float64).reshape(-1, 2)
    out = _ip.undistort_points(pts, np.asarray(cameraMatrix),
                               np.asarray(distCoeffs, np.float64).ravel(),
                               None if P is None else np.asarray(P))
    return np.asarray(out, np.float32).reshape(-1, 1, 2)


def initUndistortRectifyMap(cameraMatrix, distCoeffs, R, newCameraMatrix,
                            size, m1type=None, map1=None, map2=None):
    from ..ops import calib as _calib

    mx, my = _calib.init_undistort_rectify_map(
        np.asarray(cameraMatrix),
        np.asarray(distCoeffs, np.float64).ravel()
        if distCoeffs is not None else np.zeros(5),
        None if newCameraMatrix is None else np.asarray(newCameraMatrix),
        (int(size[0]), int(size[1])),
        None if R is None else np.asarray(R, np.float64))
    if m1type == _C.CV_16SC2:
        from ..ops import warp as _warp
        return _warp.convert_maps(mx, my)
    return np.asarray(mx, np.float32), np.asarray(my, np.float32)


def getOptimalNewCameraMatrix(cameraMatrix, distCoeffs, imageSize, alpha,
                              newImgSize=None, centerPrincipalPoint=False):
    ret = _ip.get_optimal_new_camera_matrix(
        np.asarray(cameraMatrix),
        np.asarray(distCoeffs, np.float64).ravel(),
        tuple(imageSize), float(alpha),
        None if newImgSize is None else (int(newImgSize[0]),
                                         int(newImgSize[1])),
        bool(centerPrincipalPoint))
    if isinstance(ret, tuple):
        K2, roi = ret
        return np.asarray(K2), tuple(int(v) for v in roi)
    return np.asarray(ret), (0, 0, int(imageSize[0]), int(imageSize[1]))


def stereoRectify(cameraMatrix1, distCoeffs1, cameraMatrix2, distCoeffs2,
                  imageSize, R, T, R1=None, R2=None, P1=None, P2=None,
                  Q=None, flags=1024, alpha=-1, newImageSize=None):
    out = _ip.stereo_rectify(np.asarray(cameraMatrix1),
                             np.asarray(distCoeffs1, np.float64).ravel(),
                             np.asarray(cameraMatrix2),
                             np.asarray(distCoeffs2, np.float64).ravel(),
                             tuple(imageSize), np.asarray(R),
                             np.asarray(T).ravel())
    return tuple(np.asarray(x) for x in out[:5]) + tuple(out[5:])


def triangulatePoints(projMatr1, projMatr2, projPoints1, projPoints2):
    p1 = np.asarray(projPoints1, np.float64)
    p2 = np.asarray(projPoints2, np.float64)
    if p1.shape[0] == 2:
        p1, p2 = p1.T, p2.T
    out = _ip.triangulate_points(np.asarray(projMatr1),
                                 np.asarray(projMatr2),
                                 p1.reshape(-1, 2), p2.reshape(-1, 2))
    # (N, 4) homogeneous → cv2's 4×N, dtype following the input points
    dt = np.asarray(projPoints1).dtype
    dt = dt if dt in (np.float32, np.float64) else np.float64
    return np.asarray(out, dt).T


def estimateAffine2D(from_, to, inliers=None, method=8,
                     ransacReprojThreshold=3.0, **kw):
    A, inl = _ip.estimate_affine_2d(
        np.asarray(from_, np.float64).reshape(-1, 2),
        np.asarray(to, np.float64).reshape(-1, 2))
    return (None if A is None else np.asarray(A)), \
        np.asarray(inl).astype(np.uint8).reshape(-1, 1)


def estimateAffinePartial2D(from_, to, inliers=None, method=8,
                            ransacReprojThreshold=3.0, **kw):
    A, inl = _ip.estimate_affine_partial_2d(
        np.asarray(from_, np.float64).reshape(-1, 2),
        np.asarray(to, np.float64).reshape(-1, 2))
    return (None if A is None else np.asarray(A)), \
        np.asarray(inl).astype(np.uint8).reshape(-1, 1)


def perspectiveTransform(src, m):
    pts = np.asarray(src, np.float64).reshape(-1, 2)
    out = _ip.perspective_transform(pts, np.asarray(m))
    return np.asarray(out, np.asarray(src).dtype).reshape(
        np.asarray(src).shape)


def transform(src, m):
    pts = np.asarray(src, np.float64).reshape(-1, 2)
    out = _ip.transform(pts, np.asarray(m))
    return np.asarray(out, np.asarray(src).dtype).reshape(-1, 1,
                                                          out.shape[-1])


def findChessboardCorners(image, patternSize, corners=None, flags=0):
    found, pts = _ip.find_chessboard_corners(_m(image),
                                             (int(patternSize[0]),
                                              int(patternSize[1])))
    if pts is None:
        return bool(found), None
    return bool(found), np.asarray(pts, np.float32).reshape(-1, 1, 2)


def findChessboardCornersSB(image, patternSize, corners=None, flags=0):
    found, pts = _ip.find_chessboard_corners_sb(_m(image),
                                                (int(patternSize[0]),
                                                 int(patternSize[1])))
    if pts is None:
        return bool(found), None
    return bool(found), np.asarray(pts, np.float32).reshape(-1, 1, 2)


def drawChessboardCorners(image, patternSize, corners, patternWasFound):
    m = _m(np.asarray(image))
    _ip.draw_chessboard_corners(m, tuple(patternSize),
                                np.asarray(corners, np.float64)
                                .reshape(-1, 2), bool(patternWasFound))
    np.copyto(image, m.to_numpy().reshape(np.asarray(image).shape))
    return image


def drawFrameAxes(image, cameraMatrix, distCoeffs, rvec, tvec, length,
                  thickness=3):
    out = _ip.draw_frame_axes(np.asarray(image), np.asarray(cameraMatrix),
                              np.asarray(distCoeffs, np.float64).ravel(),
                              np.asarray(rvec).ravel(),
                              np.asarray(tvec).ravel(), float(length),
                              int(thickness))
    np.copyto(image, np.asarray(out).reshape(image.shape))
    return image


def decomposeHomographyMat(H, K, rotations=None, translations=None,
                           normals=None):
    num, Rs, ts, ns = _ip.decompose_homography_mat(np.asarray(H),
                                                   np.asarray(K))
    return int(num), tuple(np.asarray(r) for r in Rs), \
        tuple(np.asarray(t).reshape(3, 1) for t in ts), \
        tuple(np.asarray(n).reshape(3, 1) for n in ns)


def decomposeEssentialMat(E, R1=None, R2=None, t=None):
    r1, r2, tt = _ip.decompose_essential_mat(np.asarray(E))
    return np.asarray(r1), np.asarray(r2), np.asarray(tt).reshape(3, 1)


def computeCorrespondEpilines(points, whichImage, F, lines=None):
    out = _ip.compute_correspond_epilines(
        np.asarray(points, np.float64).reshape(-1, 2), int(whichImage),
        np.asarray(F))
    return np.asarray(out, np.float32).reshape(-1, 1, 3)


# ------------------------------------------------------------ stereo

class StereoSGBM:
    def __init__(self, minDisparity=0, numDisparities=64, blockSize=5,
                 P1=None, P2=None, uniquenessRatio=10, disp12MaxDiff=1,
                 **kw):
        self._min = int(minDisparity)
        self._kw = dict(num_disparities=int(numDisparities),
                        block_size=int(blockSize), p1=P1, p2=P2,
                        uniqueness=int(uniquenessRatio),
                        disp12_max_diff=int(disp12MaxDiff))

    @staticmethod
    def create(minDisparity=0, numDisparities=64, blockSize=5, P1=None,
               P2=None, disp12MaxDiff=1, preFilterCap=0,
               uniquenessRatio=10, speckleWindowSize=0, speckleRange=0,
               mode=0):
        return StereoSGBM(minDisparity, numDisparities, blockSize, P1, P2,
                          uniquenessRatio, disp12MaxDiff)

    def compute(self, left, right):
        disp, valid = _ip.stereo_sgbm(_m(left), _m(right), **self._kw)
        disp = np.asarray(disp, np.float64)
        out = np.where(np.asarray(valid), disp * 16.0,
                       (self._min - 1) * 16.0)
        return np.rint(out).astype(np.int16)


class StereoBM:
    def __init__(self, numDisparities=64, blockSize=15):
        self._kw = dict(num_disparities=int(numDisparities),
                        block_size=int(blockSize))

    @staticmethod
    def create(numDisparities=64, blockSize=15):
        return StereoBM(numDisparities, blockSize)

    def compute(self, left, right):
        disp, valid = _ip.stereo_bm(_m(left), _m(right), **self._kw)
        disp = np.asarray(disp, np.float64)
        out = np.where(np.asarray(valid), disp * 16.0, -16.0)
        return np.rint(out).astype(np.int16)


def StereoSGBM_create(*a, **k):
    return StereoSGBM.create(*a, **k)


def StereoBM_create(*a, **k):
    return StereoBM.create(*a, **k)


# ------------------------------------------------------------ photo

def fastNlMeansDenoising(src, dst=None, h=3, templateWindowSize=7,
                         searchWindowSize=21):
    return _o(_ip.fast_nl_means_denoising(_m(src), float(h),
                                          int(templateWindowSize),
                                          int(searchWindowSize)))


def fastNlMeansDenoisingColored(src, dst=None, h=3, hColor=3,
                                templateWindowSize=7, searchWindowSize=21):
    return _o(_ip.fast_nl_means_denoising_colored(
        _m(src), float(h), float(hColor), int(templateWindowSize),
        int(searchWindowSize)))


def inpaint(src, inpaintMask, inpaintRadius, flags):
    method = "telea" if int(flags) == _C.INPAINT_TELEA else "diffusion"
    return _o(_ip.inpaint(_m(src), np.asarray(inpaintMask),
                          int(inpaintRadius), method))


def seamlessClone(src, dst, mask, p, flags, blend=None):
    # cv2-exact DST-I spectral path (ops/poisson_cv.py, ±1 LSB of
    # cv2 5.0); the iterative ops/poisson variants remain the
    # device-friendly framework spec behind rustcv_tpu.imgproc.
    from ..ops import poisson_cv as _pcv
    out = _pcv.seamless_clone_cv(
        np.asarray(_m(src).to_numpy(), np.uint8),
        np.asarray(_m(dst).to_numpy(), np.uint8),
        np.asarray(mask), (int(p[0]), int(p[1])), int(flags))
    return _o(out)


def colorChange(src, mask, dst=None, red_mul=1.0, green_mul=1.0,
                blue_mul=1.0):
    from ..ops import poisson_cv as _pcv
    out = _pcv.color_change_cv(
        np.asarray(_m(src).to_numpy(), np.uint8), np.asarray(mask),
        float(red_mul), float(green_mul), float(blue_mul))
    return _o(out)


def illuminationChange(src, mask, dst=None, alpha=0.2, beta=0.4):
    from ..ops import poisson_cv as _pcv
    out = _pcv.illumination_change_cv(
        np.asarray(_m(src).to_numpy(), np.uint8), np.asarray(mask),
        float(alpha), float(beta))
    return _o(out)


def textureFlattening(src, mask, dst=None, low_threshold=30,
                      high_threshold=45, kernel_size=3):
    from ..ops import poisson_cv as _pcv
    out = _pcv.texture_flattening_cv(
        np.asarray(_m(src).to_numpy(), np.uint8), np.asarray(mask),
        float(low_threshold), float(high_threshold), int(kernel_size))
    return _o(out)


def detailEnhance(src, dst=None, sigma_s=10, sigma_r=0.15):
    return _o(_ip.detail_enhance(_m(src), float(sigma_s), float(sigma_r)))


def stylization(src, dst=None, sigma_s=60, sigma_r=0.45):
    return _o(_ip.stylization(_m(src), float(sigma_s), float(sigma_r)))


def pencilSketch(src, dst1=None, dst2=None, sigma_s=60, sigma_r=0.07,
                 shade_factor=0.02):
    g, c = _ip.pencil_sketch(_m(src), float(sigma_s), float(sigma_r),
                             float(shade_factor))
    return _o(g), _o(c)


def edgePreservingFilter(src, dst=None, flags=1, sigma_s=60, sigma_r=0.4):
    return _o(_ip.edge_preserving_filter(_m(src), float(sigma_s),
                                         float(sigma_r)))


def decolor(src, grayscale=None, color_boost=None):
    g, boost = _ip.decolor(np.asarray(src))
    return np.asarray(g), np.asarray(boost)


class _Process:
    def __init__(self, fn):
        self._fn = fn

    def process(self, *a, **k):
        return self._fn(*a, **k)


def createMergeMertens(contrast_weight=1.0, saturation_weight=1.0,
                       exposure_weight=0.0):
    return _Process(lambda imgs, *a: np.asarray(
        _ip.merge_mertens([_m(i) for i in imgs]), np.float32))


def createMergeDebevec():
    from ..ops import hdr as _hdr

    def run(imgs, times, response=None):
        return np.asarray(_hdr.merge_debevec_numpy(
            [np.asarray(i) for i in imgs],
            np.asarray(times, np.float64).ravel(), response), np.float32)
    return _Process(run)


def createMergeRobertson():
    return _Process(lambda imgs, times, response=None: np.asarray(
        _ip.merge_robertson([_m(i) for i in imgs],
                            np.asarray(times, np.float64).ravel(),
                            response), np.float32))


def createCalibrateDebevec(samples=70, lambda_=10.0, random=False):
    from ..ops import hdr as _hdr

    def run(imgs, times):
        # ops returns the (3, 256) LOG response; cv2 returns the linear
        # inverse CRF as (256, 1, 3) float32.
        g = np.asarray(_hdr.calibrate_debevec(
            [np.asarray(i) for i in imgs],
            np.asarray(times, np.float64).ravel(),
            n_samples=int(samples), lam=float(lambda_),
            random=bool(random)))
        return np.exp(g).T.reshape(256, 1, 3).astype(np.float32)
    return _Process(run)


def createCalibrateRobertson(max_iter=30, threshold=0.01):
    def run(imgs, times):
        r = np.asarray(_ip.calibrate_robertson(
            [_m(i) for i in imgs],
            np.asarray(times, np.float64).ravel(),
            max_iter=int(max_iter), threshold=float(threshold)))
        return r.T.reshape(256, 1, 3).astype(np.float32)
    return _Process(run)


def createTonemap(gamma=1.0):
    return _Process(lambda hdr: np.asarray(
        np.clip(np.asarray(hdr, np.float32), 0, None) ** (1.0 / gamma),
        np.float32))


def createTonemapDrago(gamma=1.0, saturation=1.0, bias=0.85):
    return _Process(lambda hdr: np.asarray(
        _ip.tonemap_drago(np.asarray(hdr, np.float32), gamma, saturation,
                          bias), np.float32))


def createTonemapMantiuk(gamma=1.0, scale=0.7, saturation=1.0):
    return _Process(lambda hdr: np.asarray(
        _ip.tonemap_mantiuk(np.asarray(hdr, np.float32), gamma, scale,
                            saturation), np.float32))


def createTonemapReinhard(gamma=1.0, intensity=0.0, light_adapt=1.0,
                          color_adapt=0.0):
    from ..ops import hdr as _hdr
    return _Process(lambda h: np.asarray(
        _hdr.tonemap_reinhard_cv(np.asarray(h, np.float32), gamma,
                                 intensity, light_adapt, color_adapt),
        np.float32))


def createAlignMTB(max_bits=6, exclude_range=4, cut=True):
    from ..ops import hdr as _hdr

    class _MTB(_Process):
        def process(self, src, dst=None, times=None, response=None):
            out = _ip.align_mtb([_m(i) for i in src],
                                max_bits=int(max_bits),
                                exclude_range=int(exclude_range))
            out = [np.asarray(_o(o)) for o in out]
            if dst is not None:
                for d, o in zip(dst, out):
                    np.copyto(d, o.reshape(np.asarray(d).shape))
                return dst
            return out

        def calculateShift(self, img0, img1):
            # cv2: shift moving img1 onto the reference img0 → Point(x, y)
            from ..ops.color import bgr_to_gray_cv
            g0 = np.asarray(img0)
            g1 = np.asarray(img1)
            if g0.ndim == 3:
                g0 = bgr_to_gray_cv(g0)
            if g1.ndim == 3:
                g1 = bgr_to_gray_cv(g1)
            dy, dx = _hdr.align_mtb_shift(g0, g1, int(max_bits),
                                          int(exclude_range))
            return (int(dx), int(dy))

        def shiftMat(self, src, shift, dst=None):
            a = np.asarray(src)
            dx, dy = int(shift[0]), int(shift[1])
            if a.ndim == 3:
                out = np.stack([_hdr._shift2d(a[..., c], dy, dx)
                                for c in range(a.shape[-1])], axis=-1)
            else:
                out = _hdr._shift2d(a, dy, dx)
            if dst is not None:
                np.copyto(dst, out.reshape(np.asarray(dst).shape))
                return dst
            return out

        def computeBitmaps(self, img, tb=None, eb=None):
            t, e = _hdr._mtb(np.asarray(img), int(exclude_range))
            t8 = np.asarray(t, np.uint8) * 255
            e8 = np.asarray(e, np.uint8) * 255
            if tb is not None:
                np.copyto(tb, t8.reshape(np.asarray(tb).shape))
                t8 = tb
            if eb is not None:
                np.copyto(eb, e8.reshape(np.asarray(eb).shape))
                e8 = eb
            return t8, e8

        def getMaxBits(self):
            return int(max_bits)

        def getExcludeRange(self):
            return int(exclude_range)
    return _MTB(None)


def denoise_TVL1(observations, result=None, lambda_=1.0, niters=30):
    out = _ip.denoise_tvl1([np.asarray(o) for o in observations],
                           float(lambda_), int(niters))
    out = np.asarray(out)
    if result is not None:
        np.copyto(result, out.reshape(np.asarray(result).shape))
        return result
    return out


# ------------------------------------------------------------ objdetect

class QRCodeDetector:
    def detectAndDecode(self, img, points=None, straight_qrcode=None):
        text, corners = _ip.qr_detect_and_decode(_m(img))
        if text is None:
            return "", None, None
        pts = np.asarray(corners, np.float32).reshape(1, 4, 2)
        return text, pts, None

    def detect(self, img, points=None):
        text, corners = _ip.qr_detect_and_decode(_m(img))
        if corners is None:
            return False, None
        return True, np.asarray(corners, np.float32).reshape(1, 4, 2)

    def decode(self, img, points, straight_qrcode=None):
        text, corners = _ip.qr_detect_and_decode(_m(img))
        return (text or "", points, None)


class HOGDescriptor:
    """cv2.HOGDescriptor role over ops/hog.py (64x128 window, 9 bins)."""

    def __init__(self, *a, **k):
        self._svm = None

    def setSVMDetector(self, svmdetector):
        self._svm = np.asarray(svmdetector, np.float64).ravel()

    @staticmethod
    def getDefaultPeopleDetector():
        # we ship no pretrained people SVM (no copied model data);
        # train one with ops/hog.py or supply your own weights
        raise NotImplementedError(
            "no pretrained people detector ships with rustcv_tpu; "
            "train a linear SVM over ops/hog descriptors instead")

    def compute(self, img, winStride=None, padding=None, locations=None):
        d = _ip.hog_descriptor(_m(img))
        return np.asarray(d, np.float32).reshape(-1, 1)

    def detectMultiScale(self, img, hitThreshold=0, winStride=None,
                         padding=None, scale=1.05, groupThreshold=2.0,
                         useMeanshiftGrouping=False):
        if self._svm is None:
            raise ValueError("call setSVMDetector first")
        boxes, scores = _ip.hog_detect_multi_scale(
            _m(img), self._svm, threshold=float(hitThreshold),
            scale=float(scale))
        boxes = np.asarray(boxes, np.int32).reshape(-1, 4)
        return boxes, np.asarray(scores, np.float64).reshape(-1, 1)


class CascadeClassifier:
    """Haar cascade over ops/cascade.py JSON models (cv2 XML cascades
    are not parsed — train or convert via ops/cascade.train_cascade)."""

    def __init__(self, filename=None):
        from ..ops.cascade import Cascade
        self._c = None
        if filename:
            self._c = Cascade.from_json(open(filename).read())

    def load(self, filename):
        from ..ops.cascade import Cascade
        self._c = Cascade.from_json(open(filename).read())
        return True

    def empty(self):
        return self._c is None

    def detectMultiScale(self, image, scaleFactor=1.1, minNeighbors=3,
                         flags=0, minSize=None, maxSize=None):
        from ..ops import cascade as _casc
        if self._c is None:
            # cv2 raises error on an empty cascade; a clean rejection,
            # not an AttributeError on internals
            raise ValueError("CascadeClassifier is empty: load() a "
                             "model first")
        # ops kwargs are scale_step / min_size (greedy NMS replaces
        # cv2's minNeighbors vote) — r5 call-coverage fix
        boxes, _ = _casc.detect_multi_scale(
            np.asarray(_o(np.asarray(image))), self._c,
            scale_step=float(scaleFactor),
            min_size=0 if minSize is None else int(
                np.min(np.asarray(minSize))))
        return np.asarray(boxes, np.int32).reshape(-1, 4)


# ------------------------------------------------------------ io / gui

def imread(filename, flags=1):
    m = _icodec.imread(str(filename))
    if m is None or (hasattr(m, "is_empty") and m.is_empty()):
        return None
    out = _o(m)
    if flags == 0 and out.ndim == 3:  # IMREAD_GRAYSCALE
        out = _o(_ip.cvt_gray(_m(out)))
    return out


def imwrite(filename, img, params=None):
    return bool(_icodec.imwrite(str(filename), _m(np.asarray(img))))


def imencode(ext, img, params=None):
    quality = 95
    if params:
        params = list(params)
        for i in range(0, len(params) - 1, 2):
            if params[i] == _C.IMWRITE_JPEG_QUALITY:
                quality = int(params[i + 1])
    data = _icodec.imencode(str(ext), _m(np.asarray(img)), quality=quality)
    return True, np.frombuffer(data, np.uint8).copy()


def imdecode(buf, flags=1):
    m = _icodec.imdecode(bytes(np.asarray(buf, np.uint8).tobytes()))
    if m is None:
        return None
    out = _o(m)
    if flags == 0 and out.ndim == 3:
        out = _o(_ip.cvt_gray(_m(out)))
    return out


def imshow(winname, mat):
    _hg.imshow(str(winname), _m(np.asarray(mat)))


def waitKey(delay=0):
    return int(_hg.wait_key(int(delay)))


def waitKeyEx(delay=0):
    return waitKey(delay)


def pollKey():
    return int(_hg.wait_key(1))


def destroyWindow(winname):
    _hg.destroy_window(str(winname))


def destroyAllWindows():
    _hg.destroy_all_windows()


def namedWindow(winname, flags=0):
    pass  # windows materialize on first imshow


def moveWindow(winname, x, y):
    pass


def resizeWindow(winname, width, height):
    pass


def setWindowTitle(winname, title):
    pass


def getWindowProperty(winname, prop_id):
    return 1.0 if winname in getattr(_hg, "window_names", lambda: [])() \
        else -1.0


class VideoCapture:
    """cv2.VideoCapture conventions over the async capture stack
    (capture/videocapture.py): ret, frame = cap.read()."""

    def __init__(self, index=0, apiPreference=0):
        from ..videoio import VideoCapture as _VC
        self._cap = _VC(index)
        self._mat = Mat.empty()

    def isOpened(self):
        # cv2's constructor blocks on open; ours opens on a worker —
        # settle the open attempt before answering
        return bool(self._cap.wait_until_resolved())

    def read(self, image=None):
        ok = self._cap.read(self._mat)
        if not ok:
            return False, None
        return True, _o(self._mat)

    def release(self):
        self._cap.release()

    def get(self, propId):
        if propId == _C.CAP_PROP_FRAME_WIDTH:
            return float(self._cap.get_width())
        if propId == _C.CAP_PROP_FRAME_HEIGHT:
            return float(self._cap.get_height())
        return 0.0

    def set(self, propId, value):
        if propId == _C.CAP_PROP_FRAME_WIDTH:
            self._cap.set_resolution(int(value), self._cap.get_height())
            return True
        if propId == _C.CAP_PROP_FRAME_HEIGHT:
            self._cap.set_resolution(self._cap.get_width(), int(value))
            return True
        return False

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.release()
