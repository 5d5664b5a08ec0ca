"""cv2 facade — algorithm classes over the ops layer.

Optical-flow engines, detectors, stitching, Delaunay, 3d containers,
QR encoding, FLANN — each a cv2-calling-convention wrapper over the
accelerator-native implementation in ``rustcv_tpu.ops``.  Cross-validated
against OpenCV 5.0 in ``tests/test_cv2_algos.py``.
"""
from __future__ import annotations

import numpy as np

from . import _constants as _C
from ._classes import KeyPoint, _Process, createMergeDebevec, \
    createMergeMertens, createMergeRobertson, createCalibrateDebevec, \
    createCalibrateRobertson, createTonemap, createTonemapDrago, \
    createTonemapMantiuk, createTonemapReinhard, createAlignMTB, \
    BFMatcher, QRCodeDetector
from .. import imgproc as _ip

__all__ = [
    "DenseOpticalFlow", "SparseOpticalFlow",
    "DISOpticalFlow", "DISOpticalFlow_create",
    "DISOpticalFlow_PRESET_ULTRAFAST", "DISOpticalFlow_PRESET_FAST",
    "DISOpticalFlow_PRESET_MEDIUM",
    "FarnebackOpticalFlow", "FarnebackOpticalFlow_create",
    "SparsePyrLKOpticalFlow", "SparsePyrLKOpticalFlow_create",
    "VariationalRefinement", "VariationalRefinement_create",
    "LineSegmentDetector", "createLineSegmentDetector",
    "GeneralizedHoughBallard", "GeneralizedHoughGuil",
    "createGeneralizedHoughBallard", "createGeneralizedHoughGuil",
    "MSER", "MSER_create",
    "SimpleBlobDetector", "SimpleBlobDetector_Params",
    "SimpleBlobDetector_create",
    "AffineFeature", "AffineFeature_create", "BFMatcher_create",
    "DescriptorMatcher", "DescriptorMatcher_create", "FlannBasedMatcher",
    "MergeDebevec", "MergeMertens", "MergeRobertson", "MergeExposures",
    "CalibrateDebevec", "CalibrateRobertson", "CalibrateCRF",
    "Tonemap", "TonemapDrago", "TonemapMantiuk", "TonemapReinhard",
    "AlignMTB", "AlignExposures",
    "Stitcher", "Stitcher_create",
    "Subdiv2D", "Octree", "Octree_createWithDepth",
    "Octree_createWithResolution", "Odometry", "Volume",
    "QRCodeEncoder", "QRCodeEncoder_create", "QRCodeDetectorAruco",
    "flann_Index", "PyRotationWarper", "segmentation_IntelligentScissorsMB",
    "findContoursLinkRuns",
]

DISOpticalFlow_PRESET_ULTRAFAST = 0
DISOpticalFlow_PRESET_FAST = 1
DISOpticalFlow_PRESET_MEDIUM = 2


def _gray(a):
    a = np.asarray(a)
    if a.ndim == 3:
        from . import cvtColor
        a = cvtColor(a, _C.COLOR_BGR2GRAY)
    return a


class DenseOpticalFlow:
    def calc(self, I0, I1, flow):
        raise NotImplementedError


class SparseOpticalFlow:
    def calc(self, prevImg, nextImg, prevPts, nextPts, status=None,
             err=None):
        raise NotImplementedError


class DISOpticalFlow(DenseOpticalFlow):
    """cv2.DISOpticalFlow over ops/disflow.py (inverse-search DIS)."""

    _PRESET = {0: (2, 12), 1: (2, 16), 2: (1, 25)}  # finest_scale, iters

    def __init__(self, preset=DISOpticalFlow_PRESET_FAST):
        self._finest, self._iters = self._PRESET[int(preset)]

    def calc(self, I0, I1, flow=None):
        from ..ops.disflow import dis_flow_numpy

        out = dis_flow_numpy(_gray(I0), _gray(I1),
                             finest_scale=self._finest, iters=self._iters)
        return np.asarray(out, np.float32)

    def getFinestScale(self):
        return self._finest

    def setFinestScale(self, v):
        self._finest = int(v)

    @staticmethod
    def create(preset=DISOpticalFlow_PRESET_FAST):
        return DISOpticalFlow(preset)


def DISOpticalFlow_create(preset=DISOpticalFlow_PRESET_FAST):
    return DISOpticalFlow(preset)


class FarnebackOpticalFlow(DenseOpticalFlow):
    def __init__(self, numLevels=5, pyrScale=0.5, fastPyramids=False,
                 winSize=13, numIters=10, polyN=5, polySigma=1.1,
                 flags=0):
        self._levels = int(numLevels)
        self._win = int(winSize)
        self._iters = int(numIters)
        self._poly_n = int(polyN)
        self._poly_sigma = float(polySigma)

    def calc(self, I0, I1, flow=None):
        from ._classes import _m

        out = _ip.calc_optical_flow_farneback(
            _m(_gray(I0)), _m(_gray(I1)), levels=self._levels,
            winsize=self._win, iterations=self._iters,
            poly_n=self._poly_n, poly_sigma=self._poly_sigma)
        return np.asarray(out, np.float32)

    @staticmethod
    def create(*a, **k):
        return FarnebackOpticalFlow(*a, **k)


def FarnebackOpticalFlow_create(*a, **k):
    return FarnebackOpticalFlow(*a, **k)


class SparsePyrLKOpticalFlow(SparseOpticalFlow):
    def __init__(self, winSize=(21, 21), maxLevel=3, crit=None, flags=0,
                 minEigThreshold=1e-4):
        self._win = winSize
        self._levels = int(maxLevel)

    def calc(self, prevImg, nextImg, prevPts, nextPts=None, status=None,
             err=None):
        from ._classes import calcOpticalFlowPyrLK

        return calcOpticalFlowPyrLK(prevImg, nextImg, prevPts, nextPts,
                                    winSize=self._win,
                                    maxLevel=self._levels)

    @staticmethod
    def create(*a, **k):
        return SparsePyrLKOpticalFlow(*a, **k)


def SparsePyrLKOpticalFlow_create(*a, **k):
    return SparsePyrLKOpticalFlow(*a, **k)


class VariationalRefinement(DenseOpticalFlow):
    """cv2.VariationalRefinement role: refine a given flow field — one
    finest-scale inverse-search pass seeded with the input flow
    (ops/disflow.py's level solver)."""

    def __init__(self, fixedPointIterations=5, sorIterations=5,
                 omega=1.6, alpha=20.0, delta=5.0, gamma=10.0):
        self._iters = int(fixedPointIterations) * int(sorIterations)

    def calc(self, I0, I1, flow):
        from ..ops.disflow import _level_np

        i0 = _gray(I0).astype(np.float64)
        i1 = _gray(I1).astype(np.float64)
        f = np.asarray(flow, np.float64)
        out = _level_np(i0, i1, f, max(self._iters, 1))
        return np.asarray(out, np.float32)

    def calcUV(self, I0, I1, flow_u, flow_v):
        f = np.stack([np.asarray(flow_u), np.asarray(flow_v)], axis=-1)
        out = self.calc(I0, I1, f)
        return out[..., 0], out[..., 1]

    @staticmethod
    def create(*a, **k):
        return VariationalRefinement(*a, **k)


def VariationalRefinement_create(*a, **k):
    return VariationalRefinement(*a, **k)


# ------------------------------------------------------------- detectors

class LineSegmentDetector:
    def __init__(self, refine=1, scale=0.8, sigma_scale=0.6, quant=2.0,
                 ang_th=22.5, log_eps=0, density_th=0.7, n_bins=1024):
        self._ang = float(ang_th)

    def detect(self, image, lines=None, width=None, prec=None, nfa=None):
        segs = _ip.detect_line_segments(_gray(image))
        segs = np.asarray(segs, np.float32)
        if segs.size == 0:
            return None, None, None, None
        n = segs.shape[0]
        widths = np.ones((n, 1), np.float32)
        precs = np.full((n, 1), np.deg2rad(self._ang), np.float32)
        return segs.reshape(-1, 1, 4), widths, precs, None

    def drawSegments(self, image, lines):
        from . import line as _line

        for seg in np.asarray(lines).reshape(-1, 4):
            _line(image, (int(round(seg[0])), int(round(seg[1]))),
                  (int(round(seg[2])), int(round(seg[3]))), (0, 0, 255), 1)
        return image


def createLineSegmentDetector(*a, **k):
    return LineSegmentDetector(*a, **k)


class GeneralizedHoughBallard:
    def __init__(self):
        self._table = None
        self._votes_thresh = 30
        self._levels = 64

    def setTemplate(self, templ, center=None):
        from ..ops.ghough import build_r_table

        self._templ_shape = np.asarray(templ).shape
        self._table = build_r_table(_gray(templ), self._levels)

    def setVotesThreshold(self, v):
        self._votes_thresh = int(v)

    def getVotesThreshold(self):
        return self._votes_thresh

    def setLevels(self, v):
        self._levels = int(v)

    def detect(self, image, positions=None, votes=None):
        from ..ops.ghough import ghough_detect

        pos, v = ghough_detect(_gray(image), self._table,
                               self._votes_thresh, self._levels)
        if len(pos) == 0:
            return None, None
        out = np.concatenate(
            [pos, np.ones((len(pos), 1), np.float32),
             np.zeros((len(pos), 1), np.float32)], axis=1)
        return out.reshape(-1, 1, 4), v.reshape(-1, 1, 1).astype(np.int32)


class GeneralizedHoughGuil(GeneralizedHoughBallard):
    def detect(self, image, positions=None, votes=None):
        from ..ops.ghough import ghough_detect_guil

        pos, angles, scales, v = ghough_detect_guil(
            _gray(image), self._table, self._votes_thresh,
            levels=self._levels)
        if len(pos) == 0:
            return None, None
        out = np.stack([pos[:, 0], pos[:, 1],
                        np.asarray(scales, np.float32),
                        np.degrees(np.asarray(angles, np.float32))],
                       axis=1).astype(np.float32)
        return out.reshape(-1, 1, 4), v.reshape(-1, 1, 1).astype(np.int32)


def createGeneralizedHoughBallard():
    return GeneralizedHoughBallard()


def createGeneralizedHoughGuil():
    return GeneralizedHoughGuil()


class MSER:
    def __init__(self, delta=5, min_area=60, max_area=14400,
                 max_variation=0.25, min_diversity=0.2, **k):
        self._kw = dict(delta=int(delta), min_area=int(min_area),
                        max_area=int(max_area),
                        max_variation=float(max_variation),
                        min_diversity=float(min_diversity))

    def detectRegions(self, image):
        regions, bboxes = _ip.detect_mser_regions(_gray(image),
                                                  **self._kw)
        return ([np.asarray(r, np.int32) for r in regions],
                np.asarray(bboxes, np.int32).reshape(-1, 4))

    def detect(self, image, mask=None):
        regions, bboxes = self.detectRegions(image)
        kps = []
        for b in bboxes:
            kps.append(KeyPoint(b[0] + b[2] / 2.0, b[1] + b[3] / 2.0,
                                float(max(b[2], b[3]))))
        return kps

    @staticmethod
    def create(*a, **k):
        return MSER(*a, **k)


def MSER_create(*a, **k):
    return MSER(*a, **k)


class SimpleBlobDetector_Params:
    def __init__(self):
        self.thresholdStep = 10
        self.minThreshold = 50
        self.maxThreshold = 220
        self.minRepeatability = 2
        self.minDistBetweenBlobs = 10
        self.filterByColor = True
        self.blobColor = 0
        self.filterByArea = True
        self.minArea = 25
        self.maxArea = 5000
        self.filterByCircularity = False
        self.minCircularity = 0.8
        self.maxCircularity = 3.4e38
        self.filterByInertia = True
        self.minInertiaRatio = 0.1
        self.maxInertiaRatio = 3.4e38
        self.filterByConvexity = True
        self.minConvexity = 0.95
        self.maxConvexity = 3.4e38


class SimpleBlobDetector:
    """cv2.SimpleBlobDetector over ops/blob.py.

    cv2's circularity/convexity thresholds assume its continuous
    contour measures; ours are traced-polygon values which run lower
    on small blobs (see ops/blob.py BlobParams).  The cv2-unit
    thresholds are rescaled by the ratio of the two defaults
    (0.7/0.8 for circularity, 0.9/0.95 for convexity) so cv2's
    defaults select the same blobs."""

    _CIRC_SCALE = 0.7 / 0.8
    _CONV_SCALE = 0.9 / 0.95

    def __init__(self, parameters=None):
        self._p = parameters or SimpleBlobDetector_Params()

    def detect(self, image, mask=None):
        from ..ops.blob import BlobParams, detect_blobs

        p = self._p
        bp = BlobParams(
            min_threshold=int(p.minThreshold),
            max_threshold=int(p.maxThreshold),
            threshold_step=int(p.thresholdStep),
            min_repeatability=int(p.minRepeatability),
            min_dist_between_blobs=float(p.minDistBetweenBlobs),
            blob_color=int(p.blobColor),
            min_area=float(p.minArea) if p.filterByArea else 1.0,
            max_area=float(p.maxArea) if p.filterByArea else 1e18,
            min_circularity=(float(p.minCircularity) * self._CIRC_SCALE
                             if p.filterByCircularity else 0.0),
            min_convexity=(float(p.minConvexity) * self._CONV_SCALE
                           if p.filterByConvexity else 0.0),
            min_inertia=(float(p.minInertiaRatio)
                         if p.filterByInertia else 0.0))
        blobs = detect_blobs(_gray(image), bp)
        return [KeyPoint(float(b[0]), float(b[1]), float(b[2]))
                for b in np.asarray(blobs).reshape(-1, 3)]

    @staticmethod
    def create(parameters=None):
        return SimpleBlobDetector(parameters)


def SimpleBlobDetector_create(parameters=None):
    return SimpleBlobDetector(parameters)


class AffineFeature:
    """cv2.AffineFeature (ASIFT) over ops/asift.py."""

    def __init__(self, backend=None, maxTilt=5, minTilt=0,
                 tiltStep=1.4142, rotateStepBase=72):
        pass

    def detectAndCompute(self, image, mask=None, descriptors=None,
                         useProvidedKeypoints=False):
        from ..ops.asift import affine_detect_and_compute

        kp6, desc = affine_detect_and_compute(_gray(image))
        kps = [KeyPoint(float(k[0]), float(k[1]), float(k[2]),
                        float(k[3]), float(k[4]), int(k[5]))
               for k in np.asarray(kp6).reshape(-1, 6)]
        return kps, np.asarray(desc)

    @staticmethod
    def create(*a, **k):
        return AffineFeature(*a, **k)


def AffineFeature_create(*a, **k):
    return AffineFeature(*a, **k)


def BFMatcher_create(normType=4, crossCheck=False):
    return BFMatcher(normType, crossCheck)


class DescriptorMatcher:
    BRUTEFORCE = 2
    BRUTEFORCE_L1 = 3
    BRUTEFORCE_HAMMING = 4
    BRUTEFORCE_HAMMINGLUT = 5
    BRUTEFORCE_SL2 = 6
    FLANNBASED = 1

    _NAMES = {"BruteForce": _C.NORM_L2, "BruteForce-L1": _C.NORM_L1,
              "BruteForce-Hamming": _C.NORM_HAMMING,
              "BruteForce-HammingLUT": _C.NORM_HAMMING,
              "BruteForce-SL2": _C.NORM_L2SQR,
              "FlannBased": _C.NORM_L2}

    @staticmethod
    def create(matcherType):
        if isinstance(matcherType, str):
            norm = DescriptorMatcher._NAMES.get(matcherType)
            if norm is None:
                raise ValueError(f"unknown matcher {matcherType!r}")
            return BFMatcher(norm)
        ids = {2: _C.NORM_L2, 3: _C.NORM_L1, 4: _C.NORM_HAMMING,
               5: _C.NORM_HAMMING, 6: _C.NORM_L2SQR, 1: _C.NORM_L2}
        return BFMatcher(ids[int(matcherType)])


def DescriptorMatcher_create(matcherType):
    return DescriptorMatcher.create(matcherType)


class FlannBasedMatcher(BFMatcher):
    """Exact-search stand-in (cv2's FLANN is approximate; ours brute
    via the same BFMatcher engine — a superset in accuracy)."""

    def __init__(self, indexParams=None, searchParams=None):
        super().__init__(_C.NORM_L2)


# ----------------------------------------------------------------- HDR

def _factory_alias(name, factory):
    def __new__(cls, *a, **k):
        return factory(*a, **k)

    return type(name, (object,), {
        "__new__": __new__,
        "__doc__": f"cv2.{name}: constructing one returns the "
                   f"{factory.__name__}() engine (same .process API)."})


MergeDebevec = _factory_alias("MergeDebevec", createMergeDebevec)
MergeMertens = _factory_alias("MergeMertens", createMergeMertens)
MergeRobertson = _factory_alias("MergeRobertson", createMergeRobertson)
CalibrateDebevec = _factory_alias("CalibrateDebevec",
                                  createCalibrateDebevec)
CalibrateRobertson = _factory_alias("CalibrateRobertson",
                                    createCalibrateRobertson)
Tonemap = _factory_alias("Tonemap", createTonemap)
TonemapDrago = _factory_alias("TonemapDrago", createTonemapDrago)
TonemapMantiuk = _factory_alias("TonemapMantiuk", createTonemapMantiuk)
TonemapReinhard = _factory_alias("TonemapReinhard", createTonemapReinhard)
AlignMTB = _factory_alias("AlignMTB", createAlignMTB)
MergeExposures = _Process
CalibrateCRF = _Process
AlignExposures = _Process


# ------------------------------------------------------------- stitching

class Stitcher:
    PANORAMA = 0
    SCANS = 1
    OK = 0
    ERR_NEED_MORE_IMGS = 1
    ERR_HOMOGRAPHY_EST_FAIL = 2
    ERR_CAMERA_PARAMS_ADJUST_FAIL = 3

    def __init__(self, mode=PANORAMA):
        self._mode = mode
        self._conf = 1.0

    def stitch(self, images, pano=None, masks=None):
        from ..ops.stitch import StitchError

        imgs = [np.asarray(i) for i in images]
        if len(imgs) < 2:
            return Stitcher.ERR_NEED_MORE_IMGS, None
        try:
            out = _ip.stitch_images(imgs)
        except StitchError:
            return Stitcher.ERR_HOMOGRAPHY_EST_FAIL, None
        if hasattr(out, "to_numpy"):
            out = out.to_numpy()
        return Stitcher.OK, np.asarray(out)

    def setPanoConfidenceThresh(self, v):
        self._conf = float(v)

    def panoConfidenceThresh(self):
        return self._conf

    @staticmethod
    def create(mode=PANORAMA):
        return Stitcher(mode)


def Stitcher_create(mode=Stitcher.PANORAMA):
    return Stitcher(mode)


# ----------------------------------------------------------- geometry 2d

class Subdiv2D:
    """cv2.Subdiv2D (Delaunay/Voronoi) over ops/subdiv.py."""

    PTLOC_ERROR = -2
    PTLOC_OUTSIDE_RECT = -1
    PTLOC_INSIDE = 0
    PTLOC_VERTEX = 1
    PTLOC_ON_EDGE = 2
    NEXT_AROUND_ORG = 0x00
    NEXT_AROUND_DST = 0x22
    PREV_AROUND_ORG = 0x11
    PREV_AROUND_DST = 0x33
    NEXT_AROUND_LEFT = 0x13
    NEXT_AROUND_RIGHT = 0x31
    PREV_AROUND_LEFT = 0x20
    PREV_AROUND_RIGHT = 0x02

    def __init__(self, rect=None):
        self._rect = rect
        self._s = None
        if rect is not None:
            self.initDelaunay(rect)

    def initDelaunay(self, rect):
        from ..ops.subdiv import Subdiv2D as _S

        self._rect = rect
        self._s = _S(tuple(float(v) for v in rect))

    def insert(self, pt):
        if hasattr(pt, "__len__") and len(pt) and \
                hasattr(pt[0], "__len__"):
            self._s.insert_multiple([tuple(map(float, p)) for p in pt])
            return 0
        return self._s.insert((float(pt[0]), float(pt[1])))

    def getTriangleList(self):
        return np.asarray(self._s.get_triangle_list(), np.float32)

    def getEdgeList(self):
        tris = np.asarray(self._s.get_triangle_list(), np.float64)
        edges = set()
        for t in tris.reshape(-1, 3, 2):
            for i in range(3):
                a, b = tuple(t[i]), tuple(t[(i + 1) % 3])
                edges.add(tuple(sorted((a, b))))
        return np.asarray([e[0] + e[1] for e in sorted(edges)],
                          np.float32)

    def findNearest(self, pt):
        i, p = self._s.find_nearest((float(pt[0]), float(pt[1])))
        return i, (float(p[0]), float(p[1]))

    def getVoronoiFacetList(self, idx):
        facets, centers = self._s.get_voronoi_facet_list(
            list(idx) if idx is not None and len(idx) else None)
        return ([np.asarray(f, np.float32) for f in facets],
                np.asarray(centers, np.float32))


# ------------------------------------------------------------- 3d module

class Octree:
    """cv2.Octree over ops/octree.py."""

    def __init__(self, *a, **k):
        self._o = None

    @staticmethod
    def createWithDepth(maxDepth, size=1.0, origin=(0, 0, 0),
                        withColors=False):
        from ..ops.octree import Octree as _O

        t = Octree()
        t._o = _O(origin=tuple(map(float, origin)), size=float(size))
        return t

    @staticmethod
    def createWithResolution(resolution, size=1.0, origin=(0, 0, 0),
                             withColors=False):
        from ..ops.octree import Octree as _O

        t = Octree()
        t._o = _O(origin=tuple(map(float, origin)), size=float(size))
        return t

    @classmethod
    def fromPointCloud(cls, pointCloud, maxDepth=8):
        from ..ops.octree import Octree as _O

        t = cls()
        t._o = _O(points=np.asarray(pointCloud, np.float64).reshape(-1, 3))
        return t

    def insertPoint(self, point):
        return self._o.insert_point(tuple(map(float, point)))

    def deletePoint(self, point):
        return self._o.delete_point(tuple(map(float, point)))

    def isPointInBounds(self, point):
        return self._o.is_point_in_bounds(tuple(map(float, point)))

    def empty(self):
        return getattr(self._o, "n_points", 0) == 0


def Octree_createWithDepth(*a, **k):
    return Octree.createWithDepth(*a, **k)


def Octree_createWithResolution(*a, **k):
    return Octree.createWithResolution(*a, **k)


class Odometry:
    """cv2.Odometry (depth/RGB-D) over ops/odometry.py."""

    def __init__(self, odometryType=None, settings=None, algo=None):
        self._k = None
        if settings is not None and hasattr(settings, "getCameraMatrix"):
            self._k = settings.getCameraMatrix()

    def setCameraMatrix(self, K):
        self._k = np.asarray(K, np.float64)

    def compute(self, srcDepthFrame, dstDepthFrame, Rt=None):
        from ..ops.odometry import rgbd_odometry

        from ..ops.calib import rodrigues

        if self._k is None:
            raise ValueError("call setCameraMatrix first")
        ok, rvec, tvec = rgbd_odometry(
            np.asarray(srcDepthFrame, np.float64),
            np.asarray(dstDepthFrame, np.float64), self._k)
        rt = np.eye(4)
        rt[:3, :3] = rodrigues(np.asarray(rvec, np.float64))
        rt[:3, 3] = np.asarray(tvec, np.float64).ravel()
        return bool(ok), rt


class Volume:
    """cv2.Volume (TSDF) over ops/tsdf.py."""

    def __init__(self, volumeType=0, settings=None, resolution=128,
                 voxelSize=0.02, K=None):
        from ..ops.tsdf import TsdfVolume

        self._v = TsdfVolume(resolution=int(resolution),
                             voxel_size=float(voxelSize))
        self._k = None if K is None else np.asarray(K, np.float64)

    def setCameraIntrinsics(self, K):
        self._k = np.asarray(K, np.float64)

    def integrate(self, depth, pose):
        if self._k is None:
            raise ValueError("call setCameraIntrinsics first")
        rt = np.asarray(pose, np.float64)
        self._v.integrate(np.asarray(depth, np.float64), self._k,
                          rt[:3, :3], rt[:3, 3])

    def raycast(self, *a, **k):
        raise NotImplementedError(
            "Volume.raycast: extract geometry via ops/tsdf marching "
            "cubes instead")

    @property
    def tsdf(self):
        return self._v


# ------------------------------------------------------------------- QR

class QRCodeEncoder:
    CORRECT_LEVEL_L = 0
    CORRECT_LEVEL_M = 1
    CORRECT_LEVEL_Q = 2
    CORRECT_LEVEL_H = 3
    MODE_AUTO = -1
    MODE_NUMERIC = 1
    MODE_ALPHANUMERIC = 2
    MODE_STRUCTURED_APPEND = 3
    MODE_BYTE = 4
    MODE_ECI = 7
    MODE_KANJI = 8
    ECI_SHIFT_JIS = 20
    ECI_UTF8 = 26

    class Params:
        def __init__(self):
            self.version = 0
            self.correction_level = 0
            self.mode = -1
            self.structure_number = 1

    def __init__(self, parameters=None):
        self._p = parameters or QRCodeEncoder.Params()

    def encode(self, encoded_info, qrcode=None):
        from ..ops.qr import encode as _enc

        level = "LMQH"[int(self._p.correction_level)]
        version = int(self._p.version)
        versions = [version] if version else [1, 2, 3, 4, 5]
        last = None
        for v in versions:
            try:
                m = _enc(str(encoded_info), version=v, level=level)
                return (np.asarray(m, np.uint8) * 255)
            except ValueError as e:
                last = e
        raise ValueError(f"payload too large: {last}")

    def encodeStructuredAppend(self, encoded_info, qrcodes=None):
        raise NotImplementedError("structured append not supported")

    @staticmethod
    def create(parameters=None):
        return QRCodeEncoder(parameters)


def QRCodeEncoder_create(parameters=None):
    return QRCodeEncoder(parameters)


class QRCodeDetectorAruco(QRCodeDetector):
    """cv2.QRCodeDetectorAruco: same detection engine as our
    QRCodeDetector (the aruco-accelerated variant differs only in the
    finder-pattern search strategy)."""


# ----------------------------------------------------------------- FLANN

class flann_Index:
    """cv2.flann_Index over ops/knn_index.py (exact kd-tree search —
    a superset of FLANN's approximate answers)."""

    def __init__(self, features=None, params=None, distType=None):
        self._idx = None
        if features is not None:
            self.build(features, params or {})

    def build(self, features, params, distType=None):
        from ..ops.knn_index import KnnIndex

        self._idx = KnnIndex(np.asarray(features, np.float32))

    def knnSearch(self, query, knn, indices=None, dists=None, params=None):
        idx, d2 = self._idx.knn_search(np.asarray(query, np.float32),
                                       int(knn))
        return np.asarray(idx, np.int32), np.asarray(d2, np.float32)

    def radiusSearch(self, query, radius, maxResults, indices=None,
                     dists=None, params=None):
        from ..ops.knn_index import radius_search

        q = np.asarray(query, np.float32).reshape(-1)
        idx, d2 = radius_search(self._idx, q, float(radius),
                                int(maxResults))
        n = len(idx)
        oi = np.zeros((1, maxResults), np.int32)
        od = np.zeros((1, maxResults), np.float32)
        oi[0, :n] = idx
        od[0, :n] = d2
        return n, oi, od


# ----------------------------------------------------------- warping etc.

class PyRotationWarper:
    """cv2.PyRotationWarper over ops/rotwarp.py (plane / cylindrical /
    spherical reprojection)."""

    def __init__(self, type="spherical", scale=1.0):
        from ..ops.rotwarp import RotationWarper

        self._w = RotationWarper(str(type), float(scale))

    def warp(self, src, K, R, interp_mode=1, border_mode=0, dst=None):
        corner, out = self._w.warp(np.asarray(src), K, R)
        return tuple(int(c) for c in corner), np.asarray(out)


class segmentation_IntelligentScissorsMB:
    """cv2.segmentation.IntelligentScissorsMB over ops/scissors.py."""

    def __init__(self):
        from ..ops.scissors import IntelligentScissors

        self._s = IntelligentScissors()

    def setEdgeFeatureCannyParameters(self, low, high, *a, **k):
        from ..ops.scissors import IntelligentScissors

        self._s = IntelligentScissors(canny_low=int(low),
                                      canny_high=int(high))
        return self

    def setGradientMagnitudeMaxLimit(self, v):
        return self

    def applyImage(self, image):
        self._s.apply_image(_gray(image))
        return self

    def buildMap(self, sourcePt):
        self._s.build_map((int(sourcePt[0]), int(sourcePt[1])))

    def getContour(self, targetPt, backward=False):
        c = self._s.get_contour((int(targetPt[0]), int(targetPt[1])))
        return np.asarray(c, np.int32).reshape(-1, 1, 2)


def findContoursLinkRuns(image):
    """cv2.findContoursLinkRuns role: same contours as findContours
    RETR_LIST/CHAIN_APPROX_NONE (the link-runs algorithm is an
    implementation detail, not an output contract)."""
    from . import findContours

    return findContours(image, _C.RETR_LIST, _C.CHAIN_APPROX_NONE)
