"""cv2.dnn — the array utilities implemented exactly (blobFromImage,
NMSBoxes family); network loading raises a guard (we bundle no model
weights and no inference graph executor lives in this package — the
device inference story is jax itself).

Cross-validated against cv2.dnn in tests/test_cv2_dnn.py.
"""
from __future__ import annotations

import numpy as np

DNN_BACKEND_DEFAULT = 0
DNN_BACKEND_OPENCV = 3
DNN_TARGET_CPU = 0

__all__ = [
    "blobFromImage", "blobFromImages", "imagesFromBlob",
    "NMSBoxes", "NMSBoxesBatched", "softNMSBoxes", "NMSBoxesRotated",
    "readNet", "readNetFromONNX", "readNetFromCaffe",
    "readNetFromTensorflow", "readNetFromTorch", "readNetFromDarknet",
    "Net", "blobFromImageWithParams", "Image2BlobParams",
]


def _resize_crop(img, size, crop):
    from . import resize

    w, h = int(size[0]), int(size[1])
    a = np.asarray(img)
    if not crop:
        return np.asarray(resize(a, (w, h)))
    # cv2 crop semantics: resize preserving aspect so both dims >=
    # target, then center-crop
    ih, iw = a.shape[:2]
    f = max(w / iw, h / ih)
    rw, rh = int(round(iw * f)), int(round(ih * f))
    r = np.asarray(resize(a, (rw, rh)))
    x0 = (rw - w) // 2
    y0 = (rh - h) // 2
    return r[y0:y0 + h, x0:x0 + w]


def blobFromImage(image, scalefactor=1.0, size=None, mean=(0, 0, 0),
                  swapRB=False, crop=False, ddepth=5):
    return blobFromImages([image], scalefactor, size, mean, swapRB, crop,
                          ddepth)


def blobFromImages(images, scalefactor=1.0, size=None, mean=(0, 0, 0),
                   swapRB=False, crop=False, ddepth=5):
    out = []
    mean = np.asarray(mean, np.float64).ravel()
    for img in images:
        a = np.asarray(img)
        if size is not None and tuple(size) != (0, 0):
            a = _resize_crop(a, size, crop)
        a = a.astype(np.float64)
        if a.ndim == 2:
            a = a[..., None]
        m = mean[:a.shape[2]] if mean.size >= a.shape[2] else \
            np.resize(mean, a.shape[2])
        if swapRB and a.shape[2] >= 3:
            a = a[..., [2, 1, 0] + list(range(3, a.shape[2]))]
        a = (a - m) * float(scalefactor)
        out.append(np.transpose(a, (2, 0, 1)))
    blob = np.stack(out).astype(np.float32 if ddepth == 5 else np.float64)
    return blob


def imagesFromBlob(blob_, images_=None):
    b = np.asarray(blob_)
    return [np.transpose(b[i], (1, 2, 0)).copy()
            for i in range(b.shape[0])]


def _iou_xywh(a, b):
    ax0, ay0, aw, ah = a
    bx0, by0, bw, bh = b
    x0 = max(ax0, bx0)
    y0 = max(ay0, by0)
    x1 = min(ax0 + aw, bx0 + bw)
    y1 = min(ay0 + ah, by0 + bh)
    inter = max(0.0, x1 - x0) * max(0.0, y1 - y0)
    union = aw * ah + bw * bh - inter
    return inter / union if union > 0 else 0.0


def NMSBoxes(bboxes, scores, score_threshold, nms_threshold, eta=1.0,
             top_k=0):
    boxes = [tuple(float(v) for v in b) for b in bboxes]
    s = np.asarray(scores, np.float64)
    order = np.argsort(-s, kind="stable")
    order = [int(i) for i in order if s[i] > score_threshold]
    keep = []
    for i in order:
        if top_k and len(keep) >= top_k:
            break
        if all(_iou_xywh(boxes[i], boxes[j]) <= nms_threshold
               for j in keep):
            keep.append(i)
    return np.asarray(keep, np.int32)


def NMSBoxesBatched(bboxes, scores, class_ids, score_threshold,
                    nms_threshold, eta=1.0, top_k=0):
    """Per-class NMS: boxes of different classes never suppress each
    other (cv2 implements this by offsetting boxes per class)."""
    cls = np.asarray(class_ids).ravel()
    boxes = [tuple(float(v) for v in b) for b in bboxes]
    s = np.asarray(scores, np.float64)
    order = np.argsort(-s, kind="stable")
    order = [int(i) for i in order if s[i] > score_threshold]
    keep = []
    for i in order:
        if top_k and len(keep) >= top_k:
            break
        if all(cls[i] != cls[j]
               or _iou_xywh(boxes[i], boxes[j]) <= nms_threshold
               for j in keep):
            keep.append(i)
    return np.asarray(keep, np.int32)


def softNMSBoxes(bboxes, scores, score_threshold, nms_threshold,
                 top_k=0, sigma=0.5, method=1):
    """Soft-NMS (gaussian by default) → (updated_scores, kept_indices),
    cv2 ordering (score-descending)."""
    boxes = [tuple(float(v) for v in b) for b in bboxes]
    s = np.asarray(scores, np.float64).copy()
    alive = list(range(len(boxes)))
    keep, out_scores = [], []
    while alive:
        i = max(alive, key=lambda k: s[k])
        if s[i] <= score_threshold:
            break
        keep.append(i)
        out_scores.append(s[i])
        alive.remove(i)
        if top_k and len(keep) >= top_k:
            break
        for j in alive:
            iou = _iou_xywh(boxes[i], boxes[j])
            if method == 1:  # linear
                if iou > nms_threshold:
                    s[j] *= 1.0 - iou
            else:  # gaussian
                s[j] *= np.exp(-(iou * iou) / sigma)
    return (np.asarray(out_scores, np.float32),
            np.asarray(keep, np.int32))


def NMSBoxesRotated(bboxes, scores, score_threshold, nms_threshold,
                    eta=1.0, top_k=0):
    from . import rotatedRectangleIntersection, contourArea

    rects = list(bboxes)
    s = np.asarray(scores, np.float64)
    order = np.argsort(-s, kind="stable")
    order = [int(i) for i in order if s[i] > score_threshold]

    def iou(a, b):
        ret, pts = rotatedRectangleIntersection(a, b)
        if pts is None or len(pts) < 3:
            return 0.0
        inter = contourArea(np.asarray(pts, np.float32))
        ua = a[1][0] * a[1][1] + b[1][0] * b[1][1] - inter
        return inter / ua if ua > 0 else 0.0

    keep = []
    for i in order:
        if top_k and len(keep) >= top_k:
            break
        if all(iou(rects[i], rects[j]) <= nms_threshold for j in keep):
            keep.append(i)
    return np.asarray(keep, np.int32)


class Image2BlobParams:
    def __init__(self):
        self.scalefactor = (1.0, 1.0, 1.0, 1.0)
        self.size = (0, 0)
        self.mean = (0.0, 0.0, 0.0, 0.0)
        self.swapRB = False
        self.ddepth = 5
        self.datalayout = 0
        self.paddingmode = 0


def blobFromImageWithParams(image, param=None, blob=None):
    p = param or Image2BlobParams()
    sf = p.scalefactor[0] if hasattr(p.scalefactor, "__len__") \
        else p.scalefactor
    return blobFromImage(image, sf, p.size if p.size != (0, 0) else None,
                         p.mean, p.swapRB, False, p.ddepth)


class Net:
    """Guard: loading serialized DNN graphs is out of scope — rustcv_tpu
    ships no weights and jax IS the device inference engine.  Export your
    model to jax/flax and run it under jit instead."""

    def __init__(self, *a, **k):
        raise NotImplementedError(self.__doc__)


def _read_guard(*a, **k):
    raise NotImplementedError(Net.__doc__)


readNet = _read_guard
readNetFromONNX = _read_guard
readNetFromCaffe = _read_guard
readNetFromTensorflow = _read_guard
readNetFromTorch = _read_guard
readNetFromDarknet = _read_guard
