"""Haar cascade object detection (OpenCV ``CascadeClassifier`` role,
Viola & Jones 2001) — detection, training, and (de)serialization.

The reference has no object detection; OpenCV-parity addition. OpenCV
ships pre-trained XML cascades as data; this module ships the ALGORITHM
plus an AdaBoost trainer (:func:`train_cascade`) and a JSON model
format, so users train/load their own cascades (no OpenCV data files
are copied).

Device formulation — gather-free window evaluation: a Haar feature is a
±-weighted sum of rectangle sums; on the integral image a rectangle sum
for EVERY window position simultaneously is four SHIFTED SLICES of the
integral (one subtraction chain per rect, vectorized over the whole
window grid). A stump compares that plane against a threshold scaled by
the per-window variance-normalization factor; a stage sums stump votes
elementwise. All stages evaluate as one fused elementwise program (no
early exit on device — the window grid is data-parallel; rejection
cascades help serial CPUs, masks help vector machines).

Frozen spec (float64 oracle == the same formulation in NumPy):
- features: two-rect (horizontal/vertical halves) and three-rect
  (center-surround band) Haar types on a ``win`` × ``win`` canonical
  window, value = white-sum − black-sum on UNNORMALIZED pixel sums;
- windows are variance-normalized: feature values divide by
  ``σ·win²`` (σ = per-window pixel std via integral of squares,
  floor 1);
- stump: vote = ``alpha`` if ``polarity·(f − thresh) < 0`` else
  ``−alpha``; stage passes when Σ votes ≥ stage threshold; a window
  detects when ALL stages pass;
- multi-scale: image pyramid by ``1/scale_step`` bilinear resizes
  (golden.resize_bilinear), detections mapped back and merged by
  greedy IoU NMS (0.3);
- training: per-stage AdaBoost over a feature pool (exhaustive stride-
  quantized positions), stage threshold set so ≥ ``min_tpr`` of
  positives pass; negatives that pass feed the next stage.
"""

from __future__ import annotations

import json
from typing import List, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

class Cascade:
    """stages: list of (threshold, stumps); stump = (ftype, x, y, w, h,
    thresh, polarity, alpha)."""

    def __init__(self, win: int, stages):
        self.win = int(win)
        self.stages = stages

    def to_json(self) -> str:
        return json.dumps({"win": self.win, "stages": [
            {"threshold": t, "stumps": [list(s) for s in ss]}
            for t, ss in self.stages]})

    @classmethod
    def from_json(cls, text: str) -> "Cascade":
        d = json.loads(text)
        return cls(d["win"], [(st["threshold"],
                               [tuple(s) for s in st["stumps"]])
                              for st in d["stages"]])


def _integral(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    a = img.astype(np.float64)
    ii = np.zeros((a.shape[0] + 1, a.shape[1] + 1))
    ii2 = np.zeros_like(ii)
    ii[1:, 1:] = a.cumsum(0).cumsum(1)
    ii2[1:, 1:] = (a * a).cumsum(0).cumsum(1)
    return ii, ii2


def _rect_sum_plane(ii: np.ndarray, x: int, y: int, w: int, h: int,
                    gy: int, gx: int) -> np.ndarray:
    """Sum of rect (x..x+w, y..y+h) for every window origin on the
    [gy, gx] grid — four shifted slices of the integral image."""
    return (ii[y + h:y + h + gy, x + w:x + w + gx]
            - ii[y + h:y + h + gy, x:x + gx]
            - ii[y:y + gy, x + w:x + w + gx]
            + ii[y:y + gy, x:x + gx])


def _feature_plane(ii: np.ndarray, ftype: int, x: int, y: int, w: int,
                   h: int, gy: int, gx: int) -> np.ndarray:
    if ftype == 0:    # two-rect horizontal: left white, right black
        wl = _rect_sum_plane(ii, x, y, w // 2, h, gy, gx)
        bl = _rect_sum_plane(ii, x + w // 2, y, w - w // 2, h, gy, gx)
        return wl - bl
    if ftype == 1:    # two-rect vertical: top white, bottom black
        wt = _rect_sum_plane(ii, x, y, w, h // 2, gy, gx)
        bb = _rect_sum_plane(ii, x, y + h // 2, w, h - h // 2, gy, gx)
        return wt - bb
    if ftype == 2:    # three-rect horizontal band: sides white, centre black
        t = w // 3
        a = _rect_sum_plane(ii, x, y, t, h, gy, gx)
        b = _rect_sum_plane(ii, x + t, y, t, h, gy, gx)
        c = _rect_sum_plane(ii, x + 2 * t, y, w - 2 * t, h, gy, gx)
        return a - b + c
    raise ValueError(f"unknown feature type {ftype}")


def score_windows(img: np.ndarray, cascade: Cascade):
    """Evaluate every window origin (stride 1) → (pass bool [gy, gx],
    margin float [gy, gx] = min over stages of (votes − threshold))."""
    win = cascade.win
    h, w = img.shape
    gy, gx = h - win + 1, w - win + 1
    if gy <= 0 or gx <= 0:
        return (np.zeros((0, 0), bool), np.zeros((0, 0)))
    ii, ii2 = _integral(img)
    area = win * win
    s1 = _rect_sum_plane(ii, 0, 0, win, win, gy, gx)
    s2 = _rect_sum_plane(ii2, 0, 0, win, win, gy, gx)
    var = np.maximum(s2 / area - (s1 / area) ** 2, 1.0)
    norm = np.sqrt(var) * area

    ok = np.ones((gy, gx), bool)
    margin = np.full((gy, gx), np.inf)
    for sthr, stumps in cascade.stages:
        votes = np.zeros((gy, gx))
        for (ftype, x, y, fw, fh, thr, pol, alpha) in stumps:
            f = _feature_plane(ii, ftype, x, y, fw, fh, gy, gx) / norm
            vote = np.where(pol * (f - thr) < 0, alpha, -alpha)
            votes += vote
        ok &= votes >= sthr
        margin = np.minimum(margin, votes - sthr)
    return ok, margin


def score_windows_device(img, cascade: Cascade):
    """jax twin of :func:`score_windows` (f32) — the same shifted-slice
    planes, fused elementwise; returns numpy (pass, margin)."""
    import jax.numpy as jnp

    win = cascade.win
    a = jnp.asarray(img).astype(jnp.float32)
    h, w = a.shape
    gy, gx = h - win + 1, w - win + 1
    if gy <= 0 or gx <= 0:
        return (np.zeros((0, 0), bool), np.zeros((0, 0)))
    ii = jnp.zeros((h + 1, w + 1), jnp.float32).at[1:, 1:].set(
        a.cumsum(0).cumsum(1))
    ii2 = jnp.zeros((h + 1, w + 1), jnp.float32).at[1:, 1:].set(
        (a * a).cumsum(0).cumsum(1))

    def rect(iimg, x, y, rw, rh):
        return (iimg[y + rh:y + rh + gy, x + rw:x + rw + gx]
                - iimg[y + rh:y + rh + gy, x:x + gx]
                - iimg[y:y + gy, x + rw:x + rw + gx]
                + iimg[y:y + gy, x:x + gx])

    def feat(ftype, x, y, fw, fh):
        if ftype == 0:
            return rect(ii, x, y, fw // 2, fh) \
                - rect(ii, x + fw // 2, y, fw - fw // 2, fh)
        if ftype == 1:
            return rect(ii, x, y, fw, fh // 2) \
                - rect(ii, x, y + fh // 2, fw, fh - fh // 2)
        t = fw // 3
        return rect(ii, x, y, t, fh) - rect(ii, x + t, y, t, fh) \
            + rect(ii, x + 2 * t, y, fw - 2 * t, fh)

    area = win * win
    s1 = rect(ii, 0, 0, win, win)
    s2 = rect(ii2, 0, 0, win, win)
    var = jnp.maximum(s2 / area - (s1 / area) ** 2, 1.0)
    norm = jnp.sqrt(var) * area
    ok = jnp.ones((gy, gx), bool)
    margin = jnp.full((gy, gx), jnp.inf)
    for sthr, stumps in cascade.stages:
        votes = jnp.zeros((gy, gx), jnp.float32)
        for (ftype, x, y, fw, fh, thr, pol, alpha) in stumps:
            f = feat(ftype, x, y, fw, fh) / norm
            votes = votes + jnp.where(pol * (f - thr) < 0,
                                      jnp.float32(alpha),
                                      jnp.float32(-alpha))
        ok &= votes >= sthr
        margin = jnp.minimum(margin, votes - sthr)
    return np.asarray(ok), np.asarray(margin)


def detect_multi_scale(img: np.ndarray, cascade: Cascade,
                       scale_step: float = 1.2, min_size: int = 0,
                       nms_iou: float = 0.3, use_device: bool = False):
    """OpenCV ``detectMultiScale`` role → (boxes int [N, 4] xywh,
    scores). Pyramid of bilinear downsizes, greedy NMS."""
    from .golden import resize_bilinear

    img = np.asarray(img)
    win = cascade.win
    boxes, scores = [], []
    s = 1.0
    cur = img
    while min(cur.shape) >= win:
        sc = score_windows_device(cur, cascade) if use_device \
            else score_windows(cur, cascade)
        ok, margin = sc
        for yy, xx in np.argwhere(ok):
            size = int(round(win * s))
            if size < min_size:
                continue
            boxes.append((int(round(xx * s)), int(round(yy * s)),
                          size, size))
            scores.append(float(margin[yy, xx]))
        s *= scale_step
        nh, nw = int(img.shape[0] / s), int(img.shape[1] / s)
        if min(nh, nw) < win:
            break
        cur = resize_bilinear(img[..., None], nw, nh)[..., 0]
    if not boxes:
        return np.zeros((0, 4), int), np.zeros(0)
    bx = np.asarray(boxes)
    sc = np.asarray(scores)
    order = np.argsort(-sc, kind="stable")
    keep = []
    for i in order:
        good = True
        for j in keep:
            xa, ya = max(bx[i, 0], bx[j, 0]), max(bx[i, 1], bx[j, 1])
            xb = min(bx[i, 0] + bx[i, 2], bx[j, 0] + bx[j, 2])
            yb = min(bx[i, 1] + bx[i, 3], bx[j, 1] + bx[j, 3])
            inter = max(xb - xa, 0) * max(yb - ya, 0)
            union = bx[i, 2] * bx[i, 3] + bx[j, 2] * bx[j, 3] - inter
            if union > 0 and inter / union > nms_iou:
                good = False
                break
        if good:
            keep.append(i)
    return bx[keep], sc[keep]


# ---------------------------------------------------------------------------
# training (AdaBoost of decision stumps over a quantized feature pool)
# ---------------------------------------------------------------------------

def _feature_pool(win: int, stride: int = 4, min_side: int = 8):
    pool = []
    for ftype in (0, 1, 2):
        for fw in range(min_side, win + 1, stride):
            for fh in range(min_side, win + 1, stride):
                for x in range(0, win - fw + 1, stride):
                    for y in range(0, win - fh + 1, stride):
                        pool.append((ftype, x, y, fw, fh))
    return pool


def _eval_features(patches: np.ndarray, pool) -> np.ndarray:
    """[P, win, win] u8 → [P, F] normalized feature values."""
    n = len(patches)
    win = patches.shape[1]
    vals = np.empty((n, len(pool)))
    for i, p in enumerate(patches):
        ii, ii2 = _integral(p)
        area = win * win
        s1 = _rect_sum_plane(ii, 0, 0, win, win, 1, 1)[0, 0]
        s2 = _rect_sum_plane(ii2, 0, 0, win, win, 1, 1)[0, 0]
        var = max(s2 / area - (s1 / area) ** 2, 1.0)
        norm = np.sqrt(var) * area
        for k, (ftype, x, y, fw, fh) in enumerate(pool):
            vals[i, k] = _feature_plane(ii, ftype, x, y, fw, fh,
                                        1, 1)[0, 0] / norm
    return vals


def train_cascade(pos: np.ndarray, neg: np.ndarray, n_stages: int = 3,
                  n_stumps: int = 8, min_tpr: float = 0.99,
                  stride: int = 4) -> Cascade:
    """AdaBoost cascade on u8 patches [P, win, win]. Deterministic."""
    win = pos.shape[1]
    pool = _feature_pool(win, stride)
    fp = _eval_features(np.asarray(pos, np.float64), pool)
    fn = _eval_features(np.asarray(neg, np.float64), pool)
    stages = []
    for _ in range(n_stages):
        if len(fn) == 0:
            break
        x = np.concatenate([fp, fn])
        y = np.concatenate([np.ones(len(fp)), -np.ones(len(fn))])
        wgt = np.concatenate([np.full(len(fp), 0.5 / len(fp)),
                              np.full(len(fn), 0.5 / len(fn))])
        stumps = []
        votes = np.zeros(len(x))
        for _ in range(n_stumps):
            best = (np.inf, 0, 0.0, 1)
            total_pos = wgt[y > 0].sum()
            for k in range(x.shape[1]):
                col = x[:, k]
                order = np.argsort(col, kind="stable")
                # error for threshold after position i, polarity +1
                # (predict + when f < thr): err = P(w, y=-1, f<thr)
                #                                + P(w, y=+1, f>=thr)
                cw = np.cumsum(wgt[order] * (y[order] < 0))
                cp = np.cumsum(wgt[order] * (y[order] > 0))
                err_plus = cw[:-1] + (total_pos - cp[:-1])
                err_minus = 1.0 - err_plus
                ip = int(np.argmin(err_plus))
                im = int(np.argmin(err_minus))
                if err_plus[ip] < best[0]:
                    thr = 0.5 * (col[order[ip]] + col[order[ip + 1]])
                    best = (err_plus[ip], k, thr, 1)
                if err_minus[im] < best[0]:
                    thr = 0.5 * (col[order[im]] + col[order[im + 1]])
                    best = (err_minus[im], k, thr, -1)
            err, k, thr, pol = best
            err = min(max(err, 1e-9), 1 - 1e-9)
            alpha = 0.5 * np.log((1 - err) / err)
            pred = np.where(pol * (x[:, k] - thr) < 0, 1.0, -1.0)
            wgt = wgt * np.exp(-alpha * pred * y)
            wgt = wgt / wgt.sum()
            ftype, fx, fy, fw, fh = pool[k]
            stumps.append((ftype, fx, fy, fw, fh, float(thr), int(pol),
                           float(alpha)))
            votes = votes + alpha * pred
        # stage threshold: pass >= min_tpr of positives
        pos_votes = votes[:len(fp)]
        sthr = float(np.quantile(pos_votes, 1.0 - min_tpr))
        stages.append((sthr, stumps))
        keep = votes[len(fp):] >= sthr   # negatives that survive
        fn = fn[keep]
    return Cascade(win, stages)
