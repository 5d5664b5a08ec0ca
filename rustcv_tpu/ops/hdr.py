"""HDR imaging (OpenCV ``MergeMertens`` / ``CalibrateDebevec`` /
``MergeDebevec`` / ``Tonemap`` roles).

The reference has no HDR stack; OpenCV-parity addition to the photo
family (nlmeans/inpaint/poisson).

Device formulation: Mertens exposure fusion is pyramidal elementwise math —
per-exposure quality weights (contrast = |laplacian|, saturation =
channel std, well-exposedness = Gaussian around mid-gray), softmax-style
normalization across the stack, then a Laplacian-pyramid blend. Every
stage is elementwise / separable-blur work; the device twin jits the
whole fusion as one program (pyramids unrolled over static levels).
Debevec calibration is a tiny host lstsq (256+N unknowns — sparse
sampled pixels, once per camera); the radiance merge and tonemaps are
elementwise device math.

Frozen spec (float64 oracles):
- Mertens weights: ``C = |4c − Σ_4 c_q|`` on the gray mean (replicate
  border), ``S = std across channels``, ``E = Π_c exp(−(v_c − 0.5)² /
  (2·0.2²))``, all on [0,1] floats; ``w = C·S·E + 1e-12``, normalized
  across exposures;
- pyramid: 5-tap [1,4,6,4,1]/16 separable blur, downsample ``[::2]``;
  Laplacian = level − upsample(next); upsample = zero-stuff ×2 then the
  same blur ×4 gain; levels = ``min(⌊log2(min(H, W))⌋ − 2, 6)``;
- collapse: Σ_levels upsample-accumulate, clipped to [0, 1];
- Debevec: ``g`` solved from sampled pixels with smoothness λ = 10 and
  the triangle weight ``w(z) = min(z, 255 − z) + 1``; radiance =
  ``exp(Σ w·(g(z) − ln Δt) / Σ w)``;
- Reinhard global tonemap: ``L_out = L·(1 + L/L_white²)/(1 + L)`` on
  the log-average-scaled luminance, gamma 1/2.2 display encode.
"""

from __future__ import annotations

from functools import partial
from typing import List, Sequence

import numpy as np

import jax
import jax.numpy as jnp

_SIGMA_E = 0.2


def _levels_for(h: int, w: int) -> int:
    return max(1, min(int(np.floor(np.log2(min(h, w)))) - 2, 6))


# ---------------------------------------------------------------------------
# float64 oracle
# ---------------------------------------------------------------------------

def _blur5(a: np.ndarray) -> np.ndarray:
    t = np.array([1, 4, 6, 4, 1], np.float64) / 16.0
    p = np.pad(a, ((0, 0), (2, 2)) + ((0, 0),) * (a.ndim - 2), mode="edge")
    out = sum(t[k] * p[:, k:k + a.shape[1]] for k in range(5))
    p = np.pad(out, ((2, 2), (0, 0)) + ((0, 0),) * (a.ndim - 2), mode="edge")
    return sum(t[k] * p[k:k + a.shape[0], :] for k in range(5))


def _down(a: np.ndarray) -> np.ndarray:
    return _blur5(a)[::2, ::2]


def _up(a: np.ndarray, shape) -> np.ndarray:
    h, w = shape
    z = np.zeros((a.shape[0] * 2, a.shape[1] * 2) + a.shape[2:], a.dtype)
    z[::2, ::2] = a
    return (_blur5(z) * 4.0)[:h, :w]


def _weights_np(imgs: List[np.ndarray]) -> np.ndarray:
    ws = []
    for im in imgs:
        v = im  # [H, W, C] in [0, 1]
        gray = v.mean(axis=-1)
        p = np.pad(gray, 1, mode="edge")
        lap = np.abs(4 * gray - (p[:-2, 1:-1] + p[2:, 1:-1]
                                 + p[1:-1, :-2] + p[1:-1, 2:]))
        sat = v.std(axis=-1)
        wellexp = np.exp(-((v - 0.5) ** 2)
                         / (2 * _SIGMA_E * _SIGMA_E)).prod(axis=-1)
        ws.append(lap * sat * wellexp + 1e-12)
    w = np.stack(ws)
    return w / w.sum(axis=0, keepdims=True)


def merge_mertens_numpy(images: Sequence[np.ndarray]) -> np.ndarray:
    """u8 exposure stack [(H, W, 3)...] → fused float32 (H, W, 3) in
    [0, 1] (OpenCV MergeMertens convention)."""
    imgs = [np.asarray(im, np.float64) / 255.0 for im in images]
    h, w = imgs[0].shape[:2]
    n_lvl = _levels_for(h, w)
    wts = _weights_np(imgs)

    acc = None
    for k, im in enumerate(imgs):
        # Gaussian pyramid of the weight, Laplacian pyramid of the image
        gw = [wts[k]]
        gi = [im]
        for _ in range(n_lvl - 1):
            gw.append(_down(gw[-1]))
            gi.append(_down(gi[-1]))
        contrib = []
        for lv in range(n_lvl):
            if lv < n_lvl - 1:
                lap = gi[lv] - _up(_down(gi[lv]), gi[lv].shape[:2])
            else:
                lap = gi[lv]
            contrib.append(lap * gw[lv][..., None])
        if acc is None:
            acc = contrib
        else:
            acc = [a + c for a, c in zip(acc, contrib)]

    out = acc[-1]
    for lv in range(n_lvl - 2, -1, -1):
        out = _up(out, acc[lv].shape[:2]) + acc[lv]
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def calibrate_debevec(images: Sequence[np.ndarray],
                      times: Sequence[float], n_samples: int = 70,
                      lam: float = 10.0, seed: int = 7,
                      random: bool = False) -> np.ndarray:
    """Recover the log response g[256] per channel → (3, 256) float64
    (g[127] pinned to 0).  ``random=False`` samples a centred uniform
    grid (cv2 CalibrateDebevec's deterministic mode); ``random=True``
    draws uniform points from ``seed``."""
    imgs = [np.asarray(im) for im in images]
    h, w = imgs[0].shape[:2]
    if random:
        rng = np.random.default_rng(seed)
        ys = rng.integers(0, h, n_samples)
        xs = rng.integers(0, w, n_samples)
    else:
        x_points = max(1, int(np.sqrt(float(n_samples) * w / h)))
        y_points = max(1, n_samples // x_points)
        step_x, step_y = w // x_points, h // y_points
        xs_g = np.arange(x_points) * step_x + step_x // 2
        ys_g = np.arange(y_points) * step_y + step_y // 2
        gx, gy = np.meshgrid(xs_g, ys_g)
        xs = gx.ravel()[:n_samples]
        ys = gy.ravel()[:n_samples]
    n_samples = len(xs)
    lnt = np.log(np.asarray(times, np.float64))
    out = np.zeros((3, 256))
    wgt = np.minimum(np.arange(256), 255 - np.arange(256)) + 1.0
    for c in range(3):
        a = []
        b = []
        for j, im in enumerate(imgs):
            z = im[ys, xs, c]
            for i in range(n_samples):
                row = np.zeros(256 + n_samples)
                ww = wgt[z[i]]
                row[z[i]] = ww
                row[256 + i] = -ww
                a.append(row)
                b.append(ww * lnt[j])
        # smoothness
        for z in range(1, 255):
            row = np.zeros(256 + n_samples)
            row[z - 1], row[z], row[z + 1] = lam * wgt[z], -2 * lam * wgt[z], lam * wgt[z]
            a.append(row)
            b.append(0.0)
        # pin g[127] = 0
        row = np.zeros(256 + n_samples)
        row[127] = 1.0
        a.append(row)
        b.append(0.0)
        sol, *_ = np.linalg.lstsq(np.asarray(a), np.asarray(b), rcond=None)
        out[c] = sol[:256]
    return out


def merge_debevec_numpy(images: Sequence[np.ndarray],
                        times: Sequence[float],
                        response: np.ndarray = None) -> np.ndarray:
    """→ radiance float32 (H, W, 3) (linear, arbitrary scale).

    ``response=None`` matches OpenCV MergeDebevec's default: a linear
    response g(z) = ln(z) with g(0) := g(1) (merge_debevec.cpp uses
    linearResponse + log, pinning index 0 to avoid log(0))."""
    if response is None:
        lin = np.arange(256, dtype=np.float64)
        lin[0] = 1.0
        response = np.broadcast_to(np.log(lin), (3, 256))
    lnt = np.log(np.asarray(times, np.float64))
    wgt = np.minimum(np.arange(256), 255 - np.arange(256)) + 1.0
    num = None
    den = None
    for j, im in enumerate(images):
        z = np.asarray(im)
        wz = wgt[z]
        g = np.stack([response[c][z[..., c]] for c in range(3)], axis=-1)
        contrib = wz * (g - lnt[j])
        num = contrib if num is None else num + contrib
        den = wz if den is None else den + wz
    return np.exp(num / np.maximum(den, 1e-9)).astype(np.float32)


def tonemap_reinhard_cv(hdr: np.ndarray, gamma: float = 1.0,
                        intensity: float = 0.0, light_adapt: float = 1.0,
                        color_adapt: float = 0.0) -> np.ndarray:
    """OpenCV ``TonemapReinhard`` (Reinhard–Devlin photoreceptor model,
    cv2 photo/src/tonemap.cpp structure, verified differentially):
    min-max normalize, gray via cv2's RGB2GRAY-coefficients-on-BGR
    quirk, adaptation map key from the log-luminance statistics, then
    per-channel V/(V+adapt^key) compression and 1/gamma power."""
    img = np.asarray(hdr, np.float32)
    lo, hi = float(img.min()), float(img.max())
    if hi - lo > 2.2e-16:
        img = ((img - lo) / (hi - lo)).astype(np.float32)
    # cv2 calls cvtColor(..., COLOR_RGB2GRAY) on BGR data: channel 0
    # gets the R weight.
    gray = (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2]).astype(np.float32)
    log_img = np.log(np.maximum(gray, 1e-4))
    log_mean = float(log_img.mean())
    log_min = float(log_img.min())
    log_max = float(log_img.max())
    key = (log_max - log_mean) / max(log_max - log_min, 2.2e-16)
    map_key = 0.3 + 0.7 * key ** 1.4
    my_intensity = np.exp(-float(intensity))
    gray_mean = float(gray.mean())
    chan_mean = img.reshape(-1, 3).mean(axis=0)
    out = np.empty_like(img)
    for c in range(3):
        glob = color_adapt * chan_mean[c] + (1.0 - color_adapt) * gray_mean
        adapt = (color_adapt * img[..., c]
                 + (1.0 - color_adapt) * gray).astype(np.float32)
        adapt = light_adapt * adapt + (1.0 - light_adapt) * glob
        adapt = np.power(np.float32(my_intensity) * adapt,
                         np.float32(map_key))
        out[..., c] = img[..., c] * (1.0 / (adapt + img[..., c]))
    out = np.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)
    lo, hi = float(out.min()), float(out.max())
    if hi - lo > 2.2e-16:
        out = (out - lo) / (hi - lo)
    return np.power(out, 1.0 / float(gamma)).astype(np.float32)


def tonemap_reinhard_numpy(hdr: np.ndarray, gamma: float = 2.2,
                           l_white: float = 4.0) -> np.ndarray:
    """Radiance → u8 display (global Reinhard on luminance)."""
    h = np.asarray(hdr, np.float64)
    # Rec.709 luminance, BGR channel order
    lum = 0.2126 * h[..., 2] + 0.7152 * h[..., 1] + 0.0722 * h[..., 0]
    log_avg = np.exp(np.log(lum + 1e-9).mean())
    l = 0.18 * lum / log_avg
    ld = l * (1.0 + l / (l_white * l_white)) / (1.0 + l)
    scale = ld / np.maximum(lum, 1e-9)
    out = np.clip(h * scale[..., None], 0.0, 1.0) ** (1.0 / gamma)
    return np.clip(np.floor(out * 255.0 + 0.5), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# device twin (Mertens fusion, one jitted program)
# ---------------------------------------------------------------------------

def _blur5_j(a: jax.Array) -> jax.Array:
    t = np.array([1, 4, 6, 4, 1], np.float32) / 16.0
    pad = ((0, 0), (2, 2)) + ((0, 0),) * (a.ndim - 2)
    p = jnp.pad(a, pad, mode="edge")
    out = sum(jnp.float32(t[k]) * p[:, k:k + a.shape[1]] for k in range(5))
    pad = ((2, 2), (0, 0)) + ((0, 0),) * (a.ndim - 2)
    p = jnp.pad(out, pad, mode="edge")
    return sum(jnp.float32(t[k]) * p[k:k + a.shape[0], :] for k in range(5))


def _up_j(a: jax.Array, shape) -> jax.Array:
    h, w = shape
    z = jnp.zeros((a.shape[0] * 2, a.shape[1] * 2) + a.shape[2:], a.dtype)
    z = z.at[::2, ::2].set(a)
    return (_blur5_j(z) * 4.0)[:h, :w]


@jax.jit
def merge_mertens(stack: jax.Array) -> jax.Array:
    """Device twin — u8 [N, H, W, 3] stack → float32 (H, W, 3) in
    [0, 1]; ~1e-3 of the f64 oracle."""
    imgs = stack.astype(jnp.float32) / 255.0
    n, h, w = imgs.shape[:3]
    n_lvl = _levels_for(h, w)

    gray = imgs.mean(axis=-1)
    p = jnp.pad(gray, ((0, 0), (1, 1), (1, 1)), mode="edge")
    lap = jnp.abs(4 * gray - (p[:, :-2, 1:-1] + p[:, 2:, 1:-1]
                              + p[:, 1:-1, :-2] + p[:, 1:-1, 2:]))
    sat = imgs.std(axis=-1)
    wellexp = jnp.exp(-((imgs - 0.5) ** 2)
                      / (2 * _SIGMA_E * _SIGMA_E)).prod(axis=-1)
    wts = lap * sat * wellexp + 1e-12
    wts = wts / wts.sum(axis=0, keepdims=True)

    acc = None
    for k in range(n):
        gw = [wts[k]]
        gi = [imgs[k]]
        for _ in range(n_lvl - 1):
            gw.append(_blur5_j(gw[-1])[::2, ::2])
            gi.append(_blur5_j(gi[-1])[::2, ::2])
        contrib = []
        for lv in range(n_lvl):
            if lv < n_lvl - 1:
                down = _blur5_j(gi[lv])[::2, ::2]
                lap_l = gi[lv] - _up_j(down, gi[lv].shape[:2])
            else:
                lap_l = gi[lv]
            contrib.append(lap_l * gw[lv][..., None])
        acc = contrib if acc is None else [a + c
                                           for a, c in zip(acc, contrib)]

    out = acc[-1]
    for lv in range(n_lvl - 2, -1, -1):
        out = _up_j(out, acc[lv].shape[:2]) + acc[lv]
    return jnp.clip(out, 0.0, 1.0)


# ---------------------------------------------------------------------------
# AlignMTB (median-threshold-bitmap exposure alignment)
# ---------------------------------------------------------------------------

def _median_u8(img: np.ndarray) -> int:
    """cv2 AlignMTB getMedian: histogram walk `while(sum < total/2)
    sum += hist[median++]` — i.e. (first value with cumsum >=
    total//2) + 1.  Verified on 100 random images."""
    img = np.asarray(img, np.uint8)
    hist = np.bincount(img.ravel(), minlength=256)
    cum = np.cumsum(hist)
    return int(np.argmax(cum >= img.size // 2)) + 1


def _mtb(gray: np.ndarray, exclude_range: int = 4):
    """Median-threshold bitmap + exclusion mask (cv2 AlignMTB
    computeBitmaps, bit-exact): tb = img > median, eb = |img - median|
    > exclude_range, with the histogram median above."""
    g = np.asarray(gray)
    if g.dtype != np.uint8:
        g = np.clip(g, 0, 255).astype(np.uint8)
    med = _median_u8(g)
    return g > med, np.abs(g.astype(np.int32) - med) > exclude_range


def _shift2d(a: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """cv2 AlignMTB shiftMat semantics: +dx right, +dy down,
    zero-filled (measured via cv2's exposed shiftMat)."""
    out = np.zeros_like(a)
    ys = slice(max(dy, 0), a.shape[0] + min(dy, 0))
    xs = slice(max(dx, 0), a.shape[1] + min(dx, 0))
    out[ys, xs] = a[slice(max(-dy, 0), a.shape[0] + min(-dy, 0)),
                    slice(max(-dx, 0), a.shape[1] + min(-dx, 0))]
    return out


def align_mtb_shift(ref_gray: np.ndarray, img_gray: np.ndarray,
                    max_bits: int = 6, exclude_range: int = 4):
    """Translation (dy, dx) such that shifting ``img`` by it aligns it
    onto ``ref`` (OpenCV ``AlignMTB.calculateShift``, bit-exact:
    36/36 pure shifts + 25/25 exposure-scaled randomized pairs).
    Pyramid = [::2, ::2] decimation (Ward's downsample, NOT resize),
    maxlevel = min(int(ln(max(h,w))/ln 2) - 1, max_bits - 1); per
    level the 9 one-px offsets of 2x the coarser shift are scanned
    x-outer/y-inner, error = countNonZero((tb1^tb2s) & eb1 & eb2s),
    strict < (first minimum wins)."""
    ref = np.asarray(ref_gray)
    img = np.asarray(img_gray)
    maxlevel = int(np.log(float(max(ref.shape))) / np.log(2.0)) - 1
    maxlevel = min(maxlevel, max_bits - 1)
    refs, imgs = [ref], [img]
    for _ in range(maxlevel):
        r0 = refs[-1]
        i0 = imgs[-1]
        # ascontiguousarray: np.bincount segfaults (numpy 2.x) on
        # repeatedly-strided u8 views from stacked [::2, ::2] slices
        refs.append(np.ascontiguousarray(
            r0[:(r0.shape[0] // 2) * 2:2, :(r0.shape[1] // 2) * 2:2]))
        imgs.append(np.ascontiguousarray(
            i0[:(i0.shape[0] // 2) * 2:2, :(i0.shape[1] // 2) * 2:2]))
    dy = dx = 0
    for lv in range(len(refs) - 1, -1, -1):
        dy *= 2
        dx *= 2
        rb, rm = _mtb(refs[lv], exclude_range)
        ib, im = _mtb(imgs[lv], exclude_range)
        min_err = refs[lv].size
        ny, nx = dy, dx
        for ox in (-1, 0, 1):          # x outer (cv2 scan order)
            for oy in (-1, 0, 1):
                ty, tx = dy + oy, dx + ox
                sb = _shift2d(ib, ty, tx)
                sm = _shift2d(im, ty, tx)
                err = int(((rb ^ sb) & rm & sm).sum())
                if err < min_err:
                    min_err, ny, nx = err, ty, tx
        dy, dx = ny, nx
    return dy, dx


def align_mtb(images, max_bits: int = 6, exclude_range: int = 4):
    """Align a u8 BGR exposure stack (OpenCV ``AlignMTB.process``):
    the PIVOT is the middle image (len//2), others are gray-converted
    (BT.601 u8), registered to it and shifted (zero borders); the
    pivot passes through unchanged."""
    from .color import bgr_to_gray_cv

    imgs = [np.asarray(im) for im in images]
    pivot = len(imgs) // 2
    ref = (bgr_to_gray_cv(imgs[pivot]) if imgs[pivot].ndim == 3
           else imgs[pivot])
    out = []
    for k, im in enumerate(imgs):
        if k == pivot:
            out.append(im.copy())
            continue
        g = bgr_to_gray_cv(im) if im.ndim == 3 else im
        dy, dx = align_mtb_shift(ref, g, max_bits, exclude_range)
        if im.ndim == 3:
            shifted = np.stack([_shift2d(im[..., c], dy, dx)
                                for c in range(im.shape[-1])], axis=-1)
        else:
            shifted = _shift2d(im, dy, dx)
        out.append(shifted)
    return out


# ---------------------------------------------------------------------------
# Robertson merge / calibration (round 3)
# ---------------------------------------------------------------------------

def robertson_weights() -> np.ndarray:
    """OpenCV MergeRobertson's pixel weights, inferred black-box and
    pinned by tests/test_hdr_ext.py: the shifted-normalized Gaussian hat
    ``(exp(−4((z−127.5)/127.5)²) − e⁻⁴) / (1 − e⁻⁴)``."""
    z = np.arange(256, dtype=np.float64)
    w = np.exp(-4.0 * ((z - 127.5) / 127.5) ** 2)
    return (w - np.exp(-4.0)) / (1.0 - np.exp(-4.0))


def _linear_response() -> np.ndarray:
    """Default CRF: linear, normalized so g(128) = 1 (cv2 convention)."""
    g = np.arange(256, dtype=np.float64) / 128.0
    return np.stack([g, g, g], axis=0)


def merge_robertson_numpy(images: Sequence[np.ndarray],
                          times: Sequence[float],
                          response: np.ndarray = None) -> np.ndarray:
    """→ radiance float32 (H, W, 3): ``x = Σ w(z)·t·g(z) / Σ w(z)·t²``
    (Robertson 1999; verified against cv2.MergeRobertson by
    construction in tests). ``response`` is (3, 256) or cv2's
    (256, 1, 3); default linear."""
    ts = np.asarray(times, np.float64)
    if response is None:
        resp = _linear_response()
    else:
        r = np.asarray(response, np.float64)
        resp = r.reshape(256, 3).T if r.ndim == 3 else r
    wgt = robertson_weights()
    num = 0.0
    den = 0.0
    for j, im in enumerate(images):
        z = np.asarray(im)
        wz = wgt[z]
        g = np.stack([resp[c][z[..., c]] for c in range(3)], axis=-1)
        num = num + wz * ts[j] * g
        den = den + wz * ts[j] * ts[j]
    return (num / np.maximum(den, 1e-30)).astype(np.float32)


def calibrate_robertson(images: Sequence[np.ndarray],
                        times: Sequence[float], max_iter: int = 30,
                        threshold: float = 0.01) -> np.ndarray:
    """Robertson EM response recovery → (3, 256), g(128) = 1 per
    channel (OpenCV ``CalibrateRobertson`` role)."""
    ts = np.asarray(times, np.float64)
    zs = np.stack([np.asarray(im).reshape(-1, 3) for im in images])
    resp = _linear_response().copy()
    wgt = robertson_weights()
    for _ in range(max_iter):
        # E-step: radiance per pixel
        g = np.stack([resp[c][zs[..., c]] for c in range(3)], axis=-1)
        w = wgt[zs]
        num = (w * ts[:, None, None] * g).sum(axis=0)
        den = (w * (ts ** 2)[:, None, None]).sum(axis=0)
        x = num / np.maximum(den, 1e-30)
        # M-step: g(z) = mean of t·x over pixels with value z
        new = resp.copy()
        delta = 0.0
        for c in range(3):
            tx = ts[:, None] * x[:, c][None, :]
            vals = zs[..., c].ravel()
            sums = np.bincount(vals, weights=tx.ravel(), minlength=256)
            cnts = np.bincount(vals, minlength=256)
            upd = np.where(cnts > 0, sums / np.maximum(cnts, 1), resp[c])
            if upd[128] > 1e-30:
                upd = upd / upd[128]
            delta = max(delta, float(np.abs(upd - new[c]).max()))
            new[c] = upd
        resp = new
        if delta < threshold:
            break
    return resp


# ---------------------------------------------------------------------------
# Drago tonemap (round 3)
# ---------------------------------------------------------------------------

def tonemap_drago_numpy(hdr: np.ndarray, gamma: float = 1.0,
                        saturation: float = 1.0,
                        bias: float = 0.85) -> np.ndarray:
    """Drago'03 adaptive-logarithmic tonemap → float32 in [0, 1]
    (OpenCV ``TonemapDrago`` role; ≤0.01 MAE vs cv2 pinned — cv2
    treats channel 2 as R in its luminance, reproduced here):
    ``Ld = ln(1+L) / log10(1+Lmax) / ln(2 + 8·(L/Lmax)^(ln b/ln ½))``
    on luminance scaled by the log-average, followed by the saturation
    ratio map, min-max normalization, and gamma."""
    img = np.asarray(hdr, np.float64)
    gray = np.maximum(img[..., 0] * 0.299 + img[..., 1] * 0.587
                      + img[..., 2] * 0.114, 1e-12)
    lwa = np.exp(np.mean(np.log(gray + 1e-4)))
    lmax = gray.max() / lwa
    lw = gray / lwa
    p = np.log(bias) / np.log(0.5)
    ld = (np.log1p(lw) / np.log10(1.0 + lmax)
          / np.log(2.0 + 8.0 * (lw / lmax) ** p))
    ratio = np.power(img / gray[..., None], saturation)
    out = ratio * ld[..., None]
    mn, mx = out.min(), out.max()
    out = (out - mn) / max(mx - mn, 1e-12)
    if gamma != 1.0:
        out = out ** (1.0 / gamma)
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# Mantiuk tonemap (round 3b): gradient-domain contrast compression
# ---------------------------------------------------------------------------

def _poisson_dct(div: np.ndarray) -> np.ndarray:
    """Solve ∇²u = div with Neumann BC exactly via DCT-II (the
    transform module's basis — two matmuls each way)."""
    from .transform import dct_numpy, idct

    h, w = div.shape
    d = dct_numpy(div)
    iy = np.arange(h)[:, None]
    ix = np.arange(w)[None, :]
    lam = (2.0 * np.cos(np.pi * iy / h) - 2.0
           + 2.0 * np.cos(np.pi * ix / w) - 2.0)
    lam[0, 0] = 1.0  # gauge: the DC term is free (mean fixed below)
    u = d / lam
    u[0, 0] = 0.0
    return idct(u)


def tonemap_mantiuk_numpy(hdr: np.ndarray, gamma: float = 1.0,
                          scale: float = 0.7,
                          saturation: float = 1.0) -> np.ndarray:
    """Mantiuk'06-role gradient-domain tonemap (OpenCV
    ``TonemapMantiuk``): scale log-luminance contrasts by the contrast
    scale factor (``g' = scale·g`` — measured to track cv2's transduced
    pyramid far better than power compression: corr 0.95 vs 0.75 at the
    0.7 default) and reintegrate exactly with the DCT Poisson solver;
    per-channel ratios with ``saturation``, min-max normalize, display
    gamma. Output float32 [0, 1]; correlation ≥0.9 with cv2 pinned in
    tests (the discretizations differ)."""
    img = np.asarray(hdr, np.float64)
    gray = np.maximum(img[..., 0] * 0.299 + img[..., 1] * 0.587
                      + img[..., 2] * 0.114, 1e-9)
    loglum = np.log10(gray)
    gx = np.zeros_like(loglum)
    gy = np.zeros_like(loglum)
    gx[:, :-1] = loglum[:, 1:] - loglum[:, :-1]
    gy[:-1, :] = loglum[1:, :] - loglum[:-1, :]
    cx = scale * gx
    cy = scale * gy
    div = np.zeros_like(loglum)
    div[:, 0] += cx[:, 0]
    div[:, 1:] += cx[:, 1:] - cx[:, :-1]
    div[0, :] += cy[0, :]
    div[1:, :] += cy[1:, :] - cy[:-1, :]
    new_log = _poisson_dct(div)
    new_log += loglum.mean() - new_log.mean()
    new_lum = 10.0 ** new_log
    ratio = np.power(img / gray[..., None], saturation)
    out = ratio * new_lum[..., None]
    mn, mx = out.min(), out.max()
    out = (out - mn) / max(mx - mn, 1e-12)
    if gamma != 1.0:
        out = out ** (1.0 / gamma)
    return out.astype(np.float32)
