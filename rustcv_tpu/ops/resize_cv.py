"""cv2-exact ``resize`` for uint8 — reverse-engineered OpenCV 5.0 arithmetic.

These are the *frozen-spec host twins* backing the drop-in ``cv2`` facade
(the device capture pipeline keeps using ``imgproc.resize``'s device kernels;
see reference rustcv/src/imgproc — the reference has no resize of its own
and delegates display scaling to the OS, so this spec is pinned against
OpenCV itself).  Every branch below was established empirically against
cv2 5.0 with multi-thousand-case randomized differential sweeps
(tests/test_cv2_differential.py::resize rows):

- ``INTER_LINEAR`` u8: 11-bit fixed-point.  Per-axis coordinates are
  ``(d+0.5)·scale − 0.5`` with ``scale = 1.0/(dst/src)`` (that exact
  double sequence — using ``src/dst`` directly is one ulp off and flips
  tap indices), cast to float32 BEFORE the floor; out-of-range taps are
  CLAMPED with the fractional weight kept (cv2 5 does NOT zero the
  boundary coefficient); weights ``cvRound(f·2048)`` (half-to-even);
  horizontal pass in int; vertical pass is the SSE ``mulhi`` form
  ``(((b·(S>>4))>>16) summed + 2) >> 2``.  Bit-exact (600/600 sweeps).
  cv2 reroutes exact 2×2 decimation to INTER_AREA's fast path; so do we.
- ``INTER_AREA`` u8, integer scales: block sum; ``(sum+2)>>2`` for 2×2
  (the dedicated SIMD kernel rounds half away from the scalar path),
  else ``rint(sum·float32(1/area))``.  Bit-exact.
- ``INTER_AREA`` u8, non-integer downscale: cv2's DecimateAlpha tab —
  per-dst-pixel partial-cell float32 weights (cell boundaries in double,
  1e-3 epsilon guards) accumulated in float32 in ascending-tap order.
  Bit-exact (554/554).
- ``INTER_AREA`` u8, any upscaled axis: generic bilinear fixed-point with
  cv2's area coefficient scheme ``sx = floor(dx·scale)``,
  ``f = (dx+1) − (sx+1)·inv_scale`` (≤0 → 0, else frac), per axis.
  Bit-exact (754/754 incl. the double-rounding sy edge cases).
- ``INTER_CUBIC`` u8: two regimes, established by single-variable probes
  (identity-H / identity-V / 1-row / 1-column images).  Sources with
  ``min(sh, sw) < 4`` run the classic 11-bit fixed point (2048-quantized
  shorts) with a HALF-EVEN final rounding of ``Σ/2^22`` (cv2 casts the
  accumulated product through float, so ``(Σ + 2^21) >> 22`` half-up is
  wrong ~100× more often) — exact to ~4 ppm ≤1 LSB.  Larger
  sources run the float32 kernels (A=−0.75 weights evaluated in float32
  from the float32 fraction, UNQUANTIZED) — matches cv2 bit-for-bit on
  ~3/4 of random size pairs; the rest differ by ≤1 LSB on ≲0.1 % of
  pixels whose value lands exactly on a .5 boundary (cv2's SIMD fma
  contraction jitter — same class as the warpAffine caveat).
- ``INTER_LANCZOS4`` u8: full 11-bit fixed point, 8 taps, weights from
  the sin/cos quadrature table, single rounding ``(Σ + 2^21) >> 22``.
  Bit-exact (60/60).
- ``INTER_NEAREST`` u8: ``floor(dst·(1/inv_scale))`` tap tables (exact
  double sequence), pure gather.  Bit-exact.
"""

from __future__ import annotations

import numpy as np

__all__ = ["resize_cv_u8"]

_SCALE = 2048  # INTER_RESIZE_COEF_SCALE (11-bit)


def _cvround(x: np.ndarray) -> np.ndarray:
    return np.rint(x).astype(np.int64)


# ----------------------------------------------------------------- linear

def _lin_coeffs(n_dst: int, n_src: int):
    scale = 1.0 / (n_dst / n_src)
    d = np.arange(n_dst)
    f = ((d + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    t0 = np.clip(s, 0, n_src - 1)
    t1 = np.clip(s + 1, 0, n_src - 1)
    a0 = _cvround((np.float32(1) - f) * np.float32(_SCALE))
    a1 = _cvround(f * np.float32(_SCALE))
    return t0, t1, a0, a1


def _area_up_coeffs(n_dst: int, n_src: int):
    # cv2's generic INTER_AREA coefficient scheme (any upscaled axis).
    inv = n_dst / n_src
    scale = 1.0 / inv
    d = np.arange(n_dst)
    s = np.floor(d * scale).astype(np.int64)
    f = ((d + 1) - (s + 1) * inv).astype(np.float32)
    f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    t0 = np.clip(s, 0, n_src - 1)
    t1 = np.clip(s + 1, 0, n_src - 1)
    a0 = _cvround((np.float32(1) - f) * np.float32(_SCALE))
    a1 = _cvround(f * np.float32(_SCALE))
    return t0, t1, a0, a1


def _bilinear_fixed(a: np.ndarray, xs, ys) -> np.ndarray:
    (x0, x1, a0, a1), (y0, y1, b0, b1) = xs, ys
    src = a.astype(np.int64)
    ax = a0[None, :, None], a1[None, :, None]
    H = src[:, x0] * ax[0] + src[:, x1] * ax[1]
    S0, S1 = H[y0], H[y1]
    by = b0[:, None, None], b1[:, None, None]
    out = (((by[0] * (S0 >> 4)) >> 16) + ((by[1] * (S1 >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


# ------------------------------------------------------------------- area

def _area_fast(a: np.ndarray, w: int, h: int) -> np.ndarray:
    sh, sw = a.shape[:2]
    kx, ky = sw // w, sh // h
    blk = a.reshape(h, ky, w, kx, -1).astype(np.int64).sum((1, 3))
    if kx == 2 and ky == 2:
        return ((blk + 2) >> 2).astype(np.uint8)
    s = np.float32(1.0 / (kx * ky))
    return np.clip(np.rint(blk.astype(np.float32) * s), 0, 255).astype(np.uint8)


def _area_tab(n_src: int, n_dst: int):
    # cv2 computeResizeAreaTab: per-dst tap list with partial-cell weights.
    scale = 1.0 / (n_dst / n_src)
    idxs, alphas = [], []
    for dx in range(n_dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cellw = min(scale, n_src - fsx1)
        sx1 = int(np.ceil(fsx1))
        sx2 = min(int(np.floor(fsx2)), n_src - 1)
        sx1 = min(sx1, sx2)
        taps = []
        if sx1 - fsx1 > 1e-3:
            taps.append((sx1 - 1, np.float32((sx1 - fsx1) / cellw)))
        for sx in range(sx1, sx2):
            taps.append((sx, np.float32(1.0 / cellw)))
        if fsx2 - sx2 > 1e-3:
            taps.append((sx2,
                         np.float32(min(min(fsx2 - sx2, 1.0), cellw) / cellw)))
        idxs.append([t[0] for t in taps])
        alphas.append([t[1] for t in taps])
    T = max(len(x) for x in idxs)
    I = np.zeros((T, n_dst), np.int64)
    A = np.zeros((T, n_dst), np.float32)
    for d in range(n_dst):
        for k, (i, al) in enumerate(zip(idxs[d], alphas[d])):
            I[k, d] = i
            A[k, d] = al
    return I, A


def _area_general(a: np.ndarray, w: int, h: int) -> np.ndarray:
    sh, sw = a.shape[:2]
    XI, XA = _area_tab(sw, w)
    YI, YA = _area_tab(sh, h)
    srcf = a.astype(np.float32)
    buf = np.zeros((sh, w) + a.shape[2:], np.float32)
    for k in range(XI.shape[0]):  # ascending-tap f32 order == cv2's
        buf += srcf[:, XI[k]] * XA[k][None, :, None]
    out = np.zeros((h, w) + a.shape[2:], np.float32)
    for k in range(YI.shape[0]):
        out += buf[YI[k]] * YA[k][:, None, None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


# ------------------------------------------------------------------ cubic

def _cubic_coeffs_f32(n_dst: int, n_src: int):
    scale = 1.0 / (n_dst / n_src)
    d = np.arange(n_dst)
    f = ((d + 0.5) * scale - 0.5).astype(np.float32)
    s0 = np.floor(f).astype(np.int64)
    x = (f - s0).astype(np.float32)
    A = np.float32(-0.75)
    c0 = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A
    c1 = ((A + 2) * x - (A + 3)) * x * x + 1
    c2 = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1
    c3 = np.float32(1) - c0 - c1 - c2
    ws = [np.atleast_1d(c.astype(np.float32)) for c in (c0, c1, c2, c3)]
    taps = [np.clip(s0 + k - 1, 0, n_src - 1) for k in range(4)]
    return taps, ws


def _cubic(a: np.ndarray, w: int, h: int) -> np.ndarray:
    sh, sw = a.shape[:2]
    xt, xw = _cubic_coeffs_f32(w, sw)
    yt, yw = _cubic_coeffs_f32(h, sh)
    if min(sh, sw) < 4:  # cv2's fixed-point regime for tiny sources
        src = a.astype(np.int64)
        xq = [_cvround(c.astype(np.float64) * _SCALE) for c in xw]
        yq = [_cvround(c.astype(np.float64) * _SCALE) for c in yw]
        H = sum(src[:, xt[k]] * xq[k][None, :, None] for k in range(4))
        V = sum(H[yt[k]] * yq[k][:, None, None] for k in range(4))
        out = np.rint(V.astype(np.float64) * 2.0 ** -22)
        return np.clip(out, 0, 255).astype(np.uint8)
    srcf = a.astype(np.float32)
    H = srcf[:, xt[0]] * xw[0][None, :, None]
    for k in range(1, 4):
        H = H + srcf[:, xt[k]] * xw[k][None, :, None]
    V = H[yt[0]] * yw[0][:, None, None]
    for k in range(1, 4):
        V = V + H[yt[k]] * yw[k][:, None, None]
    return np.clip(np.rint(V), 0, 255).astype(np.uint8)


# --------------------------------------------------------------- lanczos4

_S45 = 0.70710678118654752440084436210485
_LANCZOS_CS = ((1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45),
               (-1, 0), (_S45, _S45), (0, -1), (-_S45, _S45))


def _lanczos_weights(x: float) -> np.ndarray:
    # cv2 interpolateLanczos4: sin/cos quadrature, normalized to 1.
    if x < 2.2204460492503131e-16:
        w = np.zeros(8)
        w[3] = 1.0
        return w
    y0 = -(x + 3) * np.pi * 0.25
    s0, c0 = np.sin(y0), np.cos(y0)
    w = np.zeros(8)
    for k in range(8):
        y = -(x + 3 - k) * np.pi * 0.25
        w[k] = (_LANCZOS_CS[k][0] * s0 + _LANCZOS_CS[k][1] * c0) / (y * y)
    return w / w.sum()


def _lanczos_coeffs(n_dst: int, n_src: int):
    scale = 1.0 / (n_dst / n_src)
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    s0 = np.floor(f).astype(np.int64)
    fr = (f - s0).astype(np.float32)
    W = np.stack([_lanczos_weights(float(v)).astype(np.float32) for v in fr])
    Wq = _cvround(W.astype(np.float64) * _SCALE)
    taps = [np.clip(s0 + k - 3, 0, n_src - 1) for k in range(8)]
    return taps, Wq


def _lanczos4(a: np.ndarray, w: int, h: int) -> np.ndarray:
    sh, sw = a.shape[:2]
    xt, XQ = _lanczos_coeffs(w, sw)
    yt, YQ = _lanczos_coeffs(h, sh)
    src = a.astype(np.int64)
    H = src[:, xt[0]] * XQ[:, 0][None, :, None]
    for k in range(1, 8):
        H = H + src[:, xt[k]] * XQ[:, k][None, :, None]
    V = H[yt[0]] * YQ[:, 0][:, None, None]
    for k in range(1, 8):
        V = V + H[yt[k]] * YQ[:, k][:, None, None]
    out = (V + (1 << 21)) >> 22
    return np.clip(out, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------- nearest

def _nearest(a: np.ndarray, w: int, h: int) -> np.ndarray:
    sh, sw = a.shape[:2]
    ifx, ify = 1.0 / (w / sw), 1.0 / (h / sh)
    xi = np.minimum(np.floor(np.arange(w) * ifx).astype(np.int64), sw - 1)
    yi = np.minimum(np.floor(np.arange(h) * ify).astype(np.int64), sh - 1)
    return np.ascontiguousarray(a[yi[:, None], xi[None, :]])


# --------------------------------------------------------------- dispatch

def resize_cv_u8(src: np.ndarray, w: int, h: int,
                 interpolation: int = 1) -> np.ndarray:
    """cv2.resize for uint8 input (INTER_NEAREST/LINEAR/CUBIC/AREA/
    LANCZOS4 = 0/1/2/3/4), following cv2 5.0's dispatch rules."""
    a = np.asarray(src)
    if a.dtype != np.uint8:
        raise ValueError("resize_cv_u8 is the uint8 spec")
    sh, sw = a.shape[:2]
    if (w, h) == (sw, sh):
        return a.copy()
    squeeze = a.ndim == 2
    a3 = a[..., None] if squeeze else a
    scale_x, scale_y = sw / w, sh / h
    is_fast = (abs(scale_x - round(scale_x)) < 2.3e-16
               and abs(scale_y - round(scale_y)) < 2.3e-16
               and scale_x >= 1 and scale_y >= 1)
    if interpolation == 1 and is_fast and round(scale_x) == 2 \
            and round(scale_y) == 2:
        interpolation = 3  # cv2 reroutes exact 2x2 linear decimation
    if interpolation == 0:
        return _nearest(a, w, h)
    elif interpolation == 1:
        out = _bilinear_fixed(a3, _lin_coeffs(w, sw), _lin_coeffs(h, sh))
    elif interpolation == 2:
        out = _cubic(a3, w, h)
    elif interpolation == 3:
        if is_fast:
            out = _area_fast(a3, w, h)
        elif scale_x >= 1 and scale_y >= 1:
            out = _area_general(a3, w, h)
        else:
            out = _bilinear_fixed(a3, _area_up_coeffs(w, sw),
                                  _area_up_coeffs(h, sh))
    elif interpolation == 4:
        out = _lanczos4(a3, w, h)
    else:
        raise ValueError(f"unknown interpolation {interpolation}")
    return out[..., 0] if squeeze else out
