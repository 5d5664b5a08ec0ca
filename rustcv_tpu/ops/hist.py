"""Histogram ops — calcHist / equalizeHist (OpenCV parity), accelerator-native.

Device histogramming avoids scatter (the slow form on the device it was
built for): the device computes 256 masked reductions
(one fused pass, vectorized over the bin axis); equalization builds the
exact-integer LUT on-device and applies it with one gather.

Frozen spec (exact integer, device == oracle bit-for-bit):
- hist[b]  = #pixels with value b (int32)
- equalize: cdf = inclusive cumsum(hist); cdf_min = cdf at the lowest
  populated bin; d = N − cdf_min; lut[i] = (255·(cdf[i]−cdf_min) + d//2)
  // d (round-half-up for even d; the numerator stays < 2^31 up to 4K —
  8.4M pixels — which the doubled 510-form would overflow); identity when
  d == 0 (constant image); out = lut[img].
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp


def calc_hist_numpy(gray: np.ndarray) -> np.ndarray:
    return np.bincount(gray.reshape(-1), minlength=256).astype(np.int32)


def equalize_hist_numpy(gray: np.ndarray) -> np.ndarray:
    """Bit-exact cv2.equalizeHist: the LUT is cvRound(f32(sum) * f32
    scale) with scale = 255.f/(total - hist[first]) — the f32 product
    and the round-half-to-even must BOTH be replicated or knife-edge
    CDF values flip by 1 LSB (found by the r5 rotating-seed sweep;
    the previous exact-integer round-half-up formula differed on ~12%
    of random images)."""
    hist = calc_hist_numpy(gray).astype(np.int64)
    cdf = np.cumsum(hist)
    n = int(cdf[-1])
    populated = np.nonzero(hist)[0]
    cdf_min = int(cdf[populated[0]]) if populated.size else 0
    denom = n - cdf_min
    if denom <= 0:
        return gray.copy()  # constant image: identity
    scale = np.float32(255.0) / np.float32(denom)
    lut = np.rint((cdf - cdf_min).astype(np.float32) * scale)
    return np.clip(lut, 0, 255).astype(np.uint8)[gray]


@jax.jit
def calc_hist(gray: jax.Array) -> jax.Array:
    """u8 image (any shape) → [256] int32 counts (exact).

    Histogram as ONE matmul: hi-nibble one-hot [16, N] × lo-nibble
    one-hot [N, 16] → counts[h, l] = #pixels with value h·16+l. Exact in
    f32 up to 2^24 pixels (16.7 MP — beyond 4K)."""
    flat = gray.reshape(-1).astype(jnp.int32)
    if flat.size >= (1 << 24):  # f32 count exactness bound
        bins = jnp.arange(256, dtype=jnp.int32)
        return jax.vmap(lambda b: jnp.sum((flat == b).astype(jnp.int32)))(bins)
    nib = jnp.arange(16, dtype=jnp.int32)
    hi = (flat[None, :] >> 4 == nib[:, None]).astype(jnp.float32)  # [16, N]
    lo = (flat[None, :] & 15 == nib[:, None]).astype(jnp.float32)  # [16, N]
    counts = jax.lax.dot(
        hi, lo.T, precision=jax.lax.Precision.HIGHEST
    )  # [16, 16]
    return counts.reshape(256).astype(jnp.int32)


@jax.jit
def apply_lut(img: jax.Array, lut: jax.Array) -> jax.Array:
    """u8 image (any shape) × 256-entry u8 LUT → u8 image (OpenCV ``LUT``).

    Gather-free: out_i = hi_onehot(p_i) @ lut[16, 16] · lo_onehot(p_i) —
    one [N, 16] matmul + a 16-term elementwise dot instead of a per-pixel
    gather. Exact: all values
    ≤ 255 in f32."""
    p = img.reshape(-1).astype(jnp.int32)
    nib = jnp.arange(16, dtype=jnp.int32)
    hi = (p[:, None] >> 4 == nib[None, :]).astype(jnp.float32)
    lo = (p[:, None] & 15 == nib[None, :]).astype(jnp.float32)
    sub = lut.reshape(16, 16).astype(jnp.float32)
    a = jax.lax.dot(hi, sub, precision=jax.lax.Precision.HIGHEST)
    return jnp.sum(a * lo, axis=-1).astype(jnp.uint8).reshape(img.shape)


@jax.jit
def equalize_hist(gray: jax.Array) -> jax.Array:
    """Histogram equalization, bit-exact vs cv2 at ANY size: the LUT is
    cv2's own f32 arithmetic (cvRound(f32(sum) · 255.f/denom)) — one
    IEEE multiply + round-half-even, identical on CPU/device/numpy, and
    immune to the int32 overflow that forced the old exact-integer
    formula onto a host path above ~8.4M pixels."""
    hist = calc_hist(gray)
    cdf = jnp.cumsum(hist)
    n = cdf[-1]
    first = jnp.argmax(hist > 0)  # lowest populated bin
    cdf_min = cdf[first]
    denom = n - cdf_min
    scale = jnp.float32(255.0) / jnp.maximum(denom, 1).astype(jnp.float32)
    lut = jnp.rint((cdf - cdf_min).astype(jnp.float32) * scale)
    lut = jnp.clip(lut, 0, 255).astype(jnp.uint8)
    out = apply_lut(gray, lut)  # gather-free LUT apply (see apply_lut)
    return jnp.where(denom > 0, out, gray)  # constant image: identity


# ---------------------------------------------------------------------------
# CLAHE
# ---------------------------------------------------------------------------
#
# Frozen spec (exact integer, device == oracle bit-for-bit):
# - edge-pad so both dims are grid multiples (tiles th×tw); per-tile
#   256-bin histograms;
# - clip limit L = max(1, clip_limit·th·tw // 256); excess = Σ max(h−L, 0)
#   redistributes as +excess//256 per bin and +1 to the first excess%256;
# - per-tile LUT: lut[i] = (255·cdf[i] + n//2) // n (n = th·tw);
# - bilinear LUT interpolation on the half-tile-shifted cell lattice,
#   weights (2r+1)/(2·th), edge cells clamped to the nearest tile; value =
#   (Σ w·lut_v + D//2) // D with D = 4·th·tw (all int32);
# - crop back to the original size.


def clahe_numpy(
    gray: np.ndarray, clip_limit: int = 40, grid: tuple = (8, 8)
) -> np.ndarray:
    """Float-free CLAHE oracle (see the frozen spec above)."""
    gy, gx = grid
    h, w = gray.shape
    th = -(-h // gy)
    tw = -(-w // gx)
    img = np.pad(gray, ((0, gy * th - h), (0, gx * tw - w)), mode="edge")
    n = th * tw
    limit = max(1, clip_limit * n // 256)
    tiles = img.reshape(gy, th, gx, tw).transpose(0, 2, 1, 3)
    luts = np.zeros((gy, gx, 256), np.int64)
    for i in range(gy):
        for j in range(gx):
            hst = np.bincount(tiles[i, j].reshape(-1), minlength=256).astype(np.int64)
            excess = int(np.maximum(hst - limit, 0).sum())
            hst = np.minimum(hst, limit) + excess // 256
            hst[: excess % 256] += 1
            cdf = np.cumsum(hst)
            luts[i, j] = np.clip((255 * cdf + n // 2) // n, 0, 255)
    pimg = np.pad(
        img, ((th // 2, th - th // 2), (tw // 2, tw - tw // 2)), mode="edge"
    )
    cy, cx = gy + 1, gx + 1
    cells = pimg.reshape(cy, th, cx, tw).transpose(0, 2, 1, 3).astype(np.int64)
    wy = (2 * np.arange(th) + 1).reshape(th, 1)
    wx = (2 * np.arange(tw) + 1).reshape(1, tw)
    d = 4 * th * tw
    out = np.zeros_like(cells)
    for i in range(cy):
        for j in range(cx):
            p = cells[i, j]
            v = []
            for di in (0, 1):
                for dj in (0, 1):
                    ti = min(max(i - 1 + di, 0), gy - 1)
                    tj = min(max(j - 1 + dj, 0), gx - 1)
                    v.append(luts[ti, tj][p])
            acc = (
                (2 * th - wy) * (2 * tw - wx) * v[0]
                + (2 * th - wy) * wx * v[1]
                + wy * (2 * tw - wx) * v[2]
                + wy * wx * v[3]
            )
            out[i, j] = (acc + d // 2) // d
    res = out.transpose(0, 2, 1, 3).reshape(cy * th, cx * tw)
    res = res[th // 2 : th // 2 + gy * th, tw // 2 : tw // 2 + gx * tw]
    return np.clip(res, 0, 255).astype(np.uint8)[:h, :w]


@partial(jax.jit, static_argnames=("clip_limit", "grid"))
def clahe(
    gray: jax.Array, clip_limit: int = 40, grid: tuple = (8, 8)
) -> jax.Array:
    """Contrast-limited adaptive histogram equalization (OpenCV
    ``createCLAHE`` role) — bit-exact vs :func:`clahe_numpy`.

    Everything batches over tiles/cells: per-tile histograms are nibble
    one-hot matmuls and each interpolation cell's four corner LUTs apply
    via batched [n, 16] @ [16, 16] matmuls — no per-pixel gathers."""
    from .color import _div_floor_exact

    gy, gx = grid
    h, w = gray.shape
    th = -(-h // gy)
    tw = -(-w // gx)
    img = jnp.pad(gray, ((0, gy * th - h), (0, gx * tw - w)), mode="edge")
    n = th * tw
    limit = max(1, clip_limit * n // 256)
    tiles = img.reshape(gy, th, gx, tw).transpose(0, 2, 1, 3)
    flat = tiles.reshape(gy * gx, n).astype(jnp.int32)
    nib = jnp.arange(16, dtype=jnp.int32)
    hi = (flat[..., None] >> 4 == nib).astype(jnp.float32)  # [T, n, 16]
    lo = (flat[..., None] & 15 == nib).astype(jnp.float32)
    hist = (
        jnp.einsum("tnh,tnl->thl", hi, lo, precision=jax.lax.Precision.HIGHEST)
        .reshape(gy * gx, 256)
        .astype(jnp.int32)
    )  # counts[t, hi*16+lo] — matches the value layout
    excess = jnp.maximum(hist - limit, 0).sum(axis=-1, keepdims=True)
    hist = jnp.minimum(hist, limit) + excess // 256
    hist = hist + (jnp.arange(256) < (excess % 256)).astype(jnp.int32)
    cdf = jnp.cumsum(hist, axis=-1)
    luts = jnp.clip(
        _div_floor_exact(255 * cdf + n // 2, jnp.full_like(cdf, n)), 0, 255
    ).reshape(gy, gx, 256)

    # Static corner-LUT tables per half-tile-shifted interpolation cell.
    cy, cx = gy + 1, gx + 1
    iy = np.arange(cy)
    jx = np.arange(cx)
    corner_tabs = [
        luts[np.clip(iy - 1 + di, 0, gy - 1)][:, np.clip(jx - 1 + dj, 0, gx - 1)]
        for di in (0, 1)
        for dj in (0, 1)
    ]  # each [cy, cx, 256]

    pimg = jnp.pad(
        img, ((th // 2, th - th // 2), (tw // 2, tw - tw // 2)), mode="edge"
    )
    cells = pimg.reshape(cy, th, cx, tw).transpose(0, 2, 1, 3)
    p = cells.reshape(cy, cx, n).astype(jnp.int32)
    phi = (p[..., None] >> 4 == nib).astype(jnp.float32)
    plo = (p[..., None] & 15 == nib).astype(jnp.float32)

    def lut_apply(tab):
        sub = tab.reshape(cy, cx, 16, 16).astype(jnp.float32)
        a = jnp.einsum(
            "cxnh,cxhl->cxnl", phi, sub, precision=jax.lax.Precision.HIGHEST
        )
        return jnp.sum(a * plo, axis=-1).astype(jnp.int32)

    v00, v01, v10, v11 = (lut_apply(t) for t in corner_tabs)
    wy = jnp.broadcast_to(
        (2 * jnp.arange(th, dtype=jnp.int32) + 1).reshape(th, 1), (th, tw)
    ).reshape(n)
    wx = jnp.broadcast_to(
        (2 * jnp.arange(tw, dtype=jnp.int32) + 1).reshape(1, tw), (th, tw)
    ).reshape(n)
    d = 4 * th * tw
    acc = (
        (2 * th - wy) * (2 * tw - wx) * v00
        + (2 * th - wy) * wx * v01
        + wy * (2 * tw - wx) * v10
        + wy * wx * v11
    )
    out = (acc + d // 2) // d  # constant divisor → multiply-shift lowering
    out = (
        out.reshape(cy, cx, th, tw)
        .transpose(0, 2, 1, 3)
        .reshape(cy * th, cx * tw)
    )
    out = out[th // 2 : th // 2 + gy * th, tw // 2 : tw // 2 + gx * tw]
    return jnp.clip(out, 0, 255).astype(jnp.uint8)[:h, :w]


def calc_hue_hist(hsv: np.ndarray, mask: np.ndarray = None) -> np.ndarray:
    """Normalized 180-bin hue histogram of an HSV image (host; optionally
    restricted to ``mask`` != 0) — the model half of
    :func:`back_project_hue`."""
    hue = np.asarray(hsv)[..., 0].reshape(-1)
    if mask is not None:
        hue = hue[np.asarray(mask).reshape(-1) != 0]
    h = np.bincount(hue, minlength=256)[:180].astype(np.float64)
    s = h.sum()
    return h / s if s > 0 else h


@jax.jit
def _backproject_device(hue: jax.Array, lut: jax.Array) -> jax.Array:
    return apply_lut(hue, lut)


def back_project_hue(hsv, hue_hist: np.ndarray) -> np.ndarray:
    """Histogram backprojection (OpenCV ``calcBackProject`` for the hue
    channel): per-pixel likelihood u8 = 255·hist[bin(hue)]/max(hist) — the
    CamShift/mean-shift tracking weight image. Models with fewer than 180
    bins map via bin = hue·nbins // 180 (the common 16-bin usage). The
    256-entry LUT applies with the gather-free nibble matmul; device
    inputs stay on device (no ndim-probe fetch)."""
    h = np.asarray(hue_hist, np.float64).reshape(-1)
    nbins = min(len(h), 180)
    h = h[:nbins]
    peak = h.max() if nbins else 0.0
    lut = np.zeros(256, np.uint8)
    if peak > 0:
        bins = (np.arange(180) * nbins) // 180
        lut[:180] = np.clip(np.round(255.0 * h[bins] / peak), 0, 255).astype(
            np.uint8
        )
    a = hsv if hasattr(hsv, "ndim") else np.asarray(hsv)
    hue = a[..., 0] if a.ndim == 3 else a  # slice BEFORE any upload
    return np.asarray(_backproject_device(jnp.asarray(hue), jnp.asarray(lut)))


def mean_shift(prob: np.ndarray, window: tuple, max_iter: int = 20,
               eps: float = 0.0):
    """OpenCV ``meanShift``: iterate the search window to the centroid of
    the weight image (e.g. :func:`back_project_hue` output) until the
    shift is below ``eps`` or ``max_iter``. ``window`` = (x, y, w, h);
    returns (iterations_used, final_window)."""
    p = np.asarray(prob, np.float64)
    hh, ww = p.shape[:2]
    x, y, w, h = (int(v) for v in window)
    w = max(1, min(w, ww))
    h = max(1, min(h, hh))
    x = min(max(x, 0), ww - w)  # clamp BEFORE the loop too (max_iter=0
    y = min(max(y, 0), hh - h)  # must still return an in-bounds window)
    it = 0
    for it in range(1, max_iter + 1):
        x = min(max(x, 0), ww - w)
        y = min(max(y, 0), hh - h)
        roi = p[y : y + h, x : x + w]
        m00 = roi.sum()
        if m00 <= 0:
            break
        xs = np.arange(w)
        ys = np.arange(h)
        cx = (roi.sum(axis=0) * xs).sum() / m00
        cy = (roi.sum(axis=1) * ys).sum() / m00
        # window center INDEX is x + (w-1)/2; move it onto the centroid
        nx = int(round(x + cx - (w - 1) / 2.0))
        ny = int(round(y + cy - (h - 1) / 2.0))
        nx = min(max(nx, 0), ww - w)
        ny = min(max(ny, 0), hh - h)
        if abs(nx - x) <= eps and abs(ny - y) <= eps:
            x, y = nx, ny
            break
        x, y = nx, ny
    return it, (x, y, w, h)


def cam_shift(prob: np.ndarray, window: tuple, max_iter: int = 10):
    """OpenCV ``CamShift`` (simplified): meanShift convergence, then the
    window resizes from the zeroth moment (s = 2·√(m00/255), CamShift's
    classic rule) and recenters. Returns ((cx, cy, w, h), window)."""
    it, (x, y, w, h) = mean_shift(prob, window, max_iter=max_iter)
    p = np.asarray(prob, np.float64)
    roi = p[y : y + h, x : x + w]
    m00 = roi.sum()
    if m00 > 0:
        s = int(round(2.0 * np.sqrt(m00 / 255.0)))
        nw = max(4, s)
        nh = max(4, int(round(s * h / max(w, 1))))
        cx = x + w / 2.0
        cy = y + h / 2.0
        x = int(round(cx - nw / 2.0))
        y = int(round(cy - nh / 2.0))
        w, h = nw, nh
        hh, ww = p.shape[:2]
        w = min(w, ww)
        h = min(h, hh)
        x = min(max(x, 0), ww - w)
        y = min(max(y, 0), hh - h)
    return (x + w / 2.0, y + h / 2.0, w, h), (x, y, w, h)
