"""Device stencil filters — Gaussian blur, Sobel, gradient magnitude.

Bit-exact vs :mod:`golden` (integer taps implemented as shifted adds, which
XLA fuses into a single elementwise DAG — no convolution primitive needed for
5-tap integer kernels). Works on
(H, W), (H, W, C) or batched (..., H, W[, C]) arrays; the two spatial axes
are identified by the ``hw_axes`` convention: they are the last two axes for
gray input, axes (-3, -2) when a channel axis is present.

Specs frozen in golden.py (the reference has no filters; BASELINE configs
2–4 demand them).
"""

from __future__ import annotations

from functools import lru_cache, partial

import numpy as np

import jax
import jax.numpy as jnp

GAUSS5 = (1, 4, 6, 4, 1)  # per-axis taps, sum 16
# Input rows the Gaussian5 → Sobel3 chain needs beyond each output edge.
HALO = len(GAUSS5) // 2 + 1


def _replicate_pad(a: jax.Array, axis: int, r: int) -> jax.Array:
    pad = [(0, 0)] * a.ndim
    pad[axis] = (r, r)
    return jnp.pad(a, pad, mode="edge")


def _taps(a: jax.Array, axis: int, weights, r: int):
    """Σ w_k · shift_k(a) along ``axis`` with replicate border, int32."""
    p = _replicate_pad(a, axis, r)
    n = a.shape[axis]
    acc = None
    for k, w in enumerate(weights):
        if w == 0:
            continue
        sl = jax.lax.slice_in_dim(p, k, k + n, axis=axis)
        term = w * sl if w != 1 else sl
        acc = term if acc is None else acc + term
    return acc


def _spatial_axes(x: jax.Array, has_channels: bool):
    return (-3, -2) if has_channels else (-2, -1)


@partial(jax.jit, static_argnames=("has_channels",))
def gaussian5_u8(img: jax.Array, has_channels: bool = None) -> jax.Array:  # type: ignore[assignment]
    """5×5 Gaussian on u8, replicate border, (Σ+128)>>8 — exact vs golden."""
    if has_channels is None:
        has_channels = img.ndim >= 3 and img.shape[-1] in (1, 3, 4)
    ax_h, ax_w = _spatial_axes(img, has_channels)
    a = img.astype(jnp.int32)
    tmp = _taps(a, ax_w, GAUSS5, 2)
    acc = _taps(tmp, ax_h, GAUSS5, 2)
    return ((acc + 128) >> 8).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("has_channels",))
def pyr_down(img: jax.Array, has_channels: bool = None) -> jax.Array:  # type: ignore[assignment]
    """Pyramid downsample: 5×5 Gaussian + even-index decimation — exact vs
    golden.pyr_down. Output ceil(H/2) × ceil(W/2)."""
    if has_channels is None:
        has_channels = img.ndim >= 3 and img.shape[-1] in (1, 3, 4)
    blurred = gaussian5_u8(img, has_channels=has_channels)
    ax_h, ax_w = _spatial_axes(img, has_channels)
    idx_h = jnp.arange(0, img.shape[ax_h], 2)
    idx_w = jnp.arange(0, img.shape[ax_w], 2)
    return jnp.take(jnp.take(blurred, idx_h, axis=ax_h), idx_w, axis=ax_w)


@jax.jit
def sobel3_gray(gray: jax.Array):
    """Sobel gx/gy on u8 gray (..., H, W) → int32 pair, exact vs golden."""
    a = gray.astype(jnp.int32)
    ax_h, ax_w = -2, -1
    smooth_v = _taps(a, ax_h, (1, 2, 1), 1)
    diff_v = _taps(a, ax_h, (-1, 0, 1), 1)
    gx = _taps(smooth_v, ax_w, (-1, 0, 1), 1)
    gy = _taps(diff_v, ax_w, (1, 2, 1), 1)
    return gx, gy


@jax.jit
def isqrt_exact(x: jax.Array) -> jax.Array:
    """Exact floor-sqrt of non-negative int32 (≤ ~2.1e9 via f32 + fix-up)."""
    xf = x.astype(jnp.float32)
    s = jnp.sqrt(xf).astype(jnp.int32)
    # f32 sqrt may be off by an ULP; two monotone fix-ups restore floor.
    s = jnp.where((s + 1) * (s + 1) <= x, s + 1, s)
    s = jnp.where(s * s > x, s - 1, s)
    return s


@jax.jit
def gradient_magnitude_u8(gx: jax.Array, gy: jax.Array) -> jax.Array:
    """min(255, isqrt(gx²+gy²)). gx,gy ≤ 1020 ⇒ gx²+gy² ≤ 2.08e6, fits i32."""
    mag2 = gx * gx + gy * gy
    return jnp.minimum(isqrt_exact(mag2), 255).astype(jnp.uint8)


@jax.jit
def blur_sobel_mag_u8(img_bgr: jax.Array) -> jax.Array:
    """Fused BASELINE config-3 pipeline: gray → Gaussian5 → Sobel → |∇|.

    One jitted program; XLA fuses the whole integer DAG into a few kernels.
    """
    from .color import bgr_to_gray

    gray = bgr_to_gray(img_bgr)
    blurred = gaussian5_u8(gray, has_channels=False)
    gx, gy = sobel3_gray(blurred)
    return gradient_magnitude_u8(gx, gy)


def _window_reduce(img: jax.Array, ksize: int, fn) -> jax.Array:
    has_channels = img.ndim >= 3 and img.shape[-1] in (1, 3, 4)
    ax_h, ax_w = _spatial_axes(img, has_channels)
    r = ksize // 2
    p = _replicate_pad(_replicate_pad(img, ax_h, r), ax_w, r)
    h = img.shape[ax_h]
    w = img.shape[ax_w]
    acc = None
    for dy in range(ksize):
        for dx in range(ksize):
            sl = jax.lax.slice_in_dim(
                jax.lax.slice_in_dim(p, dy, dy + h, axis=ax_h), dx, dx + w, axis=ax_w
            )
            acc = sl if acc is None else fn(acc, sl)
    return acc


@partial(jax.jit, static_argnames=("ksize",))
def erode_u8(img: jax.Array, ksize: int = 3) -> jax.Array:
    """k×k erosion (window min), replicate border — exact vs golden.erode."""
    return _window_reduce(img, ksize, jnp.minimum)


@partial(jax.jit, static_argnames=("ksize",))
def dilate_u8(img: jax.Array, ksize: int = 3) -> jax.Array:
    """k×k dilation (window max), replicate border — exact vs golden.dilate."""
    return _window_reduce(img, ksize, jnp.maximum)


@partial(jax.jit, static_argnames=("k",))
def median_u8(img: jax.Array, k: int = 5) -> jax.Array:
    """k×k median (odd k) via BITWISE BISECTION — exact, any kernel size.

    Sorting networks scale O(k² log² k²) compare-exchanges; instead build
    the median value bit-by-bit from the MSB: bit b of the median is 0 iff
    at least ⌈k²/2⌉ taps are ≤ prefix + 2^b − 1. Eight counting rounds of
    k² compares each — pure fusible elementwise work, no tap-array mutation, and
    the same code handles every k (the selection-network form is kept for
    k = 3 where its 19 exchanges win). Bit-exact vs golden.median_k.
    """
    if k % 2 != 1 or k < 1:
        raise ValueError(f"median_u8: odd k required, got {k}")
    has_channels = img.ndim >= 3 and img.shape[-1] in (1, 3, 4)
    ax_h, ax_w = _spatial_axes(img, has_channels)
    r = k // 2
    p = _replicate_pad(_replicate_pad(img, ax_h, r), ax_w, r)
    h = img.shape[ax_h]
    w = img.shape[ax_w]
    taps = [
        jax.lax.slice_in_dim(
            jax.lax.slice_in_dim(p, dy, dy + h, axis=ax_h), dx, dx + w, axis=ax_w
        ).astype(jnp.int32)
        for dy in range(k)
        for dx in range(k)
    ]
    need = (k * k) // 2 + 1
    med = jnp.zeros_like(taps[0])
    for bit in range(7, -1, -1):
        thresh = med + ((1 << bit) - 1)
        cnt = sum((t <= thresh).astype(jnp.int32) for t in taps)
        med = jnp.where(cnt >= need, med, med + (1 << bit))
    return med.astype(jnp.uint8)


@jax.jit
def median3_u8(img: jax.Array) -> jax.Array:
    """3×3 median via a 9-element sorting/selection network (exact).

    Uses the classic min/max exchange network for the median of 9 — pure
    elementwise work, bit-exact vs golden.median3.
    """
    has_channels = img.ndim >= 3 and img.shape[-1] in (1, 3, 4)
    ax_h, ax_w = _spatial_axes(img, has_channels)
    p = _replicate_pad(_replicate_pad(img, ax_h, 1), ax_w, 1)
    h = img.shape[ax_h]
    w = img.shape[ax_w]
    t = []
    for dy in range(3):
        for dx in range(3):
            t.append(
                jax.lax.slice_in_dim(
                    jax.lax.slice_in_dim(p, dy, dy + h, axis=ax_h), dx, dx + w, axis=ax_w
                )
            )

    def ex(a, b):  # full compare-exchange: t[a] ≤ t[b] afterwards
        lo = jnp.minimum(t[a], t[b])
        hi = jnp.maximum(t[a], t[b])
        t[a], t[b] = lo, hi

    # Smith's median-of-9 exchange network (19 compare-exchanges).
    for a, b in (
        (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5),
        (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7),
        (4, 2), (6, 4), (4, 2),
    ):
        ex(a, b)
    return t[4]


@partial(jax.jit, static_argnames=("type",))
def threshold_u8(img: jax.Array, thresh: jax.Array, maxval: jax.Array, type: str = "binary") -> jax.Array:
    """Element-wise threshold, bit-exact vs golden.threshold; thresh/maxval
    are traced (changing them never recompiles)."""
    a = img.astype(jnp.int32)
    thresh = jnp.asarray(thresh, jnp.int32)
    maxval = jnp.asarray(maxval, jnp.int32)
    above = a > thresh
    if type == "binary":
        out = jnp.where(above, maxval, 0)
    elif type == "binary_inv":
        out = jnp.where(above, 0, maxval)
    elif type == "trunc":
        out = jnp.where(above, thresh, a)
    elif type == "tozero":
        out = jnp.where(above, a, 0)
    elif type == "tozero_inv":
        out = jnp.where(above, 0, a)
    else:
        raise ValueError(f"unknown threshold type {type!r}")
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("low", "high"))
def canny_u8(gray: jax.Array, low: int = 40, high: int = 90) -> jax.Array:
    """Canny edges on u8 gray (..., H, W) → u8 mask, bit-exact vs
    golden.canny (fully integer; see the frozen spec there)."""
    from .golden import CANNY_HYST_ROUNDS

    blurred = gaussian5_u8(gray, has_channels=False)
    gx, gy = sobel3_gray(blurred)
    mag = isqrt_exact(gx * gx + gy * gy)

    a = jnp.abs(gx)
    b = jnp.abs(gy)
    sector0 = (b << 16) <= a * 27146
    sector2 = (b << 16) >= a * 158218
    diag_main = (~sector0) & (~sector2) & (gx * gy >= 0)
    diag_anti = (~sector0) & (~sector2) & (gx * gy < 0)

    ax_h, ax_w = -2, -1
    pad = [(0, 0)] * (mag.ndim - 2) + [(1, 1), (1, 1)]
    p = jnp.pad(mag, pad)  # zeros
    h = mag.shape[ax_h]
    w = mag.shape[ax_w]

    def nb(dy, dx):
        sl = jax.lax.slice_in_dim(p, 1 + dy, 1 + dy + h, axis=ax_h)
        return jax.lax.slice_in_dim(sl, 1 + dx, 1 + dx + w, axis=ax_w)

    n1 = jnp.where(sector0, nb(0, -1), 0)
    n2 = jnp.where(sector0, nb(0, 1), 0)
    n1 = jnp.where(sector2, nb(-1, 0), n1)
    n2 = jnp.where(sector2, nb(1, 0), n2)
    n1 = jnp.where(diag_main, nb(-1, -1), n1)
    n2 = jnp.where(diag_main, nb(1, 1), n2)
    n1 = jnp.where(diag_anti, nb(-1, 1), n1)
    n2 = jnp.where(diag_anti, nb(1, -1), n2)
    nms = jnp.where((mag >= n1) & (mag >= n2), mag, 0)

    strong = (nms > high).astype(jnp.uint8)
    weak = (nms > low).astype(jnp.uint8)

    def grow(_, s):
        grown = _window_reduce(s * jnp.uint8(255), 3, jnp.maximum) > 0
        return jnp.where(weak.astype(bool) & grown, jnp.uint8(1), s)

    strong = jax.lax.fori_loop(0, CANNY_HYST_ROUNDS, grow, strong)
    return strong * jnp.uint8(255)


def _stackblur_mul_shr(r: int) -> tuple[int, int]:
    """StackBlur's fixed-point divider for div=(r+1)²: shr = 9 +
    floor(log2(div)), mul = ceil(2^shr / div) — reconstructs the classic
    stackblur table from its defining formula (no table copied)."""
    div = (r + 1) * (r + 1)
    shr = 9 + (div.bit_length() - 1)
    mul = -(-(1 << shr) // div)
    return mul, shr


def _tri_sum(a: jax.Array, axis: int, r: int) -> jax.Array:
    """Triangular-weighted sum Σ_{|i|≤r} (r+1−|i|)·a[x+i] with replicate
    border — computed as two box sums of length r+1 via cumsum (a triangle
    is box∗box), so cost is O(1) per pixel for any radius."""
    if r == 0:
        return a
    p = _replicate_pad(a, axis, r)
    n = a.shape[axis]
    c = jnp.cumsum(p, axis=axis)
    zero = jnp.zeros_like(jax.lax.slice_in_dim(c, 0, 1, axis=axis))
    c = jnp.concatenate([zero, c], axis=axis)  # c[i] = Σ p[:i]
    # box1 over window [j, j+r] of p → length n+r
    b1 = (jax.lax.slice_in_dim(c, r + 1, n + 2 * r + 1, axis=axis)
          - jax.lax.slice_in_dim(c, 0, n + r, axis=axis))
    c2 = jnp.cumsum(b1, axis=axis)
    c2 = jnp.concatenate([zero, c2], axis=axis)
    # box2 over window [j, j+r] of b1 → length n, centered triangle
    return (jax.lax.slice_in_dim(c2, r + 1, n + r + 1, axis=axis)
            - jax.lax.slice_in_dim(c2, 0, n, axis=axis))


@partial(jax.jit, static_argnames=("kw", "kh"))
def stack_blur_u8(img: jax.Array, kw: int, kh: int = None) -> jax.Array:  # type: ignore[assignment]
    """StackBlur (triangular separable, replicate border): per pass
    out = (tri_sum · mul) >> shr with the stackblur fixed-point divider.
    Exact vs golden.stack_blur_u8. vs OpenCV's cv2.stackBlur: OpenCV's
    SIMD body uses rounding shifts while its scalar tail truncates, so its
    exact bits are build/lane-position-dependent and unreproducible in
    principle; measured envelope ≤3 LSB at k≤13, ≤6 at k≤63, excluding
    the final column (a cv2 tail bug: up to 14 LSB off its own spec) and
    k ≥ min(H, W) (cv2's both-edge overhang is unspecified) — documented
    tolerance, tests/test_cv2_shim.py.

    kw/kh odd, ≤255 (int32 headroom: 255·(r+1)²·mul < 2³¹ at r=127)."""
    if kh is None:
        kh = kw
    rw, rh = kw // 2, kh // 2
    if kw % 2 == 0 or kh % 2 == 0 or kw > 255 or kh > 255:
        raise ValueError("stack_blur_u8: odd ksize ≤ 255 required")
    has_channels = img.ndim >= 3 and img.shape[-1] in (1, 3, 4)
    ax_h, ax_w = _spatial_axes(img, has_channels)
    a = img.astype(jnp.int32)
    mul, shr = _stackblur_mul_shr(rw)
    h = (_tri_sum(a, ax_w, rw) * mul) >> shr
    mul, shr = _stackblur_mul_shr(rh)
    v = (_tri_sum(h, ax_h, rh) * mul) >> shr
    return v.astype(jnp.uint8)


@partial(jax.jit, static_argnames=("ksize",))
def box_blur_u8(img: jax.Array, ksize: int = 3) -> jax.Array:
    """Box blur k×k (odd k), replicate border, rounded integer mean."""
    r = ksize // 2
    has_channels = img.ndim >= 3 and img.shape[-1] in (1, 3, 4)
    ax_h, ax_w = _spatial_axes(img, has_channels)
    a = img.astype(jnp.int32)
    ones = (1,) * ksize
    tmp = _taps(a, ax_w, ones, r)
    acc = _taps(tmp, ax_h, ones, r)
    n = ksize * ksize
    return ((acc + n // 2) // n).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("maxval", "method", "block", "c", "inv"))
def adaptive_threshold_u8(
    gray: jax.Array,
    maxval: int = 255,
    method: str = "mean",
    block: int = 11,
    c: int = 2,
    inv: bool = False,
) -> jax.Array:
    """Adaptive threshold — exact vs golden.adaptive_threshold. GRAY
    (…, H, W) input only: a trailing channel axis would silently box-mean
    across channels (the -1 axis)."""
    if gray.ndim >= 3 and gray.shape[-1] in (1, 3, 4):
        raise ValueError("adaptive_threshold_u8: gray (H, W) input required")
    a = gray.astype(jnp.int32)
    if method == "mean":
        r = block // 2
        ones = (1,) * block
        acc = _taps(_taps(a, -1, ones, r), -2, ones, r)
        n = block * block
        t = (acc + n // 2) // n
    elif method == "gaussian":
        t = gaussian5_u8(gray, has_channels=False).astype(jnp.int32)
    else:
        raise ValueError(f"unknown method {method!r} (mean, gaussian)")
    above = a > t - c
    if inv:
        above = ~above
    return jnp.where(above, maxval, 0).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("sigma",))
def bilateral5_u8(gray: jax.Array, sigma: int = 25) -> jax.Array:
    """5×5 bilateral filter — exact vs golden.bilateral5_u8.

    The frozen range kernel is an integer quadratic ramp (max(0, 64 −
    d²//S)), so the whole filter is 25 shifted views + elementwise
    arithmetic — no lookup gathers; the normalizing division is the
    f32-reciprocal exact floor divide (numerator ≤ 14.7M < 2^24)."""
    from .color import _div_floor_exact

    if gray.ndim >= 3 and gray.shape[-1] in (1, 3, 4):
        raise ValueError("bilateral5_u8: gray (H, W) input required")
    a = gray.astype(jnp.int32)
    h, w = a.shape[-2], a.shape[-1]
    p = jnp.pad(a, [(0, 0)] * (a.ndim - 2) + [(2, 2), (2, 2)], mode="edge")
    s_range = max(1, (2 * sigma * sigma) // 64)
    spatial = [[1, 4, 6, 4, 1][i] * [1, 4, 6, 4, 1][j] for i in range(5) for j in range(5)]
    num = jnp.zeros_like(a)
    den = jnp.zeros_like(a)
    for k, (dy, dx) in enumerate((i, j) for i in range(5) for j in range(5)):
        v = jax.lax.slice_in_dim(
            jax.lax.slice_in_dim(p, dy, dy + h, axis=-2), dx, dx + w, axis=-1
        )
        d = jnp.abs(v - a)
        wt = spatial[k] * jnp.maximum(0, 64 - (d * d) // s_range)
        num = num + wt * v
        den = den + wt
    out = _div_floor_exact(num + den // 2, den)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


@jax.jit
def laplacian3(gray: jax.Array) -> jax.Array:
    """3×3 Laplacian → int32, exact vs golden.laplacian3."""
    a = gray.astype(jnp.int32)
    up = _taps(a, -2, (1, 0, 0), 1)
    dn = _taps(a, -2, (0, 0, 1), 1)
    lf = _taps(a, -1, (1, 0, 0), 1)
    rt = _taps(a, -1, (0, 0, 1), 1)
    return up + dn + lf + rt - 4 * a


@jax.jit
def scharr3_gray(gray: jax.Array):
    """Scharr gx/gy on u8 gray (..., H, W) → int32 pair, exact vs golden."""
    a = gray.astype(jnp.int32)
    smooth_v = _taps(a, -2, (3, 10, 3), 1)
    gx = _taps(smooth_v, -1, (-1, 0, 1), 1)
    smooth_h = _taps(a, -1, (3, 10, 3), 1)
    gy = _taps(smooth_h, -2, (-1, 0, 1), 1)
    return gx, gy


MORPH_OPS = ("open", "close", "gradient", "tophat", "blackhat")


@partial(jax.jit, static_argnames=("op", "ksize"))
def morphology_ex_u8(img: jax.Array, op: str, ksize: int = 3) -> jax.Array:
    """Compound morphology (OpenCV ``morphologyEx`` role) — exact vs
    golden.morphology_ex; every difference is non-negative so u8 is safe."""
    if op == "open":
        return dilate_u8(erode_u8(img, ksize), ksize)
    if op == "close":
        return erode_u8(dilate_u8(img, ksize), ksize)
    if op == "gradient":
        out = dilate_u8(img, ksize).astype(jnp.int32) - erode_u8(img, ksize)
    elif op == "tophat":
        out = img.astype(jnp.int32) - morphology_ex_u8(img, "open", ksize)
    elif op == "blackhat":
        out = morphology_ex_u8(img, "close", ksize).astype(jnp.int32) - img
    else:
        raise ValueError(f"unknown morphology op {op!r} (one of {MORPH_OPS})")
    return out.astype(jnp.uint8)


def filter2d_u8(img: jax.Array, kernel) -> jax.Array:
    """Arbitrary-kernel correlation (OpenCV ``filter2D`` role), float32
    shifted-view accumulation + round-half-even saturate. Exact vs
    golden.filter2d for dyadic-rational kernels (integer/2^k taps keep f32
    accumulation exact); ±1 LSB for general float kernels. The kernel is
    a host (odd, odd) numpy array — its values are baked into the program
    and rank-1 kernels take a separable fast path (pass distinct kernels
    sparingly; each value set compiles its own program)."""
    import numpy as np  # kernel is host-static

    k = np.ascontiguousarray(kernel, np.float64)
    if k.ndim != 2 or k.shape[0] % 2 == 0 or k.shape[1] % 2 == 0:
        raise ValueError("kernel must be 2-D with odd sides")
    return _filter2d_for(k.tobytes(), k.shape)(img)


@lru_cache(maxsize=64)
def _filter2d_for(kbytes: bytes, kshape):
    import numpy as np

    k = np.frombuffer(kbytes, np.float64).reshape(kshape)
    kh, kw = kshape
    # separable fast path when the kernel is rank-1 (within f64 eps)
    u, s, vt = np.linalg.svd(k)
    rank1 = s[1:].max(initial=0.0) < 1e-12 * max(s[0], 1e-30)

    @jax.jit
    def fn(img):
        has_channels = img.ndim >= 3 and img.shape[-1] in (1, 3, 4)
        ax_h, ax_w = _spatial_axes(img, has_channels)
        f = img.astype(jnp.float32)
        if rank1:
            ky = tuple(float(x) for x in u[:, 0] * np.sqrt(s[0]))
            kx = tuple(float(x) for x in vt[0] * np.sqrt(s[0]))
            acc = _taps(_taps(f, ax_w, kx, kw // 2), ax_h, ky, kh // 2)
        else:
            ry, rx = kh // 2, kw // 2
            p = _replicate_pad(_replicate_pad(f, ax_h, ry), ax_w, rx)
            h, w = img.shape[ax_h], img.shape[ax_w]
            acc = None
            for dy in range(kh):
                for dx in range(kw):
                    wgt = float(k[dy, dx])
                    if wgt == 0.0:
                        continue
                    sl = jax.lax.slice_in_dim(
                        jax.lax.slice_in_dim(p, dy, dy + h, axis=ax_h),
                        dx, dx + w, axis=ax_w)
                    acc = wgt * sl if acc is None else acc + wgt * sl
            if acc is None:
                acc = jnp.zeros_like(f)
        r = jnp.round(acc)  # round half to even, matching np.rint
        return jnp.clip(r, 0, 255).astype(jnp.uint8)

    return fn


@jax.jit
def integral_u8(img: jax.Array) -> jax.Array:
    """Summed-area table (H+1, W+1) int32 with zero top row/left column —
    matches golden.integral for images where H*W*255 < 2^31 (up to 4K);
    the facade falls back to the host oracle beyond that."""
    if img.ndim != 2:
        raise ValueError("integral expects a single-channel (H, W) image")
    s = jnp.cumsum(jnp.cumsum(img.astype(jnp.int32), axis=0), axis=1)
    return jnp.pad(s, ((1, 0), (1, 0)))


@partial(jax.jit, static_argnames=("has_channels",))
def pyr_up(img: jax.Array, has_channels: bool = None) -> jax.Array:  # type: ignore[assignment]
    """Pyramid upsample to (2H, 2W): polyphase binomial on the source
    (even = [1,6,1], odd = [4,4] per axis; replicate border), interleaved
    by stack+reshape - no scatter, no zero-stuffed intermediate. Exact vs
    golden.pyr_up; constant images stay constant including borders."""
    if has_channels is None:
        has_channels = img.ndim >= 3 and img.shape[-1] in (1, 3, 4)
    ax_h, ax_w = _spatial_axes(img, has_channels)
    ax_h = ax_h % img.ndim
    ax_w = ax_w % img.ndim

    def up_axis(a, axis):
        n = a.shape[axis]
        p = _replicate_pad(a, axis, 1)
        left = jax.lax.slice_in_dim(p, 0, n, axis=axis)
        right = jax.lax.slice_in_dim(p, 2, n + 2, axis=axis)
        even = left + 6 * a + right
        odd = 4 * (a + right)
        out = jnp.stack([even, odd], axis=axis + 1)
        shape = list(a.shape)
        shape[axis] *= 2
        return out.reshape(shape)

    acc = up_axis(up_axis(img.astype(jnp.int32), ax_w), ax_h)
    return jnp.clip((acc + 32) >> 6, 0, 255).astype(jnp.uint8)


def get_structuring_element(shape: str, ksize: int):
    """Morphology kernels (OpenCV ``getStructuringElement``): bool
    (k, k) numpy mask. shape: "rect" (all ones), "cross" (center row +
    column), "ellipse" (inscribed disc, the OpenCV inclusion rule:
    |dx| <= r·sqrt(1-(dy/r)^2) rounded)."""
    import numpy as np

    if ksize < 1 or ksize % 2 == 0:
        raise ValueError("ksize must be odd and positive")
    r = ksize // 2
    if shape == "rect":
        return np.ones((ksize, ksize), bool)
    if shape == "cross":
        m = np.zeros((ksize, ksize), bool)
        m[r, :] = True
        m[:, r] = True
        return m
    if shape == "ellipse":
        m = np.zeros((ksize, ksize), bool)
        rr = max(r, 1)
        for dy in range(-r, r + 1):
            t = 1.0 - (dy / rr) ** 2
            dx = int(round(rr * np.sqrt(max(t, 0.0)))) if r > 0 else 0
            m[dy + r, r - dx : r + dx + 1] = True
        return m
    raise ValueError(f"unknown shape {shape!r} (rect, cross, ellipse)")


def _masked_window_reduce(img: jax.Array, kernel, fn) -> jax.Array:
    """Windowed reduce over only the True offsets of ``kernel`` (any kh×kw)."""
    import numpy as np

    k = np.asarray(kernel, bool)
    kh, kw = k.shape
    has_channels = img.ndim >= 3 and img.shape[-1] in (1, 3, 4)
    ax_h, ax_w = _spatial_axes(img, has_channels)
    p = _replicate_pad(_replicate_pad(img, ax_h, kh // 2), ax_w, kw // 2)
    h = img.shape[ax_h]
    w = img.shape[ax_w]
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            if not k[dy, dx]:
                continue
            sl = jax.lax.slice_in_dim(
                jax.lax.slice_in_dim(p, dy, dy + h, axis=ax_h),
                dx, dx + w, axis=ax_w)
            acc = sl if acc is None else fn(acc, sl)
    if acc is None:
        raise ValueError("structuring element has no True cells")
    return acc


def erode_kernel_u8(img: jax.Array, kernel) -> jax.Array:
    """Erosion over an arbitrary structuring element (host bool mask,
    baked into the program) — exact vs golden.erode_kernel."""
    return _morph_kernel_jit(np.asarray(kernel, bool).tobytes(),
                             np.asarray(kernel).shape, "erode")(img)


def dilate_kernel_u8(img: jax.Array, kernel) -> jax.Array:
    """Dilation over an arbitrary structuring element."""
    return _morph_kernel_jit(np.asarray(kernel, bool).tobytes(),
                             np.asarray(kernel).shape, "dilate")(img)


@lru_cache(maxsize=64)
def _morph_kernel_jit(kbytes: bytes, kshape, op: str):
    import numpy as np

    k = np.frombuffer(kbytes, bool).reshape(kshape)
    fn = jnp.minimum if op == "erode" else jnp.maximum

    @jax.jit
    def run(img):
        return _masked_window_reduce(img, k, fn)

    return run


# ---------------------------------------------------------------------------
# Generic directional derivatives (OpenCV ``Sobel``/``getDerivKernels``)
# ---------------------------------------------------------------------------

def deriv_kernels(dx: int, dy: int, ksize: int):
    """Integer separable Sobel kernels (kx, ky) for derivative orders
    (dx, dy), odd ``ksize`` ≥ 3 (OpenCV ``getDerivKernels`` role):
    binomial smoothing row convolved ``order`` times with [-1, 0, 1]
    (each derivative application keeps length by using the [1, 1]
    pascal step then differencing — the classic Sobel construction:
    ksize 3, order 1 → [-1, 0, 1]; order 0 → [1, 2, 1])."""
    if ksize % 2 == 0 or ksize < 3:
        raise ValueError("ksize must be odd and >= 3")
    if dx + dy < 1 or dx > 2 or dy > 2:
        raise ValueError("derivative orders must satisfy 1 <= dx+dy, <= 2 each")

    def kernel(order: int):
        # binomial smoothing (ksize-1-order steps of ⊛[1,1]) then the
        # derivative (order steps of ⊛[-1,1]) — lengths add to ksize;
        # ksize 3: order 0 → [1,2,1], order 1 → [-1,0,1], 2 → [1,-2,1]
        k = np.array([1.0])
        for _ in range(ksize - 1 - order):
            k = np.convolve(k, [1.0, 1.0])
        for _ in range(order):
            k = np.convolve(k, [-1.0, 1.0])
        return k.astype(np.int64)

    return kernel(dx), kernel(dy)


def sobel_xy_numpy(gray: np.ndarray, dx: int, dy: int,
                   ksize: int = 3) -> np.ndarray:
    """Oracle — exact int64 separable application, replicate border."""
    kx, ky = deriv_kernels(dx, dy, ksize)
    a = np.asarray(gray, np.int64)
    r = ksize // 2
    p = np.pad(a, ((0, 0), (r, r)), mode="edge")
    out = np.zeros_like(a)
    for k, w in enumerate(kx):            # correlation (OpenCV filter2D)
        if w:
            out += w * p[:, k:k + a.shape[1]]
    p = np.pad(out, ((r, r), (0, 0)), mode="edge")
    out2 = np.zeros_like(a)
    for k, w in enumerate(ky):
        if w:
            out2 += w * p[k:k + a.shape[0], :]
    return out2


@partial(jax.jit, static_argnames=("dx", "dy", "ksize"))
def sobel_xy(gray: jax.Array, dx: int, dy: int,
             ksize: int = 3) -> jax.Array:
    """Device twin — int32 exact (values bounded by 255·4^(ksize-1))."""
    kx, ky = deriv_kernels(dx, dy, ksize)
    r = ksize // 2
    a = gray.astype(jnp.int32)
    out = _taps(a, -1, tuple(int(w) for w in kx), r)
    return _taps(out, -2, tuple(int(w) for w in ky), r)
