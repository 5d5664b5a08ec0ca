"""imgproc — drawing primitives and image processing (OpenCV-style API).

Reference surface: ``rustcv/src/imgproc/mod.rs:1-4`` re-exports
``{Point, Rect, Scalar, rectangle, put_text}`` from ``drawing.rs``. We add the
processing ops the BASELINE configs require (resize, blurs, Sobel, Harris) —
the reference has no equivalents, so their specs are frozen in ops/golden.py.

In-place semantics preserved: ``rectangle(mat, …)`` mutates the Mat like the
reference (``drawing.rs:67``). If the Mat currently lives on device, the draw
is executed there functionally and the device handle is swapped — no D2H.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.mat import Mat
from ..ops import golden
from ..ops import text as _text


@dataclass(frozen=True)
class Point:
    """Integer pixel coordinate (drawing.rs:8-17)."""

    x: int
    y: int


@dataclass(frozen=True)
class Rect:
    """x/y/width/height rectangle (drawing.rs:19-36)."""

    x: int
    y: int
    width: int
    height: int


@dataclass(frozen=True)
class Scalar:
    """BGR color triple (drawing.rs:38-58)."""

    v0: int  # Blue
    v1: int  # Green
    v2: int  # Red

    @classmethod
    def new(cls, b: int, g: int, r: int) -> "Scalar":
        return cls(b, g, r)

    @classmethod
    def all(cls, v: int) -> "Scalar":
        return cls(v, v, v)

    @property
    def bgr(self):
        return (self.v0, self.v1, self.v2)


def _draw_packed_inplace(mat: Mat, device_fn, host_mask_fn, color) -> None:
    """Shared in-place drawing: device path draws on packed rows; host path
    paints the golden mask (identical bytes). BGR (3-channel) Mats only —
    packed-rows math would silently misinterpret gray layouts."""
    import numpy as np

    if mat.is_empty():
        return
    if mat.channels != 3:
        raise ValueError(
            f"drawing requires a 3-channel BGR Mat (got {mat.channels} channels)"
        )
    bgr = np.asarray(color.bgr if isinstance(color, Scalar) else color, np.uint8)
    if mat.is_on_device:
        d = mat.device()
        packed = d.reshape(*d.shape[:-2], d.shape[-2] * d.shape[-1])
        out = device_fn(packed)
        mat.set_device(out.reshape(d.shape))
        return
    h, w = mat.rows, mat.cols
    mask = host_mask_fn(h, w)
    mat.array[mask > 0] = bgr  # writable host view, in place


def line(mat: Mat, p1: Point, p2: Point, color: Scalar, thickness: int = 1) -> None:
    """Draw a line segment in place (OpenCV ``line``; exact integer
    distance-field spec, golden.line_mask — device and host identical)."""
    from ..ops import draw as _draw

    _draw_packed_inplace(
        mat,
        lambda packed: _draw.line_packed(
            packed, (p1.x, p1.y), (p2.x, p2.y), color.bgr, thickness
        ),
        lambda h, w: golden.line_mask(h, w, (p1.x, p1.y), (p2.x, p2.y), thickness),
        color,
    )


def circle(mat: Mat, center: Point, radius: int, color: Scalar,
           thickness: int = 1) -> None:
    """Draw a circle in place (OpenCV ``circle``; thickness < 0 fills)."""
    from ..ops import draw as _draw

    _draw_packed_inplace(
        mat,
        lambda packed: _draw.circle_packed(
            packed, (center.x, center.y), radius, color.bgr, thickness
        ),
        lambda h, w: golden.circle_mask(h, w, (center.x, center.y), radius, thickness),
        color,
    )


def polylines(mat: Mat, pts, color: Scalar, thickness: int = 1,
              closed: bool = False) -> None:
    """Draw connected segments through ``pts`` [K, 2] (x, y) (OpenCV
    ``polylines`` role; per-segment golden.line_mask spec)."""
    import numpy as np

    p = np.asarray(pts, np.int64).reshape(-1, 2)
    for i in range(len(p) - 1):
        line(mat, Point(int(p[i][0]), int(p[i][1])),
             Point(int(p[i + 1][0]), int(p[i + 1][1])), color, thickness)
    if closed and len(p) > 2:
        line(mat, Point(int(p[-1][0]), int(p[-1][1])),
             Point(int(p[0][0]), int(p[0][1])), color, thickness)


def ellipse(mat: Mat, center: Point, axes, angle: float, color: Scalar,
            thickness: int = 1) -> None:
    """Draw a rotated ellipse in place (OpenCV ``ellipse`` full-arc role;
    frozen float64 spec golden.ellipse_mask). The mask is computed on the
    host and painted on device (put_text precedent) — identical bytes on
    both paths. ``thickness < 0`` fills."""
    from ..ops import draw as _draw

    if mat.is_empty():
        return
    mask = golden.ellipse_mask(
        mat.rows, mat.cols, (center.x, center.y),
        (int(axes[0]), int(axes[1])), angle, thickness,
    )
    _draw_packed_inplace(
        mat,
        lambda packed: _draw.paint_mask_packed(packed, mask, color.bgr),
        lambda h, w: mask,
        color,
    )


def fill_poly(mat: Mat, pts, color: Scalar) -> None:
    """Fill a polygon in place (OpenCV ``fillPoly`` single-polygon role;
    exact-integer even-odd spec golden.fill_poly_mask — device and host
    bit-identical, boundary included)."""
    import numpy as np

    from ..ops import draw as _draw

    p = np.asarray(pts, np.int32).reshape(-1, 2)
    _draw_packed_inplace(
        mat,
        lambda packed: _draw.fill_poly_packed(packed, p, color.bgr),
        lambda h, w: golden.fill_poly_mask(h, w, p),
        color,
    )


def arrowed_line(mat: Mat, p1: Point, p2: Point, color: Scalar,
                 thickness: int = 1, tip_length: float = 0.1) -> None:
    """Arrow from p1 to p2 (OpenCV ``arrowedLine``): the shaft plus two
    head strokes at ±π/4 off the reverse direction, head length
    ``tip_length``·|p2−p1| (endpoints rounded half-away like OpenCV)."""
    import math

    line(mat, p1, p2, color, thickness)
    dx, dy = p1.x - p2.x, p1.y - p2.y
    L = math.hypot(dx, dy)
    if L == 0:
        return
    tip = tip_length * L
    ang = math.atan2(dy, dx)
    for da in (math.pi / 4, -math.pi / 4):
        hx = int(math.floor(p2.x + tip * math.cos(ang + da) + 0.5))
        hy = int(math.floor(p2.y + tip * math.sin(ang + da) + 0.5))
        line(mat, Point(hx, hy), p2, color, thickness)


def draw_contours(mat: Mat, contours, contour_idx: int, color: Scalar,
                  thickness: int = 1) -> None:
    """Draw contours in place (OpenCV ``drawContours`` role):
    ``contour_idx < 0`` draws all; ``thickness < 0`` fills each polygon
    (fill_poly spec), else strokes it closed (polylines spec)."""
    sel = contours if contour_idx < 0 else [contours[contour_idx]]
    for c in sel:
        import numpy as np

        p = np.asarray(c, np.int64).reshape(-1, 2)
        if len(p) < 2:
            continue
        if thickness < 0 and len(p) >= 3:
            fill_poly(mat, p, color)
        else:
            polylines(mat, p, color, max(thickness, 1), closed=True)


def rectangle(mat: Mat, rect: Rect, color: Scalar, thickness: int = 1) -> None:
    """Draw a rectangle outline in place (drawing.rs:67-106 semantics)."""
    if mat.is_empty():
        return
    if mat.is_on_device:
        import jax.numpy as jnp

        from ..ops import draw as _draw

        out = _draw.rectangle(
            mat.device(),
            jnp.asarray([rect.x, rect.y, rect.width, rect.height], jnp.int32),
            jnp.asarray(color.bgr, jnp.uint8),
            thickness,
        )
        mat.set_device(out)
        return
    golden.rectangle(
        mat.data, mat.rows, mat.cols, mat.step,
        (rect.x, rect.y, rect.width, rect.height), color.bgr, thickness,
    )


def put_text(mat: Mat, text: str, org: Point, font_scale: float, color: Scalar) -> None:
    """Render text with ``org`` as the baseline origin (drawing.rs:123-163)."""
    if mat.is_empty():
        return
    mask, dx, dy = _text.rasterize(text, font_scale)
    if mat.is_on_device:
        import jax.numpy as jnp

        from ..ops import draw as _draw

        out = _draw.blend_mask_at(
            mat.device(), jnp.asarray(mask), org.x + dx, org.y + dy,
            jnp.asarray(color.bgr, jnp.int32),
        )
        mat.set_device(out)
        return
    golden.blend_mask(mat.array, mask, org.x + dx, org.y + dy, color.bgr)


# ---------------------------------------------------------------------------
# Processing ops (device-backed when the Mat lives on device)
# ---------------------------------------------------------------------------


def _apply(mat: Mat, device_fn, host_fn) -> Mat:
    if mat.is_on_device:
        return Mat.from_device(device_fn(mat.device()))
    return Mat.from_array(host_fn(mat.to_numpy()))


def _gray_of_mat(mat: Mat, allow_bgr: bool = True):
    """Single-channel array of a Mat — device-resident arrays stay on
    device. BGR inputs convert via the exact luma when ``allow_bgr``,
    otherwise raise (ops whose spec is gray-only)."""
    a = mat.device() if mat.is_on_device else mat.to_numpy()
    if a.ndim == 3 and a.shape[-1] == 1:
        return a[..., 0]
    if a.ndim == 3 and a.shape[-1] == 3:
        if not allow_bgr:
            raise ValueError("gray (single-channel) input required")
        if mat.is_on_device:
            from ..ops import color as _color

            return _color.bgr_to_gray(a)
        return golden.bgr_to_gray(a)
    if a.ndim != 2:
        raise ValueError(f"unsupported Mat shape {a.shape}")
    return a


def resize(mat: Mat, width: int, height: int, interpolation: str = "bilinear") -> Mat:
    """Resize with a frozen spec per mode (OpenCV's INTER_* trio):
    "bilinear" (11-bit fixed-point, golden.resize_bilinear), "nearest"
    (half-pixel-center taps), "area" (exact box mean for integer
    downscales, bilinear otherwise)."""
    from ..ops import resize as _resize

    fns = {
        "bilinear": (_resize.resize_bilinear, golden.resize_bilinear),
        "nearest": (_resize.resize_nearest, golden.resize_nearest),
        "area": (_resize.resize_area, golden.resize_area),
        "cubic": (_resize.resize_bicubic, golden.resize_bicubic),
    }
    if interpolation not in fns:
        raise ValueError(
            f"unknown interpolation {interpolation!r} "
            "(bilinear, nearest, area, cubic)"
        )
    dev, host = fns[interpolation]
    return _apply(
        mat,
        lambda d: dev(d, width, height),
        lambda h: host(h, width, height),
    )


def gaussian_blur(mat: Mat, ksize: int = 5, sigma: float = -1.0) -> Mat:
    """Gaussian blur, replicate border. The default 5×5 runs the frozen
    integer spec (golden.gaussian5_u8); other ``ksize``/``sigma`` route
    through get_gaussian_kernel + sep_filter_2d (float-kernel path,
    ±1 LSB)."""
    from ..ops import filters as _filters

    if ksize == 5 and sigma < 0:
        return _apply(mat, _filters.gaussian5_u8, golden.gaussian5_u8)
    k = get_gaussian_kernel(ksize, sigma)
    return sep_filter_2d(mat, k, k)


def adaptive_threshold(mat: Mat, maxval: int = 255, method: str = "mean",
                       block: int = 11, c: int = 2, inv: bool = False) -> Mat:
    """OpenCV ``adaptiveThreshold``: T = neighborhood mean (k×k box; or
    the 5×5 Gaussian spec) − c; GRAY input only (frozen spec,
    host==device; a BGR Mat raises — the spec is single-channel)."""
    from ..ops import filters as _filters

    g = _gray_of_mat(mat, allow_bgr=False)
    if mat.is_on_device:
        return Mat.from_device(
            _filters.adaptive_threshold_u8(g, maxval, method, block, c, inv)
        )
    return Mat.from_array(golden.adaptive_threshold(g, maxval, method, block, c, inv))


def bilateral_filter(mat: Mat, sigma: int = 25) -> Mat:
    """Edge-preserving 5×5 bilateral filter (OpenCV ``bilateralFilter``
    role; integer quadratic-ramp range kernel — see ops/golden.py). GRAY
    input only."""
    from ..ops import filters as _filters

    g = _gray_of_mat(mat, allow_bgr=False)
    if mat.is_on_device:
        return Mat.from_device(_filters.bilateral5_u8(g, sigma))
    return Mat.from_array(golden.bilateral5_u8(g, sigma))


def pyr_down(mat: Mat) -> Mat:
    """Image-pyramid downsample: 5×5 Gaussian + even-index decimation
    (OpenCV pyrDown shape semantics; golden.pyr_down)."""
    from ..ops import filters as _filters

    return _apply(mat, _filters.pyr_down, golden.pyr_down)


def pyr_up(mat: Mat) -> Mat:
    """Image-pyramid upsample to (2H, 2W): zero-stuff + 5×5 binomial
    with ×4 gain (OpenCV pyrUp role; golden.pyr_up)."""
    from ..ops import filters as _filters

    return _apply(mat, _filters.pyr_up, golden.pyr_up)


def stack_blur(mat: Mat, kw: int, kh: int = None) -> Mat:
    """StackBlur (separable triangular, replicate border, stackblur
    fixed-point divider) — frozen spec golden.stack_blur_u8; OpenCV
    tolerance documented there (cv2.stackBlur's exact bits are
    SIMD-lane-position-dependent)."""
    from ..ops import filters as _filters

    if kh is None:
        kh = kw
    return _apply(mat, lambda d: _filters.stack_blur_u8(d, kw, kh),
                  lambda h: golden.stack_blur_u8(h, kw, kh))


def box_blur(mat: Mat, ksize: int = 3) -> Mat:
    from ..ops import filters as _filters

    def host(h):
        a = h.astype(np.int64)
        r = ksize // 2
        p = np.pad(a, [(r, r), (r, r)] + [(0, 0)] * (a.ndim - 2), mode="edge")
        acc = np.zeros_like(a)
        hh, ww = h.shape[:2]
        for dy in range(ksize):
            for dx in range(ksize):
                acc += p[dy : dy + hh, dx : dx + ww]
        n = ksize * ksize
        return ((acc + n // 2) // n).astype(np.uint8)

    return _apply(mat, lambda d: _filters.box_blur_u8(d, ksize), host)


def cvt_gray(mat: Mat) -> Mat:
    """BGR → gray (integer BT.601 luma)."""
    from ..ops import color as _color

    return _apply(mat, _color.bgr_to_gray, golden.bgr_to_gray)


def cvt_hsv(mat: Mat) -> Mat:
    """BGR → HSV u8 (OpenCV 8-bit convention, H ∈ [0, 180)) — exact
    all-integer spec (golden.bgr_to_hsv); device and host agree
    bit-for-bit."""
    from ..ops import color as _color

    return _apply(mat, _color.bgr_to_hsv, golden.bgr_to_hsv)


def cvt_hsv_to_bgr(mat: Mat) -> Mat:
    """HSV u8 (H ∈ [0, 180)) → BGR — frozen integer spec
    (golden.hsv_to_bgr); round-trips cvt_hsv within ±4 LSB (H is
    quantized to 2°, so an exact inverse does not exist)."""
    from ..ops import color as _color

    return _apply(mat, _color.hsv_to_bgr, golden.hsv_to_bgr)


def cvt_ycrcb(mat: Mat) -> Mat:
    """BGR → YCrCb u8 (OpenCV 8-bit convention, 14-bit fixed-point
    constants) — exact integer spec (golden.bgr_to_ycrcb)."""
    from ..ops import color as _color

    return _apply(mat, _color.bgr_to_ycrcb, golden.bgr_to_ycrcb)


def cvt_ycrcb_to_bgr(mat: Mat) -> Mat:
    """YCrCb u8 → BGR — exact integer spec (golden.ycrcb_to_bgr)."""
    from ..ops import color as _color

    return _apply(mat, _color.ycrcb_to_bgr, golden.ycrcb_to_bgr)


def cvt_lab(mat: Mat) -> Mat:
    """BGR → CIE L*a*b* u8 (OpenCV 8-bit convention; frozen float spec
    golden.bgr_to_lab, device within ±1 LSB — documented tolerance)."""
    from ..ops import color as _color

    return _apply(mat, _color.bgr_to_lab, golden.bgr_to_lab)


def cvt_lab_to_bgr(mat: Mat) -> Mat:
    """Lab u8 → BGR (golden.lab_to_bgr, ±1 LSB device tolerance)."""
    from ..ops import color as _color

    return _apply(mat, _color.lab_to_bgr, golden.lab_to_bgr)


def in_range(mat: Mat, lower, upper) -> Mat:
    """Per-channel inclusive range mask → u8 {0, 255} Mat (OpenCV
    ``inRange``); compose with :func:`cvt_hsv` for color segmentation."""
    from ..ops import color as _color

    return _apply(
        mat,
        lambda d: _color.in_range(d, lower, upper),
        lambda h: golden.in_range(h, lower, upper),
    )


def moments(mat: Mat) -> dict:
    """Raw spatial moments m00/m10/m01 (+ centroid when nonempty) of a u8
    mask/gray Mat (OpenCV ``moments``). Exact: device path reduces per-row
    partials on-device and finishes in host int64."""
    from ..ops import color as _color

    if mat.is_on_device:
        return _color.moments(mat.device())
    return golden.moments(mat.to_numpy())


def fast_corners(
    mat: Mat, threshold: int = 20, n: int = 9, max_corners: int = 256,
    nms: bool = True,
):
    """FAST-n corner detection (features2d ``FastFeatureDetector`` role):
    float32 [K, 2] (x, y) points, strongest first. Pure elementwise on
    device — 16 static ring shifts + the rotate-AND contiguity trick
    (ops/fast.py); host path runs the identical frozen spec."""
    import numpy as np

    from ..ops import fast as _fast

    g = _gray_of_mat(mat)
    if mat.is_on_device:
        coords, valid = _fast.fast_corner_list(
            g, threshold=threshold, n=n, max_corners=max_corners, nms=nms
        )
        coords = np.asarray(coords)[np.asarray(valid)]
    else:
        mask, score = _fast.fast_corners_numpy(
            g, threshold=threshold, n=n, nms=nms
        )
        ys, xs = np.nonzero(mask)
        order = np.argsort(-score[ys, xs], kind="stable")[:max_corners]
        coords = np.stack([ys[order], xs[order]], axis=-1)
    return coords[:, ::-1].astype(np.float32)


def compute_brief(mat: Mat, pts):
    """BRIEF-256 descriptors at float32 (x, y) keypoints → (u32 [K, 8],
    valid bool [K]); upright (no orientation), frozen pair pattern —
    ops/brief.py. Pair with :func:`fast_corners` /
    :func:`good_features_to_track` and :func:`match_descriptors`."""
    import numpy as np

    from ..ops import brief as _brief

    pts = np.asarray(pts, np.float32).reshape(-1, 2)
    g = _gray_of_mat(mat)
    if mat.is_on_device:
        desc, valid = _brief.brief_descriptors(g, pts)
        return np.asarray(desc), np.asarray(valid)
    return _brief.brief_descriptors_numpy(g, pts)


def match_descriptors(d1, d2, valid1=None, valid2=None, ratio: float = 0.8):
    """Hamming matching (±1 matmul + Lowe ratio + cross-check) →
    int32 [M, 2] (index-into-d1, index-into-d2). See ops/brief.py."""
    from ..ops.brief import match_descriptors as _m

    return _m(d1, d2, valid1, valid2, ratio)


def corner_sub_pix(mat: Mat, pts, win: int = 11, iters: int = 10):
    """Sub-pixel corner refinement (OpenCV ``cornerSubPix``): float32
    [K, 2] (x, y) in → refined out. All points refine in one vmapped
    device program (ops/features.corner_sub_pix)."""
    import numpy as np

    from ..ops import features as _features

    pts = np.asarray(pts, np.float32).reshape(-1, 2)
    g = _gray_of_mat(mat)
    return np.asarray(_features.corner_sub_pix(g, pts, win=win, iters=iters))


def good_features_to_track(mat: Mat, max_corners: int = 256, **kw):
    """Corner seeds for tracking (OpenCV ``goodFeaturesToTrack`` role,
    Harris scoring): returns float32 [K, 2] (x, y) points, K ≤ max_corners
    (jit path returns a fixed top-K + validity; invalid rows dropped)."""
    import numpy as np

    from ..ops import features as _features

    gray = _gray_of_mat(mat)
    if mat.is_on_device:
        coords, valid = _features.harris_corner_list(
            gray, max_corners=max_corners, **kw
        )
        coords = np.asarray(coords)[np.asarray(valid)]
    else:
        mask = golden.harris_corners(gray, **kw)
        # Rank with the SAME fixed-point response the mask used; stable sort
        # so integer ties break by flat index ascending, exactly like the
        # device path's lax.top_k.
        resp = golden.harris_response_i32(
            gray, k_num=int(round(kw.get("k", 0.04) * 1024))
        )
        ys, xs = np.nonzero(mask)
        order = np.argsort(-resp[ys, xs], kind="stable")[:max_corners]
        coords = np.stack([ys[order], xs[order]], axis=-1)
    # (y, x) → (x, y)
    return coords[:, ::-1].astype(np.float32)


def good_features_to_track_with_quality(mat: Mat, max_corners: int = 256,
                                        **kw):
    """OpenCV ``goodFeaturesToTrackWithQuality`` role → (points
    float32 [K, 2] (x, y), quality float32 [K] — the fixed-point
    Harris response at each corner)."""
    import numpy as np

    pts = good_features_to_track(mat, max_corners=max_corners, **kw)
    gray = _gray_of_mat(mat)
    g = np.asarray(gray)
    resp = golden.harris_response_i32(
        g, k_num=int(round(kw.get("k", 0.04) * 1024)))
    xs = pts[:, 0].astype(np.int64)
    ys = pts[:, 1].astype(np.int64)
    return pts, resp[ys, xs].astype(np.float32)


def calc_optical_flow_pyr_lk(
    prev: Mat, nxt: Mat, pts, win: int = 21, levels: int = 3, iters: int = 10
):
    """Pyramidal Lucas–Kanade sparse flow (OpenCV ``calcOpticalFlowPyrLK``):
    track float32 (x, y) points from ``prev`` to ``nxt``. Returns
    (next_pts [N, 2] float32, status [N] bool). Device path vectorizes all
    points' gauss-newton iterations in one program (ops/optflow.py)."""
    import numpy as np

    from ..ops import optflow as _of

    def _gray(m: Mat):
        # Device Mats STAY on device (no D2H+H2D round trip per call).
        if m.is_on_device:
            from ..ops import color as _color

            d = m.device()
            if d.ndim == 3 and d.shape[-1] == 3:
                return _color.bgr_to_gray(d)
            return d[..., 0] if d.ndim == 3 else d
        a = m.to_numpy()
        if a.ndim == 3 and a.shape[-1] == 3:
            return golden.bgr_to_gray(a)
        return a[..., 0] if a.ndim == 3 else a

    pts = np.asarray(pts, np.float32).reshape(-1, 2)
    if prev.is_on_device or nxt.is_on_device:
        import jax.numpy as jnp

        nxt_pts, st = _of.calc_optical_flow_pyr_lk(
            jnp.asarray(_gray(prev)), jnp.asarray(_gray(nxt)), jnp.asarray(pts),
            win=win, levels=levels, iters=iters,
        )
        return np.asarray(nxt_pts), np.asarray(st)
    nxt_pts, st = _of.calc_optical_flow_pyr_lk_numpy(
        _gray(prev), _gray(nxt), pts, win=win, levels=levels, iters=iters
    )
    return nxt_pts.astype(np.float32), st


def connected_components(mat: Mat, max_rounds: int = 256):
    """4-connectivity labeling of a u8 mask Mat (OpenCV
    ``connectedComponents``): (count, labels int32 (H, W)), background 0,
    components numbered in raster order of their first pixel. Device
    algorithm: segmented min-scans to a fixed point (ops/ccl.py) — no
    union-find pointer chasing."""
    from ..ops import ccl as _ccl

    a = mat.device() if mat.is_on_device else mat.to_numpy()
    if a.ndim == 3:
        a = a[..., 0]
    return _ccl.connected_components(a, max_rounds=max_rounds)


def connected_components_with_stats(mat: Mat, max_rounds: int = 256):
    """OpenCV ``connectedComponentsWithStats``: (count, labels, stats,
    centroids) — see :func:`connected_components` and ops/ccl.py."""
    from ..ops import ccl as _ccl

    a = mat.device() if mat.is_on_device else mat.to_numpy()
    if a.ndim == 3:
        a = a[..., 0]
    return _ccl.connected_components_with_stats(a, max_rounds=max_rounds)


def find_contours(mat: Mat, max_rounds: int = 256):
    """External contours of a u8 mask Mat (OpenCV ``findContours``
    RETR_EXTERNAL role): list of int32 [K, 2] (x, y) boundary polylines,
    one per 4-connected component (device labeling + host Moore tracing,
    work proportional to boundary length — ops/ccl.py)."""
    from ..ops import ccl as _ccl

    a = mat.device() if mat.is_on_device else mat.to_numpy()
    if a.ndim == 3:
        a = a[..., 0]
    return _ccl.find_contours(a, max_rounds=max_rounds)


def estimate_affine_partial_2d(src_pts, dst_pts, **kw):
    """RANSAC similarity estimation (OpenCV ``estimateAffinePartial2D``):
    (M 2×3 or None, inlier mask). See ops/geometry.py."""
    from ..ops.geometry import estimate_affine_partial_2d as _e

    return _e(src_pts, dst_pts, **kw)


def estimate_affine_2d(src_pts, dst_pts, **kw):
    """RANSAC full-affine estimation (OpenCV ``estimateAffine2D``)."""
    from ..ops.geometry import estimate_affine_2d as _e

    return _e(src_pts, dst_pts, **kw)


def distance_transform(mat: Mat) -> "np.ndarray":
    """Exact L1 (city-block) distance of each nonzero pixel to the nearest
    zero (OpenCV ``distanceTransform`` DIST_L1): int32 (H, W). Four
    tropical min-plus scans on device — no fixed-point iteration
    (ops/ccl.distance_transform_l1)."""
    from ..ops import ccl as _ccl

    g = _gray_of_mat(mat, allow_bgr=False)
    return _ccl.distance_transform_l1(g)


def flood_fill(mat: Mat, seed, new_val: int, lo_diff: int = 0, up_diff: int = 0):
    """OpenCV ``floodFill`` (fixed-range): returns (filled Mat, count,
    mask). See ops/ccl.flood_fill."""
    from ..ops import ccl as _ccl

    a = mat.device() if mat.is_on_device else mat.to_numpy()
    import numpy as np

    a = np.asarray(a)
    if a.ndim == 3:
        a = a[..., 0]
    out, count, mask = _ccl.flood_fill(a, seed, new_val, lo_diff, up_diff)
    return Mat.from_array(out), count, mask


def hu_moments(mat: Mat):
    """The seven Hu invariants of a u8 mask Mat (OpenCV ``HuMoments``)."""
    import numpy as np

    a = np.asarray(mat.device()) if mat.is_on_device else mat.to_numpy()
    return golden.hu_moments(a)


def match_shapes(mat_a: Mat, mat_b: Mat) -> float:
    """Shape-similarity distance from Hu moments (OpenCV ``matchShapes``
    I1 method; 0 = identical up to translation/scale/rotation)."""
    import numpy as np

    a = np.asarray(mat_a.device()) if mat_a.is_on_device else mat_a.to_numpy()
    b = np.asarray(mat_b.device()) if mat_b.is_on_device else mat_b.to_numpy()
    return golden.match_shapes(a, b)


def get_rotation_matrix_2d(center, angle_deg: float, scale: float = 1.0):
    """OpenCV ``getRotationMatrix2D`` (2×3 float64)."""
    from ..ops.warp import get_rotation_matrix_2d as _grm

    return _grm(tuple(center), angle_deg, scale)


def warp_affine(mat: Mat, m, dst_size, mode: str = "bilinear",
                border: str = "constant") -> Mat:
    """OpenCV ``warpAffine``: M (2×3) maps src→dst; ``dst_size`` = (w, h);
    bilinear (11-bit fixed-point, resize-spec rounding) or nearest;
    constant-0 or replicate border. M is folded into the compiled program
    (static per transform — see ops/warp.py)."""
    from ..ops import warp as _warp

    return _apply(
        mat,
        lambda d: _warp.warp_affine(d, m, dst_size, mode, border),
        lambda h: _warp.warp_affine_numpy(h, m, dst_size, mode, border),
    )


def get_perspective_transform(src_pts, dst_pts):
    """OpenCV ``getPerspectiveTransform`` (exact 4-point 3×3 homography)."""
    from ..ops.warp import get_perspective_transform as _g

    return _g(src_pts, dst_pts)


def warp_perspective(mat: Mat, h_mat, dst_size, mode: str = "bilinear",
                     border: str = "constant") -> Mat:
    """OpenCV ``warpPerspective``: 3×3 homography (src→dst), same
    fixed-point sampling spec and packed-quad gather as
    :func:`warp_affine` (ops/warp.py)."""
    from ..ops import warp as _warp

    return _apply(
        mat,
        lambda d: _warp.warp_perspective(d, h_mat, dst_size, mode, border),
        lambda h: _warp.warp_perspective_numpy(h, h_mat, dst_size, mode, border),
    )


def remap(mat: Mat, map_x, map_y, border: str = "constant") -> Mat:
    """OpenCV ``remap``: sample at float32 per-pixel source coordinates
    (the undistort/rectify primitive). Maps are traced arguments — new
    distortion fields never recompile; same fixed-point bilinear spec as
    warp_affine (ops/warp.remap)."""
    import numpy as np

    from ..ops import warp as _warp

    mx = np.asarray(map_x, np.float32)
    my = np.asarray(map_y, np.float32)
    return _apply(
        mat,
        lambda d: _warp.remap(d, mx, my, border),
        lambda h: _warp.remap_numpy(h, mx, my, border),
    )


def rotate(mat: Mat, angle_deg: float, center=None, scale: float = 1.0) -> Mat:
    """Rotate about ``center`` (default: image center) by ``angle_deg``
    (counter-clockwise for y-down images), same canvas size."""
    h, w = mat.rows, mat.cols
    if center is None:
        center = ((w - 1) / 2.0, (h - 1) / 2.0)
    m = get_rotation_matrix_2d(center, angle_deg, scale)
    return warp_affine(mat, m, (w, h))


def warp_polar(mat: Mat, center, max_radius: float, dst_size,
               semilog: bool = False, inverse: bool = False,
               border: str = "constant") -> Mat:
    """Polar/semilog-polar warp (OpenCV ``warpPolar`` role): rows =
    angle, cols = radius; ``inverse`` maps back to cartesian. Host map
    build + traced-map device remap (ops/warp.py polar spec)."""
    import numpy as np

    from ..ops import warp as _warp

    a = mat.device() if mat.is_on_device else mat.to_numpy()
    squeeze = a.ndim == 3 and a.shape[-1] == 1
    out = _warp.warp_polar(a[..., 0] if squeeze else a, center, max_radius,
                           dst_size, semilog, inverse, border)
    if squeeze:
        out = out[..., None]
    return Mat.from_device(out) if mat.is_on_device else Mat.from_array(
        np.asarray(out))


def linear_polar(mat: Mat, center, max_radius: float,
                 inverse: bool = False) -> Mat:
    """Legacy OpenCV ``linearPolar`` (dst = src size)."""
    return warp_polar(mat, center, max_radius, (mat.rows, mat.cols),
                      False, inverse)


def log_polar(mat: Mat, center, max_radius: float,
              inverse: bool = False) -> Mat:
    """Legacy OpenCV ``logPolar`` (semilog radius axis, dst = src size)."""
    return warp_polar(mat, center, max_radius, (mat.rows, mat.cols),
                      True, inverse)


def calc_hist(mat: Mat):
    """256-bin histogram (int32 counts) of a u8 gray Mat (BGR inputs are
    converted via the exact luma) — OpenCV ``calcHist`` for the common
    single-channel case. Device path: scatter-free (ops/hist.py)."""
    import numpy as np

    from ..ops import hist as _hist

    if mat.is_on_device:
        d = mat.device()
        if d.ndim == 3 and d.shape[-1] == 3:
            from ..ops import color as _color

            d = _color.bgr_to_gray(d)
        return np.asarray(_hist.calc_hist(d))
    h = mat.to_numpy()
    if h.ndim == 3 and h.shape[-1] == 3:
        h = golden.bgr_to_gray(h)
    return _hist.calc_hist_numpy(h)


def equalize_hist(mat: Mat) -> Mat:
    """Histogram equalization of a u8 gray Mat (OpenCV ``equalizeHist``,
    exact-integer frozen spec — device and host agree bit-for-bit)."""
    from ..ops import hist as _hist

    def _gray(a):
        if a.ndim == 3 and a.shape[-1] == 1:
            return a[..., 0]
        if a.ndim != 2:
            raise ValueError("equalize_hist: gray (single-channel) input required")
        return a

    return _apply(
        mat,
        lambda d: _hist.equalize_hist(_gray(d)),
        lambda h: _hist.equalize_hist_numpy(_gray(h)),
    )


def hough_lines(mat: Mat, threshold: int = 50, max_lines: int = 32,
                n_thetas: int = 180, rho_bins: int = 2048,
                max_points: int = None):
    """Standard Hough line transform on a binary edge Mat (OpenCV
    ``HoughLines``): float32 [K, 2] (rho, theta) pairs, strongest first.
    The accumulator is one-hot matmuls over compacted edge points —
    no scatter (ops/hough.py). Pair with :func:`canny`.

    ``max_points`` caps the compacted edge list (a static program shape).
    By default it is sized from the ACTUAL edge count (next power of two,
    ≥ 65536) so no votes are dropped — pass a value to pin the compiled
    bucket instead."""
    import numpy as np

    from ..ops import hough as _hough

    a = mat.device() if mat.is_on_device else mat.to_numpy()
    if a.ndim == 3:
        a = a[..., 0]
    if max_points is None:
        n_edges = int(np.count_nonzero(np.asarray(a)))
        max_points = 65536
        while max_points < n_edges:
            max_points *= 2
    lines, valid, _ = _hough.hough_lines(
        np.asarray(a) if not mat.is_on_device else a,
        n_thetas=n_thetas, rho_bins=rho_bins, max_points=max_points,
        max_lines=max_lines, threshold=threshold,
    )
    return np.asarray(lines)[np.asarray(valid)]


def hough_lines_p(mat: Mat, threshold: int = 50,
                  min_line_length: float = 30.0, max_line_gap: float = 5.0,
                  max_segments: int = 64, **kw):
    """Line segments on a binary edge Mat (OpenCV ``HoughLinesP`` role;
    deterministic spec — device accumulator peaks + host inlier-run
    extraction, see ops/hough.hough_lines_p). Returns int32 [M, 4]
    (x1, y1, x2, y2)."""
    from ..ops import hough as _hough

    a = mat.device() if mat.is_on_device else mat.to_numpy()
    if a.ndim == 3:
        a = a[..., 0]
    return _hough.hough_lines_p(
        a, threshold=threshold, min_line_length=min_line_length,
        max_line_gap=max_line_gap, max_segments=max_segments, **kw,
    )


def lut(mat: Mat, table) -> Mat:
    """Apply a 256-entry u8 lookup table per byte (OpenCV ``LUT`` — gamma
    and tone curves). Device path is gather-free (ops/hist.apply_lut)."""
    import numpy as np

    from ..ops import hist as _hist

    t = np.asarray(table, np.uint8).reshape(256)
    return _apply(
        mat,
        lambda d: _hist.apply_lut(d, t),
        lambda h: t[h],
    )


def apply_color_map(mat: Mat, colormap: str = "jet") -> Mat:
    """Map a gray (or BGR-via-luma) Mat through a 256-entry color table
    (OpenCV ``applyColorMap`` role; frozen anchor-interpolation tables,
    golden.colormap_table). Returns a BGR Mat. Device path is three
    gather-free LUT applies (ops/hist.apply_lut)."""
    import numpy as np

    from ..ops import hist as _hist

    table = golden.colormap_table(colormap)  # [256, 3] BGR
    g = _gray_of_mat(mat)
    if mat.is_on_device:
        import jax.numpy as jnp

        chans = [_hist.apply_lut(g, table[:, c]) for c in range(3)]
        bgr = jnp.stack(chans, axis=-1)  # (H, W, 3)
        return Mat.from_device(bgr)
    return Mat.from_array(table[np.asarray(g)])


def normalize(mat: Mat, alpha: float = 0.0, beta: float = 255.0,
              norm_type: str = "minmax") -> Mat:
    """Normalize a u8 Mat (OpenCV ``normalize`` role; frozen f64 spec
    golden.normalize_u8, device f32 ±1 LSB): ``minmax`` maps the value
    range to [alpha, beta]; ``inf``/``l1``/``l2`` scale the norm to
    ``alpha``."""
    from ..ops import arith as _arith

    return _apply(
        mat,
        lambda d: _arith.normalize_u8(d, alpha, beta, norm_type),
        lambda h: golden.normalize_u8(h, alpha, beta, norm_type),
    )


def accumulate_weighted(acc, mat: Mat, alpha: float):
    """Running average (OpenCV ``accumulateWeighted``): returns the new
    float32 accumulator (1−α)·acc + α·mat. ``acc`` may be a float32
    ndarray, a jax.Array, or None (initialised to the frame)."""
    import numpy as np

    from ..ops import arith as _arith

    if mat.is_on_device:
        src = mat.device()
        if acc is None:
            return src.astype("float32")
        return _arith.accumulate_weighted(acc, src, alpha)
    src = mat.to_numpy()
    if acc is None:
        return src.astype(np.float32)
    return _arith.accumulate_weighted_numpy(np.asarray(acc), src, alpha)


def calc_hue_hist(mat_hsv: Mat, mask=None):
    """Normalized 180-bin hue histogram of an HSV Mat (the model for
    :func:`back_project`)."""
    import numpy as np

    from ..ops import hist as _hist

    a = np.asarray(mat_hsv.device()) if mat_hsv.is_on_device else mat_hsv.to_numpy()
    return _hist.calc_hue_hist(a, mask)


def back_project(mat_hsv: Mat, hue_hist) -> Mat:
    """Histogram backprojection (OpenCV ``calcBackProject``, hue channel):
    per-pixel likelihood u8 — the CamShift/mean-shift weight image; pair
    with :func:`moments` for the tracking window update."""
    from ..ops import hist as _hist

    a = mat_hsv.device() if mat_hsv.is_on_device else mat_hsv.to_numpy()
    return Mat.from_array(_hist.back_project_hue(a, hue_hist))


def kmeans_quantize(mat: Mat, k: int = 8, iters: int = 10):
    """Color quantization via k-means (OpenCV ``kmeans`` role): (quantized
    Mat with ≤ k colors, palette [k, 3] u8). Assignment and update are
    both matmuls (ops/kmeans.py)."""
    import numpy as np

    from ..ops import kmeans as _km

    a = np.asarray(mat.device()) if mat.is_on_device else mat.to_numpy()
    out, pal = _km.kmeans_quantize(a, k=k, iters=iters)
    return Mat.from_array(out), pal


def mean_shift(prob_mat: Mat, window, max_iter: int = 20):
    """OpenCV ``meanShift`` over a weight image (e.g. :func:`back_project`
    output): (iterations, (x, y, w, h))."""
    from ..ops import hist as _hist

    g = _gray_of_mat(prob_mat, allow_bgr=False)
    import numpy as np

    return _hist.mean_shift(np.asarray(g), tuple(window), max_iter=max_iter)


def cam_shift(prob_mat: Mat, window, max_iter: int = 20):
    """OpenCV ``CamShift`` (simplified, axis-aligned): ((cx, cy, w, h),
    next window) — meanShift + moment-driven window resize."""
    from ..ops import hist as _hist

    g = _gray_of_mat(prob_mat, allow_bgr=False)
    import numpy as np

    return _hist.cam_shift(np.asarray(g), tuple(window), max_iter=max_iter)


def clahe(mat: Mat, clip_limit: int = 40, grid=(8, 8)) -> Mat:
    """Contrast-limited adaptive histogram equalization (OpenCV
    ``createCLAHE`` role) on a u8 gray Mat — exact-integer frozen spec,
    host == device bit-for-bit (ops/hist.clahe)."""
    from ..ops import hist as _hist

    g = tuple(grid)
    gray = _gray_of_mat(mat, allow_bgr=False)
    if mat.is_on_device:
        return Mat.from_device(_hist.clahe(gray, clip_limit, g))
    return Mat.from_array(_hist.clahe_numpy(gray, clip_limit, g))


def match_template(mat: Mat, tmpl: Mat, method: str = "ccoeff_normed"):
    """OpenCV ``matchTemplate``: grayscale correlation search (BGR inputs
    are converted via the exact luma). Returns the float32 response map
    (H−th+1, W−tw+1) as a NumPy array — feed to :func:`min_max_loc`. On a
    device Mat the three window statistics run as matrix unit convolutions
    (ops/template.py)."""
    import numpy as np

    from ..ops import template as _tmpl

    def _gray_of(m: Mat):
        if m.is_on_device:
            from ..ops import color as _color

            d = m.device()
            if d.ndim == 3 and d.shape[-1] == 3:
                return _color.bgr_to_gray(d)
            return d[..., 0] if d.ndim == 3 else d
        h = m.to_numpy()
        if h.ndim == 3 and h.shape[-1] == 3:
            return golden.bgr_to_gray(h)
        return h[..., 0] if h.ndim == 3 else h

    g = _gray_of(mat)
    t = _gray_of(tmpl)
    if mat.is_on_device or tmpl.is_on_device:
        import jax.numpy as jnp

        return np.asarray(
            _tmpl.match_template(jnp.asarray(g), jnp.asarray(t), method)
        )
    return _tmpl.match_template_numpy(np.asarray(g), np.asarray(t), method).astype(
        np.float32
    )


def min_max_loc(resp):
    """(min_val, max_val, (min_x, min_y), (max_x, max_y)) — OpenCV
    ``minMaxLoc`` over a response map."""
    from ..ops.template import min_max_loc as _mml

    return _mml(resp)


def sobel(mat: Mat, dx: int = 1, dy: int = 0, ksize: int = 3):
    """Directional derivative (OpenCV ``Sobel`` role, CV_32S-style
    SIGNED output): gray (BGR converts via exact luma) → int32 ndarray
    [H, W]. Exact integer separable kernels from getDerivKernels
    construction (ops/filters.sobel_xy; host oracle int64-exact)."""
    import numpy as np

    from ..ops import filters as _filters

    g = _gray_of_mat(mat)
    if mat.is_on_device:
        return np.asarray(_filters.sobel_xy(g, dx, dy, ksize))
    return _filters.sobel_xy_numpy(np.asarray(g), dx, dy,
                                   ksize).astype(np.int32)


def sobel_magnitude(mat: Mat) -> Mat:
    """gray(BGR input ok) → Sobel → exact |∇| u8."""
    from ..ops import filters as _filters

    def host(h):
        g = golden.bgr_to_gray(h) if h.ndim == 3 else h.squeeze()
        gx, gy = golden.sobel3_gray(g)
        return golden.gradient_magnitude_u8(gx, gy)

    def dev(d):
        from ..ops import color as _color

        g = _color.bgr_to_gray(d) if d.ndim == 3 else d.squeeze()
        gx, gy = _filters.sobel3_gray(g)
        return _filters.gradient_magnitude_u8(gx, gy)

    return _apply(mat, dev, host)


def laplacian(mat: Mat) -> "np.ndarray":
    """3×3 Laplacian (OpenCV ``Laplacian`` ksize=1, CV_16S-style signed
    output role): gray (BGR input converts via the exact luma) → signed
    int32 (H, W) array, exact integer arithmetic vs golden.laplacian3,
    replicate borders."""
    from ..ops import filters as _filters

    g = _gray_of_mat(mat)
    if mat.is_on_device:
        return np.asarray(_filters.laplacian3(g))
    return golden.laplacian3(np.asarray(g))


def scharr(mat: Mat, dx: int = 1, dy: int = 0) -> "np.ndarray":
    """Scharr 3×3 derivative (OpenCV ``Scharr`` role): exactly one of
    (dx, dy) = (1, 0) or (0, 1). Signed int32 (H, W) output, exact vs
    golden.scharr3_gray, replicate borders."""
    if (dx, dy) not in ((1, 0), (0, 1)):
        raise ValueError("scharr requires (dx, dy) of (1, 0) or (0, 1)")
    from ..ops import filters as _filters

    g = _gray_of_mat(mat)
    if mat.is_on_device:
        gx, gy = _filters.scharr3_gray(g)
        return np.asarray(gx if dx else gy)
    gx, gy = golden.scharr3_gray(np.asarray(g))
    return gx if dx else gy


def threshold(mat: Mat, thresh: int, maxval: int = 255, type: str = "binary") -> Mat:
    """Element-wise threshold (binary/binary_inv/trunc/tozero/tozero_inv)."""
    from ..ops import filters as _filters

    return _apply(
        mat,
        lambda d: _filters.threshold_u8(d, thresh, maxval, type=type),
        lambda h: golden.threshold(h, thresh, maxval, type=type),
    )


def flip(mat: Mat, flip_code: int = 0) -> Mat:
    """Flip: 0 = vertical (x-axis), 1 = horizontal, -1 = both (cv2 codes)."""
    if mat.is_on_device:
        d = mat.device()
        if flip_code == 0:
            out = d[::-1]
        elif flip_code > 0:
            out = d[:, ::-1]
        else:
            out = d[::-1, ::-1]
        return Mat.from_device(out)
    h = mat.to_numpy()
    if flip_code == 0:
        out = h[::-1]
    elif flip_code > 0:
        out = h[:, ::-1]
    else:
        out = h[::-1, ::-1]
    return Mat.from_array(np.ascontiguousarray(out))


def erode(mat: Mat, ksize: int = 3) -> Mat:
    """k×k erosion (window minimum), replicate border."""
    from ..ops import filters as _filters

    return _apply(mat, lambda d: _filters.erode_u8(d, ksize), lambda h: golden.erode(h, ksize))


def dilate(mat: Mat, ksize: int = 3) -> Mat:
    """k×k dilation (window maximum), replicate border."""
    from ..ops import filters as _filters

    return _apply(mat, lambda d: _filters.dilate_u8(d, ksize), lambda h: golden.dilate(h, ksize))


def guided_filter(guide_mat: Mat, src_mat: Mat, radius: int = 8,
                  eps: float = 1e-3) -> Mat:
    """Guided filter (He et al.; OpenCV ximgproc ``guidedFilter`` role):
    box-filter-only edge-preserving smoothing of ``src`` steered by a
    gray ``guide`` (ops/dtfilter.py)."""
    import numpy as np

    from ..ops import dtfilter as _dt

    g = _gray_of_mat(guide_mat)
    s = src_mat.device() if src_mat.is_on_device else src_mat.to_numpy()
    squeeze = s.ndim == 3 and s.shape[-1] == 1
    out = _dt.guided_filter(g if guide_mat.is_on_device else np.asarray(g),
                            s[..., 0] if squeeze else s, radius, eps)
    if squeeze:
        out = out[..., None]
    return Mat.from_device(out) if src_mat.is_on_device else         Mat.from_array(np.asarray(out))


def color_change(mat: Mat, mask, mul=(1.5, 1.0, 1.0)) -> Mat:
    """Seamless per-channel gradient scaling (OpenCV ``colorChange``
    role; ops/poisson.py)."""
    import numpy as np

    from ..ops import poisson as _poi

    return Mat.from_array(_poi.color_change(mat.to_numpy(),
                                            np.asarray(mask), mul))


def illumination_change(mat: Mat, mask, alpha: float = 0.2,
                        beta: float = 0.4) -> Mat:
    """Seamless illumination attenuation (OpenCV ``illuminationChange``
    role; ops/poisson.py)."""
    import numpy as np

    from ..ops import poisson as _poi

    return Mat.from_array(_poi.illumination_change(
        mat.to_numpy(), np.asarray(mask), alpha, beta))


def texture_flattening(mat: Mat, mask, low_threshold: float = 30.0) -> Mat:
    """Seamless texture removal keeping strong edges (OpenCV
    ``textureFlattening`` role; ops/poisson.py)."""
    import numpy as np

    from ..ops import poisson as _poi

    return Mat.from_array(_poi.texture_flattening(
        mat.to_numpy(), np.asarray(mask), low_threshold))


def pyr_mean_shift_filtering(mat: Mat, sp: int = 10, sr: float = 25.0,
                             max_level: int = 1,
                             max_iter: int = 5) -> Mat:
    """Mean-shift posterization (OpenCV ``pyrMeanShiftFiltering`` role):
    per-pixel joint spatial-color mode seeking over a decimation
    pyramid (ops/meanshift_filter.py; gather-per-offset device twin for
    device-resident Mats)."""
    import numpy as np

    from ..ops import meanshift_filter as _msf

    if mat.is_on_device:
        return Mat.from_device(_msf.pyr_mean_shift(
            mat.device(), sp=sp, sr=float(sr), max_level=max_level,
            max_iter=max_iter))
    return Mat.from_array(_msf.pyr_mean_shift_numpy(
        mat.to_numpy(), sp=sp, sr=float(sr), max_level=max_level,
        max_iter=max_iter))


def edge_preserving_filter(mat: Mat, sigma_s: float = 60.0,
                           sigma_r: float = 0.4) -> Mat:
    """Domain-transform recursive edge-preserving smoothing (OpenCV
    ``edgePreservingFilter`` role) — lax.scan recursion on device
    (ops/dtfilter.py)."""
    return _photo_op(mat, "edge_preserving_filter", sigma_s, sigma_r)


def detail_enhance(mat: Mat, sigma_s: float = 10.0,
                   sigma_r: float = 0.15) -> Mat:
    """OpenCV ``detailEnhance`` role: DT base + 3x detail."""
    return _photo_op(mat, "detail_enhance", sigma_s, sigma_r)


def stylization(mat: Mat, sigma_s: float = 60.0,
                sigma_r: float = 0.45) -> Mat:
    """OpenCV ``stylization`` role: DT-flattened regions + dark edges."""
    return _photo_op(mat, "stylization", sigma_s, sigma_r)


def pencil_sketch(mat: Mat, sigma_s: float = 60.0, sigma_r: float = 2.0,
                  shade_factor: float = 0.05):
    """OpenCV ``pencilSketch`` role → (gray sketch Mat, color Mat)."""
    import numpy as np

    from ..ops import dtfilter as _dt

    a = mat.device() if mat.is_on_device else mat.to_numpy()
    if a.ndim == 2:
        a = a[..., None]
    if a.shape[-1] == 1:
        import numpy as _np
        rep = (a if isinstance(a, _np.ndarray) else a)
        a = _np.repeat(_np.asarray(rep), 3, -1) if isinstance(rep, _np.ndarray) else None
        if a is None:
            import jax.numpy as jnp
            a = jnp.repeat(rep, 3, -1)
    sk, co = _dt.pencil_sketch(a, sigma_s, sigma_r, shade_factor)
    mk = Mat.from_device if mat.is_on_device else (
        lambda x: Mat.from_array(np.asarray(x)))
    return mk(sk[..., None] if np.asarray(sk).ndim == 2 else sk), mk(co)


def _photo_op(mat: Mat, name: str, sigma_s: float, sigma_r: float) -> Mat:
    import numpy as np

    from ..ops import dtfilter as _dt

    a = mat.device() if mat.is_on_device else mat.to_numpy()
    squeeze = a.ndim == 3 and a.shape[-1] == 1
    if squeeze:
        if isinstance(a, np.ndarray):
            a = np.repeat(a, 3, -1)
        else:
            import jax.numpy as jnp
            a = jnp.repeat(a, 3, -1)
    out = getattr(_dt, name)(a, sigma_s, sigma_r)
    if squeeze:
        out = out[..., :1]
    return Mat.from_device(out) if mat.is_on_device else Mat.from_array(
        np.asarray(out))


def align_mtb(mats, max_bits: int = 6, exclude_range: int = 4):
    """Median-threshold-bitmap exposure alignment (OpenCV ``AlignMTB``
    role): translation-register a u8 stack to its first image
    (exposure-invariant; ops/hdr.py). Returns aligned Mats."""
    import numpy as np

    from ..ops import hdr as _hdr

    arrays = [m.to_numpy() if hasattr(m, "to_numpy") else np.asarray(m)
              for m in mats]
    return [Mat.from_array(a)
            for a in _hdr.align_mtb(arrays, max_bits, exclude_range)]


def merge_mertens(mats):
    """Exposure fusion (OpenCV ``MergeMertens`` role): u8 BGR exposure
    stack → float32 [0,1] fused image. One jitted pyramid program for
    device-resident Mats (ops/hdr.py)."""
    import numpy as np

    from ..ops import hdr as _hdr

    arrays = [m.to_numpy() if hasattr(m, "to_numpy") else np.asarray(m)
              for m in mats]
    if any(getattr(m, "is_on_device", False) for m in mats):
        import jax.numpy as jnp

        return np.asarray(_hdr.merge_mertens(jnp.asarray(np.stack(arrays))))
    return _hdr.merge_mertens_numpy(arrays)


def merge_robertson(mats, times, response=None):
    """Robertson radiance merge (OpenCV ``MergeRobertson`` role):
    u8 BGR stack + exposure times → float32 radiance; matches cv2 to
    2e-5 rel with the same response (ops/hdr.py)."""
    import numpy as np

    from ..ops import hdr as _hdr

    arrays = [m.to_numpy() if hasattr(m, "to_numpy") else np.asarray(m)
              for m in mats]
    return _hdr.merge_robertson_numpy(arrays, times, response)


def calibrate_robertson(mats, times, max_iter: int = 30,
                        threshold: float = 0.01):
    """Robertson EM response recovery (OpenCV ``CalibrateRobertson``
    role) → (3, 256), g(128)=1 per channel (ops/hdr.py)."""
    import numpy as np

    from ..ops import hdr as _hdr

    arrays = [m.to_numpy() if hasattr(m, "to_numpy") else np.asarray(m)
              for m in mats]
    return _hdr.calibrate_robertson(arrays, times, max_iter,
                                    threshold)


def tonemap_drago(hdr_img, gamma: float = 1.0, saturation: float = 1.0,
                  bias: float = 0.85):
    """Drago'03 adaptive-logarithmic tonemap (OpenCV ``TonemapDrago``
    role): float radiance → float32 [0,1]; ≤0.01 MAE vs cv2 pinned
    (ops/hdr.py)."""
    from ..ops import hdr as _hdr

    return _hdr.tonemap_drago_numpy(hdr_img, gamma, saturation, bias)


def denoise_tvl1(observations, lam: float = 1.0, niters: int = 30):
    """Multi-observation TV-L1 denoising (OpenCV ``denoise_TVL1``
    role): list of u8 frames → u8. Device-resident inputs run the
    fused fori_loop twin (ops/tvl1.py)."""
    import numpy as np

    from ..ops import tvl1 as _tvl1

    if any(getattr(m, "is_on_device", False) for m in observations):
        import jax.numpy as jnp

        stack = jnp.stack([m.device() for m in observations])
        return np.asarray(_tvl1.denoise_tvl1(stack, lam=lam,
                                             niters=niters))
    arrays = [m.to_numpy() if hasattr(m, "to_numpy") else np.asarray(m)
              for m in observations]
    return _tvl1.denoise_tvl1_numpy(arrays, lam=lam, niters=niters)


def seamless_clone(src_mat: Mat, dst_mat: Mat, mask, center,
                   mixed: bool = False) -> Mat:
    """Poisson blending (OpenCV ``seamlessClone`` role): solve the
    guided Laplace equation inside the mask — device fused-Jacobi
    fori_loop for device-resident destinations (ops/poisson.py).
    ``mixed`` = MIXED_CLONE (keep stronger destination gradients)."""
    import numpy as np

    from ..ops import poisson as _poi

    flags = _poi.MIXED_CLONE if mixed else _poi.NORMAL_CLONE
    s = src_mat.to_numpy() if hasattr(src_mat, "to_numpy") else np.asarray(src_mat)
    if s.ndim == 3 and s.shape[-1] == 1:
        s = s[..., 0]
    if dst_mat.is_on_device:
        d = dst_mat.device()
        squeeze = d.ndim == 3 and d.shape[-1] == 1
        out = _poi.seamless_clone(s, d[..., 0] if squeeze else d,
                                  np.asarray(mask), center, flags)
        return Mat.from_device(out[..., None] if squeeze else out)
    d = dst_mat.to_numpy()
    squeeze = d.ndim == 3 and d.shape[-1] == 1
    out = _poi.seamless_clone_numpy(s, d[..., 0] if squeeze else d,
                                    np.asarray(mask), center, flags)
    return Mat.from_array(out[..., None] if squeeze else out)


def inpaint(mat: Mat, mask, radius: int = 3,
            method: str = "telea") -> Mat:
    """Inpaint holes (OpenCV ``inpaint`` role): ``telea`` = host Fast
    Marching (sequential escape, like GrabCut/CCL); ``diffusion`` =
    harmonic fill whose device twin is a fused Jacobi fori_loop
    (ops/inpaint.py)."""
    import numpy as np

    from ..ops import inpaint as _inp

    if mat.is_on_device and method == "diffusion":
        import jax.numpy as jnp

        out = _inp.inpaint_diffusion(mat.device(), jnp.asarray(
            np.asarray(mask).astype(bool)))
        return Mat.from_device(out)
    a = mat.to_numpy()
    squeeze = a.ndim == 3 and a.shape[-1] == 1
    out = _inp.inpaint(a[..., 0] if squeeze else a, np.asarray(mask),
                       radius, method)
    return Mat.from_array(out[..., None] if squeeze else out)


def fast_nl_means_denoising(mat: Mat, h: float = 10.0,
                            template_window_size: int = 7,
                            search_window_size: int = 21) -> Mat:
    """Non-local means denoising (OpenCV ``fastNlMeansDenoising`` role)
    on a gray image — lax.scan over the search window, box-filtered
    patch distances, zero gathers (ops/nlmeans.py; f64 oracle, +-1 LSB)."""
    from ..ops import nlmeans as _nl

    return _apply(
        mat,
        lambda d: _nl.nl_means(d if d.ndim == 2 else d[..., 0], h,
                               template_window_size, search_window_size),
        lambda a: _nl.nl_means_numpy(a if a.ndim == 2 else a[..., 0], h,
                                     template_window_size,
                                     search_window_size),
    )


def fast_nl_means_denoising_colored(mat: Mat, h: float = 10.0,
                                    h_color: float = 10.0,
                                    template_window_size: int = 7,
                                    search_window_size: int = 21) -> Mat:
    """Colored NL-means (OpenCV ``fastNlMeansDenoisingColored`` role):
    denoise L with ``h``, a/b with ``h_color`` in CIE Lab, convert back."""
    import jax.numpy as _jnp

    from ..ops import nlmeans as _nl

    a = mat.device() if mat.is_on_device else _jnp.asarray(mat.to_numpy())
    out = _nl.nl_means_colored(a, h, h_color, template_window_size,
                               search_window_size)
    return Mat.from_device(out) if mat.is_on_device else Mat.from_array(
        __import__("numpy").asarray(out))


def median_blur(mat: Mat, ksize: int = 3) -> Mat:
    """k×k median filter (odd k, exact). k = 3 uses the 19-exchange
    selection network; larger kernels use bitwise bisection (8 counting
    rounds — same cost for any k, see ops/filters.median_u8)."""
    from ..ops import filters as _filters

    if ksize == 3:
        return _apply(mat, _filters.median3_u8, golden.median3)
    return _apply(
        mat,
        lambda d: _filters.median_u8(d, ksize),
        lambda h: golden.median_k(h, ksize),
    )


def canny(mat: Mat, low: int = 40, high: int = 90) -> Mat:
    """Canny edges (frozen integer spec, golden.canny). BGR input is
    converted to gray first; returns a u8 edge mask Mat."""
    from ..ops import color as _color
    from ..ops import filters as _filters

    if mat.is_on_device:
        d = mat.device()
        g = _color.bgr_to_gray(d) if d.ndim == 3 else d.squeeze()
        return Mat.from_device(_filters.canny_u8(g, low, high))
    h = mat.to_numpy()
    g = golden.bgr_to_gray(h) if h.ndim == 3 and h.shape[-1] == 3 else h.squeeze()
    return Mat.from_array(golden.canny(g, low, high))


def thinning(mat: Mat) -> Mat:
    """Zhang-Suen skeletonization (OpenCV ximgproc ``thinning`` role;
    frozen spec in ops/morphx.py, device while_loop == oracle
    BIT-EXACT). Input: u8 mask (non-zero = set); returns a 255/0 u8
    Mat (OpenCV's convention)."""
    import jax.numpy as jnp

    from ..ops import morphx as _morphx

    if mat.is_on_device:
        d = mat.device()
        g = d.squeeze() if d.ndim == 3 else d
        return Mat.from_device(_morphx.thinning(g) * jnp.uint8(255))
    h = mat.to_numpy().squeeze()
    return Mat.from_array(_morphx.thinning_numpy(h) * np.uint8(255))


def anisotropic_diffusion(mat: Mat, alpha: float = 0.15, k: float = 20.0,
                          niters: int = 10) -> Mat:
    """Perona-Malik edge-preserving diffusion (OpenCV ximgproc
    ``anisotropicDiffusion`` role; f64 oracle ±1 LSB in
    ops/morphx.py)."""
    from ..ops import morphx as _morphx

    if mat.is_on_device:
        return Mat.from_device(_morphx.anisotropic_diffusion(
            mat.device(), alpha=alpha, k=k, niters=niters))
    return Mat.from_array(_morphx.anisotropic_diffusion_numpy(
        mat.to_numpy(), alpha=alpha, k=k, niters=niters))


def harris_corners(mat: Mat, k: float = 0.04, threshold_rel: float = 0.01, nms_radius: int = 1) -> np.ndarray:
    """Corner mask (H, W) bool."""
    from ..ops import color as _color
    from ..ops import features as _features

    if mat.is_on_device:
        d = mat.device()
        g = _color.bgr_to_gray(d) if d.ndim == 3 else d.squeeze()
        return np.asarray(_features.harris_corners(g, k=k, threshold_rel=threshold_rel, nms_radius=nms_radius))
    h = mat.to_numpy()
    g = golden.bgr_to_gray(h) if h.ndim == 3 else h.squeeze()
    return golden.harris_corners(g, k=k, threshold_rel=threshold_rel, nms_radius=nms_radius)


__all__ = [
    "Point", "Rect", "Scalar", "absdiff", "adaptive_threshold", "add",
    "add_weighted", "back_project", "bitwise_and", "bitwise_not",
    "bitwise_or", "bitwise_xor", "convert_scale_abs", "count_non_zero",
    "mean_std_dev", "norm", "psnr", "subtract",
    "bilateral_filter", "box_blur", "stack_blur", "calc_hist",
    "calc_hue_hist", "canny",
    "calc_optical_flow_farneback", "calc_optical_flow_dis",
    "calc_optical_flow_pyr_lk", "circle", "clahe", "compute_brief",
    "connected_components", "connected_components_with_stats",
    "accumulate_weighted", "apply_color_map", "approx_poly_dp",
    "arc_length", "arrowed_line", "bounding_rect", "contour_area",
    "convex_hull", "convex_hull_indices", "convexity_defects",
    "create_background_subtractor_mog2",
    "create_background_subtractor_knn", "draw_contours", "ellipse",
    "fill_poly", "is_contour_convex", "min_area_rect",
    "min_enclosing_circle", "normalize", "point_polygon_test",
    "corner_sub_pix", "cvt_gray", "detect_blobs", "distance_transform",
    "cvt_hsv", "cvt_hsv_to_bgr", "cvt_lab", "cvt_lab_to_bgr",
    "cvt_ycrcb", "cvt_ycrcb_to_bgr",
    "dilate", "equalize_hist", "erode",
    "estimate_affine_2d", "estimate_affine_partial_2d", "fast_corners",
    "sift_features", "match_descriptors_l2", "stitch_images",
    "hog_descriptor", "hog_detect_multi_scale",
    "cascade_detect_multi_scale", "detect_aruco_markers",
    "qr_detect_and_decode",
    "warp_polar", "linear_polar", "log_polar",
    "dct", "idct", "dft", "idft", "mul_spectrums", "get_optimal_dft_size",
    "calibrate_camera", "find_homography", "solve_pnp",
    "solve_pnp_ransac", "stereo_rectify", "reproject_image_to_3d",
    "fisheye_project_points", "fisheye_undistort_points",
    "fisheye_init_undistort_rectify_map", "fisheye_undistort",
    "find_fundamental_mat", "compute_correspond_epilines",
    "triangulate_points",
    "find_essential_mat", "decompose_essential_mat", "recover_pose",
    "correct_matches", "stereo_calibrate", "decompose_homography_mat",
    "estimate_affine_3d",
    "find_chessboard_corners", "draw_chessboard_corners",
    "detect_mser_regions",
    "box_points", "intersect_convex_convex",
    "rotated_rectangle_intersection", "emd", "get_gabor_kernel",
    "detect_line_segments", "thinning", "anisotropic_diffusion",
    "find_transform_ecc", "compute_ecc",
    "akaze_features", "match_descriptors_hamming_any",
    "find_contours", "flip", "flood_fill", "gaussian_blur",
    "dilate_kernel", "erode_kernel", "filter2d", "fit_ellipse", "fit_line",
    "get_gaussian_kernel", "get_perspective_transform",
    "get_structuring_element", "integral", "sep_filter_2d",
    "morphology_ex",
    "warp_perspective",
    "cam_shift", "good_features_to_track", "hough_circles", "hough_lines",
    "hough_lines_p", "hu_moments",
    "kmeans_quantize",
    "line", "lut", "match_descriptors", "match_shapes", "mean_shift",
    "polylines",
    "grab_cut",
    "get_rotation_matrix_2d", "get_optimal_new_camera_matrix",
    "init_undistort_rectify_map", "project_points", "rodrigues",
    "undistort", "undistort_points",
    "harris_corners", "in_range", "laplacian", "match_template",
    "median_blur", "min_max_loc", "orb_features", "phase_correlate",
    "pyr_up", "moments", "pyr_down", "put_text",
    "rectangle", "remap", "resize", "rotate", "scharr", "sobel",
    "sobel_magnitude",
    "stereo_bm", "stereo_sgbm", "threshold",
    "fast_nl_means_denoising", "fast_nl_means_denoising_colored",
    "inpaint", "seamless_clone", "merge_mertens", "align_mtb",
    "merge_robertson", "calibrate_robertson", "tonemap_drago",
    "denoise_tvl1",
    "pyr_mean_shift_filtering", "guided_filter",
    "color_change", "illumination_change", "texture_flattening",
    "edge_preserving_filter", "detail_enhance", "stylization",
    "pencil_sketch",
    "warp_affine", "watershed",
    "copy_make_border", "split", "merge", "mix_channels",
    "cart_to_polar", "polar_to_cart", "magnitude", "phase", "fast_atan2",
    "compare", "find_non_zero", "reduce", "sort", "sort_idx",
    "hconcat", "vconcat", "repeat", "transform", "perspective_transform",
    "get_affine_transform", "gemm", "scale_add", "set_identity",
    "determinant", "invert", "solve", "eigen", "sv_decomp",
    "sv_back_subst", "pca_compute", "pca_project", "pca_back_project",
    "calc_covar_matrix", "mahalanobis", "RNG",
    "spatial_gradient", "corner_min_eigen_val",
    "corner_eigen_vals_and_vecs", "pre_corner_detect",
    "find_circles_grid", "circles_grid_object_points",
    "slic_superpixels",
    "clip_line", "ellipse2poly", "draw_keypoints", "draw_matches",
    "build_r_table", "ghough_detect",
    "variational_refine",
    "accumulate", "accumulate_square", "accumulate_product",
    "blend_linear", "blur", "box_filter", "sqr_box_filter",
    "compare_hist", "create_hanning_window", "cube_root",
    "convert_points_to_homogeneous", "convert_points_from_homogeneous",
    "complete_symm", "extract_channel", "insert_channel",
    "has_non_zero", "invert_affine_transform", "patch_nans",
    "rand_shuffle", "reduce_arg_max", "reduce_arg_min",
    "solve_cubic", "solve_poly", "trace", "transpose",
    "mul_transposed", "sum_elems", "multiply", "divide",
    "compose_rt", "decompose_projection_matrix",
    "calibration_matrix_values", "sampson_distance",
    "estimate_translation_2d", "estimate_translation_3d",
    "init_camera_matrix_2d", "stereo_rectify_uncalibrated",
    "filter_speckles", "read_optical_flow", "write_optical_flow",
    "fit_ellipse_ams", "fit_ellipse_direct",
    "distance_transform_l2_with_labels", "convert_maps", "draw_marker",
    "multi_band_blend", "gain_compensation", "voronoi_seam",
    "decolor",
    "save_point_cloud", "load_point_cloud", "depth_to_3d",
    "find_planes", "triangle_rasterize",
    "IntelligentScissors",
    "detect_barcodes", "encode_ean13",
    "batch_distance", "div_spectrums", "eigen_non_symmetric",
    "mat_mul_deriv", "copy_to", "flip_nd", "transpose_nd",
    "finite_mask", "approx_poly_n", "solve_p3p",
    "fast_nl_means_denoising_multi",
    "good_features_to_track_with_quality", "solve_pnp_refine",
    "ghough_detect_guil", "tonemap_mantiuk",
    "register_depth", "warp_frame", "rescale_depth",
    "estimate_chessboard_sharpness", "calibrate_camera_extended",
    "phase_correlate_iterative",
    "integral2", "integral3", "threshold_with_mask",
    "color_correction_matrix", "apply_ccm", "register_cameras",
    "solve_pnp_generic", "draw_frame_axes",
    "filter_homography_decomp_by_visible_refpoints",
    "save_mesh", "load_mesh", "kmeans", "depth_to_3d_sparse",
    "build_optical_flow_pyramid", "solve_lp",
    "KnnIndex", "radius_search",
    "border_interpolate", "rectangle_intersection_area",
    "Subdiv2D", "rgbd_normals", "RotationWarper", "rgbd_odometry",
    "TsdfVolume", "affine_detect_and_compute", "build_mst",
    "Octree", "detect_color_checker", "color_checker_ccm",
    "cvt_color_two_plane", "solve_pnp_epnp",
    "get_rect_sub_pix", "get_text_size", "check_range",
    "init_inverse_rectification_map", "find_transform_ecc_multiscale",
    "fast_nl_means_denoising_colored_multi", "ScaleEstimator",
    "min_enclosing_convex_polygon",
    "min_enclosing_triangle",
]


def stereo_bm(left: Mat, right: Mat, num_disparities: int = 64,
              block_size: int = 15, texture: int = 10, uniqueness: int = 10):
    """Stereo block matching (OpenCV ``StereoBM`` role) over a rectified
    gray pair: (disparity float32 (H, W), valid bool). The cost volume is
    D shifted SADs box-filtered on device; sub-pixel parabola refinement
    (ops/stereo.py)."""
    import numpy as np

    from ..ops import stereo as _stereo

    gl = _gray_of_mat(left)
    gr = _gray_of_mat(right)
    disp, valid = _stereo.stereo_bm(
        gl if left.is_on_device else np.asarray(gl),
        gr if right.is_on_device else np.asarray(gr),
        num_disparities=num_disparities, block_size=block_size,
        texture=texture, uniqueness=uniqueness,
    )
    return np.asarray(disp), np.asarray(valid)


def stereo_sgbm(left: Mat, right: Mat, num_disparities: int = 64,
                block_size: int = 5, p1=None, p2=None, uniqueness: int = 10,
                disp12_max_diff: int = 1, num_dirs: int = 8,
                prefilter_cap: int = 63):
    """Semi-global stereo matching (OpenCV ``StereoSGBM`` role) over a
    rectified gray pair: (disparity float32 (H, W), valid bool).
    Birchfield-Tomasi costs on clipped-Sobel prefilter, lax.scan path
    aggregation over 4/8 directions, uniqueness + sub-pixel + LR
    consistency (ops/sgbm.py; frozen int64 oracle)."""
    import numpy as np

    from ..ops import sgbm as _sgbm

    gl = _gray_of_mat(left)
    gr = _gray_of_mat(right)
    disp, valid = _sgbm.stereo_sgbm(
        gl if left.is_on_device else np.asarray(gl),
        gr if right.is_on_device else np.asarray(gr),
        num_disparities=num_disparities, block_size=block_size,
        p1=p1, p2=p2, uniqueness=uniqueness,
        disp12_max_diff=disp12_max_diff, num_dirs=num_dirs,
        prefilter_cap=prefilter_cap,
    )
    return np.asarray(disp), np.asarray(valid)


_DIS_PRESETS = {"ultrafast": (2, 5, False), "fast": (2, 8, False),
                "medium": (1, 12, True)}


def calc_optical_flow_dis(prev: Mat, nxt: Mat, finest_scale: int = 1,
                          iters: int = 8, refine: bool = False,
                          preset: str = None):
    """DIS dense optical flow (OpenCV ``DISOpticalFlow`` role): patch
    inverse search + inverse-residual densification over a pyramid —
    vmapped shared-fraction patch solves on device (ops/disflow.py).
    ``refine=True`` runs the Brox variational polish afterwards
    (ops/varref.py — OpenCV's DIS presets do the same internally).
    ``preset`` ("ultrafast"/"fast"/"medium", OpenCV's DIS presets)
    overrides the scale/iteration/refinement knobs.
    Returns float32 flow [H, W, 2] (u, v) with I1(x+u) ~= I0(x)."""
    import numpy as np

    from ..ops import disflow as _dis

    if preset is not None:
        finest_scale, iters, refine = _DIS_PRESETS[preset]
    g0 = _gray_of_mat(prev)
    g1 = _gray_of_mat(nxt)
    if prev.is_on_device:
        flow = np.asarray(_dis.dis_flow(g0, g1, finest_scale, iters))
    else:
        flow = _dis.dis_flow_numpy(np.asarray(g0), np.asarray(g1),
                                   finest_scale, iters)
    if refine:
        from ..ops import varref as _vr

        flow = _vr.variational_refine_numpy(
            np.asarray(g0), np.asarray(g1), flow).astype(np.float32)
    return flow


def calc_optical_flow_farneback(
    prev: Mat, nxt: Mat, levels: int = 3, winsize: int = 13,
    iterations: int = 3, poly_n: int = 5, poly_sigma: float = 1.1,
):
    """Dense optical flow via polynomial expansion (OpenCV
    ``calcOpticalFlowFarneback`` role): float32 (H, W, 2) [fx, fy] with
    prev(p) ~ next(p + flow(p)). All-device: six separable Gaussian-basis
    correlations + per-pixel 2x2 solves; one shared gather samples the
    displaced coefficient planes (ops/farneback.py)."""
    import numpy as np

    from ..ops import farneback as _fb

    gp = _gray_of_mat(prev)
    gn = _gray_of_mat(nxt)
    if prev.is_on_device or nxt.is_on_device:
        import jax.numpy as jnp

        fl = _fb.farneback_flow(
            jnp.asarray(gp), jnp.asarray(gn), levels=levels, winsize=winsize,
            iterations=iterations, poly_n=poly_n, poly_sigma=poly_sigma,
        )
        return np.asarray(fl)
    return _fb.farneback_flow_numpy(
        np.asarray(gp), np.asarray(gn), levels=levels, winsize=winsize,
        iterations=iterations, poly_n=poly_n, poly_sigma=poly_sigma,
    )


def morphology_ex(mat: Mat, op: str, ksize: int = 3) -> Mat:
    """Compound morphology (OpenCV ``morphologyEx``): op in
    ("open", "close", "gradient", "tophat", "blackhat")."""
    from ..ops import filters as _filters

    return _apply(
        mat,
        lambda d: _filters.morphology_ex_u8(d, op, ksize),
        lambda h: golden.morphology_ex(h, op, ksize),
    )


def filter2d(mat: Mat, kernel) -> Mat:
    """Arbitrary-kernel correlation (OpenCV ``filter2D``): u8 saturate,
    replicate border; ``kernel`` is a host (odd, odd) array baked into
    the device program (rank-1 kernels run separably)."""
    from ..ops import filters as _filters

    return _apply(
        mat,
        lambda d: _filters.filter2d_u8(d, kernel),
        lambda h: golden.filter2d(h, kernel),
    )


def integral(mat: Mat):
    """Summed-area table (OpenCV ``integral``): (H+1, W+1) with zero top
    row/left column. Device path is int32 (valid through 4K); larger
    images use the host int64 oracle."""
    import numpy as np

    from ..ops import filters as _filters

    g = _gray_of_mat(mat)
    h, w = g.shape[-2], g.shape[-1]
    if mat.is_on_device and h * w * 255 < 2**31:
        return np.asarray(_filters.integral_u8(g)).astype(np.int64)
    return golden.integral(np.asarray(g))


def stitch_images(mats, min_matches: int = 12):
    """Panorama stitching (OpenCV ``Stitcher`` role): SIFT registration
    chained image-to-image, RANSAC homographies, feather-blended
    compositing — device remap compositing for device-resident Mats
    (ops/stitch.py). Returns a Mat anchored at the first image."""
    import numpy as np

    arrays = []
    for m in mats:
        a = m.device() if getattr(m, "is_on_device", False) else (
            m.to_numpy() if hasattr(m, "to_numpy") else np.asarray(m))
        if a.ndim == 3 and a.shape[-1] == 1:
            a = a[..., 0]
        arrays.append(a)
    from ..ops import stitch as _stitch

    out = _stitch.stitch(arrays, min_matches=min_matches)
    return Mat.from_array(np.asarray(out) if out.ndim != 3 else out)


def qr_detect_and_decode(mat: Mat, thresh=None):
    """QR detection + decode (OpenCV ``QRCodeDetector.detectAndDecode``
    role): model-2 versions 1-4, byte mode, all ECC levels/masks, with
    full Reed-Solomon correction → (text or None, corners or None).
    Generate codes with ops/qr.encode + ops/qr.draw (ops/qr.py)."""
    import numpy as np

    from ..ops import qr as _qr

    g = np.asarray(_gray_of_mat(mat))
    return _qr.detect_and_decode(g, thresh=thresh)


def detect_aruco_markers(mat: Mat, dictionary, thresh=None):
    """Fiducial marker detection (OpenCV ``aruco.detectMarkers`` role):
    → (corners list [4,2] CW from canonical top-left, ids int32 [N]).
    Build dictionaries with ops/aruco.Dictionary.generate (self-
    generated codes — no OpenCV data); draw with ops/aruco.draw_marker;
    pose via ops/aruco.estimate_pose_single_markers."""
    import numpy as np

    from ..ops import aruco as _aruco

    g = np.asarray(_gray_of_mat(mat))
    return _aruco.detect_markers(g, dictionary, thresh=thresh)


def cascade_detect_multi_scale(mat: Mat, cascade_model,
                               scale_step: float = 1.2,
                               min_size: int = 0):
    """Haar cascade detection (OpenCV ``CascadeClassifier
    .detectMultiScale`` role) → (boxes [N,4] xywh, margins). Train or
    load models with ops/cascade.py (train_cascade / Cascade.from_json);
    device scorer for device-resident Mats — every Haar rect is four
    shifted slices of the integral image over the whole window grid."""
    import numpy as np

    from ..ops import cascade as _casc

    g = np.asarray(_gray_of_mat(mat))
    return _casc.detect_multi_scale(g, cascade_model,
                                    scale_step=scale_step,
                                    min_size=min_size,
                                    use_device=mat.is_on_device)


def hog_descriptor(mat: Mat):
    """HOG block grid (OpenCV ``HOGDescriptor.compute`` role) for a gray
    Mat with 8-multiple dims → float32 [H/8-1, W/8-1, 36] (ops/hog.py:
    one-hot orientation planes + separable pad/reshape cell binning,
    zero gathers). Slice 15x7 block windows for 3780-dim descriptors."""
    import numpy as np

    from ..ops import hog as _hog

    g = _gray_of_mat(mat)
    if mat.is_on_device:
        return np.asarray(_hog.hog_blocks(g))
    return hog_blocks_f32(np.asarray(g))


def hog_blocks_f32(a):
    import numpy as np

    from ..ops import hog as _hog

    return _hog.hog_blocks_numpy(np.asarray(a)).astype(np.float32)


def hog_detect_multi_scale(mat: Mat, svm_weights, svm_bias: float,
                           threshold: float = 0.0, scale: float = 1.2):
    """Sliding-window linear-SVM detection over a scale pyramid (OpenCV
    ``HOGDescriptor.detectMultiScale`` role) → (boxes [N,4] xywh,
    scores). Device score maps for device-resident Mats."""
    import numpy as np

    from ..ops import hog as _hog

    g = np.asarray(_gray_of_mat(mat))
    return _hog.detect_multi_scale(g, svm_weights, svm_bias,
                                   threshold=threshold, scale=scale,
                                   use_device=mat.is_on_device)


def akaze_features(mat: Mat, n_octaves: int = 4, n_sublevels: int = 4,
                   threshold: float = 0.001, max_keypoints: int = 2000):
    """AKAZE keypoints + descriptors (OpenCV ``AKAZE`` role): returns
    (keypoints float32 [N, 6] (x, y, size, angle_deg, response,
    evolution_idx), descriptors u8 [N, 64] — 486-bit M-LDB + pad).
    Device-resident Mats build the FED nonlinear scale space on device;
    the sparse stage is host f64 (ops/akaze.py). Match with
    :func:`match_descriptors_hamming_any`."""
    import numpy as np

    from ..ops import akaze as _akaze

    g = _gray_of_mat(mat)
    return _akaze.detect_and_compute(
        np.asarray(g), n_octaves=n_octaves, n_sublevels=n_sublevels,
        threshold=threshold, max_keypoints=max_keypoints,
        backend="device" if mat.is_on_device else "host")


def match_descriptors_hamming_any(d1, d2, ratio: float = 0.8):
    """Hamming matcher for byte descriptors of any width (AKAZE's 64
    bytes, BRIEF/ORB's 32, …) — ±1 matmul, ratio + cross-check
    (ops/akaze.py)."""
    from ..ops.akaze import match_descriptors_hamming as _m

    return _m(d1, d2, ratio=ratio)


def sift_features(mat: Mat, n_features: int = 0,
                  contrast_threshold: float = 0.04,
                  edge_threshold: float = 10.0, sigma: float = 1.6,
                  double_image: bool = True):
    """SIFT keypoints + descriptors (OpenCV ``SIFT`` role, Lowe 2004):
    returns (keypoints float32 [N, 6] (x, y, size, angle_deg, response,
    octave), descriptors u8 [N, 128]). Device-resident Mats build the
    Gaussian/DoG pyramids on device; the sparse per-keypoint stage is
    host f64 (ops/sift.py). Match with :func:`match_descriptors_l2`."""
    import numpy as np

    from ..ops import sift as _sift

    g = _gray_of_mat(mat)
    return _sift.detect_and_compute(
        np.asarray(g), n_features=n_features,
        contrast_threshold=contrast_threshold,
        edge_threshold=edge_threshold, sigma=sigma,
        double_image=double_image, use_device=mat.is_on_device)


def orb_features(mat: Mat, max_keypoints: int = 512, threshold: int = 20):
    """ORB-style features (OpenCV ``ORB`` role): FAST corners → intensity-
    centroid orientation → steered BRIEF-256. Returns (pts float32 [K, 2]
    (x, y), angles float32 [K] radians, desc u32 [K, 8], valid bool [K]).
    Match with :func:`match_descriptors` (rotation-aware, unlike upright
    :func:`compute_brief`)."""
    import numpy as np

    from ..ops import brief as _brief
    from ..ops import fast as _fast

    g = _gray_of_mat(mat)
    if mat.is_on_device:
        import jax.numpy as jnp

        yx, vk = _fast.fast_corner_list(g, threshold=threshold,
                                        max_corners=max_keypoints)
        pts = jnp.stack([yx[:, 1], yx[:, 0]], axis=-1).astype(jnp.float32)
        ang = _brief.orb_orientations(g, pts)
        desc, vd = _brief.orb_descriptors(g, pts, ang)
        return (np.asarray(pts), np.asarray(ang, np.float32),
                np.asarray(desc), np.asarray(vk & vd))
    g = np.asarray(g)
    mask, score = _fast.fast_corners_numpy(g, threshold=threshold)
    ys, xs = np.nonzero(mask)
    order = np.argsort(-score[ys, xs], kind="stable")[:max_keypoints]
    pts = np.stack([xs[order], ys[order]], axis=-1).astype(np.float32)
    ang = _brief.orb_orientations_numpy(g, pts)
    desc, vd = _brief.orb_descriptors_numpy(g, pts, ang)
    return pts, ang.astype(np.float32), desc, vd


# --- contour geometry (host-side point-list utilities, ops/shape.py) -----
from ..ops.shape import (  # noqa: E402  (re-exports)
    approx_poly_dp,
    arc_length,
    bounding_rect,
    box_points,
    contour_area,
    convex_hull,
    convex_hull_indices,
    convexity_defects,
    intersect_convex_convex,
    is_contour_convex,
    min_area_rect,
    min_enclosing_circle,
    point_polygon_test,
    rotated_rectangle_intersection,
)
from ..ops.emd import emd  # noqa: E402  (re-export)
from ..ops.ecc import (  # noqa: E402  (re-exports)
    compute_ecc,
    find_transform_ecc,
)


def create_background_subtractor_knn(n_samples: int = 7, **kw):
    """Per-pixel sample-consensus background model (OpenCV
    ``createBackgroundSubtractorKNN`` role) — deterministic cyclic-slot
    bank, all-elementwise device update (ops/knn_bgsub.py). ``kw``
    forwards to KNNParams (dist2_threshold, k_nn, ...)."""
    from ..ops.knn_bgsub import BackgroundSubtractorKNN

    return BackgroundSubtractorKNN(n_samples=n_samples, **kw)


def create_background_subtractor_mog2(k: int = 4, **kw):
    """Per-pixel Gaussian-mixture background model (OpenCV
    ``createBackgroundSubtractorMOG2`` role) — all-elementwise device
    update, model stays on device between frames (ops/bgsub.py).
    ``kw`` forwards to MOG2Params (alpha, var_threshold, ratio, ...);
    ``detect_shadows=True`` marks chromatic shadows 127 like OpenCV
    (Prati brightness-ratio test, ``shadow_tau`` threshold)."""
    from ..ops.bgsub import BackgroundSubtractorMOG2

    return BackgroundSubtractorMOG2(k=k, **kw)


def hough_circles(mat: Mat, dp: int = 4, min_dist: float = 20.0,
                  min_radius: int = 10, max_radius: int = 60,
                  edge_threshold: int = 60, vote_threshold: int = 20,
                  max_circles: int = 16):
    """Gradient Hough circle transform (OpenCV ``HoughCircles``): u8 gray
    → float32 [K, 3] (cx, cy, r), vote-sorted, greedily suppressing
    centers within ``min_dist`` of a stronger circle. The 2-D center
    accumulator runs as per-radius matrix unit outer-product matmuls
    (ops/hough.py)."""
    import numpy as np

    from ..ops import hough as _hough

    g = _gray_of_mat(mat)
    if mat.is_on_device:
        circ, valid, votes = _hough.hough_circles(
            g, dp=dp, min_radius=min_radius, max_radius=max_radius,
            edge_threshold=edge_threshold, vote_threshold=vote_threshold,
            max_circles=max_circles)
        circ = np.asarray(circ)[np.asarray(valid)]
        votes = np.asarray(votes)[np.asarray(valid)]
    else:
        circ, votes = _hough.hough_circles_numpy(
            np.asarray(g), dp=dp, min_radius=min_radius,
            max_radius=max_radius, edge_threshold=edge_threshold,
            vote_threshold=vote_threshold, max_circles=max_circles)
    keep = []
    for i in np.argsort(-votes, kind="stable"):
        c = circ[i]
        if all(np.hypot(c[0] - circ[j][0], c[1] - circ[j][1]) >= min_dist
               for j in keep):
            keep.append(i)
    return circ[keep].reshape(-1, 3)


def phase_correlate(prev: Mat, nxt: Mat, window: bool = True):
    """Global translation via phase correlation (OpenCV
    ``phaseCorrelate``): ((dx, dy) float32, peak response). Flow sign
    convention: content moved by +d from prev to nxt (ops/registration.py)."""
    import numpy as np

    from ..ops import registration as _reg

    gp = _gray_of_mat(prev)
    gn = _gray_of_mat(nxt)
    if prev.is_on_device or nxt.is_on_device:
        import jax.numpy as jnp

        d, resp = _reg.phase_correlate(jnp.asarray(gp), jnp.asarray(gn),
                                       window=window)
        return np.asarray(d), float(resp)
    d, resp = _reg.phase_correlate_numpy(np.asarray(gp), np.asarray(gn),
                                         window=window)
    return d, resp


def _pair(a: Mat, b: Mat):
    """Aligned array pair (device if either is device-resident). Host
    gray Mats are (H, W, 1) while device ones are (H, W) — trailing
    1-channels squeeze so mixed-residency pairs broadcast."""
    def _sq(x):
        return x[..., 0] if x.ndim == 3 and x.shape[-1] == 1 else x

    if a.is_on_device or b.is_on_device:
        import jax.numpy as jnp

        return (jnp.asarray(_sq(a.device() if a.is_on_device else a.to_numpy())),
                jnp.asarray(_sq(b.device() if b.is_on_device else b.to_numpy())),
                True)
    return _sq(a.to_numpy()), _sq(b.to_numpy()), False


def add(a: Mat, b: Mat) -> Mat:
    """Saturating u8 add (ops/arith.py)."""
    from ..ops import arith as _ar

    x, y, dev = _pair(a, b)
    out = _ar.add_u8(x, y)
    return Mat.from_device(out) if dev else Mat.from_array(__import__("numpy").asarray(out))


def subtract(a: Mat, b: Mat) -> Mat:
    """Saturating u8 subtract."""
    from ..ops import arith as _ar

    x, y, dev = _pair(a, b)
    out = _ar.subtract_u8(x, y)
    return Mat.from_device(out) if dev else Mat.from_array(__import__("numpy").asarray(out))


def absdiff(a: Mat, b: Mat) -> Mat:
    """|a − b| per element."""
    from ..ops import arith as _ar

    x, y, dev = _pair(a, b)
    out = _ar.absdiff_u8(x, y)
    return Mat.from_device(out) if dev else Mat.from_array(__import__("numpy").asarray(out))


def add_weighted(a: Mat, alpha: float, b: Mat, beta: float,
                 gamma: float = 0.0) -> Mat:
    """αa + βb + γ with u8 saturation (OpenCV ``addWeighted``)."""
    from ..ops import arith as _ar

    x, y, dev = _pair(a, b)
    out = _ar.add_weighted_u8(x, float(alpha), y, float(beta), float(gamma))
    return Mat.from_device(out) if dev else Mat.from_array(__import__("numpy").asarray(out))


def convert_scale_abs(mat: Mat, alpha: float = 1.0, beta: float = 0.0) -> Mat:
    """|αx + β| saturated to u8 (OpenCV ``convertScaleAbs``)."""
    from ..ops import arith as _ar

    return _apply(
        mat,
        lambda d: _ar.convert_scale_abs_u8(d, float(alpha), float(beta)),
        lambda h: _ar.convert_scale_abs_numpy(h, alpha, beta),
    )


def bitwise_and(a: Mat, b: Mat) -> Mat:
    from ..ops import arith as _ar

    x, y, dev = _pair(a, b)
    out = _ar.bitwise_and(x, y)
    return Mat.from_device(out) if dev else Mat.from_array(__import__("numpy").asarray(out))


def bitwise_or(a: Mat, b: Mat) -> Mat:
    from ..ops import arith as _ar

    x, y, dev = _pair(a, b)
    out = _ar.bitwise_or(x, y)
    return Mat.from_device(out) if dev else Mat.from_array(__import__("numpy").asarray(out))


def bitwise_xor(a: Mat, b: Mat) -> Mat:
    from ..ops import arith as _ar

    x, y, dev = _pair(a, b)
    out = _ar.bitwise_xor(x, y)
    return Mat.from_device(out) if dev else Mat.from_array(__import__("numpy").asarray(out))


def bitwise_not(mat: Mat) -> Mat:
    from ..ops import arith as _ar

    return _apply(mat, _ar.bitwise_not, lambda h: ~h)


def count_non_zero(mat: Mat) -> int:
    from ..ops import arith as _ar
    import numpy as np

    a = mat.device() if mat.is_on_device else mat.to_numpy()
    if mat.is_on_device:
        return int(_ar.count_non_zero(a))
    return int(np.count_nonzero(a))


def norm(mat: Mat, kind: str = "l2") -> float:
    """L1 / L2 / inf norm (OpenCV ``norm`` NORM_L1/L2/INF)."""
    from ..ops import arith as _ar

    if mat.is_on_device:
        return float(_ar.norm_u8(mat.device(), kind=kind))
    return _ar.norm_numpy(mat.to_numpy(), kind=kind)


def mean_std_dev(mat: Mat):
    """(mean, population stddev) as floats (OpenCV ``meanStdDev``)."""
    from ..ops import arith as _ar
    import numpy as np

    if mat.is_on_device:
        m, s = _ar.mean_stddev_u8(mat.device())
        return float(m), float(s)
    f = mat.to_numpy().astype(np.float64)
    return float(f.mean()), float(f.std())


def psnr(a: Mat, b: Mat) -> float:
    """PSNR in dB (OpenCV ``PSNR``)."""
    from ..ops import arith as _ar

    x, y, _ = _pair(a, b)
    import jax.numpy as jnp
    import numpy as np

    return _ar.psnr_u8(jnp.asarray(np.asarray(x)), jnp.asarray(np.asarray(y)))


def detect_mser_regions(mat, delta: int = 5, min_area: int = 60,
                        max_area: int = 14400, max_variation: float = 0.25,
                        min_diversity: float = 0.2,
                        polarity: str = "both"):
    """Maximally stable extremal regions (OpenCV ``MSER.detectRegions``
    role; frozen component-tree spec in ops/mser.py, native C++ hot
    path). Returns (regions: list of int32 (K, 2) (x, y) arrays,
    bboxes: int32 (N, 4) (x, y, w, h))."""
    import numpy as np

    from ..ops.mser import mser_regions as _mser

    if isinstance(mat, Mat):
        gray = np.asarray(_gray_of_mat(mat))
    else:
        a = np.asarray(mat)
        gray = golden.bgr_to_gray(a) if a.ndim == 3 else a
    return _mser(gray, delta=delta, min_area=min_area, max_area=max_area,
                 max_variation=max_variation, min_diversity=min_diversity,
                 polarity=polarity)


def detect_line_segments(mat, **kw):
    """Line segments (OpenCV ximgproc ``FastLineDetector`` role; frozen
    chain-trace + Douglas-Peucker spec in ops/lsd.py) → float64 (N, 4)
    rows (x1, y1, x2, y2). Device Canny feeds the host tracer; pass
    ``edges=`` to reuse an on-device edge map."""
    import numpy as np

    from ..ops.lsd import detect_line_segments as _detect

    if kw.get("edges") is not None:
        return _detect(None, **kw)
    if isinstance(mat, Mat):
        gray = np.asarray(_gray_of_mat(mat))
    else:
        a = np.asarray(mat)
        gray = golden.bgr_to_gray(a) if a.ndim == 3 else a
    return _detect(gray, **kw)


def find_chessboard_corners(mat, pattern_size, refine: bool = True):
    """Inner chessboard corners (OpenCV ``findChessboardCorners`` role;
    frozen pipeline spec in ops/chessboard.py). Accepts a Mat or array,
    gray or BGR. Returns (found, corners float64 (rows·cols, 2)
    row-major — the ``calibrate_camera`` object-point traversal)."""
    import numpy as np

    from ..ops.chessboard import find_chessboard_corners as _find

    if isinstance(mat, Mat):
        gray = np.asarray(_gray_of_mat(mat))
    else:
        a = np.asarray(mat)
        gray = golden.bgr_to_gray(a) if a.ndim == 3 else a
    return _find(gray, pattern_size, refine=refine)


def find_chessboard_corners_sb(mat, pattern_size,
                               normalize: bool = False,
                               refine: bool = True):
    """Sector-based chessboard detection (OpenCV
    ``findChessboardCornersSB`` role; frozen spec in
    ops/chessboard_sb.py — corner-likelihood convolutions on device +
    host lattice growth). Same canonical ordering contract as
    :func:`find_chessboard_corners`; more robust under blur/low
    contrast. ``normalize`` = CALIB_CB_NORMALIZE_IMAGE role."""
    import numpy as np

    from ..ops.chessboard_sb import find_chessboard_corners_sb as _find

    if isinstance(mat, Mat):
        gray = np.asarray(_gray_of_mat(mat))
    else:
        a = np.asarray(mat)
        gray = golden.bgr_to_gray(a) if a.ndim == 3 else a
    return _find(gray, pattern_size, normalize=normalize, refine=refine)


def draw_chessboard_corners(mat: Mat, pattern_size, corners,
                            found: bool) -> None:
    """Overlay detected corners in place (OpenCV
    ``drawChessboardCorners`` role): found → color-cycled circles
    chained row by row; not found → red circles only."""
    import numpy as np

    pts = np.asarray(corners, np.float64).reshape(-1, 2)
    if not found:
        for p in pts:
            circle(mat, Point(int(round(p[0])), int(round(p[1]))), 4,
                   Scalar(0, 0, 255), 1)
        return
    colors = [(0, 0, 255), (0, 128, 255), (0, 255, 255), (0, 255, 0),
              (255, 128, 0), (255, 0, 0), (255, 0, 255)]
    cols = int(pattern_size[0])
    prev = None
    for i, p in enumerate(pts):
        c = Scalar(*colors[(i // cols) % len(colors)])
        cur = Point(int(round(p[0])), int(round(p[1])))
        circle(mat, cur, 4, c, 1)
        if prev is not None:
            line(mat, prev, cur, c, 1)
        prev = cur


# --- camera model (host tables + device remap, ops/calib.py) -------------
from ..ops.calib import (  # noqa: E402  (re-exports)
    calibrate_camera,
    fisheye_init_undistort_rectify_map,
    fisheye_project_points,
    fisheye_undistort,
    fisheye_undistort_points,
    get_optimal_new_camera_matrix,
    init_undistort_rectify_map,
    project_points,
    reproject_image_to_3d,
    rodrigues,
    solve_pnp,
    solve_pnp_ransac,
    stereo_calibrate,
    stereo_rectify,
    decompose_homography_mat,
    estimate_affine_3d,
    undistort_points,
)
from ..ops.epipolar import (  # noqa: E402  (re-exports)
    compute_correspond_epilines,
    correct_matches,
    decompose_essential_mat,
    find_essential_mat,
    find_fundamental_mat,
    recover_pose,
    triangulate_points,
)
from ..ops.sift import match_descriptors_l2  # noqa: E402
from ..ops.geometry import find_homography  # noqa: E402
from ..ops.transform import (  # noqa: E402  (re-exports)
    dct,
    dft,
    get_optimal_dft_size,
    idct,
    idft,
    mul_spectrums,
)
from ..ops.core_ops import (  # noqa: E402  (re-exports)
    RNG,
    calc_covar_matrix,
    cart_to_polar,
    compare,
    copy_make_border,
    determinant,
    eigen,
    fast_atan2,
    find_non_zero,
    gemm,
    get_affine_transform,
    hconcat,
    invert,
    magnitude,
    mahalanobis,
    mix_channels,
    pca_back_project,
    pca_compute,
    pca_project,
    perspective_transform,
    phase,
    polar_to_cart,
    scale_add,
    set_identity,
    solve,
    split,
    sv_back_subst,
    sv_decomp,
    vconcat,
)
from ..ops.decolor import decolor  # noqa: E402
from ..ops.scissors import IntelligentScissors  # noqa: E402
from ..ops.barcode import detect_and_decode as detect_barcodes  # noqa: E402
from ..ops.barcode import encode_ean13  # noqa: E402
from ..ops.threed import (  # noqa: E402  (re-exports)
    depth_to_3d,
    find_planes,
    load_point_cloud,
    depth_to_3d_sparse,
    load_mesh,
    register_depth,
    rescale_depth,
    rgbd_normals,
    save_mesh,
    save_point_cloud,
    triangle_rasterize,
    warp_frame,
)
from ..ops.blend import (  # noqa: E402  (re-exports)
    gain_compensation,
    multi_band_blend,
    voronoi_seam,
)
from ..ops.calib_ext import (  # noqa: E402  (re-exports)
    calibrate_camera_extended,
    calibration_matrix_values,
    draw_frame_axes,
    filter_homography_decomp_by_visible_refpoints,
    register_cameras,
    solve_pnp_epnp,
    solve_pnp_generic,
    solve_p3p,
    compose_rt,
    decompose_projection_matrix,
    estimate_translation_2d,
    estimate_translation_3d,
    filter_speckles,
    init_camera_matrix_2d,
    read_optical_flow,
    sampson_distance,
    stereo_rectify_uncalibrated,
    write_optical_flow,
)
from ..ops.registration import (  # noqa: E402
    phase_correlate_iterative,
)
from ..ops.optflow import build_optical_flow_pyramid  # noqa: E402
from ..ops.knn_index import KnnIndex, radius_search  # noqa: E402
from ..ops.subdiv import Subdiv2D  # noqa: E402
from ..ops.rotwarp import RotationWarper  # noqa: E402
from ..ops.odometry import rgbd_odometry  # noqa: E402
from ..ops.tsdf import TsdfVolume  # noqa: E402
from ..ops.asift import affine_detect_and_compute  # noqa: E402
from ..ops.octree import Octree  # noqa: E402
from ..ops.core_ops import check_range, get_rect_sub_pix  # noqa: E402
from ..ops.calib_ext import (  # noqa: E402
    init_inverse_rectification_map,
)
from ..ops.ecc import find_transform_ecc_multiscale  # noqa: E402
from ..ops.dsst_scale import ScaleEstimator  # noqa: E402
from ..ops.text import get_text_size  # noqa: E402
from ..ops.colorchecker import (  # noqa: E402
    color_checker_ccm,
    detect_color_checker,
)
from ..ops.chessboard import (  # noqa: E402
    estimate_chessboard_sharpness,
)
from ..ops.circles_grid import (  # noqa: E402  (re-exports)
    circles_grid_object_points,
    find_circles_grid,
)
from ..ops.corner import (  # noqa: E402  (re-exports)
    corner_eigen_vals_and_vecs,
    corner_min_eigen_val,
    pre_corner_detect,
    spatial_gradient,
)
from ..ops.core_ops import (  # noqa: E402  (round-3b batch re-exports)
    accumulate,
    accumulate_product,
    accumulate_square,
    blend_linear,
    blur,
    box_filter,
    compare_hist,
    complete_symm,
    convert_points_from_homogeneous,
    convert_points_to_homogeneous,
    create_hanning_window,
    cube_root,
    extract_channel,
    has_non_zero,
    insert_channel,
    invert_affine_transform,
    mul_transposed,
    patch_nans,
    rand_shuffle,
    reduce_arg_max,
    reduce_arg_min,
    solve_cubic,
    solve_poly,
    sqr_box_filter,
    sum_elems,
    trace,
)
from ..ops.core_ops import (  # noqa: E402  (tail re-exports)
    apply_ccm,
    batch_distance,
    color_correction_matrix,
    copy_to,
    div_spectrums,
    eigen_non_symmetric,
    integral2,
    integral3,
    solve_lp,
    border_interpolate,
    build_mst,
    rectangle_intersection_area,
    threshold_with_mask,
    finite_mask,
    flip_nd,
    mat_mul_deriv,
    transpose_nd,
)
from ..ops.shape import (  # noqa: E402
    approx_poly_n,
    min_enclosing_convex_polygon,
    min_enclosing_triangle,
)
from ..ops.core_ops import divide_u8 as divide  # noqa: E402
from ..ops.core_ops import merge_channels as merge  # noqa: E402
from ..ops.core_ops import multiply_u8 as multiply  # noqa: E402
from ..ops.core_ops import transpose_mat as transpose  # noqa: E402
from ..ops.ghough import (  # noqa: E402  (re-exports)
    build_r_table,
    ghough_detect,
    ghough_detect_guil,
)
from ..ops.slic import slic_superpixels  # noqa: E402
from ..ops.varref import variational_refine  # noqa: E402
from ..ops.viz import (  # noqa: E402  (re-exports)
    clip_line,
    draw_keypoints,
    draw_matches,
    ellipse2poly,
)
from ..ops.core_ops import reduce_mat as reduce  # noqa: E402
from ..ops.core_ops import repeat_mat as repeat  # noqa: E402
from ..ops.core_ops import sort_idx  # noqa: E402
from ..ops.core_ops import sort_mat as sort  # noqa: E402
from ..ops.core_ops import transform_points as transform  # noqa: E402


def undistort(mat: Mat, K, dist, new_K=None) -> Mat:
    """Undistort a u8 image (OpenCV ``undistort``): 5-coefficient
    radial-tangential model; host map build + device packed-quad remap
    (ops/calib.py)."""
    import numpy as np

    from ..ops import calib as _calib

    a = mat.device() if mat.is_on_device else mat.to_numpy()
    out = _calib.undistort(a, K, dist, new_K)
    if mat.is_on_device:
        return Mat.from_device(out)
    return Mat.from_array(np.asarray(out))


def watershed(mat: Mat, markers) -> "np.ndarray":
    """Marker-based watershed (OpenCV ``watershed``): int32 markers
    (0 unknown, >0 seeds) → int32 labels with −1 watershed lines.
    Minimax-semiring scan flood, no priority queue (ops/watershed.py)."""
    from ..ops import watershed as _ws

    return _ws.watershed(_gray_of_mat(mat), markers)


from ..ops.filters import get_structuring_element  # noqa: E402
from ..ops.shape import (  # noqa: E402
    fit_ellipse,
    fit_ellipse_ams,
    fit_ellipse_direct,
    fit_line,
)
from ..ops.ccl import distance_transform_l2_with_labels  # noqa: E402
from ..ops.warp import convert_maps  # noqa: E402
from ..ops.viz import draw_marker  # noqa: E402


def erode_kernel(mat: Mat, kernel) -> Mat:
    """Erosion over an arbitrary bool structuring element (see
    :func:`get_structuring_element`)."""
    from ..ops import filters as _filters

    return _apply(
        mat,
        lambda d: _filters.erode_kernel_u8(d, kernel),
        lambda h: golden.erode_kernel(h, kernel),
    )


def dilate_kernel(mat: Mat, kernel) -> Mat:
    """Dilation over an arbitrary bool structuring element."""
    from ..ops import filters as _filters

    return _apply(
        mat,
        lambda d: _filters.dilate_kernel_u8(d, kernel),
        lambda h: golden.dilate_kernel(h, kernel),
    )


def get_gaussian_kernel(ksize: int, sigma: float = -1.0):
    """1-D Gaussian taps (OpenCV ``getGaussianKernel``): float64 [k]
    normalized to sum 1; sigma<=0 uses OpenCV's 0.3*((k-1)*0.5-1)+0.8."""
    import numpy as np

    if ksize < 1 or ksize % 2 == 0:
        raise ValueError("ksize must be odd and positive")
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    t = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(t * t) / (2.0 * sigma * sigma))
    return k / k.sum()


def get_gabor_kernel(ksize, sigma: float, theta: float, lambd: float,
                     gamma: float, psi: float = 3.14159265358979 / 2):
    """Gabor filter taps (OpenCV ``getGaborKernel``): float64 (kh, kw),
    g = exp(−(x'² + γ²y'²)/2σ²)·cos(2πx'/λ + ψ) with x', y' the
    θ-rotated coordinates; ``ksize`` int or (width, height), each
    dimension auto-sized from σ when ≤ 0 (OpenCV's 3·max(σ, σ/γ)
    half-extent rule)."""
    import numpy as np

    if np.isscalar(ksize):
        kw = kh = int(ksize)
    else:
        kw, kh = int(ksize[0]), int(ksize[1])
    sigma_x = float(sigma)
    sigma_y = sigma_x / float(gamma)
    c, s = np.cos(theta), np.sin(theta)
    if kw <= 0:
        kw = 2 * int(round(max(abs(3 * sigma_x * c), abs(3 * sigma_y * s)))) + 1
    if kh <= 0:
        kh = 2 * int(round(max(abs(3 * sigma_x * s), abs(3 * sigma_y * c)))) + 1
    xs = np.arange(kw, dtype=np.float64) - (kw - 1) / 2
    ys = np.arange(kh, dtype=np.float64) - (kh - 1) / 2
    x, y = np.meshgrid(xs, ys)
    xr = x * c + y * s
    yr = -x * s + y * c
    ex = -0.5 / (sigma_x * sigma_x)
    ey = -0.5 / (sigma_y * sigma_y)
    return np.exp(ex * xr * xr + ey * yr * yr) * np.cos(
        2.0 * np.pi / float(lambd) * xr + float(psi))


def sep_filter_2d(mat: Mat, kx, ky) -> Mat:
    """Separable correlation (OpenCV ``sepFilter2D``): outer(ky, kx)
    through :func:`filter2d` (the rank-1 fast path applies)."""
    import numpy as np

    return filter2d(mat, np.outer(np.asarray(ky, np.float64),
                                  np.asarray(kx, np.float64)))


GC_BGD, GC_FGD, GC_PR_BGD, GC_PR_FGD = 0, 1, 2, 3


def grab_cut(mat: Mat, mask=None, rect=None, iter_count: int = 5,
             seed: int = 0):
    """GrabCut foreground extraction (OpenCV ``grabCut``): GMM color
    models + a REAL min-cut (native C++ Dinic over the 8-connected
    grid). Returns the GC_* mask (ops/grabcut.py)."""
    import numpy as np

    from ..ops import grabcut as _gc

    a = mat.to_numpy() if not mat.is_on_device else np.asarray(mat.device())
    if a.ndim == 2:
        raise ValueError("grab_cut needs a BGR image")
    return _gc.grab_cut(a, mask=mask, rect=rect, iter_count=iter_count,
                        seed=seed)


def detect_blobs(mat: Mat, params=None):
    """Blob detection (OpenCV ``SimpleBlobDetector``): [K, 3] float64
    (cx, cy, diameter). Thresholds + device CCL + host contour geometry,
    merged across levels (ops/blob.py)."""
    import numpy as np

    from ..ops import blob as _blob

    g = _gray_of_mat(mat)
    p = params if params is not None else _blob.BlobParams()
    return _blob.detect_blobs(np.asarray(g), p)


def fast_nl_means_denoising_multi(frames, img_index: int,
                                  temporal_window: int, h: float = 10.0,
                                  template: int = 7, search: int = 21):
    """Temporal NL-means (OpenCV ``fastNlMeansDenoisingMulti`` role):
    denoise one frame of a u8 gray stack using a temporal window of
    neighbors. Device-resident stacks run the scanned jitted twin
    (ops/nlmeans.py)."""
    import numpy as np

    from ..ops import nlmeans as _nl

    if any(getattr(m, "is_on_device", False) for m in frames):
        import jax.numpy as jnp

        stack = jnp.stack([m.device() for m in frames])
        return np.asarray(_nl.nl_means_multi(
            stack, img_index, temporal_window, h=h, template=template,
            search=search))
    arrays = np.stack([m.to_numpy() if hasattr(m, "to_numpy")
                       else np.asarray(m) for m in frames])
    return _nl.nl_means_multi_numpy(arrays, img_index, temporal_window,
                                    h=h, template=template,
                                    search=search)


def solve_pnp_refine(obj_pts, img_pts, k, dist, rvec, tvec,
                     iterations: int = 20):
    """OpenCV ``solvePnPRefineLM``/``VVS`` role: Gauss-Newton
    refinement of an existing pose through the full distortion model
    (the same minimizer solve_pnp ends with; ops/calib.py)."""
    import numpy as np

    from ..ops import calib as _calib

    return _calib.refine_pose(
        np.asarray(obj_pts, np.float64).reshape(-1, 3),
        np.asarray(img_pts, np.float64).reshape(-1, 2),
        np.asarray(k, np.float64), dist,
        np.asarray(rvec, np.float64).ravel(),
        np.asarray(tvec, np.float64).ravel(), iterations)


def tonemap_mantiuk(hdr_img, gamma: float = 1.0, scale: float = 0.7,
                    saturation: float = 1.0):
    """Mantiuk gradient-domain tonemap (OpenCV ``TonemapMantiuk``
    role): contrast scaling in the log-luminance gradient field +
    exact DCT Poisson reintegration (ops/hdr.py)."""
    from ..ops import hdr as _hdr

    return _hdr.tonemap_mantiuk_numpy(hdr_img, gamma, scale, saturation)


def kmeans(data, k: int, iters: int = 10):
    """Generic k-means (OpenCV ``kmeans`` role): (N, D) float data →
    (compactness, labels (N,), centers (K, D)). Deterministic k-means++
    init (ops/kmeans.py); device path for jax arrays."""
    import numpy as np

    from ..ops import kmeans as _km

    centers, labels, inertia = _km.kmeans(
        np.asarray(data, np.float32), k, iters=iters)
    return (float(np.asarray(inertia)), np.asarray(labels),
            np.asarray(centers))


def cvt_color_two_plane(y_plane, uv_plane):
    """NV12 two-plane → BGR (OpenCV ``cvtColorTwoPlane`` with
    COLOR_YUV2BGR_NV12 role): separate (H, W) Y and (H/2, W/2, 2) or
    (H/2, W) interleaved UV planes, via the frozen BT.601 NV12 kernel
    (ops/golden.py)."""
    import numpy as np

    from ..ops import golden as _golden

    y = np.asarray(y_plane)
    uv = np.asarray(uv_plane)
    h, w = y.shape
    buf = np.concatenate([y.reshape(-1), uv.reshape(-1)]).astype(
        np.uint8)
    return _golden.nv12_to_bgr(buf, w, h)


def fast_nl_means_denoising_colored_multi(frames, img_index: int,
                                          temporal_window: int,
                                          h: float = 10.0,
                                          h_color: float = 10.0,
                                          template: int = 7,
                                          search: int = 21):
    """Colored temporal NL-means (OpenCV
    ``fastNlMeansDenoisingColoredMulti`` role): Lab split over the
    temporal spec (ops/nlmeans.py)."""
    import numpy as np

    from ..ops import nlmeans as _nl

    arrays = np.stack([m.to_numpy() if hasattr(m, "to_numpy")
                       else np.asarray(m) for m in frames])
    return _nl.nl_means_colored_multi_numpy(
        arrays, img_index, temporal_window, h=h, h_color=h_color,
        template=template, search=search)
