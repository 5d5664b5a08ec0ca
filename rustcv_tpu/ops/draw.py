"""Device drawing ops — rectangle and alpha-mask blending (put_text backend).

The reference draws in-place with per-pixel CPU loops
(``rustcv/src/imgproc/drawing.rs:67-163``). accelerator-native design: drawing is a
functional masked update over the whole image — one fused elementwise kernel,
amortized to zero when composed into the per-tick pipeline. Rectangle
parameters are **traced** (dynamic), so moving overlays never recompile.

Semantics match golden.rectangle (the faithful reference port) for all
in-bounds cases, including the reference's edge overdraw when ``thickness``
exceeds the rectangle dims. The single deviation: the reference's flat-index
bound check lets x ≥ cols writes bleed into the next row's start
(drawing.rs:83-88, a stride artifact); we clip at the column boundary.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _edge_masks(xs, ys, rect_xywh, thickness, w, h):
    """Shared rectangle edge-mask computation; xs/ys are pixel-coordinate
    iotas broadcastable against each other; rect fields may carry batch dims.
    Returns (mask, expand) where expand lifts (...,) params to image rank."""
    x, y, rw, rh = (rect_xywh[..., i] for i in range(4))
    x_min = jnp.maximum(x, 0)
    y_min = jnp.maximum(y, 0)
    x_max = jnp.minimum(x + rw, w)
    y_max = jnp.minimum(y + rh, h)
    degenerate = (x_min >= x_max) | (y_min >= y_max)

    def expand(v):
        return v[..., None, None]

    x_min_e, x_max_e = expand(x_min), expand(x_max)
    y_min_e, y_max_e = expand(y_min), expand(y_max)
    th = expand(thickness)

    x_span = (xs >= x_min_e) & (xs < x_max_e)
    y_span = (ys >= y_min_e) & (ys < y_max_e)
    top_bot = ((ys >= y_min_e) & (ys < y_min_e + th)) | (
        (ys >= y_max_e - th) & (ys < y_max_e)
    )
    left_right = ((xs >= x_min_e) & (xs < x_min_e + th)) | (
        (xs >= x_max_e - th) & (xs < x_max_e)
    )
    mask = (x_span & top_bot) | (y_span & left_right)
    return mask & ~expand(degenerate), expand


@jax.jit
def rectangle_packed(
    img: jax.Array, rect_xywh: jax.Array, color_bgr: jax.Array, thickness: jax.Array
) -> jax.Array:
    """Rectangle on packed-rows BGR u8 (..., H, W*3) — the device-native
    layout. Lane c holds pixel c//3, channel c%3; the mask and the per-lane
    color are computed directly in packed coordinates, so the whole op is
    elementwise on a full-lane-width array (no trailing-3 layout anywhere).
    Semantics identical to :func:`rectangle`.
    """
    h, w3 = img.shape[-2], img.shape[-1]
    w = w3 // 3
    rect_xywh = jnp.asarray(rect_xywh, jnp.int32)
    thickness = jnp.asarray(thickness, jnp.int32)
    color_bgr = jnp.asarray(color_bgr, jnp.uint8)

    ys = jax.lax.broadcasted_iota(jnp.int32, (h, 1), 0)
    cs = jax.lax.broadcasted_iota(jnp.int32, (1, w3), 1)
    xs = cs // 3
    ch = cs % 3

    mask, expand = _edge_masks(xs, ys, rect_xywh, thickness, w, h)
    b = expand(color_bgr[..., 0].astype(jnp.uint8))
    g = expand(color_bgr[..., 1].astype(jnp.uint8))
    r = expand(color_bgr[..., 2].astype(jnp.uint8))
    lane_color = jnp.where(ch == 0, b, jnp.where(ch == 1, g, r))
    return jnp.where(mask, lane_color, img)


@jax.jit
def rectangle(img: jax.Array, rect_xywh: jax.Array, color_bgr: jax.Array, thickness: jax.Array) -> jax.Array:
    """Draw a rectangle outline. img: (..., H, W, 3) u8; rect (..., 4) i32;
    color (..., 3) u8; thickness i32 scalar or (...,). Returns a new image.

    A rect (or color/thickness) with leading batch dims applies per-image.
    """
    h, w = img.shape[-3], img.shape[-2]
    rect_xywh = jnp.asarray(rect_xywh, jnp.int32)
    thickness = jnp.asarray(thickness, jnp.int32)
    color_bgr = jnp.asarray(color_bgr, jnp.uint8)

    ys = jax.lax.broadcasted_iota(jnp.int32, (h, 1), 0)  # (H, 1)
    xs = jax.lax.broadcasted_iota(jnp.int32, (1, w), 1)  # (1, W)
    mask, _ = _edge_masks(xs, ys, rect_xywh, thickness, w, h)
    color = color_bgr[..., None, None, :]  # (..., 1, 1, 3)
    return jnp.where(mask[..., None], color, img)


@jax.jit
def blend_mask_packed_batch(
    img: jax.Array, mask3: jax.Array, orgs: jax.Array, color_bgr: jax.Array
) -> jax.Array:
    """Batched text blend on packed-rows BGR (N, H, W*3).

    ``mask3``: (mh, mw*3) u8 — the coverage mask pre-expanded ×3 along
    columns on the host (np.repeat(mask, 3, axis=1)); shared by all streams.
    ``orgs``: (N, 2) i32 top-left (x, y) pixel placement per stream;
    ``color_bgr``: (3,) i32. Frozen integer blend (golden.blend_mask).
    Border clipping via padded-canvas (see blend_mask_at).
    """
    mh, mw3 = mask3.shape
    h, w3 = img.shape[-2], img.shape[-1]
    w = w3 // 3

    ch = jax.lax.broadcasted_iota(jnp.int32, (1, mw3), 1) % 3
    color = jnp.asarray(color_bgr, jnp.int32)
    lane_color = jnp.where(ch == 0, color[0], jnp.where(ch == 1, color[1], color[2]))
    a = mask3.astype(jnp.int32)

    def one(im, org):
        big = jnp.pad(im, [(mh, mh), (mw3, mw3)])
        px = jnp.clip(org[0] * 3 + mw3, 0, w3 + mw3)
        py = jnp.clip(org[1] + mh, 0, h + mh)
        region = jax.lax.dynamic_slice(big, (py, px), (mh, mw3)).astype(jnp.int32)
        blended = ((lane_color * a + region * (255 - a)) // 255).astype(jnp.uint8)
        big = jax.lax.dynamic_update_slice(big, blended, (py, px))
        return big[mh : mh + h, mw3 : mw3 + w3]

    return jax.vmap(one)(img, jnp.asarray(orgs, jnp.int32))


@jax.jit
def blend_masks_packed_batch(
    img: jax.Array, masks3: jax.Array, orgs: jax.Array, color_bgr: jax.Array
) -> jax.Array:
    """Per-stream text blend: like :func:`blend_mask_packed_batch` but with a
    distinct mask per stream (``masks3``: (N, mh, mw*3) u8 — pad differing
    strings to a common bucketed canvas on the host)."""
    mh, mw3 = masks3.shape[-2], masks3.shape[-1]
    h, w3 = img.shape[-2], img.shape[-1]

    ch = jax.lax.broadcasted_iota(jnp.int32, (1, mw3), 1) % 3
    color = jnp.asarray(color_bgr, jnp.int32)
    lane_color = jnp.where(ch == 0, color[0], jnp.where(ch == 1, color[1], color[2]))

    def one(im, m3, org):
        a = m3.astype(jnp.int32)
        big = jnp.pad(im, [(mh, mh), (mw3, mw3)])
        px = jnp.clip(org[0] * 3 + mw3, 0, w3 + mw3)
        py = jnp.clip(org[1] + mh, 0, h + mh)
        region = jax.lax.dynamic_slice(big, (py, px), (mh, mw3)).astype(jnp.int32)
        blended = ((lane_color * a + region * (255 - a)) // 255).astype(jnp.uint8)
        big = jax.lax.dynamic_update_slice(big, blended, (py, px))
        return big[mh : mh + h, mw3 : mw3 + w3]

    return jax.vmap(one)(img, masks3, jnp.asarray(orgs, jnp.int32))


@jax.jit
def blend_mask_at(img: jax.Array, mask: jax.Array, x0: jax.Array, y0: jax.Array, color_bgr: jax.Array) -> jax.Array:
    """Alpha-blend a fixed-size u8 coverage mask at dynamic (x0, y0).

    Frozen integer blend (see golden.blend_mask):
    ``new = (color·a + old·(255−a)) // 255`` with a ∈ [0,255].

    img: (H, W, 3) u8; mask: (mh, mw) u8 (static shape — use bucketed text
    canvases so varying strings don't recompile). Placement clips at borders
    via padded-canvas trick: we blend on a padded copy then slice back.
    """
    h, w = img.shape[-3], img.shape[-2]
    mh, mw = mask.shape
    # Pad so any clamped placement keeps the full mask in-bounds.
    pad = [(0, 0)] * (img.ndim - 3) + [(mh, mh), (mw, mw), (0, 0)]
    big = jnp.pad(img, pad)
    px = jnp.clip(jnp.asarray(x0, jnp.int32) + mw, 0, w + mw)
    py = jnp.clip(jnp.asarray(y0, jnp.int32) + mh, 0, h + mh)

    region = jax.lax.dynamic_slice(
        big, (py, px, 0), (mh, mw, 3)
    ).astype(jnp.int32)
    a = mask.astype(jnp.int32)[..., None]
    color = jnp.asarray(color_bgr, jnp.int32)
    blended = ((color * a + region * (255 - a)) // 255).astype(jnp.uint8)
    big = jax.lax.dynamic_update_slice(big, blended, (py, px, 0))
    return big[mh : mh + h, mw : mw + w, :]


def _lane_color(color: jax.Array, chan: jax.Array, shape) -> jax.Array:
    """Per-lane BGR byte for packed rows: color [3] (shared) or [..., 3]
    (per-image) → u8 broadcast to ``shape``."""
    if color.ndim == 1:
        return jnp.take(color, chan)
    arr = color[..., None, None, :]  # [..., 1, 1, 3]
    arr = jnp.broadcast_to(arr, (*shape, 3))
    idx = jnp.broadcast_to(chan, shape)[..., None]
    return jnp.take_along_axis(arr, idx, axis=-1)[..., 0].astype(jnp.uint8)


@jax.jit
def line_packed(
    img: jax.Array, p1: jax.Array, p2: jax.Array, color_bgr: jax.Array,
    thickness: jax.Array,
) -> jax.Array:
    """Line stroke on packed-rows BGR u8 (..., H, W*3) — exact integer
    distance-field spec (golden.line_mask): one fused elementwise kernel,
    endpoints/thickness traced (moving lines never recompile). Leading
    batch dims on the params draw per-image."""
    h, w3 = img.shape[-2], img.shape[-1]
    w = w3 // 3
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w3), 0)
    lane = jax.lax.broadcasted_iota(jnp.int32, (h, w3), 1)
    xs = lane // 3
    chan = lane % 3

    p1 = jnp.asarray(p1, jnp.int32)
    p2 = jnp.asarray(p2, jnp.int32)
    thickness = jnp.asarray(thickness, jnp.int32)

    def ex(v):
        return v[..., None, None]

    ax, ay = ex(p1[..., 0]), ex(p1[..., 1])
    bx, by = ex(p2[..., 0]), ex(p2[..., 1])
    abx = bx - ax
    aby = by - ay
    apx = xs - ax
    apy = ys - ay
    bpx = xs - bx
    bpy = ys - by
    # Exact INT32-safe spec (golden.line_mask): the floored perpendicular
    # distance (2|cross|)//isqrt(|AB|²) replaces the cross² comparison,
    # whose product overflows int32 at large coordinates.
    from .filters import isqrt_exact

    ab2 = abx * abx + aby * aby
    t2 = thickness * thickness
    t2e = ex(t2) if t2.ndim else t2
    te = ex(thickness) if thickness.ndim else thickness
    dot = apx * abx + apy * aby
    cross = jnp.abs(apx * aby - apy * abx)
    s = jnp.maximum(isqrt_exact(ab2), 1)
    from .color import _div_floor_exact

    perp = _div_floor_exact(2 * cross, jnp.broadcast_to(s, cross.shape))
    body = (dot >= 0) & (dot <= ab2) & (perp <= te)
    caps = (4 * (apx * apx + apy * apy) <= t2e) | (
        4 * (bpx * bpx + bpy * bpy) <= t2e
    )
    degenerate = ab2 == 0
    mask = jnp.where(degenerate, caps, body | caps)

    lane_color = _lane_color(jnp.asarray(color_bgr, jnp.uint8), chan, mask.shape)
    return jnp.where(mask, lane_color, img).astype(jnp.uint8)


@jax.jit
def circle_packed(
    img: jax.Array, center: jax.Array, radius: jax.Array,
    color_bgr: jax.Array, thickness: jax.Array,
) -> jax.Array:
    """Circle (ring; thickness < 0 = filled) on packed-rows BGR u8 —
    exact integer spec (golden.circle_mask), fully traced params."""
    h, w3 = img.shape[-2], img.shape[-1]
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w3), 0)
    lane = jax.lax.broadcasted_iota(jnp.int32, (h, w3), 1)
    xs = lane // 3
    chan = lane % 3

    center = jnp.asarray(center, jnp.int32)
    radius = jnp.asarray(radius, jnp.int32)
    thickness = jnp.asarray(thickness, jnp.int32)

    def ex(v):
        return v[..., None, None]

    cx, cy = ex(center[..., 0]), ex(center[..., 1])
    r = ex(radius) if radius.ndim else radius
    t = ex(thickness) if thickness.ndim else thickness
    # all magnitudes fit int32 up to 8K coordinates (d² ≤ 1.3e8, hi² ≤ 7e7)
    d2 = (xs - cx) * (xs - cx) + (ys - cy) * (ys - cy)
    filled = d2 <= r * r
    lo = jnp.maximum(0, 2 * r - t)
    hi = 2 * r + t
    ring = (4 * d2 >= lo * lo) & (4 * d2 <= hi * hi)
    mask = jnp.where(t < 0, filled, ring)

    lane_color = _lane_color(jnp.asarray(color_bgr, jnp.uint8), chan, mask.shape)
    return jnp.where(mask, lane_color, img).astype(jnp.uint8)


@jax.jit
def paint_mask_packed(img: jax.Array, mask: jax.Array,
                      color_bgr: jax.Array) -> jax.Array:
    """Paint a full-frame (H, W) u8 mask onto packed-rows BGR u8
    (..., H, W*3). Host-computed frozen masks (ellipse, text) paint
    through this — mask > 0 pixels take ``color_bgr``."""
    h, w3 = img.shape[-2], img.shape[-1]
    lane = jax.lax.broadcasted_iota(jnp.int32, (h, w3), 1)
    chan = lane % 3
    m3 = jnp.repeat(mask > 0, 3, axis=-1)
    lane_color = _lane_color(jnp.asarray(color_bgr, jnp.uint8), chan, (h, w3))
    return jnp.where(m3, lane_color, img).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("include_edges",))
def fill_poly_packed(img: jax.Array, pts: jax.Array, color_bgr: jax.Array,
                     include_edges: bool = True) -> jax.Array:
    """Filled polygon on packed-rows BGR u8 (..., H, W*3) — bit-identical
    to golden.fill_poly_mask: exact-integer even-odd ray crossing per
    pixel (one fused elementwise program; the K edge tests unroll — K is
    the static leading dim of ``pts`` [K, 2] i32), OR'd with thickness-1
    edge strokes. Vertex values are traced (moving polygons never
    recompile); vertex COUNT recompiles."""
    h, w3 = img.shape[-2], img.shape[-1]
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w3), 0)
    lane = jax.lax.broadcasted_iota(jnp.int32, (h, w3), 1)
    xs = lane // 3
    chan = lane % 3

    p = jnp.asarray(pts, jnp.int32)
    k = p.shape[0]
    from .filters import isqrt_exact
    from .color import _div_floor_exact

    inside = jnp.zeros((h, w3), bool)
    edge = jnp.zeros((h, w3), bool)
    for i in range(k):
        x1, y1 = p[i, 0], p[i, 1]
        x2, y2 = p[(i + 1) % k, 0], p[(i + 1) % k, 1]
        d = y2 - y1
        straddle = (y1 > ys) != (y2 > ys)
        t = (ys - y1) * (x2 - x1) - (xs - x1) * d
        inside = inside ^ (straddle & ((t > 0) == (d > 0)) & (d != 0))
        if include_edges:
            # thickness-1 stroke, exact golden.line_mask arithmetic
            abx, aby = x2 - x1, y2 - y1
            apx, apy = xs - x1, ys - y1
            bpx, bpy = xs - x2, ys - y2
            ab2 = abx * abx + aby * aby
            dot = apx * abx + apy * aby
            cross = jnp.abs(apx * aby - apy * abx)
            s = jnp.maximum(isqrt_exact(ab2), 1)
            perp = _div_floor_exact(2 * cross, jnp.broadcast_to(s, cross.shape))
            body = (dot >= 0) & (dot <= ab2) & (perp <= 1)
            caps = (4 * (apx * apx + apy * apy) <= 1) | (
                4 * (bpx * bpx + bpy * bpy) <= 1
            )
            stroke = jnp.where(ab2 == 0, caps, body | caps)
            edge = edge | stroke

    mask = inside | edge
    lane_color = _lane_color(jnp.asarray(color_bgr, jnp.uint8), chan, mask.shape)
    return jnp.where(mask, lane_color, img).astype(jnp.uint8)
