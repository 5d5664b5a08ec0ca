"""Device (XLA) color conversions — bit-exact vs :mod:`golden`.

All arithmetic is int32 with explicit shifts/clamps so XLA cannot reassociate
into anything that changes u8 results (SURVEY.md §7 hard-part #2). Every
function accepts either a single frame or a leading batch dimension — shapes
are static under ``jit`` and the batch axis is the natural sharding axis for
multi-device execution (``parallel/mesh.py``).

Reference formulas: ``rustcv-camera/src/decode.rs:160-219``,
``rustcv/src/videoio/mod.rs:344-399`` (see golden.py for the exact spec).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp


def _bt601(y, u, v):
    """BT.601 integer kernel; y/u/v int32, returns u8 stacked BGR last-axis."""
    c = y - 16
    d = u - 128
    e = v - 128
    b = (298 * c + 516 * d + 128) >> 8
    g = (298 * c - 100 * d - 208 * e + 128) >> 8
    r = (298 * c + 409 * e + 128) >> 8
    out = jnp.stack([b, g, r], axis=-1)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


def _unpack_yuyv_words(src: jax.Array, width: int, height: int):
    """Deinterleave YUYV via u8→u32 bitcast: one layout conversion instead of
    four strided gathers (u8 packs 4 per 32-bit word; word-wise shifts are pure
    elementwise work). Returns int32 planes (…, H, W/2): y0, u, y1, v."""
    batch = src.shape[:-1] if src.shape[-1] == height * width * 2 else src.shape[:-2]
    words = jax.lax.bitcast_convert_type(
        src.reshape(*batch, height, width // 2, 4), jnp.uint32
    ).astype(jnp.int32)
    return words & 255, (words >> 8) & 255, (words >> 16) & 255, (words >> 24) & 255


def _interleave_pair_bgr(b0, g0, r0, b1, g1, r1, width: int, height: int):
    """Pack per-pair BGR planes (…, H, W/2) i32 → packed rows (…, H, W*3)
    u8 via three u16 words + bitcast (little-endian byte order:
    [b0,g0][r0,b1][g1,r1] = the 6-byte BGR pair).

    Packed-rows is the device-native BGR layout (see module note below):
    a trailing dim of 3 pads badly in device tilings, while (H, W*3) is
    dense AND matches Mat's host layout byte-for-byte. The three u16 word
    planes are stacked and swapped so XLA can fold the stride-3 interleave
    into the consumer's layout.
    """
    batch = b0.shape[:-2]
    w0 = (b0 | (g0 << 8)).astype(jnp.uint16)
    w1 = (r0 | (b1 << 8)).astype(jnp.uint16)
    w2 = (g1 | (r1 << 8)).astype(jnp.uint16)
    stacked = jnp.stack([w0, w1, w2], axis=-2)  # (..., H, 3, W/2)
    packed = jnp.swapaxes(stacked, -1, -2)      # (..., H, W/2, 3)
    bytes_ = jax.lax.bitcast_convert_type(packed, jnp.uint8)
    return bytes_.reshape(*batch, height, width * 3)


@partial(jax.jit, static_argnames=("width", "height"))
def yuyv_to_bgr_packed(src: jax.Array, width: int, height: int) -> jax.Array:
    """YUYV → packed-rows BGR u8 (…, H, W*3) — the device-native layout
    (dense layout; identical bytes to the interleaved form)."""
    y0, u, y1, v = _unpack_yuyv_words(src, width, height)
    b0, g0, r0, b1, g1, r1 = _bt601_pair(y0, y1, u, v)
    return _interleave_pair_bgr(b0, g0, r0, b1, g1, r1, width, height)


def _bt601_pair(y0, y1, u, v):
    """BT.601 for a YUYV pair in plane form → six i32 planes (clamped)."""
    c0 = 298 * (y0 - 16)
    c1 = 298 * (y1 - 16)
    d = u - 128
    e = v - 128
    tb = 516 * d + 128
    tg = -100 * d - 208 * e + 128
    tr = 409 * e + 128

    def cl(x):
        return jnp.clip(x >> 8, 0, 255)

    return cl(c0 + tb), cl(c0 + tg), cl(c0 + tr), cl(c1 + tb), cl(c1 + tg), cl(c1 + tr)


@partial(jax.jit, static_argnames=("width", "height"))
def yuyv_to_bgr(src: jax.Array, width: int, height: int) -> jax.Array:
    """YUYV packed 4:2:2 → BGR u8 (bit-exact vs golden.yuyv_to_bgr).

    ``src``: u8, shape (..., height*width*2) flat or (..., H, W*2);
    returns (..., H, W, 3). Prefer :func:`yuyv_to_bgr_packed` inside device
    pipelines — the HWC trailing-3 layout pads badly in device tilings.
    """
    out = yuyv_to_bgr_packed(src, width, height)
    return out.reshape(*out.shape[:-2], height, width, 3)


@partial(jax.jit, static_argnames=("width", "height"))
def yuyv_to_gray(src: jax.Array, width: int, height: int) -> jax.Array:
    """YUYV → gray u8 directly (≡ bgr_to_gray(yuyv_to_bgr(src)) bit-exact,
    without materializing BGR — the fast path for filter-only pipelines)."""
    y0, u, y1, v = _unpack_yuyv_words(src, width, height)
    b0, g0, r0, b1, g1, r1 = _bt601_pair(y0, y1, u, v)
    gr0 = (77 * r0 + 150 * g0 + 29 * b0 + 128) >> 8
    gr1 = (77 * r1 + 150 * g1 + 29 * b1 + 128) >> 8
    return _pack_gray_pairs(gr0, gr1, width, height)


def _unpack_uyvy_words(src: jax.Array, width: int, height: int):
    """UYVY macro-pixels via u8→u32 bitcast → int32 planes y0, u, y1, v."""
    batch = src.shape[:-1] if src.ndim > 1 and src.shape[-1] == height * width * 2 else src.shape[:-2]
    words = jax.lax.bitcast_convert_type(
        src.reshape(*batch, height, width // 2, 4), jnp.uint32
    ).astype(jnp.int32)
    # little-endian byte order U Y0 V Y1 (mask byte 3: the int32 cast of the
    # uint32 word sign-extends a plain >> 24)
    return (words >> 8) & 255, words & 255, (words >> 24) & 255, (words >> 16) & 255


@partial(jax.jit, static_argnames=("width", "height"))
def uyvy_to_bgr_packed(src: jax.Array, width: int, height: int) -> jax.Array:
    """UYVY → packed-rows BGR u8 (…, H, W*3) — device-native layout."""
    y0, u, y1, v = _unpack_uyvy_words(src, width, height)
    b0, g0, r0, b1, g1, r1 = _bt601_pair(y0, y1, u, v)
    return _interleave_pair_bgr(b0, g0, r0, b1, g1, r1, width, height)


@partial(jax.jit, static_argnames=("width", "height"))
def uyvy_to_gray(src: jax.Array, width: int, height: int) -> jax.Array:
    """UYVY → gray u8 directly (≡ bgr_to_gray(uyvy_to_bgr(src)) bit-exact)."""
    y0, u, y1, v = _unpack_uyvy_words(src, width, height)
    b0, g0, r0, b1, g1, r1 = _bt601_pair(y0, y1, u, v)
    gr0 = (77 * r0 + 150 * g0 + 29 * b0 + 128) >> 8
    gr1 = (77 * r1 + 150 * g1 + 29 * b1 + 128) >> 8
    return _pack_gray_pairs(gr0, gr1, width, height)


@partial(jax.jit, static_argnames=("width", "height"))
def uyvy_to_bgr(src: jax.Array, width: int, height: int) -> jax.Array:
    batch = src.shape[:-1] if src.ndim > 1 and src.shape[-1] == height * width * 2 else src.shape[:-2]
    out = uyvy_to_bgr_packed(src, width, height)
    return out.reshape(*batch, height, width, 3)


def _unpack_nv12_pairs(src: jax.Array, width: int, height: int):
    """NV12 → pair-form planes (…, H, W/2) int32: y0, y1, u, v.

    The Y plane is split into even/odd columns via a u8→u16 bitcast; the
    interleaved UV plane deinterleaves the same way and is row-doubled
    (2×2 chroma sites — one small repeat over the half-res plane).
    """
    batch = src.shape[:-1]
    flat = src.reshape(*batch, height * width * 3 // 2)
    yw = jax.lax.bitcast_convert_type(
        flat[..., : height * width].reshape(*batch, height, width // 2, 2),
        jnp.uint16,
    ).astype(jnp.int32)
    y0 = yw & 255
    y1 = yw >> 8
    uvw = jax.lax.bitcast_convert_type(
        flat[..., height * width :].reshape(*batch, height // 2, width // 2, 2),
        jnp.uint16,
    ).astype(jnp.int32)
    u = jnp.repeat(uvw & 255, 2, axis=-2)
    v = jnp.repeat(uvw >> 8, 2, axis=-2)
    return y0, y1, u, v


@partial(jax.jit, static_argnames=("width", "height"))
def nv12_to_bgr_packed(src: jax.Array, width: int, height: int) -> jax.Array:
    """NV12 → packed-rows BGR u8 (…, H, W*3) — device-native layout."""
    y0, y1, u, v = _unpack_nv12_pairs(src, width, height)
    b0, g0, r0, b1, g1, r1 = _bt601_pair(y0, y1, u, v)
    return _interleave_pair_bgr(b0, g0, r0, b1, g1, r1, width, height)


@partial(jax.jit, static_argnames=("width", "height"))
def nv12_to_bgr(src: jax.Array, width: int, height: int) -> jax.Array:
    """NV12 planar → BGR u8 (…, H, W, 3); bit-exact vs golden.nv12_to_bgr."""
    out = nv12_to_bgr_packed(src, width, height)
    return out.reshape(*out.shape[:-2], height, width, 3)


def _unpack_yv12_pairs(src: jax.Array, width: int, height: int):
    """YV12 → pair-form planes (…, H, W/2) int32: y0, y1, u, v (V plane
    first in the wire format; chroma row-doubled, columns map 1:1 onto
    pixel pairs)."""
    batch = src.shape[:-1]
    npix = width * height
    nq = npix // 4
    flat = src.reshape(*batch, npix * 3 // 2)
    yw = jax.lax.bitcast_convert_type(
        flat[..., :npix].reshape(*batch, height, width // 2, 2), jnp.uint16
    ).astype(jnp.int32)
    v = flat[..., npix : npix + nq].astype(jnp.int32).reshape(*batch, height // 2, width // 2)
    u = flat[..., npix + nq :].astype(jnp.int32).reshape(*batch, height // 2, width // 2)
    return yw & 255, yw >> 8, jnp.repeat(u, 2, axis=-2), jnp.repeat(v, 2, axis=-2)


def _pack_gray_pairs(gr0, gr1, width: int, height: int) -> jax.Array:
    """Interleave per-pair luma planes (…, H, W/2) → gray u8 (…, H, W)."""
    batch = gr0.shape[:-2]
    w16 = (gr0 | (gr1 << 8)).astype(jnp.uint16)
    return jax.lax.bitcast_convert_type(w16, jnp.uint8).reshape(*batch, height, width)


@partial(jax.jit, static_argnames=("width", "height"))
def yv12_to_bgr_packed(src: jax.Array, width: int, height: int) -> jax.Array:
    """YV12 (planar Y, V, U — V first) → packed-rows BGR u8 (…, H, W*3).

    Pair-form like NV12: Y even/odd columns via one u16 bitcast; the
    half-res chroma planes map 1:1 onto pixel pairs after a 2× row repeat
    (chroma column k IS pair k — no column work)."""
    y0, y1, u, v = _unpack_yv12_pairs(src, width, height)
    b0, g0, r0, b1, g1, r1 = _bt601_pair(y0, y1, u, v)
    return _interleave_pair_bgr(b0, g0, r0, b1, g1, r1, width, height)


@partial(jax.jit, static_argnames=("width", "height"))
def yv12_to_bgr(src: jax.Array, width: int, height: int) -> jax.Array:
    """YV12 planar → BGR u8 (…, H, W, 3); bit-exact vs golden."""
    batch = src.shape[:-1]
    out = yv12_to_bgr_packed(src, width, height)
    return out.reshape(*batch, height, width, 3)


@partial(jax.jit, static_argnames=("width", "height"))
def yv12_to_gray(src: jax.Array, width: int, height: int) -> jax.Array:
    """YV12 → gray u8 directly (≡ bgr_to_gray(yv12_to_bgr(src)) bit-exact).
    Luma still needs the full BT.601 round trip — the stored Y is not the
    output gray (range expansion + BGR rounding)."""
    y0, y1, u, v = _unpack_yv12_pairs(src, width, height)
    b0, g0, r0, b1, g1, r1 = _bt601_pair(y0, y1, u, v)
    gr0 = (77 * r0 + 150 * g0 + 29 * b0 + 128) >> 8
    gr1 = (77 * r1 + 150 * g1 + 29 * b1 + 128) >> 8
    return _pack_gray_pairs(gr0, gr1, width, height)


@partial(jax.jit, static_argnames=("width", "height"))
def nv12_to_gray(src: jax.Array, width: int, height: int) -> jax.Array:
    """NV12 → gray u8 directly (≡ bgr_to_gray(nv12_to_bgr(src)) bit-exact)."""
    y0, y1, u, v = _unpack_nv12_pairs(src, width, height)
    b0, g0, r0, b1, g1, r1 = _bt601_pair(y0, y1, u, v)
    gr0 = (77 * r0 + 150 * g0 + 29 * b0 + 128) >> 8
    gr1 = (77 * r1 + 150 * g1 + 29 * b1 + 128) >> 8
    return _pack_gray_pairs(gr0, gr1, width, height)


def _bgra_pixel_words(src: jax.Array, width: int, height: int):
    """BGRA bytes → four per-group-phase u32 pixel words (…, H, W/4)."""
    batch = src.shape[:-1]
    words = jax.lax.bitcast_convert_type(
        src.reshape(*batch, height, width // 4, 4, 4), jnp.uint32
    )  # (..., H, W/4, 4): word s = pixel 4q+s (little-endian b|g<<8|r<<16|a<<24)
    return [words[..., s] for s in range(4)]


@partial(jax.jit, static_argnames=("width", "height"))
def bgra_to_bgr_packed(src: jax.Array, width: int, height: int) -> jax.Array:
    """BGRA32 → packed-rows BGR u8 (…, H, W*3) by pure u32 byte compaction:
    16 input bytes (4 px) → 3 output words, no per-byte lane work.
    Requires width % 4 == 0 (falls back via bgra_to_bgr otherwise)."""
    batch = src.shape[:-1]
    p0, p1, p2, p3 = _bgra_pixel_words(src, width, height)
    w0 = (p0 & 0xFFFFFF) | ((p1 & 0xFF) << 24)
    w1 = ((p1 >> 8) & 0xFFFF) | ((p2 & 0xFFFF) << 16)
    w2 = ((p2 >> 16) & 0xFF) | ((p3 & 0xFFFFFF) << 8)
    packed = jnp.stack([w0, w1, w2], axis=-1).astype(jnp.uint32)
    bytes_ = jax.lax.bitcast_convert_type(packed, jnp.uint8)  # (..., 3, 4)
    return bytes_.reshape(*batch, height, width * 3)


@partial(jax.jit, static_argnames=("width", "height"))
def bgra_to_bgr(src: jax.Array, width: int, height: int) -> jax.Array:
    batch = src.shape[:-1]
    if width % 4 == 0:
        out = bgra_to_bgr_packed(src, width, height)
        return out.reshape(*batch, height, width, 3)
    m = src.reshape(*batch, height, width, 4)
    return m[..., :3]


@partial(jax.jit, static_argnames=("width", "height"))
def rgba_to_bgr(src: jax.Array, width: int, height: int) -> jax.Array:
    batch = src.shape[:-1]
    m = src.reshape(*batch, height, width, 4)
    return m[..., jnp.array([2, 1, 0])]


@partial(jax.jit, static_argnames=("width", "height"))
def rgb_to_bgr_packed(src: jax.Array, width: int, height: int) -> jax.Array:
    """RGB24 → packed-rows BGR u8 (…, H, W*3) by u32 word shuffles: each
    4-pixel group is 3 words in and 3 out, R/B swapped with shifts+masks.
    Requires width % 4 == 0."""
    batch = src.shape[:-1]
    words = jax.lax.bitcast_convert_type(
        src.reshape(*batch, height, width // 4, 3, 4), jnp.uint32
    )  # (..., H, W/4, 3); little-endian byte streams of r0g0b0 r1g1b1 …
    i0, i1, i2 = words[..., 0], words[..., 1], words[..., 2]
    r0 = i0 & 255;  g0 = (i0 >> 8) & 255;  b0 = (i0 >> 16) & 255;  r1 = i0 >> 24  # noqa: E702
    g1 = i1 & 255;  b1 = (i1 >> 8) & 255;  r2 = (i1 >> 16) & 255;  g2 = i1 >> 24  # noqa: E702
    b2 = i2 & 255;  r3 = (i2 >> 8) & 255;  g3 = (i2 >> 16) & 255;  b3 = i2 >> 24  # noqa: E702
    o0 = b0 | (g0 << 8) | (r0 << 16) | (b1 << 24)
    o1 = g1 | (r1 << 8) | (b2 << 16) | (g2 << 24)
    o2 = r2 | (b3 << 8) | (g3 << 16) | (r3 << 24)
    packed = jnp.stack([o0, o1, o2], axis=-1).astype(jnp.uint32)
    bytes_ = jax.lax.bitcast_convert_type(packed, jnp.uint8)
    return bytes_.reshape(*batch, height, width * 3)


@partial(jax.jit, static_argnames=("width", "height"))
def unpack_bgr_planes(src: jax.Array, width: int, height: int):
    """Packed BGR rows (…, H, W*3) → int32 planes (b, g, r), each (…, H, W),
    via the 3-word/4-pixel bitcast trick (no strided u8 gathers). Requires
    width % 4 == 0. Inverse of :func:`interleave_bgr_planes`."""
    batch = src.shape[:-1] if src.shape[-1] == height * width * 3 else src.shape[:-2]
    words = jax.lax.bitcast_convert_type(
        src.reshape(*batch, height, width // 4, 3, 4), jnp.uint32
    ).astype(jnp.int32)
    i0, i1, i2 = words[..., 0], words[..., 1], words[..., 2]
    b0 = i0 & 255;  g0 = (i0 >> 8) & 255;  r0 = (i0 >> 16) & 255;  b1 = (i0 >> 24) & 255  # noqa: E702
    g1 = i1 & 255;  r1 = (i1 >> 8) & 255;  b2 = (i1 >> 16) & 255;  g2 = (i1 >> 24) & 255  # noqa: E702
    r2 = i2 & 255;  b3 = (i2 >> 8) & 255;  g3 = (i2 >> 16) & 255;  r3 = (i2 >> 24) & 255  # noqa: E702

    def merge(p0, p1, p2, p3):
        return jnp.stack([p0, p1, p2, p3], axis=-1).reshape(*batch, height, width)

    return merge(b0, b1, b2, b3), merge(g0, g1, g2, g3), merge(r0, r1, r2, r3)


@partial(jax.jit, static_argnames=("width", "height"))
def interleave_bgr_planes(b, g, r, width: int, height: int) -> jax.Array:
    """int32/u8 planes (…, H, W) → packed BGR rows u8 (…, H, W*3) via three
    u32 words per 4-pixel group. Requires width % 4 == 0."""
    batch = b.shape[:-2]
    bb = b.astype(jnp.int32).reshape(*batch, height, width // 4, 4)
    gg = g.astype(jnp.int32).reshape(*batch, height, width // 4, 4)
    rr = r.astype(jnp.int32).reshape(*batch, height, width // 4, 4)
    b0, b1, b2, b3 = bb[..., 0], bb[..., 1], bb[..., 2], bb[..., 3]
    g0, g1, g2, g3 = gg[..., 0], gg[..., 1], gg[..., 2], gg[..., 3]
    r0, r1, r2, r3 = rr[..., 0], rr[..., 1], rr[..., 2], rr[..., 3]
    o0 = b0 | (g0 << 8) | (r0 << 16) | (b1 << 24)
    o1 = g1 | (r1 << 8) | (b2 << 16) | (g2 << 24)
    o2 = r2 | (b3 << 8) | (g3 << 16) | (r3 << 24)
    packed = jnp.stack([o0, o1, o2], axis=-1).astype(jnp.uint32)
    bytes_ = jax.lax.bitcast_convert_type(packed, jnp.uint8)
    return bytes_.reshape(*batch, height, width * 3)


@partial(jax.jit, static_argnames=("width", "height"))
def rgb_to_gray_packed_rows(src: jax.Array, width: int, height: int) -> jax.Array:
    """Packed RGB rows (…, H*W*3 bytes) → gray u8 (…, H, W), word-wise
    (≡ bgr_to_gray(rgb_to_bgr(src)) bit-exact). Requires width % 4 == 0."""
    batch = src.shape[:-1] if src.shape[-1] == height * width * 3 else src.shape[:-2]
    words = jax.lax.bitcast_convert_type(
        src.reshape(*batch, height, width // 4, 3, 4), jnp.uint32
    ).astype(jnp.int32)
    i0, i1, i2 = words[..., 0], words[..., 1], words[..., 2]
    r0 = i0 & 255;  g0 = (i0 >> 8) & 255;  b0 = (i0 >> 16) & 255;  r1 = (i0 >> 24) & 255  # noqa: E702
    g1 = i1 & 255;  b1 = (i1 >> 8) & 255;  r2 = (i1 >> 16) & 255;  g2 = (i1 >> 24) & 255  # noqa: E702
    b2 = i2 & 255;  r3 = (i2 >> 8) & 255;  g3 = (i2 >> 16) & 255;  b3 = (i2 >> 24) & 255  # noqa: E702

    def luma(r, g, b):
        return (77 * r + 150 * g + 29 * b + 128) >> 8

    w32 = (
        luma(r0, g0, b0)
        | (luma(r1, g1, b1) << 8)
        | (luma(r2, g2, b2) << 16)
        | (luma(r3, g3, b3) << 24)
    ).astype(jnp.uint32)
    return jax.lax.bitcast_convert_type(w32, jnp.uint8).reshape(*batch, height, width)


@partial(jax.jit, static_argnames=("width", "height"))
def bgr_to_gray_packed_rows(src: jax.Array, width: int, height: int) -> jax.Array:
    """Packed BGR rows (…, H*W*3 bytes) → gray u8 (…, H, W), word-wise
    (≡ bgr_to_gray on the HWC view, bit-exact). Requires width % 4 == 0.
    Same 3-word/4-pixel trick as :func:`rgb_to_gray_packed_rows` with the
    B/R byte roles swapped (little-endian b0g0r0 b1g1r1 … streams)."""
    batch = src.shape[:-1] if src.shape[-1] == height * width * 3 else src.shape[:-2]
    words = jax.lax.bitcast_convert_type(
        src.reshape(*batch, height, width // 4, 3, 4), jnp.uint32
    ).astype(jnp.int32)
    i0, i1, i2 = words[..., 0], words[..., 1], words[..., 2]
    b0 = i0 & 255;  g0 = (i0 >> 8) & 255;  r0 = (i0 >> 16) & 255;  b1 = (i0 >> 24) & 255  # noqa: E702
    g1 = i1 & 255;  r1 = (i1 >> 8) & 255;  b2 = (i1 >> 16) & 255;  g2 = (i1 >> 24) & 255  # noqa: E702
    r2 = i2 & 255;  b3 = (i2 >> 8) & 255;  g3 = (i2 >> 16) & 255;  r3 = (i2 >> 24) & 255  # noqa: E702

    def luma(r, g, b):
        return (77 * r + 150 * g + 29 * b + 128) >> 8

    w32 = (
        luma(r0, g0, b0)
        | (luma(r1, g1, b1) << 8)
        | (luma(r2, g2, b2) << 16)
        | (luma(r3, g3, b3) << 24)
    ).astype(jnp.uint32)
    return jax.lax.bitcast_convert_type(w32, jnp.uint8).reshape(*batch, height, width)


@partial(jax.jit, static_argnames=("width", "height"))
def rgb_to_bgr(src: jax.Array, width: int, height: int) -> jax.Array:
    batch = src.shape[:-1]
    if width % 4 == 0:
        out = rgb_to_bgr_packed(src, width, height)
        return out.reshape(*batch, height, width, 3)
    m = src.reshape(*batch, height, width, 3)
    return m[..., ::-1]


@partial(jax.jit, static_argnames=("pattern", "width", "height"))
def demosaic_bilinear_packed(
    raw: jax.Array, pattern: str, width: int, height: int
) -> jax.Array:
    """Integer bilinear Bayer demosaic → packed-rows BGR u8 (…, H, W*3).

    Bit-exact vs ``golden.demosaic_bilinear`` (then packed). The CFA is
    period-2 in x, so the image deinterleaves into even/odd column planes
    with ONE u8→u16 bitcast (no strided gathers); every neighbor sum is a
    shift of those planes, the per-site select collapses to row-parity masks
    (column parity is static per plane), and the output pair-interleaves
    through the same u16 word trick as the YUYV path. Requires width % 2 == 0.
    """
    from .golden import BAYER_PATTERNS

    spec = BAYER_PATTERNS[pattern]
    batch = raw.shape[:-1] if raw.shape[-1] == height * width else raw.shape[:-2]
    hw = width // 2
    # Deinterleave even/odd columns: u16 words, lo byte = even col.
    words = jax.lax.bitcast_convert_type(
        raw.reshape(*batch, height, hw, 2), jnp.uint16
    ).astype(jnp.int32)
    a_e = words & 255
    a_o = words >> 8

    def up(p):  # row -1 ↦ row 1 (reflect-101, matching golden's jnp.pad)
        return jnp.concatenate([p[..., 1:2, :], p[..., :-1, :]], axis=-2)

    def down(p):  # row H ↦ row H-2
        return jnp.concatenate([p[..., 1:, :], p[..., -2:-1, :]], axis=-2)

    def left_of_even(o):  # even col 2k: left = odd col 2k-1; col -1 ↦ col 1
        return jnp.concatenate([o[..., :, 0:1], o[..., :, :-1]], axis=-1)

    def right_of_odd(e):  # odd col 2k+1: right = even col 2k+2; col W ↦ W-2
        return jnp.concatenate([e[..., :, 1:], e[..., :, -1:]], axis=-1)

    def site_values(a_same, h_l, h_r):
        horiz = h_l + h_r
        vert = up(a_same) + down(a_same)
        diag = up(h_l) + up(h_r) + down(h_l) + down(h_r)
        g4 = (horiz + vert + 2) >> 2
        h2 = (horiz + 1) >> 1
        v2 = (vert + 1) >> 1
        d4 = (diag + 2) >> 2
        return g4, h2, v2, d4

    ge4, he2, ve2, de4 = site_values(a_e, left_of_even(a_o), a_o)
    go4, ho2, vo2, do4 = site_values(a_o, a_e, right_of_odd(a_e))

    row_par = jax.lax.broadcasted_iota(jnp.int32, (height, 1), 0) % 2
    (ry, rx), (by, bx) = spec["r"], spec["b"]

    def plane_bgr(a, g4, h2, v2, d4, colpar):
        # Per column-parity plane the site type depends only on row parity.
        is_r = (row_par == ry) & (rx == colpar)
        is_b = (row_par == by) & (bx == colpar)
        g_red_row = (row_par == ry) & ~is_r & ~is_b
        g_blue_row = (row_par == by) & ~is_r & ~is_b
        r = jnp.where(is_r, a, jnp.where(g_red_row, h2, jnp.where(g_blue_row, v2, d4)))
        b = jnp.where(is_b, a, jnp.where(g_blue_row, h2, jnp.where(g_red_row, v2, d4)))
        g = jnp.where(is_r | is_b, g4, a)
        return b, g, r

    b0, g0, r0 = plane_bgr(a_e, ge4, he2, ve2, de4, 0)
    b1, g1, r1 = plane_bgr(a_o, go4, ho2, vo2, do4, 1)
    clip = lambda x: jnp.clip(x, 0, 255)  # noqa: E731
    return _interleave_pair_bgr(
        clip(b0), clip(g0), clip(r0), clip(b1), clip(g1), clip(r1), width, height
    )


@partial(jax.jit, static_argnames=("pattern", "width", "height"))
def demosaic_bilinear(raw: jax.Array, pattern: str, width: int, height: int) -> jax.Array:
    """Integer bilinear Bayer demosaic → (..., H, W, 3) u8 BGR.

    Bit-exact vs golden.demosaic_bilinear; ``raw``: u8 flat (..., H*W) or
    (..., H, W). The reference only enumerates the Bayer FourCCs — the spec
    is frozen in golden.py. Even widths route through the packed-rows
    kernel (device-native layout) and reshape the byte-identical result.
    """
    if width % 2 == 0:
        batch = raw.shape[:-1] if raw.shape[-1] == height * width else raw.shape[:-2]
        packed = demosaic_bilinear_packed(raw, pattern, width, height)
        return packed.reshape(*batch, height, width, 3)
    from .golden import BAYER_PATTERNS

    spec = BAYER_PATTERNS[pattern]
    batch = raw.shape[:-1] if raw.shape[-1] == height * width else raw.shape[:-2]
    a = raw.reshape(*batch, height, width).astype(jnp.int32)
    pad = [(0, 0)] * len(batch) + [(1, 1), (1, 1)]
    # reflect-101 preserves CFA site parity at borders (see golden spec)
    p = jnp.pad(a, pad, mode="reflect")

    def sl(dy, dx):
        return p[..., 1 + dy : 1 + dy + height, 1 + dx : 1 + dx + width]

    cross = sl(-1, 0) + sl(1, 0) + sl(0, -1) + sl(0, 1)
    diag = sl(-1, -1) + sl(-1, 1) + sl(1, -1) + sl(1, 1)
    horiz = sl(0, -1) + sl(0, 1)
    vert = sl(-1, 0) + sl(1, 0)
    g4 = (cross + 2) >> 2
    h2 = (horiz + 1) >> 1
    v2 = (vert + 1) >> 1
    d4 = (diag + 2) >> 2

    ys = jax.lax.broadcasted_iota(jnp.int32, (height, width), 0) % 2
    xs = jax.lax.broadcasted_iota(jnp.int32, (height, width), 1) % 2
    mr = (ys == spec["r"][0]) & (xs == spec["r"][1])
    mb = (ys == spec["b"][0]) & (xs == spec["b"][1])
    g_in_red_row = (~mr & ~mb) & (ys == spec["r"][0])
    g_in_blue_row = (~mr & ~mb) & (ys == spec["b"][0])

    r = jnp.where(mr, a, jnp.where(g_in_red_row, h2, jnp.where(g_in_blue_row, v2, d4)))
    b = jnp.where(mb, a, jnp.where(g_in_blue_row, h2, jnp.where(g_in_red_row, v2, d4)))
    g = jnp.where(mr | mb, g4, a)
    out = jnp.stack([b, g, r], axis=-1)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


@jax.jit
def bgr_to_gray(bgr: jax.Array) -> jax.Array:
    """(77R + 150G + 29B + 128) >> 8, exact vs golden.bgr_to_gray."""
    b = bgr[..., 0].astype(jnp.int32)
    g = bgr[..., 1].astype(jnp.int32)
    r = bgr[..., 2].astype(jnp.int32)
    return ((77 * r + 150 * g + 29 * b + 128) >> 8).astype(jnp.uint8)


def _div_floor_exact(a: jax.Array, b: jax.Array) -> jax.Array:
    """Exact floor(a / b) for int32 0 <= a < 2^24, 1 <= b (no integer-divide
    vector instruction on the device — f32 reciprocal + one-step fix-up, same pattern
    as filters.isqrt_exact)."""
    q = jnp.floor(a.astype(jnp.float32) / b.astype(jnp.float32)).astype(jnp.int32)
    r = a - q * b
    q = jnp.where(r < 0, q - 1, q)
    r = a - q * b
    return jnp.where(r >= b, q + 1, q)


@jax.jit
def bgr_to_hsv(bgr: jax.Array) -> jax.Array:
    """(…, 3) u8 BGR → HSV u8 (H ∈ [0, 180)) — bit-exact vs
    golden.bgr_to_hsv (the spec is all-integer; see there)."""
    b = bgr[..., 0].astype(jnp.int32)
    g = bgr[..., 1].astype(jnp.int32)
    r = bgr[..., 2].astype(jnp.int32)
    v = jnp.maximum(jnp.maximum(b, g), r)
    mn = jnp.minimum(jnp.minimum(b, g), r)
    diff = v - mn
    s = jnp.where(
        v == 0, 0, _div_floor_exact(510 * diff + v, jnp.maximum(2 * v, 1))
    )
    r_is = r == v
    g_is = (g == v) & ~r_is
    num = jnp.where(r_is, g - b, jnp.where(g_is, b - r, r - g))
    base = jnp.where(r_is, 0, jnp.where(g_is, 120, 240))
    t = base * diff + 60 * num
    t = jnp.where(t < 0, t + 360 * diff, t)
    h = jnp.where(
        diff == 0,
        0,
        _div_floor_exact(t + diff, jnp.maximum(2 * diff, 1)) % 180,
    )
    return jnp.stack([h, s, v], axis=-1).astype(jnp.uint8)


@jax.jit
def bgr_to_ycrcb(bgr: jax.Array) -> jax.Array:
    """(…, 3) u8 BGR → YCrCb u8 — bit-exact vs golden.bgr_to_ycrcb
    (14-bit fixed-point constants, arithmetic-shift descale)."""
    b = bgr[..., 0].astype(jnp.int32)
    g = bgr[..., 1].astype(jnp.int32)
    r = bgr[..., 2].astype(jnp.int32)
    y = (4899 * r + 9617 * g + 1868 * b + 8192) >> 14
    cr = ((r - y) * 11682 + (128 << 14) + 8192) >> 14
    cb = ((b - y) * 9241 + (128 << 14) + 8192) >> 14
    out = jnp.stack([y, jnp.clip(cr, 0, 255), jnp.clip(cb, 0, 255)], axis=-1)
    return out.astype(jnp.uint8)


@jax.jit
def ycrcb_to_bgr(ycrcb: jax.Array) -> jax.Array:
    """(…, 3) u8 YCrCb → BGR u8 — bit-exact vs golden.ycrcb_to_bgr."""
    y = ycrcb[..., 0].astype(jnp.int32)
    cr = ycrcb[..., 1].astype(jnp.int32) - 128
    cb = ycrcb[..., 2].astype(jnp.int32) - 128
    r = y + ((22987 * cr + 8192) >> 14)
    g = y + ((-11698 * cr - 5638 * cb + 8192) >> 14)
    b = y + ((29049 * cb + 8192) >> 14)
    out = jnp.stack([b, g, r], axis=-1)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


@jax.jit
def hsv_to_bgr(hsv: jax.Array) -> jax.Array:
    """(…, 3) u8 HSV (H ∈ [0, 180)) → BGR u8 — bit-exact vs
    golden.hsv_to_bgr. The 6-sector select is a one-hot sum (per-pixel
    small-axis gathers are the slow form on the device; see CLAUDE.md)."""
    h = hsv[..., 0].astype(jnp.int32)
    s = hsv[..., 1].astype(jnp.int32)
    v = hsv[..., 2].astype(jnp.int32)
    sector = (h // 30) % 6  # h ≤ 255: tiny static range, XLA folds the div
    rem = h % 30

    def rdiv(a, d):
        return _div_floor_exact(2 * a + d, jnp.full_like(a, 2 * d))

    p = rdiv(v * (255 - s), 255)
    q = rdiv(v * (255 * 30 - s * rem), 255 * 30)
    t = rdiv(v * (255 * 30 - s * (30 - rem)), 255 * 30)
    # (B, G, R) per sector — indices into (v, p, q, t), golden's table.
    tabs = ((1, 3, 0), (1, 0, 2), (3, 0, 1), (0, 2, 1), (0, 1, 3), (2, 1, 0))
    vpqt = (v, p, q, t)
    chans = []
    for c in range(3):
        acc = jnp.zeros_like(v)
        for sec in range(6):
            acc = acc + jnp.where(sector == sec, vpqt[tabs[sec][c]], 0)
        chans.append(acc)
    out = jnp.stack(chans, axis=-1)
    out = jnp.where((s == 0)[..., None], v[..., None], out)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


@jax.jit
def bgr_to_lab(bgr: jax.Array) -> jax.Array:
    """(…, 3) u8 BGR → CIE L*a*b* u8 — float32 device path for the frozen
    float64 spec golden.bgr_to_lab (±1 LSB documented tolerance)."""
    from .golden import _LAB_M, _LAB_WHITE

    srgb = bgr[..., ::-1].astype(jnp.float32) / 255.0
    lin = jnp.where(
        srgb > 0.04045,
        ((srgb + 0.055) / 1.055) ** 2.4,
        srgb / 12.92,
    )
    xyz = lin @ jnp.asarray(_LAB_M.T, jnp.float32)
    d = jnp.float32(6.0 / 29.0)
    t = xyz / jnp.asarray(_LAB_WHITE, jnp.float32)
    f = jnp.where(t > d**3, jnp.cbrt(t), t / (3 * d * d) + 4.0 / 29.0)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    out = jnp.stack(
        [
            jnp.round((116.0 * fy - 16.0) * (255.0 / 100.0)),
            jnp.round(500.0 * (fx - fy)) + 128.0,
            jnp.round(200.0 * (fy - fz)) + 128.0,
        ],
        axis=-1,
    )
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


@jax.jit
def lab_to_bgr(lab: jax.Array) -> jax.Array:
    """(…, 3) u8 Lab → BGR u8 (inverse; golden.lab_to_bgr, ±1 LSB)."""
    import numpy as _np2

    from .golden import _LAB_M, _LAB_WHITE

    ell = lab[..., 0].astype(jnp.float32) * (100.0 / 255.0)
    a = lab[..., 1].astype(jnp.float32) - 128.0
    b = lab[..., 2].astype(jnp.float32) - 128.0
    fy = (ell + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    d = jnp.float32(6.0 / 29.0)

    def finv(f):
        return jnp.where(f > d, f**3, 3 * d * d * (f - 4.0 / 29.0))

    xyz = jnp.stack([finv(fx), finv(fy), finv(fz)], axis=-1) * jnp.asarray(
        _LAB_WHITE, jnp.float32
    )
    minv = _np2.linalg.inv(_LAB_M).T
    lin = xyz @ jnp.asarray(minv, jnp.float32)
    srgb = jnp.where(
        lin > 0.0031308,
        1.055 * jnp.maximum(lin, 0.0) ** (1.0 / 2.4) - 0.055,
        12.92 * lin,
    )
    out = jnp.round(srgb[..., ::-1] * 255.0)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


@jax.jit
def in_range(img: jax.Array, lower: jax.Array, upper: jax.Array) -> jax.Array:
    """Per-channel inclusive range mask → u8 {0, 255} (OpenCV inRange);
    bit-exact vs golden.in_range."""
    a = img.astype(jnp.int32)
    lo = jnp.asarray(lower, jnp.int32)
    hi = jnp.asarray(upper, jnp.int32)
    ok = jnp.all((a >= lo) & (a <= hi), axis=-1)
    return jnp.where(ok, 255, 0).astype(jnp.uint8)


@jax.jit
def moments_rows(mask: jax.Array) -> jax.Array:
    """Per-row moment partials [H, 2] int32: (Σ value, Σ value·x) per row.

    Full moments overflow int32 at 4K (m10 ≈ 2^45) and device has no int64 /
    float64 wide enough for exact device totals, so the device emits exact
    per-row partials (row Σv ≤ 255·4096 and row Σv·x ≤ 2^31 for W ≤ 4096)
    and the caller finishes in host int64 (a tiny [H, 2] D2H)."""
    a = mask.astype(jnp.int32)
    if a.ndim == 3:
        a = a[..., 0]
    w = a.shape[-1]
    xs = jnp.arange(w, dtype=jnp.int32)
    return jnp.stack([a.sum(axis=-1), (a * xs).sum(axis=-1)], axis=-1)


def moments(mask: jax.Array) -> dict:
    """Raw moments m00/m10/m01 (+ centroid) of a device u8 mask — exact
    (device per-row partials + host int64 finish; matches golden.moments).
    Widths beyond 4096 would overflow the int32 row partial (255·Σx >
    2^31), so those fall back to an exact host computation."""
    if mask.shape[-1] > 4096:
        from . import golden

        return golden.moments(np.asarray(mask))
    rows = np.asarray(moments_rows(mask)).astype(np.int64)
    m00 = int(rows[:, 0].sum())
    m10 = int(rows[:, 1].sum())
    m01 = int((rows[:, 0] * np.arange(rows.shape[0], dtype=np.int64)).sum())
    out = {"m00": m00, "m10": m10, "m01": m01}
    if m00 > 0:
        out["centroid"] = (m10 / m00, m01 / m00)
    return out


def yuyv_to_bgr_packed_overlay(
    src: jax.Array, width: int, height: int,
    rects: jax.Array, colors: jax.Array, thickness: jax.Array,
) -> jax.Array:
    """YUYV → packed BGR with the rectangle overlay composited on the PAIR
    planes, before the byte interleave — so the overlay fuses into the
    decode's elementwise DAG instead of costing a separate read+write of
    the BGR image after the interleave relayout (bit-exact vs
    rectangle_packed(yuyv_to_bgr_packed(...)), tests/test_headline_stages.py).

    src (N, H·W·2) u8; rects (N, 4) i32; colors (N, 3) u8; thickness i32.
    """
    from . import draw as _draw

    y0, u, y1, v = _unpack_yuyv_words(src, width, height)
    b0, g0, r0, b1, g1, r1 = _bt601_pair(y0, y1, u, v)
    ys = jax.lax.broadcasted_iota(jnp.int32, (height, 1), 0)
    xs_e = jax.lax.broadcasted_iota(jnp.int32, (1, width // 2), 1) * 2
    rects = jnp.asarray(rects, jnp.int32)
    colors = jnp.asarray(colors).astype(jnp.int32)
    thickness = jnp.asarray(thickness, jnp.int32)
    mask_e, expand = _draw._edge_masks(xs_e, ys, rects, thickness,
                                       width, height)
    mask_o, _ = _draw._edge_masks(xs_e + 1, ys, rects, thickness,
                                  width, height)
    cb, cg, cr = (expand(colors[..., i]) for i in range(3))
    b0 = jnp.where(mask_e, cb, b0)
    g0 = jnp.where(mask_e, cg, g0)
    r0 = jnp.where(mask_e, cr, r0)
    b1 = jnp.where(mask_o, cb, b1)
    g1 = jnp.where(mask_o, cg, g1)
    r1 = jnp.where(mask_o, cr, r1)
    return _interleave_pair_bgr(b0, g0, r0, b1, g1, r1, width, height)


# --------------------------------------------------------------------------
# cv2-exact u8 color conversions (numpy, facade path)
#
# These reproduce OpenCV 5.0's *fixed-point table* arithmetic digit for
# digit (full 256^3-cube validated in tests/test_cv2_differential.py).
# They are deliberately separate from the RustCV-spec device kernels above:
# the capture pipeline keeps the frozen golden.py BT.601 forms
# (decode.rs:160-191), while the drop-in cv2 facade needs OpenCV's own
# rounding (different coefficients and double-rounded division tables).


def _cv_hsv_tables():
    hsv_shift = 12
    i = np.arange(256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << hsv_shift) / i[1:]).astype(np.int64)
    hdiv = np.zeros(256, np.int64)
    hdiv[1:] = np.rint((180 << hsv_shift) / (6.0 * i[1:])).astype(np.int64)
    return sdiv, hdiv


_CV_HSV_SDIV, _CV_HSV_HDIV = _cv_hsv_tables()


def bgr_to_gray_cv(bgr: np.ndarray) -> np.ndarray:
    """OpenCV 5.0 COLOR_BGR2GRAY u8: 15-bit fixed point
    (9798 R + 19235 G + 3735 B + 2^14) >> 15 — full-cube exact."""
    b = bgr[..., 0].astype(np.int64)
    g = bgr[..., 1].astype(np.int64)
    r = bgr[..., 2].astype(np.int64)
    return ((3735 * b + 19235 * g + 9798 * r + (1 << 14)) >> 15).astype(
        np.uint8)


def bgr_to_hsv_cv(bgr: np.ndarray) -> np.ndarray:
    """OpenCV COLOR_BGR2HSV u8: the hsv_shift=12 division-table double
    rounding (color_hsv's sdiv/hdiv tables) — full-cube exact."""
    b = bgr[..., 0].astype(np.int64)
    g = bgr[..., 1].astype(np.int64)
    r = bgr[..., 2].astype(np.int64)
    v = np.maximum(b, np.maximum(g, r))
    diff = v - np.minimum(b, np.minimum(g, r))
    s = (diff * _CV_HSV_SDIV[v] + (1 << 11)) >> 12
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _CV_HSV_HDIV[diff] + (1 << 11)) >> 12
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def _cv_lab_tables():
    # sRGB gamma table 0..255 -> 0..2040 (gamma_shift = 3)
    i = np.arange(256, dtype=np.float64) / 255.0
    gam = np.where(i <= 0.04045, i / 12.92, ((i + 0.055) / 1.055) ** 2.4)
    gtab = np.rint(255.0 * 8 * gam).astype(np.int64)
    # f(t) table on the descaled XYZ grid (lab_shift2 = 15)
    x = np.arange(3072, dtype=np.float64) / (255.0 * 8)
    ctab = np.rint((1 << 15) * np.where(
        x < 216.0 / 24389.0, x * (841.0 / 108.0) + 16.0 / 116.0,
        np.cbrt(x))).astype(np.int64)
    # two entries where OpenCV's softfloat table construction rounds the
    # other way (FMA in the linear branch at 49, cbrt ULP at 628) —
    # pinned by the full-cube sweep
    ctab[49] -= 1
    ctab[628] += 1
    d65 = (0.950456, 1.0, 1.088754)
    srgb2xyz = ((0.412453, 0.357580, 0.180423),
                (0.212671, 0.715160, 0.072169),
                (0.019334, 0.119193, 0.950227))
    coef = np.array([[int(np.rint((1 << 12) * srgb2xyz[i][j] / d65[i]))
                      for j in range(3)] for i in range(3)], np.int64)
    return gtab, ctab, coef


_CV_LAB_GTAB, _CV_LAB_CTAB, _CV_LAB_COEF = _cv_lab_tables()


def bgr_to_lab_cv(bgr: np.ndarray) -> np.ndarray:
    """OpenCV COLOR_BGR2Lab u8: gamma + cube-root tables with
    lab_shift=12 / lab_shift2=15 descales — full-cube exact."""
    rr = _CV_LAB_GTAB[bgr[..., 2].astype(np.int64)]
    gg = _CV_LAB_GTAB[bgr[..., 1].astype(np.int64)]
    bb = _CV_LAB_GTAB[bgr[..., 0].astype(np.int64)]
    c = _CV_LAB_COEF

    def desc(v, n):
        return (v + (1 << (n - 1))) >> n

    f_x = _CV_LAB_CTAB[desc(rr * c[0, 0] + gg * c[0, 1] + bb * c[0, 2], 12)]
    f_y = _CV_LAB_CTAB[desc(rr * c[1, 0] + gg * c[1, 1] + bb * c[1, 2], 12)]
    f_z = _CV_LAB_CTAB[desc(rr * c[2, 0] + gg * c[2, 1] + bb * c[2, 2], 12)]
    lum = desc(296 * f_y - 1336934, 15)  # (116*255+50)//100, 16*255<<15
    a = desc(500 * (f_x - f_y) + (128 << 15), 15)
    b = desc(200 * (f_y - f_z) + (128 << 15), 15)
    out = np.stack([lum, a, b], axis=-1)
    return np.clip(out, 0, 255).astype(np.uint8)
