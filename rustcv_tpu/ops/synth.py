"""Device-side simulation frame synthesis.

A real camera DMAs frames into kernel buffers without touching the CPU; the
accelerator-native analog of a *simulated* camera is frame synthesis directly in device memory
— zero host↔device traffic on the capture path. These kernels are bit-exact
re-implementations of the host generators in
:mod:`rustcv_tpu.capture.simulation` (``synth_bgr`` / ``encode_yuyv`` /
``encode_nv12`` / ``encode_bgra``): a frame is a pure function of
``(width, height, format, seq)``, so host and device sources are
interchangeable and parity-testable.

``seq`` is a traced array (one per stream) — animating frames never
recompiles; ``vmap`` batches N streams in one fused program.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# Must stay identical to capture.simulation._BAR_COLORS_BGR.
_BAR_COLORS_BGR = np.array(
    [
        [235, 235, 235], [20, 235, 235], [235, 235, 20], [20, 235, 20],
        [235, 20, 235], [20, 20, 235], [235, 20, 20], [20, 20, 20],
    ],
    dtype=np.uint8,
)


def _pattern_planes(seq: jax.Array, xs: jax.Array, ys: jax.Array, width: int, height: int):
    """Evaluate the pattern at arbitrary integer coordinate grids.

    Closed-form in (x, y, seq) so callers can evaluate at full, half (YUYV
    pair) or quarter (NV12 chroma) resolution without any strided slicing.
    Returns (b, g, r) int32 planes shaped like xs/ys.
    """
    # Color bars via threshold compares — integer division has no vector
    # instruction (a `xs*8//W` per pixel costs a long emulation sequence),
    # so bar k ⇔ xs ∈ [ceil(k·W/8), ceil((k+1)·W/8)) is tested directly.
    # (Equivalent to clip(xs*8//max(W,1), 0, 7) for xs ∈ [0, W).)
    b = jnp.zeros_like(xs)
    g = jnp.zeros_like(xs)
    r = jnp.zeros_like(xs)
    wmax = max(width, 1)
    for idx, (bb, gg, rr) in enumerate(_BAR_COLORS_BGR.tolist()):
        lo = -(-idx * wmax // 8)  # smallest xs with xs*8//W == idx
        hi = -(-(idx + 1) * wmax // 8)
        m = (xs >= lo) if idx == 7 else ((xs >= lo) & (xs < hi))
        b = jnp.where(m, bb, b)
        g = jnp.where(m, gg, g)
        r = jnp.where(m, rr, r)

    gy0 = height * 2 // 3
    grad = (xs + ys + seq * 7) % 256
    in_grad = ys >= gy0
    b = jnp.where(in_grad, grad, b)
    g = jnp.where(in_grad, 255 - grad, g)
    r = jnp.where(in_grad, (grad * 2) % 256, r)

    sq = max(4, height // 8)
    span = max(1, width - sq)
    pos = (seq * max(2, width // 64)) % (2 * span)
    x0 = jnp.where(pos < span, pos, 2 * span - pos)
    y0 = max(0, height // 2 - sq // 2)
    in_sq = (ys >= y0) & (ys < y0 + sq) & (xs >= x0) & (xs < x0 + sq)
    b = jnp.where(in_sq, 255, b)
    g = jnp.where(in_sq, 255, g)
    r = jnp.where(in_sq, 255, r)
    return b, g, r


def _synth_bgr_one(seq: jax.Array, width: int, height: int) -> jax.Array:
    """One (H, W, 3) u8 frame for traced scalar ``seq`` (int32)."""
    seq = seq.astype(jnp.int32)
    ys = jax.lax.broadcasted_iota(jnp.int32, (height, width), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (height, width), 1)
    b, g, r = _pattern_planes(seq, xs, ys, width, height)
    return jnp.stack([b, g, r], axis=-1).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("width", "height"))
def synth_bgr(seqs: jax.Array, width: int, height: int) -> jax.Array:
    """Batched pattern frames: seqs [N] i32 → u8 [N, H, W, 3]."""
    return jax.vmap(lambda s: _synth_bgr_one(s, width, height))(seqs)


def _bt601_forward(bgr: jax.Array):
    b = bgr[..., 0].astype(jnp.int32)
    g = bgr[..., 1].astype(jnp.int32)
    r = bgr[..., 2].astype(jnp.int32)
    y = ((66 * r + 129 * g + 25 * b + 128) >> 8) + 16
    u = ((-38 * r - 74 * g + 112 * b + 128) >> 8) + 128
    v = ((112 * r - 94 * g - 18 * b + 128) >> 8) + 128
    return (
        jnp.clip(y, 0, 255), jnp.clip(u, 0, 255), jnp.clip(v, 0, 255),
    )


@jax.jit
def encode_yuyv(bgr: jax.Array) -> jax.Array:
    """(..., H, W, 3) u8 → packed YUYV flat (..., H*W*2) u8; matches
    capture.simulation.encode_yuyv bit-for-bit."""
    h, w = bgr.shape[-3], bgr.shape[-2]
    batch = bgr.shape[:-3]
    y, u, v = _bt601_forward(bgr)
    y2 = y.reshape(*batch, h, w // 2, 2)
    up = (u.reshape(*batch, h, w // 2, 2).sum(axis=-1) + 1) >> 1
    vp = (v.reshape(*batch, h, w // 2, 2).sum(axis=-1) + 1) >> 1
    out = jnp.stack([y2[..., 0], up, y2[..., 1], vp], axis=-1).astype(jnp.uint8)
    return out.reshape(*batch, h * w * 2)


def _pack_yuyv_words(y0, u0, y1, u1, v0, v1, batch, h, w):
    """Pair planes → YUYV wire words → u8 (little-endian bitcast)."""
    up = (u0 + u1 + 1) >> 1
    vp = (v0 + v1 + 1) >> 1
    words = (y0 | (up << 8) | (y1 << 16) | (vp << 24)).astype(jnp.uint32)
    return jax.lax.bitcast_convert_type(words, jnp.uint8).reshape(*batch, h * w * 2)


def _synth_yuyv_one(seq: jax.Array, width: int, height: int) -> jax.Array:
    """Wire-format YUYV frame, synthesized at pair resolution: the pattern is
    evaluated at even/odd columns directly (closed form), the BT.601 forward
    transform runs per plane, and one u32→u8 bitcast emits the packed bytes —
    no interleaved intermediate ever exists. Bit-exact vs
    encode_yuyv(synth_bgr(...))."""
    seq = seq.astype(jnp.int32)
    hw = width // 2
    ys = jax.lax.broadcasted_iota(jnp.int32, (height, hw), 0)
    js = jax.lax.broadcasted_iota(jnp.int32, (height, hw), 1)

    def yuv_at(xs):
        b, g, r = _pattern_planes(seq, xs, ys, width, height)
        y = ((66 * r + 129 * g + 25 * b + 128) >> 8) + 16
        u = ((-38 * r - 74 * g + 112 * b + 128) >> 8) + 128
        v = ((112 * r - 94 * g - 18 * b + 128) >> 8) + 128
        return (
            jnp.clip(y, 0, 255), jnp.clip(u, 0, 255), jnp.clip(v, 0, 255),
        )

    y0, u0, v0 = yuv_at(js * 2)
    y1, u1, v1 = yuv_at(js * 2 + 1)
    return _pack_yuyv_words(y0, u0, y1, u1, v0, v1, (), height, width)


@partial(jax.jit, static_argnames=("width", "height"))
def synth_yuyv(seqs: jax.Array, width: int, height: int) -> jax.Array:
    """Batched wire-format YUYV synthesis: [N] i32 → u8 [N, H*W*2]."""
    return jax.vmap(lambda s: _synth_yuyv_one(s, width, height))(seqs)


@jax.jit
def encode_nv12(bgr: jax.Array) -> jax.Array:
    """(..., H, W, 3) u8 → NV12 flat (..., H*W*3//2) u8 (2×2 chroma mean)."""
    h, w = bgr.shape[-3], bgr.shape[-2]
    batch = bgr.shape[:-3]
    y, u, v = _bt601_forward(bgr)
    u4 = u.reshape(*batch, h // 2, 2, w // 2, 2).sum(axis=(-3, -1))
    v4 = v.reshape(*batch, h // 2, 2, w // 2, 2).sum(axis=(-3, -1))
    uv = jnp.stack([(u4 + 2) >> 2, (v4 + 2) >> 2], axis=-1).astype(jnp.uint8)
    yf = y.astype(jnp.uint8).reshape(*batch, h * w)
    return jnp.concatenate([yf, uv.reshape(*batch, h * w // 2)], axis=-1)


@jax.jit
def encode_bgra(bgr: jax.Array) -> jax.Array:
    h, w = bgr.shape[-3], bgr.shape[-2]
    batch = bgr.shape[:-3]
    a = jnp.full((*batch, h, w, 1), 255, jnp.uint8)
    return jnp.concatenate([bgr, a], axis=-1).reshape(*batch, h * w * 4)


@jax.jit
def encode_rgb(bgr: jax.Array) -> jax.Array:
    h, w = bgr.shape[-3], bgr.shape[-2]
    batch = bgr.shape[:-3]
    return bgr[..., ::-1].reshape(*batch, h * w * 3)


def synth_raw(seqs: jax.Array, width: int, height: int, pixel_format) -> jax.Array:
    """Batched raw frames in wire format: [N] → u8 [N, raw_bytes]."""
    from ..core.pixel_format import PixelFormat

    if pixel_format == PixelFormat.YUYV:
        return synth_yuyv(seqs, width, height)
    bgr = synth_bgr(seqs, width, height)
    if pixel_format == PixelFormat.NV12:
        return encode_nv12(bgr)
    if pixel_format == PixelFormat.BGRA32:
        return encode_bgra(bgr)
    if pixel_format == PixelFormat.RGB24:
        return encode_rgb(bgr)
    if pixel_format == PixelFormat.BGR24:
        return bgr.reshape(*bgr.shape[:-3], height * width * 3)
    from ..core.errors import SimulationError

    raise SimulationError(f"device simulation cannot encode {pixel_format}")
