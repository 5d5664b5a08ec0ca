"""device-side JPEG reconstruction: dequant → 8×8 IDCT (matmuls) →
chroma upsampling → YCbCr→BGR.

The host half (:func:`rustcv_tpu.native.jpeg_entropy_decode`) performs the
sequential Huffman entropy decode; this module does everything numeric
on-device. The 8×8 IDCT is expressed as two batched matmuls
(``Mᵀ · F · M``) — a natural matrix unit op over thousands of blocks per frame
(SURVEY.md §7 hard-part #1's plan, realized).

Frozen reconstruction spec (our oracle; libjpeg differs by ≤1-2 LSB due to
its fixed-point islow IDCT — parity vs PIL is tolerance-tested):
- float32 IDCT with basis M[u,x] = 0.5·C(u)·cos((2x+1)uπ/16),
  sample = clamp(round(idct + 128)) per component;
- chroma upsampling = libjpeg's *fancy* (triangular) integer filters
  (h2v2: vertical 3:1 then horizontal (3t+tn+8|7)>>4; h2v1: (3s+sn+1|2)>>2),
  nearest for other factors;
- color: R = Y + 1.402·Cr', G = Y − 0.344136·Cb' − 0.714136·Cr',
  B = Y + 1.772·Cb' (float32, rounded, clamped), BGR output.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp


@lru_cache(maxsize=1)
def idct_basis() -> np.ndarray:
    """M[u, x] = 0.5·C(u)·cos((2x+1)uπ/16), float32 (computed in float64)."""
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    m = 0.5 * np.cos((2 * x + 1) * u * np.pi / 16)
    m[0, :] *= 1 / np.sqrt(2)
    return m.astype(np.float32)


@lru_cache(maxsize=1)
def idct_kmat() -> np.ndarray:
    """The 2-D IDCT as ONE [64, 64] matrix: K[u·8+v, x·8+y] = M[u,x]·M[v,y].

    ``spatial = Mᵀ·F·M`` over thousands of 8×8 blocks is then a single
    ``[nblocks, 64] @ [64, 64]`` matmul on the natural block-row layout
    — no per-block reshapes (relayouts) before the compute. The matmul
    form is bit-identical to the two-sided einsum at HIGHEST precision."""
    m = idct_basis().astype(np.float64)
    return np.einsum("ux,vy->uvxy", m, m).reshape(64, 64).astype(np.float32)


# ---------------------------------------------------------------------------
# Device ops
# ---------------------------------------------------------------------------


@jax.jit
def dequant_idct_plane(coeffs: jax.Array, qt: jax.Array) -> jax.Array:
    """(bh, bw, 8, 8) i16 coeffs + (8, 8) quant → u8 samples (bh*8, bw*8).

    Dequant fuses into the input scaling; the 2-D IDCT is ONE
    ``[nblocks, 64] @ [64, 64]`` matmul at HIGHEST precision (see
    :func:`idct_kmat` — bit-identical to the two-sided ``Mᵀ·F·M`` einsum
    and ~6× cheaper once composed with the packed unpack)."""
    bh, bw = coeffs.shape[0], coeffs.shape[1]
    k = jnp.asarray(idct_kmat())
    f = coeffs.reshape(bh * bw, 64).astype(jnp.float32) * qt.reshape(64).astype(
        jnp.float32
    )
    spatial = jax.lax.dot(f, k, precision=jax.lax.Precision.HIGHEST)
    samples = jnp.clip(jnp.round(spatial + 128.0), 0, 255).astype(jnp.int32)
    return samples.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)


def _fancy_h2(x: jax.Array, axis: int) -> Tuple[jax.Array, jax.Array]:
    """Neighbor taps (prev, next) along axis with replicate border."""
    first = jax.lax.slice_in_dim(x, 0, 1, axis=axis)
    last = jax.lax.slice_in_dim(x, x.shape[axis] - 1, x.shape[axis], axis=axis)
    prev = jnp.concatenate([first, jax.lax.slice_in_dim(x, 0, x.shape[axis] - 1, axis=axis)], axis=axis)
    nxt = jnp.concatenate([jax.lax.slice_in_dim(x, 1, x.shape[axis], axis=axis), last], axis=axis)
    return prev, nxt


def _interleave(a: jax.Array, b: jax.Array, axis: int) -> jax.Array:
    """Interleave two equal arrays along ``axis`` (a first)."""
    stacked = jnp.stack([a, b], axis=axis + 1 if axis >= 0 else a.ndim + axis + 1)
    shape = list(a.shape)
    shape[axis] = shape[axis] * 2
    return stacked.reshape(shape)


@jax.jit
def upsample_h2v1_fancy(c: jax.Array) -> jax.Array:
    """libjpeg h2v1 fancy: out[2i]=(3s+prev+1)>>2, out[2i+1]=(3s+next+2)>>2."""
    prev, nxt = _fancy_h2(c, axis=-1)
    even = (3 * c + prev + 1) >> 2
    odd = (3 * c + nxt + 2) >> 2
    return _interleave(even, odd, axis=-1)


@jax.jit
def upsample_h2v2_fancy(c: jax.Array) -> jax.Array:
    """libjpeg h2v2 fancy: vertical 3:1 (t=3·cur+near), then horizontal
    (3t + t_near + 8|7) >> 4."""
    prev_r, next_r = _fancy_h2(c, axis=-2)
    t_even = 3 * c + prev_r  # output row 2r
    t_odd = 3 * c + next_r  # output row 2r+1
    t = _interleave(t_even, t_odd, axis=-2)
    prev_c, next_c = _fancy_h2(t, axis=-1)
    even = (3 * t + prev_c + 8) >> 4
    odd = (3 * t + next_c + 7) >> 4
    return _interleave(even, odd, axis=-1)


def upsample(c: jax.Array, fh: int, fv: int) -> jax.Array:
    if (fh, fv) == (1, 1):
        return c
    if (fh, fv) == (2, 2):
        return upsample_h2v2_fancy(c)
    if (fh, fv) == (2, 1):
        return upsample_h2v1_fancy(c)
    # Generic nearest for exotic factors.
    out = jnp.repeat(c, fv, axis=-2)
    return jnp.repeat(out, fh, axis=-1)


def unpack_coeffs(pos: jax.Array, val: jax.Array, total: int) -> jax.Array:
    """FLAT-packed nonzeros → dense coefficient vector (int16).

    One scatter-add per stream — kept only as a reference/utility; the
    production path is :func:`unpack_block_coeffs` (one-hot reduce)."""
    return jnp.zeros(total, jnp.int16).at[pos].add(val)


def choose_block_packing(nnzb: np.ndarray) -> Tuple[int, int]:
    """Pick (K, dense-row capacity) from a frame's per-block nonzero counts.

    Camera-quality block histograms are bimodal: most blocks hold ≤4
    nonzeros, a small tail is nearly dense. Pick the K ∈ {2, 4, 6, 8} that
    minimizes wire bytes (K slots/block at 3 B + 132 B per busy block),
    with 4× headroom on the busy-block capacity for busier later frames.
    """
    nb = nnzb.size
    best_k, best_bytes, best_busy = 4, None, 0
    for k in (2, 4, 6, 8):
        busy = int((nnzb > k).sum())
        bytes_ = nb * k * 3 + busy * 132
        if best_bytes is None or bytes_ < best_bytes:
            best_k, best_bytes, best_busy = k, bytes_, busy
    cap = int(-(-max(1024, 4 * best_busy) // 1024) * 1024)
    return best_k, min(cap, nb)


def unpack_block_coeffs(
    idx: jax.Array, val: jax.Array, dense_ids: jax.Array, dense_rows: jax.Array
) -> jax.Array:
    """BLOCK-packed coefficients → dense block rows (int16, [nblocks, 64]).

    Keeps the block-row layout (NOT flattened): the consumer slices
    component ranges along the block axis and feeds them straight into the
    [64, 64] IDCT matmul (flattening here would force XLA relayouts).

    ``idx``/``val``: [nblocks, K] per-block slots (uint8 natural coefficient
    index / int16 value, zero-filled when unused — a (0, 0) slot adds value
    0 at index 0, a no-op). ``dense_ids``/``dense_rows``: busy blocks
    shipped whole; padded entries carry the sentinel id == nblocks, which
    lands on a scratch row that is dropped. The per-block unpack is a
    one-hot compare-multiply-reduce over K (pure elementwise work instead
    of a flat scatter-add) plus one row-granular scatter for the few
    busy blocks.
    """
    nblocks = idx.shape[0]
    j = jnp.arange(64, dtype=jnp.int32)
    oh = idx.astype(jnp.int32)[..., None] == j  # [nblocks, K, 64] (fused)
    blocks = jnp.where(oh, val[..., None].astype(jnp.int32), 0).sum(axis=-2)
    blocks = jnp.concatenate(
        [blocks.astype(jnp.int16), jnp.zeros((1, 64), jnp.int16)]
    )
    blocks = blocks.at[dense_ids].set(dense_rows)
    return blocks[:nblocks]


@jax.jit
def ycbcr_to_bgr_planes(y: jax.Array, cb: jax.Array, cr: jax.Array):
    """YCbCr planes → (b, g, r) u8 planes — same frozen color spec as
    :func:`ycbcr_to_bgr` without the trailing-3 interleave (callers keep
    plane/packed-rows layouts; byte-identical values)."""
    yf = y.astype(jnp.float32)
    d = cb.astype(jnp.float32) - 128.0
    e = cr.astype(jnp.float32) - 128.0
    r = yf + 1.402 * e
    g = yf - 0.344136 * d - 0.714136 * e
    b = yf + 1.772 * d
    return tuple(
        jnp.clip(jnp.round(p), 0, 255).astype(jnp.uint8) for p in (b, g, r)
    )


@jax.jit
def ycbcr_to_bgr(y: jax.Array, cb: jax.Array, cr: jax.Array) -> jax.Array:
    b, g, r = ycbcr_to_bgr_planes(y, cb, cr)
    return jnp.stack([b, g, r], axis=-1)


def decode_jpeg_tpu(data) -> jax.Array:
    """Full hybrid decode: host entropy → device reconstruction.

    Returns a device (H, W, 3) u8 BGR array (grayscale streams broadcast).
    """
    from .. import native

    info, coeffs, qts = native.jpeg_entropy_decode(data)
    h, w = info["height"], info["width"]
    hmax = max(info["h_samp"])
    vmax = max(info["v_samp"])

    planes = []
    for c in range(info["ncomp"]):
        plane = dequant_idct_plane(jax.device_put(coeffs[c]), jax.device_put(qts[c].astype(np.int32)))
        fh = hmax // info["h_samp"][c]
        fv = vmax // info["v_samp"][c]
        plane = upsample(plane, fh, fv)
        planes.append(plane[:h, :w])

    if info["ncomp"] == 1:
        yp = planes[0].astype(jnp.uint8)
        return jnp.stack([yp, yp, yp], axis=-1)
    return ycbcr_to_bgr(planes[0], planes[1], planes[2])


# ---------------------------------------------------------------------------
# NumPy oracle (same frozen spec, float64 IDCT then round — used by tests)
# ---------------------------------------------------------------------------


def decode_jpeg_numpy(data) -> np.ndarray:
    from .. import native

    info, coeffs, qts = native.jpeg_entropy_decode(data)
    h, w = info["height"], info["width"]
    hmax = max(info["h_samp"])
    vmax = max(info["v_samp"])
    m = idct_basis().astype(np.float64)

    planes = []
    for c in range(info["ncomp"]):
        f = coeffs[c].astype(np.float64) * qts[c].astype(np.float64)
        spatial = np.einsum("ux,abuv,vy->abxy", m, f, m)
        samples = np.clip(np.round(spatial + 128.0), 0, 255).astype(np.int64)
        bh, bw = samples.shape[:2]
        plane = samples.transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        fh = hmax // info["h_samp"][c]
        fv = vmax // info["v_samp"][c]
        if (fh, fv) == (2, 2):
            prev_r = np.vstack([plane[:1], plane[:-1]])
            next_r = np.vstack([plane[1:], plane[-1:]])
            t = np.empty((plane.shape[0] * 2, plane.shape[1]), np.int64)
            t[0::2] = 3 * plane + prev_r
            t[1::2] = 3 * plane + next_r
            prev_c = np.hstack([t[:, :1], t[:, :-1]])
            next_c = np.hstack([t[:, 1:], t[:, -1:]])
            out = np.empty((t.shape[0], t.shape[1] * 2), np.int64)
            out[:, 0::2] = (3 * t + prev_c + 8) >> 4
            out[:, 1::2] = (3 * t + next_c + 7) >> 4
            plane = out
        elif (fh, fv) == (2, 1):
            prev_c = np.hstack([plane[:, :1], plane[:, :-1]])
            next_c = np.hstack([plane[:, 1:], plane[:, -1:]])
            out = np.empty((plane.shape[0], plane.shape[1] * 2), np.int64)
            out[:, 0::2] = (3 * plane + prev_c + 1) >> 2
            out[:, 1::2] = (3 * plane + next_c + 2) >> 2
            plane = out
        elif (fh, fv) != (1, 1):
            plane = np.repeat(np.repeat(plane, fv, axis=0), fh, axis=1)
        planes.append(plane[:h, :w])

    if info["ncomp"] == 1:
        yp = planes[0].astype(np.uint8)
        return np.stack([yp, yp, yp], axis=-1)
    y = planes[0].astype(np.float64)
    d = planes[1].astype(np.float64) - 128.0
    e = planes[2].astype(np.float64) - 128.0
    out = np.stack(
        [y + 1.772 * d, y - 0.344136 * d - 0.714136 * e, y + 1.402 * e], axis=-1
    )
    return np.clip(np.round(out), 0, 255).astype(np.uint8)
