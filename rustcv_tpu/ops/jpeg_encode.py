"""device-side JPEG *encode*: BGR→YCbCr → chroma subsampling → forward DCT
(one [64,64] matmul) → quantization — the mirror image of
:mod:`rustcv_tpu.ops.jpeg_tpu`.

The host half (:func:`rustcv_tpu.native.jpeg_entropy_encode`) performs the
sequential Huffman entropy coding; this module does everything numeric
on-device. The reference encodes camera frames to JPEG on the host with
turbojpeg for MJPEG-over-HTTP fan-out
(rustcv-backend-v4l2/examples/web_streaming.rs:44-100); here the
number-crunching half moves to the device and only quantized (mostly-zero)
coefficients cross back to the host.

Frozen encode spec (our oracle — float64 in :func:`encode_coeffs_numpy`,
tolerance-tested vs the float32 device path):
- pad the BGR image to MCU-aligned dims by edge replication;
- color: Y = 0.299·R + 0.587·G + 0.114·B,
  Cb = −0.168736·R − 0.331264·G + 0.5·B + 128,
  Cr = 0.5·R − 0.418688·G − 0.081312·B + 128, rounded (half-to-even),
  clamped to [0, 255] integers;
- subsampling (integer, on the rounded planes): 4:2:0 = (a+b+c+d+2)>>2
  over 2×2; 4:2:2 = (a+b+1)>>1 over horizontal pairs; 4:4:4 = none;
- level shift −128, 2-D forward DCT as ONE [nblocks, 64] @ [64, 64] matmul
  with Kf = idct_kmat().T (the IDCT basis is orthogonal, so the forward
  transform is its transpose — same no-relayout block-row trick, see
  jpeg_tpu.idct_kmat);
- quantize: round(F / q) (half-to-even), clamped to [−1023, 1023] so every
  value fits baseline Huffman categories (AC ≤ 10 bits, DC diff ≤ 11).

Quality → quant tables: the standard IJG mapping over the Annex-K base
tables (scale = 5000/q below 50 else 200−2q; entries clamped to [1, 255]).
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import List, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .jpeg_tpu import idct_kmat

# Annex K.1/K.2 base quantization tables (natural row-major order).
BASE_QT_LUMA = np.array(
    [
        16, 11, 10, 16, 24, 40, 51, 61,
        12, 12, 14, 19, 26, 58, 60, 55,
        14, 13, 16, 24, 40, 57, 69, 56,
        14, 17, 22, 29, 51, 87, 80, 62,
        18, 22, 37, 56, 68, 109, 103, 77,
        24, 35, 55, 64, 81, 104, 113, 92,
        49, 64, 78, 87, 103, 121, 120, 101,
        72, 92, 95, 98, 112, 100, 103, 99,
    ],
    np.int64,
)
BASE_QT_CHROMA = np.array(
    [
        17, 18, 24, 47, 99, 99, 99, 99,
        18, 21, 26, 66, 99, 99, 99, 99,
        24, 26, 56, 99, 99, 99, 99, 99,
        47, 66, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
    ],
    np.int64,
)

_SAMP = {"4:2:0": (2, 2), "4:2:2": (2, 1), "4:4:4": (1, 1)}


@lru_cache(maxsize=64)
def quant_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """IJG quality scaling → (luma, chroma) uint16 tables, natural order."""
    q = min(100, max(1, int(quality)))
    scale = 5000 // q if q < 50 else 200 - 2 * q
    qy = np.clip((BASE_QT_LUMA * scale + 50) // 100, 1, 255)
    qc = np.clip((BASE_QT_CHROMA * scale + 50) // 100, 1, 255)
    return qy.astype(np.uint16), qc.astype(np.uint16)


def _geometry(w: int, h: int, subsampling: str) -> dict:
    """MCU-aligned geometry for a 3-component image."""
    fh, fv = _SAMP[subsampling]
    mcu_w, mcu_h = 8 * fh, 8 * fv
    mcus_x = -(-w // mcu_w)
    mcus_y = -(-h // mcu_h)
    return {
        "pad_w": mcus_x * mcu_w,
        "pad_h": mcus_y * mcu_h,
        "h_samp": [fh, 1, 1],
        "v_samp": [fv, 1, 1],
        "blocks": [
            (mcus_y * fv, mcus_x * fh),
            (mcus_y, mcus_x),
            (mcus_y, mcus_x),
        ],
    }


@lru_cache(maxsize=1)
def fdct_kmat() -> np.ndarray:
    """Forward 2-D DCT as ONE [64, 64] matrix (transpose of the IDCT kmat:
    the separable basis is orthogonal)."""
    return np.ascontiguousarray(idct_kmat().T)


def _blocks(plane: jnp.ndarray) -> jnp.ndarray:
    """(…, H, W) → (…, nblocks, 64) block rows (natural order in-block)."""
    h, w = plane.shape[-2], plane.shape[-1]
    batch = plane.shape[:-2]
    bh, bw = h // 8, w // 8
    nd = len(batch)
    perm = tuple(range(nd)) + (nd, nd + 2, nd + 1, nd + 3)
    return (
        plane.reshape(*batch, bh, 8, bw, 8)
        .transpose(perm)
        .reshape(*batch, bh * bw, 64)
    )


def _fdct_quant(plane: jnp.ndarray, qt: jnp.ndarray) -> jnp.ndarray:
    """Integer plane → quantized coefficient rows (…, nblocks, 64) int16."""
    x = _blocks(plane).astype(jnp.float32) - 128.0
    k = jnp.asarray(fdct_kmat())
    f = jnp.matmul(x, k, precision=jax.lax.Precision.HIGHEST)
    q = jnp.round(f / qt.reshape(64).astype(jnp.float32))
    return jnp.clip(q, -1023, 1023).astype(jnp.int16)


def _subsample_h2v2(p: jnp.ndarray) -> jnp.ndarray:
    h, w = p.shape[-2], p.shape[-1]
    q = p.reshape(*p.shape[:-2], h // 2, 2, w // 2, 2).astype(jnp.int32)
    return (q.sum(axis=(-3, -1)) + 2) >> 2


def _subsample_h2v1(p: jnp.ndarray) -> jnp.ndarray:
    w = p.shape[-1]
    q = p.reshape(*p.shape[:-1], w // 2, 2).astype(jnp.int32)
    return (q.sum(axis=-1) + 1) >> 1


def encode_coeffs_from_planes(
    b: jax.Array,
    g: jax.Array,
    r: jax.Array,
    quality: int = 90,
    subsampling: str = "4:2:0",
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """B/G/R u8 planes (…, H, W) → quantized coefficient rows per component
    (…, [nb, 64] int16, natural order over the padded MCU grid).

    The traceable core of the encoder — fuse it into larger device programs
    (e.g. an engine tick that transcodes: decode → filter → overlay →
    encode). Plane inputs compose with the packed-rows pipelines via
    ``color.unpack_bgr_planes`` (no trailing-3 layout anywhere)."""
    h, w = b.shape[-2], b.shape[-1]
    geo = _geometry(w, h, subsampling)
    qy, qc = quant_tables(quality)
    pad = [(0, 0)] * (b.ndim - 2) + [(0, geo["pad_h"] - h), (0, geo["pad_w"] - w)]
    bf, gf, rf = (
        jnp.pad(p, pad, mode="edge").astype(jnp.float32) for p in (b, g, r)
    )
    y = 0.299 * rf + 0.587 * gf + 0.114 * bf
    cb = -0.168736 * rf - 0.331264 * gf + 0.5 * bf + 128.0
    cr = 0.5 * rf - 0.418688 * gf - 0.081312 * bf + 128.0
    y, cb, cr = (
        jnp.clip(jnp.round(p), 0, 255).astype(jnp.int32) for p in (y, cb, cr)
    )
    fh, fv = _SAMP[subsampling]
    if (fh, fv) == (2, 2):
        cb, cr = _subsample_h2v2(cb), _subsample_h2v2(cr)
    elif (fh, fv) == (2, 1):
        cb, cr = _subsample_h2v1(cb), _subsample_h2v1(cr)
    qyj = jnp.asarray(qy.astype(np.int32))
    qcj = jnp.asarray(qc.astype(np.int32))
    return (
        _fdct_quant(y, qyj),
        _fdct_quant(cb, qcj),
        _fdct_quant(cr, qcj),
    )


@partial(jax.jit, static_argnames=("quality", "subsampling"))
def encode_coeffs_tpu(
    bgr: jax.Array, quality: int = 90, subsampling: str = "4:2:0"
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """(H, W, 3) u8 BGR → quantized coefficient rows per component.

    Everything numeric on-device in one fused program; feed the results to
    :func:`rustcv_tpu.native.jpeg_entropy_encode` (see
    :func:`encode_jpeg_tpu`). Returns ([nby, 64], [nbc, 64], [nbc, 64])
    int16 in natural order over the padded MCU grid.
    """
    return encode_coeffs_from_planes(
        bgr[..., 0], bgr[..., 1], bgr[..., 2], quality, subsampling
    )


@partial(jax.jit, static_argnames=("quality",))
def encode_coeffs_gray_tpu(gray: jax.Array, quality: int = 90) -> jax.Array:
    """(H, W) u8 grayscale → quantized luma coefficient rows [nb, 64]."""
    h, w = gray.shape[0], gray.shape[1]
    pad_h, pad_w = -(-h // 8) * 8, -(-w // 8) * 8
    plane = jnp.pad(gray, ((0, pad_h - h), (0, pad_w - w)), mode="edge")
    qy, _ = quant_tables(quality)
    return _fdct_quant(plane.astype(jnp.int32), jnp.asarray(qy.astype(np.int32)))


def encode_jpeg_tpu(
    bgr, quality: int = 90, subsampling: str = "4:2:0"
) -> bytes:
    """Full hybrid encode: device numeric path → host entropy coding.

    ``bgr`` is (H, W, 3) u8 BGR (host or device array); 2-D input encodes
    grayscale. Returns baseline JFIF bytes decodable by any JPEG decoder.
    """
    from .. import native

    a = jnp.asarray(bgr)
    if a.ndim == 2:
        qy, _ = quant_tables(quality)
        co = np.asarray(encode_coeffs_gray_tpu(a, quality))
        bh, bw = a.shape[0], a.shape[1]
        bh, bw = -(-bh // 8), -(-bw // 8)
        return native.jpeg_entropy_encode(
            [co.reshape(bh, bw, 64)], [qy],
            int(a.shape[1]), int(a.shape[0]), [1], [1],
        )
    h, w = int(a.shape[0]), int(a.shape[1])
    g = _geometry(w, h, subsampling)
    qy, qc = quant_tables(quality)
    cy, cb, cr = encode_coeffs_tpu(a, quality, subsampling)
    comps = []
    for c, arr in enumerate((cy, cb, cr)):
        bh, bw = g["blocks"][c]
        comps.append(np.asarray(arr).reshape(bh, bw, 64))
    return native.jpeg_entropy_encode(
        comps, [qy, qc, qc], w, h, g["h_samp"], g["v_samp"]
    )


@partial(jax.jit, static_argnames=("quality", "subsampling"))
def _encode_coeffs_batch(bgr, quality, subsampling):
    return jax.vmap(
        lambda f: encode_coeffs_tpu(f, quality, subsampling)
    )(bgr)


def encode_jpeg_batch_tpu(
    bgr, quality: int = 90, subsampling: str = "4:2:0"
) -> List[bytes]:
    """Batched encode: (N, H, W, 3) u8 BGR → N JFIF byte strings.

    One fused device program computes all N frames' coefficients (the MJPEG
    fan-out shape — N streams per tick, cf. web_streaming); the host loop
    entropy-encodes each frame.
    """
    from .. import native

    a = jnp.asarray(bgr)
    n, h, w = int(a.shape[0]), int(a.shape[1]), int(a.shape[2])
    g = _geometry(w, h, subsampling)
    qy, qc = quant_tables(quality)
    cy, cb, cr = _encode_coeffs_batch(a, quality, subsampling)
    cy, cb, cr = np.asarray(cy), np.asarray(cb), np.asarray(cr)
    out = []
    for i in range(n):
        comps = []
        for c, arr in enumerate((cy[i], cb[i], cr[i])):
            bh, bw = g["blocks"][c]
            comps.append(arr.reshape(bh, bw, 64))
        out.append(
            native.jpeg_entropy_encode(
                comps, [qy, qc, qc], w, h, g["h_samp"], g["v_samp"]
            )
        )
    return out


def pack_coeff_rows(
    coeffs: jax.Array, k_slots: int, dense_cap: int
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Device-side block-pack of quantized coefficient rows — the encode-
    direction twin of the decode path's block-packed upload (D2H shrinks
    ~3× vs dense int16 grids).

    ``coeffs``: (..., B, 64) int16. Per block, the first ``k_slots``
    nonzeros are emitted as (position u8, value i16) slot pairs via a
    rank-one-hot reduce (accelerator-native: no scatters, no lane gathers). Blocks
    with more than ``k_slots`` nonzeros ship whole as 64-wide dense rows
    (row-granular escape, top-k selected); their slot rows are zero.

    Returns ``(idx u8 (...,B,K), val i16 (...,B,K), dense_ids i32
    (...,DCAP) — block ids, sentinel B for unused slots, DESCENDING by
    nnz — dense_rows i16 (...,DCAP,64), n_dense i32 (...))``. If
    ``n_dense > dense_cap`` the packing is incomplete and the caller must
    fall back to the dense grids (they remain program outputs).
    """
    nz = coeffs != 0
    nnz = nz.sum(-1)  # (..., B) i32
    rank = jnp.cumsum(nz.astype(jnp.int32), axis=-1) - 1
    light = nnz <= k_slots
    sel = nz & light[..., None]
    oh = (sel[..., None] & (rank[..., None] == jnp.arange(k_slots))).astype(
        jnp.float32
    )  # (..., B, 64, K)
    # One-hot selection as a matmul; HIGHEST keeps it an exact f32 product
    # (a TF32 default would round values past its 11-bit significand).
    hi = jax.lax.Precision.HIGHEST
    val = jnp.einsum("...jk,...j->...k", oh, coeffs.astype(jnp.float32), precision=hi)
    idx = jnp.einsum("...jk,j->...k", oh, jnp.arange(64, dtype=jnp.float32), precision=hi)
    b = coeffs.shape[-2]
    dense_cap = min(dense_cap, b)  # tiny images: cap cannot exceed blocks
    score = jnp.where(nnz > k_slots, nnz, -1)
    top, ids = jax.lax.top_k(score, dense_cap)
    valid = top > 0
    rows = jnp.take_along_axis(
        coeffs, jnp.minimum(ids, b - 1)[..., None], axis=-2
    )
    return (
        idx.astype(jnp.uint8),
        val.astype(jnp.int16),
        jnp.where(valid, ids, b).astype(jnp.int32),
        rows * valid[..., None].astype(jnp.int16),
        # TRUE busy-block count (NOT capped at dense_cap — overflow must be
        # detectable by the n_dense > dense_cap comparison).
        (nnz > k_slots).sum(-1).astype(jnp.int32),
    )


def blob_from_packed(idx, val, dense_ids, dense_rows, ndense) -> jax.Array:
    """Concatenate the packed-coefficient outputs into one u8 array
    (..., blob_bytes): [idx u8 | val i16 | dense_ids i32 | dense_rows i16 |
    ndense i32], each flattened little-endian. One D2H fetch instead of
    five per delivered tick. Inverse: :func:`split_blob`."""
    batch = idx.shape[:-2]

    def u8(a):
        b = jax.lax.bitcast_convert_type(a, jnp.uint8)
        return b.reshape(*batch, -1)

    return jnp.concatenate(
        [u8(idx), u8(val), u8(dense_ids), u8(dense_rows),
         u8(ndense[..., None])],
        axis=-1,
    )


def split_blob(blob: np.ndarray, nbt: int, k: int, dcap: int):
    """Host inverse of :func:`blob_from_packed` for one batch item or a
    batch: returns (idx, val, dense_ids, dense_rows, ndense) numpy views."""
    batch = blob.shape[:-1]
    o0 = nbt * k
    o1 = o0 + nbt * k * 2
    o2 = o1 + dcap * 4
    o3 = o2 + dcap * 64 * 2
    o4 = o3 + 4
    if blob.shape[-1] != o4:
        raise ValueError(f"blob length {blob.shape[-1]} != expected {o4}")
    def seg(a, dt):  # batched slices are row-strided → compact before view
        return np.ascontiguousarray(a).view(dt)

    idx = blob[..., :o0].reshape(*batch, nbt, k)
    val = seg(blob[..., o0:o1], np.int16).reshape(*batch, nbt, k)
    ids = seg(blob[..., o1:o2], np.int32).reshape(*batch, dcap)
    rows = seg(blob[..., o2:o3], np.int16).reshape(*batch, dcap, 64)
    nd = seg(blob[..., o3:o4], np.int32).reshape(*batch)
    return idx, val, ids, rows, nd


def unpack_coeff_rows_numpy(idx, val, dense_ids, dense_rows, nblocks):
    """Host oracle: reverse :func:`pack_coeff_rows` to dense (B, 64) i16
    (single item, no batch dims) — test/reference use."""
    out = np.zeros((nblocks + 1, 64), np.int16)
    np.add.at(
        out[:nblocks],
        (np.arange(nblocks)[:, None], idx.astype(np.intp)),
        val,
    )
    out[dense_ids] = dense_rows
    return out[:nblocks]


# ---------------------------------------------------------------------------
# NumPy oracle (same frozen spec, float64 transform — used by tests)
# ---------------------------------------------------------------------------


def encode_coeffs_numpy(
    bgr: np.ndarray, quality: int = 90, subsampling: str = "4:2:0"
) -> Tuple[List[np.ndarray], List[np.ndarray], dict]:
    """Float64 oracle for :func:`encode_coeffs_tpu`.

    Returns (coeffs [list of [bh, bw, 64] int16], qts, geometry).
    """
    h, w = bgr.shape[:2]
    g = _geometry(w, h, subsampling)
    qy, qc = quant_tables(quality)
    img = np.pad(
        bgr, ((0, g["pad_h"] - h), (0, g["pad_w"] - w), (0, 0)), mode="edge"
    ).astype(np.float64)
    b, gg, r = img[..., 0], img[..., 1], img[..., 2]
    y = 0.299 * r + 0.587 * gg + 0.114 * b
    cb = -0.168736 * r - 0.331264 * gg + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * gg - 0.081312 * b + 128.0
    planes = [
        np.clip(np.round(p), 0, 255).astype(np.int64) for p in (y, cb, cr)
    ]
    fh, fv = _SAMP[subsampling]
    for i in (1, 2):
        p = planes[i]
        if (fh, fv) == (2, 2):
            ph, pw = p.shape
            p = (p.reshape(ph // 2, 2, pw // 2, 2).sum(axis=(1, 3)) + 2) >> 2
        elif (fh, fv) == (2, 1):
            ph, pw = p.shape
            p = (p.reshape(ph, pw // 2, 2).sum(axis=-1) + 1) >> 1
        planes[i] = p
    k = fdct_kmat().astype(np.float64)
    coeffs = []
    for c, p in enumerate(planes):
        ph, pw = p.shape
        bh, bw = ph // 8, pw // 8
        x = (
            p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(bh * bw, 64)
        ).astype(np.float64) - 128.0
        f = x @ k
        qt = (qy if c == 0 else qc).astype(np.float64).reshape(64)
        q = np.clip(np.round(f / qt), -1023, 1023).astype(np.int16)
        coeffs.append(q.reshape(bh, bw, 64))
    return coeffs, [qy, qc, qc], g


def encode_jpeg_numpy(
    bgr: np.ndarray, quality: int = 90, subsampling: str = "4:2:0"
) -> bytes:
    """Full oracle encode (float64 numeric path + native entropy coder)."""
    from .. import native

    coeffs, qts, g = encode_coeffs_numpy(bgr, quality, subsampling)
    return native.jpeg_entropy_encode(
        coeffs, qts, bgr.shape[1], bgr.shape[0], g["h_samp"], g["v_samp"]
    )
