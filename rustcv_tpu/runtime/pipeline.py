"""Fused per-tick pipeline builder.

The reference processes each frame with a chain of per-pixel CPU loops
(decode → convert → draw, ``rustcv/src/videoio/mod.rs:344-399`` +
``imgproc/drawing.rs``). Accelerator design: the whole per-tick chain for a
**batch of N streams** is one jitted XLA program —
``raw u8 [N, bytes] → convert → (resize) → (filter) → (overlay) → outputs`` —
so there is exactly one dispatch per tick and XLA fuses every elementwise
stage (SURVEY.md §7 hard-part #4: amortize dispatch over the batch axis).

Programs are cached per :class:`PipelineSpec` (shape bucket × format ×
stages). Overlay parameters (rects, colors, thickness) are traced arguments,
so moving overlays never recompile. Optional mesh sharding: the batch axis is
the data-parallel axis (one stream group per device).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.pixel_format import PixelFormat
from ..ops import color as _ops_color
from ..ops import decode as _decode
from ..ops import draw as _draw
from ..ops import filters as _filters
from ..ops import resize as _resize


@dataclass(frozen=True)
class PipelineSpec:
    """Static description of one compiled pipeline variant."""

    pixel_format: PixelFormat
    width: int
    height: int
    resize_to: Optional[Tuple[int, int]] = None  # (w, h) after convert
    filter: str = "none"  # none | gaussian | sobel_mag | blur_sobel | harris
    overlay: bool = False  # rectangle overlay on the BGR output
    emit_bgr: bool = True  # return the BGR image
    emit_filtered: bool = True  # return the filter output (if any)
    # Hybrid MJPEG: inputs are DCT coefficient grids (C++ entropy decode on
    # the host) and reconstruction runs on-device (ops/jpeg_tpu.py).
    mjpeg_hybrid: bool = False
    # Packed hybrid: inputs are BLOCK-packed nonzeros (K slots per 8×8 block
    # + a dense-row escape for busy blocks) instead of dense grids (~6-10×
    # fewer H2D bytes); the device unpacks with a one-hot reduce + row
    # scatter into the dense layout described by coeff_geometry = ((bh, bw)
    # per component), which must be set (static program geometry).
    mjpeg_packed: bool = False
    coeff_geometry: Tuple[Tuple[int, int], ...] = ()
    # Full-host MJPEG via native libjpeg-turbo: the decoder emits BGR
    # scanlines straight into pitched staging (decode.rs:92-123 semantics),
    # so the staged bytes are already BGR and the device does no swap.
    mjpeg_staged_bgr: bool = False
    # JPEG transcode output: quality > 0 fuses the encoder's numeric half
    # (BGR→YCbCr, subsample, FDCT-as-matmul, quantize) into THIS program
    # after the overlay; outputs gain enc_y/enc_cb/enc_cr coefficient rows
    # (int16) for the host Huffman coder (native.jpeg_entropy_encode).
    encode_jpeg: int = 0
    encode_subsampling: str = "4:2:0"
    # Device-side block-pack of the encode coefficients (K slots per block
    # + dense-row escape; ops/jpeg_encode.pack_coeff_rows): adds
    # enc_idx/enc_val/enc_dense_ids/enc_dense_rows/enc_ndense outputs for
    # ~3× smaller D2H delivery. The dense enc_y/cb/cr stay as outputs for
    # over-capacity fallback ticks. 0 = off; else the K slot count.
    encode_packed: int = 0
    encode_dense_cap: int = 0

    def raw_bytes(self) -> int:
        if self.pixel_format == PixelFormat.MJPEG:
            # MJPEG is entropy-decoded on host before staging: to BGR by the
            # native libjpeg path, else to RGB by PIL (the device then swaps).
            return self.width * self.height * 3
        return self.pixel_format.buffer_size(self.width, self.height)

    def staged_format(self) -> PixelFormat:
        if self.pixel_format == PixelFormat.MJPEG:
            return PixelFormat.BGR24 if self.mjpeg_staged_bgr else PixelFormat.RGB24
        return self.pixel_format


def _build(spec: PipelineSpec):
    w, h = spec.width, spec.height

    # Packed-rows BGR (…, H, W*3) is the device-native layout (a trailing
    # channel dim of 3 pads badly in device tilings). The YUYV/NV12 fast
    # paths stay packed end-to-end (decode → overlay → output); other
    # formats currently go through the interleaved path.
    _PAIRWISE = (
        PixelFormat.YUYV, PixelFormat.UYVY, PixelFormat.NV12, PixelFormat.YV12,
    )
    packed = (
        (
            spec.staged_format()
            in _PAIRWISE
            + (PixelFormat.BGRA32, PixelFormat.RGB24, PixelFormat.BGR24)
            or spec.staged_format().is_bayer
        )
        and not spec.mjpeg_hybrid
        and (spec.staged_format() in _PAIRWISE or spec.width % 4 == 0)
        # Resize stays packed too (plane-form resize + word-trick
        # (de)interleave, bit-exact) when both widths are 4-aligned.
        and (
            spec.resize_to is None
            or (spec.width % 4 == 0 and spec.resize_to[0] % 4 == 0)
        )
    ) or (
        # Hybrid MJPEG reconstruction is plane-form until the very end, so
        # packed rows come from one interleave at the OUTPUT geometry (with
        # resize_to, the planes are resized first — 2.25× less interleave
        # work at 1080p→480p and no trailing-3 layout anywhere).
        spec.mjpeg_hybrid
        and (spec.resize_to[0] if spec.resize_to else spec.width) % 4 == 0
    )
    # Post-resize geometry (the dims every downstream stage sees).
    cur_w, cur_h = (w, h) if spec.resize_to is None else spec.resize_to

    def reconstruct_mjpeg(x):
        """Batched coefficient-level reconstruction (x = coeff/qt arrays)."""
        from ..ops import jpeg_tpu

        if spec.mjpeg_packed:
            idx, val, dense_ids, dense_rows, qty, qtc = x
            geom = spec.coeff_geometry
            # [N, nblocks, 64] block rows — sliced per component along the
            # block axis, straight into the [64, 64] IDCT matmul (layout-
            # preserving: no flatten/relayout between unpack and IDCT).
            dense = jax.vmap(jpeg_tpu.unpack_block_coeffs)(idx, val, dense_ids, dense_rows)
            splits, off = [], 0
            for bh, bw in geom:
                splits.append(dense[:, off : off + bh * bw].reshape(-1, bh, bw, 8, 8))
                off += bh * bw
            y_c, cb_c, cr_c = splits
        else:
            y_c, cb_c, cr_c, qty, qtc = x
        planes = []
        for coeff, qt in ((y_c, qty), (cb_c, qtc), (cr_c, qtc)):
            p = jax.vmap(jpeg_tpu.dequant_idct_plane, in_axes=(0, None))(coeff, qt)
            planes.append(p)
        # Upsampling factors from plane shape ratios (static).
        fy = planes[0].shape[-2] // planes[1].shape[-2]
        fx = planes[0].shape[-1] // planes[1].shape[-1]
        cb = jpeg_tpu.upsample(planes[1], fx, fy)[..., :h, :w]
        cr = jpeg_tpu.upsample(planes[2], fx, fy)[..., :h, :w]
        b, g, r = jpeg_tpu.ycbcr_to_bgr_planes(planes[0][..., :h, :w], cb, cr)
        if spec.resize_to is not None:
            dw, dh = spec.resize_to
            stacked = jnp.stack([b, g, r], axis=-3)  # (N, 3, H, W)
            small = _resize.resize_bilinear_plane(stacked, dw, dh)
            b, g, r = small[..., 0, :, :], small[..., 1, :, :], small[..., 2, :, :]
        if packed:
            return _ops_color.interleave_bgr_planes(b, g, r, cur_w, cur_h)
        return jnp.stack([b, g, r], axis=-1)

    def run(raw, rects, rect_colors, thickness):
        # raw: u8 [N, raw_bytes] (or the coeff tuple in hybrid-MJPEG mode)
        from ..ops import color as _color

        if spec.mjpeg_hybrid:
            # Resize (plane-form) + packed interleave happen inside —
            # reconstruction is plane-form until the very end.
            bgr = reconstruct_mjpeg(raw)
        elif packed:
            if spec.staged_format() == PixelFormat.YUYV:
                bgr = _color.yuyv_to_bgr_packed(raw, w, h)
            elif spec.staged_format() == PixelFormat.UYVY:
                bgr = _color.uyvy_to_bgr_packed(raw, w, h)
            elif spec.staged_format() == PixelFormat.NV12:
                bgr = _color.nv12_to_bgr_packed(raw, w, h)
            elif spec.staged_format() == PixelFormat.YV12:
                bgr = _color.yv12_to_bgr_packed(raw, w, h)
            elif spec.staged_format() == PixelFormat.BGRA32:
                bgr = _color.bgra_to_bgr_packed(raw, w, h)
            elif spec.staged_format() == PixelFormat.BGR24:
                # Already-BGR staging (native MJPEG decode): packed rows is
                # just the row-major byte view — zero device work.
                bgr = raw.reshape(*raw.shape[:-1], h, w * 3)
            elif spec.staged_format().is_bayer:
                bgr = _color.demosaic_bilinear_packed(
                    raw, spec.staged_format().value.split("_")[1], w, h
                )
            else:
                bgr = _color.rgb_to_bgr_packed(raw, w, h)
            if spec.resize_to is not None:
                bgr = _resize.resize_bilinear_packed(
                    bgr, w, h, spec.resize_to[0], spec.resize_to[1]
                )
        else:
            bgr = _decode.convert_on_device(raw, spec.staged_format(), w, h)
            if spec.resize_to is not None:
                bgr = _resize.resize_bilinear(bgr, spec.resize_to[0], spec.resize_to[1])

        def gray_plane():
            # Direct raw→gray when possible: skips a round trip through the
            # interleaved BGR image (identical u8 values, parity-tested).
            if spec.resize_to is None and not spec.mjpeg_hybrid:
                if spec.staged_format() == PixelFormat.YUYV:
                    return _color.yuyv_to_gray(raw, w, h)
                if spec.staged_format() == PixelFormat.UYVY:
                    return _color.uyvy_to_gray(raw, w, h)
                if spec.staged_format() == PixelFormat.NV12:
                    return _color.nv12_to_gray(raw, w, h)
                if spec.staged_format() == PixelFormat.YV12:
                    return _color.yv12_to_gray(raw, w, h)
                if spec.staged_format() == PixelFormat.RGB24 and spec.width % 4 == 0:
                    return _color.rgb_to_gray_packed_rows(raw, w, h)
                if spec.staged_format() == PixelFormat.BGR24 and spec.width % 4 == 0:
                    return _color.bgr_to_gray_packed_rows(raw, w, h)
            if packed:
                if cur_w % 4 == 0:
                    # Luma straight off the packed rows, word-wise (covers
                    # bayer, BGRA32, and every resized packed pipeline —
                    # post-resize, matching the interleaved path's order).
                    return _color.bgr_to_gray_packed_rows(bgr, cur_w, cur_h)
                # Recover the HWC view for the generic luma.
                return _color.bgr_to_gray(bgr.reshape(*bgr.shape[:-1], cur_w, 3))
            return _color.bgr_to_gray(bgr)

        out = {}
        if spec.filter == "gaussian":
            # Packed rows would blur ACROSS channels horizontally — blur in
            # HWC view (the stencil needs spatial adjacency per channel).
            img = bgr.reshape(*bgr.shape[:-1], cur_w, 3) if packed else bgr
            filtered = _filters.gaussian5_u8(img)
        elif spec.filter == "sobel_mag":
            gray = gray_plane()
            gx, gy = _filters.sobel3_gray(gray)
            filtered = _filters.gradient_magnitude_u8(gx, gy)
        elif spec.filter == "blur_sobel":
            gray = gray_plane()
            blurred = _filters.gaussian5_u8(gray, has_channels=False)
            gx, gy = _filters.sobel3_gray(blurred)
            filtered = _filters.gradient_magnitude_u8(gx, gy)
        elif spec.filter == "canny":
            filtered = _filters.canny_u8(gray_plane())
        elif spec.filter == "harris":
            from ..ops import features as _features

            filtered = _features.harris_corners(gray_plane())
        elif spec.filter == "harris_points":
            # Serving-friendly output: fixed-size top-K corner coordinates +
            # validity mask per stream (tiny D2H instead of a full mask).
            from ..ops import features as _features

            coords, valid = jax.vmap(
                lambda g: _features.harris_corner_list(g, max_corners=256)
            )(gray_plane())
            out["corners"] = coords
            out["corners_valid"] = valid
            filtered = None
        elif spec.filter == "none":
            filtered = None
        else:
            raise ValueError(f"unknown filter {spec.filter!r}")

        if spec.overlay:
            if packed:
                bgr = _draw.rectangle_packed(bgr, rects, rect_colors, thickness)
            else:
                bgr = _draw.rectangle(bgr, rects, rect_colors, thickness)
        if spec.encode_jpeg:
            from ..ops import jpeg_encode as _jenc

            if packed and cur_w % 4 == 0:
                eb, eg, er = _ops_color.unpack_bgr_planes(bgr, cur_w, cur_h)
            else:
                hwc = bgr.reshape(*bgr.shape[:-1], cur_w, 3) if packed else bgr
                eb, eg, er = hwc[..., 0], hwc[..., 1], hwc[..., 2]
            cy, ccb, ccr = _jenc.encode_coeffs_from_planes(
                eb, eg, er, spec.encode_jpeg, spec.encode_subsampling
            )
            out["enc_y"], out["enc_cb"], out["enc_cr"] = cy, ccb, ccr
            if spec.encode_packed:
                allc = jnp.concatenate([cy, ccb, ccr], axis=-2)
                (
                    out["enc_idx"], out["enc_val"], out["enc_dense_ids"],
                    out["enc_dense_rows"], out["enc_ndense"],
                ) = _jenc.pack_coeff_rows(
                    allc, spec.encode_packed, spec.encode_dense_cap
                )
                # Single-fetch delivery blob: every packed buffer as one u8
                # array, so delivery is ONE device-to-host copy per tick
                # instead of five (layout: see jpeg_encode.split_blob).
                out["enc_blob"] = _jenc.blob_from_packed(
                    out["enc_idx"], out["enc_val"], out["enc_dense_ids"],
                    out["enc_dense_rows"], out["enc_ndense"],
                )
        if spec.emit_bgr:
            out["bgr"] = bgr
        if spec.emit_filtered and filtered is not None:
            out["filtered"] = filtered
        # One-element completion handle, computed in-program: fetching it is
        # a tiny D2H that cannot finish before the whole program has run.
        if spec.emit_bgr:
            probe = bgr
        elif filtered is not None:
            probe = filtered
        else:
            probe = next(iter(out.values()))
        out["_sync"] = probe.reshape(-1)[:1]
        return out

    return jax.jit(run)


@lru_cache(maxsize=64)
def get_pipeline(spec: PipelineSpec):
    """The jitted program for ``spec`` (cached — warm once per bucket)."""
    return _build(spec)


def make_dummy_overlay(n: int):
    """Placeholder overlay args for specs with overlay=False."""
    return (
        jnp.zeros((n, 4), jnp.int32),
        jnp.zeros((n, 3), jnp.uint8),
        jnp.int32(0),
    )
