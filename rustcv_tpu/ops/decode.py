"""Frame decode dispatch — raw pixel formats → BGR.

Mirrors ``rustcv-camera/src/decode.rs:36-86`` (``decode_frame`` dispatch on
PixelFormat) with two paths:

- :func:`decode_frame_host` — NumPy oracle decode into a host Mat (the
  bit-exact CPU path, used by ``Frame.decode_bgr`` and as the test oracle).
- :func:`decode_to_device` — decode a raw frame to a device BGR array.
  Uncompressed formats upload raw bytes and convert on-device (the raw YUYV
  payload is 2 B/px vs 3 B/px BGR — converting after H2D also saves PCIe
  bandwidth). MJPEG performs host entropy decode (PIL/libjpeg-turbo, the
  same engine family as the reference's turbojpeg choice at
  ``rustcv/src/videoio/mod.rs:206-252``) then device color conversion.
"""

from __future__ import annotations

import io

import numpy as np

from ..core.errors import DecodeError
from ..core.pixel_format import PixelFormat
from . import color as dcolor
from . import golden


def decode_mjpeg_host_rgb(data: np.ndarray | bytes) -> np.ndarray:
    """MJPEG → RGB u8 (H, W, 3) via PIL/libjpeg-turbo on the host."""
    from PIL import Image

    buf = data.tobytes() if isinstance(data, np.ndarray) else bytes(data)
    try:
        img = Image.open(io.BytesIO(buf))
        img = img.convert("RGB")
    except Exception as e:  # noqa: BLE001 — map to taxonomy
        raise DecodeError(f"JPEG decompress: {e}") from e
    return np.asarray(img, dtype=np.uint8)


def decode_mjpeg_into_mat(data: np.ndarray | bytes, mat) -> None:
    """MJPEG → BGR decoded DIRECTLY into the Mat's pitched host buffer —
    the reference's turbojpeg hot path (decompress into Mat with
    pitch = step, ``rustcv-camera/src/decode.rs:92-123``). Uses the native
    libjpeg-turbo scanline decoder (bit-exact with the PIL fallback,
    ~4× faster, zero intermediate copies); falls back to PIL when the
    native library is unavailable."""
    from .. import native as _native

    buf = data.tobytes() if isinstance(data, np.ndarray) else bytes(data)
    if _native.jpeg_host_available():
        from PIL import Image

        try:
            with Image.open(io.BytesIO(buf)) as img:  # header-only: no decode
                w, h = img.size
            mat.ensure_size(h, w, 3)
            _native.jpeg_decode_pitched(buf, mat.data, bgr=True)
            return
        except Exception as e:  # noqa: BLE001 — map to taxonomy
            raise DecodeError(f"JPEG decompress: {e}") from e
    rgb = decode_mjpeg_host_rgb(buf)
    mat.ensure_size(rgb.shape[0], rgb.shape[1], 3)
    mat.array[:] = rgb[..., ::-1]


def decode_frame_host(frame, mat) -> None:
    """Decode a Frame into a host Mat (reference decode.rs:36-86 semantics)."""
    w, h = frame.width, frame.height
    fmt = frame.pixel_format
    data = frame.data

    if fmt == PixelFormat.MJPEG:
        decode_mjpeg_into_mat(data, mat)
    elif fmt == PixelFormat.YUYV:
        mat.ensure_size(h, w, 3)
        mat.array[:] = golden.yuyv_to_bgr(data, w, h)
    elif fmt == PixelFormat.UYVY:
        mat.ensure_size(h, w, 3)
        mat.array[:] = golden.uyvy_to_bgr(data, w, h)
    elif fmt == PixelFormat.NV12:
        mat.ensure_size(h, w, 3)
        mat.array[:] = golden.nv12_to_bgr(data, w, h)
    elif fmt == PixelFormat.YV12:
        mat.ensure_size(h, w, 3)
        mat.array[:] = golden.yv12_to_bgr(data, w, h)
    elif fmt == PixelFormat.BGR24:
        mat.ensure_size(h, w, 3)
        mat.array[:] = data.reshape(-1)[: h * w * 3].reshape(h, w, 3)
    elif fmt == PixelFormat.RGB24:
        mat.ensure_size(h, w, 3)
        mat.array[:] = golden.rgb_to_bgr(data, w, h)
    elif fmt == PixelFormat.BGRA32:
        mat.ensure_size(h, w, 3)
        mat.array[:] = golden.bgra_to_bgr(data, w, h)
    elif fmt == PixelFormat.RGBA32:
        mat.ensure_size(h, w, 3)
        mat.array[:] = golden.rgba_to_bgr(data, w, h)
    elif fmt == PixelFormat.GRAY8:
        mat.ensure_size(h, w, 3)
        g = data.reshape(-1)[: h * w].reshape(h, w)
        mat.array[:] = np.repeat(g[..., None], 3, axis=-1)
    elif fmt.is_bayer:
        mat.ensure_size(h, w, 3)
        pattern = fmt.value.split("_")[1]
        mat.array[:] = golden.demosaic_bilinear(
            data.reshape(-1)[: h * w].reshape(h, w), pattern
        )
    else:
        raise DecodeError(f"unsupported pixel format for decode: {fmt}")

    if getattr(frame, "bottom_up", False):
        # Negative-pitch sources deliver rows bottom-to-top
        # (rustcv-backend-msmf/src/stream.rs:317-410): row-local decodes
        # commute with the flip, so flipping the decoded image is exact.
        if fmt in (PixelFormat.NV12, PixelFormat.YV12) or fmt.is_bayer:
            raise DecodeError(f"bottom-up layout unsupported for planar/CFA format {fmt}")
        mat.array[:] = mat.array[::-1].copy()


def convert_on_device(raw: "object", fmt: PixelFormat, width: int, height: int):
    """Device-side raw→BGR for uncompressed formats. ``raw``: u8 jax array,
    flat last axis (optionally batched)."""
    if fmt == PixelFormat.YUYV:
        return dcolor.yuyv_to_bgr(raw, width, height)
    if fmt == PixelFormat.UYVY:
        return dcolor.uyvy_to_bgr(raw, width, height)
    if fmt == PixelFormat.NV12:
        return dcolor.nv12_to_bgr(raw, width, height)
    if fmt == PixelFormat.YV12:
        return dcolor.yv12_to_bgr(raw, width, height)
    if fmt == PixelFormat.BGRA32:
        return dcolor.bgra_to_bgr(raw, width, height)
    if fmt == PixelFormat.RGBA32:
        return dcolor.rgba_to_bgr(raw, width, height)
    if fmt == PixelFormat.RGB24:
        return dcolor.rgb_to_bgr(raw, width, height)
    if fmt == PixelFormat.BGR24:
        return raw.reshape(*raw.shape[:-1], height, width, 3)
    if fmt == PixelFormat.GRAY8:
        import jax.numpy as jnp

        g = raw.reshape(*raw.shape[:-1], height, width)
        return jnp.repeat(g[..., None], 3, axis=-1)
    if fmt.is_bayer:
        return dcolor.demosaic_bilinear(raw, fmt.value.split("_")[1], width, height)
    raise DecodeError(f"unsupported device format: {fmt}")


def decode_to_device(frame, mjpeg_hybrid: bool = False):
    """Decode one Frame to a device (H, W, 3) u8 BGR array.

    ``mjpeg_hybrid=True`` uses the coefficient-level path: C++ Huffman
    entropy decode on the host, dequant + IDCT (matmuls) + upsample +
    color on the device (ops/jpeg_tpu.py). Pixels differ from the full-host libjpeg
    path by ≤1-2 LSB (float vs fixed-point IDCT — tolerance-tested).
    """
    import jax

    fmt = frame.pixel_format
    if fmt == PixelFormat.MJPEG:
        if mjpeg_hybrid:
            from . import jpeg_tpu

            return jpeg_tpu.decode_jpeg_tpu(frame.data)
        rgb = decode_mjpeg_host_rgb(frame.data)
        dev = jax.device_put(rgb)
        return dcolor.rgb_to_bgr(dev.reshape(-1), rgb.shape[1], rgb.shape[0])
    dev = jax.device_put(np.ascontiguousarray(frame.data).reshape(-1))
    out = convert_on_device(dev, fmt, frame.width, frame.height)
    if getattr(frame, "bottom_up", False):
        if fmt in (PixelFormat.NV12, PixelFormat.YV12) or fmt.is_bayer:
            raise DecodeError(f"bottom-up layout unsupported for planar/CFA format {fmt}")
        out = out[..., ::-1, :, :]
    return out
