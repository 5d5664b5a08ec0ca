"""imgcodecs — imread / imwrite with BGR discipline.

Reference: ``rustcv/src/imgcodecs/mod.rs:9-76`` — ``imread`` decodes to RGB8
then repacks BGR; ``imwrite`` converts BGR→RGB honoring the Mat's stride
(``row_bytes``) before encoding. PIL replaces the Rust ``image`` crate.
"""

from __future__ import annotations

import os

from ..core.errors import CameraError
from ..core.mat import Mat


def imread(path: str) -> Mat:
    """Load an image file as a BGR Mat. Raises on missing/corrupt files."""
    import numpy as np
    from PIL import Image

    if not os.path.exists(path):
        raise CameraError(f"imread: no such file: {path}")
    try:
        img = Image.open(path).convert("RGB")
    except Exception as e:  # noqa: BLE001
        raise CameraError(f"imread: cannot decode {path}: {e}") from e
    rgb = np.asarray(img, dtype=np.uint8)
    return Mat.from_array(np.ascontiguousarray(rgb[..., ::-1]))


def imencode(ext: str, mat: Mat, quality: int = 95, backend: str = "host") -> bytes:
    """Encode a BGR Mat to in-memory image bytes (OpenCV ``imencode``).

    ``ext``: ".jpg"/".jpeg"/".png"/... (PIL format inferred). For JPEG,
    ``backend="tpu"`` routes through the hybrid encoder — the numeric path
    (color convert, subsample, FDCT, quantize) runs on-device and only the
    Huffman coding on the host (:mod:`rustcv_tpu.ops.jpeg_encode`); the
    right choice when frames already live in device memory or when
    batching. The default host backend (PIL) suits one-off host-resident
    images.
    """
    import io

    from PIL import Image

    if mat.is_empty():
        raise CameraError("imencode: empty Mat")
    e = ext.lower().lstrip(".")
    bgr = mat.to_numpy()
    if backend == "tpu":
        if e not in ("jpg", "jpeg"):
            raise ValueError(
                f"imencode: backend='tpu' supports JPEG only, not {ext!r}"
            )
        from ..ops.jpeg_encode import encode_jpeg_tpu

        return encode_jpeg_tpu(bgr, quality=quality)
    if backend != "host":
        raise ValueError(f"imencode: unknown backend {backend!r}")
    buf = io.BytesIO()
    fmt = {"jpg": "JPEG", "jpeg": "JPEG"}.get(e, e.upper())
    kw = {"quality": quality} if fmt == "JPEG" else {}
    try:
        Image.fromarray(bgr[..., ::-1]).save(buf, fmt, **kw)
    except (ValueError, OSError, KeyError) as err:
        raise CameraError(f"imencode: cannot encode {ext!r}: {err}") from err
    return buf.getvalue()


def imdecode(data: bytes, backend: str = "host") -> Mat:
    """Decode in-memory image bytes to a BGR Mat (OpenCV ``imdecode``).

    ``backend="tpu"`` uses the hybrid JPEG path (host entropy decode →
    device IDCT/upsample/color, :mod:`rustcv_tpu.ops.jpeg_tpu`) — JPEG
    only; other formats and the default go through PIL on the host.
    """
    import io

    import numpy as np
    from PIL import Image

    if backend == "tpu":
        from ..ops.jpeg_tpu import decode_jpeg_tpu

        return Mat.from_array(np.asarray(decode_jpeg_tpu(data)))
    if backend != "host":
        raise ValueError(f"imdecode: unknown backend {backend!r}")
    try:
        img = Image.open(io.BytesIO(data)).convert("RGB")
    except Exception as e:  # noqa: BLE001
        raise CameraError(f"imdecode: cannot decode buffer: {e}") from e
    rgb = np.asarray(img, dtype=np.uint8)
    return Mat.from_array(np.ascontiguousarray(rgb[..., ::-1]))


def imwrite(path: str, mat: Mat) -> bool:
    """Write a BGR Mat to an image file (format from the extension)."""
    from PIL import Image

    if mat.is_empty():
        return False
    bgr = mat.to_numpy()  # stride-aware packed copy (honors step)
    try:
        Image.fromarray(bgr[..., ::-1]).save(path)
    except (ValueError, OSError):
        return False
    return True


__all__ = ["imread", "imwrite", "imencode", "imdecode"]


def imreadmulti(path: str):
    """Multi-page read (OpenCV ``imreadmulti`` role): every frame of a
    multi-page TIFF / animated GIF → list of Mats (PIL backend)."""
    import numpy as np
    from PIL import Image, ImageSequence

    out = []
    with Image.open(path) as img:
        for frame in ImageSequence.Iterator(img):
            rgb = np.asarray(frame.convert("RGB"))
            out.append(Mat.from_array(rgb[..., ::-1].copy()))
    return out


def imcount(path: str) -> int:
    """OpenCV ``imcount`` role: number of pages/frames in the file."""
    from PIL import Image

    with Image.open(path) as img:
        return int(getattr(img, "n_frames", 1))


def imwritemulti(path: str, mats) -> bool:
    """Multi-page write (OpenCV ``imwritemulti`` role): TIFF multipage
    or animated GIF depending on the extension."""
    import numpy as np
    from PIL import Image

    frames = []
    for m in mats:
        a = m.to_numpy() if hasattr(m, "to_numpy") else np.asarray(m)
        if a.ndim == 3:
            a = a[..., ::-1]  # BGR → RGB
        frames.append(Image.fromarray(a))
    if not frames:
        return False
    frames[0].save(path, save_all=True, append_images=frames[1:])
    return True


def imread_with_metadata(path: str):
    """Metadata-aware read (OpenCV ``imreadWithMetadata`` role):
    → (Mat, dict) with PNG text chunks / EXIF tag ids (PIL backend)."""
    import numpy as np
    from PIL import Image

    with Image.open(path) as img:
        meta = {str(k): str(v) for k, v in (img.info or {}).items()
                if isinstance(v, (str, int, float))}
        try:
            exif = img.getexif()
            for k, v in exif.items():
                meta[f"exif:{k}"] = str(v)
        except Exception:
            pass
        rgb = np.asarray(img.convert("RGB"))
    return Mat.from_array(rgb[..., ::-1].copy()), meta


def imwrite_with_metadata(path: str, mat, metadata: dict) -> bool:
    """Metadata-aware write (OpenCV ``imwriteWithMetadata`` role):
    PNG text chunks (PNG) or quality-style kwargs passthrough."""
    import numpy as np
    from PIL import Image, PngImagePlugin

    a = mat.to_numpy() if hasattr(mat, "to_numpy") else np.asarray(mat)
    if a.ndim == 3:
        a = a[..., ::-1]
    img = Image.fromarray(a)
    if path.lower().endswith(".png"):
        info = PngImagePlugin.PngInfo()
        for k, v in (metadata or {}).items():
            info.add_text(str(k), str(v))
        img.save(path, pnginfo=info)
    else:
        img.save(path)
    return True
