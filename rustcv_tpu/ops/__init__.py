"""Compute ops: golden CPU oracles + device (XLA) kernels.

Submodules:
- ``golden``   — frozen NumPy specs (test oracles), bit-exact.
- ``color``    — device color conversions (YUYV/NV12/BGRA/RGB → BGR, gray).
- ``filters``  — device Gaussian/box blur, Sobel, gradient magnitude.
- ``resize``   — device fixed-point bilinear resize.
- ``features`` — device Harris corners + NMS.
- ``draw``     — device rectangle / alpha-mask blend.
- ``text``     — host glyph rasterization (masks consumed by ``draw``).
- ``decode``   — PixelFormat dispatch (host oracle + device paths).
- ``jpeg_tpu``    — hybrid MJPEG decode (host entropy → device IDCT).
- ``jpeg_encode`` — hybrid JPEG encode (device FDCT → host entropy).
"""

from . import (  # noqa: F401
    brief,
    ccl,
    color,
    decode,
    draw,
    fast,
    geometry,
    features,
    filters,
    golden,
    hist,
    hough,
    jpeg_encode,
    jpeg_tpu,
    kmeans,
    optflow,
    resize,
    stereo,
    synth,
    template,
    text,
    warp,
)
