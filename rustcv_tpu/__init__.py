"""rustcv_tpu — a accelerator-native reimplementation of RustCV's OpenCV-compatible
vision pipeline.

The reference (RustCV, pure Rust) runs per-pixel decode/convert/filter loops
on the CPU behind an OpenCV-style facade. Here the entire hot path — YUYV /
MJPEG decode, color conversion, resize, Gaussian/Sobel filtering, Harris
features, drawing overlays — runs as fused JAX/XLA/Pallas programs on the device,
with batched multi-stream execution and host-side simulation frame sources
replacing the OS camera drivers.

Public surface mirrors the reference facade (``rustcv/src/lib.rs:12-16``):

    from rustcv_tpu import prelude  # Mat, VideoCapture, TickMeter
    from rustcv_tpu import highgui, imgproc, imgcodecs
"""

from . import core
from .core import Mat, TickMeter
from .version import __version__

__all__ = ["Mat", "TickMeter", "core", "__version__"]


def __getattr__(name):
    # Lazy submodule access keeps `import rustcv_tpu` light (no jax import).
    import importlib

    if name in (
        "ops", "capture", "runtime", "parallel", "highgui", "imgcodecs",
        "imgproc", "models", "utils", "videoio", "prelude",
    ):
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
