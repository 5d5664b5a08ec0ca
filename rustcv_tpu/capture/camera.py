"""Camera — the synchronous zero-copy capture API (Stack B analog).

Reference: ``rustcv-camera/src/camera.rs:39-162`` — ``open``/``open_with`` →
negotiate + start; ``next_frame()`` returns a zero-copy Frame view valid
until the next dequeue; ``read_decoded(&mut Mat)`` captures + decodes to BGR
reusing the Mat allocation.

device addition: :meth:`read_decoded_device` decodes to a device BGR array
(uncompressed raw uploads + on-device convert), the building block the batched
runtime executor composes per stream.
"""

from __future__ import annotations

from typing import Optional

from ..core.config import ResolvedConfig, SimpleConfig
from ..core.frame import Frame
from ..core.mat import Mat
from ..core.telemetry import DeviceTelemetry
from ..ops import decode as _decode
from .simulation import SimulationDriver
from .source import DeviceControls, Driver, FrameSource

_DEFAULT_DRIVER: Optional[SimulationDriver] = None


def default_driver():
    """Real camera when present (V4L2 on Linux), else simulation — the
    runtime analog of the reference's compile-time backend switch."""
    global _DEFAULT_DRIVER
    if _DEFAULT_DRIVER is None:
        try:
            from .v4l2 import V4L2Driver, list_video_devices

            if list_video_devices():
                drv = V4L2Driver()
                if drv.list_devices():
                    _DEFAULT_DRIVER = drv
                    return _DEFAULT_DRIVER
        except Exception:  # noqa: BLE001 — any probe failure → simulation
            pass
        _DEFAULT_DRIVER = SimulationDriver()
    return _DEFAULT_DRIVER


class Camera:
    """Primary zero-copy capture handle."""

    def __init__(self, source: FrameSource, controls: DeviceControls):
        self._source = source
        self.controls = controls
        self._source.start()

    # -- constructors (camera.rs:55-91) ---------------------------------

    @classmethod
    def open(cls, device_id: str = "sim:0", driver: Optional[Driver] = None) -> "Camera":
        return cls.open_with(device_id, SimpleConfig(), driver)

    @classmethod
    def open_with(
        cls, device_id: str, config: SimpleConfig, driver: Optional[Driver] = None
    ) -> "Camera":
        drv = driver if driver is not None else default_driver()
        if hasattr(drv, "open_simple"):
            source, controls = drv.open_simple(device_id, config)
        else:
            from ..core.config import CameraConfig, Priority

            cfg = CameraConfig()
            if config.width is not None and config.height is not None:
                cfg = cfg.resolution(config.width, config.height, Priority.HIGH)
            if config.fps is not None:
                cfg = cfg.fps(config.fps, Priority.MEDIUM)
            if config.pixel_format is not None:
                cfg = cfg.format(config.pixel_format, Priority.HIGH)
            source, controls = drv.open(device_id, cfg)
        return cls(source, controls)

    # -- capture (camera.rs:113-137) ------------------------------------

    def next_frame(self) -> Frame:
        """Blocking zero-copy dequeue; ~33 ms at 30 fps (camera-rate bound)."""
        return self._source.next_frame()

    def read_decoded(self, mat: Mat) -> None:
        """Capture + decode to BGR into a reused Mat (host, bit-exact path)."""
        frame = self.next_frame()
        _decode.decode_frame_host(frame, mat)

    def read_decoded_device(self):
        """Capture + decode to a device (H, W, 3) u8 BGR array."""
        return _decode.decode_to_device(self.next_frame())

    # -- info ------------------------------------------------------------

    def resolved_config(self) -> ResolvedConfig:
        return self._source.resolved_config()

    def telemetry(self) -> DeviceTelemetry:
        return self._source.telemetry()

    @property
    def source(self) -> FrameSource:
        return self._source

    def close(self) -> None:
        self._source.stop()

    def __enter__(self) -> "Camera":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
