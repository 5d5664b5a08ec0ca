"""VideoCapture — the OpenCV-style facade over a background capture worker.

Reference: ``rustcv/src/videoio/mod.rs:15-399``. The Rust facade hides a
Tokio worker behind a synchronous API, talking over bounded(1) channels with
``Command{NextFrame, SetResolution, Stop}`` / ``Response{FrameData,
PropertySet, Error, EndOfStream}``; decode to BGR happens on the caller
thread. Semantics preserved here with a Python worker thread + two
``queue.Queue(maxsize=1)``:

- ``read(mat) -> bool`` — request a frame, copy raw bytes across the thread
  boundary (the reference's COPY #1, mod.rs:89), decode on the caller thread.
- ``set_resolution(w, h)`` — hot reload: the worker stops the stream and
  reopens with a ``Priority.REQUIRED`` resolution (full renegotiation),
  blocking the caller until PropertySet/Error (mod.rs:115-147, 269-289).
- Degraded open: if the initial open fails the worker stays alive so a later
  ``set_resolution`` can recover (mod.rs:76-79).

``decode_on_device=True`` routes decode through the device instead of the host
oracle (identical pixels — parity-tested); the batched multi-stream
executor in :mod:`rustcv_tpu.runtime` is the high-throughput path.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np

from ..core.config import CameraConfig, Priority
from ..core.errors import CameraError
from ..core.errors import EndOfStream as EndOfStreamError
from ..core.mat import Mat
from ..core.pixel_format import PixelFormat
from ..ops import decode as _decode
from ..ops import golden
from .camera import default_driver
from .source import Driver

# -- protocol messages (mod.rs:15-33) ---------------------------------------


@dataclass
class _NextFrame:
    pass


@dataclass
class _SetResolution:
    width: int
    height: int


@dataclass
class _Stop:
    pass


@dataclass
class _FrameData:
    data: np.ndarray
    width: int
    height: int
    pixel_format: PixelFormat
    sequence: int


@dataclass
class _PropertySet:
    pass


@dataclass
class _Error:
    error: Exception


@dataclass
class _EndOfStream:
    pass


def resolve_device_id(index_or_id: Union[int, str], driver: Driver) -> str:
    """int index → backend device id (mod.rs:305: linux "/dev/video{i}")."""
    if isinstance(index_or_id, str):
        return index_or_id
    devices = driver.list_devices()
    if 0 <= index_or_id < len(devices):
        return devices[index_or_id].id
    # Mirror the reference's optimistic path: synthesize the id even if not
    # currently enumerated (open will fail with DeviceNotFound). The prefix
    # is backend-specific (linux: "/dev/video{i}", mod.rs:305).
    prefix = getattr(driver, "device_prefix", "sim:")
    return f"{prefix}{index_or_id}"


class VideoCapture:
    """Synchronous camera facade backed by a worker thread."""

    def __init__(
        self,
        index: Union[int, str] = 0,
        driver: Optional[Driver] = None,
        config: Optional[CameraConfig] = None,
        decode_on_device: bool = False,
        mjpeg_hybrid: bool = False,
    ):
        if driver is None:
            from .avi import FileDriver, is_video_file

            if is_video_file(index):
                # OpenCV semantics: VideoCapture("clip.avi") opens the file
                # as an MJPEG source (read() returns False at end of video).
                driver = FileDriver()
        self._driver = driver if driver is not None else default_driver()
        self._device_id = resolve_device_id(index, self._driver)
        self._decode_on_device = decode_on_device
        self._mjpeg_hybrid = mjpeg_hybrid
        self._cmd: "queue.Queue" = queue.Queue(maxsize=1)
        self._res: "queue.Queue" = queue.Queue(maxsize=1)
        self._opened = threading.Event()
        self._resolved = None  # set by the worker before _opened
        # Initialized BEFORE the worker starts: the worker stores its open
        # error here, so assigning afterwards could erase it (race).
        self._last_error: Optional[Exception] = None
        self._worker = threading.Thread(
            target=self._worker_loop,
            args=(config if config is not None else CameraConfig(),),
            name="rustcv-bg-worker",
            daemon=True,
        )
        self._worker.start()

    # -- worker (mod.rs:57-157) -----------------------------------------

    def _worker_loop(self, config: CameraConfig) -> None:
        source = None
        try:
            source, _controls = self._driver.open(self._device_id, config)
            source.start()
            self._resolved = source.resolved_config()
            self._opened.set()
        except Exception as e:  # noqa: BLE001
            # Degraded open: stay alive, a later SetResolution may recover.
            # Catches EVERYTHING, not just CameraError — an unexpected error
            # (e.g. a malformed config object) must not kill the worker:
            # callers block on the response queue, so a dead worker turns
            # every later read() into a hang (found by a bad-config probe).
            source = None
            self._last_error = e

        while True:
            cmd = self._cmd.get()
            if isinstance(cmd, _Stop):
                if source is not None:
                    source.stop()
                return
            if isinstance(cmd, _NextFrame):
                if source is None:
                    self._res.put(_EndOfStream())
                    continue
                try:
                    frame = source.next_frame()
                    # COPY #1: detach from the ring before crossing threads.
                    self._res.put(
                        _FrameData(
                            frame.data.copy(), frame.width, frame.height,
                            frame.pixel_format, frame.sequence,
                        )
                    )
                except EndOfStreamError:
                    self._res.put(_EndOfStream())  # finite source drained
                except Exception as e:  # noqa: BLE001 — protocol invariant:
                    self._res.put(_Error(e))  # every command gets a response
            elif isinstance(cmd, _SetResolution):
                try:
                    if source is not None:
                        # Fully RELEASE the old source before reopening: real
                        # V4L2 devices are exclusive — STREAMOFF alone keeps
                        # the fd + mmap ring owned, so the reopen would EBUSY
                        # forever (stop→drop→reopen, mod.rs:115-147).
                        if hasattr(source, "close"):
                            source.close()
                        else:
                            source.stop()
                        source = None
                        _controls = None
                    cfg = CameraConfig().resolution(
                        cmd.width, cmd.height, Priority.REQUIRED
                    )
                    source, _controls = self._driver.open(self._device_id, cfg)
                    source.start()
                    self._resolved = source.resolved_config()
                    self._opened.set()
                    self._res.put(_PropertySet())
                except Exception as e:  # noqa: BLE001
                    source = None
                    self._opened.clear()
                    self._res.put(_Error(e))

    # -- public API (mod.rs:168-299) -------------------------------------

    def read(self, mat: Mat) -> bool:
        """Capture + decode the next frame into ``mat``. False on stream end."""
        if not self._worker.is_alive():
            return False
        self._cmd.put(_NextFrame())
        res = self._res.get()
        if isinstance(res, _EndOfStream):
            return False
        if isinstance(res, _Error):
            self._last_error = res.error
            return False

        fd: _FrameData = res
        if self._decode_on_device:
            if fd.pixel_format == PixelFormat.MJPEG:
                if self._mjpeg_hybrid:
                    from ..ops import jpeg_tpu

                    mat.set_device(jpeg_tpu.decode_jpeg_tpu(fd.data))
                    return True
                rgb = _decode.decode_mjpeg_host_rgb(fd.data)
                import jax

                from ..ops import color as dcolor

                dev = dcolor.rgb_to_bgr(jax.device_put(rgb).reshape(-1), rgb.shape[1], rgb.shape[0])
            else:
                import jax

                dev = _decode.convert_on_device(
                    jax.device_put(fd.data.reshape(-1)), fd.pixel_format, fd.width, fd.height
                )
            mat.set_device(dev)
            return True

        # Host decode on the caller thread (mod.rs:192-257 semantics).
        self._decode_host(fd, mat)
        return True

    @staticmethod
    def _decode_host(fd: _FrameData, mat: Mat) -> None:
        w, h = fd.width, fd.height
        if fd.pixel_format == PixelFormat.YUYV:
            mat.ensure_size(h, w, 3)
            mat.array[:] = golden.yuyv_to_bgr(fd.data, w, h)
        elif fd.pixel_format == PixelFormat.BGRA32:
            mat.ensure_size(h, w, 3)
            mat.array[:] = golden.bgra_to_bgr(fd.data, w, h)
        elif fd.pixel_format == PixelFormat.MJPEG:
            _decode.decode_mjpeg_into_mat(fd.data, mat)
        elif fd.pixel_format == PixelFormat.NV12:
            mat.ensure_size(h, w, 3)
            mat.array[:] = golden.nv12_to_bgr(fd.data, w, h)
        elif fd.pixel_format == PixelFormat.RGB24:
            mat.ensure_size(h, w, 3)
            mat.array[:] = golden.rgb_to_bgr(fd.data, w, h)
        else:  # raw copy fallback (mod.rs:255-257)
            mat.ensure_size(h, w, 3)
            n = min(fd.data.size, mat.rows * mat.row_bytes)
            mat.array.reshape(-1)[:n] = fd.data.reshape(-1)[:n]

    def set_resolution(self, width: int, height: int) -> bool:
        """Hot-swap resolution; blocks until renegotiation completes."""
        if not self._worker.is_alive():
            return False
        self._cmd.put(_SetResolution(width, height))
        res = self._res.get()
        if isinstance(res, _Error):
            self._last_error = res.error
            return False
        return isinstance(res, _PropertySet)

    def is_opened(self) -> bool:
        return self._worker.is_alive() and self._opened.is_set()

    def wait_until_resolved(self, timeout: float = 5.0) -> bool:
        """Block until the background open attempt settles (OpenCV's
        constructor-blocks semantics) → is_opened().  The worker either
        sets ``_opened`` or records ``_last_error`` and neither can be
        un-done before the first command, so polling both is race-free."""
        import time as _time

        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            if self._opened.is_set() or self._last_error is not None \
                    or not self._worker.is_alive():
                break
            _time.sleep(0.001)
        return self.is_opened()

    def get_width(self) -> int:
        """Negotiated width (mod.rs get_width — no frame is consumed)."""
        rc = getattr(self, "_resolved", None)
        return rc.width if rc is not None else 0

    def get_height(self) -> int:
        rc = getattr(self, "_resolved", None)
        return rc.height if rc is not None else 0

    @property
    def resolved_config(self):
        return getattr(self, "_resolved", None)

    @property
    def last_error(self) -> Optional[Exception]:
        return self._last_error

    def release(self) -> None:
        if self._worker.is_alive():
            try:
                self._cmd.put(_Stop(), timeout=1)
            except queue.Full:
                pass
            self._worker.join(timeout=2)

    def __enter__(self) -> "VideoCapture":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __del__(self):  # Drop impl analog (mod.rs:336-340)
        try:
            self.release()
        except Exception:
            pass
