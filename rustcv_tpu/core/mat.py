"""Mat — the stride-aware BGR image container.

Reference parity:
- ``rustcv/src/core/mat.rs:6-52`` — rows/cols/channels + ``step`` (bytes per
  row, may exceed ``cols*channels`` for padded hardware layouts), ``row_bytes``,
  ``new/empty/is_empty``.
- ``rustcv-camera/src/mat.rs:20-129`` — ``ensure_size`` reallocates only when
  the dimensions actually change (zero allocation in steady-state read loops).

accelerator-native redesign (per BASELINE north star): a Mat can be **host-backed**
(NumPy ``uint8``, stride-aware — the zero-copy interop surface) or
**device-backed** (a packed ``jax.Array`` living in device memory). The two sides
materialize lazily: pipelines keep data on-device; only APIs that need host
bytes (``data``, ``imwrite``) pay a D2H copy. Mutating host bytes invalidates
the device twin and vice versa.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _as_view3(buf: np.ndarray, rows: int, cols: int, channels: int, step: int) -> np.ndarray:
    """A (rows, cols, channels) u8 view into a (rows, step) stride-aware buffer."""
    return np.lib.stride_tricks.as_strided(
        buf, shape=(rows, cols, channels), strides=(step, channels, 1), writeable=True
    )


class Mat:
    """BGR (or generic n-channel) u8 image with explicit row stride."""

    __slots__ = ("rows", "cols", "channels", "step", "_host", "_dev")

    def __init__(
        self,
        rows: int = 0,
        cols: int = 0,
        channels: int = 3,
        step: Optional[int] = None,
        _host: Optional[np.ndarray] = None,
        _dev=None,
    ):
        self.rows = rows
        self.cols = cols
        self.channels = channels
        self.step = step if step is not None else cols * channels
        if self.step < cols * channels:
            raise ValueError(f"step {self.step} < row_bytes {cols * channels}")
        self._host = _host
        self._dev = _dev
        if rows > 0 and _host is None and _dev is None:
            self._host = np.zeros((rows, self.step), dtype=np.uint8)

    # ---- constructors -------------------------------------------------

    @classmethod
    def empty(cls) -> "Mat":
        """An empty Mat (reference: ``Mat::empty``)."""
        return cls(0, 0, 3, 0)

    @classmethod
    def new(cls, rows: int, cols: int, channels: int = 3, step: Optional[int] = None) -> "Mat":
        return cls(rows, cols, channels, step)

    @classmethod
    def zeros(cls, rows: int, cols: int, channels: int = 3) -> "Mat":
        return cls(rows, cols, channels)

    @classmethod
    def from_array(cls, arr: np.ndarray) -> "Mat":
        """Wrap an HWC (or HW) u8 NumPy array. Copies only if non-contiguous."""
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if arr.dtype != np.uint8:
            raise TypeError(f"Mat requires uint8, got {arr.dtype}")
        arr = np.ascontiguousarray(arr)
        rows, cols, ch = arr.shape
        host = arr.reshape(rows, cols * ch)
        return cls(rows, cols, ch, cols * ch, _host=host)

    @classmethod
    def from_device(cls, dev_arr) -> "Mat":
        """Wrap a packed device array of shape (H, W, C) u8 without transfer."""
        if dev_arr.ndim == 2:
            rows, cols, ch = dev_arr.shape[0], dev_arr.shape[1], 1
        else:
            rows, cols, ch = dev_arr.shape
        return cls(rows, cols, ch, cols * ch, _dev=dev_arr)

    # ---- basic queries (rustcv/src/core/mat.rs) -----------------------

    def is_empty(self) -> bool:
        return self.rows == 0 or self.cols == 0

    @property
    def row_bytes(self) -> int:
        """Meaningful bytes per row = cols*channels (reference ``row_bytes``)."""
        return self.cols * self.channels

    def total(self) -> int:
        return self.rows * self.cols

    @property
    def shape(self):
        return (self.rows, self.cols, self.channels)

    # ---- host side -----------------------------------------------------

    def _materialize_host(self) -> np.ndarray:
        if self._host is None:
            if self._dev is None:
                self._host = np.zeros((self.rows, self.step), dtype=np.uint8)
            else:
                packed = np.asarray(self._dev).reshape(self.rows, self.row_bytes)
                if self.step == self.row_bytes:
                    self._host = np.ascontiguousarray(packed)
                else:
                    self._host = np.zeros((self.rows, self.step), dtype=np.uint8)
                    self._host[:, : self.row_bytes] = packed
        return self._host

    @property
    def data(self) -> np.ndarray:
        """Raw stride-aware bytes, shape (rows, step). Mutating invalidates
        the device twin (call sites that mutate should use :meth:`array`)."""
        host = self._materialize_host()
        self._dev = None  # conservatively assume the caller mutates
        return host

    @property
    def array(self) -> np.ndarray:
        """Writable (rows, cols, channels) u8 view of the host pixels."""
        host = self._materialize_host()
        self._dev = None
        return _as_view3(host, self.rows, self.cols, self.channels, self.step)

    def to_numpy(self) -> np.ndarray:
        """Read-only packed copy as (rows, cols, channels)."""
        if self._host is None and self._dev is not None:
            return np.asarray(self._dev).reshape(self.rows, self.cols, self.channels)
        host = self._materialize_host()
        return _as_view3(host, self.rows, self.cols, self.channels, self.step).copy()

    # ---- device side ----------------------------------------------------

    @property
    def is_on_device(self) -> bool:
        return self._dev is not None

    def device(self):
        """The packed (H, W, C) u8 device array; uploads host bytes if needed."""
        if self._dev is None:
            import jax

            packed = self.to_numpy() if self._host is not None else np.zeros(
                (self.rows, self.cols, self.channels), np.uint8
            )
            self._dev = jax.device_put(packed)
        return self._dev

    def set_device(self, dev_arr) -> None:
        """Replace contents with a device array (functional-update sink)."""
        if dev_arr.ndim == 2:
            rows, cols, ch = dev_arr.shape[0], dev_arr.shape[1], 1
        else:
            rows, cols, ch = dev_arr.shape
        self.rows, self.cols, self.channels = rows, cols, ch
        self.step = cols * ch
        self._dev = dev_arr
        self._host = None

    # ---- reuse semantics (rustcv-camera/src/mat.rs:65-74) --------------

    def ensure_size(self, rows: int, cols: int, channels: int = 3) -> None:
        """Reallocate only when dimensions change (steady-state zero-alloc)."""
        if (rows, cols, channels) == (self.rows, self.cols, self.channels) and (
            self._host is not None
        ):
            return
        self.rows, self.cols, self.channels = rows, cols, channels
        self.step = cols * channels
        self._host = np.zeros((rows, self.step), dtype=np.uint8)
        self._dev = None

    # ---- misc ----------------------------------------------------------

    def copy(self) -> "Mat":
        # Pass buffers through the constructor: the bare Mat(rows, ...) form
        # would allocate+zero a full frame only to discard it.
        return Mat(
            self.rows, self.cols, self.channels, self.step,
            _host=None if self._host is None else self._host.copy(),
            _dev=self._dev,
        )

    def __repr__(self) -> str:
        loc = "device" if (self._dev is not None and self._host is None) else "host"
        return (
            f"Mat({self.rows}x{self.cols}x{self.channels}, step={self.step}, {loc})"
        )
