"""FrameSource protocol — the Driver/Stream abstraction.

Analog of the reference's trait layer (``rustcv-core/src/traits.rs:95-180``):
``Driver::{list_devices, open} -> (Stream, DeviceControls)`` and
``Stream::{start, stop, next_frame, inject_frame}``, plus the split control
planes ``SensorControl`` / ``LensControl`` / ``SystemControl``
(``traits.rs:126-159``) and trigger config (``traits.rs:27-90``).

On a device host there is no camera hardware (BASELINE runs the simulation
source), so the only built-in driver is :mod:`.simulation`; the protocol is
the extension point for real capture backends.
"""

from __future__ import annotations

import abc
import enum
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..core.config import CameraConfig, ResolvedConfig
from ..core.frame import Frame
from ..core.pixel_format import PixelFormat
from ..core.telemetry import DeviceTelemetry


@dataclass(frozen=True)
class DeviceInfo:
    """Enumerated device identity (traits.rs:10-24)."""

    id: str
    name: str
    driver: str


@dataclass(frozen=True)
class ModeDescriptor:
    """One capturable mode: (format, width, height, supported fps list)."""

    pixel_format: PixelFormat
    width: int
    height: int
    fps_options: Tuple[int, ...] = (30,)


class TriggerMode(enum.Enum):
    FREE_RUN = "free_run"
    HARDWARE = "hardware"
    SOFTWARE = "software"


class TriggerPolarity(enum.Enum):
    RISING = "rising"
    FALLING = "falling"


@dataclass
class TriggerConfig:
    """Hardware-trigger configuration (traits.rs:27-90)."""

    mode: TriggerMode = TriggerMode.FREE_RUN
    source_line: int = 0
    polarity: TriggerPolarity = TriggerPolarity.RISING
    delay_us: int = 0


class FrameSource(abc.ABC):
    """A started stream of frames (the ``Stream`` trait analog)."""

    @abc.abstractmethod
    def start(self) -> None: ...

    @abc.abstractmethod
    def stop(self) -> None: ...

    @abc.abstractmethod
    def next_frame(self) -> Frame:
        """Blocking dequeue. The returned Frame is a zero-copy view valid
        until the next call (the previous Frame is invalidated — the runtime
        analog of the reference's borrow-checked contract)."""

    @abc.abstractmethod
    def resolved_config(self) -> ResolvedConfig: ...

    def inject_frame(self, data, pixel_format: PixelFormat, width: int, height: int) -> None:
        """Simulation/fault-injection hook (traits.rs:119-121). The reference
        declares this behind the ``simulation`` feature but never implements
        it; sources here may override (SimulationSource does)."""
        from ..core.errors import SimulationError

        raise SimulationError(f"inject_frame not supported by {type(self).__name__}")

    def telemetry(self) -> DeviceTelemetry:
        return DeviceTelemetry()


class SensorControl(abc.ABC):
    """Exposure/gain control plane (traits.rs:133-138)."""

    @abc.abstractmethod
    def set_exposure(self, exposure_us: Optional[int]) -> None:
        """None → auto-exposure; value → manual (V4L2 semantics:
        EXPOSURE_AUTO then EXPOSURE_ABSOLUTE, controls.rs:44-60)."""

    @abc.abstractmethod
    def set_gain(self, gain: Optional[float]) -> None: ...


class LensControl(abc.ABC):
    """Zoom/focus control plane (traits.rs:140-144)."""

    @abc.abstractmethod
    def set_zoom(self, zoom: float) -> None: ...

    @abc.abstractmethod
    def set_focus(self, focus: Optional[int]) -> None:
        """None → autofocus; value → manual absolute focus."""


class SystemControl(abc.ABC):
    """System-level plane (traits.rs:146-159)."""

    @abc.abstractmethod
    def force_reset(self) -> None:
        """Hard reset (the reference marks this ``unsafe``)."""

    @abc.abstractmethod
    def set_trigger(self, config: TriggerConfig) -> None: ...

    @abc.abstractmethod
    def export_state(self) -> Dict:
        """JSON-serializable snapshot of device settings (traits.rs:154-158)
        — the reference's nearest analog of checkpointing."""


@dataclass
class DeviceControls:
    """Aggregate of the split control surfaces (traits.rs:126-130)."""

    sensor: Optional[SensorControl] = None
    lens: Optional[LensControl] = None
    system: Optional[SystemControl] = None


class Driver(abc.ABC):
    """Device enumeration + open (the ``Driver`` trait analog)."""

    @abc.abstractmethod
    def list_devices(self) -> List[DeviceInfo]: ...

    @abc.abstractmethod
    def open(self, device_id: str, config: CameraConfig) -> Tuple[FrameSource, DeviceControls]: ...
