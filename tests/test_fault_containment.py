"""Per-stream fault containment: one failing source degrades that stream,
the batch keeps running."""

import numpy as np

from rustcv_tpu.capture import SimulationDriver
from rustcv_tpu.core import CameraError, PixelFormat, SimpleConfig
from rustcv_tpu.runtime import MultiStreamEngine


class _FlakySource:
    """Wraps a FrameSource; fails every call after `fail_after`."""

    def __init__(self, inner, fail_after: int):
        self._inner = inner
        self._count = 0
        self._fail_after = fail_after

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def next_frame(self):
        self._count += 1
        if self._count > self._fail_after:
            raise CameraError("synthetic device failure")
        return self._inner.next_frame()


def test_one_stream_fails_batch_survives(jax_cpu):
    eng = MultiStreamEngine(
        SimulationDriver(paced=False), 4,
        SimpleConfig(width=64, height=48, pixel_format=PixelFormat.YUYV),
    )
    # Sabotage stream 2 after its first frame.
    eng._sources[2] = _FlakySource(eng._sources[2], fail_after=1)

    r1 = eng.tick(block=True)
    assert list(r1.sequences) == [0, 0, 0, 0]
    r2 = eng.tick(block=True)
    # stream 2 failed: seq marked -1, error counted, other streams advanced
    assert r2.sequences[2] == -1
    assert [r2.sequences[i] for i in (0, 1, 3)] == [1, 1, 1]
    assert eng.stream_errors[2] == 1
    assert eng.stream_errors[[0, 1, 3]].sum() == 0
    # stream 2's staging row reuses its last good frame (tick-1 content)
    from rustcv_tpu.capture import synth_raw
    from rustcv_tpu.ops import golden

    stale = golden.yuyv_to_bgr(synth_raw(64, 48, PixelFormat.YUYV, 0), 64, 48)
    np.testing.assert_array_equal(r2.numpy("bgr")[2], stale)
    fresh = golden.yuyv_to_bgr(synth_raw(64, 48, PixelFormat.YUYV, 1), 64, 48)
    np.testing.assert_array_equal(r2.numpy("bgr")[0], fresh)
    eng.close()


def test_drop_count_ignores_fault_sentinel(jax_cpu):
    """A stream fault on the run's last tick recorded seq=-1 into
    the drop math and subtracted that stream's whole range. Sentinel ticks
    must be excluded from expected/observed counts."""
    eng = MultiStreamEngine(
        SimulationDriver(paced=False), 2,
        SimpleConfig(width=64, height=48, pixel_format=PixelFormat.YUYV),
    )
    # Stream 1 fails from tick 4 onward (incl. the final measured tick).
    eng._sources[1] = _FlakySource(eng._sources[1], fail_after=3)
    stats = eng.run(6, warmup=0, measure_latency=False)
    # No real drops happened: stream 0 delivered 0..5, stream 1 delivered
    # 0..2 then faulted; a bogus count would report ~3 drops here.
    assert stats.dropped_frames == 0
    eng.close()


def test_drop_count_ignores_first_tick_fault(jax_cpu):
    eng = MultiStreamEngine(
        SimulationDriver(paced=False), 2,
        SimpleConfig(width=64, height=48, pixel_format=PixelFormat.YUYV),
    )

    class _FailFirstN(_FlakySource):
        def next_frame(self):
            self._count += 1
            if self._count <= self._fail_after:
                raise CameraError("synthetic early failure")
            return self._inner.next_frame()

    eng._sources[1] = _FailFirstN(eng._sources[1], 2)
    stats = eng.run(5, warmup=0, measure_latency=False)
    assert stats.dropped_frames == 0
    eng.close()


def test_overlay_cache_is_content_keyed(jax_cpu):
    """The overlay cache was keyed by id(); a GC'd caller array
    could recycle its id and silently serve stale rects. Content changes —
    including IN-PLACE mutation — must take effect."""
    eng = MultiStreamEngine(
        SimulationDriver(paced=False), 1,
        SimpleConfig(width=64, height=48, pixel_format=PixelFormat.YUYV),
        overlay=True,
    )
    rects = np.array([[4, 4, 20, 16]], np.int32)
    colors = np.array([[0, 255, 0]], np.uint8)
    r1 = eng.tick(rects=rects, rect_colors=colors, block=True).numpy("bgr")[0]
    # top edge drawn at y=4 (BGR green)
    assert tuple(r1[4, 10]) == (0, 255, 0)

    # In-place mutation: move the rect; the old id is unchanged.
    rects[0] = [30, 30, 20, 10]
    r2 = eng.tick(rects=rects, rect_colors=colors, block=True).numpy("bgr")[0]
    assert tuple(r2[30, 35]) == (0, 255, 0)
    assert tuple(r2[4, 10]) != (0, 255, 0)

    # New same-shape array (CPython often recycles the id of the collected
    # previous one — the exact failure mode once seen).
    del rects
    rects2 = np.array([[10, 38, 20, 8]], np.int32)
    r3 = eng.tick(rects=rects2, rect_colors=colors, block=True).numpy("bgr")[0]
    assert tuple(r3[38, 15]) == (0, 255, 0)
    assert tuple(r3[30, 35]) != (0, 255, 0)
    eng.close()
