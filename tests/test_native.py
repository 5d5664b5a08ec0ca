"""Native C++ layer tests: build, bit-exact parity with the frozen Python
specs, and the ring's DQBUF-style semantics."""

import time

import numpy as np
import pytest

from rustcv_tpu import native
from rustcv_tpu.capture import simulation as sim
from rustcv_tpu.core import PixelFormat, ResolvedConfig
from rustcv_tpu.ops import golden

pytestmark = pytest.mark.skipif(
    not native.available(), reason=f"native lib unavailable: {native.build_error()}"
)


class TestNativeParity:
    @pytest.mark.parametrize("w,h,seq", [(64, 48, 0), (160, 120, 7), (130, 54, 999)])
    def test_synth_bgr(self, w, h, seq):
        np.testing.assert_array_equal(native.synth_bgr(w, h, seq), sim.synth_bgr(w, h, seq))

    @pytest.mark.parametrize("w,h,seq", [(64, 48, 0), (160, 120, 42)])
    def test_synth_yuyv(self, w, h, seq):
        want = sim.synth_raw(w, h, PixelFormat.YUYV, seq)
        np.testing.assert_array_equal(native.synth_yuyv(w, h, seq), want)

    def test_yuyv_to_bgr(self, rng):
        src = rng.integers(0, 256, 64 * 48 * 2, dtype=np.uint8)
        want = golden.yuyv_to_bgr(src, 64, 48)
        np.testing.assert_array_equal(native.yuyv_to_bgr(src, 64, 48), want)


class TestNativeRing:
    def test_free_run_sequenced(self):
        ring = native.NativeRing(4, 64, 48)
        ring.start(fps=1000, paced=False)
        try:
            seqs = []
            for _ in range(5):
                res = ring.dequeue()
                assert res is not None
                slot, view, seq, ts = res
                seqs.append(seq)
                # frame content matches the frozen spec for its seq
                np.testing.assert_array_equal(
                    view, sim.synth_raw(64, 48, PixelFormat.YUYV, seq)
                )
                ring.requeue(slot)
            assert seqs == sorted(seqs)
        finally:
            ring.stop()
            ring.close()

    def test_drops_when_consumer_stalls(self):
        ring = native.NativeRing(2, 64, 48)
        ring.start(fps=500, paced=True)
        try:
            res = ring.dequeue()
            assert res is not None
            time.sleep(0.1)  # hold the slot; ring has 1 free slot for ~50 frames
            assert ring.dropped > 0
        finally:
            ring.stop()
            ring.close()


class TestNativeSource:
    def test_frame_source_contract(self):
        from rustcv_tpu.capture.native_source import NativeSimulationSource

        src = NativeSimulationSource(
            ResolvedConfig(64, 48, 120, PixelFormat.YUYV, 4), paced=False
        )
        src.start()
        try:
            f0 = src.next_frame()
            s0 = f0.sequence
            np.testing.assert_array_equal(
                f0.data, sim.synth_raw(64, 48, PixelFormat.YUYV, s0)
            )
            owned = f0.to_owned()
            f1 = src.next_frame()
            assert f1.sequence > s0
            with pytest.raises(RuntimeError):
                _ = f0.data  # slot requeued → view invalid
            _ = owned.data
            assert src.telemetry().link_throughput_mbps > 0
        finally:
            src.close()


class TestJpegEntropyRobustness:
    """The entropy parser runs on untrusted camera/MJPEG bytes (a 7-byte
    truncated DQT once overflowed the heap). Malformed input must raise
    ValueError — never read out of bounds or crash."""

    def _sample(self):
        from rustcv_tpu.capture.simulation import encode_mjpeg, synth_bgr

        return bytes(encode_mjpeg(synth_bgr(96, 64, 3)))

    def test_advice_repro_truncated_dqt(self):
        with pytest.raises(ValueError):
            native.jpeg_entropy_decode(b"\xff\xd8\xff\xdb\x00\x03\x00")

    def test_all_truncations_reject_cleanly(self):
        data = self._sample()
        info, coeffs, _ = native.jpeg_entropy_decode(data)  # sanity: valid
        assert info["width"] == 96
        for k in range(len(data)):
            try:
                native.jpeg_entropy_decode(data[:k])
            except ValueError:
                pass  # rejection is the expected outcome; crash is the bug

    def test_header_bitflips_reject_or_decode(self):
        data = bytearray(self._sample())
        for i in range(min(len(data), 300)):
            mutated = bytearray(data)
            mutated[i] ^= 0xFF
            try:
                native.jpeg_entropy_decode(bytes(mutated))
            except ValueError:
                pass

    def test_oversubscribed_dht_counts_rejected(self):
        # DHT whose 16 counts sum to 17*16=272 > 256 must be rejected, not
        # index values[256] out of bounds.
        seg = bytes([0x00] + [17] * 16) + bytes(range(256))
        dht = b"\xff\xc4" + (len(seg) + 2).to_bytes(2, "big") + seg
        data = b"\xff\xd8" + dht + b"\xff\xd9"
        with pytest.raises(ValueError):
            native.jpeg_entropy_decode(data)

    def test_packed_emitters_reject_truncations(self):
        """The packed/blockpacked emitters share the hardened parser; every
        truncation must reject via ValueError (ASan/UBSan-fuzzed in dev) —
        and None (over capacity) only on otherwise-valid streams."""
        data = self._sample()
        for k in range(0, len(data), 7):
            try:
                native.jpeg_entropy_decode_packed(data[:k], capacity=4096)
            except ValueError:
                pass
            try:
                native.jpeg_entropy_decode_blockpacked(data[:k], 4, 1024)
            except ValueError:
                pass

    def test_blockpacked_staging_shape_mismatch_is_valueerror(self):
        data = self._sample()
        import numpy as _np

        with pytest.raises(ValueError):
            native.jpeg_entropy_decode_blockpacked(
                data, 4, 64,
                out_idx=_np.zeros((7, 4), _np.uint8),
                out_val=_np.zeros((7, 4), _np.int16),
            )


class TestGilRelease:
    """The multi-worker scaling claim (decode/encode pools) rests on the
    ctypes coders releasing the GIL. A wall-clock speedup depends on the
    host's cores, so instead we prove the
    release directly: a pure-Python counter thread keeps making progress
    WHILE a native entropy decode runs. With the GIL held for the call's
    duration, the counter would sit frozen until the call returned.

    (sys.setswitchinterval is raised so the scheduler would NOT hand the
    GIL over mid-call by timeslice alone at this rate; progress therefore
    demonstrates an explicit release.)
    """

    def test_counter_progresses_during_native_decode(self):
        import sys
        import threading

        from rustcv_tpu.capture.simulation import encode_mjpeg, synth_bgr

        jpg = bytes(encode_mjpeg(synth_bgr(1280, 720, 3), quality=95))
        native.jpeg_entropy_decode(jpg)  # warm (lazy lib build)

        # One counter cell, not a growing list: while the main thread waits
        # to take the GIL back, the counter thread may run for a whole
        # switch interval, and a list would grow by gigabytes meanwhile.
        progress = [0]
        stop = threading.Event()

        def count():
            while not stop.is_set():
                progress[0] += 1

        t = threading.Thread(target=count, daemon=True)
        t.start()
        while not progress[0]:  # counter thread actually running
            time.sleep(0.001)
        old = sys.getswitchinterval()
        # No timeslice handoffs from here on: 1 s is far longer than the five
        # native calls take together, and each time the main thread wants
        # the GIL back it waits at most one interval.
        sys.setswitchinterval(1.0)
        try:
            before = progress[0]
            for _ in range(5):
                native.jpeg_entropy_decode(jpg)  # ~10+ ms of native work
            during = progress[0] - before
            stop.set()
            t.join(timeout=5)
            # With the GIL held across the native calls, `during` would be
            # ~0 (the main thread never yields within one interval).
            assert during > 1000, f"counter made only {during} steps"
        finally:
            sys.setswitchinterval(old)
