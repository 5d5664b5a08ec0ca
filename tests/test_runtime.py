"""Runtime tests: fused pipelines, multi-stream engine, shape buckets, mesh
sharding over the 8-device virtual CPU mesh (BASELINE configs 2, 3, 5)."""

import numpy as np
import pytest

from rustcv_tpu.core import PixelFormat, SimpleConfig
from rustcv_tpu.capture import SimulationDriver, synth_raw
from rustcv_tpu.ops import golden
from rustcv_tpu.runtime import MultiStreamEngine, PipelineSpec, bucket_for, get_pipeline


def _driver(**kw):
    kw.setdefault("paced", False)
    return SimulationDriver(**kw)


class TestBuckets:
    def test_bucket_selection(self):
        assert bucket_for(640, 480) == (640, 480)
        assert bucket_for(600, 400) == (640, 480)
        assert bucket_for(1900, 1000) == (1920, 1080)


class TestPipeline:
    def test_cache_identity(self):
        s1 = PipelineSpec(PixelFormat.YUYV, 64, 48)
        s2 = PipelineSpec(PixelFormat.YUYV, 64, 48)
        assert get_pipeline(s1) is get_pipeline(s2)

    def test_convert_only(self, jax_cpu):
        spec = PipelineSpec(PixelFormat.YUYV, 64, 48)
        fn = get_pipeline(spec)
        raw = np.stack([synth_raw(64, 48, PixelFormat.YUYV, s) for s in range(4)])
        from rustcv_tpu.runtime import make_dummy_overlay

        out = fn(jax_cpu.device_put(raw), *make_dummy_overlay(4))
        want = np.stack([golden.yuyv_to_bgr(r, 64, 48) for r in raw])
        np.testing.assert_array_equal(np.asarray(out["bgr"]).reshape(want.shape), want)

    def test_full_chain_pixel_exact(self, jax_cpu):
        """convert → resize → blur_sobel → overlay, batch 2, vs oracle."""
        spec = PipelineSpec(
            PixelFormat.YUYV, 64, 48, resize_to=(32, 24),
            filter="blur_sobel", overlay=True,
        )
        fn = get_pipeline(spec)
        raw = np.stack([synth_raw(64, 48, PixelFormat.YUYV, s) for s in range(2)])
        rects = np.array([[2, 2, 10, 8], [5, 5, 12, 10]], np.int32)
        colors = np.array([[255, 0, 0], [0, 255, 0]], np.uint8)
        import jax.numpy as jnp

        out = fn(
            jax_cpu.device_put(raw), jnp.asarray(rects), jnp.asarray(colors),
            jnp.int32(2),
        )
        for i in range(2):
            bgr = golden.yuyv_to_bgr(raw[i], 64, 48)
            small = golden.resize_bilinear(bgr, 32, 24)
            mag = golden.blur_sobel_mag_u8(small)
            ov = small.copy()
            golden.rectangle(
                ov.reshape(24, -1), 24, 32, 32 * 3,
                tuple(rects[i]), tuple(colors[i]), 2,
            )
            np.testing.assert_array_equal(np.asarray(out["filtered"][i]), mag)
            # resize pipelines are packed-rows end-to-end now (r2): same
            # bytes, device-native (N, H, W*3) layout.
            np.testing.assert_array_equal(
                np.asarray(out["bgr"][i]).reshape(24, 32, 3), ov.reshape(24, 32, 3)
            )


    def test_resize_unaligned_dst_falls_back_interleaved(self, jax_cpu):
        """dst width not 4-aligned → interleaved path, identical pixels."""
        from rustcv_tpu.runtime import make_dummy_overlay

        spec = PipelineSpec(
            PixelFormat.YUYV, 64, 48, resize_to=(30, 20), filter="sobel_mag",
        )
        fn = get_pipeline(spec)
        raw = np.stack([synth_raw(64, 48, PixelFormat.YUYV, s) for s in range(2)])
        out = fn(jax_cpu.device_put(raw), *make_dummy_overlay(2))
        assert out["bgr"].shape == (2, 20, 30, 3)  # interleaved HWC
        for i in range(2):
            bgr = golden.yuyv_to_bgr(raw[i], 64, 48)
            small = golden.resize_bilinear(bgr, 30, 20)
            np.testing.assert_array_equal(np.asarray(out["bgr"][i]), small)
            gray = golden.bgr_to_gray(small)
            gx, gy = golden.sobel3_gray(gray)
            np.testing.assert_array_equal(
                np.asarray(out["filtered"][i]), golden.gradient_magnitude_u8(gx, gy)
            )


class TestEngine:
    def test_eight_streams_tick(self, jax_cpu):
        eng = MultiStreamEngine(
            _driver(), 8,
            SimpleConfig(width=64, height=48, pixel_format=PixelFormat.YUYV),
            filter="none",
        )
        res = eng.tick(block=True)
        assert res.numpy("bgr").shape == (8, 48, 64, 3)
        # every stream's frame 0 decoded exactly
        want = golden.yuyv_to_bgr(synth_raw(64, 48, PixelFormat.YUYV, 0), 64, 48)
        for i in range(8):
            np.testing.assert_array_equal(res.numpy("bgr")[i], want)
        eng.close()

    def test_mjpeg_host_decode_path(self, jax_cpu):
        eng = MultiStreamEngine(
            _driver(), 2,
            SimpleConfig(width=64, height=48, pixel_format=PixelFormat.MJPEG),
        )
        res = eng.tick(block=True)
        from rustcv_tpu.ops.decode import decode_mjpeg_host_rgb

        want = decode_mjpeg_host_rgb(synth_raw(64, 48, PixelFormat.MJPEG, 0))[..., ::-1]
        np.testing.assert_array_equal(res.numpy("bgr")[0], want)
        eng.close()

    def test_run_stats(self, jax_cpu):
        eng = MultiStreamEngine(
            _driver(), 4,
            SimpleConfig(width=64, height=48, pixel_format=PixelFormat.YUYV),
            filter="blur_sobel",
        )
        stats = eng.run(10, warmup=2)
        assert stats.ticks == 10 and stats.frames == 40
        assert stats.fps_per_stream > 0
        assert stats.p50_latency_ms > 0
        assert stats.dropped_frames == 0  # free-run sources never drop
        eng.close()

    def test_run_chained_honors_rects(self, jax_cpu):
        # Regression: run_chained used to reuse a cached dummy overlay and
        # silently ignore caller-provided rects.
        eng = MultiStreamEngine(
            _driver(device_count=2), 2,
            SimpleConfig(width=64, height=48, pixel_format=PixelFormat.YUYV),
            device_sim=True, overlay=True,
        )
        rects = np.array([[4, 4, 20, 16], [8, 8, 30, 20]], np.int32)
        cols = np.array([[0, 255, 0], [255, 0, 0]], np.uint8)
        st = eng.run_chained(4, chain=2, rects=rects, rect_colors=cols)
        assert st.ticks == 4 and st.frames == 8
        st2 = eng.run_chained(4, chain=2)  # dummy path still works after
        assert st2.ticks == 4
        eng.close()

    def test_set_resolution_hot_swap(self, jax_cpu):
        eng = MultiStreamEngine(
            _driver(), 2,
            SimpleConfig(width=64, height=48, pixel_format=PixelFormat.YUYV),
        )
        r1 = eng.tick(block=True)
        assert r1.numpy("bgr").shape == (2, 48, 64, 3)
        eng.set_resolution(160, 120)
        r2 = eng.tick(block=True)
        assert r2.numpy("bgr").shape == (2, 120, 160, 3)
        eng.close()

    def test_mesh_sharded_engine(self, jax_cpu):
        if len(jax_cpu.devices()) < 8:
            import pytest

            pytest.skip("needs 8 devices (virtual CPU mesh)")
        from rustcv_tpu.parallel import stream_mesh

        mesh = stream_mesh()
        assert mesh.devices.size == 8
        eng = MultiStreamEngine(
            _driver(), 8,
            SimpleConfig(width=64, height=48, pixel_format=PixelFormat.YUYV),
            filter="sobel_mag",
            mesh=mesh,
        )
        res = eng.tick(block=True)
        # sharded over 8 devices along streams
        assert len(res.outputs["bgr"].sharding.device_set) == 8
        want = golden.yuyv_to_bgr(synth_raw(64, 48, PixelFormat.YUYV, 0), 64, 48)
        np.testing.assert_array_equal(res.numpy("bgr")[3], want)
        g = golden.bgr_to_gray(want)
        gx, gy = golden.sobel3_gray(g)
        np.testing.assert_array_equal(
            res.numpy("filtered")[5], golden.gradient_magnitude_u8(gx, gy)
        )
        eng.close()

    def test_mesh_sharded_engine_with_fused_encode(self, jax_cpu):
        """Stream-DP mesh + fused JPEG encode: the coefficient outputs shard
        over the batch axis and the payloads must equal the meshless run's
        byte-for-byte."""
        if len(jax_cpu.devices()) < 8:
            pytest.skip("needs 8 devices (virtual CPU mesh)")
        from rustcv_tpu import native
        from rustcv_tpu.parallel import stream_mesh

        if not native.available():
            pytest.skip("native lib unavailable")
        kw = dict(
            filter="none", overlay=False, encode_jpeg_quality=88,
        )
        cfg = SimpleConfig(width=64, height=48, pixel_format=PixelFormat.YUYV)
        eng_mesh = MultiStreamEngine(_driver(), 8, cfg, mesh=stream_mesh(), **kw)
        eng_ref = MultiStreamEngine(_driver(), 8, cfg, **kw)
        try:
            pm = eng_mesh.encode_payloads(eng_mesh.tick(block=True))
            pr = eng_ref.encode_payloads(eng_ref.tick(block=True))
            assert pm == pr  # identical JFIF bytes per stream
        finally:
            eng_mesh.close()
            eng_ref.close()

    def test_mesh_psum_reduction(self, jax_cpu):
        if len(jax_cpu.devices()) < 8:
            import pytest

            pytest.skip("needs 8 devices (virtual CPU mesh)")
        from rustcv_tpu.parallel import corner_counts_psum, shard_batch, stream_mesh

        mesh = stream_mesh()
        mask = np.zeros((8, 16, 16), bool)
        mask[:, 4, 4] = True
        mask[0, 8, 8] = True
        total = corner_counts_psum(shard_batch(mask, mesh), mesh)
        assert int(total) == 9


class TestGaussianFilterPacked:
    def test_gaussian_filter_on_packed_path(self, jax_cpu):
        """Regression: filter='gaussian' must blur per channel even when the
        decode path produces packed-rows BGR."""
        eng = MultiStreamEngine(
            _driver(), 2,
            SimpleConfig(width=64, height=48, pixel_format=PixelFormat.YUYV),
            filter="gaussian", device_sim=True,
        )
        res = eng.tick(block=True)
        base = golden.yuyv_to_bgr(synth_raw(64, 48, PixelFormat.YUYV, 0), 64, 48)
        want = golden.gaussian5_u8(base)
        np.testing.assert_array_equal(np.asarray(res.outputs["filtered"])[0], want)
        eng.close()


class TestWarmBuckets:
    def test_warm_then_swap_uses_cache(self, jax_cpu):
        from rustcv_tpu.runtime import get_pipeline

        eng = MultiStreamEngine(
            _driver(), 2,
            SimpleConfig(width=64, height=48, pixel_format=PixelFormat.YUYV),
            device_sim=True,
        )
        n = eng.warm_buckets(buckets=[(64, 48), (160, 120)])
        assert n == 2
        info_before = get_pipeline.cache_info()
        eng.set_resolution(160, 120)  # must hit the warmed cache
        assert get_pipeline.cache_info().misses == info_before.misses
        assert eng.tick(block=True).numpy("bgr").shape == (2, 120, 160, 3)
        eng.close()


class TestSoakAndStats:
    def test_soak_200_ticks_counters_consistent(self, jax_cpu):
        eng = MultiStreamEngine(
            _driver(), 2,
            SimpleConfig(width=64, height=48, pixel_format=PixelFormat.YUYV),
            device_sim=True,
        )
        stats = eng.run(200, warmup=2, measure_latency=False)
        assert stats.ticks == 200 and stats.dropped_frames == 0
        res = eng.tick(block=True)
        assert list(res.sequences) == [202, 202]  # no clock drift over the soak
        eng.close()

    def test_host_gather_ms_populated(self, jax_cpu):
        eng = MultiStreamEngine(
            _driver(), 2,
            SimpleConfig(width=64, height=48, pixel_format=PixelFormat.YUYV),
        )
        stats = eng.run(5, warmup=1, measure_latency=False)
        assert stats.host_gather_ms > 0  # host path gathers frames
        eng.close()


class TestHarrisPoints:
    def test_corner_coordinates_output(self, jax_cpu):
        eng = MultiStreamEngine(
            _driver(), 2,
            SimpleConfig(width=160, height=120, pixel_format=PixelFormat.YUYV),
            filter="harris_points", device_sim=True,
        )
        res = eng.tick(block=True)
        coords = np.asarray(res.outputs["corners"])
        valid = np.asarray(res.outputs["corners_valid"])
        assert coords.shape == (2, 256, 2) and valid.shape == (2, 256)
        n_valid = int(valid[0].sum())
        assert n_valid > 0
        # every valid coordinate is a corner in the golden mask
        raw = synth_raw(160, 120, PixelFormat.YUYV, 0)
        gray = golden.bgr_to_gray(golden.yuyv_to_bgr(raw, 160, 120))
        mask = golden.harris_corners(gray)
        hits = sum(bool(mask[y, x]) for (y, x) in coords[0][valid[0]])
        assert hits >= 0.9 * n_valid
        eng.close()


class TestCannyFilter:
    def test_engine_canny(self, jax_cpu):
        eng = MultiStreamEngine(
            _driver(), 2,
            SimpleConfig(width=160, height=120, pixel_format=PixelFormat.YUYV),
            filter="canny", device_sim=True,
        )
        res = eng.tick(block=True)
        gray = golden.bgr_to_gray(
            golden.yuyv_to_bgr(synth_raw(160, 120, PixelFormat.YUYV, 0), 160, 120)
        )
        want = golden.canny(gray)
        np.testing.assert_array_equal(np.asarray(res.outputs["filtered"])[0], want)
        eng.close()


class TestSpatialParallel:
    """Row-band spatial sharding: ppermute halo exchange, bit-exact with the
    golden chain incl. the two-stage global border rule."""

    def test_spatial_blur_sobel_bit_exact(self, rng, jax_cpu):
        from rustcv_tpu.parallel import blur_sobel_mag_spatial, stream_mesh

        mesh = stream_mesh(axis="rows")
        for shape in ((2, 64, 96), (1, 1080, 256), (3, 48, 64)):
            g = rng.integers(0, 256, shape, dtype=np.uint8)
            got = np.asarray(blur_sobel_mag_spatial(jax_cpu.numpy.asarray(g), mesh))
            want = np.stack([
                golden.gradient_magnitude_u8(*golden.sobel3_gray(golden.gaussian5_u8(x)))
                for x in g
            ])
            np.testing.assert_array_equal(got, want, err_msg=str(shape))

    @pytest.mark.parametrize("n_dev", [2, 4, 8])
    def test_spatial_blur_sobel_mesh_sizes(self, rng, jax_cpu, n_dev):
        """One tall frame over 2, 4 and 8 devices (each band ≥ HALO rows)."""
        from rustcv_tpu.parallel import blur_sobel_mag_spatial, stream_mesh

        mesh = stream_mesh(jax_cpu.devices()[:n_dev], axis="rows")
        g = rng.integers(0, 256, (1, 24 * n_dev, 72), dtype=np.uint8)
        got = np.asarray(blur_sobel_mag_spatial(jax_cpu.numpy.asarray(g), mesh))
        want = golden.gradient_magnitude_u8(
            *golden.sobel3_gray(golden.gaussian5_u8(g[0])))
        np.testing.assert_array_equal(got[0], want)

    def test_spatial_2d_mesh_bit_exact(self, rng, jax_cpu):
        """2-D (streams × rows) mesh: stream-DP and row-sharded halos in
        ONE program over one mesh — still bit-exact vs golden."""
        import jax as _jax

        from rustcv_tpu.parallel import blur_sobel_mag_spatial_2d, grid_mesh

        if len(_jax.devices()) < 8:
            pytest.skip("needs the 8-device virtual mesh")
        mesh = grid_mesh(4, 2)
        g = rng.integers(0, 256, (4, 64, 96), dtype=np.uint8)
        got = np.asarray(blur_sobel_mag_spatial_2d(jax_cpu.numpy.asarray(g), mesh))
        want = np.stack([
            golden.gradient_magnitude_u8(*golden.sobel3_gray(golden.gaussian5_u8(x)))
            for x in g
        ])
        np.testing.assert_array_equal(got, want)
        # batch sizes that are multiples of the stream axis also work
        g2 = rng.integers(0, 256, (8, 32, 64), dtype=np.uint8)
        got2 = np.asarray(blur_sobel_mag_spatial_2d(jax_cpu.numpy.asarray(g2), mesh))
        want2 = np.stack([
            golden.gradient_magnitude_u8(*golden.sobel3_gray(golden.gaussian5_u8(x)))
            for x in g2
        ])
        np.testing.assert_array_equal(got2, want2)

    def test_spatial_rejects_tiny_bands(self, rng, jax_cpu):
        from rustcv_tpu.parallel import blur_sobel_mag_spatial, stream_mesh

        mesh = stream_mesh(axis="rows")
        if mesh.devices.size == 1:
            pytest.skip("band/divisibility constraints are vacuous on 1 device")
        g = rng.integers(0, 256, (1, 8, 128), dtype=np.uint8)  # 1-row bands
        with pytest.raises(ValueError):
            blur_sobel_mag_spatial(jax_cpu.numpy.asarray(g), mesh)
        with pytest.raises(ValueError):  # indivisible height
            blur_sobel_mag_spatial(jax_cpu.numpy.asarray(g[:, :7]), mesh)

    def test_spatial_output_stays_sharded(self, rng, jax_cpu):
        from rustcv_tpu.parallel import blur_sobel_mag_spatial, stream_mesh

        mesh = stream_mesh(axis="rows")
        g = jax_cpu.numpy.asarray(rng.integers(0, 256, (1, 64, 128), np.uint8))
        out = blur_sobel_mag_spatial(g, mesh)
        assert len(out.sharding.device_set) == mesh.devices.size


class TestSubBatch:
    """sub_batch: sequential narrow sub-ticks inside one program — XLA's
    temp working set grows faster than linearly with batch width, and
    chunking restores the narrow working set. Outputs must be
    BIT-IDENTICAL to the monolithic program."""

    def test_outputs_match_monolithic(self, jax_cpu):
        def mk(sub):
            return MultiStreamEngine(
                SimulationDriver(device_count=4, paced=False), 4,
                SimpleConfig(width=128, height=96,
                             pixel_format=PixelFormat.YUYV),
                filter="blur_sobel", overlay=True, device_sim=True,
                sub_batch=sub,
            )

        rects = np.tile(np.array([[10, 10, 60, 40]], np.int32), (4, 1))
        colors = np.tile(np.array([[0, 255, 0]], np.uint8), (4, 1))
        eng_m, eng_s = mk(None), mk(2)
        for _ in range(3):
            rm = eng_m.tick(block=True, rects=rects, rect_colors=colors)
            rs = eng_s.tick(block=True, rects=rects, rect_colors=colors)
            np.testing.assert_array_equal(rm.numpy("bgr"), rs.numpy("bgr"))
            np.testing.assert_array_equal(rm.numpy("filtered"),
                                          rs.numpy("filtered"))
        eng_m.close()
        eng_s.close()

    def test_validation(self, jax_cpu):
        cfg = SimpleConfig(width=64, height=48,
                           pixel_format=PixelFormat.YUYV)
        with pytest.raises(ValueError, match="divide"):
            MultiStreamEngine(SimulationDriver(device_count=4, paced=False),
                              4, cfg, device_sim=True, sub_batch=3)
        with pytest.raises(ValueError, match="device_sim"):
            MultiStreamEngine(SimulationDriver(device_count=4, paced=False),
                              4, cfg, sub_batch=2)
