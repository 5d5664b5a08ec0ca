"""MultiStreamEngine — batched execution of N capture streams on one device
(or a mesh).

This replaces the reference's per-camera Tokio workers
(``rustcv/src/videoio/mod.rs:52-157``, dual-camera examples) with the
accelerator shape: every tick gathers one frame per stream into a host
staging block ``[N, raw_bytes]``, uploads once, and runs ONE fused jitted
program for decode→convert→filter→overlay (SURVEY.md §2.7 "batched
multi-stream execution"). Double-buffered staging + async dispatch overlap
host gather, H2D, and device compute across ticks.

MJPEG streams are entropy-decoded on the host thread pool (the sequential,
bit-granular part — SURVEY.md §7 hard-part #1) into BGR staging rows; all
raw formats upload undecoded (YUYV = 2 B/px, saving PCIe bandwidth) and
convert on the device.

Multi-device: pass a ``jax.sharding.Mesh``; the stream axis shards across
devices (data parallelism over cameras — the natural axis, SURVEY §5) and
every collective-free stage runs fully parallel.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import jax

from ..core.config import ResolvedConfig, SimpleConfig
from ..core.errors import CameraError, DecodeError
from ..core.pixel_format import PixelFormat
from ..capture.source import Driver, FrameSource
from ..ops import decode as _decode
from .pipeline import PipelineSpec, get_pipeline, make_dummy_overlay


@dataclass
class TickResult:
    """Outputs of one engine tick (device arrays unless fetched)."""

    outputs: Dict[str, jax.Array]
    sequences: np.ndarray  # [N] per-stream frame sequence numbers
    tick_index: int

    def numpy(self, key: str = "bgr") -> np.ndarray:
        out = np.asarray(self.outputs[key])
        if key == "bgr" and out.ndim == 3:
            # Device-native packed rows (N, H, W*3) → user-facing (N, H, W, 3)
            n, h, w3 = out.shape
            out = out.reshape(n, h, w3 // 3, 3)
        return out


@dataclass
class EngineStats:
    ticks: int = 0
    frames: int = 0
    wall_s: float = 0.0
    p50_latency_ms: float = 0.0
    p99_latency_ms: float = 0.0
    host_gather_ms: float = 0.0
    dropped_frames: int = 0
    latencies_ms: List[float] = field(default_factory=list)

    @property
    def fps_total(self) -> float:
        return self.frames / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def fps_per_stream(self) -> float:
        return self.ticks / self.wall_s if self.wall_s > 0 else 0.0


class MultiStreamEngine:
    """Own N sources; run the fused batched pipeline once per tick."""

    def __init__(
        self,
        driver: Driver,
        n_streams: int,
        config: SimpleConfig,
        *,
        filter: str = "none",
        resize_to: Optional[Tuple[int, int]] = None,
        overlay: bool = False,
        emit_bgr: bool = True,
        mesh: Optional["jax.sharding.Mesh"] = None,
        decode_workers: int = 8,
        device_sim: bool = False,
        mjpeg_backend: str = "host",
        encode_jpeg_quality: int = 0,
        encode_subsampling: str = "4:2:0",
        encode_packed: Optional[bool] = None,
        sub_batch: Optional[int] = None,
    ):
        """``device_sim=True`` synthesizes frames directly in device memory (see
        ops/synth.py) — the zero-H2D capture path for simulated streams. The
        sources are still opened for negotiation/config/telemetry; only the
        per-tick byte path moves on-device. Unsupported for MJPEG (entropy
        coding is host work).

        ``sub_batch``: process the stream batch as sequential chunks of
        this size INSIDE the one compiled program (``lax.map``), which
        bounds XLA's temporary working set to that of the narrow batch
        (it grows faster than linearly with batch width). Device-sim path
        only; must divide n_streams; not combined with ``mesh`` (each shard
        is already narrow)."""
        if n_streams < 1:
            raise ValueError("n_streams must be >= 1")
        self.n = n_streams
        self._driver = driver
        self._sources: List[FrameSource] = []
        self._open_all(config)

        rc = self._sources[0].resolved_config()
        self._resolved = rc
        if mjpeg_backend not in ("host", "hybrid"):
            raise ValueError(f"unknown mjpeg_backend {mjpeg_backend!r}")
        self._mjpeg_hybrid = (
            mjpeg_backend == "hybrid" and rc.pixel_format == PixelFormat.MJPEG
        )
        if self._mjpeg_hybrid:
            from .. import native as _native

            if not _native.available():
                raise CameraError(
                    f"mjpeg_backend='hybrid' needs the native library: {_native.build_error()}"
                )
        # Full-host MJPEG: prefer the native libjpeg-turbo pitched decode
        # (BGR scanlines straight into the staging row — bit-exact with the
        # PIL fallback, ~4× faster, zero intermediate copies).
        self._mjpeg_native = False
        if rc.pixel_format == PixelFormat.MJPEG and not self._mjpeg_hybrid:
            from .. import native as _native

            self._mjpeg_native = _native.jpeg_host_available()
        # Encoded delivery: block-pack the quantized coefficients on-device
        # (≈3× fewer D2H bytes) whenever the native packed coder can finish
        # them. K=10 slots covers typical q85 blocks; busy blocks escape as
        # dense rows with nbt/16 capacity (over-capacity ticks fall back to
        # fetching the dense grids, which remain program outputs).
        pack_k = 0
        pack_cap = 0
        if int(encode_jpeg_quality) > 0:
            if encode_packed is None:
                from .. import native as _native

                encode_packed = _native.available()
            if encode_packed:
                from ..ops.jpeg_encode import _geometry as _enc_geometry

                dw, dh = resize_to if resize_to is not None else (rc.width, rc.height)
                nbt = sum(
                    bh * bw for bh, bw in _enc_geometry(dw, dh, encode_subsampling)["blocks"]
                )
                pack_k = 10
                pack_cap = min(nbt, max(128, nbt // 16))
        self.spec = PipelineSpec(
            pixel_format=rc.pixel_format,
            width=rc.width,
            height=rc.height,
            resize_to=resize_to,
            filter=filter,
            overlay=overlay,
            emit_bgr=emit_bgr,
            mjpeg_hybrid=self._mjpeg_hybrid,
            mjpeg_staged_bgr=self._mjpeg_native,
            encode_jpeg=int(encode_jpeg_quality),
            encode_subsampling=encode_subsampling,
            encode_packed=pack_k,
            encode_dense_cap=pack_cap,
        )
        self._fn = get_pipeline(self.spec)
        self._coeff_staging = None  # hybrid MJPEG: built lazily at first tick
        self._packed_staging = None
        self._fn_dense = None
        self._qts = None
        self.stream_errors = np.zeros(self.n, np.int64)  # per-stream faults
        self._mesh = mesh
        self._in_sharding = None
        if mesh is not None:
            axis = mesh.axis_names[0]
            self._in_sharding = jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec(axis)
            )
            if n_streams % mesh.devices.size != 0:
                raise ValueError(
                    f"n_streams={n_streams} not divisible by mesh size {mesh.devices.size}"
                )

        self._device_sim = device_sim
        if sub_batch is not None:
            if not device_sim:
                raise ValueError("sub_batch requires device_sim=True")
            if mesh is not None:
                raise ValueError("sub_batch is per-device; shards on a mesh "
                                 "are already narrow")
            if n_streams % sub_batch:
                raise ValueError(
                    f"sub_batch={sub_batch} must divide n_streams={n_streams}")
            if sub_batch == n_streams:
                sub_batch = None  # monolithic anyway
        self._sub_batch = sub_batch
        self._sim_fn = None
        self._seqs = np.zeros(self.n, np.int64)
        self._seqs_dev = None
        self._overlay_cache = None  # (rects_id, colors_id, th) → device args
        self._sim_t0 = time.monotonic()
        self._frame_pool = None
        if device_sim:
            if rc.pixel_format == PixelFormat.MJPEG:
                raise CameraError("device_sim does not support MJPEG streams")
            pool_k = getattr(self._driver, "n_unique_frames", 0)
            if pool_k > 0:
                # Device frame pool: K wire-format frames pre-synthesized in
                # device memory; ticks gather from the pool like a camera's DMA'd ring
                # (removes synthesis from the measured pipeline — the analog
                # of the host path's n_unique_frames cache).
                from ..ops import synth as _synth

                self._frame_pool = _synth.synth_raw(
                    jax.numpy.arange(pool_k, dtype=jax.numpy.int32),
                    rc.width, rc.height, rc.pixel_format,
                )
            self._sim_fn = self._build_sim_fn()
            self._pool = None
            self._staging = []
        else:
            if self._mjpeg_hybrid:
                # Hybrid staging (packed coefficient rows) is geometry-
                # dependent and built lazily at the first tick; the dense BGR
                # staging below would be ~100 MB of dead host RAM at 8×1080p.
                self._staging = []
            else:
                nbytes = self.spec.raw_bytes()
                # Double-buffered staging: gather tick k+1 while tick k's
                # upload is in flight (host-side analog of the mmap ring).
                self._staging = [
                    np.zeros((self.n, nbytes), np.uint8) for _ in range(2)
                ]
            self._pool = (
                ThreadPoolExecutor(
                    max_workers=decode_workers, thread_name_prefix="rustcv-decode"
                )
                if rc.pixel_format == PixelFormat.MJPEG or self.n > 1
                else None
            )
        self._staging_idx = 0
        self._tick_index = 0

    def _build_sim_fn(self, spec=None, pool=None):
        """The composed device-sim program (synth → pipeline → clock) for
        ``spec``. Cached per spec so set_resolution back to a previously
        seen bucket reuses the SAME jit object (its compiled executable
        cache included) — without this, every swap rebuilt a fresh closure
        and recompiled an already-seen shape."""
        from ..ops import synth as _synth

        if spec is None:
            spec = self.spec
            pool = self._frame_pool
        if not hasattr(self, "_sim_fn_cache"):
            self._sim_fn_cache = {}
        key = (spec, None if pool is None else pool.shape[0])
        if key in self._sim_fn_cache:
            return self._sim_fn_cache[key]
        inner = get_pipeline(spec)
        sub = self._sub_batch

        def one_tick(seqs_c, rects_c, colors_c, thickness):
            if pool is not None:
                raw = jax.numpy.take(pool, seqs_c % pool.shape[0], axis=0)
            else:
                raw = _synth.synth_raw(seqs_c, spec.width, spec.height,
                                       spec.pixel_format)
            return inner(raw, rects_c, colors_c, thickness)

        def run(seqs, rects, rect_colors, thickness):
            if sub is None:
                out = one_tick(seqs, rects, rect_colors, thickness)
            else:
                # sequential 8-wide sub-ticks inside ONE program: keeps
                # XLA's temp working set at the narrow batch's size (see
                # constructor docstring)
                k = seqs.shape[0] // sub
                stacked = jax.lax.map(
                    lambda a: one_tick(a[0], a[1], a[2], thickness),
                    (seqs.reshape(k, sub),
                     rects.reshape(k, sub, rects.shape[-1]),
                     rect_colors.reshape(k, sub, rect_colors.shape[-1])))
                out = {
                    key: (v[0] if key == "_sync"
                          else v.reshape(v.shape[0] * v.shape[1],
                                         *v.shape[2:]))
                    for key, v in stacked.items()
                }
            # Self-advancing stream clock: the next tick feeds this back, so
            # steady-state ticks perform ZERO host→device transfers.
            out["_next_seqs"] = seqs + 1
            return out

        fn = jax.jit(run)
        self._sim_fn_cache[key] = fn
        return fn

    def _build_sim_fn_chained(self, k: int):
        """K whole ticks per dispatch via ``lax.scan`` over the device-
        resident stream clock — dispatch amortization for the tiny
        single-stream programs where per-tick dispatch dominates device
        work (the chain is IN-PROGRAM: one dispatch runs K data-dependent
        ticks). Returns {"_sync", "_next_seqs"} only — a throughput shape;
        consumers needing outputs run normal ticks."""
        import jax.numpy as jnp

        from ..ops import synth as _synth

        spec = self.spec
        inner = self._fn
        pool = self._frame_pool

        def run(seqs, rects, rect_colors, thickness):
            def body(s, _):
                if pool is not None:
                    raw = jnp.take(pool, s % pool.shape[0], axis=0)
                else:
                    raw = _synth.synth_raw(s, spec.width, spec.height, spec.pixel_format)
                out = inner(raw, rects, rect_colors, thickness)
                # Probe = full reduction over EVERY output array. A sliced
                # probe (the normal _sync) would let XLA dead-code the whole
                # tick down to one pixel's dependency cone inside the fused
                # scan body.
                probe = jnp.int32(0)
                for key, v in out.items():
                    if key != "_sync":
                        probe = probe + v.astype(jnp.int32).sum()
                return s + 1, probe

            final_seqs, probes = jax.lax.scan(body, seqs, None, length=k)
            return {
                "_sync": probes.sum()[None],
                "_next_seqs": final_seqs,
            }

        return jax.jit(run)

    def run_chained(
        self,
        n_ticks: int,
        *,
        chain: int = 16,
        warmup: int = 1,
        rects: Optional[np.ndarray] = None,
        rect_colors: Optional[np.ndarray] = None,
    ) -> EngineStats:
        """Dispatch-amortized throughput harness (device_sim only): each
        dispatch executes ``chain`` ticks in-program; dispatches pipeline
        back-to-back and waiting on the last one bounds the run; per-dispatch
        overhead is amortized over ``chain`` ticks.

        This is the DEVICE-ONLY rate — device_sim synthesizes frames in
        device memory, so chained numbers exclude the H2D ingest path
        entirely (ingest-inclusive rates are the unchained host-staged
        rows / `host_path_fps` in bench.py)."""
        if not self._device_sim:
            raise CameraError("run_chained requires device_sim=True")
        if getattr(self, "_chain_fns", None) is None:
            self._chain_fns = {}
        if chain not in self._chain_fns:
            self._chain_fns[chain] = self._build_sim_fn_chained(chain)
        fn = self._chain_fns[chain]

        # Always build overlay args from the call (a cached "dummy" entry
        # must not shadow caller-provided rects); they upload once per run.
        r = jax.numpy.asarray(
            rects if rects is not None else np.zeros((self.n, 4), np.int32),
            jax.numpy.int32,
        )
        c = jax.numpy.asarray(
            rect_colors if rect_colors is not None else np.zeros((self.n, 3), np.uint8),
            jax.numpy.uint8,
        )
        th = jax.numpy.int32(2)

        seqs = jax.numpy.asarray(self._seqs.astype(np.int32))
        if self._in_sharding is not None:
            seqs = jax.device_put(np.asarray(seqs), self._in_sharding)
        for _ in range(max(1, warmup)):
            out = fn(seqs, r, c, th)
            np.asarray(out["_sync"])
            seqs = out["_next_seqs"]

        n_disp = max(1, n_ticks // chain)
        t0 = time.perf_counter()
        out = None
        for _ in range(n_disp):
            out = fn(seqs, r, c, th)
            seqs = out["_next_seqs"]
        jax.block_until_ready(out)  # programs run in dispatch order
        wall = time.perf_counter() - t0

        self._seqs = np.asarray(seqs).astype(np.int64)
        self._seqs_dev = None
        stats = EngineStats()
        stats.ticks = n_disp * chain
        stats.frames = stats.ticks * self.n
        stats.wall_s = wall
        return stats

    # ------------------------------------------------------------------

    def _open_all(self, config: SimpleConfig) -> None:
        for s in self._sources:
            s.stop()
        self._sources = []
        for i in range(self.n):
            if hasattr(self._driver, "open_simple"):
                src, _ = self._driver.open_simple(f"sim:{i}", config)
            else:
                from ..core.config import CameraConfig, Priority

                cfg = CameraConfig()
                if config.width is not None:
                    cfg = cfg.resolution(config.width, config.height, Priority.HIGH)
                src, _ = self._driver.open(f"sim:{i}", cfg)
            src.start()
            self._sources.append(src)
        # Homogeneous-batch invariant: one shape bucket per engine.
        cfgs = {
            (s.resolved_config().width, s.resolved_config().height,
             s.resolved_config().pixel_format)
            for s in self._sources
        }
        if len(cfgs) != 1:
            raise CameraError(f"streams negotiated heterogeneous configs: {cfgs}")

    @property
    def resolved_config(self) -> ResolvedConfig:
        return self._resolved

    @property
    def sources(self) -> Sequence[FrameSource]:
        return tuple(self._sources)

    # ------------------------------------------------------------------

    def _gather_row(
        self, i: int, staging: np.ndarray, prev: np.ndarray, seqs: np.ndarray
    ) -> None:
        """Fill stream i's staging row. Per-stream fault containment: a
        failing source does not kill the tick — its last good frame is reused
        (copied from the previous staging buffer), the error is counted, and
        the batch proceeds (degraded-stream semantics, the batched analog of
        the reference's capture-error backoff loop)."""
        try:
            frame = self._sources[i].next_frame()
            seqs[i] = frame.sequence
            if self._resolved.pixel_format == PixelFormat.MJPEG:
                if self._mjpeg_native:
                    # SIMD decode of BGR scanlines directly into the pitched
                    # staging row — no intermediate image, no device swap.
                    from .. import native as _native

                    w, h = self._resolved.width, self._resolved.height
                    try:
                        got = _native.jpeg_decode_pitched(
                            frame.data, staging[i].reshape(h, w * 3), bgr=True
                        )
                    except ValueError as e:  # corrupt frame → stream fault
                        raise DecodeError(str(e)) from e
                    if got != (w, h):
                        raise CameraError(
                            f"stream {i} geometry {got} != negotiated ({w}, {h})"
                        )
                else:
                    rgb = _decode.decode_mjpeg_host_rgb(frame.data)
                    staging[i] = rgb.reshape(-1)  # device swaps RGB→BGR
            else:
                staging[i] = frame.data.reshape(-1)
        except CameraError as e:
            self.stream_errors[i] += 1
            seqs[i] = -1
            staging[i] = prev[i]  # last good frame
            from ..utils import get_logger

            get_logger().warning("stream %d capture failed (reusing last frame): %s", i, e)

    # -- hybrid MJPEG gather (C++ entropy decode → coefficient staging) ----

    def _entropy_decode_checked(self, i: int):
        from .. import native as _native

        frame = self._sources[i].next_frame()
        info, coeffs, qts = _native.jpeg_entropy_decode(frame.data)
        if (info["width"], info["height"]) != (
            self._resolved.width, self._resolved.height,
        ):
            raise CameraError(
                f"stream {i} geometry {info['width']}x{info['height']} != negotiated"
            )
        return frame.sequence, coeffs, qts

    def _init_hybrid(self) -> tuple:
        """Sizing pass: stream 0's first frame fixes the coefficient geometry
        (subsampling), quant tables, and the packed capacity; compiles the
        packed-input pipeline variant. Returns (seq0, dense coeffs) so the
        caller can fold the consumed frame into the first tick."""
        from dataclasses import replace

        seq, coeffs, qts = self._entropy_decode_checked(0)
        if coeffs[1].shape != coeffs[2].shape:
            raise CameraError("hybrid MJPEG expects matching Cb/Cr geometry")
        self._coeff_shapes = [c.shape for c in coeffs]
        total = int(sum(c.size for c in coeffs))
        self._coeff_total = total
        nblocks = int(sum(c.shape[0] * c.shape[1] for c in coeffs))
        self._nblocks = nblocks
        # Block-packed sizing from the first frame's per-block nonzero
        # histogram (shared policy: ops/jpeg_tpu.choose_block_packing).
        from ..ops.jpeg_tpu import choose_block_packing

        nnzb = np.concatenate(
            [(c != 0).sum(axis=(2, 3)).reshape(-1) for c in coeffs]
        )
        self._packed_k, self._dense_cap = choose_block_packing(nnzb)
        k = self._packed_k
        self._qts = (
            jax.device_put(qts[0].astype(np.int32)),
            jax.device_put(qts[1].astype(np.int32)),
        )
        self._coeff_staging = [
            [np.zeros((self.n, *c.shape), np.int16) for c in coeffs]
            for _ in range(2)
        ]
        self._packed_staging = [
            (
                np.zeros((self.n, nblocks, k), np.uint8),
                np.zeros((self.n, nblocks, k), np.int16),
                np.full((self.n, self._dense_cap), nblocks, np.int32),
                np.zeros((self.n, self._dense_cap, 64), np.int16),
            )
            for _ in range(2)
        ]
        # Packed-input program (H2D ~10× smaller); the dense program stays
        # compiled for over-capacity fallback ticks.
        self._fn_dense = self._fn
        geom = tuple((int(s[0]), int(s[1])) for s in self._coeff_shapes)
        self.spec = replace(self.spec, mjpeg_packed=True, coeff_geometry=geom)
        self._fn = get_pipeline(self.spec)
        return seq, coeffs

    def _pack_dense_host(self, i: int, coeffs, staging) -> bool:
        """Host-side block-pack of dense grids into stream i's packed rows.
        Returns False if the busy blocks exceed the dense-row capacity."""
        idx_st, val_st, dense_ids_st, dense_rows_st = staging
        k = self._packed_k
        blocks = np.concatenate([c.reshape(-1, 64) for c in coeffs])
        nnzb = (blocks != 0).sum(axis=1)
        busy = np.flatnonzero(nnzb > k)
        if busy.size > self._dense_cap:
            return False
        light = nnzb <= k
        bid, j = np.nonzero(blocks * light[:, None])
        rank = np.zeros_like(bid)
        if bid.size:
            # rank within block (nonzeros are emitted in natural order)
            starts = np.flatnonzero(np.diff(bid, prepend=-1))
            rank = np.arange(bid.size) - np.repeat(starts, np.diff(np.append(starts, bid.size)))
        idx_st[i] = 0
        val_st[i] = 0
        idx_st[i, bid, rank] = j.astype(np.uint8)
        val_st[i, bid, rank] = blocks[bid, j]
        dense_ids_st[i] = self._nblocks  # scratch-row sentinel
        dense_rows_st[i] = 0
        dense_ids_st[i, : busy.size] = busy.astype(np.int32)
        dense_rows_st[i, : busy.size] = blocks[busy]
        return True

    def _gather_row_hybrid(
        self, i, staging, prev_staging, dense_bufs, seqs, dense_flags
    ):
        """Block-packed entropy decode for stream i; frames whose overflow
        exceeds capacity dense-decode instead and flag the tick. Per-stream
        fault containment like the raw path: capture/decode errors reuse the
        previous tick's packed rows (seq=-1 sentinel, error counted) instead
        of killing the whole batched tick."""
        from .. import native as _native

        idx_st, val_st, dense_ids_st, dense_rows_st = staging
        try:
            frame = self._sources[i].next_frame()
            seqs[i] = frame.sequence
            try:
                r = _native.jpeg_entropy_decode_blockpacked(
                    frame.data, self._packed_k, self._dense_cap,
                    out_idx=idx_st[i], out_val=val_st[i],
                    out_dense_ids=dense_ids_st[i], out_dense_rows=dense_rows_st[i],
                )
            except ValueError as e:  # corrupt frame → taxonomy
                raise DecodeError(str(e)) from e
            if r is None:  # busy blocks over capacity — decode dense, same bytes
                # The aborted packed decode left stream i's staging rows
                # partially overwritten; restore the last good rows so a
                # later fault-reuse never copies a half-written frame.
                for cur, prev in zip(staging, prev_staging):
                    cur[i] = prev[i]
                try:
                    info, coeffs, _qts = _native.jpeg_entropy_decode(frame.data)
                except ValueError as e:
                    raise DecodeError(str(e)) from e
                self._check_geometry(i, info)
                for c in range(3):
                    if dense_bufs[c][i].shape != coeffs[c].shape:
                        raise DecodeError(
                            f"stream {i} coefficient grid {coeffs[c].shape} != "
                            f"negotiated {dense_bufs[c][i].shape} (subsampling changed)"
                        )
                    dense_bufs[c][i] = coeffs[c]
                dense_flags[i] = True
                return
            self._check_geometry(i, r[0])
        except (CameraError, ValueError) as e:
            # ValueError: staging/grid mismatches from mid-stream geometry
            # changes (wrapper raises them deliberately) — same containment.
            self.stream_errors[i] += 1
            seqs[i] = -1
            for cur, prev in zip(staging, prev_staging):
                cur[i] = prev[i]  # last good packed rows
            from ..utils import get_logger

            get_logger().warning(
                "stream %d hybrid capture failed (reusing last frame): %s", i, e
            )

    def _check_geometry(self, i: int, info: dict) -> None:
        if (info["width"], info["height"]) != (
            self._resolved.width, self._resolved.height,
        ):
            raise CameraError(
                f"stream {i} geometry {info['width']}x{info['height']} != negotiated"
            )

    def gather_hybrid(self):
        """One frame per stream → packed nonzero-coefficient staging (the
        host does only the sequential entropy decode; GIL is released inside
        the native call, so streams decode in parallel). Returns
        ``(kind, bufs, seqs)`` with kind "packed" (pos/val arrays) or
        "dense" (per-component grids, the over-capacity fallback)."""
        seqs = np.zeros(self.n, np.int64)
        first_rest = 0
        seed = None
        if self._coeff_staging is None:
            seq0, coeffs0 = self._init_hybrid()
            seqs[0] = seq0
            seed = coeffs0
            first_rest = 1
        staging = self._packed_staging[self._staging_idx]
        prev_staging = self._packed_staging[self._staging_idx ^ 1]
        dense_bufs = self._coeff_staging[self._staging_idx]
        self._staging_idx ^= 1
        dense_flags = np.zeros(self.n, bool)
        if seed is not None:
            if not self._pack_dense_host(0, seed, staging):
                for c in range(3):
                    dense_bufs[c][0] = seed[c]
                dense_flags[0] = True
        futs = [
            self._pool.submit(
                self._gather_row_hybrid, i, staging, prev_staging, dense_bufs,
                seqs, dense_flags,
            )
            for i in range(first_rest, self.n)
        ]
        for f in futs:
            f.result()
        if dense_flags.any():
            # Rare tick: materialize packed streams' dense rows on the host
            # so the whole batch runs the dense program. add.at (not fancy
            # assignment): the zero-filled slots land harmlessly on index 0.
            idx_st, val_st, dense_ids_st, dense_rows_st = staging
            for i in np.flatnonzero(~dense_flags):
                blocks = np.zeros((self._nblocks + 1, 64), np.int16)
                np.add.at(
                    blocks[: self._nblocks],
                    (np.arange(self._nblocks)[:, None], idx_st[i].astype(np.intp)),
                    val_st[i],
                )
                blocks[dense_ids_st[i]] = dense_rows_st[i]
                row = blocks[: self._nblocks].reshape(-1)
                off = 0
                for b in dense_bufs:
                    size = b[i].size
                    b[i] = row[off : off + size].reshape(b[i].shape)
                    off += size
            return "dense", dense_bufs, seqs
        return "packed", staging, seqs

    def gather(self) -> Tuple[np.ndarray, np.ndarray]:
        """Pull one frame per stream into the current staging buffer."""
        staging = self._staging[self._staging_idx]
        prev = self._staging[self._staging_idx ^ 1]
        self._staging_idx ^= 1
        seqs = np.zeros(self.n, np.int64)
        if self._pool is not None:
            futs = [
                self._pool.submit(self._gather_row, i, staging, prev, seqs)
                for i in range(self.n)
            ]
            for f in futs:
                f.result()
        else:
            self._gather_row(0, staging, prev, seqs)
        return staging, seqs

    def _timed_gather(self):
        t = time.perf_counter()
        pre = self._gather_any()
        return pre, time.perf_counter() - t

    def _gather_any(self):
        """Pull one frame per stream; tagged result for :meth:`tick`'s
        ``pregathered`` argument (prefetch pipelining)."""
        if self._mjpeg_hybrid:
            return self.gather_hybrid()
        staging, seqs = self.gather()
        return ("raw", staging, seqs)

    def tick(
        self,
        rects: Optional[np.ndarray] = None,
        rect_colors: Optional[np.ndarray] = None,
        thickness: int = 2,
        block: bool = False,
        text: Optional[str] = None,
        text_org: Tuple[int, int] = (10, 30),
        text_scale: float = 1.0,
        text_color: Tuple[int, int, int] = (0, 255, 255),
        pregathered=None,
    ) -> TickResult:
        """One batched step. ``block=False`` leaves results as in-flight
        device futures (pipelined dispatch); blocking is only for latency
        measurement / final consumption.

        Overlay params are cached on device by CONTENT — mutate or replace
        the ``rects``/``rect_colors`` arrays freely; a changed value is
        re-uploaded, an unchanged one costs no transfer."""
        if self._device_sim:
            paced = getattr(self._driver, "paced", False)
            if paced:
                # Sensor-timed sequences: wall clock drives seq, so a slow
                # consumer sees gaps (drop semantics preserved on-device).
                seq_now = int((time.monotonic() - self._sim_t0) * self._resolved.fps)
                seqs = np.maximum(self._seqs, seq_now)
                self._seqs_dev = None  # clock jumped: must re-upload
            else:
                seqs = self._seqs.copy()
            if self._seqs_dev is not None and not paced:
                x = self._seqs_dev  # device-resident, fed back from last tick
            else:
                x = jax.numpy.asarray(seqs.astype(np.int32))
                if self._in_sharding is not None:
                    x = jax.device_put(np.asarray(x), self._in_sharding)
            self._seqs = seqs + 1
        elif self._mjpeg_hybrid:
            if pregathered is not None:
                kind, bufs, seqs = pregathered
            else:
                _tg = time.perf_counter()
                kind, bufs, seqs = self.gather_hybrid()
                self._last_gather_s = time.perf_counter() - _tg
            staged = tuple(
                jax.device_put(b, self._in_sharding) if self._in_sharding is not None
                else jax.device_put(b)
                for b in bufs
            )
            x = staged + self._qts
            fn_override = self._fn if kind == "packed" else self._fn_dense
        else:
            if pregathered is not None:
                _kind, staging, seqs = pregathered
            else:
                _tg = time.perf_counter()
                staging, seqs = self.gather()
                self._last_gather_s = time.perf_counter() - _tg
            if self._in_sharding is not None:
                x = jax.device_put(staging, self._in_sharding)
            else:
                x = jax.device_put(staging)

        if self.spec.overlay:
            # Upload overlay params only when they change. Keyed by CONTENT,
            # not id(): CPython recycles ids of same-shape temporaries, so an
            # id key can silently serve stale rects once the caller's array
            # is garbage-collected. The arrays are tiny (n×4 /
            # n×3), so hashing their bytes each tick is noise.
            key = (
                None if rects is None else np.asarray(rects).tobytes(),
                None if rect_colors is None else np.asarray(rect_colors).tobytes(),
                thickness,
            )
            if self._overlay_cache is not None and self._overlay_cache[0] == key:
                r, c, th = self._overlay_cache[1]
            else:
                r = jax.numpy.asarray(
                    rects if rects is not None else np.zeros((self.n, 4), np.int32),
                    jax.numpy.int32,
                )
                c = jax.numpy.asarray(
                    rect_colors if rect_colors is not None else np.zeros((self.n, 3), np.uint8),
                    jax.numpy.uint8,
                )
                th = jax.numpy.int32(thickness)
                self._overlay_cache = (key, (r, c, th))
        else:
            if self._overlay_cache is None or self._overlay_cache[0] != "dummy":
                self._overlay_cache = ("dummy", make_dummy_overlay(self.n))
            r, c, th = self._overlay_cache[1]

        if self._device_sim:
            fn = self._sim_fn
        elif self._mjpeg_hybrid:
            fn = fn_override  # packed program, or dense on fallback ticks
        else:
            fn = self._fn
        out = fn(x, r, c, th)
        if self._device_sim and "_next_seqs" in out:
            self._seqs_dev = out["_next_seqs"]
        if text is not None and "bgr" in out and out["bgr"].ndim == 3:
            out = dict(out)
            out["bgr"] = self._apply_text(out["bgr"], text, text_org, text_scale, text_color)
        if block:
            jax.block_until_ready(out)
        res = TickResult(out, seqs, self._tick_index)
        self._tick_index += 1
        return res

    # ------------------------------------------------------------------

    def run(
        self,
        n_ticks: int,
        *,
        warmup: int = 3,
        measure_latency: bool = True,
        rects: Optional[np.ndarray] = None,
        rect_colors: Optional[np.ndarray] = None,
    ) -> EngineStats:
        """Sustained throughput + latency harness (the analog of the
        reference's criterion bench stats: FPS / P99 / drop rate,
        ``rustcv-camera/benches/capture.rs:140-212``)."""
        stats = EngineStats()
        for _ in range(warmup):
            self.tick(rects=rects, rect_colors=rect_colors, block=True)

        # Per-stream first/last GOOD sequence: a contained stream fault
        # records the sentinel seq=-1, which must not enter the drop math
        # (a first/last-tick fault once corrupted the expected count).
        first_seqs = np.full(self.n, -1, np.int64)
        last_seqs = np.full(self.n, -1, np.int64)
        good_counts = np.zeros(self.n, np.int64)
        lat: List[float] = []
        # Throughput mode on host-staged paths: PREFETCH the next tick's
        # gather on a side thread so host capture/entropy-decode of tick k+1
        # overlaps tick k's H2D upload and device compute (the host-side
        # analog of double-buffered DMA; SURVEY §2.7). Latency mode stays
        # strictly sequential — it measures the full per-tick path.
        prefetch = not measure_latency and not self._device_sim and n_ticks > 0
        if prefetch and getattr(self, "_prefetch_pool", None) is None:
            self._prefetch_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="rustcv-prefetch"
            )
        t0 = time.perf_counter()
        pending = None
        gather_total = 0.0
        gfut = self._prefetch_pool.submit(self._timed_gather) if prefetch else None
        for k in range(n_ticks):
            if measure_latency:
                t_s = time.perf_counter()
                res = self.tick(rects=rects, rect_colors=rect_colors, block=True)
                lat.append((time.perf_counter() - t_s) * 1e3)
            elif prefetch:
                pre, gather_s = gfut.result()
                if k + 1 < n_ticks:
                    gfut = self._prefetch_pool.submit(self._timed_gather)
                res = self.tick(
                    rects=rects, rect_colors=rect_colors, block=False,
                    pregathered=pre,
                )
                self._last_gather_s = gather_s  # prefetched (mostly hidden)
                pending = res
            else:
                res = self.tick(rects=rects, rect_colors=rect_colors, block=False)
                pending = res
            gather_total += getattr(self, "_last_gather_s", 0.0)
            self._last_gather_s = 0.0
            good = res.sequences >= 0
            first_seqs = np.where((first_seqs < 0) & good, res.sequences, first_seqs)
            last_seqs = np.where(good, res.sequences, last_seqs)
            good_counts += good
        if pending is not None:
            # Device programs execute in dispatch order, so waiting on the
            # last tick bounds the whole run.
            jax.block_until_ready(pending.outputs)
        wall = time.perf_counter() - t0

        stats.ticks = n_ticks
        stats.frames = n_ticks * self.n
        stats.wall_s = wall
        stats.host_gather_ms = gather_total * 1e3 / max(1, n_ticks)
        if lat:
            stats.latencies_ms = lat
            stats.p50_latency_ms = float(np.percentile(lat, 50))
            stats.p99_latency_ms = float(np.percentile(lat, 99))
        valid = first_seqs >= 0
        if valid.any():
            expected = (last_seqs[valid] - first_seqs[valid] + 1).sum()
            stats.dropped_frames = int(max(0, expected - good_counts[valid].sum()))
        return stats

    # ------------------------------------------------------------------

    def _apply_text(self, bgr_packed, text, org, scale, color):
        """Text overlay on packed-rows BGR (post-pipeline step).

        ``text`` may be a single string (shared by all streams) or a list of
        N strings (per-stream, e.g. per-camera FPS counters). Glyph masks are
        rasterized on the host per (text, scale) with bucketed canvases →
        stable shapes, pre-expanded ×3 for the packed layout, and cached on
        device; changing strings re-uses the same compiled blend program.
        """
        from ..ops import draw as _draw
        from ..ops import text as _text

        per_stream = isinstance(text, (list, tuple))
        key = (tuple(text) if per_stream else text, float(scale))
        cache = getattr(self, "_text_cache", None)
        if cache is None:
            cache = self._text_cache = {}
        if key not in cache:
            cache.clear()  # keep one live mask set (bounded memory)
            if per_stream:
                if len(text) != self.n:
                    raise ValueError(f"need {self.n} strings, got {len(text)}")
                rendered = [_text.rasterize(t, scale) for t in text]
                mh = max(m.shape[0] for m, _, _ in rendered)
                mw = max(m.shape[1] for m, _, _ in rendered)
                stack = np.zeros((self.n, mh, mw), np.uint8)
                for i, (m, _, _) in enumerate(rendered):
                    stack[i, : m.shape[0], : m.shape[1]] = m
                mask3 = np.repeat(stack, 3, axis=2)
                dx, dy = rendered[0][1], rendered[0][2]
            else:
                mask, dx, dy = _text.rasterize(text, scale)
                mask3 = np.repeat(mask, 3, axis=1)
            cache[key] = (jax.device_put(mask3), dx, dy)
        mask3_dev, dx, dy = cache[key]
        orgs = np.tile(
            np.array([[org[0] + dx, org[1] + dy]], np.int32), (self.n, 1)
        )
        color_dev = jax.numpy.asarray(np.array(color, np.int32))
        if per_stream:
            return _draw.blend_masks_packed_batch(
                bgr_packed, mask3_dev, jax.numpy.asarray(orgs), color_dev
            )
        return _draw.blend_mask_packed_batch(
            bgr_packed, mask3_dev, jax.numpy.asarray(orgs), color_dev
        )

    def encode_payloads(self, res: TickResult) -> List[bytes]:
        """Finish the fused JPEG transcode: one JFIF byte string per stream.

        Requires ``encode_jpeg_quality > 0`` — the tick program already
        produced quantized coefficient rows (enc_y/enc_cb/enc_cr) on the
        device; this fetches them (int16, mostly zeros) and runs the host
        Huffman coder per stream (native.jpeg_entropy_encode)."""
        if not self.spec.encode_jpeg:
            raise CameraError(
                "engine was built without encode_jpeg_quality; no transcode outputs"
            )
        if self.spec.encode_packed and "enc_idx" in res.outputs:
            nd = np.asarray(res.outputs["enc_ndense"])
            if (nd <= self.spec.encode_dense_cap).all():
                return self._encode_from_host_packed(
                    np.asarray(res.outputs["enc_idx"]),
                    np.asarray(res.outputs["enc_val"]),
                    np.asarray(res.outputs["enc_dense_ids"]),
                    np.asarray(res.outputs["enc_dense_rows"]),
                )
            # Over-capacity tick (unusually busy coefficients): the dense
            # grids are still program outputs — fall through and fetch them.
        return self._encode_from_host(
            np.asarray(res.outputs["enc_y"]),
            np.asarray(res.outputs["enc_cb"]),
            np.asarray(res.outputs["enc_cr"]),
        )

    def _enc_geometry(self):
        from ..ops import jpeg_encode as _jenc

        if self.spec.resize_to is not None:
            dw, dh = self.spec.resize_to
        else:
            dw, dh = self.spec.width, self.spec.height
        g = _jenc._geometry(dw, dh, self.spec.encode_subsampling)
        qy, qc = _jenc.quant_tables(self.spec.encode_jpeg)
        return dw, dh, g, qy, qc

    def _encode_pool_map(self, fn) -> List[bytes]:
        # The ctypes coder releases the GIL: parallelize across streams like
        # the hybrid-decode half does (a serial loop scales with n).
        if self.n > 1:
            pool = self._pool
            if pool is None:
                if getattr(self, "_encode_pool", None) is None:
                    self._encode_pool = ThreadPoolExecutor(
                        max_workers=min(8, self.n),
                        thread_name_prefix="rustcv-encode",
                    )
                pool = self._encode_pool
            return list(pool.map(fn, range(self.n)))
        return [fn(0)]

    def _encode_from_host_packed(self, idx, val, dense_ids, dense_rows) -> List[bytes]:
        """Host Huffman coding straight from packed slot/escape rows."""
        from .. import native

        dw, dh, g, qy, qc = self._enc_geometry()

        def _one(i: int) -> bytes:
            return native.jpeg_entropy_encode_packed(
                idx[i], val[i], dense_ids[i], dense_rows[i],
                g["blocks"], [qy, qc, qc], dw, dh, g["h_samp"], g["v_samp"],
            )

        return self._encode_pool_map(_one)

    def _encode_from_host(self, cy, cb, cr) -> List[bytes]:
        """Host Huffman coding of already-fetched dense coefficient rows."""
        from .. import native

        dw, dh, g, qy, qc = self._enc_geometry()

        def _one(i: int) -> bytes:
            comps = [
                arr[i].reshape(*g["blocks"][c], 64)
                for c, arr in enumerate((cy, cb, cr))
            ]
            return native.jpeg_entropy_encode(
                comps, [qy, qc, qc], dw, dh, g["h_samp"], g["v_samp"]
            )

        return self._encode_pool_map(_one)

    def stream_encoded(
        self,
        *,
        depth: int = 2,
        rects: Optional[np.ndarray] = None,
        rect_colors: Optional[np.ndarray] = None,
        thickness: int = 2,
        stop=None,
        max_ticks: Optional[int] = None,
    ):
        """Generator of ``(TickResult, [JFIF bytes per stream])`` — the
        pipelined encoded-delivery hot path (the reference's JPEG-bytes
        fan-out pattern, ``web_streaming.rs:44-100``, with the encoder's
        numeric half fused into the device tick).

        Per iteration: dispatch tick k, start the async D2H of its quantized
        coefficient rows (``copy_to_host_async`` — the transfer rides
        alongside later device compute), and Huffman-code tick k-depth whose
        bytes already landed. Device compute, D2H, and host entropy coding
        of different ticks overlap; payloads are ~50-100× smaller than raw
        BGR, so the host link carries kilobytes, not the frame buffer."""
        if not self.spec.encode_jpeg:
            raise CameraError(
                "engine was built without encode_jpeg_quality; no transcode outputs"
            )
        from collections import deque

        if getattr(self, "_fetch_pool", None) is None:
            self._fetch_pool = ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="rustcv-fetch"
            )
        packed = bool(self.spec.encode_packed)
        # Packed delivery fetches ONE fused byte blob (a single D2H round
        # trip per tick); dense fetches the three coefficient grids.
        keys = ("enc_blob",) if packed else ("enc_y", "enc_cb", "enc_cr")
        inflight = deque()

        def _drain_one():
            res, futs = inflight.popleft()
            vals = [f.result() for f in futs]
            if packed:
                from ..ops.jpeg_encode import split_blob

                nbt = res.outputs["enc_idx"].shape[-2]
                idx, val, ids, rows, nd = split_blob(
                    vals[0], nbt, self.spec.encode_packed,
                    self.spec.encode_dense_cap,
                )
                if (nd <= self.spec.encode_dense_cap).all():
                    return res, self._encode_from_host_packed(idx, val, ids, rows)
                # Over-capacity tick: the dense grids are still device
                # outputs — synchronous fetch, rare by construction.
                return res, self._encode_from_host(
                    np.asarray(res.outputs["enc_y"]),
                    np.asarray(res.outputs["enc_cb"]),
                    np.asarray(res.outputs["enc_cr"]),
                )
            return res, self._encode_from_host(*vals)

        k = 0
        while (max_ticks is None or k < max_ticks) and (
            stop is None or not stop.is_set()
        ):
            res = self.tick(
                rects=rects, rect_colors=rect_colors, thickness=thickness,
                block=False,
            )
            for key in keys:
                try:
                    res.outputs[key].copy_to_host_async()
                except Exception:  # noqa: BLE001 — optional fast path
                    pass
            inflight.append(
                (res, tuple(self._fetch_pool.submit(np.asarray, res.outputs[key])
                            for key in keys))
            )
            if len(inflight) > depth:
                yield _drain_one()
            k += 1
        while inflight:
            yield _drain_one()

    def run_encoded(
        self,
        n_ticks: int,
        *,
        warmup: int = 3,
        rects: Optional[np.ndarray] = None,
        rect_colors: Optional[np.ndarray] = None,
    ) -> Tuple[EngineStats, float]:
        """Sustained encoded-delivery harness: drives :meth:`stream_encoded`
        for ``n_ticks`` and returns ``(EngineStats, payload_mb_per_tick)``
        where fps counts ticks whose JPEG bytes actually LANDED on the host
        (true host-visible delivery, not device dispatch)."""
        for _ in range(warmup):
            self.tick(rects=rects, rect_colors=rect_colors, block=True)
        stats = EngineStats()
        payload_bytes = 0
        t0 = time.perf_counter()
        n_out = 0
        for _res, payloads in self.stream_encoded(
            rects=rects, rect_colors=rect_colors, max_ticks=n_ticks
        ):
            payload_bytes += sum(len(p) for p in payloads)
            n_out += 1
        stats.wall_s = time.perf_counter() - t0
        stats.ticks = n_out
        stats.frames = n_out * self.n
        return stats, payload_bytes / max(1, n_out) / 1e6

    def warm_buckets(self, buckets=None) -> int:
        """Ahead-of-time compile this engine's pipeline for every shape
        bucket (default: runtime.buckets.SHAPE_BUCKETS), so a later
        ``set_resolution`` is a cache swap instead of a recompile — the
        static-shape answer to the reference's hot-reload semantics
        (SURVEY.md §7 hard-part #3). Returns the number compiled."""
        from dataclasses import replace

        from .buckets import SHAPE_BUCKETS, warm

        specs = [
            replace(self.spec, width=w, height=h)
            for (w, h) in (buckets if buckets is not None else SHAPE_BUCKETS)
            if self.spec.pixel_format != PixelFormat.YUYV or w % 2 == 0
        ]
        count = warm(specs, self.n)
        if self._device_sim and self._frame_pool is None:
            # Also compile the COMPOSED device-sim program per bucket (the
            # jit objects are cached in _sim_fn_cache, so a later
            # set_resolution reuses them): one real tick each, synced.
            dummy = make_dummy_overlay(self.n)
            for s in specs:
                fn = self._build_sim_fn(spec=s)
                out = fn(
                    jax.numpy.zeros(self.n, jax.numpy.int32), *dummy
                )
                np.asarray(out["_sync"])
        return count

    def set_resolution(self, width: int, height: int) -> None:
        """Hot-swap all streams to a new resolution (blocking), preserving
        the reference's stop→renegotiate→restart semantics (mod.rs:115-147).
        The pipeline for the new bucket comes from the compile cache."""
        cfg = SimpleConfig(
            width=width, height=height,
            fps=self._resolved.fps, pixel_format=self._resolved.pixel_format,
            buffer_count=self._resolved.buffer_count,
        )
        self._open_all(cfg)
        rc = self._sources[0].resolved_config()
        self._resolved = rc
        pack_k = self.spec.encode_packed
        pack_cap = self.spec.encode_dense_cap
        if pack_k and self.spec.resize_to is None:
            # Pack geometry follows the output dims when there is no resize.
            from ..ops.jpeg_encode import _geometry as _enc_geometry

            nbt = sum(
                bh * bw
                for bh, bw in _enc_geometry(
                    rc.width, rc.height, self.spec.encode_subsampling
                )["blocks"]
            )
            pack_cap = min(nbt, max(128, nbt // 16))
        self.spec = PipelineSpec(
            pixel_format=rc.pixel_format, width=rc.width, height=rc.height,
            resize_to=self.spec.resize_to, filter=self.spec.filter,
            overlay=self.spec.overlay, emit_bgr=self.spec.emit_bgr,
            mjpeg_hybrid=self.spec.mjpeg_hybrid,
            mjpeg_staged_bgr=self.spec.mjpeg_staged_bgr,
            encode_jpeg=self.spec.encode_jpeg,
            encode_subsampling=self.spec.encode_subsampling,
            encode_packed=pack_k,
            encode_dense_cap=pack_cap,
        )
        self._fn = get_pipeline(self.spec)
        # Hybrid coefficient staging is geometry-dependent: rebuild lazily
        # (the fresh spec above is non-packed; _init_hybrid re-derives the
        # packed variant from the new geometry).
        self._coeff_staging = None
        self._packed_staging = None
        self._fn_dense = None
        self._qts = None
        self._overlay_cache = None
        if self._device_sim:
            if self._frame_pool is not None:
                from ..ops import synth as _synth

                self._frame_pool = _synth.synth_raw(
                    jax.numpy.arange(self._frame_pool.shape[0], dtype=jax.numpy.int32),
                    rc.width, rc.height, rc.pixel_format,
                )
            self._sim_fn = self._build_sim_fn()
        elif self._mjpeg_hybrid:
            self._staging = []
        else:
            nbytes = self.spec.raw_bytes()
            self._staging = [np.zeros((self.n, nbytes), np.uint8) for _ in range(2)]

    # ------------------------------------------------------------------

    def export_state(self) -> dict:
        """JSON-serializable snapshot of the engine's configuration and
        stream positions — the pipeline-level analog of the reference's
        ``SystemControl::export_state`` device snapshot (traits.rs:154-158)
        and the nearest thing this domain has to a checkpoint."""
        rc = self._resolved
        return {
            "n_streams": self.n,
            "width": rc.width,
            "height": rc.height,
            "fps": rc.fps,
            "pixel_format": rc.pixel_format.value,
            "buffer_count": rc.buffer_count,
            "filter": self.spec.filter,
            "resize_to": list(self.spec.resize_to) if self.spec.resize_to else None,
            "overlay": self.spec.overlay,
            "device_sim": self._device_sim,
            "sequences": [int(s) for s in self._seqs],
            "tick_index": self._tick_index,
        }

    @classmethod
    def from_state(cls, state: dict, driver=None, mesh=None) -> "MultiStreamEngine":
        """Rebuild an engine from :meth:`export_state` (stream clocks resume
        from the recorded sequence positions)."""
        from ..capture import SimulationDriver
        from ..core.pixel_format import PixelFormat as PF

        if driver is None:
            driver = SimulationDriver(device_count=state["n_streams"], paced=False)
        eng = cls(
            driver, state["n_streams"],
            SimpleConfig(
                width=state["width"], height=state["height"], fps=state["fps"],
                pixel_format=PF(state["pixel_format"]),
                buffer_count=state["buffer_count"],
            ),
            filter=state["filter"],
            resize_to=tuple(state["resize_to"]) if state["resize_to"] else None,
            overlay=state["overlay"],
            device_sim=state["device_sim"],
            mesh=mesh,
        )
        eng._seqs = np.array(state["sequences"], np.int64)
        eng._seqs_dev = None
        eng._tick_index = state["tick_index"]
        return eng

    def close(self) -> None:
        for s in self._sources:
            s.stop()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        if getattr(self, "_prefetch_pool", None) is not None:
            self._prefetch_pool.shutdown(wait=False)
            self._prefetch_pool = None
        if getattr(self, "_encode_pool", None) is not None:
            self._encode_pool.shutdown(wait=False)
            self._encode_pool = None
        if getattr(self, "_fetch_pool", None) is not None:
            self._fetch_pool.shutdown(wait=False)
            self._fetch_pool = None

    def __enter__(self) -> "MultiStreamEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
