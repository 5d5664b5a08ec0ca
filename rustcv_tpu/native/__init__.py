"""Native (C++) host capture layer — build + ctypes bindings.

The reference's runtime around the compute path is native (Rust drivers +
an ObjC bridge); ours is C++: ``capture.cpp`` provides the threaded frame
ring (V4L2 mmap-ring/DQBUF analog), the synthetic sensor, and the per-pixel
conversion hot loops for the host path.

Built on demand with g++ (no pybind11 in this environment — plain C ABI via
ctypes). If the toolchain is unavailable the package degrades gracefully:
``available()`` returns False and pure-NumPy paths are used instead.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [
    os.path.join(_HERE, "capture.cpp"),
    os.path.join(_HERE, "jpeg_entropy.cpp"),
    os.path.join(_HERE, "jpeg_encode.cpp"),
    os.path.join(_HERE, "jpeg_host.cpp"),
    os.path.join(_HERE, "v4l2.cpp"),
    os.path.join(_HERE, "maxflow.cpp"),
    os.path.join(_HERE, "unionfind.cpp"),
    os.path.join(_HERE, "mser.cpp"),
]
_SRC = _SRCS[0]
_SO = os.path.join(_HERE, "librustcv_capture.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _build() -> Optional[str]:
    """Compile the shared library; returns an error string or None.

    First attempt links libjpeg-turbo (the fast host MJPEG path); if the
    header/library is absent the build retries without it and
    ``rcv_jpeg_host_available()`` reports 0 (PIL fallback)."""
    base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", "-o", _SO, *_SRCS]
    attempts = [base[:1] + ["-DRCV_HAVE_LIBJPEG"] + base[1:] + ["-ljpeg"], base]
    err = None
    for cmd in attempts:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"g++ invocation failed: {e}"
        if proc.returncode == 0:
            return None
        err = f"g++ failed: {proc.stderr[:2000]}"
    return err


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rcv_synth_bgr.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_long]
    lib.rcv_synth_yuyv.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_long]
    lib.rcv_encode_yuyv.argtypes = [u8p, u8p, ctypes.c_int, ctypes.c_int]
    lib.rcv_yuyv_to_bgr.argtypes = [u8p, u8p, ctypes.c_int, ctypes.c_int]
    lib.rcv_bgra_to_bgr.argtypes = [u8p, u8p, ctypes.c_long]
    lib.rcv_rgb_to_bgr.argtypes = [u8p, u8p, ctypes.c_long]
    lib.rcv_ring_create.restype = ctypes.c_void_p
    lib.rcv_ring_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.rcv_ring_start.argtypes = [ctypes.c_void_p, ctypes.c_double, ctypes.c_int]
    lib.rcv_ring_stop.argtypes = [ctypes.c_void_p]
    lib.rcv_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.rcv_ring_dequeue.restype = ctypes.c_long
    lib.rcv_ring_dequeue.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(u8p),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ctypes.c_long,
    ]
    lib.rcv_ring_requeue.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.rcv_ring_dropped.restype = ctypes.c_long
    lib.rcv_ring_dropped.argtypes = [ctypes.c_void_p]
    lib.rcv_ring_slot_bytes.restype = ctypes.c_long
    lib.rcv_ring_slot_bytes.argtypes = [ctypes.c_void_p]
    u8cp = ctypes.POINTER(ctypes.c_uint8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    intp = ctypes.POINTER(ctypes.c_int)
    lib.rcv_jpeg_info.restype = ctypes.c_int
    lib.rcv_jpeg_info.argtypes = [u8cp, ctypes.c_long, intp, intp, intp, intp, intp, intp, intp]
    lib.rcv_jpeg_coeffs.restype = ctypes.c_int
    lib.rcv_jpeg_coeffs.argtypes = [
        u8cp, ctypes.c_long, i16p, i16p, i16p, u16p, u16p, u16p,
    ]
    i32p = ctypes.POINTER(ctypes.c_int32)
    longp = ctypes.POINTER(ctypes.c_long)
    lib.rcv_jpeg_coeffs_packed.restype = ctypes.c_int
    lib.rcv_jpeg_coeffs_packed.argtypes = [
        u8cp, ctypes.c_long, i32p, i16p, ctypes.c_long, u16p, u16p, u16p, longp,
    ]
    lib.rcv_jpeg_coeffs_blockpacked.restype = ctypes.c_int
    lib.rcv_jpeg_coeffs_blockpacked.argtypes = [
        u8cp, ctypes.c_long, u8cp, i16p, ctypes.c_int, i32p, i16p,
        ctypes.c_long, u16p, u16p, u16p, longp,
    ]
    lib.rcv_jpeg_host_available.restype = ctypes.c_int
    lib.rcv_jpeg_host_available.argtypes = []
    lib.rcv_jpeg_entropy_encode.restype = ctypes.c_long
    lib.rcv_jpeg_entropy_encode.argtypes = [
        i16p, i16p, i16p, ctypes.c_int, intp, intp, intp, intp,
        ctypes.c_int, ctypes.c_int, u16p, u16p, u8cp, ctypes.c_long,
    ]
    lib.rcv_jpeg_entropy_encode_packed.restype = ctypes.c_long
    lib.rcv_jpeg_entropy_encode_packed.argtypes = [
        u8cp, i16p, ctypes.c_int, i32p, i16p, ctypes.c_int,
        ctypes.c_int, intp, intp, intp, intp,
        ctypes.c_int, ctypes.c_int, u16p, u16p, u8cp, ctypes.c_long,
    ]
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.rcv_v4l2_available.restype = ctypes.c_int
    lib.rcv_v4l2_open.restype = ctypes.c_void_p
    lib.rcv_v4l2_open.argtypes = [ctypes.c_char_p, intp]
    lib.rcv_v4l2_enum_modes.restype = ctypes.c_long
    lib.rcv_v4l2_enum_modes.argtypes = [
        ctypes.c_void_p, u32p, intp, intp, intp, ctypes.c_long,
    ]
    lib.rcv_v4l2_setup.restype = ctypes.c_int
    lib.rcv_v4l2_setup.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, u32p, intp, intp, intp, longp,
    ]
    lib.rcv_v4l2_dequeue.restype = ctypes.c_long
    lib.rcv_v4l2_dequeue.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(u8p), longp, longp, longp,
    ]
    lib.rcv_v4l2_set_ctrl.restype = ctypes.c_int
    lib.rcv_v4l2_set_ctrl.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int32]
    lib.rcv_v4l2_get_ctrl.restype = ctypes.c_int
    lib.rcv_v4l2_get_ctrl.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.rcv_v4l2_restart.restype = ctypes.c_int
    lib.rcv_v4l2_restart.argtypes = [ctypes.c_void_p]
    lib.rcv_v4l2_stop.restype = ctypes.c_int
    lib.rcv_v4l2_stop.argtypes = [ctypes.c_void_p]
    lib.rcv_v4l2_close.argtypes = [ctypes.c_void_p]
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.rcv_maxflow_grid.restype = ctypes.c_int64
    lib.rcv_maxflow_grid.argtypes = [
        ctypes.c_int32, ctypes.c_int32, i64p, i64p, i64p, i64p, i64p, i64p,
        u8cp,
    ]
    lib.rcv_jpeg_decode_pitched.restype = ctypes.c_int
    lib.rcv_jpeg_decode_pitched.argtypes = [
        u8cp, ctypes.c_long, u8cp, ctypes.c_long, ctypes.c_long,
        ctypes.c_int, intp, intp,
    ]
    lib.rcv_union_find.restype = ctypes.c_long
    lib.rcv_union_find.argtypes = [
        i32p, ctypes.c_long, i32p, i32p, ctypes.c_long,
    ]
    lib.rcv_ccl_label8.restype = ctypes.c_long
    lib.rcv_ccl_label8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.rcv_ccl_label.restype = ctypes.c_long
    lib.rcv_ccl_label.argtypes = [
        u8cp, ctypes.c_long, ctypes.c_long, i32p,
    ]
    lib.rcv_mser.restype = ctypes.c_long
    lib.rcv_mser.argtypes = [
        u8cp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, i32p, ctypes.c_long,
    ]


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it on first use. None if unavailable."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        if not os.path.exists(_SO) or any(
            os.path.getmtime(_SO) < os.path.getmtime(s) for s in _SRCS
        ):
            err = _build()
            if err is not None:
                _build_error = err
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            # A library built on another machine (copied checkout) can link
            # against shared objects this one lacks: rebuild here once.
            err = _build()
            if err is not None:
                _build_error = err
                return None
            try:
                lib = ctypes.CDLL(_SO)
            except OSError as e:
                _build_error = str(e)
                return None
        _bind(lib)
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> Optional[str]:
    get_lib()
    return _build_error


# ---------------------------------------------------------------------------
# NumPy-friendly wrappers
# ---------------------------------------------------------------------------



def _as_u8_buf(data: "np.ndarray | bytes") -> np.ndarray:
    """Flat uint8 view of frame bytes — zero-copy for the common case (a
    contiguous uint8 ndarray, e.g. a ring/mmap view on the per-tick hot
    path); only non-array or non-contiguous inputs are copied."""
    if isinstance(data, np.ndarray):
        if data.dtype == np.uint8 and data.flags.c_contiguous:
            return data.reshape(-1)
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    return np.frombuffer(bytes(data), np.uint8)


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def synth_bgr(w: int, h: int, seq: int) -> np.ndarray:
    lib = get_lib()
    out = np.empty((h, w, 3), np.uint8)
    lib.rcv_synth_bgr(_u8p(out), w, h, seq)
    return out


def synth_yuyv(w: int, h: int, seq: int) -> np.ndarray:
    lib = get_lib()
    out = np.empty(h * w * 2, np.uint8)
    lib.rcv_synth_yuyv(_u8p(out), w, h, seq)
    return out


def yuyv_to_bgr(src: np.ndarray, w: int, h: int) -> np.ndarray:
    lib = get_lib()
    src = np.ascontiguousarray(src.reshape(-1))
    out = np.empty((h, w, 3), np.uint8)
    lib.rcv_yuyv_to_bgr(_u8p(src), _u8p(out), w, h)
    return out


def jpeg_host_available() -> bool:
    """True when the fast libjpeg-turbo host decode was compiled in."""
    lib = get_lib()
    return bool(lib is not None and lib.rcv_jpeg_host_available())


def jpeg_decode_pitched(
    data: "np.ndarray | bytes",
    out: np.ndarray,
    *,
    bgr: bool = True,
) -> tuple:
    """Decode a JPEG directly into the pitched buffer ``out`` (2-D uint8,
    one scanline per row, pitch = out.strides[0] — must be C-contiguous
    rows). Returns (width, height). This is the reference's
    decompress-into-Mat-with-pitch hot path (decode.rs:92-123): zero
    intermediate copies, SIMD scanline decode, BGR (or RGB) order emitted
    by the decoder itself.
    """
    lib = get_lib()
    if lib is None or not lib.rcv_jpeg_host_available():
        raise RuntimeError("native libjpeg host decode unavailable")
    if out.dtype != np.uint8 or out.ndim != 2 or out.strides[1] != 1:
        raise ValueError("out must be a 2-D uint8 row-contiguous buffer")
    buf = _as_u8_buf(data)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.rcv_jpeg_decode_pitched(
        _u8p(buf), buf.size, _u8p(out), out.strides[0], out.shape[0],
        1 if bgr else 0, ctypes.byref(w), ctypes.byref(h),
    )
    if rc == -4:
        raise ValueError(
            f"JPEG geometry {w.value}x{h.value} exceeds staging "
            f"({out.shape[0]} rows × pitch {out.strides[0]})"
        )
    if rc != 0:
        raise ValueError(f"JPEG decode failed (rc={rc})")
    return w.value, h.value


def jpeg_entropy_decode(data: "np.ndarray | bytes"):
    """Baseline-JPEG entropy decode → coefficient grids + quant tables.

    Returns ``(info, coeffs, qtables)`` where info is a dict with
    width/height/ncomp/h_samp/v_samp, ``coeffs[c]`` is int16
    (bh, bw, 8, 8) in natural order (full padded MCU grid), ``qtables[c]``
    is uint16 (8, 8). Raises ValueError for non-baseline streams.
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    buf = _as_u8_buf(data)
    w = ctypes.c_int()
    h = ctypes.c_int()
    nc = ctypes.c_int()
    hs = (ctypes.c_int * 3)()
    vs = (ctypes.c_int * 3)()
    bw = (ctypes.c_int * 3)()
    bh = (ctypes.c_int * 3)()
    rc = lib.rcv_jpeg_info(
        _u8p(buf), buf.size, ctypes.byref(w), ctypes.byref(h), ctypes.byref(nc),
        hs, vs, bw, bh,
    )
    if rc != 0:
        raise ValueError(f"unsupported or corrupt JPEG (rcv_jpeg_info rc={rc})")
    ncomp = nc.value
    coeffs = []
    qts = []
    outs = []
    qs = []
    for c in range(3):
        if c < ncomp:
            arr = np.zeros((bh[c], bw[c], 64), np.int16)
            q = np.zeros(64, np.uint16)
        else:
            arr = np.zeros((1, 1, 64), np.int16)
            q = np.zeros(64, np.uint16)
        outs.append(arr)
        qs.append(q)
    rc = lib.rcv_jpeg_coeffs(
        _u8p(buf), buf.size,
        outs[0].ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        outs[1].ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        outs[2].ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        qs[0].ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        qs[1].ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        qs[2].ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
    )
    if rc != 0:
        raise ValueError(f"JPEG entropy decode failed (rc={rc})")
    for c in range(ncomp):
        coeffs.append(outs[c].reshape(outs[c].shape[0], outs[c].shape[1], 8, 8))
        qts.append(qs[c].reshape(8, 8))
    info = {
        "width": w.value, "height": h.value, "ncomp": ncomp,
        "h_samp": [hs[c] for c in range(ncomp)],
        "v_samp": [vs[c] for c in range(ncomp)],
    }
    return info, coeffs, qts


def jpeg_entropy_info(data: "np.ndarray | bytes") -> dict:
    """Header-only parse: geometry + per-component padded block grids."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    buf = _as_u8_buf(data)
    w = ctypes.c_int(); h = ctypes.c_int(); nc = ctypes.c_int()  # noqa: E702
    hs = (ctypes.c_int * 3)(); vs = (ctypes.c_int * 3)()  # noqa: E702
    bw = (ctypes.c_int * 3)(); bh = (ctypes.c_int * 3)()  # noqa: E702
    rc = lib.rcv_jpeg_info(
        _u8p(buf), buf.size, ctypes.byref(w), ctypes.byref(h), ctypes.byref(nc),
        hs, vs, bw, bh,
    )
    if rc != 0:
        raise ValueError(f"unsupported or corrupt JPEG (rcv_jpeg_info rc={rc})")
    n = nc.value
    return {
        "width": w.value, "height": h.value, "ncomp": n,
        "h_samp": [hs[c] for c in range(n)], "v_samp": [vs[c] for c in range(n)],
        "blocks": [(bh[c], bw[c]) for c in range(n)],
    }


def jpeg_entropy_decode_packed(data: "np.ndarray | bytes", capacity: int):
    """Entropy decode to PACKED nonzero coefficients.

    Returns ``(info, pos, val, nnz, qts)`` where ``pos`` (int32) / ``val``
    (int16) are length-``capacity`` buffers whose first ``nnz`` entries are
    the nonzero coefficients as flat indices into the concatenated dense
    per-component layout (scatter-adding val into zeros reproduces
    :func:`jpeg_entropy_decode`'s grids exactly); entries past ``nnz`` are
    zero-filled (safe to scatter-add as-is). Returns ``None`` if the frame
    has more than ``capacity`` nonzeros (caller falls back to dense).
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    info = jpeg_entropy_info(data)
    buf = _as_u8_buf(data)
    pos = np.zeros(capacity, np.int32)
    val = np.zeros(capacity, np.int16)
    qs = [np.zeros(64, np.uint16) for _ in range(3)]
    nnz = ctypes.c_long()
    rc = lib.rcv_jpeg_coeffs_packed(
        _u8p(buf), buf.size,
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        val.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        capacity,
        qs[0].ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        qs[1].ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        qs[2].ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.byref(nnz),
    )
    if rc == -24:
        return None  # over capacity — dense fallback
    if rc != 0:
        raise ValueError(f"JPEG packed entropy decode failed (rc={rc})")
    qts = [qs[c].reshape(8, 8) for c in range(info["ncomp"])]
    return info, pos, val, int(nnz.value), qts


def jpeg_entropy_decode_blockpacked(
    data: "np.ndarray | bytes",
    k: int,
    dense_cap: int,
    out_idx: "np.ndarray | None" = None,
    out_val: "np.ndarray | None" = None,
    out_dense_ids: "np.ndarray | None" = None,
    out_dense_rows: "np.ndarray | None" = None,
):
    """Entropy decode to BLOCK-PACKED coefficients.

    Layout: ``idx``/``val`` are ``[total_blocks, k]`` (uint8 natural coeff
    index / int16 value; unused slots zero-filled) over the concatenated
    per-component block grid. Blocks with more than ``k`` nonzeros take the
    DENSE-ROW escape: ``dense_ids`` (int32 global block id) + ``dense_rows``
    (int16 [dense_cap, 64], the full block). Entries past ``dense_n`` are
    padded with id = total_blocks (a scratch row the device unpack drops)
    and zero rows, so the arrays are scatter-safe as-is.

    ``out_*`` buffers may be supplied to avoid per-frame allocation.

    Returns ``(info, idx, val, dense_ids, dense_rows, dense_n, qts)`` or
    ``None`` if the busy blocks exceed ``dense_cap`` (caller falls back to
    the fully dense path).
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    info = jpeg_entropy_info(data)
    nblocks = sum(bh * bw for bh, bw in info["blocks"])
    buf = _as_u8_buf(data)
    idx = out_idx if out_idx is not None else np.zeros((nblocks, k), np.uint8)
    val = out_val if out_val is not None else np.zeros((nblocks, k), np.int16)
    dense_ids = (
        out_dense_ids if out_dense_ids is not None else np.zeros(dense_cap, np.int32)
    )
    dense_rows = (
        out_dense_rows
        if out_dense_rows is not None
        else np.zeros((dense_cap, 64), np.int16)
    )
    if idx.shape != (nblocks, k) or val.shape != (nblocks, k):
        # ValueError (not assert): callers map this into the DecodeError
        # taxonomy so a mid-stream geometry/subsampling change is a
        # contained per-stream fault, not a batch-killing AssertionError.
        raise ValueError(
            f"staging shape {idx.shape} != frame block grid ({nblocks}, {k}) "
            "(geometry or subsampling changed mid-stream)"
        )
    qs = [np.zeros(64, np.uint16) for _ in range(3)]
    dense_n = ctypes.c_long()
    rc = lib.rcv_jpeg_coeffs_blockpacked(
        _u8p(buf), buf.size,
        _u8p(idx),
        val.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        k,
        dense_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dense_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        dense_cap,
        qs[0].ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        qs[1].ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        qs[2].ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.byref(dense_n),
    )
    if rc == -24:
        return None  # busy blocks over capacity — dense fallback
    if rc != 0:
        raise ValueError(f"JPEG blockpacked entropy decode failed (rc={rc})")
    n = int(dense_n.value)
    dense_ids[n:] = nblocks  # scratch-row sentinel (buffers reused across ticks)
    dense_rows[n:] = 0
    qts = [qs[c].reshape(8, 8) for c in range(info["ncomp"])]
    return info, idx, val, dense_ids, dense_rows, n, qts


def jpeg_entropy_encode(
    coeffs: list,
    qts: list,
    width: int,
    height: int,
    h_samp: list,
    v_samp: list,
) -> bytes:
    """Baseline-JPEG entropy encode: quantized coefficient grids → JFIF bytes.

    The host half of the device encode path (mirror of
    :func:`jpeg_entropy_decode`): ``coeffs[c]`` is int16 ``[bh, bw, 64]``
    (or ``[bh, bw, 8, 8]``) in natural order over the full padded MCU grid,
    ``qts[c]`` the natural-order quant table (uint16, 64 entries; component
    0 = luma table, components 1-2 share the chroma table). Standard
    Annex-K Huffman tables, single interleaved scan.
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    ncomp = len(coeffs)
    if ncomp not in (1, 3):
        raise ValueError(f"ncomp must be 1 or 3, got {ncomp}")
    arrs = []
    bws = (ctypes.c_int * 3)()
    bhs = (ctypes.c_int * 3)()
    hs = (ctypes.c_int * 3)()
    vs = (ctypes.c_int * 3)()
    total_blocks = 0
    for c in range(ncomp):
        a = np.ascontiguousarray(coeffs[c], np.int16).reshape(
            coeffs[c].shape[0], coeffs[c].shape[1], 64
        )
        arrs.append(a)
        bhs[c], bws[c] = a.shape[0], a.shape[1]
        hs[c], vs[c] = h_samp[c], v_samp[c]
        total_blocks += a.shape[0] * a.shape[1]
    while len(arrs) < 3:
        arrs.append(np.zeros((1, 1, 64), np.int16))
    q0 = np.ascontiguousarray(qts[0], np.uint16).reshape(64)
    q1 = (
        np.ascontiguousarray(qts[1], np.uint16).reshape(64)
        if ncomp == 3
        else q0
    )
    # TRUE worst case per coefficient: 16-bit symbol code + 10 magnitude
    # bits = 26 bits, doubled by 0xFF byte stuffing in the worst pattern
    # → 6.5 B; use 8 B/coeff + headers (dense max-magnitude grids are
    # in-contract and must not overflow — regression-tested).
    cap = 4096 + total_blocks * 64 * 8
    out = np.empty(cap, np.uint8)
    i16 = ctypes.POINTER(ctypes.c_int16)
    u16 = ctypes.POINTER(ctypes.c_uint16)
    n = lib.rcv_jpeg_entropy_encode(
        arrs[0].ctypes.data_as(i16),
        arrs[1].ctypes.data_as(i16),
        arrs[2].ctypes.data_as(i16),
        ncomp, bws, bhs, hs, vs, width, height,
        q0.ctypes.data_as(u16), q1.ctypes.data_as(u16),
        _u8p(out), cap,
    )
    if n < 0:
        raise ValueError(f"JPEG entropy encode failed (rc={n})")
    return out[:n].tobytes()


def jpeg_entropy_encode_packed(
    idx: "np.ndarray",
    val: "np.ndarray",
    dense_ids: "np.ndarray",
    dense_rows: "np.ndarray",
    blocks: list,
    qts: list,
    width: int,
    height: int,
    h_samp: list,
    v_samp: list,
) -> bytes:
    """Entropy-encode from BLOCK-PACKED coefficients (the device-side
    :func:`rustcv_tpu.ops.jpeg_encode.pack_coeff_rows` layout): ``idx``/
    ``val`` are [nbt, K] u8/i16 over the component-concatenated block axis,
    ``dense_ids``/[dcap] i32 (sentinel ≥ nbt unused) + ``dense_rows``
    [dcap, 64] i16 the busy-block escape. ``blocks`` = per-component
    (bh, bw). Bytes are identical to :func:`jpeg_entropy_encode` on the
    equivalent dense grids (parity-tested)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    ncomp = len(blocks)
    if ncomp not in (1, 3):
        raise ValueError(f"ncomp must be 1 or 3, got {ncomp}")
    idx = np.ascontiguousarray(idx, np.uint8)
    val = np.ascontiguousarray(val, np.int16)
    dense_ids = np.ascontiguousarray(dense_ids, np.int32)
    dense_rows = np.ascontiguousarray(dense_rows, np.int16).reshape(-1, 64)
    if idx.shape != val.shape or idx.ndim != 2:
        raise ValueError(f"idx/val shape mismatch: {idx.shape} vs {val.shape}")
    k = idx.shape[1]
    nbt = sum(bh * bw for bh, bw in blocks)
    if idx.shape[0] != nbt:
        raise ValueError(f"idx rows {idx.shape[0]} != total blocks {nbt}")
    bws = (ctypes.c_int * 3)()
    bhs = (ctypes.c_int * 3)()
    hs = (ctypes.c_int * 3)()
    vs = (ctypes.c_int * 3)()
    for c in range(ncomp):
        bhs[c], bws[c] = blocks[c]
        hs[c], vs[c] = h_samp[c], v_samp[c]
    q0 = np.ascontiguousarray(qts[0], np.uint16).reshape(64)
    q1 = (
        np.ascontiguousarray(qts[1], np.uint16).reshape(64)
        if ncomp == 3 else q0
    )
    cap = 4096 + nbt * 64 * 8
    out = np.empty(cap, np.uint8)
    i16 = ctypes.POINTER(ctypes.c_int16)
    u16 = ctypes.POINTER(ctypes.c_uint16)
    i32 = ctypes.POINTER(ctypes.c_int32)
    n = lib.rcv_jpeg_entropy_encode_packed(
        _u8p(idx), val.ctypes.data_as(i16), k,
        dense_ids.ctypes.data_as(i32), dense_rows.ctypes.data_as(i16),
        int(dense_ids.shape[0]),
        ncomp, bws, bhs, hs, vs, width, height,
        q0.ctypes.data_as(u16), q1.ctypes.data_as(u16),
        _u8p(out), cap,
    )
    if n < 0:
        raise ValueError(f"JPEG packed entropy encode failed (rc={n})")
    return out[:n].tobytes()


def ccl_label(mask: "np.ndarray", connectivity: int = 4) -> tuple:
    """Two-pass union-find connected components (4- or 8-connectivity)
    over a u8 mask: returns ``(count, labels int32 (H, W))``, components
    numbered 1..count by raster-first pixel, background 0. GIL released."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    m = np.ascontiguousarray(mask, np.uint8)
    if m.ndim != 2:
        raise ValueError(f"ccl_label: 2-D mask required, got {m.shape}")
    labels = np.empty(m.shape, np.int32)
    i32 = ctypes.POINTER(ctypes.c_int32)
    fn = lib.rcv_ccl_label8 if connectivity == 8 else lib.rcv_ccl_label
    n = fn(_u8p(m), m.shape[0], m.shape[1], labels.ctypes.data_as(i32))
    if n < 0:
        raise ValueError(f"ccl_label failed (rc={n})")
    return int(n), labels


def union_find(n: int, edges_a: "np.ndarray", edges_b: "np.ndarray") -> tuple:
    """Min-root union-find over ``n`` nodes with undirected edges
    ``(edges_a[i], edges_b[i])``. Returns ``(count, root)`` where
    ``root[i]`` is the SMALLEST node id in i's component (so components
    number naturally in raster order when node ids are raster-ordered).
    The C pass releases the GIL and runs in O(m α(n))."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    ea = np.ascontiguousarray(edges_a, np.int32)
    eb = np.ascontiguousarray(edges_b, np.int32)
    if ea.shape != eb.shape or ea.ndim != 1:
        raise ValueError(f"edge arrays must be 1-D and equal: {ea.shape} vs {eb.shape}")
    parent = np.empty(int(n), np.int32)
    i32 = ctypes.POINTER(ctypes.c_int32)
    cnt = lib.rcv_union_find(
        parent.ctypes.data_as(i32), int(n),
        ea.ctypes.data_as(i32), eb.ctypes.data_as(i32), int(ea.shape[0]),
    )
    if cnt < 0:
        raise ValueError(f"union_find failed (rc={cnt}; edge id out of range?)")
    return int(cnt), parent


def mser_triples(gray: "np.ndarray", delta: int, min_area: int,
                 max_area: int, max_variation: float,
                 min_diversity: float) -> "np.ndarray | None":
    """MSER (seed, level, area) triples — bit-identical to the frozen
    Python spec (ops/mser.py; tests pin it). Returns int32 (N, 3) sorted
    by (seed, level), or None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    g = np.ascontiguousarray(gray, np.uint8)
    if g.ndim != 2:
        raise ValueError(f"mser_triples: 2-D gray required, got {g.shape}")
    i32 = ctypes.POINTER(ctypes.c_int32)
    cap = 4096
    while True:
        out = np.empty((cap, 3), np.int32)
        cnt = lib.rcv_mser(
            _u8p(g), g.shape[0], g.shape[1], int(delta), int(min_area),
            int(max_area), float(max_variation), float(min_diversity),
            out.ctypes.data_as(i32), cap,
        )
        if cnt < 0:
            raise ValueError(f"rcv_mser failed (rc={cnt})")
        if cnt <= cap:
            return out[:cnt].copy()
        cap = int(cnt)


class NativeRing:
    """Threaded producer ring: the native capture front-end.

    The producer thread synthesizes YUYV frames at sensor rate into ring
    slots; :meth:`dequeue` blocks like DQBUF and returns a zero-copy view.
    Hold at most ``slots-1`` frames; requeue via :meth:`requeue` (the Frame
    invalidation contract is enforced one level up, in the Python source).
    """

    def __init__(self, slots: int, width: int, height: int):
        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError(f"native library unavailable: {_build_error}")
        self._ring = self._lib.rcv_ring_create(slots, width, height)
        self.width = width
        self.height = height
        self.slot_bytes = self._lib.rcv_ring_slot_bytes(self._ring)

    def start(self, fps: float, paced: bool = True) -> None:
        self._lib.rcv_ring_start(self._ring, float(fps), 1 if paced else 0)

    def stop(self) -> None:
        self._lib.rcv_ring_stop(self._ring)

    def dequeue(self, timeout_ms: int = 2000):
        """→ (slot, data_view, seq, ts_ns) or None on timeout."""
        data = ctypes.POINTER(ctypes.c_uint8)()
        seq = ctypes.c_long()
        ts = ctypes.c_long()
        slot = self._lib.rcv_ring_dequeue(
            self._ring, ctypes.byref(data), ctypes.byref(seq), ctypes.byref(ts),
            timeout_ms,
        )
        if slot < 0:
            return None
        view = np.ctypeslib.as_array(data, shape=(self.slot_bytes,))
        return int(slot), view, int(seq.value), int(ts.value)

    def requeue(self, slot: int) -> None:
        self._lib.rcv_ring_requeue(self._ring, slot)

    @property
    def dropped(self) -> int:
        return int(self._lib.rcv_ring_dropped(self._ring))

    def close(self) -> None:
        if self._ring:
            self._lib.rcv_ring_destroy(self._ring)
            self._ring = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
