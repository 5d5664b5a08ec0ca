"""MOSSE correlation-filter tracking (OpenCV ``legacy::TrackerMOSSE``
role, Bolme et al. 2010 — the reference has no tracker; OpenCV-parity
addition like MOG2/Kalman, spec frozen in :mod:`rustcv_tpu.ops.golden`).

device-first design:

- The whole tracking step is ONE jitted program (:func:`step`): clamped
  ``dynamic_slice`` crop → preprocess → rfft2 → correlate with the
  filter → peak + PSR → re-crop at the new centre → blended filter
  update, all gated on the PSR threshold with ``jnp.where`` (no
  data-dependent Python control flow). State (A, B, centre) stays
  device-resident between frames — per-frame host traffic is one scalar
  fetch (psr + centre), the same device-resident-state pattern as the
  engine's stream clock.
- :func:`init` trains over the 8 fixed perturbation warps of
  ``golden.MOSSE_WARPS`` as one fused program (the warps batch on a
  leading axis; the bilinear resample is four static-offset lerps, not a
  gather — all warps share the sampling grid shape).
- Banks of trackers vmap: both :func:`init` and :func:`step` are pure
  functional cores over a ``MosseState`` pytree, so ``jax.vmap`` tracks N
  same-window-size objects in two dispatches (the Kalman bank precedent).

Tolerance contract: device math is float32 (rfft2) vs the float64 golden;
tests bound the response/PSR at rtol 1e-3 and require the integer peak
trajectory to match the golden run exactly on well-posed scenes
(tests/test_tracker.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from . import golden

__all__ = ["MosseState", "init", "step", "TrackerMOSSE"]


class MosseState(NamedTuple):
    """Device-resident tracker state (a pytree; vmap-able on a leading
    bank axis)."""

    a_re: jax.Array     # float32 [h, w] filter numerator (matmul-DFT
    a_im: jax.Array     # float32 [h, w]  planes, ops/transform)
    b: jax.Array        # float32 [h, w] filter denominator
    g_re: jax.Array     # float32 [h, w] desired-response spectrum
    g_im: jax.Array     # float32 [h, w]
    center: jax.Array   # int32 [2] (cy, cx)


def _hann(h: int, w: int) -> jnp.ndarray:
    def hann1(n):
        if n == 1:
            return jnp.ones(1, jnp.float32)
        k = jnp.arange(n, dtype=jnp.float32)
        return 0.5 - 0.5 * jnp.cos(2.0 * jnp.pi * k / (n - 1))
    return jnp.outer(hann1(h), hann1(w))


def _preprocess(patch: jax.Array) -> jax.Array:
    p = jnp.log1p(patch.astype(jnp.float32))
    p = (p - p.mean()) / (p.std() + golden.MOSSE_EPS)
    return p * _hann(*p.shape)


def _crop(frame: jax.Array, cy, cx, h: int, w: int):
    """Clamped h×w dynamic_slice centred at traced (cy, cx)."""
    fh, fw = frame.shape
    oy = jnp.clip(cy - h // 2, 0, fh - h)
    ox = jnp.clip(cx - w // 2, 0, fw - w)
    return jax.lax.dynamic_slice(frame, (oy, ox), (h, w)), oy, ox


@partial(jax.jit, static_argnames=("h", "w"))
def _init_core(frame: jax.Array, cy, cx, h: int, w: int) -> MosseState:
    f = frame.astype(jnp.float32)
    patch, _, _ = _crop(f, cy, cx, h, w)

    # all 8 perturbation warps share one sampling-grid formulation:
    # four static-offset bilinear lerps over clamped integer coords
    # (the LK "shared fractional offset" lesson — no per-pixel gather
    # tables, just index arithmetic XLA lowers to dynamic slices).
    angs = jnp.array([a for a, _ in golden.MOSSE_WARPS], jnp.float32)
    scs = jnp.array([s for _, s in golden.MOSSE_WARPS], jnp.float32)
    c = jnp.cos(angs) / scs                    # [P]
    s = jnp.sin(angs) / scs
    cyf, cxf = (h - 1) / 2.0, (w - 1) / 2.0
    ys, xs = jnp.mgrid[0:h, 0:w]
    ys = ys.astype(jnp.float32) - cyf
    xs = xs.astype(jnp.float32) - cxf
    sx = c[:, None, None] * xs + s[:, None, None] * ys + cxf   # [P, h, w]
    sy = -s[:, None, None] * xs + c[:, None, None] * ys + cyf
    x0 = jnp.clip(jnp.floor(sx), 0, w - 1).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(sy), 0, h - 1).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, w - 1)
    y1 = jnp.minimum(y0 + 1, h - 1)
    fx = jnp.clip(sx - x0, 0.0, 1.0)
    fy = jnp.clip(sy - y0, 0.0, 1.0)
    top = patch[y0, x0] * (1 - fx) + patch[y0, x1] * fx
    bot = patch[y1, x0] * (1 - fx) + patch[y1, x1] * fx
    warped = top * (1 - fy) + bot * fy                         # [P, h, w]

    pp = jax.vmap(_preprocess)(warped)
    from .transform import dft2_planes

    fr, fi = dft2_planes(pp)                                   # [P, h, w]
    gr, gi = dft2_planes(_gauss(h, w))
    # A = Σ_p G · conj(F_p); B = Σ_p |F_p|²
    a_re = (gr[None] * fr + gi[None] * fi).sum(0)
    a_im = (gi[None] * fr - gr[None] * fi).sum(0)
    B = (fr * fr + fi * fi).sum(0)
    return MosseState(a_re, a_im, B, gr, gi, jnp.stack(
        [jnp.asarray(cy, jnp.int32), jnp.asarray(cx, jnp.int32)]))


def _gauss(h: int, w: int) -> jnp.ndarray:
    ys, xs = jnp.mgrid[0:h, 0:w]
    d2 = (ys - h // 2).astype(jnp.float32) ** 2 + (
        xs - w // 2).astype(jnp.float32) ** 2
    return jnp.exp(-d2 / (2.0 * golden.MOSSE_SIGMA ** 2))


def init(frame, bbox) -> MosseState:
    """Train a filter on ``bbox`` = (x, y, w, h) of a gray frame (u8 or
    float, host or device array). Window size is static — one compile per
    (frame shape, bbox size)."""
    x, y, w, h = (int(v) for v in bbox)
    if h < 4 or w < 4:
        raise ValueError("MOSSE window must be at least 4x4")
    return _init_core(jnp.asarray(frame), y + h // 2, x + w // 2, h, w)


@partial(jax.jit, static_argnames=("h", "w"))
def _step_core(state: MosseState, frame: jax.Array, lr: float,
               psr_threshold: float, h: int, w: int):
    f = frame.astype(jnp.float32)
    cy, cx = state.center[0], state.center[1]
    patch, oy, ox = _crop(f, cy, cx, h, w)
    from .transform import dft2_planes, idft2_planes

    fr, fi = dft2_planes(_preprocess(patch))
    inv_b = 1.0 / (state.b + golden.MOSSE_EPS)
    rr = (fr * state.a_re - fi * state.a_im) * inv_b
    ri = (fr * state.a_im + fi * state.a_re) * inv_b
    resp, _ = idft2_planes(rr, ri, scale=True)
    flat = jnp.argmax(resp)
    py = (flat // w).astype(jnp.int32)
    px = (flat % w).astype(jnp.int32)

    # PSR over the sidelobe (one-hot exclusion square, no boolean gather)
    ys, xs = jnp.mgrid[0:h, 0:w]
    excl = (jnp.abs(ys - py) <= 5) & (jnp.abs(xs - px) <= 5)
    n_side = (h * w) - excl.sum()
    side_mean = jnp.where(excl, 0.0, resp).sum() / n_side
    side_var = jnp.where(excl, 0.0, (resp - side_mean) ** 2).sum() / n_side
    peak = resp[py, px]
    psr = (peak - side_mean) / (jnp.sqrt(side_var) + golden.MOSSE_EPS)
    ok = psr >= psr_threshold

    fh, fw = f.shape
    ncy = jnp.clip(oy + py, h // 2, fh - h + h // 2).astype(jnp.int32)
    ncx = jnp.clip(ox + px, w // 2, fw - w + w // 2).astype(jnp.int32)
    ncy = jnp.where(ok, ncy, cy)
    ncx = jnp.where(ok, ncx, cx)

    patch2, _, _ = _crop(f, ncy, ncx, h, w)
    f2r, f2i = dft2_planes(_preprocess(patch2))
    rate = jnp.where(ok, jnp.float32(lr), 0.0)
    # G · conj(F2)
    na_re = state.g_re * f2r + state.g_im * f2i
    na_im = state.g_im * f2r - state.g_re * f2i
    a_re = rate * na_re + (1.0 - rate) * state.a_re
    a_im = rate * na_im + (1.0 - rate) * state.a_im
    B = rate * (f2r * f2r + f2i * f2i) + (1.0 - rate) * state.b
    new = MosseState(a_re, a_im, B, state.g_re, state.g_im,
                     jnp.stack([ncy, ncx]))
    return new, ok, psr


def step(state: MosseState, frame, lr: float = 0.2,
         psr_threshold: float = 5.7):
    """One tracking step — returns (new_state, ok, psr). ``ok``/``psr``
    are device scalars; fetch them only when the host needs the verdict
    (a bank of trackers can run many frames fully device-resident)."""
    h, w = state.g_re.shape  # full-spectrum planes
    return _step_core(state, jnp.asarray(frame), lr, psr_threshold, h, w)


class TrackerMOSSE:
    """OpenCV legacy tracker API: ``init(image, bbox)`` then
    ``ok, bbox = update(image)``; bbox = (x, y, w, h). ``backend="host"``
    runs the float64 golden spec; ``backend="device"`` (default) runs the
    jitted f32 twin with device-resident state."""

    def __init__(self, learning_rate: float = 0.2,
                 psr_threshold: float = 5.7, backend: str = "device"):
        if backend not in ("device", "host"):
            raise ValueError(backend)
        self.learning_rate = float(learning_rate)
        self.psr_threshold = float(psr_threshold)
        self.backend = backend
        self._state = None
        self._size: Tuple[int, int] = (0, 0)
        self.last_psr = float("nan")

    @staticmethod
    def _gray(image) -> np.ndarray:
        a = image
        if hasattr(a, "to_numpy"):        # Mat
            a = a.to_numpy()
        a = np.asarray(a) if not isinstance(a, jax.Array) else a
        if a.ndim == 3:                   # BGR → gray via the frozen spec
            a = golden.bgr_to_gray(np.asarray(a))
        return a

    def init(self, image, bbox) -> None:
        g = self._gray(image)
        x, y, w, h = (int(v) for v in bbox)
        self._size = (h, w)
        if self.backend == "host":
            self._state = golden.mosse_init(np.asarray(g), (x, y, w, h))
        else:
            self._state = init(g, (x, y, w, h))

    def update(self, image):
        if self._state is None:
            raise RuntimeError("call init() first")
        g = self._gray(image)
        if self.backend == "host":
            self._state, ok, psr = golden.mosse_step(
                self._state, np.asarray(g), lr=self.learning_rate,
                psr_threshold=self.psr_threshold)
            cy, cx = self._state["center"]
        else:
            self._state, ok_d, psr_d = step(
                self._state, g, lr=self.learning_rate,
                psr_threshold=self.psr_threshold)
            ok, psr = bool(ok_d), float(psr_d)
            cy, cx = (int(v) for v in np.asarray(self._state.center))
        self.last_psr = float(psr)
        h, w = self._size
        return bool(ok), (cx - w // 2, cy - h // 2, w, h)
