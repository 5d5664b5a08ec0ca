"""KCF tracker (OpenCV ``TrackerKCF`` role, Henriques et al. 2015) —
kernelized correlation filter on a padded window, gray features.

Companion to the MOSSE tracker (ops/tracker.py): same device-resident
single-program-step design, plus the Gaussian-kernel ridge regression
in the Fourier domain that distinguishes KCF.

Device formulation: one jitted step — clamped ``dynamic_slice`` crop →
normalized/Hann features → kernel correlation (two rfft2/irfft2 pairs,
all whole-window elementwise) → response peak + confidence →
``jnp.where``-gated model/α̂ blend. State (x_model, α̂, ŷ, centre) stays
device-resident; banks vmap like the Kalman/MOSSE banks.

Frozen spec (float64 oracle in this module):
- window = (⌊1+padding⌋×) target size: ``win = floor(target·2.5)``
  (padding 1.5), min 8 px per side;
- features: ``gray/255 − 0.5`` × Hann (the MOSSE Hann);
- regression target: unit-peak Gaussian at (h//2, w//2),
  ``σ = √(th·tw)·output_sigma_factor`` with factor 0.1 (target size,
  not window size);
- Gaussian kernel correlation:
  ``k = exp(−max(‖x‖² + ‖z‖² − 2·irfft2(x̂*·ẑ), 0) / (σ_k²·N))``,
  σ_k = 0.2, N = window pixel count;
- train: ``α̂ = ŷ / (k̂xx + λ)``, λ = 1e−4;
- detect at the OLD centre; peak of ``irfft2(k̂(x_model, z)·α̂)`` moves
  the centre (response is centred like MOSSE's: peak at (h//2, w//2) =
  no motion); confidence = peak value, ``ok = peak ≥ detect_thresh``
  (0.35); on failure the state freezes (no adaptation, centre holds);
- update: ``x_model ← (1−η)x_model + η·z``, ``α̂ ← (1−η)α̂ + η·α̂_z``
  with η = 0.075, α̂_z trained on the re-cropped patch at the new
  centre.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from . import golden

__all__ = ["KcfState", "init", "step", "TrackerKCF",
           "kcf_init", "kcf_step"]

PADDING = 1.5
OUTPUT_SIGMA_FACTOR = 0.1
KERNEL_SIGMA = 0.2
LAMBDA = 1e-4
INTERP_FACTOR = 0.075
DETECT_THRESH = 0.35


# ---------------------------------------------------------------------------
# float64 oracle
# ---------------------------------------------------------------------------

def _hann_np(h: int, w: int) -> np.ndarray:
    return golden.mosse_hann(h, w)


def _features_np(patch: np.ndarray) -> np.ndarray:
    return (patch.astype(np.float64) / 255.0 - 0.5) * _hann_np(*patch.shape)


def _kernel_np(x: np.ndarray, z: np.ndarray) -> np.ndarray:
    h, w = x.shape
    n = h * w
    xf = np.fft.rfft2(x)
    zf = np.fft.rfft2(z)
    cross = np.fft.irfft2(np.conj(xf) * zf, s=(h, w))
    d = (x * x).sum() + (z * z).sum() - 2.0 * cross
    return np.exp(-np.maximum(d, 0.0) / (KERNEL_SIGMA * KERNEL_SIGMA * n))


def _win_of_target(w: int, h: int) -> Tuple[int, int]:
    return (max(int(np.floor(h * (1.0 + PADDING))), 8),
            max(int(np.floor(w * (1.0 + PADDING))), 8))


def kcf_init(frame: np.ndarray, bbox) -> dict:
    """bbox = (x, y, w, h). Returns the oracle state dict."""
    x, y, tw, th = (int(v) for v in bbox)
    if tw < 4 or th < 4:
        raise ValueError("KCF target must be at least 4x4")
    wh, ww = _win_of_target(tw, th)
    cy, cx = y + th // 2, x + tw // 2
    patch, _, _ = golden._mosse_crop(np.asarray(frame, np.float64),
                                     cy, cx, wh, ww)
    xm = _features_np(patch)
    sig = np.sqrt(tw * th) * OUTPUT_SIGMA_FACTOR
    yresp = golden.mosse_gauss(wh, ww, sig)
    yf = np.fft.rfft2(yresp)
    k = _kernel_np(xm, xm)
    alphaf = yf / (np.fft.rfft2(k) + LAMBDA)
    return {"x": xm, "alphaf": alphaf, "yf": yf, "center": (cy, cx),
            "size": (wh, ww), "target": (th, tw)}


def kcf_step(state: dict, frame: np.ndarray,
             interp_factor: float = INTERP_FACTOR,
             detect_thresh: float = DETECT_THRESH):
    """One step → (new_state, ok, peak_response)."""
    wh, ww = state["size"]
    cy, cx = state["center"]
    f = np.asarray(frame, np.float64)
    patch, oy, ox = golden._mosse_crop(f, cy, cx, wh, ww)
    z = _features_np(patch)
    k = _kernel_np(state["x"], z)
    resp = np.fft.irfft2(np.fft.rfft2(k) * state["alphaf"], s=(wh, ww))
    py, px = np.unravel_index(int(resp.argmax()), resp.shape)
    peak = float(resp[py, px])
    if peak < detect_thresh:
        return state, False, peak
    fh, fw = f.shape
    ncy = oy + wh // 2 + (int(py) - wh // 2)
    ncx = ox + ww // 2 + (int(px) - ww // 2)
    ncy = int(np.clip(ncy, wh // 2, fh - wh + wh // 2))
    ncx = int(np.clip(ncx, ww // 2, fw - ww + ww // 2))
    patch2, _, _ = golden._mosse_crop(f, ncy, ncx, wh, ww)
    z2 = _features_np(patch2)
    k2 = _kernel_np(z2, z2)
    alphaf2 = state["yf"] / (np.fft.rfft2(k2) + LAMBDA)
    eta = interp_factor
    new = {
        "x": (1 - eta) * state["x"] + eta * z2,
        "alphaf": (1 - eta) * state["alphaf"] + eta * alphaf2,
        "yf": state["yf"], "center": (ncy, ncx),
        "size": (wh, ww), "target": state["target"],
    }
    return new, True, peak


# ---------------------------------------------------------------------------
# device twin (float32)
# ---------------------------------------------------------------------------

class KcfState(NamedTuple):
    """Device-resident KCF state (vmap-able pytree). Spectra are
    (re, im) f32 plane pairs (matmul-form DFT, ops/transform): no
    complex dtype anywhere in the tracker state."""

    x: jax.Array         # float32 [h, w] model features
    alphaf_re: jax.Array  # float32 [h, w]
    alphaf_im: jax.Array  # float32 [h, w]
    yf_re: jax.Array      # float32 [h, w]
    yf_im: jax.Array      # float32 [h, w]
    center: jax.Array    # int32 [2] (cy, cx)


def _hann_j(h: int, w: int) -> jnp.ndarray:
    def hann1(n):
        if n == 1:
            return jnp.ones(1, jnp.float32)
        k = jnp.arange(n, dtype=jnp.float32)
        return 0.5 - 0.5 * jnp.cos(2.0 * jnp.pi * k / (n - 1))
    return jnp.outer(hann1(h), hann1(w))


def _features_j(patch: jax.Array) -> jax.Array:
    return (patch.astype(jnp.float32) / 255.0 - 0.5) * _hann_j(*patch.shape)


def _kernel_j(x: jax.Array, z: jax.Array) -> jax.Array:
    from .transform import dft2_planes, idft2_planes, mul_spectrums_planes

    h, w = x.shape
    n = h * w
    xf = dft2_planes(x)
    zf = dft2_planes(z)
    pr, pi = mul_spectrums_planes(zf, xf, conj_b=True)  # conj(xf)·zf
    cross, _ = idft2_planes(pr, pi, scale=True)
    d = (x * x).sum() + (z * z).sum() - 2.0 * cross
    return jnp.exp(-jnp.maximum(d, 0.0)
                   / (KERNEL_SIGMA * KERNEL_SIGMA * n))


def _cdiv_planes(nr, ni, dr, di):
    """(nr+i·ni) / (dr+i·di) elementwise on planes."""
    m = dr * dr + di * di
    return (nr * dr + ni * di) / m, (ni * dr - nr * di) / m


def _crop_j(frame: jax.Array, cy, cx, h: int, w: int):
    fh, fw = frame.shape
    oy = jnp.clip(cy - h // 2, 0, fh - h)
    ox = jnp.clip(cx - w // 2, 0, fw - w)
    return jax.lax.dynamic_slice(frame, (oy, ox), (h, w)), oy, ox


@partial(jax.jit, static_argnames=("wh", "ww", "sig"))
def _init_core(frame: jax.Array, cy, cx, wh: int, ww: int,
               sig: float) -> KcfState:
    f = frame.astype(jnp.float32)
    patch, _, _ = _crop_j(f, cy, cx, wh, ww)
    xm = _features_j(patch)
    ys, xs = jnp.mgrid[0:wh, 0:ww]
    d2 = (ys - wh // 2).astype(jnp.float32) ** 2 + (
        xs - ww // 2).astype(jnp.float32) ** 2
    yresp = jnp.exp(-d2 / (2.0 * sig * sig))
    from .transform import dft2_planes

    yf_re, yf_im = dft2_planes(yresp)
    k = _kernel_j(xm, xm)
    kf_re, kf_im = dft2_planes(k)
    a_re, a_im = _cdiv_planes(yf_re, yf_im, kf_re + LAMBDA, kf_im)
    return KcfState(xm, a_re, a_im, yf_re, yf_im, jnp.stack(
        [jnp.asarray(cy, jnp.int32), jnp.asarray(cx, jnp.int32)]))


def init(frame, bbox) -> KcfState:
    x, y, tw, th = (int(v) for v in bbox)
    if tw < 4 or th < 4:
        raise ValueError("KCF target must be at least 4x4")
    wh, ww = _win_of_target(tw, th)
    sig = float(np.sqrt(tw * th) * OUTPUT_SIGMA_FACTOR)
    return _init_core(jnp.asarray(frame), y + th // 2, x + tw // 2,
                      wh, ww, sig)


@partial(jax.jit, static_argnames=("wh", "ww"))
def _step_core(state: KcfState, frame: jax.Array, interp_factor: float,
               detect_thresh: float, wh: int, ww: int):
    f = frame.astype(jnp.float32)
    cy, cx = state.center[0], state.center[1]
    patch, oy, ox = _crop_j(f, cy, cx, wh, ww)
    z = _features_j(patch)
    k = _kernel_j(state.x, z)
    from .transform import dft2_planes, idft2_planes, mul_spectrums_planes

    kf = dft2_planes(k)
    rr, ri = mul_spectrums_planes(kf, (state.alphaf_re, state.alphaf_im))
    resp, _ = idft2_planes(rr, ri, scale=True)
    flat = jnp.argmax(resp)
    py = (flat // ww).astype(jnp.int32)
    px = (flat % ww).astype(jnp.int32)
    peak = resp[py, px]
    ok = peak >= detect_thresh

    fh, fw = f.shape
    ncy = jnp.clip(oy + py, wh // 2, fh - wh + wh // 2).astype(jnp.int32)
    ncx = jnp.clip(ox + px, ww // 2, fw - ww + ww // 2).astype(jnp.int32)
    ncy = jnp.where(ok, ncy, cy)
    ncx = jnp.where(ok, ncx, cx)

    patch2, _, _ = _crop_j(f, ncy, ncx, wh, ww)
    z2 = _features_j(patch2)
    k2 = _kernel_j(z2, z2)
    k2f_re, k2f_im = dft2_planes(k2)
    a2_re, a2_im = _cdiv_planes(state.yf_re, state.yf_im,
                                k2f_re + LAMBDA, k2f_im)
    eta = jnp.where(ok, jnp.float32(interp_factor), 0.0)
    new = KcfState(
        (1 - eta) * state.x + eta * z2,
        (1 - eta) * state.alphaf_re + eta * a2_re,
        (1 - eta) * state.alphaf_im + eta * a2_im,
        state.yf_re, state.yf_im, jnp.stack([ncy, ncx]))
    return new, ok, peak


def step(state: KcfState, frame, interp_factor: float = INTERP_FACTOR,
         detect_thresh: float = DETECT_THRESH):
    """One tracking step → (new_state, ok, peak). Device scalars — fetch
    only when the host needs the verdict."""
    wh, ww = state.x.shape
    return _step_core(state, jnp.asarray(frame), interp_factor,
                      detect_thresh, wh, ww)


class TrackerKCF:
    """OpenCV tracker API: ``init(image, bbox)``, ``ok, bbox =
    update(image)``. ``backend`` = "device" (jitted f32 twin, default)
    | "host" (float64 oracle)."""

    def __init__(self, interp_factor: float = INTERP_FACTOR,
                 detect_thresh: float = DETECT_THRESH,
                 backend: str = "device"):
        if backend not in ("device", "host"):
            raise ValueError(backend)
        self.interp_factor = float(interp_factor)
        self.detect_thresh = float(detect_thresh)
        self.backend = backend
        self._state = None
        self._target: Tuple[int, int] = (0, 0)
        self.last_response = float("nan")

    @staticmethod
    def _gray(image) -> np.ndarray:
        a = image
        if hasattr(a, "to_numpy"):
            a = a.to_numpy()
        a = np.asarray(a) if not isinstance(a, jax.Array) else a
        if a.ndim == 3 and a.shape[-1] == 1:
            a = a[..., 0]
        elif a.ndim == 3:
            a = golden.bgr_to_gray(np.asarray(a))
        return a

    def init(self, image, bbox) -> None:
        g = self._gray(image)
        x, y, w, h = (int(v) for v in bbox)
        self._target = (h, w)
        if self.backend == "host":
            self._state = kcf_init(np.asarray(g), (x, y, w, h))
        else:
            self._state = init(g, (x, y, w, h))

    def update(self, image):
        if self._state is None:
            raise RuntimeError("call init() first")
        g = self._gray(image)
        if self.backend == "host":
            self._state, ok, peak = kcf_step(
                self._state, np.asarray(g),
                interp_factor=self.interp_factor,
                detect_thresh=self.detect_thresh)
            cy, cx = self._state["center"]
        else:
            self._state, ok_d, peak_d = step(
                self._state, g, interp_factor=self.interp_factor,
                detect_thresh=self.detect_thresh)
            ok, peak = bool(ok_d), float(peak_d)
            cy, cx = (int(v) for v in np.asarray(self._state.center))
        self.last_response = float(peak)
        h, w = self._target
        return bool(ok), (cx - w // 2, cy - h // 2, w, h)
