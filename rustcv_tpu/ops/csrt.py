"""CSRT tracker (OpenCV ``TrackerCSRT`` role — Lukežič et al. 2017,
"Discriminative Correlation Filter with Channel and Spatial
Reliability").

Third member of the tracker family (ops/tracker.py MOSSE, ops/kcf.py):
the same device-resident single-program-step design, plus the three
CSRT ingredients — multi-channel features, a spatial reliability mask
constraining the filter support, and channel-reliability weighting.

Device formulation: one jitted step — clamped ``dynamic_slice`` crop →
9-channel features (gray + 8 hard-binned gradient orientations, all
elementwise) → batched rfft2 over channels → weighted response sum →
peak → ``jnp.where``-gated re-learn (histograms, mask, 4 fixed ADMM
rounds, channel weights) — no data-dependent control flow. Banks vmap
like the MOSSE/KCF banks.

Frozen spec (float64 oracle in this module; divergences from OpenCV
documented: fixed scale — the DSST scale pyramid is out of scope like
MOSSE/KCF —, gray-intensity histograms instead of HSV color, hard
orientation binning instead of fHOG):
- window = floor(target·(1+1.5) padding), min 16 px per side; target
  rect must be ≥ 8×8;
- features: c₀ = gray/255 − 0.5; c₁..c₈ = |∇|/255 hard-assigned to
  ⌊θ·8/π⌋ mod 8 orientation bins (central differences, zero-padded
  borders); every channel × Hann;
- spatial reliability: 16-bin intensity histograms (+1 smoothing) of
  the central target rect (fg) vs the rest of the window (bg) →
  posterior q = p_fg/(p_fg + p_bg) per pixel; m = (q ≥ 0.5) AND the
  centered ⌊1.5·target⌋ rect; if Σm < max(16, 0.1·target area) the
  mask falls back to the exact target rect (a vanished-contrast guard);
- regression target: unit-peak Gaussian over CIRCULAR distance from
  (0, 0), σ = √(tw·th)·0.1 — peak at the origin, NOT the window centre:
  only then does the learned correlation filter's spatial support
  coincide with the (centred) object appearance that the mask
  constrains; the response peak at (0, 0) means "no motion" and the
  signed wrap of the peak position is the displacement;
- constrained per-channel filter, CORRELATION form (response
  R_c(z) = irfft2(ẑ_c ⊙ conj(ĝ_c))) — in correlation form the filter's
  spatial support coincides with the object appearance, which is what
  the reliability mask constrains (in convolution form the support
  wraps to the origin and the mask would zero it); 4 ADMM rounds with
  μ₀ = 5, β = 3, μmax = 20, λ = 0.01:
    ĥ = (f̂⊙conj(ŷ) + μ·fft(g) − fft(l)) / (|f̂|² + λ + μ)
    g = m ⊙ (irfft(ĥ) + l/μ);  l += μ·(irfft(ĥ) − g);  μ ← min(βμ, μmax)
- channel reliability: w_c = max(0, max(R_c(f))) + 1e−6, normalized to
  Σw = 1, blended with learning rate on update;
- response scale: s = Σ_c w_c·max(R_c(f)) (the weighted TRAINING peak)
  makes confidence self-calibrating — ADMM shrinkage leaves absolute
  responses small, so thresholds are relative to s;
- detect at the old centre: R = Σ_c w_c·R_c(z); displacement =
  ((peak + win//2) mod win) − win//2 per axis; ok = peak/s ≥
  detect_thresh (0.3); on failure state freezes;
- update (learning rate η = 0.04): histograms, filter g, and channel
  weights all blend (1−η)·old + η·new from the re-crop at the new
  centre; the regression target and window geometry are fixed.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from . import golden

__all__ = ["CsrtState", "init", "step", "TrackerCSRT",
           "csrt_init", "csrt_step"]

PADDING = 1.5
OUTPUT_SIGMA_FACTOR = 0.1
LAMBDA = 0.01
MU0, BETA, MU_MAX = 5.0, 3.0, 20.0
ADMM_ITERS = 4
ETA = 0.04
DETECT_THRESH = 0.3
N_BINS = 16
N_ORIENT = 8


def _win_of_target(tw: int, th: int) -> Tuple[int, int]:
    return (max(int(np.floor(th * (1.0 + PADDING))), 16),
            max(int(np.floor(tw * (1.0 + PADDING))), 16))


# ---------------------------------------------------------------------------
# float64 oracle
# ---------------------------------------------------------------------------

def _features_np(patch: np.ndarray) -> np.ndarray:
    """u8 (h, w) → (9, h, w) float64 Hann-windowed channels."""
    p = patch.astype(np.float64)
    h, w = p.shape
    gx = np.zeros_like(p)
    gy = np.zeros_like(p)
    gx[:, 1:-1] = (p[:, 2:] - p[:, :-2]) * 0.5
    gy[1:-1, :] = (p[2:, :] - p[:-2, :]) * 0.5
    mag = np.hypot(gx, gy) / 255.0
    theta = np.arctan2(gy, gx) % np.pi
    bins = np.minimum((theta * (N_ORIENT / np.pi)).astype(np.int64),
                      N_ORIENT - 1)
    ch = [p / 255.0 - 0.5]
    for b in range(N_ORIENT):
        ch.append(np.where(bins == b, mag, 0.0))
    hann = golden.mosse_hann(h, w)
    return np.stack(ch) * hann


def _mask_np(patch: np.ndarray, th: int, tw: int, hist_fg: np.ndarray,
             hist_bg: np.ndarray) -> np.ndarray:
    h, w = patch.shape
    b = np.minimum(patch.astype(np.int64) >> 4, N_BINS - 1)
    q = hist_fg[b] / (hist_fg[b] + hist_bg[b])
    m = q >= 0.5
    rh = min(int(np.floor(1.5 * th)), h)
    rw = min(int(np.floor(1.5 * tw)), w)
    y0, x0 = (h - rh) // 2, (w - rw) // 2
    rect = np.zeros((h, w), bool)
    rect[y0:y0 + rh, x0:x0 + rw] = True
    m = m & rect
    if m.sum() < max(16, 0.1 * th * tw):
        m = np.zeros((h, w), bool)
        y0, x0 = (h - th) // 2, (w - tw) // 2
        m[y0:y0 + th, x0:x0 + tw] = True
    return m.astype(np.float64)


def _hists_np(patch: np.ndarray, th: int, tw: int):
    h, w = patch.shape
    b = np.minimum(patch.astype(np.int64) >> 4, N_BINS - 1)
    y0, x0 = (h - th) // 2, (w - tw) // 2
    fg_mask = np.zeros((h, w), bool)
    fg_mask[y0:y0 + th, x0:x0 + tw] = True
    fg = np.bincount(b[fg_mask], minlength=N_BINS).astype(np.float64) + 1.0
    bg = np.bincount(b[~fg_mask], minlength=N_BINS).astype(np.float64) + 1.0
    return fg / fg.sum(), bg / bg.sum()


def _learn_np(feats: np.ndarray, yf: np.ndarray,
              mask: np.ndarray) -> np.ndarray:
    """ADMM-constrained per-channel filters → g (C, h, w) float64."""
    c, h, w = feats.shape
    fhat = np.fft.rfft2(feats)
    g = np.zeros((c, h, w))
    l = np.zeros((c, h, w))
    mu = MU0
    denom_base = (fhat * np.conj(fhat)).real + LAMBDA
    num = fhat * np.conj(yf)
    for _ in range(ADMM_ITERS):
        hhat = (num + mu * np.fft.rfft2(g) - np.fft.rfft2(l)) / (
            denom_base + mu)
        h_sp = np.fft.irfft2(hhat, s=(h, w))
        g = mask * (h_sp + l / mu)
        l = l + mu * (h_sp - g)
        mu = min(BETA * mu, MU_MAX)
    return g


def _weights_np(feats: np.ndarray, g: np.ndarray):
    c, h, w = feats.shape
    resp = np.fft.irfft2(np.fft.rfft2(feats) * np.conj(np.fft.rfft2(g)),
                         s=(h, w))
    peaks = np.maximum(resp.reshape(c, -1).max(axis=1), 0.0) + 1e-6
    wgt = peaks / peaks.sum()
    return wgt, float((wgt * peaks).sum())


def csrt_init(frame: np.ndarray, bbox) -> dict:
    """bbox = (x, y, w, h). Returns the oracle state dict."""
    x, y, tw, th = (int(v) for v in bbox)
    if tw < 8 or th < 8:
        raise ValueError("CSRT target must be at least 8x8")
    wh, ww = _win_of_target(tw, th)
    cy, cx = y + th // 2, x + tw // 2
    f = np.asarray(frame, np.float64)
    patch, _, _ = golden._mosse_crop(f, cy, cx, wh, ww)
    patch = patch.astype(np.uint8)
    sig = np.sqrt(tw * th) * OUTPUT_SIGMA_FACTOR
    iy = np.minimum(np.arange(wh), wh - np.arange(wh)).astype(np.float64)
    ix = np.minimum(np.arange(ww), ww - np.arange(ww)).astype(np.float64)
    d2 = iy[:, None] ** 2 + ix[None, :] ** 2
    yresp = np.exp(-d2 / (2.0 * sig * sig))
    yf = np.fft.rfft2(yresp)
    hist_fg, hist_bg = _hists_np(patch, th, tw)
    mask = _mask_np(patch, th, tw, hist_fg, hist_bg)
    feats = _features_np(patch)
    g = _learn_np(feats, yf, mask)
    wgt, scale = _weights_np(feats, g)
    return {"g": g, "w": wgt, "scale": scale, "yf": yf,
            "hist_fg": hist_fg, "hist_bg": hist_bg, "center": (cy, cx),
            "size": (wh, ww), "target": (th, tw)}


def csrt_step(state: dict, frame: np.ndarray, eta: float = ETA,
              detect_thresh: float = DETECT_THRESH):
    """One step → (new_state, ok, peak_response)."""
    wh, ww = state["size"]
    th, tw = state["target"]
    cy, cx = state["center"]
    f = np.asarray(frame, np.float64)
    patch, oy, ox = golden._mosse_crop(f, cy, cx, wh, ww)
    patch = patch.astype(np.uint8)
    z = _features_np(patch)
    resp = np.fft.irfft2(
        np.fft.rfft2(z) * np.conj(np.fft.rfft2(state["g"])), s=(wh, ww))
    r = (state["w"][:, None, None] * resp).sum(axis=0)
    py, px = np.unravel_index(int(r.argmax()), r.shape)
    peak = float(r[py, px]) / state["scale"]
    if peak < detect_thresh:
        return state, False, peak
    dy = int((py + wh // 2) % wh) - wh // 2   # signed wrap
    dx = int((px + ww // 2) % ww) - ww // 2
    fh, fw = f.shape
    ncy = int(np.clip(oy + wh // 2 + dy, wh // 2, fh - wh + wh // 2))
    ncx = int(np.clip(ox + ww // 2 + dx, ww // 2, fw - ww + ww // 2))
    patch2, _, _ = golden._mosse_crop(f, ncy, ncx, wh, ww)
    patch2 = patch2.astype(np.uint8)
    fg2, bg2 = _hists_np(patch2, th, tw)
    hist_fg = (1 - eta) * state["hist_fg"] + eta * fg2
    hist_bg = (1 - eta) * state["hist_bg"] + eta * bg2
    mask = _mask_np(patch2, th, tw, hist_fg, hist_bg)
    z2 = _features_np(patch2)
    g2 = _learn_np(z2, state["yf"], mask)
    w2, s2 = _weights_np(z2, g2)
    new = {
        "g": (1 - eta) * state["g"] + eta * g2,
        "w": (1 - eta) * state["w"] + eta * w2,
        "scale": (1 - eta) * state["scale"] + eta * s2,
        "yf": state["yf"], "hist_fg": hist_fg, "hist_bg": hist_bg,
        "center": (ncy, ncx), "size": (wh, ww), "target": (th, tw),
    }
    return new, True, peak


# ---------------------------------------------------------------------------
# device twin (float32)
# ---------------------------------------------------------------------------

class CsrtState(NamedTuple):
    """Device-resident CSRT state (vmap-able pytree)."""

    g: jax.Array        # float32 [C, h, w] masked filters
    w: jax.Array        # float32 [C] channel weights
    scale: jax.Array    # float32 [] training response peak
    yf_re: jax.Array    # float32 [h, w]  (matmul-DFT planes,
    yf_im: jax.Array    # float32 [h, w]   ops/transform.dft2_planes)
    hist_fg: jax.Array  # float32 [16]
    hist_bg: jax.Array  # float32 [16]
    center: jax.Array   # int32 [2] (cy, cx)


def _hann_j(h: int, w: int) -> jnp.ndarray:
    def hann1(n):
        k = jnp.arange(n, dtype=jnp.float32)
        return 0.5 - 0.5 * jnp.cos(2.0 * jnp.pi * k / (n - 1))
    return jnp.outer(hann1(h), hann1(w))


def _features_j(patch: jax.Array) -> jax.Array:
    p = patch.astype(jnp.float32)
    h, w = p.shape
    gx = jnp.zeros_like(p).at[:, 1:-1].set((p[:, 2:] - p[:, :-2]) * 0.5)
    gy = jnp.zeros_like(p).at[1:-1, :].set((p[2:, :] - p[:-2, :]) * 0.5)
    mag = jnp.hypot(gx, gy) / 255.0
    theta = jnp.arctan2(gy, gx) % jnp.pi
    bins = jnp.minimum((theta * (N_ORIENT / jnp.pi)).astype(jnp.int32),
                       N_ORIENT - 1)
    onehot = (bins[None] == jnp.arange(N_ORIENT,
                                       dtype=jnp.int32)[:, None, None])
    ch = jnp.concatenate([(p / 255.0 - 0.5)[None],
                          jnp.where(onehot, mag[None], 0.0)], axis=0)
    return ch * _hann_j(h, w)


def _hists_j(patch: jax.Array, th: int, tw: int):
    h, w = patch.shape
    b = jnp.minimum(patch.astype(jnp.int32) >> 4, N_BINS - 1)
    y0, x0 = (h - th) // 2, (w - tw) // 2
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    fg_mask = ((ys >= y0) & (ys < y0 + th) & (xs >= x0) & (xs < x0 + tw))
    onehot = (b[None] == jnp.arange(N_BINS,
                                    dtype=jnp.int32)[:, None, None])
    fg = (onehot & fg_mask[None]).sum(axis=(1, 2)).astype(jnp.float32) + 1.0
    bg = (onehot & ~fg_mask[None]).sum(axis=(1, 2)).astype(
        jnp.float32) + 1.0
    return fg / fg.sum(), bg / bg.sum()


def _mask_j(patch: jax.Array, th: int, tw: int, hist_fg: jax.Array,
            hist_bg: jax.Array) -> jax.Array:
    h, w = patch.shape
    b = jnp.minimum(patch.astype(jnp.int32) >> 4, N_BINS - 1)
    q = hist_fg[b] / (hist_fg[b] + hist_bg[b])
    rh, rw = min(int(np.floor(1.5 * th)), h), min(int(np.floor(1.5 * tw)), w)
    y0, x0 = (h - rh) // 2, (w - rw) // 2
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    rect = ((ys >= y0) & (ys < y0 + rh) & (xs >= x0) & (xs < x0 + rw))
    m = (q >= 0.5) & rect
    ty0, tx0 = (h - th) // 2, (w - tw) // 2
    trect = ((ys >= ty0) & (ys < ty0 + th)
             & (xs >= tx0) & (xs < tx0 + tw))
    fallback = m.sum() < max(16, 0.1 * th * tw)
    return jnp.where(fallback, trect, m).astype(jnp.float32)


def _learn_j(feats: jax.Array, yf, mask: jax.Array) -> jax.Array:
    from .transform import dft2_planes, idft2_planes

    c, h, w = feats.shape
    yr, yi = yf
    fr, fi = dft2_planes(feats)
    denom_base = fr * fr + fi * fi + LAMBDA
    # num = fhat · conj(yf)
    num_r = fr * yr + fi * yi
    num_i = fi * yr - fr * yi
    g = jnp.zeros((c, h, w), jnp.float32)
    l = jnp.zeros((c, h, w), jnp.float32)
    mu = MU0
    for _ in range(ADMM_ITERS):  # fixed trip count: unrolled in trace
        gr, gi = dft2_planes(g)
        lr, li = dft2_planes(l)
        hr = (num_r + mu * gr - lr) / (denom_base + mu)
        hi_ = (num_i + mu * gi - li) / (denom_base + mu)
        h_sp, _ = idft2_planes(hr, hi_, scale=True)
        g = mask * (h_sp + l / mu)
        l = l + mu * (h_sp - g)
        mu = min(BETA * mu, MU_MAX)
    return g


def _weights_j(feats: jax.Array, g: jax.Array):
    from .transform import dft2_planes, idft2_planes, mul_spectrums_planes

    c, h, w = feats.shape
    pr, pi = mul_spectrums_planes(dft2_planes(feats), dft2_planes(g),
                                  conj_b=True)
    resp, _ = idft2_planes(pr, pi, scale=True)
    peaks = jnp.maximum(resp.reshape(c, -1).max(axis=1), 0.0) + 1e-6
    wgt = peaks / peaks.sum()
    return wgt, (wgt * peaks).sum()


def _crop_j(frame: jax.Array, cy, cx, h: int, w: int):
    fh, fw = frame.shape
    oy = jnp.clip(cy - h // 2, 0, fh - h)
    ox = jnp.clip(cx - w // 2, 0, fw - w)
    return jax.lax.dynamic_slice(frame, (oy, ox), (h, w)), oy, ox


@partial(jax.jit, static_argnames=("wh", "ww", "th", "tw", "sig"))
def _init_core(frame: jax.Array, cy, cx, wh: int, ww: int, th: int,
               tw: int, sig: float) -> CsrtState:
    patch, _, _ = _crop_j(frame.astype(jnp.float32), cy, cx, wh, ww)
    patch = patch.astype(jnp.uint8)
    iy = jnp.minimum(jnp.arange(wh), wh - jnp.arange(wh)).astype(
        jnp.float32)
    ix = jnp.minimum(jnp.arange(ww), ww - jnp.arange(ww)).astype(
        jnp.float32)
    d2 = iy[:, None] ** 2 + ix[None, :] ** 2
    from .transform import dft2_planes

    yf_re, yf_im = dft2_planes(jnp.exp(-d2 / (2.0 * sig * sig)))
    fg, bg = _hists_j(patch, th, tw)
    mask = _mask_j(patch, th, tw, fg, bg)
    feats = _features_j(patch)
    g = _learn_j(feats, (yf_re, yf_im), mask)
    wgt, scale = _weights_j(feats, g)
    return CsrtState(g, wgt, scale, yf_re, yf_im, fg, bg, jnp.stack(
        [jnp.asarray(cy, jnp.int32), jnp.asarray(cx, jnp.int32)]))


def init(frame, bbox) -> CsrtState:
    x, y, tw, th = (int(v) for v in bbox)
    if tw < 8 or th < 8:
        raise ValueError("CSRT target must be at least 8x8")
    wh, ww = _win_of_target(tw, th)
    sig = float(np.sqrt(tw * th) * OUTPUT_SIGMA_FACTOR)
    return _init_core(jnp.asarray(frame), y + th // 2, x + tw // 2,
                      wh, ww, th, tw, sig)


@partial(jax.jit, static_argnames=("wh", "ww", "th", "tw"))
def _step_core(state: CsrtState, frame: jax.Array, eta: float,
               detect_thresh: float, wh: int, ww: int, th: int, tw: int):
    f = frame.astype(jnp.float32)
    cy, cx = state.center[0], state.center[1]
    patch, oy, ox = _crop_j(f, cy, cx, wh, ww)
    z = _features_j(patch.astype(jnp.uint8))
    from .transform import dft2_planes, idft2_planes, mul_spectrums_planes

    pr, pi = mul_spectrums_planes(dft2_planes(z), dft2_planes(state.g),
                                  conj_b=True)
    resp, _ = idft2_planes(pr, pi, scale=True)
    r = (state.w[:, None, None] * resp).sum(axis=0)
    flat = jnp.argmax(r)
    py = (flat // ww).astype(jnp.int32)
    px = (flat % ww).astype(jnp.int32)
    peak = r[py, px] / state.scale
    ok = peak >= detect_thresh

    dy = (py + wh // 2) % wh - wh // 2   # signed wrap
    dx = (px + ww // 2) % ww - ww // 2
    fh, fw = f.shape
    ncy = jnp.clip(oy + wh // 2 + dy, wh // 2,
                   fh - wh + wh // 2).astype(jnp.int32)
    ncx = jnp.clip(ox + ww // 2 + dx, ww // 2,
                   fw - ww + ww // 2).astype(jnp.int32)
    ncy = jnp.where(ok, ncy, cy)
    ncx = jnp.where(ok, ncx, cx)

    patch2, _, _ = _crop_j(f, ncy, ncx, wh, ww)
    patch2 = patch2.astype(jnp.uint8)
    fg2, bg2 = _hists_j(patch2, th, tw)
    e = jnp.where(ok, jnp.float32(eta), 0.0)
    hist_fg = (1 - e) * state.hist_fg + e * fg2
    hist_bg = (1 - e) * state.hist_bg + e * bg2
    mask = _mask_j(patch2, th, tw, hist_fg, hist_bg)
    z2 = _features_j(patch2)
    g2 = _learn_j(z2, (state.yf_re, state.yf_im), mask)
    w2, s2 = _weights_j(z2, g2)
    new = CsrtState(
        (1 - e) * state.g + e * g2,
        (1 - e) * state.w + e * w2,
        (1 - e) * state.scale + e * s2,
        state.yf_re, state.yf_im, hist_fg, hist_bg,
        jnp.stack([ncy, ncx]))
    return new, ok, peak


def step(state: CsrtState, frame, eta: float = ETA,
         detect_thresh: float = DETECT_THRESH, target=None):
    """One tracking step → (new_state, ok, peak). Device scalars — fetch
    only when the host needs the verdict. ``target`` = (th, tw); when
    None it is derived from the window (the init convention)."""
    _, wh, ww = state.g.shape
    if target is None:
        th = int(round(wh / (1.0 + PADDING)))
        tw = int(round(ww / (1.0 + PADDING)))
    else:
        th, tw = target
    return _step_core(state, jnp.asarray(frame), eta, detect_thresh,
                      wh, ww, th, tw)


class TrackerCSRT:
    """OpenCV tracker API: ``init(image, bbox)``, ``ok, bbox =
    update(image)``. ``backend`` = "device" (jitted f32 twin, default)
    | "host" (float64 oracle)."""

    def __init__(self, eta: float = ETA,
                 detect_thresh: float = DETECT_THRESH,
                 backend: str = "device"):
        if backend not in ("device", "host"):
            raise ValueError(backend)
        self.eta = float(eta)
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
            self._state = csrt_init(np.asarray(g), (x, y, w, h))
        else:
            self._state = init(g, (x, y, w, h))

    def update(self, image):
        if self._state is None:
            raise RuntimeError("call init() first")
        g = self._gray(image)
        if self.backend == "host":
            self._state, ok, peak = csrt_step(
                self._state, np.asarray(g), eta=self.eta,
                detect_thresh=self.detect_thresh)
            cy, cx = self._state["center"]
        else:
            self._state, ok_d, peak_d = step(
                self._state, g, eta=self.eta,
                detect_thresh=self.detect_thresh, target=self._target)
            ok, peak = bool(ok_d), float(peak_d)
            cy, cx = (int(v) for v in np.asarray(self._state.center))
        self.last_response = float(peak)
        h, w = self._target
        return bool(ok), (cx - w // 2, cy - h // 2, w, h)
