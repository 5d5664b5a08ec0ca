"""Template matching — normalized cross-correlation as matrix unit convolutions
(small templates) or FFT cross-correlation (large ones).

OpenCV ``matchTemplate`` parity for the common methods, accelerator-native:

- templates under ~32×32: the cross-correlation is a `lax.conv` in the
  rows-as-channels im2col form — systolic-array work, not sliding loops;
- larger templates: FFT cross-correlation — ``irfft2(rfft2(img) ·
  conj(rfft2(zero-padded template)))``, whose circular wrap only touches
  indices outside the VALID output region. A 64×64 template @1080p is
  ~0.6 GFLOP of FFT work vs ~16 GFLOP (conv);
- window statistics (Σ W, Σ W²) never use convs at all: uint32 integral
  images + 4-corner differences — wraparound-exact because every true
  window sum < 2³² for windows up to 256×256 (255²·256² < 2³²).

Frozen spec (float32 device / float64 oracle, tolerance-tested like
Harris):

- ``ccoeff_normed``: R = Σ(T′·W) / √(ΣT′² · Σ(W−mean(W))²) with
  T′ = T − mean(T); degenerate windows (zero variance on either side) → 0.
- ``ccorr_normed``:  R = Σ(T·W) / √(ΣT² · ΣW²); zero denominators → 0.
- ``sqdiff``:        R = Σ(T−W)² = ΣT² − 2Σ(T·W) + ΣW². Accuracy is
  RELATIVE to the response scale (~1e-7·scale on the FFT route, ~1e-9 on
  conv): an exact-cut minimum reads ~0 + ε·ΣW², not exactly 0 — peak
  LOCATIONS are unaffected. Exact-zero detection needs the conv route
  (templates below FFT_AREA_THRESHOLD).

Output shape (H−th+1, W−tw+1), peak (ccoeff/ccorr: max; sqdiff: min) at
the template's top-left corner.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

METHODS = ("ccoeff_normed", "ccorr_normed", "sqdiff")


def _rows_as_channels(img_f32: jax.Array, th: int) -> jax.Array:
    """[H, W] → conv lhs [1, th, H−th+1, W]: channel i is the image shifted
    down by i rows. Turns the single-channel 2-D correlation into a conv
    with a th·tw-deep contraction — an im2col matmul the matrix unit can
    tile, where a naive 1-feature spatial conv lowers to scalar-ish code."""
    hp = img_f32.shape[0] - th + 1
    return jnp.stack(
        [jax.lax.slice_in_dim(img_f32, i, i + hp, axis=0) for i in range(th)],
        axis=0,
    )[None]


def _conv_rows(lhs: jax.Array, kernels: jax.Array) -> jax.Array:
    """lhs [1, th, H', W] × kernels [k, th, tw] → [k, H', W−tw+1]."""
    rhs = kernels[:, :, None, :]  # [k, th, 1, tw]
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1, 1), padding="VALID",
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[0]


# Templates with area ≥ this go through the FFT route (the conv's FLOPs
# scale with template area; the FFT's don't).
FFT_AREA_THRESHOLD = 256


def _window_sums_u32(img_u8: jax.Array, th: int, tw: int):
    """Exact (Σ W, Σ W²) for every valid window via uint32 integral images.
    Prefix sums may wrap, but 4-corner DIFFERENCES are exact modulo 2³²
    and every true window sum < 2³² (windows ≤ 256×256), so the wraparound
    cancels. Returns float32 maps."""
    a = img_u8.astype(jnp.uint32)

    def win(x):
        c = jnp.cumsum(jnp.cumsum(x, axis=0, dtype=jnp.uint32), axis=1,
                       dtype=jnp.uint32)
        ii = jnp.pad(c, ((1, 0), (1, 0)))
        s = (
            ii[th:, tw:] - ii[:-th, tw:] - ii[th:, :-tw] + ii[:-th, :-tw]
        )
        return s.astype(jnp.float32)

    return win(a), win(a * a)


def _fft_cross(a_f32: jax.Array, t_f32: jax.Array) -> jax.Array:
    """Valid-region cross-correlation Σ T·W via FFT. The template is
    zero-padded to the image size; circular wraparound only contaminates
    output rows/cols beyond the valid (H−th+1, W−tw+1) region, which are
    sliced away."""
    h, w = a_f32.shape
    th, tw = t_f32.shape
    tp = jnp.zeros((h, w), jnp.float32).at[:th, :tw].set(t_f32)
    from .transform import dft2_planes, idft2_planes, mul_spectrums_planes

    # matmul-DFT planes (ops/transform.dft2_planes)
    pr, pi = mul_spectrums_planes(dft2_planes(a_f32), dft2_planes(tp),
                                  conj_b=True)
    full, _ = idft2_planes(pr, pi, scale=True)
    return full[: h - th + 1, : w - tw + 1]


@partial(jax.jit, static_argnames=("method",))
def match_template(
    img: jax.Array, tmpl: jax.Array, method: str = "ccoeff_normed"
) -> jax.Array:
    """u8 grayscale image (H, W) × template (th, tw) → float32 response map
    (H−th+1, W−tw+1). Route (conv vs FFT) is chosen by the static template
    area; both satisfy the same tolerance contract vs the float64 oracle."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r} (one of {METHODS})")
    a = img.astype(jnp.float32)
    t = tmpl.astype(jnp.float32)
    th, tw = t.shape
    n = float(th * tw)
    use_fft = th * tw >= FFT_AREA_THRESHOLD

    s1, s2 = _window_sums_u32(img, th, tw)

    def cross_with(kernel):
        if use_fft:
            return _fft_cross(a, kernel)
        lhs = _rows_as_channels(a, th)
        return _conv_rows(lhs, jnp.stack([kernel]))[0]

    if method == "sqdiff":
        return s2 - 2.0 * cross_with(t) + jnp.sum(t * t)
    if method == "ccorr_normed":
        denom = jnp.sqrt(s2 * jnp.sum(t * t))
        return jnp.where(denom > 0, cross_with(t) / jnp.maximum(denom, 1e-20), 0.0)
    # ccoeff_normed: Σ T′ = 0 ⇒ the T′ correlation is already mean-free.
    tp = t - jnp.mean(t)
    win_var = s2 - s1 * s1 / n  # Σ(W − mean W)²
    denom = jnp.sqrt(jnp.maximum(win_var, 0.0) * jnp.sum(tp * tp))
    return jnp.where(
        denom > 1e-6, cross_with(tp) / jnp.maximum(denom, 1e-20), 0.0
    )


def min_max_loc(resp) -> Tuple[float, float, Tuple[int, int], Tuple[int, int]]:
    """(min_val, max_val, (min_x, min_y), (max_x, max_y)) of a 2-D response
    (OpenCV ``minMaxLoc`` — locations are (x, y))."""
    a = np.asarray(resp)
    imin = int(np.argmin(a))
    imax = int(np.argmax(a))
    w = a.shape[1]
    return (
        float(a.flat[imin]),
        float(a.flat[imax]),
        (imin % w, imin // w),
        (imax % w, imax // w),
    )


# ---------------------------------------------------------------------------
# NumPy oracle (float64 — tolerance-tested like Harris)
# ---------------------------------------------------------------------------


def match_template_numpy(
    img: np.ndarray, tmpl: np.ndarray, method: str = "ccoeff_normed"
) -> np.ndarray:
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    a = img.astype(np.float64)
    t = tmpl.astype(np.float64)
    th, tw = t.shape
    win = np.lib.stride_tricks.sliding_window_view(a, (th, tw))
    n = th * tw
    if method == "sqdiff":
        return np.einsum("hwij,hwij->hw", win - t, win - t)
    if method == "ccorr_normed":
        cross = np.einsum("hwij,ij->hw", win, t)
        denom = np.sqrt(np.einsum("hwij,hwij->hw", win, win) * np.sum(t * t))
        return np.where(denom > 0, cross / np.maximum(denom, 1e-300), 0.0)
    tp = t - t.mean()
    cross = np.einsum("hwij,ij->hw", win, tp)
    s1 = np.einsum("hwij->hw", win)
    s2 = np.einsum("hwij,hwij->hw", win, win)
    win_var = s2 - s1 * s1 / n
    denom = np.sqrt(np.maximum(win_var, 0.0) * np.sum(tp * tp))
    return np.where(denom > 1e-6, cross / np.maximum(denom, 1e-300), 0.0)
