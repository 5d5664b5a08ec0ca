"""Non-local means denoising (OpenCV ``fastNlMeansDenoising`` /
``fastNlMeansDenoisingColored`` role, Buades et al. 2005).

The reference has no photo module; OpenCV-parity addition, spec frozen
here with a float64 NumPy oracle (:func:`nl_means_numpy`).

Device formulation
---------------
For every search offset ``s`` the patch distance field
``D_s = box_{templ}( (I − shift_s(I))² )`` and its weight
``w_s = exp(−D_s / (h²·n_templ))`` are whole-image elementwise maps — no
per-pixel gathers anywhere. The search window is a ``lax.scan`` over the
(2r+1)² offsets: the carry is the (numerator, denominator) accumulator
pair and each step is one ``dynamic_slice`` of the pre-padded image +
one separable box filter — compile size stays O(1) in the search radius
instead of unrolling 441 shifted programs. The division happens once at
the end. Everything is f32 elementwise work that XLA fuses per step.

Frozen spec (oracle float64):
- pad the image by ``search//2 + template//2`` with edge replication;
- ``D_s(p) = Σ_{t∈templ} (I(p+t) − I(p+s+t))²`` (replicate border);
- ``w_s(p) = exp(−D_s(p) / (h² · n_templ))`` — the centre offset s=0
  participates naturally with weight 1;
- ``out(p) = round( Σ_s w_s·I(p+s) / Σ_s w_s )`` clipped to u8.

The colored variant converts to CIE Lab (ops/color.py), denoises L with
``h`` and a/b with ``h_color``, and converts back — OpenCV's exact
decomposition (modules/photo/src/denoising.cpp role).

Tolerance contract: device f32 vs f64 oracle — output u8 within ±1 LSB
(tests/test_nlmeans.py); weights are well-conditioned (exp of negative
bounded arguments).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax


def nl_means_numpy(img: np.ndarray, h: float = 10.0, template: int = 7,
                   search: int = 21) -> np.ndarray:
    """Oracle — the frozen spec above in float64 NumPy. (H, W) u8 → u8."""
    hh, ww = img.shape
    sr, tr = search // 2, template // 2
    pad = sr + tr
    p = np.pad(img.astype(np.float64), pad, mode="edge")
    base = p[sr:sr + hh + 2 * tr, sr:sr + ww + 2 * tr]  # I with templ apron
    n_templ = template * template
    inv = 1.0 / (h * h * n_templ)
    num = np.zeros((hh, ww))
    den = np.zeros((hh, ww))
    for sy in range(-sr, sr + 1):
        for sx in range(-sr, sr + 1):
            shifted = p[sr + sy:sr + sy + hh + 2 * tr,
                        sr + sx:sr + sx + ww + 2 * tr]
            d2 = (base - shifted) ** 2
            # box sum over the template window
            acc = np.zeros((hh, ww))
            for ty in range(template):
                for tx in range(template):
                    acc += d2[ty:ty + hh, tx:tx + ww]
            w = np.exp(-acc * inv)
            num += w * shifted[tr:tr + hh, tr:tr + ww]
            den += w
    return np.clip(np.floor(num / den + 0.5), 0, 255).astype(np.uint8)


@partial(jax.jit, static_argnames=("h", "template", "search"))
def nl_means(img: jax.Array, h: float = 10.0, template: int = 7,
             search: int = 21) -> jax.Array:
    """Device twin — (H, W) u8 → u8, f32 internals, scan over offsets."""
    from .filters import _taps

    hh, ww = img.shape
    sr, tr = search // 2, template // 2
    pad = sr + tr
    p = jnp.pad(img.astype(jnp.float32), pad, mode="edge")
    base = p[sr:sr + hh + 2 * tr, sr:sr + ww + 2 * tr]
    n_templ = template * template
    inv = jnp.float32(1.0 / (h * h * n_templ))
    ones = (1,) * template

    offs = jnp.stack(
        jnp.meshgrid(jnp.arange(search), jnp.arange(search),
                     indexing="ij"), axis=-1).reshape(-1, 2)

    def step(carry, s):
        num, den = carry
        shifted = lax.dynamic_slice(
            p, (s[0], s[1]), (hh + 2 * tr, ww + 2 * tr))
        d2 = (base - shifted) * (base - shifted)
        acc = _taps(_taps(d2, -1, ones, tr), -2, ones, tr)[
            tr:tr + hh, tr:tr + ww]
        w = jnp.exp(-acc * inv)
        num = num + w * shifted[tr:tr + hh, tr:tr + ww]
        den = den + w
        return (num, den), None

    zero = jnp.zeros((hh, ww), jnp.float32)
    (num, den), _ = lax.scan(step, (zero, zero), offs)
    return jnp.clip(jnp.floor(num / den + 0.5), 0, 255).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("h", "h_color", "template", "search"))
def nl_means_colored(bgr: jax.Array, h: float = 10.0, h_color: float = 10.0,
                     template: int = 7, search: int = 21) -> jax.Array:
    """(H, W, 3) u8 BGR → u8: denoise L with ``h``, a/b with ``h_color``
    in CIE Lab, convert back (OpenCV fastNlMeansDenoisingColored role)."""
    from .color import bgr_to_lab, lab_to_bgr

    lab = bgr_to_lab(bgr)
    ell = nl_means(lab[..., 0], h, template, search)
    a = nl_means(lab[..., 1], h_color, template, search)
    b = nl_means(lab[..., 2], h_color, template, search)
    return lab_to_bgr(jnp.stack([ell, a, b], axis=-1))


def nl_means_multi_numpy(frames: np.ndarray, img_index: int,
                         temporal_window: int, h: float = 10.0,
                         template: int = 7, search: int = 21
                         ) -> np.ndarray:
    """Oracle for the temporal variant (OpenCV
    ``fastNlMeansDenoisingMulti`` role): denoise ``frames[img_index]``
    with patches drawn from the ``temporal_window`` frames centred on
    it — the SAME spec as nl_means_numpy with the search set extended
    across time (the reference frame's own s=0 keeps weight 1)."""
    if temporal_window % 2 == 0:
        raise ValueError("temporal_window must be odd")
    half = temporal_window // 2
    if not (half <= img_index < len(frames) - half):
        raise ValueError("temporal window leaves the stack")
    hh, ww = frames[img_index].shape
    sr, tr = search // 2, template // 2
    pad = sr + tr
    base_p = np.pad(frames[img_index].astype(np.float64), pad,
                    mode="edge")
    base = base_p[sr:sr + hh + 2 * tr, sr:sr + ww + 2 * tr]
    n_templ = template * template
    inv = 1.0 / (h * h * n_templ)
    num = np.zeros((hh, ww))
    den = np.zeros((hh, ww))
    for f in range(img_index - half, img_index + half + 1):
        pf = np.pad(frames[f].astype(np.float64), pad, mode="edge")
        for sy in range(-sr, sr + 1):
            for sx in range(-sr, sr + 1):
                shifted = pf[sr + sy:sr + sy + hh + 2 * tr,
                             sr + sx:sr + sx + ww + 2 * tr]
                d2 = (base - shifted) ** 2
                acc = np.zeros((hh, ww))
                for ty in range(template):
                    for tx in range(template):
                        acc += d2[ty:ty + hh, tx:tx + ww]
                w = np.exp(-acc * inv)
                num += w * shifted[tr:tr + hh, tr:tr + ww]
                den += w
    return np.clip(np.floor(num / den + 0.5), 0, 255).astype(np.uint8)


@partial(jax.jit, static_argnames=("img_index", "temporal_window", "h",
                                   "template", "search"))
def nl_means_multi(frames: jax.Array, img_index: int,
                   temporal_window: int, h: float = 10.0,
                   template: int = 7, search: int = 21) -> jax.Array:
    """Device twin — (T, H, W) u8 stack; one scan over
    (frame, offset) pairs."""
    from .filters import _taps

    half = temporal_window // 2
    hh, ww = frames.shape[1], frames.shape[2]
    sr, tr = search // 2, template // 2
    pad = sr + tr
    sub = frames[img_index - half:img_index + half + 1]
    p = jnp.pad(sub.astype(jnp.float32),
                ((0, 0), (pad, pad), (pad, pad)), mode="edge")
    base = p[half, sr:sr + hh + 2 * tr, sr:sr + ww + 2 * tr]
    n_templ = template * template
    inv = jnp.float32(1.0 / (h * h * n_templ))
    ones = (1,) * template

    fy, oy, ox = jnp.meshgrid(jnp.arange(temporal_window),
                              jnp.arange(search), jnp.arange(search),
                              indexing="ij")
    offs = jnp.stack([fy.ravel(), oy.ravel(), ox.ravel()], axis=-1)

    def step(carry, s):
        num, den = carry
        shifted = lax.dynamic_slice(
            p, (s[0], s[1], s[2]),
            (1, hh + 2 * tr, ww + 2 * tr))[0]
        d2 = (base - shifted) * (base - shifted)
        acc = _taps(_taps(d2, -1, ones, tr), -2, ones, tr)[
            tr:tr + hh, tr:tr + ww]
        w = jnp.exp(-acc * inv)
        num = num + w * shifted[tr:tr + hh, tr:tr + ww]
        den = den + w
        return (num, den), None

    zero = jnp.zeros((hh, ww), jnp.float32)
    (num, den), _ = lax.scan(step, (zero, zero), offs)
    return jnp.clip(jnp.floor(num / den + 0.5), 0, 255).astype(jnp.uint8)


def nl_means_colored_multi_numpy(frames: np.ndarray, img_index: int,
                                 temporal_window: int, h: float = 10.0,
                                 h_color: float = 10.0,
                                 template: int = 7, search: int = 21
                                 ) -> np.ndarray:
    """Colored temporal variant (OpenCV
    ``fastNlMeansDenoisingColoredMulti`` role): Lab split — L denoised
    with the temporal spec at ``h``, a/b at ``h_color`` (OpenCV's
    decomposition, as in the single-frame colored path)."""
    from .golden import bgr_to_lab, lab_to_bgr

    labs = np.stack([bgr_to_lab(np.asarray(f)) for f in frames])
    out = np.zeros_like(labs[img_index])
    for c, hh_ in ((0, h), (1, h_color), (2, h_color)):
        out[..., c] = nl_means_multi_numpy(
            labs[..., c], img_index, temporal_window, h=hh_,
            template=template, search=search)
    return lab_to_bgr(out)
