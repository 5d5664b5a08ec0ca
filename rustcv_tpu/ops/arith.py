"""Core per-element arithmetic (OpenCV ``add``/``addWeighted``/
``absdiff``/``bitwise_*``/``convertScaleAbs``/``norm``/``countNonZero``/
``meanStdDev`` roles).

Pure elementwise work — XLA fuses chains of these into single device-memory
passes, so composition is free. All frozen specs
match the NumPy oracles in this module bit-for-bit; saturating u8
rounding is round-half-even (jnp.round == np.rint), matching filter2d.

Reductions (norm/mean/std/count) return device scalars; the facades
fetch them. Sums accumulate in float64-safe ranges: int32 partials for
L1/count (< 2^31 through 8.4 Mpx), f32 for L2 with a f64 host finish in
the oracle-checked facades.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp


def _sat_u8(x: jax.Array) -> jax.Array:
    return jnp.clip(jnp.round(x), 0, 255).astype(jnp.uint8)


@jax.jit
def add_u8(a: jax.Array, b: jax.Array) -> jax.Array:
    """Saturating u8 add."""
    return jnp.minimum(a.astype(jnp.int32) + b.astype(jnp.int32), 255).astype(jnp.uint8)


@jax.jit
def subtract_u8(a: jax.Array, b: jax.Array) -> jax.Array:
    """Saturating u8 subtract (clamps at 0)."""
    return jnp.maximum(a.astype(jnp.int32) - b.astype(jnp.int32), 0).astype(jnp.uint8)


@jax.jit
def absdiff_u8(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.abs(a.astype(jnp.int32) - b.astype(jnp.int32)).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("alpha", "beta", "gamma"))
def add_weighted_u8(a: jax.Array, alpha: float, b: jax.Array, beta: float,
                    gamma: float = 0.0) -> jax.Array:
    """αa + βb + γ, f32, round-half-even, saturate. ±1 LSB vs the oracle
    for non-dyadic weights (XLA fuses the expression into FMAs whose
    extra precision can land exactly on .5 boundaries); dyadic weights
    (k/2^n) are exact."""
    return _sat_u8(alpha * a.astype(jnp.float32)
                   + beta * b.astype(jnp.float32) + gamma)


@partial(jax.jit, static_argnames=("alpha", "beta"))
def convert_scale_abs_u8(a: jax.Array, alpha: float = 1.0,
                         beta: float = 0.0) -> jax.Array:
    """|αx + β| then saturate (OpenCV ``convertScaleAbs``)."""
    return _sat_u8(jnp.abs(alpha * a.astype(jnp.float32) + beta))


@jax.jit
def bitwise_and(a: jax.Array, b: jax.Array) -> jax.Array:
    return a & b


@jax.jit
def bitwise_or(a: jax.Array, b: jax.Array) -> jax.Array:
    return a | b


@jax.jit
def bitwise_xor(a: jax.Array, b: jax.Array) -> jax.Array:
    return a ^ b


@jax.jit
def bitwise_not(a: jax.Array) -> jax.Array:
    return ~a


@jax.jit
def count_non_zero(a: jax.Array) -> jax.Array:
    """int32 count (device scalar)."""
    return jnp.sum((a != 0).astype(jnp.int32))


@partial(jax.jit, static_argnames=("kind",))
def norm_u8(a: jax.Array, kind: str = "l2") -> jax.Array:
    """L1 / L2 / inf norm of a u8 array (f32 device scalar; L1 exact via
    int32 through 8.4 Mpx, L2 squares sum in f32)."""
    if kind == "l1":
        return jnp.sum(a.astype(jnp.int32)).astype(jnp.float32)
    if kind == "l2":
        f = a.astype(jnp.float32)
        return jnp.sqrt(jnp.sum(f * f))
    if kind == "inf":
        return jnp.max(a).astype(jnp.float32)
    raise ValueError(f"unknown norm {kind!r} (l1, l2, inf)")


@jax.jit
def mean_stddev_u8(a: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """(mean, stddev) f32 device scalars (population std, OpenCV style)."""
    f = a.astype(jnp.float32)
    m = jnp.mean(f)
    return m, jnp.sqrt(jnp.maximum(jnp.mean(f * f) - m * m, 0.0))


def psnr_u8(a: jax.Array, b: jax.Array) -> float:
    """Peak signal-to-noise ratio (dB), inf for identical inputs."""
    d = absdiff_u8(a, b).astype(jnp.float32)
    mse = float(jnp.mean(d * d))
    if mse == 0.0:
        return float("inf")
    return float(10.0 * np.log10(255.0 * 255.0 / mse))


# ---------------------------------------------------------------- oracles

def add_weighted_numpy(a, alpha, b, beta, gamma=0.0):
    # mirror the device's f32 op order exactly
    v = (np.float32(alpha) * a.astype(np.float32)
         + np.float32(beta) * b.astype(np.float32) + np.float32(gamma))
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def convert_scale_abs_numpy(a, alpha=1.0, beta=0.0):
    v = np.abs((alpha * a.astype(np.float32) + np.float32(beta)))
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def norm_numpy(a, kind="l2"):
    f = a.astype(np.float64)
    if kind == "l1":
        return float(f.sum())
    if kind == "l2":
        return float(np.sqrt((f.astype(np.float32) ** 2).sum(dtype=np.float32)))
    if kind == "inf":
        return float(f.max())
    raise ValueError(kind)


@partial(jax.jit, static_argnames=("kind",))
def normalize_u8(img: jax.Array, alpha: float = 0.0, beta: float = 255.0,
                 kind: str = "minmax") -> jax.Array:
    """u8 normalize (OpenCV ``normalize`` role; frozen spec
    golden.normalize_u8). Device f32 vs the f64 oracle — documented
    ±1 LSB at scale boundaries. ``minmax`` maps [min, max] → [alpha,
    beta]; ``inf``/``l1``/``l2`` scale so the norm equals ``alpha``."""
    a = img.astype(jnp.float32)
    if kind == "minmax":
        lo = a.min()
        hi = a.max()
        scale = jnp.where(hi == lo, 0.0, (beta - alpha) / (hi - lo))
        out = (a - lo) * scale + alpha
    elif kind in ("inf", "l1", "l2"):
        n = {
            "inf": lambda: jnp.abs(a).max(),
            "l1": lambda: jnp.abs(a).sum(),
            "l2": lambda: jnp.sqrt((a * a).sum()),
        }[kind]()
        out = a * jnp.where(n == 0, 0.0, alpha / n)
    else:
        raise ValueError(f"unknown norm kind {kind!r}")
    return jnp.clip(jnp.floor(out + 0.5), 0, 255).astype(jnp.uint8)


@jax.jit
def accumulate_weighted(acc: jax.Array, src: jax.Array,
                        alpha: float) -> jax.Array:
    """Running average (OpenCV ``accumulateWeighted``):
    acc' = (1−α)·acc + α·src, float32 accumulator, u8 or float src."""
    return (1.0 - alpha) * acc.astype(jnp.float32) + alpha * src.astype(
        jnp.float32
    )


def accumulate_weighted_numpy(acc, src, alpha):
    return ((1.0 - np.float32(alpha)) * acc.astype(np.float32)
            + np.float32(alpha) * src.astype(np.float32))
