"""Stereo block matching (OpenCV ``StereoBM`` role) — disparity from a
rectified L/R pair.

Device formulation: the cost volume is D shifted absolute differences box-
filtered with separable taps (a vmapped stack — no per-pixel loops), the
disparity is an argmin over D, and sub-pixel refinement fits the standard
parabola through the three costs around the winner. Memory: the [D, H, W]
int32 volume is ~530 MB at 1080p/64 disparities — fine in device memory; use
chunked calls for larger products.

Frozen spec:
- cost(d) = Σ_window |L(x, y) − R(x−d, y)| (exact integer; replicate
  border for the window, columns x < d take the clamped R column 0);
- disparity = argmin_d cost (ties → smallest d);
- validity: the LEFT image's window texture Σ|∂x L| (central difference)
  must exceed texture·window² (reject flat regions — a flat pair matches
  everywhere with zero cost), and the uniqueness test min2 ≥
  min·(1 + uniq/100) over d outside ±1 of the winner;
- sub-pixel (float32): d + (c⁻ − c⁺) / (2·(c⁻ − 2c + c⁺)) clamped to
  ±0.5, 0 at the volume edges or degenerate denominators.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .filters import _taps


def _box(a: jax.Array, r: int) -> jax.Array:
    ones = (1,) * (2 * r + 1)
    return _taps(_taps(a, -1, ones, r), -2, ones, r)


@partial(jax.jit, static_argnames=("num_disparities", "block_size",
                                   "texture", "uniqueness"))
def stereo_bm(
    left: jax.Array,
    right: jax.Array,
    num_disparities: int = 64,
    block_size: int = 15,
    texture: int = 10,
    uniqueness: int = 10,
):
    """u8 rectified pair (H, W) → (disparity float32 (H, W), valid bool).

    Invalid pixels (texture/uniqueness failures, d-range columns) carry
    disparity 0 and valid False."""
    h, w = left.shape
    r = block_size // 2
    lf = left.astype(jnp.int32)
    rt = right.astype(jnp.int32)

    def cost_for(d):
        # R shifted right by d: R(x−d); columns x < d clamp to column 0
        shifted = jnp.pad(rt, ((0, 0), (d, 0)), mode="edge")[:, :w]
        return _box(jnp.abs(lf - shifted), r)

    costs = jnp.stack([cost_for(d) for d in range(num_disparities)])  # [D,H,W]
    best = jnp.argmin(costs, axis=0).astype(jnp.int32)
    cmin = jnp.min(costs, axis=0)

    # validity: texture (left-image gradient energy) + uniqueness
    n_win = (2 * r + 1) ** 2
    dx = jnp.abs(_taps(lf, -1, (-1, 0, 1), 1))
    textured = _box(dx, r) > texture * n_win
    d_axis = jnp.arange(num_disparities)[:, None, None]
    near = jnp.abs(d_axis - best[None]) <= 1
    # sentinel only survives when D <= 3 (all lags masked) — callers use
    # D >= 16; real costs are <= 255·win² so ×110 stays well inside int32
    masked = jnp.where(near, jnp.int32(1 << 24), costs)
    second = jnp.min(masked, axis=0)
    unique = second * 100 >= cmin * (100 + uniqueness)
    # columns that can't see the full disparity range are invalid
    xcol = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    in_range = xcol >= (num_disparities - 1)
    valid = textured & unique & in_range

    # sub-pixel parabola
    dm1 = jnp.clip(best - 1, 0, num_disparities - 1)
    dp1 = jnp.clip(best + 1, 0, num_disparities - 1)
    take = lambda idx: jnp.take_along_axis(costs, idx[None], axis=0)[0]
    cm = take(dm1).astype(jnp.float32)
    cp = take(dp1).astype(jnp.float32)
    c0 = cmin.astype(jnp.float32)
    denom = cm - 2.0 * c0 + cp
    frac = jnp.where(
        (best > 0) & (best < num_disparities - 1) & (denom > 0),
        jnp.clip((cm - cp) / (2.0 * jnp.maximum(denom, 1e-9)), -0.5, 0.5),
        0.0,
    )
    disp = jnp.where(valid, best.astype(jnp.float32) + frac, 0.0)
    return disp, valid


def stereo_bm_numpy(
    left: np.ndarray,
    right: np.ndarray,
    num_disparities: int = 64,
    block_size: int = 15,
    texture: int = 10,
    uniqueness: int = 10,
) -> Tuple[np.ndarray, np.ndarray]:
    """Oracle — same frozen spec, float64/ int64 NumPy."""
    h, w = left.shape
    r = block_size // 2
    lf = left.astype(np.int64)
    rt = right.astype(np.int64)

    def box(a):
        p = np.pad(a, ((r, r), (r, r)), mode="edge")
        acc = np.zeros_like(a)
        for dy in range(2 * r + 1):
            for dx in range(2 * r + 1):
                acc = acc + p[dy : dy + h, dx : dx + w]
        return acc

    costs = np.stack([
        box(np.abs(lf - np.pad(rt, ((0, 0), (d, 0)), mode="edge")[:, :w]))
        for d in range(num_disparities)
    ])
    best = costs.argmin(axis=0)
    cmin = costs.min(axis=0)
    n_win = (2 * r + 1) ** 2
    pdx = np.pad(lf, ((0, 0), (1, 1)), mode="edge")
    dx = np.abs(pdx[:, 2:] - pdx[:, :-2])
    textured = box(dx) > texture * n_win
    d_axis = np.arange(num_disparities)[:, None, None]
    masked = np.where(np.abs(d_axis - best[None]) <= 1, 2**30, costs)
    second = masked.min(axis=0)
    unique = second * 100 >= cmin * (100 + uniqueness)
    xcol = np.arange(w)[None, :]
    valid = textured & unique & (xcol >= num_disparities - 1)
    dm1 = np.clip(best - 1, 0, num_disparities - 1)
    dp1 = np.clip(best + 1, 0, num_disparities - 1)
    ii, jj = np.mgrid[0:h, 0:w]
    cm = costs[dm1, ii, jj].astype(np.float64)
    cp = costs[dp1, ii, jj].astype(np.float64)
    c0 = cmin.astype(np.float64)
    denom = cm - 2.0 * c0 + cp
    frac = np.where(
        (best > 0) & (best < num_disparities - 1) & (denom > 0),
        np.clip((cm - cp) / (2.0 * np.maximum(denom, 1e-9)), -0.5, 0.5),
        0.0,
    )
    disp = np.where(valid, best + frac, 0.0).astype(np.float32)
    return disp, valid
