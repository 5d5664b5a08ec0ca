"""Extended morphology: skeleton thinning and anisotropic diffusion
(OpenCV ximgproc ``thinning`` / ``anisotropicDiffusion`` roles).

The reference has neither; OpenCV-parity additions. Both are ideal device
shapes — fixed-stencil elementwise iteration, no gathers, no data-
dependent shapes — so the device twins are single fused programs
(``lax.while_loop`` / ``fori_loop``) and the oracles here are the
frozen specs.

Frozen specs:
- thinning: Zhang-Suen (1984), exact. Two alternating sub-iterations
  delete a set pixel p when 2 ≤ B(p) ≤ 6, A(p) = 1 (01 transitions in
  the clockwise ring p2..p9,p2), and the sub-iteration's two products
  of cardinal neighbors are zero (1: p2·p4·p6 = p4·p6·p8 = 0;
  2: p2·p4·p8 = p2·p6·p8 = 0), repeated until a full double pass
  changes nothing. Borders are zero-padded. Device == oracle
  BIT-EXACT (binary algorithm, no arithmetic tolerance).
- anisotropic_diffusion: Perona-Malik with the exponential conduction
  g = exp(−(|∇|/K)²), 4-neighbor fluxes, zero-flux (replicate)
  borders: I ← I + α·Σ_d g(∇_d I)·∇_d I per iteration, float; u8
  callers round+clip at the end. Device f32 vs oracle f64 within
  ±1 LSB after the final round for sane (α ≤ 0.25, K ≥ 1) settings.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["thinning", "thinning_numpy", "anisotropic_diffusion",
           "anisotropic_diffusion_numpy"]


# ---------------------------------------------------------------------------
# Zhang-Suen thinning
# ---------------------------------------------------------------------------

def _ring_np(m: np.ndarray):
    """p2..p9: N, NE, E, SE, S, SW, W, NW of each pixel (zero-padded)."""
    p = np.pad(m, 1)
    return [
        p[:-2, 1:-1], p[:-2, 2:], p[1:-1, 2:], p[2:, 2:],
        p[2:, 1:-1], p[2:, :-2], p[1:-1, :-2], p[:-2, :-2],
    ]


def _subpass_np(m: np.ndarray, second: bool) -> np.ndarray:
    r = _ring_np(m)
    b = sum(x.astype(np.int32) for x in r)
    ring = r + [r[0]]
    a = sum(((ring[i] == 0) & (ring[i + 1] == 1)).astype(np.int32)
            for i in range(8))
    p2, p4, p6, p8 = r[0], r[2], r[4], r[6]
    if not second:
        cond = (p2 * p4 * p6 == 0) & (p4 * p6 * p8 == 0)
    else:
        cond = (p2 * p4 * p8 == 0) & (p2 * p6 * p8 == 0)
    kill = (m == 1) & (b >= 2) & (b <= 6) & (a == 1) & cond
    return m & ~kill


def thinning_numpy(mask) -> np.ndarray:
    """Frozen Zhang-Suen spec → u8 (0/1) skeleton."""
    m = (np.asarray(mask) != 0).astype(np.uint8)
    while True:
        n1 = _subpass_np(m, False)
        n2 = _subpass_np(n1, True)
        if np.array_equal(n2, m):
            return n2
        m = n2


def _ring_j(m: jax.Array):
    p = jnp.pad(m, 1)
    return [
        p[:-2, 1:-1], p[:-2, 2:], p[1:-1, 2:], p[2:, 2:],
        p[2:, 1:-1], p[2:, :-2], p[1:-1, :-2], p[:-2, :-2],
    ]


def _subpass_j(m: jax.Array, second: bool) -> jax.Array:
    r = _ring_j(m)
    b = sum(x.astype(jnp.int32) for x in r)
    ring = r + [r[0]]
    a = sum(((ring[i] == 0) & (ring[i + 1] == 1)).astype(jnp.int32)
            for i in range(8))
    p2, p4, p6, p8 = r[0], r[2], r[4], r[6]
    if not second:
        cond = (p2 * p4 * p6 == 0) & (p4 * p6 * p8 == 0)
    else:
        cond = (p2 * p4 * p8 == 0) & (p2 * p6 * p8 == 0)
    kill = (m == 1) & (b >= 2) & (b <= 6) & (a == 1) & cond
    return (m & ~kill).astype(jnp.uint8)


@jax.jit
def _thin_core(m: jax.Array) -> jax.Array:
    def body(state):
        cur, _ = state
        nxt = _subpass_j(_subpass_j(cur, False), True)
        return nxt, jnp.any(nxt != cur)

    def cond(state):
        return state[1]

    out, _ = jax.lax.while_loop(cond, body, (m, jnp.bool_(True)))
    return out


def thinning(mask) -> jax.Array:
    """Skeletonize a binary mask (OpenCV ximgproc ``thinning``
    THINNING_ZHANGSUEN role) → u8 (0/1) jax array, bit-exact vs
    :func:`thinning_numpy`. One fused while_loop program on device."""
    m = (jnp.asarray(mask) != 0).astype(jnp.uint8)
    if m.ndim != 2:
        raise ValueError("thinning expects a 2-D mask")
    return _thin_core(m)


# ---------------------------------------------------------------------------
# Perona-Malik anisotropic diffusion
# ---------------------------------------------------------------------------

def anisotropic_diffusion_numpy(img, alpha: float = 0.15, k: float = 20.0,
                                niters: int = 10) -> np.ndarray:
    """Frozen Perona-Malik spec (f64). u8 in → u8 out (round+clip);
    float in → float64 out. Channels diffuse independently."""
    a = np.asarray(img)
    was_u8 = a.dtype == np.uint8
    x = a.astype(np.float64)
    chans = x[None] if x.ndim == 2 else np.moveaxis(x, -1, 0)
    out = []
    for c in chans:
        cur = c
        for _ in range(niters):
            p = np.pad(cur, 1, mode="edge")
            dn = p[:-2, 1:-1] - cur
            ds = p[2:, 1:-1] - cur
            de = p[1:-1, 2:] - cur
            dw = p[1:-1, :-2] - cur
            flux = sum(np.exp(-(d / k) ** 2) * d for d in (dn, ds, de, dw))
            cur = cur + alpha * flux
        out.append(cur)
    y = out[0] if x.ndim == 2 else np.stack(out, axis=-1)
    if was_u8:
        return np.clip(np.floor(y + 0.5), 0, 255).astype(np.uint8)
    return y


@jax.jit
def _diffuse_core(x: jax.Array, alpha: jax.Array, k: jax.Array,
                  niters: jax.Array) -> jax.Array:
    def body(_, cur):
        p = jnp.pad(cur, ((1, 1), (1, 1), (0, 0)), mode="edge")
        dn = p[:-2, 1:-1] - cur
        ds = p[2:, 1:-1] - cur
        de = p[1:-1, 2:] - cur
        dw = p[1:-1, :-2] - cur
        flux = sum(jnp.exp(-(d / k) ** 2) * d for d in (dn, ds, de, dw))
        return cur + alpha * flux

    return jax.lax.fori_loop(0, niters, body, x)


def anisotropic_diffusion(img, alpha: float = 0.15, k: float = 20.0,
                          niters: int = 10):
    """Perona-Malik diffusion (OpenCV ximgproc ``anisotropicDiffusion``
    role) — one fused fori_loop program; u8 in → u8 out. Oracle:
    :func:`anisotropic_diffusion_numpy` (device f32 within ±1 LSB)."""
    a = jnp.asarray(img)
    was_u8 = a.dtype == jnp.uint8
    x = a.astype(jnp.float32)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    y = _diffuse_core(x, jnp.float32(alpha), jnp.float32(k),
                      jnp.asarray(niters, jnp.int32))
    if squeeze:
        y = y[..., 0]
    if was_u8:
        return jnp.clip(jnp.floor(y + 0.5), 0, 255).astype(jnp.uint8)
    return y
