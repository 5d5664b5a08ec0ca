"""TV-L1 denoising (OpenCV ``denoise_TVL1`` role): minimize
``TV(u) + λ·Σ_i |u − f_i|`` over any number of noisy observations via
the Chambolle-Pock primal-dual algorithm.

Frozen spec (denoise_tvl1_numpy, float64): forward-difference gradient
with replicate (Neumann) boundary, divergence as its negative adjoint;
dual ball projections ``p ← p/max(1,|p|)`` per pixel and
``q_i ← clip(q_i, ±λ)``; steps τ = σ = 1/√(8+N) (‖K‖² ≤ 8+N for N
observations); over-relaxation θ = 1. Images are scaled to [0,1]
internally and the result rounded back to u8 — OpenCV's interface.

cv2's implementation uses a different primal-dual parameterization, so
outputs are not bit-equal; tests pin (a) within-4-LSB mean agreement
with cv2.denoise_TVL1 on piecewise-constant scenes and (b) an energy
decrease vs the noisy input.

Device formulation: one ``fori_loop`` whose body is pure shifted-view
elementwise math (gradient/divergence = jnp.diff-style slices) — XLA
fuses the whole iteration; no gathers, no scatters.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import numpy as np

import jax
import jax.numpy as jnp


def _grad_np(u):
    gx = np.zeros_like(u)
    gy = np.zeros_like(u)
    gx[:, :-1] = u[:, 1:] - u[:, :-1]
    gy[:-1, :] = u[1:, :] - u[:-1, :]
    return gx, gy


def _div_np(px, py):
    d = np.zeros_like(px)
    d[:, 0] = px[:, 0]
    d[:, 1:] = px[:, 1:] - px[:, :-1]
    d[:, -1] = -px[:, -2] if px.shape[1] > 1 else d[:, -1]
    d2 = np.zeros_like(py)
    d2[0, :] = py[0, :]
    d2[1:, :] = py[1:, :] - py[:-1, :]
    d2[-1, :] = -py[-2, :] if py.shape[0] > 1 else d2[-1, :]
    return d + d2


def denoise_tvl1_numpy(observations: Sequence[np.ndarray],
                       lam: float = 1.0, niters: int = 30) -> np.ndarray:
    """Oracle — float64 Chambolle-Pock, u8 in/out."""
    fs = [np.asarray(o, np.float64) / 255.0 for o in observations]
    n = len(fs)
    if n == 0:
        raise ValueError("need at least one observation")
    u = fs[0].copy()
    ub = u.copy()
    px = np.zeros_like(u)
    py = np.zeros_like(u)
    qs = [np.zeros_like(u) for _ in range(n)]
    step = 1.0 / np.sqrt(8.0 + n)
    tau = sigma = step
    for _ in range(niters):
        gx, gy = _grad_np(ub)
        px = px + sigma * gx
        py = py + sigma * gy
        mag = np.maximum(1.0, np.sqrt(px * px + py * py))
        px /= mag
        py /= mag
        for i in range(n):
            qs[i] = np.clip(qs[i] + sigma * (ub - fs[i]), -lam, lam)
        u_new = u + tau * (_div_np(px, py) - sum(qs))
        ub = 2.0 * u_new - u
        u = u_new
    return np.clip(np.rint(u * 255.0), 0, 255).astype(np.uint8)


@partial(jax.jit, static_argnames=("lam", "niters"))
def denoise_tvl1(stack: jax.Array, lam: float = 1.0,
                 niters: int = 30) -> jax.Array:
    """Device twin — ``stack`` is (N, H, W) u8; one fused fori_loop."""
    fs = stack.astype(jnp.float32) / 255.0
    n = fs.shape[0]
    u0 = fs[0]

    def grad(u):
        gx = jnp.pad(u[:, 1:] - u[:, :-1], ((0, 0), (0, 1)))
        gy = jnp.pad(u[1:, :] - u[:-1, :], ((0, 1), (0, 0)))
        return gx, gy

    def div(px, py):
        dx = jnp.concatenate(
            [px[:, :1], px[:, 1:-1] - px[:, :-2], -px[:, -2:-1]], axis=1)
        dy = jnp.concatenate(
            [py[:1, :], py[1:-1, :] - py[:-2, :], -py[-2:-1, :]], axis=0)
        return dx + dy

    step = 1.0 / np.sqrt(8.0 + n)
    tau = sigma = jnp.float32(step)

    def body(_, carry):
        u, ub, px, py, qs = carry
        gx, gy = grad(ub)
        px = px + sigma * gx
        py = py + sigma * gy
        mag = jnp.maximum(1.0, jnp.sqrt(px * px + py * py))
        px = px / mag
        py = py / mag
        qs = jnp.clip(qs + sigma * (ub[None] - fs), -lam, lam)
        u_new = u + tau * (div(px, py) - qs.sum(axis=0))
        return u_new, 2.0 * u_new - u, px, py, qs

    z = jnp.zeros_like(u0)
    qs0 = jnp.zeros_like(fs)
    u, *_ = jax.lax.fori_loop(0, niters, body, (u0, u0, z, z, qs0))
    return jnp.clip(jnp.round(u * 255.0), 0, 255).astype(jnp.uint8)


def tv_l1_energy(u: np.ndarray, observations: Sequence[np.ndarray],
                 lam: float = 1.0) -> float:
    """The objective being minimized (for tests/diagnostics)."""
    uf = np.asarray(u, np.float64) / 255.0
    gx, gy = _grad_np(uf)
    e = float(np.sqrt(gx * gx + gy * gy).sum())
    for f in observations:
        e += lam * float(np.abs(uf - np.asarray(f, np.float64)
                                / 255.0).sum())
    return e
