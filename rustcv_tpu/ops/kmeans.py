"""k-means clustering — both halves of Lloyd's iteration as matmuls.

OpenCV ``kmeans`` role (the classic vision use: color quantization).
accelerator-native: the assignment step is a distance matmul
(‖x‖² − 2·X@Cᵀ + ‖c‖², argmin over K) and the update step is a one-hot
segment-mean (onehot[K, N] @ X[N, D]) — no scatter, no per-point loops;
iterations run under ``lax.fori_loop`` in one compiled program.

Deterministic: the default init is seeded k-means++ on the host (a
subsample for large N); pass ``init_centers`` to override.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp


def kmeans_pp_init(data: np.ndarray, k: int, seed: int = 7,
                   sample: int = 4096) -> np.ndarray:
    """Seeded k-means++ seeding on the host (over a subsample for large
    N) — deterministic and robust where spaced/random picks collapse."""
    rng = np.random.default_rng(seed)
    x = np.asarray(data, np.float64)
    if len(x) > sample:
        x = x[rng.choice(len(x), sample, replace=False)]
    centers = [x[rng.integers(len(x))]]
    for _ in range(1, k):
        d2 = np.min(
            ((x[:, None, :] - np.array(centers)[None]) ** 2).sum(-1), axis=1
        )
        tot = d2.sum()
        if tot <= 0:
            centers.append(x[rng.integers(len(x))])
            continue
        centers.append(x[rng.choice(len(x), p=d2 / tot)])
    return np.array(centers, np.float32)


def kmeans(data, k: int, iters: int = 10, init_centers=None):
    """[N, D] float32 → (centers [k, D] f32, labels [N] int32, inertia
    f32). Default init: seeded k-means++ (host — pass host data or
    ``init_centers`` to avoid a D2H fetch of device arrays)."""
    if init_centers is None:
        init_centers = kmeans_pp_init(np.asarray(data), k)
    return _kmeans_device(
        jnp.asarray(data), jnp.asarray(init_centers, jnp.float32), iters
    )


@partial(jax.jit, static_argnames=("iters",))
def _kmeans_device(data: jax.Array, c0: jax.Array, iters: int = 10):
    """Lloyd iterations; empty clusters keep their previous center (no
    reseeding — branch-free program)."""
    x = data.astype(jnp.float32)
    k = c0.shape[0]
    x2 = jnp.sum(x * x, axis=1, keepdims=True)  # [N, 1]

    def assign(c):
        d = (
            x2
            - 2.0 * jax.lax.dot(x, c.T, precision=jax.lax.Precision.HIGHEST)
            + jnp.sum(c * c, axis=1)[None, :]
        )
        return jnp.argmin(d, axis=1).astype(jnp.int32), d

    def body(_, c):
        lab, _ = assign(c)
        oh = (lab[None, :] == jnp.arange(k)[:, None]).astype(jnp.float32)
        sums = jax.lax.dot(oh, x, precision=jax.lax.Precision.HIGHEST)
        counts = oh.sum(axis=1, keepdims=True)
        return jnp.where(counts > 0, sums / jnp.maximum(counts, 1.0), c)

    c = jax.lax.fori_loop(0, iters, body, c0)
    lab, d = assign(c)
    inertia = jnp.sum(jnp.take_along_axis(d, lab[:, None], axis=1))
    return c, lab, inertia


def kmeans_quantize(bgr, k: int = 8, iters: int = 10) -> Tuple[np.ndarray, np.ndarray]:
    """Color quantization: (H, W, 3) u8 → (quantized u8 image with ≤ k
    colors, palette [k, 3] u8)."""
    a = np.asarray(bgr)
    h, w = a.shape[:2]
    host_flat = a.reshape(-1, 3).astype(np.float32)
    init = kmeans_pp_init(host_flat, k)  # init from HOST bytes (no D2H)
    centers, labels, _ = kmeans(jnp.asarray(host_flat), k, iters, init_centers=init)
    pal = np.clip(np.round(np.asarray(centers)), 0, 255).astype(np.uint8)
    out = pal[np.asarray(labels)].reshape(h, w, 3)
    return out, pal


def kmeans_numpy(data: np.ndarray, k: int, iters: int = 10,
                 init_centers=None):
    """Float64 oracle (same init and update rules)."""
    x = data.astype(np.float64)
    n = len(x)
    c = (
        np.asarray(init_centers, np.float64).copy()
        if init_centers is not None
        else kmeans_pp_init(x, k).astype(np.float64)
    )
    for _ in range(iters):
        d = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
        lab = d.argmin(1)
        for j in range(k):
            sel = lab == j
            if sel.any():
                c[j] = x[sel].mean(0)
    d = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    lab = d.argmin(1)
    return c, lab, d[np.arange(n), lab].sum()
