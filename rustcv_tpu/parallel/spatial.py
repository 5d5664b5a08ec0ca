"""Spatial parallelism — shard ONE frame's rows across devices.

The stream axis is the natural data-parallel axis (parallel/mesh.py), but a
single huge frame (8K stitch, microscopy scan) can also be split: each device
owns a horizontal band and stencils exchange 3-row halos with neighbors via
``lax.ppermute`` — the image-domain analog of blockwise sequence
parallelism (SURVEY §5 "long-context analog"). Nothing like this exists in
the reference (single-process, CPU loops).

Border discipline is bit-exact with the golden chain: the Gaussian
replicates the ORIGINAL image at the global border and Sobel replicates the
BLURRED image at its border (the two-stage rule), so global-edge devices
substitute replicated rows for the missing halo and patch the blurred edge
row before the Sobel taps. Interior bands consume true neighbor rows — the
result equals the single-device kernel exactly, tested on the virtual mesh.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from ..ops.filters import GAUSS5, HALO  # one source of truth for radii


def _taps(a, weights, axis, start, size):
    acc = None
    for k, wgt in enumerate(weights):
        if wgt == 0:
            continue
        sl = jax.lax.slice_in_dim(a, start + k, start + k + size, axis=axis)
        term = sl if wgt == 1 else wgt * sl
        acc = term if acc is None else acc + term
    return acc


def _band_blur_sobel(g, axis_name: str, n_dev: int):
    """Local band [N, band, W] → |∇| u8, with ppermute halo exchange."""
    idx = jax.lax.axis_index(axis_name)
    band = g.shape[-2]
    w = g.shape[-1]

    # Halo exchange between neighbouring devices: my top rows go to the device above (becoming
    # its bottom halo) and vice versa. Unpaired devices receive zeros and
    # substitute global-edge replication below.
    fwd = [(i, i + 1) for i in range(n_dev - 1)]   # i's bottom rows → i+1
    bwd = [(i + 1, i) for i in range(n_dev - 1)]   # i+1's top rows → i
    top_halo = jax.lax.ppermute(g[:, -HALO:, :], axis_name, perm=fwd)
    bot_halo = jax.lax.ppermute(g[:, :HALO, :], axis_name, perm=bwd)
    top_rep = jnp.repeat(g[:, :1, :], HALO, axis=1)   # global top: replicate
    bot_rep = jnp.repeat(g[:, -1:, :], HALO, axis=1)  # global bottom
    top = jnp.where(idx == 0, top_rep, top_halo)
    bot = jnp.where(idx == n_dev - 1, bot_rep, bot_halo)
    a = jnp.concatenate([top, g, bot], axis=1).astype(jnp.int32)  # band+6 rows

    # Columns: replicate-pad by 2 (Gaussian) — global in W (not sharded).
    a = jnp.concatenate([a[..., :1], a[..., :1], a, a[..., -1:], a[..., -1:]], axis=-1)

    # Gaussian at centers rows [-1, band+1) (array row c+3, taps c+1..c+5 →
    # start 0), cols [0, w).
    tmp = _taps(a, GAUSS5, axis=-1, start=0, size=w)
    blur = (_taps(tmp, GAUSS5, axis=-2, start=0, size=band + 2) + 128) >> 8

    # Two-stage border rule at GLOBAL edges: Sobel must see the replicated
    # BLURRED edge row, not a blur of replicated originals.
    row = jax.lax.broadcasted_iota(jnp.int32, blur.shape, blur.ndim - 2)
    blur = jnp.where((idx == 0) & (row == 0), blur[:, 1:2, :], blur)
    blur = jnp.where(
        (idx == n_dev - 1) & (row == band + 1), blur[:, band : band + 1, :], blur
    )

    # Sobel (3×3) over blurred rows [0, band), cols replicate-padded by 1.
    b = jnp.concatenate([blur[..., :1], blur, blur[..., -1:]], axis=-1)
    smooth_v = _taps(b, (1, 2, 1), axis=-2, start=0, size=band)
    diff_v = _taps(b, (-1, 0, 1), axis=-2, start=0, size=band)
    gx = _taps(smooth_v, (-1, 0, 1), axis=-1, start=0, size=w)
    gy = _taps(diff_v, (1, 2, 1), axis=-1, start=0, size=w)

    mag2 = gx * gx + gy * gy
    s = jnp.sqrt(mag2.astype(jnp.float32)).astype(jnp.int32)
    s = jnp.where((s + 1) * (s + 1) <= mag2, s + 1, s)
    s = jnp.where(s * s > mag2, s - 1, s)
    return jnp.minimum(s, 255).astype(jnp.uint8)


@lru_cache(maxsize=8)
def _spatial_fn(mesh: Mesh, axis: str, n_dev: int):
    """Cached jitted shard_map program per (mesh, axis) — rebuilding the
    shard_map wrapper per call re-traced eagerly (~127 XLA compilations per
    warm call, measured); the jit wrapper compiles once per input shape."""
    return jax.jit(
        shard_map(
            partial(_band_blur_sobel, axis_name=axis, n_dev=n_dev),
            mesh=mesh,
            in_specs=P(None, axis, None),
            out_specs=P(None, axis, None),
        )
    )


@lru_cache(maxsize=8)
def _spatial2d_fn(mesh: Mesh, saxis: str, raxis: str, n_rows: int):
    return jax.jit(
        shard_map(
            partial(_band_blur_sobel, axis_name=raxis, n_dev=n_rows),
            mesh=mesh,
            in_specs=P(saxis, raxis, None),
            out_specs=P(saxis, raxis, None),
        )
    )


def blur_sobel_mag_spatial_2d(gray: jax.Array, mesh: Mesh) -> jax.Array:
    """Fused Gaussian5+Sobel+|∇| on a 2-D (streams × rows) mesh: the batch
    axis shards over ``stream`` (pure DP, no collectives) AND each frame's
    rows shard over ``rows`` with ppermute halo exchange — both mesh axes
    working in one program (the composed tp/sp-style layout the 1-D paths
    exercise separately). ``gray``: u8 [N, H, W]; N divides the stream
    axis, H the rows axis (each band ≥ HALO rows). Bit-exact with the
    single-device golden chain."""
    if len(mesh.axis_names) != 2:
        raise ValueError(
            f"2-D spatial sharding expects a 2-axis mesh, got {mesh.axis_names}"
        )
    saxis, raxis = mesh.axis_names
    n_s = int(mesh.shape[saxis])
    n_r = int(mesh.shape[raxis])
    if gray.ndim != 3:
        raise ValueError(f"expected [N, H, W], got shape {gray.shape}")
    if gray.shape[0] % n_s != 0:
        raise ValueError(f"N={gray.shape[0]} must divide over {n_s} stream groups")
    if gray.shape[-2] % n_r != 0:
        raise ValueError(f"H={gray.shape[-2]} must divide over {n_r} row bands")
    if gray.shape[-2] // n_r < HALO:
        raise ValueError(
            f"band height {gray.shape[-2] // n_r} < halo {HALO}: use fewer "
            "row devices for this image height"
        )
    return _spatial2d_fn(mesh, saxis, raxis, n_r)(gray)


def blur_sobel_mag_spatial(gray: jax.Array, mesh: Mesh) -> jax.Array:
    """Fused Gaussian5+Sobel+|∇| with the ROW axis sharded across the mesh.

    ``gray``: u8 [N, H, W] (or [H, W]); H must divide evenly by the (1-D)
    mesh size and each band must be at least HALO rows. Bit-exact with the
    single-device golden chain.
    """
    squeeze = gray.ndim == 2
    if squeeze:
        gray = gray[None]
    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"spatial sharding expects a 1-D mesh, got axes {mesh.axis_names}"
        )
    axis = mesh.axis_names[0]
    n_dev = int(mesh.shape[axis])
    if gray.shape[-2] % n_dev != 0:
        raise ValueError(
            f"H={gray.shape[-2]} must divide evenly over {n_dev} devices"
        )
    if gray.shape[-2] // n_dev < HALO:
        raise ValueError(
            f"band height {gray.shape[-2] // n_dev} < halo {HALO}: use fewer "
            "devices for this image height"
        )
    out = _spatial_fn(mesh, axis, n_dev)(gray)
    return out[0] if squeeze else out
