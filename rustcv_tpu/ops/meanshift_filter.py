"""Mean-shift color filtering / posterization (OpenCV
``pyrMeanShiftFiltering`` role, Comaniciu & Meer).

The reference has no segmentation-by-filtering; OpenCV-parity addition.

Device formulation: every pixel carries a (position, color) state that
drifts toward its joint spatial-color mode. One iteration = a loop over
the (2·sp+1)² window offsets; each offset contributes ONE whole-image
nearest-neighbor gather (flat ``jnp.take`` at the per-pixel rounded
position + static offset) gated by the color-distance test — the state
update is then pure elementwise means. Iterations unroll (≤ max_iter);
per-pixel convergence freezes a pixel's state via ``jnp.where`` (no
data-dependent control flow). This is a gather-heavy op by nature (the
windows MOVE per pixel — the repo's shifted-view tricks don't apply);
it is a parity op, not a hot-path one.

Frozen spec (float64 oracle = the same vectorized formulation in
NumPy):
- pyramid: ``max_level`` halvings by ``[::2, ::2]`` decimation of the
  u8 image; levels processed coarse → fine; at each finer level every
  pixel's INITIAL color is the coarser result's color at its parent
  pixel (position restarts at the pixel itself);
- window membership: ``q ∈ B((py, px), sp)`` (rounded centre, clamped
  at borders — out-of-image offsets clamp to the edge pixel) AND
  ``Σ_c (I_c(q) − c_c)² ≤ sr²``;
- update: means of member positions / colors (the centre pixel always
  qualifies only if it passes the color test; an empty member set
  leaves the state unchanged);
- convergence: ``(Δpy)² + (Δpx)² ≤ 0.25`` and ``Σ_c Δc_c² ≤ 1.0``
  freezes the pixel; ``max_iter`` = 5;
- output: final colors rounded half-up to u8.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp


def _ms_level(img_f, init_c, sp: int, sr: float, max_iter: int, xp):
    """One pyramid level, vectorized over all pixels. ``img_f``
    [H, W, 3] float; ``init_c`` [H, W, 3] float initial colors."""
    h, w = img_f.shape[:2]
    flat = img_f.reshape(-1, 3)
    ys, xs = xp.meshgrid(xp.arange(h), xp.arange(w), indexing="ij")
    py = ys.astype(flat.dtype)
    px = xs.astype(flat.dtype)
    c = init_c
    frozen = xp.zeros((h, w), bool)
    sr2 = sr * sr
    for _ in range(max_iter):
        cy = xp.clip(xp.floor(py + 0.5), 0, h - 1).astype(xp.int32)
        cx = xp.clip(xp.floor(px + 0.5), 0, w - 1).astype(xp.int32)
        sum_y = xp.zeros((h, w), flat.dtype)
        sum_x = xp.zeros((h, w), flat.dtype)
        sum_c = xp.zeros((h, w, 3), flat.dtype)
        cnt = xp.zeros((h, w), flat.dtype)
        for dy in range(-sp, sp + 1):
            qy = xp.clip(cy + dy, 0, h - 1)
            for dx in range(-sp, sp + 1):
                qx = xp.clip(cx + dx, 0, w - 1)
                vals = xp.take(flat, qy * w + qx, axis=0)
                d2 = ((vals - c) ** 2).sum(axis=-1)
                m = (d2 <= sr2).astype(flat.dtype)
                sum_y = sum_y + m * qy.astype(flat.dtype)
                sum_x = sum_x + m * qx.astype(flat.dtype)
                sum_c = sum_c + m[..., None] * vals
                cnt = cnt + m
        has = cnt > 0
        safe = xp.maximum(cnt, 1.0)
        ny = xp.where(has, sum_y / safe, py)
        nx = xp.where(has, sum_x / safe, px)
        nc = xp.where(has[..., None], sum_c / safe[..., None], c)
        move2 = (ny - py) ** 2 + (nx - px) ** 2
        dcol2 = ((nc - c) ** 2).sum(axis=-1)
        done = (move2 <= 0.25) & (dcol2 <= 1.0)
        py = xp.where(frozen, py, ny)
        px = xp.where(frozen, px, nx)
        c = xp.where(frozen[..., None], c, nc)
        frozen = frozen | done
    return c


def _ms_level_jax(img_f, init_c, sp: int, sr, max_iter: int):
    """JAX twin of :func:`_ms_level`: identical arithmetic in the same
    accumulation order, but the (2·sp+1)² offset loop and the iteration
    loop are ``lax.scan``s instead of Python unrolls — the unrolled form
    emitted one gather HLO per offset per iteration per level (726 at
    sp=5/iters=3/2 levels) and took XLA >10 min to compile; the scanned
    program compiles in seconds and returns
    bit-identical f32 results (same adds, same order)."""
    h, w = img_f.shape[:2]
    flat = img_f.reshape(-1, 3)
    ys, xs = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
    sr2 = jnp.float32(sr) * jnp.float32(sr)
    offs = jnp.asarray(
        [(dy, dx) for dy in range(-sp, sp + 1) for dx in range(-sp, sp + 1)],
        jnp.int32)

    def one_iter(state, _):
        py, px, c, frozen = state
        cy = jnp.clip(jnp.floor(py + 0.5), 0, h - 1).astype(jnp.int32)
        cx = jnp.clip(jnp.floor(px + 0.5), 0, w - 1).astype(jnp.int32)

        def one_off(acc, off):
            sum_y, sum_x, sum_c, cnt = acc
            qy = jnp.clip(cy + off[0], 0, h - 1)
            qx = jnp.clip(cx + off[1], 0, w - 1)
            vals = jnp.take(flat, qy * w + qx, axis=0)
            d2 = ((vals - c) ** 2).sum(axis=-1)
            m = (d2 <= sr2).astype(flat.dtype)
            return (sum_y + m * qy.astype(flat.dtype),
                    sum_x + m * qx.astype(flat.dtype),
                    sum_c + m[..., None] * vals,
                    cnt + m), None

        zero = jnp.zeros((h, w), flat.dtype)
        (sum_y, sum_x, sum_c, cnt), _ = jax.lax.scan(
            one_off, (zero, zero, jnp.zeros((h, w, 3), flat.dtype), zero),
            offs)
        has = cnt > 0
        safe = jnp.maximum(cnt, 1.0)
        ny = jnp.where(has, sum_y / safe, py)
        nx = jnp.where(has, sum_x / safe, px)
        nc = jnp.where(has[..., None], sum_c / safe[..., None], c)
        move2 = (ny - py) ** 2 + (nx - px) ** 2
        dcol2 = ((nc - c) ** 2).sum(axis=-1)
        done = (move2 <= 0.25) & (dcol2 <= 1.0)
        py = jnp.where(frozen, py, ny)
        px = jnp.where(frozen, px, nx)
        c = jnp.where(frozen[..., None], c, nc)
        return (py, px, c, frozen | done), None

    state0 = (ys.astype(flat.dtype), xs.astype(flat.dtype), init_c,
              jnp.zeros((h, w), bool))
    (py, px, c, frozen), _ = jax.lax.scan(one_iter, state0, None,
                                          length=max_iter)
    return c


def _run(img: np.ndarray, sp: int, sr: float, max_level: int,
         max_iter: int, xp):
    levels = [xp.asarray(img)]
    for _ in range(max_level):
        levels.append(levels[-1][::2, ::2])
    dtype = xp.float64 if xp is np else xp.float32
    out_c = None
    for lv in range(len(levels) - 1, -1, -1):
        im = levels[lv].astype(dtype)
        if out_c is None:
            init = im.copy() if xp is np else im
        else:
            h, w = im.shape[:2]
            init = out_c[
                xp.minimum(xp.arange(h) // 2, out_c.shape[0] - 1)][:,
                xp.minimum(xp.arange(w) // 2, out_c.shape[1] - 1)]
        if xp is np:
            out_c = _ms_level(im, init, sp, sr, max_iter, xp)
        else:
            out_c = _ms_level_jax(im, init, sp, sr, max_iter)
    res = xp.clip(xp.floor(out_c + 0.5), 0, 255)
    return res.astype(xp.uint8)


def pyr_mean_shift_numpy(img: np.ndarray, sp: int = 10, sr: float = 25.0,
                         max_level: int = 1,
                         max_iter: int = 5) -> np.ndarray:
    """Oracle — float64 NumPy. u8 (H, W, 3) → posterized u8."""
    return _run(np.asarray(img), sp, sr, max_level, max_iter, np)


@partial(jax.jit, static_argnames=("sp", "max_level", "max_iter"))
def pyr_mean_shift(img: jax.Array, sp: int = 10, sr: float = 25.0,
                   max_level: int = 1, max_iter: int = 5) -> jax.Array:
    """Device twin — f32; color-gate decisions can flip on ties, so the
    contract is distributional (≥99% of pixels within ±1), not exact."""
    return _run(img, sp, jnp.float32(sr), max_level, max_iter, jnp)
