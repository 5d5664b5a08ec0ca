"""SLIC superpixels (OpenCV ``ximgproc.createSuperpixelSLIC`` role).

Frozen spec (slic_numpy, float64): classic SLIC restricted to the 3×3
cell neighborhood — each pixel considers the 9 clusters whose home
cells surround its own (equivalent coverage to the paper's 2S×2S
search window), distance D² = ‖Δcolor‖² + (ruler/S)²·‖Δxy‖², centers
initialized to block means, 10 Lloyd iterations, then a host
connectivity pass that absorbs islands smaller than S²/4 into the
neighbor with the longest shared boundary.

Device formulation (GATHER- AND SCATTER-FREE — the repo's recurring
lesson): the image is padded to integer multiples of S so every cell
is an S×S block. Per-pixel candidate centers come from
``jnp.repeat``-upsampled center maps rolled by the 9 offsets (pure
layout ops); the argmin assignment is elementwise; the center UPDATE
inverts the roll: for each offset o, the masked block-sum
(reshape (gh,S,gw,S) → sum) of pixels choosing offset o is rolled by
−o and accumulated — a segment-sum with no scatter. The whole
iteration is a fori_loop body of ~30 fused elementwise/layout HLOs.

The connectivity pass stays on the host (pointer-chasing, the
GrabCut/CCL escape precedent).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

_OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def _prep(img: np.ndarray) -> np.ndarray:
    a = np.asarray(img)
    if a.ndim == 2:
        a = a[..., None]
    return a.astype(np.float64)


def _pad_to(a, s: int, xp):
    h, w = a.shape[:2]
    ph = (-h) % s
    pw = (-w) % s
    if ph or pw:
        a = xp.pad(a, ((0, ph), (0, pw), (0, 0)), mode="edge")
    return a


def slic_numpy(img: np.ndarray, region_size: int = 20, ruler: float = 10.0,
               num_iterations: int = 10) -> np.ndarray:
    """Oracle — raw labels (H, W) int32 = home-cell index of the
    assigned cluster (before connectivity enforcement)."""
    feat = _prep(img)
    h0, w0 = feat.shape[:2]
    s = int(region_size)
    feat = _pad_to(feat, s, np)
    h, w, c = feat.shape
    gh, gw = h // s, w // s
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    fxy = np.stack([ys, xs], -1)
    wxy = (ruler / s) ** 2

    # centers = block means of (feat, xy)
    def block_mean(a):
        return a.reshape(gh, s, gw, s, -1).mean(axis=(1, 3))

    cf = block_mean(feat)                      # (gh, gw, c)
    cxy = block_mean(fxy)                      # (gh, gw, 2)

    lab_off = np.zeros((h, w), np.int64)
    for _ in range(num_iterations):
        best = np.full((h, w), np.inf)
        lab_off = np.zeros((h, w), np.int64)
        for oi, (dy, dx) in enumerate(_OFFSETS):
            # candidate center of cell (home+o) per pixel, invalid → inf
            ccf = np.roll(cf, (-dy, -dx), axis=(0, 1))
            ccxy = np.roll(cxy, (-dy, -dx), axis=(0, 1))
            pcf = ccf.repeat(s, 0).repeat(s, 1)
            pcxy = ccxy.repeat(s, 0).repeat(s, 1)
            d = (((feat - pcf) ** 2).sum(-1)
                 + wxy * ((fxy - pcxy) ** 2).sum(-1))
            gy = np.arange(gh)[:, None] + dy
            gx = np.arange(gw)[None, :] + dx
            invalid = ((gy < 0) | (gy >= gh) | (gx < 0) | (gx >= gw))
            d = np.where(invalid.repeat(s, 0).repeat(s, 1), np.inf, d)
            better = d < best
            best = np.where(better, d, best)
            lab_off = np.where(better, oi, lab_off)
        # update: masked block sums rolled back
        sf = np.zeros_like(cf)
        sxy = np.zeros_like(cxy)
        cnt = np.zeros((gh, gw, 1))
        for oi, (dy, dx) in enumerate(_OFFSETS):
            m = (lab_off == oi)[..., None].astype(np.float64)
            bs_f = (feat * m).reshape(gh, s, gw, s, c).sum(axis=(1, 3))
            bs_xy = (fxy * m).reshape(gh, s, gw, s, 2).sum(axis=(1, 3))
            bs_n = m.reshape(gh, s, gw, s, 1).sum(axis=(1, 3))
            sf += np.roll(bs_f, (dy, dx), axis=(0, 1))
            sxy += np.roll(bs_xy, (dy, dx), axis=(0, 1))
            cnt += np.roll(bs_n, (dy, dx), axis=(0, 1))
        nz = cnt[..., 0] > 0
        cf = np.where(nz[..., None], sf / np.maximum(cnt, 1), cf)
        cxy = np.where(nz[..., None], sxy / np.maximum(cnt, 1), cxy)

    # final labels = home cell + chosen offset
    gy = (np.arange(h) // s)[:, None] + np.array(
        [dy for dy, _ in _OFFSETS])[lab_off].reshape(h, w)
    gx = (np.arange(w) // s)[None, :] + np.array(
        [dx for _, dx in _OFFSETS])[lab_off].reshape(h, w)
    labels = (gy * gw + gx).astype(np.int32)
    return labels[:h0, :w0]


@partial(jax.jit, static_argnames=("region_size", "num_iterations",
                                   "ruler"))
def slic_device(img: jax.Array, region_size: int = 20,
                ruler: float = 10.0, num_iterations: int = 10
                ) -> jax.Array:
    """Device twin — raw labels (H, W) int32 (same spec, f32)."""
    a = img
    if a.ndim == 2:
        a = a[..., None]
    feat = a.astype(jnp.float32)
    h0, w0 = feat.shape[:2]
    s = int(region_size)
    feat = _pad_to(feat, s, jnp)
    h, w, c = feat.shape
    gh, gw = h // s, w // s
    ys, xs = jnp.mgrid[0:h, 0:w]
    fxy = jnp.stack([ys, xs], -1).astype(jnp.float32)
    wxy = jnp.float32((ruler / s) ** 2)

    def block_mean(x):
        return x.reshape(gh, s, gw, s, -1).mean(axis=(1, 3))

    cf0 = block_mean(feat)
    cxy0 = block_mean(fxy)

    gy_cell = jnp.arange(gh)[:, None]
    gx_cell = jnp.arange(gw)[None, :]

    def assign(cf, cxy):
        best = jnp.full((h, w), jnp.inf, jnp.float32)
        lab = jnp.zeros((h, w), jnp.int32)
        for oi, (dy, dx) in enumerate(_OFFSETS):
            ccf = jnp.roll(cf, (-dy, -dx), axis=(0, 1))
            ccxy = jnp.roll(cxy, (-dy, -dx), axis=(0, 1))
            pcf = ccf.repeat(s, 0).repeat(s, 1)
            pcxy = ccxy.repeat(s, 0).repeat(s, 1)
            d = (((feat - pcf) ** 2).sum(-1)
                 + wxy * ((fxy - pcxy) ** 2).sum(-1))
            invalid = ((gy_cell + dy < 0) | (gy_cell + dy >= gh)
                       | (gx_cell + dx < 0) | (gx_cell + dx >= gw))
            d = jnp.where(invalid.repeat(s, 0).repeat(s, 1), jnp.inf, d)
            better = d < best
            best = jnp.where(better, d, best)
            lab = jnp.where(better, oi, lab)
        return lab

    def body(_, carry):
        cf, cxy = carry
        lab = assign(cf, cxy)
        sf = jnp.zeros_like(cf)
        sxy = jnp.zeros_like(cxy)
        cnt = jnp.zeros((gh, gw, 1), jnp.float32)
        for oi, (dy, dx) in enumerate(_OFFSETS):
            m = (lab == oi)[..., None].astype(jnp.float32)
            bs_f = (feat * m).reshape(gh, s, gw, s, c).sum(axis=(1, 3))
            bs_xy = (fxy * m).reshape(gh, s, gw, s, 2).sum(axis=(1, 3))
            bs_n = m.reshape(gh, s, gw, s, 1).sum(axis=(1, 3))
            sf = sf + jnp.roll(bs_f, (dy, dx), axis=(0, 1))
            sxy = sxy + jnp.roll(bs_xy, (dy, dx), axis=(0, 1))
            cnt = cnt + jnp.roll(bs_n, (dy, dx), axis=(0, 1))
        nz = cnt[..., 0] > 0
        cf = jnp.where(nz[..., None], sf / jnp.maximum(cnt, 1), cf)
        cxy = jnp.where(nz[..., None], sxy / jnp.maximum(cnt, 1), cxy)
        return cf, cxy

    cf, cxy = jax.lax.fori_loop(0, num_iterations, body, (cf0, cxy0))
    lab = assign(cf, cxy)
    offs = jnp.asarray(_OFFSETS, jnp.int32)
    gy = (jnp.arange(h) // s)[:, None] + offs[lab, 0]
    gx = (jnp.arange(w) // s)[None, :] + offs[lab, 1]
    return (gy * gw + gx).astype(jnp.int32)[:h0, :w0]


def enforce_connectivity(labels: np.ndarray, min_size: int
                         ) -> Tuple[np.ndarray, int]:
    """Host finishing pass: split disconnected label fragments, absorb
    components < min_size into the adjacent component sharing the
    longest boundary, then compact label ids → (labels, n)."""
    h, w = labels.shape
    comp = np.full((h, w), -1, np.int64)
    sizes = []
    stack = []
    n = 0
    for y0 in range(h):
        for x0 in range(w):
            if comp[y0, x0] >= 0:
                continue
            lv = labels[y0, x0]
            stack.append((y0, x0))
            comp[y0, x0] = n
            count = 0
            while stack:
                y, x = stack.pop()
                count += 1
                for yy, xx in ((y - 1, x), (y + 1, x), (y, x - 1),
                               (y, x + 1)):
                    if (0 <= yy < h and 0 <= xx < w
                            and comp[yy, xx] < 0
                            and labels[yy, xx] == lv):
                        comp[yy, xx] = n
                        stack.append((yy, xx))
            sizes.append(count)
            n += 1
    sizes = np.asarray(sizes)
    # absorb small components into the 4-neighbor component with the
    # longest shared boundary (iterate until stable; small counts)
    for _ in range(4):
        small = np.nonzero(sizes < min_size)[0]
        if len(small) == 0:
            break
        small_set = set(int(sid) for sid in small)
        contact: dict = {}
        for y in range(h):
            for x in range(w):
                a = int(comp[y, x])
                if a not in small_set:
                    continue
                for yy, xx in ((y + 1, x), (y, x + 1), (y - 1, x),
                               (y, x - 1)):
                    if 0 <= yy < h and 0 <= xx < w:
                        b = int(comp[yy, xx])
                        if b != a:
                            contact[(a, b)] = contact.get((a, b), 0) + 1
        merged = False
        for sid in small:
            cands = [(cnt, b) for (a, b), cnt in contact.items()
                     if a == sid]
            if not cands:
                continue
            _, tgt = max(cands)
            comp[comp == sid] = tgt
            sizes[tgt] += sizes[sid]
            sizes[sid] = 0
            merged = True
        if not merged:
            break
        # recompact ids
        uniq, comp = np.unique(comp, return_inverse=True)
        comp = comp.reshape(h, w)
        new_sizes = np.bincount(comp.ravel())
        sizes = new_sizes
    uniq, comp = np.unique(comp, return_inverse=True)
    return comp.reshape(h, w).astype(np.int32), int(len(uniq))


def slic_superpixels(img, region_size: int = 20, ruler: float = 10.0,
                     num_iterations: int = 10,
                     enforce: bool = True) -> Tuple[np.ndarray, int]:
    """→ (labels (H, W) int32 compact ids, n_superpixels). Accepts
    numpy (oracle path) or jax arrays (device path + host finish)."""
    if isinstance(img, np.ndarray):
        raw = slic_numpy(img, region_size, ruler, num_iterations)
    else:
        raw = np.asarray(slic_device(img, region_size, ruler,
                                     num_iterations))
    if not enforce:
        uniq, inv = np.unique(raw, return_inverse=True)
        return inv.reshape(raw.shape).astype(np.int32), len(uniq)
    return enforce_connectivity(raw, (region_size * region_size) // 4)
