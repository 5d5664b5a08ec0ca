"""MSER — maximally stable extremal regions (OpenCV ``MSER`` role).

The reference has no feature detectors; OpenCV-parity addition. MSER is
a component-tree algorithm — per-pixel union-find with data-dependent
merge history, the one shape a device cannot express (the CCL/GrabCut
precedent) — so the hot path is native C++ (native/mser.cpp) with this
module holding the frozen Python spec, the shared region extraction,
and the public API. Native and spec emit IDENTICAL (seed, level, area)
triples (tests/test_mser.py pins this); pixel sets then come from one
connected-components pass per distinct level (device/native CCL).

Frozen spec (deterministic; divergences from OpenCV's grow-history
implementation are by design and documented):
- Pixels activate in increasing (gray, flat index) order; 4-adjacent
  active pixels union. On union the identity with the LARGER current
  area absorbs (tie: smaller seed flat index). An identity records its
  birth level, seed (first pixel), area history at its area-change
  levels, and (absorber, level) when absorbed.
- A(I, g) = identity I's area at level g: its last recorded area at
  ≤ g after chasing absorber links for levels past its death; levels
  below birth clamp to the birth area.
- variation(I, g) = (A(chase(I, g), g+Δ) − A(I, max(g−Δ, birth)))
  / A(I, g), evaluated at I's area-change levels only.
- Candidate: min_area ≤ A ≤ max_area, variation ≤ max_variation, and
  variation is a local minimum over the identity's consecutive
  evaluated levels (single evaluation points qualify).
- Diversity: candidates sorted by (variation, −area, seed, level);
  greedily accepted unless nested with an accepted candidate whose
  relative area difference |A_i − A_j| / max(A_i, A_j) is below
  min_diversity. Nesting: I ⊆ J iff chase(I, level_J) == J.
- MSER− (bright-on-dark) = the same procedure on 255 − gray.

Result contract: list of (seed_flat, level, area) sorted by
(seed, level); the public API converts to point lists + bboxes.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import List, Tuple

import numpy as np


class _Identity:
    __slots__ = ("birth", "seed", "levels", "areas", "absorber",
                 "absorb_level")

    def __init__(self, birth: int, seed: int):
        self.birth = birth
        self.seed = seed
        self.levels: List[int] = []
        self.areas: List[int] = []
        self.absorber = -1
        self.absorb_level = -1


def _mser_triples_spec(gray: np.ndarray, delta: int, min_area: int,
                       max_area: int, max_variation: float,
                       min_diversity: float):
    """The frozen spec: (seed, level, area) triples (see module doc)."""
    g = np.asarray(gray, np.uint8)
    h, w = g.shape
    n = h * w
    flat = g.reshape(-1).astype(np.int64)
    order = np.argsort(flat, kind="stable")  # (gray, flat idx) ascending

    parent = np.full(n, -1, np.int64)   # -1 = inactive; else uf parent
    root_ident = {}                     # root pixel -> identity index
    root_area = {}                      # root pixel -> current area
    idents: List[_Identity] = []

    def find(x):
        r = x
        while parent[r] != r:
            r = parent[r]
        while parent[x] != r:
            parent[x], x = r, parent[x]
        return r

    # counting-sort boundaries per level
    level_of = flat[order]
    touched: List[int] = []             # identities dirty this level

    pos = 0
    for level in range(256):
        end = pos + int(np.searchsorted(level_of[pos:], level + 1))
        for k in range(pos, end):
            p = int(order[k])
            parent[p] = p
            ident = len(idents)
            idents.append(_Identity(level, p))
            root_ident[p] = ident
            root_area[p] = 1
            touched.append(ident)
            y, x = divmod(p, w)
            for q in (p - w if y > 0 else -1, p + w if y + 1 < h else -1,
                      p - 1 if x > 0 else -1, p + 1 if x + 1 < w else -1):
                if q < 0 or parent[q] < 0:
                    continue
                ra, rb = find(p), find(q)
                if ra == rb:
                    continue
                ia, ib = root_ident[ra], root_ident[rb]
                aa, ab = root_area[ra], root_area[rb]
                # larger area absorbs; tie → smaller seed
                if (ab, -idents[ib].seed) > (aa, -idents[ia].seed):
                    ra, rb, ia, ib, aa, ab = rb, ra, ib, ia, ab, aa
                parent[rb] = ra
                root_area[ra] = aa + ab
                del root_area[rb], root_ident[rb]
                idents[ib].absorber = ia
                idents[ib].absorb_level = level
                touched.append(ia)
        pos = end
        # record area-change points for identities touched this level
        if touched:
            seen = set()
            for ident in touched:
                if ident in seen:
                    continue
                seen.add(ident)
                it = idents[ident]
                if it.absorber >= 0 and it.absorb_level == level:
                    continue  # died this level; history ends before
                # find the identity's current root area
                r = find(it.seed)
                if root_ident.get(r) != ident:
                    continue  # absorbed transitively
                a = root_area[r]
                if not it.areas or it.areas[-1] != a:
                    it.levels.append(level)
                    it.areas.append(a)
            touched.clear()
        if pos >= n:
            # flush remaining levels: areas no longer change
            break

    def chase(ident: int, level: int) -> int:
        it = idents[ident]
        while it.absorber >= 0 and it.absorb_level <= level:
            ident = it.absorber
            it = idents[ident]
        return ident

    def area_at(ident: int, level: int) -> int:
        ident = chase(ident, level)
        it = idents[ident]
        if level < it.birth:
            level = it.birth
        i = bisect_right(it.levels, level) - 1
        if i < 0:
            return it.areas[0] if it.areas else 1
        return it.areas[i]

    # --- stability scan over each identity's change points --------------
    cands = []  # (var, -area, seed, level, ident)
    for idx, it in enumerate(idents):
        if not it.levels:
            continue
        vs = []
        for lv in it.levels:
            a_hi = area_at(idx, min(lv + delta, 255))
            a_lo = area_at(idx, max(lv - delta, it.birth))
            a = area_at(idx, lv)
            vs.append((a_hi - a_lo) / a)
        for i, lv in enumerate(it.levels):
            if vs[i] > max_variation:
                continue
            a = it.areas[i]
            if not (min_area <= a <= max_area):
                continue
            if i > 0 and vs[i] > vs[i - 1]:
                continue
            if i + 1 < len(vs) and vs[i] > vs[i + 1]:
                continue
            cands.append((vs[i], -a, it.seed, lv, idx))

    # --- diversity pruning ----------------------------------------------
    cands.sort()
    accepted: List[Tuple[int, int, int, int]] = []  # (ident, level, area, seed)
    for var, na, seed, lv, idx in cands:
        a = -na
        ok = True
        for jdx, jlv, ja, _ in accepted:
            nested = (lv <= jlv and chase(idx, jlv) == jdx) or \
                     (jlv <= lv and chase(jdx, lv) == idx)
            if nested and abs(a - ja) / max(a, ja) < min_diversity:
                ok = False
                break
        if ok:
            accepted.append((idx, lv, a, seed))
    out = [(seed, lv, a) for _, lv, a, seed in accepted]
    out.sort()
    return out


def mser_triples(gray: np.ndarray, delta: int = 5, min_area: int = 60,
                 max_area: int = 14400, max_variation: float = 0.25,
                 min_diversity: float = 0.2, use_native: bool = True):
    """(seed, level, area) triples per the frozen spec — native C++ when
    available (bit-identical; tests pin it), Python spec otherwise."""
    g = np.ascontiguousarray(np.asarray(gray, np.uint8))
    if use_native:
        from .. import native

        if native.available() and hasattr(native, "mser_triples"):
            res = native.mser_triples(g, delta, min_area, max_area,
                                      max_variation, min_diversity)
            if res is not None:
                return [tuple(int(v) for v in row) for row in res]
    return _mser_triples_spec(g, delta, min_area, max_area,
                              max_variation, min_diversity)


def mser_regions(gray, delta: int = 5, min_area: int = 60,
                 max_area: int = 14400, max_variation: float = 0.25,
                 min_diversity: float = 0.2, polarity: str = "both"):
    """Detect MSERs (OpenCV ``MSER.detectRegions`` role) → (regions,
    bboxes): regions = list of int32 (K, 2) (x, y) point arrays in
    raster order, bboxes = int32 (N, 4) (x, y, w, h). ``polarity``:
    "dark" (MSER+ on the gray image), "bright" (on its inversion), or
    "both" (dark first, then bright)."""
    from .ccl import connected_components

    g = np.asarray(gray, np.uint8)
    if g.ndim != 2:
        raise ValueError("mser_regions expects a gray image")
    if polarity not in ("dark", "bright", "both"):
        raise ValueError(f"unknown polarity {polarity!r}")
    images = []
    if polarity in ("dark", "both"):
        images.append(g)
    if polarity in ("bright", "both"):
        images.append((255 - g.astype(np.int32)).astype(np.uint8))
    regions, bboxes = [], []
    for img in images:
        triples = mser_triples(img, delta, min_area, max_area,
                               max_variation, min_diversity)
        labels_at = {lv: connected_components(img <= lv)[1]
                     for lv in {t[1] for t in triples}}
        for seed, lv, _area in triples:  # triple order preserved
            labels = labels_at[lv]
            sy, sx = divmod(seed, g.shape[1])
            ys, xs = np.nonzero(labels == labels[sy, sx])
            regions.append(np.stack([xs, ys], axis=1).astype(np.int32))
            x0, y0 = xs.min(), ys.min()
            bboxes.append((x0, y0, xs.max() - x0 + 1, ys.max() - y0 + 1))
    return regions, np.asarray(bboxes, np.int32).reshape(-1, 4)
