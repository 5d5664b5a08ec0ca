"""Marker-based watershed segmentation (the OpenCV ``watershed`` role).

Device formulation: watershed-by-bottleneck in TWO schedule-independent
phases (no priority queue, no pointer chasing):

1. **Costs** — every pixel's minimum-bottleneck cost to any seed (cost
   of a path = max intensity en route; c(seed) = I(seed)). The (min,
   max) bottleneck semiring IS associative, so directional
   ``associative_scan`` sweeps iterated in a ``lax.while_loop`` converge
   to the unique fixpoint (the CCL machinery in another semiring).
2. **Labels** — the smallest seed label that reaches each pixel along a
   bottleneck-OPTIMAL path: min-label propagation over the fixed edge
   set {q→p : max(c*(q), I(p)) = c*(p)}, via gated segmented min-scans
   (ccl.py's reset combiner with the gate as the segment break), again
   to fixpoint. Pure min over a fixed graph — unique fixpoint, so the
   result is deterministic and schedule-independent.

Why two phases: a fused (cost, label) packed key is NOT associative — at
equal-cost ties a dominated-at-q path can win on label downstream, so
any one-value-per-pixel DP is combination-order-dependent. Splitting
makes both phases true semiring computations with unique fixpoints.

Frozen spec:
- cost(p) = min over 4-connected paths from any seed of max(intensity
  along path, including both endpoints);
- label(p) = min label over seeds with a bottleneck-optimal path to p;
  seed pixels always keep their own marker value and are never ridge;
- output (OpenCV markers convention): -1 on watershed lines (a pixel
  whose LEFT or UP 4-neighbor carries a different positive label), else
  the region label; 0 only when there are no seeds at all;
- markers: int32 (H, W), 0 = unknown, positive labels = seeds.

Oracle: the same two fixpoints by plain Jacobi relaxation (both unique,
so the schedule difference cannot matter) — device matches exactly.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

_INF = jnp.int32(2**30)
MAX_LABEL = 2**30 - 1


def _cost_scan(cost: jax.Array, inten: jax.Array, axis: int, reverse: bool):
    """Bottleneck relaxation along ``axis`` (associative: max distributes
    over min for scalars)."""
    axis = axis % cost.ndim

    def comb(a, b):
        c1, m1 = a
        c2, m2 = b
        return jnp.minimum(c2, jnp.maximum(c1, m2)), jnp.maximum(m1, m2)

    c, _ = jax.lax.associative_scan(comb, (cost, inten), axis=axis,
                                    reverse=reverse)
    return c


def _gated_min_scan(vals: jax.Array, gate: jax.Array, axis: int, reverse: bool):
    """Min propagation that only flows across positions whose ``gate`` is
    set (gate(i) = edge from the previous position is valid)."""
    axis = axis % vals.ndim
    b0 = gate.astype(jnp.int32)

    def comb(a, b):
        m1, b1 = a
        m2, b2 = b
        m = jnp.minimum(m2, jnp.where(b2 > 0, m1, _INF))
        return m, b1 * b2

    m, _ = jax.lax.associative_scan(comb, (vals, b0), axis=axis, reverse=reverse)
    return m


def _fix(round_fn, init, max_rounds):
    def cond(s):
        i, cur, changed = s
        return (i < max_rounds) & changed

    def body(s):
        i, cur, _ = s
        nxt = round_fn(cur)
        return i + 1, nxt, jnp.any(nxt != cur)

    _, out, changed = jax.lax.while_loop(cond, body, (0, init, jnp.bool_(True)))
    return out, jnp.logical_not(changed)


@partial(jax.jit, static_argnames=("max_rounds",))
def _flood(gray: jax.Array, markers: jax.Array, max_rounds: int):
    inten = gray.astype(jnp.int32)
    seeded = markers > 0

    # phase 1: bottleneck costs
    c0 = jnp.where(seeded, inten, _INF)

    def cost_round(c):
        c = _cost_scan(c, inten, -1, False)
        c = _cost_scan(c, inten, -1, True)
        c = _cost_scan(c, inten, -2, False)
        c = _cost_scan(c, inten, -2, True)
        return c

    cost, ok1 = _fix(cost_round, c0, max_rounds)

    # phase 2: min label over bottleneck-optimal edges.
    # gate_right(x) := edge (x-1)->x valid := max(c*(x-1), I(x)) == c*(x)
    def shift(a, axis, rev):
        pad = [(0, 0), (0, 0)]
        pad[axis] = (0, 1) if rev else (1, 0)
        sl = [slice(None)] * 2
        sl[axis] = slice(1, None) if rev else slice(None, -1)
        return jnp.pad(a, pad, constant_values=_INF)[tuple(sl)]

    gates = {}
    for axis in (-1, -2):
        for rev in (False, True):
            prev_c = shift(cost, axis, rev)
            gates[(axis, rev)] = jnp.maximum(prev_c, inten) == cost

    l0 = jnp.where(seeded, markers.astype(jnp.int32), _INF)

    def label_round(l):
        for axis in (-1, -2):
            for rev in (False, True):
                l = _gated_min_scan(l, gates[(axis, rev)], axis, rev)
        return l

    labels, ok2 = _fix(label_round, l0, max_rounds)
    labels = jnp.where(labels < _INF, labels, 0)
    labels = jnp.where(seeded, markers, labels)  # seeds keep their value
    # watershed lines: left/up neighbor carries a DIFFERENT positive label
    left = jnp.pad(labels, ((0, 0), (1, 0)))[:, :-1]
    up = jnp.pad(labels, ((1, 0), (0, 0)))[:-1, :]
    ridge = ((left > 0) & (labels > 0) & (left != labels)) | (
        (up > 0) & (labels > 0) & (up != labels))
    out = jnp.where(ridge & ~seeded, -1, labels)  # seeds never ridge
    return out.astype(jnp.int32), ok1 & ok2


def watershed(gray, markers, max_rounds: int = 512) -> np.ndarray:
    """u8 gray (H, W) × int32 markers (H, W) → int32 segmentation
    (−1 ridge, labels elsewhere). Raises on non-convergence."""
    m = np.asarray(markers)
    if m.size and (m.min() < 0 or m.max() > MAX_LABEL):
        raise ValueError(f"marker labels must be in [0, {MAX_LABEL}]")
    out, converged = _flood(jnp.asarray(gray), jnp.asarray(m, np.int32),
                            max_rounds)
    if not bool(converged):
        raise ValueError(f"watershed: no fixed point in {max_rounds} rounds")
    return np.asarray(out)


def watershed_numpy(gray: np.ndarray, markers: np.ndarray) -> np.ndarray:
    """Oracle — both fixpoints by Jacobi relaxation (unique, so any fair
    schedule gives the same answer as the device's scan sweeps)."""
    INF = np.int64(2**40)
    inten = gray.astype(np.int64)
    m = markers.astype(np.int64)
    h, w = gray.shape

    def neighbors(a, fill):
        out = []
        for shift in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            n = np.roll(a, shift, axis=(0, 1))
            if shift == (0, 1):
                n[:, 0] = fill
            elif shift == (0, -1):
                n[:, -1] = fill
            elif shift == (1, 0):
                n[0, :] = fill
            else:
                n[-1, :] = fill
            out.append(n)
        return out

    cost = np.where(m > 0, inten, INF)
    while True:
        prev = cost.copy()
        for n in neighbors(cost, INF):
            cost = np.minimum(cost, np.maximum(n, inten))
        if np.array_equal(cost, prev):
            break
    labels = np.where(m > 0, m, INF)
    while True:
        prev = labels.copy()
        for nc, nl in zip(neighbors(cost, INF), neighbors(labels, INF)):
            valid = np.maximum(nc, inten) == cost
            labels = np.minimum(labels, np.where(valid, nl, INF))
        if np.array_equal(labels, prev):
            break
    labels = np.where(labels < INF, labels, 0)
    labels = np.where(m > 0, m, labels)
    left = np.pad(labels, ((0, 0), (1, 0)))[:, :-1]
    up = np.pad(labels, ((1, 0), (0, 0)))[:-1, :]
    ridge = ((left > 0) & (labels > 0) & (left != labels)) | (
        (up > 0) & (labels > 0) & (up != labels))
    return np.where(ridge & (m <= 0), -1, labels).astype(np.int32)
