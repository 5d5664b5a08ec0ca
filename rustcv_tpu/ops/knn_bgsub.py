"""KNN background subtraction (OpenCV ``BackgroundSubtractorKNN`` role,
Zivkovic & van der Heijden 2006 — the sample-consensus companion to
MOG2, ops/bgsub.py).

Device formulation: the model is an [N, H, W(, C)] float32 sample bank per
pixel; matching is N squared-distance compares (elementwise, N
unrolled), the k-NN vote is a sum of match bits, and the sample
replacement is a one-hot select on a DETERMINISTIC cyclic slot clock —
no gathers, no scatters, no RNG. State threads functionally through
:func:`knn_step` (drops into ``lax.scan`` / engine ticks like MOG2's).

Frozen spec (per pixel, per frame x; deterministic — OpenCV's
stochastic sample replacement is replaced by a cyclic clock, a
documented divergence that keeps device/oracle bit-agreement):
- match_i = Σ_c (x_c − s_ic)² < dist2_threshold (default 400);
- background iff Σ match_i ≥ k_nn (default 2);
- init: every slot holds the init frame;
- update every ``update_period`` frames (default 1): the slot at
  ``clock mod N`` is overwritten with x IF the pixel was background,
  or always after ``n_fg_max`` consecutive foreground frames (absorbs
  scene changes; counter resets on background) — then clock += 1;
- shadows are not modeled here (MOG2's detect_shadows covers the role; OpenCV's KNN shadow detection is an HSV
  heuristic bolted on either subtractor; compose with bgr_to_hsv if
  needed).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import numpy as np

import jax
import jax.numpy as jnp


class KNNParams(NamedTuple):
    dist2_threshold: float = 400.0
    k_nn: int = 2
    update_period: int = 1
    n_fg_max: int = 30


class KNNState(NamedTuple):
    samples: jax.Array   # float32 [N, H, W(, C)]
    clock: jax.Array     # int32 scalar — cyclic replacement slot
    fg_run: jax.Array    # int32 [H, W] consecutive-foreground counter


def knn_init(frame, n_samples: int = 7) -> KNNState:
    """Bank seeded with the init frame in every slot (matching pixels
    immediately read background; a zero bank would deadlock — nothing
    writes until something reads background)."""
    x = jnp.asarray(frame).astype(jnp.float32)
    return KNNState(
        jnp.broadcast_to(x[None], (n_samples,) + x.shape).copy(),
        jnp.zeros((), jnp.int32),
        jnp.zeros(tuple(x.shape[:2]), jnp.int32),
    )


@partial(jax.jit, static_argnames=("params",))
def knn_step(state: KNNState, frame: jax.Array,
             params: KNNParams = KNNParams()):
    """→ (new_state, fg_mask bool [H, W])."""
    x = frame.astype(jnp.float32)
    s = state.samples
    if x.ndim == s.ndim - 1:
        d2 = (s - x[None]) ** 2
        if x.ndim == 3:
            d2 = d2.sum(axis=-1)
    else:
        raise ValueError("frame rank must be samples rank - 1")
    match = d2 < params.dist2_threshold          # [N, H, W]
    votes = match.sum(axis=0)
    bg = votes >= params.k_nn
    fg = ~bg

    fg_run = jnp.where(fg, state.fg_run + 1, 0).astype(jnp.int32)
    absorb = fg_run >= params.n_fg_max
    do_update = (state.clock % params.update_period) == 0
    write = (bg | absorb) & do_update            # [H, W]
    slot = state.clock // params.update_period % s.shape[0]
    one_hot = jnp.arange(s.shape[0]) == slot     # [N]
    wmask = write[None] & one_hot[:, None, None]
    if x.ndim == 3:
        wmask = wmask[..., None]
    new_samples = jnp.where(wmask, x[None], s)
    fg_run = jnp.where(absorb, 0, fg_run)
    return KNNState(new_samples, state.clock + 1, fg_run), fg


def knn_step_numpy(state, frame: np.ndarray,
                   params: KNNParams = KNNParams()):
    """float64 oracle — same spec, dict state {'samples','clock','fg_run'}."""
    x = np.asarray(frame, np.float64)
    s = state["samples"]
    d2 = (s - x[None]) ** 2
    if x.ndim == 3:
        d2 = d2.sum(axis=-1)
    match = d2 < params.dist2_threshold
    votes = match.sum(axis=0)
    bg = votes >= params.k_nn
    fg = ~bg
    fg_run = np.where(fg, state["fg_run"] + 1, 0)
    absorb = fg_run >= params.n_fg_max
    do_update = (state["clock"] % params.update_period) == 0
    write = (bg | absorb) & do_update
    slot = state["clock"] // params.update_period % s.shape[0]
    new_samples = s.copy()
    sel = write
    if x.ndim == 3:
        new_samples[slot][sel] = x[sel]
    else:
        new_samples[slot][sel] = x[sel]
    fg_run = np.where(absorb, 0, fg_run)
    return {"samples": new_samples, "clock": state["clock"] + 1,
            "fg_run": fg_run}, fg


def knn_init_numpy(frame, n_samples: int = 7):
    x = np.asarray(frame, np.float64)
    return {"samples": np.tile(x[None], (n_samples,) + (1,) * x.ndim),
            "clock": 0, "fg_run": np.zeros(tuple(x.shape[:2]), np.int64)}


class BackgroundSubtractorKNN:
    """OpenCV-style object API: ``apply(frame) -> fg mask u8`` (255
    foreground). Device-resident state."""

    def __init__(self, n_samples: int = 7, **kw):
        self.params = KNNParams(**kw)
        self.n_samples = n_samples
        self._state = None

    def apply(self, frame) -> np.ndarray:
        a = frame.to_numpy() if hasattr(frame, "to_numpy") else frame
        a = jnp.asarray(np.asarray(a))
        if self._state is None:
            self._state = knn_init(a, self.n_samples)
        self._state, fg = knn_step(self._state, a, self.params)
        return (np.asarray(fg) * np.uint8(255)).astype(np.uint8)

    def background(self) -> np.ndarray:
        """Mean of the sample bank (diagnostic view)."""
        if self._state is None:
            raise RuntimeError("apply() first")
        return np.asarray(self._state.samples.mean(axis=0))
