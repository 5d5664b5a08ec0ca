"""Background subtraction — Gaussian-mixture model per pixel (the OpenCV
``BackgroundSubtractorMOG2`` role; Zivkovic-style update rules, frozen
simplified spec below).

Device formulation: the entire model is [K, H, W(, C)] float32 planes and
every rule — matching, ownership, running-moment updates, weight
normalization, the sorted-cumulative-weight background test — is
elementwise arithmetic with the K axis unrolled (K=4 default). No
gathers, no scatters, no sorting networks beyond K pairwise compares.
State threads functionally through :func:`mog2_step`, so it drops into
``lax.scan`` over a clip or a streaming engine tick unchanged.

Frozen spec (per pixel, per frame x):
- distance d2_k = Σ_c (x_c − μ_kc)²; match_k = d2_k < T_var · v_k · C;
  best = argmin_k d2_k among matches (ties → smallest k);
- foreground decision BEFORE updating: sort components by weight
  descending (stable; ties → smaller k first); the background set is the
  smallest prefix whose cumulative weight exceeds ``ratio`` (a component
  is in the set if the cumulative weight BEFORE it is < ratio); the pixel
  is foreground iff it matches nothing or its best match is not in the
  background set;
- update (α = learning rate): w_k ← (1−α)·w_k + α·o_k with o_k = [k is
  best match]; matched component: ρ = α / max(w_k', 1e-6), μ ← μ + ρ·δ,
  v ← v + ρ·(d2/C − v), v clamped to [v_min, v_max];
- no match: the lowest-weight component (ties → smallest k) is replaced
  with μ = x, v = v_init, w = α;
- weights renormalized to sum 1 each frame.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import numpy as np

import jax
import jax.numpy as jnp


class MOG2Params(NamedTuple):
    alpha: float = 0.01  # learning rate (OpenCV: 1/history)
    var_threshold: float = 16.0  # squared-mahalanobis match gate
    ratio: float = 0.9  # background cumulative-weight prefix
    var_init: float = 225.0  # variance for fresh components (15^2)
    var_min: float = 4.0
    var_max: float = 5000.0


def mog2_init(shape: Tuple[int, ...], k: int = 4):
    """Fresh model for frames of ``shape`` ((H, W) or (H, W, C)):
    (w [K,H,W], mean [K,*shape], var [K,H,W]) — all zeros except var
    (var_init) so the first frame seeds component 0."""
    hw = shape[:2]
    w = jnp.zeros((k,) + hw, jnp.float32)
    mean = jnp.zeros((k,) + shape, jnp.float32)
    var = jnp.full((k,) + hw, MOG2Params().var_init, jnp.float32)
    return w, mean, var


@partial(jax.jit, static_argnames=("params",))
def mog2_step(state, frame: jax.Array, params: MOG2Params = MOG2Params()):
    """One model update: (state, u8 frame (H, W) or (H, W, C)) →
    (new state, fg mask bool (H, W))."""
    w, mean, var = state
    k = w.shape[0]
    p = params
    x = frame.astype(jnp.float32)
    chan = x.ndim == 3
    nc = x.shape[-1] if chan else 1
    delta = x[None] - mean  # [K, H, W(, C)]
    d2 = jnp.sum(delta * delta, axis=-1) if chan else delta * delta  # [K,H,W]

    match = d2 < p.var_threshold * var * nc
    big = jnp.float32(3.4e38)
    d2m = jnp.where(match, d2, big)
    best = jnp.argmin(d2m, axis=0)  # [H, W]; ties → smallest k
    any_match = jnp.any(match, axis=0)
    onehot = (jax.lax.broadcasted_iota(jnp.int32, w.shape, 0)
              == best[None]) & any_match[None]

    # ---- foreground decision on the PRE-update model -------------------
    # rank each component by weight desc (stable): count of strictly
    # heavier components + equal-weight components with smaller index
    wi = w[:, None]  # [K, 1, H, W]
    wj = w[None]  # [1, K, H, W]
    i_idx = jnp.arange(k)[:, None, None, None]
    j_idx = jnp.arange(k)[None, :, None, None]
    before = (wj > wi) | ((wj == wi) & (j_idx < i_idx))  # j sorts before i
    cum_before = jnp.sum(jnp.where(before, wj, 0.0), axis=1)  # [K, H, W]
    in_bg = cum_before < p.ratio
    # in_bg at the best-match component, gather-free (device: one-hot sum
    # beats take_along_axis)
    bg_at_best = jnp.any(onehot & in_bg, axis=0)
    fg = ~(any_match & bg_at_best)

    # ---- update --------------------------------------------------------
    o = onehot.astype(jnp.float32)
    w2 = (1.0 - p.alpha) * w + p.alpha * o
    rho = p.alpha / jnp.maximum(w2, 1e-6)
    upd = o * rho
    mean2 = mean + (upd[..., None] if chan else upd) * delta
    var2 = var + upd * (d2 / nc - var)
    var2 = jnp.clip(var2, p.var_min, p.var_max)

    # ---- replacement when nothing matched ------------------------------
    worst = jnp.argmin(w2 + jnp.float32(1e-7)
                       * jax.lax.broadcasted_iota(jnp.float32, w.shape, 0),
                       axis=0)
    repl = (jax.lax.broadcasted_iota(jnp.int32, w.shape, 0)
            == worst[None]) & ~any_match[None]
    w2 = jnp.where(repl, p.alpha, w2)
    mean2 = jnp.where(repl[..., None] if chan else repl, x[None], mean2)
    var2 = jnp.where(repl, p.var_init, var2)

    w2 = w2 / jnp.sum(w2, axis=0, keepdims=True)
    return (w2, mean2, var2), fg


class BackgroundSubtractorMOG2:
    """Stateful convenience wrapper (OpenCV-style ``apply``): feeds frames
    through :func:`mog2_step`, keeping the model on device."""

    def __init__(self, k: int = 4, detect_shadows: bool = False,
                 shadow_tau: float = 0.5, **kw):
        self._k = k
        self._params = MOG2Params(**kw)
        self._state = None
        self._detect_shadows = detect_shadows
        self._shadow_tau = shadow_tau

    def apply(self, frame) -> np.ndarray:
        f = jnp.asarray(frame)
        if self._state is None:
            self._state = mog2_init(f.shape, self._k)
        elif f.shape != self._state[1].shape[1:]:
            raise ValueError(
                f"frame shape {f.shape} != model shape "
                f"{self._state[1].shape[1:]} (create a new subtractor)")
        prev_state = self._state
        self._state, fg = mog2_step(self._state, f, self._params)
        if not self._detect_shadows:
            return np.asarray(fg)
        sh = shadow_mask(prev_state, f, fg, tau=self._shadow_tau)
        out = jnp.where(sh, jnp.uint8(127),
                        jnp.where(fg.astype(bool), jnp.uint8(255),
                                  jnp.uint8(0)))
        return np.asarray(out)

    @property
    def background(self) -> np.ndarray:
        """Highest-weight component's mean (u8) — the modeled background."""
        if self._state is None:
            raise RuntimeError("apply() at least one frame first")
        w, mean, _ = self._state
        top = jnp.argmax(w, axis=0)
        sel = jnp.take_along_axis(
            mean, top[None, ..., None] if mean.ndim == 4 else top[None], 0)[0]
        return np.asarray(jnp.clip(jnp.round(sel), 0, 255).astype(jnp.uint8))


# ---------------------------------------------------------------- oracle

def mog2_step_numpy(state, frame: np.ndarray,
                    params: MOG2Params = MOG2Params()):
    """Same frozen spec, float64 loops (oracle)."""
    w, mean, var = [np.array(s, np.float64) for s in state]
    p = params
    x = frame.astype(np.float64)
    chan = x.ndim == 3
    nc = x.shape[-1] if chan else 1
    k = w.shape[0]
    h, wd = w.shape[1:]
    fg = np.zeros((h, wd), bool)
    for yy in range(h):
        for xx in range(wd):
            xv = x[yy, xx] if chan else np.array([x[yy, xx]])
            d2s = np.array([
                np.sum((xv - (mean[c, yy, xx] if chan else [mean[c, yy, xx]])) ** 2)
                for c in range(k)
            ])
            matches = d2s < p.var_threshold * var[:, yy, xx] * nc
            order = sorted(range(k), key=lambda c: (-w[c, yy, xx], c))
            cum = 0.0
            in_bg = np.zeros(k, bool)
            for c in order:
                in_bg[c] = cum < p.ratio
                cum += w[c, yy, xx]
            if matches.any():
                best = int(np.argmin(np.where(matches, d2s, np.inf)))
                fg[yy, xx] = not in_bg[best]
                for c in range(k):
                    o = 1.0 if c == best else 0.0
                    w[c, yy, xx] = (1 - p.alpha) * w[c, yy, xx] + p.alpha * o
                rho = p.alpha / max(w[best, yy, xx], 1e-6)
                if chan:
                    mean[best, yy, xx] += rho * (xv - mean[best, yy, xx])
                else:
                    mean[best, yy, xx] += rho * (xv[0] - mean[best, yy, xx])
                var[best, yy, xx] += rho * (d2s[best] / nc - var[best, yy, xx])
                var[best, yy, xx] = min(max(var[best, yy, xx], p.var_min), p.var_max)
            else:
                fg[yy, xx] = True
                w[:, yy, xx] *= 1 - p.alpha
                worst = int(np.argmin(w[:, yy, xx] + 1e-7 * np.arange(k)))
                w[worst, yy, xx] = p.alpha
                mean[worst, yy, xx] = xv if chan else xv[0]
                var[worst, yy, xx] = p.var_init
            w[:, yy, xx] /= w[:, yy, xx].sum()
    return (w, mean, var), fg


@partial(jax.jit, static_argnames=("tau",))
def shadow_mask(state, frame: jax.Array, fg: jax.Array,
                tau: float = 0.5) -> jax.Array:
    """Shadow detection on foreground pixels (OpenCV MOG2's
    ``detectShadows`` role, Prati-style chromatic test): with B the
    top-weight background mean, brightness ratio r = (x·B)/(B·B); the
    pixel is SHADOW when τ ≤ r < 1 and its chromatic residual
    ‖x − r·B‖² is within the matched variance gate. → bool (H, W)."""
    w, mean, var = state
    top = jnp.argmax(w, axis=0)
    if mean.ndim == 4:
        b = jnp.take_along_axis(mean, top[None, ..., None], 0)[0]
        x = frame.astype(jnp.float32)
        num = (x * b).sum(-1)
        den = jnp.maximum((b * b).sum(-1), 1e-6)
        r = num / den
        resid = ((x - r[..., None] * b) ** 2).sum(-1)
        nch = x.shape[-1]
    else:
        b = jnp.take_along_axis(mean, top[None], 0)[0]
        x = frame.astype(jnp.float32)
        r = x / jnp.maximum(b, 1e-6)
        resid = jnp.zeros_like(x)
        nch = 1
    v = jnp.take_along_axis(var, top[None], 0)[0]
    gate = MOG2Params().var_threshold * v * nch
    return (fg.astype(bool) & (r >= tau) & (r < 1.0)
            & (resid <= gate))
