"""Kalman filtering (OpenCV ``cv::KalmanFilter`` role — the reference has
no Kalman; this is an OpenCV-parity addition like MOG2/meanShift).

Three layers, device-first:

- :class:`KalmanFilter` — the OpenCV object API (predict/correct with the
  exact member names), host float64, one tracker. Validated against the
  frozen spec in :mod:`rustcv_tpu.ops.golden` (it *is* the spec, shared).
- :func:`predict_batch` / :func:`correct_batch` — jitted batched updates
  over a bank of N trackers (``(N, S)`` states, ``(N, S, S)`` covariances,
  shared model matrices). Multi-object tracking runs the whole bank in two
  dispatches; the tiny per-tracker solves batch into one ``jnp.linalg.solve``
  call XLA lowers well at small S.
- :func:`filter_scan` — a whole T-step filter pass in ONE program via
  ``lax.scan`` (device-resident measurement sequence in, filtered states
  out). This is the dispatch-amortized form for offline track smoothing —
  the same in-program-chaining pattern as the engine's ``run_chained``.

Tolerance contract: device math is float32; tests bound it against the
float64 golden at rtol 1e-4 over conditioned models (documented-tolerance
per the fidelity contract — linear algebra, not integer pixels).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from . import golden

__all__ = ["KalmanFilter", "predict_batch", "correct_batch", "filter_scan"]


class KalmanFilter:
    """OpenCV ``cv::KalmanFilter`` API: construct with state/measurement
    (and optional control) dimensions, set the model matrices, then
    alternate ``predict()``/``correct(z)``. Member names match OpenCV's
    (snake_case): ``transition_matrix``, ``measurement_matrix``,
    ``process_noise_cov``, ``measurement_noise_cov``, ``control_matrix``,
    ``state_pre/state_post``, ``error_cov_pre/error_cov_post``, ``gain``.

    Like OpenCV, ``predict()`` copies the prior into the posterior so that
    consecutive predicts without a correct keep propagating."""

    def __init__(self, dynam_params: int, measure_params: int,
                 control_params: int = 0):
        if dynam_params < 1 or measure_params < 1:
            raise ValueError("state and measurement dims must be >= 1")
        d, m, c = dynam_params, measure_params, control_params
        self.transition_matrix = np.eye(d)
        self.measurement_matrix = np.zeros((m, d))
        self.process_noise_cov = np.eye(d)
        self.measurement_noise_cov = np.eye(m)
        self.control_matrix = np.zeros((d, c)) if c > 0 else None
        self.state_pre = np.zeros(d)
        self.state_post = np.zeros(d)
        self.error_cov_pre = np.zeros((d, d))
        self.error_cov_post = np.zeros((d, d))
        self.gain = np.zeros((d, m))

    def predict(self, control: Optional[np.ndarray] = None) -> np.ndarray:
        # Accept column-vector state from callers (cv2 idiom stores
        # statePost as (d, 1)); keep the internal state 1-D so the
        # innovation below stays a vector, not a broadcast outer product.
        self.state_post = np.asarray(self.state_post,
                                     np.float64).reshape(-1)
        self.state_pre, self.error_cov_pre = golden.kalman_predict(
            self.state_post, self.error_cov_post,
            self.transition_matrix, self.process_noise_cov,
            self.control_matrix, control,
        )
        # OpenCV copies pre → post in predict (kalman.cpp): repeated
        # predicts without a correct keep extrapolating.
        self.state_post = self.state_pre.copy()
        self.error_cov_post = self.error_cov_pre.copy()
        return self.state_pre

    def correct(self, measurement: np.ndarray) -> np.ndarray:
        self.state_pre = np.asarray(self.state_pre, np.float64).reshape(-1)
        measurement = np.asarray(measurement, np.float64).reshape(-1)
        self.state_post, self.error_cov_post, self.gain = golden.kalman_correct(
            self.state_pre, self.error_cov_pre, measurement,
            self.measurement_matrix, self.measurement_noise_cov,
        )
        return self.state_post


@jax.jit
def predict_batch(x, P, A, Q):
    """Batched time update: x (N, S), P (N, S, S); A/Q shared (S, S) or
    per-tracker (N, S, S). Returns (x', P') in float32."""
    x = x.astype(jnp.float32)
    P = P.astype(jnp.float32)
    A = A.astype(jnp.float32)
    Q = Q.astype(jnp.float32)
    # Branch on rank at trace time: an ellipsis einsum would silently SUM
    # a batched A over the bank instead of broadcasting per-tracker.
    a = "nij" if A.ndim == 3 else "ij"
    xp = jnp.einsum(f"{a},nj->ni", A, x)
    al = a.replace("i", "l").replace("j", "k")
    Pp = jnp.einsum(f"{a},njk,{al}->nil", A, P, A) + Q
    return xp, Pp


@jax.jit
def correct_batch(x, P, z, H, R):
    """Batched measurement update: z (N, M); H (M, S), R (M, M) shared (or
    batched with a leading N). Returns (x⁺ (N, S), P⁺ (N, S, S), K
    (N, S, M)) in float32 — same formulas as golden.kalman_correct."""
    x = x.astype(jnp.float32)
    P = P.astype(jnp.float32)
    z = z.astype(jnp.float32)
    H = H.astype(jnp.float32)
    R = R.astype(jnp.float32)
    h = "nij" if H.ndim == 3 else "ij"
    HP = jnp.einsum(f"{h},njk->nik", H, P)             # (N, M, S)
    hj = h.replace("i", "p").replace("j", "k").replace("p", "j")
    S = jnp.einsum(f"nik,{hj}->nij", HP, H) + R        # (N, M, M)
    K = jnp.linalg.solve(S, HP).transpose(0, 2, 1)     # (N, S, M)
    innov = z - jnp.einsum(f"{h},nj->ni", H, x)
    xn = x + jnp.einsum("nij,nj->ni", K, innov)
    Pn = P - jnp.einsum("nij,njk->nik", K, HP)
    return xn, Pn, K


@partial(jax.jit, static_argnames=())
def filter_scan(x0, P0, zs, A, H, Q, R):
    """Run a full predict/correct filter over a measurement sequence in one
    program: zs (T, N, M) → filtered states (T, N, S) and final (x, P).
    ``lax.scan`` keeps the whole pass on device — one dispatch for T steps
    over a bank of N trackers."""

    def step(carry, z):
        x, P = carry
        xp, Pp = predict_batch(x, P, A, Q)
        xn, Pn, _ = correct_batch(xp, Pp, z, H, R)
        return (xn, Pn), xn

    (xf, Pf), xs = jax.lax.scan(step, (x0.astype(jnp.float32),
                                       P0.astype(jnp.float32)), zs)
    return xs, xf, Pf
