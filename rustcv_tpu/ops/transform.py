"""Discrete transforms (OpenCV ``dct`` / ``idct`` / ``dft`` / ``idft`` /
``mulSpectrums`` / ``getOptimalDFTSize`` roles).

The reference has no transform module; OpenCV-parity addition used by
the FFT matchTemplate / phaseCorrelate family.

Device formulation: the 2-D orthonormal DCT-II is two basis MATMULS
(``B @ A @ Bᵀ`` with the [N, N] cosine basis) — exactly the IDCT-as-one-
matmul trick that carries the JPEG path (ops/jpeg_tpu.idct_kmat, the
layout-seam lesson), so the matrix unit does the whole transform in two ops; no
FFT butterflies, no transposes beyond the matmul's own. DFT rides
``jnp.fft`` (XLA's native FFT). Host float64 oracles freeze both.

Frozen spec:
- dct: orthonormal DCT-II, ``C[k, n] = s_k·cos(π(2n+1)k / 2N)`` with
  ``s_0 = √(1/N)``, ``s_k = √(2/N)`` — OpenCV's normalization; idct is
  the exact transpose (DCT-III);
- 1-D inputs (row/column vectors) transform along their single
  non-unit axis, matching OpenCV;
- mulSpectrums: elementwise complex product, optional conjugation of B;
- getOptimalDFTSize: smallest 5-smooth (2^a·3^b·5^c) integer ≥ n.
"""

from __future__ import annotations

from functools import lru_cache, partial

import numpy as np

import jax
import jax.numpy as jnp


@lru_cache(maxsize=32)
def _dct_basis(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis (float64): row k = frequency k."""
    k = np.arange(n)[:, None].astype(np.float64)
    m = np.arange(n)[None, :].astype(np.float64)
    b = np.cos(np.pi * (2.0 * m + 1.0) * k / (2.0 * n))
    b *= np.sqrt(2.0 / n)
    b[0] *= np.sqrt(0.5)
    return b


def dct_numpy(a: np.ndarray, inverse: bool = False) -> np.ndarray:
    """Oracle — float64. 2-D arrays transform both axes; 1-row/1-col
    arrays transform their long axis only (OpenCV semantics)."""
    a = np.asarray(a, np.float64)
    if a.ndim != 2:
        raise ValueError("dct expects a 2-D array (use shape (1, N) for 1-D)")
    h, w = a.shape
    bh, bw = _dct_basis(h), _dct_basis(w)
    if inverse:
        bh, bw = bh.T, bw.T
    if h == 1:
        return a @ bw.T
    if w == 1:
        return bh @ a
    return bh @ a @ bw.T


@partial(jax.jit, static_argnames=("inverse",))
def dct(a: jax.Array, inverse: bool = False) -> jax.Array:
    """Device twin — float32 basis matmuls (two for 2-D) at HIGHEST
    precision: a device default may lower f32 matmuls to bf16 or TF32
    passes, far outside the f64 oracle's tolerance."""
    a = a.astype(jnp.float32)
    h, w = a.shape
    bh = jnp.asarray(_dct_basis(h), jnp.float32)
    bw = jnp.asarray(_dct_basis(w), jnp.float32)
    if inverse:
        bh, bw = bh.T, bw.T
    hi = jax.lax.Precision.HIGHEST
    if h == 1:
        return jax.lax.dot(a, bw.T, precision=hi)
    if w == 1:
        return jax.lax.dot(bh, a, precision=hi)
    return jax.lax.dot(jax.lax.dot(bh, a, precision=hi), bw.T,
                       precision=hi)


def idct(a, **kw):
    """OpenCV ``idct``: the inverse orthonormal transform."""
    if isinstance(a, np.ndarray):
        return dct_numpy(a, inverse=True)
    return dct(a, inverse=True)


def mul_spectrums(a, b, conj_b: bool = False):
    """Elementwise complex spectrum product (OpenCV ``mulSpectrums``
    role, complex-array form). Works on numpy or jax arrays."""
    xp = np if isinstance(a, np.ndarray) else jnp
    return a * (xp.conj(b) if conj_b else b)


def dft(a):
    """2-D forward DFT → complex (OpenCV ``dft`` complex-output role)."""
    xp = np if isinstance(a, np.ndarray) else jnp
    return xp.fft.fft2(xp.asarray(a))


def idft(a, scale: bool = True):
    """2-D inverse DFT (complex). ``scale=False`` matches OpenCV's
    unnormalized default; True divides by N (DFT_SCALE)."""
    xp = np if isinstance(a, np.ndarray) else jnp
    out = xp.fft.ifft2(a)
    if not scale:
        out = out * a.shape[0] * a.shape[1]
    return out


@lru_cache(maxsize=32)
def _dft_mats(n: int):
    """(C, S) float64 with ``D = C − iS`` the forward DFT matrix:
    C[k,m] = cos(2πkm/n), S[k,m] = sin(2πkm/n)."""
    k = np.arange(n)[:, None].astype(np.float64)
    m = np.arange(n)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * k * m / n
    return np.cos(ang), np.sin(ang)


@jax.jit
def dft2_planes(x: jax.Array):
    """2-D forward DFT over the LAST TWO axes of a REAL array as
    (re, im) float32 planes via four matmuls (leading axes batch) —
    no complex dtype anywhere. For image-sized transforms the [N, N]
    basis matmul is a natural device formulation (same lesson as the
    JPEG IDCT-as-one-matmul)."""
    x = x.astype(jnp.float32)
    h, w = x.shape[-2], x.shape[-1]
    ch, sh = (jnp.asarray(m, jnp.float32) for m in _dft_mats(h))
    cw, sw = (jnp.asarray(m, jnp.float32) for m in _dft_mats(w))
    hi = jax.lax.Precision.HIGHEST
    mm = partial(jnp.matmul, precision=hi)
    a = mm(ch, x)      # C_h x   (broadcasts over leading axes)
    b = mm(sh, x)      # S_h x
    re = mm(a, cw) - mm(b, sw)
    im = -(mm(a, sw) + mm(b, cw))
    return re, im


@partial(jax.jit, static_argnames=("scale",))
def idft2_planes(re: jax.Array, im: jax.Array, scale: bool = True):
    """Inverse of :func:`dft2_planes` on (re, im) planes (conjugate
    basis; ``scale`` divides by H·W; leading axes batch). Returns
    (re, im)."""
    h, w = re.shape[-2], re.shape[-1]
    ch, sh = (jnp.asarray(m, jnp.float32) for m in _dft_mats(h))
    cw, sw = (jnp.asarray(m, jnp.float32) for m in _dft_mats(w))
    hi = jax.lax.Precision.HIGHEST
    mm = partial(jnp.matmul, precision=hi)
    # D* = C + iS: (C+iS)(xr+ixi) = (C xr − S xi) + i(C xi + S xr)
    p = mm(ch, re) - mm(sh, im)
    q = mm(ch, im) + mm(sh, re)
    out_re = mm(p, cw) - mm(q, sw)
    out_im = mm(p, sw) + mm(q, cw)
    if scale:
        inv = jnp.float32(1.0 / (h * w))
        out_re, out_im = out_re * inv, out_im * inv
    return out_re, out_im


def mul_spectrums_planes(a, b, conj_b: bool = False):
    """:func:`mul_spectrums` on (re, im) plane pairs."""
    ar, ai = a
    br, bi = b
    if conj_b:
        bi = -bi
    return ar * br - ai * bi, ar * bi + ai * br


def get_optimal_dft_size(n: int) -> int:
    """Smallest 5-smooth integer ≥ n (OpenCV ``getOptimalDFTSize``)."""
    if n <= 0:
        raise ValueError("n must be positive")
    best = None
    p2 = 1
    while p2 < 2 * n:
        p23 = p2
        while p23 < 2 * n:
            p235 = p23
            while p235 < n:
                p235 *= 5
            if best is None or p235 < best:
                best = p235
            p23 *= 3
        p2 *= 2
    return best
