"""Gaussian kernel construction.

Replaces the reference's O(N²P) scalar pairwise loops
(``src/gauss_kernel.cpp:13-42`` for the symmetric train kernel,
``src/temp_kernel.cpp:13-44`` for the rectangular test×train kernel).

The formulation uses the rank-P identity

    ||xᵢ − xⱼ||² = rᵢ + rⱼ − 2 xᵢ·xⱼ,   rᵢ = ||xᵢ||²

so the whole kernel is one (N, P)×(P, N) matmul plus broadcast adds and an
``exp``, which XLA fuses into the matmul's epilogue.  ``gauss_kernel`` and
``cross_kernel`` are plain XLA at every precision and size.

Numerics note (SURVEY.md §7 caveat): the dot form loses precision relative
to the reference's explicit difference-sum when ||x||² is large relative to
distances.  Inputs here are standardized columns, so rᵢ ≈ P and the f64
path reproduces the explicit form within ~1e-12 (tested in
``tests/test_kernels.py``).  The max(·, 0) clamp removes tiny negative
squared distances on the diagonal.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _sqdist(Xa, Xb):
    """Pairwise squared Euclidean distances via the rank-P matmul identity."""
    ra = jnp.sum(Xa * Xa, axis=1)
    rb = jnp.sum(Xb * Xb, axis=1)
    G = Xa @ Xb.T
    d2 = ra[:, None] + rb[None, :] - 2.0 * G
    return jnp.maximum(d2, 0.0)


@functools.partial(jax.jit, static_argnames=("explicit",))
def gauss_kernel(X, sigma, explicit: bool = False):
    """Symmetric N×N Gaussian kernel ``exp(-||xᵢ-xⱼ||²/σ)``.

    Equivalent of ``bGaussKernel`` → ``BigGaussKernel``
    (``R/bigKRLS_Rcpp_functions.R:201-210``, ``src/gauss_kernel.cpp:18-23``).
    ``sigma`` is the bandwidth named as in the reference (it multiplies as
    1/σ inside the exponent — it is σ², reference doc ``R/bigKRLS.R:68``).

    ``explicit=True`` uses the difference-sum form (reference-identical
    numerics, O(N²P) memory traffic) — for validation only.
    """
    sigma = jnp.asarray(sigma, dtype=X.dtype)
    if explicit:
        d2 = jnp.sum((X[:, None, :] - X[None, :, :]) ** 2, axis=-1)
    else:
        d2 = _sqdist(X, X)
    K = jnp.exp(-d2 / sigma)
    # exact 1.0 on the diagonal like the reference's exp(0) at i==j
    n = X.shape[0]
    K = jnp.where(jnp.eye(n, dtype=bool), jnp.ones((), X.dtype), K)
    return 0.5 * (K + K.T)


@jax.jit
def cross_kernel(X_new, X_old, sigma):
    """Rectangular U×V kernel between new data and training data.

    Equivalent of ``bTempKernel`` → ``BigTempKernel``
    (``R/bigKRLS_Rcpp_functions.R:219-227``, ``src/temp_kernel.cpp:14-30``).
    """
    sigma = jnp.asarray(sigma, dtype=X_new.dtype)
    return jnp.exp(-_sqdist(X_new, X_old) / sigma)
