"""Spectral-filter solver: coefficients and leave-one-out loss.

This is the accelerator redesign of the reference's heart,
``bSolveForc`` → ``BigSolveForc`` (``src/solveforc.cpp:13-78``).

The reference computes, for a candidate ridge penalty λ and eigensystem
K = Q Λ Qᵀ (possibly truncated):

    G⁻¹  = Q diag(1/(Λ+λ)) Qᵀ          (never materialized)
    c    = G⁻¹ y
    Le   = Σᵢ (cᵢ / G⁻¹ᵢᵢ)²            (the exact LOO error loss)

via a sequential triangular loop of growing GEMVs — a CPU trick that halves
FLOPs and avoids an N×N temporary (``examples/solveforc.Rmd:37-111``).
On a parallel device that serialization is pure loss.  The mathematically identical,
fully-parallel form used here:

    w        = (Qᵀy) / (Λ+λ)            O(k)
    c        = Q w                      O(Nk) GEMV
    G⁻¹ᵢᵢ    = Σₖ Q²ᵢₖ / (λₖ+λ)         O(Nk) GEMV against precomputed Q²
    Le       = Σᵢ (cᵢ/G⁻¹ᵢᵢ)²           O(N)

Both per-λ GEMVs reuse two precomputed objects — ``Qᵀy`` and ``Q∘Q`` — so a
whole *batch* of λ candidates costs two (N,k)×(k,B) GEMMs (the "batched
spectral-filter solve" of BASELINE.json).  The golden-section search driver
in ``lambda_search.py`` consumes the batched form.

Note on truncation parity: the reference passes the FULL eigenvalue list
into ``BigSolveForc`` together with lastkeeper-truncated vectors; Armadillo's
flat memory semantics mean only the first ``lastkeeper`` values are actually
used (SURVEY.md §2.1 C6).  Here the truncated ``values``/``vectors`` pair is
used explicitly — same math, stated honestly.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..types import Eigensystem


@jax.jit
def solve_precompute(vectors, y_std):
    """Precompute the two reusable objects for batched λ solves."""
    Qty = vectors.T @ y_std            # (k,)
    Q2 = vectors * vectors             # (N, k)
    return Qty, Q2


@jax.jit
def spectral_solve_batch(vectors, values, Qty, Q2, lambdas):
    """Coefficients, Ĝ⁻¹ diagonals and LOO losses for a batch of λs.

    Returns ``coeffs`` (N, B), ``ginv_diag`` (N, B), ``loo`` (B,).
    """
    lambdas = jnp.atleast_1d(lambdas)
    filt = 1.0 / (values[:, None] + lambdas[None, :])      # (k, B)
    W = Qty[:, None] * filt                                # (k, B)
    coeffs = vectors @ W                                   # (N, B)
    ginv_diag = Q2 @ filt                                  # (N, B)
    loo = jnp.sum((coeffs / ginv_diag) ** 2, axis=0)       # (B,)
    return coeffs, ginv_diag, loo


@jax.jit
def loo_loss_batch(vectors, values, Qty, Q2, lambdas):
    """LOO error losses only (λ-search inner step, ref ``bLooLoss``
    ``R/bigKRLS_Rcpp_functions.R:92-95``)."""
    _, _, loo = spectral_solve_batch(vectors, values, Qty, Q2, lambdas)
    return loo


def solve_for_c(eig: Eigensystem, y_std, lambda_):
    """Single-λ convenience wrapper: (Le, coeffs), like ``bSolveForc``."""
    Qty, Q2 = solve_precompute(eig.vectors, y_std)
    coeffs, _, loo = spectral_solve_batch(
        eig.vectors, eig.values, Qty, Q2, jnp.asarray([lambda_], y_std.dtype)
    )
    return loo[0], coeffs[:, 0]
