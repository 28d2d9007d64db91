"""Golden-section search for the ridge penalty λ over exact LOO error.

Re-implements the reference's ``bLambdaSearch``
(``R/bigKRLS_Rcpp_functions.R:5-82``) with the same control flow and bound
heuristics — deterministic parity matters because λ* sits inside nested
heuristics and shifts every downstream estimate (SURVEY.md §7 hard part #2)
— but with each LOO evaluation recast as the O(N·k) batched spectral solve
(``ops/solve.py``) instead of the reference's O(N²·k/2) triangular loop.

Reference semantics replicated exactly:

* tolerance default ``tol = 1e-3 · N``  (``:11-15``; note the reference's
  orchestrator computes an identical ``n/1000`` at ``R/bigKRLS.R:232-236``
  but never passes it — the values coincide, so behavior is identical);
* upper bound: start at ``U = N``, decrement by 1 while
  ``Σ λₖ/(λₖ+U) < 1``  (``:16-25``);
* lower bound: start at machine epsilon, with
  ``q = which.min |λₖ − λ₁/1000|`` (a 1-based index used as a count),
  increment by 0.05 while ``Σ λₖ/(λₖ+L) > q``  (``:26-37``);
* golden ratio constant 0.381966 and the S1/S2 bracketing loop  (``:38-77``);
* the NaN-eigenvalue guard lives in ``ops/eig.py``.

Both bound loops walk a monotone condition in unit steps, so they are
evaluated here by exact integer bisection over the step count — identical
final bounds, O(log N) device reductions instead of O(N) host iterations.
"""
from __future__ import annotations


from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np

from .ops.solve import loo_loss_batch, solve_precompute
from .types import Eigensystem

_GOLD = 0.381966
_EPS = 2.220446049250313e-16  # R's .Machine$double.eps


def _sum_filter(values: np.ndarray, lam: float) -> float:
    return float(np.sum(values / (values + lam)))


def _upper_bound(values: np.ndarray, n: int) -> float:
    """Largest U in {n, n-1, ...} with Σ λₖ/(λₖ+U) ≥ 1 (reference loop :19-21).

    The sum is monotone increasing as U decreases, so the first k unit
    decrements at which the condition holds is found by bisection.  The
    condition is guaranteed by k = n (U = 0 ⇒ sum = #{λₖ > 0} ≥ 1), so the
    walk never reaches negative U — same stopping point as the reference's
    one-step loop."""
    def cond(k: int) -> bool:
        return _sum_filter(values, float(n - k)) >= 1.0

    if cond(0):
        return float(n)
    lo, hi = 1, 1
    while hi < n and not cond(hi):
        lo = hi + 1
        hi = min(2 * hi, n)
    while lo < hi:
        mid = (lo + hi) // 2
        if cond(mid):
            hi = mid
        else:
            lo = mid + 1
    return float(n - lo)


def _lower_bound(values: np.ndarray) -> float:
    """Reference loop :26-34: L = eps + 0.05·k, smallest k with
    Σ λₖ/(λₖ+L) ≤ q, where q = 1-based argmin |λₖ − λ₁/1000|."""
    q = int(np.argmin(np.abs(values - values.max() / 1000.0))) + 1
    if _sum_filter(values, _EPS) <= q:
        return _EPS
    # smallest k >= 1 with cond; cond monotone in k
    hi = 1
    while _sum_filter(values, _EPS + 0.05 * hi) > q:
        hi *= 2
    lo = max(1, hi // 2)
    while lo < hi:
        mid = (lo + hi) // 2
        if _sum_filter(values, _EPS + 0.05 * mid) <= q:
            hi = mid
        else:
            lo = mid + 1
    return _EPS + 0.05 * lo


import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=())
def _golden_search_device(vectors, values, Qty, Q2, L, U, tol):
    """The golden-section loop as a single on-device ``lax.while_loop``.

    Identical control flow to the host loop below (and to the reference's
    ``bLambdaSearch`` :55-77), but the ~16 sequential LOO evaluations run
    without a host↔device round trip each — one round trip instead of
    ~16.
    """
    gold = jnp.asarray(_GOLD, Qty.dtype)

    def loo(lam):
        filt = 1.0 / (values + lam)
        w = Qty * filt
        coeffs = vectors @ w
        ginv_diag = Q2 @ filt
        return jnp.sum((coeffs / ginv_diag) ** 2)

    X1 = L + gold * (U - L)
    X2 = U - gold * (U - L)
    state = (L, U, X1, X2, loo(X1), loo(X2), jnp.asarray(0, jnp.int32))

    def cond(state):
        _, _, _, _, S1, S2, it = state
        return jnp.logical_and(jnp.abs(S1 - S2) > tol, it < 10_000)

    def body(state):
        L, U, X1, X2, S1, S2, it = state

        def left(_):
            U2 = X2
            X2n = X1
            X1n = L + gold * (U2 - L)
            return (L, U2, X1n, X2n, loo(X1n), S1, it + 1)

        def right(_):
            L2 = X1
            X1n = X2
            X2n = U - gold * (U - L2)
            return (L2, U, X1n, X2n, S2, loo(X2n), it + 1)

        return jax.lax.cond(S1 < S2, left, right, None)

    L, U, X1, X2, S1, S2, it = jax.lax.while_loop(cond, body, state)
    return jnp.where(S1 < S2, X1, X2), it


def _resolve_bounds(eig: Eigensystem, n: int, L, U, tol):
    """Shared bound/tolerance defaulting for BOTH stepwise λ paths —
    the heuristics are parity-critical (CLAUDE.md), so they exist in
    exactly one place (code-review r05).  Returns ``(L, U, tol)`` as
    floats, bounds computed over the FULL value list like the
    reference."""
    values_full = np.asarray(eig.values_full, dtype=np.float64)
    if tol is None:
        tol = 1e-3 * n
    if U is None:
        U = _upper_bound(values_full, n)
    if L is None:
        L = _lower_bound(values_full)
    return float(L), float(U), float(tol)


def lambda_search_solve(
    eig: Eigensystem,
    y_std,
    L: Optional[float] = None,
    U: Optional[float] = None,
    tol: Optional[float] = None,
):
    """Bound heuristics (host, exact — same code as :func:`lambda_search`)
    + golden-section search + the final spectral solve as ONE device
    dispatch, via the proven ``ops.adaptive._golden_solve`` program
    (identical control flow to ``_golden_search_device`` followed by
    ``solve_for_c``; equality pinned by the fused/adaptive tests).
    Returns ``(lam, Le, coeffs)`` with ``Le``/``coeffs`` still on
    device.  The stepwise fit uses this when it is not logging per-
    iteration brackets — one dispatch + one λ fetch instead of
    search-dispatch → λ fetch → solve-dispatch (r05 fetch discipline;
    noisy fits keep the host loop for reference-formatted logs)."""
    L, U, tol = _resolve_bounds(eig, int(y_std.shape[0]), L, U, tol)
    from .ops.adaptive import _golden_solve
    dt = y_std.dtype
    lam, Le, coeffs, _ = _golden_solve(
        eig.vectors, eig.values, y_std, jnp.asarray(L, dt),
        jnp.asarray(U, dt), jnp.asarray(tol, dt))
    return float(lam), Le, coeffs


def lambda_search(
    eig: Eigensystem,
    y_std,
    L: Optional[float] = None,
    U: Optional[float] = None,
    tol: Optional[float] = None,
    noisy: bool = False,
    device_loop: bool = True,
    log: Callable[[str], None] = print,
) -> float:
    """Golden-section search; returns λ*.

    Matches ``bLambdaSearch(L, U, y, Eigenobject, tol, noisy)``.
    Bounds heuristics consume the FULL eigenvalue list (reference passes
    ``Eigenobject$values`` untruncated); the LOO evaluations use the
    truncated system, as in ``BigSolveForc``.
    """
    n = int(y_std.shape[0])
    L, U, tol = _resolve_bounds(eig, n, L, U, tol)

    Qty, Q2 = solve_precompute(eig.vectors, y_std)
    vals_trunc = eig.values

    if device_loop and not noisy:
        dt = y_std.dtype
        lam, _ = _golden_search_device(
            eig.vectors, vals_trunc, Qty, Q2,
            jnp.asarray(L, dt), jnp.asarray(U, dt), jnp.asarray(tol, dt))
        return float(lam)

    def loo(lams):
        arr = jnp.asarray(lams, dtype=y_std.dtype)
        return np.asarray(loo_loss_batch(eig.vectors, vals_trunc, Qty, Q2, arr))

    X1 = L + _GOLD * (U - L)
    X2 = U - _GOLD * (U - L)
    S = loo([X1, X2])
    S1, S2 = float(S[0]), float(S[1])
    if noisy:
        log(f"L: {L:.3f} X1: {X1:.3f} X2: {X2:.3f} U: {U:.3f} "
            f"S1: {S1:.3f} S2: {S2:.3f}")

    it = 0
    while abs(S1 - S2) > tol:
        if S1 < S2:
            U = X2
            X2 = X1
            X1 = L + _GOLD * (U - L)
            S2 = S1
            S1 = float(loo([X1])[0])
        else:
            L = X1
            X1 = X2
            X2 = U - _GOLD * (U - L)
            S1 = S2
            S2 = float(loo([X2])[0])
        it += 1
        if noisy:
            log(f"L: {L:.3f} X1: {X1:.3f} X2: {X2:.3f} U: {U:.3f} "
                f"S1: {S1:.3f} S2: {S2:.3f}")
        if it > 10000:  # defensive; reference typically converges in ~16
            break

    out = X1 if S1 < S2 else X2
    if noisy:
        log(f"lambda = {out:.5f}")
    return float(out)
