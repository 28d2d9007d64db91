"""Adaptive-truncation eigensolver for the default dense fit.

The reference's default fit at N > 3000 sets ``eigtrunc = 0.001`` and then
computes the FULL O(N³) eigendecomposition anyway, discarding everything
below ``eigtrunc·λ₁`` afterwards (``R/bigKRLS.R:195-204`` +
``R/bigKRLS_Rcpp_functions.R:190-197`` — the pipeline only ever *consumes*
the top ``lastkeeper`` eigenpairs).  On the real 2016 election data the
standardized kernel keeps 225 of 3106 pairs, so ~93% of the dense ``eigh``
is wasted work.  This module computes only ~``lastkeeper`` eigenpairs by
progressive block-Krylov iteration (all GEMMs, ``ops/eig.py``) and
*verifies a posteriori* that the truncation condition was captured, falling
back to the exact dense path when it was not.

The one thing that genuinely needs the full spectrum is the λ-search bound
heuristics (and Neffective): ``L`` is the smallest ``eps + 0.05k`` with
``Σᵢ λᵢ/(λᵢ+L) ≤ q`` (``R/bigKRLS_Rcpp_functions.R:26-34``), a sum over ALL
N eigenvalues — and on real data λ* pins exactly at ``L``, so truncating
the value list silently shifts λ* (measured 0.26 vs 1.50 on the election
data).  Instead of computing all N eigenvalues, the tail spectrum is
reconstructed from its **exact power-sum moments**:

    tr(R^j),  j = 1..5,   R = K − Q̂ Λ̂ Q̂ᵀ  (the deflated residual)

— three extra N×N GEMMs (R, R², R³), no eigensolver.  Deflating *first*
avoids the catastrophic ``tr(K^j) − Σ λ̂ʲ`` cancellation (tr(K³) ≈ 4·10⁸
while the tail's third moment is ≈ 13 on the election data).  A 3-point
Gauss quadrature matched to (m₀..m₅) then stands in for the n−k trailing
eigenvalues in every bound / Neffective sum:

    Σ_tail f(λ) ≈ Σ_atoms wᵢ f(θᵢ)

Measured on the election data (k=256): λ* and the L/U bounds come out
*identical* to the full path, coefficients match to 1e-7, and Neffective
to 1e-3 — at a fraction of the dense-eigh cost.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..types import Eigensystem
from .eig import _subspace_iteration, lastkeeper_from_values

_EPS = 2.220446049250313e-16  # R's .Machine$double.eps


@functools.partial(jax.jit, static_argnames=("k", "iters"))
def _krylov_moments(K, key, k: int, iters: int):
    """Top-k block-Krylov eigenpairs of K plus the deflated-residual
    power-sum moments m₁..m₅ = tr(Rʲ), R = K − Q̂Λ̂Q̂ᵀ.

    One fused device program: the Krylov work is (N,N)×(N,q) GEMMs, the
    moment work is two N×N GEMMs (R², R³ = R²·R) plus Frobenius inner
    products — everything is dense linear algebra on the device.
    """
    vals, vecs = _subspace_iteration(K, key, k, iters)
    R = K - (vecs * vals[None, :]) @ vecs.T
    R = 0.5 * (R + R.T)
    R2 = R @ R
    R3 = R2 @ R
    m1 = jnp.trace(R)
    m2 = jnp.sum(R * R)
    m3 = jnp.trace(R3)
    m4 = jnp.sum(R2 * R2)
    m5 = jnp.sum(R2 * R3)
    return vals, -vecs, jnp.stack([m1, m2, m3, m4, m5])


def tail_quadrature(moments: np.ndarray, npts: int):
    """Gauss-quadrature atoms/weights from power-sum moments m₀..m_{2npts−1}
    of a nonnegative measure (the classical Hankel → Jacobi route).

    Returns ``(theta, w)`` or ``None`` when the (scaled) Hankel moment
    matrix is not positive definite or an atom comes out negative —
    callers degrade ``npts`` until a valid quadrature exists.
    """
    m = np.asarray(moments, dtype=np.float64)
    m0 = float(m[0])
    if m0 <= 0.0 or m[1] <= 0.0:
        return np.zeros(0), np.zeros(0)
    if npts == 1:
        return np.array([m[1] / m0]), np.array([m0])
    # scale for conditioning: unit count, unit mean
    s = m[1] / m0
    ms = np.array([m[j] / (m0 * s ** j) for j in range(2 * npts)])
    H = np.array([[ms[i + j] for j in range(npts)] for i in range(npts)])
    H1 = np.array([[ms[i + j + 1] for j in range(npts)] for i in range(npts)])
    try:
        C = np.linalg.cholesky(H)
    except np.linalg.LinAlgError:
        return None
    Ci = np.linalg.inv(C)
    J = Ci @ H1 @ Ci.T
    J = 0.5 * (J + J.T)
    theta, V = np.linalg.eigh(J)
    if theta[0] < -1e-10:
        return None
    w = m0 * (V[0, :] ** 2)
    return np.maximum(theta, 0.0) * s, w


def _tail_atoms(tail_moments: np.ndarray, max_npts: int = 3):
    """Best valid quadrature, degrading 3 → 2 → 1 points as needed."""
    for npts in range(max_npts, 0, -1):
        out = tail_quadrature(tail_moments[: 2 * npts], npts)
        if out is not None:
            return out
    return np.zeros(0), np.zeros(0)


def _wsum(head: np.ndarray, theta: np.ndarray, w: np.ndarray,
          c: float) -> float:
    """Σ λ/(λ+c) over the completed spectrum (head values exactly, tail
    via quadrature atoms).  Degenerate atoms (θ=0, or zero weight) are
    masked explicitly: probing c=0 — which the U bisection does when it
    tests U=n−mid at mid=n — would otherwise produce 0/0 (ADVICE r04)."""
    denom = theta + c
    tail = np.where((w > 0) & (denom > 0),
                    w * theta / np.where(denom > 0, denom, 1.0), 0.0)
    return float(np.sum(head / (head + c)) + np.sum(tail))


def _upper_bound_completed(head, theta, w, n: int) -> float:
    """Reference U loop (``R/bigKRLS_Rcpp_functions.R:19-21``) on the
    completed spectrum: largest U ∈ {n, n−1, …} with Σ λ/(λ+U) ≥ 1."""
    if _wsum(head, theta, w, float(n)) >= 1.0:
        return float(n)
    lo, hi = 1, n
    while lo < hi:
        mid = (lo + hi) // 2
        if _wsum(head, theta, w, float(n - mid)) >= 1.0:
            hi = mid
        else:
            lo = mid + 1
    return float(n - lo)


def _lower_bound_completed(head, theta, w) -> float:
    """Reference L loop (``:26-34``) on the completed spectrum: smallest
    L = eps + 0.05k with Σ λ/(λ+L) ≤ q, q = 1-based argmin |λᵢ − λ₁/1000|.

    The q index is taken over the head only: valid because the
    a-posteriori truncation check in :func:`adaptive_eigensystem`
    verifies the head extends past ``min(eigtrunc, 1e-3)·λ₁`` — i.e.
    past the λ₁/1000 crossing even when the caller's ``eigtrunc`` is
    coarser than the 0.001 default (ADVICE r03, medium) — so the
    crossing always lies inside the computed head (tail atoms are
    aggregates, not order statistics, and must never supply q)."""
    q = int(np.argmin(np.abs(head - head[0] / 1000.0))) + 1
    if _wsum(head, theta, w, _EPS) <= q:
        return _EPS
    hi = 1
    while _wsum(head, theta, w, _EPS + 0.05 * hi) > q:
        hi *= 2
    lo = max(1, hi // 2)
    while lo < hi:
        mid = (lo + hi) // 2
        if _wsum(head, theta, w, _EPS + 0.05 * mid) <= q:
            hi = mid
        else:
            lo = mid + 1
    return _EPS + 0.05 * lo


def _round64(x: float) -> int:
    return int(math.ceil(x / 64.0)) * 64


def _extrapolate_khat(vals: np.ndarray, thresh: float) -> Optional[int]:
    """Log-linear decay extrapolation: at which index would the spectrum
    cross ``thresh``?  None when the computed head is too flat to say."""
    k = vals.shape[0]
    i0 = k // 2
    seg = vals[i0:]
    if np.any(seg <= 0):
        return k  # spectrum already hit zero: crossing is inside the head
    idx = np.arange(i0, k, dtype=np.float64)
    logs = np.log(seg)
    slope = np.polyfit(idx, logs, 1)[0]
    if slope >= -1e-12:
        return None
    return int(math.ceil(k + (math.log(thresh) - logs[-1]) / slope))


def _capture_plan(vals_np: np.ndarray, eigtrunc: float, k: int, kcap: int,
                  n: Optional[int] = None, margin: int = 8,
                  noisy: bool = False,
                  log: Callable[[str], None] = print):
    """A-posteriori truncation-capture decision shared by the fused and
    stepwise adaptive drivers.  Returns ``("ok", lastkeeper)``,
    ``("grow", knext)`` or ``("fallback", None)``.

    Capture must reach past BOTH eigtrunc·λ₁ (the truncation rule) and
    λ₁/1000 (the λ-search q-index input) — with a coarse eigtrunc the
    second is the binding one (ADVICE r03, medium)."""
    n = vals_np.shape[0] if n is None else n
    cap_trunc = min(eigtrunc, 1e-3)
    cap_thresh = cap_trunc * vals_np[0]
    k_capture = lastkeeper_from_values(vals_np, cap_trunc)
    lastkeeper = lastkeeper_from_values(vals_np, eigtrunc)
    if vals_np[k - 1] < cap_thresh and k_capture <= k - margin:
        return "ok", lastkeeper
    khat = _extrapolate_khat(vals_np, cap_thresh)
    if khat is None or khat > kcap:
        if noisy:
            log(f"  adaptive eig: spectrum too flat (needs "
                f"~{khat if khat else '>' + str(kcap)} of {n} pairs); "
                "falling back to exact dense eigh")
        return "fallback", None
    knext = min(_round64(max(1.25 * khat + margin, 1.5 * k)), kcap)
    if knext <= k:
        if noisy:
            log("  adaptive eig: cannot grow past the dense-crossover "
                "width; falling back to exact dense eigh")
        return "fallback", None
    if noisy:
        log(f"  adaptive eig: truncation not captured at k={k}, "
            f"growing to k={knext}")
    return "grow", knext


@dataclasses.dataclass
class AdaptiveEig:
    """Result of the adaptive path: a truncated eigensystem plus the
    moment-completed spectrum functionals the λ-search and Neffective
    need from the not-computed tail."""

    eig: Eigensystem
    L: float                 # completed-spectrum λ-search lower bound
    U: float                 # completed-spectrum λ-search upper bound
    k: int                   # eigenpairs actually computed
    tail_theta: np.ndarray   # quadrature atoms standing in for the tail
    tail_w: np.ndarray

    def neffective(self, lam: float, n: int) -> float:
        """N − Σ λ/(λ+λ*) over the completed spectrum (reference
        ``R/bigKRLS.R:280`` computes this over all N eigenvalues)."""
        head = np.asarray(self.eig.values_full, dtype=np.float64)
        return float(n) - _wsum(head, self.tail_theta, self.tail_w, lam)


def _hankel(ms, npts: int, offset: int):
    return jnp.stack([jnp.stack([ms[i + j + offset] for j in range(npts)])
                      for i in range(npts)])


def _quad_device(m, npts: int):
    """One candidate ``npts``-point quadrature from device moments
    m[0..5] (m[0] = tail count) — the on-device mirror of
    :func:`tail_quadrature`.  Returns (theta, w, valid) with theta/w
    zero-padded to 3 atoms; ``valid`` is False exactly where the host
    version returns ``None`` (non-PD scaled Hankel / negative atom)."""
    dt = m.dtype
    if npts == 1:
        theta = jnp.stack([m[1] / m[0],
                           jnp.zeros((), dt), jnp.zeros((), dt)])
        w = jnp.stack([m[0], jnp.zeros((), dt), jnp.zeros((), dt)])
        return theta, w, jnp.asarray(True)
    s = m[1] / m[0]
    ms = m[: 2 * npts] / (m[0] * s ** jnp.arange(2 * npts, dtype=dt))
    H = _hankel(ms, npts, 0)
    H1 = _hankel(ms, npts, 1)
    C = jnp.linalg.cholesky(H)
    chol_ok = jnp.all(jnp.isfinite(C))
    # guard the downstream solves against NaN/Inf from a failed factor
    Cs = jnp.where(chol_ok, C, jnp.eye(npts, dtype=dt))
    Ci = jax.scipy.linalg.solve_triangular(Cs, jnp.eye(npts, dtype=dt),
                                           lower=True)
    J = Ci @ H1 @ Ci.T
    theta_s, V = jnp.linalg.eigh(0.5 * (J + J.T))
    valid = chol_ok & (theta_s[0] >= -1e-10) & jnp.all(jnp.isfinite(theta_s))
    theta = jnp.maximum(theta_s, 0.0) * s
    w = m[0] * V[0, :] ** 2
    pad = 3 - npts
    theta = jnp.concatenate([theta, jnp.zeros((pad,), dt)])
    w = jnp.concatenate([w, jnp.zeros((pad,), dt)])
    return theta, w, valid


def _tail_atoms_device(moments, m0):
    """Best valid quadrature (3 → 2 → 1 points, like :func:`_tail_atoms`)
    computed on device: all three candidates are tiny fixed-shape
    problems; the first valid one is selected with ``where``."""
    dt = moments.dtype
    m = jnp.concatenate([m0[None], jnp.maximum(moments, 0.0)])
    t3, w3, v3 = _quad_device(m, 3)
    t2, w2, v2 = _quad_device(m, 2)
    t1, w1, v1 = _quad_device(m, 1)
    zero = jnp.zeros((3,), dt)
    theta = jnp.where(v3, t3, jnp.where(v2, t2, jnp.where(v1, t1, zero)))
    w = jnp.where(v3, w3, jnp.where(v2, w2, jnp.where(v1, w1, zero)))
    base = (m[0] > 0) & (m[1] > 0)
    return jnp.where(base, theta, zero), jnp.where(base, w, zero)


def _wsum_device(values, theta, w, c):
    """Σ λ/(λ+c) over the completed spectrum, on device.  Pad atoms
    (θ=w=0) are masked EXPLICITLY: on a degenerate spectrum the U
    bisection can probe c = n−mid = 0, where the unmasked expression is
    0·0/(0+0) = NaN, NaN comparisons read False, and the bisection
    returns a garbage U (the f64 host oracle catches the mismatch, but
    every such fit then pays an avoidable redispatch — ADVICE r04)."""
    denom = theta + c
    tail = jnp.where((w > 0) & (denom > 0),
                     w * theta / jnp.where(denom > 0, denom,
                                           jnp.ones_like(denom)),
                     0.0)
    return jnp.sum(values / (values + c)) + jnp.sum(tail)


def _upper_bound_completed_device(values, theta, w, n: int):
    """Device mirror of :func:`_upper_bound_completed` (integer bisection
    over k = n−U; same structure as ``ops.fused._upper_bound_device``
    but the filter sums include the tail atoms)."""
    dt = values.dtype

    def cond_k(k):
        return _wsum_device(values, theta, w,
                            jnp.asarray(n, dt) - k) >= 1.0

    nbits = max(1, (n + 1).bit_length())

    def body(_, lohi):
        lo, hi = lohi
        mid = (lo + hi) // 2
        hit = cond_k(mid.astype(dt))
        return jnp.where(hit, lo, mid + 1), jnp.where(hit, mid, hi)

    lo, _ = jax.lax.fori_loop(
        0, nbits, body, (jnp.asarray(0, jnp.int32),
                         jnp.asarray(n, jnp.int32)))
    return jnp.asarray(n, dt) - lo.astype(dt)


def _lower_bound_completed_device(values, theta, w):
    """Device mirror of :func:`_lower_bound_completed`.  The q index is
    taken over the computed head only — legitimate for the same reason
    as the host version (the capture check guarantees the head crosses
    λ₁/1000)."""
    dt = values.dtype
    eps = jnp.asarray(_EPS, dt)
    q = jnp.argmin(jnp.abs(values - values[0] / 1000.0)) + 1
    qf = q.astype(dt)

    def cond_k(k):
        return _wsum_device(values, theta, w, eps + 0.05 * k) <= qf

    # bracket: the condition surely holds once L ≥ S·λ₁/q (S = total
    # mass ≤ n).  Saturate BEFORE the int cast: at large N the float
    # value exceeds 2³¹ and float→int32 overflow is implementation-
    # defined in XLA — a wrapped negative bracket would invert the
    # bisection and silently garbage L (caught by the host f64 oracle,
    # but then every fit pays the redispatch).  48 bisection iterations
    # cover any bracket ≤ 2³¹ anyway.
    k_hi_f = jnp.ceil((_wsum_device(values, theta, w,
                                    jnp.asarray(0.0, dt))
                       * values[0] / qf) / 0.05) + 1.0
    k_hi = jnp.minimum(k_hi_f, 2.0 ** 31 - 1).astype(jnp.int32)

    def body(_, lohi):
        lo, hi = lohi
        mid = (lo + hi) // 2
        hit = cond_k(mid.astype(dt))
        return jnp.where(hit, lo, mid + 1), jnp.where(hit, mid, hi)

    lo, _ = jax.lax.fori_loop(0, 48, body,
                              (jnp.asarray(0, jnp.int32), k_hi))
    return eps + 0.05 * lo.astype(dt)


@jax.jit
def _golden_solve(vectors, values, y_std, L, U, tol):
    """Golden-section λ search + final spectral solve as ONE device
    program — identical control flow to
    ``lambda_search._golden_search_device`` followed by ``solve_for_c``
    (equality pinned by tests), but the adaptive path saves the extra
    dispatches: each host↔device round trip idles the device, and the
    whole adaptive region is latency-bound (ops/fused.py rationale)."""
    gold = jnp.asarray(0.381966, y_std.dtype)
    Qty = vectors.T @ y_std
    Q2 = vectors * vectors

    def loo_c(lam):
        filt = 1.0 / (values + lam)
        coeffs = vectors @ (Qty * filt)
        ginv_diag = Q2 @ filt
        return jnp.sum((coeffs / ginv_diag) ** 2), coeffs

    def loo(lam):
        return loo_c(lam)[0]

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
            X1n = L + gold * (U2 - L)
            return (L, U2, X1n, X1, loo(X1n), S1, it + 1)

        def right(_):
            L2 = X1
            X2n = U - gold * (U - L2)
            return (L2, U, X2, X2n, S2, loo(X2n), it + 1)

        return jax.lax.cond(S1 < S2, left, right, None)

    L, U, X1, X2, S1, S2, it = jax.lax.while_loop(cond, body, state)
    lam = jnp.where(S1 < S2, X1, X2)
    Le, coeffs = loo_c(lam)
    return lam, Le, coeffs, it


@functools.partial(jax.jit, static_argnames=("k", "iters", "extra"))
def _adaptive_fused(K, y_std, key, k: int, iters: int, eigtrunc, tol,
                    extra: Optional[int] = None):
    """The ENTIRE adaptive post-kernel region as ONE device program
    (VERDICT r03 next-round #6): block-Krylov top-k + deflated tail
    moments + on-device 3-point moment quadrature + completed-spectrum
    λ bounds + golden-section search + spectral solve.  The previous
    design was two dispatches with a host round trip for the quadrature
    between them — pure round-trip latency on a region whose whole
    compute is short.

    Truncation without dynamic shapes: like ``ops/fused.py``, the
    spectral filter is multiplied by a mask zeroing columns ≥ lastkeeper
    (algebraically identical to the hard slice).

    The caller still fetches ``(values, moments, lastkeeper, L, U)`` at
    the end (one round trip) to a-posteriori verify the truncation
    capture AND to check the device bounds against the exact f64 host
    oracle — if either check fails, the host grows k / re-solves with
    exact bounds, so working-precision bound arithmetic can never
    silently shift λ* (the parity-critical quantity)."""
    n = K.shape[0]
    dt = y_std.dtype
    vals, vecs = _subspace_iteration(K, key, k, iters, extra)
    R = K - (vecs * vals[None, :]) @ vecs.T
    R = 0.5 * (R + R.T)
    R2 = R @ R
    R3 = R2 @ R
    moments = jnp.stack([jnp.trace(R), jnp.sum(R * R), jnp.trace(R3),
                         jnp.sum(R2 * R2), jnp.sum(R2 * R3)])
    vecs = -vecs

    # lastkeeper as a mask (no dynamic shapes inside one program)
    keep = vals >= eigtrunc * vals[0]
    idx = jnp.arange(k)
    lastkeeper = jnp.maximum(jnp.max(jnp.where(keep, idx, -1)) + 1, 1)
    mask = (idx < lastkeeper).astype(dt)

    theta, w = _tail_atoms_device(moments, jnp.asarray(n - k, dt))
    L = _lower_bound_completed_device(vals, theta, w)
    U = _upper_bound_completed_device(vals, theta, w, n)

    # golden search + solve on the masked basis (same control flow as
    # _golden_solve; equality pinned by tests)
    gold = jnp.asarray(0.381966, dt)
    Qty = vecs.T @ y_std
    Q2 = vecs * vecs

    def loo_c(lam):
        filt = mask / (vals + lam)
        coeffs = vecs @ (Qty * filt)
        ginv_diag = Q2 @ filt
        return jnp.sum((coeffs / ginv_diag) ** 2), coeffs

    def loo(lam):
        return loo_c(lam)[0]

    X1 = L + gold * (U - L)
    X2 = U - gold * (U - L)
    state = (L, U, X1, X2, loo(X1), loo(X2), jnp.asarray(0, jnp.int32))

    def cond(state):
        _, _, _, _, S1, S2, it = state
        return jnp.logical_and(jnp.abs(S1 - S2) > tol, it < 10_000)

    def body(state):
        L_, U_, X1, X2, S1, S2, it = state

        def left(_):
            U2 = X2
            X1n = L_ + gold * (U2 - L_)
            return (L_, U2, X1n, X1, loo(X1n), S1, it + 1)

        def right(_):
            L2 = X1
            X2n = U_ - gold * (U_ - L2)
            return (L2, U_, X2, X2n, S2, loo(X2n), it + 1)

        return jax.lax.cond(S1 < S2, left, right, None)

    Lf, Uf, X1, X2, S1, S2, it = jax.lax.while_loop(cond, body, state)
    lam = jnp.where(S1 < S2, X1, X2)
    Le, coeffs = loo_c(lam)
    # the vcov spectral filter (sans the σ̂² scale, which needs the
    # residuals): free here, saves the caller a separate dispatch
    spectrum = mask / (vals + lam) ** 2
    return (vals, vecs, moments, lastkeeper, theta, w, L, U,
            lam, Le, coeffs, spectrum, it)


@functools.lru_cache(maxsize=8)
def _replicator(rep):
    """One jitted identity per target sharding — a fresh ``jax.jit``
    per call would never hit the trace cache and recompile the reshard
    program on every fetch (code-review r05)."""
    return jax.jit(lambda *ys: ys, out_shardings=rep)


def _fetch_replicated(xs, mesh=None):
    """``device_get`` that is safe on multi-process meshes (ADVICE r04):
    if GSPMD left any of the small fused-program outputs sharded across
    non-addressable devices, reshard them replicated through ONE jitted
    identity first — a fully replicated array is host-readable on every
    process, a non-addressable sharded one is not."""
    if mesh is not None and any(
            isinstance(x, jax.Array) and not x.is_fully_addressable
            and not x.sharding.is_fully_replicated for x in xs):
        from jax.sharding import NamedSharding, PartitionSpec
        xs = _replicator(NamedSharding(mesh, PartitionSpec()))(*xs)
    return jax.device_get(xs)


def postkernel_adaptive(K, y_std, eigtrunc: float, tol: float,
                        iters: Optional[int] = None, noisy: bool = False,
                        mesh=None, log: Callable[[str], None] = print):
    """The adaptive post-kernel fit in ONE device dispatch
    (:func:`_adaptive_fused`) plus one result fetch.  Returns
    ``(AdaptiveEig, lam, Le, coeffs, spectrum)`` — ``spectrum`` is the
    masked vcov filter ``1/(λ+λ*)²`` (σ̂²-scale applied by the caller;
    it comes straight out of the fused program, no extra dispatch) —
    or ``None`` when the dense path is the right call.  Shared by
    ``model.fit`` and ``bench.py`` so both measure the same code.

    Verification protocol (nothing is trusted at working precision):

    * truncation capture is checked a posteriori on the fetched values
      (grow k and redispatch, or fall back to dense — exactly as
      :func:`adaptive_eigensystem`);
    * the device-computed λ bounds are compared against the exact f64
      host recomputation from the same values/moments; a mismatch
      (different bisection step selected) triggers one extra
      golden+solve dispatch with the exact bounds.  Matching bounds ⇒
      the fused λ/coefficients are exactly what the two-dispatch path
      would have produced.

    ``mesh``: the adaptive route is mesh-capable (VERDICT r03 #1) — K
    arrives block-sharded, every Krylov/moment GEMM runs partitioned
    (XLA propagates the operand shardings), and the returned eigenbasis
    is committed row-sharded so all downstream O(N·k) work stays
    distributed.  Only the tiny Ritz/quadrature objects are replicated."""
    n = int(K.shape[0])
    dt = y_std.dtype
    if K.dtype == jnp.float64:
        # f64 parity config: deep basis + default oversampling (what the
        # CPU oracle tests pin at 1e-7 coefficient agreement)
        iters = 5 if iters is None else iters
        extra = None
    else:
        # f32: depth 3 with minimal (+8) oversampling already sits at
        # the f32 noise floor (measured vs a depth-6 wide reference on
        # the election data: max rel eigenvalue error 1.5e-6 — same as
        # depth 4 wide; the Ritz eigh is width³ and dominates the region)
        iters = 3 if iters is None else iters
        extra = 8
    kcap = (int(n * 0.25) // 64) * 64
    if kcap < 64:
        if noisy:
            log("  adaptive eig: N too small to truncate profitably; "
                "using exact dense eigh")
        return None
    k = min(_round64(max(64, n / 16.0)), kcap)
    key = jax.random.PRNGKey(0)

    for attempt in range(3):
        (vals, vecs, moments, lk_d, theta_d, w_d, L_d, U_d, lam_d, Le_d,
         coeffs_d, spectrum_d, _it) = _adaptive_fused(
            K, y_std, key, k, iters, jnp.asarray(eigtrunc, dt),
            jnp.asarray(tol, dt), extra)
        # ONE round trip for EVERYTHING the host needs — including λ*
        # and the LOO loss: a separate float(lam_d) later would be a
        # second round trip on a latency-bound region
        (vals_np, m_np, lk_dev, L_dev, U_dev, lam_h,
         Le_h) = _fetch_replicated(
            (vals, moments, lk_d, L_d, U_d, lam_d, Le_d), mesh)
        vals_np = np.asarray(vals_np, dtype=np.float64)
        if np.any(np.isnan(vals_np)):
            # reference guard (R/bigKRLS_Rcpp_functions.R:8-9)
            raise ValueError(
                "Missing eigenvalues prevent obtaining the regularization "
                "parameter lambda. Check for repeated observations (or "
                "other perfect linear combinations in X).")
        plan, aux = _capture_plan(vals_np, eigtrunc, k, kcap, n=n,
                                  noisy=noisy, log=log)
        if plan == "ok":
            lastkeeper = aux
            break
        if plan == "fallback":
            return None
        k = aux
    else:
        if noisy:
            log("  adaptive eig: truncation not captured after 3 attempts; "
                "falling back to exact dense eigh")
        return None

    # exact f64 bounds from the fetched values/moments (the oracle)
    m_np = np.asarray(m_np, dtype=np.float64)
    tail_m = np.concatenate([[float(n - k)], np.maximum(m_np, 0.0)])
    theta, w = _tail_atoms(tail_m)
    L = _lower_bound_completed(vals_np, theta, w)
    U = _upper_bound_completed(vals_np, theta, w, n)
    if noisy:
        log(f"  adaptive eig: computed {k} of {n} eigenpairs "
            f"(lastkeeper={lastkeeper}); tail completed by "
            f"{theta.size}-point moment quadrature for the lambda bounds "
            f"(one fused dispatch)")

    vectors = vecs[:, :lastkeeper]
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        from ..parallel.sharded import commit
        vectors = commit(vectors, NamedSharding(
            mesh, PartitionSpec(mesh.axis_names[0], None)))
    eig = Eigensystem(values_full=vals, vectors=vectors,
                      lastkeeper=lastkeeper)
    out = AdaptiveEig(eig=eig, L=float(L), U=float(U), k=k,
                      tail_theta=theta, tail_w=w)

    # accept the fused solve only if the device bounds picked the SAME
    # bisection steps as the f64 oracle (grid steps are 0.05 / 1.0, so a
    # different step is far outside float rounding) and the device
    # lastkeeper agrees with the host's
    same_bounds = (abs(float(L_dev) - L) <= 1e-5 * max(1.0, abs(L))
                   and abs(float(U_dev) - U) <= 1e-5 * max(1.0, abs(U))
                   and int(lk_dev) == lastkeeper)
    if same_bounds:
        return out, float(lam_h), float(Le_h), coeffs_d, \
            spectrum_d[:lastkeeper]
    if noisy:
        log("  adaptive eig: working-precision bounds differ from the "
            "f64 oracle; re-running golden+solve with exact bounds")
    lam, Le, coeffs = resume_adaptive(out, y_std, tol)
    spectrum = 1.0 / (out.eig.values + lam) ** 2
    return out, lam, Le, coeffs, spectrum


def resume_adaptive(out: "AdaptiveEig", y_std, tol: float):
    """Golden search + spectral solve from a checkpointed
    :class:`AdaptiveEig` — the Krylov/moment work (the expensive prefix)
    is already done; only the single fused golden+solve dispatch runs.
    Returns ``(lam, Le, coeffs)``.  (VERDICT r03 next-round #5.)"""
    dt = y_std.dtype
    lam, Le, coeffs, _ = _golden_solve(
        out.eig.vectors, out.eig.values, y_std,
        jnp.asarray(out.L, dt), jnp.asarray(out.U, dt),
        jnp.asarray(tol, dt))
    return float(lam), Le, coeffs


def adaptive_eigensystem(
    K,
    eigtrunc: float,
    iters: Optional[int] = None,
    seed: int = 0,
    max_fraction: float = 0.25,
    margin: int = 8,
    noisy: bool = False,
    mesh=None,
    log: Callable[[str], None] = print,
) -> Optional[AdaptiveEig]:
    """Compute only ~lastkeeper eigenpairs of K, with verified truncation.

    Protocol (VERDICT r02 next-round #1):

    1. block-Krylov top-k pairs + deflated tail moments, k₀ ≈ N/16;
    2. verify a posteriori that the spectrum crossed
       ``min(eigtrunc, 1e-3)·λ₁`` at least ``margin`` indices before k
       (Ritz values at the basis edge are the least converged — the
       margin keeps the kept spectrum well inside the converged
       region).  The λ₁/1000 floor is NOT the truncation rule — it
       guarantees the λ-search's q index (1-based argmin
       |λᵢ − λ₁/1000|, a parity-critical bound input) is computable
       from the head alone even under a coarse ``eigtrunc`` like 0.01
       (ADVICE r03, medium);
    3. if not: extrapolate the decay to estimate the needed k, grow and
       retry — or return ``None`` (→ caller runs the exact dense eigh)
       when the estimate exceeds ``max_fraction·N``, where dense wins;
    4. build the 3-point tail quadrature and the completed-spectrum
       λ-search bounds.

    Returns ``None`` whenever the dense path is the right call; never
    silently degrades accuracy (the no-silent-caps rule).

    ``iters=None`` picks a precision-matched Krylov depth: 5 in f64
    (eigenvalue error ~1e-14, coefficient parity ≤1e-7 — what the f64
    oracle tests pin) and 4 in f32, where depth 4 already reaches ~8e-9
    relative eigenvalue error — two decades below f32's own 1.2e-7 eps,
    so a fifth iteration buys nothing but a wider (and slower) Ritz
    problem.
    """
    n = int(K.shape[0])
    if iters is None:
        iters = 5 if K.dtype == jnp.float64 else 4
    kcap = (int(n * max_fraction) // 64) * 64
    if kcap < 64:
        if noisy:
            log("  adaptive eig: N too small to truncate profitably; "
                "using exact dense eigh")
        return None
    k = min(_round64(max(64, n / 16.0)), kcap)
    key = jax.random.PRNGKey(seed)

    for attempt in range(3):
        vals, vecs, moments = _krylov_moments(K, key, k, iters)
        vals_np, m_np = jax.device_get((vals, moments))   # one round trip
        vals_np = np.asarray(vals_np, dtype=np.float64)
        if np.any(np.isnan(vals_np)):
            # reference guard (R/bigKRLS_Rcpp_functions.R:8-9)
            raise ValueError(
                "Missing eigenvalues prevent obtaining the regularization "
                "parameter lambda. Check for repeated observations (or "
                "other perfect linear combinations in X).")
        plan, aux = _capture_plan(vals_np, eigtrunc, k, kcap, n=n,
                                  margin=margin, noisy=noisy, log=log)
        if plan == "ok":
            lastkeeper = aux
            break
        if plan == "fallback":
            return None
        k = aux
    else:
        if noisy:
            log("  adaptive eig: truncation not captured after 3 attempts; "
                "falling back to exact dense eigh")
        return None

    # tail quadrature from the deflated moments; m0 = count of the tail
    m_np = np.asarray(m_np, dtype=np.float64)
    tail_m = np.concatenate([[float(n - k)], np.maximum(m_np, 0.0)])
    theta, w = _tail_atoms(tail_m)
    L = _lower_bound_completed(vals_np, theta, w)
    U = _upper_bound_completed(vals_np, theta, w, n)
    if noisy:
        log(f"  adaptive eig: computed {k} of {n} eigenpairs "
            f"(lastkeeper={lastkeeper}); tail completed by "
            f"{theta.size}-point moment quadrature for the lambda bounds")

    vectors = vecs[:, :lastkeeper]
    if mesh is not None:
        # commit the eigenbasis row-sharded over the mesh's first axis so
        # every downstream O(N·k) GEMM (golden solve, vcov quadratic
        # forms, derivative assembly) runs partitioned; the (k,) values
        # and quadrature atoms stay replicated — they are tiny
        from jax.sharding import NamedSharding, PartitionSpec
        from ..parallel.sharded import commit
        vectors = commit(vectors, NamedSharding(
            mesh, PartitionSpec(mesh.axis_names[0], None)))
    eig = Eigensystem(values_full=vals, vectors=vectors,
                      lastkeeper=lastkeeper)
    return AdaptiveEig(eig=eig, L=float(L), U=float(U), k=k,
                       tail_theta=theta, tail_w=w)
