"""Symmetric eigendecomposition of the kernel — full and truncated.

Replaces the reference's ``bEigen`` → ``BigEigen`` stack
(``R/bigKRLS_Rcpp_functions.R:173-199``, ``src/eigen.cpp:13-45``):

* full path: LAPACK ``eig_sym`` → here ``jnp.linalg.eigh`` (XLA's
  device eigensolver).
* truncated path (``Neig < N``): the reference calls ARPACK Lanczos via
  ``arma::eigs_sym`` after a wasteful dense→sparse copy
  (``src/eigen.cpp:20-22``).  Here the right tool depends on scale:

    - for N up to a few thousand, a full ``eigh`` followed by a top-``neig``
      slice is exact and avoids sequential Lanczos steps, so
      ``method="auto"`` does that below ``full_threshold``;
    - for large N, blocked **randomized subspace iteration** (GEMM-rich,
      trivially shardable over a device mesh) approximates the top-``neig``
      pairs; a Lanczos implementation with full reorthogonalization is also
      provided for spectra where subspace iteration converges slowly.

Conventions copied from the reference:

* eigenvalues returned **descending** (reference flips LAPACK's ascending
  output: ``flipud``/``fliplr``, ``src/eigen.cpp:28-29``);
* eigenvectors **negated** (``vecs <- -1*vecs``,
  ``R/bigKRLS_Rcpp_functions.R:186``) — the original-KRLS sign convention.
  Model outputs are invariant; kept for intermediate comparability;
* ``lastkeeper = max{ 1-based index k : values[k] >= eigtrunc·values[1] }``
  (``R/bigKRLS_Rcpp_functions.R:190``), applied to the **vectors only** —
  the full value list is retained for the λ-search bounds and Neffective.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..types import Eigensystem


@jax.jit
def _eigh_desc(K):
    vals, vecs = jnp.linalg.eigh(K)
    return vals[::-1], -vecs[:, ::-1]


def _dgks(B, W):
    """Block Gram–Schmidt of W against the orthonormal columns of B,
    applied twice ("twice is enough", DGKS) — keeps W ⊥ B to machine
    epsilon even when W has nearly converged into span(B).  Zero-padded
    (not yet filled) blocks of B contribute exactly nothing.  All GEMMs,
    so it shards with B."""
    for _ in range(2):
        W = W - B @ (B.T @ W)
    return W


def _block_orth(W):
    """Orthonormalize the columns of a tall block W.

    f64 (parity mode): Householder QR — the configuration the CPU
    oracle tests pin.

    f32 (throughput mode): **CholeskyQR²** — ``G = WᵀW`` (HIGHEST),
    Cholesky, triangular solve, applied twice.  All GEMMs plus one
    tiny q×q factorization in place of a tall Householder QR.  Two
    passes give Householder-level orthonormality whenever
    cond(W) ≲ 1/√eps_f32 ≈ 3e3 — comfortably true for DGKS-projected
    power blocks — and the breakdown case (non-PD Gram → NaN factor)
    falls back to Householder QR inside the program via ``lax.cond``, so
    quality can never silently degrade.

    Gated on block height ≥ 16384: below that the Householder QR is
    cheap, and keeping it keeps the f32 λ* of the adaptive and dense
    paths equal at the N=3106 shape (with CholQR it moved 1.5e-4 rel).
    The gate was chosen before the H100 port and is not yet measured
    on the H100."""
    if W.dtype == jnp.float64 or W.shape[0] < 16384:
        return jnp.linalg.qr(W)[0]

    def chol_pass(w):
        G = jnp.matmul(w.T, w, precision=jax.lax.Precision.HIGHEST)
        L = jnp.linalg.cholesky(G)
        q = jax.scipy.linalg.solve_triangular(L, w.T, lower=True).T
        return q, L

    Q1, L1 = chol_pass(W)
    Q2, L2 = chol_pass(Q1)
    # breakdown guard: finiteness alone misses the window where the Gram
    # Cholesky still "succeeds" numerically but Q2 is no longer
    # orthonormal (cond(W) a few thousand at f32 — e.g. un-projected
    # power blocks on a fast-decaying spectrum).  _ritz_topk assumes an
    # orthonormal basis, so verify ‖I − Q2ᵀQ2‖_max directly (one more
    # q×q GEMM, still ≫ cheaper than Householder) and fall back when it
    # exceeds ~100× the f32 epsilon.
    G2 = jnp.matmul(Q2.T, Q2, precision=jax.lax.Precision.HIGHEST)
    orth_err = jnp.max(jnp.abs(G2 - jnp.eye(G2.shape[0], dtype=G2.dtype)))
    ok = (jnp.all(jnp.isfinite(L1)) & jnp.all(jnp.isfinite(L2))
          & jnp.isfinite(orth_err) & (orth_err < 1e-5))
    # guard NaN poisoning: the cond branches see a finite operand
    Q2s = jnp.where(jnp.isfinite(Q2), Q2, 0.0)
    return jax.lax.cond(ok, lambda _: Q2s,
                        lambda _: jnp.linalg.qr(W)[0], None)


def _ritz_topk(B, KB, k: int):
    """Rayleigh–Ritz on an already-orthonormal basis: T = BᵀKB, top-k.
    No n×width QR — progressive DGKS (see ``_dgks``) keeps B orthonormal
    as it is built, which removes the single most expensive non-GEMM step
    of the old design (Householder QR of the n×(d·q) stacked basis)."""
    return _ritz_from_gram(B, B.T @ KB, k)


def _ritz_from_gram(B, T, k: int):
    """Top-k Ritz pairs of the projected operator ``T = BᵀKB``.  Only the
    k wanted Ritz vectors are formed (an n×k product, not n×width)."""
    T = 0.5 * (T + T.T)
    evals, S = jnp.linalg.eigh(T)          # ascending
    return evals[::-1][:k], B @ S[:, ::-1][:, :k]


def _krylov_geometry(n: int, k: int, iters: int,
                     extra: Optional[int] = None):
    """(q, progressive): block width, and whether the fast *progressive*
    basis flow applies.

    ``extra`` is the oversampling beyond k (default ``min(k,32)+8``).
    The Ritz eigenproblem is (iters+1)·q wide and its eigh is the
    dominant non-GEMM cost of the whole block-Krylov solve; extra=8 at
    depth 3 leaves the eigenvalue error at the f32 noise floor, so the
    adaptive path passes that trimmed value at f32.

    Progressive (large n: total width (iters+1)·q ≤ n) keeps the basis
    orthonormal as it grows (per-block QR + block DGKS) and reuses the
    recorded K·V products for Rayleigh–Ritz — no n×width Householder QR,
    no second fat kernel pass.  When the width would reach/exceed n
    (small n), the stacked-blocks + one fat reduced QR flow is used
    instead: the reduced QR caps the basis at the FULL space, making
    Rayleigh–Ritz exact there — progressive blocks beyond n would be
    pure numerical noise and must not be generated."""
    if extra is None:
        extra = min(k, 32) + 8
    q = min(n, k + extra)
    return q, (iters + 1) * q <= n


@functools.partial(jax.jit, static_argnames=("k", "iters", "extra"))
def _subspace_iteration(K, key, k: int, iters: int,
                        extra: Optional[int] = None):
    """Randomized **block-Krylov** iteration for the top-k eigenpairs of
    symmetric K (Musco & Musco 2015 style).

    All heavy work is (N,N)x(N,q) GEMMs — dense and shardable.
    Unlike plain subspace/power iteration (which discards each step's
    basis), every power step's block is *kept*: the Rayleigh–Ritz
    projection runs on the combined n×((d+1)·q) Krylov basis — a
    degree-``d`` polynomial approximation instead of a single power.  On
    slowly-decaying spectra (the λ-parity hard case, SURVEY.md §7 #1–2)
    this is the difference between ~1e-2 and ~1e-15 trailing-eigenvalue
    error; depth 8 is already at machine precision on a gap-free 1/k
    spectrum (measured, ``tests/test_lambda_parity.py``).

    At large n (total width (iters+1)·q ≤ n) the basis is kept
    orthonormal *progressively* (per-block QR + block DGKS against
    everything already stored) and each K@V_g product is recorded as the
    g-th block of K·B, so Rayleigh–Ritz needs neither an n×width
    Householder QR nor a second fat K·B product — T = BᵀKB comes from
    one small GEMM over already-computed pieces (plus a single extra
    width-q product for the last block).  At small n the stacked blocks
    are reduced by one fat QR instead, which caps the basis at the full
    space and makes Rayleigh–Ritz exact there (``_krylov_geometry``).
    """
    n = K.shape[0]
    q, progressive = _krylov_geometry(n, k, iters, extra)
    V = jax.random.normal(key, (n, q), dtype=K.dtype)
    V = _block_orth(V)

    if progressive:
        width = (iters + 1) * q
        B = jnp.zeros((n, width), K.dtype).at[:, :q].set(V)
        KBs = []
        for g in range(iters):        # static depth: unrolled under jit
            W = K @ V                 # K @ V_g — reused as KB block g
            KBs.append(W)
            W = _dgks(B, W)
            V = _block_orth(W)        # per-block conditioning
            B = B.at[:, (g + 1) * q:(g + 2) * q].set(V)
        KBs.append(K @ V)             # K @ V_d
        return _ritz_topk(B, jnp.concatenate(KBs, axis=1), k)

    blocks = [V]
    for _ in range(iters):            # small n: stacked blocks + fat QR
        W = K @ blocks[-1]
        W = _block_orth(W)            # per-block conditioning
        blocks.append(W)
    B = jnp.concatenate(blocks, axis=1)
    Q, _ = jnp.linalg.qr(B)           # reduced QR: n × min(n, (iters+1)q)
    return _ritz_topk(Q, K @ Q, k)


@functools.partial(jax.jit, static_argnames=("k",))
def _lanczos(K, key, k: int):
    """Lanczos with full reorthogonalization, m = min(N, 2k+32) steps.

    Mirrors the role of ARPACK's ``eigs_sym`` (``src/eigen.cpp:18-25``)
    using fixed-shape ``lax.scan`` so it compiles once.
    """
    n = K.shape[0]
    m = min(n, 2 * k + 32)
    v0 = jax.random.normal(key, (n,), dtype=K.dtype)
    v0 = v0 / jnp.linalg.norm(v0)

    V0 = jnp.zeros((m, n), K.dtype).at[0].set(v0)

    def body(carry, i):
        V, alphas, betas = carry
        v = V[i]
        w = K @ v
        alpha = jnp.dot(v, w)
        w = w - alpha * v
        # full reorthogonalization (twice for stability)
        w = w - V.T @ (V @ w)
        w = w - V.T @ (V @ w)
        beta = jnp.linalg.norm(w)
        vnext = w / jnp.maximum(beta, jnp.finfo(K.dtype).tiny)
        V = jax.lax.cond(i + 1 < m, lambda V: V.at[i + 1].set(vnext),
                         lambda V: V, V)
        return (V, alphas.at[i].set(alpha), betas.at[i].set(beta)), None

    carry = (V0, jnp.zeros((m,), K.dtype), jnp.zeros((m,), K.dtype))
    (V, alphas, betas), _ = jax.lax.scan(body, carry, jnp.arange(m))

    T = (jnp.diag(alphas) + jnp.diag(betas[:-1], 1) + jnp.diag(betas[:-1], -1))
    evals, S = jnp.linalg.eigh(T)
    evals = evals[::-1]
    S = S[:, ::-1]
    vecs = V.T @ S[:, :k]
    return evals[:k], vecs


@functools.partial(jax.jit, static_argnames=("q",))
def _subspace_init(X, key, q: int):
    V = jax.random.normal(key, (X.shape[0], q), dtype=X.dtype)
    return _block_orth(V)


def _cheb_degrees(nprod: int):
    """Split a product budget into Chebyshev application degrees.

    First application degree 2 (its cutoff comes from a *random*
    subspace's Ritz values, so a short filter limits the damage of a
    weak cutoff), then degree-3 applications while budget lasts — the
    longer filters run once the Gram Ritz values have sharpened the
    cutoff.  Degree-1 remainder is a shifted power step."""
    degrees = []
    budget = int(nprod)
    first = True
    while budget > 0:
        d = min(2 if first else 3, budget)
        degrees.append(d)
        budget -= d
        first = False
    return degrees


def _block_scale(U):
    """Scalar scale of a recurrence block (max-abs: overflow-proof at
    f32 even when the filter has amplified the block by ~1e8)."""
    return jnp.maximum(jnp.max(jnp.abs(U)), jnp.asarray(1e-30, U.dtype))


@functools.partial(jax.jit, static_argnames=("matmul",))
def _cheb_app_start(X, V, c_prev, sigma, matmul):
    """First product of a Chebyshev application: ``W = K·V`` plus the
    FREE cutoff update — the q×q Gram ``VᵀW`` is the Rayleigh quotient
    of the current orthonormal block, and its smallest eigenvalue
    θ_min ≤ λ_q (Cauchy interlacing), so ``c = max(c_prev, θ_min)`` can
    never damp a wanted direction (λ_neig > λ_q ≥ θ_min).  The Gram +
    its q×q eigh cost ~2Nq² + O(q³) FLOPs — noise next to the 2N²(P+q)
    product.  Returns the first two (scalar-rescaled) recurrence blocks
    ``T₀(K̃)V = V`` and ``T₁(K̃)V`` for ``K̃ = (2K − cI)/c`` (the affine
    map sending the damped interval [0, c] to [−1, 1]; the kernel is
    PSD so the spectrum has no meaningful mass below 0)."""
    W = matmul(X, V, sigma)
    S = jnp.matmul(V.T, W, precision=jax.lax.Precision.HIGHEST)
    S = 0.5 * (S + S.T)
    theta = jnp.linalg.eigvalsh(S)             # ascending
    c = jnp.maximum(jnp.maximum(c_prev, theta[0]), 1e-6 * theta[-1])
    Y = (2.0 / c) * W - V
    tau = _block_scale(Y)
    return V, Y / tau, 1.0 / tau, c


@functools.partial(jax.jit, static_argnames=("matmul",))
def _cheb_step(X, Yp, Yc, r, c, sigma, matmul):
    """One Chebyshev three-term recurrence step (one K@V product):
    ``Y_{j+1} = 2·K̃·Y_j − Y_{j−1}`` with K̃ as in
    :func:`_cheb_app_start`, carried in scalar-rescaled form (blocks are
    kept near unit scale; ``r`` is the previous block's relative scale)
    so degree-3 filters cannot overflow f32 even at λ₁/c ~ 1e8.  Scalar
    rescaling leaves the final block's column span — the only thing
    Rayleigh–Ritz consumes — exactly the Chebyshev-filtered subspace.

    Generic fallback for backends without an epilogue hook (ring,
    test doubles); the production XLA path uses
    :func:`_cheb_step_fused`, whose memory footprint matters at N=1M."""
    Z = matmul(X, Yc, sigma)
    U = (4.0 / c) * Z - 2.0 * Yc - r * Yp
    tau = _block_scale(U)
    return Yc, U / tau, 1.0 / tau


@functools.partial(jax.jit, static_argnames=("matmul",),
                   donate_argnums=(1,))
def _cheb_step_fused(X, Yp, Yc, r, c, sigma, matmul):
    """:func:`_cheb_step` with the recurrence epilogue folded into the
    product's accumulator: ``U = (K@Yc + init)·(4/c)`` with
    ``init = −(c/4)(2Yc + rYp)`` as the scan's initial carry — no
    separate Z or U block ever materializes, and ``Yp`` is donated so
    ``init`` can reuse its buffer.  This keeps the step at the plain
    power iteration's HBM footprint; the separate product-then-combine
    formulation holds Yp + Yc + Z + U + the kernel tile at once (2.2 GB
    blocks each at N=1M), which ran out of memory on a 16 GB device."""
    init = (-(c / 4.0)) * (2.0 * Yc + r * Yp)
    U = matmul(X, Yc, sigma, init=init, out_scale=4.0 / c)
    tau = _block_scale(U)
    return Yc, U / tau, 1.0 / tau


def _epilogue_capable(matmul) -> bool:
    """True when ``matmul`` is the XLA streaming product (possibly a
    functools.partial of it, e.g. ``kernel_matmul_fast``) and therefore
    accepts the fused ``init``/``out_scale`` epilogue."""
    from .matvec import kernel_matmul
    f = matmul
    while isinstance(f, functools.partial):
        f = f.func
    return f is kernel_matmul


@functools.partial(jax.jit, static_argnames=("steps", "matmul"))
def _power_chunk_blocks(X, V, sigma, steps: int, matmul):
    """``steps`` plain power iterations returning every intermediate
    block (stacked column-wise) — the small-n streaming flow, whose
    caller runs one fat reduced QR over the stacked basis
    (``_krylov_geometry``)."""
    blocks = []
    for _ in range(steps):               # static: unrolled under jit
        W = matmul(X, V, sigma)
        V = _block_orth(W)               # per-block conditioning
        blocks.append(V)
    return V, jnp.concatenate(blocks, axis=1)


@functools.partial(jax.jit, static_argnames=("k", "matmul"))
def _fatqr_ritz_streaming(X, B, sigma, k: int, matmul):
    """Rayleigh–Ritz after one fat reduced QR of the stacked (not yet
    mutually orthogonal) blocks; K·Q recomputed at full precision.  The
    QR caps the basis at the full space — exact there — and is only used
    when its n×width cost is small by construction (width ≳ n)."""
    Q, _ = jnp.linalg.qr(B)
    return _ritz_topk(Q, matmul(X, Q, sigma), k)


@functools.partial(jax.jit, static_argnames=("steps", "matmul", "store_kb"),
                   donate_argnums=(2, 3))
def _krylov_chunk(X, V, B, KB, g, sigma, steps: int, matmul,
                  store_kb: bool):
    """``steps`` kernel-free block-Krylov steps (K@V product + block DGKS
    + QR).  The host drives these in chunks so progress can be reported
    and Ctrl-C lands between device calls — the device-side analog of the
    reference's ``Rcpp::checkUserInterrupt()`` in every hot loop
    (SURVEY.md §2.13).

    ``B`` is the preallocated n×((d+1)·q) basis holding orthonormal
    blocks V_0..V_g (zeros beyond); each step stores K@V_g into ``KB``
    (when ``store_kb`` — the product is full-precision and reusable for
    Rayleigh–Ritz) and appends the next orthonormalized block to ``B``.
    ``g`` is a traced scalar so one compiled program serves every chunk.
    ``B`` and ``KB`` are donated and updated in place: at N=1M, neig=500
    they are 15 GB each, and an input and an output copy of both would
    not fit one 80 GB card.
    """
    q = V.shape[1]
    for _ in range(steps):               # static: unrolled under jit
        W = matmul(X, V, sigma)          # K @ V_g
        if store_kb:
            KB = jax.lax.dynamic_update_slice(
                KB, W, (jnp.asarray(0, g.dtype), g * q))
        W = _dgks(B, W)
        V = _block_orth(W)               # per-block conditioning
        g = g + 1
        B = jax.lax.dynamic_update_slice(
            B, V, (jnp.asarray(0, g.dtype), g * q))
    return V, B, KB, g


@functools.partial(jax.jit, static_argnames=("k", "matmul", "reuse_kb"))
def _krylov_ritz_streaming(X, B, KB, V_last, sigma, k: int, matmul,
                           reuse_kb: bool):
    """Rayleigh–Ritz for the streaming path.  With ``reuse_kb`` the power
    products already populated K·B at full precision and only the last
    block's product is computed here (width q); otherwise (reduced-
    precision power iterations) the whole K·B is recomputed with the
    full-precision ``matmul`` so Ritz quality never inherits fast-accum
    noise."""
    if reuse_kb:
        # KB's last block is still zero: fill T's last columns from the
        # fresh product instead of writing it into a copy of KB
        q = V_last.shape[1]
        W = matmul(X, V_last, sigma)
        T = (B.T @ KB).at[:, -q:].set(B.T @ W)
        return _ritz_from_gram(B, T, k)
    return _ritz_topk(B, matmul(X, B, sigma), k)


def _resolve_fast_power(fast_power, krylov: bool, progressive: bool) -> bool:
    """Resolve ``fast_power="auto"`` by the solver flow's FLOP structure:

    * progressive block-Krylov REUSES its full-precision power products
      as K·B for Rayleigh–Ritz.  Running the power products fast forces
      a full-width K·B recompute at full precision for Ritz, which costs
      one more full-width product than the power products save.  Auto
      keeps full precision here.
    * the constant-memory power flow (and the small-n stacked flow)
      recomputes K·B for Ritz regardless, so fast power products cost
      nothing extra there.
    """
    if fast_power != "auto":
        return bool(fast_power)
    return not (krylov and progressive)


def _auto_krylov(n: int, q: int, iters: int, itemsize: int,
                 budget: Optional[int] = None, fraction: float = 0.6) -> bool:
    """Pick block-Krylov vs constant-memory power iteration by memory fit.

    The progressive basis costs ~2·N·(iters+1)·q elements (B plus the
    recorded K·B); above ``fraction`` of the device's memory
    (``utils.memory.device_memory_budget``) the solver degrades to
    constant memory and logs why (no-silent-caps)."""
    basis_bytes = 2 * n * (iters + 1) * q * itemsize
    if budget is None:
        from ..utils.memory import device_memory_budget
        budget = device_memory_budget()
    ok = basis_bytes <= fraction * budget
    if not ok:
        import logging
        logging.getLogger("bigkrls_tpu").warning(
            "eigensystem_streaming: block-Krylov basis would need "
            "%.1f GB (> %d%% of %.1f GB device memory); using the "
            "constant-memory Chebyshev subspace iteration instead — "
            "raise `iters` if trailing-eigenvalue accuracy matters at "
            "this scale",
            basis_bytes / 1024 ** 3, int(fraction * 100),
            budget / 1024 ** 3)
    return ok


def eigensystem_streaming(
    X_std,
    sigma,
    neig: int,
    eigtrunc: float = 0.0,
    iters: int = 8,
    seed: int = 0,
    matmul=None,
    fast_power="auto",
    power_matmul=None,
    mesh=None,
    progress=None,
    chunk: int = 4,
    krylov: Optional[bool] = None,
) -> Eigensystem:
    """Truncated eigensystem of the (never-materialized) kernel of X_std.

    Kernel-free subspace iteration: each power step is one streaming K@V
    product (``ops/matvec.py``, or a ring matmul over a device mesh) —
    storage O(N·q), FLOPs 2N²(P+q) per iteration.  This is the
    eigensolver for N past one device's memory (SURVEY.md §7 hard parts #1/#4;
    replaces the reference's ARPACK ``eigs_sym``, ``src/eigen.cpp:18-25``).

    Same conventions as :func:`eigensystem` (descending values, negated
    vectors, lastkeeper truncation of the vectors only).  ``neig`` must be
    < N (streaming a full decomposition makes no sense).

    ``fast_power`` runs the power iterations' tile@V contraction at the
    platform's default precision (``kernel_matmul_fast``: TF32 on an
    H100, plain f32 on the CPU), with the final Rayleigh–Ritz still at
    full f32 (subspace iteration is self-correcting: each QR
    re-orthonormalizes, so accumulation noise only perturbs
    not-yet-converged directions; tolerance pinned by
    ``tests/test_streaming.py::test_fast_power_self_correcting``).  It
    applies to the XLA product only; a ring ``matmul`` keeps full
    precision and the option is logged as ignored.  The default
    ``"auto"`` enables it exactly where it is a net win — the flows
    whose Rayleigh–Ritz recomputes K·B anyway (see
    :func:`_resolve_fast_power`); True/False force it.

    ``mesh`` row-shards the returned eigenvectors over the mesh's first
    axis (callers pass a 1-D ring mesh together with its ring ``matmul``).

    ``progress(done, total)`` is called after every ``chunk`` iterations;
    when set, each chunk is synchronized (``block_until_ready``) so the
    callback reflects real completion and KeyboardInterrupt lands between
    chunks instead of after the whole decomposition.

    ``krylov=True`` keeps every power step's block (kept
    orthonormal progressively — per-block QR + block DGKS, see
    :func:`_subspace_iteration`) and runs the final Rayleigh–Ritz on the
    combined block-Krylov basis — same GEMM count as plain subspace
    iteration, dramatically better accuracy on slowly-decaying spectra;
    depth 8 is machine-precision on a gap-free 1/k spectrum.  Memory is
    O(N·q·d) for the basis (plus the same again for the recorded K·B
    when the power products run at full precision — they are then reused
    for Rayleigh–Ritz, saving a second full-width kernel pass);
    ``krylov=False`` forces the constant-memory flow: CHEBYSHEV-filtered
    subspace iteration (three-term recurrence between orthonormalization
    points; cutoff from the free per-application Gram Ritz values —
    interlacing keeps it below λ_q, so wanted directions are never
    damped).  Its filter quality per product is strictly better than
    plain power iteration's, so ``iters ≥ 4`` maps to ``iters − 2``
    products at measured equal-or-better accuracy on the slow-decay
    spectra this flow serves (see the inline measurement note at the
    dispatch site) — the 500k/1M product bill drops ~2/7.
    ``krylov=None`` (default) picks automatically: the block-Krylov
    basis unless its footprint (~2·N·(iters+1)·q elements) would exceed
    ~60% of the device's memory (``utils.memory``) — at N=500k /
    neig=200 the basis alone would be ~25 GB, so the fit degrades to
    constant memory and SAYS so rather than OOMing."""
    from .matvec import kernel_matmul, kernel_matmul_fast
    if matmul is None:
        matmul = kernel_matmul
    n = X_std.shape[0]
    neig = min(int(neig), n)
    if n >= 200_000:
        # one product per device program at this scale: per-product
        # granularity is what progress/interrupt should mean here, and it
        # bounds the wall-clock of a single program (kept from the first
        # platform; whether the H100 needs the bound is not yet measured)
        chunk = min(chunk, 1)
    key = jax.random.PRNGKey(seed)
    q, progressive = _krylov_geometry(n, neig, iters)

    if krylov is None:
        krylov = _auto_krylov(n, q, iters,
                              jnp.dtype(X_std.dtype).itemsize)
    if power_matmul is None:
        # reduced-precision backend for the POWER products only; the
        # final Rayleigh–Ritz always recomputes K·B with the
        # full-precision ``matmul`` (see _krylov_ritz_streaming), which
        # is the safeguard that keeps fast accumulation from touching
        # the reported eigenvalues beyond the pinned tolerance
        # (tests/test_streaming.py::test_fast_power_self_correcting)
        fast_power = _resolve_fast_power(fast_power, krylov, progressive)
        power_matmul = matmul
        if fast_power and matmul is kernel_matmul:
            power_matmul = kernel_matmul_fast
        elif fast_power:
            import logging
            logging.getLogger("bigkrls_tpu").info(
                "eigensystem_streaming: fast_power ignored for a matmul "
                "other than kernel_matmul; power products stay at full "
                "precision")
        if power_matmul is not matmul:
            import logging
            logging.getLogger("bigkrls_tpu").info(
                "eigensystem_streaming: reduced-precision power products "
                "enabled (a Ritz-recomputes-K.B flow; Rayleigh-Ritz "
                "stays full precision)")

    V = _subspace_init(X_std, key, q)

    row_sharding = None
    if mesh is not None and n % int(mesh.devices.size) == 0:
        from jax.sharding import NamedSharding, PartitionSpec
        row_sharding = NamedSharding(
            mesh, PartitionSpec(mesh.axis_names[0], None))
    elif mesh is not None:
        import logging
        # no-silent-caps: at awkward N the sharding_report would otherwise
        # show replicated Q with no hint why (VERDICT r02 weak #7)
        logging.getLogger("bigkrls_tpu").warning(
            "eigensystem_streaming: N=%d not divisible by %d devices; the "
            "Krylov basis and eigenvectors stay replicated at rest (the "
            "ring matmul still row-shards every K@V product internally)",
            n, int(mesh.devices.size))

    if krylov and progressive:
        reuse_kb = power_matmul is matmul
        width = (iters + 1) * q
        B = jnp.zeros((n, width), V.dtype).at[:, :q].set(V)
        KB = jnp.zeros((n, width), V.dtype)
        if row_sharding is not None:
            from ..parallel.sharded import commit
            B = commit(B, row_sharding)       # multi-host safe reshard
            KB = commit(KB, row_sharding)
        g = jnp.asarray(0, jnp.int32)
        done = 0
        while done < iters:
            steps = min(chunk, iters - done)
            V, B, KB, g = _krylov_chunk(X_std, V, B, KB, g, sigma, steps,
                                        power_matmul, reuse_kb)
            done += steps
            if progress is not None:
                jax.block_until_ready(V)
                progress(done, iters)
        vals, vecs = _krylov_ritz_streaming(X_std, B, KB, V, sigma, neig,
                                            matmul, reuse_kb)
    elif krylov:
        # small n (basis width would reach n): stacked blocks + fat QR
        done = 0
        bases = []
        while done < iters:
            steps = min(chunk, iters - done)
            V, blocks = _power_chunk_blocks(X_std, V, sigma, steps,
                                            power_matmul)
            bases.append(blocks)
            done += steps
            if progress is not None:
                jax.block_until_ready(V)
                progress(done, iters)
        vals, vecs = _fatqr_ritz_streaming(
            X_std, jnp.concatenate(bases, axis=1), sigma, neig, matmul)
    else:
        # constant-memory flow: CHEBYSHEV-filtered subspace iteration.
        # Plain power iteration's filter after d products is (t/c)^d —
        # near the wanted/unwanted boundary t = c(1+ε) that is only
        # e^{dε}; a Chebyshev filter of the same total degree achieves
        # cosh(d·acosh(1+2ε)) ≈ ½e^{2d√ε}, quadratically better exactly
        # on the slowly-decaying (gap-free) spectra this flow serves.
        # Measured (CPU f32, N=3072, dense-eigh oracle): 4 filter
        # products + 1 full-precision Ritz product match or beat the old
        # plain flow's 6+1 at P=20 (the 500k/1M bench class: max-rel
        # 3.9e-2 vs 4.4e-2, λ-bound sums 2.5e-4 vs 2.8e-4) and at P=67
        # (5.2e-2 vs 6.6e-2) — so ``iters`` ≥ 4 maps to ``iters − 2``
        # products at equal-or-better accuracy, and 500k/1M fits drop
        # ~2/7 of their product bill.  The cutoff needs no a-priori
        # spectral bounds: each application starts from the free Gram
        # Ritz values (see _cheb_app_start), and a pessimistic cutoff
        # degrades gracefully toward plain power (T_m(2t/c−1) ~ (2t/c)^m
        # for t ≫ c), never below it.
        nprod = iters if iters <= 3 else max(3, iters - 2)
        # At N ≥ 600k, wait for every product to finish before queueing
        # the next: the recurrence keeps one more live block than plain
        # power did, and several queued programs' (Yp, Yc, Z, U) sets
        # (q=548 blocks are 2.2 GB each at N=1M) ran out of memory on a
        # 16 GB device.  Below that the queue stays fully asynchronous,
        # since waiting costs host/device overlap.  Whether the 80 GB
        # H100 needs the bound is not yet measured.
        sync = n >= 600_000

        def _settle(x):
            if sync:
                jax.block_until_ready(x)

        step_fn = (_cheb_step_fused if _epilogue_capable(power_matmul)
                   else _cheb_step)
        c = jnp.asarray(0.0, V.dtype)
        done = 0
        for d in _cheb_degrees(nprod):
            Yp, Yc, r, c = _cheb_app_start(X_std, V, c, sigma,
                                           power_matmul)
            V = None        # Yp aliases it; drop the stale reference
            _settle(r)
            done += 1
            if progress is not None:
                jax.block_until_ready(Yc)
                progress(done, nprod)
            for _ in range(d - 1):
                Yp, Yc, r = step_fn(X_std, Yp, Yc, r, c, sigma,
                                    power_matmul)
                _settle(r)
                done += 1
                if progress is not None:
                    jax.block_until_ready(Yc)
                    progress(done, nprod)
            del Yp
            V = _block_orth(Yc)
            del Yc
            _settle(V[0, 0])
        # Rayleigh–Ritz on the last block only (B = V, K·B recomputed at
        # full precision)
        vals, vecs = _krylov_ritz_streaming(X_std, V, V, V, sigma, neig,
                                            matmul, False)
    vecs = -vecs
    if mesh is not None and n % int(mesh.devices.size) == 0:
        from jax.sharding import NamedSharding, PartitionSpec
        from ..parallel.sharded import commit
        vecs = commit(
            vecs, NamedSharding(mesh, PartitionSpec(mesh.axis_names[0],
                                                    None)))
    vals_np = np.asarray(jax.device_get(vals))
    if np.any(np.isnan(vals_np)):
        raise ValueError(
            "Missing eigenvalues prevent obtaining the regularization "
            "parameter lambda. Check for repeated observations (or other "
            "perfect linear combinations in X).")
    lastkeeper = lastkeeper_from_values(vals_np, eigtrunc)
    return Eigensystem(values_full=vals, vectors=vecs[:, :lastkeeper],
                       lastkeeper=lastkeeper)


def lastkeeper_from_values(values: np.ndarray, eigtrunc: float) -> int:
    """Reference truncation rule: ``max(which(values >= eigtrunc*values[1]))``
    (``R/bigKRLS_Rcpp_functions.R:190``), returned as a count."""
    values = np.asarray(values)
    cond = values >= eigtrunc * values[0]
    idx = np.nonzero(cond)[0]
    if idx.size == 0:
        return 1
    return int(idx.max()) + 1


def _replicated_eigh_fits(n: int, itemsize: int, budget: Optional[int] = None,
                          fraction: float = 0.35) -> bool:
    """Memory-crossover heuristic for the FULL-spectrum decomposition
    under a mesh (the documented Jacobi crossover, VERDICT r03 #2).

    A replicated ``eigh`` needs the gathered operator plus workspace and
    eigenvectors on EVERY device (~3·N² elements each); block Jacobi
    keeps everything block-sharded (~3·N²/devices each) but costs
    ~(sweeps·12bN²·(nb−1)) ≈ 10× the eigh FLOPs — wall-clock-measured at
    30–100× eigh on the 8-virtual-device CPU mesh (tools/
    jacobi_crossover.py; see docs/performance.md).  So the crossover is
    a MEMORY crossover, not a FLOP one: replicate while the operator
    fits comfortably per device, distribute when it cannot."""
    need = 3 * n * n * itemsize
    if budget is None:
        from ..utils.memory import device_memory_budget
        budget = device_memory_budget()
    return need <= fraction * budget


def eigensystem(
    K,
    neig: Optional[int] = None,
    eigtrunc: float = 0.0,
    method: str = "auto",
    full_threshold: int = 8192,
    subspace_iters: int = 8,
    seed: int = 0,
    mesh=None,
) -> Eigensystem:
    """Compute the (possibly truncated) eigensystem of the kernel.

    ``method``: "auto" | "full" | "subspace" | "lanczos" | "jacobi".
    "auto" picks the exact full solver when ``neig`` is not a real
    truncation, block-Krylov when the truncation is aggressive
    (``neig ≤ N/8``, with λ-parity pinned at that ratio by
    ``tests/test_lambda_parity.py``), dense eigh-then-slice for mild
    truncations up to ``full_threshold``, and block-Krylov beyond.

    ``mesh``: when given, the returned eigenvectors are committed
    row-sharded over the mesh's first axis, so every downstream O(N·k)
    GEMM (λ-search solves, vcov quadratic forms, derivative assembly)
    stays distributed.  With a real truncation, "auto" additionally
    prefers subspace iteration regardless of N — its K@V products are
    plain GEMMs against the block-sharded K, which XLA partitions over
    the mesh.  For a FULL decomposition under a mesh, "auto" follows
    the MEASURED memory crossover (``_replicated_eigh_fits``,
    docs/performance.md): replicated ``eigh`` while ~3N² fits
    per-device memory (30–100× faster there — eigh has no SPMD
    partitioning either way, so replication costs only memory), and the
    distributed block-Jacobi solver (``parallel/jacobi.py``, sharded
    stripe-GEMM sweeps, O(N²/devices) per-device footprint) beyond it.
    """
    n = K.shape[0]
    neig = n if neig is None else min(n, int(neig))

    if method == "auto":
        if neig < n and mesh is not None:
            method = "subspace"
        elif mesh is not None:
            # full spectrum under a mesh: replicated eigh while the
            # operator fits per-device memory (it is 30-100× faster at
            # that scale — measured, docs/performance.md), distributed
            # block Jacobi once it cannot (the memory crossover)
            import logging
            if _replicated_eigh_fits(n, jnp.dtype(K.dtype).itemsize):
                method = "full"
                logging.getLogger("bigkrls_tpu").info(
                    "mesh full-spectrum eig: operator fits per-device "
                    "memory; using replicated eigh (the measured fast "
                    "side of the Jacobi memory crossover)")
            else:
                method = "jacobi"
                logging.getLogger("bigkrls_tpu").info(
                    "mesh full-spectrum eig: N=%d too large to replicate; "
                    "using distributed block Jacobi", n)
        elif neig >= n:
            method = "full"
        elif neig * 8 <= n:
            # aggressive truncations are iteration-bound, not eigh-bound
            # (threshold chosen before the H100 port, not yet measured on
            # the H100);
            # λ*/coefficient parity is pinned by
            # tests/test_lambda_parity.py at ratios N/8 and N/32 on a
            # gap-free 1/k spectrum (the iterative-solver worst case)
            method = "subspace"
        elif n <= full_threshold:
            method = "full"
        else:
            method = "subspace"

    if method == "full":
        vals, vecs = _eigh_desc(K)
        vals = vals[:neig]
        vecs = vecs[:, :neig]
    elif method == "subspace":
        key = jax.random.PRNGKey(seed)
        vals, vecs = _subspace_iteration(K, key, neig, subspace_iters)
        vecs = -vecs
    elif method == "lanczos":
        key = jax.random.PRNGKey(seed)
        vals, vecs = _lanczos(K, key, neig)
        vecs = -vecs
    elif method == "jacobi":
        from ..parallel.jacobi import block_jacobi_eigh
        try:
            vals, vecs = block_jacobi_eigh(K, mesh=mesh)
        except RuntimeError as e:
            import logging
            logging.getLogger("bigkrls_tpu").warning(
                "block Jacobi fell back to gathered dense eigh: %s", e)
            vals, vecs = jnp.linalg.eigh(K)
        vals = vals[::-1][:neig]
        vecs = -vecs[:, ::-1][:, :neig]
    else:
        raise ValueError(f"unknown eig method: {method!r}")

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        from ..parallel.sharded import commit
        vecs = commit(
            vecs, NamedSharding(mesh, PartitionSpec(mesh.axis_names[0],
                                                    None)))

    vals_np = np.asarray(jax.device_get(vals))
    if np.any(np.isnan(vals_np)):
        # reference guard: NaN eigenvalues -> duplicated rows diagnosis
        # (R/bigKRLS_Rcpp_functions.R:8-9)
        raise ValueError(
            "Missing eigenvalues prevent obtaining the regularization "
            "parameter lambda. Check for repeated observations (or other "
            "perfect linear combinations in X)."
        )
    lastkeeper = lastkeeper_from_values(vals_np, eigtrunc)
    return Eigensystem(values_full=vals, vectors=vecs[:, :lastkeeper],
                       lastkeeper=lastkeeper)
