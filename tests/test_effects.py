"""Marginal-effects oracles.

The fused all-columns implementation is verified against:
1. a literal numpy transcription of the reference loops
   (``src/bigderiv_v3.cpp``): per-column D∘K GEMV for continuous columns,
   per-row toggled-kernel first differences for binary columns;
2. dense-covariance recomputation of the AME variances;
3. numerical differentiation of the actual fitted prediction surface
   (independent of any formula transcription).
"""
import jax.numpy as jnp
import numpy as np

from bigkrls_tpu.ops.effects import derivatives_all
from bigkrls_tpu.ops.eig import eigensystem
from bigkrls_tpu.ops.kernels import gauss_kernel


def _naive_continuous(X, K, c, j, sigma):
    n = X.shape[0]
    D = X[:, j][:, None] - X[:, j][None, :]   # D[i,k] = x_i - x_k
    L = D * K
    return (-2.0 / sigma) * (L @ c), L


def _naive_binary(X, K, c, j, sigma):
    """Point estimates per ``bigderiv_v3.cpp:50-78`` (the well-defined part)."""
    x = X[:, j]
    z0, z1 = x.min(), x.max()
    sdXj = 1.0 / (z1 - z0)
    n = X.shape[0]
    out = np.zeros(n)
    for i in range(n):
        c1 = 1.0 if x[i] == z0 else 0.0
        both_max = (x + x[i] == 2 * z1).astype(float)
        both_min = (x + x[i] == 2 * z0).astype(float)
        c2 = np.exp((-2 * (both_max + both_min) + 1) * (z1 - z0) ** 2 / sigma)
        out[i] = (sdXj * (-1.0) ** c1 * (1 - c2) * K[:, i]) @ c
    return out


def _naive_binary_var(X, K, V, j, sigma):
    """Intended variance formula (see ops/effects.py docstring): the
    correctly-adjusted treatment/control kernels, hᵀVh, reference factor 2."""
    x = X[:, j]
    z0, z1 = x.min(), x.max()
    n = X.shape[0]
    phi = -((z1 - z0) ** 2) / sigma
    b = (x == z1).astype(float)
    adj_T = np.zeros((n, n))
    adj_C = np.zeros((n, n))
    for i in range(n):
        both_min = ((x == z0) & (x[i] == z0)).astype(float)
        both_max = ((x == z1) & (x[i] == z1)).astype(float)
        first_greater = (x[i] > x).astype(float)
        second_greater = (x[i] < x).astype(float)
        adj_T[i] = both_min - second_greater
        adj_C[i] = both_max - first_greater
    KT = np.exp(adj_T * phi) * K
    KC = np.exp(adj_C * phi) * K
    h = (KT - KC).T @ np.ones(n)
    sd2 = 1.0 / (z1 - z0) ** 2
    return 2.0 * sd2 * (h @ V @ h) / n ** 2


def _fixture(rng, n=50, with_binary=True):
    p = 4
    X = rng.normal(size=(n, p))
    if with_binary:
        X[:, 2] = (X[:, 2] > 0.2).astype(float)
    X = (X - X.mean(0)) / X.std(0, ddof=1)
    y = np.sin(X[:, 0]) + X[:, 1] + (X[:, 2] if with_binary else 0) \
        + 0.3 * rng.normal(size=n)
    y = (y - y.mean()) / y.std(ddof=1)
    sigma = float(p)
    K = np.asarray(gauss_kernel(jnp.asarray(X), sigma))
    lam = 0.4
    c = np.linalg.solve(K + lam * np.eye(n), y)
    eig = eigensystem(jnp.asarray(K))
    sigmasq = float(np.mean((y - K @ c) ** 2))
    spectrum = sigmasq / (np.asarray(eig.values) + lam) ** 2
    V = (np.asarray(eig.vectors) * spectrum) @ np.asarray(eig.vectors).T
    binary = np.array([np.unique(X[:, j]).size == 2 for j in range(p)])
    return X, y, K, c, eig, spectrum, V, sigma, binary


def _run_effects(X, K, c, eig, spectrum, sigma, binary):
    z0 = X.min(axis=0)
    z1 = X.max(axis=0)
    res = derivatives_all(
        jnp.asarray(X), jnp.asarray(K), jnp.asarray(c), eig.vectors,
        jnp.asarray(spectrum), sigma, jnp.asarray(binary),
        jnp.asarray(z0), jnp.asarray(z1))
    return np.asarray(res.derivatives), np.asarray(res.var_avgderiv)


def test_continuous_derivatives_match_naive(rng):
    X, y, K, c, eig, spectrum, V, sigma, binary = _fixture(rng)
    deriv, _ = _run_effects(X, K, c, eig, spectrum, sigma, binary)
    for j in range(X.shape[1]):
        if binary[j]:
            continue
        ref, _ = _naive_continuous(X, K, c, j, sigma)
        assert np.max(np.abs(deriv[:, j] - ref)) < 1e-10


def test_continuous_var_matches_dense(rng):
    X, y, K, c, eig, spectrum, V, sigma, binary = _fixture(rng)
    n = X.shape[0]
    _, var = _run_effects(X, K, c, eig, spectrum, sigma, binary)
    for j in range(X.shape[1]):
        if binary[j]:
            continue
        _, L = _naive_continuous(X, K, c, j, sigma)
        ref = (1.0 / n ** 2) * (2.0 / sigma) ** 2 * np.sum(L.T @ V @ L)
        assert abs(var[j] - ref) < 1e-10 * max(1.0, abs(ref))


def test_binary_derivatives_match_naive(rng):
    X, y, K, c, eig, spectrum, V, sigma, binary = _fixture(rng)
    deriv, _ = _run_effects(X, K, c, eig, spectrum, sigma, binary)
    j = int(np.nonzero(binary)[0][0])
    ref = _naive_binary(X, K, c, j, sigma)
    assert np.max(np.abs(deriv[:, j] - ref)) < 1e-10


def test_binary_var_matches_naive(rng):
    X, y, K, c, eig, spectrum, V, sigma, binary = _fixture(rng)
    _, var = _run_effects(X, K, c, eig, spectrum, sigma, binary)
    j = int(np.nonzero(binary)[0][0])
    ref = _naive_binary_var(X, K, V, j, sigma)
    assert abs(var[j] - ref) < 1e-10 * max(1.0, abs(ref))


def test_binary_derivative_is_exact_first_difference(rng):
    """Independent check: the binary 'derivative' equals the difference of
    kernel predictions with observation i's column toggled to max vs min,
    divided by the (standardized) level gap."""
    X, y, K, c, eig, spectrum, V, sigma, binary = _fixture(rng)
    j = int(np.nonzero(binary)[0][0])
    deriv, _ = _run_effects(X, K, c, eig, spectrum, sigma, binary)
    x = X[:, j]
    z0, z1 = x.min(), x.max()
    for i in range(0, X.shape[0], 7):
        xt = X[i].copy(); xt[j] = z1
        xc = X[i].copy(); xc[j] = z0
        kt = np.exp(-np.sum((xt[None, :] - X) ** 2, axis=1) / sigma)
        kc = np.exp(-np.sum((xc[None, :] - X) ** 2, axis=1) / sigma)
        fd = (kt @ c - kc @ c) / (z1 - z0)
        assert abs(deriv[i, j] - fd) < 1e-10


def test_continuous_derivative_matches_finite_difference(rng):
    """Numerical differentiation of the fitted surface ŷ(x) = Σ c_k k(x,x_k)."""
    X, y, K, c, eig, spectrum, V, sigma, binary = _fixture(rng, with_binary=False)
    deriv, _ = _run_effects(X, K, c, eig, spectrum, sigma, binary)
    eps = 1e-6
    for i in (0, 11, 23):
        for j in range(X.shape[1]):
            xp = X[i].copy(); xp[j] += eps
            xm = X[i].copy(); xm[j] -= eps
            kp = np.exp(-np.sum((xp[None, :] - X) ** 2, axis=1) / sigma)
            km = np.exp(-np.sum((xm[None, :] - X) ** 2, axis=1) / sigma)
            fd = (kp @ c - km @ c) / (2 * eps)
            assert abs(deriv[i, j] - fd) < 1e-5


def test_binary_fuzz_many_patterns(rng):
    """Fuzz the binary first-difference path over random binary patterns,
    levels, and bandwidths (SURVEY.md §7 hard part #3)."""
    for seed in range(5):
        gen = np.random.default_rng(seed)
        n = 40
        frac = gen.uniform(0.15, 0.85)
        levels = sorted(gen.normal(size=2))
        xb = np.where(gen.uniform(size=n) < frac, levels[1], levels[0])
        if np.unique(xb).size < 2:
            continue
        X = np.column_stack([gen.normal(size=n), xb])
        X = (X - X.mean(0)) / X.std(0, ddof=1)
        sigma = float(gen.uniform(0.5, 6.0))
        K = np.asarray(gauss_kernel(jnp.asarray(X), sigma))
        c = np.linalg.solve(K + 0.3 * np.eye(n), gen.normal(size=n))
        eig = eigensystem(jnp.asarray(K))
        spectrum = 0.5 / (np.asarray(eig.values) + 0.3) ** 2
        binary = np.array([False, True])
        z0 = X.min(axis=0)
        z1 = X.max(axis=0)
        res = derivatives_all(
            jnp.asarray(X), jnp.asarray(K), jnp.asarray(c), eig.vectors,
            jnp.asarray(spectrum), sigma, jnp.asarray(binary),
            jnp.asarray(z0), jnp.asarray(z1))
        deriv = np.asarray(res.derivatives)
        ref = _naive_binary(X, K, c, 1, sigma)
        assert np.max(np.abs(deriv[:, 1] - ref)) < 1e-9, f"seed {seed}"
        V = (np.asarray(eig.vectors) * spectrum) @ np.asarray(eig.vectors).T
        ref_var = _naive_binary_var(X, K, V, 1, sigma)
        assert abs(float(res.var_avgderiv[1]) - ref_var) < 1e-9 * max(
            1.0, abs(ref_var)), f"seed {seed}"


def _reference_vcv_accumulation(X, K, V, j, sigma):
    """LITERAL numpy transcription of the reference's binary AME variance
    accumulation (``src/bigderiv_v3.cpp:41-86``), including its
    ``adj_*_local`` row vectors and the three colsum-times-rowsum terms.

    Two expressions in the C++ are shape-non-conformant and only run
    because ``ARMA_NO_DEBUG`` disables Armadillo's checks: ``:66-67``
    multiplies two N×1 colvecs (transcribed as the dot product — the only
    well-defined reading) and ``:82-84`` takes rowvec % colvec
    (transcribed elementwise over N)."""
    x = X[:, j]
    z0, z1 = x.min(), x.max()
    sdXj = 1.0 / (z1 - z0)
    phi = -1.0 / (sdXj ** 2 * sigma)
    n = len(x)
    adj_T = np.zeros((n, n))
    adj_C = np.zeros((n, n))
    KT_rowsums = np.zeros(n)
    KC_rowsums = np.zeros(n)
    for i in range(n):
        both_max = (x + x[i] == 2 * z1).astype(float)
        both_min = (x + x[i] == 2 * z0).astype(float)
        first_greater = (x[i] > x).astype(float)
        second_greater = (x[i] < x).astype(float)
        adj_T_local = both_min - first_greater
        adj_C_local = both_max - second_greater
        adj_T[i] = adj_T_local + first_greater - second_greater
        adj_C[i] = adj_C_local - first_greater + second_greater
        KT_rowsums[i] = np.exp(adj_T_local * phi) @ K[:, i]
        KC_rowsums[i] = np.exp(adj_C_local * phi) @ K[:, i]
    MT = (np.exp(adj_T * phi) * K) @ V.T
    MC = (np.exp(adj_C * phi) * K) @ V.T
    vcv_sum = np.sum(MT.sum(0) * KT_rowsums + MC.sum(0) * KC_rowsums
                     - 2.0 * MT.sum(0) * KC_rowsums)
    return 2.0 * sdXj ** 2 * vcv_sum / n ** 2


def test_binary_var_equals_reference_accumulation(rng):
    """VERDICT r01 item 10: measure, don't assert, the relation between our
    hᵀVh binary AME variance and the reference's accumulation.  Under the
    well-defined reading of its non-conformant shapes the divergence is
    exactly zero — the local adjustment vectors are columns of the stored
    matrices ((x_i > x_k) == (x_k < x_i)), and the three accumulation
    terms telescope to 1ᵀ(K_T−K_C)V(K_T−K_C)ᵀ1 (see ops/effects.py)."""
    for seed in (3, 11, 42, 2024):
        r = np.random.default_rng(seed)
        X, y, K, c, eig, spectrum, V, sigma, binary = _fixture(r)
        _, var = _run_effects(X, K, c, eig, spectrum, sigma, binary)
        for j in np.nonzero(binary)[0]:
            ref = _reference_vcv_accumulation(X, K, V, int(j), sigma)
            intended = _naive_binary_var(X, K, V, int(j), sigma)
            scale = max(1.0, abs(ref))
            assert abs(ref - intended) < 1e-12 * scale
            assert abs(var[int(j)] - ref) < 1e-12 * scale
