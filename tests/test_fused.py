"""Fused single-dispatch post-kernel core vs the step-by-step pipeline.

``ops/fused.py::postkernel_device`` runs eigh → lastkeeper → λ bounds →
golden search → spectral solve as one jitted program (the unfused path
pays ~8 host↔device round trips).  In f64 both paths
walk the same integer bound lattice and the same golden bracket, so λ*,
Le, the coefficients, and lastkeeper must agree essentially exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from bigkrls_tpu.lambda_search import lambda_search
from bigkrls_tpu.ops.eig import eigensystem
from bigkrls_tpu.ops.fused import postkernel_device
from bigkrls_tpu.ops.kernels import gauss_kernel
from bigkrls_tpu.ops.solve import solve_for_c


@pytest.mark.parametrize("n,p,eigtrunc", [(300, 5, 0.0), (420, 7, 0.001)])
def test_fused_matches_pipeline(rng, n, p, eigtrunc):
    X = rng.normal(size=(n, p))
    X = (X - X.mean(0)) / X.std(0, ddof=1)
    y = np.sin(X[:, 0]) + X[:, 1] + 0.3 * rng.normal(size=n)
    y = (y - y.mean()) / y.std(ddof=1)
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    K = gauss_kernel(Xj, float(p))

    eig = eigensystem(K, eigtrunc=eigtrunc)
    lam_ref = lambda_search(eig, yj)
    Le_ref, c_ref = solve_for_c(eig, yj, lam_ref)

    vals, vecs, lastkeeper, lam, Le, c, spectrum, iters = postkernel_device(
        K, yj, jnp.asarray(eigtrunc, yj.dtype),
        jnp.asarray(1e-3 * n, yj.dtype))

    assert int(lastkeeper) == eig.lastkeeper
    assert float(lam) == pytest.approx(float(lam_ref), rel=1e-9)
    assert float(Le) == pytest.approx(float(Le_ref), rel=1e-9)
    assert np.max(np.abs(np.asarray(c) - np.asarray(c_ref))) < 1e-10
    assert int(iters) > 0
    # masked spectrum agrees with the truncated filter, zero beyond
    spec = np.asarray(spectrum)
    vals_np = np.asarray(vals)
    k = eig.lastkeeper
    assert np.allclose(spec[:k], 1.0 / (vals_np[:k] + float(lam)) ** 2)
    assert np.all(spec[k:] == 0.0)


def test_noisy_fit_uses_fused_and_matches_quiet(rng):
    """noisy=True (the default for N>2000) must not disable the fused
    core: both modes go through ``postkernel_device`` and agree exactly."""
    import bigkrls_tpu as bk

    n, p = 260, 4
    X = rng.normal(size=(n, p))
    y = np.sin(X[:, 0]) + X[:, 1] + 0.3 * rng.normal(size=n)

    lines = []
    quiet = bk.fit(y, X, noisy=False)
    loud = bk.fit(y, X, noisy=True, log=lines.append)

    assert loud.lambda_ == quiet.lambda_
    assert loud.looe == quiet.looe
    np.testing.assert_array_equal(loud.coeffs, quiet.coeffs)
    np.testing.assert_array_equal(loud.derivatives, quiet.derivatives)
    joined = "\n".join(lines)
    assert "fused device program" in joined
    assert "golden-section iterations" in joined
    assert "Skipping step 3/5" not in joined
