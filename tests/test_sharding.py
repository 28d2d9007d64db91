"""Multi-device sharding tests.

Two bars, per VERDICT r01 #1:

1. representation equivalence — ``fit(mesh=...)`` must return the same
   model as the single-device fit (the mesh analog of the reference's
   base-R vs bigmemory equality test, ``test_basic_usage.R:103-123``);
2. genuine distribution — every N×N / N×k intermediate of the mesh fit
   must be *partitioned* across devices (asserted via the fit's
   ``sharding_report`` audit), not merely replicated.

Plus the ring matmul (SURVEY.md §2.5 SP/CP row): K@V with no device ever
holding X, V or K whole, equivalence-tested against the dense product.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bigkrls_tpu as bk
from bigkrls_tpu.parallel.fit_step import fit_step
from bigkrls_tpu.parallel.ring_kernel import (make_ring_matmul,
                                              make_ring_mesh,
                                              padded_ring_kernel,
                                              ring_mesh_of)
from bigkrls_tpu.parallel.sharded import (block_sharding, make_mesh,
                                          replicated, row_sharding)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    return make_mesh(devices=jax.devices()[:8])


def test_make_mesh_shape(mesh):
    assert mesh.axis_names == ("i", "j")
    assert mesh.devices.size == 8
    # most-square factorization of 8
    assert sorted(mesh.devices.shape) == [2, 4]


def test_sharded_fit_matches_single_device(mesh):
    rng = np.random.default_rng(0)
    n, p = 64, 3
    X = rng.normal(size=(n, p))
    y = np.asarray(X @ np.ones(p) + 0.3 * rng.normal(size=n))
    m1 = bk.fit(y, X, noisy=False)
    m2 = bk.fit(y, X, noisy=False, mesh=mesh)
    assert abs(m1.lambda_ - m2.lambda_) < 1e-9
    assert np.max(np.abs(m1.coeffs - m2.coeffs)) < 1e-9
    assert np.max(np.abs(m1.yfitted - m2.yfitted)) < 1e-9
    assert np.max(np.abs(m1.derivatives - m2.derivatives)) < 1e-8
    assert np.max(np.abs(np.asarray(m1.K) - np.asarray(m2.K))) < 1e-12
    assert np.allclose(m1.var_avgderivatives, m2.var_avgderivatives)


def test_fit_mesh_intermediates_partitioned(mesh):
    """Every heavy intermediate of fit(mesh=...) carries >1 addressable
    shard: K 2-D block-sharded, Q/derivatives/X row-sharded."""
    rng = np.random.default_rng(4)
    n, p = 64, 4
    X = rng.normal(size=(n, p))
    X[:, -1] = (X[:, -1] > 0).astype(float)
    y = np.asarray(np.sin(X[:, 0]) + X[:, 1] + 0.2 * rng.normal(size=n))
    m = bk.fit(y, X, noisy=False, mesh=mesh)

    rep = m.sharding_report
    assert rep is not None
    # K: genuinely 2-D partitioned (both dims smaller per shard)
    assert rep["K"]["devices"] == 8 and not rep["K"]["replicated"]
    assert rep["K"]["shard_shape"][0] < rep["K"]["shape"][0]
    assert rep["K"]["shard_shape"][1] < rep["K"]["shape"][1]
    # N×k objects: row-partitioned
    for name in ("Q", "derivatives", "X_std"):
        assert not rep[name]["replicated"], (name, rep[name])
        assert rep[name]["shard_shape"][0] < rep[name]["shape"][0], \
            (name, rep[name])
    # the live arrays agree with the report
    k_devs = {s.device for s in m.K.addressable_shards}
    assert len(k_devs) == 8
    q_devs = {s.device for s in m.vcov_c_factored.Q.addressable_shards}
    assert len(q_devs) == 8


def test_fit_mesh_truncated_subspace_distributed(mesh):
    """Truncated mesh fits route the O(N²k) eig work through subspace
    iteration whose K@V GEMMs are partitioned against the block-sharded K
    ("auto" method prefers it under a mesh); results match the identical
    single-device subspace fit exactly."""
    rng = np.random.default_rng(5)
    n, p, k = 96, 3, 24
    X = rng.normal(size=(n, p))
    y = np.asarray(X @ np.ones(p) + 0.2 * rng.normal(size=n))
    m1 = bk.fit(y, X, noisy=False, neig=k, eig_method="subspace")
    m2 = bk.fit(y, X, noisy=False, neig=k, mesh=mesh)   # auto -> subspace
    assert m2.lastkeeper == m1.lastkeeper
    assert abs(m1.lambda_ - m2.lambda_) < 1e-7 * max(1.0, m1.lambda_)
    assert np.max(np.abs(m1.coeffs - m2.coeffs)) < 1e-7
    rep = m2.sharding_report
    assert not rep["Q"]["replicated"]
    assert rep["Q"]["shard_shape"][0] < n
    assert rep["Q"]["shape"] == (n, m2.lastkeeper)


def test_fit_mesh_adaptive_truncation_distributed(mesh):
    """VERDICT r03 #1 done-bar: under the 8-device mesh a default
    eigtrunc>0 fit at N≥2048 takes the ADAPTIVE route (eig_path
    "adaptive-krylov:…"), its eigenbasis is genuinely partitioned, and
    λ*/coefficients match the single-device adaptive fit — a distributed
    fit no longer pays full-spectrum cost for a ~90%-discarded spectrum
    (the reference's own answer at scale is its truncated path,
    /root/reference/src/eigen.cpp:18-25)."""
    rng = np.random.default_rng(8)
    n, p = 2048, 3
    X = rng.normal(size=(n, p))
    y = np.asarray(np.sin(X[:, 0]) + X[:, 1] + 0.2 * rng.normal(size=n))
    kw = dict(noisy=False, eigtrunc=0.001, derivative=False)
    m1 = bk.fit(y, X, **kw)
    assert m1.eig_path.startswith("adaptive-krylov"), m1.eig_path
    m2 = bk.fit(y, X, mesh=mesh, **kw)
    assert m2.eig_path == m1.eig_path
    assert m1.lambda_ == pytest.approx(m2.lambda_, rel=1e-9)
    assert np.max(np.abs(m1.coeffs - m2.coeffs)) < 1e-8
    assert m1.lastkeeper == m2.lastkeeper
    assert m1.neffective == pytest.approx(m2.neffective, abs=1e-6)
    rep = m2.sharding_report
    assert rep["K"]["devices"] == 8 and not rep["K"]["replicated"]
    assert not rep["Q"]["replicated"]
    assert rep["Q"]["shard_shape"][0] < n
    assert rep["Q"]["shape"] == (n, m2.lastkeeper)


def test_ring_matmul_matches_dense():
    """Ring K@V (ppermute collectives, no device holds X/V whole) equals
    the dense product; N deliberately NOT divisible by the ring size."""
    from bigkrls_tpu.ops.kernels import gauss_kernel

    devices = jax.devices()[:8]
    ring = make_ring_mesh(devices)
    rng = np.random.default_rng(6)
    n, p, m = 61, 3, 5   # 61 % 8 != 0 -> exercises the padding path
    X = jnp.asarray(rng.normal(size=(n, p)))
    V = jnp.asarray(rng.normal(size=(n, m)))
    sigma = float(p)

    ring_mm = make_ring_matmul(ring)
    Y = ring_mm(X, V, sigma)
    Y_ref = gauss_kernel(X, sigma) @ V
    assert np.max(np.abs(np.asarray(Y) - np.asarray(Y_ref))) < 1e-10
    # builder is cached per mesh (stable jit static arg)
    assert make_ring_matmul(ring) is ring_mm

    # with committed row-sharded inputs (divisible N) the product stays
    # row-sharded end to end
    from jax.sharding import NamedSharding, PartitionSpec as P
    n2 = 64
    X2 = jax.device_put(jnp.asarray(rng.normal(size=(n2, p))),
                        NamedSharding(ring, P("r", None)))
    V2 = jax.device_put(jnp.asarray(rng.normal(size=(n2, m))),
                        NamedSharding(ring, P("r", None)))
    Y2 = ring_mm(X2, V2, sigma)
    assert np.max(np.abs(np.asarray(Y2) -
                         np.asarray(gauss_kernel(X2, sigma) @ V2))) < 1e-10
    assert not Y2.sharding.is_fully_replicated
    assert Y2.addressable_shards[0].data.shape[0] == n2 // 8


def test_streaming_fit_with_mesh(mesh):
    """fit(mesh, streaming=True): every K@V product runs as a ring matmul
    over the device ring — no device holds X, K (never built), or Q whole
    — and the estimates match the single-device streaming fit."""
    rng = np.random.default_rng(3)
    n, p = 64, 3
    X = rng.normal(size=(n, p))
    y = np.asarray(X @ np.ones(p) + 0.2 * rng.normal(size=n))
    m1 = bk.fit(y, X, neig=20, streaming=True, noisy=False)
    m2 = bk.fit(y, X, neig=20, streaming=True, noisy=False, mesh=mesh)
    assert m2.K is None
    assert abs(m1.lambda_ - m2.lambda_) < 1e-8 * max(1.0, m1.lambda_)
    assert np.max(np.abs(m1.coeffs - m2.coeffs)) < 1e-8
    assert np.max(np.abs(m1.derivatives - m2.derivatives)) < 1e-7
    rep = m2.sharding_report
    assert not rep["X_std"]["replicated"]
    assert rep["X_std"]["shard_shape"][0] == n // 8
    assert not rep["Q"]["replicated"]
    assert rep["Q"]["shard_shape"][0] < n


def test_ring_kernel_dense_construction(mesh):
    """The explicit dense ring kernel builder (kept for K-at-rest use)."""
    rng = np.random.default_rng(7)
    X = jnp.asarray(rng.normal(size=(30, 3)))
    from bigkrls_tpu.ops.kernels import gauss_kernel
    ring = ring_mesh_of(mesh)
    K_ring = padded_ring_kernel(ring, X, 3.0)
    K_ref = gauss_kernel(X, 3.0)
    assert np.max(np.abs(np.asarray(K_ring) - np.asarray(K_ref))) < 1e-12


def test_block_sharded_matmul_roundtrip(mesh):
    rng = np.random.default_rng(2)
    A = jnp.asarray(rng.normal(size=(32, 32)))
    As = jax.device_put(A, block_sharding(mesh))
    out = jax.jit(lambda a: a @ a.T)(As)
    assert np.allclose(np.asarray(out), np.asarray(A @ A.T))


def test_dryrun_multichip_entrypoint():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "graft_entry", "/root/repo/__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    assert np.isfinite(float(out.looloss))
