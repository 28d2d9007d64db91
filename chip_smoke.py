"""On-card smoke test: the KRLS fit end to end on one GPU.

    python chip_smoke.py          # one card: device, kernels, default fit,
                                  # streaming fit
    python chip_smoke.py --four   # only the multi-card phase, on 4 cards

Each phase prints one line; any failed check raises, so the script exits
non-zero and prints no result.  The last line of a passing run is one
JSON object naming the device as JAX reports it.  One JAX process holds
the card(s) for the whole run.

The phase functions take their sizes as arguments so that
``tests/test_chip_smoke.py`` can rehearse them on the CPU at a tiny size;
``main`` runs them at the real widths and refuses any platform but a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import bench
import bigkrls_tpu as bk
from bigkrls_tpu.lambda_search import _lower_bound, _upper_bound
from bigkrls_tpu.ops.kernels import gauss_kernel
from bigkrls_tpu.ops.matvec import kernel_matmul
from bigkrls_tpu.warmup import enable_compile_cache

# f32-vs-f64 agreement of the default fit on bench.synthetic_election(),
# measured on the CPU by tests/test_chip_smoke.py (which fails if this
# record no longer matches).  The card's agreement must stay within
# AGREEMENT_FACTOR times max(this, AGREEMENT_FLOOR); the floor is the f32
# epsilon, so an exact CPU agreement does not demand an exact one here.
CPU_F32_VS_F64 = {"lambda_rel": 2.3946029015437514e-08,
                  "ame_rel": 3.2119493594896545e-05,
                  "r2_abs": 3.5898718504512317e-06}
AGREEMENT_FACTOR = 10.0
AGREEMENT_FLOOR = float(np.finfo(np.float32).eps)

# phase 2 bounds: what true f32 gives at these widths; a product that ran
# in TF32 misses them
GAUSS_BOUND = 1e-5            # max abs error of K entries
MATMUL_BOUND = 5e-5           # max error over max|ref|
# multi-card vs one-card agreement (--four)
MESH_LAMBDA_REL = 1e-5
MESH_AME_REL = 1e-4


def say(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> dict:
    """The GPU JAX found, its memory limit, and the card's name and power
    limit from ``nvidia-smi`` (a child that does not import JAX)."""
    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU; JAX found "
                         f"{dev.platform!r} ({dev.device_kind})")
    rec = {"platform": dev.platform, "kind": dev.device_kind,
           "count": len(devs),
           "bytes_limit": dev.memory_stats().get("bytes_limit")}
    say(f"[device] {rec['kind']} x{rec['count']} "
        f"bytes_limit={rec['bytes_limit']} | nvidia-smi: "
        f"{bench.gpu_name_and_power_limit()}")
    return rec


def _standardized(X):
    return (X - X.mean(0)) / X.std(0, ddof=1)


def phase_kernels(n_gauss: int = 3106, p_gauss: int = 67,
                  n_mm: int = 20000, p_mm: int = 20, m_mm: int = 540,
                  seed: int = 0) -> dict:
    """gauss_kernel and kernel_matmul in f32 against f64 references, under
    the library's precision="highest"."""
    rng = np.random.default_rng(seed)
    Xg = _standardized(rng.normal(size=(n_gauss, p_gauss)))
    Xm = _standardized(rng.normal(size=(n_mm, p_mm)))
    Vm = rng.normal(size=(n_mm, m_mm))
    with jax.default_matmul_precision("highest"):
        K32 = gauss_kernel(jnp.asarray(Xg, jnp.float32), float(p_gauss))
        K64 = gauss_kernel(jnp.asarray(Xg, jnp.float64), float(p_gauss))
        gauss_err = float(jnp.max(jnp.abs(K32.astype(jnp.float64) - K64)))
        del K32, K64
        Y32 = kernel_matmul(jnp.asarray(Xm, jnp.float32),
                            jnp.asarray(Vm, jnp.float32), float(p_mm))
        ref = (gauss_kernel(jnp.asarray(Xm, jnp.float64), float(p_mm))
               @ jnp.asarray(Vm, jnp.float64))
        mm_err = float(jnp.max(jnp.abs(Y32.astype(jnp.float64) - ref))
                       / jnp.max(jnp.abs(ref)))
        del Y32, ref
    say(f"[kernels] gauss_kernel f32 N={n_gauss} P={p_gauss}: max abs err "
        f"{gauss_err:.3e} (bound {GAUSS_BOUND:.0e}); kernel_matmul f32 "
        f"N={n_mm} P={p_mm} m={m_mm}: max err/max|ref| {mm_err:.3e} "
        f"(bound {MATMUL_BOUND:.0e})")
    if not gauss_err <= GAUSS_BOUND:
        raise AssertionError(f"gauss_kernel f32 error {gauss_err:.3e}")
    if not mm_err <= MATMUL_BOUND:
        raise AssertionError(f"kernel_matmul f32 error {mm_err:.3e}")
    return {"gauss_err": gauss_err, "matmul_err": mm_err}


def f32_vs_f64(y, X, **fit_kwargs):
    """Fit the same data in f32 and in f64; returns the f32 model and
    the agreement of λ*, the AMEs and R²."""
    m32 = bk.fit(y, X, dtype=jnp.float32, noisy=False, **fit_kwargs)
    m64 = bk.fit(y, X, dtype=jnp.float64, noisy=False, **fit_kwargs)
    ame64 = np.asarray(m64.avgderivatives)
    agree = {
        "lambda_rel": abs(m32.lambda_ - m64.lambda_) / m64.lambda_,
        "ame_rel": float(np.max(np.abs(m32.avgderivatives - ame64))
                         / np.max(np.abs(ame64))),
        "r2_abs": abs(m32.R2 - m64.R2),
    }
    return m32, m64, agree


def phase_default_fit(y, X, cpu_record=None) -> dict:
    """Default fit in f32 -> summary -> predict(se_pred=True), checked
    against an f64 fit of the same data, then the reference's census CV
    protocol (``crossvalidate(ptesting=20, neig=50)``) in f32.
    ``cpu_record`` (the CPU rehearsal's agreement) bounds the card's
    agreement; None skips that bound (the rehearsal itself)."""
    t = time.time()
    m32, m64, agree = f32_vs_f64(y, X)
    s = bk.summary(m32)
    pred = bk.predict(m32, X[:10], se_pred=True)
    cv = bk.crossvalidate(y, X, seed=1, ptesting=20, neig=50, noisy=False,
                          dtype=jnp.float32)
    r2_oos = float(cv["pseudoR2_oos"])
    dt = time.time() - t
    ok_pred = (pred.predicted.shape == (10,)
               and np.all(np.isfinite(pred.predicted))
               and np.all(np.isfinite(pred.se_pred))
               and np.all(pred.se_pred > 0))
    # in-sample predict reproduces the fitted values
    pred_err = float(np.max(np.abs(pred.predicted - m32.yfitted[:10])))
    say(f"[default-fit] N={X.shape[0]} P={X.shape[1]} f32 eig_path="
        f"{m32.eig_path} lambda*={m32.lambda_:.6g} (f64 {m64.lambda_:.6g}) "
        f"R2={m32.R2:.6f} | f32-vs-f64 lambda_rel={agree['lambda_rel']:.3e} "
        f"ame_rel={agree['ame_rel']:.3e} r2_abs={agree['r2_abs']:.3e}"
        + ("" if cpu_record is None else
           f" | CPU rehearsal lambda_rel={cpu_record['lambda_rel']:.3e} "
           f"ame_rel={cpu_record['ame_rel']:.3e} "
           f"r2_abs={cpu_record['r2_abs']:.3e} (x{AGREEMENT_FACTOR:g}, "
           f"floor {AGREEMENT_FLOOR:.1e})")
        + f" | predict max|pred-yfitted|={pred_err:.2e} | crossvalidate "
        f"oos R2={r2_oos:.4f} | {dt:.1f}s cold")
    if not (np.isfinite(m32.coeffs).all() and np.isfinite(s.n_dof)
            and ok_pred):
        raise AssertionError("default fit: non-finite output or bad predict")
    if not pred_err <= 1e-3 * float(np.std(y)):
        raise AssertionError(f"predict disagrees with yfitted: {pred_err}")
    if not 0.0 < r2_oos < 1.0:
        raise AssertionError(f"crossvalidate: oos R2 {r2_oos}")
    if cpu_record is not None:
        for key, val in agree.items():
            bound = AGREEMENT_FACTOR * max(cpu_record[key], AGREEMENT_FLOOR)
            if not val <= bound:
                raise AssertionError(
                    f"f32-vs-f64 {key} {val:.3e} > {bound:.3e}")
    return {"agreement": agree, "eig_path": m32.eig_path,
            "lambda": m32.lambda_, "r2_oos": r2_oos}


def _lambda_bounds(model) -> tuple:
    values = np.asarray(model.K_eigenvalues, np.float64)
    return _lower_bound(values), _upper_bound(values, model.X.shape[0])


def phase_streaming(n: int = 100_000, p: int = 20, neig: int = 500,
                    r2_range=(0.5, 1.0)) -> dict:
    """The bench's streaming configuration through ``bk.fit``."""
    y, X = bench.synthetic_streaming(n, p)
    t = time.time()
    m = bk.fit(y, X, neig=neig, streaming=True, noisy=False,
               which_derivatives=[0, 1, 2, 3, 4], dtype=jnp.float32)
    dt = time.time() - t
    lo, hi = _lambda_bounds(m)
    stats = jax.devices()[0].memory_stats() or {}
    phases = {d["phase"]: d["seconds"] for d in m.timings}
    say(f"[streaming-fit] N={n} P={p} neig={neig} eig_path={m.eig_path} "
        f"lambda*={m.lambda_:.6g} in ({lo:.4g}, {hi:.4g}) R2={m.R2:.6f} "
        f"peak_bytes_in_use={stats.get('peak_bytes_in_use')} | one cold "
        f"run, not a metric: {dt:.1f}s, timings {phases}")
    finite = all(np.isfinite(np.asarray(a)).all() for a in (
        m.coeffs, m.yfitted, m.derivatives, m.avgderivatives,
        m.var_avgderivatives, m.K_eigenvalues))
    if not finite:
        raise AssertionError("streaming fit: non-finite output")
    if not r2_range[0] < m.R2 < r2_range[1]:
        raise AssertionError(f"streaming fit: R2 {m.R2} outside {r2_range}")
    if not lo < m.lambda_ < hi:
        raise AssertionError(
            f"streaming fit: lambda* {m.lambda_} not inside ({lo}, {hi})")
    return {"lambda": m.lambda_, "R2": m.R2, "timings": phases}


def _spread(arr, ndev: int, name: str) -> None:
    """Assert ``arr`` is split over ``ndev`` distinct devices."""
    shards = arr.addressable_shards
    devices = {s.device for s in shards}
    if len(devices) != ndev or any(
            s.data.shape[0] >= arr.shape[0] for s in shards):
        raise AssertionError(
            f"{name}: shards on {sorted(d.id for d in devices)}, shapes "
            f"{[s.data.shape for s in shards]} of {arr.shape}")


def _mesh_vs_single(tag: str, y, X, mesh, ndev: int, **kw) -> dict:
    single = bk.fit(y, X, noisy=False, dtype=jnp.float32, **kw)
    t = time.time()
    multi = bk.fit(y, X, noisy=False, dtype=jnp.float32, mesh=mesh, **kw)
    dt = time.time() - t
    rep = multi.sharding_report
    names = ["Q", "X_std"] + (["K"] if multi.K is not None else [])
    for name in names:
        info = rep[name]
        if info["replicated"] or info["devices"] != ndev:
            raise AssertionError(f"{tag}: {name} not sharded: {info}")
    _spread(multi.vcov_c_factored.Q, ndev, f"{tag} Q")
    if multi.K is not None:
        _spread(multi.K, ndev, f"{tag} K")
    lam_rel = abs(multi.lambda_ - single.lambda_) / single.lambda_
    ame_rel = float(np.max(np.abs(multi.avgderivatives
                                  - single.avgderivatives))
                    / np.max(np.abs(single.avgderivatives)))
    say(f"[four:{tag}] N={X.shape[0]} P={X.shape[1]} eig_path="
        f"{multi.eig_path} lambda* {multi.lambda_:.6g} vs one card "
        f"{single.lambda_:.6g}: rel {lam_rel:.3e} (bound "
        f"{MESH_LAMBDA_REL:.0e}); AME rel {ame_rel:.3e} (bound "
        f"{MESH_AME_REL:.0e}); shards "
        + ", ".join(f"{k}={rep[k]['shard_shape']}/{rep[k]['shape']}"
                    for k in names)
        + f" | {dt:.1f}s cold")
    if not lam_rel <= MESH_LAMBDA_REL:
        raise AssertionError(f"{tag}: lambda rel {lam_rel:.3e}")
    if not ame_rel <= MESH_AME_REL:
        raise AssertionError(f"{tag}: AME rel {ame_rel:.3e}")
    return {"lambda_rel": lam_rel, "ame_rel": ame_rel}


def phase_four(ndev: int = 4, dense_shape=(3106, 67),
               stream_n: int = 100_000, stream_p: int = 20,
               neig: int = 500) -> dict:
    """Dense fit on a 2x2 mesh and the streaming ring fit, each against
    the one-card fit of the same data in the same process."""
    from bigkrls_tpu.parallel.sharded import make_mesh
    devs = jax.devices()
    if len(devs) < ndev:
        raise SystemExit(f"chip_smoke --four: needs {ndev} devices, "
                         f"found {len(devs)}")
    mesh = make_mesh((2, ndev // 2), devices=devs[:ndev])
    n, p = dense_shape
    y, X = bench.synthetic_election()
    dense = _mesh_vs_single("dense-2x2", y[:n], X[:n, :p], mesh, ndev)
    ys, Xs = bench.synthetic_streaming(stream_n, stream_p)
    ring = _mesh_vs_single("ring", ys, Xs, mesh, ndev, neig=neig,
                           streaming=True, which_derivatives=[0, 1, 2, 3, 4])
    return {"dense": dense, "ring": ring}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-card phase, on 4 cards")
    args = ap.parse_args(argv)
    jax.config.update("jax_enable_x64", True)   # f64 references
    enable_compile_cache()
    t0 = time.time()
    dev = phase_device()
    if args.four:
        phase_four()
    else:
        phase_kernels()
        y, X = bench.synthetic_election()
        phase_default_fit(y, X, cpu_record=CPU_F32_VS_F64)
        phase_streaming()
    say(f"[done] {time.time() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
