"""Bring-up measurements of the kernels on one GPU.

    python tools/gpu_bringup.py [OUT_DIR]     # default OUT_DIR: chiprun_out

Prints one line per measurement and writes them, with the profiler trace
of one streaming product, under OUT_DIR.  Every time is the median of
several runs after a compile warm-up, on the host clock around work that
ends in ``block_until_ready``; every line carries the card's name and
power limit.  Needs a GPU.  The numbers behind PERF.md's bring-up
findings:

* ``gauss_kernel`` (f32, precision="highest") at N=3106 and N=16384, P=67;
* ``kernel_matmul`` at (100k, 20)x(100k, 540) with column blocks 1000,
  2000 and 4000, against a large f32-HIGHEST GEMM, a bf16 GEMM and a
  device copy as practical ceilings; the trace's device time per kernel;
* ``fast_eig_power`` on and off at N=50000, P=20, neig=500: one product
  each way, and the fits' λ*, AMEs and times.
"""
from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
import bigkrls_tpu as bk  # noqa: E402
from bigkrls_tpu.ops.kernels import gauss_kernel  # noqa: E402
from bigkrls_tpu.ops.matvec import kernel_matmul, kernel_matmul_fast  # noqa: E402
from bigkrls_tpu.warmup import enable_compile_cache  # noqa: E402


def median_time(fn, reps=5):
    """Median seconds of ``fn()`` over ``reps`` runs after one warm-up."""
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t)
    return float(np.median(ts))


def gemm_tflops(n, dtype, precision):
    a = jnp.ones((n, n), dtype)
    f = jax.jit(lambda x: jnp.matmul(x, x, precision=precision))
    return 2.0 * n ** 3 / median_time(lambda: f(a)) / 1e12


def copy_gbs(nbytes):
    a = jnp.ones((nbytes // 4,), jnp.float32)
    f = jax.jit(lambda x: x * 2.0)
    return 2.0 * nbytes / median_time(lambda: f(a)) / 1e9


def device_time_by_kernel(trace_dir):
    """Sum of device event durations per (line, kernel name) over the GPU
    planes of the newest trace under ``trace_dir``: {name: seconds}."""
    paths = []
    for root, _, files in os.walk(trace_dir):
        paths += [os.path.join(root, f) for f in files
                  if f.endswith(".xplane.pb")]
    data = jax.profiler.ProfileData.from_file(max(paths, key=os.path.getmtime))
    out = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                key = f"{line.name} | {ev.name}"
                out[key] = out.get(key, 0.0) + ev.duration_ns * 1e-9
    return out


def main(out_dir="chiprun_out"):
    enable_compile_cache()
    os.makedirs(out_dir, exist_ok=True)
    card = bench.device_record()["nvidia_smi"]
    rec = {"card": card, "kind": jax.devices()[0].device_kind}

    def say(key, value, text):
        rec[key] = value
        print(f"{text} [{card}]", flush=True)

    f32 = gemm_tflops(8192, jnp.float32, jax.lax.Precision.HIGHEST)
    say("gemm_f32_highest_tflops", f32,
        f"GEMM 8192^3 f32 HIGHEST: {f32:.1f} TFLOP/s")
    bf16 = gemm_tflops(8192, jnp.bfloat16, None)
    say("gemm_bf16_tflops", bf16, f"GEMM 8192^3 bf16: {bf16:.1f} TFLOP/s")
    cp = copy_gbs(4 * 1024 ** 3)
    say("copy_gbs", cp, f"copy 4 GiB (read+write): {cp:.0f} GB/s")

    rng = np.random.default_rng(0)
    with jax.default_matmul_precision("highest"):
        for n in (3106, 16384):
            X = jnp.asarray(rng.normal(size=(n, 67)), jnp.float32)
            t = median_time(lambda: gauss_kernel(X, 67.0))
            say(f"gauss_kernel_n{n}_s", t,
                f"gauss_kernel f32 N={n} P=67: {t * 1e3:.3f} ms "
                f"({2.0 * n * n * 67 / t / 1e12:.2f} TFLOP/s at 2N^2P)")

        n, p, m = 100_000, 20, 540
        X = jnp.asarray(rng.normal(size=(n, p)), jnp.float32)
        V = jnp.asarray(rng.normal(size=(n, m)), jnp.float32)
        flops = 2.0 * n * n * (p + m)
        times = {}
        for block in (1000, 2000, 4000, 4000, 2000, 1000):   # ABC CBA
            t = median_time(lambda: kernel_matmul(X, V, 20.0, block=block),
                            reps=3)
            times.setdefault(block, []).append(t)
        for block, ts in times.items():
            t = min(ts)
            say(f"kernel_matmul_n100k_block{block}_s", ts,
                f"kernel_matmul (100k,20)x(100k,540) block={block}: "
                + ", ".join(f"{x * 1e3:.1f}" for x in ts) + " ms (two "
                f"passes), best {flops / t / 1e12:.1f} TFLOP/s at 2N^2(P+m)")
        trace_dir = os.path.join(out_dir, "trace_kernel_matmul")
        with jax.profiler.trace(trace_dir):
            jax.block_until_ready(kernel_matmul(X, V, 20.0))
        split = sorted(device_time_by_kernel(trace_dir).items(),
                       key=lambda kv: -kv[1])
        say("kernel_matmul_trace_split", split[:40],
            "kernel_matmul trace, device time by line | kernel: "
            + "; ".join(f"{k[:90]} {v * 1e3:.1f} ms" for k, v in split[:8]))
        del X, V

        n = 50_000
        X = jnp.asarray(rng.normal(size=(n, p)), jnp.float32)
        V = jnp.asarray(rng.normal(size=(n, m)), jnp.float32)
        t_full = median_time(lambda: kernel_matmul(X, V, 20.0), reps=3)
        t_fast = median_time(lambda: kernel_matmul_fast(X, V, 20.0), reps=3)
        say("product_n50k_full_s", t_full,
            f"product (50k,20)x(50k,540): full precision {t_full * 1e3:.1f} "
            f"ms, fast_accum {t_fast * 1e3:.1f} ms")
        rec["product_n50k_fast_s"] = t_fast
        del X, V

    y, Xh = bench.synthetic_streaming(n, p)
    fits, wall = {}, {}
    for fast in (False, True):
        kw = dict(neig=500, streaming=True, noisy=False,
                  which_derivatives=[0, 1, 2, 3, 4], fast_eig_power=fast)
        bk.fit(y, Xh, **kw)                            # compile
        t = time.perf_counter()
        fits[fast] = bk.fit(y, Xh, **kw)
        wall[fast] = time.perf_counter() - t
    a, b = fits[False], fits[True]
    lam_rel = abs(b.lambda_ - a.lambda_) / a.lambda_
    ame_rel = float(np.max(np.abs(b.avgderivatives - a.avgderivatives))
                    / np.max(np.abs(a.avgderivatives)))
    say("fast_power_n50k", {"lambda_off": a.lambda_, "lambda_on": b.lambda_,
                            "lambda_rel": lam_rel, "ame_rel": ame_rel,
                            "fit_off_s": wall[False], "fit_on_s": wall[True],
                            "timings_off": a.timings,
                            "timings_on": b.timings},
        f"fast_eig_power N=50k P=20 neig=500: off lambda*={a.lambda_:.8g} "
        f"fit {wall[False]:.2f}s, on lambda*={b.lambda_:.8g} fit "
        f"{wall[True]:.2f}s; "
        f"lambda rel {lam_rel:.3e}, AME rel {ame_rel:.3e}")

    with open(os.path.join(out_dir, "gpu_bringup.json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    peak = bench.device_peaks(rec["kind"])["f32_tflops"]
    best = min(min(rec[f"kernel_matmul_n100k_block{b}_s"])
               for b in (1000, 2000, 4000))
    print(f"kernel_matmul best block: {flops / best / 1e12 / peak:.1%} of the "
          f"{peak:.0f} TFLOP/s f32 peak, {flops / best / 1e12 / f32:.1%} of "
          f"the measured f32-HIGHEST GEMM [{card}]", flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:])
