"""Compile-cache warming for production shapes.

First-time XLA compiles of the whole pipeline can take longer than the
fit itself; steady state is seconds.  JAX's persistent compilation cache
amortizes that — but only for shapes that have been compiled *once*.  This module pre-populates the cache by
running the real fit pipeline on synthetic data at the exact shapes a
production job will use, so the first real run is already warm.

The pipeline's compiled programs are keyed by (N, P, k, dtype, pipeline
flags), where k is the number of kept eigenvectors.  N and P come from
the data shape; k is data-dependent through the ``lastkeeper`` truncation
rule, so to warm a run whose truncation point you know (e.g. the 2016
election data keeps 2895 of 3106), pin it with ``neig=2895, eigtrunc=0``.

Usage:

    python -m bigkrls_tpu warmup --shapes 3106x67,50000x40 --streaming-from 32768

or programmatically::

    from bigkrls_tpu.warmup import enable_compile_cache, warmup
    enable_compile_cache()          # $JAX_COMPILATION_CACHE_DIR or <repo>/.jax_cache
    report = warmup(3106, 67)      # {"first_s": ..., "steady_s": ...,
                                    #  "compile_overhead_s": ...}
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np


REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache(cache_dir: Optional[str] = None) -> str:
    """Turn on JAX's persistent compilation cache (idempotent).

    Location: ``cache_dir`` if given; else ``$JAX_COMPILATION_CACHE_DIR``
    when set, which JAX reads itself, so no directory is set in code;
    else the fixed ``.jax_cache`` at the package's repository root.  The
    path is part of the cache key, so it never depends on a temporary
    name, a pid or the time.  Returns the directory in use."""
    import jax
    if cache_dir is None and os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        cache_dir = os.environ["JAX_COMPILATION_CACHE_DIR"]
    else:
        cache_dir = cache_dir or REPO_CACHE_DIR
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir


def warmup(n: int, p: int, *, binary_cols: int = 0, seed: int = 0,
           repeat: bool = True, noisy: bool = False, log=print,
           **fit_kwargs) -> dict:
    """Run the fit pipeline on synthetic data of shape (n, p) to populate
    the compile cache; returns wall-clock evidence of the warm/cold split.

    ``fit_kwargs`` are forwarded to :func:`bigkrls_tpu.fit` — pass the
    same pipeline flags (``neig``, ``eigtrunc``, ``streaming``,
    ``derivative``, ``dtype`` …) the production run will use, since they
    key the compiled programs.  ``binary_cols`` makes the trailing columns
    binary so the binary-derivative program compiles too.

    With ``repeat=True`` (default) the fit runs twice: the first call
    includes compilation, the second is steady state, and
    ``compile_overhead_s`` is their difference — the per-phase split is
    returned in ``first_timings``/``steady_timings`` (the reference has no
    analog; its compile cost is C++ build time, SURVEY.md §5.1).
    """
    import bigkrls_tpu as bk

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))
    for j in range(max(0, min(binary_cols, p))):
        X[:, p - 1 - j] = (X[:, p - 1 - j] > 0).astype(float)
    y = X @ rng.normal(size=p) + rng.normal(size=n)

    kwargs = dict(fit_kwargs)
    kwargs.setdefault("noisy", noisy)
    t0 = time.time()
    m1 = bk.fit(y, X, **kwargs)
    first = time.time() - t0
    out = {"n": n, "p": p, "first_s": round(first, 3),
           "first_timings": m1.timings}
    if repeat:
        t0 = time.time()
        m2 = bk.fit(y, X, **kwargs)
        steady = time.time() - t0
        out["steady_s"] = round(steady, 3)
        out["steady_timings"] = m2.timings
        out["compile_overhead_s"] = round(first - steady, 3)
    if noisy:
        log(f"warmup {n}x{p}: first={first:.2f}s"
            + (f" steady={out['steady_s']:.2f}s compile_overhead="
               f"{out['compile_overhead_s']:.2f}s" if repeat else ""))
    return out
