"""Kernel-free matmul: Y = K(X) @ V without materializing K.

The reference's hard wall is storing the N×N kernel (≈5N² doubles peak,
``INSTALL.md:75``; practical limit N≈15k, ``README.md:69``).  Every
consumer of K in the KRLS pipeline is actually a *product* K @ V:

* truncated eigendecomposition: subspace iteration / Lanczos only need
  K @ V (``ops/eig.py``);
* fitted values: K @ c;
* ALL marginal-effect quantities (``ops/effects.py``): K@c, K@1, K@X,
  K@(X∘c), K@B, K@(B∘c) — stackable into ONE multi-RHS product.

So for N where K cannot live in device memory (N=500k f32 ⇒ 1 TB), the
fit runs "streaming": K is recomputed tile-by-tile from X (O(N·P)
storage) and contracted against V on the fly.  FLOP cost per product is
2N²(P+m): each step is a rank-P GEMM, an elementwise ``exp`` and a
second GEMM against a V block, and device-memory traffic is O(N·(P+m))
per column block instead of O(N²).

``kernel_matmul`` is a ``lax.scan`` over column blocks, each step
materializing only an (N, block) tile.  It is the only streaming
backend: it runs on every platform and under sharding (row-shard X over
a mesh and the scan's GEMMs shard with it).
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# DEFAULT_BLOCK: of the widths 1000, 2000 and 4000, 4000 ran the
# (100k, 20)x(100k, 540) product fastest on an H100 (PERF.md).  Divisor
# candidates for the pad-free path (descending): a block that divides N
# makes Xp/Vp reshape views instead of padded COPIES — at N=1M that
# removes two 2.2 GB round trips through device memory and the output
# slice-copy from every product.  The streaming shapes the benchmark runs
# (50k/100k/500k/1M) are all multiples of 1000.
DEFAULT_BLOCK = 4000
# the default policy keeps one (N, block) tile under this many bytes: each
# scan step holds two such arrays (the rank-P product and the exp tile),
# so at N=1M f32 the block drops to 1000 (4 GB tiles) instead of 4000
# (16 GB), leaving device memory to the eigensolver's bases
TILE_BYTES = 4 * 1024 ** 3
_BLOCK_DIVISORS = (4000, 2500, 2048, 2000, 1250, 1024, 1000, 800, 640, 512,
                   500, 400, 320, 256, 250, 200, 128)


def pick_block(n: int, block: Optional[int] = None,
               itemsize: int = 4) -> int:
    """Column-block width of :func:`kernel_matmul` for N rows.

    An explicit ``block`` is a memory bound the caller chose and is
    returned as is, never widened.  The default policy takes the largest
    divisor of N in ``_BLOCK_DIVISORS`` (pad-free) whose (N, block) tile
    of ``itemsize``-byte elements stays under ``TILE_BYTES``, else pads:
    to one block of N rounded up to 128 rows when N is below
    ``DEFAULT_BLOCK``, to multiples of the capped ``DEFAULT_BLOCK``
    otherwise."""
    if block is not None:
        return block
    cap = max(128, TILE_BYTES // (n * itemsize))
    for cand in _BLOCK_DIVISORS:
        if cand <= min(n, cap) and n % cand == 0:
            return cand
    return min(DEFAULT_BLOCK, cap, _round_up(n, 128))


@functools.partial(jax.jit, static_argnames=("block", "fast_accum"))
def kernel_matmul(X, V, sigma, block: Optional[int] = None,
                  fast_accum: bool = False, init=None, out_scale=None):
    """Y = exp(-pairwise_sqdist(X, X)/sigma) @ V, never materializing K.

    ``V`` is (N, m); returns (N, m).  Peak temporary is one (N, block)
    kernel tile; ``block=None`` takes the pad-free default policy of
    :func:`pick_block` (X/V enter the scan as reshape views, no copies).

    ``init``/``out_scale`` fuse a linear epilogue into the product:
    returns ``(K@V + init) * out_scale`` with ``init`` as the scan's
    initial accumulator — no separate Z/U blocks materialize.  This is
    what keeps the Chebyshev recurrence (``ops/eig._cheb_step``) at the
    plain-power memory footprint at N=1M (2.2 GB blocks; a separate
    product-then-combine formulation ran out of device memory there).

    The rank-P distance contraction always runs true-f32/HIGHEST
    (errors there sit inside exp() and distort K itself);
    ``fast_accum`` lowers only the tile@V contraction to the platform's
    ``Precision.DEFAULT`` (TF32 on an H100, plain f32 on the CPU),
    which subspace iteration self-corrects
    (tests/test_streaming.py::test_fast_power_self_correcting).
    """
    n, p = X.shape
    m = V.shape[1]
    sigma = jnp.asarray(sigma, X.dtype)
    block = pick_block(n, block, jnp.dtype(X.dtype).itemsize)  # trace-time
    npad = _round_up(n, block)
    if npad == n:
        Xp, Vp, r = X, V, jnp.sum(X * X, axis=1)
    else:
        Xp = jnp.zeros((npad, p), X.dtype).at[:n].set(X)
        Vp = jnp.zeros((npad, m), V.dtype).at[:n].set(V)
        r = jnp.sum(Xp * Xp, axis=1)
    # padded rows of X are zero => their r is 0; their kernel vs real rows is
    # exp(-(r_i)/sigma) != 0, so mask the padded COLUMNS' V rows (set to 0
    # above) — the contraction then ignores them exactly.
    nblocks = npad // block

    Xb = Xp.reshape(nblocks, block, p)
    Vb = Vp.reshape(nblocks, block, m)
    rb = r.reshape(nblocks, block)
    contract_prec = (jax.lax.Precision.DEFAULT if fast_accum
                     else jax.lax.Precision.HIGHEST)

    def step(acc, blk):
        Xj, Vj, rj = blk
        g = jnp.matmul(Xp, Xj.T,               # (npad, block) rank-P GEMM
                       precision=jax.lax.Precision.HIGHEST)
        d2 = jnp.maximum(r[:, None] + rj[None, :] - 2.0 * g, 0.0)
        tile = jnp.exp(-d2 / sigma)
        return acc + jnp.matmul(tile, Vj, precision=contract_prec), None

    if init is None:
        acc0 = jnp.zeros((npad, m), X.dtype)
    elif npad == n:
        acc0 = init
    else:
        acc0 = jnp.zeros((npad, m), X.dtype).at[:n].set(init)
    Y, _ = jax.lax.scan(step, acc0, (Xb, Vb, rb))
    if out_scale is not None:
        Y = Y * out_scale
    return Y if npad == n else Y[:n]


# module-level alias (stable hash for jit static args — a fresh
# functools.partial per call would defeat the compile cache): rank-P
# part HIGHEST, tile@V at the platform's default precision
kernel_matmul_fast = functools.partial(kernel_matmul, fast_accum=True)
