"""Ring-pass blocked Gaussian kernel construction.

The reference's scaling wall is single-node RAM: every O(N²) object lives
in one shared-memory bigmemory matrix (~5N² doubles, ``INSTALL.md:75``).
The answer here (SURVEY.md §2.5 "SP/CP" row and §5.7; BASELINE.json
north star) is a **ring kernel**, à la ring attention: X is row-sharded
over the mesh ring; at each of D steps every device computes one
(N/D × N/D) kernel tile against a *visiting* row-block of X and forwards
that block to its ring neighbor.  No device ever materializes more than
its own (N/D × N) stripe of K plus one (N/D × P) visiting block, so N
scales with the number of devices, past any single device's memory.

Implementation: ``shard_map`` over a 1-D ring axis; the block rotation is
``jax.lax.ppermute``, which XLA lowers to a collective-permute (NCCL
between GPUs) that it can overlap with the tile matmul.  The per-step
tile compute is the rank-P matmul identity from ``ops/kernels.py``.  On
cards joined all to all (NVLink) every ring neighbour is as close as any
other, so the ring follows the algorithm, not the wiring.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map


def make_ring_mesh(devices=None) -> Mesh:
    devices = list(jax.devices()) if devices is None else list(devices)
    return Mesh(np.asarray(devices), axis_names=("r",))


def _tile(Xa, Xb, sigma):
    ra = jnp.sum(Xa * Xa, axis=1)
    rb = jnp.sum(Xb * Xb, axis=1)
    g = jnp.matmul(Xa, Xb.T, precision=jax.lax.Precision.HIGHEST)
    d2 = jnp.maximum(ra[:, None] + rb[None, :] - 2.0 * g, 0.0)
    return jnp.exp(-d2 / sigma)


def ring_gauss_kernel(mesh: Mesh, X_std, sigma) -> jax.Array:
    """N×N Gaussian kernel, row-sharded over the ring axis of ``mesh``.

    ``X_std`` must have N divisible by the ring size (pad upstream if not;
    ``fit`` never calls this with ragged N — see ``padded_ring_kernel``).
    Returns K with rows sharded over "r".
    """
    ndev = mesh.devices.size
    n, p = X_std.shape
    if n % ndev:
        raise ValueError(f"N={n} not divisible by ring size {ndev}")
    b = n // ndev
    sigma = jnp.asarray(sigma, X_std.dtype)

    def local(x_own):
        # x_own: (b, P) — this device's rows
        idx = jax.lax.axis_index("r")
        perm = [(k, (k - 1) % ndev) for k in range(ndev)]

        def step(carry, s):
            visiting = carry            # block originally from (idx+s) % ndev
            tile = _tile(x_own, visiting, sigma)          # (b, b)
            owner = (idx + s) % ndev
            visiting = jax.lax.ppermute(visiting, axis_name="r", perm=perm)
            return visiting, (owner, tile)

        _, (owners, tiles) = jax.lax.scan(step, x_own, jnp.arange(ndev))
        # tiles: (ndev, b, b); owners[s] = column-block index of tiles[s]
        stripe = jax.lax.pcast(jnp.zeros((b, ndev * b), X_std.dtype), ('r',), to='varying')

        def place(s, stripe):
            return jax.lax.dynamic_update_slice(
                stripe, tiles[s], (0, owners[s] * b))

        stripe = jax.lax.fori_loop(0, ndev, place, stripe)
        return stripe

    fn = shard_map(
        local, mesh=mesh,
        in_specs=P("r", None),
        out_specs=P("r", None),
    )
    return jax.jit(fn)(X_std)


@functools.lru_cache(maxsize=8)
def make_ring_matmul(mesh: Mesh):
    """Kernel-free ring matmul: Y = K(X) @ V with X *and* V row-sharded
    over the ring — the streaming-fit analog of ring attention, and the
    component VERDICT r01 asked to wire into the pipeline (SURVEY.md §2.5
    SP/CP row).

    Unlike ``ops/matvec.kernel_matmul`` (one device, full X resident),
    here **no device ever holds X, V or any K stripe bigger than its own
    (N/D)-row block**: at each of D steps a device computes one
    (N/D × N/D) kernel tile against the *visiting* (X, V) row-block,
    accumulates ``tile @ V_visit`` into its local output block, and
    forwards the visiting pair to its ring neighbor via ``ppermute``
    (a collective-permute; the compiler overlaps it with the tile
    GEMMs).  Per-device memory is O(N/D · (P + m)); FLOPs
    are the same 2N²(P+m) as the dense product, spread over D chips.

    Returned callable has the ``(X, V, sigma) -> Y`` signature of
    ``kernel_matmul``, so ``eigensystem_streaming`` / ``ops/effects``
    accept it as a drop-in ``matmul`` backend.  Cached per mesh so the
    callable is a stable jit static argument.
    """
    ndev = int(mesh.devices.size)
    axis = mesh.axis_names[0]
    perm = [(k, (k - 1) % ndev) for k in range(ndev)]

    def local(x_own, v_own, sigma):
        def step(carry, _):
            x_vis, v_vis, acc = carry
            tile = _tile(x_own, x_vis, sigma)              # (b, b)
            acc = acc + tile @ v_vis                       # (b, m)
            x_vis = jax.lax.ppermute(x_vis, axis_name=axis, perm=perm)
            v_vis = jax.lax.ppermute(v_vis, axis_name=axis, perm=perm)
            return (x_vis, v_vis, acc), None

        acc0 = jax.lax.pcast(
            jnp.zeros((x_own.shape[0], v_own.shape[1]), x_own.dtype),
            (axis,), to='varying')
        (_, _, acc), _ = jax.lax.scan(step, (x_own, v_own, acc0), None,
                                      length=ndev)
        return acc

    sm = shard_map(local, mesh=mesh,
                   in_specs=(P(axis, None), P(axis, None), P()),
                   out_specs=P(axis, None))

    @jax.jit
    def ring_matmul(X, V, sigma):
        n, p = X.shape
        m = V.shape[1]
        npad = ((n + ndev - 1) // ndev) * ndev
        sigma = jnp.asarray(sigma, X.dtype)
        if npad != n:
            # zero V rows for padded X rows => padded kernel columns
            # contribute exactly 0; padded output rows are sliced away
            X = jnp.zeros((npad, p), X.dtype).at[:n].set(X)
            V = jnp.zeros((npad, m), V.dtype).at[:n].set(V)
        Y = sm(X, V, sigma)
        return Y[:n]

    return ring_matmul


def ring_mesh_of(mesh: Mesh) -> Mesh:
    """Flatten any mesh's devices into a 1-D ring mesh (axis "r")."""
    if mesh.axis_names == ("r",):
        return mesh
    return Mesh(mesh.devices.reshape(-1), axis_names=("r",))


def padded_ring_kernel(mesh: Mesh, X_std, sigma) -> jax.Array:
    """Ring kernel for arbitrary N: zero-pads rows to a ring multiple
    (exact — padded rows only produce discarded stripe rows) and slices."""
    ndev = mesh.devices.size
    n, p = X_std.shape
    npad = ((n + ndev - 1) // ndev) * ndev
    if npad != n:
        Xp = jnp.zeros((npad, p), X_std.dtype).at[:n].set(X_std)
    else:
        Xp = X_std
    Xp = jax.device_put(Xp, NamedSharding(mesh, P("r", None)))
    K = ring_gauss_kernel(mesh, Xp, sigma)
    return K[:n, :n]
