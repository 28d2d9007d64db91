"""Multi-device sharding for the KRLS fit — the replacement for the
reference's shared-memory bigmemory backing + PSOCK worker pool
(SURVEY.md §2.5, §5.8).

Design: a 2-D logical mesh ("i", "j").  Every O(N²) object (kernel K,
covariance quadratic forms) is block-sharded over both axes; O(N·k) and
O(N·P) objects are row-sharded over "i"; small vectors are replicated.
``jax.jit`` with sharding annotations makes XLA insert the all-gathers /
reduce-scatters — there is no hand-written communication in the dense
path (``parallel/ring_kernel.py`` is the explicit ppermute ring for
kernel construction and the streaming products).
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(shape: Optional[Sequence[int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Create a 2-D ("i", "j") mesh over the available devices.

    ``shape=None`` picks the most-square factorization of the device count,
    which maximizes block-sharding balance for the N×N objects.
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    d = len(devices)
    if shape is None:
        a = int(np.floor(np.sqrt(d)))
        while d % a:
            a -= 1
        shape = (a, d // a)
    mesh_devices = np.asarray(devices).reshape(shape)
    return Mesh(mesh_devices, axis_names=("i", "j"))


def row_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("i", None))


def block_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("i", "j"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def spans_processes(mesh: Mesh) -> bool:
    """True when the mesh covers devices of more than one host process."""
    return any(d.process_index != jax.process_index()
               for d in mesh.devices.flat)


def place(arr, sharding: NamedSharding):
    """Commit ``arr`` to ``sharding``, multi-host safe.

    Single-process: plain ``device_put``.  Multi-host (the mesh spans
    non-addressable devices): every host holds the full host-local value —
    the fit's inputs are replicated across processes by construction, like
    the reference's per-worker re-attach of the same shared matrices
    (``R/bigKRLS.R:348-354``) — so the global array is assembled from
    local shards via ``make_array_from_callback``.
    """
    if not spans_processes(sharding.mesh):
        return jax.device_put(arr, sharding)
    arr_np = np.asarray(arr)
    return jax.make_array_from_callback(
        arr_np.shape, sharding, lambda idx: arr_np[idx])


def commit(arr, sharding: NamedSharding):
    """Reshard an existing (possibly global) jax.Array onto ``sharding``
    through a jitted identity — works across processes, where an eager
    ``device_put`` of a device array may not."""
    if not spans_processes(sharding.mesh):
        return jax.device_put(arr, sharding)
    return jax.jit(lambda x: x, out_shardings=sharding)(arr)


def host_gather(arr) -> np.ndarray:
    """Fetch an array to host numpy, all-gathering across processes when
    it is not fully addressable (multi-host fits: coefficients,
    derivatives and fitted values are row-sharded over all hosts)."""
    if isinstance(arr, jax.Array) and not arr.is_fully_addressable:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(arr, tiled=True))
    return np.asarray(arr)


def shard_fit_arrays(mesh: Mesh, X_std, y_std):
    """Place the standardized inputs for a sharded fit: X row-sharded over
    "i" (rows of the kernel/eigenvectors live with their device row),
    y replicated (it is O(N) and feeds reductions everywhere)."""
    X_std = place(X_std, row_sharding(mesh))
    y_std = place(y_std, replicated(mesh))
    return X_std, y_std


@functools.lru_cache(maxsize=8)
def sharded_gauss_kernel(mesh: Mesh):
    """A jitted Gaussian-kernel builder whose N×N output is block-sharded
    over ("i", "j") — the distributed replacement for the reference's
    single shared-memory K (``src/gauss_kernel.cpp``).  X enters
    row-sharded; the rank-P GEMM and the exp epilogue are partitioned by
    XLA according to the output sharding, so each device computes exactly
    its own K block (collecting the column row-block of X from its peers)."""
    from ..ops.kernels import gauss_kernel

    return jax.jit(
        gauss_kernel,
        static_argnames=("explicit",),
        in_shardings=(row_sharding(mesh), NamedSharding(mesh, P())),
        out_shardings=block_sharding(mesh),
    )


def shard_info(arr) -> Optional[dict]:
    """Device-placement summary of one array for ``KRLSModel.sharding_report``."""
    sharding = getattr(arr, "sharding", None)
    if sharding is None:
        return None
    shards = getattr(arr, "addressable_shards", None)
    shard_shape = tuple(shards[0].data.shape) if shards else None
    return {
        "shape": tuple(arr.shape),
        "shard_shape": shard_shape,
        "devices": len(sharding.device_set),
        "replicated": bool(sharding.is_fully_replicated),
    }
