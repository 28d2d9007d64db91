"""Multi-host initialization — the distributed communication backend.

The reference has no distributed backend at all: its "communication" is
POSIX shared memory plus PSOCK task dispatch on one node
(``R/bigKRLS.R:337-354``, SURVEY.md §5.8 — workers re-attach big matrices
by reading ``.desc`` descriptor files).  Here multi-host runs use JAX's
standard runtime: call :func:`initialize_distributed` once per host
process *before any JAX computation*; every mesh/sharding in ``parallel/``
then spans the global device set, with pjit/shard_map emitting
collectives (NCCL between GPUs) within a host and across hosts.  Shardings
replace descriptor files as the addressing scheme.

Tested for real in ``tests/test_distributed.py``: two spawned CPU
processes form a coordinator + worker pair, build a global 2-D mesh over
4 devices (2 local per process), and run a sharded GEMM whose result is
checked against numpy on both hosts.
"""
from __future__ import annotations

import logging
from typing import Optional, Sequence

import jax

log = logging.getLogger("bigkrls_tpu")


def is_initialized() -> bool:
    """True if the multi-host runtime (coordinator client) is already up."""
    try:
        return bool(jax.distributed.is_initialized())
    except AttributeError:  # older jax: fall back to the global state
        from jax._src import distributed as _dist
        return _dist.global_state.client is not None


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> int:
    """Initialize the multi-host runtime; returns the global device count.

    With no arguments, ``jax.distributed.initialize()`` auto-detects the
    cluster environment (SLURM, Open MPI,
    ``JAX_COORDINATOR_ADDRESS``-style variables).  If nothing is detected
    — a plain single-host run — that raises inside JAX; we catch it and
    proceed single-process, which is the correct no-op.  When the caller
    passes explicit coordination arguments, errors propagate: a requested
    multi-host setup that cannot form is a real failure, never silently
    downgraded to one host.

    Idempotent: a second call returns the device count without touching
    the already-running coordinator service.
    """
    if is_initialized():
        return len(jax.devices())

    explicit = coordinator_address is not None or (
        num_processes is not None and num_processes > 1)
    kwargs = {}
    if local_device_ids is not None:
        kwargs["local_device_ids"] = list(local_device_ids)
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **kwargs,
        )
    except (ValueError, RuntimeError) as e:
        if explicit:
            raise
        # No cluster environment detected (or JAX backends already came up
        # in this single-host process): single-process execution.
        log.debug("single-host run (no cluster auto-detected): %s", e)
    return len(jax.devices())


def global_mesh(shape: Optional[Sequence[int]] = None):
    """A 2-D ("i","j") mesh over ALL global devices (all hosts)."""
    from .sharded import make_mesh
    return make_mesh(shape=shape, devices=jax.devices())


def process_info() -> dict:
    """Host-placement summary: this process's index, count, device split."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
