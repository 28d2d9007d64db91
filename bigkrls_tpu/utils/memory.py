"""Device-memory introspection shared by every memory-aware sizing rule.

The streaming eigensolver, the blocked acf statistic, and the mesh eig
crossover all size their working sets against the accelerator's reported
memory.  The lookup lives here once: ``memory_stats()['bytes_limit']``.
Only the CPU backend may report nothing; there the budget is a fixed
8 GiB, a stand-in for host memory that keeps CPU test runs small.  An
accelerator that reports no limit is an error, because every sizing rule
would otherwise plan against a number that describes no real device.
"""
from __future__ import annotations

import jax

CPU_BUDGET = 8 * 1024 ** 3


def device_memory_budget() -> int:
    """Bytes of device memory to plan against (this process's first
    device: in a multi-host run only local devices report memory)."""
    dev = jax.local_devices()[0]
    limit = (dev.memory_stats() or {}).get("bytes_limit")
    if limit:
        return int(limit)
    if dev.platform == "cpu":
        return CPU_BUDGET
    raise RuntimeError(
        f"device {dev.device_kind!r} ({dev.platform}) reports no "
        "memory_stats()['bytes_limit']; cannot size device working sets")
