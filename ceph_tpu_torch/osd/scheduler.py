"""The op scheduler's cost rule, the part of ``ceph_tpu/osd/scheduler.py``
the EC read aggregator charges repair decodes through.

The dmClock scheduler itself waits for the cluster port; callers pass
any object with ``async grant(op_class, cost=...)``.
"""

from __future__ import annotations


def size_scaled_cost(config: dict, nbytes: int) -> float:
    """dmClock size-scaled cost (ref: the mclock cost-per-byte options):
    an op advances its queue's virtual time by
    ``max(1, bytes / osd_qos_cost_per_io_bytes)`` tag units instead of a
    flat 1. ONE definition: client admission and the recovery throttle
    charge through it, so the two paths can never silently diverge."""
    per_io = int(config.get("osd_qos_cost_per_io_bytes", 65536))
    return max(1.0, nbytes / max(per_io, 1))
