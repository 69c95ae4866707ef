"""Cluster simulation: the static churn analysis (``churn.py``).

Replays OSD add/remove/reweight events over an OSDMap and measures, per
epoch, how much data CRUSH remaps, with every placement computed batch
wise on the card (ref: src/tools/osdmaptool.cc --test-map-pgs), and
the live tier's fault layer (``faults.py``): named, composable messenger
and device faults a running cluster installs at runtime. The Thrasher
waits for its port (ROADMAP Queue A item 4).
"""

from ceph_tpu_torch.sim.churn import ChurnEvent, ChurnSim, StepReport  # noqa: F401
from ceph_tpu_torch.sim.faults import (                                # noqa: F401
    FaultInjector, FaultRule, delay, drop, duplicate, partition, reorder,
)
