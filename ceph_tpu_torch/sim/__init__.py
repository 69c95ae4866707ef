"""Cluster simulation: static churn analysis + live thrashing.

Two tiers, as in ``ceph_tpu/sim``:

- **static** (``churn.py``): replay OSD add/remove/reweight events over
  an OSDMap and measure, per epoch, how much data CRUSH remaps, with
  every placement computed batch wise on the card (ref:
  src/tools/osdmaptool.cc --test-map-pgs).
- **live** (``faults.py`` + ``thrasher.py`` + ``loadgen.py``): named,
  composable messenger and device faults a running cluster installs at
  runtime, a seeded Thrasher that drives them (and kills, revives and
  SIGKILLs daemons) against a running vstart cluster under continuing
  client writes (ref: qa/tasks/ceph_manager.py Thrasher + ``ms inject
  socket failures``), and the closed-loop session load generator.
"""

from ceph_tpu_torch.sim.churn import ChurnEvent, ChurnSim, StepReport  # noqa: F401
from ceph_tpu_torch.sim.faults import (                                # noqa: F401
    FaultInjector, FaultRule, delay, drop, duplicate, partition, reorder,
)
from ceph_tpu_torch.sim.thrasher import Thrasher                       # noqa: F401
