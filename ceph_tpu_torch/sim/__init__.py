"""Cluster simulation: the static churn analysis (``churn.py``).

Replays OSD add/remove/reweight events over an OSDMap and measures, per
epoch, how much data CRUSH remaps, with every placement computed batch
wise on the card (ref: src/tools/osdmaptool.cc --test-map-pgs). The
reference's live tier (``faults``, ``thrasher``) drives the host cluster
and is not ported.
"""

from ceph_tpu_torch.sim.churn import ChurnEvent, ChurnSim, StepReport  # noqa: F401
