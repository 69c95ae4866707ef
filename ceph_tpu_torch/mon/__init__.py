"""The monitor tier of the port: the quorum (``Monitor``, ``MonMap``,
``MonitorDBStore``), its services and ``MonClient``. ``Monitor`` and
``MonClient`` decode maps onto the card unless given ``device="cpu"``."""
from ceph_tpu_torch.mon.client import MonClient
from ceph_tpu_torch.mon.monitor import Monitor, MonMap
from ceph_tpu_torch.mon.store import MonitorDBStore

__all__ = ["Monitor", "MonMap", "MonClient", "MonitorDBStore"]
