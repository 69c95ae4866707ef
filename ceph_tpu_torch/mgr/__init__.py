"""The mgr (``ceph_tpu/mgr/``, ported): the daemon and its modules
(``daemon.py``, ``modules.py``, ``tuner.py``), the reported-counter
index (``daemon_state.py``), the report session's wire messages
(``messages.py``) and the daemons' reporter (``client.py``). A ``Mgr``
runs on CUDA unless given ``device="cpu"``."""
from ceph_tpu_torch.mgr.daemon import Mgr, MgrModule
from ceph_tpu_torch.mgr.modules import (
    BalancerModule, PGAutoscalerModule, ProgressModule,
    PrometheusModule, RestModule,
)

__all__ = ["Mgr", "MgrModule", "BalancerModule", "PGAutoscalerModule",
           "ProgressModule", "PrometheusModule", "RestModule"]
