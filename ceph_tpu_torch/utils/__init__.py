"""Device selection, kernel build, timing, bounds and perf counters."""

from ceph_tpu_torch.utils.config import Config, ConfigProxy, Option, OPTIONS
from ceph_tpu_torch.utils.logging import get_logger, set_subsys_level
from ceph_tpu_torch.utils.perf_counters import PerfCounters, PerfCountersBuilder
