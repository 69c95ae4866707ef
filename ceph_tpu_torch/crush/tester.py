"""The crushtool --test engine, batched.

ref: src/crush/CrushTester.{h,cc} (CrushTester::test) — loops x over
[min_x, max_x], runs the rule, and aggregates per-device utilization,
bad-mapping counts and timing. Here the whole x range is one (or a few)
batched mapper calls on the device instead of a scalar loop.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ceph_tpu_torch.crush.mapper import Mapper
from ceph_tpu_torch.crush.types import CrushMap, ITEM_NONE
from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("crush")


@dataclasses.dataclass
class TestResult:
    rule: int
    num_rep: int
    total_x: int
    device_counts: np.ndarray          # (max_devices,) placements per device
    bad_mappings: int                  # x's with < num_rep distinct devices
    seconds: float
    mappings: np.ndarray | None = None  # (N, num_rep) if requested

    @property
    def mappings_per_second(self) -> float:
        return self.total_x / self.seconds if self.seconds else float("inf")

    def utilization_summary(self) -> dict:
        c = self.device_counts
        active = c[c > 0]
        expected = c.sum() / max(len(c), 1)
        return {
            "devices": int(len(c)),
            "active_devices": int(len(active)),
            "placements": int(c.sum()),
            "expected_per_device": float(expected),
            "min": int(c.min()) if len(c) else 0,
            "max": int(c.max()) if len(c) else 0,
            "stddev": float(c.std()),
        }


class CrushTester:
    """ref: src/crush/CrushTester.h CrushTester."""

    def __init__(self, crush_map: CrushMap,
                 device_weights: np.ndarray | None = None,
                 batch: int | None = None, device=None):
        self.map = crush_map
        # batch bounds device memory: it becomes the Mapper's VM tile size
        self.mapper = Mapper(crush_map, device_weights, block=batch,
                             device=device)
        self.batch = batch
        from ceph_tpu_torch.utils.perf_counters import (
            PerfCountersBuilder, PerfCountersCollection)
        existing = PerfCountersCollection.instance().get("crush_tester")
        self.perf = existing or (
            PerfCountersBuilder("crush_tester")
            .add_u64_counter("mappings", "PGs mapped")
            .add_u64_counter("bad_mappings", "short firstn results")
            .add_time("map_seconds", "time in test sweeps")
            .create_perf_counters())

    def test(self, rule: int, num_rep: int, min_x: int = 0,
             max_x: int = 1023, keep_mappings: bool = False) -> TestResult:
        """Aggregated sweep over [min_x, max_x].

        Without keep_mappings this is Mapper.sweep: per-device counts
        accumulate on the device and only the (max_devices,) count
        vector is read back.

        Bad mappings follow CrushTester's meaning (result size < num_rep):
        counted for firstn rules only — indep/EC rules emit ITEM_NONE
        holes as *expected* degraded output (ref: src/crush/CrushTester.cc
        CrushTester::test size check on do_rule's result vector).
        """
        n = max_x - min_x + 1
        t0 = time.perf_counter()
        if keep_mappings:
            out = self.mapper.map_pgs(
                rule, np.arange(min_x, max_x + 1, dtype=np.int64),
                num_rep).cpu().numpy()
            valid = out != ITEM_NONE
            counts = np.bincount(out[valid],
                                 minlength=self.map.max_devices)
            if self.mapper.rule_is_firstn(rule):
                bad = int((valid.sum(axis=1) < num_rep).sum())
            else:
                bad = 0
            kept = out
        else:
            counts_dev, bad_dev = self.mapper.sweep(rule, min_x, n, num_rep)
            counts = counts_dev.cpu().numpy()   # readback waits for the run
            bad = int(bad_dev)
            kept = None
        seconds = time.perf_counter() - t0
        self.perf.inc("mappings", n)
        self.perf.inc("bad_mappings", bad)
        self.perf.tinc("map_seconds", seconds)
        res = TestResult(
            rule=rule, num_rep=num_rep, total_x=n,
            device_counts=counts, bad_mappings=bad, seconds=seconds,
            mappings=kept)
        log.dout(5, "test done", rule=rule, num_rep=num_rep, n=n,
                 secs=round(seconds, 3))
        return res
