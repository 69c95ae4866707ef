"""In-process typed perf counters.

Analog of Ceph's PerfCounters (ref: src/common/perf_counters.h
PerfCountersBuilder / PerfCounters). Same counter taxonomy — u64 counters,
time sums, and (count, sum) averages — registered through PerfCountersBuilder and dumped
as JSON, standing in for ``ceph daemon <id> perf dump`` over the admin socket
(ref: src/common/admin_socket.cc). Histograms use fixed log2 buckets.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Dict

TYPE_U64 = "u64"          # PERFCOUNTER_U64
TYPE_TIME = "time"        # PERFCOUNTER_TIME
TYPE_LONGRUNAVG = "avg"   # PERFCOUNTER_LONGRUNAVG
TYPE_HISTOGRAM = "hist"   # PERFCOUNTER_HISTOGRAM


@dataclass
class _Counter:
    type: str
    doc: str = ""
    value: float = 0
    count: int = 0
    sum: float = 0.0
    monotonic: bool = False  # add_u64_counter (inc-only) vs add_u64 (gauge)
    buckets: list = field(default_factory=lambda: [0] * 64)


class PerfCounters:
    def __init__(self, name: str):
        self.name = name
        self._counters: Dict[str, _Counter] = {}
        self._lock = threading.Lock()

    def _get(self, key: str, expected: str) -> _Counter:
        c = self._counters[key]
        if c.type != expected:
            raise TypeError(f"counter {key} is {c.type}, not {expected}")
        return c

    def inc(self, key: str, amount: int = 1) -> None:
        with self._lock:
            self._get(key, TYPE_U64).value += amount

    def set(self, key: str, value: float) -> None:
        with self._lock:
            c = self._get(key, TYPE_U64)
            if c.monotonic:
                raise TypeError(f"counter {key} is monotonic (add_u64_"
                                f"counter); use inc(), not set()")
            c.value = value

    def tinc(self, key: str, seconds: float) -> None:
        with self._lock:
            self._get(key, TYPE_TIME).value += seconds

    def avg_add(self, key: str, value: float) -> None:
        with self._lock:
            c = self._get(key, TYPE_LONGRUNAVG)
            c.count += 1
            c.sum += value

    def hist_add(self, key: str, value: float) -> None:
        with self._lock:
            c = self._get(key, TYPE_HISTOGRAM)
            bucket = min(63, max(0, int(value).bit_length()))
            c.buckets[bucket] += 1
            c.count += 1
            c.sum += value

    class _Timer:
        def __init__(self, pc: "PerfCounters", key: str):
            self.pc, self.key = pc, key

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.pc.tinc(self.key, time.perf_counter() - self.t0)

    def timer(self, key: str) -> "_Timer":
        return self._Timer(self, key)

    def dump(self) -> dict:
        """``perf dump`` analog."""
        with self._lock:
            out = {}
            for key, c in self._counters.items():
                if c.type == TYPE_U64:
                    out[key] = int(c.value)
                elif c.type == TYPE_TIME:
                    out[key] = c.value
                elif c.type == TYPE_LONGRUNAVG:
                    out[key] = {"avgcount": c.count, "sum": c.sum}
                else:
                    out[key] = {"count": c.count, "sum": c.sum,
                                "log2_buckets": [b for b in c.buckets]}
            return out

    def dump_json(self) -> str:
        return json.dumps({self.name: self.dump()}, indent=2)


def hist_cumulative(buckets: list) -> list[tuple[float, int]]:
    """Render log2 buckets as cumulative prometheus-style ``le``
    pairs: bucket i counts values v with int(v).bit_length() == i,
    i.e. v < 2**i — so the cumulative count through bucket i is the
    count of observations <= (2**i - 1), and 2**i is a valid inclusive
    upper bound. Returns [(le, cumulative_count), ...] up to the
    highest non-empty bucket (always at least one pair), monotone by
    construction."""
    top = 0
    for i, b in enumerate(buckets):
        if b:
            top = i
    out: list[tuple[float, int]] = []
    run = 0
    for i in range(top + 1):
        run += int(buckets[i])
        out.append((float(2 ** i), run))
    return out


class PerfCountersCollection:
    """Process-wide registry of PerfCounters instances, the analog of
    CephContext's collection behind ``perf dump``
    (ref: src/common/perf_counters_collection.h PerfCountersCollection)."""

    _instance: "PerfCountersCollection | None" = None

    def __init__(self) -> None:
        self._loggers: Dict[str, PerfCounters] = {}
        self._lock = threading.Lock()

    @classmethod
    def instance(cls) -> "PerfCountersCollection":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def add(self, pc: PerfCounters) -> None:
        with self._lock:
            self._loggers[pc.name] = pc

    def remove(self, pc: PerfCounters) -> None:
        with self._lock:
            self._loggers.pop(pc.name, None)

    def get(self, name: str) -> PerfCounters | None:
        with self._lock:
            return self._loggers.get(name)

    def dump(self) -> dict:
        """Cluster-of-one ``perf dump``: {logger_name: {counter: value}}."""
        with self._lock:
            return {name: pc.dump() for name, pc in self._loggers.items()}

    def dump_json(self) -> str:
        return json.dumps(self.dump(), indent=2, sort_keys=True)


class PerfCountersBuilder:
    """ref: src/common/perf_counters.h PerfCountersBuilder."""

    def __init__(self, name: str):
        self._pc = PerfCounters(name)

    def add_u64_counter(self, key: str, doc: str = "") -> "PerfCountersBuilder":
        """Monotonic counter (inc-only), PERFCOUNTER_COUNTER analog."""
        self._pc._counters[key] = _Counter(TYPE_U64, doc, monotonic=True)
        return self

    def add_u64(self, key: str, doc: str = "") -> "PerfCountersBuilder":
        """Gauge (set allowed), plain PERFCOUNTER_U64 analog."""
        self._pc._counters[key] = _Counter(TYPE_U64, doc)
        return self

    def add_time(self, key: str, doc: str = "") -> "PerfCountersBuilder":
        self._pc._counters[key] = _Counter(TYPE_TIME, doc)
        return self

    def add_time_avg(self, key: str, doc: str = "") -> "PerfCountersBuilder":
        self._pc._counters[key] = _Counter(TYPE_LONGRUNAVG, doc)
        return self

    def add_histogram(self, key: str, doc: str = "") -> "PerfCountersBuilder":
        self._pc._counters[key] = _Counter(TYPE_HISTOGRAM, doc)
        return self

    def create_perf_counters(self, register: bool = True) -> PerfCounters:
        """Finalize; registers with the process collection by default, the
        way daemons hand their counters to the CephContext collection."""
        if register:
            PerfCountersCollection.instance().add(self._pc)
        return self._pc
