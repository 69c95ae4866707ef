"""DaemonStateIndex: the mgr's per-daemon reported-counter store.

ref: src/mgr/DaemonState.{h,cc} (DaemonStateIndex + DaemonState) — the
receiving half of the MMgrOpen/MMgrReport session protocol
(src/mgr/DaemonServer.cc). Every reporting daemon gets one
:class:`DaemonState`: its counter *schema* (sent once per session),
the latest value per counter, and a bounded ring-buffer TIME SERIES
per monotonic counter — ``mgr_stats_retention`` samples deep — that
turns instantaneous gauges into answerable questions ("is recovery
speeding up or stalling?") via :meth:`rate`. Histograms keep their
latest log2 bucket vector for :meth:`percentile` reads.

Self-healing discipline (the TracingModule-cursor analog): the index
is rebuilt ENTIRELY from fresh sessions — a promoted standby mgr
starts empty, daemons re-open against it (schema re-sent because the
session seq changed), and the index repopulates within one report
period. Staleness is handled by TTL (:meth:`cull`), not connection
resets: a TCP reset the daemon transparently reconnects across must
not wipe state that the very next report extends, while a genuinely
dead daemon stops reporting and ages out.

The port's copy of ``ceph_tpu/mgr/daemon_state.py``, on the port's
``utils/perf_counters.py`` types.
"""

from __future__ import annotations

import time
from collections import deque

from ceph_tpu_torch.utils.perf_counters import (
    TYPE_HISTOGRAM, TYPE_LONGRUNAVG, TYPE_TIME, TYPE_U64,
)

# every type a shipped schema entry may name MUST be a type
# PerfCounters registers (the test_meta guard pins this set against
# the perf_counters module, so the two cannot drift apart)
ALLOWED_TYPES = frozenset(
    (TYPE_U64, TYPE_TIME, TYPE_LONGRUNAVG, TYPE_HISTOGRAM))


class DaemonState:
    """One reporting daemon's schema + latest values + time series."""

    def __init__(self, name: str, seq: int, retention: int):
        self.name = name
        self.seq = seq                     # session token (MMgrOpen)
        self.retention = max(int(retention), 2)
        # (logger, counter) -> {"type", "doc", "monotonic"}
        self.schema: dict[tuple[str, str], dict] = {}
        # (logger, counter) -> latest reported value (scalar for
        # u64/time, {"avgcount","sum"} for avg,
        # {"count","sum","log2_buckets"} for hist)
        self.latest: dict[tuple[str, str], object] = {}
        # (logger, counter) -> deque[(sender_ts, value)] — monotonic
        # u64 counters only (rates over gauges are meaningless)
        self.series: dict[tuple[str, str], deque] = {}
        self.last_report = time.monotonic()
        self.reports = 0

    def apply_schema(self, entries: list) -> int:
        """Install schema entries; returns how many were accepted.
        Entries naming a type PerfCounters does not register are
        DROPPED (schema is declared data from arbitrary daemons —
        a bad entry must not poison the index)."""
        n = 0
        for ent in entries:
            if not isinstance(ent, dict):
                continue
            typ = ent.get("type")
            logger, counter = ent.get("logger"), ent.get("counter")
            if typ not in ALLOWED_TYPES or not logger or not counter:
                continue
            key = (str(logger), str(counter))
            self.schema[key] = {
                "type": typ, "doc": str(ent.get("doc", "")),
                "monotonic": bool(ent.get("monotonic"))}
            n += 1
        return n

    def apply_values(self, ts: float, counters: dict) -> None:
        """Apply one report's changed-counter payload; values for
        counters WITHOUT a schema entry are dropped (schema-first
        discipline — it is what forces a clean re-open after mgr
        failover instead of typeless guessing). Every schema'd
        monotonic counter gets a series sample each report (changed or
        not — an unchanged counter means rate 0 over the span, which
        the series must be able to say)."""
        for logger, vals in counters.items():
            if not isinstance(vals, dict):
                continue
            for counter, value in vals.items():
                key = (str(logger), str(counter))
                if key in self.schema:
                    self.latest[key] = value
        for key, sch in self.schema.items():
            if not (sch["type"] == TYPE_U64 and sch["monotonic"]):
                continue
            val = self.latest.get(key)
            if not isinstance(val, (int, float)):
                continue
            ring = self.series.get(key)
            if ring is None:
                ring = self.series[key] = deque(maxlen=self.retention)
            ring.append((float(ts), float(val)))
        self.last_report = time.monotonic()
        self.reports += 1

    # -- queries -----------------------------------------------------------
    def rate(self, logger: str, counter: str,
             window_s: float | None = None) -> float | None:
        """Derivative of a monotonic counter over its ring: the slope
        between the newest sample and the oldest sample inside
        ``window_s`` (whole ring when None). None when the counter has
        no series (unknown, non-monotonic, or < 2 samples)."""
        ring = self.series.get((logger, counter))
        if not ring or len(ring) < 2:
            return None
        t1, v1 = ring[-1]
        t0, v0 = ring[0]
        if window_s is not None:
            for ts, val in ring:
                if ts >= t1 - window_s:
                    t0, v0 = ts, val
                    break
        if t1 <= t0:
            return None
        return (v1 - v0) / (t1 - t0)

    def percentile(self, logger: str, counter: str,
                   q: float) -> float | None:
        """Upper-bound read of quantile ``q`` from the latest log2
        bucket vector: bucket i holds values v with
        int(v).bit_length() == i, so 2**i is a valid inclusive upper
        bound for everything through bucket i (same contract as
        hist_cumulative)."""
        val = self.latest.get((logger, counter))
        if not isinstance(val, dict) or "log2_buckets" not in val:
            return None
        total = int(val.get("count", 0))
        if total <= 0:
            return None
        target = max(1, int(q * total + 0.999999))
        run = 0
        for i, b in enumerate(val["log2_buckets"]):
            run += int(b)
            if run >= target:
                return float(2 ** i)
        return float(2 ** (len(val["log2_buckets"]) - 1))

    def avg_value(self, logger: str, counter: str) -> float | None:
        """Mean of a reported time-avg counter (sum/avgcount)."""
        val = self.latest.get((logger, counter))
        if not isinstance(val, dict) or not val.get("avgcount"):
            return None
        return float(val["sum"]) / float(val["avgcount"])

    def dump(self) -> dict:
        """The reported state rendered perf-dump-shaped:
        {logger: {counter: value}} — directly comparable with the
        daemon's own local ``perf dump``."""
        out: dict[str, dict] = {}
        for (logger, counter), val in self.latest.items():
            out.setdefault(logger, {})[counter] = val
        return out


class DaemonStateIndex:
    """All reporting daemons, keyed by entity name (ref:
    DaemonStateIndex). The consumers: PrometheusModule renders
    `/metrics` from :meth:`dump_all`, `ceph daemon-stats` serves
    :meth:`rate` tables, and the ProgressModule's osd-perf digest
    reads :meth:`DaemonState.avg_value`."""

    def __init__(self, retention: int = 120):
        self.retention = retention
        self.daemons: dict[str, DaemonState] = {}

    def open(self, name: str, seq: int) -> DaemonState:
        """New session: a newer seq RESETS the daemon's state (fresh
        incarnation / post-failover re-open must not inherit retired
        counters); an older one is a zombie's late open and keeps the
        current state."""
        cur = self.daemons.get(name)
        if cur is not None and seq <= cur.seq:
            return cur
        st = DaemonState(name, seq, self.retention)
        self.daemons[name] = st
        return st

    def report(self, name: str, seq: int, schema: list | None,
               ts: float, counters: dict) -> bool:
        """Apply one MMgrReport payload. A report carrying schema is
        self-sufficient (an open that raced or was lost re-creates the
        session here); a schema-less report for an unknown daemon or a
        stale seq is dropped — the sender will re-open with schema on
        its next period once it notices."""
        st = self.daemons.get(name)
        if st is None or seq > st.seq:
            if not schema:
                return False
            st = self.open(name, seq)
        elif seq < st.seq:
            return False                    # zombie incarnation
        if schema:
            st.apply_schema(schema)
        st.apply_values(ts, counters or {})
        return True

    def remove(self, name: str) -> None:
        self.daemons.pop(name, None)

    def cull(self, stale_s: float) -> list[str]:
        """Drop daemons silent past ``stale_s`` (TTL, not conn-reset
        — see the module docstring); returns the culled names."""
        now = time.monotonic()
        dead = [n for n, st in self.daemons.items()
                if now - st.last_report > stale_s]
        for n in dead:
            self.daemons.pop(n, None)
        return dead

    def rate(self, name: str, logger: str, counter: str,
             window_s: float | None = None) -> float | None:
        st = self.daemons.get(name)
        return st.rate(logger, counter, window_s) if st else None

    def dump_all(self) -> dict:
        """{daemon: {logger: {counter: value}}} — the reported-state
        view `/metrics` renders from."""
        return {name: st.dump()
                for name, st in sorted(self.daemons.items())}

    def daemon_stats(self, name: str) -> dict | None:
        """The `ceph daemon-stats <name>` payload: latest values plus
        live rates for every monotonic counter with >= 2 samples."""
        st = self.daemons.get(name)
        if st is None:
            return None
        rates = {}
        for (logger, counter), sch in st.schema.items():
            if sch["type"] == TYPE_U64 and sch["monotonic"]:
                r = st.rate(logger, counter)
                if r is not None:
                    rates.setdefault(logger, {})[counter] = round(r, 3)
        return {"daemon": name, "reports": st.reports,
                "series_depth": max(
                    (len(r) for r in st.series.values()), default=0),
                "latest": st.dump(), "rates_per_s": rates}
