"""MgrReporter: the daemon side of the mgr report session.

ref: src/mgr/MgrClient.{h,cc} — every daemon (OSD, MDS, mon) follows
the committed MgrMap to the ACTIVE mgr, opens a session (MMgrOpen),
and ships its perf counters every ``mgr_stats_period``: the counter
schema once per session, then compact value deltas (changed counters
only; histograms ship their full log2 buckets when touched). An
mgrmap epoch naming a NEW active gid resets the session — the schema
is re-sent, which is exactly what repopulates a promoted standby's
empty DaemonStateIndex after failover. A send failure also resets, so
a flapping mgr costs one period of missed samples, never a wedged
session.

The reporter owns NO transport: it borrows the daemon's messenger and
a ``mgrmap_fn`` view (MonClient.mgrmap for OSD/MDS, the MgrMonitor's
own map for mons), so one implementation serves all three daemon
types.

The port's copy of ``ceph_tpu/mgr/client.py``.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import time

from ceph_tpu_torch.mgr.messages import MMgrOpen, MMgrReport
from ceph_tpu_torch.msg import EntityAddr
from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("mgrc")

# process-monotonic session tokens: a revived daemon's reporter opens
# with a HIGHER seq, so the mgr resets its state instead of letting a
# zombie's late frames interleave (mirrors the MDS gid discipline)
_SESSION_SEQ = itertools.count(1)


def schema_entries(loggers) -> list[dict]:
    """Declared schema for a set of PerfCounters loggers — every entry
    names a type PerfCounters registers (the test_meta guard pins
    this against daemon_state.ALLOWED_TYPES)."""
    out = []
    for pc in loggers:
        for key, c in pc._counters.items():
            out.append({"logger": pc.name, "counter": key,
                        "type": c.type, "doc": c.doc,
                        "monotonic": c.monotonic})
    return out


class MgrReporter:
    def __init__(self, name: str, messenger, mgrmap_fn, loggers_fn,
                 config: dict | None = None):
        self.name = name
        self.msgr = messenger
        self.mgrmap_fn = mgrmap_fn          # () -> MgrMap | None
        self.loggers_fn = loggers_fn        # () -> [PerfCounters]
        self.config = config or {}
        self._session_gid = 0               # active mgr gid we opened to
        self._seq = 0
        self._schema_sent = False
        self._reports_since_schema = 0
        self._last: dict = {}               # (logger, counter) -> value
        self.reports_sent = 0
        self.sessions_opened = 0

    async def loop(self) -> None:
        """The report loop — ``mgr_stats_period`` is read LIVE every
        iteration (0 disables reporting entirely: the bench section's
        'reporting off' leg)."""
        try:
            while True:
                period = float(self.config.get("mgr_stats_period",
                                               0.5))
                if period <= 0:
                    self._session_gid = 0
                    await asyncio.sleep(0.5)
                    continue
                try:
                    await self.report_once()
                except asyncio.CancelledError:
                    raise
                except Exception as e:       # never kill the daemon
                    log.dout(5, f"{self.name} mgr report failed: {e}")
                    self._session_gid = 0
                await asyncio.sleep(period)
        except asyncio.CancelledError:
            pass

    def _collect(self) -> dict:
        cur: dict = {}
        for pc in self.loggers_fn():
            dumped = pc.dump()
            for counter, value in dumped.items():
                cur[(pc.name, counter)] = value
        return cur

    async def report_once(self) -> bool:
        """One session-check + report. Returns True when a report was
        shipped."""
        mm = self.mgrmap_fn()
        if mm is None or not mm.available():
            self._session_gid = 0
            return False
        addr = EntityAddr(*mm.active_addr)
        peer = f"mgr.{mm.active_name}"
        if mm.active_gid != self._session_gid:
            # new active (first contact or failover): fresh session —
            # the schema travels again and the delta baseline resets
            self._seq = next(_SESSION_SEQ)
            self._schema_sent = False
            self._last = {}
            await asyncio.wait_for(self.msgr.send_message(
                MMgrOpen(daemon=self.name, session_seq=self._seq),
                addr, peer), timeout=2.0)
            self._session_gid = mm.active_gid
            self.sessions_opened += 1
        cur = self._collect()
        schema = b""
        # schema travels on session open AND periodically thereafter
        # (mgr_stats_schema_refresh reports): the mgr's index drops
        # silent daemons by TTL, and a daemon whose reports were only
        # DELAYED (a long jit compile stalling the shared loop) would
        # otherwise keep shipping schema-less reports the index must
        # reject forever — the refresh re-seeds the session within one
        # window, the one-way-channel analog of upstream's
        # reconnect-resends-schema
        refresh = int(self.config.get("mgr_stats_schema_refresh", 20))
        if not self._schema_sent or \
                self._reports_since_schema >= refresh:
            schema = json.dumps(
                schema_entries(self.loggers_fn())).encode()
        # a schema-carrying report re-seeds the receiver from scratch,
        # so it must ship FULL values — a delta against OUR baseline
        # would leave a freshly re-created index entry holding only
        # the counters that happened to move this period
        changed = cur if schema else \
            {k: v for k, v in cur.items() if self._last.get(k) != v}
        counters: dict[str, dict] = {}
        for (logger, counter), value in changed.items():
            counters.setdefault(logger, {})[counter] = value
        values = json.dumps({"t": time.monotonic(),
                             "counters": counters}).encode()
        # an all-unchanged period still reports (empty counters): the
        # mgr extends every monotonic series with a carried-forward
        # sample — "nothing happened" is a rate of 0, not a data gap —
        # and the report refreshes the index's staleness TTL
        try:
            await asyncio.wait_for(self.msgr.send_message(
                MMgrReport(daemon=self.name, session_seq=self._seq,
                           schema=schema, values=values),
                addr, peer), timeout=2.0)
        except Exception:
            self._session_gid = 0           # re-open next period
            raise
        self._schema_sent = True
        self._reports_since_schema = \
            0 if schema else self._reports_since_schema + 1
        self._last = cur
        self.reports_sent += 1
        return True

    def dump(self) -> dict:
        return {"session_gid": self._session_gid, "seq": self._seq,
                "schema_sent": self._schema_sent,
                "reports_sent": self.reports_sent,
                "sessions_opened": self.sessions_opened}
