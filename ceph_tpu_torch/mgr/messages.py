"""Mgr session wire messages: the daemon -> mgr report protocol.

ref: src/messages/MMgrOpen.h + MMgrReport.h (received by
src/mgr/DaemonServer.cc, sent by src/mgr/MgrClient.cc) — every daemon
opens a session to the ACTIVE mgr (found through the mgrmap
subscription) and streams its perf counters: the counter *schema*
(name, type, doc) once per session, then compact value deltas every
``mgr_stats_period``. The mgr's DaemonStateIndex is rebuilt entirely
from these sessions, which is what lets `/metrics` and `ceph osd perf`
survive the daemons living in other processes (ROADMAP #1b) — nothing
reads the process-local PerfCountersCollection across daemon
boundaries anymore.

Schema/value payloads are JSON blobs rather than per-counter codec
fields: the schema is declared data (the reference ships it as a
packed PerfCounterType vector; the shape matters, not the packing) and
the value report's compactness comes from the changed-counters-only
delta filter, not byte packing.

The port's copy of ``ceph_tpu/mgr/messages.py``.
"""

from __future__ import annotations

from ceph_tpu_torch.msg.message import Message, register


@register
class MMgrOpen(Message):
    """Daemon -> mgr session open (ref: MMgrOpen): announces the
    daemon name and its ``session_seq`` — a per-incarnation monotonic
    token. The mgr resets the daemon's state on a NEWER session_seq
    (fresh incarnation or post-failover re-open) and drops reports
    carrying an older one (a zombie's late frames must not resurrect
    retired state).

    NB the field is NOT named ``seq``: ``Message.seq`` is the
    messenger's per-connection frame counter, assigned on send — a
    payload field of the same name gets silently overwritten by the
    transport (a live trap: MDSBeacon carries one, unused)."""

    TYPE = 157
    FIELDS = [("daemon", "str"), ("session_seq", "u64")]


@register
class MMgrReport(Message):
    """Daemon -> mgr perf-counter report (ref: MMgrReport).

    ``schema``: JSON list of counter declarations
    ``{"logger", "counter", "type", "doc", "monotonic"}`` — sent once
    per session (empty blob afterwards); ``type`` must be one of the
    types PerfCounters registers (u64/time/avg/hist — the test_meta
    guard pins the contract). ``values``: JSON
    ``{"t": <sender monotonic stamp>, "counters": {logger: {counter:
    value}}}`` holding only counters that CHANGED since the last
    report (the compact-delta discipline); histograms ship their full
    log2 bucket vector when touched, avgs their (avgcount, sum)
    pair."""

    TYPE = 158
    FIELDS = [("daemon", "str"), ("session_seq", "u64"),
              ("schema", "blob"), ("values", "blob")]
