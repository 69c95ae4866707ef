"""Crash capture: daemons' top-level task exception hook (round 14).

ref: src/global/signal_handler.cc + the ceph-crash/crash-module
pipeline — upstream daemons dump a crash metadata file on a fatal
signal and ``ceph-crash`` posts it to the mon, where `ceph crash ls`
and the RECENT_CRASH health warning surface it until acknowledged.

Here the failure mode worth catching is an asyncio one: every daemon
runs its long-lived loops (heartbeats, stats, admission, reporting) as
fire-and-forget tasks, and an uncaught exception in one of them kills
the loop SILENTLY — the daemon limps on half-alive, which is exactly
the gray failure the observability plane exists to expose.
:func:`watch` is the hook: wrap the task at spawn, and a non-cancel
death builds a BOUNDED crash report (exception, capped traceback,
daemon identity, wall time) and ships it monward as an
:class:`~ceph_tpu_torch.mon.messages.MCrashReport` — fire-and-forget,
leader-forwarded like every other daemon report. The mon pools reports
in memory, serves ``ceph crash ls/info <id>`` (read-only cap class),
and raises RECENT_CRASH until ``ceph crash archive`` acks them.

A bounded process-local ring (:func:`recent_crashes`) keeps the same
reports for asok/debug reads even when no mon is reachable.

The port's copy of ``ceph_tpu/utils/crash.py``.
"""

from __future__ import annotations

import asyncio
import itertools
import time
import traceback
from collections import deque

from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("crash")

# hard caps: a crash report must never become the memory problem (or
# the giant frame) it exists to report
MAX_TRACEBACK = 4000
MAX_EXCEPTION = 400

_RECENT: deque = deque(maxlen=16)
_SEQ = itertools.count(1)


def build_report(daemon: str, exc: BaseException,
                 where: str = "") -> dict:
    """One bounded crash report dict. ``crash_id`` is unique per
    process (stamp + seq + daemon) — the mon keys its pool on it."""
    stamp = time.time()
    tb = "".join(traceback.format_exception(
        type(exc), exc, exc.__traceback__))
    return {
        "crash_id": f"{int(stamp)}.{next(_SEQ)}.{daemon}",
        "daemon": str(daemon),
        "where": str(where)[:120],
        "exception": repr(exc)[:MAX_EXCEPTION],
        "traceback": tb[-MAX_TRACEBACK:],
        "stamp": stamp,
    }


def recent_crashes() -> list[dict]:
    """The process-local ring (newest last) — the asok/debug view."""
    return list(_RECENT)


def watch(task: asyncio.Task, daemon: str, monc,
          where: str = "") -> asyncio.Task:
    """The top-level task exception hook: attach a done-callback that,
    when ``task`` dies with a real exception (cancellation is a normal
    stop, not a crash), records a bounded report locally and ships it
    monward via ``monc.send_report``. Returns ``task`` so spawn sites
    wrap in place:

        self._hb_task = crash.watch(
            asyncio.ensure_future(self._hb_loop()), name, self.monc,
            where="hb_loop")

    Shipping is itself fire-and-forget and exception-swallowed: crash
    reporting must never cascade a second failure into the daemon.
    """
    def _done(t: asyncio.Task) -> None:
        if t.cancelled():
            return
        try:
            exc = t.exception()
        except asyncio.CancelledError:       # pragma: no cover
            return
        if exc is None:
            return
        rep = build_report(daemon, exc, where=where)
        _RECENT.append(rep)
        log.dout(0, f"{daemon} task {where or '?'} crashed: "
                    f"{rep['exception']} (crash_id {rep['crash_id']})")
        if monc is None:
            return
        try:
            from ceph_tpu_torch.mon.messages import MCrashReport
            asyncio.ensure_future(monc.send_report(MCrashReport(
                daemon=rep["daemon"], crash_id=rep["crash_id"],
                exception=rep["exception"],
                traceback=rep["traceback"], stamp=rep["stamp"])))
        except Exception:
            pass                 # never cascade out of the hook

    task.add_done_callback(_done)
    return task
