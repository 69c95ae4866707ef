"""TrackedOp / OpTracker: per-op event timelines.

ref: src/common/TrackedOp.{h,cc} — every client op gets a tracked
record with timestamped lifecycle events; in-flight ops and a bounded
history are dumpable via the admin socket (``dump_ops_in_flight`` /
``dump_historic_ops``), and ops older than the warn threshold are
counted as slow (ref: OpTracker::check_ops_in_flight).

Ages and event offsets are measured on ``time.monotonic()`` — a
wall-clock jump (NTP step, suspend) must not age every in-flight op
into a SLOW_OPS storm or make durations run backwards. One wall-clock
``initiated_at`` stamp is kept for display only. Defaults for the
history depth and the complaint threshold come from the registered
``osd_op_history_size`` / ``osd_op_complaint_time`` config options.

The port's copy of ``ceph_tpu/utils/op_tracker.py``.
"""

from __future__ import annotations

import time
from collections import deque


def _opt_default(name: str, fallback):
    try:
        from ceph_tpu_torch.utils.config import global_config
        return global_config().get(name)
    except Exception:
        return fallback


class TrackedOp:
    def __init__(self, tracker: "OpTracker", desc: str):
        self._tracker = tracker
        self.desc = desc
        self.initiated_at = time.time()      # wall clock, display only
        self.start = time.monotonic()        # all durations hang off this
        self.events: list[tuple[float, str]] = [(self.start, "queued")]
        self.done = False

    def mark_event(self, name: str) -> None:
        self.events.append((time.monotonic(), name))

    def finish(self) -> None:
        if not self.done:
            self.done = True
            self.mark_event("done")
            self._tracker._finish(self)

    @property
    def duration(self) -> float:
        end = self.events[-1][0] if self.done else time.monotonic()
        return end - self.start

    def dump(self) -> dict:
        return {
            "description": self.desc,
            "initiated_at": self.initiated_at,
            "age": round(self.duration, 6),
            "events": [{"time": round(t - self.start, 6), "event": e}
                       for t, e in self.events],
        }


class OpTracker:
    """ref: OpTracker — per-daemon registry."""

    def __init__(self, history_size: int | None = None,
                 slow_op_warn_s: float | None = None):
        if history_size is None:
            history_size = int(_opt_default("osd_op_history_size", 20))
        if slow_op_warn_s is None:
            slow_op_warn_s = float(
                _opt_default("osd_op_complaint_time", 30.0))
        self.inflight: dict[int, TrackedOp] = {}
        self.history: deque[TrackedOp] = deque(maxlen=history_size)
        self.slow_op_warn_s = slow_op_warn_s
        self._seq = 0

    def create(self, desc: str) -> TrackedOp:
        self._seq += 1
        op = TrackedOp(self, desc)
        op._seq = self._seq
        self.inflight[self._seq] = op
        return op

    def _finish(self, op: TrackedOp) -> None:
        self.inflight.pop(getattr(op, "_seq", -1), None)
        self.history.append(op)

    def dump_ops_in_flight(self) -> dict:
        """ref: admin socket dump_ops_in_flight."""
        return {"num_ops": len(self.inflight),
                "ops": [op.dump() for op in self.inflight.values()]}

    def dump_historic_ops(self) -> dict:
        """ref: admin socket dump_historic_ops (slowest-last order)."""
        return {"num_ops": len(self.history),
                "ops": [op.dump() for op in self.history]}

    def slow_ops(self) -> list[TrackedOp]:
        return [op for op in self.inflight.values()
                if op.duration > self.slow_op_warn_s]

    def dump_slow_ops(self) -> dict:
        """ref: admin socket dump_slow_ops — the in-flight ops past
        the complaint threshold (what the SLOW_OPS health warning and
        the mon's slow-op count are built from)."""
        ops = sorted(self.slow_ops(), key=lambda o: o.start)
        return {"num_slow_ops": len(ops),
                "complaint_time": self.slow_op_warn_s,
                "ops": [op.dump() for op in ops]}
