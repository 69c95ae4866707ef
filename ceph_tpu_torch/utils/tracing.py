"""Distributed op tracing: Tracer/Span core + cross-daemon reassembly.

Analog of Ceph's tracing layer (ref: src/common/tracer.{h,cc}
— the Jaeger/blkin integration whose trace context rides MOSDOp so one
client op can be decomposed into queue / replica / store time across
daemons). A ``Span`` is one timed phase inside one daemon; spans of one
logical op share a ``trace_id`` and link through ``parent_span_id``, and
the context crosses message boundaries as two u64s appended to every
wire ``Message`` (zero = untraced).

Sampling model:

- **head-based**: ``trace_sampling_rate`` decides at the op's root
  (client side) whether the trace gets a nonzero trace_id and therefore
  propagates downstream;
- **tail-based retention for slow ops**: an UNSAMPLED root is still
  timed locally (one Span object, no propagation), and if its duration
  crosses ``trace_slow_keep_s`` it is assigned a trace id post-hoc and
  kept in the slow buffer — SLOW_OPS warnings stay drill-downable even
  at sampling 0. ``trace_slow_keep_s <= 0`` disables even this local
  timing (the truly-off path the bench pins).

Completed spans land in a bounded per-daemon buffer (asok
``dump_tracing``) and a bounded ship queue the daemon's existing
reporting loop drains monward (MPGStats / MDSBeacon piggyback,
MTraceReport for clients); the mon pools them and the mgr
TracingModule reassembles cross-daemon traces by trace_id
(``ceph trace ls`` / ``ceph trace show <trace_id>``).

The port's copy of ``ceph_tpu/utils/tracing.py``.
"""

from __future__ import annotations

import json
import random
import time
from collections import OrderedDict, deque
from typing import Any


def new_trace_id() -> int:
    """Nonzero 63-bit id (0 is the 'untraced' sentinel on the wire)."""
    return random.getrandbits(63) | 1


class Span:
    """One timed phase inside one daemon (ref: a jspan/blkin trace
    point pair). ``trace_id == 0`` marks a local-only root still
    awaiting the tail-retention decision."""

    __slots__ = ("tracer", "trace_id", "span_id", "parent_span_id",
                 "name", "service", "start", "_t0", "duration", "tags",
                 "finished")

    def __init__(self, tracer: "Tracer | None", name: str,
                 trace_id: int, parent_span_id: int = 0,
                 tags: dict | None = None):
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = new_trace_id()
        self.parent_span_id = parent_span_id
        self.name = name
        self.service = tracer.service if tracer is not None else ""
        self.start = time.time()          # wall: cross-daemon alignment
        self._t0 = time.monotonic()       # monotonic: durations
        self.duration: float | None = None
        self.tags: dict = dict(tags) if tags else {}
        self.finished = False

    def tag(self, key: str, value: Any) -> "Span":
        self.tags[key] = value
        return self

    def child(self, name: str, tags: dict | None = None) -> "Span":
        """A child span in the SAME daemon (same trace, linked)."""
        return Span(self.tracer, name, self.trace_id,
                    parent_span_id=self.span_id, tags=tags)

    def annotate(self, name: str, duration: float,
                 tags: dict | None = None) -> None:
        """Record an already-measured sub-phase as a FINISHED child
        span (the kv/WAL split: synchronous store code times its own
        phases and the caller attaches them post-hoc — a live child
        span would double-count the enclosing wall)."""
        s = self.child(name, tags=tags)
        s.finished = True
        s.duration = max(float(duration), 0.0)
        # start back-dated so the child nests inside this span's wall
        s.start = self.start
        if s.tracer is not None:
            s.tracer.record(s)

    def finish(self) -> None:
        if self.finished:
            return
        self.finished = True
        self.duration = time.monotonic() - self._t0
        if self.tracer is not None:
            self.tracer.record(self)

    def dump(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "name": self.name,
            "service": self.service,
            "start": self.start,
            "duration": round(
                self.duration if self.duration is not None
                else time.monotonic() - self._t0, 9),
            "tags": self.tags,
        }


class Tracer:
    """Per-daemon span factory + bounded completed-span buffers.

    Knobs are read LIVE from the daemon's config dict (falling back to
    the registered utils.config defaults), so `config set` style
    runtime changes apply to the next op."""

    def __init__(self, service: str, config: dict | None = None):
        self.service = service
        self.config = config if config is not None else {}
        self._buf: deque[dict] = deque(maxlen=self._buffer_size())
        # slow spans survive fast-op churn in their own bounded ring
        self._slow: deque[dict] = deque(maxlen=64)
        # pending shipment to the mon (piggybacked on the daemon's
        # existing report loop); bounded — observability must never
        # become the memory leak it exists to find
        self._shipq: deque[bytes] = deque(maxlen=1024)

    # -- knobs -------------------------------------------------------------
    def _get(self, name: str, default):
        if name in self.config:
            return self.config[name]
        try:
            from ceph_tpu_torch.utils.config import global_config
            return global_config().get(name)
        except Exception:
            return default

    def sampling_rate(self) -> float:
        return float(self._get("trace_sampling_rate", 0.0))

    def slow_keep_s(self) -> float:
        return float(self._get("trace_slow_keep_s", 30.0))

    def _buffer_size(self) -> int:
        return int(self._get("trace_buffer_size", 256))

    # -- span creation -----------------------------------------------------
    def start_root(self, name: str,
                   tags: dict | None = None) -> Span | None:
        """Root span for a NEW logical op. Head-sampled roots get a
        propagating trace id; unsampled roots are local-only (tail
        retention candidates); None when tracing is fully off
        (sampling 0 AND tail tracking disabled)."""
        rate = self.sampling_rate()
        if rate > 0.0 and random.random() < rate:
            return Span(self, name, new_trace_id(), tags=tags)
        if self.slow_keep_s() > 0.0:
            return Span(self, name, 0, tags=tags)
        return None

    def from_msg(self, name: str, msg,
                 tags: dict | None = None) -> Span | None:
        """Continue a propagated trace from an incoming message's
        appended context; None when the message is untraced."""
        tid = getattr(msg, "trace_id", 0)
        if not tid:
            return None
        return Span(self, name, tid,
                    parent_span_id=getattr(msg, "parent_span_id", 0),
                    tags=tags)

    # -- recording ---------------------------------------------------------
    def record(self, span: Span) -> None:
        slow = span.duration is not None and \
            0.0 < self.slow_keep_s() <= span.duration
        if span.trace_id == 0:
            if not slow:
                return                    # unsampled and fast: drop
            # tail retention: promote the local-only root so the mgr
            # can index it (children were never created — by design)
            span.trace_id = new_trace_id()
            span.tags["tail_sampled"] = True
        if slow:
            span.tags.setdefault("slow", True)
        d = span.dump()
        size = self._buffer_size()
        if size != self._buf.maxlen:      # knob changed at runtime
            self._buf = deque(self._buf, maxlen=size)
        self._buf.append(d)
        if slow:
            self._slow.append(d)
        self._shipq.append(json.dumps(d).encode())

    # -- surfaces ----------------------------------------------------------
    def drain_ship(self, max_n: int = 256) -> list[bytes]:
        """Spans awaiting shipment to the mon (destructive read)."""
        out = []
        while self._shipq and len(out) < max_n:
            out.append(self._shipq.popleft())
        return out

    def ship_pending(self) -> int:
        return len(self._shipq)

    def dump(self) -> dict:
        """The asok ``dump_tracing`` payload."""
        return {
            "service": self.service,
            "sampling_rate": self.sampling_rate(),
            "slow_keep_s": self.slow_keep_s(),
            "buffered": len(self._buf),
            "pending_ship": len(self._shipq),
            "spans": list(self._buf),
            "slow_spans": list(self._slow),
        }


class TraceIndex:
    """Cross-daemon trace reassembly by trace_id (the mgr
    TracingModule's — and the mon's `trace ls/show` — backing store).

    Bounded at ``max_traces`` complete trace groups; the oldest (by
    last span arrival) are evicted first."""

    # spans retained per trace: far above any real op tree (a
    # replicated write is ~10 spans), low enough that one hostile
    # trace_id cannot grow the index without bound
    MAX_SPANS_PER_TRACE = 256
    # tree depth served by show(): beyond it children are elided
    # rather than recursing toward Python's recursion limit
    MAX_TREE_DEPTH = 64

    def __init__(self, max_traces: int = 512):
        self.max_traces = max_traces
        # trace_id -> {"spans": {span_id: span-dict}, "stamp": wall}
        self.traces: "OrderedDict[int, dict]" = OrderedDict()

    def add(self, span: dict) -> None:
        # normalize BEFORE storing: span blobs arrive over the wire
        # from arbitrary clients (MTraceReport is an uncapped
        # fire-and-forget report), and one mistyped field must not
        # poison every later ls()/show() — malformed spans drop here
        try:
            tid = int(span.get("trace_id", 0))
            sid = int(span.get("span_id", 0))
            if not tid or not sid:
                return
            tags = span.get("tags")
            norm = {
                "trace_id": tid,
                "span_id": sid,
                "parent_span_id": int(span.get("parent_span_id", 0)),
                "name": str(span.get("name", "?")),
                "service": str(span.get("service", "?")),
                "start": float(span.get("start", 0.0)),
                "duration": float(span.get("duration", 0.0)),
                "tags": tags if isinstance(tags, dict) else {},
            }
        except (TypeError, ValueError):
            return
        ent = self.traces.get(tid)
        if ent is None:
            ent = self.traces[tid] = {"spans": {}, "stamp": 0.0}
        if sid not in ent["spans"] and \
                len(ent["spans"]) >= self.MAX_SPANS_PER_TRACE:
            return                    # one trace can't eat the index
        ent["spans"][sid] = norm
        ent["stamp"] = max(ent["stamp"], norm["start"])
        self.traces.move_to_end(tid)
        while len(self.traces) > self.max_traces:
            self.traces.popitem(last=False)

    # -- views -------------------------------------------------------------
    def _root(self, ent: dict) -> dict | None:
        spans = ent["spans"]
        ids = set(spans)
        roots = [s for s in spans.values()
                 if int(s.get("parent_span_id", 0)) not in ids]
        if not roots:
            return None
        # prefer the true root (no parent at all), else earliest start
        roots.sort(key=lambda s: (int(s.get("parent_span_id", 0)) != 0,
                                  s.get("start", 0.0)))
        return roots[0]

    def duration_of(self, tid: int) -> float:
        ent = self.traces.get(tid)
        if not ent:
            return 0.0
        root = self._root(ent)
        if root is not None and int(root.get("parent_span_id", 0)) == 0:
            return float(root.get("duration", 0.0))
        # partial trace: span envelope
        starts = [s["start"] for s in ent["spans"].values()]
        ends = [s["start"] + s.get("duration", 0.0)
                for s in ent["spans"].values()]
        return max(ends) - min(starts) if starts else 0.0

    def ls(self, limit: int = 20) -> list[dict]:
        """Slowest traces first (ref: the 'where did the latency go'
        entry point)."""
        rows = []
        for tid, ent in self.traces.items():
            root = self._root(ent)
            rows.append({
                "trace_id": tid,
                "root": root.get("name", "?") if root else "?",
                "service": root.get("service", "?") if root else "?",
                "duration": round(self.duration_of(tid), 6),
                "num_spans": len(ent["spans"]),
                "services": sorted({s.get("service", "?")
                                    for s in ent["spans"].values()}),
                "slow": any(s.get("tags", {}).get("slow")
                            for s in ent["spans"].values()),
            })
        rows.sort(key=lambda r: r["duration"], reverse=True)
        return rows[:limit]

    def show(self, tid: int) -> dict | None:
        """One reassembled trace: the span tree plus a per-phase
        latency breakdown (span name -> summed duration)."""
        ent = self.traces.get(tid)
        if ent is None:
            return None
        spans = ent["spans"]
        children: dict[int, list[int]] = {}
        for sid, s in spans.items():
            children.setdefault(
                int(s.get("parent_span_id", 0)), []).append(sid)
        root = self._root(ent)
        t0 = min(s["start"] for s in spans.values())

        def node(sid: int, depth: int = 0) -> dict:
            s = spans[sid]
            kids = sorted(children.get(sid, []),
                          key=lambda c: spans[c]["start"])
            return {
                "span_id": sid,
                "name": s.get("name"),
                "service": s.get("service"),
                "offset": round(s["start"] - t0, 6),
                "duration": round(s.get("duration", 0.0), 6),
                "tags": s.get("tags", {}),
                # depth-capped: a hostile parent chain must not drive
                # this recursion toward the interpreter limit
                "children": [node(c, depth + 1) for c in kids]
                if depth < self.MAX_TREE_DEPTH else ([{
                    "span_id": 0, "name": f"({len(kids)} elided)",
                    "service": "", "offset": 0.0, "duration": 0.0,
                    "tags": {}, "children": [],
                }] if kids else []),
            }

        phases: dict[str, float] = {}
        for s in spans.values():
            phases[s.get("name", "?")] = round(
                phases.get(s.get("name", "?"), 0.0) +
                s.get("duration", 0.0), 6)
        top = [sid for sid, s in spans.items()
               if int(s.get("parent_span_id", 0)) not in spans]
        return {
            "trace_id": tid,
            "duration": round(self.duration_of(tid), 6),
            "root": root.get("name") if root else None,
            "num_spans": len(spans),
            "phases": phases,
            "tree": [node(sid) for sid in sorted(
                top, key=lambda c: spans[c]["start"])],
        }
