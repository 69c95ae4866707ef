"""Op QoS scheduler: the dmClock-analog admission queue.

ref: src/osd/scheduler/mClockScheduler.{h,cc} + src/dmclock — the
reference's answer to "one hot tenant must not starve everyone else".
Every queue (a client/pool pair, the recovery class, the scrub class)
carries a QoS profile (reservation IOPS, weight, limit IOPS) and every
submitted op is stamped with three tags, exactly dmClock's algebra:

    R  = max(now, prev_R + cost / reservation)     (ρ tag)
    P  = max(now, prev_P + cost / weight)          (δ/proportion tag)
    L  = max(now, prev_L + cost / limit)

Dequeue is two-phase:

1. **reservation phase** — among queue heads whose R tag has come due
   (R <= now), serve the smallest R. Reservations are hard floors:
   they are paid first, whatever the weights say.
2. **weight phase** — otherwise, among heads whose L tag has come due
   (limit not exceeded), serve the smallest P tag. Weights split the
   *surplus* capacity proportionally.

A queue whose limit tag is in the future is ineligible until it comes
due, so `limit` is a hard ceiling even for an otherwise-idle cluster.
``max(now, ...)`` resets an idle queue's tags, so sleeping tenants
don't bank credit (the standard dmClock idle rule).

Three op classes ride the same instance (ref: mClock's op classes):

- ``client`` — one queue per (entity, pool); profile resolution:
  per-entity ``ceph osd client-profile`` > pool ``qos_*`` > the
  ``osd_qos_default_*`` knobs;
- ``recovery`` — the recovery throttle folded in: recovery pushes
  take a grant from THIS queue (``osd_qos_recovery_*``) instead of a
  side token bucket, so client-vs-recovery arbitration happens at one
  decision point (no starvation in either direction: recovery has a
  reservation, clients have theirs);
- ``scrub`` — background best-effort (weight-only, limited).

Scaling: queue heads live in two lazy heaps (by R and by P/L), so a
dequeue is O(log n_queues) — a 10k-session harness must not turn every
admission into an O(tenants) scan (the mClockScheduler uses the same
shape: per-class sub-queues + an eligibility heap).

``mode() == "fifo"`` (the ``osd_op_queue`` knob, read LIVE) disables
the tag algebra: one FIFO queue, exactly the pre-scheduler admission
loop — the baseline the QoS bench/tests compare against.

The port's copy of ``ceph_tpu/osd/scheduler.py``: host code only, it
touches no device.
"""

from __future__ import annotations

import asyncio
import heapq
from collections import deque
from dataclasses import dataclass

from ceph_tpu_torch.utils.logging import get_logger
from ceph_tpu_torch.utils.perf_counters import PerfCountersBuilder

log = get_logger("osd")

# process-wide counters (-> prometheus ceph_osd_qos_*, like osd_recovery's)
QOS_PERF = (
    PerfCountersBuilder("osd_qos")
    .add_u64_counter("dequeued_client", "client ops granted")
    .add_u64_counter("dequeued_recovery", "recovery grants issued")
    .add_u64_counter("dequeued_scrub", "scrub grants issued")
    .add_u64_counter("reservation_grants",
                     "grants issued in the reservation phase")
    .add_u64_counter("weight_grants",
                     "grants issued in the weight phase")
    .add_u64_counter("limit_waits",
                     "dequeue passes that found nothing due yet "
                     "(limit- or reservation-deferred heads) and "
                     "slept until the next tag horizon")
    .add_u64_counter("fifo_grants",
                     "grants issued with the scheduler in fifo mode")
    .create_perf_counters())

INF = float("inf")


def size_scaled_cost(config: dict, nbytes: int) -> float:
    """dmClock size-scaled cost (ref: the mclock
    cost-per-byte options): an op advances its queue's virtual time
    by ``max(1, bytes / osd_qos_cost_per_io_bytes)`` tag units
    instead of a flat 1. ONE definition — client admission
    (daemon._op_cost) and the recovery throttle charge through it,
    so the two paths can never silently diverge."""
    per_io = int(config.get("osd_qos_cost_per_io_bytes", 65536))
    return max(1.0, nbytes / max(per_io, 1))


@dataclass(frozen=True)
class QoSProfile:
    """One queue's dmClock parameters. ``reservation``/``limit`` are
    ops/s (0 = none/unlimited); ``weight`` is the proportional share
    (0 falls back to the default weight)."""

    reservation: float = 0.0
    weight: float = 1.0
    limit: float = 0.0

    def effective_weight(self) -> float:
        return self.weight if self.weight > 0 else 1.0


class _Queue:
    __slots__ = ("key", "op_class", "profile", "items",
                 "r_prev", "p_prev", "l_prev")

    def __init__(self, key, op_class: str, profile: QoSProfile):
        self.key = key
        self.op_class = op_class
        self.profile = profile
        # each entry: (r_tag, p_tag, l_tag, item, cost)
        self.items: deque = deque()

        self.r_prev = 0.0
        self.p_prev = 0.0
        self.l_prev = 0.0


class OpScheduler:
    """The admission scheduler. One per OSD daemon.

    ``submit(item, ...)`` stamps and enqueues; ``dequeue()`` awaits
    the next grant honoring reservation -> weight -> limit. The knobs
    (``osd_op_queue``, ``osd_qos_default_*``) are read LIVE from the
    daemon's config dict so a runtime flip to fifo applies to the next
    dequeue decision. ``now_fn`` is injectable for deterministic
    virtual-clock unit tests."""

    def __init__(self, config: dict | None = None, now_fn=None):
        self.config = config if config is not None else {}
        self._now = now_fn or (
            lambda: asyncio.get_event_loop().time())
        self.queues: dict[object, _Queue] = {}
        # lazy eligibility heaps over queue HEADS; entries go stale
        # when a head is dequeued — validated on pop. _rheap is
        # R-ordered (reservation phase); _pheap is P-ordered and holds
        # only heads whose LIMIT tag was already due when pushed;
        # limit-deferred heads park in the lim-ordered _lheap and
        # migrate to _pheap as they come due — so a dequeue touches
        # O(log tenants) entries, not every due head.
        self._rheap: list = []
        self._pheap: list = []
        self._lheap: list = []
        self._seq = 0
        self._fifo: deque = deque()
        self._event = asyncio.Event()
        self.queued = 0
        self.dequeued_total = 0
        # set by drain(): straggler grant() calls (a late recovery
        # retry firing after daemon stop) resolve immediately instead
        # of parking on a queue nothing drains anymore
        self.stopped = False

    # -- knobs (live) -----------------------------------------------------
    def _get(self, name: str, default):
        v = self.config.get(name)
        return default if v is None else v

    def mode(self) -> str:
        return str(self._get("osd_op_queue", "mclock"))

    def default_profile(self) -> QoSProfile:
        return QoSProfile(
            reservation=float(self._get("osd_qos_default_reservation",
                                        0.0)),
            weight=float(self._get("osd_qos_default_weight", 1.0)),
            limit=float(self._get("osd_qos_default_limit", 0.0)))

    def class_profile(self, op_class: str) -> QoSProfile:
        if op_class == "recovery":
            return QoSProfile(
                reservation=float(self._get(
                    "osd_qos_recovery_reservation", 10.0)),
                weight=float(self._get("osd_qos_recovery_weight", 1.0)),
                limit=float(self._get("osd_qos_recovery_limit", 0.0)))
        if op_class == "scrub":
            return QoSProfile(
                reservation=0.0,
                weight=float(self._get("osd_qos_scrub_weight", 0.5)),
                limit=float(self._get("osd_qos_scrub_limit", 10.0)))
        return self.default_profile()

    # -- submit -----------------------------------------------------------
    def submit(self, item, key=("client", "", 0),
               op_class: str = "client",
               profile: QoSProfile | None = None,
               cost: float = 1.0) -> None:
        """Stamp ``item`` with dmClock tags and enqueue it under
        ``key``. ``cost`` scales the tag increments (an op that is N
        times as expensive advances the queue's virtual time N times
        as far)."""
        if self.mode() == "fifo":
            self._fifo.append(item)
            self.queued += 1
            self._event.set()
            return
        q = self.queues.get(key)
        prof = profile or self.class_profile(op_class)
        if q is None:
            q = self.queues[key] = _Queue(key, op_class, prof)
        else:
            q.profile = prof          # live re-resolution (knob/CLI edits)
        now = self._now()
        cost = max(float(cost), 1e-9)
        r = max(now, q.r_prev + cost / prof.reservation) \
            if prof.reservation > 0 else INF
        p = max(now, q.p_prev + cost / prof.effective_weight())
        lim = max(now, q.l_prev + cost / prof.limit) \
            if prof.limit > 0 else now
        q.r_prev = r if r != INF else q.r_prev
        q.p_prev = p
        q.l_prev = lim
        q.items.append((r, p, lim, item, cost))
        if len(q.items) == 1:
            self._push_head(q)
        self.queued += 1
        self._event.set()

    def _push_head(self, q: _Queue, now: float | None = None) -> None:
        r, p, lim, _item, _c = q.items[0]
        self._seq += 1
        if r != INF:
            # reservation eligibility = max(R, L): the limit is a hard
            # ceiling over BOTH phases — a profile with reservation >
            # limit must be served at the limit rate, not the
            # reservation rate
            heapq.heappush(self._rheap, (max(r, lim), self._seq,
                                         q.key))
        if now is None:
            now = self._now()
        if lim <= now:
            heapq.heappush(self._pheap, (p, lim, self._seq, q.key))
        else:
            heapq.heappush(self._lheap, (lim, p, self._seq, q.key))

    # -- dequeue ----------------------------------------------------------
    def _head(self, key):
        q = self.queues.get(key)
        if q is None or not q.items:
            return None
        return q

    def try_dequeue(self, now: float | None = None):
        """One synchronous scheduling decision. Returns
        ``(item, op_class)`` or ``(None, wake_at)`` where ``wake_at``
        is the earliest time any head becomes eligible (None = queue
        empty). Split from the async loop for virtual-clock tests."""
        if self.mode() == "fifo":
            if self._fifo:
                self.queued -= 1
                self.dequeued_total += 1
                QOS_PERF.inc("fifo_grants")
                return self._fifo.popleft(), "client"
            # drain anything stamped before a live flip to fifo —
            # keeping each drained queue's heap entry fresh, so a flip
            # BACK to mclock mid-backlog leaves every head reachable
            for q in self.queues.values():
                if q.items:
                    _r, _p, _l, item, _c = q.items.popleft()
                    if q.items:
                        self._push_head(q)
                    self.queued -= 1
                    self.dequeued_total += 1
                    QOS_PERF.inc("fifo_grants")
                    return item, q.op_class
            return None, None
        if now is None:
            now = self._now()
        if self._fifo:
            # backlog stamped while the knob said fifo: serve it first
            # (arrival order) — a flip back to mclock must not strand
            # un-tagged ops in a queue the tag phases never read
            self.queued -= 1
            self.dequeued_total += 1
            QOS_PERF.inc("fifo_grants")
            return self._fifo.popleft(), "client"
        # phase 1: reservation — smallest due max(R, L) tag
        while self._rheap:
            rtag, _seq, key = self._rheap[0]
            if rtag > now:
                break
            heapq.heappop(self._rheap)
            q = self._head(key)
            if q is None or \
                    max(q.items[0][0], q.items[0][2]) != rtag:
                continue                      # stale entry
            return self._pop(q, "reservation", now)
        # migrate limit-deferred heads whose L tag came due into the
        # P-ordered ready heap (amortized: each head moves once)
        while self._lheap and self._lheap[0][0] <= now:
            lim, p, seq, key = heapq.heappop(self._lheap)
            q = self._head(key)
            if q is None or q.items[0][2] != lim or q.items[0][1] != p:
                continue                      # stale entry
            heapq.heappush(self._pheap, (p, lim, seq, key))
        # phase 2: weight — smallest P among limit-due heads
        while self._pheap:
            p, lim, seq, key = heapq.heappop(self._pheap)
            q = self._head(key)
            if q is None or q.items[0][2] != lim or q.items[0][1] != p:
                continue                      # stale entry
            return self._pop(q, "weight", now)
        # nothing eligible: compute the wake-up horizon
        wake = None
        if self._rheap:
            wake = self._rheap[0][0]
        if self._lheap:
            lim = self._lheap[0][0]
            wake = lim if wake is None else min(wake, lim)
        if wake is not None:
            QOS_PERF.inc("limit_waits")
        return None, wake

    def _pop(self, q: _Queue, phase: str, now: float | None = None):
        _r, _p, _l, item, _c = q.items.popleft()
        if q.items:
            self._push_head(q, now)
        elif not q.items and q.profile.reservation <= 0 and \
                q.profile.limit <= 0 and len(self.queues) > 4096:
            # bound idle default-profile queue state (10k+ sessions):
            # tags reset on next submit anyway via max(now, ...)
            self.queues.pop(q.key, None)
        self.queued -= 1
        self.dequeued_total += 1
        QOS_PERF.inc("reservation_grants" if phase == "reservation"
                     else "weight_grants")
        QOS_PERF.inc(f"dequeued_{q.op_class}"
                     if q.op_class in ("client", "recovery", "scrub")
                     else "dequeued_client")
        return item, q.op_class

    async def dequeue(self):
        """Await the next grant: ``(item, op_class)``."""
        while True:
            item, extra = self.try_dequeue()
            if item is not None:
                return item, extra
            self._event.clear()
            if extra is None:                 # empty: wait for submit
                await self._event.wait()
                continue
            delay = max(extra - self._now(), 0.0)
            if delay <= 0:
                continue
            try:                              # sleep until eligibility
                await asyncio.wait_for(self._event.wait(),
                                       timeout=min(delay, 1.0))
            except asyncio.TimeoutError:
                pass

    def pop_grant(self):
        """Pop one due recovery/scrub grant WITHOUT running the client
        phases — the admission loop calls this while it is parked on
        the client throttle for a dequeued op, so a saturated client
        cap can never stall recovery/scrub (grants don't consume
        throttle slots; the head-of-line inversion the folded-in
        design must not reintroduce). Honors the class's limit tag."""
        now = self._now()
        for key in (("recovery",), ("scrub",)):
            q = self.queues.get(key)
            if q is not None and q.items and q.items[0][2] <= now:
                return self._pop(q, "weight", now)[0]
        return None

    # -- grants (recovery / scrub ride the same decision point) -----------
    async def grant(self, op_class: str, key=None,
                    cost: float = 1.0) -> None:
        """Submit a grant token under ``op_class`` and wait until the
        admission loop dequeues it — how non-message work (recovery
        pushes, scrub rounds) takes its turn in the same tag algebra
        client ops use. In fifo mode (or with no admission loop
        draining us) the grant is immediate, matching the
        pre-scheduler behavior."""
        if self.mode() == "fifo" or self.stopped:
            return
        fut = asyncio.get_event_loop().create_future()
        self.submit(_Grant(fut), key=key or (op_class,),
                    op_class=op_class, cost=cost)
        await fut

    def drain(self, release=None) -> int:
        """Drop every queued item (daemon stop): returns the count.
        ``release(item)`` runs per dropped item so admission-throttle
        costs (and grant futures) don't leak with the queue."""
        self.stopped = True
        n = 0
        def _one(item):
            nonlocal n
            n += 1
            if isinstance(item, _Grant):
                if not item.fut.done():
                    item.fut.cancel()
            elif release is not None:
                release(item)
        while self._fifo:
            _one(self._fifo.popleft())
        for q in self.queues.values():
            while q.items:
                _one(q.items.popleft()[3])
        self.queued = 0
        self._rheap.clear()
        self._pheap.clear()
        self._lheap.clear()
        return n

    def backlog(self, key) -> int:
        """Queued depth of ONE queue (fifo mode: the global queue) —
        the per-tenant saturation check backing MOSDBackoff, O(1) so
        admission stays scan-free at 10k tenants."""
        if self.mode() == "fifo":
            return len(self._fifo)
        q = self.queues.get(key)
        return len(q.items) if q is not None else 0

    def dump(self) -> dict:
        return {
            "mode": self.mode(),
            "queued": self.queued,
            "dequeued_total": self.dequeued_total,
            "queues": {
                "/".join(str(x) for x in
                         (k if isinstance(k, tuple) else (k,))): {
                    "class": q.op_class,
                    "depth": len(q.items),
                    "reservation": q.profile.reservation,
                    "weight": q.profile.weight,
                    "limit": q.profile.limit,
                } for k, q in self.queues.items() if q.items},
        }


class _Grant:
    """A non-message scheduler token (recovery/scrub grant)."""

    __slots__ = ("fut",)

    def __init__(self, fut: asyncio.Future):
        self.fut = fut


class SchedulerThrottle:
    """the recovery throttle folded into the scheduler (the
    "scheduler class instead of a side throttle" move): ``acquire``
    first takes a grant from the scheduler's ``recovery`` queue — so
    recovery paces against client ops in one tag algebra — then the
    concurrency slot (``osd_recovery_max_active``) and, when a byte
    rate is configured, token-bucket budget. The acquire/release API
    (and ``dump``) is RecoveryThrottle's, so every PG call site is
    unchanged; with ``scheduler=None`` (or fifo mode) it degrades to
    exactly the old side throttle."""

    def __init__(self, scheduler: OpScheduler | None,
                 max_active: int = 8, bytes_per_s: int = 0,
                 config: dict | None = None):
        from ceph_tpu_torch.osd.recovery import RecoveryThrottle
        self.scheduler = scheduler
        # with a config dict, the knobs are read LIVE per acquire
        # (the tuner's recovery governor commits `config
        # set` and every in-flight backfill follows on its next push)
        self.config = config
        self._legacy = RecoveryThrottle(max_active=max_active,
                                        bytes_per_s=bytes_per_s)

    def _sync_knobs(self) -> None:
        if self.config is None:
            return
        self._legacy.set_limits(
            max_active=self.config.get("osd_recovery_max_active", 8),
            bytes_per_s=self.config.get("osd_recovery_max_bytes", 0))

    async def acquire(self, nbytes: int = 0):
        self._sync_knobs()
        if self.scheduler is not None:
            # size-scaled cost, same divisor the client
            # admission path charges: a 4 MiB recovery push pays its
            # bytes against the recovery reservation instead of
            # looking as cheap as a metadata-only push
            await self.scheduler.grant(
                "recovery",
                cost=size_scaled_cost(self.scheduler.config, nbytes))
        return await self._legacy.acquire(nbytes)

    def op(self, nbytes: int = 0):
        return _ThrottledOp(self, nbytes)

    @property
    def max_active(self) -> int:
        return self._legacy.max_active

    @property
    def throttled_ops(self) -> int:
        return self._legacy.throttled_ops

    def dump(self) -> dict:
        out = self._legacy.dump()
        if self.scheduler is not None:
            out["scheduler_mode"] = self.scheduler.mode()
        return out


class _ThrottledOp:
    def __init__(self, throttle: SchedulerThrottle, nbytes: int):
        self.throttle = throttle
        self.nbytes = nbytes
        self._release = None

    async def __aenter__(self):
        self._release = await self.throttle.acquire(self.nbytes)
        return self

    async def __aexit__(self, *exc):
        if self._release is not None:
            self._release()
