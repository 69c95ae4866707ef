"""Recovery reservations + QoS throttling.

ref: src/common/AsyncReserver.h (the slot table that caps concurrent
backfills per OSD, osd_max_backfills) and src/osd/scheduler/ (the
mClock analog this framework lacked — SURVEY §5.3): recovery pushes
must not starve foreground client I/O, so every push first takes a
slot from a small concurrency semaphore and, when a byte-rate is
configured, waits for tokens from a bucket refilled at
``osd_recovery_max_bytes`` per second. Client ops never touch either,
which is exactly the deprioritization: under contention recovery
queues behind its own throttle while client traffic flows.

Both objects live one-per-OSD-daemon (not per-PG): the caps are
per-OSD resources, like the reference's.

The port's copy of ``ceph_tpu/osd/recovery.py``, with two more counters
and ``RecoveryDeviceError``: an EC shard rebuild (``osd/ec_pg.py``) whose
device path failed on the card is counted (``push_device_failures`` for
a push, ``rebuild_device_failures`` for the local self-recovery and
position fix) and raised, never skipped or retried.
"""

from __future__ import annotations

import asyncio

from ceph_tpu_torch.utils.logging import get_logger
from ceph_tpu_torch.utils.perf_counters import PerfCountersBuilder

log = get_logger("osd")

# process-wide counters (exported via `perf dump` + prometheus like
# crush_mapper's); per-daemon introspection uses the objects' dump()s
PERF = (PerfCountersBuilder("osd_recovery")
        .add_u64_counter("reservations_granted",
                         "local+remote backfill reservations granted")
        .add_u64_counter("reservations_rejected",
                         "reservation requests rejected (slots full)")
        .add_u64_counter("reservations_toofull",
                         "remote reservations rejected for fullness")
        .add_u64_counter("backfill_objects_scanned",
                         "objects compared by backfill scans")
        .add_u64_counter("backfill_objects_pushed",
                         "objects pushed (or removed) by backfill")
        .add_u64_counter("backfills_started", "backfill runs started")
        .add_u64_counter("backfills_completed",
                         "backfill runs finished (all targets at MAX)")
        .add_u64_counter("throttle_waits",
                         "recovery ops that waited on the QoS throttle")
        .add_u64_counter("push_device_failures",
                         "EC pushes whose shard rebuild failed on the "
                         "card (raised, never skipped)")
        .add_u64_counter("rebuild_device_failures",
                         "EC local shard rebuilds (self-recovery, "
                         "position fix) that failed on the card "
                         "(raised, never retried)")
        .create_perf_counters())


class RecoveryDeviceError(RuntimeError):
    """An EC shard rebuild whose device path failed on the card. Peering
    and recovery let it propagate: a later round on the same card would
    not serve it, and no host path stands in for the card."""


class AsyncReserver:
    """Bounded named-slot table (ref: common/AsyncReserver.h).

    ``request(name)`` waits until one of ``max_slots`` slots is free
    and holds it under ``name`` until ``release(name)`` (idempotent);
    ``try_request(name)`` is the non-blocking form the REMOTE side
    uses (a reservation request message must answer GRANT/REJECT now,
    not park the connection). ``peak`` records the high-water mark so
    tests can assert the cap was never exceeded."""

    def __init__(self, max_slots: int = 1):
        self.max_slots = max(1, int(max_slots))
        self.granted: set[str] = set()
        self.peak = 0
        self._waiters: list[tuple[str, asyncio.Future]] = []

    def _grant(self, name: str) -> None:
        self.granted.add(name)
        self.peak = max(self.peak, len(self.granted))
        PERF.inc("reservations_granted")

    def try_request(self, name: str) -> bool:
        if name in self.granted:
            return True                   # re-request after a lost reply
        if len(self.granted) >= self.max_slots:
            PERF.inc("reservations_rejected")
            return False
        self._grant(name)
        return True

    async def request(self, name: str) -> None:
        if self.try_request(name):
            return
        fut = asyncio.get_event_loop().create_future()
        self._waiters.append((name, fut))
        await fut

    def release(self, name: str) -> None:
        self.granted.discard(name)
        while self._waiters and len(self.granted) < self.max_slots:
            wname, fut = self._waiters.pop(0)
            if fut.done():                # canceled waiter
                continue
            self._grant(wname)
            fut.set_result(True)

    def cancel(self, name: str) -> None:
        """Drop a grant AND any queued wait for ``name``."""
        self._waiters = [(n, f) for n, f in self._waiters if n != name]
        self.release(name)

    def dump(self) -> dict:
        return {"max_slots": self.max_slots,
                "granted": sorted(self.granted),
                "peak": self.peak,
                "waiting": [n for n, _ in self._waiters]}


class RecoveryThrottle:
    """Token-bucket + concurrency gate for recovery/backfill pushes.

    ``max_active`` (osd_recovery_max_active) bounds in-flight recovery
    ops; ``bytes_per_s`` (osd_recovery_max_bytes, 0 = unlimited) rate-
    limits push payload bytes with one-second burst capacity. Client
    ops bypass this object entirely, so a saturated bucket delays only
    recovery."""

    def __init__(self, max_active: int = 8, bytes_per_s: int = 0):
        self.max_active = max(1, int(max_active))
        self.bytes_per_s = max(0, int(bytes_per_s))
        self._sem = asyncio.Semaphore(self.max_active)
        self._debt = 0          # permits to absorb after a live shrink
        self._tokens = float(self.bytes_per_s)
        self._last_refill = None
        self.throttled_ops = 0
        self.throttled_bytes = 0

    def _refill(self, now: float) -> None:
        if self._last_refill is None:
            self._last_refill = now
        self._tokens = min(
            float(self.bytes_per_s),
            self._tokens + (now - self._last_refill) * self.bytes_per_s)
        self._last_refill = now

    def set_limits(self, max_active: int | None = None,
                   bytes_per_s: int | None = None) -> bool:
        """Retune LIVE (round 17: the mgr tuner's recovery governor
        commits `config set` and running OSDs must follow without a
        restart). Growing ``max_active`` releases the extra permits
        immediately; shrinking records a debt that in-flight releases
        absorb — already-granted pushes finish, new acquires see the
        tighter bound. Returns True when anything changed."""
        changed = False
        if max_active is not None:
            max_active = max(1, int(max_active))
            delta = max_active - self.max_active
            if delta:
                changed = True
                self.max_active = max_active
                if delta > 0:
                    take = min(delta, self._debt)
                    self._debt -= take
                    for _ in range(delta - take):
                        self._sem.release()
                else:
                    # absorb -delta permits as they come back
                    self._debt += -delta
        if bytes_per_s is not None:
            bytes_per_s = max(0, int(bytes_per_s))
            if bytes_per_s != self.bytes_per_s:
                changed = True
                self.bytes_per_s = bytes_per_s
                self._tokens = min(self._tokens, float(bytes_per_s))
        return changed

    def _release_slot(self) -> None:
        if self._debt > 0:
            self._debt -= 1
        else:
            self._sem.release()

    async def acquire(self, nbytes: int = 0):
        """Take one recovery slot (+ tokens for nbytes). Returns a
        zero-arg release callable; use ``async with throttle.op(n)``
        where structure allows."""
        loop = asyncio.get_event_loop()
        if self._sem.locked():
            self.throttled_ops += 1
            PERF.inc("throttle_waits")
        await self._sem.acquire()
        if self.bytes_per_s > 0 and nbytes > 0:
            waited = False
            while True:
                self._refill(loop.time())
                if self._tokens >= min(nbytes, self.bytes_per_s):
                    # a push larger than one second's budget drains
                    # the full bucket rather than stalling forever
                    self._tokens -= min(nbytes, self.bytes_per_s)
                    break
                if not waited:
                    waited = True
                    self.throttled_ops += 1
                    self.throttled_bytes += nbytes
                    PERF.inc("throttle_waits")
                need = min(nbytes, self.bytes_per_s) - self._tokens
                await asyncio.sleep(need / self.bytes_per_s)
        return self._release_slot

    def op(self, nbytes: int = 0) -> "_ThrottledOp":
        return _ThrottledOp(self, nbytes)

    def dump(self) -> dict:
        return {"max_active": self.max_active,
                "bytes_per_s": self.bytes_per_s,
                "active": self.max_active + self._debt -
                self._sem._value,
                "throttled_ops": self.throttled_ops,
                "throttled_bytes": self.throttled_bytes}


class _ThrottledOp:
    def __init__(self, throttle: RecoveryThrottle, nbytes: int):
        self.throttle = throttle
        self.nbytes = nbytes
        self._release = None

    async def __aenter__(self):
        self._release = await self.throttle.acquire(self.nbytes)
        return self

    async def __aexit__(self, *exc):
        if self._release is not None:
            self._release()
