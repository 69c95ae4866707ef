"""Objecter: the client-side op engine.

ref: src/osdc/Objecter.{h,cc} — computes each op's target from the
client's own OSDMap (object -> PG -> acting primary, the client-side
placement that is the whole point of CRUSH), tracks in-flight ops, and
resends when the map changes or the target replies EAGAIN/times out
(ref: Objecter::_calc_target + handle_osd_map resend logic).

Robustness layer (the Thrasher tier rides on it):

- every op is bounded by a configurable ``op_timeout`` and
  ``max_attempts``; resends back off exponentially, so a thrashed or
  partitioned target makes ops FAIL CLEANLY with -ETIMEDOUT instead
  of hanging or hot-looping;
- every op is a ``TrackedOp`` in ``self.op_tracker`` (ref:
  src/common/TrackedOp) with per-attempt events, dumpable as
  ``dump_ops_in_flight``/``dump_historic_ops``;
- ``wait_for_map_on_osds(epoch)`` is the **osdmap epoch barrier**:
  it probes OSDs with MOSDMapPing until each reports an observed
  epoch >= the target (ref: upstream eviction's barrier — the mon
  committing an epoch says nothing about which OSDs enforce it yet).
  CephFS eviction uses it so caps are only dropped after the OSDs
  that could serve a zombie's writes have seen the blocklist epoch.
"""

from __future__ import annotations

import asyncio
import json

import numpy as np

from ceph_tpu_torch.mon.client import MonClient
from ceph_tpu_torch.msg import Dispatcher, EntityAddr
from ceph_tpu_torch.msg.messenger import ConnectionError_
from ceph_tpu_torch.osd.messages import (
    BACKOFF_OP_ACK_BLOCK, BACKOFF_OP_BLOCK, BACKOFF_OP_UNBLOCK,
    MOSDBackoff, MOSDMapPing, MOSDMapPingReply, MOSDOpReply,
    MUTATING_OPS, OSD_FLAG_FULL_TRY, make_osd_op,
)
from ceph_tpu_torch.osd.osdmap import FLAG_FULL, FLAG_PAUSERD, FLAG_PAUSEWR
from ceph_tpu_torch.osd.types import ObjectLocator
from ceph_tpu_torch.utils.logging import get_logger
from ceph_tpu_torch.utils.op_tracker import OpTracker

log = get_logger("objecter")


class ObjectOperationError(Exception):
    def __init__(self, errno: int, msg: str = ""):
        super().__init__(f"errno {errno}: {msg}")
        self.errno = errno


class Objecter(Dispatcher):
    def __init__(self, monc: MonClient, op_timeout: float = 20.0,
                 max_attempts: int = 50,
                 slow_op_warn_s: float = 5.0,
                 config: dict | None = None):
        self.monc = monc
        self.msgr = monc.msgr
        self.msgr.add_dispatcher(self)
        # distributed tracing (ref: the Objecter starting the op's
        # root span in src/osdc/Objecter.cc under jaeger): the client
        # is where head-based sampling is decided — a sampled root's
        # context rides every MOSDOp hop of the op
        from ceph_tpu_torch.utils.tracing import Tracer
        self.tracer = Tracer("client", config)
        self._trace_flush_at = 0.0
        self._trace_flush_later: object | None = None
        # default per-op deadline and resend cap (ref: objecter's
        # rados_osd_op_timeout): thrashed ops fail cleanly, not hang
        self.op_timeout = op_timeout
        self.max_attempts = max_attempts
        self.op_tracker = OpTracker(slow_op_warn_s=slow_op_warn_s)
        self._tid = 0
        # keyed on (tid, attempt): the tid is the LOGICAL op id (stable
        # across resends for OSD-side dedup), but a late reply from a
        # timed-out earlier attempt must not resolve a newer attempt's
        # waiter — for reads that would surface a result captured before
        # the retry's map refresh (ref: Objecter op->attempts /
        # MOSDOp::get_retry_attempt).
        self._waiters: dict[tuple[int, int], asyncio.Future] = {}
        # epoch-barrier probes keyed by tid
        self._map_ping_waiters: dict[int, asyncio.Future] = {}
        # server-asserted backoffs (ref: Objecter::OSDSession backoffs):
        # (pool, pg seed) -> id -> [begin, end, primary, event, t0].
        # Ops whose oid falls in a recorded range park on the event
        # until the OSD's UNBLOCK (or the self-heal window expires —
        # a died OSD can't unblock anyone).
        self._backoffs: dict[tuple[int, int], dict[int, list]] = {}
        # in-flight attempt -> (pool, seed, oid): a BLOCK covering an
        # op whose send is awaiting its reply resolves that attempt
        # IMMEDIATELY (the OSD dropped the op — waiting out the reply
        # timeout would stall the resend by seconds)
        self._inflight: dict[tuple[int, int], tuple[int, int, str]] = {}
        # seconds a backoff may park ops with no UNBLOCK before the
        # client drops it and retries (lost-UNBLOCK/dead-OSD self-heal;
        # a still-inactive PG simply re-asserts it)
        self.backoff_stall_s = 3.0

    async def ms_dispatch(self, msg) -> bool:
        if isinstance(msg, MOSDOpReply):
            fut = self._waiters.pop(
                (msg.tid, getattr(msg, "attempt", 0)), None)
            if fut and not fut.done():
                fut.set_result(msg)
            return True
        if isinstance(msg, MOSDMapPingReply):
            fut = self._map_ping_waiters.pop(msg.tid, None)
            if fut and not fut.done():
                fut.set_result(msg.epoch)
            return True
        if isinstance(msg, MOSDBackoff):
            await self._handle_backoff(msg)
            return True
        return False

    async def _handle_backoff(self, m: MOSDBackoff) -> None:
        """ref: Objecter::handle_osd_backoff — record BLOCKs (and ack
        them), release parked ops on UNBLOCK."""
        key = (m.pool, m.seed)
        if m.op == BACKOFF_OP_BLOCK:
            loop = asyncio.get_event_loop()
            self._backoffs.setdefault(key, {})[m.id] = [
                m.begin, m.end, m.from_osd, asyncio.Event(),
                loop.time()]
            # the blocked op was DROPPED server-side: wake its waiter
            # now so it re-enters the loop and parks, instead of
            # burning the whole per-attempt reply timeout first
            for wkey, (p, s, o) in list(self._inflight.items()):
                if p == m.pool and s == m.seed and m.begin <= o and \
                        (not m.end or o < m.end):
                    fut = self._waiters.pop(wkey, None)
                    if fut and not fut.done():
                        fut.set_result(None)
            try:
                await m.conn.send_message(MOSDBackoff(
                    op=BACKOFF_OP_ACK_BLOCK, id=m.id, pool=m.pool,
                    seed=m.seed, begin=m.begin, end=m.end,
                    epoch=m.epoch, from_osd=m.from_osd))
            except Exception:
                pass
        elif m.op == BACKOFF_OP_UNBLOCK:
            ent = self._backoffs.get(key, {}).pop(m.id, None)
            if ent is not None:
                ent[3].set()
            if not self._backoffs.get(key):
                self._backoffs.pop(key, None)

    def _match_backoff(self, pool_id: int, seed: int,
                       oid: str) -> list | None:
        """The recorded backoff covering (pool, seed, oid), if any."""
        for ent in self._backoffs.get((pool_id, seed), {}).values():
            begin, end = ent[0], ent[1]
            if begin <= oid and (not end or oid < end):
                return ent
        return None

    def _flag_gate(self, osdmap, pool_id: int,
                   has_write: bool) -> tuple[str, int] | None:
        """Why this op must not be sent right now, or None (ref:
        Objecter::target_should_be_paused + op_submit's ENOSPC
        check). Returns (reason, errno) — errno 0 means 'park
        unconditionally' (pause flags), nonzero means FULL_TRY ops
        fail fast with it instead of parking."""
        if not has_write and osdmap.test_flag(FLAG_PAUSERD):
            return "pauserd", 0
        if has_write and osdmap.test_flag(FLAG_PAUSEWR):
            return "pausewr", 0
        if has_write and osdmap.test_flag(FLAG_FULL):
            return "cluster full", -28                  # -ENOSPC
        pool = osdmap.pools.get(pool_id)
        if has_write and pool is not None and pool.is_full():
            return f"pool '{pool.name}' full", -122     # -EDQUOT
        return None

    async def _wait_for_new_map(self, cur, deadline: float) -> None:
        """Park until the map moves past ``cur`` (the wait-queue the
        pause/full gates put ops on; the incremental clearing the flag
        resumes them) — bounded so the op deadline still rules."""
        loop = asyncio.get_event_loop()
        try:
            await self.monc.subscribe("osdmap", cur.epoch + 1)
            await self.monc.wait_for_osdmap(
                min_epoch=cur.epoch + 1,
                timeout=max(0.05, min(1.0,
                                      deadline - loop.time())))
        except TimeoutError:
            pass

    def _calc_target(self, osdmap, pool_id: int, oid: str):
        """ref: Objecter::_calc_target."""
        pool = osdmap.pools[pool_id]
        raw_pg = osdmap.object_locator_to_pg(
            oid, ObjectLocator(pool=pool_id))
        seed = int(pool.raw_pg_to_pg(np.asarray([raw_pg.seed]),
                                     xp=np)[0])
        # epoch-keyed cache: steady-state op targeting never re-enters
        # the mapper (see OSDMap.pg_to_acting_primary)
        _, actp = osdmap.pg_to_acting_primary(pool_id, seed)
        return seed, actp

    async def pool_id(self, name: str) -> int:
        osdmap = await self.monc.wait_for_osdmap()
        for p in osdmap.pools.values():
            if p.name == name:
                return p.id
        raise ObjectOperationError(-2, f"no pool {name!r}")

    async def op_submit(self, pool_id: int, oid: str, ops: list[tuple],
                        timeout: float | None = None,
                        seed: int | None = None,
                        snapc: tuple | None = None, snap_id: int = 0,
                        flags: int = 0):
        """Send one op bundle; retries across map changes with
        exponential backoff, bounded by ``timeout`` (None = the
        objecter's op_timeout) and ``max_attempts``.
        ``seed`` overrides name hashing for PG-targeted ops (pgls).
        ``snapc``/``snap_id``: self-managed snap write context / read
        snap (ref: Objecter::Op snapc+snapid).
        ``flags``: MOSDOp flags — OSD_FLAG_FULL_TRY makes writes
        blocked by a FULL cluster / full pool fail fast (-ENOSPC /
        -EDQUOT) instead of parking on the flag wait-queue.
        Returns (result, data, extra_dict)."""
        if timeout is None:
            timeout = self.op_timeout
        loop = asyncio.get_event_loop()
        deadline = loop.time() + timeout
        # One tid for the whole logical op: resends must carry the SAME
        # reqid so the PG's dedup (pg.py _reqid_results) recognizes a
        # retry of an already-applied op instead of re-executing it
        # (ref: Objecter keeps op->tid across resends; osd_reqid_t).
        self._tid += 1
        tid = self._tid
        tracked = self.op_tracker.create(
            f"osd_op(client tid {tid} pool {pool_id} {oid!r} "
            f"{len(ops)} ops)")
        has_write = any(o[0] in MUTATING_OPS for o in ops)
        span = self.tracer.start_root(
            "client_op",
            tags={"oid": oid, "pool": pool_id, "tid": tid,
                  "op_class": "write" if has_write else "read"})
        try:
            return await self._op_submit_inner(
                pool_id, oid, ops, deadline, tid, seed, snapc,
                snap_id, tracked, flags, span, has_write)
        finally:
            tracked.finish()
            if span is not None:
                span.finish()
            self.flush_traces()

    def flush_traces(self, force: bool = False) -> None:
        """Ship buffered spans monward via MTraceReport — the client's
        stand-in for the stats/beacon piggyback (fire-and-forget,
        rate-limited)."""
        if not self.tracer.ship_pending():
            return
        loop = asyncio.get_event_loop()
        if not force and loop.time() - self._trace_flush_at < 0.25:
            # rate-limited: arm ONE trailing flush so the last spans
            # of a burst still ship (an idle client never flushes
            # otherwise)
            self._arm_trailing_flush(loop)
            return
        self._trace_flush_at = loop.time()
        from ceph_tpu_torch.mon.messages import MTraceReport
        blobs = self.tracer.drain_ship()
        asyncio.ensure_future(self.monc.send_report(
            MTraceReport(daemon=self.monc.name, spans=blobs)))
        if self.tracer.ship_pending():
            # a burst bigger than one drain batch: re-arm so the
            # remainder ships even if the client goes idle
            self._arm_trailing_flush(loop)

    def _arm_trailing_flush(self, loop) -> None:
        if self._trace_flush_later is not None:
            return
        def _later():
            self._trace_flush_later = None
            self.flush_traces(force=True)
        self._trace_flush_later = loop.call_later(0.3, _later)

    async def _op_submit_inner(self, pool_id, oid, ops, deadline, tid,
                               seed, snapc, snap_id, tracked,
                               flags=0, span=None, has_write=None):
        loop = asyncio.get_event_loop()
        attempt = 0
        if has_write is None:
            has_write = any(o[0] in MUTATING_OPS for o in ops)
        while True:
            if loop.time() > deadline:
                tracked.mark_event("timed out")
                raise ObjectOperationError(-110, f"op on {oid} timed out")
            if attempt >= self.max_attempts:
                tracked.mark_event("retries exhausted")
                raise ObjectOperationError(
                    -110, f"op on {oid} failed after {attempt} attempts")
            osdmap = await self.monc.wait_for_osdmap()
            gate = self._flag_gate(osdmap, pool_id, has_write)
            if gate is not None:
                reason, errno = gate
                if errno and (flags & OSD_FLAG_FULL_TRY):
                    tracked.mark_event(f"failing fast: {reason}")
                    raise ObjectOperationError(
                        errno, f"{reason} (FULL_TRY)")
                # park on the wait-queue: the incremental that clears
                # the flag (or raises the quota) resumes the op
                tracked.mark_event(f"parked ({reason})")
                await self._wait_for_new_map(osdmap, deadline)
                continue
            if seed is not None:
                _, actp = osdmap.pg_to_acting_primary(pool_id, seed)
                pg_seed, primary = seed, actp
            else:
                pg_seed, primary = self._calc_target(osdmap, pool_id,
                                                     oid)
            if primary < 0 or primary not in osdmap.osd_addrs:
                tracked.mark_event("no primary; waiting for map")
                await self._refresh_map(osdmap)
                continue
            backoff = self._match_backoff(pool_id, pg_seed, oid)
            if backoff is not None:
                # server-asserted flow control: park until the OSD
                # UNBLOCKs, the backing-off primary changes, or the
                # self-heal window expires (UNBLOCK lost / OSD died)
                tracked.mark_event(
                    f"parked (backoff from osd.{backoff[2]})")
                await self._wait_backoff(backoff, pool_id, pg_seed,
                                         primary, deadline)
                continue
            host, port, _hb = osdmap.osd_addrs[primary]
            fut = loop.create_future()
            self._waiters[(tid, attempt)] = fut
            self._inflight[(tid, attempt)] = (pool_id, pg_seed, oid)
            try:
                tracked.mark_event(
                    f"sent to osd.{primary} (attempt {attempt})")
                op_msg = make_osd_op(tid, osdmap.epoch, pool_id,
                                     pg_seed, oid, ops,
                                     attempt=attempt, snapc=snapc,
                                     snap_id=snap_id, flags=flags)
                op_msg.set_trace(span)
                await self.msgr.send_message(
                    op_msg, EntityAddr(host, port), f"osd.{primary}")
                reply = await asyncio.wait_for(
                    fut, timeout=min(5.0 + attempt,
                                     deadline - loop.time()))
            except (asyncio.TimeoutError, ConnectionError, OSError,
                    ConnectionError_):
                self._waiters.pop((tid, attempt), None)
                attempt += 1
                tracked.mark_event("attempt failed; backing off")
                await self._refresh_map(osdmap)
                await asyncio.sleep(
                    min(0.05 * (1 << min(attempt, 5)), 1.0))
                continue
            finally:
                self._inflight.pop((tid, attempt), None)
            if reply is None:
                # dropped server-side with a BLOCK: re-enter the loop
                # — the backoff match at the top parks the op (same
                # attempt: nothing executed)
                tracked.mark_event("backed off mid-flight")
                continue
            if reply.result == -11:       # wrong target / not active
                attempt += 1
                tracked.mark_event("EAGAIN (stale target)")
                await self._refresh_map(osdmap)
                await asyncio.sleep(min(0.1 * attempt, 1.0))
                continue
            if reply.result == -28 and has_write and \
                    not (flags & OSD_FLAG_FULL_TRY):
                # OSD failsafe rejection: the cluster is fuller than
                # our map admits (the op was NOT applied). Wait for
                # the map to catch up — the next pass parks on the
                # FULL flag, exactly as if we had never been stale.
                attempt += 1
                tracked.mark_event("ENOSPC from failsafe; map stale")
                await self._wait_for_new_map(osdmap, deadline)
                continue
            tracked.mark_event("reply received")
            extra = json.loads(reply.extra) if reply.extra else {}
            return reply.result, reply.data, extra

    async def _wait_backoff(self, ent: list, pool_id: int, seed: int,
                            primary: int, deadline: float) -> None:
        """Park on one backoff's release event in short slices,
        dropping the backoff when its asserting primary changed (the
        interval ended — a new primary owes us no UNBLOCK) or it
        stalled past ``backoff_stall_s``."""
        loop = asyncio.get_event_loop()
        while loop.time() < deadline:
            try:
                await asyncio.wait_for(
                    ent[3].wait(),
                    timeout=max(0.02, min(0.25,
                                          deadline - loop.time())))
                return
            except asyncio.TimeoutError:
                pass
            if ent[2] != primary or \
                    loop.time() - ent[4] > self.backoff_stall_s:
                bos = self._backoffs.get((pool_id, seed), {})
                for bid, e in list(bos.items()):
                    if e is ent:
                        bos.pop(bid, None)
                ent[3].set()
                return
            # freshen our view: a moved primary ends the backoff
            cur = self.monc.osdmap
            if cur is not None:
                try:
                    _, actp = cur.pg_to_acting_primary(pool_id, seed)
                    if actp != primary:
                        return
                except KeyError:
                    return                  # pool vanished

    # -- osdmap epoch barrier ----------------------------------------------
    async def wait_for_map_on_osds(self, epoch: int,
                                   osds: list[int] | None = None,
                                   timeout: float = 15.0) -> None:
        """Block until every targeted OSD reports an observed osdmap
        epoch >= ``epoch`` (ref: upstream eviction's epoch barrier /
        Objecter::wait_for_map — but against the OSDs' own view, which
        is the one that enforces blocklists). ``osds`` defaults to
        every up OSD in the client's current map; down OSDs are
        skipped (they re-fetch maps on boot before serving ops).
        Raises ObjectOperationError(-110) if the barrier can't be
        proven within ``timeout``."""
        loop = asyncio.get_event_loop()
        deadline = loop.time() + timeout
        try:
            # the probe set must come from a map that already CONTAINS
            # the target epoch's view: deriving it from an older map
            # would silently skip an OSD that booted between our map
            # and the target epoch — the exact stale-enforcer the
            # barrier exists to catch. (An OSD booting later still
            # observes >= its own boot epoch > ours before serving.)
            osdmap = await self.monc.wait_for_osdmap(
                min_epoch=epoch if osds is None else 1,
                timeout=max(0.1, deadline - loop.time()))
        except TimeoutError as e:
            raise ObjectOperationError(
                -110, f"epoch barrier {epoch}: client map never "
                      f"reached it ({e})") from e
        if osds is None:
            osds = [o for o in range(osdmap.max_osd)
                    if bool(osdmap.is_up(np.asarray(o)))
                    and o in osdmap.osd_addrs]
        pending = set(osds)
        tracked = self.op_tracker.create(
            f"osdmap_barrier(epoch {epoch} osds {sorted(pending)})")
        try:
            while pending:
                if loop.time() > deadline:
                    tracked.mark_event("timed out")
                    raise ObjectOperationError(
                        -110, f"epoch barrier {epoch} not observed by "
                              f"osds {sorted(pending)}")
                order = sorted(pending)
                # concurrent probes: unreachable OSDs must not burn
                # the budget serially in front of reachable ones
                got_all = await asyncio.gather(
                    *[self._probe_osd_epoch(o, deadline, osdmap)
                      for o in order])
                for o, got in zip(order, got_all):
                    if got is not None and got >= epoch:
                        pending.discard(o)
                        tracked.mark_event(f"osd.{o} at {got}")
                if pending:
                    # an unreached/stale OSD may just need the next
                    # map publish; also refresh our own view so a
                    # now-down OSD drops out of the barrier set
                    await asyncio.sleep(0.1)
                    osdmap = await self.monc.wait_for_osdmap()
                    pending = {
                        o for o in pending
                        if o < osdmap.max_osd and
                        bool(osdmap.is_up(np.asarray(o))) and
                        o in osdmap.osd_addrs}
            tracked.mark_event("barrier reached")
        finally:
            tracked.finish()

    async def _probe_osd_epoch(self, osd: int, deadline: float,
                               osdmap) -> int | None:
        """One MOSDMapPing round-trip; None on timeout/conn failure."""
        loop = asyncio.get_event_loop()
        ent = osdmap.osd_addrs.get(osd)
        if ent is None:
            return None
        self._tid += 1
        tid = self._tid
        fut = loop.create_future()
        self._map_ping_waiters[tid] = fut
        try:
            await self.msgr.send_message(
                MOSDMapPing(tid=tid, epoch=0),
                EntityAddr(ent[0], ent[1]), f"osd.{osd}")
            return await asyncio.wait_for(
                fut, timeout=max(0.05, min(1.0, deadline - loop.time())))
        except (asyncio.TimeoutError, ConnectionError, OSError,
                ConnectionError_):
            return None
        finally:
            self._map_ping_waiters.pop(tid, None)

    async def _refresh_map(self, cur) -> None:
        await self.monc.subscribe(
            "osdmap", cur.epoch + 1 if cur else 0)
        await asyncio.sleep(0.1)
