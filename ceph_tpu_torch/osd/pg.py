"""PG: per-placement-group replicated state machine.

ref: src/osd/PG.cc + PeeringState.{h,cc} + PrimaryLogPG.cc — one PG
owns one ObjectStore collection and an ordered op pipeline. The
reference's boost::statechart phases map to:

- ``advance_map``: new acting set from the OSDMap ends the current
  interval (ref: PeeringState::advance_map / start_peering_interval);
- ``peering`` (primary): query every acting peer's info+log, adopt the
  authoritative log (max last_update — ref: find_best_info), merge to
  produce per-peer missing sets (ref: GetMissing), pull what the
  primary itself lacks, then activate;
- ``active``: client ops execute (PrimaryLogPG::execute_ctx):
  writes get an eversion, a pg-log entry, and an ObjectStore
  transaction replicated to acting peers as MOSDRepOp, acked to the
  client when every live acting replica commits
  (ref: ReplicatedBackend::submit_transaction);
- ``recovery``: missing objects are pushed whole at their
  authoritative version (ref: PGBackend::run_recovery_op); when no
  peer is missing anything the PG is clean.

The pg log + per-object versions persist in the collection's
``_pgmeta_`` object (ref: pgmeta_oid omap), so a restarted OSD
re-peers from durable state.

The port's copy of ``ceph_tpu/osd/pg.py``. Peering does not retry a
``RecoveryDeviceError``: an EC rebuild that failed on the card.
"""

from __future__ import annotations

import asyncio
import json

from ceph_tpu_torch.msg.messenger import ConnectionError_
from ceph_tpu_torch.os_.objectstore import StoreError, Transaction
from ceph_tpu_torch.osd.messages import (
    BACKFILL_OP_FINISH, BACKFILL_OP_PROGRESS, BACKFILL_OP_RESET,
    MBackfillReserve, MOSDOp, MOSDOpReply, MOSDPGBackfill,
    MOSDPGBackfillReply, MOSDPGInfo, MOSDPGPull, MOSDPGPush,
    MOSDPGPushReply, MOSDPGQuery, MOSDPGScan, MOSDPGScanReply,
    MOSDRepOp, MOSDRepOpReply, MUTATING_OPS,
    MWatchNotify, OSD_OP_DELETE,
    OSD_OP_GETXATTR, OSD_OP_NOTIFY, OSD_OP_NOTIFY_ACK, OSD_OP_OMAP_GET,
    OSD_OP_OMAP_SET, OSD_OP_PGLS,
    OSD_OP_OMAP_RM, OSD_OP_READ, OSD_OP_SETXATTR, OSD_OP_SNAPTRIM,
    OSD_OP_STAT,
    OSD_OP_TRUNCATE, OSD_OP_UNWATCH, OSD_OP_WATCH, OSD_OP_WRITE,
    OSD_OP_WRITEFULL, OSD_OP_ZERO,
    RESERVE_GRANT, RESERVE_REJECT, RESERVE_RELEASE, RESERVE_REQUEST,
    RESERVE_TOOFULL,
)
from ceph_tpu_torch.osd.pg_log import OP_DELETE, OP_MODIFY, LogEntry, PGLog, \
    eversion
from ceph_tpu_torch.osd.recovery import PERF as RECOVERY_PERF
from ceph_tpu_torch.osd.recovery import RecoveryDeviceError
from ceph_tpu_torch.osd.types import MAX_OID, MIN_OID, pg_t
from ceph_tpu_torch.utils.logging import get_logger


def _finish_store_span(span, store) -> None:
    """Close an objectstore_commit span, attaching the store's
    per-phase sub-spans (the kv/WAL split: WALStore reports
    apply/wal_kv_commit, BlueStore block_write/kv_commit/
    deferred_write) recorded during the synchronous commit."""
    if span is None:
        return
    for phase, dt in getattr(store, "last_txn_phases", {}).items():
        span.annotate(phase, dt)
    span.finish()

log = get_logger("osd")

PGMETA = "_pgmeta_"

# snapshot clone objects live beside their head in the same PG under a
# reserved prefix (ref: the SnapSet clone list; upstream names clones
# hobject(oid, snapid) — here the snapid rides in the name)
CLONE_PREFIX = "_snapclone."


def clone_name(oid: str, clone_id: int) -> str:
    return f"{CLONE_PREFIX}{clone_id}.{oid}"


def clone_head(name: str) -> str | None:
    """The head oid a clone object belongs to, or None for non-clones."""
    if not name.startswith(CLONE_PREFIX):
        return None
    rest = name[len(CLONE_PREFIX):]
    parts = rest.split(".", 1)
    return parts[1] if len(parts) == 2 else None


class PG:
    def __init__(self, osd, pool, pgid: pg_t):
        self.osd = osd                    # OSD daemon (service facade)
        self.pool = pool
        self.pgid = pgid
        self.cid = str(pgid)
        self.pg_log = PGLog()
        self.state = "initial"
        self.epoch = 0                    # interval epoch
        self.acting: list[int] = []
        self.up: list[int] = []
        self.primary = -1
        self.last_user_version = 0
        # PastIntervals (ref: osd_types PastIntervals + PeeringState::
        # build_prior): every acting set this PG has had since it was
        # last clean, [[first_epoch, last_epoch, [acting...]], ...].
        # Peering must hear from at least one member of EACH past
        # interval before activating — the current acting set's logs
        # alone cannot prove no other interval acknowledged writes
        # (e.g. acting flipped A->B->A: B took writes while A was out).
        # Persisted in the pg meta object; trimmed at last_epoch_clean.
        self.past_intervals: list[list] = []
        self.interval_start = 0           # epoch current acting set began
        self.last_epoch_clean = 0
        # backfill (ref: pg_info_t.last_backfill + PeeringState's
        # backfill machinery). ``last_backfill`` is THIS instance's
        # persisted watermark: the store holds every object <= it (in
        # sorted-name order); MAX_OID = complete. ``backfill_targets``
        # is primary-side state: acting peers whose logs are NOT
        # continuous with the authoritative log (or who reported an
        # incomplete watermark) -> their current watermark; log-delta
        # recovery cannot serve them, the scan/push machinery must.
        self.last_backfill = MAX_OID
        # the authoritative head last_backfill was last valid AT (ref:
        # the role of pg_info_t.last_update for backfill peers):
        # resuming from the watermark after a rejoin is only sound if
        # the authoritative log is still continuous with this point —
        # then every sub-watermark change since is derivable from the
        # retained log; otherwise the scan must restart from MIN.
        self.backfill_at = eversion()
        self.backfill_targets: dict[int, str] = {}
        self.peer_last_backfill: dict[int, str] = {}
        self.peer_backfill_at: dict[int, eversion] = {}
        # last_epoch_started (ref: pg_info_t.last_epoch_started): the
        # interval_start of the newest interval this OSD saw ACTIVATE
        # for this PG — recorded by the primary when peering completes
        # and pushed to acting replicas (MOSDPGInfo activate=1), so
        # every survivor of an interval can out-elect a revived
        # pre-failover primary's divergent log (find_best_info orders
        # by (les, head), not head alone). Persisted with the pg meta.
        self.last_epoch_started = 0
        self.peer_les: dict[int, int] = {}
        self._backfill_task: asyncio.Task | None = None
        # the (wm, end] name range a backfill scan is comparing RIGHT
        # NOW: mutations inside it park with -EAGAIN so a write — or a
        # brand-new object, invisible to the batch snapshot — cannot
        # slip between the scan's version read and the watermark
        # advance (the reference blocks ops on objects being
        # backfilled). None = no scan in flight.
        self._backfill_inflight: tuple[str, str] | None = None
        self._backfill_waiters: dict[int, asyncio.Future] = {}
        # reservation nonces: the tid under which the target granted
        # its remote slot (target side) / each target granted ours
        # (primary side). A RELEASE only frees the grant whose tid it
        # carries — the fault layer duplicates messages by design, and
        # a duplicated release must not free a RE-acquired grant.
        self._remote_grant_tid = 0
        self._reserve_tids: dict[int, int] = {}
        self.backfill_stats = {"scanned": 0, "pushed": 0,
                               "removed": 0, "resumed_from": ""}
        # per-client op counts (round 17): the mgr tuner's hot-pool
        # protector reads these off `pg dump` and diffs across ticks
        # to rank pools/entities by live op rate — no wire change, the
        # counts ride the MPGStats stats blob like backfill progress.
        # Primary-only and reset with the PG object (a new primary
        # restarts at zero; the tuner diffs, so baselines self-heal).
        self.client_ops: dict[str, int] = {}
        # peering scratch
        self.peer_logs: dict[int, PGLog] = {}
        self.peer_missing: dict[int, dict[str, LogEntry]] = {}
        self.my_missing: dict[str, LogEntry] = {}
        self._peering_task: asyncio.Task | None = None
        self._info_waiter: asyncio.Future | None = None
        self._expected_infos: set[int] = set()
        # OSDs that announced data for this PG (MOSDPGNotify model):
        # their identity survives the per-round peer_logs rebuild, so
        # every peering round re-queries them even if their one
        # announcement raced a wipe
        self._notifiers: set[int] = set()
        # op pipeline
        self.op_queue: asyncio.Queue = asyncio.Queue()
        self._worker: asyncio.Task | None = None
        # the op the serialized worker is executing RIGHT NOW, as its
        # trace "execute" span (the worker is one-op-at-a-time, so an
        # instance slot is race-free); _submit_write hangs the
        # objectstore/repop child spans off it
        self._active_span = None
        # asserted client backoffs (ref: PG::Backoff / backoff_map):
        # client entity -> [backoff id, conn]. Asserted while the PG
        # is not active (peering) or its op queue is saturated;
        # re-asserted across interval change, released on activation /
        # drain. The Objecter parks matching ops until UNBLOCK.
        self.backoffs: dict[str, list] = {}
        # tid -> [pending_replica_set, future, reqid, timed_out]: one
        # record per in-flight repop. ``timed_out`` marks repops whose
        # client already got -EAGAIN; a late completing reply (or a
        # re-peer + completed recovery) promotes the recorded dedup
        # result to success so resends stop seeing -EAGAIN.
        self._repop_waiters: dict[int, list] = {}
        self._push_waiters: dict[str, asyncio.Future] = {}
        # (peer_osd, oid) -> future completed by MOSDPGPushReply: the
        # primary's recovery only counts ACKED pushes as recovered
        self._push_ack_waiters: dict[tuple[int, str],
                                     asyncio.Future] = {}
        # (client, tid) -> (result, extra): replays of mutating ops whose
        # reply was lost return the recorded outcome instead of
        # re-executing (ref: pg_log_entry_t reqid dedup)
        self._reqid_results: dict[tuple, tuple] = {}
        # watch/notify (ref: PrimaryLogPG watchers_): oid ->
        # {(client, cookie): conn}. In-memory on the primary; clients
        # re-watch after a primary change (the reference persists watch
        # state in the object info — documented simplification).
        self._watchers: dict[str, dict[tuple, object]] = {}
        self._notify_waiters: dict[int, list] = {}   # id -> [pending, fut, acks]
        # head oid -> [(clone_id, covered_snaps)], lazily built from the
        # store and INVALIDATED whenever clone state changes (COW, trim,
        # recovery push, split). Keeps the hot snapc-write path O(1) —
        # without it every snap-context write scanned the whole PG
        # collection (r4 review finding).
        self._clone_idx: dict[str, list] | None = None
        self.scrub_errors = 0
        self.last_scrub = 0.0
        self._scrubber = None
        # set by merge_from: the parent absorbed a source's objects +
        # log — the next advance() must re-peer even though the acting
        # set may be unchanged, so replicas reconcile any divergence
        # the folded logs carry
        self._force_repeer = False
        self._ensure_collection()
        self._load_meta()

    # -- persistence -------------------------------------------------------
    def _ensure_collection(self) -> None:
        if self.cid not in self.osd.store.list_collections():
            t = Transaction().create_collection(self.cid)
            t.touch(self.cid, PGMETA)
            self.osd.store.queue_transaction(t)

    def _load_meta(self) -> None:
        try:
            omap = self.osd.store.omap_get(self.cid, PGMETA)
        except StoreError:
            return
        blob = omap.get("pg_log")
        if blob:
            self.pg_log = PGLog.decode(blob)
            self.last_user_version = self.pg_log.head.v
        pblob = omap.get("peering")
        if pblob:
            meta = json.loads(pblob)
            self.past_intervals = meta.get("past_intervals", [])
            self.interval_start = meta.get("interval_start", 0)
            self.last_epoch_clean = meta.get("last_epoch_clean", 0)
            self.last_epoch_started = meta.get("last_epoch_started", 0)
            self.last_backfill = meta.get("last_backfill", MAX_OID)
            self.backfill_at = eversion(
                *meta.get("backfill_at", (0, 0)))

    def _meta_txn(self, t: Transaction) -> Transaction:
        t.omap_setkeys(self.cid, PGMETA, {
            "pg_log": self.pg_log.encode(),
            "peering": json.dumps({
                "past_intervals": self.past_intervals,
                "interval_start": self.interval_start,
                "last_epoch_clean": self.last_epoch_clean,
                "last_epoch_started": self.last_epoch_started,
                "last_backfill": self.last_backfill,
                "backfill_at": list(self.backfill_at),
            }).encode()})
        return t

    def _trim_keep(self) -> int:
        """Retained pg-log length (ref: osd_min_pg_log_entries). The
        log tail this leaves behind is the log-delta recovery horizon:
        a peer whose head predates it must be backfilled."""
        return int(self.osd.config.get("osd_min_pg_log_entries", 1000))

    def _backfill_enabled(self) -> bool:
        """Escape hatch for the seed-reproduction regression test
        (tests/test_backfill.py): with backfill off, a peer past the
        log horizon silently gets only the retained log delta — the
        exact data-loss hole backfill exists to close."""
        return bool(self.osd.config.get("osd_backfill", True))

    @property
    def scrubber(self):
        if self._scrubber is None:
            from ceph_tpu_torch.osd.scrub import Scrubber
            self._scrubber = Scrubber(self)
        return self._scrubber

    def is_primary(self) -> bool:
        return self.primary == self.osd.whoami

    def role_active(self) -> bool:
        # backfill runs ONLINE: client ops keep flowing while the scan
        # copies history (only the per-object gates in _execute park)
        return self.state in ("active", "recovering", "clean",
                              "backfilling", "backfill_wait",
                              "backfill_toofull")

    # -- interval changes --------------------------------------------------
    def advance(self, up: list[int], acting: list[int], primary: int,
                epoch: int) -> None:
        """ref: PeeringState::advance_map — a changed acting set starts
        a new interval; the primary re-peers. The closing interval is
        recorded in past_intervals (every member of it may hold writes
        this PG acknowledged — see _peer_inner's prior coverage)."""
        changed = (acting != self.acting or primary != self.primary)
        if changed:
            old = [o for o in self.acting if o >= 0]
            if old and epoch > self.interval_start:
                self.past_intervals.append(
                    [self.interval_start, epoch - 1, old,
                     self.primary])
                self.past_intervals = [
                    iv for iv in self.past_intervals
                    if iv[1] >= self.last_epoch_clean]
            self.interval_start = epoch
            try:        # survive restarts: intervals gate activation
                self.osd.store.queue_transaction(
                    self._meta_txn(Transaction()))
            except StoreError as e:
                # degraded to in-memory-only intervals until the next
                # successful meta write (every log append retries it) —
                # loud, because a crash before then re-opens the
                # pre-PastIntervals activation hole
                log.error(f"pg {self.pgid} interval persist failed: {e}")
        self.up = up
        self.acting = acting
        self.primary = primary
        self.epoch = epoch
        if not changed and self.role_active() and \
                not self._force_repeer:
            return
        self._force_repeer = False
        if changed:
            # interval actually ended: stop any backfill run and free
            # its reservations. NOT on mere epoch bumps — a replica
            # falls through here on every unrelated map change, and
            # releasing its remote reservation slot mid-scan would let
            # a second primary in past osd_max_backfills.
            self._cancel_backfill()
        if self._peering_task:
            self._peering_task.cancel()
            self._peering_task = None
        if self.is_primary():
            self.state = "peering"
            if changed:
                # blocked clients stay blocked across the interval
                # change; released when this peering round activates
                self.reassert_backoffs()
            self._peering_task = asyncio.ensure_future(self._peer())
        else:
            self.state = "replica" if self.osd.whoami in acting \
                else "stray"
            # no longer the primary: our backoffs must not park
            # clients that should now talk to the new primary
            self.release_backoffs()
            if self._worker:
                self._worker.cancel()
                self._worker = None
                # admitted-but-unexecuted ops die with the worker:
                # give their admission-throttle slots back (clients
                # resend to the new primary) — leaked slots would
                # eventually wedge the whole OSD's op admission
                self._drain_op_queue()
            if self.state == "stray" and primary >= 0 \
                    and primary != self.osd.whoami:
                # announce ourselves to the new primary (ref:
                # MOSDPGNotify): a pgp_num change (pg splitting's
                # migration phase) can hand the PG to OSDs that hold
                # none of its data — without this notify a FRESH
                # primary instance has no way to learn the data's old
                # location and would activate empty. Re-sent on EVERY
                # map advance while stray: a one-shot notify can land
                # mid-peering (peer_logs is rebuilt there) and be lost.
                asyncio.ensure_future(self.osd.send_osd(
                    primary, MOSDPGInfo(
                        pgid=self.cid, epoch=epoch,
                        from_osd=self.osd.whoami,
                        log=self.pg_log.encode(), notify=1,
                        intervals=json.dumps(self.past_intervals),
                        last_backfill=self.last_backfill,
                        backfill_at_epoch=self.backfill_at.epoch,
                        backfill_at_v=self.backfill_at.v,
                        les=self.last_epoch_started, activate=0)))

    # -- client backoffs (ref: PG::add_backoff/release_backoffs) ---------
    async def send_backoff(self, m: MOSDOp) -> None:
        """BLOCK the whole PG range for this op's client instead of
        queueing while we are not active / saturated; the op itself is
        dropped (the parked Objecter resends after UNBLOCK)."""
        from ceph_tpu_torch.osd.daemon import OVERLOAD_PERF
        from ceph_tpu_torch.osd.messages import BACKOFF_OP_BLOCK, MOSDBackoff
        ent = self.backoffs.get(m.src)
        if ent is None:
            ent = [self.osd.next_tid(), m.conn]
            self.backoffs[m.src] = ent
        else:
            ent[1] = m.conn               # freshest connection wins
        OVERLOAD_PERF.inc("backoffs_sent")
        try:
            await m.conn.send_message(MOSDBackoff(
                op=BACKOFF_OP_BLOCK, id=ent[0], pool=self.pgid.pool,
                seed=self.pgid.seed, begin=MIN_OID, end=MAX_OID,
                epoch=self.epoch, from_osd=self.osd.whoami))
        except Exception:
            pass          # client's backoff self-heal covers the loss

    def release_backoffs(self) -> None:
        """UNBLOCK every asserted backoff (activation, drain, or this
        OSD ceasing to be the primary — a new primary owes the client
        nothing, so it must stop waiting on us)."""
        if not self.backoffs:
            return
        from ceph_tpu_torch.osd.daemon import OVERLOAD_PERF
        from ceph_tpu_torch.osd.messages import BACKOFF_OP_UNBLOCK, \
            MOSDBackoff
        released = list(self.backoffs.items())
        self.backoffs = {}

        async def _send(bid, conn):
            OVERLOAD_PERF.inc("backoffs_released")
            try:
                await conn.send_message(MOSDBackoff(
                    op=BACKOFF_OP_UNBLOCK, id=bid,
                    pool=self.pgid.pool, seed=self.pgid.seed,
                    begin=MIN_OID, end=MAX_OID, epoch=self.epoch,
                    from_osd=self.osd.whoami))
            except Exception:
                pass
        for _src, (bid, conn) in released:
            asyncio.ensure_future(_send(bid, conn))

    def reassert_backoffs(self) -> None:
        """Interval change while still primary: the blocked clients
        stay blocked — re-send the BLOCKs so a client that raced the
        change keeps parking (ref: backoffs surviving interval
        change)."""
        from ceph_tpu_torch.osd.messages import BACKOFF_OP_BLOCK, MOSDBackoff

        async def _send(bid, conn):
            try:
                await conn.send_message(MOSDBackoff(
                    op=BACKOFF_OP_BLOCK, id=bid, pool=self.pgid.pool,
                    seed=self.pgid.seed, begin=MIN_OID, end=MAX_OID,
                    epoch=self.epoch, from_osd=self.osd.whoami))
            except Exception:
                pass
        for _src, (bid, conn) in list(self.backoffs.items()):
            asyncio.ensure_future(_send(bid, conn))

    def dump_backoffs(self) -> dict:
        return {src: {"id": bid, "begin": MIN_OID, "end": "MAX"}
                for src, (bid, _conn) in self.backoffs.items()}

    def _cancel_backfill(self) -> None:
        """Interval change / teardown: stop the scan and free every
        reservation (the target's persisted watermark survives — the
        next primary resumes from it, which is the whole point)."""
        if self._backfill_task is not None:
            self._backfill_task.cancel()
            self._backfill_task = None
        self._backfill_inflight = None
        self.osd.local_reserver.cancel(self.cid)
        # target-side slot too: a dead primary never sends RELEASE, but
        # its death moves the map, which lands here on every target
        self.osd.remote_reserver.cancel(self.cid)
        for o in list(self.backfill_targets):
            if o != self.osd.whoami and self.osd.osd_is_up(o):
                asyncio.ensure_future(self._send_reserve_op(
                    o, RESERVE_RELEASE,
                    self._reserve_tids.get(o, 0)))
        self.backfill_targets = {}

    async def _send_reserve_op(self, osd: int, op: int,
                               tid: int = 0) -> None:
        try:
            await self.osd.send_osd(osd, MBackfillReserve(
                pgid=self.cid, epoch=self.epoch, tid=tid, op=op,
                from_osd=self.osd.whoami))
        except Exception:
            pass          # peer death releases its slots anyway

    def live_acting(self) -> list[int]:
        return [o for o in self.acting
                if o >= 0 and self.osd.osd_is_up(o)]

    # -- peering (primary) -------------------------------------------------
    async def _peer(self) -> None:
        try:
            await self._peer_inner()
        except asyncio.CancelledError:
            pass
        except RecoveryDeviceError:
            # a rebuild failed on the card (counted and logged where it
            # failed): not retried, the next interval peers again
            self.state = "peering"
            raise
        except Exception as e:
            log.dout(1, f"pg {self.pgid} peering failed ({e}); retrying")
            self.state = "peering"
            self.osd.request_repeer(self, delay=0.5)

    async def _peer_inner(self) -> None:
        interval_epoch = self.epoch
        peers = [o for o in self.live_acting() if o != self.osd.whoami]
        self.peer_logs = {}
        self.peer_les = {}
        if len(self.live_acting()) < self.pool.min_size:
            self.state = "peering"        # undersized: wait for map
            return
        # prior set (ref: PeeringState::build_prior): members of every
        # past interval since last clean that MAY have gone active —
        # any of them may hold writes acknowledged while the current
        # acting set was out. An interval whose primary never received
        # an up_thru grant >= its first epoch never activated (the
        # grant precedes activation below), so it cannot hold acked
        # writes and is excluded — without this test, every transient
        # one-epoch acting set whose members later die would block the
        # PG forever. Reachable prior strays are queried alongside the
        # acting peers; their logs compete in find_best_info below.
        om = self.osd.osdmap
        active_ivs = []
        for iv in self.past_intervals:
            prim = iv[3] if len(iv) > 3 else \
                (iv[2][0] if iv[2] else -1)
            if om is not None and prim >= 0 and \
                    om.up_thru.get(prim, 0) < iv[0]:
                continue                  # never activated
            active_ivs.append(iv)
        prior = set()
        for iv in active_ivs:
            prior.update(iv[2])
        prior |= self._notifiers     # announced data holders (notify)
        prior -= set(self.acting)
        prior.discard(self.osd.whoami)
        strays = [o for o in sorted(prior) if self.osd.osd_is_up(o)]
        query = peers + strays
        if query:
            fut = asyncio.get_event_loop().create_future()
            self._info_waiter = fut
            self._expected_infos = set(query)
            for o in query:
                await self.osd.send_osd(o, MOSDPGQuery(
                    pgid=self.cid, epoch=interval_epoch,
                    from_osd=self.osd.whoami))
            try:
                await asyncio.wait_for(fut, timeout=3.0)
            except asyncio.TimeoutError:
                pass
            finally:
                self._info_waiter = None
            if not set(query) <= set(self.peer_logs):
                # a QUERIED peer didn't answer; retry soon (map may be
                # stale). Subset test, not proper-subset: an
                # unsolicited notify landing in peer_logs mid-wait must
                # not mask a queried peer's silence.
                self.state = "peering"
                self.osd.request_repeer(self, delay=0.5)
                return
        if self.epoch != interval_epoch:
            return                        # superseded interval
        # interval coverage gate: activation requires having heard
        # from >=1 member of EACH past interval — an interval whose
        # every member is down blocks peering (upstream: 'down' /
        # 'incomplete'; recovery needs those OSDs back or an operator
        # decision, never silent activation that may discard their
        # acknowledged writes).
        heard = set(self.peer_logs) | {self.osd.whoami}
        for iv in active_ivs:
            _f, _l, members = iv[0], iv[1], iv[2]
            if not (set(members) & heard):
                log.dout(1, f"pg {self.pgid} down: no member of past "
                            f"interval [{_f},{_l}] {members} reachable")
                self.state = "peering"
                self.osd.request_repeer(self, delay=1.0)
                return
        # up_thru grant (ref: OSDMonitor::prepare_alive / PeeringState
        # need_up_thru): BEFORE activating, this interval must be
        # recorded in the map — that is what lets FUTURE peers apply
        # the maybe-went-active test above to THIS interval.
        if om is not None and \
                om.up_thru.get(self.osd.whoami, 0) < self.interval_start:
            from ceph_tpu_torch.mon.messages import MOSDAlive
            await self.osd.monc.send_report(MOSDAlive(
                osd=self.osd.whoami, epoch=self.interval_start))
            # re-want the map stream explicitly: the grant may ALREADY
            # be committed (the mon dedupes re-requests, so no new inc
            # will ever be published for it) with the publish lost to
            # a dropped subscription — without this re-subscribe the
            # retry loop below waits forever on a map that will never
            # arrive
            await self.osd.monc.subscribe("osdmap", om.epoch + 1)
            self.state = "peering"    # retry once the grant's map lands
            self.osd.request_repeer(self, delay=0.3)
            return
        # authoritative log: max head (ref: find_best_info) — among
        # COMPLETE candidates only (last_backfill == MAX): a mid-
        # backfill peer's log may be current while its store lacks most
        # objects, so its info must never win authority (ref:
        # find_best_info's infos-with-incomplete-last_backfill skip).
        # With every candidate incomplete there is no authoritative
        # store anywhere: block rather than activate and serve holes.
        backfill_on = self._backfill_enabled()
        infos = [(self.osd.whoami, self.pg_log, self.last_backfill)]
        infos += [(o, plog, self.peer_last_backfill.get(o, MAX_OID))
                  for o, plog in self.peer_logs.items()]
        if backfill_on:
            complete = [c for c in infos if c[2] == MAX_OID]
            if not complete:
                log.dout(1, f"pg {self.pgid} incomplete: every "
                            f"candidate is mid-backfill")
                self.state = "peering"
                self.osd.request_repeer(self, delay=1.0)
                return
        else:
            complete = infos
        # order candidates by (last_epoch_started, head) — ref:
        # find_best_info's max-les-then-max-last_update. Head alone is
        # WRONG here: a revived pre-failover primary can carry a
        # divergent entry (logged locally, never committed on enough
        # replicas/shards) whose version outranks everything the
        # surviving interval wrote — but its les predates the interval
        # that peered without it, so the survivors' log must win and
        # the divergent entry rolls back below.
        def _key(o: int, plog: PGLog) -> tuple:
            les = self.last_epoch_started if o == self.osd.whoami \
                else self.peer_les.get(o, 0)
            if plog.head == eversion():
                # an empty log testifies to nothing: a fresh primary
                # that activated empty (pgp_num split migration) must
                # not out-elect a stray actually holding the data
                les = 0
            return (les, plog.head)
        best_osd, best, _ = complete[0]
        for o, plog, _lb in complete[1:]:
            if _key(o, plog) > _key(best_osd, best):
                best, best_osd = plog, o
        if backfill_on and \
                _key(best_osd, best) < max(
                    _key(c[0], c[1]) for c in infos):
            # the newest log lives ONLY on a mid-backfill candidate:
            # adopting the best complete log would roll back writes
            # acknowledged in a later interval (the incomplete holder
            # has them for oids <= its watermark; the dead primary had
            # the rest). Upstream calls this 'down' — block until the
            # missing holder returns, never silently discard.
            log.dout(1, f"pg {self.pgid} down: newest log only on an "
                        f"incomplete (mid-backfill) peer")
            self.state = "peering"
            self.osd.request_repeer(self, delay=1.0)
            return
        if backfill_on and best_osd != self.osd.whoami and \
                not best.continuous_with(self.pg_log.head) and \
                self.last_backfill == MAX_OID:
            # THIS osd's own history predates the authoritative log's
            # tail (fresh store, or a rejoin from past the horizon)
            # AND the map made it primary: its missing set below is
            # incomplete by construction, so demote its own watermark —
            # the self-backfill block under it rebuilds the store from
            # a complete peer before anything is served. (A persisted
            # watermark < MAX is kept: that is resume progress.)
            self.last_backfill = MIN_OID
        if best_osd != self.osd.whoami:
            # divergent-entry revert (ref: PGLog::_merge_divergent_
            # entries rolling back to the authoritative version): any
            # local entry NEWER than the authoritative log's newest for
            # that object is an uncommitted write the elected interval
            # never saw — the store may hold its bytes, so queue a pull
            # back to the authoritative version before serving anything
            auth_newest = best.newest_per_object()
            for oid, e in self.pg_log.newest_per_object().items():
                ae = auth_newest.get(oid)
                if ae is not None and e.version > ae.version:
                    log.dout(1, f"pg {self.pgid} reverting divergent "
                                f"{oid} {e.version} -> {ae.version}")
                    self.my_missing[oid] = ae
            # merge may ADD to my_missing; leftovers from an earlier
            # interval whose pulls failed must stay until recovered —
            # our log may now BE the best (merged last round) while the
            # object bytes still aren't here
            self.my_missing.update(self.pg_log.merge(best))
            # our log now IS the authoritative interval's: adopt its
            # les so the raced-notify check below (and any election we
            # testify in before re-activating) ranks us where the
            # merged log actually stands
            self.last_epoch_started = max(self.last_epoch_started,
                                          self.peer_les.get(best_osd,
                                                            0))
            t = self._meta_txn(Transaction())
            self.osd.store.queue_transaction(t)
        if backfill_on and self.last_backfill != MAX_OID:
            # our own resume-safety check (mirror of the per-target
            # one below): entries newer than our backfill_at with oids
            # under our watermark are changes we provably missed —
            # pull them as log-delta; if the log can no longer prove
            # the sub-watermark region, restart our scan from MIN
            if self.pg_log.continuous_with(self.backfill_at):
                for oid, e in self.pg_log.newest_per_object().items():
                    if oid <= self.last_backfill and \
                            e.version > self.backfill_at and \
                            self._version_blob(oid) != \
                            e.version.epoch.to_bytes(4, "little") + \
                            e.version.v.to_bytes(8, "little"):
                        self.my_missing[oid] = e
            else:
                self.last_backfill = MIN_OID
        if self.my_missing:
            # pull objects the primary itself lacks. Source selection
            # matters: a peer whose log never saw the object would stay
            # silent (handle_pg_pull), so prefer one whose log carries
            # the exact entry we need; the merged-from peer qualifies.
            peer_newest = {o: plog.newest_per_object()
                           for o, plog in self.peer_logs.items()}
            for oid, entry in list(self.my_missing.items()):
                # candidate sources in preference order; ROTATE through
                # them — a single fixed source whose log has the entry
                # but whose store lacks the bytes (its own pulls failed
                # earlier) stays silent, and retrying only it would
                # livelock while another peer holds the object
                cands: list[int] = []
                if best_osd != self.osd.whoami:
                    cands.append(best_osd)
                for o, newest in peer_newest.items():
                    ne = newest.get(oid)
                    if ne is not None and ne.version == entry.version:
                        cands.append(o)
                cands.extend(o for o in self.live_acting())
                seen: set[int] = set()
                for src in cands:
                    if src in seen or src < 0 or \
                            src == self.osd.whoami or \
                            not self.osd.osd_is_up(src):
                        continue
                    seen.add(src)
                    await self._pull(src, oid)
                    if oid not in self.my_missing:
                        break
            if self.my_missing:
                # do NOT activate with stale objects: a client read
                # would serve pre-outage data. Retry the interval.
                self.state = "peering"
                self.osd.request_repeer(self, delay=0.5)
                return
        if backfill_on and self.last_backfill != MAX_OID:
            # THIS primary is itself mid-backfill (it was a target when
            # the map promoted it — there is no pg_temp here to prevent
            # that): before serving anything it must finish its own
            # copy, pulling the scan from a complete peer. Runs inline
            # in peering (ops queue behind role_active) — the working
            # sets this framework runs keep it short.
            src = best_osd if best_osd != self.osd.whoami else next(
                (o for o, _pl, _lb in complete
                 if o != self.osd.whoami and self.osd.osd_is_up(o)),
                None)
            if src is None or not await self._backfill_self(src):
                self.state = "peering"
                self.osd.request_repeer(self, delay=0.5)
                return
        self.last_user_version = max(self.last_user_version,
                                     self.pg_log.head.v)
        # per-peer missing sets (ref: GetMissing) — acting peers only:
        # prior strays answered queries but take no recovery pushes
        # (they leave the set at the next clean interval). A peer whose
        # log is NOT continuous with the authoritative log (its head
        # predates our tail — it missed more history than the retained
        # log can describe) or who reports an incomplete last_backfill
        # becomes a BACKFILL TARGET: its missing set cannot be derived
        # from the log, the scan machinery rebuilds it. Its log-derived
        # missing is kept only for oids <= its watermark (objects it is
        # supposed to hold current — e.g. it missed repops while briefly
        # down mid-backfill); everything above is the scan's job.
        self.backfill_targets = {}
        self.peer_missing = {}
        for o, plog in self.peer_logs.items():
            if o not in self.acting:
                continue
            missing = plog.missing_vs(self.pg_log)
            lb = self.peer_last_backfill.get(o, MAX_OID)
            if backfill_on and \
                    (lb != MAX_OID or
                     not self.pg_log.continuous_with(plog.head)):
                at = self.peer_backfill_at.get(o, eversion())
                if lb != MAX_OID and \
                        self.pg_log.continuous_with(at):
                    # RESUME: the retained log proves exactly what
                    # changed below the watermark since it was last
                    # valid — push those as log-delta, scan the rest
                    wm = lb
                    missing = {oid: e for oid, e in missing.items()
                               if oid <= wm}
                    for oid, e in \
                            self.pg_log.newest_per_object().items():
                        if oid <= wm and e.version > at:
                            missing[oid] = e
                else:
                    # fresh join, or the target was away so long the
                    # sub-watermark deltas fell off the log: nothing
                    # below the watermark is provably current — the
                    # scan must restart from MIN
                    wm = MIN_OID
                    missing = {}
                self.backfill_targets[o] = wm
                log.dout(1, f"pg {self.pgid} osd.{o} needs backfill "
                            f"(log head {plog.head} < tail "
                            f"{self.pg_log.tail}; watermark "
                            f"{wm!r})")
            self.peer_missing[o] = missing
        # a notify that raced this round (landed after find_best_info
        # ran) may know newer acked writes: go again rather than
        # activating and serving stale data. Terminates: the next round
        # adopts that log, making its head ours. (Backfill targets are
        # exempt: their entries are a subset of ours by construction.)
        if any(_key(o, pl) > _key(self.osd.whoami, self.pg_log)
               for o, pl in self.peer_logs.items()
               if o not in self.backfill_targets):
            log.dout(1, f"pg {self.pgid} raced notify knows newer "
                        f"writes; re-peering")
            self.state = "peering"
            self.osd.request_repeer(self, delay=0.2)
            return
        self.state = "active"
        # record + broadcast the activation epoch: this interval is
        # now "started", and every acting survivor must be able to
        # testify to it in a future election (see MOSDPGInfo.les) —
        # persist BEFORE serving so a crash can't forget the interval
        if self.interval_start > self.last_epoch_started:
            self.last_epoch_started = self.interval_start
            self.osd.store.queue_transaction(
                self._meta_txn(Transaction()))
            for o in self.acting:
                if o < 0 or o == self.osd.whoami or \
                        not self.osd.osd_is_up(o):
                    continue
                asyncio.ensure_future(self.osd.send_osd(
                    o, MOSDPGInfo(
                        pgid=self.cid, epoch=self.epoch,
                        from_osd=self.osd.whoami,
                        log=self.pg_log.encode(), notify=0,
                        intervals="", last_backfill=self.last_backfill,
                        backfill_at_epoch=self.backfill_at.epoch,
                        backfill_at_v=self.backfill_at.v,
                        les=self.last_epoch_started, activate=1)))
        # activation releases the peering backoffs: parked clients
        # resend and the ops now dispatch (ref: on_activate_complete
        # releasing PG backoffs)
        self.release_backoffs()
        if self._worker is None:
            self._worker = asyncio.ensure_future(self._op_worker())
        asyncio.ensure_future(self._recover())
        log.dout(5, f"pg {self.pgid} active; acting {self.acting} "
                    f"missing {sum(map(len, self.peer_missing.values()))}")

    def handle_pg_query(self, m: MOSDPGQuery) -> None:
        asyncio.ensure_future(self.osd.send_osd(m.from_osd, MOSDPGInfo(
            pgid=self.cid, epoch=self.epoch, from_osd=self.osd.whoami,
            log=self.pg_log.encode(), notify=0, intervals="",
            last_backfill=self.last_backfill,
            backfill_at_epoch=self.backfill_at.epoch,
            backfill_at_v=self.backfill_at.v,
            les=self.last_epoch_started, activate=0)))

    def handle_pg_info(self, m: MOSDPGInfo) -> None:
        if getattr(m, "activate", 0):
            # primary's activation broadcast: adopt the started epoch
            # so THIS replica can out-elect a revived older primary
            # even if the broadcasting primary later dies too
            if m.les > self.last_epoch_started:
                self.last_epoch_started = m.les
                try:
                    self.osd.store.queue_transaction(
                        self._meta_txn(Transaction()))
                except StoreError as e:
                    log.error(f"pg {self.pgid} les persist failed: "
                              f"{e}")
            return
        plog = PGLog.decode(m.log)
        self.peer_logs[m.from_osd] = plog
        self.peer_les[m.from_osd] = getattr(m, "les", 0)
        self.peer_last_backfill[m.from_osd] = m.last_backfill
        self.peer_backfill_at[m.from_osd] = eversion(
            m.backfill_at_epoch, m.backfill_at_v)
        if m.notify:
            # unsolicited stray announcement (ref: MOSDPGNotify): merge
            # its interval history so the coverage gate knows this OSD,
            # and if it knows writes we don't (a pgp_num change moved
            # the PG here before any data followed), re-peer — its log
            # now competes in find_best_info and recovery pulls from it
            self._notifiers.add(m.from_osd)
            if m.intervals:
                try:
                    have = {json.dumps(iv) for iv in self.past_intervals}
                    added = False
                    for iv in json.loads(m.intervals):
                        # prune like advance() does: an interval that
                        # closed before our last clean epoch is already
                        # covered — merging it verbatim could wedge the
                        # coverage gate on long-dead OSDs
                        if json.dumps(iv) not in have and \
                                len(iv) >= 2 and \
                                iv[1] >= self.last_epoch_clean:
                            self.past_intervals.append(iv)
                            added = True
                    if added:
                        # persist: merged intervals gate activation
                        # exactly like our own (advance() persists for
                        # the same reason) — a crash must not forget
                        # them
                        try:
                            self.osd.store.queue_transaction(
                                self._meta_txn(Transaction()))
                        except StoreError as e:
                            log.error(f"pg {self.pgid} interval "
                                      f"persist failed: {e}")
                except (ValueError, TypeError):
                    pass
            if self.is_primary() and plog.head > self.pg_log.head:
                # the stray knows writes we don't. Re-peer when settled;
                # when a round is mid-flight (it may already have passed
                # find_best_info), queue ANOTHER round — peer_logs keeps
                # this log, and _notifiers guarantees the stray is
                # re-queried even if it gets wiped
                log.dout(1, f"pg {self.pgid} stray osd.{m.from_osd} "
                            f"knows newer writes; re-peering")
                if self.state in ("active", "recovering", "clean"):
                    self.state = "peering"
                    self.osd.request_repeer(self, delay=0.1)
                # mid-peering arrivals are handled by the end-of-round
                # raced-notify check in _peer_inner
        expected = self._expected_infos or set(
            o for o in self.live_acting() if o != self.osd.whoami)
        if self._info_waiter and not self._info_waiter.done() and \
                set(self.peer_logs) >= expected:
            self._info_waiter.set_result(True)

    # -- self-managed snapshots (ref: PrimaryLogPG make_writeable /
    # SnapSet; clones are first-class objects in the same PG) ------------
    def _clone_list(self, oid: str) -> list[tuple[int, list[int]]]:
        """[(clone_id, covered_snap_ids)] ascending, from the clone
        objects' _clsnaps xattrs (served from the lazy per-PG index)."""
        if self._clone_idx is None:
            store = self.osd.store
            idx: dict[str, list] = {}
            prefix = CLONE_PREFIX
            try:
                names = store.list_objects(self.cid)
            except StoreError:
                names = []
            for name in names:
                head = clone_head(name)
                if head is None:
                    continue
                cid_ = int(name[len(prefix):].split(".", 1)[0])
                try:
                    blob = store.getattrs(self.cid, name).get("_clsnaps")
                except StoreError:
                    continue
                covered = json.loads(blob) if blob else []
                idx.setdefault(head, []).append((cid_, covered))
            for lst in idx.values():
                lst.sort()
            self._clone_idx = idx
        return self._clone_idx.get(oid, [])

    def _resolve_snap_read(self, oid: str, snap_id: int) -> str | None:
        """Object name serving a read AT snap_id, or None (-ENOENT):
        the clone covering the snap, else the head if the object
        existed unmodified since (and was not created after the snap)
        (ref: PrimaryLogPG::find_object_context snapid resolution)."""
        for cid_, covered in self._clone_list(oid):
            if snap_id in covered:
                return clone_name(oid, cid_)
        store = self.osd.store
        if not store.exists(self.cid, oid):
            return None
        try:
            pre = store.getattrs(self.cid, oid).get("_pre")
        except StoreError:
            return None
        if pre and snap_id in json.loads(pre):
            return None                 # created after this snap
        return oid

    def _maybe_cow(self, t: Transaction, oid: str, snap_seq: int,
                   snaps: list[int]) -> str | None:
        """Clone-on-write: preserve the head state for every live snap
        not yet covered by a clone, as part of the SAME transaction as
        the incoming mutation (ref: make_writeable). Returns the clone
        name when one was made (caller logs it so recovery tracks it)."""
        store = self.osd.store
        live = [s for s in snaps if s <= snap_seq]
        if not store.exists(self.cid, oid):
            return None     # born-after marking happens post-mutation
        covered: set[int] = set()
        for _, csnaps in self._clone_list(oid):
            covered |= set(csnaps)
        try:
            pre = store.getattrs(self.cid, oid).get("_pre")
            if pre:
                covered |= set(json.loads(pre))
        except StoreError:
            pass
        new_snaps = sorted(s for s in live if s not in covered)
        if not new_snaps:
            return None
        clone = clone_name(oid, snap_seq)
        if store.exists(self.cid, clone):
            # a clone for this snap id already exists (e.g. a stale
            # client snapc still names a snap whose clone was since
            # trimmed down): NEVER overwrite it — that would replace
            # data preserved for OTHER snaps with the current head
            # (silent snapshot corruption, r4 review finding)
            return None
        # O(metadata) clone (ref: make_writeable -> _make_clone): the
        # store's OP_CLONE carries data+attrs+omap to the clone object —
        # on BlueStore by sharing the head's blobs (refcount bump, zero
        # data bytes move), so snapshotting never costs O(size) here.
        size = store.stat(self.cid, oid)
        t.clone(self.cid, oid, clone)
        t.setattrs(self.cid, clone,
                   {"_clsnaps": json.dumps(new_snaps).encode()})
        t.rmattr(self.cid, clone, "_pre")
        # clone_overlap (ref: SnapSet::clone_overlap): byte ranges the
        # clone still shares with the head. Starts as the full clone
        # extent; head writes in this same op (and later ones) subtract
        # themselves in do_op. Only the NEWEST clone's overlap is live:
        # once a younger clone exists, the older clone's overlap-vs-head
        # at that moment equals its overlap vs the younger clone, and
        # both sides are immutable from then on — so freezing it is
        # exact, not an approximation. Recovery/scrub can use it to push
        # only divergent bytes.
        t.setattrs(self.cid, clone, {"_clover": json.dumps(
            [[0, size]] if size else []).encode()})
        self._clone_idx = None          # clone set changes when t lands
        return clone

    def _newest_clone_overlap(self, oid: str) -> tuple[str, list] | None:
        """(clone_name, overlap_intervals) of the newest existing clone
        of oid, or None when there is no clone / no recorded overlap."""
        clones = self._clone_list(oid)
        if not clones:
            return None
        name = clone_name(oid, clones[-1][0])
        try:
            blob = self.osd.store.getattrs(self.cid, name).get("_clover")
        except StoreError:
            return None
        if not blob:
            return None
        return name, json.loads(blob)

    @staticmethod
    def _overlap_sub(ivals: list, off: int, end: int | None) -> list:
        """Subtract [off, end) (end None = to infinity) from sorted
        disjoint [lo, hi) intervals (ref: interval_set::subtract)."""
        out = []
        for lo, hi in ivals:
            if (end is not None and end <= lo) or off >= hi:
                out.append([lo, hi])
                continue
            if lo < off:
                out.append([lo, off])
            if end is not None and end < hi:
                out.append([end, hi])
        return out

    def _snaptrim(self, t: Transaction, oid: str, snap_id: int) -> list:
        """Drop snap_id from the object's clones; clones covering no
        remaining snap are removed (ref: the snap trimmer /
        PrimaryLogPG::trim_object). Returns touched clone names."""
        touched = []
        for cid_, covered in self._clone_list(oid):
            if snap_id not in covered:
                continue
            covered = [s for s in covered if s != snap_id]
            name = clone_name(oid, cid_)
            if covered:
                t.setattrs(self.cid, name,
                           {"_clsnaps": json.dumps(covered).encode()})
            else:
                t.remove(self.cid, name)
            touched.append(name)
        if touched:
            self._clone_idx = None
        return touched

    async def snap_trim_removed(self, snap_id: int, batch: int,
                                sleep: float) -> int:
        """Primary-driven background trim of one deleted snapid (ref:
        PrimaryLogPG::do_snap_trim / the SnapTrimmer state machine,
        driven here from the osdmap's removed_snaps queue): every clone
        covering snap_id drops it, clones covering nothing are removed.
        Replicated via the normal repop pipeline (one log entry per
        touched clone), `batch` objects per burst with `sleep` between
        bursts so client I/O is not starved. Idempotent — a restart
        replays the whole removed_snaps queue. Returns objects trimmed."""
        if not self.is_primary():
            return 0
        store = self.osd.store
        try:
            names = store.list_objects(self.cid)
        except StoreError:
            return 0
        heads = sorted({h for h in (clone_head(n) for n in names)
                        if h is not None})
        done = 0
        for i, head in enumerate(heads):
            if not self.is_primary():       # map moved the PG away
                break
            t = Transaction()
            touched = self._snaptrim(t, head, snap_id)
            if not touched:
                continue
            reqid = (f"osd.{self.osd.whoami}.snaptrim", 0,
                     self.osd.next_tid())
            await self._submit_write(head, t, False, reqid,
                                     extra_oids=touched)
            done += 1
            if sleep and batch and (i + 1) % batch == 0:
                await asyncio.sleep(sleep)
        return done

    # -- watch/notify ------------------------------------------------------
    async def _do_notify(self, m, oid: str, timeout_ms: int,
                         payload: bytes) -> None:
        """Fan a notify out to every watcher and gather acks (ref:
        PrimaryLogPG::do_osd_op NOTIFY + watch_info_t). Runs as its own
        task so the op worker is not head-of-line blocked; NOTIFY_ACK
        ops bypass the worker queue (daemon routes them directly)."""
        notify_id = self.osd.next_tid()
        watchers = dict(self._watchers.get(oid, {}))
        # every watcher is pending BEFORE any send: an ack that races
        # in while later sends still await must neither be dropped nor
        # complete the future early (NOTIFY_ACK bypasses the op queue,
        # so it can arrive mid-loop)
        pending = set(watchers.keys())
        fut = asyncio.get_event_loop().create_future()
        acks: list = []
        self._notify_waiters[notify_id] = [pending, fut, acks]
        for (client, cookie), conn in list(watchers.items()):
            try:
                await conn.send_message(MWatchNotify(
                    oid=oid, pgid=self.cid, notify_id=notify_id,
                    cookie=cookie, payload=payload))
            except Exception:
                # dead watcher: drop the registration (the reference
                # ages watchers out via the watch timeout)
                self._watchers.get(oid, {}).pop((client, cookie), None)
                pending.discard((client, cookie))
        if pending:
            await asyncio.wait([fut],
                               timeout=(timeout_ms or 2000) / 1000.0)
        self._notify_waiters.pop(notify_id, None)
        await self._reply(m, 0, b"", {
            "notify_id": notify_id,
            "acks": sorted(str(k) for k in acks),
            "timeouts": sorted(str(k) for k in pending - set(acks))})

    def handle_notify_ack(self, client: str, notify_id: int,
                          cookie: int) -> None:
        ent = self._notify_waiters.get(notify_id)
        if ent is None:
            return
        pending, fut, acks = ent
        key = (client, cookie)
        if key in pending:
            acks.append(key)
            pending.discard(key)
        if not pending and not fut.done():
            fut.set_result(True)

    # -- pg splitting ------------------------------------------------------
    def split_objects(self, osdmap, new_pool) -> set:
        """pg_num grew: move every local object whose name now folds to
        a CHILD pg seed into that child's collection (ref: PG::
        split_into + pg_t::is_split — ceph_stable_mod guarantees a
        child's placement equals the parent's while pgp_num is
        unchanged, so the split is a local collection move; a later
        pgp_num bump migrates whole child PGs through normal peering).

        Runs on every replica identically (deterministic name fold), so
        post-split logs and stores stay consistent across the acting
        set. Idempotent: re-running moves nothing. Returns the child
        cids that received objects or log entries — the caller must
        ensure those children have local PG instances even when this
        OSD is not in their latest acting set (a batched pg_num +
        pgp_num map consume can move a child away in the same pass;
        without an instance there is no stray to announce the data)."""
        self._clone_idx = None          # clones move with their heads
        import numpy as np
        from ceph_tpu_torch.osd.types import ObjectLocator, pg_t as _pg_t
        store = self.osd.store
        if self.cid not in store.list_collections():
            return set()
        moved = 0
        touched: set[str] = set()
        loc = ObjectLocator(pool=self.pool.id)
        for oid in list(store.list_objects(self.cid)):
            if oid == PGMETA:
                continue
            # snap clones fold by their HEAD's name (they must stay in
            # the head's PG)
            raw = osdmap.object_locator_to_pg(clone_head(oid) or oid,
                                              loc)
            # fold the raw hash by the NEW pg_num (the objecter's
            # _calc_target fold — ceph_stable_mod)
            seed = int(new_pool.raw_pg_to_pg(
                np.asarray([raw.seed]), xp=np)[0])
            if seed == self.pgid.seed:
                continue
            child_cid = str(_pg_t(self.pool.id, seed))
            t = Transaction()
            if child_cid not in store.list_collections():
                t.create_collection(child_cid)
                t.touch(child_cid, PGMETA)
            try:
                data = store.read(self.cid, oid)
                attrs = store.getattrs(self.cid, oid)
                omap = store.omap_get(self.cid, oid)
            except StoreError:
                continue
            t.touch(child_cid, oid)
            if data:
                t.write(child_cid, oid, 0, data)
            if attrs:
                t.setattrs(child_cid, oid, attrs)
            if omap:
                t.omap_setkeys(child_cid, oid, omap)
            t.remove(self.cid, oid)
            store.queue_transaction(t)
            moved += 1
            touched.add(child_cid)
        # Split the PG LOG with the objects (ref: PGLog::split_into).
        # Store moves alone are NOT enough: a replica that missed the
        # writes (down during them) has the hole in neither child store
        # nor child log — every peer's child log would be empty, the
        # logs compare equal, and the acked object is never recovered
        # (objects vanished under the round-4 deep thrash's pg_num
        # growth mid-recovery). Moving the entries lets the child's
        # peering see exactly the divergence the parent's log recorded.
        child_logs: dict[str, PGLog] = {}
        child_seen: dict[str, set] = {}
        keep: list[LogEntry] = []
        for entry in self.pg_log.entries:
            raw = osdmap.object_locator_to_pg(
                clone_head(entry.oid) or entry.oid, loc)
            seed = int(new_pool.raw_pg_to_pg(
                np.asarray([raw.seed]), xp=np)[0])
            if seed == self.pgid.seed:
                keep.append(entry)
                continue
            child_cid = str(_pg_t(self.pool.id, seed))
            clog = child_logs.get(child_cid)
            if clog is None:
                clog = PGLog()
                try:
                    blob = store.omap_get(child_cid, PGMETA).get(
                        "pg_log")
                    if blob:
                        clog = PGLog.decode(blob)
                except StoreError:
                    pass
                child_logs[child_cid] = clog
                # crash idempotency: a crash after the child's merged
                # log persisted but before the parent's trimmed meta
                # did re-runs this split with the moved entries ALREADY
                # in the loaded child log — appending them again would
                # duplicate them and skew head/version accounting
                child_seen[child_cid] = {
                    (e.version.epoch, e.version.v, e.oid)
                    for e in clog.entries}
            key = (entry.version.epoch, entry.version.v, entry.oid)
            if key in child_seen[child_cid]:
                continue
            child_seen[child_cid].add(key)
            clog.append(entry)
        if child_logs:
            self.pg_log.entries = keep
            # the parent's head must describe entries it still HAS:
            # keeping a head that moved to a child would win
            # find_best_info with a log that lacks writes a sibling
            # replica retained
            self.pg_log.head = keep[-1].version if keep else eversion()
            for child_cid, clog in child_logs.items():
                clog.entries.sort(key=lambda en: (en.version.epoch,
                                                  en.version.v))
                if clog.entries:
                    clog.head = clog.entries[-1].version
                t = Transaction()
                if child_cid not in store.list_collections():
                    t.create_collection(child_cid)
                    t.touch(child_cid, PGMETA)
                t.omap_setkeys(child_cid, PGMETA,
                               {"pg_log": clog.encode()})
                store.queue_transaction(t)
                # an already-instantiated child loaded its pre-split
                # persisted log; hand it the split result in memory too
                child_pg = self.osd.pgs.get(child_cid)
                if child_pg is not None:
                    child_pg.pg_log = clog
                    child_pg.last_user_version = max(
                        child_pg.last_user_version, clog.head.v)
            store.queue_transaction(self._meta_txn(Transaction()))
        touched.update(child_logs)
        if moved or child_logs:
            log.dout(1, f"pg {self.pgid} split: moved {moved} objects, "
                        f"{sum(len(c.entries) for c in child_logs.values())} "
                        f"log entries (pg_num -> {new_pool.pg_num})")
        return touched

    # -- pg merging (round 6: the inverse of split) ------------------------
    def is_merge_source(self) -> bool:
        """This PG is folded away by the pool's pending pg_num
        decrease (ref: pg_t::is_merge_source)."""
        return self.pool.is_merge_source(self.pgid.seed)

    def merge_ready(self) -> bool:
        """Quiesce barrier (ref: PeeringState ready_to_merge): a
        source is ready once it is CLEAN at the folded placement —
        pgp_num dropped with the pg_num_pending commit, so clean means
        the source already sits on its fold target's OSDs. From this
        moment new client ops are backed off (see OSD.ms_dispatch), so
        the store+log contents the fold will move are frozen modulo
        already-admitted ops, every one of which lands in the log and
        therefore in the merged parent."""
        return self.is_merge_source() and self.is_primary() and \
            self.state == "clean"

    def _stop_tasks(self) -> None:
        """Tear down a source PG's machinery before the fold."""
        if self._worker:
            self._worker.cancel()
            self._worker = None
            self._drain_op_queue()
        if self._peering_task:
            self._peering_task.cancel()
            self._peering_task = None
        self._cancel_backfill()

    def merge_from(self, source: "PG") -> None:
        """Fold ``source``'s collection back into this (parent) PG:
        objects, log entries and versions move; the source collection
        is removed (ref: PG::merge_from + PGLog merge on pg_num
        decrease).

        Runs on every OSD holding the source collection, off the SAME
        committed map, with the same deterministic fold — so replicas
        stay consistent, exactly like split_objects in reverse. The
        log merge dedups by (epoch, v, oid) (crash-idempotent: a
        crash between the parent meta persisting and the source
        collection removal re-runs the fold with the entries already
        present) and the parent re-peers afterwards so any divergence
        a replica's folded log carries is reconciled by the normal
        missing-set machinery."""
        store = self.osd.store
        source.release_backoffs()
        source._stop_tasks()
        self._clone_idx = None
        moved = 0
        if source.cid in store.list_collections():
            for oid in list(store.list_objects(source.cid)):
                if oid == PGMETA:
                    continue
                try:
                    data = store.read(source.cid, oid)
                    attrs = store.getattrs(source.cid, oid)
                    omap = store.omap_get(source.cid, oid)
                except StoreError:
                    continue
                t = Transaction()
                t.touch(self.cid, oid)
                if data:
                    t.write(self.cid, oid, 0, data)
                if attrs:
                    t.setattrs(self.cid, oid, attrs)
                if omap:
                    t.omap_setkeys(self.cid, oid, omap)
                t.remove(source.cid, oid)
                store.queue_transaction(t)
                moved += 1
        # merge the source's log (same dedup discipline as
        # split_objects' child_seen): without it a replica that held
        # the only copy of a source write would fold a log nobody
        # compares, and the write could be silently dropped
        seen = {(e.version.epoch, e.version.v, e.oid)
                for e in self.pg_log.entries}
        folded = 0
        for entry in source.pg_log.entries:
            key = (entry.version.epoch, entry.version.v, entry.oid)
            if key in seen:
                continue
            seen.add(key)
            self.pg_log.entries.append(entry)
            folded += 1
        if folded:
            self.pg_log.entries.sort(
                key=lambda en: (en.version.epoch, en.version.v))
            self.pg_log.head = self.pg_log.entries[-1].version
        # horizon: the merged log's tail is the YOUNGER of the two —
        # claiming the older horizon would promise log-delta recovery
        # for history only one half retains (conservative: peers below
        # it backfill, which is always safe)
        if source.pg_log.tail > self.pg_log.tail:
            self.pg_log.tail = source.pg_log.tail
        self.last_user_version = max(self.last_user_version,
                                     source.last_user_version,
                                     self.pg_log.head.v)
        # an incomplete party taints the merged watermark (upstream
        # marks the merged PG for backfill; the readiness barrier
        # makes this the crash-race path, not the normal one)
        if source.last_backfill != MAX_OID:
            self.last_backfill = min(self.last_backfill,
                                     source.last_backfill)
        try:
            self.osd.store.queue_transaction(
                self._meta_txn(Transaction()))
            if source.cid in store.list_collections():
                store.queue_transaction(
                    Transaction().remove_collection(source.cid))
        except StoreError as e:
            log.error(f"pg {self.pgid} merge meta persist failed: {e}")
        self._force_repeer = True
        log.dout(1, f"pg {self.pgid} absorbed {source.pgid}: "
                    f"{moved} objects, {folded} log entries "
                    f"(pg_num -> {self.pool.pg_num})")

    # -- recovery ----------------------------------------------------------
    async def _pull(self, from_osd: int, oid: str) -> None:
        """Primary pulls an object it is missing (ref: RecoveryOp pull)."""
        fut = asyncio.get_event_loop().create_future()
        self._push_waiters[oid] = fut
        await self.osd.send_osd(from_osd, MOSDPGPull(
            pgid=self.cid, epoch=self.epoch, oid=oid,
            from_osd=self.osd.whoami))
        try:
            await asyncio.wait_for(fut, timeout=3.0)
        except asyncio.TimeoutError:
            log.dout(1, f"pg {self.pgid} pull of {oid} timed out")
        finally:
            self._push_waiters.pop(oid, None)

    def handle_pg_pull(self, m: MOSDPGPull) -> None:
        # only answer exists=False when OUR LOG says the object was
        # deleted — a peer that merely never had the object (stale log,
        # mid-split, mid-recovery itself) must stay silent, or the
        # puller would "recover" the absence as an authoritative delete
        # and drop an acked object (round-4 deep thrash, obj35)
        if not self.osd.store.exists(self.cid, m.oid):
            newest = self.pg_log.newest_per_object().get(m.oid)
            if newest is None or newest.op != OP_DELETE:
                log.dout(1, f"pg {self.pgid} pull of {m.oid}: absent "
                            f"here with no delete entry; not answering")
                return
        asyncio.ensure_future(
            self.osd.send_osd(m.from_osd, self.make_push(m.oid)))

    def _object_state(self, oid: str):
        """(exists, data, attrs, omap, version)"""
        try:
            data = self.osd.store.read(self.cid, oid)
            attrs = self.osd.store.getattrs(self.cid, oid)
            omap = self.osd.store.omap_get(self.cid, oid)
        except StoreError:
            return False, b"", {}, {}, eversion()
        vb = attrs.get("_v")
        ver = eversion() if not vb else eversion(
            int.from_bytes(vb[:4], "little"),
            int.from_bytes(vb[4:12], "little"))
        return True, data, attrs, omap, ver

    def make_push(self, oid: str) -> MOSDPGPush:
        exists, data, attrs, omap, ver = self._object_state(oid)
        return MOSDPGPush(
            pgid=self.cid, epoch=self.epoch, oid=oid,
            version_epoch=ver.epoch, version_v=ver.v, exists=exists,
            data=data, attrs=attrs, omap=omap,
            from_osd=self.osd.whoami)

    def apply_push(self, m: MOSDPGPush) -> bool:
        """Apply a recovery push. Returns True iff the object durably
        landed — the caller must only ack on success, because the
        primary counts an ACKED push as 'recovered' for the durability
        promotion (_promote_pending_eagain)."""
        self._clone_idx = None          # pushes can create/replace clones
        t = Transaction()
        if m.exists:
            t.remove(self.cid, m.oid)
            t.write(self.cid, m.oid, 0, m.data)
            if m.attrs:
                t.setattrs(self.cid, m.oid, m.attrs)
            if m.omap:
                t.omap_setkeys(self.cid, m.oid, m.omap)
        else:
            t.remove(self.cid, m.oid)
        span = self.osd.tracer.from_msg(
            "push_apply", m, tags={"osd": self.osd.whoami,
                                   "oid": m.oid})
        try:
            self.osd.store.queue_transaction(t)
        except StoreError as e:
            log.error(f"pg {self.pgid} push apply failed: {e}")
            if span is not None:
                span.tag("error", str(e)).finish()
            return False
        finally:
            if span is not None and not span.finished:
                span.finish()
        self.my_missing.pop(m.oid, None)
        fut = self._push_waiters.get(m.oid)
        if fut and not fut.done():
            fut.set_result(True)
        return True

    def handle_push_reply(self, m: MOSDPGPushReply) -> None:
        fut = self._push_ack_waiters.get((m.from_osd, m.oid))
        if fut and not fut.done():
            fut.set_result(True)

    async def _send_gated_pushes(self, sends) -> bool:
        """Send recovery pushes and gate 'recovered' on the peer's ACK
        (MOSDPGPushReply): counting at send time would let
        _promote_pending_eagain flip an -EAGAIN'd write to success
        while a live acting replica still lacks it. Shared by the
        replicated and EC recovery paths (they differ only in how the
        push message is built).

        sends: [(peer_osd, oid, MOSDPGPush)]. Retires acked oids from
        peer_missing; returns True (and schedules a retry) when a LIVE
        peer's push went unacked — a down peer is left to the next map
        change."""
        acks: list[tuple[int, str, asyncio.Future, object]] = []
        for o, oid, push in sends:
            fut = asyncio.get_event_loop().create_future()
            self._push_ack_waiters[(o, oid)] = fut
            # each push is its own (head-sampled) trace root: recovery
            # has no client op to hang off, but its store/apply time
            # on the target is exactly the interference perf work
            # needs to see
            span = self.osd.tracer.start_root(
                "recovery_push",
                tags={"pgid": self.cid, "oid": oid, "to_osd": o})
            push.set_trace(span)
            try:
                await self.osd.send_osd(o, push)
            except Exception as e:
                log.dout(1, f"pg {self.pgid} push {oid}->{o} "
                            f"failed: {e}")
                self._push_ack_waiters.pop((o, oid), None)
                if span is not None:
                    span.tag("send_failed", True).finish()
                continue
            acks.append((o, oid, fut, span))
        if acks:
            await asyncio.wait([f for _, _, f, _ in acks], timeout=5.0)
        incomplete = False
        for o, oid, fut, span in acks:
            self._push_ack_waiters.pop((o, oid), None)
            if span is not None:
                if not fut.done():
                    span.tag("unacked", True)
                span.finish()
            if fut.done():
                self.peer_missing.get(o, {}).pop(oid, None)
            elif self.osd.osd_is_up(o):
                incomplete = True
        if incomplete:
            log.dout(1, f"pg {self.pgid} recovery pushes unacked; "
                        "retrying")
            loop = asyncio.get_event_loop()
            loop.call_later(1.0, lambda: asyncio.ensure_future(
                self._recover()))
        return incomplete

    async def _recover(self) -> None:
        """Push every peer's missing objects (ref: run_recovery_op)."""
        if not self.is_primary():
            return
        self.state = "recovering" if any(self.peer_missing.values()) \
            else self.state
        sends = [(o, oid, self.make_push(oid))
                 for o, missing in list(self.peer_missing.items())
                 for oid in list(missing)]
        if await self._send_gated_pushes(sends):
            return
        if not any(self.peer_missing.values()) and \
                self.state in ("active", "recovering"):
            if self._maybe_start_backfill():
                return          # clean is decided when backfill ends
            if len(self.live_acting()) >= self.pool.size:
                self._mark_clean()
            else:
                self.state = "active"
            self._promote_pending_eagain()

    def _maybe_start_backfill(self) -> bool:
        """Kick the backfill driver when peering flagged targets.
        Returns True while backfill owns the clean decision."""
        if self._backfill_task is not None:
            return True
        if not self.backfill_targets:
            return False
        self._backfill_task = asyncio.ensure_future(
            self._backfill())
        return True

    def _mark_clean(self) -> None:
        """Every acting replica has every object at full size: past
        intervals are subsumed by the current one (ref: last_epoch_clean
        gating PastIntervals trimming). Every OSD that hosted the PG
        since the previous clean is told, so replica/stray instances
        trim their own copies too — otherwise a later promotion of one
        of them would block forever on intervals this clean made
        irrelevant (r4 review finding)."""
        notify = set(self.acting)
        for iv in self.past_intervals:
            notify.update(iv[2])
        notify.discard(self.osd.whoami)
        self.state = "clean"
        self.last_epoch_clean = self.epoch
        self.past_intervals = []
        try:
            self.osd.store.queue_transaction(
                self._meta_txn(Transaction()))
        except StoreError as e:
            log.error(f"pg {self.pgid} clean meta persist failed: {e}")
        from ceph_tpu_torch.osd.messages import MPGCleanNotice
        for o in notify:
            if o >= 0 and self.osd.osd_is_up(o):
                asyncio.ensure_future(self.osd.send_osd(
                    o, MPGCleanNotice(pgid=self.cid, epoch=self.epoch,
                                      from_osd=self.osd.whoami)))

    def handle_clean_notice(self, m) -> None:
        """Replica/stray half of _mark_clean's trimming."""
        if m.epoch <= self.last_epoch_clean:
            return
        self.last_epoch_clean = m.epoch
        self.past_intervals = [iv for iv in self.past_intervals
                               if iv[1] >= m.epoch]
        try:
            self.osd.store.queue_transaction(
                self._meta_txn(Transaction()))
        except StoreError as e:
            log.error(f"pg {self.pgid} clean-notice persist failed: {e}")

    # -- op execution ------------------------------------------------------
    async def queue_op(self, m: MOSDOp) -> None:
        await self.op_queue.put(m)

    def _drain_op_queue(self) -> None:
        """Release the admission-throttle slot of every queued-but-
        never-executed op (worker cancelled on primaryship loss)."""
        while True:
            try:
                m = self.op_queue.get_nowait()
            except asyncio.QueueEmpty:
                break
            cost = getattr(m, "_throttle_cost", None)
            if cost is not None:
                self.osd.client_throttle.release(cost)

    async def _op_worker(self) -> None:
        import time as _time
        try:
            while True:
                m = await self.op_queue.get()
                tracked = self.osd.op_tracker.create(
                    f"osd_op({m.src} {self.cid} {m.oid} "
                    f"tid={m.tid})")
                if not self.role_active():
                    tracked.mark_event("waiting_for_active")
                    while not self.role_active():
                        await asyncio.sleep(0.05)
                tracked.mark_event("started")
                # trace phases: "queue" (admission -> here) closes,
                # "execute" opens; _submit_write hangs the repop/store
                # children off self._active_span
                op_span = getattr(m, "_span", None)
                qspan = getattr(m, "_queue_span", None)
                if qspan is not None:
                    qspan.finish()
                self._active_span = op_span.child("execute") \
                    if op_span is not None else None
                t0 = _time.monotonic()
                try:
                    await self._execute(m)
                except Exception as e:
                    log.error(f"pg {self.pgid} op failed: {e}")
                    await self._reply(m, -5, b"", {})       # -EIO
                finally:
                    tracked.finish()
                    if self._active_span is not None:
                        self._active_span.finish()
                        self._active_span = None
                    if op_span is not None:
                        op_span.finish()
                    # per-op-class latency histogram (µs, log2
                    # buckets) — queryable tail latency even with
                    # tracing sampled out
                    cls_key = "op_w_latency_hist" if any(
                        c in MUTATING_OPS for c in m.op_codes) \
                        else "op_r_latency_hist"
                    self.osd.perf.hist_add(
                        cls_key, (_time.monotonic() - t0) * 1e6)
                    self.osd.perf.inc("ops")
                    src = str(m.src)
                    self.client_ops[src] = \
                        self.client_ops.get(src, 0) + 1
                    cost = getattr(m, "_throttle_cost", None)
                    if cost is not None:
                        self.osd.client_throttle.release(cost)
                if self.backoffs and self.role_active() and \
                        self.op_queue.qsize() <= int(self.osd.config.get(
                            "osd_pg_op_queue_cap", 512)) // 2:
                    # saturation backoffs: the queue drained — let the
                    # parked clients resend
                    self.release_backoffs()
        except asyncio.CancelledError:
            pass

    async def _reply(self, m: MOSDOp, result: int, data: bytes,
                     extra: dict) -> None:
        if m.conn is None:
            return
        try:
            await m.conn.send_message(MOSDOpReply(
                tid=m.tid, attempt=getattr(m, "attempt", 0),
                result=result, epoch=self.epoch, data=data,
                extra=json.dumps(extra) if extra else ""))
        except Exception:
            pass                          # client resends via objecter

    async def _execute(self, m: MOSDOp) -> None:
        """ref: PrimaryLogPG::execute_ctx — reads serve immediately,
        writes run the replication pipeline. Mutations are deduped by
        (client, tid) so objecter resends of an applied-but-unacked op
        (e.g. a non-idempotent DELETE) return the original result."""
        # reqid = (entity, messenger incarnation, tid) — distinct client
        # processes sharing a name must not collide
        reqid = (m.src, getattr(m.conn, "peer_session", 0), m.tid)
        if m.oid in self.my_missing:
            # a just-promoted/revived primary may not yet hold this
            # object: serving now would return -ENOENT for an existing
            # object (or mutate around missing state). Park via -EAGAIN
            # until recovery lands it (ref: PrimaryLogPG::
            # wait_for_unreadable_object).
            await self._reply(m, -11, b"", {})
            return
        mutating = {OSD_OP_WRITE, OSD_OP_WRITEFULL, OSD_OP_TRUNCATE,
                    OSD_OP_ZERO, OSD_OP_DELETE, OSD_OP_SETXATTR,
                    OSD_OP_OMAP_SET, OSD_OP_SNAPTRIM}
        if self._backfill_blocked(
                m.oid, any(c in mutating for c in m.op_codes)):
            await self._reply(m, -11, b"", {})          # -EAGAIN
            return
        if any(c in mutating for c in m.op_codes) and \
                reqid in self._reqid_results:
            # resend of an applied-but-unacked mutation: return the
            # recorded outcome, never re-execute (a DELETE replay would
            # spuriously return -ENOENT; a write would duplicate log
            # entries). ref: PrimaryLogPG::already_complete (reqids)
            # A recorded -EAGAIN means the op is applied locally but NOT
            # yet known durable: the dup keeps seeing -EAGAIN (the
            # objecter backs off and resends) until the late
            # MOSDRepOpReply or a re-peer + completed recovery promotes
            # the record to success (ref: PrimaryLogPG::already_complete
            # only short-circuits dups of committed repops). Replying
            # immediately — rather than parking the dup on the repop
            # future — keeps the serialized op worker free.
            result, extra = self._reqid_results[reqid]
            await self._reply(m, result, b"", extra)
            return
        store = self.osd.store
        cid = self.cid
        oid = m.oid
        data_out = b""
        extra: dict = {}
        t = Transaction()
        mutated = False
        deleted = False
        cow_clones: list[str] = []
        snap_seq = getattr(m, "snap_seq", 0)
        snapc = list(getattr(m, "snaps", []) or [])
        snap_id = getattr(m, "snap_id", 0)
        # filter the client's snap context against the pool's deletion
        # queue (ref: PrimaryLogPG::filter_snapc): a laggy client whose
        # context still names a deleted snap must not make the COW path
        # mint a clone covering it — the trimmer already ran for that
        # snapid and would never revisit it
        removed = self.pool.extra.get("removed_snaps")
        if removed and snapc:
            rm = set(removed)
            snapc = [s for s in snapc if s not in rm]
        # snap reads resolve once to the serving object (clone or head)
        read_oid = oid
        if snap_id:
            resolved = self._resolve_snap_read(oid, snap_id)
            if resolved is None:
                await self._reply(m, -2, b"", {})           # -ENOENT
                return
            read_oid = resolved
        born_after: list[int] = []
        # clone_overlap upkeep: (clone_name, intervals) of the newest
        # clone; data-mutating ops below subtract their ranges, and a
        # single _clover setattrs is appended after the op loop when
        # anything actually shrank (setattrs auto-creates, so writing
        # unchanged intervals back could resurrect a trimmed clone)
        overlap: tuple[str, list] | None = None
        overlap_dirty = False
        if any(c in mutating for c in m.op_codes):
            overlap = self._newest_clone_overlap(oid)
        if snap_seq and any(c in mutating for c in m.op_codes):
            # clone-on-write rides in the SAME transaction as the
            # mutation (atomic on every replica); the clone gets its own
            # log entry below so log-based recovery tracks it
            clone = self._maybe_cow(t, oid, snap_seq, snapc)
            if clone:
                cow_clones.append(clone)
                # the just-made clone (same txn) is now the newest:
                # its overlap starts at the full pre-mutation extent
                try:
                    sz = store.stat(cid, oid)
                except StoreError:
                    sz = 0
                overlap = (clone, [[0, sz]] if sz else [])
            elif not store.exists(cid, oid):
                # the object is being born after these snaps existed:
                # mark it (APPENDED after the mutation ops — a WRITEFULL
                # remove would wipe an earlier xattr) so snap reads at
                # them say -ENOENT
                born_after = sorted(s for s in snapc if s <= snap_seq)
        for code, off, length, name, data in m.unpack_ops():
            if code == OSD_OP_READ:
                try:
                    data_out = store.read(
                        cid, read_oid, off, length if length else None)
                except StoreError:
                    await self._reply(m, -2, b"", {})       # -ENOENT
                    return
            elif code == OSD_OP_STAT:
                try:
                    extra["size"] = store.stat(cid, read_oid)
                except StoreError:
                    await self._reply(m, -2, b"", {})
                    return
            elif code == OSD_OP_GETXATTR:
                try:
                    attrs = store.getattrs(cid, read_oid)
                except StoreError:
                    await self._reply(m, -2, b"", {})
                    return
                if name not in attrs:
                    await self._reply(m, -61, b"", {})      # -ENODATA
                    return
                data_out = attrs[name]
            elif code == OSD_OP_OMAP_GET:
                try:
                    omap = store.omap_get(cid, read_oid)
                except StoreError:
                    await self._reply(m, -2, b"", {})
                    return
                # name = optional key-prefix filter (ref: the role of
                # omap_get_vals' start_after/filter_prefix) — callers
                # with large omaps fetch only the range they need
                extra["omap"] = {k: v.hex() for k, v in omap.items()
                                 if not k.startswith("_")
                                 and (not name or k.startswith(name))}
            elif code == OSD_OP_PGLS:
                objs = [o for o in store.list_objects(cid)
                        if o != PGMETA and clone_head(o) is None]
                extra["objects"] = objs
            elif code == OSD_OP_WATCH:
                self._watchers.setdefault(oid, {})[(m.src, off)] = m.conn
            elif code == OSD_OP_UNWATCH:
                self._watchers.get(oid, {}).pop((m.src, off), None)
            elif code == OSD_OP_NOTIFY:
                asyncio.ensure_future(
                    self._do_notify(m, oid, off, data))
                return                      # replies when acks are in
            elif code == OSD_OP_NOTIFY_ACK:
                self.handle_notify_ack(m.src, off, length)
            elif code == OSD_OP_SNAPTRIM:
                touched = self._snaptrim(t, oid, off)
                if touched:
                    mutated = True
                    cow_clones.extend(touched)
                overlap = None      # clone set changed under us
            elif code == OSD_OP_WRITE:
                t.write(cid, oid, off, data)
                mutated = True
                if overlap:
                    overlap = (overlap[0], self._overlap_sub(
                        overlap[1], off, off + len(data)))
                    overlap_dirty = True
            elif code == OSD_OP_WRITEFULL:
                t.remove(cid, oid)
                t.write(cid, oid, 0, data)
                mutated = True
                if overlap:
                    overlap = (overlap[0], [])
                    overlap_dirty = True
            elif code == OSD_OP_TRUNCATE:
                t.truncate(cid, oid, off)
                mutated = True
                if overlap:
                    overlap = (overlap[0], self._overlap_sub(
                        overlap[1], off, None))
                    overlap_dirty = True
            elif code == OSD_OP_ZERO:
                t.zero(cid, oid, off, length)
                mutated = True
                if overlap:
                    overlap = (overlap[0], self._overlap_sub(
                        overlap[1], off, off + length))
                    overlap_dirty = True
            elif code == OSD_OP_DELETE:
                if not store.exists(cid, oid):
                    await self._reply(m, -2, b"", {})
                    return
                t.remove(cid, oid)
                mutated = True
                deleted = True
                if overlap:
                    overlap = (overlap[0], [])
                    overlap_dirty = True
            elif code == OSD_OP_SETXATTR:
                t.touch(cid, oid)
                # attrs persist past the op: copy out of the frame view
                t.setattrs(cid, oid, {name: bytes(data)})
                mutated = True
            elif code == OSD_OP_OMAP_SET:
                t.touch(cid, oid)
                t.omap_setkeys(cid, oid, {name: bytes(data)})
                mutated = True
            elif code == OSD_OP_OMAP_RM:
                if not store.exists(cid, oid):
                    await self._reply(m, -2, b"", {})
                    return
                t.omap_rmkeys(cid, oid, [name])
                mutated = True
            else:
                await self._reply(m, -95, b"", {})   # -EOPNOTSUPP
                return
        if not mutated:
            await self._reply(m, 0, data_out, extra)
            return
        if born_after and not deleted:
            t.setattrs(cid, oid,
                       {"_pre": json.dumps(born_after).encode()})
        if overlap is not None and overlap_dirty:
            # last-op-wins: this setattrs lands after _maybe_cow's
            # initial full-extent _clover in the same transaction
            t.setattrs(cid, overlap[0],
                       {"_clover": json.dumps(overlap[1]).encode()})
        result, applied, waiter = await self._submit_write(
            oid, t, deleted, reqid, extra_oids=cow_clones)
        if result == -11 and waiter is not None and waiter.done():
            # the last reply landed between the timeout firing and this
            # task resuming: the repop IS fully committed — without this
            # check the -11 would be recorded with the waiter already
            # popped, and nothing could ever promote it
            result = 0
        extra["version"] = str(self.pg_log.head)
        if applied:
            # The op is in the pg log, so a RESEND must never re-execute
            # (a DELETE replay would return -ENOENT; a write would
            # duplicate log entries) — but a repop-timeout -EAGAIN is
            # recorded AS -EAGAIN: dups keep seeing -EAGAIN until the
            # repop commits on every live acting replica (late reply) or
            # a re-peer + recovery has made the log durable on the new
            # acting set (_promote_pending_eagain). Recording 0 here
            # immediately (round 3) let a dup be acked with fewer than
            # min_size durable copies (ADVICE.md round 3, medium).
            self._reqid_results[reqid] = (result, extra)
        if len(self._reqid_results) > 2000:      # bounded (log-trim analog)
            kept_eagain = 0
            for k in list(self._reqid_results)[:1000]:
                if self._reqid_results.get(k, (0,))[0] == -11 and \
                        kept_eagain < 500:
                    # keep -EAGAIN entries awaiting promotion — but
                    # only a bounded number: a wedged replica would
                    # otherwise grow the table by one per timed-out
                    # write forever. Beyond the cap the oldest are
                    # evicted like any trimmed reqid: a later dup
                    # re-executes, which is the reference's semantics
                    # once a reqid ages out of the pg log's dup window.
                    kept_eagain += 1
                    continue
                self._reqid_results.pop(k, None)
        await self._reply(m, result, data_out, extra)

    async def _submit_write(self, oid: str, t: Transaction, deleted: bool,
                            reqid: tuple,
                            extra_oids: list[str] | None = None) -> tuple:
        """The replication pipeline (ref: ReplicatedBackend::
        submit_transaction + issue_repop). Returns (result, applied,
        waiter): ``applied`` is True iff the op landed in the local
        store+log (it may still report -EAGAIN when replicas never
        confirmed — the repop record stays registered, marked
        timed_out, so a late reply can complete it and promote the
        dedup result)."""
        if len(self.live_acting()) < self.pool.min_size:
            return -11, False, None                     # -EAGAIN
        # backfill straddle gate: one txn can touch the head AND its
        # snap clones, whose names sort far apart. For a backfill
        # target the whole txn must be send-or-skip by its watermark —
        # sending would materialize partial state for the above-
        # watermark oid, skipping would silently drop the below-
        # watermark one (the scan never revisits covered ground). A
        # straddling txn parks until the watermark moves past it.
        if self.backfill_targets:
            txn_oids = [oid] + list(extra_oids or [])
            for lb in self.backfill_targets.values():
                below = [x <= lb for x in txn_oids]
                if any(below) and not all(below):
                    return -11, False, None             # -EAGAIN
        self.last_user_version += 1
        version = eversion(self.epoch, self.last_user_version)
        entry = self.pg_log.add(
            version, oid, OP_DELETE if deleted else OP_MODIFY)
        # snap clones created/trimmed in this txn get their own log
        # entries so peering's missing computation recovers them too —
        # shipped to replicas alongside the head entry
        extra_entries = []
        for clone_oid in (extra_oids or []):
            self.last_user_version += 1
            extra_entries.append(self.pg_log.add(
                eversion(self.epoch, self.last_user_version),
                clone_oid, OP_MODIFY))
        self.pg_log.trim(keep=self._trim_keep())
        if not deleted:
            t.setattrs(self.cid, oid, {"_v":
                       version.epoch.to_bytes(4, "little") +
                       version.v.to_bytes(8, "little")})
        self._meta_txn(t)
        txn_blob = t.encode()
        replicas = [o for o in self.live_acting()
                    if o != self.osd.whoami
                    and self._should_send_repop(o, oid)]
        tid = self.osd.next_tid()
        waiter = None
        if replicas:
            waiter = asyncio.get_event_loop().create_future()
            self._repop_waiters[tid] = [set(replicas), waiter, reqid,
                                        False]
        op_span = self._active_span
        store_span = op_span.child(
            "objectstore_commit",
            tags={"osd": self.osd.whoami}) if op_span else None
        import time as _time
        _t0 = _time.monotonic()
        try:
            self.osd.store.queue_transaction(t)
        except StoreError as e:
            log.error(f"pg {self.pgid} local commit failed: {e}")
            self._repop_waiters.pop(tid, None)
            return -5, False, waiter
        finally:
            _finish_store_span(store_span, self.osd.store)
            # the `ceph osd perf` commit leg: primary-side txn commit
            # time as a reported time-avg (ref: os_commit_latency)
            self.osd.perf.avg_add("commit_latency",
                                  _time.monotonic() - _t0)
        repop_span = op_span.child(
            "repop_wait",
            tags={"replicas": sorted(replicas)}) \
            if op_span and replicas else None
        send_failed = False
        for o in replicas:
            rep = MOSDRepOp(
                tid=tid, epoch=self.epoch, pgid=self.cid,
                txn=txn_blob, log_entry=entry.encode(),
                extra_log=[e.encode() for e in extra_entries])
            rep.set_trace(repop_span)
            try:
                await self.osd.send_osd(o, rep)
            except (ConnectionError, OSError, asyncio.TimeoutError,
                    ConnectionError_) as e:
                # An unreachable replica (SIGKILLed process, dead
                # port) must NOT surface as client EIO: it is the same
                # situation as a replica that never confirms, so it
                # takes the same -EAGAIN exit below — the objecter
                # resends once the map moves and the PG re-peers.
                send_failed = True
                log.dout(1, f"pg {self.pgid} repop {tid} -> osd.{o} "
                            f"send failed: {e!r}")
        if waiter is not None and send_failed:
            ent = self._repop_waiters.get(tid)
            if ent is not None:
                ent[3] = True
            if repop_span is not None:
                repop_span.tag("send_failed", True)
                repop_span.finish()
            return -11, True, waiter                    # -EAGAIN
        if waiter is not None:
            # asyncio.wait (NOT wait_for): wait_for CANCELS the future
            # on timeout, which would make it impossible for a late
            # MOSDRepOpReply to ever complete the repop — and dups of
            # the -EAGAIN'd op would stay -EAGAIN until re-peer even
            # though every replica committed.
            done, _ = await asyncio.wait(
                [waiter],
                timeout=self.osd.config.get("osd_repop_timeout", 5.0))
            if repop_span is not None:
                if not done:
                    repop_span.tag("timed_out", True)
                repop_span.finish()
            if not done:
                # A replica never confirmed: the client MUST NOT see
                # success, or a subsequent primary failure could lose an
                # acknowledged write (ref: ReplicatedBackend's
                # all-replica-commit-before-ack contract). -EAGAIN makes
                # the objecter resend once the map moves and the PG
                # re-peers. The record stays in _repop_waiters, marked
                # timed_out: a late reply promotes the recorded dedup
                # result to success (handle_rep_reply).
                ent = self._repop_waiters.get(tid)
                if ent is not None:
                    ent[3] = True
                # bound the timed-out backlog: under a wedged-but-up
                # replica every write parks a record here; beyond the
                # cap the oldest are dropped (their dup entries age out
                # of _reqid_results the same way — reference semantics
                # once a reqid leaves the pg log's dup window)
                stale = [t_ for t_, e_ in self._repop_waiters.items()
                         if e_[3]]
                for t_ in stale[:-500]:
                    self._repop_waiters.pop(t_, None)
                log.dout(1, f"pg {self.pgid} repop {tid} timed out")
                return -11, True, waiter                # -EAGAIN
            self._repop_waiters.pop(tid, None)
        return 0, True, waiter

    def handle_rep_op(self, m: MOSDRepOp) -> None:
        """Replica applies the shipped transaction (ref:
        ReplicatedBackend::do_repop)."""
        self._clone_idx = None      # the txn may create/trim clones; a
        # later re-promotion to primary must not serve a stale index
        span = self.osd.tracer.from_msg(
            "repop_apply", m, tags={"osd": self.osd.whoami,
                                    "pgid": self.cid})
        entry = LogEntry.decode(m.log_entry)
        t = Transaction.decode(m.txn)
        store_span = span.child(
            "objectstore_commit",
            tags={"osd": self.osd.whoami}) if span else None
        import time as _time
        _t0 = _time.monotonic()
        try:
            self.osd.store.queue_transaction(t)
        except StoreError as e:
            log.error(f"pg {self.pgid} repop apply failed: {e}")
            if span is not None:
                span.tag("error", str(e)).finish()
            return
        finally:
            _finish_store_span(store_span, self.osd.store)
            # the `ceph osd perf` apply leg (ref: os_apply_latency)
            self.osd.perf.avg_add("apply_latency",
                                  _time.monotonic() - _t0)
        if span is not None:
            span.finish()
        self.pg_log.append(entry)
        for blob in getattr(m, "extra_log", None) or []:
            e2 = LogEntry.decode(blob)
            self.pg_log.append(e2)
            self.last_user_version = max(self.last_user_version,
                                         e2.version.v)
        self.pg_log.trim(keep=self._trim_keep())
        self.last_user_version = max(self.last_user_version,
                                     entry.version.v)

        async def _ack():
            try:
                # reply on the incoming connection: the replica may not
                # have seen the map naming the primary yet
                await m.conn.send_message(MOSDRepOpReply(
                    tid=m.tid, result=0, pgid=self.cid,
                    from_osd=self.osd.whoami))
            except Exception:
                pass      # primary's repop timeout covers the loss
        asyncio.ensure_future(_ack())

    def handle_rep_reply(self, m: MOSDRepOpReply) -> None:
        ent = self._repop_waiters.get(m.tid)
        if ent is None:
            return
        pending, fut, reqid, timed_out = ent
        pending.discard(m.from_osd)
        if not pending:
            if not fut.done():
                fut.set_result(True)
            self._repop_waiters.pop(m.tid, None)
            if timed_out:
                # Late completion of a timed-out repop: every live
                # acting replica has now committed, so dups of the
                # -EAGAIN'd op may see success. (If the client task has
                # not recorded the -11 yet, its waiter.done() check in
                # _execute sees the completion instead.)
                self._promote(reqid)

    def _promote(self, reqid: tuple) -> None:
        res = self._reqid_results.get(reqid)
        if res and res[0] == -11:
            self._reqid_results[reqid] = (0, res[1])

    def _promote_pending_eagain(self) -> None:
        """A re-peer + acked recovery has made every pg-log entry
        durable on the (new) live acting set — writes whose repop timed
        out in an earlier interval are now recoverable from any acting
        member, so their dedup results flip from -EAGAIN to success
        (the 'log-based recovery has made it durable' argument, gated
        on recovery pushes actually being ACKED, not merely sent).
        Only timed-out records are touched: in-flight repops of the
        current interval keep their waiters. A record whose
        never-replied replica is STILL live in the current acting set
        must NOT promote — recovery completing for older objects says
        nothing about this write, which was logged after peering and so
        was never in peer_missing (r4 review finding: promoting it
        would ack a write a live acting replica lacks)."""
        for tid, ent in list(self._repop_waiters.items()):
            if not ent[3]:                # not timed out: still in flight
                continue
            if any(r in self.acting and self.osd.osd_is_up(r)
                   for r in ent[0]):
                continue                  # wedged live replica: keep -EAGAIN
            self._repop_waiters.pop(tid, None)
            self._promote(ent[2])
            if not ent[1].done():
                ent[1].set_result(True)

    # -- backfill (ref: PrimaryLogPG's backfill state machine) -------------
    def _version_blob(self, oid: str) -> bytes:
        """The object's 12-byte ``_v`` xattr (epoch u32le + v u64le) —
        the scan digest's version token. Identical layout on replicated
        objects and EC shards, so one comparison serves both."""
        try:
            return self.osd.store.getattrs(self.cid, oid).get("_v", b"")
        except StoreError:
            return b""

    async def _build_backfill_push(self, oid: str, target: int):
        """Whole-object push for a backfill target (replicated PGs push
        the primary's byte-identical copy; ECPG overrides to rebuild
        the target POSITION's shard). None = cannot build right now."""
        return self.make_push(oid)

    async def _backfill_push_acked(self, oid: str, target: int) -> bool:
        """One throttled, ACK-gated backfill push. The QoS throttle
        (osd_recovery_max_active + osd_recovery_max_bytes) runs HERE —
        client ops never touch it, so under contention backfill queues
        behind its own budget while foreground writes flow."""
        push = await self._build_backfill_push(oid, target)
        if push is None:
            return False
        release = await self.osd.recovery_throttle.acquire(
            len(push.data))
        fut = asyncio.get_event_loop().create_future()
        self._push_ack_waiters[(target, oid)] = fut
        span = self.osd.tracer.start_root(
            "backfill_push",
            tags={"pgid": self.cid, "oid": oid, "to_osd": target})
        push.set_trace(span)
        try:
            await self.osd.send_osd(target, push)
            await asyncio.wait([fut], timeout=5.0)
            return fut.done()
        except Exception as e:
            log.dout(1, f"pg {self.pgid} backfill push {oid}->"
                        f"osd.{target} failed: {e}")
            return False
        finally:
            release()
            self._push_ack_waiters.pop((target, oid), None)
            if span is not None:
                if not fut.done():
                    span.tag("unacked", True)
                span.finish()

    async def _scan_peer(self, osd_id: int, begin: str, end: str,
                         limit: int = 0):
        """Request a peer's sorted (begin, end] object/version digest
        (ref: MOSDPGScan round trip). None on timeout/failure."""
        tid = self.osd.next_tid()
        fut = asyncio.get_event_loop().create_future()
        self._backfill_waiters[tid] = fut
        try:
            await self.osd.send_osd(osd_id, MOSDPGScan(
                pgid=self.cid, epoch=self.epoch, tid=tid, begin=begin,
                end=end, limit=limit, from_osd=self.osd.whoami))
            return await asyncio.wait_for(fut, timeout=5.0)
        except Exception:
            return None
        finally:
            self._backfill_waiters.pop(tid, None)

    async def _backfill_ctl(self, target: int, op: int,
                            watermark: str) -> bool:
        """Watermark control round trip: the target PERSISTS the new
        last_backfill before acking, so an acked PROGRESS/FINISH is a
        durable resume point (FINISH ships the authoritative log — the
        target is then log-continuous and a normal replica)."""
        tid = self.osd.next_tid()
        fut = asyncio.get_event_loop().create_future()
        self._backfill_waiters[tid] = fut
        try:
            head = self.pg_log.head
            await self.osd.send_osd(target, MOSDPGBackfill(
                pgid=self.cid, epoch=self.epoch, tid=tid, op=op,
                last_backfill=watermark,
                log=self.pg_log.encode()
                if op == BACKFILL_OP_FINISH else b"",
                at_epoch=head.epoch, at_v=head.v,
                from_osd=self.osd.whoami))
            m = await asyncio.wait_for(fut, timeout=5.0)
            return m.result == 0
        except Exception:
            return False
        finally:
            self._backfill_waiters.pop(tid, None)

    async def _reserve_remote(self, target: int) -> str:
        """'grant' | 'reject' | 'toofull' from the target's reserver."""
        tid = self.osd.next_tid()
        fut = asyncio.get_event_loop().create_future()
        self._backfill_waiters[tid] = fut
        try:
            await self.osd.send_osd(target, MBackfillReserve(
                pgid=self.cid, epoch=self.epoch, tid=tid,
                op=RESERVE_REQUEST, from_osd=self.osd.whoami))
            m = await asyncio.wait_for(fut, timeout=3.0)
            if m.op == RESERVE_GRANT:
                self._reserve_tids[target] = tid
                return "grant"
            return "toofull" if m.op == RESERVE_TOOFULL else "reject"
        except Exception:
            return "reject"
        finally:
            self._backfill_waiters.pop(tid, None)

    async def _backfill(self) -> None:
        """Primary backfill driver: reserve (local slot, then one
        remote slot per target, capped at osd_max_backfills on each
        OSD), then scan/push each target forward from its persisted
        watermark. backfill_wait = waiting on a slot; backfill_toofull
        = a target refused for fullness; backfilling = scans running."""
        # interval identity, NOT the raw epoch: map epochs advance for
        # unrelated reasons (up_thru grants, other pools) without
        # ending this interval — only an acting-set change (which bumps
        # interval_start and cancels this task anyway) invalidates us
        interval = self.interval_start
        granted_remote: list[int] = []
        try:
            self.state = "backfill_wait"
            await self.osd.local_reserver.request(self.cid)
            while True:
                if self.interval_start != interval or \
                        not self.is_primary():
                    return
                verdicts: dict[int, str] = {}
                for o in list(self.backfill_targets):
                    if self.osd.osd_is_up(o):
                        verdicts[o] = await self._reserve_remote(o)
                if not verdicts:
                    return        # every target down: the map decides
                if all(v == "grant" for v in verdicts.values()):
                    granted_remote = list(verdicts)
                    break
                for o, v in verdicts.items():
                    if v == "grant":          # don't sit on slots
                        asyncio.ensure_future(self._send_reserve_op(
                            o, RESERVE_RELEASE,
                            self._reserve_tids.get(o, 0)))
                self.state = "backfill_toofull" if "toofull" in \
                    verdicts.values() else "backfill_wait"
                await asyncio.sleep(float(self.osd.config.get(
                    "osd_backfill_retry_interval", 0.5)))
            self.state = "backfilling"
            RECOVERY_PERF.inc("backfills_started")
            for o in sorted(self.backfill_targets):
                if self.interval_start != interval or \
                        not self.is_primary():
                    return
                if self.osd.osd_is_up(o):
                    await self._backfill_one(o, interval)
            if self.interval_start != interval or \
                    not self.is_primary():
                return
            if not self.backfill_targets:
                RECOVERY_PERF.inc("backfills_completed")
            # the clean decision belongs to the ONE canonical path in
            # _recover — re-enter it after this task unwinds (the
            # finally below releases slots and clears the task pointer
            # first, so _maybe_start_backfill can restart failed
            # targets after a beat)
            self.state = "active"
            loop = asyncio.get_event_loop()
            loop.call_later(
                1.0 if self.backfill_targets else 0.0,
                lambda: asyncio.ensure_future(self._recover()))
        finally:
            # _cancel_backfill (interval change) already nulled the
            # task pointer and freed the slots — and a NEW driver may
            # have taken them by the time this cancelled frame unwinds.
            # Only the still-current task may release.
            if self._backfill_task is asyncio.current_task():
                self._backfill_task = None
                self._backfill_inflight = None
                self.osd.local_reserver.release(self.cid)
                for o in granted_remote:
                    asyncio.ensure_future(self._send_reserve_op(
                        o, RESERVE_RELEASE,
                        self._reserve_tids.get(o, 0)))

    async def _backfill_one(self, target: int, interval: int) -> bool:
        """Scan/push one target forward to MAX_OID. Every batch:
        compare the primary's sorted collection slice against the
        target's digest, push differing/missing objects (ACK-gated),
        remove target-side extras, and only THEN advance the persisted
        watermark — so a crash at any point resumes at a boundary
        where the invariant 'target holds every object <= watermark'
        still holds."""
        wm = self.backfill_targets.get(target, MIN_OID)
        if self.peer_last_backfill.get(target, MAX_OID) == MAX_OID:
            # fresh/discontinuous target: durably mark it incomplete
            # BEFORE the first scan — from here until FINISH its info
            # says 'backfill me', whatever crashes
            if not await self._backfill_ctl(target, BACKFILL_OP_RESET,
                                            MIN_OID):
                return False
            self.peer_last_backfill[target] = MIN_OID
            wm = MIN_OID
        elif wm > MIN_OID:
            self.backfill_stats["resumed_from"] = wm
        scan_max = int(self.osd.config.get("osd_backfill_scan_max", 64))
        store = self.osd.store
        while True:
            if self.interval_start != interval or \
                    not self.is_primary() or \
                    not self.osd.osd_is_up(target):
                return False
            try:
                names = sorted(
                    o for o in store.list_objects(self.cid)
                    if o != PGMETA and o > wm)
            except StoreError:
                return False
            batch = names[:scan_max]
            end = MAX_OID if len(names) <= scan_max else batch[-1]
            # block mutations over the WHOLE open range, not just the
            # snapshot: an object created in (wm, end] mid-batch would
            # be invisible to both this scan and the repop gate. Held
            # until the watermark advance lands so nothing slips into
            # the supposedly-covered region.
            self._backfill_inflight = (wm, end)
            try:
                reply = await self._scan_peer(target, wm, end)
                if reply is None:
                    return False
                theirs = dict(reply.objects)
                for oid in batch:
                    self.backfill_stats["scanned"] += 1
                    RECOVERY_PERF.inc("backfill_objects_scanned")
                    mine = self._version_blob(oid)
                    if mine and theirs.get(oid) == mine:
                        continue          # identical version: skip
                    if not await self._backfill_push_acked(oid, target):
                        return False
                    self.backfill_stats["pushed"] += 1
                    RECOVERY_PERF.inc("backfill_objects_pushed")
                for oid in sorted(set(theirs) - set(batch)):
                    # the target holds an object this primary doesn't:
                    # it was deleted past the target's horizon — the
                    # removal push (exists=False) reaps it
                    if oid == PGMETA or store.exists(self.cid, oid):
                        continue
                    if not await self._backfill_push_acked(oid, target):
                        return False
                    self.backfill_stats["removed"] += 1
                    RECOVERY_PERF.inc("backfill_objects_pushed")
                op = BACKFILL_OP_FINISH if end == MAX_OID \
                    else BACKFILL_OP_PROGRESS
                if not await self._backfill_ctl(target, op, end):
                    return False
                wm = end
                self.peer_last_backfill[target] = end
                if end != MAX_OID:
                    self.backfill_targets[target] = end
            finally:
                self._backfill_inflight = None
            if end == MAX_OID:
                self.backfill_targets.pop(target, None)
                log.dout(1, f"pg {self.pgid} backfill of osd.{target} "
                            f"complete")
                return True

    async def _backfill_self(self, src: int) -> bool:
        """Reverse backfill: THIS primary is incomplete (it was a
        backfill target when the map promoted it). Page the complete
        peer's digest and pull every object we lack or hold stale,
        advancing OUR persisted watermark; remove local objects the
        source doesn't list (deleted past our horizon). Runs inside
        peering, before any op can be served."""
        interval = self.interval_start
        scan_max = int(self.osd.config.get("osd_backfill_scan_max", 64))
        store = self.osd.store
        wm = self.last_backfill
        if wm > MIN_OID:
            self.backfill_stats["resumed_from"] = wm
        log.dout(1, f"pg {self.pgid} self-backfill from osd.{src} "
                    f"(watermark {wm!r})")
        while wm != MAX_OID:
            if self.interval_start != interval:
                return False
            reply = await self._scan_peer(src, wm, MAX_OID,
                                          limit=scan_max)
            if reply is None:
                return False
            theirs = dict(reply.objects)
            for oid in sorted(theirs):
                RECOVERY_PERF.inc("backfill_objects_scanned")
                if store.exists(self.cid, oid) and \
                        self._version_blob(oid) == theirs[oid]:
                    continue
                release = await self.osd.recovery_throttle.acquire(0)
                try:
                    await self._pull(src, oid)
                finally:
                    release()
                if self._version_blob(oid) != theirs[oid]:
                    # the pull timed out or delivered something other
                    # than the version the source listed: do NOT
                    # advance the watermark over a stale copy
                    return False
                RECOVERY_PERF.inc("backfill_objects_pushed")
            try:
                extras = [o for o in store.list_objects(self.cid)
                          if o != PGMETA and wm < o <= reply.up_to
                          and o not in theirs]
            except StoreError:
                extras = []
            for oid in extras:
                try:
                    store.queue_transaction(
                        Transaction().remove(self.cid, oid))
                    self._clone_idx = None
                except StoreError:
                    return False
            wm = reply.up_to
            self.last_backfill = wm
            # our log IS the authoritative log here (adopted in this
            # peering round), so its head is the point this watermark
            # is valid at
            self.backfill_at = self.pg_log.head
            try:
                store.queue_transaction(self._meta_txn(Transaction()))
            except StoreError as e:
                log.error(f"pg {self.pgid} self-backfill watermark "
                          f"persist failed: {e}")
                return False
        return True

    # target-side handlers --------------------------------------------------
    def handle_pg_scan(self, m: MOSDPGScan) -> None:
        out: dict[str, bytes] = {}
        up_to = m.end
        try:
            names = sorted(
                o for o in self.osd.store.list_objects(self.cid)
                if o != PGMETA and m.begin < o <= m.end)
        except StoreError:
            names = []
        if m.limit and len(names) > m.limit:
            names = names[:m.limit]
            up_to = names[-1]
        for oid in names:
            out[oid] = self._version_blob(oid)

        async def _reply():
            try:
                await m.conn.send_message(MOSDPGScanReply(
                    pgid=self.cid, tid=m.tid, from_osd=self.osd.whoami,
                    objects=out, up_to=up_to))
            except Exception:
                pass                  # requester's timeout covers it
        asyncio.ensure_future(_reply())

    def handle_scan_reply(self, m: MOSDPGScanReply) -> None:
        fut = self._backfill_waiters.get(m.tid)
        if fut and not fut.done():
            fut.set_result(m)

    def handle_backfill(self, m: MOSDPGBackfill) -> None:
        """Target half of the watermark protocol: persist BEFORE
        acking (an acked watermark must survive a crash). Messages
        from a superseded interval are dropped — a delayed/duplicated
        FINISH from a dead primary must not mark a freshly-RESET
        target complete with a stale log (the fault layer delays and
        duplicates messages by design)."""
        if m.epoch < self.interval_start:
            log.dout(1, f"pg {self.pgid} ignoring stale backfill op "
                        f"{m.op} from epoch {m.epoch} < interval "
                        f"{self.interval_start}")
            return
        result = 0
        if m.op == BACKFILL_OP_RESET:
            self.last_backfill = MIN_OID
            self.backfill_at = eversion(m.at_epoch, m.at_v)
        elif m.op == BACKFILL_OP_PROGRESS:
            self.last_backfill = m.last_backfill
            self.backfill_at = eversion(m.at_epoch, m.at_v)
        elif m.op == BACKFILL_OP_FINISH:
            if m.log:
                self.pg_log = PGLog.decode(m.log)
                self.last_user_version = max(self.last_user_version,
                                             self.pg_log.head.v)
            self.last_backfill = MAX_OID
            self.backfill_at = eversion()
        try:
            self.osd.store.queue_transaction(
                self._meta_txn(Transaction()))
        except StoreError as e:
            log.error(f"pg {self.pgid} backfill watermark persist "
                      f"failed: {e}")
            result = -5

        async def _reply():
            try:
                await m.conn.send_message(MOSDPGBackfillReply(
                    pgid=self.cid, tid=m.tid, op=m.op, result=result,
                    from_osd=self.osd.whoami))
            except Exception:
                pass
        asyncio.ensure_future(_reply())

    def handle_backfill_reply(self, m: MOSDPGBackfillReply) -> None:
        fut = self._backfill_waiters.get(m.tid)
        if fut and not fut.done():
            fut.set_result(m)

    def handle_backfill_reserve(self, m: MBackfillReserve) -> None:
        if m.op == RESERVE_REQUEST:
            if m.epoch < self.interval_start:
                return    # superseded primary: no reply, no slot leak
            if self.osd.backfill_toofull():
                verdict = RESERVE_TOOFULL
                RECOVERY_PERF.inc("reservations_toofull")
            elif self.osd.remote_reserver.try_request(self.cid):
                verdict = RESERVE_GRANT
                self._remote_grant_tid = m.tid
            else:
                verdict = RESERVE_REJECT

            async def _reply():
                try:
                    await m.conn.send_message(MBackfillReserve(
                        pgid=self.cid, epoch=self.epoch, tid=m.tid,
                        op=verdict, from_osd=self.osd.whoami))
                except Exception:
                    pass
            asyncio.ensure_future(_reply())
        elif m.op == RESERVE_RELEASE:
            if m.epoch < self.interval_start:
                return    # delayed release from a dead primary
            if m.tid and m.tid != self._remote_grant_tid:
                return    # duplicate of an ALREADY-honored release:
                #           the slot has been re-granted under a new
                #           tid in the meantime — don't free that one
            self._remote_grant_tid = 0
            self.osd.remote_reserver.release(self.cid)
        else:                             # GRANT / REJECT / TOOFULL
            fut = self._backfill_waiters.get(m.tid)
            if fut and not fut.done():
                fut.set_result(m)

    def _should_send_repop(self, peer: int, oid: str) -> bool:
        """Ongoing-write gate for backfill targets (ref: PrimaryLogPG
        should_send_op): a target holds exactly the objects <= its
        watermark, so writes at-or-below it MUST replicate (or the
        already-copied object diverges silently) and writes above it
        MUST NOT (the txn would materialize a partial object the scan
        then wrongly version-matches; the scan will copy it whole)."""
        lb = self.backfill_targets.get(peer)
        return lb is None or oid <= lb

    def _backfill_blocked(self, oid: str, mutating: bool) -> bool:
        """Degraded-object gate (ref: wait_for_unreadable_object /
        wait_for_degraded_object): ops park with -EAGAIN while (a)
        this primary's own copy is above its own watermark — it may
        not hold the object at all — or (b) the object sits in the
        batch a backfill scan is comparing RIGHT NOW (mutations only:
        a write between the version read and the watermark advance
        would be invisible to both the scan and the repop gate)."""
        if self.last_backfill != MAX_OID and oid > self.last_backfill:
            return True
        if not mutating or self._backfill_inflight is None:
            return False
        lo, hi = self._backfill_inflight
        return lo < oid <= hi

    # -- stats -------------------------------------------------------------
    def stats(self) -> dict:
        objs = [o for o in self.osd.store.list_objects(self.cid)
                if o != PGMETA] if self.cid in \
            self.osd.store.list_collections() else []
        nbytes = 0
        for o in objs:
            try:
                nbytes += self.osd.store.stat(self.cid, o)
            except StoreError:
                pass
        state = self.state
        if self.is_primary():
            live = len(self.live_acting())
            if live < self.pool.size and self.role_active():
                # also during backfill states: a SECOND replica down
                # mid-backfill is genuine under-replication monitoring
                # must see, not business-as-usual backfill
                state = f"{self.state}+undersized+degraded"
        out = {"state": state, "num_objects": len(objs),
               "num_bytes": nbytes,
               "acting": self.acting, "up": self.up,
               "last_update": str(self.pg_log.head),
               "scrub_errors": self.scrub_errors}
        if self.client_ops:
            out["num_ops"] = sum(self.client_ops.values())
            out["client_ops"] = dict(self.client_ops)
        if self.is_merge_source():
            # merge progress rides MPGStats into pg dump / status
            out["merge"] = {"pending": self.pool.pg_num_pending,
                            "target": self.pool.merge_target(
                                self.pgid.seed),
                            "ready": int(self.merge_ready())}
        if self.backfill_targets or \
                self.last_backfill != MAX_OID or \
                self.backfill_stats["pushed"] or \
                self.backfill_stats["scanned"]:
            # backfill progress rides MPGStats into `ceph status` /
            # pg dump (ref: pg_stat_t's backfill fields)
            out["backfill"] = {
                "targets": {str(o): wm for o, wm in
                            sorted(self.backfill_targets.items())},
                "last_backfill": self.last_backfill,
                **self.backfill_stats}
        return out
