"""OSD wire messages: client ops, replication sub-ops, peering,
recovery, heartbeats.

ref: src/messages/MOSDOp.h, MOSDOpReply.h, MOSDRepOp.h,
MOSDRepOpReply.h, MOSDPing.h, MOSDPGQuery/Info/Log/Push (peering +
recovery), narrowed to the op surface this framework's PG implements.

The port's copy of ``ceph_tpu/osd/messages.py``.
"""

from __future__ import annotations

from ceph_tpu_torch.msg.message import Message, register

# client op codes (ref: include/rados.h CEPH_OSD_OP_*)
OSD_OP_READ = 1
OSD_OP_WRITE = 2
OSD_OP_WRITEFULL = 3
OSD_OP_DELETE = 4
OSD_OP_STAT = 5
OSD_OP_TRUNCATE = 6
OSD_OP_ZERO = 7
OSD_OP_GETXATTR = 8
OSD_OP_SETXATTR = 9
OSD_OP_OMAP_GET = 10
OSD_OP_OMAP_SET = 11
OSD_OP_PGLS = 12           # list objects in pg (rados ls building block)
OSD_OP_OMAP_RM = 13
OSD_OP_WATCH = 14          # register a watcher (cookie in `offset`)
OSD_OP_UNWATCH = 15
OSD_OP_NOTIFY = 16         # fan payload out to watchers, await acks
OSD_OP_NOTIFY_ACK = 17     # watcher -> primary (notify_id in `offset`)
OSD_OP_SNAPTRIM = 18       # drop a snap id from the object's clones

# heartbeat ops (ref: MOSDPing::PING / PING_REPLY)
PING = 1
PING_REPLY = 2

# op codes that mutate object state — the write class pausewr/FULL
# gating and the OSD failsafe apply to (ref: MOSDOp::may_write()).
MUTATING_OPS = frozenset((
    OSD_OP_WRITE, OSD_OP_WRITEFULL, OSD_OP_TRUNCATE, OSD_OP_ZERO,
    OSD_OP_DELETE, OSD_OP_SETXATTR, OSD_OP_OMAP_SET, OSD_OP_OMAP_RM,
    OSD_OP_SNAPTRIM,
))

# MOSDOp.flags bits (ref: include/rados.h CEPH_OSD_FLAG_FULL_TRY):
# FULL_TRY makes a write to a FULL cluster / full pool fail fast with
# -ENOSPC / -EDQUOT instead of parking on the objecter's wait queue.
OSD_FLAG_FULL_TRY = 1 << 20


@register
class MOSDOp(Message):
    """One client op bundle on one object (ref: MOSDOp).

    ops: list of encoded (op u8, offset u64, length u64, name str,
    data blob) tuples — flattened here as parallel lists for the
    declarative codec."""

    TYPE = 160
    FIELDS = [
        ("tid", "u64"), ("attempt", "u32"), ("epoch", "u32"),
        ("pool", "s64"), ("seed", "u32"), ("oid", "str"),
        ("op_codes", "list:u32"), ("op_offs", "list:u64"),
        ("op_lens", "list:u64"), ("op_names", "list:str"),
        # zero-copy decode: write payloads arrive as memoryviews over
        # the wire frame and ride into np.frombuffer / the EC encode
        # carve without a host staging copy (encode side unchanged)
        ("op_datas", "list:blob_view"),
        # self-managed snap context (ref: SnapContext in MOSDOp):
        # writes carry (snap_seq, snaps) for clone-on-write; reads
        # carry snap_id (0 = head)
        ("snap_seq", "u64"), ("snaps", "list:u64"), ("snap_id", "u64"),
        # op flags (ref: MOSDOp::flags — FULL_TRY et al)
        ("flags", "u32"),
    ]

    def unpack_ops(self):
        return list(zip(self.op_codes, self.op_offs, self.op_lens,
                        self.op_names, self.op_datas))


def make_osd_op(tid: int, epoch: int, pool: int, seed: int, oid: str,
                ops: list[tuple], attempt: int = 0,
                snapc: tuple | None = None, snap_id: int = 0,
                flags: int = 0) -> MOSDOp:
    """ops: (code, offset, length, name, data) tuples.

    ``attempt`` distinguishes objecter resends of one logical op (same
    tid): the OSD echoes it so a late reply from a timed-out earlier
    attempt cannot resolve a newer attempt's waiter with a stale read
    (ref: MOSDOp::get_retry_attempt). ``snapc`` = (seq, [snap ids])
    write snap context; ``snap_id`` = read-at-snap (0 = head)."""
    seq, snaps = snapc if snapc else (0, [])
    return MOSDOp(
        tid=tid, attempt=attempt, epoch=epoch, pool=pool, seed=seed,
        oid=oid,
        op_codes=[o[0] for o in ops], op_offs=[o[1] for o in ops],
        op_lens=[o[2] for o in ops], op_names=[o[3] for o in ops],
        op_datas=[o[4] for o in ops],
        snap_seq=seq, snaps=list(snaps), snap_id=snap_id, flags=flags)


@register
class MOSDOpReply(Message):
    TYPE = 161
    FIELDS = [("tid", "u64"), ("attempt", "u32"), ("result", "s32"),
              ("epoch", "u32"),
              ("data", "blob"), ("extra", "str")]   # extra: json


@register
class MOSDRepOp(Message):
    """Primary -> replica shard write (ref: MOSDRepOp): the encoded
    ObjectStore transaction plus the pg log entry it commits."""

    TYPE = 162
    FIELDS = [("tid", "u64"), ("epoch", "u32"), ("pgid", "str"),
              ("txn", "blob"), ("log_entry", "blob"),
              # snap-clone entries committed by the same txn (kept
              # separate from log_entry for compatibility with the
              # single-entry fast path)
              ("extra_log", "list:blob")]


@register
class MOSDRepOpReply(Message):
    TYPE = 163
    FIELDS = [("tid", "u64"), ("result", "s32"), ("pgid", "str"),
              ("from_osd", "s32")]


@register
class MWatchNotify(Message):
    """Primary -> watching client: a notify fired on a watched object
    (ref: src/messages/MWatchNotify.h). The client acks with an
    OSD_OP_NOTIFY_ACK op so the notifier can collect completions."""

    TYPE = 177
    FIELDS = [("oid", "str"), ("pgid", "str"), ("notify_id", "u64"),
              ("cookie", "u64"), ("payload", "blob")]


@register
class MOSDPing(Message):
    TYPE = 180
    FIELDS = [("op", "u8"), ("from_osd", "s32"), ("epoch", "u32"),
              ("stamp", "f64")]


# -- EC sub-ops ------------------------------------------------------------

@register
class MOSDECSubOpWrite(Message):
    """Primary -> shard: this shard's chunk bytes for a stripe range
    plus object metadata (ref: MOSDECSubOpWrite / ECSubWrite)."""

    TYPE = 164
    FIELDS = [("tid", "u64"), ("epoch", "u32"), ("pgid", "str"),
              ("oid", "str"), ("first_stripe", "u64"),
              ("data", "blob"),             # n_stripes*chunk_size bytes
              ("truncate_stripes", "u64"),  # shard truncated to this
              ("size", "u64"),              # logical object size
              ("remove", "bool"),
              ("attrs", "map:str:blob"), ("omap", "map:str:blob"),
              ("omap_rm", "list:str"),
              ("log_entry", "blob")]


@register
class MOSDECSubOpWriteReply(Message):
    TYPE = 165
    FIELDS = [("tid", "u64"), ("result", "s32"), ("pgid", "str"),
              ("from_osd", "s32")]


@register
class MOSDECSubOpRead(Message):
    """Primary -> shard: read chunk bytes (ref: MOSDECSubOpRead)."""

    TYPE = 166
    FIELDS = [("tid", "u64"), ("epoch", "u32"), ("pgid", "str"),
              ("oid", "str"), ("chunk_off", "u64"),
              ("chunk_len", "u64"), ("from_osd", "s32")]


@register
class MOSDECSubOpReadReply(Message):
    # ``shard_pos``: the acting position the stored shard's bytes
    # were encoded for (the write-time _pos stamp; -1 = unstamped).
    # Readers must file the chunk under THIS position, not the
    # holder's current slot — interval shuffles can move a holder.
    TYPE = 167
    FIELDS = [("tid", "u64"), ("pgid", "str"), ("oid", "str"),
              ("exists", "bool"), ("data", "blob"),
              ("version_epoch", "u32"), ("version_v", "u64"),
              ("size", "u64"), ("from_osd", "s32"),
              ("shard_pos", "s32")]


# -- peering ---------------------------------------------------------------

@register
class MOSDPGQuery(Message):
    """Primary asks a peer for its pg info+log (ref: MOSDPGQuery →
    peer replies MOSDPGInfo)."""

    TYPE = 170
    FIELDS = [("pgid", "str"), ("epoch", "u32"), ("from_osd", "s32")]


@register
class MOSDPGInfo(Message):
    """Peer's view: last_update + full log blob (ref: MOSDPGInfo/
    MOSDPGLog merged — logs here are small enough to ship whole).
    ``notify=1`` marks an UNSOLICITED stray announcement (ref:
    MOSDPGNotify): a map change moved the PG off this OSD, and the new
    primary — possibly a fresh instance with no history — must learn
    this stray exists before activating empty. ``intervals`` ships the
    sender's past_intervals (JSON) for the primary's coverage gate.
    ``last_backfill`` is the sender's persisted backfill watermark
    (ref: pg_info_t.last_backfill) — MAX_OID on every complete
    replica; anything lower marks the sender a mid-backfill target
    whose store only holds objects <= the watermark."""

    TYPE = 171
    FIELDS = [("pgid", "str"), ("epoch", "u32"), ("from_osd", "s32"),
              ("log", "blob"), ("notify", "u8"), ("intervals", "str"),
              ("last_backfill", "str"),
              # authoritative log head at the sender's last persisted
              # watermark advance: the resume-safety token (see
              # MOSDPGBackfill)
              ("backfill_at_epoch", "u32"), ("backfill_at_v", "u64"),
              # appended (zero-fill): the sender's persisted
              # last_epoch_started (ref: pg_info_t.last_epoch_started).
              # find_best_info orders candidates by (les, head) — a
              # revived pre-failover primary whose log carries a
              # divergent entry (logged but never committed on enough
              # shards) has a HIGHER head but a LOWER les than the
              # interval that peered without it, so it can never win
              # authority back and resurrect the uncommitted write.
              ("les", "u32"),
              # appended: primary -> acting replicas at activation —
              # adopt ``les`` so a future election hears the newer
              # interval from ANY survivor, not just the old primary
              ("activate", "u8")]


@register
class MOSDPGPull(Message):
    """Primary requests a whole-object push from a peer holding the
    authoritative copy (ref: MOSDPGPull PullOp)."""

    TYPE = 174
    FIELDS = [("pgid", "str"), ("epoch", "u32"), ("oid", "str"),
              ("from_osd", "s32")]


@register
class MOSDPGPush(Message):
    """Recovery push: whole-object state at a version
    (ref: MOSDPGPush PushOp)."""

    TYPE = 172
    FIELDS = [("pgid", "str"), ("epoch", "u32"), ("oid", "str"),
              ("version_epoch", "u32"), ("version_v", "u64"),
              ("exists", "bool"), ("data", "blob"),
              ("attrs", "map:str:blob"), ("omap", "map:str:blob"),
              ("from_osd", "s32")]


@register
class MOSDPGPushReply(Message):
    TYPE = 173
    FIELDS = [("pgid", "str"), ("oid", "str"), ("from_osd", "s32")]


@register
class MOSDRepScrub(Message):
    """Primary -> replica: send your scrub map for this PG
    (ref: MOSDRepScrub)."""

    TYPE = 175
    FIELDS = [("pgid", "str"), ("tid", "u64"), ("epoch", "u32"),
              ("from_osd", "s32")]


@register
class MOSDRepScrubMap(Message):
    """Replica's scrub map: oid -> json{size, digest, omap_digest,
    version} (ref: ScrubMap)."""

    TYPE = 176
    FIELDS = [("pgid", "str"), ("tid", "u64"), ("from_osd", "s32"),
              ("scrub_map", "map:str:blob")]


@register
class MPGCleanNotice(Message):
    """Primary -> every OSD that hosted the PG since its last clean:
    the PG is clean at ``epoch``, so past intervals up to it are
    subsumed — trim them (the stray/replica half of last_epoch_clean;
    ref: the purge_strays/pg-notify machinery's role). Best-effort: a
    missed notice leaves the conservative blocking behavior."""

    TYPE = 178
    FIELDS = [("pgid", "str"), ("epoch", "u32"), ("from_osd", "s32")]


@register
class MOSDMapPing(Message):
    """Client -> OSD: which osdmap epoch do you hold? The probe behind
    the Objecter's osdmap epoch barrier (ref: upstream eviction's
    wait-for-blocklist-epoch via Objecter::wait_for_map + the OSD's
    map gate): the caller needs proof a specific OSD has OBSERVED an
    epoch, not just that the mon committed it."""

    TYPE = 181
    FIELDS = [("tid", "u64"), ("epoch", "u32")]


@register
class MOSDMapPingReply(Message):
    """OSD -> client: the osdmap epoch this OSD currently serves."""

    TYPE = 182
    FIELDS = [("tid", "u64"), ("epoch", "u32"), ("from_osd", "s32")]


# -- backfill (ref: src/messages/MOSDPGScan.h + MOSDPGBackfill.h) ----------

@register
class MOSDPGScan(Message):
    """Backfill collection scan request (ref: MOSDPGScan GET_DIGEST):
    list your sorted object names in (begin, end] with their versions.
    ``end`` == MAX_OID means unbounded; ``limit`` > 0 pages the reply
    (the sender advances ``begin`` to the reply's ``up_to``)."""

    TYPE = 183
    FIELDS = [("pgid", "str"), ("epoch", "u32"), ("tid", "u64"),
              ("begin", "str"), ("end", "str"), ("limit", "u32"),
              ("from_osd", "s32")]


@register
class MOSDPGScanReply(Message):
    """Scan digest (ref: MOSDPGScan DIGEST / BackfillInterval):
    oid -> 12-byte version blob (epoch u32le + v u64le, the _v xattr
    layout). ``up_to`` is the exclusive-upper bound actually covered:
    every object the sender holds in (begin, up_to] is listed — MAX_OID
    when the collection is exhausted."""

    TYPE = 184
    FIELDS = [("pgid", "str"), ("tid", "u64"), ("from_osd", "s32"),
              ("objects", "map:str:blob"), ("up_to", "str")]


BACKFILL_OP_RESET = 1      # primary -> target: you are a backfill
#                            target; persist last_backfill = MIN
BACKFILL_OP_PROGRESS = 2   # primary -> target: watermark advanced
BACKFILL_OP_FINISH = 3     # primary -> target: complete; adopt the
#                            shipped log, persist last_backfill = MAX


@register
class MOSDPGBackfill(Message):
    """Backfill watermark control (ref: MOSDPGBackfill PROGRESS/
    FINISH): the target persists ``last_backfill`` so a restart
    resumes the scan instead of starting over. FINISH additionally
    carries the primary's pg log so the target's log is continuous
    with the authoritative history it now fully holds."""

    TYPE = 185
    FIELDS = [("pgid", "str"), ("epoch", "u32"), ("tid", "u64"),
              ("op", "u8"), ("last_backfill", "str"), ("log", "blob"),
              # the authoritative head this watermark is valid AT: on
              # rejoin, resuming from the watermark is only sound if
              # the authoritative log is still continuous with this
              # point (everything that changed below the watermark
              # since is then derivable from the retained log); else
              # the target must rescan from MIN
              ("at_epoch", "u32"), ("at_v", "u64"),
              ("from_osd", "s32")]


@register
class MOSDPGBackfillReply(Message):
    TYPE = 186
    FIELDS = [("pgid", "str"), ("tid", "u64"), ("op", "u8"),
              ("result", "s32"), ("from_osd", "s32")]


RESERVE_REQUEST = 1
RESERVE_GRANT = 2
RESERVE_REJECT = 3         # no free slot: retry later (backfill_wait)
RESERVE_TOOFULL = 4        # target past its full ratio (backfill_toofull)
RESERVE_RELEASE = 5


@register
class MBackfillReserve(Message):
    """Remote backfill reservation (ref: MBackfillReserve + the OSD's
    AsyncReserver): the primary holds a LOCAL slot and asks each
    target for a REMOTE slot before scanning, capping concurrent
    backfills per OSD at osd_max_backfills."""

    TYPE = 187
    FIELDS = [("pgid", "str"), ("epoch", "u32"), ("tid", "u64"),
              ("op", "u8"), ("from_osd", "s32")]


@register
class MOSDPGRepair(Message):
    """Mon -> acting primary: run a repair scrub on this PG (ref: the
    mon's `ceph pg repair` -> MOSDScrub(repair=true) path)."""

    TYPE = 188
    FIELDS = [("pgid", "str"), ("epoch", "u32"), ("from_osd", "s32")]


# -- client backoff (ref: src/messages/MOSDBackoff.h) ----------------------

BACKOFF_OP_BLOCK = 1       # osd -> client: stop sending ops for range
BACKOFF_OP_ACK_BLOCK = 2   # client -> osd: block acknowledged
BACKOFF_OP_UNBLOCK = 3     # osd -> client: resume (client resends)


@register
class MOSDBackoff(Message):
    """OSD -> client flow control (ref: MOSDBackoff + the PG Backoff
    machinery): when a PG is not yet active (peering) or its op queue
    is saturated, the primary BLOCKs the [begin, end) object-name
    range of that PG instead of queueing unboundedly. The Objecter
    parks matching ops and resumes on UNBLOCK — re-asserted across
    interval changes, released on activation. ``id`` pairs an UNBLOCK
    with its BLOCK."""

    TYPE = 189
    FIELDS = [("op", "u8"), ("id", "u64"), ("pool", "s64"),
              ("seed", "u32"), ("begin", "str"), ("end", "str"),
              ("epoch", "u32"), ("from_osd", "s32")]
