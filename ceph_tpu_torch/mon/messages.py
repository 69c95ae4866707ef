"""Monitor wire messages.

ref: src/messages/MMonElection.h, MMonPaxos.h, MMonCommand.h,
MMonSubscribe.h, MOSDBoot.h, MOSDFailure.h, MOSDMap.h — the control
plane's message set, declared with the msg field-spec codecs.

The port's copy of ``ceph_tpu/mon/messages.py``.
"""

from __future__ import annotations

from ceph_tpu_torch.msg.message import Message, register

# election ops (ref: MMonElection::OP_*)
ELECTION_PROPOSE = 1
ELECTION_ACK = 2
ELECTION_VICTORY = 3

# paxos ops (ref: MMonPaxos::OP_*)
PAXOS_COLLECT = 1
PAXOS_LAST = 2
PAXOS_BEGIN = 3
PAXOS_ACCEPT = 4
PAXOS_COMMIT = 5
PAXOS_LEASE = 6
PAXOS_CATCHUP = 7


@register
class MMonElection(Message):
    TYPE = 100
    FIELDS = [("op", "u8"), ("epoch", "u32"), ("rank", "s32"),
              ("quorum", "list:s32")]


@register
class MMonPaxos(Message):
    TYPE = 110
    FIELDS = [
        ("op", "u8"),
        ("pn", "u64"),
        ("last_committed", "u64"),
        ("version", "u64"),            # value version for begin/commit
        ("value", "blob"),             # encoded store txn ('' if none)
        ("uncommitted_pn", "u64"),     # LAST: pn of carried uncommitted
        ("extra", "map:u64:blob"),     # LAST/share: missing commits
    ]


@register
class MMonProposeForward(Message):
    """Peon -> leader: a service proposal forwarded for commit
    (ref: src/messages/MForward.h, narrowed to store txns)."""

    TYPE = 111
    FIELDS = [("service", "str"), ("value", "blob")]


@register
class MMonCommand(Message):
    TYPE = 120
    FIELDS = [("tid", "u64"), ("cmd", "str"), ("inbl", "blob")]


@register
class MMonCommandAck(Message):
    TYPE = 121
    FIELDS = [("tid", "u64"), ("retcode", "s32"), ("rs", "str"),
              ("outbl", "blob")]


@register
class MMonSubscribe(Message):
    """what -> start epoch (ref: MMonSubscribe::what)."""

    TYPE = 122
    FIELDS = [("what", "map:str:str")]


@register
class MMonMap(Message):
    """monmap blob: the mon addresses (ref: MMonMap). ``epoch`` (round
    6, appended) duplicates the blob's epoch so a subscriber can gate
    on it without decoding — the monmap is a versioned paxos artifact
    now (MonmapMonitor) and clients FOLLOW it: a removed mon's address
    stops being dialed, a rotated mon set doesn't strand clients."""

    TYPE = 123
    FIELDS = [("monmap", "blob"), ("epoch", "u64")]


@register
class MOSDBoot(Message):
    TYPE = 140
    FIELDS = [("osd", "s32"), ("addr_host", "str"), ("addr_port", "u32"),
              ("hb_port", "u32"), ("boot_epoch", "u32")]


@register
class MOSDFailure(Message):
    """ref: MOSDFailure — reporter accuses target of being unreachable.
    ``alive=1`` is the cancellation (ref: OSD::send_still_alive /
    MOSDFailure::FLAG_ALIVE): the reporter heard the target again
    within grace, so the mon must drop that reporter's accusation."""

    TYPE = 141
    # reporter survives peon->leader forwarding (msg.src gets rewritten
    # to the forwarding mon at each messenger hop)
    FIELDS = [("target", "s32"), ("failed_for", "u32"), ("epoch", "u32"),
              ("reporter", "str"), ("alive", "u8")]


@register
class MOSDAlive(Message):
    """Target refutes a failure report (ref: MOSDAlive/implicit via boot)."""

    TYPE = 142
    FIELDS = [("osd", "s32"), ("epoch", "u32")]


@register
class MOSDMap(Message):
    """Map publication: incrementals keyed by epoch, or a full map for
    far-behind subscribers (ref: MOSDMap::incremental_maps/maps)."""

    TYPE = 143
    FIELDS = [("fsid", "str"), ("incrementals", "map:u64:blob"),
              ("full", "map:u64:blob")]


@register
class MMonGetOSDMap(Message):
    TYPE = 144
    FIELDS = [("start_epoch", "u32")]


@register
class MOSDMarkMeDown(Message):
    """OSD -> mon on graceful shutdown (ref: MOSDMarkMeDown): commit
    my down state in the next incremental instead of burning a full
    heartbeat-grace period of client timeouts. The OSD observes the
    committed map (its subscription stays live while stopping) as the
    ack before it exits. Honored even under ``nodown`` — the flag
    suppresses failure-report markdowns, not an explicit request."""

    TYPE = 146
    FIELDS = [("osd", "s32"), ("epoch", "u32")]


@register
class MDSBeacon(Message):
    """MDS -> mon liveness + state-request beacon (ref:
    src/messages/MMDSBeacon.h). ``state`` is the daemon's CURRENT
    state; when it differs from the FSMap's recorded state and is a
    legal ladder step the MDSMonitor commits it. ``ident`` is the
    incarnation's RADOS entity name — the blocklist fence at failover
    targets it. ``epoch`` is the fsmap epoch the daemon has observed
    (a far-behind daemon gets a fresh publish).

    Round 7 (appended, zero-filled for old construction sites):
    ``ops`` is the cumulative count of client requests this
    incarnation has served and ``subtree_ops`` the same count keyed by
    load-tracking prefix (the owning subtree root, or the depth-1
    directory for paths under "/") — the per-rank load signal the
    MDSMonitor's rebalancer consumes (ref: the mds_load_t each beacon
    carries upstream)."""

    TYPE = 147
    FIELDS = [("gid", "u64"), ("name", "str"), ("ident", "str"),
              ("addr_host", "str"), ("addr_port", "u32"),
              ("state", "str"), ("seq", "u64"), ("epoch", "u64"),
              ("ops", "u64"), ("subtree_ops", "map:str:u64"),
              # round 9 (appended, zero-filled): completed trace spans
              # piggybacked monward — each blob one JSON span dict
              # (utils.tracing.Span.dump)
              ("trace_spans", "list:blob")]


@register
class MMDSMap(Message):
    """FSMap publication to mdsmap subscribers (ref:
    src/messages/MMDSMap.h): the full encoded FSMap — it is small
    (a handful of daemons), so no incremental tier."""

    TYPE = 148
    FIELDS = [("epoch", "u64"), ("fsmap", "blob")]


@register
class MPGStats(Message):
    """OSD -> mon pg stat report (ref: src/messages/MPGStats.h);
    per-pg stats as an encoded blob map keyed by 'pool.seed'.
    ``slow_ops`` piggybacks the daemon's OpTracker slow-op count so
    the mon can raise a SLOW_OPS health warning (ref: the osd_perf /
    health_check path upstream routes through the mgr).
    ``used_bytes``/``capacity_bytes`` are the daemon's statfs (ref:
    osd_stat_t::statfs riding MPGStats): the mon aggregates them into
    per-OSD utilization and derives NEARFULL/FULL state + the cluster
    FULL flag. capacity 0 = unbounded store, fullness not tracked.
    ``trace_spans`` (round 9, appended) piggybacks the daemon's
    completed trace spans so the mon's pool — and through it the mgr
    TracingModule — can reassemble cross-daemon traces without a new
    report channel. ``peer_latency`` (round 11, appended) piggybacks
    the daemon's per-peer heartbeat round-trip EWMAs (osd -> µs) —
    the raw material of the mon's gray-failure slow-score sweep."""

    TYPE = 145
    FIELDS = [("osd", "s32"), ("epoch", "u32"),
              ("stats", "map:str:blob"), ("slow_ops", "u32"),
              ("used_bytes", "u64"), ("capacity_bytes", "u64"),
              ("trace_spans", "list:blob"),
              ("peer_latency", "map:str:u64"),
              # round 14 (appended, zero-filled for pre-devmon blobs):
              # the daemon's cumulative device-runtime view — kernel-
              # path checks/mismatches, launches by engine, jit
              # compile count/ms, transfer bytes (all u64) — plus the
              # backend name. Per-report deltas drive the mon's
              # KERNEL_PATH_DEGRADED sweep + `device-runtime status`.
              ("device_health", "map:str:u64"),
              ("device_engine", "str")]


@register
class MLog(Message):
    """Daemon -> mon clog entry (ref: src/messages/MLog.h /
    LogClient): one cluster-log line, paxos-ordered by the LogMonitor
    and surfaced by `ceph log last`."""

    TYPE = 149
    FIELDS = [("name", "str"), ("level", "str"), ("msg", "str"),
              ("stamp", "f64")]


@register
class MAuthUpdate(Message):
    """AuthMonitor key publication to ``keyring`` subscribers (ref:
    the role of cephx ticket/rotating-key distribution in MAuth /
    MAuthReply): entity -> secret, an EMPTY secret meaning revoked.
    The table is filtered per subscriber — daemons (mon./osd./mds./
    mgr.) get the full table, a client only its own entry — so a
    client subscription can never exfiltrate another entity's key.
    ``caps`` (round 11, appended) carries each entity's cap table
    (JSON per entity, same filtering) so the OSD's per-op admission
    check works off the committed table; pre-caps blobs decode with
    an empty map per the zero-fill append discipline."""

    TYPE = 150
    FIELDS = [("version", "u64"), ("keys", "map:str:blob"),
              ("caps", "map:str:str")]


@register
class MMDSMigrationDone(Message):
    """Exporting MDS -> mon: the two-phase subtree handoff of ``path``
    from rank ``from_rank`` to ``to_rank`` finished its export/import
    exchange (caps + completed-request tables landed durably on the
    importer, which acked). The mon answers by COMMITTING the
    authority flip — rewriting the FSMap subtree map and clearing the
    migration entry — which is the only point authority actually
    moves (ref: the MExportDirFinish/subtree-map commit pairing in
    upstream's Migrator, collapsed onto the mon's paxos commit).
    Re-sent until the sender observes the flipped fsmap, so a lost
    report or mon leader change cannot strand a frozen subtree."""

    TYPE = 152
    FIELDS = [("gid", "u64"), ("path", "str"), ("from_rank", "s32"),
              ("to_rank", "s32")]


@register
class MTraceReport(Message):
    """Client -> mon trace-span shipment (the piggyback gap-filler:
    OSDs ride MPGStats and MDSes ride MDSBeacon, but a client has no
    periodic report — the objecter flushes its tracer's ship queue
    through this instead). Fire-and-forget, leader-forwarded like the
    other daemon reports; each blob is one JSON span dict."""

    TYPE = 153
    FIELDS = [("daemon", "str"), ("spans", "list:blob")]


@register
class MMgrBeacon(Message):
    """Mgr -> mon liveness beacon (ref: src/messages/MMgrBeacon.h):
    the MgrMonitor turns beacons into the committed MgrMap — the first
    available mgr becomes ACTIVE, later ones standbys, and a silent
    active is failed after ``mgr_beacon_grace`` with a standby
    promoted in the same commit. ``gid`` is the incarnation id (a
    restarted mgr is a NEW gid, so a zombie's late beacons can never
    re-claim the active slot); ``available`` means the daemon is ready
    to serve if named active; ``epoch`` is the mgrmap epoch the daemon
    has observed (a far-behind daemon gets a fresh publish)."""

    TYPE = 154
    # "beacon_seq", not "seq": Message.seq is the transport frame
    # counter and would overwrite a payload field of that name on send
    FIELDS = [("gid", "u64"), ("name", "str"), ("addr_host", "str"),
              ("addr_port", "u32"), ("available", "u8"),
              ("beacon_seq", "u64"), ("epoch", "u64")]


@register
class MMgrMap(Message):
    """MgrMap publication to ``mgrmap`` subscribers (ref:
    src/messages/MMgrMap.h): the full encoded MgrMap — it is tiny
    (one active + a handful of standbys), so no incremental tier.
    Daemons follow it to find the active mgr for their perf-counter
    report sessions; a new epoch naming a different active is the
    signal to re-open (and re-send the counter schema)."""

    TYPE = 155
    FIELDS = [("epoch", "u64"), ("mgrmap", "blob")]


@register
class MMgrDigest(Message):
    """Active mgr -> mon digest (ref: src/messages/MMonMgrReport.h —
    the reverse leg of the telemetry plane): the ProgressModule's
    event list and the per-OSD commit/apply latency table derived from
    reported counters, shipped every progress tick so the mon can
    serve `ceph progress ls/json`, the status ``progress`` block and
    `ceph osd perf` without holding any counter state itself. Pooled
    IN MEMORY on the leader (never paxos — it is derived state the
    next tick re-sends), so a mon leader change self-heals on the
    following digest."""

    TYPE = 156
    FIELDS = [("name", "str"), ("gid", "u64"), ("progress", "blob"),
              ("osd_perf", "blob")]


@register
class MCrashReport(Message):
    """Daemon -> mon crash report (round 14; ref: the ceph-crash ->
    crash-module posting pipeline): a daemon's top-level task
    exception hook ships a BOUNDED report (exception repr, capped
    traceback, daemon identity, wall stamp) the moment a long-lived
    loop dies with a real exception — the silent half-alive daemon
    becomes `ceph crash ls` + a RECENT_CRASH health warning until
    acknowledged (`ceph crash archive`). Fire-and-forget and
    leader-forwarded like every other daemon report; pooled IN MEMORY
    (bounded) on the leader — crash evidence is observability, never
    a paxos artifact."""

    TYPE = 159
    FIELDS = [("daemon", "str"), ("crash_id", "str"),
              ("exception", "str"), ("traceback", "str"),
              ("stamp", "f64")]


@register
class MOSDPGReadyToMerge(Message):
    """Source-PG primary -> mon (ref: src/messages/MOSDPGReadyToMerge.h):
    this merge-source PG (seed >= pool.pg_num_pending) is clean,
    co-located with its fold target, and QUIESCED (new client ops are
    backed off). The mon commits the pg_num decrease only once every
    source of the pool has reported ready — the readiness barrier that
    makes the fold a consistent local collection move. Re-sent every
    stats tick while the merge is pending, so a mon leader change
    cannot lose the barrier state."""

    TYPE = 151
    FIELDS = [("pgid", "str"), ("epoch", "u32"), ("from_osd", "s32"),
              ("pending", "u32")]


@register
class MConfigMap(Message):
    """Mon -> daemon (ref: src/messages/MConfig.h): the full central
    config db at a version, published over the `config` subscription
    after every ConfigMonitor commit. ``cfgmap`` is the JSON-encoded
    ``{who: {name: raw-str}}`` mask map — full-map (not delta) so a
    daemon that missed versions applies one message and is current,
    and so `config rm` is visible as absence (round 18)."""

    TYPE = 190
    FIELDS = [("version", "u64"), ("cfgmap", "blob")]
