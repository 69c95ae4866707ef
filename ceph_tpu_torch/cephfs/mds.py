"""The MDS daemon: metadata authority + client capabilities.

ref: src/mds/ (MDSDaemon, Server::handle_client_request, Locker's cap
machinery, MDLog/EUpdate journaling) + src/messages/MClientRequest.h /
MClientReply.h / MClientCaps.h — rebuilt small on this framework's
messenger. The division of labor is the reference's:

- ALL namespace mutations flow through the MDS, which journals each
  one to a metadata-pool journal object before applying it to the
  dirfrag omap objects (the same on-disk model ``CephFSLite`` uses —
  an MDS restart replays uncommitted journal events idempotently, the
  EUpdate/MDLog pattern in miniature).
- File DATA I/O never touches the MDS: clients read/write the
  ``.file<path>`` RADOS objects directly — but only while holding a
  file capability granted by the MDS.

Capabilities (ref: Locker, simplified to the file caps that matter at
this scope): ``CAP_FR`` is shared-read, ``CAP_FW`` is exclusive-write.
A conflicting open triggers revoke messages to the current holders;
the grant is withheld until every holder acks (writers flush before
acking), which is exactly the reference's revoke/ack dance. Sessions
(ref: MClientSession) gate everything; closing a session drops its
caps and wakes any waiter blocked on them.

Cap leases: clients heartbeat SESSION_RENEW; a holder whose
lease lapses while a revoke is outstanding is EVICTED (session + caps
dropped, its revoke waiters resolved) so a dead client cannot hold
exclusivity hostage — the Session::last_cap_renew + stale-eviction
behavior in miniature.

High availability (ref: MDSMonitor + MDSMap): an MDS started
through :meth:`MDSDaemon.create` runs **mon-coordinated**: it owns a
per-incarnation RADOS identity (``mds.<name>.<gid>`` — the blocklist
fence at failover targets exactly this incarnation), beacons the
MDSMonitor every ``mds_beacon_interval``, and climbs the failover
ladder the FSMap assigns it:

    standby -> (standby_replay) -> replay -> reconnect -> rejoin -> active

Sessions live in a persistent **session table** (``.mds_sessions``
omap, ref: SessionMap) with each session's recently completed request
tids, so a promoted standby reconstructs who was mounted, accepts
MClientReconnect cap claims from those clients, and dedups replayed
mutations. Before touching the journal the new active barriers on
``last_failure_osd_epoch`` — the osdmap epoch of its predecessor's
blocklist — so a fenced zombie can never land a late journal write.

Multi-active (ref: the Migrator + MDBalancer + the subtree
map): up to ``max_mds`` ranks serve disjoint namespace subtrees. Each
rank owns a PER-RANK journal + session table (``journal_oid(rank)`` /
``sessions_oid(rank)``), requests for a subtree another rank owns are
redirected with -ESTALE (payload names the owner), and subtree
authority moves between live ranks through a two-phase migration:
freeze + drain -> journaled handoff marker -> caps/completed-table
export (the importer persists them BEFORE acking) -> mon-committed
subtree-map flip -> unfreeze/redirect. Authority only ever moves in
the mon's paxos commit, so a crash on either side leaves the subtree
where it was, and the transferred completed-request tables keep
mutation replay exactly-once across the handoff.

Snapshots are snaprealms (``mkdir <dir>/.snap/<name>``): a
point-in-time capture of the namespace under the realm root, whose file
data the OSDs keep by COW clones; everything under ``.snap`` is
read-only (-EROFS).

Not rebuilt: the full inode lock matrix, cross-rank rename (-EXDEV;
route both paths to one rank).

The port's copy of ``ceph_tpu/cephfs/mds.py``. ``MDSDaemon.create``
takes ``device=`` for the ``Rados`` it owns (CUDA unless ``"cpu"``; it
raises without a card), so the maps it follows decode there and its
placement lookups map by ``crush_straw2`` on the card; the journal,
session table, caps and snaprealms are host state. The seven messages
registered here are the reference's on the wire, so a client of either
package talks to an MDS of the other.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import time

from ceph_tpu_torch.cephfs import CephFSLite, FSError, _fileobj, _norm
from ceph_tpu_torch.cephfs.fsmap import (
    FSMap, STATE_ACTIVE, STATE_RECONNECT, STATE_REJOIN, STATE_REPLAY,
    STATE_STANDBY, STATE_STANDBY_REPLAY, STATE_STOPPED,
)
from ceph_tpu_torch.mon.messages import MDSBeacon, MMDSMap, MMDSMigrationDone
from ceph_tpu_torch.msg import Dispatcher, Messenger
from ceph_tpu_torch.msg.message import Message, register
from ceph_tpu_torch.utils.locks import KeyedLocks
from ceph_tpu_torch.utils.logging import get_logger
from ceph_tpu_torch.utils.perf_counters import PerfCountersBuilder

log = get_logger("mds")

SESSION_OPEN = 1
SESSION_CLOSE = 2
SESSION_RENEW = 3   # client heartbeat keeping its cap lease alive
                    # (ref: CEPH_SESSION_REQUEST_RENEWCAPS)

CAP_FR = 1          # shared read
CAP_FW = 2          # exclusive write

CAP_OP_GRANT = 1    # mds -> client (unsolicited would go here; unused)
CAP_OP_REVOKE = 2   # mds -> client: stop using this cap, then ack
CAP_OP_ACK = 3      # client -> mds: revoke done (writers flushed)
CAP_OP_RELEASE = 4  # client -> mds: voluntary drop (file close)

RECONNECT_REQ = 1     # client -> mds: session + cap claims
RECONNECT_ACK = 2     # mds -> client: session restored, caps replayed
RECONNECT_REJECT = 3  # mds -> client: unknown session; re-mount

JOURNAL_OID = ".mds_journal"
SESSIONS_OID = ".mds_sessions"   # session table (ref: SessionMap)
REALMS_OID = ".mds_realms"       # snaprealm table (ref: SnapRealm
                                 # state in the mdlog, persisted flat)


def journal_oid(rank: int) -> str:
    """Per-rank journal object (rank 0 keeps the legacy name so every
    pre-multi-active store and test reads unchanged)."""
    return JOURNAL_OID if rank <= 0 else f"{JOURNAL_OID}.{rank}"


def sessions_oid(rank: int) -> str:
    return SESSIONS_OID if rank <= 0 else f"{SESSIONS_OID}.{rank}"


def realms_oid(rank: int) -> str:
    return REALMS_OID if rank <= 0 else f"{REALMS_OID}.{rank}"


SNAPDIR = ".snap"   # the magic snapshot directory component
EROFS = -30         # writes through .snap / under a snapshot path


def snap_split(path: str) -> tuple[str, str, str] | None:
    """Decompose a normalized path that traverses the magic ``.snap``
    directory (ref: the CEPH_SNAPDIR inode): returns
    ``(realm_root, snap_name, rest)`` or None for ordinary paths.

        /d/.snap           -> ("/d", "",   "")
        /d/.snap/s1        -> ("/d", "s1", "")
        /d/.snap/s1/a/f    -> ("/d", "s1", "a/f")
        /.snap/s1          -> ("/",  "s1", "")

    Only the FIRST .snap component is magic — a second one inside
    ``rest`` is simply a name that cannot exist (capture never records
    one)."""
    parts = path.split("/")
    if SNAPDIR not in parts:
        return None
    i = parts.index(SNAPDIR)
    root = "/".join(parts[:i]) or "/"
    name = parts[i + 1] if len(parts) > i + 1 else ""
    rest = "/".join(parts[i + 2:])
    return root, name, rest


# -ESTALE: the reply code a rank answers with for a path it does not
# own — payload carries {"rank": owner, "path": subtree_root} so the
# client re-targets without waiting for the next fsmap publish (ref:
# the CDIR_AUTH forward / MClientRequest forwarding upstream)
ESTALE = -116
EXDEV = -18      # cross-rank rename: not supported at this scope

# ops whose replay after failover must be deduplicated by (client, tid)
# — the completed-request table the reference keeps per Session
MUTATING_OPS = frozenset(
    ("mkdir", "rmdir", "create", "unlink", "rename", "setattr"))

# completed tids retained per session (bounds the table entry)
COMPLETED_KEEP = 64

# per-incarnation gid source: process-monotonic so a restarted daemon
# is a NEW entity the FSMap tombstones can never confuse with its
# predecessor (ref: mds_gid_t allocation in the mon, moved daemon-side
# since incarnations here are in-process objects)
_GID = itertools.count(1)

# process-wide MDS failover counters (exported via `perf dump` and the
# mgr prometheus module's generic ceph_perf rows)
MDS_PERF = (
    PerfCountersBuilder("mds")
    .add_u64_counter("beacons_sent", "MDSBeacons sent to the mon")
    .add_u64_counter("state_transitions", "failover-ladder rungs taken")
    .add_u64_counter("takeovers", "rank takeovers begun (replay)")
    .add_u64_counter("journal_replays", "journal replay passes")
    .add_u64_counter("reconnect_accepted",
                     "client sessions restored via MClientReconnect")
    .add_u64_counter("reconnect_rejected",
                     "reconnect claims refused (unknown session)")
    .add_u64_counter("sessions_dropped",
                     "recovering sessions that never reconnected")
    .add_u64_counter("caps_replayed", "caps reinstated from claims")
    .add_u64_counter("standby_replay_polls",
                     "standby-replay journal/session tail polls")
    .add_u64_counter("subtrees_exported",
                     "subtree handoffs completed as the exporter")
    .add_u64_counter("subtrees_imported",
                     "subtree handoffs completed as the importer")
    .add_u64_counter("redirects_sent",
                     "-ESTALE redirects to the owning rank")
    # the metadata op class of the per-op-class latency histograms
    # (read/write live on the OSD): microseconds, log2 buckets,
    # rendered as le-bucketed series by the prometheus module
    .add_histogram("req_latency_hist",
                   "client metadata op latency, microseconds "
                   "(log2 buckets)")
    .create_perf_counters()
)


@register
class MClientSession(Message):
    """ref: MClientSession (REQUEST_OPEN/REQUEST_CLOSE + ack)."""
    TYPE = 220
    FIELDS = [("op", "u32"), ("cseq", "u64")]


@register
class MClientRequest(Message):
    """ref: MClientRequest — one metadata op. ``op`` is the lowercase
    op name (mkdir/rmdir/readdir/stat/create/unlink/rename/open/
    setattr); path2 = rename target; flags = cap mode for open,
    size for setattr."""
    TYPE = 221
    FIELDS = [("tid", "u64"), ("op", "str"), ("path", "str"),
              ("path2", "str"), ("flags", "u64")]


@register
class MClientReply(Message):
    """ref: MClientReply. result <= 0 errno; payload = op-specific
    JSON; cap_mode/cap_seq set for open replies."""
    TYPE = 222
    FIELDS = [("tid", "u64"), ("result", "s64"), ("payload", "blob"),
              ("cap_mode", "u32"), ("cap_seq", "u64")]


@register
class MClientCaps(Message):
    """ref: MClientCaps — both directions (op disambiguates)."""
    TYPE = 223
    FIELDS = [("op", "u32"), ("path", "str"), ("mode", "u32"),
              ("cseq", "u64")]


@register
class MMDSExportDir(Message):
    """Exporting rank -> importing rank: the payload half of a subtree
    handoff (ref: MExportDir + the cap/session state MExportDirPrep
    carries). The subtree's NAMESPACE needs no copying — dirfrags are
    shared RADOS objects — so what moves is serving state: ``caps``
    maps path -> JSON {holders: {client: [mode, count]}} for every cap
    under the subtree, and ``completed`` maps client -> JSON
    {tid: result} (the completed-request tables), which the importer
    persists to ITS session table BEFORE acking — the durability step
    that keeps mutation replay exactly-once across the handoff."""
    TYPE = 225
    FIELDS = [("path", "str"), ("from_rank", "s32"),
              ("to_rank", "s32"), ("cap_seq", "u64"),
              ("caps", "map:str:blob"), ("completed", "map:str:blob"),
              # snaprealms rooted under the subtree (appended,
              # zero-fills on old corpus): str(snapid) -> realm JSON;
              # the importer persists them to ITS realm table before
              # acking, so .snap keeps serving after authority flips
              ("realms", "map:str:blob")]


@register
class MMDSExportDirAck(Message):
    """Importing rank -> exporting rank: state merged AND persisted;
    the exporter may report MMDSMigrationDone to the mon."""
    TYPE = 226
    FIELDS = [("path", "str"), ("result", "s32")]


@register
class MClientReconnect(Message):
    """ref: MClientReconnect — a client's session + cap claims to a
    newly promoted MDS during its reconnect window. ``caps`` maps
    path -> JSON {mode, count, cseq}; the ack restores the session
    with those caps reinstated, the reject means the session is
    unknown (missed the window / never in the table) and the client
    must re-mount from scratch."""
    TYPE = 224
    FIELDS = [("op", "u32"), ("caps", "map:str:blob")]


class MDSDaemon(Dispatcher):
    """Single-rank MDS over one metadata/data pool ioctx.

    Two modes: **standalone** (``MDSDaemon(ioctx)`` + ``start()`` —
    immediately active, no mon coordination; the original surface,
    still what the single-daemon tests drive) and **HA**
    (``MDSDaemon.create(...)`` + ``start_ha()`` — beacons the
    MDSMonitor and serves only once the FSMap promotes it)."""

    def __init__(self, ioctx, name: str = "a",
                 messenger: Messenger | None = None,
                 lease_timeout: float = 10.0,
                 revoke_timeout: float = 30.0,
                 config: dict | None = None,
                 keyring=None):
        cfg = config or {}
        self.fs = CephFSLite(ioctx)
        self.ioctx = ioctx
        self.name = name
        # the committed-caps table for the per-op request gate.
        # NOT the messenger's keyring: client MDS-
        # facing messengers are keyless, so the transport stays
        # keyless-CRC; in HA mode create()'s monc keyring wins.
        self.keyring = keyring
        self.msgr = messenger or Messenger(f"mds.{name}")
        self.msgr.add_dispatcher(self)
        self.sessions: dict[str, object] = {}       # client -> conn
        # cap leases (ref: Session::last_cap_renew + the Locker's
        # stale-session eviction): a client renews via SESSION_RENEW;
        # one whose lease lapses while sitting on an unacked revoke is
        # EVICTED (session + caps dropped) instead of stalling every
        # conflicting open to the revoke timeout.
        self.lease_timeout = lease_timeout
        self.revoke_timeout = revoke_timeout
        self._session_seen: dict[str, float] = {}   # client -> loop time
        # path -> {client: [mode, refcount]}; invariant: at most one
        # CAP_FW holder, never FW alongside another client's FR. A
        # same-client re-open bumps the refcount and can only upgrade
        # the mode (FW absorbs FR); releases drop the entry at zero.
        self.caps: dict[str, dict[str, list]] = {}
        self._cap_seq = 0
        # (path, client, seq) -> future resolved by the holder's ack
        self._revoke_waiters: dict[tuple, asyncio.Future] = {}
        # serializes the revoke+grant decision per path: without it two
        # concurrent conflicting opens both see the pre-revoke holder
        # table and both grant themselves exclusivity. User-counted so
        # entries drop when the last opener leaves (no per-path leak).
        self._open_locks = KeyedLocks()
        self._req_tasks: set[asyncio.Task] = set()
        self._stopping = False
        self._journal_seq = 0
        self.addr = None
        # journal residency (segments-of-one, batch-trimmed): a
        # successful event stays in the journal until the trim horizon
        # passes it, so a standby-replay follower has something real to
        # tail; failed events are removed immediately (an op the client
        # was told failed must never replay "successfully" later).
        # The APPLIED WATERMARK (the "applied" journal key) records
        # the contiguous prefix already applied: replay skips it —
        # re-applying an applied rename/unlink against LATER namespace
        # state is destructive (an old rename replayed after its path
        # was recreated overwrites acked data), so only the genuine
        # crash window (applied-but-unflushed, bounded by in-flight
        # concurrency, same as the pre-residency design) ever replays.
        self._resident_seqs: set[int] = set()
        self._pending_seqs: set[int] = set()
        self._applied_flushed = 0
        self._trimming = False
        self.journal_max = cfg.get("mds_journal_max_entries", 64)
        # session table mirror + per-session completed request tids
        # (ref: SessionMap + Session::completed_requests)
        self._session_table: set[str] = set()
        self._completed: dict[str, dict[int, int]] = {}
        # -- HA state -------------------------------------------------
        self.config = cfg
        self.gid = next(_GID)
        self.ident = f"mds.{name}.{self.gid}"   # RADOS entity; fence key
        self.state = STATE_ACTIVE               # standalone default
        self.monc = None                        # set by create()
        self._own_rados = None
        self.fsmap: FSMap | None = None
        # -- snaprealms (ref: SnapRealm + SnapServer client side) ------
        # sid -> {"name", "path", "tree"}: the point-in-time namespace
        # capture under the realm root. Journaled (mksnap/rmsnap
        # events) AND persisted flat in realms_oid so failover replay
        # and cold takeover both rebuild it; rides MMDSExportDir on
        # subtree migration.
        self.realms: dict[int, dict] = {}
        self.snap_enabled = cfg.get("mds_snap_enabled", True)
        self.snap_max = int(cfg.get("mds_snap_max_per_realm", 100))
        # -- multi-active state ------------------------------
        self.rank = 0                           # standalone serves rank 0
        self.journal_oid = journal_oid(0)
        self.sessions_oid = sessions_oid(0)
        self.realms_oid = realms_oid(0)
        # cumulative op counters for the beacon's load report
        self._op_count = 0
        self._subtree_op_counts: dict[str, int] = {}
        # distributed tracing: metadata-op spans continue the client's
        # context; completed spans piggyback on the beacon
        from ceph_tpu_torch.utils.tracing import Tracer
        self.tracer = Tracer(f"mds.{name}", cfg)
        # migration path -> Event set when the freeze lifts; requests
        # whose path falls UNDER a frozen path park on it (export in
        # progress). NB the frozen key is the MIGRATION path, which is
        # usually not yet a subtree-map root (first pin of /d1 while
        # the map holds only "/") — so matching is by prefix against
        # the request path, never via subtree_owner.
        self._frozen: dict[str, asyncio.Event] = {}
        # admitted request path -> in-flight count; the export drain
        # waits until nothing under the migrating path remains
        self._inflight_reqs: dict[str, int] = {}
        self._exports: set[str] = set()          # roots being exported
        self._export_acks: dict[str, asyncio.Future] = {}
        self._export_tasks: set[asyncio.Task] = set()
        self.migration_timeout = cfg.get("mds_migration_timeout", 10.0)
        self.beacon_interval = cfg.get("mds_beacon_interval", 1.0)
        self.reconnect_timeout = cfg.get("mds_reconnect_timeout", 2.0)
        self.replay_interval = cfg.get("mds_replay_interval", 0.25)
        self._beacon_seq = 0
        self._beacon_task: asyncio.Task | None = None
        self._mgr_reporter = None
        self._mgr_report_task: asyncio.Task | None = None
        self._tail_task: asyncio.Task | None = None
        self._takeover_task: asyncio.Task | None = None
        self._active_event = asyncio.Event()
        self._replay_done = asyncio.Event()
        self._recovering: set[str] = set()       # sessions awaiting
        self._killed = False                     # reconnect claims
        # central-config application state
        self._mon_cfg_state: dict = {}
        self.mirror_global_config = False

    # -- lifecycle ---------------------------------------------------------
    @classmethod
    async def create(cls, monmap, pool: str, name: str = "a",
                     keyring=None, config: dict | None = None,
                     gid: int | None = None, device=None) -> "MDSDaemon":
        """Build a mon-coordinated MDS with an OWN per-incarnation
        RADOS identity. The identity is what the MDSMonitor blocklists
        at failover — data-path ops through a shared admin ioctx would
        dodge the fence, exactly like the client-side reasoning in
        :meth:`CephFSClient.create`.

        ``device`` is its ``Rados``'s: the maps it follows decode there
        and its objecter's placement lookups map there, by
        ``crush_straw2`` on the card. CUDA unless ``"cpu"``; it raises
        without a card."""
        from ceph_tpu_torch.rados import Rados
        from ceph_tpu_torch.utils.device import resolve
        device = resolve(device)
        cfg = config or {}
        self = cls.__new__(cls)
        # _GID is process-local: proc-backend children pass their pid
        # so separate-process MDSs can't collide on gid
        if gid is None:
            gid = next(_GID)
        ident = f"mds.{name}.{gid}"
        if keyring is not None and f"mds.{name}" not in keyring.keys:
            # no provisioned base entity to derive from (standalone
            # harnesses): mint a local key. When ``mds.<name>`` IS
            # provisioned, Keyring.get derives the incarnation key on
            # BOTH ends — adding a random one here would shadow the
            # derivation locally and fail auth against a remote mon.
            keyring.add(ident)
        r = Rados(monmap, name=ident, keyring=keyring, device=device)
        await r.connect()
        io = await r.open_ioctx(pool)
        # warm the data path BEFORE beaconing starts: the identity's
        # first op maps its first PG, which on the card creates this
        # process's CUDA context and loads the crush_straw2 kernel
        # (under its build lock when another process is building it)
        # — seconds that would otherwise hold the event loop past the
        # beacon grace once this daemon serves
        from ceph_tpu_torch.rados import ObjectOperationError
        try:
            await io.stat(".mds_warmup")
        except ObjectOperationError:
            pass
        MDSDaemon.__init__(
            self, io, name=name,
            lease_timeout=cfg.get("mds_session_timeout", 10.0),
            revoke_timeout=cfg.get("mds_revoke_timeout", 30.0),
            config=cfg)
        self.gid = gid
        self.ident = ident
        self._own_rados = r
        self.monc = r.monc
        self.state = STATE_STANDBY
        self.rank = -1                 # no rank until the FSMap assigns
        return self

    @property
    def device(self):
        """Where this MDS's placement lookups run: the device of the
        ``Rados`` that opened its ioctx (its own, under :meth:`create`)."""
        return self.ioctx.rados.monc.device

    async def start(self, host: str = "127.0.0.1", port: int = 0):
        """Standalone start: immediately active (no mon coordination)."""
        # root dirfrag first (idempotent): journal replay on a fresh
        # pool needs it, and every request would ENOENT without it
        await self.fs.mount()
        await self._load_realms()
        await self._replay_journal()
        await self._load_session_table()
        self.addr = await self.msgr.bind(host, port)
        self.state = STATE_ACTIVE
        self._active_event.set()
        self._replay_done.set()
        log.dout(1, f"mds up at {self.addr}")
        return self.addr

    def _apply_config_map(self, cfgmap: dict) -> None:
        """Apply a mon-published central config map."""
        from ceph_tpu_torch.utils.config import apply_mon_config
        changed = apply_mon_config(
            f"mds.{self.name}", cfgmap, self.config,
            self._mon_cfg_state,
            mirror_global=self.mirror_global_config)
        if changed:
            log.dout(10, f"mds.{self.name} applied mon config "
                         f"{sorted(changed)}")

    async def start_ha(self, host: str = "127.0.0.1", port: int = 0):
        """Mon-coordinated start: bind, subscribe to the mdsmap, and
        beacon as a standby; all serving waits for the FSMap to
        promote this gid (ref: MDSDaemon::init + Beacon::init)."""
        self.addr = await self.msgr.bind(host, port)
        self.state = STATE_STANDBY
        # MMDSMap publishes arrive on the MonClient's messenger
        self.monc.msgr.add_dispatcher(self)
        await self.monc.subscribe("mdsmap", 0)
        # mgr report session (ref: MgrClient): mgrmap finds
        # the active mgr; the shared "mds" logger ships under THIS
        # daemon's name (the in-process daemons share one logger —
        # documented delta; a real multi-process MDS would own it)
        await self.monc.subscribe("mgrmap", 0)
        # central config db: wire-delivered live knob flips
        self.monc.config_callbacks.append(self._apply_config_map)
        await self.monc.subscribe("config", 0)
        from ceph_tpu_torch.mgr.client import MgrReporter
        self._mgr_reporter = MgrReporter(
            f"mds.{self.name}", self.monc.msgr,
            lambda: self.monc.mgrmap, lambda: [MDS_PERF],
            self.config)
        # crash capture: the long-lived loops carry the
        # top-level exception hook — a dead beacon loop is a dead
        # daemon in disguise, and the report says so
        from ceph_tpu_torch.utils import crash as _crash
        self._mgr_report_task = _crash.watch(
            asyncio.ensure_future(self._mgr_reporter.loop()),
            f"mds.{self.name}", self.monc, where="mgr_report_loop")
        self._beacon_task = _crash.watch(
            asyncio.ensure_future(self._beacon_loop()),
            f"mds.{self.name}", self.monc, where="beacon_loop")
        log.dout(1, f"mds.{self.name} (gid {self.gid}) standby at "
                    f"{self.addr}")
        return self.addr

    async def stop(self) -> None:
        # cancel detached request handlers FIRST: a handler parked in
        # the 30 s revoke wait must not outlive the daemon and mutate
        # caps / append journal events a later MDS would replay. The
        # stopping flag stops ms_dispatch spawning NEW tasks while the
        # gather below yields to the loop; the while drains any that
        # slipped in before the flag was observed.
        self._stopping = True
        for t in (self._beacon_task, self._tail_task,
                  self._takeover_task, self._mgr_report_task,
                  *self._export_tasks):
            if t is not None:
                t.cancel()
        while self._req_tasks:
            tasks = list(self._req_tasks)
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
        await self.msgr.shutdown()
        if self._own_rados is not None:
            await self._own_rados.shutdown()
            self._own_rados = None

    async def kill(self) -> None:
        """``kill -9`` analog for storms: drop everything on the floor
        — no beacons, no session teardown, no rados shutdown (the
        zombie keeps its identity so fencing is observable: its late
        writes must bounce off the blocklist)."""
        self._killed = True
        self._stopping = True
        for t in (self._beacon_task, self._tail_task,
                  self._takeover_task, self._mgr_report_task,
                  *self._export_tasks):
            if t is not None:
                t.cancel()
        for t in list(self._req_tasks):
            t.cancel()
        await self.msgr.shutdown()

    # -- beacons + fsmap (HA) ---------------------------------------------
    async def _beacon_loop(self) -> None:
        try:
            while not self._stopping and self.state != STATE_STOPPED:
                await self._send_beacon()
                await asyncio.sleep(self.beacon_interval)
        except asyncio.CancelledError:
            pass

    async def _send_beacon(self) -> None:
        if self.monc is None or self.state == STATE_STOPPED:
            return
        self._beacon_seq += 1
        # completed trace spans piggyback on the beacon (the MDS's
        # only periodic monward report)
        spans = self.tracer.drain_ship()
        try:
            await self.monc.send_report(MDSBeacon(
                gid=self.gid, name=self.name, ident=self.ident,
                addr_host=self.addr.host, addr_port=self.addr.port,
                state=self.state, seq=self._beacon_seq,
                epoch=self.fsmap.epoch if self.fsmap else 0,
                ops=self._op_count,
                subtree_ops=dict(self._subtree_op_counts),
                trace_spans=spans))
            MDS_PERF.inc("beacons_sent")
        except Exception as e:
            log.dout(5, f"beacon send failed: {e!r}")

    def _handle_fsmap(self, fm: FSMap) -> None:
        if self.fsmap is not None and fm.epoch <= self.fsmap.epoch:
            return
        self.fsmap = fm
        self._check_migrations()
        me = fm.infos.get(self.gid)
        if me is None:
            if fm.is_stopped(self.gid) and \
                    self.state != STATE_STOPPED:
                # removed/fenced: stop serving. The reference respawns;
                # here the cluster harness revives with a fresh
                # incarnation (new gid, new identity).
                log.dout(1, f"mds.{self.name} (gid {self.gid}) "
                            f"removed from fsmap; stopping service")
                self.state = STATE_STOPPED
                self._active_event.clear()
            return
        if me.state == STATE_STANDBY_REPLAY and \
                self.state == STATE_STANDBY:
            self.state = STATE_STANDBY_REPLAY
            MDS_PERF.inc("state_transitions")
            self._tail_task = asyncio.ensure_future(
                self._standby_replay_loop())
            log.dout(1, f"mds.{self.name} -> standby_replay")
        elif me.state == STATE_REPLAY and self.state in (
                STATE_STANDBY, STATE_STANDBY_REPLAY):
            if self._tail_task is not None:
                self._tail_task.cancel()
                self._tail_task = None
            self.state = STATE_REPLAY
            # the rank this incarnation now serves: journal + session
            # table are PER RANK (rank 0 keeps the legacy object names)
            self.rank = me.rank
            self.journal_oid = journal_oid(self.rank)
            self.sessions_oid = sessions_oid(self.rank)
            self.realms_oid = realms_oid(self.rank)
            MDS_PERF.inc("state_transitions")
            MDS_PERF.inc("takeovers")
            self._takeover_task = asyncio.ensure_future(
                self._takeover())

    async def _takeover(self) -> None:
        """replay -> reconnect -> rejoin -> active (ref: the
        MDSDaemon rank-start sequence MDSRank::replay_start ..
        active_start)."""
        try:
            # FENCE BARRIER first (ref: MDSMap::last_failure_osd_epoch
            # + MDSRank waiting on the objecter's map): the journal
            # must not be replayed while any OSD could still accept
            # the fenced predecessor's writes.
            epoch = self.fsmap.last_failure_osd_epoch \
                if self.fsmap else 0
            objecter = getattr(self.ioctx.rados, "objecter", None)
            while epoch and objecter is not None and \
                    not self._stopping:
                try:
                    await objecter.wait_for_map_on_osds(
                        epoch, timeout=10.0)
                    break
                except Exception as e:
                    log.dout(0, f"takeover fence barrier (epoch "
                                f"{epoch}) not proven: {e}; retrying")
                    await asyncio.sleep(0.2)
            await self.fs.mount()
            await self._load_realms()     # before replay: a replayed
            await self._replay_journal()  # mksnap re-persists on top
            await self._load_session_table()
            self._recovering = set(self._session_table)
            self._replay_done.set()
            await self._advance(STATE_RECONNECT)
            # reconnect window (ref: MDSRank::reconnect_start): bounded
            # wait for every session in the table to re-claim its caps
            loop = asyncio.get_event_loop()
            deadline = loop.time() + self.reconnect_timeout
            while self._recovering and loop.time() < deadline:
                await asyncio.sleep(0.02)
            for client in sorted(self._recovering):
                if client not in self._recovering:
                    # a parked reconnect task landed while an earlier
                    # straggler was being dropped (the await below
                    # yields): that session was just restored + ACKed
                    # — forgetting it now would silently destroy it
                    continue
                # missed the window: session + caps die (the client
                # must re-mount); ref: MDSRank kills unreconnected
                # sessions at reconnect_done
                log.dout(1, f"session {client} never reconnected; "
                            f"dropping")
                MDS_PERF.inc("sessions_dropped")
                await self._forget_session(client)
            self._recovering.clear()
            await self._advance(STATE_REJOIN)
            # rejoin: cap/lock state was rebuilt from the reconnect
            # claims themselves; nothing further to recover at this
            # scope (no distributed subtrees)
            await self._advance(STATE_ACTIVE)
            self._active_event.set()
            # an in-flight migration FROM this rank (committed against
            # the predecessor, aborted only if the mon noticed the
            # death) restarts here with the replayed state
            self._check_migrations()
            log.dout(1, f"mds.{self.name} active (takeover complete, "
                        f"rank {self.rank}, {len(self.sessions)} "
                        f"sessions)")
        except asyncio.CancelledError:
            pass
        except Exception as e:
            log.dout(0, f"mds takeover failed: {e!r}")

    async def _advance(self, state: str) -> None:
        self.state = state
        MDS_PERF.inc("state_transitions")
        await self._send_beacon()     # don't wait a beacon interval

    async def _standby_replay_loop(self) -> None:
        """Warm follower (ref: standby-replay tailing the active's
        MDLog). The namespace itself lives in the RADOS dirfrags, so
        the real warm state is the journal position and the session
        table — tailed here so a takeover starts its replay and its
        reconnect window without cold reads. Entries are NEVER applied
        from this loop: applying against the shared dirfrag objects
        would race the live active."""
        from ceph_tpu_torch.rados import ObjectOperationError
        try:
            while not self._stopping and \
                    self.state == STATE_STANDBY_REPLAY:
                MDS_PERF.inc("standby_replay_polls")
                try:
                    entries = await self.ioctx.get_omap_vals(
                        self.journal_oid)
                    seqs = [int(k) for k in entries if k.isdigit()]
                    if seqs:
                        self._journal_seq = max(self._journal_seq,
                                                max(seqs))
                except ObjectOperationError:
                    pass                      # nothing journaled yet
                try:
                    table = await self.ioctx.get_omap_vals(
                        self.sessions_oid)
                    self._ingest_session_table(table)
                except ObjectOperationError:
                    pass                      # no sessions yet
                await asyncio.sleep(self.replay_interval)
        except asyncio.CancelledError:
            pass

    # -- subtree migration (ref: src/mds/Migrator.{h,cc},
    # two-phase: freeze -> journaled handoff -> import -> mon flip) -------
    def _check_migrations(self) -> None:
        """Spawn an export task for every in-flight migration whose
        FROM rank is ours (idempotent — one task per subtree root)."""
        fm = self.fsmap
        if fm is None or self._stopping or self.state != STATE_ACTIVE:
            return
        for mig in fm.migrations:
            if mig["from"] == self.rank and \
                    mig["path"] not in self._exports:
                t = asyncio.ensure_future(
                    self._export_subtree(dict(mig)))
                self._export_tasks.add(t)
                t.add_done_callback(self._export_tasks.discard)

    async def _export_subtree(self, mig: dict) -> None:
        """Run the exporter's half of the two-phase handoff:

        1. FREEZE the subtree (new requests under it park) and drain
           the in-flight ones, so the journal + cap table are a
           consistent snapshot;
        2. journal the handoff marker (crash here: nothing moved —
           the mon's intent entry survives and a successor retries);
        3. ship caps + completed-request tables to the importer and
           wait for its ack (the importer PERSISTS the tables before
           acking — the exactly-once handoff durability);
        4. report MMDSMigrationDone until the mon's commit flips the
           subtree map (authority moves exactly here);
        5. unfreeze: parked requests wake, re-check ownership, and
           redirect to the new owner.

        Aborts (mon dropped the intent, e.g. the importer died) just
        unfreeze — authority never moved."""
        path, to = mig["path"], mig["to"]
        if path in self._exports:
            return
        self._exports.add(path)
        ev = self._frozen.setdefault(path, asyncio.Event())
        ev.clear()
        loop = asyncio.get_event_loop()
        # the handoff is traceable like any op: the exporter's root
        # span context rides MMDSExportDir so the importer's merge
        # shows up as a child in the reassembled trace
        span = self.tracer.start_root(
            "subtree_export",
            tags={"path": path, "from_rank": self.rank, "to_rank": to})
        try:
            while self._inflight_under(path):
                if self._stopping or self.fsmap is None or \
                        self.fsmap.migration_for(path) is None:
                    return
                await asyncio.sleep(0.01)
            await self._journaled_apply(
                {"op": "export_subtree", "path": path, "to": to})
            caps = {
                p: json.dumps({"holders": {
                    c: [mode, cnt]
                    for c, (mode, cnt) in holders.items()}}).encode()
                for p, holders in self.caps.items()
                if p == path or p.startswith(path + "/")}
            completed = {
                c: json.dumps({str(t): r
                               for t, r in tids.items()}).encode()
                for c, tids in self._completed.items()}
            # snaprealms rooted in the subtree move with it — the
            # importer is the one serving .snap lookups afterwards
            realms = {
                str(sid): json.dumps(r).encode()
                for sid, r in self.realms.items()
                if r["path"] == path or
                r["path"].startswith(path.rstrip("/") + "/")}
            acked = False
            while not acked and not self._stopping:
                fm = self.fsmap
                if fm is None or fm.migration_for(path) is None:
                    return                  # aborted: finally unfreezes
                dest = fm.rank_holder(to)
                if dest is None or dest.state != STATE_ACTIVE:
                    await asyncio.sleep(0.05)
                    continue
                fut = loop.create_future()
                self._export_acks[path] = fut
                try:
                    export_msg = MMDSExportDir(
                        path=path, from_rank=self.rank, to_rank=to,
                        cap_seq=self._cap_seq, caps=caps,
                        completed=completed, realms=realms)
                    export_msg.set_trace(span)
                    await self.msgr.send_message(
                        export_msg, dest.addr(), "mds")
                    rep = await asyncio.wait_for(fut, timeout=2.0)
                    acked = rep.result == 0
                except Exception:
                    await asyncio.sleep(0.1)
                finally:
                    self._export_acks.pop(path, None)
            if not acked:
                return
            while not self._stopping:
                fm = self.fsmap
                if fm is None or fm.subtrees.get(path) == to:
                    break
                if fm.migration_for(path) is None:
                    return                  # aborted after the ack
                try:
                    await self.monc.send_report(MMDSMigrationDone(
                        gid=self.gid, path=path, from_rank=self.rank,
                        to_rank=to))
                except Exception as e:
                    log.dout(5, f"migration-done send failed: {e!r}")
                await asyncio.sleep(0.1)
            # flipped: the importer is authoritative — drop the
            # transferred caps so a stale holder entry here can never
            # feed a grant/revoke decision again
            for p in list(self.caps):
                if p == path or p.startswith(path + "/"):
                    self.caps.pop(p, None)
            for sid in [int(s) for s in realms]:
                self.realms.pop(sid, None)
                try:
                    await self.ioctx.rm_omap_key(self.realms_oid,
                                                 f"{sid:016d}")
                except Exception:
                    pass     # stale copy is routing-shadowed anyway
            MDS_PERF.inc("subtrees_exported")
            log.dout(1, f"mds.{self.name} (rank {self.rank}) exported "
                        f"subtree {path} -> rank {to}")
        except asyncio.CancelledError:
            pass
        finally:
            if span is not None:
                span.finish()
            self._exports.discard(path)
            done_ev = self._frozen.pop(path, None)
            if done_ev is not None:
                done_ev.set()

    async def _handle_import(self, m: MMDSExportDir) -> None:
        """The importer's half: journal the marker, merge caps, and
        PERSIST the merged completed-request tables before acking —
        a client's post-migration resend of a mutation that already
        landed on the exporter must answer from the table, not
        re-execute (the exactly-once guarantee's durable half)."""
        if not self._active_event.is_set():
            await self._active_event.wait()
        span = self.tracer.from_msg(
            "subtree_import", m, tags={"path": m.path,
                                       "rank": self.rank})
        await self._journaled_apply(
            {"op": "import_subtree", "path": m.path,
             "from": m.from_rank})
        for p, blob in m.caps.items():
            try:
                ent = json.loads(blob)
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue
            holders = self.caps.setdefault(p, {})
            for client, mode_cnt in ent.get("holders", {}).items():
                cur = holders.setdefault(client, [0, 0])
                cur[0] = max(cur[0], int(mode_cnt[0]))
                cur[1] = max(cur[1], int(mode_cnt[1]))
        self._cap_seq = max(self._cap_seq, m.cap_seq)
        for client, blob in m.completed.items():
            try:
                tids = json.loads(blob)
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue
            done = self._completed.setdefault(client, {})
            for t, r in tids.items():
                done.setdefault(int(t), int(r))
            while len(done) > COMPLETED_KEEP:
                done.pop(next(iter(done)))
            await self._save_session(client)
        for s, blob in getattr(m, "realms", {}).items():
            try:
                realm = json.loads(blob)
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue
            sid = int(s)
            self.realms[sid] = realm
            await self._save_realm(sid)     # durable BEFORE the ack
        MDS_PERF.inc("subtrees_imported")
        if span is not None:
            span.finish()
        log.dout(1, f"mds.{self.name} (rank {self.rank}) imported "
                    f"subtree {m.path} from rank {m.from_rank}")
        await m.conn.send_message(MMDSExportDirAck(
            path=m.path, result=0))

    @staticmethod
    def _depth1(path: str) -> str:
        """Load-tracking prefix for a path owned via "/": its depth-1
        component ("/a/b/c" -> "/a") — the granularity at which the
        rebalancer can carve load off the root subtree."""
        if path == "/":
            return "/"
        return "/" + path.split("/", 2)[1]

    def _frozen_event(self, *paths: str) -> asyncio.Event | None:
        """The freeze Event covering any of ``paths``, or None.
        Matching is frozen-path-prefix against the request path — the
        frozen key (a migration path) need not be a subtree-map root
        yet."""
        for froot, ev in self._frozen.items():
            if ev.is_set():
                continue
            for p in paths:
                if p and (p == froot or p.startswith(froot + "/")):
                    return ev
        return None

    def _inflight_under(self, path: str) -> bool:
        return any(p == path or p.startswith(path + "/")
                   for p in self._inflight_reqs)

    async def _route_or_park(self, m: MClientRequest
                             ) -> MClientReply | None:
        """Ownership gate (multi-active): park while the path sits
        under a frozen migration (export in flight), then redirect
        with -ESTALE when this rank is not the owner. Returns the
        reply to send, or None to serve locally — in which case the op
        has been counted and its path(s) registered in-flight
        (``m._admitted``; caller decrements when done). No await sits
        between the freeze check and the registration, so the export
        drain can never miss an admitted op."""
        while True:
            fm = self.fsmap
            owner, root = fm.subtree_owner(m.path)
            ev = self._frozen_event(m.path, m.path2)
            if ev is not None:
                await ev.wait()
                continue             # ownership may have just flipped
            if m.op == "rename" and m.path2:
                owner2, _ = fm.subtree_owner(m.path2)
                if owner2 != owner:
                    return MClientReply(
                        tid=m.tid, result=EXDEV,
                        payload=(f"cross-rank rename not supported: "
                                 f"{m.path} is served by rank {owner},"
                                 f" {m.path2} by rank {owner2}; pin "
                                 f"both under one rank").encode(),
                        cap_mode=0, cap_seq=0)
            if owner != self.rank:
                MDS_PERF.inc("redirects_sent")
                return MClientReply(
                    tid=m.tid, result=ESTALE,
                    payload=json.dumps(
                        {"rank": owner, "path": root}).encode(),
                    cap_mode=0, cap_seq=0)
            self._op_count += 1
            key = root if root != "/" else self._depth1(m.path)
            counts = self._subtree_op_counts
            if key not in counts and len(counts) >= 64:
                # bound the beacon payload: drop the coldest prefix
                counts.pop(min(counts, key=counts.get))
            counts[key] = counts.get(key, 0) + 1
            # path2 rides along for renames: a rename INTO a freezing
            # subtree must neither slip past the park nor be missed by
            # the export drain
            m._admitted = [m.path] + \
                ([m.path2] if m.op == "rename" and m.path2 else [])
            for p in m._admitted:
                self._inflight_reqs[p] = \
                    self._inflight_reqs.get(p, 0) + 1
            return None

    def _inflight_done(self, paths: list) -> None:
        for p in paths:
            n = self._inflight_reqs.get(p, 0) - 1
            if n <= 0:
                self._inflight_reqs.pop(p, None)
            else:
                self._inflight_reqs[p] = n

    # -- journaling (ref: MDLog + EUpdate, batch-trimmed segments) ---------
    async def _journal(self, event: dict) -> int:
        """Append-then-apply: the event lands durably in the journal
        omap before the dirfrag mutation happens. Successful events
        stay resident until the trim horizon passes (replay is
        idempotent and order-converging); failed events are removed
        immediately."""
        self._journal_seq += 1
        seq = self._journal_seq
        await self.ioctx.set_omap(self.journal_oid, f"{seq:016d}",
                                  json.dumps(event).encode())
        self._pending_seqs.add(seq)
        self._resident_seqs.add(seq)
        return seq

    async def _commit(self, seq: int) -> None:
        self._pending_seqs.discard(seq)
        self._resident_seqs.discard(seq)
        await self.ioctx.rm_omap_key(self.journal_oid, f"{seq:016d}")

    async def _journaled_apply(self, ev: dict) -> None:
        """journal -> apply -> (lazy) trim. The entry is removed at
        once on FAILURE: an op the client was told failed must not
        linger and replay 'successfully' after conditions change (only
        a crash between append and apply leaves an unapplied entry)."""
        seq = await self._journal(ev)
        try:
            await self._apply(ev)
        except BaseException:
            await self._commit(seq)
            raise
        self._pending_seqs.discard(seq)
        await self._flush_applied()
        await self._maybe_trim()

    def _applied_horizon(self) -> int:
        """Largest seq with every seq <= it applied (pending = the
        journaled-not-yet-applied set)."""
        return (min(self._pending_seqs) - 1 if self._pending_seqs
                else self._journal_seq)

    async def _flush_applied(self) -> None:
        """Persist the contiguous applied watermark. Monotonic guard:
        flushes initiate in increasing order on one loop + one
        connection, so the stored value never regresses."""
        horizon = self._applied_horizon()
        if horizon <= self._applied_flushed:
            return
        self._applied_flushed = horizon
        # plain (non-underscore) key: the OSD's omap GET hides
        # "_"-prefixed keys as store-internal; the digit-only filters
        # in replay/tail skip this one
        await self.ioctx.set_omap(self.journal_oid, "applied",
                                  str(horizon).encode())

    async def _maybe_trim(self) -> None:
        """Trim applied journal entries once residency exceeds
        ``mds_journal_max_entries`` (ref: MDLog segment trimming).
        Horizon = just below the oldest still-pending event, so a
        crash can only ever leave a replayable suffix."""
        if self._trimming or \
                len(self._resident_seqs) <= self.journal_max:
            return
        self._trimming = True
        try:
            horizon = self._applied_horizon()
            for seq in sorted(s for s in self._resident_seqs
                              if s <= horizon):
                await self.ioctx.rm_omap_key(self.journal_oid,
                                             f"{seq:016d}")
                self._resident_seqs.discard(seq)
        finally:
            self._trimming = False

    async def _replay_journal(self) -> None:
        from ceph_tpu_torch.rados import ObjectOperationError
        MDS_PERF.inc("journal_replays")
        try:
            entries = await self.ioctx.get_omap_vals(self.journal_oid)
        except ObjectOperationError:
            return
        # entries at or below the applied watermark already landed:
        # re-applying them against the LATEST namespace (instead of
        # the state they were appended over) is not idempotent —
        # an old rename/unlink would clobber later acked writes
        applied = int(entries.get("applied", b"0") or 0)
        for k in sorted(k for k in entries if k.isdigit()):
            seq = int(k)
            if seq > applied:
                ev = json.loads(entries[k])
                log.dout(4, f"mds journal replay: {ev}")
                try:
                    await self._apply(ev)
                except FSError as e:
                    # idempotent within the crash window: EEXIST /
                    # ENOENT mean the mutation already landed
                    log.dout(5, f"replay skip ({e.errno}): {ev}")
            await self.ioctx.rm_omap_key(self.journal_oid, k)
            self._journal_seq = max(self._journal_seq, seq)
        if "applied" in entries:
            await self.ioctx.rm_omap_key(self.journal_oid, "applied")
        self._applied_flushed = 0
        self._resident_seqs.clear()
        self._pending_seqs.clear()

    async def _apply(self, ev: dict) -> None:
        op = ev["op"]
        if op == "mkdir":
            await self.fs.mkdir(ev["path"])
        elif op == "rmdir":
            await self.fs.rmdir(ev["path"])
        elif op == "create":
            # must stay idempotent AND non-destructive: a stale create
            # replayed after the file gained data must not truncate it
            try:
                await self.fs.stat(ev["path"])
            except FSError:
                await self.fs.write_file(ev["path"], b"")
        elif op == "unlink":
            await self.fs.unlink(ev["path"])
        elif op == "rename":
            await self.fs.rename(ev["path"], ev["path2"])
        elif op == "setattr":
            await self.fs.set_size(ev["path"], ev["size"])
        elif op == "mksnap":
            sid = int(ev["sid"])
            self.realms[sid] = {"name": ev["name"], "path": ev["path"],
                                "tree": ev["tree"]}
            await self._save_realm(sid)
        elif op == "rmsnap":
            sid = int(ev["sid"])
            self.realms.pop(sid, None)
            try:
                await self.ioctx.rm_omap_key(self.realms_oid,
                                             f"{sid:016d}")
            except Exception:      # already gone: replay-idempotent
                pass
        elif op in ("export_subtree", "import_subtree"):
            # handoff markers: authority lives in the mon's subtree
            # map, not the journal — replay has nothing to do (the
            # marker's value is the watermark ordering around it)
            pass
        else:                                        # pragma: no cover
            raise ValueError(f"unknown journal op {op}")

    # -- snaprealm table (ref: SnapRealm persistence — flat per-rank
    # omap, the same durability model as the session table) ---------------
    async def _save_realm(self, sid: int) -> None:
        await self.ioctx.set_omap(
            self.realms_oid, f"{sid:016d}",
            json.dumps(self.realms[sid]).encode())

    async def _load_realms(self) -> None:
        from ceph_tpu_torch.rados import ObjectOperationError
        try:
            omap = await self.ioctx.get_omap_vals(self.realms_oid)
        except ObjectOperationError:
            omap = {}
        self.realms = {int(k): json.loads(v)
                       for k, v in omap.items() if k.isdigit()}

    def _snaps_governing(self, path: str) -> list[int]:
        """Ascending snapids whose realm root is ``path`` or an
        ancestor — the snap context a write at ``path`` must carry
        (ref: SnapRealm::get_snap_context walking parent realms). The
        union of this rank's realm table and the FSMap's registry: the
        FSMap half makes the context correct even for realms whose
        tree lives on another rank."""
        out = {sid for sid, r in self.realms.items()
               if path == r["path"] or
               path.startswith(r["path"].rstrip("/") + "/")}
        if self.fsmap is not None:
            out |= set(self.fsmap.snaps_under(path))
        return sorted(out)

    def _realm(self, root: str, name: str) -> tuple[int, dict]:
        entry = next(((sid, r) for sid, r in self.realms.items()
                      if r["path"] == root and r["name"] == name), None)
        if entry is None:
            raise FSError(-2, f"no snapshot {name!r} at {root}")
        return entry

    async def _capture_tree(self, root: str) -> dict:
        """Point-in-time namespace capture under ``root``: relative
        path ("" = the root itself) -> {type, size[, oid]}. Data is NOT
        copied — a file entry records the head object's name, and
        point-in-time reads go through the OSD snap machinery
        (snap_id resolves to the COW clone)."""
        tree: dict[str, dict] = {"": {"type": "dir"}}
        stack = [""]
        base = root.rstrip("/")
        while stack:
            rel = stack.pop()
            absd = (base + "/" + rel) if rel else (root or "/")
            for nm in await self.fs.ls(absd):
                chrel = f"{rel}/{nm}" if rel else nm
                chabs = base + "/" + chrel
                try:
                    st = await self.fs.stat(chabs)
                except FSError:
                    continue            # raced an unlink: skip
                ent: dict = {"type": st["type"],
                             "size": st.get("size", 0)}
                if st["type"] == "file":
                    ent["oid"] = _fileobj(chabs)
                else:
                    stack.append(chrel)
                tree[chrel] = ent
        return tree

    @staticmethod
    def _tree_children(tree: dict, rest: str) -> list[str]:
        ent = tree.get(rest)
        if ent is None:
            raise FSError(-2, f"no such entry {rest!r} in snapshot")
        if ent["type"] != "dir":
            raise FSError(-20, f"{rest!r} is not a directory")
        pre = rest + "/" if rest else ""
        return sorted(k[len(pre):] for k in tree
                      if k and k != rest and k.startswith(pre)
                      and "/" not in k[len(pre):])

    async def _recall_realm_caps(self, root: str) -> None:
        """Revoke every cap under the realm root so writers flush and
        their next open carries the grown snap context (ref: the
        snaprealm split/update cap recall in Locker) — without this a
        holder would keep writing with the pre-snapshot context and
        the OSD would never COW, silently dirtying the snapshot."""
        base = root.rstrip("/")
        for path in [p for p in list(self.caps)
                     if p == root or p.startswith(base + "/")]:
            # the sentinel requester matches no real client, so EVERY
            # holder (including the mksnap caller itself) is revoked
            await self._revoke_conflicting(path, "\0mksnap", CAP_FW)

    async def _mksnap(self, root: str, name: str) -> int:
        """mkdir <root>/.snap/<name> (ref: Server::handle_client_
        mksnap): allocate the snapid at the mon, recall write caps,
        capture the namespace, journal the realm."""
        if not self.snap_enabled:
            raise FSError(-1, "EPERM: snapshots disabled "
                              "(mds_snap_enabled=false)")
        if not name or name.startswith("_") or name == SNAPDIR:
            raise FSError(-22, f"invalid snapshot name {name!r}")
        st = await self.fs.stat(root)
        if st["type"] != "dir":
            raise FSError(-20, f"{root} is not a directory")
        if any(r["path"] == root and r["name"] == name
               for r in self.realms.values()):
            raise FSError(-17, f"snapshot {name!r} exists at {root}")
        if sum(1 for r in self.realms.values()
               if r["path"] == root) >= self.snap_max:
            raise FSError(-31, "EMLINK: mds_snap_max_per_realm "
                               "snapshots already exist here")
        ret, rs, out = await self.ioctx.rados.mon_command(
            {"prefix": "fs snap create", "path": root, "name": name,
             "pool": self.ioctx.pool_name})
        if ret == -17:
            # a prior attempt allocated the sid but died before its
            # journal event landed (mon committed, realm didn't):
            # adopt the registered sid instead of failing the retry
            ret2, _, out2 = await self.ioctx.rados.mon_command(
                {"prefix": "fs snap ls", "path": root})
            sid = next((int(k) for k, v in
                        json.loads(out2)["snaps"].items()
                        if v["name"] == name), None) if ret2 == 0 \
                else None
            if sid is None:
                raise FSError(-17, rs or "snapshot exists")
        elif ret != 0:
            raise FSError(ret, rs or "snapid allocation refused")
        else:
            sid = int(json.loads(out)["snapid"])
        # recall BEFORE capture: holders flush their in-flight writes
        # and reacquire with a context including sid, so everything
        # captured below is stable and every later write COWs
        await self._recall_realm_caps(root)
        tree = await self._capture_tree(root)
        await self._journaled_apply({"op": "mksnap", "path": root,
                                     "name": name, "sid": sid,
                                     "tree": tree})
        log.dout(1, f"mds.{self.name}: mksnap {root}/.snap/{name} "
                    f"(snapid {sid}, {len(tree)} entries)")
        return sid

    async def _rmsnap(self, root: str, name: str) -> None:
        """rmdir <root>/.snap/<name>: drop the mon registry entry
        (queues the snapid into removed_snaps — the OSDs trim the
        clones) and journal the realm removal."""
        sid, _r = self._realm(root, name)
        ret, rs, _ = await self.ioctx.rados.mon_command(
            {"prefix": "fs snap rm", "path": root, "name": name})
        if ret not in (0, -2):       # -2: mon already forgot it
            raise FSError(ret, rs or "snap rm refused")
        await self._journaled_apply({"op": "rmsnap", "sid": sid})
        log.dout(1, f"mds.{self.name}: rmsnap {root}/.snap/{name} "
                    f"(snapid {sid})")

    async def _serve_snap(self, m: MClientRequest,
                          sp: tuple) -> tuple[bytes, int, int]:
        """Serve one request whose path traverses .snap. Returns
        (payload, cap_mode, cap_seq); raises FSError for errors.
        Everything inside a snapshot is immutable: only mkdir/rmdir of
        the snapshot names themselves mutate, all else is read-only."""
        root, name, rest = sp
        if m.op == "mkdir" and name and not rest:
            await self._mksnap(root, name)
            return b"", 0, 0
        if m.op == "rmdir" and name and not rest:
            await self._rmsnap(root, name)
            return b"", 0, 0
        if m.op == "readdir":
            if not name:      # ls <root>/.snap -> snapshot names
                return json.dumps(sorted(
                    r["name"] for r in self.realms.values()
                    if r["path"] == root)).encode(), 0, 0
            _sid, r = self._realm(root, name)
            return json.dumps(
                self._tree_children(r["tree"], rest)).encode(), 0, 0
        if m.op == "stat":
            if not name:      # the .snap dir itself
                return json.dumps({"path": m.path, "type": "dir",
                                   "size": 0}).encode(), 0, 0
            _sid, r = self._realm(root, name)
            ent = r["tree"].get(rest)
            if ent is None:
                raise FSError(-2, f"no such entry in snapshot")
            return json.dumps(
                {"path": m.path, "type": ent["type"],
                 "size": ent.get("size", 0)}).encode(), 0, 0
        if m.op == "open":
            if int(m.flags) == CAP_FW:
                raise FSError(EROFS, "snapshots are read-only")
            sid, r = self._realm(root, name)
            ent = r["tree"].get(rest)
            if ent is None:
                raise FSError(-2, "no such file in snapshot")
            if ent["type"] != "file":
                raise FSError(-21, "EISDIR")
            # no cap bookkeeping: snapshot content is immutable, so a
            # shared-read grant can never need revoking
            return json.dumps(
                {"size": ent.get("size", 0), "oid": ent["oid"],
                 "snapid": sid}).encode(), CAP_FR, 0
        raise FSError(EROFS, "snapshots are read-only")

    # -- session table (ref: SessionMap) ----------------------------------
    def _ingest_session_table(self, omap: dict) -> None:
        self._session_table = set(omap)
        for client, blob in omap.items():
            try:
                ent = json.loads(blob)
            except (json.JSONDecodeError, UnicodeDecodeError):
                ent = {}
            self._completed[client] = {
                int(t): int(r)
                for t, r in ent.get("completed", {}).items()}

    async def _load_session_table(self) -> None:
        from ceph_tpu_torch.rados import ObjectOperationError
        try:
            omap = await self.ioctx.get_omap_vals(self.sessions_oid)
        except ObjectOperationError:
            omap = {}
        self._ingest_session_table(omap)

    async def _save_session(self, client: str) -> None:
        done = self._completed.get(client, {})
        await self.ioctx.set_omap(
            self.sessions_oid, client,
            json.dumps({"completed": {str(t): r for t, r in
                                      done.items()}}).encode())
        self._session_table.add(client)

    async def _forget_session(self, client: str) -> None:
        self.sessions.pop(client, None)
        self._session_seen.pop(client, None)
        self._drop_client_caps(client)
        self._completed.pop(client, None)
        if client in self._session_table:
            self._session_table.discard(client)
            try:
                await self.ioctx.rm_omap_key(self.sessions_oid, client)
            except Exception as e:
                log.dout(5, f"session table trim for {client} "
                            f"failed: {e!r}")

    async def _record_completed(self, client: str, tid: int,
                                result: int) -> None:
        """Persist one finished mutation's (tid, result) so a replay
        against a successor MDS answers from the table instead of
        re-executing (ref: Session::add_completed_request)."""
        done = self._completed.setdefault(client, {})
        done[tid] = result
        while len(done) > COMPLETED_KEEP:
            done.pop(next(iter(done)))
        if client in self.sessions or client in self._session_table:
            await self._save_session(client)

    # -- dispatch ----------------------------------------------------------
    async def ms_dispatch(self, msg) -> bool:
        if isinstance(msg, MMDSMap):
            self._handle_fsmap(FSMap.decode(msg.fsmap))
            return True
        if isinstance(msg, MClientSession):
            if self._active_event.is_set() or \
                    msg.op != SESSION_OPEN:
                await self._handle_session(msg)
            else:
                # an OPEN racing the ladder parks until active (a
                # standby must not admit sessions — its session-table
                # writes would race the live active's); parked in a
                # task so the reader loop keeps draining
                if self._stopping:
                    return True
                t = asyncio.ensure_future(
                    self._session_when_active(msg))
                self._req_tasks.add(t)
                t.add_done_callback(self._req_task_done)
            return True
        if isinstance(msg, MClientReconnect):
            if self._stopping:
                return True
            t = asyncio.ensure_future(self._handle_reconnect(msg))
            self._req_tasks.add(t)
            t.add_done_callback(self._req_task_done)
            return True
        if isinstance(msg, MClientRequest):
            # Own task, NOT awaited: the messenger's reader loop
            # dispatches serially per connection, so an open blocked in
            # the revoke/ack wait would head-of-line-block every later
            # frame from that client — including its own CAP_OP_ACK,
            # deadlocking two clients that each hold a cap the other's
            # open needs (the reference MDS never blocks the dispatcher
            # on Locker revocation). Per-path _open_locks keep the
            # ordering that matters.
            if self._stopping:
                return True              # shutting down: drop, no task
            t = asyncio.ensure_future(self._handle_request(msg))
            self._req_tasks.add(t)
            t.add_done_callback(self._req_task_done)
            return True
        if isinstance(msg, MClientCaps):
            await self._handle_caps(msg)
            return True
        if isinstance(msg, MMDSExportDir):
            if self._stopping:
                return True
            t = asyncio.ensure_future(self._handle_import(msg))
            self._req_tasks.add(t)
            t.add_done_callback(self._req_task_done)
            return True
        if isinstance(msg, MMDSExportDirAck):
            fut = self._export_acks.get(msg.path)
            if fut and not fut.done():
                fut.set_result(msg)
            return True
        return False

    async def _session_when_active(self, m: MClientSession) -> None:
        await self._active_event.wait()
        await self._handle_session(m)

    async def _handle_session(self, m: MClientSession) -> None:
        now = asyncio.get_event_loop().time()
        if m.op == SESSION_OPEN:
            self.sessions[m.src] = m.conn
            self._session_seen[m.src] = now
            # table BEFORE ack: a session the client believes open must
            # survive into a successor's reconnect window
            await self._save_session(m.src)
        elif m.op == SESSION_RENEW:
            if m.src not in self.sessions:
                return                   # evicted: renewals are void
            self._session_seen[m.src] = now
        else:
            await self._forget_session(m.src)
        # the OPEN ack advertises the lease (ms) so the client paces
        # its renewals off the MDS's configuration instead of a
        # hardcoded beat that could exceed a short lease
        await m.conn.send_message(MClientSession(
            op=m.op,
            cseq=int(self.lease_timeout * 1000)
            if m.op == SESSION_OPEN else m.cseq))

    async def _handle_reconnect(self, m: MClientReconnect) -> None:
        """A client re-claims its session + caps from this (normally
        freshly promoted) MDS (ref: Server::handle_client_reconnect).
        Parked until journal replay finishes; claims from sessions not
        in the table are refused — the client must re-mount."""
        if not self._replay_done.is_set():
            await self._replay_done.wait()
        if m.src not in self._session_table:
            MDS_PERF.inc("reconnect_rejected")
            await m.conn.send_message(MClientReconnect(
                op=RECONNECT_REJECT, caps={}))
            return
        now = asyncio.get_event_loop().time()
        self.sessions[m.src] = m.conn
        self._session_seen[m.src] = now
        for path, blob in m.caps.items():
            try:
                claim = json.loads(blob)
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue
            ent = self.caps.setdefault(path, {}) \
                .setdefault(m.src, [0, 0])
            ent[0] = max(ent[0], int(claim.get("mode", CAP_FR)))
            ent[1] = max(ent[1], int(claim.get("count", 1)))
            self._cap_seq = max(self._cap_seq,
                                int(claim.get("cseq", 0)))
            MDS_PERF.inc("caps_replayed")
        self._recovering.discard(m.src)
        MDS_PERF.inc("reconnect_accepted")
        await m.conn.send_message(MClientReconnect(
            op=RECONNECT_ACK, caps={}))
        log.dout(1, f"session {m.src} reconnected "
                    f"({len(m.caps)} cap claims)")

    def _drop_client_caps(self, client: str) -> None:
        for path in list(self.caps):
            if self.caps[path].pop(client, None) is not None:
                if not self.caps[path]:
                    del self.caps[path]
        # a dead client can't ack: resolve its pending revokes
        for (path, holder, seq), fut in list(self._revoke_waiters.items()):
            if holder == client and not fut.done():
                fut.set_result(None)

    async def _handle_caps(self, m: MClientCaps) -> None:
        if m.op == CAP_OP_ACK:
            fut = self._revoke_waiters.pop((m.path, m.src, m.cseq), None)
            if fut and not fut.done():
                fut.set_result(None)
            holders = self.caps.get(m.path, {})
            holders.pop(m.src, None)
            if not holders:
                self.caps.pop(m.path, None)
        elif m.op == CAP_OP_RELEASE:
            holders = self.caps.get(m.path, {})
            ent = holders.get(m.src)
            if ent is not None:
                ent[1] -= 1               # one handle closed; the cap
                if ent[1] <= 0:           # survives while others remain
                    holders.pop(m.src, None)
            if not holders:
                self.caps.pop(m.path, None)

    async def _revoke_conflicting(self, path: str, client: str,
                                  want: int) -> None:
        """Send revokes to every holder whose cap conflicts with
        ``want`` and wait for their acks (ref: Locker::revoke_client_
        caps + the grant-after-ack ordering)."""
        holders = self.caps.get(path, {})
        waits = []
        keys = []
        for holder, (mode, _cnt) in list(holders.items()):
            if holder == client:
                continue
            conflict = want == CAP_FW or mode == CAP_FW
            if not conflict:
                continue
            self._cap_seq += 1
            seq = self._cap_seq
            fut = asyncio.get_event_loop().create_future()
            self._revoke_waiters[(path, holder, seq)] = fut
            keys.append((path, holder, seq))
            conn = self.sessions.get(holder)
            if conn is None:
                fut.set_result(None)
                holders.pop(holder, None)
            else:
                await conn.send_message(MClientCaps(
                    op=CAP_OP_REVOKE, path=path, mode=mode, cseq=seq))
            waits.append(fut)
        if waits:
            loop = asyncio.get_event_loop()
            deadline = loop.time() + self.revoke_timeout
            try:
                while True:
                    pending = [f for f in waits if not f.done()]
                    if not pending:
                        break
                    slice_t = min(self.lease_timeout,
                                  deadline - loop.time())
                    if slice_t <= 0:
                        raise asyncio.TimeoutError
                    await asyncio.wait(pending, timeout=slice_t)
                    # evict holders whose lease lapsed while we waited:
                    # a dead/hung client must not hold exclusivity
                    # hostage (drop_client_caps resolves its waiters)
                    now = loop.time()
                    for p, holder, seq in keys:
                        fut = self._revoke_waiters.get((p, holder, seq))
                        if fut and not fut.done() and \
                                now - self._session_seen.get(holder, 0) \
                                > self.lease_timeout:
                            log.dout(1, f"evicting client {holder}: "
                                        f"cap lease expired with a "
                                        f"revoke outstanding")
                            # FENCE FIRST (ref: MDS eviction pairs with
                            # an osdmap blocklist): until the OSDs
                            # refuse the zombie's ops, dropping its
                            # caps would let it keep writing under the
                            # stale grant when it resumes. Only after
                            # the blocklist commits do the waiters
                            # resolve and the competing open proceed.
                            try:
                                ret, rs, outbl = await \
                                    self.ioctx.rados.mon_command(
                                        {"prefix": "osd blocklist",
                                         "blocklistop": "add",
                                         "addr": holder})
                            except Exception as e:
                                ret, rs = -1, repr(e)
                            if ret != 0:
                                # NO fence, NO eviction: releasing the
                                # caps without the OSD-level fence
                                # would let the zombie write under its
                                # stale grant. Retry next slice; the
                                # revoke deadline bounds the wait.
                                log.dout(0, f"blocklist of {holder} "
                                            f"failed ({rs}); eviction "
                                            f"deferred")
                                continue
                            # EPOCH BARRIER (ref: upstream eviction's
                            # wait-for-blocklist-epoch): the mon commit
                            # alone is not a fence — an OSD still on a
                            # pre-blocklist map would accept the
                            # zombie's writes. Wait until every OSD
                            # that could serve them has OBSERVED the
                            # blocklist epoch; if that can't be proven
                            # inside the revoke window, keep the caps
                            # (defer, like a failed blocklist).
                            if not await self._blocklist_barrier(
                                    holder, outbl):
                                continue
                            await self._forget_session(holder)
            finally:
                # a holder that never acks must not leak its waiter
                for key in keys:
                    self._revoke_waiters.pop(key, None)

    async def _blocklist_barrier(self, holder: str,
                                 outbl: bytes) -> bool:
        """Wait until the OSDs observe the blocklist epoch (the fence
        is enforced OSD-side against each OSD's OWN map). True when
        proven; False defers the eviction to the next revoke slice."""
        try:
            epoch = int(json.loads(outbl).get("epoch", 0)) if outbl \
                else 0
        except (json.JSONDecodeError, ValueError):
            epoch = 0
        if not epoch:
            # old mon without epoch reporting: nothing to barrier on;
            # keep the pre-barrier behavior rather than deadlocking
            return True
        objecter = getattr(self.ioctx.rados, "objecter", None)
        if objecter is None:
            return True
        try:
            await objecter.wait_for_map_on_osds(
                epoch, timeout=min(self.lease_timeout, 10.0))
            return True
        except Exception as e:
            log.dout(0, f"epoch barrier for {holder} (epoch {epoch}) "
                        f"not reached: {e}; eviction deferred")
            return False

    def _req_task_done(self, t: asyncio.Task) -> None:
        self._req_tasks.discard(t)
        if not t.cancelled() and t.exception() is not None:
            log.dout(0, f"client request task failed: "
                        f"{t.exception()!r}")

    def _req_cap_denied(self, entity: str) -> bool:
        """Per-op MDS cap check (ref: MDSAuthCaps::is_capable, scoped
        to the r/w class like the OSD/mon slices): True when the
        sender has a committed cap table whose ``mds`` spec does not
        grant writes. Capless entities stay unrestricted — the same
        legacy-boot-key policy as the mon command and OSD admission
        checks. The table reaches this daemon through a keyring fed
        by the MAuthUpdate subscription (the monc's in HA mode, an
        explicitly handed one standalone)."""
        kr = None
        if self.monc is not None:
            kr = self.monc.msgr.keyring
        if kr is None:
            kr = self.keyring
        if kr is None or not entity:
            return False
        caps = kr.caps_of(entity)
        if not caps:
            return False
        from ceph_tpu_torch.msg.auth import cap_allows
        return not cap_allows(str(caps.get("mds", "")), "w")

    async def _handle_request(self, m: MClientRequest) -> None:
        if not self._active_event.is_set():
            # not (yet) the active rank: park — clients only target the
            # FSMap's active, so this resolves as the ladder finishes
            # (the task is cancelled if the daemon stops instead)
            await self._active_event.wait()
        m.path = _norm(m.path)          # caps/journal key consistently
        if m.path2:
            m.path2 = _norm(m.path2)
        span = self.tracer.from_msg(
            "mds_op", m, tags={"op": m.op, "path": m.path,
                               "rank": self.rank})
        t0 = time.monotonic()
        # multi-active routing: a request for a subtree this
        # rank does not own is REDIRECTED before the session check — a
        # client aimed at the wrong rank needs the owner's address,
        # not a session here. Frozen subtrees park inside.
        admitted = None
        if self.monc is not None and self.fsmap is not None:
            red = await self._route_or_park(m)
            if red is not None:
                if span is not None:
                    # the -ESTALE hop is a real phase of the op: keep
                    # it in the trace so a cross-rank bounce shows up
                    span.tag("redirect", True)
                    try:
                        span.tag("redirect_to", json.loads(
                            red.payload).get("rank"))
                    except Exception:
                        pass
                    span.finish()
                await m.conn.send_message(red)
                return
            admitted = m._admitted
        try:
            await self._serve_request(m)
        finally:
            if admitted is not None:
                self._inflight_done(admitted)
            if span is not None:
                span.finish()
            MDS_PERF.hist_add("req_latency_hist",
                              (time.monotonic() - t0) * 1e6)

    async def _serve_request(self, m: MClientRequest) -> None:
        if m.src not in self.sessions:
            await m.conn.send_message(MClientReply(
                tid=m.tid, result=-1, payload=b"no session",
                cap_mode=0, cap_seq=0))
            return
        # completed-request dedup (ref: Session::have_completed_request):
        # a mutation replayed after failover must answer from the
        # table, not re-execute — a second rename/unlink would fail and
        # a second create could truncate acknowledged data. The dedup
        # outranks the cap gate below: a mutation that ALREADY applied
        # must keep answering its recorded result even if the entity's
        # caps were narrowed after the fact (the at-most-once contract
        # is about what happened, not what would be admitted today).
        if m.op in MUTATING_OPS:
            done = self._completed.get(m.src)
            if done is not None and m.tid in done:
                await m.conn.send_message(MClientReply(
                    tid=m.tid, result=done[m.tid],
                    payload=b"(replayed)", cap_mode=0, cap_seq=0))
                return
        if m.op in MUTATING_OPS and self._req_cap_denied(m.src):
            # per-op cap enforcement at the request gate (the MDS leg
            # of the OSD's admission check): an
            # `mds r`-only entity's NEW mutation is refused -EPERM
            # before the journal sees it — deterministic and
            # unrecorded, so a replayed refusal re-refuses identically
            await m.conn.send_message(MClientReply(
                tid=m.tid, result=-1,
                payload=b"EPERM: mds caps deny write",
                cap_mode=0, cap_seq=0))
            return
        result, payload, cap_mode, cap_seq = 0, b"", 0, 0
        sp = snap_split(m.path)
        try:
            if sp is not None or (m.path2 and snap_split(m.path2)):
                if sp is None:
                    # rename INTO .snap (src outside): still a mutation
                    # of snapshot namespace
                    raise FSError(EROFS, "snapshots are read-only")
                payload, cap_mode, cap_seq = await self._serve_snap(
                    m, sp)
            elif m.op in ("mkdir", "rmdir", "create", "unlink"):
                await self._journaled_apply({"op": m.op, "path": m.path})
            elif m.op == "rename":
                await self._journaled_apply(
                    {"op": "rename", "path": m.path, "path2": m.path2})
            elif m.op == "setattr":
                await self._journaled_apply(
                    {"op": "setattr", "path": m.path,
                     "size": int(m.flags)})
            elif m.op == "readdir":
                payload = json.dumps(await self.fs.ls(m.path)).encode()
            elif m.op == "stat":
                payload = json.dumps(await self.fs.stat(m.path)).encode()
            elif m.op == "open":
                want = int(m.flags)
                # stat + create-on-open + revoke + grant all under the
                # per-path lock: two concurrent conflicting opens must
                # decide sequentially or both can believe they hold
                # exclusivity — and the existence check must be atomic
                # with the create, or a racing open-w's create (a
                # write_full truncate) can land AFTER the first opener
                # was granted FW and wrote data, destroying an
                # acknowledged write.
                async with self._open_locks.hold(m.path):
                    st = None
                    try:
                        st = await self.fs.stat(m.path)
                    except FSError:
                        if want != CAP_FW:
                            raise
                    if st is not None and st["type"] != "file":
                        raise FSError(-21, "EISDIR")
                    if st is None:                   # create on open-w
                        await self._journaled_apply(
                            {"op": "create", "path": m.path})
                    await self._revoke_conflicting(m.path, m.src,
                                                   want)
                    self._cap_seq += 1
                    cap_seq = self._cap_seq
                    ent = self.caps.setdefault(m.path, {}) \
                        .setdefault(m.src, [0, 0])
                    ent[0] = max(ent[0], want)       # FW absorbs FR
                    ent[1] += 1
                    cap_mode = ent[0]
                    # re-stat AFTER the revoke wait: a writer's
                    # setattr may have landed while we blocked
                    try:
                        st = await self.fs.stat(m.path)
                    except FSError:
                        st = None
                info = {"size": 0 if st is None else st["size"],
                        "oid": _fileobj(m.path)}
                # snap context for writes under a live realm (ref:
                # the SnapContext a Client stamps on OSD writes): the
                # OSD COWs the head into a clone before the first
                # write that carries a snapid it hasn't preserved yet
                sids = self._snaps_governing(m.path)
                if sids:
                    info["snapc"] = [sids[-1], sids[::-1]]
                payload = json.dumps(info).encode()
            else:
                result = -22                          # -EINVAL
        except FSError as e:
            result = e.errno
            payload = str(e).encode()
        except asyncio.TimeoutError:
            result = -110                             # -ETIMEDOUT
            payload = b"cap revoke timed out"
        if m.op in MUTATING_OPS and result != -110:
            # -ETIMEDOUT stays retryable; anything else is this op's
            # final answer and must survive a replay against a
            # successor
            await self._record_completed(m.src, m.tid, result)
        await m.conn.send_message(MClientReply(
            tid=m.tid, result=result, payload=payload,
            cap_mode=cap_mode, cap_seq=cap_seq))
