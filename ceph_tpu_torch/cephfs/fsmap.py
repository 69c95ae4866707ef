"""FSMap: the mon-authoritative MDS cluster membership map.

ref: src/mds/FSMap.h + src/include/fs_types.h (MDSMap::DaemonState) —
the paxos-committed map the MDSMonitor maintains and every MDS/client
subscribes to ("mdsmap"). One filesystem, up to ``max_mds`` active
ranks (round 7): the namespace is partitioned across ranks by the
**subtree map** (directory subtree root -> owning rank, the persistent
analog of the reference's subtree/dirfrag auth delegation), and the
failover ladder runs PER RANK:

    standby -> (standby_replay) -> replay -> reconnect -> rejoin -> active

A daemon is keyed by its **gid** — a per-incarnation id, so a restarted
daemon with the same name is a NEW entity (the reference's mds_gid_t).
``ident`` is the RADOS entity name the incarnation's data-path ops use;
the blocklist fence at failover targets it, so fencing a dead
incarnation never collaterally fences its successor.

``last_failure_osd_epoch`` (ref: MDSMap::last_failure_osd_epoch) is the
osdmap epoch at which the last failed active's blocklist committed; a
promoted standby barriers on it (Objecter.wait_for_map_on_osds) before
touching the journal, so a fenced predecessor can never land a late
journal write after replay began.

Subtree map + migrations (round 7, v2 encoding): ``subtrees`` maps a
normalized subtree root to the rank that serves it; "/" is always
present and defaults to rank 0, and resolution is longest-prefix
(``subtree_owner``) so a deeper pin overrides its ancestors.
``migrations`` records in-flight two-phase subtree handoffs
({path, from, to}) — the authority flip itself is ONLY the paxos
commit that rewrites ``subtrees``, so a migration that dies at any
point simply never moved authority (crash-safe by construction).

The port's copy of ``ceph_tpu/cephfs/fsmap.py``.
"""

from __future__ import annotations

from ceph_tpu_torch.encoding.denc import Decoder, Encoder

# daemon states (ref: MDSMap::DaemonState, the subset this ladder uses)
STATE_STANDBY = "standby"
STATE_STANDBY_REPLAY = "standby_replay"
STATE_REPLAY = "replay"
STATE_RECONNECT = "reconnect"
STATE_REJOIN = "rejoin"
STATE_ACTIVE = "active"
STATE_STOPPED = "stopped"

# the per-rank takeover ladder, in order; a beacon may only advance
# forward along it (ref: MDSMonitor::prepare_beacon state checks)
LADDER = (STATE_REPLAY, STATE_RECONNECT, STATE_REJOIN, STATE_ACTIVE)

# states that hold (or are taking over) a rank — beacon-grace expiry of
# one of these is a FAILOVER, not a standby drop
RANK_STATES = frozenset(LADDER)

# hard ceiling on max_mds (ref: MAX_MDS in the reference's mon checks)
MAX_MDS_CAP = 16


class MDSInfo:
    """One registered daemon incarnation (ref: MDSMap::mds_info_t)."""

    def __init__(self, gid: int, name: str, ident: str = "",
                 host: str = "", port: int = 0,
                 state: str = STATE_STANDBY, rank: int = -1):
        self.gid = gid
        self.name = name
        self.ident = ident          # RADOS entity the fence targets
        self.host = host
        self.port = port
        self.state = state
        self.rank = rank            # -1 = no rank (standby*)

    def addr(self):
        from ceph_tpu_torch.msg import EntityAddr
        return EntityAddr(self.host, self.port)

    def dump(self) -> dict:
        return {"gid": self.gid, "name": self.name, "ident": self.ident,
                "addr": [self.host, self.port], "state": self.state,
                "rank": self.rank}


class FSMap:
    def __init__(self):
        self.epoch = 0
        self.infos: dict[int, MDSInfo] = {}      # gid -> info
        self.failed: list[int] = []              # failed ranks
        self.stopped_gids: list[int] = []        # tombstones (bounded):
        # a failed/removed incarnation may keep beaconing (zombie);
        # its gid must never re-register, or a fenced daemon could
        # climb back to a rank it can no longer write for
        self.last_failure_osd_epoch = 0
        # -- multi-active (v2) --------------------------------------------
        self.max_mds = 1                         # wanted active ranks
        self.subtrees: dict[str, int] = {"/": 0}  # subtree root -> rank
        # in-flight two-phase handoffs: [{"path": root, "from": rank,
        # "to": rank}]; authority flips only when the commit rewrites
        # ``subtrees`` — until then the "from" rank stays authoritative
        self.migrations: list[dict] = []
        # -- fs snapshots (v3, ref: SnapServer's snap table made
        # paxos-durable): snapid -> {"name", "path", "pool"}. The mon is
        # the snap server of record — realms an MDS journals are derived
        # from entries here, so a failover can always rebuild. snapids
        # come from the data pool's selfmanaged-snap allocator and are
        # never reused (pool snap_seq is monotonic).
        self.snaps: dict[int, dict] = {}

    # -- queries -----------------------------------------------------------
    def by_name(self, name: str) -> MDSInfo | None:
        return next((i for i in self.infos.values() if i.name == name),
                    None)

    def rank_holder(self, rank: int = 0) -> MDSInfo | None:
        """The daemon holding (or laddering toward) ``rank``."""
        return next((i for i in self.infos.values()
                     if i.rank == rank and i.state in RANK_STATES),
                    None)

    def active(self, rank: int = 0) -> MDSInfo | None:
        i = self.rank_holder(rank)
        return i if i is not None and i.state == STATE_ACTIVE else None

    def actives(self) -> dict[int, MDSInfo]:
        """rank -> active info for every rank currently serving."""
        return {i.rank: i for i in self.infos.values()
                if i.state == STATE_ACTIVE and i.rank >= 0}

    def rank_holders(self) -> dict[int, MDSInfo]:
        return {i.rank: i for i in self.infos.values()
                if i.state in RANK_STATES and i.rank >= 0}

    def standbys(self) -> list[MDSInfo]:
        return sorted((i for i in self.infos.values()
                       if i.state in (STATE_STANDBY,
                                      STATE_STANDBY_REPLAY)),
                      key=lambda i: (i.state != STATE_STANDBY_REPLAY,
                                     i.gid))

    def subtree_owner(self, path: str) -> tuple[int, str]:
        """(owning rank, matched subtree root) for ``path`` by
        longest-prefix match — the routing primitive clients and the
        per-rank ownership check share. ``path`` must be normalized
        ("/a/b"); "/" always matches."""
        best_root, best_rank = "/", self.subtrees.get("/", 0)
        for root, rank in self.subtrees.items():
            if root == "/":
                continue
            if (path == root or path.startswith(root + "/")) and \
                    len(root) > len(best_root):
                best_root, best_rank = root, rank
        return best_rank, best_root

    def migration_for(self, path: str) -> dict | None:
        return next((m for m in self.migrations
                     if m["path"] == path), None)

    def is_stopped(self, gid: int) -> bool:
        return gid in self.stopped_gids

    def tombstone(self, gid: int, keep: int = 64) -> None:
        self.stopped_gids.append(gid)
        del self.stopped_gids[:-keep]

    def dump(self) -> dict:
        holders = self.rank_holders()
        return {
            "epoch": self.epoch,
            "max_mds": self.max_mds,
            "ranks": [holders[r].dump() for r in sorted(holders)],
            "standbys": [i.dump() for i in self.standbys()],
            "failed": sorted(self.failed),
            "stopped_gids": list(self.stopped_gids),
            "last_failure_osd_epoch": self.last_failure_osd_epoch,
            "subtrees": dict(sorted(self.subtrees.items())),
            "migrations": [dict(m) for m in self.migrations],
            "snaps": {sid: dict(s)
                      for sid, s in sorted(self.snaps.items())},
            "states": {i.name: i.state for i in self.infos.values()},
        }

    def snaps_under(self, path: str) -> dict[int, dict]:
        """snapid -> entry for every snapshot whose realm root is
        ``path`` or an ancestor of it — the set whose snap context
        governs writes at ``path`` (ref: SnapRealm::get_snap_context
        walking parent realms)."""
        return {sid: s for sid, s in self.snaps.items()
                if path == s["path"] or
                path.startswith(s["path"].rstrip("/") + "/")}

    # -- codec -------------------------------------------------------------
    def encode(self) -> bytes:
        e = Encoder()
        with e.start(3):                 # v3: + snaps
            e.u64(self.epoch)
            e.map(self.infos, lambda e, k: e.u64(k),
                  lambda e, i: (e.u64(i.gid).string(i.name)
                                .string(i.ident).string(i.host)
                                .u32(i.port).string(i.state)
                                .s32(i.rank)))
            e.list(self.failed, lambda e, v: e.s32(v))
            e.list(self.stopped_gids, lambda e, v: e.u64(v))
            e.u64(self.last_failure_osd_epoch)
            e.u32(self.max_mds)                            # v2
            e.map(self.subtrees, lambda e, k: e.string(k),  # v2
                  lambda e, v: e.s32(v))
            e.list(self.migrations,                        # v2
                   lambda e, m: (e.string(m["path"])
                                 .s32(m["from"]).s32(m["to"])))
            e.map(self.snaps, lambda e, k: e.u64(k),       # v3
                  lambda e, s: (e.string(s["name"])
                                .string(s["path"])
                                .string(s["pool"])))
        return e.tobytes()

    @classmethod
    def decode(cls, data: bytes) -> "FSMap":
        def info(d: Decoder) -> MDSInfo:
            return MDSInfo(gid=d.u64(), name=d.string(),
                           ident=d.string(), host=d.string(),
                           port=d.u32(), state=d.string(),
                           rank=d.s32())
        m = cls()
        d = Decoder(data)
        with d.start(3) as v:
            m.epoch = d.u64()
            m.infos = d.map(lambda d: d.u64(), info)
            m.failed = d.list(lambda d: d.s32())
            m.stopped_gids = d.list(lambda d: d.u64())
            m.last_failure_osd_epoch = d.u64()
            if v >= 2:
                m.max_mds = d.u32()
                m.subtrees = d.map(lambda d: d.string(),
                                   lambda d: d.s32())
                m.migrations = d.list(
                    lambda d: {"path": d.string(), "from": d.s32(),
                               "to": d.s32()})
            if v >= 3:
                m.snaps = d.map(
                    lambda d: d.u64(),
                    lambda d: {"name": d.string(), "path": d.string(),
                               "pool": d.string()})
        m.subtrees.setdefault("/", 0)     # v1 blob / invariant repair
        return m
