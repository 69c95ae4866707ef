"""MDSMonitor: the FSMap's PaxosService.

ref: src/mon/MDSMonitor.{h,cc} — owns the authoritative FSMap, turns
MDSBeacons into state-ladder commits (MDSMonitor::prepare_beacon),
and runs the beacon-grace tick that makes failover happen
(MDSMonitor::tick): a silent rank holder is FENCED (its incarnation's
RADOS identity blocklisted in the osdmap — the fourth paxos commit in
this file composes with the OSDMonitor's) and a standby is promoted
into the replay -> reconnect -> rejoin -> active ladder.

The fencing invariant (blocklist-before-promote): the FSMap commit
that hands the rank to a standby happens only AFTER the blocklist
commit, and carries that commit's osdmap epoch
(``last_failure_osd_epoch``) so the promoted daemon can barrier on the
OSDs observing it before touching the journal. A dead active that
wakes up later can therefore never land a journal or dirfrag write —
the OSDs refuse its entity outright.

Multi-active (round 7): `fs set max_mds N` opens ranks 1..N-1; the
tick fills every open rank from the standby pool through the same
per-rank ladder, and the subtree map partitions the namespace across
the actives. Subtree authority moves through a two-phase migration —
the mon commits an INTENT ({path, from, to} in FSMap.migrations), the
exporting rank freezes + hands caps/completed-tables to the importer,
and only the MMDSMigrationDone-driven commit that rewrites
``subtrees`` flips authority, so a crash on either side (or the mon)
leaves the subtree where it was. A load-based **rebalancer** on the
tick consumes the per-rank op counters beacons carry and migrates the
hottest subtree off an overloaded rank (ref: the MDBalancer's
mds_load_t exchange, collapsed onto the mon since it already sees
every beacon).

The port's copy of ``ceph_tpu/mon/mds_monitor.py``.
"""

from __future__ import annotations

import asyncio
import json

from ceph_tpu_torch.cephfs.fsmap import (
    FSMap, LADDER, MAX_MDS_CAP, RANK_STATES, STATE_ACTIVE,
    STATE_REPLAY, STATE_STANDBY, STATE_STANDBY_REPLAY,
)
from ceph_tpu_torch.mon.messages import MDSBeacon, MMDSMigrationDone
from ceph_tpu_torch.mon.service import PaxosService
from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("mon")

PFX = "fsmap"


class MDSMonitor(PaxosService):
    prefix = PFX

    def __init__(self, mon) -> None:
        super().__init__(mon)
        self.fsmap = FSMap()
        # gid -> last beacon loop-time (leader memory, not paxos: a new
        # leader restamps everyone on_active so a mon election never
        # manufactures a spurious MDS failover)
        self.last_beacon: dict[int, float] = {}
        self.beacon_grace = mon.config.get("mds_beacon_grace", 5.0)
        self._last_tick = 0.0
        self._lock = asyncio.Lock()
        # -- rebalancer state (leader memory, not paxos) ---------------
        # gid -> (loop time, cumulative ops, {prefix: cumulative ops})
        # from the last beacon; rank_rates are the derived ops/s the
        # rebalancer and the observability surface consume
        self._load_samples: dict[int, tuple] = {}
        self.rank_rates: dict[int, float] = {}
        self.subtree_rates: dict[int, dict[str, float]] = {}
        self._last_balance = 0.0
        self.refresh()

    # -- state -------------------------------------------------------------
    def last_epoch(self) -> int:
        return self.store.get_u64(PFX, "last_epoch")

    def refresh(self) -> None:
        last = self.last_epoch()
        if last and self.fsmap.epoch < last:
            blob = self.store.get(PFX, f"full_{last:08x}")
            if blob is not None:
                self.fsmap = FSMap.decode(blob)

    async def on_active(self) -> None:
        now = asyncio.get_event_loop().time()
        for gid in self.fsmap.infos:
            self.last_beacon[gid] = now

    async def _propose_change(self, build) -> tuple[bool, object]:
        """Commit one FSMap change. ``build(clone) -> (fsmap, result)
        | None`` mutates a CLONE under the serialization lock, so a
        failed proposal never corrupts the in-memory map and
        concurrent handlers never interleave epochs."""
        async with self._lock:
            cur = self.fsmap
            out = build(FSMap.decode(cur.encode()))
            if out is None:
                return False, None
            new, result = out
            new.epoch = cur.epoch + 1
            t = self.store.transaction()
            t.set(PFX, f"full_{new.epoch:08x}", new.encode())
            self.store.put_u64(t, PFX, "last_epoch", new.epoch)
            ok = await self.mon.propose_txn(t)
            return ok, result

    # -- beacons -----------------------------------------------------------
    async def handle(self, msg) -> None:
        if isinstance(msg, MDSBeacon):
            await self._handle_beacon(msg)
        elif isinstance(msg, MMDSMigrationDone):
            await self._handle_migration_done(msg)

    def _sample_load(self, m: MDSBeacon) -> None:
        """Derive per-rank ops/s from the beacon's cumulative counters
        (two-sample slope; leader memory only)."""
        now = asyncio.get_event_loop().time()
        prev = self._load_samples.get(m.gid)
        self._load_samples[m.gid] = (now, m.ops, dict(m.subtree_ops))
        info = self.fsmap.infos.get(m.gid)
        if prev is None or info is None or info.rank < 0:
            return
        t0, ops0, sub0 = prev
        dt = now - t0
        if dt <= 0 or m.ops < ops0:       # restarted counter: resample
            return
        self.rank_rates[info.rank] = (m.ops - ops0) / dt
        self.subtree_rates[info.rank] = {
            pfx: (cnt - sub0.get(pfx, 0)) / dt
            for pfx, cnt in m.subtree_ops.items()
            if cnt >= sub0.get(pfx, 0)}

    async def _handle_beacon(self, m: MDSBeacon) -> None:
        if self.fsmap.is_stopped(m.gid):
            # a fenced/removed incarnation keeps beaconing: it must
            # never re-register (it cannot write past its blocklist)
            return
        self.last_beacon[m.gid] = asyncio.get_event_loop().time()
        self._sample_load(m)
        info = self.fsmap.infos.get(m.gid)
        if info is None:
            def build(fm: FSMap):
                if fm.is_stopped(m.gid) or m.gid in fm.infos:
                    return None
                from ceph_tpu_torch.cephfs.fsmap import MDSInfo
                fm.infos[m.gid] = MDSInfo(
                    gid=m.gid, name=m.name, ident=m.ident,
                    host=m.addr_host, port=m.addr_port,
                    state=STATE_STANDBY, rank=-1)
                return fm, None
            ok, _ = await self._propose_change(build)
            if ok:
                log.dout(1, f"mds.{m.name} (gid {m.gid}) registered "
                            f"standby")
            return
        if m.state == info.state:
            return
        # ladder advance (ref: prepare_beacon): any FORWARD distance is
        # accepted, not just one rung — the daemon climbs locally
        # without waiting for each commit to publish, so back-to-back
        # rungs (an empty reconnect window), a lost beacon, or a mon
        # leader change can leave the map several rungs behind; a
        # strictly-one-rung check would wedge the map short of active
        # forever (every later beacon repeats the final state)
        if info.state in LADDER and m.state in LADDER and \
                LADDER.index(m.state) > LADDER.index(info.state):
            def build(fm: FSMap):
                i = fm.infos.get(m.gid)
                if i is None or i.state != info.state:
                    return None
                i.state = m.state
                return fm, None
            ok, _ = await self._propose_change(build)
            if ok:
                log.dout(1, f"mds.{m.name} {info.state} -> {m.state}")

    async def _handle_migration_done(self, m: MMDSMigrationDone) -> None:
        """Commit the authority flip for a finished subtree handoff.
        The flip is idempotent (the exporter re-sends Done until it
        observes the new map) and guarded: the sender must still hold
        the from-rank and the migration entry must still be live —
        a handoff the mon already aborted (exporter failed mid-way)
        must not flip late."""
        def build(fm: FSMap):
            mig = next((g for g in fm.migrations
                        if g["path"] == m.path and
                        g["from"] == m.from_rank and
                        g["to"] == m.to_rank), None)
            if mig is None:
                return None
            holder = fm.infos.get(m.gid)
            if holder is None or holder.rank != m.from_rank:
                return None
            fm.migrations.remove(mig)
            fm.subtrees[m.path] = m.to_rank
            return fm, None
        ok, _ = await self._propose_change(build)
        if ok:
            self.mon.clog("INF", f"mds: subtree {m.path} migrated "
                                 f"rank {m.from_rank} -> {m.to_rank}")
            log.dout(1, f"subtree {m.path} authority flipped to rank "
                        f"{m.to_rank}")

    # -- tick --------------------------------------------------------------
    async def tick(self) -> None:
        now = asyncio.get_event_loop().time()
        if self._last_tick and now - self._last_tick > \
                self.beacon_grace:
            # the MON itself stalled (event-loop hiccup — e.g. a first
            # CRUSH-mapper jit compile blocks every coroutine in this
            # in-process cluster): every beacon timestamp is equally
            # stale evidence, so restamp instead of mass-failing the
            # whole MDS cluster off our own clock skew
            for gid in list(self.last_beacon):
                self.last_beacon[gid] = now
        self._last_tick = now
        fm = self.fsmap
        # beacon grace: silent daemons are removed; a silent RANK
        # holder is a failover (fence first)
        for gid, info in list(fm.infos.items()):
            last = self.last_beacon.get(gid)
            if last is None:
                self.last_beacon[gid] = now
                continue
            if now - last <= self.beacon_grace:
                continue
            log.dout(1, f"mds.{info.name} (gid {gid}, "
                        f"{info.state}) missed beacon grace "
                        f"({self.beacon_grace}s)")
            await self.fail_mds(gid)
        fm = self.fsmap
        # every rank < max_mds is filled the moment a standby exists —
        # covering the very first boot (rank never held; ref: the fs
        # creation assigning its first MDS), a standby registering
        # after a rank failed, and freshly opened ranks after
        # `fs set max_mds` raised the count
        for rank in range(fm.max_mds):
            fm = self.fsmap
            if fm.rank_holder(rank) is None and fm.standbys():
                await self._promote(rank)
        await self._gc_migrations()
        await self._maybe_rebalance()
        # standby_replay assignment: one warm follower while an active
        # exists (ref: MDSMonitor maybe_promote_standby / the
        # allow_standby_replay fs flag)
        fm = self.fsmap
        # read live from the shared config dict so a served cluster
        # can flip it at runtime
        standby_replay = self.mon.config.get("mds_standby_replay",
                                             False)
        if standby_replay and fm.active() is not None and \
                not any(i.state == STATE_STANDBY_REPLAY
                        for i in fm.infos.values()):
            cand = next((i for i in fm.standbys()
                         if i.state == STATE_STANDBY), None)
            if cand is not None:
                def build(f: FSMap):
                    i = f.infos.get(cand.gid)
                    if i is None or i.state != STATE_STANDBY or \
                            f.active() is None:
                        return None
                    i.state = STATE_STANDBY_REPLAY
                    return f, None
                ok, _ = await self._propose_change(build)
                if ok:
                    log.dout(1, f"mds.{cand.name} -> standby_replay")

    async def fail_mds(self, gid: int) -> bool:
        """Remove one incarnation; a rank holder is blocklisted FIRST
        (the fencing invariant) and its rank marked failed. Promotion
        happens in the same commit when a standby is available."""
        info = self.fsmap.infos.get(gid)
        if info is None:
            return False
        epoch = 0
        if info.state in RANK_STATES and info.ident:
            ret, rs, outbl = await self.mon.osdmon.handle_command(
                {"prefix": "osd blocklist", "blocklistop": "add",
                 "addr": info.ident}, b"")
            if ret != 0:
                # NO fence, NO failover: promoting without the fence
                # would let the silent-but-alive daemon keep writing
                # the journal under a rank it no longer holds. The
                # next tick retries.
                log.dout(0, f"blocklist of {info.ident} failed ({rs});"
                            f" mds failover deferred")
                return False
            try:
                epoch = int(json.loads(outbl).get("epoch", 0))
            except (json.JSONDecodeError, ValueError):
                epoch = 0
            log.dout(1, f"fenced mds.{info.name} ({info.ident}) at "
                        f"osdmap epoch {epoch}")

        def build(fm: FSMap):
            i = fm.infos.pop(gid, None)
            if i is None:
                return None
            fm.tombstone(gid)
            if i.state in RANK_STATES:
                rank = max(i.rank, 0)
                # a rank RETIRED past max_mds (fs set max_mds lowered
                # it) is fenced but not a failover: it must neither
                # enter fm.failed (a permanent spurious FS_DEGRADED —
                # only _promote for ranks < max_mds ever clears
                # entries) nor consume a standby (a promoted holder of
                # a rank no client routes to would strand the pool)
                retired = rank >= fm.max_mds
                if not retired and rank not in fm.failed:
                    fm.failed.append(rank)
                if epoch:
                    fm.last_failure_osd_epoch = epoch
                # abort in-flight subtree handoffs touching this rank:
                # authority never moved (the flip is a separate
                # commit), so dropping the intent leaves every subtree
                # exactly where the survivors believe it is
                fm.migrations = [m for m in fm.migrations
                                 if rank not in (m["from"], m["to"])]
                # blocklist-before-promote holds: the fence committed
                # above, so the successor may ride this same commit
                cand = next(iter(fm.standbys()), None) \
                    if not retired else None
                if cand is not None:
                    cand.state = STATE_REPLAY
                    cand.rank = rank
                    fm.failed.remove(rank)
            return fm, i
        ok, removed = await self._propose_change(build)
        if ok and removed is not None:
            self.last_beacon.pop(gid, None)
            log.dout(1, f"mds.{removed.name} (gid {gid}) removed"
                        + (f"; rank {removed.rank} failover begun"
                           if removed.state in RANK_STATES else ""))
        return ok

    async def _promote(self, rank: int) -> None:
        def build(fm: FSMap):
            if fm.rank_holder(rank) is not None:
                return None
            cand = next(iter(fm.standbys()), None)
            if cand is None:
                return None
            cand.state = STATE_REPLAY
            cand.rank = rank
            if rank in fm.failed:
                fm.failed.remove(rank)
            return fm, cand.name
        ok, name = await self._propose_change(build)
        if ok and name:
            log.dout(1, f"mds.{name} promoted to rank {rank} (replay)")

    # -- subtree migration lifecycle ---------------------------------------
    @staticmethod
    def _dead_migrations(fm: FSMap) -> list[dict]:
        """Migrations that can no longer complete: an endpoint rank has
        no holder (its daemon failed — the fence path already dropped
        its per-rank entries, this is the safety net for races) or was
        retired past max_mds. Aborting = just removing the entry:
        authority never moved, the exporter unfreezes when it sees the
        entry gone."""
        holders = fm.rank_holders()
        return [m for m in fm.migrations
                if m["from"] not in holders or m["to"] not in holders
                or m["to"] >= fm.max_mds or m["from"] >= fm.max_mds]

    async def _gc_migrations(self) -> None:
        if not self._dead_migrations(self.fsmap):
            return

        def build(fm: FSMap):
            dead = self._dead_migrations(fm)
            if not dead:
                return None
            for m in dead:
                fm.migrations.remove(m)
            return fm, dead
        ok, dead = await self._propose_change(build)
        if ok and dead:
            for m in dead:
                log.dout(1, f"aborted subtree migration {m['path']} "
                            f"rank {m['from']} -> {m['to']} (endpoint "
                            f"gone)")

    async def start_migration(self, path: str, to_rank: int
                              ) -> tuple[int, str]:
        """Commit the intent phase of a subtree handoff (operator pin
        or rebalancer). Authority does NOT move here — the exporting
        rank sees the entry in its next fsmap publish and runs the
        freeze/export exchange."""
        from ceph_tpu_torch.cephfs import _norm
        path = _norm(path)
        fm = self.fsmap
        if to_rank < 0 or to_rank >= fm.max_mds:
            return -22, f"rank {to_rank} out of range (max_mds " \
                        f"{fm.max_mds})"
        owner, root = fm.subtree_owner(path)
        if path == root and owner == to_rank:
            return 0, f"subtree {path} already owned by rank {to_rank}"
        holders = fm.rank_holders()
        if to_rank not in holders or \
                holders[to_rank].state != STATE_ACTIVE:
            return -11, f"rank {to_rank} has no active holder yet"
        if owner not in holders:
            # nothing to hand off (owner rank has no daemon at all):
            # direct commit — there are no caps or in-flight ops to
            # move and no exporter to run the protocol
            def build(f: FSMap):
                o, _ = f.subtree_owner(path)
                if o in f.rank_holders():
                    return None
                f.subtrees[path] = to_rank
                return f, None
            ok, _ = await self._propose_change(build)
            return (0, f"subtree {path} assigned to rank {to_rank} "
                       f"(previous owner had no daemon)") if ok else \
                   (-11, "proposal failed")

        def build(f: FSMap):
            o, r = f.subtree_owner(path)
            if r == path and o == to_rank:
                return None
            if f.migration_for(path) is not None:
                return None
            f.migrations.append(
                {"path": path, "from": o, "to": to_rank})
            return f, o
        ok, frm = await self._propose_change(build)
        if not ok:
            if self.fsmap.migration_for(path) is not None:
                return -11, f"a migration of {path} is already in " \
                            f"flight"
            return -11, "proposal failed"
        log.dout(1, f"subtree migration {path}: rank {frm} -> "
                    f"{to_rank} (intent committed)")
        return 0, f"migrating subtree {path} from rank {frm} to " \
                  f"rank {to_rank}"

    async def _maybe_rebalance(self) -> None:
        """Load-based subtree rebalancer (ref: MDBalancer, mon-side):
        every ``mds_bal_interval`` compare per-rank op rates; when the
        hottest active rank exceeds the coldest by
        ``mds_bal_ratio`` (and clears ``mds_bal_min_ops``), migrate
        its hottest non-root load prefix to the coldest rank. One
        migration at a time — the storm of tiny migrations upstream's
        balancer is notorious for is exactly what the interval +
        single-flight guard prevents."""
        cfg = self.mon.config
        interval = cfg.get("mds_bal_interval", 10.0)
        if not interval or interval <= 0:
            return
        now = asyncio.get_event_loop().time()
        if now - self._last_balance < interval:
            return
        fm = self.fsmap
        if fm.migrations or fm.max_mds < 2:
            return
        actives = fm.actives()
        if len(actives) < 2:
            return
        rates = {r: self.rank_rates.get(r, 0.0) for r in actives}
        hot = max(rates, key=rates.get)
        cold = min(rates, key=rates.get)
        min_ops = cfg.get("mds_bal_min_ops", 20.0)
        ratio = cfg.get("mds_bal_ratio", 4.0)
        if hot == cold or rates[hot] < min_ops or \
                rates[hot] <= ratio * (rates[cold] + 1.0):
            return
        # hottest migratable prefix on the hot rank: never "/" itself
        # (that would move everything), never a prefix it doesn't own
        cands = {
            pfx: rate
            for pfx, rate in self.subtree_rates.get(hot, {}).items()
            if pfx != "/" and fm.subtree_owner(pfx)[0] == hot}
        if not cands:
            return
        victim = max(cands, key=cands.get)
        self._last_balance = now
        ret, rs = await self.start_migration(victim, cold)
        if ret == 0:
            self.mon.clog(
                "INF", f"mds rebalancer: migrating {victim} "
                       f"(rank {hot} at {rates[hot]:.0f} op/s, rank "
                       f"{cold} at {rates[cold]:.0f} op/s)")
        else:
            log.dout(1, f"rebalancer migration refused: {rs}")

    # -- commands ----------------------------------------------------------
    def summary(self) -> dict:
        fm = self.fsmap
        holder = fm.rank_holder(0)
        holders = fm.rank_holders()
        return {
            "epoch": fm.epoch,
            "max_mds": fm.max_mds,
            "up": {f"mds_{r}": holders[r].name
                   for r in sorted(holders)},
            "active": holder.name
            if holder and holder.state == STATE_ACTIVE else None,
            "actives": {r: i.name for r, i in
                        sorted(fm.actives().items())},
            "state": holder.state if holder else
            ("failed" if fm.failed else "none"),
            "failed": sorted(fm.failed),
            "standby_count": len(fm.standbys()),
            "subtrees": dict(sorted(fm.subtrees.items())),
            "migrations": [dict(m) for m in fm.migrations],
            "rank_ops_rate": {r: round(self.rank_rates.get(r, 0.0), 1)
                              for r in sorted(holders)},
            "states": {i.name: i.state for i in fm.infos.values()},
            # round 20: the snap service's registry size (prometheus
            # renders ceph_snap_registered from it)
            "num_snaps": len(fm.snaps),
        }

    async def _cmd_set_max_mds(self, cmd):
        """`fs set max_mds <n>` (ref: Filesystem::set_max_mds via
        MDSMonitor prepare_command). Raising opens ranks the tick
        fills from standbys. Lowering retires the top ranks: their
        subtrees are reassigned to rank 0 in the SAME commit (clients
        re-route immediately) and the displaced holders are then
        fenced through the normal failover path — honest
        simplification vs upstream's graceful journal-flush stop,
        documented in cephfs/README.md."""
        try:
            n = int(cmd.get("val", cmd.get("max_mds")))
        except (TypeError, ValueError):
            return -22, "usage: fs set max_mds <n>", b""
        if n < 1 or n > MAX_MDS_CAP:
            return -22, f"max_mds must be in [1, {MAX_MDS_CAP}]", b""

        def build(fm: FSMap):
            old = fm.max_mds
            if old == n:
                return None
            fm.max_mds = n
            if n < old:
                # reassign subtrees owned by retired ranks; drop
                # migrations touching them (abort = no authority move)
                for root, rank in list(fm.subtrees.items()):
                    if rank >= n:
                        fm.subtrees[root] = 0
                fm.migrations = [m for m in fm.migrations
                                 if m["from"] < n and m["to"] < n]
                fm.failed = [r for r in fm.failed if r < n]
            return fm, None
        ok, _ = await self._propose_change(build)
        if not ok:
            if self.fsmap.max_mds == n:
                return 0, f"max_mds already {n}", b""
            return -11, "proposal failed", b""
        # fence holders of retired ranks (blocklist-first ladder) so a
        # displaced active cannot keep journaling under a rank clients
        # no longer route to
        for gid, info in list(self.fsmap.infos.items()):
            if info.state in RANK_STATES and info.rank >= n:
                await self.fail_mds(gid)
        self.mon.clog("INF", f"fs max_mds set to {n}")
        return 0, f"max_mds set to {n}", b""

    # -- fs snapshots (ref: SnapServer made a mon service: the snap
    # table is paxos-durable here, not journaled per-MDS, so realms
    # survive any MDS failover by construction) ------------------------
    async def _cmd_snap_create(self, cmd):
        """`fs snap create <path> <name> <pool>`: allocate a snapid
        from the data pool's self-managed allocator (snap_seq bump —
        monotonic, never reused) and commit the realm entry into the
        FSMap in the same breath. The MDS calls this on
        `mkdir .snap/<name>`; the CLI can drive it directly."""
        path = str(cmd.get("path", "")).rstrip("/") or "/"
        name = str(cmd.get("name", ""))
        pool = str(cmd.get("pool", ""))
        if not name or not pool or "/" in name:
            return -22, "usage: fs snap create <path> <name> <pool>", \
                b""
        if any(s["path"] == path and s["name"] == name
               for s in self.fsmap.snaps.values()):
            return -17, f"snapshot {name!r} exists at {path}", b""
        ret, rs, outbl = await self.mon.osdmon.handle_command(
            {"prefix": "osd pool selfmanaged-snap-create",
             "pool": pool}, b"")
        if ret != 0:
            return ret, f"snapid allocation failed: {rs}", b""
        sid = int(json.loads(outbl)["snapid"])

        def build(fm: FSMap):
            if sid in fm.snaps or any(
                    s["path"] == path and s["name"] == name
                    for s in fm.snaps.values()):
                return None
            fm.snaps[sid] = {"name": name, "path": path, "pool": pool}
            return fm, None
        ok, _ = await self._propose_change(build)
        if not ok:
            # the allocated sid leaks (snap_seq already advanced) —
            # harmless: snapids are an infinite namespace and nothing
            # references an unregistered one
            return -11, "proposal failed", b""
        self.mon.clog("INF", f"fs snap {name!r} created at {path} "
                             f"(snapid {sid})")
        return 0, "", json.dumps({"snapid": sid}).encode()

    async def _cmd_snap_rm(self, cmd):
        """`fs snap rm <path> <name>`: drop the realm entry and queue
        the snapid into the pool's removed_snaps (rides the osdmap;
        every OSD trims the snap's clones in the background)."""
        path = str(cmd.get("path", "")).rstrip("/") or "/"
        name = str(cmd.get("name", ""))
        entry = next(((sid, s) for sid, s in self.fsmap.snaps.items()
                      if s["path"] == path and s["name"] == name), None)
        if entry is None:
            return -2, f"no snapshot {name!r} at {path}", b""
        sid, s = entry
        ret, rs, _ = await self.mon.osdmon.handle_command(
            {"prefix": "osd pool selfmanaged-snap-remove",
             "pool": s["pool"], "snapid": sid}, b"")
        if ret != 0:
            return ret, f"snap removal failed: {rs}", b""

        def build(fm: FSMap):
            if fm.snaps.pop(sid, None) is None:
                return None
            return fm, None
        ok, _ = await self._propose_change(build)
        if not ok:
            return -11, "proposal failed", b""
        self.mon.clog("INF", f"fs snap {name!r} at {path} removed "
                             f"(snapid {sid})")
        return 0, f"removed snapshot {name!r}", b""

    async def handle_command(self, cmd, inbl=b""):
        prefix = cmd.get("prefix", "")
        if prefix in ("fs status", "fs dump", "mds dump"):
            out = self.fsmap.dump()
            out["rank_ops_rate"] = {
                str(r): round(v, 1)
                for r, v in sorted(self.rank_rates.items())}
            return 0, "", json.dumps(out).encode()
        if prefix == "fs set":
            var = str(cmd.get("var", "max_mds"))
            if var != "max_mds":
                return -22, f"unknown fs var {var!r}", b""
            return await self._cmd_set_max_mds(cmd)
        if prefix == "fs subtree pin":
            path = str(cmd.get("path", ""))
            try:
                rank = int(cmd.get("rank"))
            except (TypeError, ValueError):
                return -22, "usage: fs subtree pin <path> <rank>", b""
            if not path:
                return -22, "usage: fs subtree pin <path> <rank>", b""
            ret, rs = await self.start_migration(path, rank)
            return ret, rs, b""
        if prefix == "fs subtree ls":
            return 0, "", json.dumps({
                "subtrees": dict(sorted(self.fsmap.subtrees.items())),
                "migrations": [dict(m) for m in
                               self.fsmap.migrations]}).encode()
        if prefix == "fs snap create":
            return await self._cmd_snap_create(cmd)
        if prefix == "fs snap rm":
            return await self._cmd_snap_rm(cmd)
        if prefix == "fs snap ls":
            path = str(cmd.get("path", "")) or None
            snaps = {sid: dict(s)
                     for sid, s in sorted(self.fsmap.snaps.items())
                     if path is None or s["path"] == path}
            return 0, "", json.dumps({"snaps": snaps}).encode()
        if prefix == "mds fail":
            who = str(cmd.get("who", ""))
            info = None
            if who.isdigit() and int(who) in self.fsmap.infos:
                info = self.fsmap.infos[int(who)]
            else:
                info = self.fsmap.by_name(who)
            if info is None:
                return -2, f"mds {who!r} not found", b""     # -ENOENT
            ok = await self.fail_mds(info.gid)
            if not ok:
                return -11, f"failed to fail mds {who!r} (fence or " \
                            f"proposal did not commit)", b""
            return 0, f"failed mds gid {info.gid}", b""
        return -22, f"unknown command {prefix!r}", b""
