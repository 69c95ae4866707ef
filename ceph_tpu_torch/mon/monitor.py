"""Monitor daemon: quorum membership, paxos, services, command entry.

ref: src/mon/Monitor.{h,cc} — the daemon that glues Elector + Paxos +
PaxosServices behind one messenger. Command handling mirrors
Monitor::handle_command (clients may hit any mon; peons redirect to the
leader); map subscriptions mirror Monitor::handle_subscribe +
send_latest; fire-and-forget OSD reports are forwarded leader-ward like
MForward does.

The port's copy of ``ceph_tpu/mon/monitor.py``. A ``Monitor`` decodes
its maps onto ``device`` (CUDA unless ``device="cpu"``; it raises
without a card), so the mon's own placement reads (`osd map`, `osd
df`, `pg repair`) run the CRUSH kernel there; a commit maps nothing.
"""

from __future__ import annotations

import asyncio
import json

from ceph_tpu_torch.encoding.denc import Decoder, Encoder
from ceph_tpu_torch.mon.elector import Elector
from ceph_tpu_torch.mon.messages import (
    MAuthUpdate, MConfigMap, MCrashReport, MDSBeacon, MLog, MMDSMap,
    MMDSMigrationDone,
    MMgrBeacon, MMgrDigest, MMgrMap, MMonCommand, MMonCommandAck,
    MMonElection, MMonGetOSDMap, MMonMap, MMonPaxos,
    MMonProposeForward, MMonSubscribe, MOSDAlive, MOSDBoot,
    MOSDFailure, MOSDMap, MOSDMarkMeDown, MOSDPGReadyToMerge, MPGStats,
    MTraceReport, PAXOS_ACCEPT, PAXOS_BEGIN, PAXOS_CATCHUP, PAXOS_COLLECT,
    PAXOS_LAST, PAXOS_LEASE,
)
from ceph_tpu_torch.mon.paxos import Paxos
from ceph_tpu_torch.mon.store import MonitorDBStore
from ceph_tpu_torch.msg import (Dispatcher, EntityAddr, Keyring, Messenger,
                                Policy)
from ceph_tpu_torch.utils.device import resolve
from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("mon")


class MonMap:
    """ref: src/mon/MonMap.h — name -> (rank, addr).

    Round 6: the monmap is a VERSIONED paxos artifact (MonmapMonitor),
    so it carries an epoch (v2 encoding) and membership can change at
    runtime — `ceph mon add/rm` commits a new epoch, quorum re-forms
    through the elector, and clients follow via the ``monmap``
    subscription."""

    def __init__(self, fsid: str = "tpu-cluster"):
        self.fsid = fsid
        self.epoch = 0
        self.mons: dict[str, tuple[int, str, int]] = {}
        # highest rank EVER assigned in this lineage — persisted in
        # the encoding so removal of the highest-ranked member can't
        # recycle its rank (next_rank's never-reuse invariant)
        self.max_rank = -1

    def add(self, name: str, rank: int, host: str, port: int) -> None:
        self.mons[name] = (rank, host, port)
        self.max_rank = max(self.max_rank, rank)

    def clone(self) -> "MonMap":
        return MonMap.decode(self.encode())

    def next_rank(self) -> int:
        """Rank for a joining mon: ranks are never reused within one
        map lineage (a removed rank stays retired — ``max_rank``
        remembers it even after the member left the map), so peers
        can't confuse a new member with a removed one's stale
        messages."""
        return max(self.max_rank,
                   *(r for r, _, _ in self.mons.values()),
                   -1) + 1

    def ranks(self) -> list[int]:
        return sorted(r for r, _, _ in self.mons.values())

    def addr_of_rank(self, rank: int) -> EntityAddr:
        for r, host, port in self.mons.values():
            if r == rank:
                return EntityAddr(host, port)
        raise KeyError(rank)

    def name_of_rank(self, rank: int) -> str:
        for name, (r, _, _) in self.mons.items():
            if r == rank:
                return name
        raise KeyError(rank)

    def rank_of_name(self, name: str) -> int:
        return self.mons[name][0]

    def addrs(self) -> list[EntityAddr]:
        return [EntityAddr(h, p) for _, h, p in
                sorted(self.mons.values())]

    def encode(self) -> bytes:
        e = Encoder()
        with e.start(2):                    # v2: + epoch, max_rank
            e.string(self.fsid)
            e.map(self.mons, lambda e, k: e.string(k),
                  lambda e, v: e.s32(v[0]).string(v[1]).u32(v[2]))
            e.u64(self.epoch)                              # v2
            e.s32(self.max_rank)                           # v2
        return e.tobytes()

    @classmethod
    def decode(cls, data: bytes) -> "MonMap":
        d = Decoder(data)
        m = cls()
        with d.start(2) as _v:
            m.fsid = d.string()
            m.mons = d.map(lambda d: d.string(),
                           lambda d: (d.s32(), d.string(), d.u32()))
            if _v >= 2:
                m.epoch = d.u64()
                m.max_rank = d.s32()
        for r, _h, _p in m.mons.values():
            m.max_rank = max(m.max_rank, r)
        return m


class Monitor(Dispatcher):
    def __init__(self, name: str, monmap: MonMap,
                 store: MonitorDBStore | None = None,
                 keyring: Keyring | None = None,
                 config: dict | None = None,
                 device=None):
        self.name = name                      # e.g. "a"
        # where every map this mon decodes runs its CRUSH step
        self.device = resolve(device)
        self.monmap = monmap
        self.rank = monmap.rank_of_name(name)
        self.store = store or MonitorDBStore()
        self.keyring = keyring
        cfg = config or {}
        self.election_timeout = cfg.get("mon_election_timeout", 0.3)
        self.lease_interval = cfg.get("mon_lease_interval", 0.5)
        self.lease_timeout = cfg.get("mon_lease", 2.0)
        self.paxos_timeout = cfg.get("mon_paxos_timeout", 2.0)
        self.tick_interval = cfg.get("mon_tick_interval", 0.2)
        self.config = cfg

        self.msgr = Messenger(f"mon.{name}", keyring=keyring)
        self.msgr.set_policy("mon", Policy.lossless_peer())
        self.msgr.add_dispatcher(self)

        self.elector = Elector(self)
        self.paxos = Paxos(self)
        self.leader_rank: int | None = None
        self.quorum: list[int] = []
        self.state = "probing"               # probing|electing|leader|peon
        self._stopped = False
        # set when a committed monmap no longer contains this mon: the
        # retired daemon stops electing/ticking (ref: a removed mon
        # shutting down after MonmapMonitor::prepare_update commits).
        # Assigned BEFORE the services: a restart over a durable store
        # replays a committed monmap through MonmapMonitor.refresh →
        # update_monmap inside the constructor calls below
        self._removed = False

        from ceph_tpu_torch.mon.auth_monitor import AuthMonitor
        from ceph_tpu_torch.mon.log_monitor import LogMonitor
        from ceph_tpu_torch.mon.mds_monitor import MDSMonitor
        from ceph_tpu_torch.mon.mgr_monitor import MgrMonitor
        from ceph_tpu_torch.mon.monmap_monitor import MonmapMonitor
        from ceph_tpu_torch.mon.osd_monitor import OSDMonitor
        from ceph_tpu_torch.mon.service import ConfigMonitor, HealthMonitor
        self.osdmon = OSDMonitor(self)
        self.mdsmon = MDSMonitor(self)
        self.mgrmon = MgrMonitor(self)
        self.monmapmon = MonmapMonitor(self)
        self.authmon = AuthMonitor(self)
        self.logmon = LogMonitor(self)
        self.configmon = ConfigMonitor(self)
        self.healthmon = HealthMonitor(self)
        self.services = [self.monmapmon, self.authmon, self.logmon,
                         self.osdmon, self.mdsmon, self.mgrmon,
                         self.configmon, self.healthmon]
        # mgr digest pool (round 12, ref: MMonMgrReport's receiver):
        # the active mgr ships its ProgressModule events + the per-OSD
        # commit/apply latency table every tick — IN MEMORY only
        # (derived state; the next digest re-sends everything), so a
        # leader change self-heals on the following tick
        self.mgr_progress: dict = {"events": [], "completed": []}
        self.mgr_osd_perf: dict = {}
        self._mgr_digest_gid = 0

        # tuner audit + ownership pool (round 17, see mon/tune.py):
        # provenance-carrying actuator commits land in the bounded
        # audit ring, observe-mode would-be actions arrive via `tune
        # record`, and the owned table is what the dampening sweep's
        # single-writer guard and a freshly-promoted mgr's tuner both
        # read back. Leader-local, like the slow-OSD verdicts.
        from ceph_tpu_torch.mon.tune import TuneState
        self.tune = TuneState(cfg)

        # crash-report pool (round 14, ref: the mgr crash module's
        # store): crash_id -> bounded report dict, IN MEMORY only
        # (crash evidence is observability, never a paxos artifact) —
        # `ceph crash ls/info` serve it and RECENT_CRASH warns until
        # `ceph crash archive` acks. OrderedDict-bounded: the oldest
        # reports age out past the cap.
        from collections import OrderedDict
        self.crashes: "OrderedDict[str, dict]" = OrderedDict()
        self.MAX_CRASHES = 64

        # trace-span pool (round 9, ref: the mgr's role as trace sink
        # upstream): spans piggybacked on MPGStats/MDSBeacon (and
        # shipped via MTraceReport by clients) land here, IN MEMORY
        # only — traces are observability, never a paxos artifact. The
        # mgr TracingModule drains it via `trace dump`; `trace ls/show`
        # serve the same reassembly directly for the CLI.
        import collections
        import random as _random
        from ceph_tpu_torch.utils.tracing import TraceIndex
        self.trace_spans: collections.deque = collections.deque(
            maxlen=int(cfg.get("mon_trace_buffer", 4096)))
        self._trace_seq = 0
        # pool generation: a fresh random token per pool instance, so
        # a puller (the mgr TracingModule) detects a leader change
        # even when the new pool's seq has already caught up to its
        # old cursor — seq comparison alone cannot
        self._trace_gen = _random.getrandbits(63) | 1
        self.trace_index = TraceIndex(
            max_traces=int(cfg.get("mon_trace_max_traces", 512)))
        # the mon's OWN span factory (round 11:
        # mons emitted no spans of their own, so paxos commit latency
        # was opaque): paxos propose -> accept-wait -> commit emits a
        # span family, drained into the local pool on tick — no wire
        # hop needed, the pool lives here
        from ceph_tpu_torch.utils.tracing import Tracer
        self.tracer = Tracer(f"mon.{name}", cfg)
        # the mon's own perf counters (round 12): mons are daemons too
        # in the telemetry plane — they open a session to the active
        # mgr and report like OSDs/MDSes, so paxos traffic is rate-
        # queryable from the DaemonStateIndex
        from ceph_tpu_torch.utils.perf_counters import PerfCountersBuilder
        self.perf = (
            PerfCountersBuilder(f"mon.{name}")
            .add_u64_counter("paxos_commits",
                             "paxos values applied to the store")
            .add_u64_counter("trace_spans_pooled",
                             "trace span blobs ingested into the pool")
            .add_u64_counter("mgr_digests",
                             "MMgrDigest reports pooled from the "
                             "active mgr")
            .create_perf_counters())
        self._mgr_reporter = None
        self._mgr_report_task: asyncio.Task | None = None

        # subscriptions: conn -> {what: next_epoch}
        self.subs: dict[object, dict[str, int]] = {}
        self._tick_task: asyncio.Task | None = None
        self.asok = None
        self._asok_dir = cfg.get("admin_socket_dir")

    # -- lifecycle ---------------------------------------------------------
    async def start(self, host: str = "127.0.0.1",
                    port: int = 0) -> EntityAddr:
        addr = await self.msgr.bind(host, port)
        await self.start_asok()
        self._tick_task = asyncio.ensure_future(self._tick_loop())
        self.start_mgr_reporting()
        await self.elector.start()
        return addr

    def start_mgr_reporting(self) -> None:
        """Mons are daemons in the telemetry plane too (round 12):
        report this mon's own counters to the active mgr, found
        through the mgrmon's committed map (no subscription needed —
        the map refreshes with every paxos commit)."""
        if self._mgr_report_task is not None:
            return
        from ceph_tpu_torch.mgr.client import MgrReporter
        self._mgr_reporter = MgrReporter(
            f"mon.{self.name}", self.msgr,
            lambda: self.mgrmon.mgrmap, lambda: [self.perf],
            self.config)
        self._mgr_report_task = asyncio.ensure_future(
            self._mgr_reporter.loop())

    async def start_asok(self) -> None:
        """Per-mon admin socket (ref: the mon's AdminSocket): `status`
        carries the monmap-epoch and pending-merge blocks."""
        if not self._asok_dir or self.asok is not None:
            return
        from ceph_tpu_torch.utils.admin_socket import AdminSocket
        self.asok = AdminSocket(f"{self._asok_dir}/mon.{self.name}.asok")
        self.asok.register("status", self.get_status,
                           "mon status incl. monmap epoch + pending "
                           "merges")
        self.asok.register(
            "quorum_status", lambda: {
                "monmap_epoch": self.monmap.epoch,
                "quorum": self.quorum,
                "leader": self.leader_rank,
                "mons": {n: list(v)
                         for n, v in self.monmap.mons.items()}},
            "quorum membership + monmap epoch")
        await self.asok.start()

    async def stop(self) -> None:
        self._stopped = True
        if self._tick_task:
            self._tick_task.cancel()
        if self._mgr_report_task:
            self._mgr_report_task.cancel()
            self._mgr_report_task = None
        self.elector.cancel_timer()
        if self.asok:
            await self.asok.stop()
            self.asok = None
        await self.msgr.shutdown()

    def is_leader(self) -> bool:
        return self.state == "leader"

    def join_election(self) -> None:
        """This mon takes part in an election: it leads and follows no
        one until it ends, and its paxos round is over (ref:
        Monitor::join_election -> _reset -> Paxos::restart). Without it a
        leader that called an election went on proposing while its peons
        elected."""
        if self._removed:
            return
        self.state = "electing"
        self.paxos.restart()

    def request_election(self) -> None:
        """ref: Monitor::start_election."""
        if not self._stopped and not self._removed:
            self.join_election()
            asyncio.ensure_future(self.elector.start())

    # -- monmap following (MonmapMonitor commits land here) ----------------
    def update_monmap(self, new: MonMap) -> None:
        """Adopt a committed monmap epoch (ref: Monitor::notify_new_
        monmap). Membership changes re-form the quorum through the
        existing elector; a mon that finds itself REMOVED retires —
        it stops electing and ticking, so its address can be torn down
        without confusing the survivors."""
        if new.epoch <= self.monmap.epoch:
            return
        old_members = set(self.monmap.mons)
        self.monmap = new
        if self.name not in new.mons:
            if not self._removed:
                self._removed = True
                self.state = "removed"
                self.elector.electing_me = False
                self.elector.cancel_timer()
                log.dout(1, f"mon.{self.name} removed from monmap "
                            f"epoch {new.epoch}; retiring")
            return
        if self._removed:
            # back in the map: a JOINER syncing the paxos history
            # replays epochs that predate its own membership — the
            # stale retire must lift when the epoch that contains us
            # applies (also covers a genuine re-add)
            self._removed = False
            self.state = "probing"
            log.dout(1, f"mon.{self.name} present in monmap epoch "
                        f"{new.epoch}; resuming")
        self.rank = new.rank_of_name(self.name)
        if old_members != set(new.mons):
            # quorum must re-form over the new membership: a removed
            # member may hold the leadership we are deferring to, and
            # a joiner can only sync through a fresh collect round
            self.quorum = [r for r in self.quorum
                           if r in new.ranks()]
            log.dout(1, f"mon.{self.name} monmap epoch {new.epoch}: "
                        f"members {sorted(new.mons)}; electing")
            self.request_election()

    # -- election outcomes -------------------------------------------------
    async def win_election(self, epoch: int, quorum: list[int]) -> None:
        if self.elector.epoch != epoch:
            return                    # a new election began meanwhile
        self.state = "leader"
        self.leader_rank = self.rank
        self.quorum = quorum
        ok = await self.paxos.leader_collect()
        if self.state != "leader" or self.elector.epoch != epoch:
            return                    # an election ended this reign
        if not ok:
            self.request_election()
            return
        for svc in self.services:
            await svc.on_active()
        log.dout(1, f"mon.{self.name} leader; quorum {quorum}")

    async def lose_election(self, epoch: int, leader: int,
                            quorum: list[int]) -> None:
        self.state = "peon"
        self.leader_rank = leader
        self.quorum = quorum
        self.paxos.lease_deadline = asyncio.get_event_loop().time() + \
            self.lease_timeout

    # -- ticking -----------------------------------------------------------
    async def _tick_loop(self) -> None:
        try:
            while not self._stopped:
                await asyncio.sleep(self.tick_interval)
                now = asyncio.get_event_loop().time()
                if self._removed:
                    continue          # retired: awaiting teardown
                # the mon's own spans (paxos) pool locally: same
                # ingest path the piggybacked daemon spans take
                own = self.tracer.drain_ship()
                if own:
                    self.ingest_trace_spans(own)
                if self.is_leader():
                    await self.paxos.send_lease()
                    for svc in self.services:
                        await svc.tick()
                elif self.state == "peon" and \
                        self.paxos.lease_deadline and \
                        now > self.paxos.lease_deadline:
                    log.dout(1, f"mon.{self.name} lease expired; electing")
                    self.state = "electing"
                    await self.elector.start()
        except asyncio.CancelledError:
            pass

    # -- messaging ---------------------------------------------------------
    async def send_mon(self, rank: int, msg) -> bool:
        if rank == self.rank:
            msg.src = f"mon.{self.name}"
            await self._dispatch_mon_msg(msg)
            return True
        try:
            # bounded: a dead peer must not stall elections/leases
            # behind lossless reconnect retries
            await asyncio.wait_for(self.msgr.send_message(
                msg, self.monmap.addr_of_rank(rank),
                f"mon.{self.monmap.name_of_rank(rank)}"), timeout=1.0)
            return True
        except Exception as e:
            log.dout(5, f"send to mon rank {rank} failed: {e}")
            return False

    def _src_rank(self, msg) -> int:
        name = (msg.src or "").split(".", 1)[-1]
        try:
            return self.monmap.rank_of_name(name)
        except KeyError:
            return -1

    async def ms_dispatch(self, msg) -> bool:
        # Handlers that wait on paxos round-trips (propose/collect) are
        # spawned as tasks: run inline they would block the connection
        # reader loop that must deliver the ACCEPT/LAST they await.
        if isinstance(msg, (MMonElection, MMonPaxos)):
            await self._dispatch_mon_msg(msg)
            return True
        if isinstance(msg, MMonProposeForward):
            if self.is_leader():
                asyncio.ensure_future(self.paxos.propose(msg.value))
            return True
        if isinstance(msg, MMonCommand):
            asyncio.ensure_future(self._handle_command_msg(msg))
            return True
        if isinstance(msg, MMonSubscribe):
            await self._handle_subscribe(msg)
            return True
        if isinstance(msg, MMonGetOSDMap):
            await self._send_osdmaps(msg.conn, msg.start_epoch)
            return True
        if isinstance(msg, (MOSDAlive, MOSDBoot, MOSDFailure,
                            MOSDMarkMeDown, MPGStats, MDSBeacon,
                            MLog, MOSDPGReadyToMerge,
                            MMDSMigrationDone, MTraceReport,
                            MMgrBeacon, MMgrDigest, MCrashReport)):
            if not self.is_leader():
                if self.leader_rank is not None and \
                        self.leader_rank != self.rank:
                    await self.send_mon(self.leader_rank, msg)
                return True
            # trace spans ride the existing reports (MPGStats /
            # MDSBeacon piggyback, MTraceReport for clients): pool
            # them before the service dispatch
            blobs = getattr(msg, "trace_spans", None) or \
                (msg.spans if isinstance(msg, MTraceReport) else None)
            if blobs:
                self.ingest_trace_spans(blobs)
            if isinstance(msg, MTraceReport):
                return True
            if isinstance(msg, MMgrBeacon):
                asyncio.ensure_future(self.mgrmon.handle(msg))
                return True
            if isinstance(msg, MMgrDigest):
                self._ingest_mgr_digest(msg)
                return True
            if isinstance(msg, MCrashReport):
                self._ingest_crash_report(msg)
                return True
            if isinstance(msg, (MDSBeacon, MMDSMigrationDone)):
                svc = self.mdsmon
            elif isinstance(msg, MLog):
                svc = self.logmon
            else:
                svc = self.osdmon
            asyncio.ensure_future(svc.handle(msg))
            return True
        return False

    # -- mgr digest pool (round 12) ----------------------------------------
    def _ingest_mgr_digest(self, m: MMgrDigest) -> None:
        """Pool the active mgr's digest (progress events + per-OSD
        commit/apply latency). Only the CURRENT active gid's digests
        land — a demoted mgr's late frames must not overwrite its
        successor's view. Malformed JSON is dropped: observability
        must never take a mon down."""
        active = self.mgrmon.mgrmap.active_gid
        if active and m.gid != active:
            return
        try:
            prog = json.loads(m.progress) if m.progress else {}
            perf = json.loads(m.osd_perf) if m.osd_perf else {}
        except (json.JSONDecodeError, TypeError, ValueError):
            return
        if isinstance(prog, dict):
            self.mgr_progress = {
                "events": prog.get("events", []),
                "completed": prog.get("completed", [])}
        if isinstance(perf, dict):
            self.mgr_osd_perf = perf
        self._mgr_digest_gid = m.gid
        self.perf.inc("mgr_digests")

    # -- crash pool (round 14) ---------------------------------------------
    def _ingest_crash_report(self, m: MCrashReport) -> None:
        """Pool one daemon crash report (bounded, re-capped fields —
        the sender caps too, but arbitrary daemons write these; a
        hostile report must not grow mon memory). Duplicate crash_ids
        keep the first report; the pool ages out oldest-first past
        MAX_CRASHES. A fresh report arrives unarchived — RECENT_CRASH
        raises until `ceph crash archive` acks it."""
        cid = str(m.crash_id or "")[:200]
        if not cid or cid in self.crashes:
            return
        self.crashes[cid] = {
            "crash_id": cid,
            "daemon": str(m.daemon or "?")[:120],
            "exception": str(m.exception or "")[:400],
            "traceback": str(m.traceback or "")[:4000],
            "stamp": float(getattr(m, "stamp", 0.0) or 0.0),
            "archived": False,
        }
        while len(self.crashes) > self.MAX_CRASHES:
            self.crashes.popitem(last=False)
        self.clog("WRN", f"daemon crash reported: {m.daemon} "
                         f"({self.crashes[cid]['exception'][:80]}) "
                         f"crash_id {cid}")
        log.dout(1, f"crash report pooled: {cid}")

    def _handle_crash_command(self, cmd: dict) -> tuple[int, str,
                                                        bytes]:
        """`ceph crash ls/info/archive/archive-all` (round 14, ref:
        the mgr crash module's command set): ls + info are read-only
        cap class; archive flips the ack bit that clears
        RECENT_CRASH (the report stays listed — `crash ls` is the
        permanent record within the pool's bound)."""
        prefix = cmd.get("prefix", "")
        if prefix == "crash ls":
            return 0, "", json.dumps({"crashes": [
                {k: v for k, v in rep.items() if k != "traceback"}
                for rep in self.crashes.values()]}).encode()
        if prefix == "crash info":
            cid = str(cmd.get("id", ""))
            rep = self.crashes.get(cid)
            if rep is None:
                return -2, f"no crash {cid!r}", b""       # -ENOENT
            return 0, "", json.dumps(rep).encode()
        if prefix == "crash archive":
            cid = str(cmd.get("id", ""))
            rep = self.crashes.get(cid)
            if rep is None:
                return -2, f"no crash {cid!r}", b""       # -ENOENT
            rep["archived"] = True
            return 0, f"archived {cid}", b""
        if prefix == "crash archive-all":
            n = 0
            for rep in self.crashes.values():
                if not rep["archived"]:
                    rep["archived"] = True
                    n += 1
            return 0, f"archived {n} crash(es)", b""
        return -22, f"unknown command {prefix!r}", b""    # -EINVAL

    # -- trace pool (round 9) ----------------------------------------------
    def ingest_trace_spans(self, blobs) -> None:
        """Pool shipped span blobs (JSON) for the mgr's `trace dump`
        pull and the mon's own `trace ls/show` reassembly. Malformed
        blobs are dropped — observability must never take a mon down."""
        for b in blobs:
            try:
                span = json.loads(b)
            except (json.JSONDecodeError, TypeError, ValueError):
                continue
            if not isinstance(span, dict):
                continue
            self._trace_seq += 1
            self.trace_spans.append((self._trace_seq, span))
            self.trace_index.add(span)
            self.perf.inc("trace_spans_pooled")

    async def _dispatch_mon_msg(self, msg) -> None:
        if isinstance(msg, MMonElection):
            await self.elector.handle(msg)
        elif isinstance(msg, MMonPaxos):
            msg.src_rank = self._src_rank(msg)
            if self._paxos_msg_current(msg):
                await self.paxos.dispatch(msg)

    def _paxos_msg_current(self, msg) -> bool:
        """Whether a paxos message belongs to this mon's reign. The wire
        carries no election epoch (ref: Monitor::dispatch_op drops a
        MMonPaxos of another epoch), so the mon's state stands in: a
        peon takes a leader's messages from its leader only, and a
        leader takes replies only while it leads, from its quorum. What
        else comes is from a reign that an election has ended: the
        election's PROPOSE reached each mon of the new quorum before any
        COLLECT of its winner. A COMMIT is final and taken from anyone."""
        op, src = msg.op, msg.src_rank
        if op in (PAXOS_COLLECT, PAXOS_BEGIN, PAXOS_LEASE):
            return self.state == "peon" and src == self.leader_rank
        if op in (PAXOS_LAST, PAXOS_ACCEPT, PAXOS_CATCHUP):
            return self.is_leader() and src in self.quorum
        return True

    async def ms_handle_reset(self, conn) -> None:
        self.subs.pop(conn, None)

    # -- paxos commit application -----------------------------------------
    def apply_paxos_value(self, version: int, value: bytes) -> None:
        self.store.apply_encoded(value)
        self.perf.inc("paxos_commits")
        for svc in self.services:
            svc.refresh()
        asyncio.ensure_future(self._publish_maps())

    async def _publish_maps(self) -> None:
        """Push new osdmap/fsmap/monmap/keyring epochs to subscribers
        (ref: OSDMonitor::check_subs / send_incremental +
        MDSMonitor::check_subs + Monitor::handle_subscribe's monmap
        send).

        Fan-out is CONCURRENT with a bounded width (round 11): the
        serial per-subscriber awaits this loop used to do made every
        map commit O(subscribers) sequential round-trips — with a
        10k-session load harness attached, one commit stalled the mon
        for seconds. Per-connection sends stay ordered (each conn is
        handled by one task); only distinct subscribers parallelize."""
        subscribers = list(self.subs.items())
        if not subscribers:
            return
        sem = asyncio.Semaphore(32)

        async def one(conn, subs):
            async with sem:
                await self._publish_to(conn, subs)
        await asyncio.gather(*[one(c, s) for c, s in subscribers],
                             return_exceptions=True)

    async def _publish_to(self, conn, subs) -> None:
        cur = self.osdmon.osdmap.epoch if self.osdmon.osdmap else 0
        fs_cur = self.mdsmon.fsmap.epoch
        mm_cur = self.monmap.epoch
        auth_cur = self.authmon.version
        try:
            start = subs.get("osdmap")
            if start is not None and start <= cur:
                await self._send_osdmaps(conn, start)
                subs["osdmap"] = cur + 1
            fs_start = subs.get("mdsmap")
            if fs_start is not None and fs_start <= fs_cur:
                await conn.send_message(MMDSMap(
                    epoch=fs_cur,
                    fsmap=self.mdsmon.fsmap.encode()))
                subs["mdsmap"] = fs_cur + 1
            mm_start = subs.get("monmap")
            if mm_start is not None and mm_start <= mm_cur:
                await conn.send_message(MMonMap(
                    monmap=self.monmap.encode(), epoch=mm_cur))
                subs["monmap"] = mm_cur + 1
            g_start = subs.get("mgrmap")
            g_cur = self.mgrmon.mgrmap.epoch
            if g_start is not None and g_start <= g_cur:
                await conn.send_message(MMgrMap(
                    epoch=g_cur,
                    mgrmap=self.mgrmon.mgrmap.encode()))
                subs["mgrmap"] = g_cur + 1
            a_start = subs.get("keyring")
            if a_start is not None and a_start <= auth_cur:
                await conn.send_message(MAuthUpdate(
                    version=auth_cur,
                    keys=self.authmon.publishable_for(
                        conn.peer_name),
                    caps=self.authmon.caps_for(conn.peer_name)))
                subs["keyring"] = auth_cur + 1
            c_start = subs.get("config")
            c_cur = self.configmon.version
            if c_start is not None and c_start <= c_cur:
                await conn.send_message(MConfigMap(
                    version=c_cur,
                    cfgmap=self.configmon.encode_map()))
                subs["config"] = c_cur + 1
        except Exception:
            # a dead subscriber's session takes its subs with it (a
            # reconnecting client re-subscribes)
            self.subs.pop(conn, None)

    async def _send_osdmaps(self, conn, start: int) -> None:
        if self.osdmon.osdmap is None:
            return
        cur = self.osdmon.osdmap.epoch
        incs: dict[int, bytes] = {}
        full: dict[int, bytes] = {}
        lo = max(start, 2)
        if start <= 1 or (cur - lo) > 500:
            full[cur] = self.osdmon.encode_full()
        else:
            for e in range(lo, cur + 1):
                blob = self.osdmon.get_inc(e)
                if blob is None:
                    full[cur] = self.osdmon.encode_full()
                    incs.clear()
                    break
                incs[e] = blob
        await conn.send_message(MOSDMap(fsid=self.monmap.fsid,
                                        incrementals=incs, full=full))

    # -- subscriptions -----------------------------------------------------
    async def _handle_subscribe(self, msg: MMonSubscribe) -> None:
        entry = self.subs.setdefault(msg.conn, {})
        for what, start in msg.what.items():
            entry[what] = int(start)
            if what == "monmap":
                # immediate send (ref: Monitor::handle_subscribe
                # sending the latest monmap synchronously) — the
                # cursor advances so _publish_maps won't re-send
                await msg.conn.send_message(MMonMap(
                    monmap=self.monmap.encode(),
                    epoch=self.monmap.epoch))
                entry[what] = self.monmap.epoch + 1
        await self._publish_maps()

    # -- commands ----------------------------------------------------------
    async def _handle_command_msg(self, msg: MMonCommand) -> None:
        if not self.is_leader():
            # redirect: client retries against the leader
            leader = self.leader_rank if self.leader_rank is not None \
                else -1
            await msg.conn.send_message(MMonCommandAck(
                tid=msg.tid, retcode=-11,                  # -EAGAIN
                rs=f"leader={leader}", outbl=b""))
            return
        try:
            cmd = json.loads(msg.cmd)
        except json.JSONDecodeError:
            cmd = {"prefix": msg.cmd}
        # cap enforcement, first slice (round 7): the CALLER's stored
        # caps gate mutating commands at the wire entry — the peer
        # name is the handshake-authenticated entity, so a `mon r`
        # client cannot mutate and key ops need `auth *`
        caller = getattr(msg.conn, "peer_name", None) or ""
        ret, rs = self.authmon.check_command_caps(caller, cmd)
        if ret != 0:
            await msg.conn.send_message(MMonCommandAck(
                tid=msg.tid, retcode=ret, rs=rs, outbl=b""))
            return
        ret, rs, outbl = await self.handle_command(cmd, msg.inbl)
        await msg.conn.send_message(MMonCommandAck(
            tid=msg.tid, retcode=ret, rs=rs, outbl=outbl))

    async def handle_command(self, cmd: dict,
                             inbl: bytes = b"") -> tuple[int, str, bytes]:
        """ref: Monitor::handle_command routing table — wrapped with
        the round-17 tuner provenance capture: a command carrying a
        ``provenance`` dict that COMMITS lands in the tune audit ring
        (with its sensor readings) and updates actuator ownership; a
        provenance-less command touching an owned target releases it
        (the operator wins)."""
        prefix = cmd.get("prefix", "")
        if prefix.startswith("tune"):
            return self._handle_tune_command(cmd)
        ret, rs, outbl = await self._route_command(cmd, inbl)
        prov = cmd.get("provenance")
        if ret == 0:
            if isinstance(prov, dict):
                entry = self.tune.record_commit(cmd, prov)
                self.clog(
                    "INF",
                    f"tuner[{entry['policy']}] committed "
                    f"{prefix!r} ({entry['action']})")
            else:
                self.tune.record_operator(cmd)
        return ret, rs, outbl

    def _handle_tune_command(self, cmd: dict) -> tuple[int, str,
                                                       bytes]:
        """`ceph tune status|log` (read-only) + `tune record` (the
        tuner's observe-mode would-be-action feed)."""
        prefix = cmd.get("prefix", "")
        mode = str(self.config.get("mgr_tuner_mode", "observe"))
        if prefix == "tune status":
            return 0, "", json.dumps(
                self.tune.status(mode)).encode()
        if prefix == "tune log":
            num = cmd.get("num")
            try:
                num = int(num) if num is not None else None
            except (TypeError, ValueError):
                return -22, "num must be an integer", b""
            return 0, "", json.dumps(
                {"entries": self.tune.log(num)}).encode()
        if prefix == "tune record":
            entry = cmd.get("entry")
            if not isinstance(entry, dict):
                return -22, "entry must be a dict", b""
            self.tune.record_observation(entry)
            return 0, "", b""
        return -22, f"unknown command {prefix!r}", b""    # -EINVAL

    async def _route_command(self, cmd: dict,
                             inbl: bytes = b"") -> tuple[int, str,
                                                         bytes]:
        prefix = cmd.get("prefix", "")
        if prefix in ("status", "health"):
            return 0, "", json.dumps(self.get_status()).encode()
        if prefix == "mon dump":
            return 0, "", json.dumps({
                "fsid": self.monmap.fsid,
                "epoch": self.monmap.epoch,
                "quorum": self.quorum,
                "leader": self.leader_rank,
                "mons": {n: list(v) for n, v in
                         self.monmap.mons.items()}}).encode()
        if prefix == "quorum_status":
            return 0, "", json.dumps({
                "monmap_epoch": self.monmap.epoch,
                "quorum": self.quorum,
                "quorum_names": [self.monmap.name_of_rank(r)
                                 for r in self.quorum
                                 if r in self.monmap.ranks()],
                "quorum_leader_name":
                    self.monmap.name_of_rank(self.leader_rank)
                    if self.leader_rank is not None and
                    self.leader_rank in self.monmap.ranks()
                    else ""}).encode()
        if prefix in ("mon add", "mon rm", "mon remove"):
            return await self.monmapmon.handle_command(cmd, inbl)
        if prefix.startswith("auth"):
            return await self.authmon.handle_command(cmd, inbl)
        if prefix.startswith("log"):
            return await self.logmon.handle_command(cmd, inbl)
        if prefix.startswith("config"):
            return await self.configmon.handle_command(cmd, inbl)
        if prefix.startswith(("fs", "mds")):
            return await self.mdsmon.handle_command(cmd, inbl)
        if prefix.startswith("mgr"):
            return await self.mgrmon.handle_command(cmd, inbl)
        if prefix.startswith("progress"):
            return self._handle_progress_command(cmd)
        if prefix == "osd perf":
            # per-OSD commit/apply latency from the mgr's reported
            # counter digest (ref: `ceph osd perf` off the pgmap's
            # osd_stat perf numbers — here the mgr derives them from
            # the reported objectstore time-avgs and digests them back)
            return 0, "", json.dumps({
                "osd_perf": {k: self.mgr_osd_perf[k]
                             for k in sorted(self.mgr_osd_perf)},
                "from_mgr_gid": self._mgr_digest_gid}).encode()
        if prefix.startswith("trace"):
            return self._handle_trace_command(cmd)
        if prefix.startswith("crash"):
            return self._handle_crash_command(cmd)
        if prefix == "device-runtime status":
            # per-daemon device-runtime table from the MPGStats
            # piggyback (round 14): engine, kernel-path mismatch
            # rate, compile count/time, transfer GiB + the degraded
            # table behind KERNEL_PATH_DEGRADED
            return 0, "", json.dumps(
                self.osdmon.device_runtime_status()).encode()
        if prefix.startswith(("osd", "pg")):
            return await self.osdmon.handle_command(cmd, inbl)
        return -22, f"unknown command {prefix!r}", b""    # -EINVAL

    def _handle_progress_command(self, cmd: dict) -> tuple[int, str,
                                                           bytes]:
        """`ceph progress ls/json` (round 12, ref: the progress
        module's `progress` commands): the in-flight event list the
        active mgr digests monward — ``ls`` serves events only,
        ``json`` adds the recently-completed ring."""
        prefix = cmd.get("prefix", "")
        if prefix == "progress ls":
            return 0, "", json.dumps({
                "events": self.mgr_progress.get("events", [])}).encode()
        if prefix == "progress json":
            return 0, "", json.dumps({
                "events": self.mgr_progress.get("events", []),
                "completed": self.mgr_progress.get("completed", []),
                "from_mgr_gid": self._mgr_digest_gid}).encode()
        return -22, f"unknown command {prefix!r}", b""    # -EINVAL

    def _handle_trace_command(self, cmd: dict) -> tuple[int, str, bytes]:
        """`ceph trace ...` (round 9): ``dump`` is the raw span feed
        the mgr TracingModule pulls (incremental by ``since``);
        ``ls``/``show`` serve the reassembled per-phase view directly
        from the mon's TraceIndex so the CLI works without a mgr."""
        prefix = cmd.get("prefix", "")
        if prefix == "trace dump":
            try:
                since = int(cmd.get("since", 0))
            except (TypeError, ValueError):
                return -22, "since must be an integer", b""
            if since > self._trace_seq:
                since = 0           # a new leader's pool restarts at 0
            return 0, "", json.dumps({
                "gen": self._trace_gen,
                "seq": self._trace_seq,
                "spans": [s for q, s in self.trace_spans
                          if q > since]}).encode()
        if prefix == "trace ls":
            try:
                limit = int(cmd.get("limit", 20))
            except (TypeError, ValueError):
                return -22, "limit must be an integer", b""
            return 0, "", json.dumps({
                "traces": self.trace_index.ls(limit=limit)}).encode()
        if prefix == "trace show":
            try:
                tid = int(cmd.get("trace_id", 0))
            except (TypeError, ValueError):
                return -22, "trace_id must be an integer", b""
            out = self.trace_index.show(tid)
            if out is None:
                return -2, f"no trace {tid}", b""         # -ENOENT
            return 0, "", json.dumps(out).encode()
        return -22, f"unknown command {prefix!r}", b""    # -EINVAL

    def clog(self, level: str, msg: str) -> None:
        """Append one cluster-log line through the LogMonitor (leader
        only; fire-and-forget — the log is observability, not a
        correctness dependency)."""
        if self.is_leader() and not self._stopped:
            asyncio.ensure_future(
                self.logmon.append(f"mon.{self.name}", level, msg))

    def get_status(self) -> dict:
        health = self.healthmon.checks()
        om = self.osdmon.osdmap
        osd_stat = {}
        if om is not None:
            import numpy as np
            from ceph_tpu_torch.osd.osdmap import (
                STATE_EXISTS, STATE_FULL, STATE_NEARFULL, STATE_UP,
                flag_names,
            )
            up = int(np.sum((om.osd_state & STATE_UP) != 0))
            inn = int(np.sum((np.asarray(om.osd_weight) > 0) &
                             ((om.osd_state & STATE_EXISTS) != 0)))
            exists = int(np.sum((om.osd_state & STATE_EXISTS) != 0))
            osd_stat = {"epoch": om.epoch, "num_osds": exists,
                        "num_up_osds": up, "num_in_osds": inn,
                        "pools": len(om.pools),
                        "flags": flag_names(om.flags),
                        "num_nearfull_osds": int(np.sum(
                            (om.osd_state & STATE_NEARFULL) != 0)),
                        "num_full_osds": int(np.sum(
                            (om.osd_state & STATE_FULL) != 0)),
                        "osd_utilization": {
                            str(o): {"used": u, "capacity": c}
                            for o, (u, c) in sorted(
                                self.osdmon.osd_utilization.items())},
                        "pool_quotas": [
                            {"pool": p.id, "name": p.name,
                             "quota_bytes": p.quota_bytes,
                             "quota_objects": p.quota_objects,
                             "full": int(p.is_full())}
                            for p in om.pools.values()
                            if p.quota_bytes or p.quota_objects or
                            p.is_full()],
                        # round 20: cumulative deleted snapids across
                        # pools (prometheus renders
                        # ceph_snap_removed from it — a count that
                        # stops growing while deletes continue means
                        # the trim queue feed is wedged)
                        "removed_snaps": sum(
                            len(p.extra.get("removed_snaps") or [])
                            for p in om.pools.values())}
        if om is not None:
            pending = self.osdmon.pending_merges()
            if pending:
                osd_stat["pending_merges"] = pending
            if self.osdmon.slow_osds:
                # gray-failure drill-down: score per confirmed-slow
                # OSD (prometheus renders ceph_osd_slow_score from it)
                osd_stat["slow_osds"] = {
                    str(t): v.get("score", 0.0)
                    for t, v in sorted(self.osdmon.slow_osds.items())}
            dkp = getattr(self.osdmon, "degraded_kernel_paths", {})
            if dkp:
                # kernel-path drill-down (round 14): mismatch ratio
                # per confirmed-degraded daemon (prometheus renders
                # ceph_device_path_degraded from it)
                osd_stat["degraded_kernel_paths"] = {
                    str(o): v.get("ratio", 0.0)
                    for o, v in sorted(dkp.items())}
        return {
            "fsid": self.monmap.fsid,
            "health": health,
            "quorum": self.quorum,
            "monmap": {"epoch": self.monmap.epoch,
                       "num_mons": len(self.monmap.mons),
                       "mons": sorted(self.monmap.mons)},
            "auth": {"num_keys": self.authmon.num_keys(),
                     "version": self.authmon.version},
            "osdmap": osd_stat,
            "fsmap": self.mdsmon.summary(),
            "pgmap": self.osdmon.pg_summary(),
            "mgrmap": self.mgrmon.mgrmap.summary(),
            "progress": {"events":
                         self.mgr_progress.get("events", [])},
        }

    # -- service proposals -------------------------------------------------
    async def propose_txn(self, txn, timeout: float = 5.0) -> bool:
        """Commit a store transaction through paxos (leader) or forward
        it (peon). Waits out election/collect windows instead of
        failing spuriously (ref: PaxosService::propose_pending queueing
        until paxos is writeable)."""
        blob = txn.encode()
        deadline = asyncio.get_event_loop().time() + timeout
        while asyncio.get_event_loop().time() < deadline:
            if self.is_leader() and self.paxos.active:
                if await self.paxos.propose(blob):
                    return True
            elif self.state == "peon" and self.leader_rank is not None:
                # best-effort: True means handed to the leader's
                # transport, not committed (callers needing commit
                # certainty must run on the leader)
                if await self.send_mon(self.leader_rank,
                                       MMonProposeForward(
                                           service="", value=blob)):
                    return True
            await asyncio.sleep(0.05)
        return False
