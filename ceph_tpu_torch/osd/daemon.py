"""The OSD daemon: boot, map handling, op dispatch, heartbeats, stats.

ref: src/osd/OSD.{h,cc} — the daemon that owns one ObjectStore, two
messengers (client/cluster + heartbeat), a MonClient, and the PG table.
Boot mirrors OSD::init/_send_boot (authenticate, subscribe to maps,
announce addresses, wait to be marked up); map handling mirrors
OSD::handle_osd_map + consume_map (advance every PG, instantiate new
ones — here the whole pool's placement is computed in ONE batched
mapper call instead of per-PG crush lookups); failure detection mirrors
the osd_heartbeat_grace machinery with MOSDFailure reports.

The port's copy of ``ceph_tpu/osd/daemon.py``. An ``OSD`` owns its
device (``device=``, CUDA unless ``"cpu"``; it raises without a card):
its ``MonClient`` decodes maps there, so the tracked table's sweeps and
delta remaps run the CRUSH kernel on it, and every ``ECPG`` it hosts,
with the residency cache, encodes and decodes there. The pool's EC
profile, which is cluster state, never names the device. With
``osd_crush_mesh=auto`` and more than one card visible, the tracked
table's full sweeps run sharded over a mesh of every card.
"""

from __future__ import annotations

import asyncio
import json

import numpy as np

from ceph_tpu_torch.crush.types import ITEM_NONE
from ceph_tpu_torch.mon.client import MonClient
from ceph_tpu_torch.mon.messages import (MOSDBoot, MOSDFailure,
                                   MOSDMarkMeDown, MPGStats)
from ceph_tpu_torch.msg import Dispatcher, EntityAddr, Keyring, Messenger, Policy
from ceph_tpu_torch.os_.objectstore import MemStore, ObjectStore
from ceph_tpu_torch.osd.ec_pg import ECPG
from ceph_tpu_torch.osd.messages import (
    MBackfillReserve, MOSDBackoff, MOSDECSubOpRead, MOSDECSubOpReadReply,
    MOSDECSubOpWrite,
    MOSDECSubOpWriteReply, MOSDMapPing, MOSDOp, MOSDPGBackfill,
    MOSDPGBackfillReply, MOSDPGInfo, MOSDPGPull,
    MOSDPGPush, MOSDPGPushReply, MOSDPGQuery, MOSDPGRepair, MOSDPGScan,
    MOSDPGScanReply, MOSDPing, MOSDRepOp,
    MOSDRepOpReply, MOSDRepScrub, MOSDRepScrubMap, MPGCleanNotice,
    MUTATING_OPS, PING,
    PING_REPLY,
)
from ceph_tpu_torch.osd.pg import PG
from ceph_tpu_torch.osd.recovery import AsyncReserver
from ceph_tpu_torch.osd.scheduler import (OpScheduler, QoSProfile,
                                    SchedulerThrottle, _Grant,
                                    size_scaled_cost)
from ceph_tpu_torch.osd.types import MAX_OID, pg_t
from ceph_tpu_torch.utils.device import resolve
from ceph_tpu_torch.utils.devmon import engine_name as _engine_name
from ceph_tpu_torch.utils.logging import get_logger
from ceph_tpu_torch.utils.op_tracker import OpTracker
from ceph_tpu_torch.utils.perf_counters import PerfCountersBuilder
from ceph_tpu_torch.utils.throttle import MessageThrottle

log = get_logger("osd")


def _boot_crush_mesh(cfg: dict, device):
    """Mesh provenance: the ``osd_crush_mesh`` knob decides where this
    daemon's device mesh comes from. ``auto`` on the card builds a mesh
    over every visible card when more than one is visible (one card, or
    the CPU, keeps the plain path: the sharded sweep needs more than one
    slot to be used); ``off`` (the default) never attaches one. Returns a
    Mesh or None; a failed device probe gives None, since a mesh is an
    optimization, never a boot dependency."""
    if str(cfg.get("osd_crush_mesh", "off")) != "auto" or \
            device.type != "cuda":
        return None
    try:
        import torch
        n = torch.cuda.device_count()
        if n > 1:
            from ceph_tpu_torch.parallel import make_mesh
            return make_mesh([torch.device("cuda", i) for i in range(n)])
    except RuntimeError as e:
        log.dout(0, "osd_crush_mesh=auto: device probe failed "
                    f"({type(e).__name__}: {str(e)[:120]}) -- "
                    "keeping the single-device path")
    return None


# process-wide overload-protection counters (exported via `perf dump`
# + the mgr prometheus module, like osd_recovery's)
OVERLOAD_PERF = (
    PerfCountersBuilder("osd_overload")
    .add_u64_counter("backoffs_sent", "MOSDBackoff BLOCKs sent")
    .add_u64_counter("backoffs_released", "MOSDBackoff UNBLOCKs sent")
    .add_u64_counter("failsafe_rejections",
                     "writes rejected -ENOSPC by the local failsafe")
    .add_u64_counter("throttle_queued",
                     "client ops that waited at the admission throttle")
    .create_perf_counters())


class OSD(Dispatcher):
    def __init__(self, whoami: int, monmap, store: ObjectStore | None = None,
                 keyring: Keyring | None = None,
                 config: dict | None = None, device=None):
        self.whoami = whoami
        # where this daemon's maps, encodes and decodes run
        self.device = resolve(device)
        self.monmap = monmap
        self.store = store or MemStore()
        cfg = config or {}
        self.hb_interval = cfg.get("osd_heartbeat_interval", 0.25)
        self.hb_grace = cfg.get("osd_heartbeat_grace", 1.5)
        self.stats_interval = cfg.get("osd_stats_interval", 0.5)
        self.scrub_interval = cfg.get("osd_scrub_interval", 0.0)
        self.config = cfg
        name = f"osd.{whoami}"
        self.msgr = Messenger(name, keyring=keyring)
        self.msgr.set_policy("osd", Policy.lossless_peer())
        self.msgr.add_dispatcher(self)
        self.hb_msgr = Messenger(name, keyring=keyring)
        self.hb_msgr.add_dispatcher(_HBDispatcher(self))
        self.monc = MonClient(name, monmap, keyring=keyring,
                              messenger=self.msgr, device=self.device)
        # maintain the full-cluster mapping table per epoch: the
        # advance-map sweep in _on_osdmap reads every pool's placement
        # anyway, so the (delta-updated) table replaces those mapper
        # runs rather than adding work
        self.monc.track_mapping = True
        # mesh provenance: the registered osd_crush_mesh knob attaches
        # the boot-time mesh to the tracked table, which re-attaches it
        # to every map it updates against
        self.monc.mapping_mesh = _boot_crush_mesh(cfg, self.device)
        self.monc.map_callbacks.append(self._on_osdmap)
        self.osdmap = None
        self.pgs: dict[str, PG] = {}
        self._tid = 0
        # pool id -> snapids whose removed_snaps trim already ran here
        self._snaps_trimmed: dict[int, set[int]] = {}
        self._hb_last_rx: dict[int, float] = {}
        self._hb_reported: dict[int, float] = {}
        self._hb_task: asyncio.Task | None = None
        self._stats_task: asyncio.Task | None = None
        self._scrub_task: asyncio.Task | None = None
        self._stopped = False
        self.up = False
        self._statfs_reported = 0   # last capacity sent monward
        # ref: OSD op tracking + admin socket
        self.op_tracker = OpTracker(
            history_size=cfg.get("osd_op_history_size"),
            slow_op_warn_s=cfg.get("osd_op_complaint_time"))
        # distributed tracing (ref: src/common/tracer.cc in the OSD):
        # spans for sampled ops — queue/execute/repop/objectstore
        # phases — shipped monward on the stats piggyback
        from ceph_tpu_torch.utils.tracing import Tracer
        self.tracer = Tracer(name, cfg)
        # bulk mapping sweeps in the tracked table emit crush_sweep
        # spans (n_pgs/path/n_devices) through the daemon's tracer, so
        # advance-map sweep cost is drill-downable in `trace show`
        self.monc.mapping_tracer = self.tracer
        # device-runtime observability: this daemon's
        # kernel-path health monitor (per-daemon counter family,
        # register=False like osd_ec_agg — it reaches /metrics only
        # through the report session) wired into the tracked table's
        # sweep sites; the PROCESS monitor gets this daemon's tracer
        # so jit compiles emit `jit_compile` spans that ship monward
        # on the existing stats piggyback
        from ceph_tpu_torch.utils.devmon import DeviceRuntimeMonitor, devmon
        self.devmon = DeviceRuntimeMonitor(
            name="devmon", register=False, config=cfg)
        self.monc.mapping_devmon = self.devmon
        devmon().attach_tracer(self.tracer)
        self._proc_devmon = devmon()
        # per-op-class latency histograms (ref: the OSD's
        # l_osd_op_r/w_latency counters, as real TYPE_HISTOGRAM log2
        # buckets in MICROSECONDS — the prometheus module renders them
        # as le-bucketed series)
        self.perf = (
            PerfCountersBuilder(name)
            .add_histogram("op_r_latency_hist",
                           "read op latency, microseconds "
                           "(log2 buckets)")
            .add_histogram("op_w_latency_hist",
                           "write op latency, microseconds "
                           "(log2 buckets)")
            # the telemetry plane's rate-queryable op
            # counter plus the objectstore commit/apply time-avgs
            # behind `ceph osd perf` (ref: l_osd_op +
            # os_commit_latency/os_apply_latency in osd_stat_t)
            .add_u64_counter("ops", "client ops completed")
            .add_time_avg("commit_latency",
                          "primary-side objectstore txn commit "
                          "seconds (time-avg)")
            .add_time_avg("apply_latency",
                          "replica-side objectstore txn apply "
                          "seconds (time-avg)")
            .create_perf_counters())
        # daemon -> mgr report session (ref: MgrClient):
        # the mgrmap subscription finds the active mgr; the reporter
        # ships this daemon's counter schema + value deltas there
        from ceph_tpu_torch.mgr.client import MgrReporter
        self._mgr_reporter = MgrReporter(
            name, self.msgr, lambda: self.monc.mgrmap,
            lambda: [self.perf, self.ec_agg.perf,
                     self.ec_read_agg.perf,
                     *([self.ec_resident.perf]
                       if self.ec_resident is not None else []),
                     # a BlueStore-backed OSD ships the
                     # shared-blob family (read LIVE off self.store,
                     # so a revive-remount swaps the new instance in)
                     *([self.store.perf]
                       if hasattr(self.store, "perf") else []),
                     self.devmon.perf, self._proc_devmon.perf], cfg)
        self._mgr_report_task: asyncio.Task | None = None
        self._slow_reported = 0     # last slow-op count sent monward
        self._device_reported: dict = {}   # last device_health sent
        self.asok = None
        self._asok_dir = cfg.get("admin_socket_dir")
        # backfill reservations (ref: AsyncReserver /
        # osd_max_backfills): local slots bound how many PGs this OSD
        # backfills AS PRIMARY, remote slots how many it accepts AS
        # TARGET
        max_backfills = cfg.get("osd_max_backfills", 1)
        self.local_reserver = AsyncReserver(max_backfills)
        self.remote_reserver = AsyncReserver(max_backfills)
        # op QoS scheduler (ref: mClockScheduler): the admission path's
        # dmClock-analog — client ops, recovery grants and scrub
        # rounds all dequeue through it (osd_op_queue=fifo reverts to
        # the pre-scheduler FIFO admission loop)
        self.scheduler = OpScheduler(cfg)
        # EC encode aggregator: concurrent stripe encodes
        # from every ECPG on this OSD coalesce into one padded batched
        # kernel launch per flush window (osd_ec_agg knobs, read LIVE)
        from ceph_tpu_torch.osd.ec_aggregator import ECAggregator
        self.ec_agg = ECAggregator(cfg)
        # EC decode/repair aggregator: the read-side twin —
        # degraded reads and recovery rebuilds from every ECPG coalesce
        # into one padded decode launch per flush window
        # (osd_ec_read_agg knobs, read LIVE); repair decodes charge the
        # scheduler's `recovery` class so a degraded-read storm can't
        # bypass QoS cost tags
        from ceph_tpu_torch.osd.ec_read_aggregator import ECReadAggregator
        self.ec_read_agg = ECReadAggregator(cfg,
                                            scheduler=self.scheduler)
        # hot-shard residency: gathered shard batches pin
        # device-side under osd_ec_resident_bytes, version-keyed so
        # writes invalidate by construction (None when disabled —
        # ec_pg probes with getattr)
        self.ec_resident = None
        if int(cfg.get("osd_ec_resident_bytes", 0)) > 0:
            from ceph_tpu_torch.ec.torch_plugin import DeviceShardCache
            self.ec_resident = DeviceShardCache(cfg, device=self.device)
        # recovery QoS: the side token bucket folded in as the
        # scheduler's `recovery` class (SchedulerThrottle keeps the
        # acquire/release shape every PG call site uses)
        self.recovery_throttle = SchedulerThrottle(
            self.scheduler,
            max_active=cfg.get("osd_recovery_max_active", 8),
            bytes_per_s=cfg.get("osd_recovery_max_bytes", 0),
            config=cfg)
        # client-op admission throttle (ref: OSD client_messenger
        # policy throttles, osd_client_message_cap /
        # osd_client_message_size_cap): ops past the caps queue at
        # admission instead of dispatching, draining as in-flight
        # ops complete (dequeue ORDER is the scheduler's)
        self.client_throttle = MessageThrottle(
            max_ops=int(cfg.get("osd_client_message_cap", 256)),
            max_bytes=int(cfg.get("osd_client_message_size_cap",
                                  500 << 20)))
        self._admit_task: asyncio.Task | None = None
        # per-peer heartbeat round-trip EWMA (µs source for the mon's
        # gray-failure slow-score; ref: the osd_perf commit/apply
        # latencies the reference reports per OSD)
        self._peer_rtt: dict[int, float] = {}
        # oldest UNANSWERED ping send-time per peer: a
        # frozen-but-connected peer (SIGSTOP) answers nothing, so its
        # RTT EWMA goes stale-LOW — the pending age is the live lower
        # bound on its real round trip and inflates the reported
        # latency until a reply lands
        self._hb_ping_pending: dict[int, float] = {}
        # central-config application state (baselines for `config rm`)
        self._mon_cfg_state: dict = {}
        # proc-backend children set this so mon config also mirrors
        # into the per-process global Config "mon" layer
        self.mirror_global_config = False
        # used-bytes sweep cache: (stamp, used)
        self._used_cache: tuple[float, int] | None = None
        # graceful shutdown in progress: suppresses the
        # wrongly-marked-down re-boot when OUR mark-me-down commits
        self._prepared_to_stop = False

    def store_used_bytes(self) -> int:
        """Local statfs (ref: ObjectStore::statfs): total object bytes
        in the store. O(objects) sweep, cached for half a second —
        callers are the stats loop, the failsafe at op admission and
        backfill_toofull."""
        now = asyncio.get_event_loop().time()
        if self._used_cache is not None and \
                now - self._used_cache[0] < 0.5:
            return self._used_cache[1]
        used = 0
        try:
            for cid in self.store.list_collections():
                for oid in self.store.list_objects(cid):
                    try:
                        used += self.store.stat(cid, oid)
                    except Exception:
                        pass
        except Exception:
            return 0
        self._used_cache = (now, used)
        return used

    def _mapping_status(self) -> dict:
        """Mapping-engine counters for asok ``status``: the epoch
        cache and delta-remap traffic (osdmap), the kernel/pack
        counters (crush_mapper), and this daemon's tracked table."""
        from ceph_tpu_torch.utils.perf_counters import PerfCountersCollection
        coll = PerfCountersCollection.instance()
        out = {}
        for name in ("osdmap", "crush_mapper"):
            pc = coll.get(name)
            if pc is not None:
                out[name] = pc.dump()
        if self.osdmap is not None:
            out["cache_hits"] = self.osdmap.mapping_cache_hits
            out["cache_misses"] = self.osdmap.mapping_cache_misses
        mt = self.monc.mapping_table
        if mt is not None:
            out["table_epoch"] = mt.epoch
        return out

    def _device_status(self) -> dict:
        """The asok ``device`` block / `device-runtime status`
        payload: this daemon's kernel-path health beside the process
        monitor's compile/transfer side (one daemon per process in
        production, so together they ARE the daemon's device view)."""
        from ceph_tpu_torch.utils import crash as _crash
        return {"daemon": self.devmon.dump(),
                "process": self._proc_devmon.dump(),
                "recent_crashes": _crash.recent_crashes()}

    def failsafe_full(self) -> bool:
        """The stale-map-proof last line of defense (ref: OSD
        osd_failsafe_full_ratio check in OSD::check_full_status):
        writes are rejected -ENOSPC at op admission against LOCAL
        statfs — even a client whose map predates the mon's FULL flag
        cannot push this store over the edge, and the reject happens
        before any transaction touches the store (never partially
        applied)."""
        cap = int(self.config.get("osd_capacity_bytes", 0))
        if cap <= 0:
            return False
        ratio = float(self.config.get("osd_failsafe_full_ratio", 0.97))
        return self.store_used_bytes() >= cap * ratio

    def backfill_toofull(self) -> bool:
        """Reject incoming backfill reservations past the full ratio
        (ref: OSDService::check_backfill_full -> backfill_toofull).
        Only meaningful when a capacity is configured — the stores
        this framework runs on have no intrinsic size."""
        cap = int(self.config.get("osd_capacity_bytes", 0))
        if cap <= 0:
            return False
        ratio = float(self.config.get("osd_backfill_full_ratio", 0.85))
        return self.store_used_bytes() >= cap * ratio

    # -- service facade used by PG ----------------------------------------
    def next_tid(self) -> int:
        self._tid += 1
        return self._tid

    def osd_is_up(self, osd: int) -> bool:
        if self.osdmap is None or osd >= self.osdmap.max_osd:
            return False
        return bool(self.osdmap.is_up(np.asarray(osd)))

    def osd_addr(self, osd: int) -> EntityAddr | None:
        ent = self.osdmap.osd_addrs.get(osd) if self.osdmap else None
        return EntityAddr(ent[0], ent[1]) if ent else None

    def osd_hb_addr(self, osd: int) -> EntityAddr | None:
        ent = self.osdmap.osd_addrs.get(osd) if self.osdmap else None
        return EntityAddr(ent[0], ent[2]) if ent and ent[2] else None

    async def send_osd(self, osd: int, msg) -> None:
        addr = self.osd_addr(osd)
        if addr is None:
            raise ConnectionError(f"osd.{osd} has no address")
        await asyncio.wait_for(
            self.msgr.send_message(msg, addr, f"osd.{osd}"),
            timeout=2.0)

    def request_repeer(self, pg: PG, delay: float = 0.5) -> None:
        async def later():
            await asyncio.sleep(delay)
            if pg.state == "peering" and pg.is_primary() and \
                    not self._stopped:
                pg.advance(pg.up, pg.acting, pg.primary, pg.epoch)
        asyncio.ensure_future(later())

    # -- lifecycle ---------------------------------------------------------
    async def _send_boot(self) -> None:
        await self.monc.send_report(MOSDBoot(
            osd=self.whoami, addr_host=self.msgr.addr.host,
            addr_port=self.msgr.addr.port,
            hb_port=self.hb_msgr.addr.port,
            boot_epoch=self.osdmap.epoch if self.osdmap else 0))

    def _apply_config_map(self, cfgmap: dict) -> None:
        """Apply a mon-published central config map: the
        wire analog of the in-process shared-dict live push, so a
        separate-process OSD follows `config set` without a restart."""
        from ceph_tpu_torch.utils.config import apply_mon_config
        changed = apply_mon_config(
            f"osd.{self.whoami}", cfgmap, self.config,
            self._mon_cfg_state,
            mirror_global=self.mirror_global_config)
        if changed:
            log.dout(10, f"osd.{self.whoami} applied mon config "
                         f"{sorted(changed)}")

    async def boot(self, host: str = "127.0.0.1") -> None:
        """ref: OSD::init + _send_boot."""
        await self.msgr.bind(host, 0)
        await self.hb_msgr.bind(host, 0)
        await self.monc.subscribe("osdmap", 0)
        # monmap following (runtime mon add/rm) + committed-keyring
        # following (auth rotation/revocation reach the daemon)
        await self.monc.subscribe("monmap", 0)
        # mgrmap following: the active mgr's address for the
        # perf-counter report session (re-opened on failover)
        await self.monc.subscribe("mgrmap", 0)
        if self.msgr.keyring is not None:
            await self.monc.subscribe("keyring", 0)
        # central config db: live knob flips reach this
        # daemon over the wire — the only path a separate-process
        # child has to the shared-dict semantics of the in-proc
        # backend (`config set osd ...` applies without a restart)
        self.monc.config_callbacks.append(self._apply_config_map)
        await self.monc.subscribe("config", 0)
        await self.monc.wait_for_osdmap()
        await self._send_boot()
        # wait until the map shows us up
        deadline = asyncio.get_event_loop().time() + 10.0
        while not self.up:
            if asyncio.get_event_loop().time() > deadline:
                raise TimeoutError(f"osd.{self.whoami} boot timed out")
            await self.monc.subscribe(
                "osdmap", (self.osdmap.epoch + 1) if self.osdmap else 0)
            await asyncio.sleep(0.05)
        if self._asok_dir:
            from ceph_tpu_torch.utils.admin_socket import AdminSocket
            self.asok = AdminSocket(
                f"{self._asok_dir}/osd.{self.whoami}.asok")
            self.asok.register(
                "status", lambda: {
                    "whoami": self.whoami, "up": self.up,
                    "epoch": self.osdmap.epoch if self.osdmap else 0,
                    "num_pgs": len(self.pgs),
                    "pgs": {p: pg.state
                            for p, pg in self.pgs.items()},
                    "client_throttle": self.client_throttle.dump(),
                    "qos": self.scheduler.dump(),
                    "fullness": {
                        "used_bytes": self.store_used_bytes(),
                        "capacity_bytes": int(self.config.get(
                            "osd_capacity_bytes", 0)),
                        "failsafe_full": self.failsafe_full(),
                        "backfill_toofull": self.backfill_toofull()},
                    "mapping": self._mapping_status(),
                    "ec_agg": self.ec_agg.dump(),
                    "ec_read_agg": self.ec_read_agg.dump(),
                    "ec_resident": (self.ec_resident.dump()
                                    if self.ec_resident is not None
                                    else {"enabled": False}),
                    "device": self._device_status(),
                    "mgr_session": self._mgr_reporter.dump()},
                "osd state summary")
            self.asok.register(
                "device-runtime status",
                lambda: self._device_status(),
                "device-runtime observability: engine, kernel-path "
                "launches/mismatches, jit compile count/time, "
                "transfer bytes (daemon + process views)")
            self.asok.register(
                "dump_ops_in_flight",
                self.op_tracker.dump_ops_in_flight,
                "in-flight client ops")
            self.asok.register(
                "dump_historic_ops",
                self.op_tracker.dump_historic_ops,
                "recently completed ops")
            self.asok.register(
                "ops", self.op_tracker.dump_ops_in_flight,
                "in-flight client ops (alias of dump_ops_in_flight)")
            self.asok.register(
                "dump_slow_ops", self.op_tracker.dump_slow_ops,
                "in-flight ops older than the complaint threshold")
            self.asok.register(
                "dump_qos", lambda: {
                    "scheduler": self.scheduler.dump(),
                    "recovery_throttle": self.recovery_throttle.dump(),
                    "peer_rtt_us": {str(o): int(r * 1e6)
                                    for o, r in
                                    sorted(self._peer_rtt.items())}},
                "op QoS scheduler queues, the folded-in recovery "
                "throttle, and per-peer heartbeat RTTs")
            self.asok.register(
                "dump_tracing", self.tracer.dump,
                "completed trace spans (bounded buffer + slow ring) "
                "and the tracer's sampling/retention state")
            self.asok.register(
                "config show", lambda: dict(self.config),
                "daemon configuration")
            self.asok.register(
                "dump_backoffs", lambda: {
                    p: pg.dump_backoffs()
                    for p, pg in self.pgs.items()
                    if pg.backoffs},
                "asserted client backoffs per pg")
            self.asok.register(
                "backfill status", lambda: {
                    "local_reservations": self.local_reserver.dump(),
                    "remote_reservations": self.remote_reserver.dump(),
                    "throttle": self.recovery_throttle.dump(),
                    "pgs": {p: {"state": pg.state,
                                "last_backfill": pg.last_backfill,
                                **pg.backfill_stats,
                                "targets": {
                                    str(o): wm for o, wm in
                                    pg.backfill_targets.items()}}
                            for p, pg in self.pgs.items()
                            if pg.backfill_targets or
                            pg.last_backfill != MAX_OID}},
                "backfill reservations, throttle and per-pg progress")
            await self.asok.start()
        # crash capture: every long-lived loop carries the
        # top-level exception hook — a loop that dies with a real
        # exception ships a bounded MCrashReport monward instead of
        # leaving a silently half-alive daemon
        from ceph_tpu_torch.utils import crash as _crash
        _name = f"osd.{self.whoami}"
        self._hb_task = _crash.watch(
            asyncio.ensure_future(self._hb_loop()), _name, self.monc,
            where="hb_loop")
        self._stats_task = _crash.watch(
            asyncio.ensure_future(self._stats_loop()), _name,
            self.monc, where="stats_loop")
        self._admit_task = _crash.watch(
            asyncio.ensure_future(self._admit_loop()), _name,
            self.monc, where="admit_loop")
        self._mgr_report_task = _crash.watch(
            asyncio.ensure_future(self._mgr_reporter.loop()), _name,
            self.monc, where="mgr_report_loop")
        if self.scrub_interval > 0:
            self._scrub_task = _crash.watch(
                asyncio.ensure_future(self._scrub_loop()), _name,
                self.monc, where="scrub_loop")
        # clog the boot (ref: OSD::init's "osd.N ... boot" clog line)
        asyncio.ensure_future(self.monc.clog(
            "INF", f"osd.{self.whoami} booted at {self.msgr.addr}"))
        log.dout(1, f"osd.{self.whoami} booted at {self.msgr.addr}")

    async def stop(self, mark_down: bool = False) -> None:
        """``mark_down=True`` is the graceful path (ref: OSD::shutdown
        -> MOSDMarkMeDown): tell the mon we are going so the down
        commits in the next incremental instead of after a full
        heartbeat-grace of client timeouts. The Thrasher kill path
        stays ungraceful by design — it models a crash."""
        if mark_down and self.up and not self._stopped and \
                self.osdmap is not None:
            self._prepared_to_stop = True
            try:
                await self.monc.send_report(MOSDMarkMeDown(
                    osd=self.whoami, epoch=self.osdmap.epoch))
                # the committed map is the ack: our subscription is
                # still live, _on_osdmap flips self.up
                deadline = asyncio.get_event_loop().time() + 3.0
                while self.up and \
                        asyncio.get_event_loop().time() < deadline:
                    await self.monc.subscribe(
                        "osdmap", self.osdmap.epoch + 1)
                    await asyncio.sleep(0.05)
            except Exception as e:
                log.dout(1, f"osd.{self.whoami} mark-me-down failed "
                            f"({e}); stopping anyway")
        self._stopped = True
        cancelled = []
        for task in (self._hb_task, self._stats_task,
                     self._scrub_task, self._admit_task,
                     self._mgr_report_task):
            if task:
                task.cancel()
                cancelled.append(task)
        for pg in self.pgs.values():
            if pg._worker:
                pg._worker.cancel()
                cancelled.append(pg._worker)
            if pg._peering_task:
                pg._peering_task.cancel()
            if pg._backfill_task:
                pg._backfill_task.cancel()
        # let the cancelled workers unwind so their in-flight ops'
        # finally blocks release their throttle slots NOW, then drain
        # every queued-but-never-executed op — a kill mid-admission
        # must not strand MessageThrottle tokens (the Thrasher-exposed
        # leak: queued costs were only released on primaryship loss,
        # never on daemon stop). RE-cancel survivors: pre-3.12
        # asyncio.wait_for can swallow a cancellation that races the
        # inner future's completion, leaving a worker looping back to
        # its queue with the cancel consumed — one more cancel() ends
        # it (seen under the QoS storm's 64-writer flood).
        pending = set(cancelled)
        for _ in range(8):
            if not pending:
                break
            done, pending = await asyncio.wait(pending, timeout=0.5)
            for task in pending:
                task.cancel()
        self.scheduler.drain(release=self._release_admission)
        self.ec_agg.drain()
        self.ec_read_agg.drain()
        if self.ec_resident is not None:
            self.ec_resident.clear()
        for pg in self.pgs.values():
            pg._drain_op_queue()
        if self.asok:
            await self.asok.stop()
        await self.msgr.shutdown()
        await self.hb_msgr.shutdown()

    # -- map handling ------------------------------------------------------
    async def _on_osdmap(self, osdmap) -> None:
        """ref: OSD::handle_osd_map + consume_map."""
        self.osdmap = osdmap
        was_up = self.up
        self.up = self.osd_is_up(self.whoami)
        if was_up and not self.up and not self._stopped and \
                not self._prepared_to_stop:
            # wrongly marked down (ref: OSD::_committed_osd_maps "I was
            # wrongly marked down" -> re-boot): announce ourselves again
            log.dout(1, f"osd.{self.whoami} marked down but alive; "
                        f"re-booting")
            asyncio.ensure_future(self._send_boot())
        by_pool: dict[int, list[PG]] = {}
        for pg in self.pgs.values():
            by_pool.setdefault(pg.pool.id, []).append(pg)
        # pg merging (ref: PG::merge_from on a committed pg_num
        # decrease — the inverse of the split below): every local PG
        # whose seed fell off its pool's new pg_num folds its objects
        # AND log into the stable-mod parent BEFORE anything peers at
        # the new map. Like the split, this is store-derived and runs
        # on every holder of source data — including an OSD that BOOTS
        # after the decrease with stale source collections on disk
        # (the down-during-merge case), which would otherwise strand
        # the folded history. ONE store scan per map advance (not per
        # pool): leftovers are empty on every epoch that didn't merge.
        stale = self._stale_merge_collections(osdmap)
        for pool in osdmap.pools.values():
            if stale.get(pool.id) or any(
                    pg.pgid.seed >= pool.pg_num
                    for pg in by_pool.get(pool.id, [])):
                self._fold_merged_pgs(pool, by_pool,
                                      stale.get(pool.id, []))
            seeds = np.arange(pool.pg_num, dtype=np.uint32)
            up, upp, acting, actp = osdmap.pg_to_up_acting_osds(
                pool.id, seeds)
            mine = np.flatnonzero(
                (acting == self.whoami).any(axis=1) |
                (up == self.whoami).any(axis=1) |
                (actp == self.whoami) | (upp == self.whoami))
            cls = ECPG if pool.is_erasure() else PG
            for s in mine:
                pgid = pg_t(pool.id, int(s))
                if str(pgid) not in self.pgs:
                    pg = self.pgs[str(pgid)] = cls(self, pool, pgid)
                    by_pool.setdefault(pool.id, []).append(pg)
            # pg splitting (ref: OSD::consume_map split tracking): a
            # grown pg_num re-folds object names; every local PG moves
            # its re-folded objects AND log entries into the child
            # BEFORE anything peers at the new map. Runs AFTER child
            # instantiation so split_objects can update the children's
            # in-memory logs (a child instance constructed above loaded
            # its pre-split — possibly empty — persisted log). Besides
            # the in-memory pg_num transition, the (idempotent,
            # store-derived) split runs once per PG instance: an OSD
            # that BOOTS after the increase builds its PGs from the new
            # map and would otherwise never observe a delta, stranding
            # re-folded objects in the parent collection.
            for pg in list(by_pool.get(pool.id, [])):
                if pool.pg_num > pg.pool.pg_num or \
                        not getattr(pg, "_split_checked", False):
                    touched = pg.split_objects(osdmap, pool)
                    pg._split_checked = True
                    # a batched pg_num+pgp_num consume can move a child
                    # away before it ever instantiates here: create the
                    # instance for any child we hold data for, so it
                    # becomes a STRAY that announces itself to the new
                    # primary instead of silently stranding the data
                    for child_cid in touched:
                        if child_cid not in self.pgs:
                            cpg = self.pgs[child_cid] = cls(
                                self, pool, pg_t.parse(child_cid))
                            by_pool[pool.id].append(cpg)
            for pg in by_pool.get(pool.id, []):
                row = pg.pgid.seed
                pg.pool = pool
                # EC sets are positional: holes stay as -1 markers
                pg.advance(
                    [int(o) if o != ITEM_NONE else -1
                     for o in up[row]],
                    [int(o) if o != ITEM_NONE else -1
                     for o in acting[row]],
                    int(actp[row]), osdmap.epoch)
        # drop PGs whose pool vanished
        for pgid_s in [p for p, pg in self.pgs.items()
                       if pg.pool.id not in osdmap.pools]:
            self.pgs.pop(pgid_s)
        self._kick_snap_trim(osdmap, by_pool)

    def _kick_snap_trim(self, osdmap, by_pool: dict) -> None:
        """Consume the pool removed_snaps deletion queue riding the
        osdmap (ref: OSDMap pg_pool_t::removed_snaps + the PG snap
        trimmer wakeup in PeeringState::activate): every snapid newly
        observed as removed gets a background trim pass on each local
        primary PG of the pool. Tracking is in-memory only — a restart
        replays the whole queue, which is safe because trimming is
        idempotent (clones covering nothing are already gone)."""
        for pool in osdmap.pools.values():
            removed = pool.extra.get("removed_snaps") or []
            fresh = [s for s in removed
                     if s not in self._snaps_trimmed.get(pool.id, set())]
            if not fresh:
                continue
            self._snaps_trimmed.setdefault(pool.id, set()).update(fresh)
            pgs = [pg for pg in by_pool.get(pool.id, [])
                   if pg.is_primary() and not pool.is_erasure()]
            if not pgs:
                continue
            batch = int(self.config.get("osd_snap_trim_batch", 16))
            sleep = float(self.config.get("osd_snap_trim_sleep", 0.0))

            async def trim(pgs=pgs, fresh=fresh, batch=batch,
                           sleep=sleep):
                for sid in fresh:
                    for pg in pgs:
                        try:
                            n = await pg.snap_trim_removed(
                                sid, batch, sleep)
                        except Exception as e:   # trim is best-effort
                            log.dout(1, f"snap trim pg {pg.pgid} "
                                        f"snap {sid}: {e!r}")
                            continue
                        if n:
                            log.dout(10, f"snap trim pg {pg.pgid}: "
                                         f"snap {sid}, {n} objects")
            asyncio.ensure_future(trim())

    def _stale_merge_collections(self, osdmap) -> dict[int, list]:
        """ONE pass over the store: pool id -> [(seed, cid)] of
        on-disk collections whose seed fell off the pool's pg_num
        (merge leftovers from a decrease this OSD slept through)."""
        out: dict[int, list] = {}
        for cid in self.store.list_collections():
            pid_s, _, seed_s = cid.partition(".")
            try:
                pid, seed = int(pid_s), int(seed_s, 16)
            except ValueError:
                continue
            pool = osdmap.pools.get(pid)
            if pool is not None and seed >= pool.pg_num:
                out.setdefault(pid, []).append((seed, cid))
        return out

    def _fold_merged_pgs(self, pool, by_pool: dict,
                         stale: list) -> None:
        """Fold every local merge-leftover of ``pool`` (instance or
        stale on-disk collection with seed >= the committed pg_num)
        into its stable-mod parent. The parent is instantiated when
        absent — it may not even be in our acting set (we become a
        STRAY holding merged data, and the existing notify machinery
        announces it to the real primary)."""
        import numpy as np
        cls = ECPG if pool.is_erasure() else PG
        pool_pgs = by_pool.setdefault(pool.id, [])
        leftovers = [pg for pg in pool_pgs
                     if pg.pgid.seed >= pool.pg_num]
        # stale on-disk collections without an instance (booted after
        # the merge committed)
        have = {pg.cid for pg in pool_pgs}
        for seed, cid in stale:
            if cid not in have:
                leftovers.append(cls(self, pool, pg_t(pool.id, seed)))
        for src in leftovers:
            parent_seed = int(pool.raw_pg_to_pg(
                np.asarray([src.pgid.seed]), xp=np)[0])
            parent_cid = str(pg_t(pool.id, parent_seed))
            parent = self.pgs.get(parent_cid)
            if parent is None:
                parent = self.pgs[parent_cid] = cls(
                    self, pool, pg_t.parse(parent_cid))
                pool_pgs.append(parent)
            parent.pool = pool
            parent.merge_from(src)
            self.pgs.pop(src.cid, None)
            if src in pool_pgs:
                pool_pgs.remove(src)

    # -- dispatch ----------------------------------------------------------
    def _pg_for(self, pgid_s: str, create: bool = False) -> PG | None:
        pg = self.pgs.get(pgid_s)
        if pg is None and create and self.osdmap is not None:
            pgid = pg_t.parse(pgid_s)
            pool = self.osdmap.pools.get(pgid.pool)
            if pool is None or pgid.seed >= pool.pg_num:
                # merged-away seed: a stale client (or peer) still
                # folding by the old pg_num must NOT resurrect the
                # source PG — the -11 reply below sends it for a
                # fresh map, which retargets the merged parent
                return None
            cls = ECPG if pool.is_erasure() else PG
            pg = self.pgs[pgid_s] = cls(self, pool, pgid)
            up, upp, acting, actp = self.osdmap.pg_to_up_acting_osds(
                pgid.pool, [pgid.seed])
            pg.advance([int(o) if o != ITEM_NONE else -1
                        for o in up[0]],
                       [int(o) if o != ITEM_NONE else -1
                        for o in acting[0]],
                       int(actp[0]), self.osdmap.epoch)
        return pg

    async def ms_dispatch(self, msg) -> bool:
        if isinstance(msg, MOSDMapPing):
            # epoch-barrier probe: report the map we actually serve
            # ops against (ref: the OSD side of epoch barriers)
            from ceph_tpu_torch.osd.messages import MOSDMapPingReply
            await msg.conn.send_message(MOSDMapPingReply(
                tid=msg.tid,
                epoch=self.osdmap.epoch if self.osdmap else 0,
                from_osd=self.whoami))
            return True
        if isinstance(msg, MOSDOp):
            if self.osdmap is not None and \
                    self.osdmap.is_blocklisted(msg.src):
                # cluster-level fence (ref: OSD::ms_handle_fast_connect
                # blocklist check): an evicted/zombie client's ops are
                # refused with EBLOCKLISTED no matter when it resumes
                from ceph_tpu_torch.osd.messages import MOSDOpReply
                await msg.conn.send_message(MOSDOpReply(
                    tid=msg.tid, attempt=getattr(msg, "attempt", 0),
                    result=-108, epoch=self.osdmap.epoch, data=b"",
                    extra=""))
                return True
            if self._op_cap_denied(msg):
                # per-op cap enforcement (the auth caps applied per op):
                # the handshake-authenticated entity's `osd` caps are
                # checked HERE, on the same admission path the
                # scheduler owns — an `osd r`-only entity's write is
                # refused -EPERM before it touches any queue. Capless
                # entities stay unrestricted (legacy boot keys), like
                # the mon-side slice.
                from ceph_tpu_torch.osd.messages import MOSDOpReply
                await msg.conn.send_message(MOSDOpReply(
                    tid=msg.tid, attempt=getattr(msg, "attempt", 0),
                    result=-1, epoch=self.osdmap.epoch
                    if self.osdmap else 0, data=b"", extra=""))
                return True
            pg = self._pg_for(str(pg_t(msg.pool, msg.seed)))
            if pg is None or not pg.is_primary():
                # wrong target: client's map is stale; it will resend
                from ceph_tpu_torch.osd.messages import MOSDOpReply
                await msg.conn.send_message(MOSDOpReply(
                    tid=msg.tid, attempt=getattr(msg, "attempt", 0),
                    result=-11, epoch=self.osdmap.epoch
                    if self.osdmap else 0, data=b"", extra=""))
                return True
            from ceph_tpu_torch.osd.messages import OSD_OP_NOTIFY_ACK
            if msg.op_codes and all(c == OSD_OP_NOTIFY_ACK
                                    for c in msg.op_codes):
                # acks complete a notify the op worker may itself be
                # awaiting — bypass the serialized queue. ONLY pure
                # ack bundles: a mixed bundle with mutating ops must
                # keep the per-PG serialization the queue provides.
                await pg._execute(msg)
                return True
            if any(c in MUTATING_OPS for c in msg.op_codes) and \
                    self.failsafe_full():
                # stale-map-proof failsafe: this store is past
                # osd_failsafe_full_ratio — reject BEFORE any txn is
                # built, whatever epoch (or FULL_TRY flag) the op
                # carries. Nothing is partially applied.
                from ceph_tpu_torch.osd.messages import MOSDOpReply
                OVERLOAD_PERF.inc("failsafe_rejections")
                log.dout(1, f"osd.{self.whoami} failsafe ENOSPC "
                            f"for {msg.oid}")
                await msg.conn.send_message(MOSDOpReply(
                    tid=msg.tid, attempt=getattr(msg, "attempt", 0),
                    result=-28, epoch=self.osdmap.epoch
                    if self.osdmap else 0, data=b"", extra=""))
                return True
            if pg.merge_ready():
                # merge-source quiesce (ref: the not-ready-to-merge op
                # block): once a source reported ready, NEW client ops
                # park via backoff until the pg_num decrease commits —
                # the parked client then retargets the merged parent.
                # This is the data-safety invariant's "parked" half;
                # ops admitted before readiness land in the log and
                # fold into the parent ("land in the merged parent").
                await pg.send_backoff(msg)
                return True
            queue_cap = int(
                self.config.get("osd_pg_op_queue_cap", 512))
            entity = msg.src or "?"
            if not pg.role_active() or \
                    pg.op_queue.qsize() >= queue_cap or \
                    self.scheduler.backlog(
                        ("client", entity, msg.pool)) >= queue_cap or \
                    self.scheduler.queued >= int(self.config.get(
                        "osd_qos_backlog_cap", 4096)):
                # not ready (peering) or saturated — the per-PG queue,
                # this TENANT's admission backlog (the throttle caps
                # dispatched ops below the PG cap, so the backlog is
                # where a flood actually piles up; per-tenant, so a
                # hot tenant's pile-up backs off the hot tenant, not
                # everyone), OR the OSD-WIDE backlog bound (per-tenant
                # caps alone would let 10k distinct tenants hold 10k x
                # queue_cap payloads in memory): backoff instead of
                # queueing unboundedly — the client parks and resends
                # after our UNBLOCK (ref: the PG Backoff machinery)
                await pg.send_backoff(msg)
                return True
            # admission: ops queue at the scheduler (dmClock tags per
            # client/pool queue; FIFO with osd_op_queue=fifo) rather
            # than dispatch (ref: mClockScheduler::enqueue)
            op_span = self.tracer.from_msg(
                "osd_op", msg, tags={"osd": self.whoami,
                                     "oid": msg.oid})
            if op_span is not None:
                # the op's primary-side span opens at admission; its
                # "queue" child covers throttle + pg-queue wait and is
                # closed by the op worker when execution starts
                msg._span = op_span
                msg._queue_span = op_span.child("queue")
            self.scheduler.submit(
                msg, key=("client", entity, msg.pool),
                profile=self._client_profile(entity, pg.pool),
                cost=self._op_cost(msg))
            return True
        if isinstance(msg, MOSDRepOp):
            pg = self._pg_for(msg.pgid, create=True)
            if pg is not None:
                pg.handle_rep_op(msg)
            return True
        if isinstance(msg, MOSDRepOpReply):
            pg = self._pg_for(msg.pgid)
            if pg is not None:
                pg.handle_rep_reply(msg)
            return True
        if isinstance(msg, MOSDECSubOpWrite):
            pg = self._pg_for(msg.pgid, create=True)
            if isinstance(pg, ECPG):
                pg.handle_ec_sub_write(msg)
            else:
                log.dout(1, f"ec sub-write for non-ec pg {msg.pgid}")
                await msg.conn.send_message(MOSDECSubOpWriteReply(
                    tid=msg.tid, result=-22, pgid=msg.pgid,
                    from_osd=self.whoami))
            return True
        if isinstance(msg, MOSDECSubOpWriteReply):
            pg = self._pg_for(msg.pgid)
            if isinstance(pg, ECPG):
                pg.handle_ec_sub_write_reply(msg)
            return True
        if isinstance(msg, MOSDECSubOpRead):
            pg = self._pg_for(msg.pgid, create=True)
            if isinstance(pg, ECPG):
                pg.handle_ec_sub_read(msg)
            else:
                log.dout(1, f"ec sub-read for non-ec pg {msg.pgid}")
            return True
        if isinstance(msg, MOSDECSubOpReadReply):
            pg = self._pg_for(msg.pgid)
            if isinstance(pg, ECPG):
                pg.handle_ec_sub_read_reply(msg)
            return True
        if isinstance(msg, MOSDPGQuery):
            pg = self._pg_for(msg.pgid, create=True)
            if pg is not None:
                pg.handle_pg_query(msg)
            return True
        if isinstance(msg, MOSDPGInfo):
            # create=True: an unsolicited stray NOTIFY may beat this
            # primary's own consume_map to the PG — dropping it loses
            # the only pointer to the data's old location
            pg = self._pg_for(msg.pgid, create=bool(
                getattr(msg, "notify", 0)))
            if pg is not None:
                pg.handle_pg_info(msg)
            return True
        if isinstance(msg, MOSDPGPull):
            pg = self._pg_for(msg.pgid)
            if pg is not None:
                pg.handle_pg_pull(msg)
            return True
        if isinstance(msg, MOSDPGPush):
            pg = self._pg_for(msg.pgid, create=True)
            if pg is not None and pg.apply_push(msg):
                # ack ONLY on durable apply: the primary counts acked
                # pushes as recovered (durability promotion gate)
                await self.send_osd(msg.from_osd, MOSDPGPushReply(
                    pgid=msg.pgid, oid=msg.oid, from_osd=self.whoami))
            return True
        if isinstance(msg, MOSDPGPushReply):
            pg = self._pg_for(msg.pgid)
            if pg is not None:
                pg.handle_push_reply(msg)
            return True
        if isinstance(msg, MPGCleanNotice):
            pg = self._pg_for(msg.pgid)
            if pg is not None:
                pg.handle_clean_notice(msg)
            return True
        if isinstance(msg, MOSDPGScan):
            # create=True: a scan can beat the target's own map
            # consume to a PG it is about to host
            pg = self._pg_for(msg.pgid, create=True)
            if pg is not None:
                pg.handle_pg_scan(msg)
            return True
        if isinstance(msg, MOSDPGScanReply):
            pg = self._pg_for(msg.pgid)
            if pg is not None:
                pg.handle_scan_reply(msg)
            return True
        if isinstance(msg, MOSDPGBackfill):
            pg = self._pg_for(msg.pgid, create=True)
            if pg is not None:
                pg.handle_backfill(msg)
            return True
        if isinstance(msg, MOSDPGBackfillReply):
            pg = self._pg_for(msg.pgid)
            if pg is not None:
                pg.handle_backfill_reply(msg)
            return True
        if isinstance(msg, MBackfillReserve):
            pg = self._pg_for(msg.pgid, create=True)
            if pg is not None:
                pg.handle_backfill_reserve(msg)
            return True
        if isinstance(msg, MOSDBackoff):
            # a client's ACK_BLOCK — informational only (the backoff
            # stays asserted until we UNBLOCK)
            return True
        if isinstance(msg, MOSDPGRepair):
            pg = self._pg_for(msg.pgid)
            if pg is not None and pg.is_primary():
                # ref: the PG_REPAIR scrub flavor: detect + rewrite
                # from the authoritative copy, then re-verify
                asyncio.ensure_future(pg.scrubber.repair())
            return True
        if isinstance(msg, MOSDRepScrub):
            pg = self._pg_for(msg.pgid)
            if pg is not None:
                from ceph_tpu_torch.osd.scrub import build_scrub_map
                await msg.conn.send_message(MOSDRepScrubMap(
                    pgid=msg.pgid, tid=msg.tid, from_osd=self.whoami,
                    scrub_map=build_scrub_map(pg)))
            return True
        if isinstance(msg, MOSDRepScrubMap):
            pg = self._pg_for(msg.pgid)
            if pg is not None and pg._scrubber is not None:
                pg.scrubber.handle_map(msg)
            return True
        return False

    def _op_cap_denied(self, msg) -> bool:
        """Per-op OSD cap check (ref: OSDCap::is_capable, scoped to
        the r/w class): True when the sender has a configured cap
        table whose `osd` spec does not grant the op's class. Capless
        entities are unrestricted — same legacy-boot-key policy as the
        mon command slice."""
        kr = self.msgr.keyring
        if kr is None or not msg.src:
            return False
        caps = kr.caps_of(msg.src)
        if not caps:
            return False
        from ceph_tpu_torch.msg.auth import cap_allows
        need = "w" if any(c in MUTATING_OPS for c in msg.op_codes) \
            else "r"
        return not cap_allows(str(caps.get("osd", "")), need)

    def _op_cost(self, msg) -> float:
        """Size-scaled dmClock cost over the op bundle's bytes, so a
        4 MiB op is charged honestly against 4 KiB ops sharing the
        weight (scheduler.size_scaled_cost — the same divisor the
        recovery throttle charges). Writes carry their bytes in the
        data blobs; READS carry theirs in op_lens with empty blobs —
        both count, or a 4 MiB reader rides at the flat minimum
        (a length-0 whole-object read still does: its size is
        unknowable at admission, the reference mclock limitation)."""
        datas = getattr(msg, "op_datas", ())
        lens = getattr(msg, "op_lens", None) or (0,) * len(datas)
        nbytes = sum(max(len(d), int(ln))
                     for d, ln in zip(datas, lens))
        return size_scaled_cost(self.config, nbytes)

    def _client_profile(self, entity: str, pool) -> QoSProfile:
        """QoS profile resolution for one client op: per-entity
        `osd client-profile` (rides the osdmap) > pool `qos_*` >
        the osd_qos_default_* knobs."""
        om = self.osdmap
        ent = om.client_profiles.get(entity) if om is not None else None
        if ent:
            return QoSProfile(reservation=float(ent[0]),
                              weight=float(ent[1]) or 1.0,
                              limit=float(ent[2]))
        if pool is not None and (pool.qos_reservation or
                                 pool.qos_weight or pool.qos_limit):
            return QoSProfile(reservation=float(pool.qos_reservation),
                              weight=float(pool.qos_weight) or 1.0,
                              limit=float(pool.qos_limit))
        return self.scheduler.default_profile()

    async def _admit_loop(self) -> None:
        """Admission drain: the scheduler decides ORDER (reservation
        -> weight -> limit across client/recovery/scrub queues; plain
        FIFO with osd_op_queue=fifo), the MessageThrottle decides
        VOLUME — a dequeued client op still takes a throttle slot
        before reaching its PG queue, released when the PG op worker
        finishes. Backpressure lands HERE, not on the connection
        reader loop. Recovery/scrub grants resolve inline (their
        concurrency bound is SchedulerThrottle's semaphore)."""
        try:
            while not self._stopped:
                msg, _op_class = await self.scheduler.dequeue()
                if isinstance(msg, _Grant):
                    if not msg.fut.done():
                        msg.fut.set_result(True)
                    continue
                cost = sum(len(d) for d in msg.op_datas)
                if self.client_throttle._would_block(cost):
                    # THIS op's acquire would park (op-count cap or
                    # byte budget — .saturated alone misses the
                    # byte-budget case). Park WITHOUT stalling grants:
                    # a saturated client cap (e.g. ops wedged on a
                    # degraded replica) must not block the recovery
                    # pushes that may be needed to unwedge it —
                    # grants never consume throttle slots, so they
                    # keep flowing while this op waits its turn
                    OVERLOAD_PERF.inc("throttle_queued")
                    acq = asyncio.ensure_future(
                        self.client_throttle.acquire(cost))
                    try:
                        while not acq.done():
                            g = self.scheduler.pop_grant()
                            if isinstance(g, _Grant):
                                if not g.fut.done():
                                    g.fut.set_result(True)
                                continue
                            # sleep until the slot frees OR a new
                            # submission arrives (a grant may ride
                            # it) — no timer polling: clearing the
                            # event first is safe because try_dequeue
                            # scans the queues directly, never the
                            # event
                            self.scheduler._event.clear()
                            ev = asyncio.ensure_future(
                                self.scheduler._event.wait())
                            try:
                                await asyncio.wait(
                                    {acq, ev},
                                    return_when=asyncio
                                    .FIRST_COMPLETED)
                            finally:
                                if not ev.done():
                                    ev.cancel()
                        await acq
                    except asyncio.CancelledError:
                        acq.cancel()
                        try:
                            await acq
                            # the acquire raced the cancel and WON:
                            # give the slot back or it leaks
                            self.client_throttle.release(cost)
                        except asyncio.CancelledError:
                            pass
                        raise
                else:
                    await self.client_throttle.acquire(cost)
                msg._throttle_cost = cost
                pg = self._pg_for(str(pg_t(msg.pool, msg.seed)))
                if pg is None or not pg.is_primary():
                    # the map moved while the op waited for admission
                    self.client_throttle.release(cost)
                    from ceph_tpu_torch.osd.messages import MOSDOpReply
                    try:
                        await msg.conn.send_message(MOSDOpReply(
                            tid=msg.tid,
                            attempt=getattr(msg, "attempt", 0),
                            result=-11,
                            epoch=self.osdmap.epoch
                            if self.osdmap else 0, data=b"", extra=""))
                    except Exception:
                        pass
                    continue
                await pg.queue_op(msg)
        except asyncio.CancelledError:
            pass

    def _release_admission(self, msg) -> None:
        """Release a drained op's admission-throttle slot (no-op for
        ops that never reached the throttle)."""
        cost = getattr(msg, "_throttle_cost", None)
        if cost is not None:
            self.client_throttle.release(cost)

    # -- heartbeats --------------------------------------------------------
    async def _hb_loop(self) -> None:
        """ref: OSD::heartbeat + heartbeat_check. Guard: when OUR event
        loop stalls (e.g. a long jit compile elsewhere in-process), the
        silence is ours, not the peers' — reset rx stamps instead of
        accusing everyone (the reference's equivalent is the grace
        adjustment by osd_heartbeat_stale / clock skew checks)."""
        last_iter = asyncio.get_event_loop().time()
        try:
            while not self._stopped:
                await asyncio.sleep(self.hb_interval)
                if self.osdmap is None:
                    continue
                now = asyncio.get_event_loop().time()
                if now - last_iter > self.hb_grace:
                    for o in list(self._hb_last_rx):
                        self._hb_last_rx[o] = now
                    for o in list(self._hb_ping_pending):
                        # our own stall: don't let pending ages accuse
                        # peers of our silence
                        self._hb_ping_pending[o] = now
                last_iter = now
                for o in range(self.osdmap.max_osd):
                    if o == self.whoami or not self.osd_is_up(o):
                        self._hb_last_rx.pop(o, None)
                        self._peer_rtt.pop(o, None)   # stale evidence
                        self._hb_ping_pending.pop(o, None)
                        continue
                    addr = self.osd_hb_addr(o)
                    if addr is None:
                        continue
                    self._hb_last_rx.setdefault(o, now)
                    try:
                        await asyncio.wait_for(
                            self.hb_msgr.send_message(MOSDPing(
                                op=PING, from_osd=self.whoami,
                                epoch=self.osdmap.epoch,
                                stamp=now), addr, f"osd.{o}"),
                            timeout=1.0)
                        # only the OLDEST outstanding ping is kept: its
                        # age is the peer's unanswered-for window
                        self._hb_ping_pending.setdefault(o, now)
                    except Exception:
                        pass
                    if now - self._hb_last_rx[o] > self.hb_grace and \
                            now - self._hb_reported.get(o, 0) > \
                            self.hb_grace:
                        self._hb_reported[o] = now
                        await self._report_failure(o)
                    elif o in self._hb_reported and \
                            now - self._hb_last_rx[o] <= self.hb_grace:
                        # the peer resumed within grace after we
                        # accused it: withdraw the report (ref:
                        # OSD::send_still_alive) so our stale
                        # accusation can't later pair with another
                        # reporter's and wrongly mark it down
                        self._hb_reported.pop(o, None)
                        await self.monc.send_report(MOSDFailure(
                            target=o, failed_for=0,
                            epoch=self.osdmap.epoch,
                            reporter=f"osd.{self.whoami}", alive=1))
        except asyncio.CancelledError:
            pass

    async def _scrub_loop(self) -> None:
        """Round-robin background scrub (ref: OSD::sched_scrub).
        Each PG's round takes a `scrub`-class grant from the op
        scheduler first (weight-only, `osd_qos_scrub_*`), so scrub is
        background best-effort against client and recovery work."""
        try:
            while not self._stopped:
                await asyncio.sleep(self.scrub_interval)
                for pg in list(self.pgs.values()):
                    # never scrub mid-recovery: legitimately missing
                    # objects would read as inconsistencies
                    if pg.is_primary() and pg.state in ("active",
                                                        "clean"):
                        await self.scheduler.grant("scrub")
                        await pg.scrubber.scrub()
        except asyncio.CancelledError:
            pass

    async def _report_failure(self, target: int) -> None:
        """ref: OSD::send_failures -> MOSDFailure to the mon."""
        await self.monc.send_report(MOSDFailure(
            target=target, failed_for=int(self.hb_grace),
            epoch=self.osdmap.epoch,
            reporter=f"osd.{self.whoami}"))

    def _hb_rx(self, m: MOSDPing) -> None:
        now = asyncio.get_event_loop().time()
        self._hb_last_rx[m.from_osd] = now
        self._hb_ping_pending.pop(m.from_osd, None)
        if m.op == PING_REPLY and m.stamp:
            # gray-failure signal: the PING_REPLY echoes OUR send
            # stamp, so now - stamp is a full round trip through the
            # peer's event loop — a slow-but-alive disk/host inflates
            # it long before heartbeats time out. EWMA smooths
            # scheduler jitter; the mon turns the fleet's reports into
            # a relative slow-score (ref: the osd_perf ping-time data
            # `dump_osd_network` exposes upstream).
            rtt = max(now - m.stamp, 0.0)
            prev = self._peer_rtt.get(m.from_osd)
            self._peer_rtt[m.from_osd] = rtt if prev is None else \
                0.7 * prev + 0.3 * rtt

    # -- stats -------------------------------------------------------------
    async def _stats_loop(self) -> None:
        """ref: OSD::ms_handle / MPGStats reporting loop."""
        try:
            while not self._stopped:
                await asyncio.sleep(self.stats_interval)
                if self.osdmap is None:
                    continue
                # keep subscriptions alive even with nothing to report
                # (2s-throttled, background): our session mon may have
                # died/been removed, taking the subs with it
                self.monc.renew_subs()
                stats = {p: json.dumps(pg.stats()).encode()
                         for p, pg in self.pgs.items()
                         if pg.is_primary()}
                slow = len(self.op_tracker.slow_ops())
                # statfs piggyback (ref: osd_stat_t): the mon derives
                # NEARFULL/FULL state and the cluster FULL flag from
                # it — reported whenever a capacity is configured
                cap = int(self.config.get("osd_capacity_bytes", 0))
                used = self.store_used_bytes() if cap > 0 else 0
                # trace spans ride the stats report (ref: the daemon
                # perf/health reporting the mgr aggregates upstream)
                spans = self.tracer.drain_ship()
                # per-peer heartbeat RTTs (µs) piggyback too: the
                # mon's slow-score sweep needs a FRESH fleet view
                # every tick, so holding rtts forces the report.
                # Pending-ping inflation: a peer that has
                # stopped answering (SIGSTOP gray failure) would
                # otherwise keep its last — stale-low — EWMA; the
                # oldest unanswered ping's age is the honest floor.
                _hb_now = asyncio.get_event_loop().time()
                peer_lat = {}
                for o in set(self._peer_rtt) | \
                        set(self._hb_ping_pending):
                    r = self._peer_rtt.get(o, 0.0)
                    pend = self._hb_ping_pending.get(o)
                    if pend is not None:
                        r = max(r, _hb_now - pend)
                    peer_lat[str(o)] = int(r * 1e6)
                # device-runtime piggyback: the cumulative
                # kernel-path/compile/transfer view — reported while
                # it moves, so the mon's per-report deltas track
                # ACTIVE sweep traffic (an idle daemon's unchanged
                # cumulative is delta 0, which heals the warning)
                dh = self.devmon.health_report()
                # EC degrade evidence rides the same piggyback: ops
                # this OSD served from the reference encoder after
                # device retries exhausted
                agg = self.ec_agg.perf.dump()
                ragg = self.ec_read_agg.perf.dump()
                dh["ec_fallback_ops"] = int(
                    agg.get("fallback_ops", 0)) + int(
                    ragg.get("fallback_ops", 0))
                dh["ec_flush_failures"] = int(
                    agg.get("flush_failures", 0)) + int(
                    ragg.get("flush_failures", 0))
                # keep reporting until a zero count has been sent: a
                # daemon whose slow ops drained (or whose capacity
                # went back to unbounded) while it held no primary
                # PGs must still clear the mon's warning/utilization
                if not stats and not slow and not cap and not spans \
                        and not peer_lat \
                        and dh == self._device_reported \
                        and not self._slow_reported and \
                        not self._statfs_reported:
                    continue
                await self.monc.send_report(MPGStats(
                    osd=self.whoami, epoch=self.osdmap.epoch,
                    stats=stats, slow_ops=slow,
                    used_bytes=used, capacity_bytes=cap,
                    trace_spans=spans, peer_latency=peer_lat,
                    device_health=dh,
                    device_engine=_engine_name()))
                self._slow_reported = slow
                self._statfs_reported = cap
                self._device_reported = dh
                # merge readiness barrier: re-reported EVERY tick
                # while the decrease is pending, so a mon leader
                # change can't lose the barrier state
                from ceph_tpu_torch.mon.messages import MOSDPGReadyToMerge
                for pg in list(self.pgs.values()):
                    if pg.merge_ready():
                        await self.monc.send_report(
                            MOSDPGReadyToMerge(
                                pgid=pg.cid, epoch=self.osdmap.epoch,
                                from_osd=self.whoami,
                                pending=pg.pool.pg_num_pending))
        except asyncio.CancelledError:
            pass


class _HBDispatcher(Dispatcher):
    """Heartbeat messenger dispatcher (front/back network analog)."""

    def __init__(self, osd: OSD):
        self.osd = osd

    async def ms_dispatch(self, msg) -> bool:
        if isinstance(msg, MOSDPing):
            self.osd._hb_rx(msg)
            if msg.op == PING:
                try:
                    await msg.conn.send_message(MOSDPing(
                        op=PING_REPLY, from_osd=self.osd.whoami,
                        epoch=msg.epoch,
                        stamp=msg.stamp))
                except Exception:
                    pass
            return True
        return False
