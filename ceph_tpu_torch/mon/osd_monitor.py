"""OSDMonitor: the osdmap's PaxosService.

ref: src/mon/OSDMonitor.{h,cc} — owns the authoritative OSDMap, turns
boots/failure reports/admin commands into Incrementals, commits them
through paxos (inc + full map per epoch in the store, exactly the
reference's osdmap/osdmap_full keyspaces), auto-outs down OSDs after
``mon_osd_down_out_interval``, and aggregates MPGStats into the pgmap
summary (the reference moved pgmap into mgr; the mon keeps the
summary here since this framework's mgr consumes it via commands).

The port's copy of ``ceph_tpu/mon/osd_monitor.py``. Every map it decodes
or builds is on the mon's device (``Monitor(device=)``), and the
fullness sweep takes the map lock only when it has a change to make
(``_check_fullness``), so a burst of commands cannot hold back the
leases the leader's tick sends.
"""

from __future__ import annotations

import asyncio
import json

import numpy as np

from ceph_tpu_torch.crush import builder
from ceph_tpu_torch.crush.types import WEIGHT_ONE, CrushMap
from ceph_tpu_torch.encoding import (
    decode_crush_map, decode_osdmap, encode_crush_map, encode_incremental,
    encode_osdmap,
)
from ceph_tpu_torch.mon.messages import (
    MOSDAlive, MOSDBoot, MOSDFailure, MOSDMarkMeDown, MOSDPGReadyToMerge,
    MPGStats,
)
from ceph_tpu_torch.mon.service import PaxosService
from ceph_tpu_torch.osd.osdmap import (
    FLAG_FULL, FLAG_NAMES, FLAG_NODOWN, FLAG_NOIN, FLAG_NOOUT,
    FLAG_NOUP, STATE_EXISTS, STATE_FULL, STATE_NEARFULL, STATE_UP,
    Incremental, OSDMap, flag_names,
)
from ceph_tpu_torch.osd.types import (
    FLAG_POOL_FULL_QUOTA, POOL_TYPE_ERASURE, POOL_TYPE_REPLICATED,
    PGPool,
)
from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("mon")

PFX = "osdmap"


def _quarantine_phase(state) -> str | None:
    """Collapse a device_health piggyback dict into the quarantine
    dimension the KERNEL_PATH_DEGRADED check reports: the kernel path
    is either permanently retired, actively re-probing, parked in
    quarantine awaiting its next probe, or (None) healthy."""
    if state.get("quarantine_permanent", 0):
        return "permanent"
    if state.get("reprobing", 0):
        return "reprobing"
    if state.get("quarantined", 0):
        return "quarantined"
    return None


class OSDMonitor(PaxosService):
    prefix = PFX

    def __init__(self, mon) -> None:
        super().__init__(mon)
        self.osdmap: OSDMap | None = None
        # failure accounting (leader-side, ref: OSDMonitor failure_info):
        # target -> {reporter: report wall time}. Stamped so stale
        # accusations EXPIRE (mon_osd_reporter_lifetime) instead of
        # accumulating until two unrelated reports minutes apart
        # wrongly cross min_down_reporters; a still-alive cancel
        # (MOSDFailure alive=1) removes its reporter outright.
        self.failure_reporters: dict[int, dict[str, float]] = {}
        self.down_at: dict[int, float] = {}
        self.min_down_reporters = mon.config.get(
            "mon_osd_min_down_reporters", 2)
        self.down_out_interval = mon.config.get(
            "mon_osd_down_out_interval", 600.0)
        self.reporter_lifetime = mon.config.get(
            "mon_osd_reporter_lifetime", 600.0)
        # pg stats: "pool.seed" -> dict (latest primary report)
        self.pg_stats: dict[str, dict] = {}
        # osd -> in-flight ops past the complaint threshold (from the
        # MPGStats piggyback; feeds the SLOW_OPS health warning)
        self.osd_slow_ops: dict[int, int] = {}
        # osd -> (used_bytes, capacity_bytes) from the MPGStats statfs
        # piggyback; the fullness tick derives NEARFULL/FULL from it
        self.osd_utilization: dict[int, tuple[int, int]] = {}
        # True while the FULL flag was set by the fullness tick (auto);
        # only an auto-set flag is auto-cleared — an operator's
        # `osd set full` stays until `osd unset full`
        self._full_auto = False
        # gray-failure detection (round 11; ref: the osd_perf ping
        # times `dump_osd_network` aggregates upstream): reporter ->
        # {target: heartbeat-RTT EWMA µs} from the MPGStats piggyback.
        # The tick's slow-score sweep compares each target's median
        # reported latency against the fleet median — a slow-but-alive
        # OSD scores high long before heartbeats ever time out.
        self.peer_latency: dict[int, dict[int, int]] = {}
        # target -> consecutive sweeps above/below threshold (entry/
        # exit debounce — both directions, or a boundary-hovering OSD
        # flaps the health check and, with dampening on, churns map
        # epochs)
        self._slow_suspect: dict[int, int] = {}
        self._slow_clear: dict[int, int] = {}
        # confirmed slow OSDs: target -> {score, latency_ms, since...}
        self.slow_osds: dict[int, dict] = {}
        # OSDs the dampening sweep is currently deferring to a tuner
        # affinity lease (round 17) — tracked so the WRN clog fires
        # once per deferral episode, not every sweep
        self._damp_deferred: set[int] = set()
        # device-runtime observability (round 14): per-OSD cumulative
        # device_health snapshots from the MPGStats piggyback (the
        # `ceph device-runtime status` table), the last cumulative
        # (checks, mismatches) pair per OSD for delta rates, and the
        # KERNEL_PATH_DEGRADED debounce — REPORT-driven (one step per
        # device_health delta with fresh sweeps in it), so the confirm
        # count is "N consecutive degraded sweeps reported", the
        # OSD_SLOW entry/exit discipline paced by real sweep traffic
        self.osd_device_state: dict[int, dict] = {}
        self._kp_last: dict[int, tuple[int, int]] = {}
        self._kp_suspect: dict[int, int] = {}
        self._kp_clear: dict[int, int] = {}
        # confirmed degraded kernel paths: osd -> {ratio, since, ...}
        self.degraded_kernel_paths: dict[int, dict] = {}
        # merge readiness barrier (ref: OSDMonitor ready_to_merge_pgs
        # driven by MOSDPGReadyToMerge): (pool, pg_num_pending) ->
        # {source seed: last-report loop time}. Leader memory, not
        # paxos — primaries re-report every stats tick while READY,
        # so a leader change just re-accumulates, and a source that
        # STOPPED being ready (degraded mid-barrier, or a stale
        # report from an earlier merge cycle) ages out of the window
        # instead of holding a sticky ready bit.
        self._merge_ready: dict[tuple[int, int],
                                dict[int, float]] = {}
        self.merge_ready_window = mon.config.get(
            "mon_merge_ready_window", 2.0)
        # serializes map mutations: concurrent handlers must not build
        # incrementals against the same base epoch
        self._inc_lock = asyncio.Lock()
        self.refresh()

    # -- state -------------------------------------------------------------
    def last_epoch(self) -> int:
        return self.store.get_u64(PFX, "last_epoch")

    def refresh(self) -> None:
        last = self.last_epoch()
        if last and (self.osdmap is None or self.osdmap.epoch < last):
            blob = self.store.get(PFX, f"full_{last:08x}")
            if blob is not None:
                # NO eager OSDMapMapping here: the mon's only placement
                # reads are scalar (`osd map`, pg repair) — the
                # epoch-keyed memo covers them, and a per-commit table
                # update (fresh decode -> crush digest + delta scan
                # every epoch) measurably slowed every cluster test
                # for a table nothing bulk-reads
                self.osdmap = decode_osdmap(blob, device=self.mon.device)

    def encode_full(self) -> bytes:
        return encode_osdmap(self.osdmap)

    def get_inc(self, epoch: int) -> bytes | None:
        return self.store.get(PFX, f"inc_{epoch:08x}")

    async def on_active(self) -> None:
        if self.last_epoch() == 0:
            await self.create_initial()

    async def create_initial(self) -> None:
        """Epoch-1 map: empty root + default replicated rule
        (ref: OSDMonitor::create_initial)."""
        crush = CrushMap(type_names=dict(builder.DEFAULT_TYPE_NAMES))
        root = builder.make_bucket(crush, builder.TYPE_ROOT, [],
                                   name="default")
        builder.add_simple_rule(crush, root, builder.TYPE_HOST,
                                name="replicated_rule")
        m = OSDMap(crush, max_osd=0, device=self.mon.device)
        t = self.store.transaction()
        t.set(PFX, f"full_{1:08x}", encode_osdmap(m))
        self.store.put_u64(t, PFX, "last_epoch", 1)
        await self.mon.propose_txn(t)

    async def _propose_change(self, build) -> tuple[bool, object]:
        """Commit one map change (ref: OSDMonitor::encode_pending).

        ``build(cur_map) -> (Incremental, result) | None`` runs UNDER
        the serialization lock, so everything the inc derives from the
        current map (next osd id, crush clone, pool ids) is consistent
        with the epoch it targets — concurrent handlers can neither
        allocate the same id nor clobber each other's crush edits."""
        async with self._inc_lock:
            cur = self.osdmap
            out = build(cur)
            if out is None:
                return False, None
            inc, result = out
            inc.epoch = cur.epoch + 1
            shadow = decode_osdmap(encode_osdmap(cur),
                                   device=self.mon.device)
            shadow.apply_incremental(inc)
            t = self.store.transaction()
            t.set(PFX, f"inc_{inc.epoch:08x}", encode_incremental(inc))
            t.set(PFX, f"full_{inc.epoch:08x}", encode_osdmap(shadow))
            self.store.put_u64(t, PFX, "last_epoch", inc.epoch)
            ok = await self.mon.propose_txn(t)
            return ok, result

    async def _propose_inc(self, inc: Incremental) -> bool:
        """State-independent incs (down/out/weights/boot)."""
        ok, _ = await self._propose_change(lambda om: (inc, None))
        return ok

    # -- osd reports -------------------------------------------------------
    async def handle(self, msg) -> None:
        if isinstance(msg, MOSDBoot):
            await self._handle_boot(msg)
        elif isinstance(msg, MOSDFailure):
            await self._handle_failure(msg)
        elif isinstance(msg, MOSDAlive):
            await self._handle_alive(msg)
        elif isinstance(msg, MOSDMarkMeDown):
            await self._handle_mark_me_down(msg)
        elif isinstance(msg, MPGStats):
            self._handle_pg_stats(msg)
        elif isinstance(msg, MOSDPGReadyToMerge):
            await self._handle_ready_to_merge(msg)

    async def _handle_alive(self, m: MOSDAlive) -> None:
        """up_thru grant (ref: OSDMonitor::prepare_alive): a primary
        asks to be recorded 'up through' its interval-start epoch
        before activating; peering later uses the grant to decide
        whether a past interval MAY have gone active (no grant = the
        interval's primary never activated = no acked writes to lose)."""
        om = self.osdmap
        if om is None or m.osd < 0 or m.osd >= om.max_osd or \
                not bool(om.is_up(np.asarray(m.osd))):
            return

        def build(cur):
            # the duplicate-grant test runs UNDER the proposal lock:
            # primaries re-send MOSDAlive every 0.3s until the granted
            # map reaches them, and a pre-lock check would commit one
            # redundant paxos round + map publish per retry
            if cur.up_thru.get(m.osd, 0) >= m.epoch:
                return None
            inc = Incremental()
            inc.new_up_thru[m.osd] = m.epoch
            return inc, None
        await self._propose_change(build)
        log.dout(10, f"osd.{m.osd} up_thru -> {m.epoch}")

    async def _handle_boot(self, m: MOSDBoot) -> None:
        """ref: OSDMonitor::prepare_boot — mark up, publish addrs,
        auto-in on first boot. ``noup`` suppresses the up transition
        (the OSD keeps re-announcing until the flag clears); ``noin``
        suppresses the auto-in."""
        if self.osdmap is None or m.osd >= self.osdmap.max_osd:
            return
        if self.osdmap.test_flag(FLAG_NOUP):
            log.dout(1, f"osd.{m.osd} boot ignored (noup set)")
            return
        inc = Incremental()
        inc.new_up = [m.osd]
        inc.new_addrs[m.osd] = (m.addr_host, m.addr_port, m.hb_port)
        if self.osdmap.osd_weight[m.osd] == 0 and \
                not self.osdmap.test_flag(FLAG_NOIN):
            inc.new_weight[m.osd] = WEIGHT_ONE      # auto-in on boot
        self.failure_reporters.pop(m.osd, None)
        self.down_at.pop(m.osd, None)
        self.osd_slow_ops.pop(m.osd, None)   # fresh incarnation
        self.osd_utilization.pop(m.osd, None)
        self._forget_osd_latency(m.osd)
        self._forget_osd_device(m.osd)
        await self._propose_inc(inc)
        log.dout(1, f"osd.{m.osd} boot -> up (epoch "
                    f"{self.osdmap.epoch})")

    async def _handle_failure(self, m: MOSDFailure) -> None:
        """ref: OSDMonitor::prepare_failure — mark down once enough
        distinct LIVE reporters accuse the target. alive=1 is the
        cancellation (ref: send_still_alive): the reporter heard the
        target again, its accusation is withdrawn. ``nodown``
        suppresses the markdown (reports still accumulate, so
        unsetting the flag acts on fresh evidence immediately)."""
        om = self.osdmap
        if om is None or m.target >= om.max_osd or \
                not bool(om.is_up(np.asarray(m.target))):
            return
        who = m.reporter or m.src or "?"
        if getattr(m, "alive", 0):
            reps = self.failure_reporters.get(m.target)
            if reps is not None and reps.pop(who, None) is not None:
                log.dout(5, f"osd.{m.target}: reporter {who} "
                            f"cancelled (still alive)")
                if not reps:
                    self.failure_reporters.pop(m.target, None)
            return
        import time
        reporters = self.failure_reporters.setdefault(m.target, {})
        reporters[who] = time.time()
        if len(reporters) < self.min_down_reporters:
            return
        if om.test_flag(FLAG_NODOWN):
            log.dout(1, f"osd.{m.target} would be marked down but "
                        f"nodown is set")
            return
        inc = Incremental()
        inc.new_down = [m.target]
        self._mark_down_bookkeeping(m.target)
        await self._propose_inc(inc)
        log.dout(1, f"osd.{m.target} marked down "
                    f"({len(reporters)} reporters)")

    def _mark_down_bookkeeping(self, osd: int) -> None:
        """The state transition every mark-down path shares (failure
        reports, mark-me-down, the `osd down` command): a dead daemon
        can't send the clearing report, so its slow-op count, stale
        statfs and latency evidence must drop with it — or the
        SLOW_OPS / FULL / OSD_SLOW evidence outlives it — and the
        auto-out tick's down_at clock starts (setdefault: an
        already-aging down OSD keeps its original stamp)."""
        self.failure_reporters.pop(osd, None)
        self.osd_slow_ops.pop(osd, None)
        self.osd_utilization.pop(osd, None)
        self._forget_osd_latency(osd)
        self._forget_osd_device(osd)
        self.down_at.setdefault(osd, asyncio.get_event_loop().time())

    async def _handle_mark_me_down(self, m: MOSDMarkMeDown) -> None:
        """ref: OSDMonitor::prepare_mark_me_down — a gracefully
        stopping OSD asks for its down commit up front instead of
        burning a heartbeat-grace period of client timeouts. Explicit
        request: honored even under nodown."""
        om = self.osdmap
        if om is None or m.osd < 0 or m.osd >= om.max_osd or \
                not bool(om.is_up(np.asarray(m.osd))):
            return
        inc = Incremental()
        inc.new_down = [m.osd]
        self._mark_down_bookkeeping(m.osd)
        await self._propose_inc(inc)
        log.dout(1, f"osd.{m.osd} marked down (mark-me-down)")

    def _handle_pg_stats(self, m: MPGStats) -> None:
        om = self.osdmap
        for pgid, blob in m.stats.items():
            # drop rows for PGs the map no longer has (a source
            # primary's in-flight report racing its own merge commit
            # would otherwise resurrect a folded seed as a ghost row)
            if om is not None:
                try:
                    from ceph_tpu_torch.osd.types import pg_t as _pg_t
                    pg = _pg_t.parse(pgid)
                    pool = om.pools.get(pg.pool)
                    if pool is None or pg.seed >= pool.pg_num:
                        self.pg_stats.pop(pgid, None)
                        continue
                except ValueError:
                    pass
            try:
                self.pg_stats[pgid] = json.loads(blob)
            except json.JSONDecodeError:
                pass
        slow = getattr(m, "slow_ops", 0)
        if slow:
            self.osd_slow_ops[m.osd] = slow
        else:
            self.osd_slow_ops.pop(m.osd, None)
        cap = getattr(m, "capacity_bytes", 0)
        if cap:
            self.osd_utilization[m.osd] = \
                (getattr(m, "used_bytes", 0), cap)
        else:
            self.osd_utilization.pop(m.osd, None)
        peer_lat = getattr(m, "peer_latency", None)
        if peer_lat:
            table = {}
            for k, us in peer_lat.items():
                try:
                    table[int(k)] = int(us)
                except (TypeError, ValueError):
                    continue
            self.peer_latency[m.osd] = table
        else:
            self.peer_latency.pop(m.osd, None)
        self._ingest_device_health(m)

    def _ingest_device_health(self, m: MPGStats) -> None:
        """Round 14: pool the daemon's cumulative device-runtime view
        and run one KERNEL_PATH_DEGRADED debounce step off the
        per-report (checks, mismatches) DELTA. A report without fresh
        sweeps (delta 0) is evidence of nothing and moves no counter;
        a restart's counter reset (negative delta) re-baselines."""
        dh = getattr(m, "device_health", None)
        if not isinstance(dh, dict) or not dh:
            return
        try:
            checks = int(dh.get("checks", 0))
            mism = int(dh.get("mismatches", 0))
        except (TypeError, ValueError):
            return
        state = {k: int(v) for k, v in dh.items()
                 if isinstance(v, (int, float))}
        state["engine"] = str(getattr(m, "device_engine", "") or "?")
        state["mismatch_ratio"] = round(mism / checks, 4) if checks \
            else 0.0
        self.osd_device_state[m.osd] = state
        last = self._kp_last.get(m.osd)
        self._kp_last[m.osd] = (checks, mism)
        if last is None or checks < last[0] or mism < last[1]:
            return                        # first report / re-baseline
        dc, dm_ = checks - last[0], mism - last[1]
        if dc <= 0:
            return                        # no new sweeps this period
        cfg = getattr(self.mon, "config", {})
        ratio_k = float(cfg.get("mon_kernel_path_degraded_ratio", 0.1))
        confirm = int(cfg.get("mon_kernel_path_confirm", 2))
        ratio = dm_ / dc
        if ratio >= ratio_k:
            self._kp_clear.pop(m.osd, None)
            if m.osd in self.degraded_kernel_paths:
                self.degraded_kernel_paths[m.osd].update(
                    ratio=round(ratio, 4), engine=state["engine"],
                    phase=_quarantine_phase(state))
                return
            n = self._kp_suspect.get(m.osd, 0) + 1
            self._kp_suspect[m.osd] = n
            if n >= confirm:
                import time as _time
                self._kp_suspect.pop(m.osd, None)
                self.degraded_kernel_paths[m.osd] = {
                    "ratio": round(ratio, 4),
                    "engine": state["engine"],
                    "phase": _quarantine_phase(state),
                    "since": _time.time()}
                self.mon.clog(
                    "WRN", f"osd.{m.osd} kernel path degraded "
                           f"(mismatch ratio {ratio:.2f}, engine "
                           f"{state['engine']})")
                log.dout(1, f"osd.{m.osd} KERNEL_PATH_DEGRADED "
                            f"(ratio {ratio:.2f})")
        else:
            self._kp_suspect.pop(m.osd, None)
            if m.osd not in self.degraded_kernel_paths:
                return
            n = self._kp_clear.get(m.osd, 0) + 1
            self._kp_clear[m.osd] = n
            if n >= confirm:               # symmetric exit debounce
                self._kp_clear.pop(m.osd, None)
                self.degraded_kernel_paths.pop(m.osd, None)
                self.mon.clog(
                    "INF", f"osd.{m.osd} kernel path healed")
                log.dout(1, f"osd.{m.osd} kernel path healed")

    def _forget_osd_device(self, osd: int) -> None:
        """Drop one OSD's device-runtime evidence (down/removed/fresh
        incarnation): a dead daemon can't send the clearing report,
        and a revived one re-baselines from its first report."""
        self.osd_device_state.pop(osd, None)
        self._kp_last.pop(osd, None)
        self._kp_suspect.pop(osd, None)
        self._kp_clear.pop(osd, None)
        self.degraded_kernel_paths.pop(osd, None)

    def device_runtime_status(self) -> dict:
        """The `ceph device-runtime status` payload: per-daemon
        engine, kernel-path launch/mismatch counters, compile
        count/time and transfer GiB from the reported cumulative
        state, plus the degraded table behind KERNEL_PATH_DEGRADED."""
        daemons = {}
        for osd, st in sorted(self.osd_device_state.items()):
            daemons[f"osd.{osd}"] = {
                "engine": st.get("engine", "?"),
                "checks": st.get("checks", 0),
                "mismatches": st.get("mismatches", 0),
                "mismatch_ratio": st.get("mismatch_ratio", 0.0),
                "launches": {
                    p: st.get(f"launches_{p}", 0)
                    for p in ("pallas", "xla", "scalar", "sharded")},
                "compiles": st.get("compiles", 0),
                "compile_s": round(st.get("compile_ms", 0) / 1e3, 3),
                "h2d_GiB": round(
                    st.get("h2d_bytes", 0) / (1 << 30), 6),
                "d2h_GiB": round(
                    st.get("d2h_bytes", 0) / (1 << 30), 6),
                # quarantine state machine + EC degrade evidence
                # (round 16; rides the same piggyback)
                "quarantine": {
                    "phase": _quarantine_phase(st),
                    "quarantined": st.get("quarantined", 0),
                    "reprobing": st.get("reprobing", 0),
                    "permanent": st.get("quarantine_permanent", 0),
                    "entries": st.get("quarantine_entries", 0),
                    "exits": st.get("quarantine_exits", 0)},
                "ec_fallback_ops": st.get("ec_fallback_ops", 0),
            }
        return {"daemons": daemons,
                "degraded": {str(o): dict(v) for o, v in sorted(
                    self.degraded_kernel_paths.items())}}

    # -- pg merge (ref: OSDMonitor's pg_num_pending machinery) -------------
    def pending_merges(self) -> dict:
        """pool name -> {from, to, ready, sources} for every pool with
        a pg_num decrease in flight (status/asok/health surface)."""
        om = self.osdmap
        if om is None:
            return {}
        out = {}
        for pool in om.pools.values():
            if not pool.pg_num_pending:
                continue
            ready = self._merge_ready.get(
                (pool.id, pool.pg_num_pending), set())
            out[pool.name] = {
                "from": pool.pg_num, "to": pool.pg_num_pending,
                "sources": pool.pg_num - pool.pg_num_pending,
                "ready": len(ready)}
        return out

    async def _handle_ready_to_merge(self, m: MOSDPGReadyToMerge) -> None:
        """One source PG reports clean+quiesced at the pending fold
        (ref: OSDMonitor::handle_pg_ready_to_merge). The commit itself
        happens on tick once EVERY source of the pool has reported —
        the readiness barrier."""
        from ceph_tpu_torch.osd.types import pg_t as _pg_t
        om = self.osdmap
        if om is None:
            return
        try:
            pg = _pg_t.parse(m.pgid)
        except ValueError:
            return
        pool = om.pools.get(pg.pool)
        if pool is None or not pool.pg_num_pending or \
                m.pending != pool.pg_num_pending or \
                not pool.is_merge_source(pg.seed):
            return
        self._merge_ready.setdefault(
            (pool.id, pool.pg_num_pending), {})[pg.seed] = \
            asyncio.get_event_loop().time()

    async def _check_merge_commit(self) -> None:
        """Commit pg_num decreases whose every source reported ready
        WITHIN the freshness window — sources re-report every stats
        tick only while still clean+quiesced, so a source that
        degraded mid-barrier (or a delayed report from an earlier
        merge cycle) ages out instead of satisfying the barrier. The
        commit folds pg_num down and clears pg_num_pending in ONE
        incremental, so OSDs observe a single merge transition and
        run the deterministic local fold (PG.merge_from)."""
        om = self.osdmap
        if om is None:
            return
        # hygiene: ready-sets whose pool vanished or whose pending no
        # longer matches must not outlive their merge
        live = {(p.id, p.pg_num_pending) for p in om.pools.values()
                if p.pg_num_pending}
        for key in [k for k in self._merge_ready if k not in live]:
            self._merge_ready.pop(key, None)
        now = asyncio.get_event_loop().time()
        for pool in list(om.pools.values()):
            pending = pool.pg_num_pending
            if not pending:
                continue
            stamps = self._merge_ready.get((pool.id, pending), {})
            ready = {s for s, at in stamps.items()
                     if now - at <= self.merge_ready_window}
            sources = set(range(pending, pool.pg_num))
            if not sources <= ready:
                continue

            def build(cur, pid=pool.id, pending=pending):
                p = cur.pools.get(pid)
                if p is None or p.pg_num_pending != pending:
                    return None
                import copy
                newpool = copy.deepcopy(p)
                newpool.pg_num = pending
                newpool.pg_num_pending = 0
                inc = Incremental()
                inc.new_pools[pid] = newpool
                return inc, None
            ok, _ = await self._propose_change(build)
            if ok:
                self._merge_ready.pop((pool.id, pending), None)
                # the folded seeds' stats rows are gone with the PGs
                for seed in sources:
                    self.pg_stats.pop(f"{pool.id}.{seed:x}", None)
                self.mon.clog(
                    "INF", f"pool '{pool.name}' pg_num merged down "
                           f"to {pending}")
                log.dout(1, f"pool {pool.name}: merge committed, "
                            f"pg_num -> {pending}")

    async def tick(self) -> None:
        """Auto-out: down past the interval -> weight 0
        (ref: OSDMonitor::tick mon_osd_down_out_interval); plus
        expired-blocklist trimming (ref: OSDMonitor::tick ->
        prepare_pending's blocklist expiry sweep): entries whose
        expiry passed are folded into an incremental so the map stops
        growing without bound."""
        om = self.osdmap
        if om is None:
            return
        import time
        wall = time.time()
        expired = [name for name, exp in om.blocklist.items()
                   if exp <= wall]
        if expired:
            def build(cur):
                inc = Incremental()
                inc.old_blocklist = [
                    n for n, exp in cur.blocklist.items()
                    if exp <= wall]
                return (inc, None) if inc.old_blocklist else None
            ok, _ = await self._propose_change(build)
            if ok:
                log.dout(1, f"trimmed expired blocklist: {expired}")
        # failure-report hygiene: a reporter's accusation expires after
        # mon_osd_reporter_lifetime — two stale reports minutes apart
        # must not sum to a markdown (ref: the failure_info pruning the
        # reference does in check_failure)
        for target, reps in list(self.failure_reporters.items()):
            for who, at in list(reps.items()):
                if wall - at > self.reporter_lifetime:
                    del reps[who]
            if not reps:
                self.failure_reporters.pop(target, None)
        await self._check_fullness()
        await self._check_merge_commit()
        await self._check_slow_osds()
        if not self.down_at:
            return
        if om.test_flag(FLAG_NOOUT):
            # down_at stamps survive: unsetting noout resumes the
            # down-out tick with the original down times
            return
        now = asyncio.get_event_loop().time()
        inc = Incremental()
        for osd, t0 in list(self.down_at.items()):
            if now - t0 >= self.down_out_interval and \
                    om.osd_weight[osd] != 0:
                inc.new_weight[osd] = 0
        if inc.new_weight:
            if await self._propose_inc(inc):
                for osd in inc.new_weight:
                    self.down_at.pop(osd, None)
                log.dout(1, f"auto-out: {list(inc.new_weight)}")

    # -- gray-failure (slow-OSD) sweep (round 11) --------------------------
    def _forget_osd_latency(self, osd: int) -> None:
        """Drop every latency trace of a dead/rebooted OSD: its own
        reports, its entry in every peer's report, and any slow
        verdict — a DOWN osd is OSD_DOWN's problem, not OSD_SLOW's."""
        self.peer_latency.pop(osd, None)
        for table in self.peer_latency.values():
            table.pop(osd, None)
        self._slow_suspect.pop(osd, None)
        self._slow_clear.pop(osd, None)
        self.slow_osds.pop(osd, None)
        # a dampened-then-died OSD keeps its lowered affinity in the
        # MAP; the sweep's to_heal (up + healthy + non-default
        # affinity) restores it after it boots and scores clean

    def slow_scores(self) -> dict[int, dict]:
        """Per-OSD relative latency scores from the freshest fleet
        reports: each target's BEST (minimum) reported heartbeat RTT
        over the fleet median of those minimums. The min is the
        framing-proof statistic: a slow/hostile REPORTER inflates only
        its own view, which the min discards (with a median, a gray
        reporter in a small cluster drags every healthy target's
        statistic — and the fleet baseline — up with it, capping its
        own relative score below the trip ratio); a genuinely slow
        TARGET is slow in EVERY reporter's view, so its min stays
        high. ~1.0 = normal; >> 1 = slow for everyone."""
        import statistics
        per_target: dict[int, list[int]] = {}
        for _reporter, targets in self.peer_latency.items():
            for t, us in targets.items():
                per_target.setdefault(t, []).append(us)
        if not per_target:
            return {}
        best = {t: min(v) for t, v in per_target.items()}
        fleet = max(statistics.median(best.values()), 1.0)
        return {t: {"latency_ms": round(m / 1000.0, 3),
                    "score": round(m / fleet, 2),
                    "reporters": len(per_target[t])}
                for t, m in best.items()}

    async def _check_slow_osds(self) -> None:
        """The OSD_SLOW sweep: an OSD whose relative score stays past
        ``mon_osd_slow_ratio`` (with an absolute ``mon_osd_slow_min_ms``
        floor so a fast idle cluster's jitter can never trip it) for
        ``mon_osd_slow_confirm`` consecutive sweeps is marked slow —
        health warning + `ceph osd slow ls` + prometheus score — and
        cleared the moment its score recovers. With
        ``mon_osd_slow_primary_dampening`` (off by default) the sweep
        also commits a primary-affinity dampening for slow OSDs (the
        optional primary-avoidance hint: reads stop routing to the
        slow disk's primaries) and restores the previous affinity on
        heal."""
        cfg = self.mon.config
        ratio = float(cfg.get("mon_osd_slow_ratio", 3.0))
        min_ms = float(cfg.get("mon_osd_slow_min_ms", 50.0))
        confirm = int(cfg.get("mon_osd_slow_confirm", 2))
        scores = self.slow_scores()
        tripped = {t for t, s in scores.items()
                   if s["score"] >= ratio and s["latency_ms"] >= min_ms}
        for t in [t for t in self._slow_suspect if t not in tripped]:
            self._slow_suspect.pop(t, None)
        newly: list[int] = []
        for t in tripped:
            self._slow_clear.pop(t, None)
            n = self._slow_suspect.get(t, 0) + 1
            self._slow_suspect[t] = n
            if n >= confirm and t not in self.slow_osds:
                newly.append(t)
        # exit hysteresis: clear only after `confirm` consecutive
        # clean sweeps, mirroring entry — a score hovering at the
        # ratio boundary must not flap the verdict every tick
        healed: list[int] = []
        for t in [t for t in self.slow_osds if t not in tripped]:
            n = self._slow_clear.get(t, 0) + 1
            self._slow_clear[t] = n
            if n >= confirm:
                self._slow_clear.pop(t, None)
                healed.append(t)
        import time as _time
        for t in newly:
            self.slow_osds[t] = {"since": _time.time(), **scores[t]}
            self.mon.clog(
                "WRN", f"osd.{t} is slow (score {scores[t]['score']}, "
                       f"median hb rtt {scores[t]['latency_ms']} ms)")
            log.dout(1, f"osd.{t} marked SLOW {scores[t]}")
        for t in self.slow_osds:
            if t in scores:
                self.slow_osds[t].update(scores[t])
        for t in healed:
            self.slow_osds.pop(t, None)
            self.mon.clog("INF", f"osd.{t} slow condition cleared")
            log.dout(1, f"osd.{t} slow condition cleared")
        await self._apply_primary_dampening()

    def dampened_osds(self) -> list[int]:
        """OSDs currently primary-dampened. Derived from the MAP (any
        non-default affinity), so it survives mon leader changes: a
        fresh leader can heal what the old one dampened without any
        in-memory handoff. Since round 17 there ARE other affinity
        writers (`osd primary-affinity` — operators and the mgr
        tuner): the sweep tells them apart through the mon's tuner
        affinity leases (``mon.tune``) and defers to active ones in
        :meth:`_apply_primary_dampening`; an operator write releases
        any lease, so a leased entry is always the tuner's."""
        from ceph_tpu_torch.osd.osdmap import DEFAULT_PRIMARY_AFFINITY
        om = self.osdmap
        if om is None:
            return []
        return [t for t in range(om.max_osd)
                if int(om.osd_primary_affinity[t]) !=
                DEFAULT_PRIMARY_AFFINITY]

    async def _apply_primary_dampening(self) -> None:
        """The optional primary-avoidance hint. HEALING always runs —
        even with the knob off, a previously-dampened OSD that is
        healthy again (or a stale dampening left by an old leader)
        must get its affinity back; only NEW dampening is gated on
        ``mon_osd_slow_primary_dampening``. Restores to the DEFAULT
        affinity (not a remembered value): the saved-original design
        lived in leader RAM and a leader change stranded it."""
        from ceph_tpu_torch.osd.osdmap import DEFAULT_PRIMARY_AFFINITY
        cfg = self.mon.config
        om = self.osdmap
        dampen_on = bool(cfg.get("mon_osd_slow_primary_dampening",
                                 False))
        damp = int(float(cfg.get("mon_osd_slow_primary_affinity",
                                 0.0)) * DEFAULT_PRIMARY_AFFINITY)
        dampened = set(self.dampened_osds())
        to_damp = [t for t in self.slow_osds
                   if t not in dampened and t < om.max_osd] \
            if dampen_on else []
        # restore only UP osds: a dampened OSD that died gets its
        # affinity back after it boots and scores clean (a down OSD
        # is never primary anyway, and racing the down commit with an
        # affinity epoch buys nothing)
        to_heal = [t for t in dampened
                   if t not in self.slow_osds and t < om.max_osd
                   and bool(om.is_up(np.asarray(t)))]
        # single-writer guard (round 17): an OSD whose affinity the
        # mgr tuner committed within its lease is the TUNER's to
        # dampen and heal — the sweep auto-defers (WRN once per
        # deferral episode) instead of fighting the gray-OSD
        # responder tick for tick
        from ceph_tpu_torch.mon.tune import tuner_lease_filter
        import time as _t
        tune = getattr(self.mon, "tune", None)
        if tune is not None and (to_damp or to_heal):
            to_damp, to_heal, deferred = tuner_lease_filter(
                to_damp, to_heal, tune.owned, _t.time(),
                float(cfg.get("mon_tune_affinity_lease_s", 600.0)))
            newly_deferred = [t for t in deferred
                              if t not in self._damp_deferred]
            self._damp_deferred = set(deferred)
            if newly_deferred:
                self.mon.clog(
                    "WRN", f"slow-osd dampening deferred for osd(s) "
                           f"{newly_deferred}: a tuner holds their "
                           f"primary-affinity lease")
        elif tune is not None:
            self._damp_deferred = set()
        if not to_damp and not to_heal:
            return

        def build(cur):
            inc = Incremental()
            for t in to_damp:
                inc.new_primary_affinity[t] = damp
            for t in to_heal:
                inc.new_primary_affinity[t] = DEFAULT_PRIMARY_AFFINITY
            return (inc, None) if inc.new_primary_affinity else None
        ok, _ = await self._propose_change(build)
        if ok:
            log.dout(1, f"slow-osd primary dampening: damped "
                        f"{to_damp}, restored {to_heal}")

    async def _cmd_primary_affinity(self, cmd, inbl):
        """`ceph osd primary-affinity <id> <weight>` (ref:
        OSDMonitor prepare_command "osd primary-affinity"): the
        operator/tuner primary-affinity write path (round 17). The
        mgr TunerModule's gray-OSD responder and kernel-path watchdog
        commit through HERE with a ``provenance`` dict — the monitor
        records the resulting affinity lease, and the mon-side
        dampening sweep defers to it (single-writer guard)."""
        from ceph_tpu_torch.osd.osdmap import DEFAULT_PRIMARY_AFFINITY
        try:
            osd = int(cmd["id"])
            weight = float(cmd["weight"])
        except (KeyError, TypeError, ValueError):
            return -22, "usage: osd primary-affinity <id> " \
                        "<weight 0.0..1.0>", b""
        if not 0.0 <= weight <= 1.0:
            return -22, "weight must be in [0.0, 1.0]", b""
        om = self.osdmap
        if om is None or not (0 <= osd < om.max_osd) or \
                not om.osd_state[osd] & STATE_EXISTS:
            return -2, f"osd.{osd} does not exist", b""
        raw = int(round(weight * DEFAULT_PRIMARY_AFFINITY))

        def build(cur):
            if int(cur.osd_primary_affinity[osd]) == raw:
                return None               # already there: idempotent
            inc = Incremental()
            inc.new_primary_affinity[osd] = raw
            return inc, None
        ok, _ = await self._propose_change(build)
        if ok or int(om.osd_primary_affinity[osd]) == raw:
            return 0, f"set osd.{osd} primary-affinity to " \
                      f"{weight:.4g}", b""
        return -11, "proposal failed", b""

    async def _cmd_slow_ls(self, cmd, inbl):
        """`ceph osd slow ls` — confirmed slow OSDs plus the full
        score table (the drill-down behind OSD_SLOW)."""
        return 0, "", json.dumps({
            "slow_osds": {str(t): v for t, v in
                          sorted(self.slow_osds.items())},
            "scores": {str(t): v for t, v in
                       sorted(self.slow_scores().items())},
            "dampened": self.dampened_osds()}).encode()

    async def _check_fullness(self) -> None:
        """The fullness sweep (ref: OSDMonitor::tick ->
        update_osd_stat + the pre-luminous full/nearfull flag logic +
        the pool quota sweep in OSDMonitor::tick):

        - per-OSD statfs vs mon_osd_nearfull_ratio (0.85) /
          mon_osd_full_ratio (0.95) -> NEARFULL/FULL osd_state bits;
        - any FULL osd -> the cluster FULL flag (auto-set, auto-
          cleared once no OSD is full; a manually-set flag sticks);
        - per-pool aggregate pg stats vs quota_bytes/quota_objects ->
          FLAG_POOL_FULL_QUOTA toggled in the pool struct.

        All changes ride ONE incremental so clients observe a
        consistent fullness transition."""
        nearfull_r = self.mon.config.get("mon_osd_nearfull_ratio", 0.85)
        full_r = self.mon.config.get("mon_osd_full_ratio", 0.95)
        util = dict(self.osd_utilization)
        # pool aggregates from the freshest primary reports
        pool_bytes: dict[int, int] = {}
        pool_objs: dict[int, int] = {}
        for pgid, st in self.pg_stats.items():
            try:
                pid = int(pgid.split(".")[0])
            except ValueError:
                continue
            pool_bytes[pid] = pool_bytes.get(pid, 0) + \
                st.get("num_bytes", 0)
            pool_objs[pid] = pool_objs.get(pid, 0) + \
                st.get("num_objects", 0)

        changed_auto: dict = {}

        def build(cur):
            inc = Incremental()
            any_full = False
            for osd in range(cur.max_osd):
                st = int(cur.osd_state[osd])
                if not st & STATE_EXISTS:
                    continue
                want = st & ~(STATE_NEARFULL | STATE_FULL)
                # a DOWN osd's last statfs is stale evidence: its
                # fullness bits clear and it cannot hold the cluster
                # FULL flag hostage (a dead full OSD would otherwise
                # park every write forever — boot re-reports anyway)
                if st & STATE_UP:
                    used, cap = util.get(osd, (0, 0))
                    ratio = used / cap if cap > 0 else 0.0
                    if ratio >= full_r:
                        want |= STATE_FULL
                        any_full = True
                    elif ratio >= nearfull_r:
                        want |= STATE_NEARFULL
                if want != st:
                    inc.new_state[osd] = want
            flags = cur.flags
            if any_full and not flags & FLAG_FULL:
                flags |= FLAG_FULL
                changed_auto["full"] = True
            elif not any_full and flags & FLAG_FULL and \
                    self._full_auto:
                flags &= ~FLAG_FULL
                changed_auto["full"] = False
            if flags != cur.flags:
                inc.new_flags = flags
            for pool in cur.pools.values():
                over = bool(
                    (pool.quota_bytes and
                     pool_bytes.get(pool.id, 0) >= pool.quota_bytes) or
                    (pool.quota_objects and
                     pool_objs.get(pool.id, 0) >= pool.quota_objects))
                if over != bool(pool.flags & FLAG_POOL_FULL_QUOTA):
                    import copy
                    newpool = copy.deepcopy(pool)
                    if over:
                        newpool.flags |= FLAG_POOL_FULL_QUOTA
                    else:
                        newpool.flags &= ~FLAG_POOL_FULL_QUOTA
                    inc.new_pools[pool.id] = newpool
            if not (inc.new_state or inc.new_flags is not None or
                    inc.new_pools):
                return None
            return inc, None
        # The sweep runs on every leader tick, and the tick loop is what
        # renews the peons' leases. Queued behind a burst of map commands
        # on ``_inc_lock`` (as the reference's sweep always queues), the
        # tick would send no lease for the burst's length and the peons
        # would call an election. So the build is tried on the current
        # map first, and the lock is taken only when there is a change
        # (ROADMAP Queue C).
        if build(self.osdmap) is None:
            return
        changed_auto.clear()
        ok, _ = await self._propose_change(build)
        if ok and "full" in changed_auto:
            self._full_auto = changed_auto["full"]
            log.dout(1, f"cluster FULL flag "
                        f"{'set' if self._full_auto else 'cleared'} "
                        f"by fullness sweep")

    # -- pgmap summary -----------------------------------------------------
    def pg_summary(self) -> dict:
        states: dict[str, int] = {}
        objects = 0
        nbytes = 0
        degraded = 0
        backfilling = 0
        backfill = {"scanned": 0, "pushed": 0, "removed": 0}
        for st in self.pg_stats.values():
            s = st.get("state", "unknown")
            states[s] = states.get(s, 0) + 1
            objects += st.get("num_objects", 0)
            nbytes += st.get("num_bytes", 0)
            if "degraded" in s or "undersized" in s or "down" in s:
                degraded += 1
            if "backfill" in s:
                backfilling += 1
            bf = st.get("backfill")
            if bf:
                for k in backfill:
                    backfill[k] += bf.get(k, 0)
        return {"num_pgs": len(self.pg_stats), "states": states,
                "num_objects": objects, "num_bytes": nbytes,
                "degraded_pgs": degraded,
                "backfilling_pgs": backfilling,
                "backfill_progress": backfill}

    # -- commands ----------------------------------------------------------
    async def handle_command(self, cmd, inbl=b""):
        om = self.osdmap
        if om is None:
            return -11, "osdmap not initialized", b""
        prefix = cmd.get("prefix", "")
        handler = {
            "osd new": self._cmd_new,
            "osd crush add": self._cmd_crush_add,
            "osd pool create": self._cmd_pool_create,
            "osd pool rm": self._cmd_pool_rm,
            "osd pool set": self._cmd_pool_set,
            "osd pool ls": self._cmd_pool_ls,
            "osd pool selfmanaged-snap-create": self._cmd_snap_create,
            "osd pool selfmanaged-snap-remove": self._cmd_snap_remove,
            "osd erasure-code-profile set": self._cmd_ecp_set,
            "osd erasure-code-profile get": self._cmd_ecp_get,
            "osd erasure-code-profile ls": self._cmd_ecp_ls,
            "osd set": self._cmd_set_flag,
            "osd unset": self._cmd_unset_flag,
            "osd pool set-quota": self._cmd_pool_set_quota,
            "osd down": self._cmd_down,
            "osd out": self._cmd_out,
            "osd in": self._cmd_in,
            "osd reweight": self._cmd_reweight,
            "osd dump": self._cmd_dump,
            "osd tree": self._cmd_tree,
            "osd df": self._cmd_df,
            "osd getmap": self._cmd_getmap,
            "osd getcrushmap": self._cmd_getcrushmap,
            "osd setcrushmap": self._cmd_setcrushmap,
            "osd map": self._cmd_map,
            "pg dump": self._cmd_pg_dump,
            "pg repair": self._cmd_pg_repair,
            "osd pg-upmap-items": self._cmd_pg_upmap_items,
            "osd rm-pg-upmap-items": self._cmd_rm_pg_upmap_items,
            "osd blocklist": self._cmd_blocklist,
            "osd client-profile": self._cmd_client_profile,
            "osd primary-affinity": self._cmd_primary_affinity,
            "osd slow ls": self._cmd_slow_ls,
        }.get(prefix)
        if handler is None:
            return -22, f"unknown command {prefix!r}", b""
        return await handler(cmd, inbl)

    async def _cmd_blocklist(self, cmd, inbl):
        """`osd blocklist add|rm|ls <entity> [expire-seconds]` — the
        cluster-level client fence (ref: OSDMonitor prepare_command
        "osd blocklist"; used by MDS eviction and lock breaking, so a
        zombie client cannot write after its caps moved on)."""
        import time
        op = cmd.get("blocklistop", "ls")
        if op == "ls":
            # expired entries are dead: don't report them even before
            # the periodic tick folds their removal into the map
            now = time.time()
            return 0, "", json.dumps(
                {"blocklist": {n: exp for n, exp in
                               self.osdmap.blocklist.items()
                               if exp > now}}).encode()
        name = cmd.get("addr", "")
        if not name:
            return -22, "missing addr", b""
        if op == "add":
            expire = float(cmd.get("expire", 3600.0))

            def build(om):
                inc = Incremental()
                inc.new_blocklist[name] = time.time() + expire
                return inc, None
        elif op == "rm":
            if name not in self.osdmap.blocklist:
                return 0, f"{name} isn't blocklisted", b""

            def build(om):
                inc = Incremental()
                inc.old_blocklist.append(name)
                return inc, None
        else:
            return -22, f"unknown blocklistop {op!r}", b""
        ok, _ = await self._propose_change(build)
        if not ok:
            return -11, "proposal failed", b""
        # report the epoch the fence is visible at: eviction's epoch
        # barrier (Objecter.wait_for_map_on_osds) needs it to prove
        # the OSDs enforce the blocklist before caps move on
        return 0, f"blocklist {op} {name}", json.dumps(
            {"epoch": self.osdmap.epoch}).encode()

    async def _cmd_set_flag(self, cmd, inbl):
        """`ceph osd set <flag>` (ref: OSDMonitor prepare_command
        "osd set"): pauserd, pausewr, full, noout, nodown, noup,
        noin."""
        name = cmd.get("key", "")
        bit = FLAG_NAMES.get(name)
        if bit is None:
            return -22, f"unknown flag {name!r} (have: " \
                        f"{', '.join(FLAG_NAMES)})", b""

        def build(om):
            if om.flags & bit:
                return None
            inc = Incremental()
            inc.new_flags = om.flags | bit
            return inc, None
        ok, _ = await self._propose_change(build)
        if bit == FLAG_FULL:
            self._full_auto = False      # operator-set: sticky
        if not ok and not (self.osdmap.flags & bit):
            return -11, "proposal failed", b""
        return 0, f"{name} is set", b""

    async def _cmd_unset_flag(self, cmd, inbl):
        name = cmd.get("key", "")
        bit = FLAG_NAMES.get(name)
        if bit is None:
            return -22, f"unknown flag {name!r}", b""

        def build(om):
            if not om.flags & bit:
                return None
            inc = Incremental()
            inc.new_flags = om.flags & ~bit
            return inc, None
        ok, _ = await self._propose_change(build)
        if bit == FLAG_FULL:
            self._full_auto = False
        if not ok and (self.osdmap.flags & bit):
            return -11, "proposal failed", b""
        return 0, f"{name} is unset", b""

    async def _cmd_pool_set_quota(self, cmd, inbl):
        """`ceph osd pool set-quota <pool> max_bytes|max_objects <val>`
        (ref: OSDMonitor prepare_command "osd pool set-quota"). 0
        clears the quota; the fullness tick then drops the pool's
        FULL_QUOTA flag and parked writers resume."""
        name = cmd.get("pool", "")
        field_ = cmd.get("field", "")
        if field_ not in ("max_bytes", "max_objects"):
            return -22, f"field must be max_bytes|max_objects, " \
                        f"got {field_!r}", b""
        try:
            val = int(cmd.get("val", ""))
        except (TypeError, ValueError):
            return -22, f"invalid quota value {cmd.get('val')!r}", b""
        if val < 0:
            return -22, "quota must be >= 0", b""

        def build(om):
            pool = next((p for p in om.pools.values()
                         if p.name == name), None)
            if pool is None:
                return None
            import copy
            newpool = copy.deepcopy(pool)
            if field_ == "max_bytes":
                newpool.quota_bytes = val
            else:
                newpool.quota_objects = val
            inc = Incremental()
            inc.new_pools[pool.id] = newpool
            return inc, None
        ok, _ = await self._propose_change(build)
        if not ok:
            if not any(p.name == name
                       for p in self.osdmap.pools.values()):
                return -2, f"pool '{name}' does not exist", b""
            return -11, "proposal failed", b""
        return 0, f"set pool {name} {field_} to {val}", b""

    async def _cmd_new(self, cmd, inbl):
        """Allocate an osd id (ref: `ceph osd new`)."""
        def build(om):
            osd = om.max_osd
            inc = Incremental()
            inc.new_max_osd = osd + 1
            inc.new_state[osd] = STATE_EXISTS       # exists, down
            return inc, osd
        ok, osd = await self._propose_change(build)
        if not ok:
            return -11, "proposal failed", b""
        return 0, "", json.dumps({"osdid": osd}).encode()

    async def _cmd_crush_add(self, cmd, inbl):
        """`osd crush add <id> <weight> host=<h>` — link into the tree
        (ref: OSDMonitor prepare_command osd crush add)."""
        osd = int(cmd["id"])
        weight = int(float(cmd.get("weight", 1.0)) * WEIGHT_ONE)
        host = cmd.get("host", f"host{osd}")

        def build(om):
            crush = decode_crush_map(encode_crush_map(om.crush))
            host_id = None
            for bid, name in crush.bucket_names.items():
                if name == host:
                    host_id = bid
                    break
            root = next((b.id for b in crush.buckets.values()
                         if b.type == builder.TYPE_ROOT), None)
            if host_id is None:
                host_id = builder.make_bucket(crush, builder.TYPE_HOST,
                                              [], name=host)
                if root is not None:
                    builder.insert_item(crush, host_id, 0, root)
            if osd in crush.buckets[host_id].items:
                return None                       # already linked
            crush.max_devices = max(crush.max_devices, osd + 1)
            builder.insert_item(crush, osd, weight, host_id)
            inc = Incremental()
            inc.new_crush = crush
            return inc, None
        ok, _ = await self._propose_change(build)
        if not ok:
            # distinguish already-linked (build returned None) from
            # a failed proposal
            if osd in {c for b in self.osdmap.crush.buckets.values()
                       for c in b.items}:
                return 0, f"osd.{osd} already in crush", b""
            return -11, "proposal failed", b""
        return 0, f"add item id {osd} to {host}", b""

    async def _cmd_pool_create(self, cmd, inbl):
        name = cmd["pool"]
        pg_num = int(cmd.get("pg_num", 32))
        pool_type = cmd.get("pool_type", "replicated")
        if any(p.name == name for p in self.osdmap.pools.values()):
            return 0, f"pool '{name}' already exists", b""
        if pool_type == "erasure":
            profile_name = cmd.get("erasure_code_profile", "default")
            prof = self._get_profile(profile_name)
            if prof is None:
                return -2, f"no ec profile {profile_name!r}", b""

        def build(om):
            if any(p.name == name for p in om.pools.values()):
                return None
            pid = max(om.pools, default=0) + 1
            inc = Incremental()
            if pool_type == "erasure":
                k, m_ = int(prof.get("k", 2)), int(prof.get("m", 1))
                crush = decode_crush_map(encode_crush_map(om.crush))
                root = next(b.id for b in crush.buckets.values()
                            if b.type == builder.TYPE_ROOT)
                fd = builder.TYPE_HOST
                if prof.get("crush-failure-domain") == "osd":
                    fd = builder.TYPE_OSD
                rule = builder.add_simple_rule(
                    crush, root, fd, name=f"ec_{profile_name}",
                    indep=True)
                pool = PGPool(id=pid, pg_num=pg_num,
                              type=POOL_TYPE_ERASURE, size=k + m_,
                              min_size=k, crush_rule=rule, name=name,
                              erasure_code_profile=profile_name,
                              extra={"profile": prof})
                inc.new_crush = crush
            else:
                pool = PGPool(id=pid, pg_num=pg_num,
                              type=POOL_TYPE_REPLICATED,
                              size=int(cmd.get("size", 3)),
                              min_size=int(cmd.get("min_size", 0)) or
                              max(1, int(cmd.get("size", 3)) - 1),
                              crush_rule=0, name=name)
            inc.new_pools[pid] = pool
            return inc, pid
        ok, _ = await self._propose_change(build)
        if not ok:
            if any(p.name == name for p in self.osdmap.pools.values()):
                return 0, f"pool '{name}' already exists", b""
            return -11, "proposal failed", b""
        return 0, f"pool '{name}' created", b""

    async def _cmd_pool_rm(self, cmd, inbl):
        om = self.osdmap
        name = cmd["pool"]
        pid = next((p.id for p in om.pools.values() if p.name == name),
                   None)
        if pid is None:
            return -2, f"pool '{name}' does not exist", b""
        inc = Incremental()
        inc.old_pools.append(pid)
        if not await self._propose_inc(inc):
            return -11, "proposal failed", b""
        return 0, f"pool '{name}' removed", b""

    async def _cmd_snap_create(self, cmd, inbl):
        """Allocate a self-managed snap id: bump the pool's snap_seq
        (ref: OSDMonitor::prepare_pool_op SELFMANAGED_SNAP_CREATE —
        pg_pool_t::add_unmanaged_snap)."""
        name = cmd["pool"]
        got: dict = {}

        def build(om):
            pool = next((p for p in om.pools.values()
                         if p.name == name), None)
            if pool is None:
                return None
            import copy
            newpool = copy.deepcopy(pool)
            sid = int(newpool.extra.get("snap_seq", 0)) + 1
            newpool.extra["snap_seq"] = sid
            got["snapid"] = sid
            inc = Incremental()
            inc.new_pools[pool.id] = newpool
            return inc, None
        ok, _ = await self._propose_change(build)
        if not ok or "snapid" not in got:
            if not any(p.name == name
                       for p in self.osdmap.pools.values()):
                return -2, f"pool '{name}' does not exist", b""
            return -11, "proposal failed", b""   # transient: retryable
        return 0, "", json.dumps({"snapid": got["snapid"]}).encode()

    async def _cmd_snap_remove(self, cmd, inbl):
        """Record a self-managed snap as deleted. removed_snaps rides
        the osdmap as the deletion queue: every OSD's map consumption
        kicks a background trim of the snap's clones (clients may also
        trim eagerly via OSD_OP_SNAPTRIM). snapids are never reused —
        snap_seq only ever grows."""
        name, sid = cmd["pool"], int(cmd["snapid"])

        def build(om):
            pool = next((p for p in om.pools.values()
                         if p.name == name), None)
            if pool is None:
                return None
            import copy
            newpool = copy.deepcopy(pool)
            removed = set(newpool.extra.get("removed_snaps", []))
            removed.add(sid)
            newpool.extra["removed_snaps"] = sorted(removed)
            inc = Incremental()
            inc.new_pools[pool.id] = newpool
            return inc, None
        ok, _ = await self._propose_change(build)
        if not ok:
            if not any(p.name == name
                       for p in self.osdmap.pools.values()):
                return -2, f"pool '{name}' does not exist", b""
            return -11, "proposal failed", b""   # transient: retryable
        return 0, f"removed snap {sid}", b""

    async def _cmd_pool_set(self, cmd, inbl):
        name, var, val = cmd["pool"], cmd["var"], cmd["val"]
        if var in ("qos_reservation", "qos_weight", "qos_limit"):
            return await self._cmd_pool_set_qos(name, var, val)
        if var not in ("size", "min_size", "pg_num", "pgp_num"):
            return -22, f"unknown pool var {var!r}", b""
        rejected: dict = {}

        merge_started: dict = {}

        def build(om):
            # guards run INSIDE build against the authoritative map a
            # proposal would actually apply to — prechecking against
            # self.osdmap races concurrent pool-set commands and could
            # land a conflicting pg_num transition
            # (ref: OSDMonitor::prepare_command_pool_set checks)
            pool = next((p for p in om.pools.values()
                         if p.name == name), None)
            if pool is None:
                return None
            if var in ("pg_num", "pgp_num") and pool.pg_num_pending:
                rejected["msg"] = (
                    f"pool '{name}' has a pg merge in flight "
                    f"(pg_num_pending={pool.pg_num_pending}); wait "
                    f"for it to commit")
                return None
            if var == "pgp_num" and int(val) > pool.pg_num:
                rejected["msg"] = "pgp_num cannot exceed pg_num"
                return None
            import copy
            newpool = copy.deepcopy(pool)
            if var == "pg_num" and int(val) < pool.pg_num:
                # PG MERGE (ref: the pg_num_pending two-phase
                # decrease, inverse of round-4's split): phase 1
                # commits pg_num_pending + the pgp_num fold, so source
                # PGs migrate onto their fold targets through normal
                # peering; the actual pg_num decrease commits on tick
                # once every source has quiesced and reported
                # ready-to-merge.
                if not self.mon.config.get("mon_allow_pg_merge",
                                           True):
                    rejected["msg"] = (
                        "pg_num decrease (merge) disabled "
                        "(mon_allow_pg_merge=false)")
                    return None
                if pool.is_erasure():
                    rejected["ret"] = -95              # -EOPNOTSUPP
                    rejected["msg"] = (
                        f"pool '{name}' is erasure-coded: pg merge "
                        f"(pg_num decrease) is implemented for "
                        f"replicated pools only — folding an EC "
                        f"source PG would have to re-stripe every "
                        f"object's k+m shards into the target's "
                        f"layout, which this merge (a collection "
                        f"fold) does not do; create a new pool with "
                        f"the desired pg_num and migrate, or leave "
                        f"pg_num as is (EOPNOTSUPP)")
                    return None
                if int(val) < 1:
                    rejected["msg"] = "pg_num must be >= 1"
                    return None
                newpool.pg_num_pending = int(val)
                newpool.pgp_num = min(newpool.pgp_num, int(val))
                merge_started["to"] = int(val)
            else:
                setattr(newpool, var, int(val))
                if var == "pg_num" and \
                        newpool.pgp_num > newpool.pg_num:
                    newpool.pgp_num = newpool.pg_num
            inc = Incremental()
            inc.new_pools[pool.id] = newpool
            return inc, None
        ok, _ = await self._propose_change(build)
        if not ok:
            if "msg" in rejected:
                return rejected.get("ret", -22), rejected["msg"], b""
            if not any(p.name == name
                       for p in self.osdmap.pools.values()):
                return -2, f"pool '{name}' does not exist", b""
            return -11, "proposal failed", b""
        if "to" in merge_started:
            self.mon.clog(
                "INF", f"pool '{name}' pg merge started: pg_num -> "
                       f"{merge_started['to']} pending source "
                       f"quiesce")
            return 0, f"set pool {name} pg_num_pending to {val} " \
                      f"(merge pending source readiness)", b""
        return 0, f"set pool {name} {var} to {val}", b""

    async def _cmd_pool_set_qos(self, name, var, val):
        """`osd pool set <pool> qos_reservation|qos_weight|qos_limit
        <v>` (ref: the per-pool mClock profile overrides): the pool's
        dmClock parameters for every client queue without a per-entity
        profile. 0 clears back to the osd_qos_default_* knobs."""
        try:
            fval = float(val)
        except (TypeError, ValueError):
            return -22, f"invalid {var} value {val!r}", b""
        if fval < 0:
            return -22, f"{var} must be >= 0", b""

        def build(om):
            pool = next((p for p in om.pools.values()
                         if p.name == name), None)
            if pool is None:
                return None
            import copy
            newpool = copy.deepcopy(pool)
            setattr(newpool, var, fval)
            inc = Incremental()
            inc.new_pools[pool.id] = newpool
            return inc, None
        ok, _ = await self._propose_change(build)
        if not ok:
            if not any(p.name == name
                       for p in self.osdmap.pools.values()):
                return -2, f"pool '{name}' does not exist", b""
            return -11, "proposal failed", b""
        return 0, f"set pool {name} {var} to {fval}", b""

    async def _cmd_client_profile(self, cmd, inbl):
        """`ceph osd client-profile set <entity> <reservation>
        <weight> <limit>` / `rm <entity>` / `ls` — the per-entity QoS
        table (ref: dmClock's per-client (ρ, w, λ)); rides the osdmap
        so every OSD's scheduler converges on one committed table."""
        op = cmd.get("op", "ls")
        if op == "ls":
            return 0, "", json.dumps({
                "profiles": {
                    e: {"reservation": p[0], "weight": p[1],
                        "limit": p[2]}
                    for e, p in sorted(
                        self.osdmap.client_profiles.items())}}).encode()
        entity = cmd.get("entity", "")
        if not entity:
            return -22, "missing entity", b""
        if op == "set":
            try:
                prof = (float(cmd.get("reservation", 0.0)),
                        float(cmd.get("weight", 1.0)),
                        float(cmd.get("limit", 0.0)))
            except (TypeError, ValueError):
                return -22, "reservation/weight/limit must be " \
                            "numbers", b""
            if min(prof) < 0:
                return -22, "qos parameters must be >= 0", b""

            def build(om):
                inc = Incremental()
                inc.new_client_profiles[entity] = prof
                return inc, None
        elif op == "rm":
            if entity not in self.osdmap.client_profiles:
                return 0, f"{entity} has no profile", b""

            def build(om):
                inc = Incremental()
                inc.old_client_profiles.append(entity)
                return inc, None
        else:
            return -22, f"unknown client-profile op {op!r}", b""
        ok, _ = await self._propose_change(build)
        if not ok:
            return -11, "proposal failed", b""
        return 0, f"client-profile {op} {entity}", b""

    async def _cmd_pool_ls(self, cmd, inbl):
        out = [{"pool": p.id, "name": p.name, "pg_num": p.pg_num,
                "size": p.size,
                "type": "erasure" if p.is_erasure() else "replicated"}
               for p in self.osdmap.pools.values()]
        return 0, "", json.dumps(out).encode()

    # ec profiles live in the store (committed via paxos txns)
    def _get_profile(self, name: str) -> dict | None:
        if name == "default":
            return {"k": 2, "m": 1, "plugin": "jax",
                    "technique": "reed_sol_van"}
        blob = self.store.get("ecprofiles", name)
        return json.loads(blob) if blob is not None else None

    async def _cmd_ecp_set(self, cmd, inbl):
        name = cmd["name"]
        prof = {}
        for kv in cmd.get("profile", []):
            k, _, v = kv.partition("=")
            prof[k] = v
        t = self.store.transaction()
        t.set("ecprofiles", name, json.dumps(prof).encode())
        ok = await self.mon.propose_txn(t)
        return (0, "", b"") if ok else (-11, "proposal failed", b"")

    async def _cmd_ecp_get(self, cmd, inbl):
        prof = self._get_profile(cmd["name"])
        if prof is None:
            return -2, f"no profile {cmd['name']!r}", b""
        return 0, "", json.dumps(prof).encode()

    async def _cmd_ecp_ls(self, cmd, inbl):
        names = [k for k, _ in self.store.iterate("ecprofiles")]
        return 0, "", json.dumps(["default"] + names).encode()

    async def _cmd_down(self, cmd, inbl):
        osd = int(cmd["id"])
        # same id guard as the failure/mark-me-down paths: an
        # out-of-range id would commit an Incremental whose apply
        # indexes past osd_state (and a negative one would silently
        # mark — and now auto-out — the LAST osd via numpy indexing)
        if osd < 0 or osd >= self.osdmap.max_osd:
            return -22, f"osd.{osd} does not exist", b""
        # already down: succeed without proposing (the reference's
        # "osd.N is already down") — a redundant commit would bump
        # the epoch cluster-wide for a no-op, and re-stamping
        # down_at after auto-out already popped it would leave an
        # entry the tick can never remove (removal needs a nonzero
        # weight)
        if not bool(self.osdmap.is_up(np.asarray(osd))):
            return 0, f"osd.{osd} is already down", b""
        inc = Incremental()
        inc.new_down = [osd]
        ok = await self._propose_inc(inc)
        if ok:
            # full failure-path state transition, not just the map
            # bit: a command-marked-down OSD may be a hard-killed
            # daemon (an alive one re-boots and re-reports; nothing
            # is lost)
            self._mark_down_bookkeeping(osd)
        return (0, f"marked down osd.{cmd['id']}", b"") if ok else \
            (-11, "proposal failed", b"")

    async def _cmd_out(self, cmd, inbl):
        inc = Incremental()
        inc.new_weight[int(cmd["id"])] = 0
        ok = await self._propose_inc(inc)
        return (0, f"marked out osd.{cmd['id']}", b"") if ok else \
            (-11, "proposal failed", b"")

    async def _cmd_in(self, cmd, inbl):
        inc = Incremental()
        inc.new_weight[int(cmd["id"])] = WEIGHT_ONE
        ok = await self._propose_inc(inc)
        return (0, f"marked in osd.{cmd['id']}", b"") if ok else \
            (-11, "proposal failed", b"")

    async def _cmd_reweight(self, cmd, inbl):
        inc = Incremental()
        inc.new_weight[int(cmd["id"])] = \
            int(float(cmd["weight"]) * WEIGHT_ONE)
        ok = await self._propose_inc(inc)
        return (0, "", b"") if ok else (-11, "proposal failed", b"")

    async def _cmd_dump(self, cmd, inbl):
        from ceph_tpu_torch.osd.osdmap import DEFAULT_PRIMARY_AFFINITY
        om = self.osdmap
        out = {
            "epoch": om.epoch, "max_osd": om.max_osd,
            "flags": flag_names(om.flags),
            "osds": [{
                "osd": o,
                "up": int(bool(om.is_up(np.asarray(o)))),
                "in": int(om.osd_weight[o] > 0),
                "weight": float(om.osd_weight[o] / WEIGHT_ONE),
                "nearfull": int(om.is_nearfull(o)),
                "full": int(om.is_full(o)),
                "primary_affinity": round(
                    int(om.osd_primary_affinity[o]) /
                    DEFAULT_PRIMARY_AFFINITY, 4),
                "addr": list(om.osd_addrs.get(o, ())),
            } for o in range(om.max_osd)
                if om.osd_state[o] & STATE_EXISTS],
            "pools": [{"pool": p.id, "name": p.name,
                       "type": p.type, "size": p.size,
                       "min_size": p.min_size, "pg_num": p.pg_num,
                       "pgp_num": p.pgp_num,
                       "pg_num_pending": p.pg_num_pending,
                       "crush_rule": p.crush_rule,
                       "quota_bytes": p.quota_bytes,
                       "quota_objects": p.quota_objects,
                       "full": int(p.is_full()),
                       "qos_reservation": p.qos_reservation,
                       "qos_weight": p.qos_weight,
                       "qos_limit": p.qos_limit,
                       "erasure_code_profile": p.erasure_code_profile}
                      for p in om.pools.values()],
            "pg_upmap_items": {str(k): [list(x) for x in v]
                               for k, v in om.pg_upmap_items.items()},
            "client_profiles": {e: list(p) for e, p in
                                sorted(om.client_profiles.items())},
        }
        return 0, "", json.dumps(out).encode()

    async def _cmd_tree(self, cmd, inbl):
        from ceph_tpu_torch.crush.tree_dumper import dump_tree
        return 0, "", dump_tree(self.osdmap.crush,
                                osdmap=self.osdmap).encode()

    async def _cmd_df(self, cmd, inbl):
        om = self.osdmap
        util = np.zeros(om.max_osd, dtype=np.int64)
        for pid in om.pools:
            util += om.pool_utilization(pid)
        out = []
        for o in range(om.max_osd):
            if not om.osd_state[o] & STATE_EXISTS:
                continue
            used, cap = self.osd_utilization.get(o, (0, 0))
            out.append({
                "osd": o, "pgs": int(util[o]),
                "weight": float(om.osd_weight[o] / WEIGHT_ONE),
                "used_bytes": used, "capacity_bytes": cap,
                "utilization": used / cap if cap else 0.0})
        return 0, "", json.dumps(out).encode()

    async def _cmd_getmap(self, cmd, inbl):
        return 0, "", self.encode_full()

    async def _cmd_getcrushmap(self, cmd, inbl):
        return 0, "", encode_crush_map(self.osdmap.crush)

    async def _cmd_setcrushmap(self, cmd, inbl):
        inc = Incremental()
        inc.new_crush = decode_crush_map(inbl)
        ok = await self._propose_inc(inc)
        return (0, "", b"") if ok else (-11, "proposal failed", b"")

    async def _cmd_map(self, cmd, inbl):
        """`osd map <pool> <obj>` — where would this object land
        (ref: OSDMonitor 'osd map' command)."""
        om = self.osdmap
        pool = next((p for p in om.pools.values()
                     if p.name == cmd["pool"]), None)
        if pool is None:
            return -2, f"pool '{cmd['pool']}' does not exist", b""
        from ceph_tpu_torch.osd.types import ObjectLocator
        pg = om.object_locator_to_pg(cmd["object"],
                                     ObjectLocator(pool=pool.id))
        seed = pool.raw_pg_to_pg(np.asarray([pg.seed]), xp=np)[0]
        up, upp, acting, actp = om.pg_to_up_acting_osds(pool.id, [seed])
        from ceph_tpu_torch.crush.types import ITEM_NONE
        return 0, "", json.dumps({
            "pgid": f"{pool.id}.{int(seed):x}",
            "up": [int(o) for o in up[0] if o != ITEM_NONE],
            "up_primary": int(upp[0]),
            "acting": [int(o) for o in acting[0] if o != ITEM_NONE],
            "acting_primary": int(actp[0])}).encode()

    async def _cmd_pg_upmap_items(self, cmd, inbl):
        """`osd pg-upmap-items <pgid> <from> <to> [...]` — the mgr
        balancer's write path (ref: OSDMonitor prepare_command
        osd pg-upmap-items)."""
        from ceph_tpu_torch.osd.types import pg_t
        pg = pg_t.parse(cmd["pgid"])
        maps = [int(x) for x in cmd["mappings"]]
        pairs = list(zip(maps[0::2], maps[1::2]))
        inc = Incremental()
        inc.new_pg_upmap_items[pg] = pairs
        ok = await self._propose_inc(inc)
        return (0, f"set {cmd['pgid']} pg_upmap_items", b"") if ok \
            else (-11, "proposal failed", b"")

    async def _cmd_rm_pg_upmap_items(self, cmd, inbl):
        from ceph_tpu_torch.osd.types import pg_t
        inc = Incremental()
        inc.old_pg_upmap_items.append(pg_t.parse(cmd["pgid"]))
        ok = await self._propose_inc(inc)
        return (0, "", b"") if ok else (-11, "proposal failed", b"")

    async def _cmd_pg_dump(self, cmd, inbl):
        return 0, "", json.dumps({
            "summary": self.pg_summary(),
            "pg_stats": self.pg_stats}).encode()

    async def _cmd_pg_repair(self, cmd, inbl):
        """`ceph pg repair <pgid>` (ref: OSDMonitor prepare_command
        "pg repair" -> MOSDScrub with repair=true): instruct the PG's
        acting primary to run a repair scrub — digest-mismatched
        replicas are rewritten from the authoritative copy, bad EC
        shards rebuilt through decode. The mon computes the primary
        from the map and messages it directly, like the reference's
        mon->OSD scrub ordering."""
        from ceph_tpu_torch.osd.messages import MOSDPGRepair
        from ceph_tpu_torch.osd.types import pg_t
        om = self.osdmap
        try:
            pg = pg_t.parse(cmd["pgid"])
        except (KeyError, ValueError):
            return -22, "usage: pg repair <pgid>", b""
        pool = om.pools.get(pg.pool)
        if pool is None or pg.seed >= pool.pg_num:
            return -2, f"pg {cmd['pgid']} does not exist", b""
        _up, _upp, _acting, actp = om.pg_to_up_acting_osds(
            pg.pool, [pg.seed])
        primary = int(actp[0])
        if primary < 0 or not bool(om.is_up(np.asarray(primary))):
            return -11, f"pg {cmd['pgid']} has no live primary", b""
        ent = om.osd_addrs.get(primary)
        if not ent:
            return -11, f"osd.{primary} has no address", b""
        from ceph_tpu_torch.msg import EntityAddr
        try:
            await asyncio.wait_for(self.mon.msgr.send_message(
                MOSDPGRepair(pgid=str(pg), epoch=om.epoch,
                             from_osd=-1),
                EntityAddr(ent[0], ent[1]), f"osd.{primary}"),
                timeout=2.0)
        except Exception as e:
            return -11, f"cannot reach osd.{primary}: {e}", b""
        return 0, f"instructing pg {pg} on osd.{primary} to repair", \
            b""
