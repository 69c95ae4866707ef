"""The stock mgr modules: balancer, pg_autoscaler, prometheus.

ref: src/pybind/mgr/balancer/module.py (upmap mode driving
OSDMap::calc_pg_upmaps), src/pybind/mgr/pg_autoscaler/module.py
(pg_num recommendations), src/pybind/mgr/prometheus/module.py
(the /metrics exporter).

The port's copy of ``ceph_tpu/mgr/modules.py``. The balancer's probes
run on the mgr's placement table, which maps on the mgr's device; the
crush-compat weight-set goes through the port's
``crush.builder.quantize_choose_args`` and ``encoding.encode_crush_map``.
Prometheus's device rows read the port's launch paths (``kernel``,
``vm``, ``scalar``) where the reference reads its own.
"""

from __future__ import annotations

import asyncio

from ceph_tpu_torch.mgr.daemon import MgrModule
from ceph_tpu_torch.osd.osdmap import Incremental
from ceph_tpu_torch.utils.logging import get_logger
from ceph_tpu_torch.utils.perf_counters import PerfCountersCollection

log = get_logger("mgr")


class BalancerModule(MgrModule):
    """upmap balancer (ref: balancer/module.py Module.optimize +
    Plan.execute): pull the authoritative map, run calc_pg_upmaps,
    push each change through `osd pg-upmap-items`.

    ``balancer_mode`` = "upmap" (default) | "crush-compat": the compat
    mode emits a choose_args weight-set instead (ref: the balancer's
    crush-compat mode driving CrushWrapper weight-sets) — and ALWAYS
    quantized to the fused-kernel class budget: a continuous per-item
    weight-set would silently push every mapping onto the slower
    general path (the mgr enforces the budget, not just documents
    it)."""

    NAME = "balancer"
    TICK_INTERVAL = 5.0

    def __init__(self, mgr):
        super().__init__(mgr)
        self.max_deviation = mgr.config.get("upmap_max_deviation", 1)
        self.max_optimizations = mgr.config.get(
            "upmap_max_optimizations", 20)
        self.mode = mgr.config.get("balancer_mode", "upmap")
        self.last_changes = 0

    async def tick(self) -> None:
        if self.mode == "crush-compat":
            self.last_changes = await self.optimize_weight_set()
        else:
            self.last_changes = await self.optimize()

    async def optimize_weight_set(self) -> int:
        """crush-compat balancing: scale each device's compat
        weight-set entry by target/actual PG count, quantize to the
        kernel's class budget, push via `osd setcrushmap`."""
        import numpy as np
        from ceph_tpu_torch.crush.builder import quantize_choose_args
        from ceph_tpu_torch.crush.types import ITEM_NONE, WEIGHT_ONE, \
            ChooseArg
        osdmap = await self.get("osd_map")
        if not osdmap.pools:
            return 0
        counts = np.zeros(osdmap.max_osd, dtype=np.int64)
        for pid in osdmap.pools:
            up, _, _, _ = osdmap.map_pool(pid)
            flat = up[(up != ITEM_NONE) & (up >= 0)]
            counts += np.bincount(flat, minlength=osdmap.max_osd)
        total = int(counts.sum())
        if total == 0:
            return 0
        crush = osdmap.crush
        in_w = np.asarray(osdmap.osd_weight, dtype=np.float64)
        weighted = [o for o in range(osdmap.max_osd) if in_w[o] > 0]
        if not weighted:
            return 0
        target = total / len(weighted)
        args: dict[int, ChooseArg] = {}
        changed = False
        for bid, b in crush.buckets.items():
            if not any(0 <= it < osdmap.max_osd for it in b.items):
                continue          # only device-holding buckets scale
            ws = []
            for it, w in zip(b.items, b.weights):
                if 0 <= it < osdmap.max_osd and counts[it] > 0 and \
                        in_w[it] > 0:
                    scaled = int(w * target / counts[it])
                    ws.append(max(scaled, WEIGHT_ONE // 16))
                    if scaled != w:
                        changed = True
                else:
                    ws.append(int(w))
            args[bid] = ChooseArg(weight_set=[ws])
        if not changed:
            return 0
        prev = {bid: [list(ws) for ws in arg.weight_set]
                for bid, arg in crush.choose_args.get(-1, {}).items()}
        crush.choose_args[-1] = args      # the compat weight-set id
        quantize_choose_args(crush, key=-1)
        # placement mutated in place: bump the epoch so the attached
        # table/memo can never serve pre-mutation rows for this object
        # (the every-placement-mutation-bumps-epoch invariant; the
        # authoritative epoch comes from the mon on the next fetch)
        osdmap._dirty(crush_changed=True)
        if prev == {bid: [list(ws) for ws in arg.weight_set]
                    for bid, arg in crush.choose_args[-1].items()}:
            # already installed: pushing again every tick would churn
            # the osdmap epoch forever on a stable cluster
            return 0
        from ceph_tpu_torch.encoding import encode_crush_map
        ret, rs, _ = await self.mon_command(
            {"prefix": "osd setcrushmap"}, encode_crush_map(crush))
        if ret != 0:
            log.dout(1, f"balancer setcrushmap failed: {rs}")
            return 0
        log.dout(1, f"balancer pushed quantized compat weight-set "
                    f"({len(args)} buckets)")
        return len(args)

    async def optimize(self) -> int:
        osdmap = await self.get("osd_map")
        if not osdmap.pools:
            return 0
        inc = Incremental()
        changes = osdmap.calc_pg_upmaps(
            max_deviation=self.max_deviation,
            max_iterations=self.max_optimizations, inc=inc)
        if not changes:
            return 0
        applied = 0
        for pg, pairs in inc.new_pg_upmap_items.items():
            maps: list[int] = []
            for f, t in pairs:
                maps += [int(f), int(t)]
            ret, rs, _ = await self.mon_command(
                {"prefix": "osd pg-upmap-items", "pgid": str(pg),
                 "mappings": maps})
            if ret == 0:
                applied += 1
        for pg in inc.old_pg_upmap_items:
            ret, _, _ = await self.mon_command(
                {"prefix": "osd rm-pg-upmap-items", "pgid": str(pg)})
            if ret == 0:
                applied += 1
        if applied:
            log.dout(1, f"balancer applied {applied} upmap changes")
        return applied


class PGAutoscalerModule(MgrModule):
    """pg_num recommendations (ref: pg_autoscaler/module.py): target
    ~rate pgs per osd split across pools, rounded to a power of two;
    grows pg_num via `osd pool set` when under half the target.

    BIDIRECTIONAL (ref: the autoscaler's threshold logic
    shrinking over-provisioned pools): a pool whose pg_num exceeds the
    recommendation by ``autoscaler_shrink_threshold`` (default 4x)
    gets a pg_num DECREASE proposed — the mon runs it through the
    pg_num_pending merge barrier. Shrinks only fire on a clean
    cluster: stacking a merge onto recovery would serialize two
    migrations."""

    NAME = "pg_autoscaler"
    TICK_INTERVAL = 5.0

    def __init__(self, mgr):
        super().__init__(mgr)
        self.target_per_osd = mgr.config.get(
            "mon_target_pg_per_osd", 100)
        self.max_pg_num = mgr.config.get("autoscaler_max_pg_num", 256)
        self.shrink_threshold = mgr.config.get(
            "autoscaler_shrink_threshold", 4)

    def recommend(self, n_osds: int, n_pools: int, size: int) -> int:
        if not (n_osds and n_pools and size):
            return 0
        raw = self.target_per_osd * n_osds / size / n_pools
        p = 1
        while p * 2 <= raw:
            p *= 2
        return min(max(p, 1), self.max_pg_num)

    async def tick(self) -> None:
        dump = await self.get("osd_dump")
        pg_dump = await self.get("pg_dump")
        pools = dump.get("pools", [])
        n_osds = sum(1 for o in dump.get("osds", []) if o["in"])
        # objects per pool from pg stats ("pool.seed" keys)
        objs_per_pool: dict[int, int] = {}
        for pgid, st in pg_dump.get("pg_stats", {}).items():
            pid = int(pgid.split(".")[0])
            objs_per_pool[pid] = objs_per_pool.get(pid, 0) + \
                st.get("num_objects", 0)
        for pool in pools:
            # pg splitting: OSDs split populated PGs locally
            # on a pg_num increase, so populated pools grow too. Two
            # phases like the reference: raise pg_num (split in place —
            # pgp_num stays, placement unchanged), then once the
            # cluster is clean raise pgp_num to migrate the children
            # (ref: pg_autoscaler module + OSDMonitor pgp_num ramp).
            want = self.recommend(n_osds, len(pools), pool["size"])
            if pool.get("pg_num_pending"):
                continue          # merge in flight: hands off
            if want and pool["pg_num"] * 2 <= want:
                log.dout(1, f"autoscaler: pool {pool['name']} pg_num "
                            f"{pool['pg_num']} -> {want}")
                await self.mon_command(
                    {"prefix": "osd pool set", "pool": pool["name"],
                     "var": "pg_num", "val": str(want)})
            elif want and pool["pg_num"] >= want * \
                    self.shrink_threshold and \
                    pool["type"] != 3 and self._all_clean(pg_dump):
                # over-split: propose the merge (pool type 3 =
                # erasure — the mon refuses EC merges)
                log.dout(1, f"autoscaler: pool {pool['name']} "
                            f"over-split; pg_num {pool['pg_num']} -> "
                            f"{want} (merge)")
                await self.mon_command(
                    {"prefix": "osd pool set", "pool": pool["name"],
                     "var": "pg_num", "val": str(want)})
            elif pool.get("pgp_num", pool["pg_num"]) < pool["pg_num"] \
                    and self._all_clean(pg_dump):
                log.dout(1, f"autoscaler: pool {pool['name']} pgp_num "
                            f"-> {pool['pg_num']}")
                await self.mon_command(
                    {"prefix": "osd pool set", "pool": pool["name"],
                     "var": "pgp_num", "val": str(pool["pg_num"])})

    @staticmethod
    def _all_clean(pg_dump) -> bool:
        """Exact clean states only: 'active+undersized+degraded' must
        NOT license the pgp_num ramp (migrating split children while
        degraded would stack recovery on recovery)."""
        stats = pg_dump.get("pg_stats", {})
        return bool(stats) and all(
            st.get("state", "") in ("clean", "replica")
            for st in stats.values())


class PrometheusModule(MgrModule):
    """/metrics exporter (ref: prometheus/module.py) — a tiny asyncio
    HTTP endpoint rendering cluster + perf-counter gauges in the
    exposition format."""

    NAME = "prometheus"
    TICK_INTERVAL = 2.0

    def __init__(self, mgr):
        super().__init__(mgr)
        self._server: asyncio.AbstractServer | None = None
        self.port: int | None = None
        self._latest = "# no scrape yet\n"

    async def tick(self) -> None:
        if self._server is None:
            self._server = await asyncio.start_server(
                self._serve_client, "127.0.0.1",
                self.mgr.config.get("mgr_prometheus_port", 0))
            self.port = self._server.sockets[0].getsockname()[1]
            log.dout(1, f"prometheus exporter on :{self.port}")
        self._latest = await self.render()

    async def render(self) -> str:
        status = await self.get("status")
        lines = ["# TYPE ceph_osd_up gauge"]
        om = status.get("osdmap", {})
        pg = status.get("pgmap", {})
        health = {"HEALTH_OK": 0, "HEALTH_WARN": 1,
                  "HEALTH_ERR": 2}.get(
            status.get("health", {}).get("status"), -1)
        lines += [
            f"ceph_health_status {health}",
            f"ceph_osd_up {om.get('num_up_osds', 0)}",
            f"ceph_osd_in {om.get('num_in_osds', 0)}",
            f"ceph_osd_total {om.get('num_osds', 0)}",
            f"ceph_osdmap_epoch {om.get('epoch', 0)}",
            f"ceph_pool_total {om.get('pools', 0)}",
            f"ceph_pg_total {pg.get('num_pgs', 0)}",
            f"ceph_pg_degraded {pg.get('degraded_pgs', 0)}",
            f"ceph_pg_backfilling {pg.get('backfilling_pgs', 0)}",
            f"ceph_backfill_objects_pushed "
            f"{pg.get('backfill_progress', {}).get('pushed', 0)}",
            f"ceph_objects_total {pg.get('num_objects', 0)}",
            f"ceph_bytes_total {pg.get('num_bytes', 0)}",
        ]
        for state, n in pg.get("states", {}).items():
            safe = state.replace("+", "_")
            lines.append(f'ceph_pg_state{{state="{safe}"}} {n}')
        # metadata plane: per-daemon failover-ladder state
        # plus the standby pool depth — the gauges behind the
        # MDS_ALL_DOWN / MDS_INSUFFICIENT_STANDBY health checks
        fsm = status.get("fsmap", {})
        if fsm.get("states"):
            lines.append("# TYPE ceph_mds_state gauge")
            for nm, stt in sorted(fsm["states"].items()):
                lines.append(
                    f'ceph_mds_state{{name="{nm}",state="{stt}"}} 1')
        lines += [
            f"ceph_mds_standby_count {fsm.get('standby_count', 0)}",
            f"ceph_mds_failed_ranks {len(fsm.get('failed', []))}",
            f"ceph_fsmap_epoch {fsm.get('epoch', 0)}",
        ]
        # multi-active metadata plane: rank occupancy, the
        # subtree partition, in-flight migrations, and the per-rank
        # op rates the rebalancer steers by
        lines += [
            "# TYPE ceph_mds_max_mds gauge",
            f"ceph_mds_max_mds {fsm.get('max_mds', 1)}",
            f"ceph_mds_active_count {len(fsm.get('actives', {}))}",
            f"ceph_mds_subtree_migrations_pending "
            f"{len(fsm.get('migrations', []))}",
        ]
        subtree_per_rank: dict[int, int] = {}
        for _root, rk in fsm.get("subtrees", {}).items():
            subtree_per_rank[rk] = subtree_per_rank.get(rk, 0) + 1
        for rk, n in sorted(subtree_per_rank.items()):
            lines.append(
                f'ceph_mds_subtrees{{rank="{rk}"}} {n}')
        for rk, rate in sorted(
                fsm.get("rank_ops_rate", {}).items()):
            lines.append(
                f'ceph_mds_rank_ops_rate{{rank="{rk}"}} {rate}')
        # snapshot plane: the mon snap service's registry
        # size and the cumulative deleted snapids riding the osdmap —
        # registered growing while removed stalls = trimmer wedged
        lines += [
            "# TYPE ceph_snap_registered gauge",
            f"ceph_snap_registered {fsm.get('num_snaps', 0)}",
            f"ceph_snap_removed {om.get('removed_snaps', 0)}",
        ]
        # elastic control plane: quorum depth, committed
        # auth keys, in-flight pg merges — the gauges behind
        # MON_DOWN / AUTH_KEY_REVOKED / PG_MERGE_PENDING
        mm = status.get("monmap", {})
        auth = status.get("auth", {})
        merges = om.get("pending_merges", {})
        lines += [
            "# TYPE ceph_mon_quorum_count gauge",
            f"ceph_mon_quorum_count {len(status.get('quorum', []))}",
            f"ceph_mon_total {mm.get('num_mons', 0)}",
            f"ceph_monmap_epoch {mm.get('epoch', 0)}",
            "# TYPE ceph_auth_keys gauge",
            f"ceph_auth_keys {auth.get('num_keys', 0)}",
            f"ceph_pg_merge_pending {len(merges)}",
        ]
        for pname, v in sorted(merges.items()):
            lines.append(
                f'ceph_pg_merge_sources_ready{{pool="{pname}"}} '
                f'{v.get("ready", 0)}')
        # overload protection: per-OSD utilization ratio, pool quotas,
        # fullness counts and the osdmap service flags
        lines.append("# TYPE ceph_osd_utilization gauge")
        for osd, ut in om.get("osd_utilization", {}).items():
            cap = ut.get("capacity", 0)
            ratio = ut.get("used", 0) / cap if cap else 0.0
            lines.append(
                f'ceph_osd_utilization{{osd="{osd}"}} {ratio:.6f}')
        for pq in om.get("pool_quotas", []):
            name = pq.get("name", str(pq.get("pool")))
            lines += [
                f'ceph_pool_quota_bytes{{pool="{name}"}} '
                f'{pq.get("quota_bytes", 0)}',
                f'ceph_pool_quota_objects{{pool="{name}"}} '
                f'{pq.get("quota_objects", 0)}',
                f'ceph_pool_full{{pool="{name}"}} '
                f'{pq.get("full", 0)}',
            ]
        lines += [
            f"ceph_osd_nearfull {om.get('num_nearfull_osds', 0)}",
            f"ceph_osd_full {om.get('num_full_osds', 0)}",
        ]
        flags = om.get("flags", "")
        for fname in (flags.split(",") if flags else []):
            lines.append(f'ceph_osdmap_flag{{flag="{fname}"}} 1')
        # gray failure: per-OSD slow-score behind OSD_SLOW
        slow = om.get("slow_osds", {})
        if slow:
            lines.append("# TYPE ceph_osd_slow_score gauge")
            for osd, score in sorted(slow.items()):
                lines.append(
                    f'ceph_osd_slow_score{{osd="{osd}"}} {score}')
        # device runtime: mismatch ratio per daemon whose
        # kernel path the mon confirmed degraded (KERNEL_PATH_DEGRADED)
        dkp = om.get("degraded_kernel_paths", {})
        if dkp:
            lines.append("# TYPE ceph_device_path_degraded gauge")
            for osd, ratio in sorted(dkp.items()):
                lines.append(
                    f'ceph_device_path_degraded{{osd="{osd}"}} '
                    f'{ratio}')
        # op QoS scheduler: the dmClock admission counters
        qpc = PerfCountersCollection.instance().get("osd_qos")
        if qpc is not None:
            qd = qpc.dump()
            lines.append("# ceph_osd_qos_*: scheduler counters")
            for key in sorted(qd):
                val = qd[key]
                if isinstance(val, (int, float)):
                    lines.append(f"ceph_osd_qos_{key} {val}")
        # mapping engine: epoch-cache traffic and delta-remap
        # volume — the counters behind the "<1s to map 100M PGs" target
        mpc = PerfCountersCollection.instance().get("osdmap")
        if mpc is not None:
            md = mpc.dump()
            lines += [
                "# TYPE ceph_osdmap_mapping_cache_hits counter",
                f"ceph_osdmap_mapping_cache_hits "
                f"{md.get('mapping_cache_hits', 0)}",
                "# TYPE ceph_osdmap_mapping_cache_misses counter",
                f"ceph_osdmap_mapping_cache_misses "
                f"{md.get('mapping_cache_misses', 0)}",
                "# TYPE ceph_osdmap_remap_pgs counter",
                f"ceph_osdmap_remap_pgs {md.get('remap_pgs', 0)}",
                "# TYPE ceph_osdmap_remap_full_sweeps counter",
                f"ceph_osdmap_remap_full_sweeps "
                f"{md.get('remap_full_sweeps', 0)}",
                "# TYPE ceph_osdmap_remap_sharded_sweeps counter",
                f"ceph_osdmap_remap_sharded_sweeps "
                f"{md.get('remap_sharded_sweeps', 0)}",
            ]
        # mgr plane + progress: active/standby depth and
        # the in-flight long-running-operation events
        mgrm = status.get("mgrmap", {})
        prog = status.get("progress", {})
        lines += [
            "# TYPE ceph_mgr_available gauge",
            f"ceph_mgr_available {int(bool(mgrm.get('available')))}",
            f"ceph_mgr_standby_count {len(mgrm.get('standbys', []))}",
            f"ceph_mgrmap_epoch {mgrm.get('epoch', 0)}",
            f"ceph_progress_events {len(prog.get('events', []))}",
        ]
        for ev in prog.get("events", []):
            if isinstance(ev, dict) and ev.get("id"):
                lines.append(
                    f'ceph_progress_fraction{{event="{ev["id"]}"}} '
                    f'{float(ev.get("fraction", 0.0)):.4f}')
        # self-driving tuner: mode, action counters, live
        # guardrail state — read from the sibling module so the rows
        # track the SAME loop the audit log records
        tuner = next((m for m in getattr(self.mgr, "modules", [])
                      if getattr(m, "NAME", "") == "tuner"), None)
        if tuner is not None:
            mode = str(self.mgr.config.get("mgr_tuner_mode",
                                           "observe"))
            gr = tuner.guardrails
            lines += [
                "# TYPE ceph_tuner_actions_committed counter",
                f'ceph_tuner_mode{{mode="{mode}"}} 1',
                f"ceph_tuner_ticks {tuner.ticks}",
                f"ceph_tuner_actions_committed "
                f"{tuner.actions_committed}",
                f"ceph_tuner_actions_reverted "
                f"{tuner.actions_reverted}",
                f"ceph_tuner_observations {tuner.observations}",
                f"ceph_tuner_proposals_deferred "
                f"{gr.deferred_total}",
                f"ceph_tuner_active_streaks {len(gr.streaks)}",
            ]
        # daemon perf counters; TYPE_HISTOGRAM counters render as real
        # le-bucketed _bucket/_sum/_count series, rendered from the
        # REPORTED state (daemon -> mgr MMgrReport sessions, labeled
        # ceph_daemon="osd.0") whenever any daemon has an open report
        # session — the process-local singleton
        # render survives ONLY as an explicit standalone/no-mgr
        # fallback (mgr_stats_singleton_fallback, and only when
        # nothing reports), because it silently breaks the moment
        # daemons live in other processes.
        from ceph_tpu_torch.utils.perf_counters import hist_cumulative
        hist_lines: list[str] = []

        def _perf_rows(label_key: str, label_val: str,
                       counters: dict, prefix: str = "") -> None:
            for key, val in counters.items():
                lab = f'{label_key}="{label_val}",' \
                      f'counter="{prefix}{key}"'
                if isinstance(val, (int, float)):
                    lines.append(f'ceph_perf{{{lab}}} {val}')
                elif isinstance(val, dict) and "log2_buckets" in val:
                    for le, cum in hist_cumulative(
                            val["log2_buckets"]):
                        hist_lines.append(
                            f'ceph_perf_hist_bucket{{{lab},'
                            f'le="{le:g}"}} {cum}')
                    hist_lines.extend([
                        f'ceph_perf_hist_bucket{{{lab},le="+Inf"}} '
                        f'{val["count"]}',
                        f'ceph_perf_hist_sum{{{lab}}} '
                        f'{val["sum"]:.9g}',
                        f'ceph_perf_hist_count{{{lab}}} '
                        f'{val["count"]}',
                    ])

        idx = getattr(self.mgr, "daemon_state", None)
        if idx is not None:
            # stale daemons unpin by TTL (a dead OSD stops reporting;
            # a live one's next report re-extends the window)
            idx.cull(float(self.mgr.config.get(
                "mgr_stats_stale_s", 10.0)))
        reported = idx.dump_all() if idx is not None else {}
        if reported:
            lines.append("# ceph_perf: from daemon report sessions")
            for daemon, loggers in reported.items():
                for logger, counters in loggers.items():
                    if logger in ("osd_ec_agg", "osd_ec_read_agg",
                                  "osd_ec_resident",
                                  "bluestore_sharedblob", "devmon",
                                  "device_runtime"):
                        # dedicated ceph_osd_ec_agg_* /
                        # ceph_osd_ec_read_agg_* /
                        # ceph_osd_ec_resident_* / ceph_device_*
                        # rows below — rendering them here too would
                        # double the family's cardinality every scrape
                        continue
                    # the daemon's own logger renders bare counter
                    # names; a shared/auxiliary logger is prefixed so
                    # two loggers' counters can never collide
                    _perf_rows("ceph_daemon", daemon, counters,
                               prefix="" if logger == daemon
                               else f"{logger}.")
            # per-OSD EC encode-aggregator rows: the
            # coalescing layer's batches/stripes/flush-trigger
            # counters plus the occupancy/wait long-run averages, as
            # dedicated ceph_osd_ec_agg_* series from the REPORTED
            # state (the aggregator's per-daemon counter family is
            # register=False — it only exists through report sessions)
            agg_rows: list[str] = []
            for daemon, loggers in sorted(reported.items()):
                agg = loggers.get("osd_ec_agg")
                if not agg:
                    continue
                for key, val in sorted(agg.items()):
                    if isinstance(val, dict) and "avgcount" in val:
                        val = (val["sum"] / val["avgcount"]
                               if val["avgcount"] else 0.0)
                    if isinstance(val, (int, float)):
                        agg_rows.append(
                            f'ceph_osd_ec_agg_{key}'
                            f'{{ceph_daemon="{daemon}"}} {val:.9g}')
            if agg_rows:
                lines.append("# ceph_osd_ec_agg_*: EC encode "
                             "aggregator (reported)")
                lines += agg_rows
            # per-OSD EC read-side rows: the decode/repair
            # aggregator and the hot-shard residency cache, same
            # report-session discipline as ceph_osd_ec_agg_* (both
            # families are register=False per-daemon)
            for fam, head in (("osd_ec_read_agg",
                               "# ceph_osd_ec_read_agg_*: EC "
                               "decode/repair aggregator (reported)"),
                              ("osd_ec_resident",
                               "# ceph_osd_ec_resident_*: hot-shard "
                               "residency cache (reported)"),
                              # the shared-blob clone plane
                              # (clones/refcount traffic per
                              # BlueStore-backed OSD)
                              ("bluestore_sharedblob",
                               "# ceph_bluestore_sharedblob_*: "
                               "shared-blob COW clone plane "
                               "(reported)")):
                fam_rows: list[str] = []
                for daemon, loggers in sorted(reported.items()):
                    cs = loggers.get(fam)
                    if not cs:
                        continue
                    for key, val in sorted(cs.items()):
                        if isinstance(val, dict) and "avgcount" in val:
                            val = (val["sum"] / val["avgcount"]
                                   if val["avgcount"] else 0.0)
                        if isinstance(val, (int, float)):
                            fam_rows.append(
                                f'ceph_{fam}_{key}'
                                f'{{ceph_daemon="{daemon}"}} '
                                f'{val:.9g}')
                if fam_rows:
                    lines.append(head)
                    lines += fam_rows
            # device-runtime plane: dedicated ceph_device_*
            # rows from the REPORTED state — per-daemon kernel-path
            # health (the `devmon` family) and the process monitor's
            # compile/transfer side (`device_runtime`). Built from
            # report sessions, NOT the process singleton: the rows
            # must survive daemons living in other processes.
            dev_rows: list[str] = []
            for daemon, loggers in sorted(reported.items()):
                dd = loggers.get("devmon") or {}
                dp = loggers.get("device_runtime") or {}
                if not dd and not dp:
                    continue
                lab = f'ceph_daemon="{daemon}"'

                def _num(src, key):
                    v = src.get(key)
                    return v if isinstance(v, (int, float)) else 0
                dev_rows += [
                    f'ceph_device_path_checks_total{{{lab}}} '
                    f'{_num(dd, "path_checks")}',
                    f'ceph_device_path_mismatch_total{{{lab}}} '
                    f'{_num(dd, "path_mismatch")}',
                ]
                for p in ("kernel", "vm", "scalar"):
                    dev_rows.append(
                        f'ceph_device_launches_total{{{lab},'
                        f'path="{p}"}} {_num(dd, f"launches_{p}")}')
                dev_rows += [
                    f'ceph_device_jit_compiles_total{{{lab}}} '
                    f'{_num(dp, "jit_compiles")}',
                    f'ceph_device_jit_compile_seconds_total{{{lab}}} '
                    f'{_num(dp, "jit_compile_seconds"):.9g}',
                    f'ceph_device_h2d_bytes_total{{{lab}}} '
                    f'{_num(dp, "h2d_bytes")}',
                    f'ceph_device_d2h_bytes_total{{{lab}}} '
                    f'{_num(dp, "d2h_bytes")}',
                    f'ceph_device_mem_watermark_bytes{{{lab}}} '
                    f'{_num(dp, "device_bytes_watermark")}',
                ]
                # quarantine plane: one gauge per phase
                # from the process monitor's state machine, plus the
                # EC degrade ladder's client-saving fallback count
                for ph, key in (("quarantined", "quarantined_now"),
                                ("reprobing", "reprobing_now"),
                                ("permanent",
                                 "quarantine_permanent_now")):
                    dev_rows.append(
                        f'ceph_device_quarantine{{{lab},'
                        f'phase="{ph}"}} {_num(dp, key)}')
                da = loggers.get("osd_ec_agg") or {}
                if da:
                    dev_rows.append(
                        f'ceph_osd_ec_fallback_ops_total{{{lab}}} '
                        f'{_num(da, "fallback_ops")}')
            if dev_rows:
                lines.append("# ceph_device_*: device-runtime "
                             "observability (reported)")
                lines += dev_rows
            # per-OSD commit/apply latency from the reported
            # objectstore time-avgs (the `ceph osd perf` table)
            perf_digest = self.mgr.osd_perf_digest() if hasattr(
                self.mgr, "osd_perf_digest") else {}
            if perf_digest:
                lines.append(
                    "# TYPE ceph_osd_commit_latency_ms gauge")
                for osd, row in sorted(perf_digest.items()):
                    lines += [
                        f'ceph_osd_commit_latency_ms{{ceph_daemon='
                        f'"osd.{osd}"}} {row["commit_latency_ms"]}',
                        f'ceph_osd_apply_latency_ms{{ceph_daemon='
                        f'"osd.{osd}"}} {row["apply_latency_ms"]}',
                    ]
        elif self.mgr.config.get("mgr_stats_singleton_fallback", True):
            for name, counters in PerfCountersCollection.instance() \
                    .dump().items():
                _perf_rows("daemon", name, counters)
        if hist_lines:
            lines.append("# TYPE ceph_perf_hist histogram")
            lines += hist_lines
        return "\n".join(lines) + "\n"

    async def _serve_client(self, reader, writer) -> None:
        try:
            request = await asyncio.wait_for(reader.readline(),
                                             timeout=2.0)
            while True:
                line = await asyncio.wait_for(reader.readline(),
                                              timeout=2.0)
                if line in (b"\r\n", b"\n", b""):
                    break
            body = self._latest if b"/metrics" in request else \
                "ceph_tpu mgr prometheus exporter\n"
            payload = body.encode()
            writer.write(
                b"HTTP/1.1 200 OK\r\n"
                b"Content-Type: text/plain; version=0.0.4\r\n"
                b"Content-Length: " + str(len(payload)).encode() +
                b"\r\n\r\n" + payload)
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionError, OSError):
            pass
        finally:
            writer.close()

    async def close(self) -> None:
        if self._server:
            self._server.close()


class TracingModule(MgrModule):
    """Distributed-trace aggregation (ref: the mgr's role as
    the cluster's observability sink — upstream ships spans to Jaeger,
    here they pool at the mon and the mgr reassembles). Each tick
    pulls the mon's span feed incrementally (`trace dump` with a
    ``since`` cursor) and folds it into a TraceIndex keyed by
    trace_id; ``trace_ls()`` serves slowest-traces-first and
    ``trace_show(id)`` the span tree + per-phase latency breakdown —
    the same views `ceph trace ls/show` serve mon-side, but surviving
    here across mon leader changes (the cursor self-heals when a new
    leader's pool restarts at 0)."""

    NAME = "tracing"
    # modest default pull cadence (override per-cluster with
    # mgr_tracing_interval — tests run it at 0.25 s); traces are a
    # debugging surface, not a control loop
    TICK_INTERVAL = 1.0

    def __init__(self, mgr):
        super().__init__(mgr)
        from ceph_tpu_torch.utils.tracing import TraceIndex
        self.index = TraceIndex(max_traces=mgr.config.get(
            "mgr_tracing_max_traces", 512))
        self._since = 0
        self._gen = 0            # serving pool's generation token
        self.spans_ingested = 0
        self.asok = None
        self._own_asok = False

    def _register_asok(self) -> None:
        def _safe_int(v, default=0):
            try:
                return int(v)
            except (TypeError, ValueError):
                return default
        self.asok.register(
            "trace ls",
            lambda cmd: {"traces": self.trace_ls(
                _safe_int(cmd.get("limit", 20), 20))},
            "reassembled traces, slowest first")
        self.asok.register(
            "trace show",
            lambda cmd: self.trace_show(
                _safe_int(cmd.get("trace_id", 0))) or
            {"error": "no such trace"},
            "one trace: span tree + per-phase latency breakdown")
        self.asok.register(
            "trace status",
            lambda: {"traces": len(self.index.traces),
                     "spans_ingested": self.spans_ingested,
                     "since": self._since},
            "tracing module ingest cursor + index size")

    async def tick(self) -> None:
        if self.asok is None:
            # the Mgr owns the per-mgr admin socket (the
            # daemon-stats verbs live there); the module registers its
            # trace verbs on it rather than binding the same path a
            # second time (which would silently orphan the first
            # server). Creating an own socket survives only for
            # module-without-Mgr harnesses.
            mgr_asok = getattr(self.mgr, "asok", None)
            if mgr_asok is not None:
                self.asok = mgr_asok
                self._own_asok = False
                self._register_asok()
            elif self.mgr.config.get("admin_socket_dir"):
                from ceph_tpu_torch.utils.admin_socket import AdminSocket
                self.asok = AdminSocket(
                    f"{self.mgr.config['admin_socket_dir']}/"
                    f"mgr.{self.mgr.name}.asok")
                self._own_asok = True
                self._register_asok()
                await self.asok.start()
        ret, _, out = await self.mon_command(
            {"prefix": "trace dump", "since": self._since})
        if ret != 0:
            return
        import json as _json
        try:
            data = _json.loads(out)
        except _json.JSONDecodeError:
            return
        gen = int(data.get("gen", 0))
        if gen != self._gen:
            # mon leader changed (fresh pool, fresh generation token):
            # seq comparison alone misses the case where the new pool
            # already caught up past our cursor. A response pulled
            # with since=0 is complete regardless of generation —
            # adopt and ingest it; anything else was filtered by a
            # stale cursor, so drop it and re-pull next tick.
            self._gen = gen
            if self._since != 0:
                self._since = 0
                return
        self._since = int(data.get("seq", 0))
        for span in data.get("spans", []):
            self.index.add(span)
            self.spans_ingested += 1

    # -- views (the `ceph trace ls/show` payloads) ---------------------
    def trace_ls(self, limit: int = 20) -> list[dict]:
        return self.index.ls(limit=limit)

    def trace_show(self, trace_id: int) -> dict | None:
        return self.index.show(trace_id)

    async def close(self) -> None:
        if self.asok is not None and self._own_asok:
            await self.asok.stop()


class RestModule(MgrModule):
    """Minimal read-only HTTP status endpoint (the cheap half of the
    mgr dashboard gap — ref: src/pybind/mgr/dashboard, scoped to two
    read-only JSON routes; no auth, bind-local only):

        GET /status  -> the full `ceph status` JSON
        GET /health  -> just the health block

    Serves a per-tick cached snapshot so a scrape storm cannot amplify
    into mon command load."""

    NAME = "rest"
    TICK_INTERVAL = 1.0

    def __init__(self, mgr):
        super().__init__(mgr)
        self._server: asyncio.AbstractServer | None = None
        self.port: int | None = None
        self._status: dict = {}

    async def tick(self) -> None:
        if self._server is None:
            self._server = await asyncio.start_server(
                self._serve_client, "127.0.0.1",
                self.mgr.config.get("mgr_rest_port", 0))
            self.port = self._server.sockets[0].getsockname()[1]
            log.dout(1, f"rest endpoint on :{self.port}")
        self._status = await self.get("status")

    async def _serve_client(self, reader, writer) -> None:
        import json as _json
        try:
            request = await asyncio.wait_for(reader.readline(),
                                             timeout=2.0)
            while True:
                line = await asyncio.wait_for(reader.readline(),
                                              timeout=2.0)
                if line in (b"\r\n", b"\n", b""):
                    break
            path = request.split(b" ")[1] if request.count(b" ") >= 2 \
                else b"/"
            code, body = b"200 OK", None
            if path == b"/status":
                body = self._status
            elif path == b"/health":
                body = self._status.get("health", {})
            else:
                code = b"404 Not Found"
                body = {"error": "unknown route",
                        "routes": ["/status", "/health"]}
            payload = _json.dumps(body).encode()
            writer.write(
                b"HTTP/1.1 " + code + b"\r\n"
                b"Content-Type: application/json\r\n"
                b"Content-Length: " + str(len(payload)).encode() +
                b"\r\n\r\n" + payload)
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionError, OSError,
                IndexError):
            pass
        finally:
            writer.close()

    async def close(self) -> None:
        if self._server:
            self._server.close()


class ProgressModule(MgrModule):
    """Progress events for long-running operations (ref:
    src/pybind/mgr/progress/module.py): derives completion fractions
    from pg_dump deltas and surfaces them in `ceph status`'s
    ``progress`` block and `ceph progress ls/json`.

    Event sources:

    - **backfill**: every PG observed in a backfill state joins the
      event's pg set; a member's in-flight fraction is its pushed
      count against the primary's object count (capped below 1 — the
      ``last_backfill`` watermark only says *done* when the state
      clears), a member that left the backfill states counts 1.0.
    - **recovery** (degraded-PG drain): same set discipline over
      degraded/undersized states, binary per-PG (the dump carries no
      missing-object counts).
    - **merge readiness**: per-pool ``ready/sources`` straight from
      the mon's pending_merges barrier.
    - **subtree migration**: one explicit event per in-flight FSMap
      migration (completes when the authority flip commits).

    An event whose members all completed moves to a bounded
    ``completed`` ring at fraction 1.0 — `progress ls` clears on
    settle, `progress json` keeps the recent history. Each tick the
    module DIGESTS its event table (plus the per-OSD commit/apply
    latency table from the DaemonStateIndex) monward via MMgrDigest,
    so the mon serves all of it without holding counter state; the
    full-table re-send is what makes a mon leader change self-heal on
    the next tick."""

    NAME = "progress"
    TICK_INTERVAL = 1.0

    # per-PG in-flight progress never reports complete off pushed
    # counts alone — only the state clearing does
    MAX_INFLIGHT_FRACTION = 0.95

    def __init__(self, mgr):
        super().__init__(mgr)
        import collections
        self.events: dict[str, dict] = {}
        self.completed = collections.deque(maxlen=int(
            mgr.config.get("mgr_progress_max_events", 64)))
        self.digests_sent = 0

    async def tick(self) -> None:
        status = await self.get("status")
        pg_dump = await self.get("pg_dump")
        import time as _time
        self._derive(status, pg_dump, _time.time())
        await self._send_digest()

    # -- event derivation --------------------------------------------------
    def _ev(self, key: str, message: str, now: float) -> dict:
        ev = self.events.get(key)
        if ev is None:
            ev = self.events[key] = {
                "id": key, "message": message, "fraction": 0.0,
                "started": now, "updated": now, "_pgs": {}}
        ev["message"] = message
        ev["updated"] = now
        return ev

    def _complete(self, key: str, now: float) -> None:
        ev = self.events.pop(key, None)
        if ev is None:
            return
        ev["fraction"] = 1.0
        ev["updated"] = now
        ev.pop("_pgs", None)
        ev["completed_at"] = now
        self.completed.append(ev)

    def _derive(self, status: dict, pg_dump: dict, now: float) -> None:
        stats = pg_dump.get("pg_stats", {}) or {}
        # -- backfill: pg-set event with watermark-informed fractions
        cur_bf = {pgid: st for pgid, st in stats.items()
                  if "backfill" in st.get("state", "")}
        self._pg_set_event(
            "backfill", cur_bf, stats, now,
            lambda st: min(
                self.MAX_INFLIGHT_FRACTION,
                st.get("backfill", {}).get("pushed", 0) /
                max(st.get("num_objects", 0), 1)),
            lambda n: f"Backfilling {n} pg(s)")
        # -- recovery: degraded-pg drain (binary per member)
        cur_deg = {pgid: st for pgid, st in stats.items()
                   if any(tok in st.get("state", "") for tok in
                          ("degraded", "undersized", "down"))}
        self._pg_set_event(
            "recovery", cur_deg, stats, now, lambda st: 0.0,
            lambda n: f"Recovering {n} degraded pg(s)")
        # -- merges: the readiness barrier is the fraction
        merges = status.get("osdmap", {}).get("pending_merges", {})
        for pool, v in merges.items():
            key = f"merge:{pool}"
            ev = self._ev(key, f"Merging pool '{pool}' pg_num "
                               f"{v.get('from')} -> {v.get('to')}", now)
            ev["fraction"] = round(
                v.get("ready", 0) / max(v.get("sources", 1), 1), 4)
        for key in [k for k in self.events
                    if k.startswith("merge:") and
                    k.split(":", 1)[1] not in merges]:
            self._complete(key, now)
        # -- subtree migrations: explicit events, done on the flip
        migrating = {f"migrate:{m['path']}": m
                     for m in status.get("fsmap", {})
                     .get("migrations", []) if isinstance(m, dict)}
        for key, m in migrating.items():
            self._ev(key, f"Migrating subtree {m['path']} rank "
                          f"{m.get('from')} -> {m.get('to')}", now)
        for key in [k for k in self.events
                    if k.startswith("migrate:") and
                    k not in migrating]:
            self._complete(key, now)

    def _pg_set_event(self, key: str, current: dict, stats: dict,
                      now: float, inflight_fraction,
                      message) -> None:
        """Shared pg-set discipline: members accumulate while the
        condition holds anywhere; fraction = mean member progress
        (1.0 for members whose condition cleared); the event completes
        when every member cleared."""
        ev = self.events.get(key)
        if not current and ev is None:
            return
        if ev is None:
            ev = self._ev(key, message(len(current)), now)
        ev["_pgs"].update({pgid: True for pgid in current})
        if not current:
            self._complete(key, now)
            return
        ev["message"] = message(len(current))
        ev["updated"] = now
        done = 0.0
        for pgid in ev["_pgs"]:
            st = current.get(pgid)
            if st is None:
                done += 1.0                  # condition cleared
            else:
                done += max(0.0, min(self.MAX_INFLIGHT_FRACTION,
                                     float(inflight_fraction(st))))
        ev["fraction"] = round(done / max(len(ev["_pgs"]), 1), 4)

    # -- the monward digest ------------------------------------------------
    def _public_events(self) -> list[dict]:
        return [{k: v for k, v in ev.items() if not k.startswith("_")}
                for ev in self.events.values()]

    async def _send_digest(self) -> None:
        import json as _json
        from ceph_tpu_torch.mon.messages import MMgrDigest
        perf = {}
        if hasattr(self.mgr, "osd_perf_digest"):
            perf = self.mgr.osd_perf_digest()
        await self.mgr.monc.send_report(MMgrDigest(
            name=self.mgr.name, gid=getattr(self.mgr, "gid", 0),
            progress=_json.dumps(
                {"events": self._public_events(),
                 "completed": list(self.completed)}).encode(),
            osd_perf=_json.dumps(perf).encode()))
        self.digests_sent += 1
