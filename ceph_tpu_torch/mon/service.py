"""PaxosService base + ConfigMonitor + HealthMonitor.

ref: src/mon/PaxosService.{h,cc} — a service keeps its state under a
store prefix, stages changes as store transactions proposed through
paxos, and refreshes its in-memory view after every commit.
ConfigMonitor ref: src/mon/ConfigMonitor.cc (the `ceph config ...`
central config db with who-masks). HealthMonitor ref:
src/mon/HealthMonitor.cc + health checks in OSDMonitor.

The port's copy of ``ceph_tpu/mon/service.py``.
"""

from __future__ import annotations

import json


class PaxosService:
    prefix = "svc"

    def __init__(self, mon) -> None:
        self.mon = mon
        self.store = mon.store

    def refresh(self) -> None:
        """Reload in-memory state after a paxos commit."""

    async def on_active(self) -> None:
        """Leader became active (post-collect)."""

    async def tick(self) -> None:
        """Periodic leader work."""

    async def handle_command(self, cmd: dict,
                             inbl: bytes = b"") -> tuple[int, str, bytes]:
        return -22, "unknown command", b""


class ConfigMonitor(PaxosService):
    """Central config db (ref: src/mon/ConfigMonitor.cc): `config set
    <who> <name> <value>` with who = global | <type> | <type>.<id>;
    resolution walks most-specific first, like the reference's masks.

    Round 18: the db is VERSIONED (a ``__version`` store key bumped in
    the same txn as every mutation) and published over the `config`
    subscription as an MConfigMap, so daemons in other processes —
    which cannot see the in-process shared dict — apply live knob
    flips identically (proc backend's missing ConfigMonitor analog)."""

    prefix = "config"
    VERSION_KEY = "__version"

    def __init__(self, mon) -> None:
        super().__init__(mon)
        self.version = 0
        self.cfg_map: dict[str, dict[str, str]] = {}
        self._apply_state: dict = {}
        # pre-push baselines for handle_command's direct live pushes,
        # separate from _apply_state: refresh() resolves only the
        # mon's own entity, so an osd-scoped push tracked there would
        # be "restored" (undone) on the very next refresh
        self._push_baseline: dict = {}
        self._mutate_lock = None   # lazy: created on first mutation

    def refresh(self) -> None:
        v = self.store.get(self.prefix, self.VERSION_KEY)
        self.version = int(v.decode()) if v else 0
        m: dict[str, dict[str, str]] = {}
        for k, val in self.store.iterate(self.prefix):
            if k == self.VERSION_KEY:
                continue
            who, _, name = k.partition("/")
            if name:
                m.setdefault(who, {})[name] = val.decode()
        self.cfg_map = m
        # every mon applies its own entity's resolution into its live
        # config — private per process on the proc backend, the shared
        # cluster dict (idempotent re-apply) in-process
        from ceph_tpu_torch.utils.config import apply_mon_config
        apply_mon_config(f"mon.{self.mon.name}", m, self.mon.config,
                         self._apply_state)

    def encode_map(self) -> bytes:
        import json as _json
        return _json.dumps(self.cfg_map, sort_keys=True).encode()

    async def _mutate(self, build) -> bool:
        """Serialize mutations so the version bump is strictly
        monotonic even when commands interleave across awaits."""
        import asyncio
        if self._mutate_lock is None:
            self._mutate_lock = asyncio.Lock()
        async with self._mutate_lock:
            t = self.store.transaction()
            build(t)
            t.set(self.prefix, self.VERSION_KEY,
                  str(self.version + 1).encode())
            return await self.mon.propose_txn(t)

    async def handle_command(self, cmd, inbl=b""):
        prefix = cmd.get("prefix", "")
        if prefix == "config set":
            who, name = cmd["who"], cmd["name"]
            # registered Options are validated up front and, once the
            # proposal commits, pushed into the LIVE config (round 17:
            # the tuner's recovery governor flips osd_recovery_* at
            # runtime through this path — daemons reading knobs live
            # off the shared config follow without a restart)
            live = _MISSING = object()
            from ceph_tpu_torch.utils.config import OPTIONS
            opt = OPTIONS.get(name)
            if opt is not None:
                try:
                    live = opt.validate(cmd["value"])
                except ValueError as e:
                    return -22, str(e), b""
            elif self.mon.config.get("mon_config_strict", False):
                return -22, f"unregistered option {name!r} " \
                            f"(mon_config_strict)", b""
            ok = await self._mutate(lambda t: t.set(
                self.prefix, f"{who}/{name}",
                str(cmd["value"]).encode()))
            if ok and live is not _MISSING:
                # remember what we are about to clobber (once, and only
                # when this push actually changes the value — refresh()
                # or a shared-dict daemon may have applied it already)
                cur = self.mon.config.get(name, _MISSING)
                if name not in self._push_baseline and cur != live:
                    self._push_baseline[name] = \
                        (name in self.mon.config, cur)
                self.mon.config[name] = live
            return (0, f"set {who}/{name}", b"") if ok else \
                (-11, "proposal failed", b"")
        if prefix == "config rm":
            who, name = cmd["who"], cmd["name"]
            ok = await self._mutate(
                lambda t: t.rmkey(self.prefix, f"{who}/{name}"))
            if ok and not any(
                    k.partition("/")[2] == name
                    for k, _ in self.store.iterate(self.prefix)) \
                    and name in self._push_baseline:
                # the name left EVERY scope: undo our live push so the
                # daemon-side restores aren't fighting a stuck override
                had, old = self._push_baseline.pop(name)
                if had:
                    self.mon.config[name] = old
                else:
                    self.mon.config.pop(name, None)
            return (0, "", b"") if ok else (-11, "proposal failed", b"")
        if prefix == "config get":
            who = cmd["who"]
            name = cmd.get("name")
            if name:
                v = self.resolve(who, name)
                if v is None:
                    return -2, f"no config {who}/{name}", b""   # -ENOENT
                return 0, "", v
            out = {k: v.decode() for k, v in self.store.iterate(
                self.prefix) if k.startswith(f"{who}/")}
            return 0, "", json.dumps(out).encode()
        if prefix == "config dump":
            out = {k: v.decode()
                   for k, v in self.store.iterate(self.prefix)
                   if k != self.VERSION_KEY}
            out["__version"] = str(self.version)
            return 0, "", json.dumps(out).encode()
        return -22, f"unknown command {prefix!r}", b""

    def resolve(self, who: str, name: str) -> bytes | None:
        """Most-specific wins: <type>.<id> > <type> > global
        (ref: ConfigMonitor mask resolution)."""
        for scope in (who, who.split(".", 1)[0], "global"):
            v = self.store.get(self.prefix, f"{scope}/{name}")
            if v is not None:
                return v
        return None


class HealthMonitor(PaxosService):
    """Aggregated health checks (ref: src/mon/HealthMonitor.cc +
    OSDMap::check_health): OSD_DOWN, OSD_OUT, PG_DEGRADED, MON_DOWN."""

    prefix = "health"

    def checks(self) -> dict:
        import numpy as np
        checks: dict[str, dict] = {}
        mon = self.mon
        if len(mon.quorum) < len(mon.monmap.ranks()):
            missing = sorted(set(mon.monmap.ranks()) - set(mon.quorum))
            checks["MON_DOWN"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(missing)} monitors down: {missing}"}
        # merge barrier visibility (round 6): a pool mid-merge is a
        # deliberate degradation — new ops to source PGs park until
        # the decrease commits
        pending = mon.osdmon.pending_merges() \
            if hasattr(mon.osdmon, "pending_merges") else {}
        if pending:
            checks["PG_MERGE_PENDING"] = {
                "severity": "HEALTH_WARN",
                "summary": "; ".join(
                    f"pool '{name}' merging pg_num {v['from']} -> "
                    f"{v['to']} ({v['ready']}/{v['sources']} sources "
                    f"ready)" for name, v in sorted(pending.items()))}
        # recently revoked keys (round 6): surfaces that sessions were
        # fenced — clears after mon_auth_revoke_warn_s so the log, not
        # health, is the permanent record
        authmon = getattr(mon, "authmon", None)
        if authmon is not None and authmon.revoked:
            import time
            window = getattr(mon, "config", {}) \
                .get("mon_auth_revoke_warn_s", 300.0)
            now = time.time()
            recent = sorted(
                n for n, at in authmon.revoked.items()
                if n not in authmon.keys and now - at < window)
            if recent:
                checks["AUTH_KEY_REVOKED"] = {
                    "severity": "HEALTH_WARN",
                    "summary": f"key(s) {recent} revoked recently: "
                               f"their sessions were fenced and new "
                               f"handshakes are refused"}
        om = mon.osdmon.osdmap
        if om is not None:
            from ceph_tpu_torch.osd.osdmap import (
                STATE_EXISTS, STATE_FULL, STATE_NEARFULL, STATE_UP,
                flag_names,
            )
            exists = (om.osd_state & STATE_EXISTS) != 0
            down = exists & ((om.osd_state & STATE_UP) == 0)
            if down.any():
                checks["OSD_DOWN"] = {
                    "severity": "HEALTH_WARN",
                    "summary": f"{int(down.sum())} osds down"}
            # fullness (ref: OSDMap::check_health OSD_NEARFULL /
            # OSD_FULL): FULL is an ERR — client writes are parked
            full = exists & ((om.osd_state & STATE_FULL) != 0)
            near = exists & ((om.osd_state & STATE_NEARFULL) != 0)
            if full.any():
                checks["OSD_FULL"] = {
                    "severity": "HEALTH_ERR",
                    "summary": f"{int(full.sum())} full osd(s): "
                               f"{np.flatnonzero(full).tolist()}"}
            if near.any():
                checks["OSD_NEARFULL"] = {
                    "severity": "HEALTH_WARN",
                    "summary": f"{int(near.sum())} nearfull osd(s): "
                               f"{np.flatnonzero(near).tolist()}"}
            quota_full = [p.name for p in om.pools.values()
                          if p.is_full()]
            if quota_full:
                checks["POOL_QUOTA_FULL"] = {
                    "severity": "HEALTH_WARN",
                    "summary": f"pool(s) {quota_full} reached quota "
                               f"or are marked full: writes park "
                               f"(-EDQUOT with FULL_TRY)"}
            if om.flags:
                # ref: the OSDMAP_FLAGS health check — any service
                # flag changes client/mon behavior; surface it
                checks["OSDMAP_FLAGS"] = {
                    "severity": "HEALTH_WARN",
                    "summary": f"{flag_names(om.flags)} flag(s) set"}
        if om is not None and om.crush.choose_args:
            # choose_args discipline (ref: the TPU mapper's fused
            # kernel carrying <= 4 weight classes per bucket): a
            # continuous weight-set silently drops every mapping onto
            # the ~35x-slower general path — surface it instead
            from ceph_tpu_torch.crush.builder import (
                KERNEL_WEIGHT_CLASSES, choose_args_weight_classes,
            )
            worst = choose_args_weight_classes(om.crush)
            if worst > KERNEL_WEIGHT_CLASSES:
                checks["CRUSH_CHOOSE_ARGS_CONTINUOUS"] = {
                    "severity": "HEALTH_WARN",
                    "summary": (
                        f"crush choose_args carry {worst} distinct "
                        f"weights per bucket (> "
                        f"{KERNEL_WEIGHT_CLASSES}): placement runs on "
                        f"the slow general path; quantize the "
                        f"weight-sets (crush.builder."
                        f"quantize_choose_args)")}
        # MDS cluster health (ref: MDSMonitor::insert_health_checks —
        # MDS_ALL_DOWN / MDS_INSUFFICIENT_STANDBY / FS_DEGRADED).
        # Only once a filesystem exists (a daemon ever registered or a
        # rank failed) so non-cephfs clusters stay HEALTH_OK. getattr:
        # unit tests drive this monitor with stub mons that carry only
        # the osd side.
        mdsmon = getattr(mon, "mdsmon", None)
        fm = mdsmon.fsmap if mdsmon is not None else None
        if fm is not None and (fm.infos or fm.failed):
            holders = fm.rank_holders()
            standbys = len(fm.standbys())
            laddering = [i for i in holders.values()
                         if i.state != "active"]
            if not holders and fm.failed:
                # every rank is down (multi-rank: ALL of them)
                if standbys == 0:
                    checks["MDS_ALL_DOWN"] = {
                        "severity": "HEALTH_ERR",
                        "summary": f"rank(s) {sorted(fm.failed)} "
                                   f"failed and no standby is "
                                   f"available: filesystem offline"}
                else:
                    checks["FS_DEGRADED"] = {
                        "severity": "HEALTH_WARN",
                        "summary": f"rank(s) {sorted(fm.failed)} "
                                   f"failed; standby promotion in "
                                   f"progress"}
            elif fm.failed or laddering:
                # some (not all) ranks failed or mid-ladder: the
                # filesystem serves degraded — only the affected
                # subtrees park
                parts = []
                if fm.failed:
                    parts.append(f"rank(s) {sorted(fm.failed)} failed")
                for i in laddering:
                    parts.append(f"mds.{i.name} (rank {i.rank}) is "
                                 f"laddering ({i.state})")
                checks["FS_DEGRADED"] = {
                    "severity": "HEALTH_WARN",
                    "summary": "; ".join(parts) + "; affected "
                               "subtrees' I/O parked"}
            wanted = getattr(mon, "config", {}) \
                .get("mds_standby_count_wanted", 1)
            all_active = holders and not laddering and not fm.failed \
                and len(holders) >= fm.max_mds
            if all_active and standbys < wanted:
                checks["MDS_INSUFFICIENT_STANDBY"] = {
                    "severity": "HEALTH_WARN",
                    "summary": f"have {standbys} standby(s), want "
                               f"{wanted}: a failed active has no "
                               f"successor"}
            if fm.migrations:
                checks["MDS_SUBTREE_MIGRATING"] = {
                    "severity": "HEALTH_WARN",
                    "summary": "; ".join(
                        f"subtree {m['path']} migrating rank "
                        f"{m['from']} -> {m['to']} (frozen until the "
                        f"handoff commits)" for m in fm.migrations)}
        pg = mon.osdmon.pg_summary()
        if pg.get("degraded_pgs"):
            checks["PG_DEGRADED"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{pg['degraded_pgs']} pgs degraded"}
        if pg.get("backfilling_pgs"):
            prog = pg.get("backfill_progress", {})
            checks["PG_BACKFILLING"] = {
                "severity": "HEALTH_WARN",
                "summary": (
                    f"{pg['backfilling_pgs']} pgs backfilling "
                    f"({prog.get('pushed', 0)} objects pushed, "
                    f"{prog.get('scanned', 0)} scanned)")}
        # device-runtime health (round 14): a daemon whose CRUSH
        # sweeps keep running off the expected kernel engine serves
        # ~34x slower — the mismatch-rate debounce in the OSDMonitor's
        # device_health ingest confirms/clears it (OSD_SLOW
        # discipline), this check only surfaces the verdict
        degraded = getattr(mon.osdmon, "degraded_kernel_paths", {})
        if degraded:
            rows = ", ".join(
                f"osd.{o} (mismatch ratio {v.get('ratio', 0)}, "
                f"engine {v.get('engine', '?')}"
                + (f", {v['phase']}" if v.get("phase") else "") + ")"
                for o, v in sorted(degraded.items()))
            checks["KERNEL_PATH_DEGRADED"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(degraded)} daemon(s) serving the "
                           f"CRUSH hot path off the expected kernel "
                           f"engine: {rows} — see `ceph "
                           f"device-runtime status`"}
        # recent daemon crashes (round 14): a top-level loop died with
        # a real exception; warns until `ceph crash archive <id>` acks
        crashes = getattr(mon, "crashes", {})
        fresh = [c for c in crashes.values()
                 if not c.get("archived")]
        if fresh:
            names = sorted({c.get("daemon", "?") for c in fresh})
            checks["RECENT_CRASH"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(fresh)} recent daemon crash(es) "
                           f"from {names} — `ceph crash ls` / "
                           f"`ceph crash archive <id>` to ack"}
        slow = mon.osdmon.osd_slow_ops
        if slow:
            total = sum(slow.values())
            osds = ", ".join(f"osd.{o}" for o in sorted(slow))
            checks["SLOW_OPS"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{total} slow ops, daemons [{osds}] have "
                           f"slow ops (ref: OpTracker complaint time)"}
        # gray failure (round 11): slow-but-alive OSDs — detected from
        # fleet heartbeat-RTT scores, a different animal than SLOW_OPS
        # (which needs ops to already be stuck behind the slow disk)
        slow_osds = getattr(mon.osdmon, "slow_osds", {})
        if slow_osds:
            rows = ", ".join(
                f"osd.{t} (score {v.get('score', 0)}, "
                f"{v.get('latency_ms', 0)} ms)"
                for t, v in sorted(slow_osds.items()))
            checks["OSD_SLOW"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(slow_osds)} osd(s) responding "
                           f"slowly: {rows} — see `ceph osd slow ls`"}
        status = "HEALTH_OK" if not checks else "HEALTH_WARN"
        return {"status": status, "checks": checks}
