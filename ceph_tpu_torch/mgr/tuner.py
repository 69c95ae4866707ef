"""Self-driving tuner: closed-loop telemetry -> guardrailed actuation.

ref: the mgr's role as the cluster's control-loop host (balancer,
pg_autoscaler) extended to QoS/recovery knobs — the loop upstream
operators close by hand from Grafana. The TunerModule runs on the
ACTIVE mgr only (it's a default module, so failover carries it to the
promoted standby), and every tick evaluates four declarative policies
against REPORTED state:

- **recovery governor** — scales ``osd_recovery_max_active`` /
  ``osd_recovery_max_bytes`` up while pending backfill has client-p99
  headroom under the QoS floor, halves them when the floor breaches,
  and reverts to the registered defaults once backfill drains.
- **hot-pool protector** — ranks pools by live client op rate (from
  the per-PG ``client_ops`` counters riding `pg dump`); a pool
  starving the others gets its top entity a tightened dmClock
  client-profile, removed again on heal.
- **gray-OSD responder** — commits primary-affinity dampening for
  confirmed-slow OSDs through `osd primary-affinity` (the operator
  command path, NOT the optional mon-side knob), and undampens when
  the slow verdict clears.
- **kernel-path watchdog** — an OSD whose kernel path is PERMANENTLY
  degraded (quarantine gave up re-probing) loses primary eligibility
  the same way until it heals.

Every policy is LEVEL-based: a tick computes desired state from the
sensors and diffs it against the ACTUAL cluster state (the committed
map, the live config, the mon's `tune status` ownership table), so a
promoted standby's tuner resumes without double-committing — if the
action already landed, desired == actual and nothing is proposed.

Actuation is guardrailed (class:`Guardrails`): per-proposal hysteresis
(``mgr_tuner_act_ticks`` consecutive breaching ticks to act,
``mgr_tuner_revert_ticks`` clean ticks to revert — a flapping sensor
commits nothing), a per-tick cluster-wide change budget whose excess
DEFERS to the next tick (streaks retained, nothing dropped), and the
``mgr_tuner_mode`` ladder: ``off`` evaluates nothing, ``observe``
(default) records would-be actions in the mon's audit ring via
`tune record` without committing, ``drive`` commits them with a
``provenance`` stamp (policy + sensor readings) the mon captures into
`ceph tune log`. In-flight act/revert pairs render as
``tuner:<key>`` events in `ceph progress ls`.

The port's copy of ``ceph_tpu/mgr/tuner.py``, on the port's
``mon/tune.py`` ownership table and ``utils.config.OPTIONS``. On the
card a kernel failure is counted and raised, never quarantined, so no
OSD on the card reports a permanently degraded kernel path and the
kernel-path watchdog proposes nothing there; it acts on what
``device-runtime status`` reports, as in the reference (a quarantine
that gave up, which only a CPU-side Mapper can reach).
"""

from __future__ import annotations

import json
import time

from ceph_tpu_torch.mgr.daemon import MgrModule
from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("mgr")


class Proposal:
    """One would-be actuator change: the command, why (sensors), and
    the hysteresis identity (policy, key, kind)."""

    __slots__ = ("policy", "key", "kind", "cmd", "sensors", "message")

    def __init__(self, policy: str, key: str, kind: str, cmd: dict,
                 sensors: dict, message: str):
        self.policy = policy
        self.key = key                    # actuator target, e.g. "affinity:2"
        self.kind = kind                  # "act" | "revert"
        self.cmd = cmd
        self.sensors = sensors
        self.message = message

    def ident(self) -> tuple:
        return (self.policy, self.key, self.kind)


class Guardrails:
    """The shared actuation gate: hysteresis streaks + per-tick
    budget. Pure bookkeeping over Proposal idents — unit-testable
    with virtual ticks, no cluster, no clock."""

    def __init__(self, config: dict):
        self.config = config
        # (policy, key, kind) -> consecutive ticks proposed
        self.streaks: dict[tuple, int] = {}
        self.deferred_total = 0

    def filter(self, proposals: list) -> tuple[list, list]:
        """One tick's gate: bump each proposal's streak (a tick that
        does NOT re-propose an ident resets it — that's the flap
        protection), keep the ones past their hysteresis threshold,
        then apply the change budget. Returns (granted, deferred);
        deferred proposals keep their streaks and re-qualify
        immediately next tick."""
        act_n = int(self.config.get("mgr_tuner_act_ticks", 3))
        revert_n = int(self.config.get("mgr_tuner_revert_ticks", 5))
        budget = int(self.config.get(
            "mgr_tuner_max_changes_per_tick", 2))
        seen = set()
        eligible = []
        for p in proposals:
            ident = p.ident()
            seen.add(ident)
            self.streaks[ident] = self.streaks.get(ident, 0) + 1
            need = act_n if p.kind == "act" else revert_n
            if self.streaks[ident] >= need:
                eligible.append(p)
        for ident in [i for i in self.streaks if i not in seen]:
            del self.streaks[ident]
        granted, deferred = eligible[:budget], eligible[budget:]
        self.deferred_total += len(deferred)
        return granted, deferred

    def settle(self, p) -> None:
        """A proposal was applied (committed in drive / recorded in
        observe): its streak restarts from zero — level-based
        policies stop proposing once actual == desired anyway, and in
        observe mode this is what keeps a sustained breach from
        flooding the audit ring every tick."""
        self.streaks.pop(p.ident(), None)


class TunerModule(MgrModule):
    """The closed-loop policy engine (active-mgr only, failover-safe:
    all durable state lives mon-side or in the committed map)."""

    NAME = "tuner"
    TICK_INTERVAL = 1.0

    def __init__(self, mgr):
        super().__init__(mgr)
        self.guardrails = Guardrails(mgr.config)
        # per-(pool|entity) cumulative op counts from the last tick's
        # pg dump — rates are deltas against these. Mgr-local on
        # purpose: a promoted standby's first tick just re-baselines.
        self._last_ops: dict | None = None
        self._last_ops_t = 0.0
        self.actions_committed = 0
        self.actions_reverted = 0
        self.observations = 0
        self.ticks = 0
        self.last_error = ""

    # -- the tick ----------------------------------------------------------
    async def tick(self) -> None:
        mode = str(self.mgr.config.get("mgr_tuner_mode", "observe"))
        if mode == "off":
            return
        self.ticks += 1
        now = time.time()
        status = await self.get("status")
        pg_dump = await self.get("pg_dump")
        osd_dump = await self.get("osd_dump")
        owned = await self._tune_owned()
        sensors = self._sense(status, pg_dump, osd_dump, now)
        proposals = []
        proposals += self._recovery_governor(sensors)
        proposals += self._hot_pool_protector(sensors, osd_dump,
                                              owned)
        proposals += self._gray_osd_responder(sensors, osd_dump,
                                              owned)
        proposals += await self._kernel_watchdog(sensors, osd_dump,
                                                 owned)
        # one writer per actuator target per tick: the responder's
        # verdict beats the watchdog's on a shared affinity key
        proposals = self._dedupe(proposals)
        granted, _deferred = self.guardrails.filter(proposals)
        for p in granted:
            await self._apply(p, mode, now)

    @staticmethod
    def _dedupe(proposals: list) -> list:
        out, taken = [], set()
        for p in proposals:
            tk = (p.key, p.kind)
            if tk in taken:
                continue
            taken.add(tk)
            out.append(p)
        return out

    async def _tune_owned(self) -> dict:
        """The mon's actuator-ownership table — what THIS control
        loop (possibly a predecessor incarnation, pre-failover)
        currently holds. Reverts are gated on it so the tuner never
        undoes an operator's explicit profile/affinity."""
        ret, _, out = await self.mon_command({"prefix": "tune status"})
        if ret != 0:
            return {}
        try:
            return json.loads(out).get("owned", {})
        except (json.JSONDecodeError, AttributeError):
            return {}

    # -- sensors -----------------------------------------------------------
    def _sense(self, status: dict, pg_dump: dict, osd_dump: dict,
               now: float) -> dict:
        om = status.get("osdmap", {})
        pgmap = status.get("pgmap", {})
        # client write p99 across reporting OSDs: the log2-bucket
        # upper bound from the reported op-latency histograms (µs)
        p99_ms = None
        idx = getattr(self.mgr, "daemon_state", None)
        if idx is not None:
            for name, st in idx.daemons.items():
                if not name.startswith("osd."):
                    continue
                v = st.percentile(name, "op_w_latency_hist", 0.99)
                if v is not None:
                    p99_ms = max(p99_ms or 0.0, v / 1e3)
        # per-pool / per-entity op rates from the pg-stats client_ops
        # counters: cumulative, so rates are per-tick deltas
        pool_tot: dict[int, int] = {}
        ent_tot: dict[str, int] = {}
        ent_pool: dict[str, dict[int, int]] = {}
        for pgid, st in (pg_dump.get("pg_stats", {}) or {}).items():
            cops = st.get("client_ops")
            if not isinstance(cops, dict):
                continue
            try:
                pid = int(str(pgid).split(".")[0])
            except ValueError:
                continue
            for ent, n in cops.items():
                n = int(n)
                pool_tot[pid] = pool_tot.get(pid, 0) + n
                ent_tot[ent] = ent_tot.get(ent, 0) + n
                by_pool = ent_pool.setdefault(ent, {})
                by_pool[pid] = by_pool.get(pid, 0) + n
        pool_rate: dict[int, float] = {}
        ent_rate: dict[str, float] = {}
        if self._last_ops is not None and now > self._last_ops_t:
            dt = now - self._last_ops_t
            last_pool, last_ent = self._last_ops
            for pid, n in pool_tot.items():
                d = n - last_pool.get(pid, 0)
                # a primary restart resets the counter: treat the
                # full count as this window's rather than negative
                pool_rate[pid] = max(d if d >= 0 else n, 0) / dt
            for ent, n in ent_tot.items():
                d = n - last_ent.get(ent, 0)
                ent_rate[ent] = max(d if d >= 0 else n, 0) / dt
        self._last_ops = (pool_tot, ent_tot)
        self._last_ops_t = now
        return {
            "p99_ms": p99_ms,
            "backfilling_pgs": int(pgmap.get("backfilling_pgs", 0)),
            "degraded_pgs": int(pgmap.get("degraded_pgs", 0)),
            "slow_osds": {int(k): float(v) for k, v in
                          (om.get("slow_osds", {}) or {}).items()},
            "pool_rate": pool_rate,
            "ent_rate": ent_rate,
            "pool_total": pool_tot,
            "ent_pool": ent_pool,
        }

    @staticmethod
    def _affinity_of(osd_dump: dict) -> dict[int, float]:
        return {int(o["osd"]): float(o.get("primary_affinity", 1.0))
                for o in osd_dump.get("osds", [])}

    # -- policy: recovery governor ----------------------------------------
    def _recovery_governor(self, s: dict) -> list:
        cfg = self.mgr.config
        from ceph_tpu_torch.utils.config import OPTIONS
        base_active = OPTIONS["osd_recovery_max_active"].default
        cur = int(cfg.get("osd_recovery_max_active", base_active))
        cap = int(cfg.get("mgr_tuner_recovery_max_active_cap", 32))
        floor = float(cfg.get("mgr_tuner_qos_floor_ms", 250.0))
        headroom = floor * float(cfg.get("mgr_tuner_headroom_frac",
                                         0.5))
        p99, bf = s["p99_ms"], s["backfilling_pgs"]
        sensors = {"p99_ms": round(p99, 3) if p99 is not None
                   else None, "backfilling_pgs": bf,
                   "recovery_max_active": cur}
        desired, kind, why = cur, "act", ""
        if p99 is not None and p99 > floor and cur > 1:
            # the QoS floor breached: shed recovery pressure NOW,
            # even below the configured baseline
            desired, why = max(1, cur // 2), \
                f"client p99 {p99:.0f}ms over the {floor:.0f}ms floor"
        elif bf > 0 and p99 is not None and p99 < headroom and \
                cur < cap:
            desired, why = min(cap, cur * 2), \
                f"{bf} backfilling pg(s) with p99 headroom " \
                f"({p99:.0f}ms < {headroom:.0f}ms)"
        elif bf == 0 and cur != base_active:
            desired, kind, why = base_active, "revert", \
                "backfill drained"
        if desired == cur:
            return []
        cmd = {"prefix": "config set", "who": "osd",
               "name": "osd_recovery_max_active",
               "value": str(desired)}
        return [Proposal(
            "recovery_governor", "recovery", kind, cmd, sensors,
            f"recovery_max_active {cur} -> {desired}: {why}")]

    # -- policy: hot-pool protector ---------------------------------------
    def _hot_pool_protector(self, s: dict, osd_dump: dict,
                            owned: dict) -> list:
        cfg = self.mgr.config
        ratio = float(cfg.get("mgr_tuner_hot_pool_ratio", 4.0))
        min_ops = float(cfg.get("mgr_tuner_hot_pool_min_ops", 50.0))
        profiles = osd_dump.get("client_profiles", {}) or {}
        rates = s["pool_rate"]
        hot_pid, hot_ent = None, None
        if rates:
            top = max(rates, key=rates.get)
            others = {p: r for p, r in rates.items() if p != top}
            # victims must exist: some OTHER pool has client activity
            other_pools = [p for p in s["pool_total"]
                           if p != top and s["pool_total"][p] > 0]
            second = max(others.values()) if others else 0.0
            if other_pools and rates[top] >= min_ops and \
                    rates[top] >= ratio * second:
                hot_pid = top
                # the aggressor entity: top op rate among entities
                # whose traffic lands mostly in the hot pool
                best = 0.0
                for ent, r in s["ent_rate"].items():
                    pools = s["ent_pool"].get(ent, {})
                    if not pools:
                        continue
                    if max(pools, key=pools.get) != hot_pid:
                        continue
                    if r > best:
                        best, hot_ent = r, ent
        out = []
        if hot_ent is not None and hot_ent not in profiles:
            lim = s["ent_rate"][hot_ent] * float(
                cfg.get("mgr_tuner_hot_limit_frac", 0.5))
            sensors = {
                "hot_pool": hot_pid,
                "hot_pool_rate": round(s["pool_rate"][hot_pid], 1),
                "entity": hot_ent,
                "entity_rate": round(s["ent_rate"][hot_ent], 1)}
            cmd = {"prefix": "osd client-profile", "op": "set",
                   "entity": hot_ent, "reservation": 0.0,
                   "weight": float(cfg.get("mgr_tuner_hot_weight",
                                           0.5)),
                   "limit": round(lim, 1)}
            out.append(Proposal(
                "hot_pool_protector", f"profile:{hot_ent}", "act",
                cmd, sensors,
                f"pool {hot_pid} hot ({sensors['hot_pool_rate']} "
                f"ops/s): limit {hot_ent} to {cmd['limit']} ops/s"))
        # heal: tuner-owned profiles whose entity is no longer the
        # aggressor come off (operator-set profiles are not ours)
        for key in owned:
            if not key.startswith("profile:"):
                continue
            ent = key.split(":", 1)[1]
            if ent == hot_ent or ent not in profiles:
                continue
            sensors = {"entity": ent,
                       "entity_rate": round(
                           s["ent_rate"].get(ent, 0.0), 1),
                       "hot_pool": hot_pid}
            out.append(Proposal(
                "hot_pool_protector", key, "revert",
                {"prefix": "osd client-profile", "op": "rm",
                 "entity": ent},
                sensors, f"{ent} no longer the aggressor: restore"))
        return out

    # -- policy: gray-OSD responder ---------------------------------------
    def _gray_osd_responder(self, s: dict, osd_dump: dict,
                            owned: dict) -> list:
        damp_w = float(self.mgr.config.get("mgr_tuner_affinity", 0.0))
        affinity = self._affinity_of(osd_dump)
        slow = s["slow_osds"]
        out = []
        for osd, score in sorted(slow.items()):
            if affinity.get(osd, 1.0) <= damp_w:
                continue                  # already dampened
            out.append(Proposal(
                "gray_osd_responder", f"affinity:{osd}", "act",
                {"prefix": "osd primary-affinity", "id": osd,
                 "weight": damp_w},
                {"osd": osd, "slow_score": round(score, 2)},
                f"osd.{osd} confirmed slow (score {score:.2f}): "
                f"primary-affinity -> {damp_w:g}"))
        for key in owned:
            if not key.startswith("affinity:"):
                continue
            try:
                osd = int(key.split(":", 1)[1])
            except ValueError:
                continue
            if osd in slow or affinity.get(osd, 1.0) >= 1.0:
                continue
            out.append(Proposal(
                "gray_osd_responder", key, "revert",
                {"prefix": "osd primary-affinity", "id": osd,
                 "weight": 1.0},
                {"osd": osd, "slow_score": None},
                f"osd.{osd} healed: primary-affinity -> 1.0"))
        return out

    # -- policy: kernel-path watchdog --------------------------------------
    async def _kernel_watchdog(self, s: dict, osd_dump: dict,
                               owned: dict) -> list:
        """A PERMANENTLY degraded kernel path (quarantine gave up) is
        a slow OSD by another sensor: same affinity actuator. The
        status osdmap block only carries the mismatch ratio, so the
        phase comes from `device-runtime status`.

        In the port only a Mapper on the CPU quarantines a kernel path
        (devmon's health: a kernel failure on the card is counted and
        raised, not degraded), so for OSDs on the card this sees no
        ``permanent`` phase and proposes nothing."""
        ret, _, out_bl = await self.mon_command(
            {"prefix": "device-runtime status"})
        if ret != 0:
            return []
        try:
            degraded = json.loads(out_bl).get("degraded", {})
        except (json.JSONDecodeError, AttributeError):
            return []
        damp_w = float(self.mgr.config.get("mgr_tuner_affinity", 0.0))
        affinity = self._affinity_of(osd_dump)
        permanent = {}
        for o, v in degraded.items():
            if isinstance(v, dict) and v.get("phase") == "permanent":
                try:
                    permanent[int(o)] = v
                except ValueError:
                    continue
        out = []
        for osd, v in sorted(permanent.items()):
            if affinity.get(osd, 1.0) <= damp_w:
                continue
            sensors = {"osd": osd, "phase": "permanent",
                       "mismatch_ratio": v.get("ratio"),
                       "engine": v.get("engine")}
            out.append(Proposal(
                "kernel_path_watchdog", f"affinity:{osd}", "act",
                {"prefix": "osd primary-affinity", "id": osd,
                 "weight": damp_w},
                sensors,
                f"osd.{osd} kernel path permanently degraded: "
                f"primary-affinity -> {damp_w:g}"))
        for key in owned:
            if not key.startswith("affinity:"):
                continue
            try:
                osd = int(key.split(":", 1)[1])
            except ValueError:
                continue
            if osd in permanent or osd in s["slow_osds"] or \
                    affinity.get(osd, 1.0) >= 1.0:
                continue
            out.append(Proposal(
                "kernel_path_watchdog", key, "revert",
                {"prefix": "osd primary-affinity", "id": osd,
                 "weight": 1.0},
                {"osd": osd, "phase": None},
                f"osd.{osd} kernel path healed: "
                f"primary-affinity -> 1.0"))
        return out

    # -- actuation ---------------------------------------------------------
    async def _apply(self, p, mode: str, now: float) -> None:
        prov = {"policy": p.policy, "sensors": p.sensors,
                "mode": mode, "action": p.kind}
        if mode != "drive":
            ret, _, _ = await self.mon_command(
                {"prefix": "tune record",
                 "entry": {"policy": p.policy, "action": p.kind,
                           "sensors": p.sensors, "cmd": p.cmd}})
            if ret == 0:
                self.observations += 1
                self.guardrails.settle(p)
                log.dout(1, f"tuner observe: {p.message}")
            return
        cmd = dict(p.cmd)
        cmd["provenance"] = prov
        ret, rs, _ = await self.mon_command(cmd)
        if ret != 0:
            self.last_error = f"{p.cmd.get('prefix')}: {rs}"
            log.dout(1, f"tuner commit failed ({p.message}): {rs}")
            return                    # streak survives: retried next tick
        if p.kind == "revert":
            self.actions_reverted += 1
        else:
            self.actions_committed += 1
        self.guardrails.settle(p)
        self._progress(p, now)
        log.dout(1, f"tuner drive: {p.message}")

    def _progress(self, p, now: float) -> None:
        """Render the in-flight act/revert pair in `ceph progress ls`
        via the ProgressModule sibling (its monward digest carries
        foreign ``tuner:*`` events untouched)."""
        prog = next((m for m in getattr(self.mgr, "modules", [])
                     if getattr(m, "NAME", "") == "progress"), None)
        if prog is None:
            return
        key = f"tuner:{p.key}"
        if p.kind == "revert":
            prog._complete(key, now)
        else:
            ev = prog._ev(key, f"[{p.policy}] {p.message}", now)
            ev["fraction"] = 0.5          # held until the revert lands
