"""The mgr daemon: module host with active/standby.

ref: src/mgr/ + src/pybind/mgr/mgr_module.py — a daemon that watches
cluster state through its MonClient and hosts pluggable modules
(balancer, pg_autoscaler, prometheus...). Modules get the reference's
core surface: ``get("osd_map")``-style state access, ``mon_command``,
and a periodic ``serve`` tick (ref: MgrModule.get / check_mon_command /
serve). Standby mgrs hold their modules idle until promoted
(ref: MgrStandby).

The telemetry hub role (ref: src/mgr/DaemonServer.cc +
MgrStandby): the mgr binds a server socket, BEACONS to the mon
(MMgrBeacon -> the MgrMonitor's committed MgrMap, which daemons follow
via the ``mgrmap`` subscription), and receives every daemon's
MMgrOpen/MMgrReport session into a :class:`DaemonStateIndex` — so
`/metrics`, `ceph osd perf` and `ceph daemon-stats` are built from
REPORTED state, not the process-local singleton, and keep working when
daemons live in other processes. Active/standby follows the MgrMap:
the mon's beacon-grace tick fails a silent active and promotes a
standby, whose fresh (empty) index repopulates as daemons re-open
their sessions against it.

The port's copy of ``ceph_tpu/mgr/daemon.py``. A ``Mgr`` owns its
device (``device=``, CUDA unless ``"cpu"``; it raises without a card):
its ``MonClient`` decodes the maps it follows there, and every map
``get("osd_map")`` decodes maps its CRUSH step there, so the mgr's
full-cluster ``OSDMapMapping`` (and the balancer's probes over it) maps
on that device, by ``crush_straw2`` on the card.
"""

from __future__ import annotations

import asyncio
import itertools
import json

from ceph_tpu_torch.encoding import decode_osdmap
from ceph_tpu_torch.mgr.daemon_state import DaemonStateIndex
from ceph_tpu_torch.mgr.messages import MMgrOpen, MMgrReport
from ceph_tpu_torch.mon.client import MonClient
from ceph_tpu_torch.mon.messages import MMgrBeacon
from ceph_tpu_torch.msg import Dispatcher
from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("mgr")

# per-incarnation gid source (the MDS discipline): a restarted mgr is
# a NEW entity the MgrMap can never confuse with its predecessor
_GID = itertools.count(1)


class MgrModule:
    """ref: mgr_module.py MgrModule — subclass and implement tick()."""

    NAME = "module"
    TICK_INTERVAL = 1.0

    def __init__(self, mgr: "Mgr"):
        self.mgr = mgr

    async def tick(self) -> None:
        pass

    # -- the reference's module API surface ---------------------------
    async def get(self, what: str):
        """ref: MgrModule.get — structured cluster state."""
        return await self.mgr.get(what)

    async def mon_command(self, cmd: dict, inbl: bytes = b""):
        return await self.mgr.monc.command(cmd, inbl)


class Mgr(Dispatcher):
    def __init__(self, name: str, monmap, keyring=None,
                 modules: list[type[MgrModule]] | None = None,
                 config: dict | None = None,
                 gid: int | None = None, device=None):
        self.name = name
        # _GID is process-local: separate-process mgrs (proc backend)
        # must pass an externally unique gid (their pid) or every
        # child claims gid 1 and the MgrMap can't tell them apart
        self.gid = next(_GID) if gid is None else gid
        self.monc = MonClient(f"mgr.{name}", monmap, keyring=keyring,
                              device=device)
        # the maps this mgr decodes, and so its placement table, map here
        self.device = self.monc.device
        self.config = config or {}
        from ceph_tpu_torch.mgr.modules import (
            BalancerModule, PGAutoscalerModule, PrometheusModule,
            ProgressModule, TracingModule,
        )
        from ceph_tpu_torch.mgr.tuner import TunerModule
        self.modules = [cls(self) for cls in (
            modules if modules is not None else
            [BalancerModule, PGAutoscalerModule, PrometheusModule,
             TracingModule, ProgressModule, TunerModule])]
        self.active = False
        self._tasks: list[asyncio.Task] = []
        self._stopped = False
        self.addr = None
        self._beacon_task: asyncio.Task | None = None
        self._beacon_seq = 0
        # daemon report sessions land here (the DaemonServer role):
        # rebuilt ENTIRELY from fresh sessions after failover
        self.daemon_state = DaemonStateIndex(
            retention=int(self.config.get("mgr_stats_retention", 120)))
        self.asok = None
        # full-cluster mapping table maintained ACROSS osd_map fetches
        # (digest-based crush detection handles the fresh decode per
        # fetch): the balancer's whole-pool reads and calc_pg_upmaps
        # candidate probes iterate on the table instead of re-running
        # the mapper every seconds_per_iteration
        from ceph_tpu_torch.osd.osdmap_mapping import OSDMapMapping
        self._mapping = OSDMapMapping()
        # central-config application state: proc-backend
        # children live off the wire-published config db, not the
        # in-process shared dict
        self._mon_cfg_state: dict = {}
        self.mirror_global_config = False

    # -- state access -------------------------------------------------
    async def get(self, what: str):
        """ref: MgrModule.get('osd_map'|'pg_dump'|'osd_map_crush'...)."""
        if what == "osd_map":
            ret, rs, out = await self.monc.command(
                {"prefix": "osd getmap"})
            if ret != 0:
                raise RuntimeError(f"osd getmap failed: {rs}")
            m = decode_osdmap(out, device=self.device)
            self._mapping.update(m)      # delta remap vs last fetch
            m.attach_mapping(self._mapping)
            return m
        if what == "osd_dump":
            ret, _, out = await self.monc.command({"prefix": "osd dump"})
            return json.loads(out) if ret == 0 else {}
        if what == "pg_dump":
            ret, _, out = await self.monc.command({"prefix": "pg dump"})
            return json.loads(out) if ret == 0 else {}
        if what == "status":
            ret, _, out = await self.monc.command({"prefix": "status"})
            return json.loads(out) if ret == 0 else {}
        raise KeyError(what)

    # -- daemon report sessions (the DaemonServer role) ----------------
    async def ms_dispatch(self, msg) -> bool:
        if isinstance(msg, MMgrOpen):
            self.daemon_state.open(msg.daemon, msg.session_seq)
            log.dout(5, f"mgr.{self.name} session open from "
                        f"{msg.daemon} (seq {msg.session_seq})")
            return True
        if isinstance(msg, MMgrReport):
            try:
                schema = json.loads(msg.schema) if msg.schema else None
                values = json.loads(msg.values) if msg.values else {}
            except (json.JSONDecodeError, TypeError, ValueError):
                return True          # a bad report must not kill the mgr
            if not isinstance(values, dict):
                return True
            ts = values.get("t", 0.0)
            counters = values.get("counters", {})
            if not isinstance(ts, (int, float)) or \
                    not isinstance(counters, dict):
                return True      # a bad report must not kill the mgr
            self.daemon_state.report(
                msg.daemon, msg.session_seq,
                schema if isinstance(schema, list) else None,
                float(ts), counters)
            return True
        return False

    def osd_perf_digest(self) -> dict:
        """Per-OSD commit/apply latency (ms) from the reported
        objectstore time-avg counters — the table behind `ceph osd
        perf` and the ceph_osd_*_latency_ms prometheus rows."""
        out: dict[str, dict] = {}
        for name, st in self.daemon_state.daemons.items():
            if not name.startswith("osd."):
                continue
            commit = st.avg_value(name, "commit_latency")
            apply_ = st.avg_value(name, "apply_latency")
            if commit is None and apply_ is None:
                continue
            out[name.split(".", 1)[1]] = {
                "commit_latency_ms": round((commit or 0.0) * 1e3, 3),
                "apply_latency_ms": round((apply_ or 0.0) * 1e3, 3)}
        return out

    # -- lifecycle ----------------------------------------------------
    async def start(self, active: bool = True) -> None:
        """Bind, subscribe, beacon. ``active=True`` promotes
        immediately (the first beacon claims the MgrMap's active slot
        on a fresh cluster); ``active=False`` is a STANDBY — it
        beacons and promotes only when the committed map names its
        gid (ref: MgrStandby::handle_mgr_map)."""
        self.addr = await self.monc.msgr.bind()
        self.monc.msgr.add_dispatcher(self)
        await self.monc.subscribe("osdmap", 0)
        await self.monc.subscribe("monmap", 0)
        await self.monc.subscribe("mgrmap", 0)
        if self.monc.msgr.keyring is not None:
            await self.monc.subscribe("keyring", 0)
        self.monc.config_callbacks.append(self._apply_config_map)
        await self.monc.subscribe("config", 0)
        await self._start_asok()
        # crash capture: a dead beacon loop demotes this
        # mgr by silence — the crash report says WHY
        from ceph_tpu_torch.utils import crash as _crash
        self._beacon_task = _crash.watch(
            asyncio.ensure_future(self._beacon_loop()),
            f"mgr.{self.name}", self.monc, where="beacon_loop")
        if active:
            await self.promote()

    async def _start_asok(self) -> None:
        asok_dir = self.config.get("admin_socket_dir")
        if not asok_dir or self.asok is not None:
            return
        from ceph_tpu_torch.utils.admin_socket import AdminSocket
        self.asok = AdminSocket(f"{asok_dir}/mgr.{self.name}.asok")
        from ceph_tpu_torch.utils.devmon import devmon as _devmon
        self.asok.register(
            "status", lambda: {
                "name": self.name, "gid": self.gid,
                "active": self.active,
                "modules": [m.NAME for m in self.modules],
                "reported_daemons": sorted(
                    self.daemon_state.daemons),
                # the mgr's own balancer/autoscaler sweeps ride the
                # same device runtime — surface the process view
                "device": _devmon().dump()},
            "mgr state summary incl. reporting daemons and the "
            "process device-runtime view")
        self.asok.register(
            "daemon ls", lambda: {
                "daemons": {n: {"reports": st.reports,
                                "counters": len(st.latest)}
                            for n, st in sorted(
                                self.daemon_state.daemons.items())}},
            "daemons with open report sessions")
        self.asok.register(
            "daemon-stats",
            lambda cmd: self.daemon_state.daemon_stats(
                str(cmd.get("name", ""))) or
            {"error": f"no reported daemon {cmd.get('name')!r}"},
            "one daemon's reported counters + live rates from the "
            "retained time series")
        self.asok.register(
            "metrics", self._render_metrics,
            "the /metrics prometheus exposition rendered from "
            "REPORTED daemon state — lets the proc backend verify the "
            "telemetry plane re-populates after a mgr failover "
            "without scraping HTTP")
        await self.asok.start()

    async def _render_metrics(self) -> dict:
        for mod in self.modules:
            if mod.NAME == "prometheus":
                return {"body": await mod.render()}
        return {"error": "prometheus module not loaded"}

    def _apply_config_map(self, cfgmap: dict) -> None:
        """Apply a mon-published central config map."""
        from ceph_tpu_torch.utils.config import apply_mon_config
        changed = apply_mon_config(
            f"mgr.{self.name}", cfgmap, self.config,
            self._mon_cfg_state,
            mirror_global=self.mirror_global_config)
        if changed:
            log.dout(10, f"mgr.{self.name} applied mon config "
                         f"{sorted(changed)}")

    async def _beacon_loop(self) -> None:
        """Beacon + follow the committed MgrMap (ref: MgrStandby):
        promotion/demotion is MAP-driven after the first epoch — a
        standby named active promotes; an active the map no longer
        names demotes (the mon failed it spuriously and its successor
        already holds the slot)."""
        try:
            while not self._stopped:
                self._beacon_seq += 1
                try:
                    await self.monc.send_report(MMgrBeacon(
                        gid=self.gid, name=self.name,
                        addr_host=self.addr.host,
                        addr_port=self.addr.port,
                        available=1, beacon_seq=self._beacon_seq,
                        epoch=self.monc.mgrmap.epoch
                        if self.monc.mgrmap else 0))
                except Exception as e:
                    log.dout(5, f"mgr.{self.name} beacon failed: {e}")
                mm = self.monc.mgrmap
                if mm is not None and mm.active_gid:
                    if mm.active_gid == self.gid and not self.active:
                        await self.promote()
                    elif mm.active_gid != self.gid and self.active:
                        self.demote()
                # the index's staleness TTL is enforced HERE (the Mgr
                # owns its state), not only in one consumer's render:
                # daemon-stats/daemon ls and the ProgressModule's
                # osd-perf digest must drop dead daemons even when
                # PrometheusModule isn't loaded
                self.daemon_state.cull(float(self.config.get(
                    "mgr_stats_stale_s", 10.0)))
                await asyncio.sleep(float(self.config.get(
                    "mgr_beacon_interval", 0.5)))
        except asyncio.CancelledError:
            pass

    async def promote(self) -> None:
        """Standby -> active (ref: MgrStandby::handle_mgr_map)."""
        if self.active:
            return
        self.active = True
        for mod in self.modules:
            self._tasks.append(
                asyncio.ensure_future(self._module_loop(mod)))
        log.dout(1, f"mgr.{self.name} active "
                    f"({[m.NAME for m in self.modules]})")

    def demote(self) -> None:
        """Active -> standby: module loops stop; the report sessions'
        state stays (harmless — daemons follow the map to the new
        active, and our index goes stale/culls)."""
        if not self.active:
            return
        self.active = False
        for t in self._tasks:
            t.cancel()
        self._tasks.clear()
        log.dout(1, f"mgr.{self.name} demoted to standby")

    async def _module_loop(self, mod: MgrModule) -> None:
        try:
            while not self._stopped and self.active:
                try:
                    await mod.tick()
                except Exception as e:
                    log.error(f"mgr module {mod.NAME} tick failed: {e}")
                await asyncio.sleep(
                    self.config.get(f"mgr_{mod.NAME}_interval",
                                    mod.TICK_INTERVAL))
        except asyncio.CancelledError:
            pass

    async def stop(self) -> None:
        self._stopped = True
        self.active = False
        if self._beacon_task:
            self._beacon_task.cancel()
        for t in self._tasks:
            t.cancel()
        for mod in self.modules:
            closer = getattr(mod, "close", None)
            if closer:
                await closer()
        if self.asok:
            await self.asok.stop()
            self.asok = None
        await self.monc.shutdown()
