"""vstart: in-process dev cluster launcher.

ref: src/vstart.sh — spin N mons + N osds (+ client) on localhost,
wait for HEALTH_OK, tear down. The qa-standalone tests and the demo
CLI (`python -m ceph_tpu_torch.cluster.vstart`) both drive this.

The port's copy of ``ceph_tpu/cluster/vstart.py``. A ``Cluster`` runs on
``device`` (CUDA unless ``"cpu"``; it raises without a card) and hands it
to every ``Monitor``, ``OSD``, ``Mgr`` and ``Rados`` it starts; the CLI
takes ``--device``. ``mgr_modules`` (and ``--mgr-num`` with ``--serve``)
starts ``n_mgrs`` mgrs, the first active. ``start_fs``/``add_mds`` (and
``--mds-num`` with ``--serve``) boot mon-coordinated MDS daemons on the
same device.
"""

from __future__ import annotations

import asyncio
import os
import tempfile

from ceph_tpu_torch.mon.monitor import Monitor, MonMap
from ceph_tpu_torch.msg import Keyring
from ceph_tpu_torch.os_.objectstore import MemStore, WALStore
from ceph_tpu_torch.osd.daemon import OSD
from ceph_tpu_torch.rados import Rados
from ceph_tpu_torch.utils.device import resolve

DEFAULT_CFG = {
    "mon_election_timeout": 0.15, "mon_lease_interval": 0.1,
    "mon_lease": 1.0, "mon_paxos_timeout": 2.0,
    "mon_tick_interval": 0.1, "mon_osd_min_down_reporters": 1,
    "mon_osd_down_out_interval": 5.0,
    "osd_heartbeat_interval": 0.25, "osd_heartbeat_grace": 1.5,
    "osd_stats_interval": 0.3,
    "mds_beacon_interval": 0.25, "mds_beacon_grace": 2.5,
    "mds_reconnect_timeout": 1.5, "mds_replay_interval": 0.25,
    "mgr_beacon_interval": 0.25, "mgr_beacon_grace": 2.0,
    "mgr_stats_period": 0.25, "mgr_stats_stale_s": 5.0,
    "mgr_stats_schema_refresh": 10, "mgr_progress_interval": 0.25,
}


class Cluster:
    """A running dev cluster (the vstart.sh artifact).

    Two backends: the default ``backend="inproc"`` runs
    every daemon inside this interpreter (fast, introspectable — the
    objects are right there); ``backend="proc"`` returns a
    :class:`ceph_tpu_torch.cluster.proc.ProcCluster` instead, spawning each
    daemon as a SEPARATE supervised OS process over the same real-TCP
    messenger, where kill means SIGKILL and stop means SIGTERM."""

    def __new__(cls, *args, backend: str = "inproc", **kwargs):
        if backend == "proc" and cls is Cluster:
            from ceph_tpu_torch.cluster.proc import ProcCluster
            return ProcCluster(*args, **kwargs)
        return super().__new__(cls)

    def __init__(self, n_mons: int = 1, n_osds: int = 3,
                 config: dict | None = None, auth: bool = True,
                 data_dir: str | None = None,
                 mgr_modules: list | None = None,
                 stores: list | None = None,
                 n_mgrs: int = 1, backend: str = "inproc",
                 device=None):
        self.cfg = dict(DEFAULT_CFG, **(config or {}))
        # every daemon and the client of this cluster run here
        self.device = resolve(device)
        self.n_mons = n_mons
        self.n_osds = n_osds
        self.n_mgrs = n_mgrs           # honored when mgr_modules set
        self.auth = auth
        self.data_dir = data_dir       # None = MemStore osds
        self.stores = stores           # explicit per-osd ObjectStores
        self.keyring = Keyring() if auth else None
        self.monmap = MonMap(fsid="vstart")
        self.mons: list[Monitor] = []
        self.osds: list[OSD] = []
        self.mdss: list = []                 # MDSDaemons (start_fs)
        self.fs_pool: str | None = None
        self.mgr = None                # first-started mgr (compat)
        self.mgrs: list = []
        self.mgr_modules = mgr_modules       # None = no mgr
        self.client: Rados | None = None
        # cluster-wide fault table (sim/faults.FaultInjector): set via
        # install_faults(); revived daemons inherit it
        self.faults = None
        self.asok = None                     # --serve admin socket

    async def start(self) -> "Cluster":
        names = "abcdefgh"[:self.n_mons]
        mgr_names = "xyzwvuts"[:max(self.n_mgrs, 1)]
        if self.keyring:
            for n in names:
                self.keyring.add(f"mon.{n}")
            for i in range(self.n_osds):
                self.keyring.add(f"osd.{i}")
            self.keyring.add("client.admin")
            for n in mgr_names:
                self.keyring.add(f"mgr.{n}")
        for rank, name in enumerate(names):
            self.monmap.add(name, rank, "127.0.0.1", 0)
        for rank, name in enumerate(names):
            mon = Monitor(name, self.monmap, keyring=self.keyring,
                          config=self.cfg, device=self.device)
            addr = await mon.msgr.bind()
            self.monmap.mons[name] = (rank, addr.host, addr.port)
            self.mons.append(mon)
        for mon in self.mons:
            mon._tick_task = asyncio.ensure_future(mon._tick_loop())
            mon.start_mgr_reporting()
        for mon in self.mons:
            await mon.elector.start()
        for mon in self.mons:
            await mon.start_asok()   # no-op without admin_socket_dir
        self.client = Rados(self.monmap, keyring=self.keyring,
                            config=self.cfg, device=self.device)
        # wait for a working quorum via the client path
        ret, rs, _ = await self.client.mon_command({"prefix": "status"},
                                                   timeout=30.0)
        assert ret == 0, rs
        # provision + boot osds
        for i in range(self.n_osds):
            ret, rs, _ = await self.client.mon_command(
                {"prefix": "osd new"})
            assert ret == 0, rs
            ret, rs, _ = await self.client.mon_command(
                {"prefix": "osd crush add", "id": i, "weight": 1.0,
                 "host": f"host{i}"})
            assert ret == 0, rs
        for i in range(self.n_osds):
            if self.stores is not None:
                store = self.stores[i]
            else:
                store = MemStore() if self.data_dir is None else \
                    WALStore(f"{self.data_dir}/osd{i}")
            osd = OSD(i, self.monmap, store=store,
                      keyring=self.keyring, config=self.cfg,
                      device=self.device)
            self.osds.append(osd)
        await asyncio.gather(*[o.boot() for o in self.osds])
        if self.mgr_modules is not None:
            from ceph_tpu_torch.mgr import Mgr
            for i, mname in enumerate(mgr_names):
                mgr = Mgr(mname, self.monmap, keyring=self.keyring,
                          modules=self.mgr_modules, config=self.cfg,
                          device=self.device)
                # first mgr promotes immediately and claims the
                # MgrMap's active slot via its beacon; the rest are
                # standbys that promote only when the map names them
                await mgr.start(active=(i == 0))
                self.mgrs.append(mgr)
            self.mgr = self.mgrs[0]
        await self.client.connect()
        return self

    # -- fault injection (ref: qa/tasks/ceph_manager.py helpers) -----------
    def install_faults(self, injector) -> None:
        """Attach one FaultInjector to every daemon messenger (mons,
        osds incl. heartbeat, mds, mgr, client) AND to the process
        device-call chokepoint (``utils.devmon.jit_call``), so device
        fault kinds fire too. Daemons revived later inherit it. Pass
        None to detach everywhere."""
        from ceph_tpu_torch.utils import devmon as devmon_mod
        self.faults = injector
        devmon_mod.set_fault_injector(injector)
        # mapper/EC quarantine knobs read the cluster's LIVE config
        devmon_mod.devmon().config = self.cfg
        for mon in self.mons:
            mon.msgr.faults = injector
        for osd in self.osds:
            osd.msgr.faults = injector
            osd.hb_msgr.faults = injector
        for mds in self.mdss:
            mds.msgr.faults = injector
            if mds.monc is not None:
                mds.monc.msgr.faults = injector
        for mgr in self.mgrs:
            mgr.monc.msgr.faults = injector
        if self.client is not None:
            self.client.monc.msgr.faults = injector

    # -- cephfs (ref: vstart.sh CEPH_NUM_MDS + `ceph fs new`) --------------
    async def start_fs(self, pool: str = "cephfs", n_mds: int = 2,
                       pg_num: int = 8,
                       timeout: float = 60.0,
                       max_mds: int = 1) -> list:
        """Create the fs pool and boot ``n_mds`` mon-coordinated MDS
        daemons; returns once the FSMap shows an active. With
        ``n_mds=1`` there is no standby — the configuration the
        session-survival regression pair uses to reproduce the
        pre-subsystem behavior (a dead MDS is a dead filesystem).
        ``max_mds > 1`` opens that many active ranks (multi-active;
        daemons beyond ``max_mds`` stay standbys) and waits until all
        of them reach active."""
        await self.client.pool_create(pool, pg_num=pg_num)
        await self.wait_for_clean(timeout=120)
        self.fs_pool = pool
        names = "abcdefgh"
        for i in range(n_mds):
            await self.add_mds(names[i])
        if max_mds > 1:
            await self.set_max_mds(max_mds)
            await self.wait_for_actives(max_mds, timeout=timeout)
        else:
            await self.wait_for_mds_active(timeout=timeout)
        return self.mdss

    async def set_max_mds(self, n: int) -> None:
        ret, rs, _ = await self.client.mon_command(
            {"prefix": "fs set", "var": "max_mds", "val": str(n)})
        assert ret == 0, rs

    async def wait_for_actives(self, n: int,
                               timeout: float = 60.0) -> dict:
        """Until ``n`` ranks are simultaneously active; returns
        rank -> daemon name."""
        deadline = asyncio.get_event_loop().time() + timeout
        while True:
            lead = self.leader()
            actives = {r: i.name for r, i in
                       lead.mdsmon.fsmap.actives().items()} \
                if lead is not None else {}
            if len(actives) >= n:
                return actives
            if asyncio.get_event_loop().time() > deadline:
                raise TimeoutError(
                    f"only {len(actives)}/{n} active mds ranks "
                    f"({actives})")
            await asyncio.sleep(0.05)

    async def subtree_pin(self, path: str, rank: int,
                          timeout: float = 30.0) -> None:
        """`fs subtree pin` + wait for the two-phase migration to
        commit (the subtree map names ``rank`` and no migration of
        ``path`` is in flight)."""
        ret, rs, _ = await self.client.mon_command(
            {"prefix": "fs subtree pin", "path": path,
             "rank": rank})
        assert ret == 0, rs
        import json as _json
        deadline = asyncio.get_event_loop().time() + timeout
        while True:
            ret, _, out = await self.client.mon_command(
                {"prefix": "fs subtree ls"})
            assert ret == 0
            dump = _json.loads(out)
            from ceph_tpu_torch.cephfs import _norm
            p = _norm(path)
            if dump["subtrees"].get(p) == rank and not any(
                    m["path"] == p for m in dump["migrations"]):
                return
            if asyncio.get_event_loop().time() > deadline:
                raise TimeoutError(
                    f"subtree {path} -> rank {rank} never committed "
                    f"({dump})")
            await asyncio.sleep(0.05)

    async def add_mds(self, name: str):
        from ceph_tpu_torch.cephfs.mds import MDSDaemon
        assert self.fs_pool is not None, "start_fs first"
        mds = await MDSDaemon.create(self.monmap, self.fs_pool,
                                     name=name, keyring=self.keyring,
                                     config=self.cfg, device=self.device)
        if self.faults is not None:
            mds.msgr.faults = self.faults
            mds.monc.msgr.faults = self.faults
        await mds.start_ha()
        self.mdss.append(mds)
        return mds

    def mds_active_name(self, rank: int = 0) -> str | None:
        """``rank``'s ACTIVE holder per the lead mon's FSMap."""
        lead = self.leader()
        if lead is None:
            return None
        info = lead.mdsmon.fsmap.active(rank)
        return info.name if info is not None else None

    async def wait_for_mds_active(self, not_name: str | None = None,
                                  timeout: float = 60.0,
                                  rank: int = 0) -> str:
        """Wait until SOME daemon is active on ``rank`` — pass
        ``not_name`` (the failed one) to wait out a failover."""
        deadline = asyncio.get_event_loop().time() + timeout
        while True:
            name = self.mds_active_name(rank)
            if name is not None and name != not_name:
                return name
            if asyncio.get_event_loop().time() > deadline:
                raise TimeoutError(
                    f"no active mds on rank {rank} (have {name!r}, "
                    f"excluded {not_name!r})")
            await asyncio.sleep(0.05)

    async def kill_mds(self, name: str):
        """``kill -9`` the named MDS (no beacons, no teardown); returns
        the zombie object — its RADOS identity stays open so fencing
        is observable."""
        mds = next(m for m in self.mdss
                   if m.name == name and not m._stopping)
        await mds.kill()
        return mds

    async def revive_mds(self, name: str):
        """Boot a FRESH incarnation under the same name (new gid, new
        RADOS identity — the old one stays fenced/tombstoned)."""
        return await self.add_mds(name)

    # -- runtime monmap membership (ref: `ceph mon add/rm` +
    # MonmapMonitor::prepare_update) ---------------------------------------
    async def add_mon(self, name: str | None = None,
                      timeout: float = 30.0) -> Monitor:
        """Grow the mon cluster AT RUNTIME: bind a fresh Monitor,
        commit it into the monmap (`ceph mon add`), and let the
        elector re-form quorum over the new membership — the joiner
        syncs the whole paxos store through the next collect round
        before the quorum is writeable again."""
        used = set(self.monmap.mons)
        name = name or next(n for n in "abcdefghijklmnop"
                            if n not in used)
        assert name not in used, f"mon.{name} already exists"
        if self.keyring is not None and \
                f"mon.{name}" not in self.keyring.keys:
            # provision through the AuthMonitor so the key is a
            # committed cluster decision, not a side-channel insert
            ret, rs, _ = await self.client.mon_command(
                {"prefix": "auth get-or-create",
                 "entity": f"mon.{name}"})
            assert ret == 0, rs
        new_rank = self.monmap.next_rank()
        provisional = self.monmap.clone()
        provisional.add(name, new_rank, "127.0.0.1", 0)
        mon = Monitor(name, provisional, keyring=self.keyring,
                      config=self.cfg, device=self.device)
        addr = await mon.msgr.bind()
        await mon.start_asok()
        provisional.mons[name] = (new_rank, addr.host, addr.port)
        if self.faults is not None:
            mon.msgr.faults = self.faults
        ret, rs, out = await self.client.mon_command(
            {"prefix": "mon add", "name": name, "host": addr.host,
             "port": addr.port})
        assert ret == 0, rs
        import json as _json
        assigned = _json.loads(out).get("rank", new_rank)
        assert assigned == new_rank, \
            f"mon add assigned rank {assigned}, expected {new_rank}"
        self.monmap.add(name, new_rank, addr.host, addr.port)
        self.mons.append(mon)
        mon._tick_task = asyncio.ensure_future(mon._tick_loop())
        mon.start_mgr_reporting()
        await mon.elector.start()
        await self.wait_for_quorum(len(self.monmap.mons),
                                   timeout=timeout)
        return mon

    async def rm_mon(self, name: str, timeout: float = 30.0) -> None:
        """Shrink the mon cluster at runtime (`ceph mon rm`): the
        committed map excludes the member (dead or alive — removing a
        killed mon is how the map heals after a failure), survivors
        re-elect, and a still-running removed mon retires itself."""
        ret, rs, _ = await self.client.mon_command(
            {"prefix": "mon rm", "name": name})
        assert ret == 0, rs
        self.monmap.mons.pop(name, None)
        victim = next((m for m in self.mons if m.name == name), None)
        if victim is not None:
            self.mons.remove(victim)
            if not victim._stopped:
                await victim.stop()
        await self.wait_for_quorum(len(self.monmap.mons),
                                   timeout=timeout)

    async def wait_for_quorum(self, n_mons: int,
                              timeout: float = 30.0) -> dict:
        """Until the quorum spans ``n_mons`` members AND commands are
        served (a command round-trip proves the leader's paxos is
        writeable again after the membership election)."""
        deadline = asyncio.get_event_loop().time() + timeout
        last: dict = {}
        while asyncio.get_event_loop().time() < deadline:
            try:
                ret, _, out = await self.client.mon_command(
                    {"prefix": "quorum_status"}, timeout=5.0)
            except Exception:
                ret = -1
            if ret == 0:
                import json as _json
                last = _json.loads(out)
                if len(last.get("quorum", [])) >= n_mons:
                    return last
            await asyncio.sleep(0.1)
        raise TimeoutError(
            f"quorum of {n_mons} not reached (last: {last})")

    async def kill_mon_leader(self) -> Monitor | None:
        """Hard-stop the current lead mon (ref: the qa mon thrasher).
        Returns the killed Monitor, or None when there is no leader or
        killing one would break quorum majority."""
        lead = self.leader()
        alive = [m for m in self.mons if not m._stopped]
        if lead is None or len(alive) - 1 <= len(self.monmap.mons) // 2:
            return None
        await lead.stop()
        return lead

    # -- mgr failover (ref: the qa mgr thrasher half) ----------------------
    def active_mgr(self):
        """The Mgr instance the lead mon's committed MgrMap names
        active (None when no mgr is active or no leader)."""
        lead = self.leader()
        if lead is None:
            return None
        gid = lead.mgrmon.mgrmap.active_gid
        return next((m for m in self.mgrs
                     if m.gid == gid and not m._stopped), None)

    async def kill_mgr(self, mgr=None):
        """Hard-stop a mgr (default: the active one); the mon's
        beacon-grace tick fails it and promotes a standby. Returns the
        killed Mgr."""
        mgr = mgr or self.active_mgr() or self.mgr
        await mgr.stop()
        return mgr

    async def wait_for_mgr_active(self, not_gid: int | None = None,
                                  timeout: float = 30.0):
        """Until the committed MgrMap names an active mgr whose gid
        differs from ``not_gid`` AND that daemon promoted itself;
        returns the Mgr."""
        deadline = asyncio.get_event_loop().time() + timeout
        while True:
            mgr = self.active_mgr()
            if mgr is not None and mgr.gid != (not_gid or -1) and \
                    mgr.active:
                return mgr
            if asyncio.get_event_loop().time() > deadline:
                lead = self.leader()
                raise TimeoutError(
                    f"no active mgr (map: "
                    f"{lead.mgrmon.mgrmap.summary() if lead else None})")
            await asyncio.sleep(0.05)

    # -- helpers (ref: qa/standalone/ceph-helpers.sh) ----------------------
    def leader(self) -> Monitor | None:
        """The current lead mon, or None mid-election."""
        return next((m for m in self.mons
                     if not m._stopped and m.is_leader()), None)

    async def wait_for_clean(self, timeout: float = 30.0) -> None:
        """All PGs of all pools active+clean on their primaries
        (ref: ceph-helpers.sh wait_for_clean)."""
        deadline = asyncio.get_event_loop().time() + timeout
        while True:
            if self._all_clean():
                return
            if asyncio.get_event_loop().time() > deadline:
                states = [
                    (p, pg.state) for o in self.osds if not o._stopped
                    for p, pg in o.pgs.items() if pg.is_primary()]
                raise TimeoutError(f"not clean: {states}")
            await asyncio.sleep(0.1)

    def _all_clean(self) -> bool:
        live = [o for o in self.osds if not o._stopped]
        if not live:
            return False
        seen = set()
        for o in live:
            for pgid_s, pg in o.pgs.items():
                if pg.is_primary():
                    if pg.state not in ("clean",):
                        return False
                    seen.add(pgid_s)
        # every pg of every pool must have a primary somewhere
        lead = self.leader()
        if lead is None or lead.osdmon.osdmap is None:
            return False
        om = lead.osdmon.osdmap
        want = sum(p.pg_num for p in om.pools.values())
        return len(seen) == want or want == 0

    async def kill_osd(self, osd_id: int) -> None:
        """Hard-stop (the qa kill_daemon analog)."""
        await self.osds[osd_id].stop()

    async def revive_osd(self, osd_id: int, store=None) -> None:
        """``store`` overrides the revived daemon's ObjectStore — pass
        a freshly remounted store to simulate a real process restart
        (mount replay) instead of reusing the in-process object."""
        old = self.osds[osd_id]
        osd = OSD(osd_id, self.monmap, store=store or old.store,
                  keyring=self.keyring, config=self.cfg,
                  device=self.device)
        if self.faults is not None:
            osd.msgr.faults = self.faults
            osd.hb_msgr.faults = self.faults
        self.osds[osd_id] = osd
        await osd.boot()

    async def wait_for_osd_down(self, osd_id: int,
                                timeout: float = 15.0) -> None:
        deadline = asyncio.get_event_loop().time() + timeout
        while True:
            lead = self.leader()
            om = lead.osdmon.osdmap if lead else None
            if om is not None and not bool(om.is_up(osd_id)):
                return
            if asyncio.get_event_loop().time() > deadline:
                raise TimeoutError(f"osd.{osd_id} still up")
            await asyncio.sleep(0.1)

    async def start_admin_socket(self, path: str) -> None:
        """Cluster-level admin socket: runtime fault-set control on a
        served cluster (`ceph daemon <path> fault ...`, see
        sim/README.md). Commands:

        - ``fault install`` {"name": n, "rules": [rule dicts]}
        - ``fault clear``   {"name": n}  (omit name: clear all)
        - ``fault ls``      -> the installed table
        """
        from ceph_tpu_torch.sim.faults import FaultInjector, rule_from_dict
        from ceph_tpu_torch.utils.admin_socket import AdminSocket

        def _injector() -> FaultInjector:
            if self.faults is None:
                self.install_faults(FaultInjector())
            return self.faults

        def fault_install(cmd):
            rules = [rule_from_dict(r) for r in cmd.get("rules", [])]
            if not rules:
                return {"error": "no rules"}
            _injector().install(cmd.get("name", "default"), rules)
            return {"installed": cmd.get("name", "default"),
                    "rules": len(rules)}

        def fault_clear(cmd):
            if self.faults is None:
                return {"cleared": []}
            name = cmd.get("name")
            if name:
                return {"cleared": [name] if self.faults.clear(name)
                        else []}
            names = list(self.faults.describe())
            self.faults.clear_all()
            return {"cleared": names}

        self.asok = AdminSocket(path)
        self.asok.register("fault install", fault_install,
                           "install a named fault set (rules: list of "
                           "{kind,a,b,...} dicts)")
        self.asok.register("fault clear", fault_clear,
                           "clear one named fault set (or all)")
        self.asok.register(
            "fault ls",
            lambda: self.faults.describe() if self.faults else {},
            "list installed fault sets")
        self.asok.register(
            "status", lambda: {
                "mons": [m.name for m in self.mons if not m._stopped],
                "osds": [o.whoami for o in self.osds
                         if not o._stopped]},
            "cluster daemon summary")
        await self.asok.start()

    async def stop(self, graceful: bool = False) -> None:
        """``graceful=True`` is the SIGTERM path: each OSD announces
        its departure (``stop(mark_down=True)``) so the map converges
        immediately instead of waiting out heartbeat grace — the
        same contract the proc backend's signal handler honors."""
        if self.asok:
            await self.asok.stop()
        if self.client:
            await self.client.shutdown()
        for mgr in self.mgrs:
            if not mgr._stopped:
                await mgr.stop()
        for m in self.mdss:
            if not m._stopping:
                await m.stop()
            elif m._own_rados is not None:
                # a kill()ed zombie keeps its rados open for fencing
                # probes; reap it at cluster teardown
                await m._own_rados.shutdown()
                m._own_rados = None
        for o in self.osds:
            if not o._stopped:
                await o.stop(mark_down=graceful)
        for m in self.mons:
            if not m._stopped:
                await m.stop()


async def _demo(args) -> None:
    c = await Cluster(n_mons=3, n_osds=3, device=args.device).start()
    await c.client.pool_create("rbd", pg_num=8)
    await c.wait_for_clean(timeout=120)
    io = await c.client.open_ioctx("rbd")
    await io.write_full("hello", b"world")
    print("read back:", await io.read("hello"))
    print("status:", (await c.client.status())["osdmap"])
    await c.stop()


async def _serve(args) -> None:
    """Run a cluster until signalled, publishing its conf for the
    ceph/rados CLIs (the long-lived half of vstart.sh). Every daemon
    type is served — mons/osds/mgrs (and mds with --mds-num) each get
    an admin socket next to the cluster one — and SIGTERM is a
    GRACEFUL stop (departing OSDs mark themselves down) while SIGKILL
    stays an honest crash, on both backends."""
    import signal as _signal

    from ceph_tpu_torch.cluster.conf import write_conf
    cfg = {}
    if args.asok:
        # daemon admin sockets land next to the cluster one, so
        # `ceph_cli daemon <dir>/osd.N.asok ops` works out of the box
        cfg["admin_socket_dir"] = os.path.dirname(args.asok) or "."
    mgr_modules = None
    if args.mgr_num > 0:
        from ceph_tpu_torch.mgr.modules import (
            BalancerModule, PGAutoscalerModule, ProgressModule,
            PrometheusModule,
        )
        mgr_modules = [BalancerModule, PGAutoscalerModule,
                       PrometheusModule, ProgressModule]
    c = await Cluster(n_mons=args.mon_num, n_osds=args.osd_num,
                      n_mgrs=args.mgr_num, mgr_modules=mgr_modules,
                      data_dir=args.data_dir, config=cfg,
                      backend=args.backend,
                      device=args.device).start()
    if args.pool:
        await c.client.pool_create(args.pool, pg_num=args.pg_num)
        await c.wait_for_clean(timeout=300)
        if args.mds_num > 0:
            await c.start_fs(pool=args.pool, n_mds=args.mds_num)
    write_conf(args.conf, c.monmap, c.keyring)
    if args.asok and args.backend == "inproc":
        await c.start_admin_socket(args.asok)
    print(f"cluster up; conf at {args.conf}", flush=True)
    stop_ev = asyncio.Event()
    loop = asyncio.get_event_loop()
    for sig in (_signal.SIGTERM, _signal.SIGINT):
        loop.add_signal_handler(sig, stop_ev.set)
    try:
        await stop_ev.wait()
    except asyncio.CancelledError:
        pass
    finally:
        if args.backend == "inproc":
            await c.stop(graceful=True)
        else:
            await c.stop()      # ProcCluster SIGTERMs its children


def main(argv=None) -> None:
    import argparse
    p = argparse.ArgumentParser(prog="vstart", description=__doc__)
    p.add_argument("--serve", action="store_true",
                   help="run until killed; write --conf for the CLIs")
    p.add_argument("--backend", default="inproc",
                   choices=("inproc", "proc"),
                   help="inproc: all daemons in this interpreter; "
                        "proc: one supervised OS process per daemon")
    p.add_argument("--mon-num", type=int, default=1)
    p.add_argument("--osd-num", type=int, default=3)
    p.add_argument("--mgr-num", type=int, default=0)
    p.add_argument("--mds-num", type=int, default=0,
                   help="with --pool: boot a filesystem on it")
    p.add_argument("--pool", default=None,
                   help="create this pool and wait for clean")
    p.add_argument("--pg-num", type=int, default=8)
    p.add_argument("--conf", default=os.path.join(
        tempfile.gettempdir(), "ceph_tpu_torch.conf"))
    p.add_argument("--data-dir", default=None,
                   help="durable WALStore osd data under this dir")
    p.add_argument("--asok", default=None,
                   help="cluster admin socket path (runtime fault "
                        "injection: `ceph daemon <asok> fault ...`)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the daemons' maps and EC coding run "
                        "(the card unless cpu)")
    args = p.parse_args(argv)
    if args.serve:
        asyncio.run(_serve(args))
    else:
        asyncio.run(_demo(args))


if __name__ == "__main__":
    main()
