"""Multi-process cluster backend: one OS process per daemon.

ref: vstart.sh + ceph-run + systemd units — the in-process `Cluster`
(cluster/vstart.py) runs every daemon inside ONE interpreter, which
makes "kill an OSD" a polite in-process teardown. This backend spawns
each daemon (mon, osd, mgr, mds) as a SEPARATE process over the same
real-TCP messenger, supervised by the parent:

- graceful stop = SIGTERM -> the child's signal handler runs
  ``stop(mark_down=True)`` (the daemon TELLS the mon it is leaving,
  ref: the clean-shutdown MOSDMarkMeDown path) and exits 0;
- crash = SIGKILL (or any unexpected exit) -> no goodbye on the wire,
  the cluster finds out the hard way (heartbeat grace, beacon grace),
  and the supervisor restarts the daemon with capped exponential
  backoff (ref: systemd Restart=on-failure + RestartSec).

Children rebuild their runtime from the conf document written by the
parent (cluster/conf.py): monmap with PRE-ASSIGNED mon ports (so a
respawned mon rebinds the address the map advertises), keyring, knob
overrides, data_dir (OSDs mount WALStore so a SIGKILL+respawn is a
real crash-recovery mount replay). Each child serves its own admin
socket, including ``fault install/clear/ls`` verbs so fault injection
is wire-delivered per process — and subscribes to the mon's ``config``
stream, so `ceph config set` flips knobs inside remote processes
without a restart.

Child entrypoint: ``python -m ceph_tpu_torch.cluster.proc --daemon osd
--id 0 --conf /path/cluster.conf``.

The port's copy of ``ceph_tpu/cluster/proc.py``. The cluster's device
(``device=``, CUDA unless ``"cpu"``; it raises without a card) rides the
conf document, and each child runs its daemon there: on the card every
child is a CUDA context of its own, and loads the kernels the first
process built (``utils/cuda_build.py`` writes them atomically). A mgr
child (``mgr_modules``, resolved by each module's ``NAME``) runs its
``Mgr`` there too, gid = its pid, and an mds child its ``MDSDaemon``
(``MDSDaemon.create(..., device=)``, gid = its pid).
"""

from __future__ import annotations

import asyncio
import json
import os
import shutil
import signal
import socket
import sys
import tempfile

from ceph_tpu_torch.cluster.conf import (
    conf_keyring,
    conf_monmap,
    read_conf_doc,
    write_conf,
)
from ceph_tpu_torch.cluster.vstart import DEFAULT_CFG
from ceph_tpu_torch.mon.monitor import MonMap
from ceph_tpu_torch.msg import Keyring
from ceph_tpu_torch.utils.device import resolve
from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("proc")

# proc children inherit slower-but-realer timings than the in-process
# defaults: a forked interpreter takes real seconds to come up, so
# sub-second beacon/heartbeat graces would flap every restart
PROC_CFG = {
    "osd_heartbeat_grace": 3.0,
    "mds_beacon_grace": 5.0,
    "mgr_beacon_grace": 5.0,
    "mon_osd_down_out_interval": 60.0,
}


def _free_port() -> int:
    """Pre-assign a localhost port (bind 0, read, close). The child
    rebinds it; SO_REUSEADDR makes the tiny window a non-issue for a
    dev harness."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _Child:
    """One supervised daemon process."""

    def __init__(self, name: str, argv: list[str]):
        self.name = name                 # "osd.0", "mon.a", ...
        self.argv = argv
        self.proc: asyncio.subprocess.Process | None = None
        self.desired = "run"             # "run" | "stopped"
        self.restarts = 0                # supervisor respawns observed
        self.consecutive = 0             # crashes without a calm spell
        self.started_at = 0.0
        self.watcher: asyncio.Task | None = None

    @property
    def pid(self) -> int | None:
        return self.proc.pid if self.proc else None


class ProcCluster:
    """A running dev cluster where every daemon is its own process.

    API mirrors the in-process `Cluster` where the concept survives
    the process boundary (start/stop, wait_for_clean, kill/revive,
    client) and replaces in-process object surgery with signals:
    kill_osd -> SIGKILL (supervisor respawns), stop_osd -> SIGTERM
    (graceful, stays down), pause_osd/resume_osd -> SIGSTOP/SIGCONT
    (the gray-failure primitive: alive on the socket, frozen in
    time)."""

    backend = "proc"

    def __init__(self, n_mons: int = 1, n_osds: int = 3,
                 config: dict | None = None, auth: bool = True,
                 data_dir: str | None = None,
                 mgr_modules: list | None = None,
                 stores: list | None = None,
                 n_mgrs: int = 1, backend: str = "proc",
                 device=None):
        assert stores is None, \
            "proc backend owns its stores (WALStore under data_dir)"
        # every child and the client run here (the conf carries it)
        self.device = resolve(device)
        self.cfg = dict(DEFAULT_CFG)
        self.cfg.update(PROC_CFG)
        self.cfg.update(config or {})
        self.n_mons = n_mons
        self.n_osds = n_osds
        self.n_mgrs = n_mgrs
        self.auth = auth
        self.mgr_modules = mgr_modules
        self._own_dir = data_dir is None
        self.data_dir = data_dir or tempfile.mkdtemp(prefix="ceph_proc_")
        self.asok_dir = f"{self.data_dir}/asok"
        self.conf_path = f"{self.data_dir}/cluster.conf"
        self.keyring = Keyring() if auth else None
        self.monmap = MonMap(fsid="vstart-proc")
        self.children: dict[str, _Child] = {}
        self.client = None
        self.fs_pool: str | None = None
        self.spawn_to_healthy_s: float | None = None
        self._closing = False
        self.asok = None                 # cluster-level, via vstart
        self._zombies: list = []         # kill_mds's clients

    # -- bring-up ----------------------------------------------------------
    async def start(self) -> "ProcCluster":
        from ceph_tpu_torch.rados import Rados
        t0 = asyncio.get_event_loop().time()
        os.makedirs(self.asok_dir, exist_ok=True)
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
            for n in "abcdefgh":         # mds names, provisioned ahead
                self.keyring.add(f"mds.{n}")
        for rank, name in enumerate(names):
            self.monmap.add(name, rank, "127.0.0.1", _free_port())
        mods = None
        if self.mgr_modules is not None:
            mods = [m if isinstance(m, str) else m.NAME
                    for m in self.mgr_modules]
        cfg = dict(self.cfg)
        cfg["admin_socket_dir"] = self.asok_dir
        write_conf(self.conf_path, self.monmap, self.keyring,
                   config=cfg,
                   extra={"data_dir": self.data_dir,
                          "device": str(self.device),
                          "mgr_modules": mods})
        for name in names:
            await self._spawn(f"mon.{name}")
        self.client = Rados(self.monmap, keyring=self.keyring,
                            config=self.cfg, device=self.device)
        ret, rs, _ = await self.client.mon_command(
            {"prefix": "status"}, timeout=60.0)
        assert ret == 0, rs
        for i in range(self.n_osds):
            ret, rs, _ = await self.client.mon_command(
                {"prefix": "osd new"})
            assert ret == 0, rs
            ret, rs, _ = await self.client.mon_command(
                {"prefix": "osd crush add", "id": i, "weight": 1.0,
                 "host": f"host{i}"})
            assert ret == 0, rs
        for i in range(self.n_osds):
            await self._spawn(f"osd.{i}")
        await self.wait_for_osds_up(self.n_osds, timeout=90.0)
        if self.mgr_modules is not None:
            for mname in mgr_names:
                # every proc mgr starts STANDBY; the mgrmon promotes
                # the first beacon on an empty map — same rule that
                # re-elects after a SIGKILL
                await self._spawn(f"mgr.{mname}")
            await self.wait_for_mgr_active(timeout=60.0)
        await self.client.connect()
        self.spawn_to_healthy_s = \
            asyncio.get_event_loop().time() - t0
        return self

    async def _spawn(self, name: str,
                     extra: list[str] | None = None) -> _Child:
        dtype, _, did = name.partition(".")
        argv = [sys.executable, "-m", "ceph_tpu_torch.cluster.proc",
                "--daemon", dtype, "--id", did,
                "--conf", self.conf_path] + (extra or [])
        child = self.children.get(name)
        if child is None:
            child = _Child(name, argv)
            self.children[name] = child
        else:
            child.argv = argv
            child.desired = "run"
        await self._exec(child)
        if child.watcher is None or child.watcher.done():
            child.watcher = asyncio.ensure_future(self._watch(child))
        return child

    async def _exec(self, child: _Child) -> None:
        child.proc = await asyncio.create_subprocess_exec(*child.argv)
        child.started_at = asyncio.get_event_loop().time()
        log.dout(5, f"spawned {child.name} pid={child.proc.pid}")

    async def _watch(self, child: _Child) -> None:
        """The supervisor: restart-on-crash with capped exponential
        backoff; a graceful stop (desired != run) is final."""
        base = float(self.cfg.get("proc_restart_backoff_base", 0.3))
        cap = float(self.cfg.get("proc_restart_backoff_max", 5.0))
        while True:
            rc = await child.proc.wait()
            lived = asyncio.get_event_loop().time() - child.started_at
            if child.desired != "run" or self._closing:
                return
            if lived > 5.0:
                child.consecutive = 0
            delay = min(cap, base * (2 ** child.consecutive))
            child.consecutive += 1
            log.dout(1, f"{child.name} exited rc={rc} after "
                        f"{lived:.1f}s; respawn in {delay:.2f}s")
            await asyncio.sleep(delay)
            if child.desired != "run" or self._closing:
                return
            await self._exec(child)
            child.restarts += 1

    # -- signals (the thrasher's verbs) ------------------------------------
    def kill_daemon(self, name: str) -> None:
        """SIGKILL: crash, no goodbye; the supervisor respawns."""
        self.children[name].proc.send_signal(signal.SIGKILL)

    async def stop_daemon(self, name: str) -> None:
        """SIGTERM: graceful stop (mark_down) + STAYS down."""
        child = self.children[name]
        child.desired = "stopped"
        child.proc.send_signal(signal.SIGTERM)
        try:
            await asyncio.wait_for(
                child.proc.wait(),
                float(self.cfg.get("proc_stop_timeout", 10.0)))
        except asyncio.TimeoutError:
            child.proc.send_signal(signal.SIGKILL)
            await child.proc.wait()

    def pause_daemon(self, name: str) -> None:
        """SIGSTOP: the gray-failure primitive — the process holds its
        sockets open but answers nothing; heartbeats age, OSD_SLOW
        must trip (the slow-OSD responder sees it too)."""
        self.children[name].proc.send_signal(signal.SIGSTOP)

    def resume_daemon(self, name: str) -> None:
        self.children[name].proc.send_signal(signal.SIGCONT)

    def kill_osd(self, osd_id: int) -> None:
        self.kill_daemon(f"osd.{osd_id}")

    def pause_osd(self, osd_id: int) -> None:
        self.pause_daemon(f"osd.{osd_id}")

    def resume_osd(self, osd_id: int) -> None:
        self.resume_daemon(f"osd.{osd_id}")

    async def kill_mon_leader(self) -> str | None:
        """SIGKILL the current lead mon (found over the wire); returns
        its daemon name. None when no quorum/leader is visible or a
        kill would break majority."""
        ret, _, out = await self.client.mon_command(
            {"prefix": "quorum_status"}, timeout=10.0)
        if ret != 0:
            return None
        qs = json.loads(out)
        leader = qs.get("quorum_leader_name") or None
        if leader is None or \
                len(qs.get("quorum", [])) - 1 <= len(self.monmap.mons) // 2:
            return None
        self.kill_daemon(f"mon.{leader}")
        return f"mon.{leader}"

    async def kill_active_mgr(self) -> str | None:
        """SIGKILL the MgrMap's active mgr; returns its daemon name."""
        st = await self.client.status()
        active = st.get("mgrmap", {}).get("active_name")
        if not active:
            return None
        self.kill_daemon(f"mgr.{active}")
        return f"mgr.{active}"

    # -- cephfs ------------------------------------------------------------
    async def start_fs(self, pool: str = "cephfs", n_mds: int = 2,
                       pg_num: int = 8, timeout: float = 90.0) -> None:
        await self.client.pool_create(pool, pg_num=pg_num)
        await self.wait_for_clean(timeout=120)
        self.fs_pool = pool
        for name in "abcdefgh"[:n_mds]:
            await self._spawn(f"mds.{name}", ["--pool", pool])
        deadline = asyncio.get_event_loop().time() + timeout
        while True:
            st = await self.client.status()
            fsmap = st.get("fsmap") or {}
            if fsmap.get("active"):
                return
            if asyncio.get_event_loop().time() > deadline:
                raise TimeoutError(f"no active mds ({fsmap})")
            await asyncio.sleep(0.2)

    @property
    def mdss(self) -> list[str]:
        """The MDS children the supervisor keeps running."""
        return [n for n, ch in self.children.items()
                if n.startswith("mds.") and ch.desired == "run"]

    async def mds_active_name(self, rank: int = 0) -> str | None:
        """``rank``'s ACTIVE holder per the mon's FSMap (over the wire,
        so a coroutine here where ``Cluster``'s is a plain call)."""
        ret, _, out = await self.client.mon_command({"prefix": "fs dump"})
        if ret != 0:
            return None
        return next((r["name"] for r in json.loads(out)["ranks"]
                     if r["rank"] == rank and r["state"] == "active"), None)

    async def wait_for_mds_active(self, not_name: str | None = None,
                                  timeout: float = 60.0,
                                  rank: int = 0) -> str:
        """Until some daemon is active on ``rank`` other than
        ``not_name`` (the failed one)."""
        deadline = asyncio.get_event_loop().time() + timeout
        while True:
            name = await self.mds_active_name(rank)
            if name is not None and name != not_name:
                return name
            if asyncio.get_event_loop().time() > deadline:
                raise TimeoutError(
                    f"no active mds on rank {rank} (have {name!r}, "
                    f"excluded {not_name!r})")
            await asyncio.sleep(0.05)

    async def kill_mds(self, name: str):
        """SIGKILL the MDS ``name`` (the supervisor respawns it as a new
        incarnation, a standby). Returns the zombie: a client under the
        killed incarnation's RADOS identity, opened before the kill, whose
        late writes to its rank's journal must bounce off the blocklist
        as the dead process's would (``ident``, ``ioctx``,
        ``journal_oid``, ``name``)."""
        from types import SimpleNamespace

        from ceph_tpu_torch.cephfs.mds import journal_oid
        from ceph_tpu_torch.rados import Rados
        ret, _, out = await self.client.mon_command({"prefix": "fs dump"})
        assert ret == 0
        info = next(r for r in json.loads(out)["ranks"] if r["name"] == name)
        r = Rados(self.monmap, name=info["ident"], keyring=self.keyring,
                  config=self.cfg, device=self.device)
        self._zombies.append(r)
        await r.connect()
        zombie = SimpleNamespace(
            name=name, ident=info["ident"],
            ioctx=await r.open_ioctx(self.fs_pool),
            journal_oid=journal_oid(info["rank"]))
        self.kill_daemon(f"mds.{name}")
        return zombie

    async def revive_mds(self, name: str) -> None:
        """Boot a FRESH incarnation of ``mds.<name>`` (new pid, so a new
        gid and identity): the old process stops first if it still
        runs, as a removed MDS does after ``mds fail``."""
        child = self.children[f"mds.{name}"]
        if child.proc is not None and child.proc.returncode is None:
            await self.stop_daemon(child.name)
        await self.revive_daemon(child.name)

    async def revive_daemon(self, name: str) -> None:
        """Start a stopped child again, with its own arguments, under
        the supervisor."""
        child = self.children[name]
        child.desired = "run"
        await self._exec(child)
        if child.watcher is None or child.watcher.done():
            child.watcher = asyncio.ensure_future(self._watch(child))

    # -- waiting (all over the wire: the parent has no daemon objects) -----
    async def wait_for_clean(self, timeout: float = 60.0) -> None:
        deadline = asyncio.get_event_loop().time() + timeout
        last: dict = {}
        while True:
            try:
                st = await self.client.status()
                last = st.get("pgmap", {})
                n = last.get("num_pgs", 0)
                if n > 0 and last.get("states", {}).get("clean") == n:
                    return
            except Exception:
                pass
            if asyncio.get_event_loop().time() > deadline:
                raise TimeoutError(f"not clean: {last}")
            await asyncio.sleep(0.2)

    async def wait_for_osds_up(self, n: int,
                               timeout: float = 60.0) -> None:
        deadline = asyncio.get_event_loop().time() + timeout
        last = None
        while True:
            try:
                st = await self.client.status()
                last = st.get("osdmap", {}).get("num_up_osds")
                if last == n:
                    return
            except Exception:
                pass
            if asyncio.get_event_loop().time() > deadline:
                raise TimeoutError(f"{last}/{n} osds up")
            await asyncio.sleep(0.2)

    async def wait_for_mgr_active(self, not_name: str | None = None,
                                  timeout: float = 60.0) -> str:
        deadline = asyncio.get_event_loop().time() + timeout
        last: dict = {}
        while True:
            try:
                st = await self.client.status()
                last = st.get("mgrmap", {})
                name = last.get("active_name")
                if last.get("available") and name and \
                        name != not_name:
                    return name
            except Exception:
                pass
            if asyncio.get_event_loop().time() > deadline:
                raise TimeoutError(f"no active mgr ({last})")
            await asyncio.sleep(0.2)

    async def wait_for_health(self, check: str, present: bool = True,
                              timeout: float = 30.0) -> dict:
        """Until ``check`` appears in (or clears from) the health
        report; returns the final health dict."""
        deadline = asyncio.get_event_loop().time() + timeout
        health: dict = {}
        while True:
            try:
                st = await self.client.status()
                health = st.get("health", {}) or {}
                if (check in health.get("checks", {})) == present:
                    return health
            except Exception:
                pass
            if asyncio.get_event_loop().time() > deadline:
                raise TimeoutError(
                    f"{check} {'not seen' if present else 'stuck'} "
                    f"in {health}")
            await asyncio.sleep(0.2)

    async def wait_for_restart(self, name: str, restarts_before: int,
                               timeout: float = 60.0) -> None:
        """Until the supervisor has respawned ``name`` at least once
        past ``restarts_before`` AND the fresh process is alive."""
        child = self.children[name]
        deadline = asyncio.get_event_loop().time() + timeout
        while True:
            if child.restarts > restarts_before and \
                    child.proc.returncode is None:
                return
            if asyncio.get_event_loop().time() > deadline:
                raise TimeoutError(
                    f"{name} not restarted "
                    f"({child.restarts} <= {restarts_before})")
            await asyncio.sleep(0.1)

    async def wait_for_daemon_ready(self, name: str,
                                    timeout: float = 60.0) -> dict:
        """Until the daemon's (re-created) admin socket answers
        `status` — and, for an OSD, reports itself up. Proves the
        FRESH incarnation booted: map-level waits can pass trivially
        when the grace window outlives a quick respawn, because the
        dead daemon was never marked down to begin with."""
        deadline = asyncio.get_event_loop().time() + timeout
        while True:
            try:
                out = await self.daemon_command(name, "status")
                if not name.startswith("osd.") or out.get("up"):
                    return out
            except (OSError, ConnectionError, asyncio.TimeoutError,
                    ValueError):
                pass
            if asyncio.get_event_loop().time() > deadline:
                raise TimeoutError(f"{name} asok never came ready")
            await asyncio.sleep(0.2)

    # -- config + asok plumbing --------------------------------------------
    async def config_set(self, who: str, name: str, value) -> None:
        ret, rs, _ = await self.client.mon_command(
            {"prefix": "config set", "who": who, "name": name,
             "value": str(value)})
        assert ret == 0, rs

    async def config_rm(self, who: str, name: str) -> None:
        ret, rs, _ = await self.client.mon_command(
            {"prefix": "config rm", "who": who, "name": name})
        assert ret == 0, rs

    def asok_path(self, name: str) -> str:
        return f"{self.asok_dir}/{name}.asok"

    async def daemon_command(self, name: str, cmd: dict | str) -> dict:
        from ceph_tpu_torch.utils.admin_socket import daemon_command
        return await daemon_command(self.asok_path(name), cmd)

    # -- teardown ----------------------------------------------------------
    async def stop(self) -> None:
        self._closing = True
        if self.asok:
            await self.asok.stop()
        if self.client:
            await self.client.shutdown()
        for r in self._zombies:
            await r.shutdown()
        order = ("mds.", "mgr.", "osd.", "mon.")
        for prefix in order:
            batch = [c for n, c in self.children.items()
                     if n.startswith(prefix)]
            for c in batch:
                c.desired = "stopped"
                if c.proc and c.proc.returncode is None:
                    # a SIGSTOPped child can't run its SIGTERM handler
                    c.proc.send_signal(signal.SIGCONT)
                    c.proc.send_signal(signal.SIGTERM)
            for c in batch:
                if c.proc is None:
                    continue
                try:
                    await asyncio.wait_for(
                        c.proc.wait(),
                        float(self.cfg.get("proc_stop_timeout", 10.0)))
                except asyncio.TimeoutError:
                    c.proc.send_signal(signal.SIGKILL)
                    await c.proc.wait()
        for c in self.children.values():
            if c.watcher is not None:
                c.watcher.cancel()
        if self._own_dir:
            shutil.rmtree(self.data_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# child entrypoint
# ---------------------------------------------------------------------------

def _register_fault_verbs(asok, messengers, cfg) -> None:
    """Per-daemon runtime fault injection (`ceph daemon <asok> fault
    install ...`) — the proc analog of Cluster.install_faults, scoped
    to THIS process's messengers + device chokepoint."""
    from ceph_tpu_torch.sim.faults import FaultInjector, rule_from_dict
    from ceph_tpu_torch.utils import devmon as devmon_mod
    holder: dict = {"inj": None}

    def _injector():
        if holder["inj"] is None:
            inj = FaultInjector()
            holder["inj"] = inj
            devmon_mod.set_fault_injector(inj)
            devmon_mod.devmon().config = cfg
            for m in messengers:
                m.faults = inj
        return holder["inj"]

    def fault_install(cmd):
        rules = [rule_from_dict(r) for r in cmd.get("rules", [])]
        if not rules:
            return {"error": "no rules"}
        _injector().install(cmd.get("name", "default"), rules)
        return {"installed": cmd.get("name", "default"),
                "rules": len(rules)}

    def fault_clear(cmd):
        inj = holder["inj"]
        if inj is None:
            return {"cleared": []}
        name = cmd.get("name")
        if name:
            return {"cleared": [name] if inj.clear(name) else []}
        names = list(inj.describe())
        inj.clear_all()
        return {"cleared": names}

    asok.register("fault install", fault_install,
                  "install a named fault set in THIS daemon process "
                  "(rules: list of {kind,a,b,...} dicts)")
    asok.register("fault clear", fault_clear,
                  "clear one named fault set (or all) in this process")
    asok.register("fault ls",
                  lambda: holder["inj"].describe()
                  if holder["inj"] else {},
                  "list this process's installed fault sets")


async def _child_main(args) -> None:
    doc = read_conf_doc(args.conf)
    monmap = conf_monmap(doc)
    keyring = conf_keyring(doc)
    cfg = dict(doc.get("config") or {})
    data_dir = doc.get("data_dir") or "."
    device = doc.get("device") or "cuda"
    loop = asyncio.get_event_loop()
    stop_ev = asyncio.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop_ev.set)

    if args.daemon == "mon":
        from ceph_tpu_torch.mon.monitor import Monitor
        from ceph_tpu_torch.mon.store import MonitorDBStore
        # durable paxos store: a SIGKILLed mon must come back with its
        # committed state, not rejoin empty — an amnesiac rank 0 wins
        # re-election and the cluster's maps regress under it
        mon = Monitor(args.id, monmap, keyring=keyring, config=cfg,
                      store=MonitorDBStore(
                          path=f"{data_dir}/mon{args.id}"),
                      device=device)
        _, _, port = monmap.mons[args.id]
        await mon.start("127.0.0.1", port)
        _register_fault_verbs(mon.asok, [mon.msgr], cfg)
        await stop_ev.wait()
        await mon.stop()
    elif args.daemon == "osd":
        from ceph_tpu_torch.os_.objectstore import WALStore
        from ceph_tpu_torch.osd.daemon import OSD
        osd = OSD(int(args.id), monmap,
                  store=WALStore(f"{data_dir}/osd{args.id}"),
                  keyring=keyring, config=cfg, device=device)
        osd.mirror_global_config = True
        await osd.boot()
        _register_fault_verbs(osd.asok, [osd.msgr, osd.hb_msgr], cfg)
        await stop_ev.wait()
        # graceful exit TELLS the mon (MOSDMarkMeDown analog); a
        # SIGKILL never gets here — that's the crash-honesty contract
        await osd.stop(mark_down=True)
    elif args.daemon == "mgr":
        from ceph_tpu_torch.mgr import Mgr
        mods = None
        if doc.get("mgr_modules") is not None:
            from ceph_tpu_torch.mgr import modules as _m
            by_name = {c.NAME: c for c in (
                _m.BalancerModule, _m.PGAutoscalerModule,
                _m.PrometheusModule, _m.TracingModule,
                _m.ProgressModule, _m.RestModule)}
            from ceph_tpu_torch.mgr.tuner import TunerModule
            by_name[TunerModule.NAME] = TunerModule
            mods = [by_name[n] for n in doc["mgr_modules"]
                    if n in by_name]
        # gid = pid: unique across sibling processes AND respawns
        # (the in-process itertools counter restarts at 1 per child)
        mgr = Mgr(args.id, monmap, keyring=keyring, modules=mods,
                  config=cfg, gid=os.getpid(), device=device)
        mgr.mirror_global_config = True
        await mgr.start(active=False)
        _register_fault_verbs(mgr.asok, [mgr.monc.msgr], cfg)
        await stop_ev.wait()
        await mgr.stop()
    elif args.daemon == "mds":
        from ceph_tpu_torch.cephfs.mds import MDSDaemon
        from ceph_tpu_torch.utils.admin_socket import AdminSocket
        mds = await MDSDaemon.create(monmap, args.pool, name=args.id,
                                     keyring=keyring, config=cfg,
                                     gid=os.getpid(), device=device)
        mds.mirror_global_config = True
        await mds.start_ha()
        asok = AdminSocket(
            f"{cfg.get('admin_socket_dir', data_dir)}/"
            f"mds.{args.id}.asok")
        asok.register("status",
                      lambda: {"name": mds.name, "gid": mds.gid,
                               "state": mds.state},
                      "mds identity + fsmap state")
        _register_fault_verbs(asok, [mds.msgr, mds.monc.msgr], cfg)
        await asok.start()
        await stop_ev.wait()
        await asok.stop()
        await mds.stop()
    else:
        raise SystemExit(f"unknown daemon type {args.daemon!r}")


def main(argv=None) -> None:
    import argparse
    p = argparse.ArgumentParser(
        prog="ceph_tpu_torch.cluster.proc",
        description="proc-backend daemon child (spawned by "
                    "ProcCluster; runnable by hand for debugging)")
    p.add_argument("--daemon", required=True,
                   choices=("mon", "osd", "mgr", "mds"))
    p.add_argument("--id", required=True)
    p.add_argument("--conf", required=True)
    p.add_argument("--pool", default="cephfs",
                   help="mds only: the fs metadata/data pool")
    args = p.parse_args(argv)
    asyncio.run(_child_main(args))


if __name__ == "__main__":
    main()
