"""MgrMonitor: the MgrMap's PaxosService — active/standby mgr election.

ref: src/mon/MgrMonitor.{h,cc} — mgr daemons beacon the mon
(MMgrBeacon); the monitor turns beacons into a committed, versioned
MgrMap: the first available mgr becomes ACTIVE, later arrivals queue
as standbys, and the beacon-grace tick fails a silent active —
dropping it and promoting the first standby IN THE SAME COMMIT, so
there is never an epoch with two actives. Daemons and clients follow
the map through a new ``mgrmap`` subscription (the same
beacon/publish machinery the MDSMonitor and MonmapMonitor use):
the active's address is how every daemon finds its perf-counter
report session target, and an epoch naming a NEW active is the
re-open (schema re-send) signal.

Gids are per-incarnation (allocated daemon-side like MDS gids): a
restarted mgr is a new entity, so a zombie's late beacons can never
re-claim the active slot its successor holds.

The port's copy of ``ceph_tpu/mon/mgr_monitor.py``.
"""

from __future__ import annotations

import asyncio
import json

from ceph_tpu_torch.encoding.denc import Decoder, Encoder
from ceph_tpu_torch.mon.service import PaxosService
from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("mon")

PFX = "mgrmap"


class MgrMap:
    """ref: src/mon/MgrMap.h — epoch, the active mgr (gid, name,
    addr) and the standby pool. Versioned (v1) like the other map
    artifacts, so fields append behind version bumps."""

    def __init__(self) -> None:
        self.epoch = 0
        self.active_gid = 0           # 0 = no active
        self.active_name = ""
        self.active_addr: tuple[str, int] = ("", 0)
        # gid -> (name, host, port)
        self.standbys: dict[int, tuple[str, str, int]] = {}

    def available(self) -> bool:
        return self.active_gid != 0 and self.active_addr[1] != 0

    def clone(self) -> "MgrMap":
        return MgrMap.decode(self.encode())

    def encode(self) -> bytes:
        e = Encoder()
        with e.start(1):
            e.u64(self.epoch)
            e.u64(self.active_gid)
            e.string(self.active_name)
            e.string(self.active_addr[0])
            e.u32(self.active_addr[1])
            e.map(self.standbys, lambda e, k: e.u64(k),
                  lambda e, v: e.string(v[0]).string(v[1]).u32(v[2]))
        return e.tobytes()

    @classmethod
    def decode(cls, data: bytes) -> "MgrMap":
        m = cls()
        if not data:
            return m
        d = Decoder(data)
        with d.start(1):
            m.epoch = d.u64()
            m.active_gid = d.u64()
            m.active_name = d.string()
            host = d.string()
            port = d.u32()
            m.active_addr = (host, port)
            m.standbys = d.map(
                lambda d: d.u64(),
                lambda d: (d.string(), d.string(), d.u32()))
        return m

    def summary(self) -> dict:
        return {"epoch": self.epoch,
                "active_name": self.active_name,
                "active_gid": self.active_gid,
                "available": self.available(),
                "standbys": sorted(n for n, _, _ in
                                   self.standbys.values())}


class MgrMonitor(PaxosService):
    prefix = PFX

    def __init__(self, mon) -> None:
        super().__init__(mon)
        self.mgrmap = MgrMap()
        # beacon liveness is leader-local soft state, tracked as
        # ACCUMULATED SILENCE in stall-clamped tick increments rather
        # than wall-clock stamps: an in-process jit compile can stall
        # the shared event loop (starving beacon senders AND our tick)
        # for seconds in fragments, and wall-time grace would
        # mass-fail live mgrs on resume — each tick contributes at
        # most 2 tick intervals of silence no matter how long the
        # loop was actually wedged (a new leader starts everyone at 0)
        self.last_beacon: dict[int, float] = {}
        self._silence: dict[int, float] = {}
        self._lock = asyncio.Lock()
        self.refresh()

    # -- state -------------------------------------------------------------
    def refresh(self) -> None:
        last = self.store.get_u64(PFX, "last_epoch")
        if last and self.mgrmap.epoch < last:
            blob = self.store.get(PFX, f"full_{last:08x}")
            if blob is not None:
                self.mgrmap = MgrMap.decode(blob)

    async def on_active(self) -> None:
        now = asyncio.get_event_loop().time()
        for gid in ([self.mgrmap.active_gid] if self.mgrmap.active_gid
                    else []) + list(self.mgrmap.standbys):
            self.last_beacon[gid] = now
            self._silence[gid] = 0.0

    async def _commit(self, build) -> bool:
        """Commit one mgrmap change; ``build(clone) -> MgrMap | None``
        (same failed-proposal-never-corrupts-the-live-map discipline
        as the MonmapMonitor)."""
        async with self._lock:
            cur = self.mgrmap
            new = build(cur.clone())
            if new is None:
                return False
            new.epoch = cur.epoch + 1
            t = self.store.transaction()
            t.set(PFX, f"full_{new.epoch:08x}", new.encode())
            self.store.put_u64(t, PFX, "last_epoch", new.epoch)
            return await self.mon.propose_txn(t)

    # -- beacons -----------------------------------------------------------
    async def handle(self, m) -> None:
        """One MMgrBeacon on the leader (ref: MgrMonitor::
        prepare_beacon): first available beacon claims the active
        slot, later gids join the standby pool, and a known gid just
        refreshes its grace stamp (address changes re-commit)."""
        now = asyncio.get_event_loop().time()
        self.last_beacon[m.gid] = now
        self._silence[m.gid] = 0.0
        mm = self.mgrmap
        if m.gid == mm.active_gid:
            if (m.addr_host, m.addr_port) != mm.active_addr:
                def re_addr(new: MgrMap):
                    new.active_addr = (m.addr_host, m.addr_port)
                    return new
                await self._commit(re_addr)
            return
        if m.gid in mm.standbys:
            if not mm.active_gid and m.available:
                await self._promote(m.gid)
            return
        if not m.available:
            return

        def add(new: MgrMap):
            if m.gid == new.active_gid or m.gid in new.standbys:
                return None
            if not new.active_gid:
                new.active_gid = m.gid
                new.active_name = m.name
                new.active_addr = (m.addr_host, m.addr_port)
                log.dout(1, f"mgr.{m.name} (gid {m.gid}) is now "
                            f"active")
            else:
                new.standbys[m.gid] = (m.name, m.addr_host,
                                       m.addr_port)
            return new
        if await self._commit(add):
            self.mon.clog("INF", f"mgr.{m.name} (gid {m.gid}) "
                                 f"registered ("
                                 f"{'active' if self.mgrmap.active_gid == m.gid else 'standby'})")

    @staticmethod
    def _clear_active_and_promote(new: MgrMap) -> None:
        """Drop the active slot and fill it from the standby pool
        (lowest gid — oldest incarnation) when one exists. The ONE
        place active succession happens: the grace tick's drop and
        `mgr fail` both go through here, so they can never disagree
        on who is next."""
        new.active_gid = 0
        new.active_name = ""
        new.active_addr = ("", 0)
        if new.standbys:
            gid = min(new.standbys)
            name, host, port = new.standbys.pop(gid)
            new.active_gid = gid
            new.active_name = name
            new.active_addr = (host, port)

    async def _promote(self, gid: int) -> bool:
        def promote(new: MgrMap):
            ent = new.standbys.pop(gid, None)
            if ent is None:
                return None
            new.active_gid = gid
            new.active_name = ent[0]
            new.active_addr = (ent[1], ent[2])
            return new
        ok = await self._commit(promote)
        if ok:
            self.mon.clog("INF", f"mgr.{self.mgrmap.active_name} "
                                 f"(gid {gid}) promoted to active "
                                 f"(epoch {self.mgrmap.epoch})")
        return ok

    # -- grace tick --------------------------------------------------------
    async def tick(self) -> None:
        """Fail silent mgrs past ``mgr_beacon_grace`` (ref:
        MgrMonitor::tick): a dead ACTIVE is dropped and the first
        standby (lowest gid — oldest incarnation) promoted in the same
        commit; dead standbys just leave the pool."""
        mm = self.mgrmap
        if not mm.active_gid and not mm.standbys:
            return
        grace = float(self.mon.config.get("mgr_beacon_grace", 4.0))
        now = asyncio.get_event_loop().time()
        tick_int = float(self.mon.config.get("mon_tick_interval", 0.2))
        # stall-clamped silence accrual (see __init__): however long
        # the loop was actually wedged, one tick charges at most two
        # tick intervals — the mgrs' beacon tasks were starved by the
        # same stall, so the extra wall time proves nothing
        last_tick = getattr(self, "_last_tick", now)
        self._last_tick = now
        dt = min(max(now - last_tick, 0.0), tick_int * 2)
        dead = []
        for gid in ([mm.active_gid] if mm.active_gid
                    else []) + list(mm.standbys):
            s = self._silence.get(gid, 0.0) + dt
            self._silence[gid] = s
            if s > grace:
                dead.append(gid)
        if not dead:
            return

        def drop(new: MgrMap):
            changed = False
            active_died = False
            for gid in dead:
                if gid == new.active_gid:
                    log.dout(1, f"mgr.{new.active_name} (gid {gid}) "
                                f"silent past grace; failing")
                    active_died = changed = True
                elif new.standbys.pop(gid, None) is not None:
                    changed = True
            if not changed:
                return None
            if active_died:
                self._clear_active_and_promote(new)
            return new
        if await self._commit(drop):
            for gid in dead:
                self.last_beacon.pop(gid, None)
                self._silence.pop(gid, None)
            self.mon.clog("WRN", f"mgr gid(s) {dead} failed by beacon "
                                 f"grace; active is now "
                                 f"{self.mgrmap.active_name or '(none)'}")

    # -- commands ----------------------------------------------------------
    async def handle_command(self, cmd, inbl=b""):
        prefix = cmd.get("prefix", "")
        if prefix == "mgr dump":
            return 0, "", json.dumps({
                **self.mgrmap.summary(),
                "active_addr": list(self.mgrmap.active_addr),
                "standby_gids": sorted(self.mgrmap.standbys),
            }).encode()
        if prefix == "mgr stat":
            return 0, "", json.dumps(self.mgrmap.summary()).encode()
        if prefix == "mgr fail":
            # operator failover: drop the active through the same
            # path the grace tick uses (a standby promotes in-commit)
            if not self.mgrmap.active_gid:
                return -2, "no active mgr", b""            # -ENOENT
            gid = self.mgrmap.active_gid

            def fail(new: MgrMap):
                if new.active_gid != gid:
                    return None
                self._clear_active_and_promote(new)
                return new
            ok = await self._commit(fail)
            self.last_beacon.pop(gid, None)
            self._silence.pop(gid, None)
            return (0, f"failed mgr gid {gid}", b"") if ok else \
                (-11, "proposal failed", b"")
        return -22, f"unknown command {prefix!r}", b""
