"""MonmapMonitor: the monmap's PaxosService — runtime membership.

ref: src/mon/MonmapMonitor.{h,cc} (MonmapMonitor::prepare_update /
prepare_command "mon add"/"mon remove") — the monmap becomes a
versioned paxos artifact: `ceph mon add` commits a new epoch whose
membership includes the joiner, `ceph mon rm` one that excludes the
leaver, and every mon adopts the committed map on refresh
(Monitor.update_monmap), re-forming quorum through the existing
elector.

Join/sync model (the reference's Monitor::sync_start collapsed onto
the paxos machinery this framework already has): a freshly added mon
boots with an EMPTY store and a provisional monmap. The next
election's COLLECT round reveals its last_committed=0, and the leader
share_state-streams every committed paxos version to it — replaying
the full transaction log rebuilds all service state (osdmap/fsmap/
auth/monmap prefixes are just store keys) BEFORE the quorum is
writeable again, which is exactly the "sync the paxos store before
voting" contract.

Removal: the committed map simply lacks the mon; its own refresh
retires it (stops electing/ticking), survivors elect among themselves.
Ranks are never reused within a map lineage so stale messages from a
removed member can't be confused with a successor's.

Simplification vs upstream (documented, deliberate): membership
changes commit under the CURRENT quorum with no joint-consensus
window; a single membership change at a time is the supported
operation — and round 7 ENFORCES that: a `mon add/rm` arriving while
one is mid-proposal (or while the quorum is re-forming) returns
-EAGAIN with a clear message instead of racing the election.

The port's copy of ``ceph_tpu/mon/monmap_monitor.py``.
"""

from __future__ import annotations

import asyncio
import json

from ceph_tpu_torch.mon.monitor import MonMap
from ceph_tpu_torch.mon.service import PaxosService
from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("mon")

PFX = "monmap"


class MonmapMonitor(PaxosService):
    prefix = PFX

    def __init__(self, mon) -> None:
        super().__init__(mon)
        self._lock = asyncio.Lock()
        self.refresh()

    # -- state -------------------------------------------------------------
    def last_epoch(self) -> int:
        return self.store.get_u64(PFX, "last_epoch")

    def refresh(self) -> None:
        last = self.last_epoch()
        if last and self.mon.monmap.epoch < last:
            blob = self.store.get(PFX, f"full_{last:08x}")
            if blob is not None:
                self.mon.update_monmap(MonMap.decode(blob))

    async def on_active(self) -> None:
        if self.last_epoch() == 0:
            await self._create_initial()

    async def _create_initial(self) -> None:
        """Commit the boot monmap as epoch 1 (ref: MonmapMonitor::
        create_initial) — from here on the paxos lineage is
        authoritative and `mon add/rm` can evolve it."""
        initial = self.mon.monmap.clone()
        initial.epoch = 1
        t = self.store.transaction()
        t.set(PFX, f"full_{1:08x}", initial.encode())
        self.store.put_u64(t, PFX, "last_epoch", 1)
        if await self.mon.propose_txn(t):
            log.dout(1, f"monmap epoch 1 committed "
                        f"({sorted(initial.mons)})")

    async def _propose_change(self, build) -> tuple[bool, object]:
        """Commit one monmap change; ``build(clone) -> (monmap,
        result) | None`` mutates a clone under the serialization lock
        (same discipline as the MDSMonitor's — a failed proposal never
        corrupts the live map)."""
        async with self._lock:
            cur = self.mon.monmap
            out = build(cur.clone())
            if out is None:
                return False, None
            new, result = out
            new.epoch = cur.epoch + 1
            t = self.store.transaction()
            t.set(PFX, f"full_{new.epoch:08x}", new.encode())
            self.store.put_u64(t, PFX, "last_epoch", new.epoch)
            ok = await self.mon.propose_txn(t)
            return ok, result

    # -- commands ----------------------------------------------------------
    def _membership_busy(self) -> str | None:
        """Reason a membership change must be refused RIGHT NOW, or
        None. Concurrent `mon add/rm` are serialized with an explicit
        -EAGAIN instead of queueing on the proposal lock: the second
        change would commit against a membership whose election hasn't
        re-formed yet and race the first one's quorum change (ROADMAP
        elastic follow-up d — the joint-consensus window this
        reference deliberately lacks)."""
        if self._lock.locked():
            return ("a monmap membership change is already in "
                    "progress; retry after it commits")
        if self.mon.state == "electing":
            return ("monmap quorum is re-forming (election in "
                    "progress); retry")
        return None

    async def handle_command(self, cmd, inbl=b""):
        prefix = cmd.get("prefix", "")
        if prefix in ("mon add", "mon rm", "mon remove"):
            busy = self._membership_busy()
            if busy is not None:
                return -11, busy, b""                      # -EAGAIN
        if prefix == "mon add":
            return await self._cmd_add(cmd)
        if prefix in ("mon rm", "mon remove"):
            return await self._cmd_rm(cmd)
        return -22, f"unknown command {prefix!r}", b""

    async def _cmd_add(self, cmd):
        """`ceph mon add <name> <host> <port>` (ref: MonmapMonitor
        prepare_command "mon add"). The joiner must already be BOUND at
        the address — quorum members start dialing it the moment the
        commit lands."""
        name = str(cmd.get("name", ""))
        host = str(cmd.get("host", "127.0.0.1"))
        try:
            port = int(cmd.get("port", 0))
        except (TypeError, ValueError):
            return -22, f"invalid port {cmd.get('port')!r}", b""
        if not name or not port:
            return -22, "usage: mon add <name> <host> <port>", b""
        got: dict = {}

        def build(mm: MonMap):
            if name in mm.mons:
                return None
            rank = mm.next_rank()
            mm.add(name, rank, host, port)
            got["rank"] = rank
            return mm, rank
        ok, rank = await self._propose_change(build)
        if not ok:
            if name in self.mon.monmap.mons:
                return 0, f"mon.{name} already in monmap", json.dumps(
                    {"epoch": self.mon.monmap.epoch,
                     "rank": self.mon.monmap.rank_of_name(name)}
                ).encode()
            return -11, "proposal failed", b""
        self.mon.clog("INF", f"mon.{name} added at {host}:{port} "
                             f"(rank {rank}, epoch "
                             f"{self.mon.monmap.epoch})")
        # quorum re-forms over the new membership; update_monmap on
        # every refresh already requested an election
        return 0, f"added mon.{name} at {host}:{port}", json.dumps(
            {"epoch": self.mon.monmap.epoch, "rank": rank}).encode()

    async def _cmd_rm(self, cmd):
        """`ceph mon rm <name>` (ref: MonmapMonitor prepare_command
        "mon remove"). Refuses to remove the last mon; removing a DEAD
        member is the normal way to shrink the map after a failure."""
        name = str(cmd.get("name", ""))
        if not name:
            return -22, "usage: mon rm <name>", b""
        rejected: dict = {}

        def build(mm: MonMap):
            if name not in mm.mons:
                return None
            if len(mm.mons) <= 1:
                rejected["msg"] = "cannot remove the last monitor"
                return None
            mm.mons.pop(name)
            return mm, None
        ok, _ = await self._propose_change(build)
        if not ok:
            if "msg" in rejected:
                return -22, rejected["msg"], b""
            if name not in self.mon.monmap.mons:
                return -2, f"mon.{name} not in monmap", b""   # -ENOENT
            return -11, "proposal failed", b""
        self.mon.clog("INF", f"mon.{name} removed (epoch "
                             f"{self.mon.monmap.epoch})")
        return 0, f"removed mon.{name}", json.dumps(
            {"epoch": self.mon.monmap.epoch}).encode()
