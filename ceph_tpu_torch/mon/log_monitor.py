"""LogMonitor: the paxos-ordered cluster log.

ref: src/mon/LogMonitor.{h,cc} + src/common/LogClient — daemons send
``clog``-style MLog entries to the mon; the leader appends them (and
its own events: mon add/rm, auth lifecycle, merge transitions) to a
paxos-committed, seq-ordered log surfaced by `ceph log last [n]`.
Retention is bounded by ``mon_log_max`` — older entries are trimmed in
the same transactions that append.

The port's copy of ``ceph_tpu/mon/log_monitor.py``.
"""

from __future__ import annotations

import asyncio
import json
import time

from ceph_tpu_torch.mon.messages import MLog
from ceph_tpu_torch.mon.service import PaxosService
from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("mon")

PFX = "logm"


class LogMonitor(PaxosService):
    prefix = PFX

    def __init__(self, mon) -> None:
        super().__init__(mon)
        self.max_entries = int(mon.config.get("mon_log_max", 500))
        self._lock = asyncio.Lock()

    # -- state -------------------------------------------------------------
    def last_seq(self) -> int:
        return self.store.get_u64(PFX, "last_seq")

    def first_seq(self) -> int:
        return self.store.get_u64(PFX, "first_seq", 1)

    def tail(self, n: int = 20) -> list[dict]:
        last = self.last_seq()
        lo = max(self.first_seq(), last - n + 1)
        out = []
        for seq in range(lo, last + 1):
            blob = self.store.get(PFX, f"e/{seq:016x}")
            if blob is not None:
                ent = json.loads(blob)
                ent["seq"] = seq
                out.append(ent)
        return out

    # -- append ------------------------------------------------------------
    async def append(self, who: str, level: str, msg: str,
                     stamp: float | None = None) -> bool:
        """Commit one entry (leader only). Trims past mon_log_max in
        the same transaction so the log never grows unboundedly."""
        if not self.mon.is_leader():
            return False
        async with self._lock:
            seq = self.last_seq() + 1
            first = self.first_seq()
            t = self.store.transaction()
            t.set(PFX, f"e/{seq:016x}", json.dumps({
                "stamp": stamp if stamp is not None else time.time(),
                "name": who, "level": level, "msg": msg}).encode())
            self.store.put_u64(t, PFX, "last_seq", seq)
            while seq - first + 1 > self.max_entries:
                t.rmkey(PFX, f"e/{first:016x}")
                first += 1
            self.store.put_u64(t, PFX, "first_seq", first)
            return await self.mon.propose_txn(t)

    # -- daemon clog reports -----------------------------------------------
    async def handle(self, msg) -> None:
        if isinstance(msg, MLog):
            await self.append(msg.name, msg.level or "INF", msg.msg,
                              stamp=msg.stamp or None)

    # -- commands ----------------------------------------------------------
    async def handle_command(self, cmd, inbl=b""):
        prefix = cmd.get("prefix", "")
        if prefix == "log last":
            try:
                n = int(cmd.get("num", 20))
            except (TypeError, ValueError):
                return -22, f"invalid num {cmd.get('num')!r}", b""
            return 0, "", json.dumps({"lines": self.tail(n)}).encode()
        if prefix == "log":
            # `ceph log <message>`: operator-injected entry
            text = str(cmd.get("logtext", cmd.get("message", "")))
            if not text:
                return -22, "usage: log <message>", b""
            ok = await self.append("operator", "INF", text)
            return (0, "logged", b"") if ok else \
                (-11, "proposal failed", b"")
        return -22, f"unknown command {prefix!r}", b""
