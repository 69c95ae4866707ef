"""Elector: rank-based leader election for the mon quorum.

ref: src/mon/Elector.{h,cc} — the classic strategy: a mon proposes
itself; peers with higher rank defer (ACK), peers with lower rank
counter-propose; the proposer that gathers a majority of the monmap
declares VICTORY carrying the quorum list. Epochs are even when a
leader reigns and bump on every election start, so stale messages are
discarded (ref: Elector::epoch semantics).

The port's copy of ``ceph_tpu/mon/elector.py``.
"""

from __future__ import annotations

import asyncio

from ceph_tpu_torch.mon.messages import (
    ELECTION_ACK, ELECTION_PROPOSE, ELECTION_VICTORY, MMonElection,
)
from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("mon")


class Elector:
    def __init__(self, mon) -> None:
        self.mon = mon
        self.epoch = 1
        self.electing = False
        self.acks: set[int] = set()
        self._timer: asyncio.Task | None = None

    async def start(self) -> None:
        """Propose ourselves (ref: Elector::start)."""
        self.electing = True
        self.epoch += 1
        self.acks = {self.mon.rank}
        log.dout(5, f"mon.{self.mon.rank} election epoch {self.epoch}")
        for r in self.mon.monmap.ranks():
            if r != self.mon.rank:
                await self.mon.send_mon(r, MMonElection(
                    op=ELECTION_PROPOSE, epoch=self.epoch,
                    rank=self.mon.rank, quorum=[]))
        if self._timer:
            self._timer.cancel()
        self._timer = asyncio.ensure_future(self._expire())

    async def _expire(self) -> None:
        await asyncio.sleep(self.mon.election_timeout)
        if not self.electing:
            return
        majority = len(self.mon.monmap.ranks()) // 2 + 1
        if len(self.acks) >= majority:
            await self._declare_victory()
        else:
            await self.start()          # retry with a fresh epoch

    async def _declare_victory(self) -> None:
        self.electing = False
        quorum = sorted(self.acks)
        self.epoch += 1 if self.epoch % 2 else 2   # even = reigning
        log.dout(1, f"mon.{self.mon.rank} wins election epoch "
                    f"{self.epoch} quorum {quorum}")
        for r in quorum:
            if r != self.mon.rank:
                await self.mon.send_mon(r, MMonElection(
                    op=ELECTION_VICTORY, epoch=self.epoch,
                    rank=self.mon.rank, quorum=quorum))
        # win_election blocks on the paxos collect round; it must not
        # run inline in a connection reader loop (the LAST replies it
        # waits for arrive on those very loops)
        asyncio.ensure_future(self.mon.win_election(self.epoch, quorum))

    async def handle(self, m: MMonElection) -> None:
        if m.op == ELECTION_PROPOSE:
            if m.epoch < self.epoch:
                return                  # stale
            self.epoch = max(self.epoch, m.epoch)
            if m.rank < self.mon.rank:
                # defer to the lower-ranked proposer
                self.electing = True
                await self.mon.send_mon(m.rank, MMonElection(
                    op=ELECTION_ACK, epoch=m.epoch, rank=self.mon.rank,
                    quorum=[]))
            elif not self.electing:
                await self.start()      # counter-propose
        elif m.op == ELECTION_ACK:
            if self.electing and m.epoch == self.epoch:
                self.acks.add(m.rank)
                if self.acks >= set(self.mon.monmap.ranks()):
                    if self._timer:
                        self._timer.cancel()
                    await self._declare_victory()
        elif m.op == ELECTION_VICTORY:
            if m.epoch < self.epoch:
                return
            self.epoch = m.epoch
            self.electing = False
            if self._timer:
                self._timer.cancel()
            await self.mon.lose_election(m.epoch, m.rank, m.quorum)
