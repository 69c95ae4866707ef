"""Elector: rank-based leader election for the mon quorum.

ref: src/mon/Elector.{h,cc} and ElectionLogic.{h,cc} — the classic
strategy: a mon proposes itself; peers with higher rank defer (ACK),
peers with lower rank counter-propose; the proposer that gathers a
majority of the monmap declares VICTORY carrying the quorum list. Epochs
are odd while an election runs and even while a leader reigns; every
election starts a fresh odd epoch, so stale messages are discarded.

One leader per epoch rests on three pieces of state, as in Ceph's
``ElectionLogic``:

- ``electing_me``: this mon is a candidate in the current epoch. A new
  epoch clears it, and so does deferring to another proposer; only a
  candidate counts acks, and only a candidate wins when its timer fires.
- ``acked_me``: the ranks that acked this candidacy, itself included.
- ``leader_acked``: the rank this mon acked in the current epoch, or -1.
  It defers only to a proposer ranked below that one, and it follows the
  victory of no other mon.

One rule goes past Ceph's: a mon acks one proposer in an epoch. When a
proposer ranked below the one it acked reaches it, it acks that one in a
fresh epoch, and the ack's epoch makes the proposer start over there
(ref: ElectionLogic::receive_ack from a newer epoch). Ceph acks it in the
same epoch, so the first proposer, not told, can still count the ack when
its timer fires, and both win the epoch. With one ack per mon per epoch
two majorities of one epoch share no mon, so no epoch has two winners.

Sends never hold up the election: proposals go out in the background,
since a send to a mon that is down waits out its connect timeout, and a
timer that started after them let the mons that deferred give up first.

The port's copy of ``ceph_tpu/mon/elector.py``, repaired to those rules.
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
        self.epoch = 0
        self.electing_me = False
        self.acked_me: set[int] = set()
        self.leader_acked = -1
        self._timer: asyncio.Task | None = None

    def bump_epoch(self, epoch: int) -> None:
        """Enter ``epoch``: the last one's candidacy and ack are void, and
        a mon that led or followed joins the election (ref:
        ElectionLogic::bump_epoch -> Monitor::join_election)."""
        self.epoch = epoch
        self.electing_me = False
        self.acked_me = set()
        self.leader_acked = -1
        self.mon.join_election()

    def cancel_timer(self) -> None:
        if self._timer:
            self._timer.cancel()
            self._timer = None

    def _reset_timer(self, timeout: float) -> None:
        self.cancel_timer()
        self._timer = asyncio.ensure_future(self._expire(timeout))

    async def start(self) -> None:
        """Propose ourselves (ref: ElectionLogic::start). A fresh odd
        epoch unless this one is odd and we have neither proposed nor
        acked in it: one mon is never both a candidate and another's
        voter in one epoch."""
        if self.epoch % 2 == 0 or self.electing_me or \
                self.leader_acked >= 0:
            self.bump_epoch(self.epoch + (2 if self.epoch % 2 else 1))
        else:
            self.mon.join_election()
        self.electing_me = True
        self.acked_me = {self.mon.rank}
        log.dout(5, f"mon.{self.mon.rank} election epoch {self.epoch}")
        self._reset_timer(self.mon.election_timeout)
        for r in self.mon.monmap.ranks():
            if r != self.mon.rank:
                asyncio.ensure_future(self.mon.send_mon(r, MMonElection(
                    op=ELECTION_PROPOSE, epoch=self.epoch,
                    rank=self.mon.rank, quorum=[])))

    async def _expire(self, timeout: float | None = None) -> None:
        await asyncio.sleep(self.mon.election_timeout if timeout is None
                            else timeout)
        self._timer = None
        await self.end_election_period()

    async def end_election_period(self) -> None:
        """The timer fired (ref: ElectionLogic::end_election_period): a
        candidate with a majority wins; anyone else, a candidate short of
        one or a mon whose chosen leader never declared, starts over."""
        majority = len(self.mon.monmap.ranks()) // 2 + 1
        if self.electing_me and len(self.acked_me) >= majority:
            await self._declare_victory()
        else:
            await self.start()

    async def _declare_victory(self) -> None:
        self.cancel_timer()
        quorum = sorted(self.acked_me)
        self.electing_me = False
        self.acked_me = set()
        self.epoch += 1                       # odd -> even: reigning
        log.dout(1, f"mon.{self.mon.rank} wins election epoch "
                    f"{self.epoch} quorum {quorum}")
        epoch = self.epoch
        for r in quorum:
            if r != self.mon.rank:
                await self.mon.send_mon(r, MMonElection(
                    op=ELECTION_VICTORY, epoch=epoch,
                    rank=self.mon.rank, quorum=quorum))
        # win_election blocks on the paxos collect round; it must not
        # run inline in a connection reader loop (the LAST replies it
        # waits for arrive on those very loops)
        asyncio.ensure_future(self.mon.win_election(epoch, quorum))

    async def _defer(self, who: int) -> None:
        """Ack ``who`` and give it time to declare (ref:
        ElectionLogic::defer, Elector::_defer_to)."""
        self.electing_me = False
        self.acked_me = set()
        self.leader_acked = who
        self._reset_timer(2 * self.mon.election_timeout)
        await self.mon.send_mon(who, MMonElection(
            op=ELECTION_ACK, epoch=self.epoch, rank=self.mon.rank,
            quorum=[]))

    async def handle(self, m: MMonElection) -> None:
        if m.op == ELECTION_PROPOSE:
            await self._handle_propose(m)
        elif m.op == ELECTION_ACK:
            await self._handle_ack(m)
        elif m.op == ELECTION_VICTORY:
            await self._handle_victory(m)

    async def _handle_propose(self, m: MMonElection) -> None:
        """ref: ElectionLogic::receive_propose, propose_classic_handler."""
        if m.epoch < self.epoch:
            # a mon outside our reign proposing at an old epoch has just
            # started: a new election lets it in
            if self.epoch % 2 == 0 and m.rank not in self.mon.quorum:
                self.mon.request_election()
            return
        if m.epoch > self.epoch:
            self.bump_epoch(m.epoch)
        if self.mon.rank < m.rank:
            # we would win over them: stand, unless we acked a better one
            if self.leader_acked < 0 and not self.electing_me:
                await self.start()
        elif self.leader_acked < 0 or self.leader_acked == m.rank:
            await self._defer(m.rank)
        elif m.rank < self.leader_acked:
            # better than the one we acked: ack it in a fresh epoch, so
            # no two proposers of one epoch count this mon
            self.bump_epoch(self.epoch + 2)
            await self._defer(m.rank)

    async def _handle_ack(self, m: MMonElection) -> None:
        """ref: ElectionLogic::receive_ack."""
        if m.epoch > self.epoch:
            # an ack of an epoch we never saw: a mon moved its ack to us
            # there, or we restarted; start over in it
            self.bump_epoch(m.epoch)
            await self.start()
            return
        if m.epoch < self.epoch or not self.electing_me:
            return
        self.acked_me.add(m.rank)
        if self.acked_me >= set(self.mon.monmap.ranks()):
            await self._declare_victory()

    async def _handle_victory(self, m: MMonElection) -> None:
        """ref: ElectionLogic::receive_victory_claim."""
        if m.epoch <= self.epoch:
            return                            # stale
        if m.epoch != self.epoch + 1 or (
                self.leader_acked >= 0 and self.leader_acked != m.rank):
            # we did not see this election through, or we acked another
            # mon in it: start over, past the claimed epoch
            log.dout(1, f"mon.{self.mon.rank} refuses mon rank {m.rank}'s "
                        f"victory in epoch {m.epoch}; electing")
            self.bump_epoch(m.epoch + 1)
            await self.start()
            return
        self.cancel_timer()
        self.epoch = m.epoch
        self.electing_me = False
        self.acked_me = set()
        self.leader_acked = -1
        await self.mon.lose_election(m.epoch, m.rank, m.quorum)
