"""One leader per election epoch: the mon elector and the paxos start-up
round, in ``ceph_tpu`` (the reference) and in ``ceph_tpu_torch`` (the port).

The reference's elector lets two mons win one epoch: a mon that defers
keeps the acks it gathered for itself and still counts them when its
timer fires, and a mon acks every lower-ranked proposer of an epoch, so
two proposers can each count it towards a majority. Its paxos drops a
COLLECT or a LAST whose proposal number is old and sends nothing back, so
the leader waits out ``mon_paxos_timeout`` and calls another election; and
a leader that calls an election goes on leading, so a ``begin`` in flight
across the new collect round times out and calls yet another. The port
follows Ceph's classic ``ElectionLogic`` (``electing_me``, ``acked_me``,
``leader_acked``), acks one proposer per epoch (a better one is acked in a
fresh epoch), and follows ``Paxos::handle_collect``/``handle_last`` (a
peon answers an old pn with the pn it accepted; the leader collects again
above it at once); a mon that joins an election stops leading and
restarts its paxos round.

Three kinds of case, each run through both packages:

- interleavings of election messages: over one fake mon, and over three
  electors whose every message and timer waits for the script
  (``Wire``), in one scripted order and in 600 seeded ones;
- paxos rounds on a real three-mon quorum (``start_mons``): a peon whose
  accepted pn is above the leader's, a leader that gets a higher COLLECT,
  a leader that calls an election, a ``begin`` in flight across one;
- a seeded start loop: three mons started many times with a seeded delay
  on every mon-to-mon send (each pair of mons keeps its order, as one
  connection does; sends to different peers reorder) and one mon frozen
  for a seeded while (its messages in and out wait out the freeze). Each
  start counts the epochs won by two mons, the collect and begin
  timeouts, the elections and the seconds to the first commit.

Where the reference has the fault, its case asserts the fault. Timers are
``tests/test_torch_mon.py``'s ``CFG``, unchanged. Run alone:
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_election.py -q``.
"""

from __future__ import annotations

import asyncio
import json

import numpy as np
import pytest

import ceph_tpu.mon.elector as ref_elector
import ceph_tpu.mon.messages as ref_msgs
import ceph_tpu_torch.mon.elector as port_elector
import ceph_tpu_torch.mon.messages as port_msgs
import chip_smoke as cs
from test_torch_mon import CFG, start_mons, stop_all, wait_for, wait_quorum

PKGS = ["reference", "port"]
MODS = {"reference": (ref_elector, ref_msgs, "ref"),
        "port": (port_elector, port_msgs, "port")}


def run(coro):
    return asyncio.run(coro)


# -- scripted interleavings over a fake mon -----------------------------------

class FakeMon:
    """What an ``Elector`` calls on its mon: sends and the outcomes are
    recorded, nothing is delivered. A script fires a timer by hand
    (``fire``); ``election_timeout`` is long, so none fires alone."""

    election_timeout = 1000.0

    def __init__(self, rank, n=3):
        self.rank = rank
        self.sent, self.won, self.lost = [], [], []
        self.requested = 0
        self.state = "electing"
        self.quorum: list[int] = []
        self.leader_rank = None
        self.monmap = type("M", (), {"ranks": lambda _s: list(range(n))})()

    async def send_mon(self, r, m):
        self.sent.append((r, m.op, m.epoch))

    async def win_election(self, epoch, quorum):
        self.won.append((epoch, list(quorum)))

    async def lose_election(self, epoch, leader, quorum):
        self.lost.append((epoch, leader, list(quorum)))

    def join_election(self):
        self.state = "electing"

    def request_election(self):
        self.requested += 1

    def acks(self, msgs):
        return [(r, e) for r, op, e in self.sent if op == msgs.ELECTION_ACK]

    def proposals(self, msgs):
        return sorted({e for _r, op, e in self.sent
                       if op == msgs.ELECTION_PROPOSE})


def elector(pkg, rank):
    el_mod, msgs, _ = MODS[pkg]
    mon = FakeMon(rank)
    return mon, el_mod.Elector(mon), msgs


def election(msgs, op, epoch, rank, quorum=()):
    return msgs.MMonElection(op=op, epoch=epoch, rank=rank,
                             quorum=list(quorum))


async def fire(el):
    """The election timer fires now."""
    if el._timer:
        el._timer.cancel()
    timeout, el.mon.election_timeout = el.mon.election_timeout, 0.0
    try:
        await el._expire()
    finally:
        el.mon.election_timeout = timeout
    await asyncio.sleep(0)


async def settle(*els):
    """Lets the sends a step put in the background run, and stops the
    timers."""
    await asyncio.sleep(0)
    for el in els:
        if el._timer:
            el._timer.cancel()
    await asyncio.sleep(0)


@pytest.mark.parametrize("pkg", PKGS)
def test_a_proposer_that_defers_does_not_win_at_its_timer(pkg):
    """Rank 1 proposes and rank 2 acks it; rank 0 proposes in the same
    epoch and rank 1 defers. When rank 1's timer fires, the reference
    still counts the acks it gathered for itself and wins beside rank 0;
    the port dropped its candidacy when it deferred and proposes afresh."""
    async def go():
        mon, el, msgs = elector(pkg, 1)
        await el.start()
        e = el.epoch
        await el.handle(election(msgs, msgs.ELECTION_ACK, e, 2))
        await el.handle(election(msgs, msgs.ELECTION_PROPOSE, e, 0))
        await fire(el)
        await settle(el)
        return mon, e, msgs
    mon, e, msgs = run(go())
    assert (0, msgs.ELECTION_ACK, e) in mon.sent      # it deferred to 0
    if pkg == "reference":
        assert mon.won and mon.won[0][1] == [1, 2]    # and still won
    else:
        assert mon.won == []
        assert max(mon.proposals(msgs)) > e           # a fresh election


@pytest.mark.parametrize("pkg", PKGS)
def test_a_mon_acks_one_proposer_in_an_epoch(pkg):
    """Two proposals of epoch 3 reach rank 2. Lower rank first: the
    reference acks both in epoch 3, so rank 0 and rank 1 can each count
    rank 2 for a majority; the port acks rank 0 only. Higher rank first:
    both packages ack rank 1 and then rank 0, the better proposer (Ceph's
    ``leader_acked``); the reference in epoch 3 again, the port in the
    fresh epoch 5, where rank 0 starts over."""
    async def go(order):
        mon, el, msgs = elector(pkg, 2)
        for rank in order:
            await el.handle(election(msgs, msgs.ELECTION_PROPOSE, 3, rank))
        await settle(el)
        return mon.acks(msgs), mon.won
    low_first, won = run(go((0, 1)))
    high_first, _ = run(go((1, 0)))
    assert won == []
    if pkg == "reference":
        assert low_first == [(0, 3), (1, 3)]
        assert high_first == [(1, 3), (0, 3)]
    else:
        assert low_first == [(0, 3)]
        assert high_first == [(1, 3), (0, 5)]


@pytest.mark.parametrize("sender", [0, 2])
@pytest.mark.parametrize("pkg", PKGS)
def test_a_higher_epoch_clears_a_candidacy(pkg, sender):
    """Rank 1 proposes and rank 2 acks it; then a PROPOSE at a higher
    epoch reaches it from ``sender``. The reference raises its epoch but
    keeps the acks of the old one and wins with them when its timer
    fires. The port's new epoch clears its candidacy: it defers to rank
    0, or proposes again (to rank 2) with only its own vote, and wins
    nothing at the timer."""
    async def go():
        mon, el, msgs = elector(pkg, 1)
        await el.start()
        e = el.epoch
        await el.handle(election(msgs, msgs.ELECTION_ACK, e, 2))
        await el.handle(election(msgs, msgs.ELECTION_PROPOSE, e + 2,
                                 sender))
        await asyncio.sleep(0)
        sent = list(mon.sent)
        await fire(el)
        await settle(el)
        return mon, e, msgs, sent
    mon, e, msgs, sent = run(go())
    if pkg == "reference":
        assert mon.won and mon.won[0][1] == [1, 2]    # a stale ack counted
        return
    assert mon.won == []
    if sender == 0:
        assert (0, msgs.ELECTION_ACK, e + 2) in sent
    else:
        assert (2, msgs.ELECTION_PROPOSE, e + 2) in sent


@pytest.mark.parametrize("pkg", PKGS)
def test_a_victory_from_a_mon_it_did_not_ack(pkg):
    """Rank 2 acks rank 0 in epoch 3; a VICTORY of epoch 4 from rank 1,
    whose proposal it never acked, reaches it. The reference follows
    rank 1. The port refuses it and calls an election past epoch 4, and
    then follows rank 0's victory of the epoch it acked in."""
    async def go():
        mon, el, msgs = elector(pkg, 2)
        await el.handle(election(msgs, msgs.ELECTION_PROPOSE, 3, 0))
        await el.handle(election(msgs, msgs.ELECTION_VICTORY, 4, 1,
                                 [1, 2]))
        await settle(el)
        refused = (list(mon.lost), mon.proposals(msgs))
        await el.handle(election(msgs, msgs.ELECTION_PROPOSE, 5, 0))
        await el.handle(election(msgs, msgs.ELECTION_VICTORY, 6, 0,
                                 [0, 1, 2]))
        await settle(el)
        return mon, refused
    mon, (lost, proposed) = run(go())
    if pkg == "reference":
        assert lost == [(4, 1, [1, 2])]
        return
    assert lost == [] and proposed == [5]
    assert mon.lost == [(6, 0, [0, 1, 2])]


@pytest.mark.parametrize("pkg", PKGS)
def test_a_victory_of_the_acked_mon_is_followed(pkg):
    """The plain case in both packages: rank 2 acks rank 0, rank 0's
    victory makes rank 2 its peon, and a stale victory changes nothing."""
    async def go():
        mon, el, msgs = elector(pkg, 2)
        await el.handle(election(msgs, msgs.ELECTION_PROPOSE, 3, 0))
        await el.handle(election(msgs, msgs.ELECTION_VICTORY, 4, 0,
                                 [0, 1, 2]))
        await el.handle(election(msgs, msgs.ELECTION_VICTORY, 2, 1,
                                 [1, 2]))
        await settle(el)
        return mon, el
    mon, el = run(go())
    assert mon.lost == [(4, 0, [0, 1, 2])]
    assert el.epoch == 4 and mon.won == []


@pytest.mark.parametrize("pkg", PKGS)
def test_a_mon_that_is_down_holds_no_election(pkg):
    """A proposal's send to a mon that is down waits out the connect
    timeout (here: never returns). The reference's ``start`` waits on it
    before its timer starts, so a peer that deferred gives up first; the
    port's ``start`` sends in the background and its timer runs."""
    async def go():
        mon, el, msgs = elector(pkg, 1)
        real = mon.send_mon

        async def send_mon(r, m):
            if r == 0:
                await asyncio.Event().wait()
            await real(r, m)
        mon.send_mon = send_mon
        try:
            await asyncio.wait_for(el.start(), 0.2)
            started = True
        except asyncio.TimeoutError:
            started = False
        await asyncio.sleep(0)
        out = started, el._timer is not None, mon.proposals(msgs)
        await settle(el)
        return out
    started, timer, proposed = run(go())
    if pkg == "reference":
        assert not started
    else:
        assert started and timer and proposed == [1]


# -- scripted interleavings over three electors -------------------------------

class WireMon(FakeMon):
    """A fake mon on ``Wire``: its sends wait on the wire, and its
    outcomes set its state as ``Monitor`` does."""

    def __init__(self, wire, rank, n):
        super().__init__(rank, n)
        self.wire = wire

    async def send_mon(self, r, m):
        self.wire.pending.append((self.rank, r, m))

    async def win_election(self, epoch, quorum):
        self.wire.wins.setdefault(epoch, []).append(self.rank)
        if self.wire.els[self.rank].epoch == epoch:
            self.state, self.leader_rank = "leader", self.rank
            self.quorum = list(quorum)

    async def lose_election(self, epoch, leader, quorum):
        self.state, self.leader_rank = "peon", leader
        self.quorum = list(quorum)

    def request_election(self):
        self.join_election()
        self.wire.requests.append(self.rank)


class Wire:
    """Three electors whose every message waits in ``pending`` until the
    script delivers it; timers fire only when the script fires them."""

    def __init__(self, pkg, n=3):
        el_mod, self.msgs, _ = MODS[pkg]
        self.pending: list = []
        self.requests: list = []
        self.wins: dict[int, list[int]] = {}
        self.mons = [WireMon(self, r, n) for r in range(n)]
        self.els = [el_mod.Elector(m) for m in self.mons]

    async def deliver(self, src, dst, op):
        """Delivers the first waiting message ``op`` from src to dst."""
        at = next(i for i, (s, d, m) in enumerate(self.pending)
                  if (s, d, m.op) == (src, dst, op))
        _, _, m = self.pending.pop(at)
        await self.els[dst].handle(m)
        await self.elect()

    async def elect(self):
        await asyncio.sleep(0)
        while self.requests:
            await self.els[self.requests.pop(0)].start()
            await asyncio.sleep(0)

    async def drain(self):
        while self.pending:
            s, d, m = self.pending.pop(0)
            await self.els[d].handle(m)
            await self.elect()

    def leader(self):
        """The mon that leads all, each other one its peon, or None."""
        lead = [m for m in self.mons if m.state == "leader"]
        if len(lead) != 1 or sorted(lead[0].quorum) != [0, 1, 2]:
            return None
        ok = all(m.state == "peon" and m.leader_rank == lead[0].rank
                 for m in self.mons if m is not lead[0])
        return lead[0].rank if ok else None

    async def settle(self, rounds=20):
        """Delivers everything, then fires the timers of the mons still
        electing, lowest rank first, until one mon leads all."""
        for _ in range(rounds):
            await self.drain()
            if self.leader() is not None:
                break
            for el in self.els:
                if el._timer is not None:
                    await fire(el)
                    await self.drain()
        for el in self.els:
            if el._timer:
                el._timer.cancel()
        await asyncio.sleep(0)

    def splits(self):
        return {e: r for e, r in self.wins.items() if len(r) > 1}


@pytest.mark.parametrize("pkg", PKGS)
def test_two_majorities_of_one_epoch(pkg):
    """Three mons propose in epoch 1. Rank 2 gets rank 1's proposal, then
    rank 0's; rank 0's proposal to rank 1 is late, and rank 1's timer
    fires with its own vote and rank 2's ack. The reference's rank 2 acks
    both in epoch 1, so rank 1 and rank 0 both win the next epoch. The port's
    rank 2 acks rank 0 in epoch 3: rank 1 wins epoch 2 alone, and rank 0
    starts over in epoch 3, where all three end under one leader."""
    async def go():
        w = Wire(pkg)
        msgs = w.msgs
        for el in w.els:
            await el.start()
        await w.elect()
        await w.deliver(1, 2, msgs.ELECTION_PROPOSE)
        await w.deliver(0, 2, msgs.ELECTION_PROPOSE)
        await w.deliver(2, 1, msgs.ELECTION_ACK)
        await w.deliver(2, 0, msgs.ELECTION_ACK)
        await fire(w.els[1])
        await fire(w.els[0])
        first = {e: list(r) for e, r in w.wins.items()}
        await w.settle()
        return first, w
    first, w = run(go())
    if pkg == "reference":
        assert list(first.values()) == [[1, 0]]
        return
    assert first == {2: [1]}
    assert not w.splits(), w.wins
    assert w.leader() is not None, [(m.state, m.quorum) for m in w.mons]


async def seeded_schedule(pkg, seed, steps=40):
    """Three mons start together; then, ``steps`` times, a seeded choice
    delivers the next message between two mons (each pair keeps its
    order) or fires a mon's election timer; then ``Wire.settle``."""
    rng = np.random.default_rng(seed)
    w = Wire(pkg)
    for el in w.els:
        await el.start()
    await w.elect()
    for _ in range(steps):
        heads = {}
        for i, (src, dst, _m) in enumerate(w.pending):
            heads.setdefault((src, dst), i)
        timers = [el for el in w.els if el._timer is not None]
        moves = len(heads) + len(timers)
        if not moves:
            break
        pick = int(rng.integers(moves))
        if pick < len(heads):
            _, dst, m = w.pending.pop(sorted(heads.values())[pick])
            await w.els[dst].handle(m)
            await w.elect()
        else:
            await fire(timers[pick - len(heads)])
            await w.elect()
    await w.settle()
    return w


SCHEDULE_BLOCKS = 6
SCHEDULES = 100         # seeded schedules in each block


@pytest.mark.parametrize("block", range(SCHEDULE_BLOCKS))
@pytest.mark.parametrize("pkg", PKGS)
def test_seeded_schedules_of_three_electors(pkg, block):
    """Seeded interleavings of three electors' messages and timers
    (``seeded_schedule``), 100 in each block. The port: no epoch has two
    winners, and each schedule ends with one mon leading all three. The
    reference: some schedule of the block has an epoch with two
    winners."""
    async def go():
        return [await seeded_schedule(pkg, block * SCHEDULES + i)
                for i in range(SCHEDULES)]
    wires = run(go())
    splits = [w.splits() for w in wires]
    if pkg == "reference":
        assert any(splits)
        return
    assert not any(splits), splits
    assert all(w.leader() is not None for w in wires)


# -- paxos rounds on a real quorum --------------------------------------------

async def formed(pkg, n=3):
    mons, monmap = await start_mons(n, pkg=MODS[pkg][2])
    leader = await wait_quorum(mons)
    await wait_for(lambda: all(m.paxos.last_committed ==
                               leader.paxos.last_committed and
                               (m is leader or m.state == "peon")
                               for m in mons), msg="peons in step")
    return mons, leader


def config_txn(pkg, mon, key, value):
    t = mon.store.transaction()
    t.set("config", f"global/{key}", value)
    return t


@pytest.mark.parametrize("pkg", PKGS)
def test_a_leader_below_a_peons_accepted_pn_collects_again(pkg):
    """A peon's accepted pn is above the leader's. The reference's peon
    drops the COLLECT, and the leader waits out ``mon_paxos_timeout``;
    the port's peon answers with the pn it accepted, and the leader
    collects again above it at once."""
    async def go():
        mons, leader = await formed(pkg)
        try:
            peon = next(m for m in mons if m is not leader)
            # no begin in flight: the peon's raised pn would refuse it
            await wait_for(lambda: not leader.paxos._propose_lock.locked(),
                           msg="no proposal in flight")
            high = leader.paxos.pn + 1000
            peon.paxos._store_pn(high)
            loop = asyncio.get_event_loop()
            t0 = loop.time()
            ok = await leader.paxos.leader_collect()
            dt = loop.time() - t0
            return ok, dt, high, leader.paxos.pn, peon.paxos.accepted_pn
        finally:
            await stop_all(mons)
    ok, dt, high, pn, peon_pn = run(go())
    if pkg == "reference":
        assert not ok and dt >= CFG["mon_paxos_timeout"] * 0.9
        return
    assert ok and dt < CFG["mon_paxos_timeout"] / 2, dt
    assert pn > high and peon_pn == pn


@pytest.mark.parametrize("pkg", PKGS)
def test_a_leader_that_gets_a_higher_collect(pkg):
    """A peon sends the leader a COLLECT with a pn above the leader's,
    as a mon that still believes it leads would. The reference's leader
    accepts it: a leader takes a second leader's pn. The port's leader takes no COLLECT (a leader of a newer epoch would
    have pulled it into that epoch's election first): it accepts nothing,
    goes on leading and commits."""
    async def go():
        mons, leader = await formed(pkg)
        _, msgs, _ = MODS[pkg]
        try:
            peon = next(m for m in mons if m is not leader)
            high = leader.paxos.pn + 1000
            await peon.send_mon(leader.rank, msgs.MMonPaxos(
                op=msgs.PAXOS_COLLECT, pn=high,
                last_committed=peon.paxos.last_committed, version=0,
                value=b"", uncommitted_pn=0, extra={}))
            if pkg == "reference":
                await wait_for(lambda: leader.paxos.accepted_pn == high,
                               timeout=5.0, msg="the COLLECT accepted")
                return {"accepted": leader.paxos.accepted_pn, "high": high}
            await asyncio.sleep(5 * CFG["mon_lease_interval"])
            ok = await leader.propose_txn(config_txn(pkg, leader, "k",
                                                     b"v"), timeout=2.0)
            await wait_quorum(mons)
            return {"accepted": leader.paxos.accepted_pn, "high": high,
                    "leaders": [m.name for m in mons if m.is_leader()],
                    "ok": ok}
        finally:
            await stop_all(mons)
    out = run(go())
    if pkg == "reference":
        assert out["accepted"] == out["high"]
        return
    assert len(out["leaders"]) == 1
    assert out["accepted"] < out["high"] and out["ok"]


@pytest.mark.parametrize("pkg", PKGS)
def test_a_leader_that_calls_an_election_stops_leading(pkg):
    """``request_election`` on the leader: the reference's mon stays
    "leader" with its paxos active while the election runs, so its
    services go on proposing; the port's mon is "electing" at once, its
    paxos inactive, until the election ends."""
    async def go():
        mons, leader = await formed(pkg)
        try:
            leader.request_election()
            state = (leader.is_leader(), leader.paxos.active)
            await wait_quorum(mons)
            return state
        finally:
            await stop_all(mons)
    leading, active = run(go())
    if pkg == "reference":
        assert leading and active
    else:
        assert not leading and not active


@pytest.mark.parametrize("pkg", PKGS)
def test_a_begin_in_flight_across_an_election(pkg):
    """A peon holds the leader's BEGIN while the leader calls an election
    and wins it again. The reference's begin waits for ACCEPTs of its old
    pn, which the new round drops, times out and calls another election.
    The port's election ends the begin at once; the value commits in the
    new round and no begin times out."""
    async def go():
        mons, leader = await formed(pkg)
        counter = cs.PaxosTimeouts()
        try:
            peon = next(m for m in mons if m is not leader)
            _, msgs, _ = MODS[pkg]
            held, release = [], asyncio.Event()
            real = peon._dispatch_mon_msg

            async def late(msg):
                await release.wait()
                await real(msg)

            async def holding(msg):
                # the BEGIN alone waits; what follows it is delivered
                if isinstance(msg, msgs.MMonPaxos) and not held and \
                        msg.op == msgs.PAXOS_BEGIN:
                    held.append(asyncio.ensure_future(late(msg)))
                    return
                await real(msg)
            peon._dispatch_mon_msg = holding
            wins0 = leader.elector.epoch
            proposal = asyncio.ensure_future(leader.propose_txn(
                config_txn(pkg, leader, "held", b"1"), timeout=8.0))
            await wait_for(lambda: held, timeout=5.0, msg="a held BEGIN")
            leader.request_election()
            await wait_for(lambda: leader.elector.epoch > wins0 + 1 and
                           leader.is_leader() and leader.paxos.active,
                           timeout=5.0, msg="the leader re-elected")
            epoch1 = leader.elector.epoch
            release.set()
            await asyncio.sleep(CFG["mon_paxos_timeout"] * 1.5)
            await wait_quorum(mons)
            await asyncio.wait_for(proposal, 10.0)
            await wait_for(lambda: all(m.store.get("config", "global/held")
                                       == b"1" for m in mons),
                           timeout=10.0, msg="the held value committed")
            return dict(counter.n), epoch1, leader.elector.epoch
        finally:
            counter.close()
            await stop_all(mons)
    counts, epoch1, epoch2 = run(go())
    if pkg == "reference":
        assert counts["begin"] >= 1
    else:
        assert counts["begin"] == 0 and epoch2 == epoch1


# -- a seeded start loop ------------------------------------------------------

class SeededNet:
    """Seeded delays on every mon-to-mon send, in order for each pair
    (one connection between two mons keeps its order; sends to
    different peers reorder), and one mon frozen from ``stall[1]`` for
    ``stall[2]`` seconds after the start: a message it sends or gets in
    that window waits out the freeze. ``acks`` records whom each mon
    acked in each epoch."""

    def __init__(self, rng, max_delay, stall, msgs):
        self.rng, self.max_delay = rng, max_delay
        self.stall = stall
        self.msgs = msgs
        self.t0 = None
        self.queues: dict = {}
        self.tasks: list = []
        self.acks: dict[tuple[int, int], set[int]] = {}

    def thaw(self, rank) -> float:
        """Seconds until ``rank`` thaws (0 when it is not frozen)."""
        who, at, dur = self.stall
        now = asyncio.get_event_loop().time() - self.t0
        return at + dur - now if who == rank and at <= now < at + dur \
            else 0.0

    def install(self, mons):
        self.t0 = asyncio.get_event_loop().time()
        for mon in mons:
            self._wrap(mon)

    def _wrap(self, mon):
        real_send, real_dispatch = mon.send_mon, mon._dispatch_mon_msg

        async def send_mon(rank, msg):
            if rank == mon.rank:
                return await real_send(rank, msg)
            if isinstance(msg, self.msgs.MMonElection) and \
                    msg.op == self.msgs.ELECTION_ACK:
                self.acks.setdefault((mon.rank, msg.epoch), set()).add(rank)
            q = self.queues.get((mon.rank, rank))
            if q is None:
                q = self.queues[(mon.rank, rank)] = asyncio.Queue()
                self.tasks.append(asyncio.ensure_future(
                    self._pump(q, real_send, rank)))
            loop = asyncio.get_event_loop()
            delay = float(self.rng.uniform(0.0, self.max_delay))
            q.put_nowait((loop.time() + self.thaw(mon.rank) + delay, msg))
            return True

        async def dispatch(msg):
            wait = self.thaw(mon.rank)
            if wait > 0:
                await asyncio.sleep(wait)
            await real_dispatch(msg)
        mon.send_mon, mon._dispatch_mon_msg = send_mon, dispatch

    async def _pump(self, q, send, rank):
        loop = asyncio.get_event_loop()
        while True:
            at, msg = await q.get()
            if at > loop.time():
                await asyncio.sleep(at - loop.time())
            await send(rank, msg)

    def close(self):
        for t in self.tasks:
            t.cancel()


START_SEEDS = range(8)
START_DEADLINE = 8.0        # seconds to a full quorum and its first commit
SETTLE_S = 0.3              # watched after that for a late second winner
MAX_DELAY = 0.08            # seconds, each mon-to-mon send
STALL = (0.1, 0.5, 0.2, 0.6)   # a freeze at [0.1, 0.5) s for [0.2, 0.6) s


async def seeded_start(pkg, seed) -> dict:
    """One start of three mons under ``SeededNet``: whether a full quorum
    committed, its seconds, the first commit's second, the elections won
    and the epochs won by two mons, the (mon, epoch) pairs in which a mon
    acked two proposers, the collect and begin timeouts."""
    rng = np.random.default_rng(seed)
    stall = (int(rng.integers(0, 3)), float(rng.uniform(*STALL[:2])),
             float(rng.uniform(*STALL[2:])))
    net = SeededNet(rng, MAX_DELAY, stall, MODS[pkg][1])
    wins: dict[int, list[str]] = {}
    first = {}
    loop = asyncio.get_event_loop()

    def hook(mons):
        net.install(mons)
        for mon in mons:
            win, apply = mon.win_election, mon.apply_paxos_value

            async def counted(epoch, quorum, mon=mon, win=win):
                wins.setdefault(epoch, []).append(mon.name)
                await win(epoch, quorum)

            def stamped(version, value, apply=apply):
                first.setdefault("t", loop.time() - net.t0)
                apply(version, value)
            mon.win_election, mon.apply_paxos_value = counted, stamped

    counter = cs.PaxosTimeouts()
    mons = []
    try:
        mons, _ = await start_mons(3, pkg=MODS[pkg][2], hook=hook)

        def whole():
            lead = [m for m in mons if m.is_leader()]
            return len(lead) == 1 and lead[0].paxos.active and \
                sorted(lead[0].quorum) == [0, 1, 2] and \
                all(m.state == "peon" for m in mons if m is not lead[0]) \
                and all(m.paxos.last_committed >= 1 for m in mons)
        try:
            await wait_for(whole, timeout=START_DEADLINE, msg="a quorum")
            ok = True
        except TimeoutError:
            ok = False
        t_whole = loop.time() - net.t0
        await asyncio.sleep(SETTLE_S)
    finally:
        net.close()
        await stop_all(mons)
        counter.close()
    return {"seed": seed, "stall": [round(x, 3) for x in stall],
            "whole": ok, "whole_s": round(t_whole, 3),
            "first_commit_s": round(first["t"], 3) if first else None,
            "elections": sum(len(v) for v in wins.values()),
            "split_epochs": sorted(e for e, v in wins.items()
                                   if len(v) > 1),
            "double_acks": sorted(k for k, v in net.acks.items()
                                  if len(v) > 1),
            **{f"{k}_timeouts": v for k, v in counter.n.items()}}


@pytest.mark.parametrize("pkg", PKGS)
def test_seeded_starts(pkg):
    """Eight starts of three mons under seeded delays and one frozen
    mon. The port: no epoch won by two mons, no mon acked two proposers
    of one epoch, and every start reaches a whole quorum that commits.
    The reference: some mon acked two proposers of one epoch. Its other
    counts are printed (they are the fault's evidence; how many epochs
    two mons win there depends on the host's timing)."""
    async def go():
        return [await seeded_start(pkg, seed) for seed in START_SEEDS]
    starts = run(go())
    total = {k: sum(len(s[k]) if isinstance(s[k], list) else s[k]
                    for s in starts)
             for k in ("split_epochs", "double_acks", "elections",
                       "collect_timeouts", "begin_timeouts")}
    print(f"seeded starts {pkg}: {json.dumps(total)} "
          f"{json.dumps(starts)}")
    if pkg == "reference":
        assert total["double_acks"] > 0, starts
        return
    assert total["split_epochs"] == total["double_acks"] == 0, starts
    assert all(s["whole"] for s in starts), starts
