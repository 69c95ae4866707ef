"""EC shards against their slot across an acting shuffle, ceph_tpu_torch
against ceph_tpu.

An erasure-coded PG stores position ``p`` of each object on the OSD in
slot ``p`` of its acting set, stamped ``_pos`` = ``p``. When the acting
set changes, recovery rebuilds what each member lacks, and a member that
changed slot rebuilds its shards in place (``ECPG._fix_shard_positions``).
On the card, after an OSD came back and another went out, PGs reported
clean while the OSD that took the out one's slot held none of their
objects: the recovery round that the revive's activation scheduled
started only after the ``osd out`` map had begun a new interval's
peering. It set the state to "recovering" over "peering", pushed the
old interval's missing objects and marked the PG clean. The new
interval's peering never finished: it stops when a newer map arrives
and leaves the next round to that map's advance or to its repeer timer,
and both skip a PG that is no longer "peering". So the new member was
never recovered.

Each case stages one interleaving on ``chip_smoke.PGCluster`` (one PG of
a k=2 m=2 pool on five OSD facades) with events and parked messages, and
holds every acting slot to its own position's bytes, encoded from the
host mirror:

- a recovery round of the last interval, run while the new one waits on
  its up_thru grant;
- a push built in the last interval, landing after the shuffle;
- the PG going clean while a moved holder's position fix has not run;
- a position fix whose sources were read before a client write landed;
- a push built before a client write, landing after it.

Both packages share this host logic, and ``ceph_tpu`` keeps each fault:
its cases pin the fault as it stands, the port's the repair.

Tolerance: exact bytes and stamps.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest

import chip_smoke as cs
from tests.test_torch_pg import _mods, _profile, _shards_from_mirror

K, M, SU = 2, 2, 64
N_OSDS = K + M + 1
PKGS = ["ceph_tpu", "ceph_tpu_torch"]


def _data(seed: int, n: int = 1000) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def _stamp(store, oid: str):
    """(``_pos``, ``_v``, bytes) of one stored shard; None when absent."""
    if "1.0" not in store.list_collections() or \
            oid not in store.list_objects("1.0"):
        return None
    attrs = store.getattrs("1.0", oid)
    return (int.from_bytes(attrs["_pos"], "little", signed=True),
            attrs["_v"], bytes(store.read("1.0", oid)))


def _wrong_slots(cl, mirror: dict) -> list:
    """Every (oid, slot, holder) whose stored shard is not that slot's
    position, stamped so, with the bytes the mirror gives it."""
    _up, acting, _primary = cl.placement(1, 0)
    bad = []
    for oid, data in mirror.items():
        want = _shards_from_mirror(K, M, SU, data)
        for slot, osd in enumerate(acting):
            got = _stamp(cl.osds[osd].store, oid)
            if got is None or got[0] != slot or got[2] != want[slot]:
                bad.append((oid, slot, osd))
    return bad


async def _cluster(pkg: str, mirror: dict):
    mods = _mods(pkg)
    cl = cs.PGCluster(mods, N_OSDS, _profile(K, M, SU), K + M, K + 1, "cpu",
                      {"osd_ec_resident_bytes": 0})
    await cl.start()
    for oid, data in mirror.items():
        r = await cl.client.op(oid, [(mods.M.OSD_OP_WRITEFULL, 0, len(data),
                                      "", data)])
        assert r.result == 0
    return cl


def _park_grants(cl) -> list:
    """Hold every up_thru request (MOSDAlive) until ``_grant`` runs:
    the PG's peering waits in "peering" meanwhile."""
    parked = []

    async def park(m):
        parked.append(m)
    cl.monc.real_send_report = cl.monc.send_report
    cl.monc.send_report = park
    return parked


async def _grant(cl, parked: list) -> None:
    cl.monc.send_report = cl.monc.real_send_report
    for m in parked:
        await cl.monc.send_report(m)


def _upmap(cl, acting) -> None:
    """``ceph osd pg-upmap 1.0 <acting>``: the PG's acting set, as given."""
    from ceph_tpu_torch.osd.osdmap import Incremental
    from ceph_tpu_torch.osd.types import pg_t
    cl.apply(Incremental(epoch=cl.osdmap.epoch + 1,
                         new_pg_upmap={pg_t(1, 0): tuple(acting)}))


@pytest.mark.parametrize("pkg", PKGS)
def test_a_recovery_round_of_the_last_interval_leaves_the_new_one_peering(
        pkg):
    """The out OSD's slot goes to the spare while the primary still owes
    a survivor one object from the last interval, and that interval's
    recovery round starts only now, while the new interval waits on its
    up_thru grant (as the round the last activation scheduled, or a
    retry timer, can). The reference's round marks the PG clean, and
    the spare never gets the objects; the port's round leaves the state
    to the new interval's peering, which recovers the spare."""
    mirror = {"x": _data(1), "y": _data(2, 700)}

    async def go():
        cl = await _cluster(pkg, mirror)
        try:
            _up, acting, _p = cl.placement(1, 0)
            pg = cl.primary()
            spare = next(o for o in range(N_OSDS) if o not in acting)
            owed = acting[1]
            parked = _park_grants(cl)
            cl.replace(acting[-1], spare)
            await cs.wait_until(lambda: parked and pg.state == "peering",
                                30, lambda: pg.state)
            # the last interval's recovery of `owed` is still due
            pg.peer_missing = {owed: {"x": pg.pg_log.newest_per_object()[
                "x"]}}
            await pg._recover()
            after_round = pg.state
            await _grant(cl, parked)
            await cl.wait_state(("clean",), 30)
            # the new member's shards arrive with the new interval's
            # recovery, which the port's clean waits on
            return after_round, _wrong_slots(cl, mirror), spare
        finally:
            await cl.stop()
    after_round, bad, spare = asyncio.run(go())
    if pkg == "ceph_tpu":
        assert after_round == "clean"
        assert {(oid, osd) for oid, _slot, osd in bad} == \
            {("x", spare), ("y", spare)}
    else:
        assert after_round == "peering"
        assert bad == []


def _swap(cl, a: int, b: int) -> list:
    """Swap slots ``a`` and ``b`` of the acting set; the new set."""
    _up, acting, _p = cl.placement(1, 0)
    swapped = list(acting)
    swapped[a], swapped[b] = acting[b], acting[a]
    _upmap(cl, swapped)
    return swapped


async def _settled(cl, mirror: dict) -> None:
    """The primary's PG clean and every slot holding its own shard."""
    await cs.wait_until(
        lambda: getattr(cl.primary(), "state", None) == "clean" and
        not _wrong_slots(cl, mirror), 30,
        lambda: (getattr(cl.primary(), "state", None),
                 _wrong_slots(cl, mirror)))


def _seen(pg, name: str) -> asyncio.Event:
    """An event set once ``pg.<name>`` (a method) has run."""
    done = asyncio.Event()
    real = getattr(pg, name)

    def wrapper(*a, **kw):
        try:
            return real(*a, **kw)
        finally:
            done.set()
    setattr(pg, name, wrapper)
    return done


@pytest.mark.parametrize("pkg", PKGS)
def test_a_push_of_the_last_interval_is_dropped(pkg):
    """A push for slot 2 is built, the acting set swaps slots 1 and 2,
    the PG is clean again with every shard in its slot, and then the
    push lands on its target, now in slot 1. The reference stores
    position 2's bytes there; the port drops the push (it predates the
    target's interval)."""
    mirror = {"x": _data(3)}

    async def go():
        cl = await _cluster(pkg, mirror)
        try:
            _up, acting, _p = cl.placement(1, 0)
            pg = cl.primary()
            target = acting[2]
            push = await pg._build_backfill_push("x", target)
            swapped = _swap(cl, 1, 2)
            await cs.wait_until(lambda: cl.placement(1, 0)[1] == swapped,
                                30, lambda: cl.placement(1, 0))
            await _settled(cl, mirror)
            applied = _seen(cl.pg(target), "apply_push")
            await pg.osd.send_osd(target, push)
            await asyncio.wait_for(applied.wait(), 30)
            return _wrong_slots(cl, mirror), target
        finally:
            await cl.stop()
    bad, target = asyncio.run(go())
    if pkg == "ceph_tpu":
        assert bad == [("x", 1, target)]
    else:
        assert bad == []


@pytest.mark.parametrize("pkg", PKGS)
def test_clean_waits_for_the_shards_of_moved_holders(pkg, monkeypatch):
    """Slots 1 and 2 swap holders, whose position fixes wait on an event
    (they have not run when recovery ends). The reference marks the PG
    clean with each slot holding the other's position; the port's
    recovery rebuilds both slots before the PG is clean."""
    mods = _mods(pkg)
    mirror = {"x": _data(4), "y": _data(5, 300)}
    real_fix = mods.ECPG._fix_shard_positions

    async def go():
        release = asyncio.Event()

        async def held(self):
            await release.wait()
            await real_fix(self)
        cl = await _cluster(pkg, mirror)
        monkeypatch.setattr(mods.ECPG, "_fix_shard_positions", held)
        try:
            before = cl.primary().interval_start
            swapped = _swap(cl, 1, 2)
            await cs.wait_until(
                lambda: cl.primary().interval_start > before and
                cl.primary().state == "clean", 30,
                lambda: (cl.primary().state, cl.primary().interval_start))
            at_clean = _wrong_slots(cl, mirror)
            release.set()
            await _settled(cl, mirror)
            return at_clean, swapped
        finally:
            release.set()
            await cl.stop()
    at_clean, swapped = asyncio.run(go())
    if pkg == "ceph_tpu":
        assert sorted(at_clean) == sorted(
            (oid, slot, swapped[slot]) for oid in mirror for slot in (1, 2))
    else:
        assert at_clean == []


@pytest.mark.parametrize("pkg", PKGS)
def test_a_position_fix_yields_to_a_write_that_landed(pkg):
    """Slots 1 and 2 swap holders; the holder now in slot 1 reads the
    sources of its position fix of ``x``, then a client rewrites ``x``
    (the new bytes reach slot 1 by the write's sub-op) before the fix
    lands. The reference's fix stores the old version's bytes over the
    new; the port's fix sees the shard was written and drops its
    rebuild."""
    mods = _mods(pkg)
    mirror = {"x": _data(6)}

    async def go():
        cl = await _cluster(pkg, mirror)
        try:
            _up, acting, _p = cl.placement(1, 0)
            mover = cl.pg(acting[2])
            read, go_on = asyncio.Event(), asyncio.Event()
            real_gather = mover._gather

            async def gather(oid, *a, exclude_osds=frozenset(), **kw):
                out = await real_gather(oid, *a, exclude_osds=exclude_osds,
                                        **kw)
                if mover.osd.whoami in exclude_osds and not go_on.is_set():
                    read.set()
                    await go_on.wait()
                return out
            mover._gather = gather
            primary = cl.primary()
            if hasattr(primary, "_stale_positions"):
                # the port's recovery rebuilds moved shards too: its
                # check waits until the write below has landed
                real_check = primary._stale_positions

                async def check():
                    await go_on.wait()
                    return await real_check()
                primary._stale_positions = check
            _swap(cl, 1, 2)
            await asyncio.wait_for(read.wait(), 30)
            # the holder now in slot 2 has finished its own fix
            other = cl.osds[acting[1]].store
            await cs.wait_until(lambda: _stamp(other, "x")[0] == 2, 30,
                                lambda: _stamp(other, "x")[:2])
            mirror["x"] = _data(7)
            r = await cl.client.op("x", [(mods.M.OSD_OP_WRITEFULL, 0,
                                          len(mirror["x"]), "",
                                          mirror["x"])])
            assert r.result == 0
            go_on.set()
            await cs.wait_until(lambda: mover._posfix_task.done(), 30,
                                lambda: "the position fix still runs")
            return _stamp(mover.osd.store, "x")[1], \
                _stamp(cl.osds[acting[1]].store, "x")[1]
        finally:
            await cl.stop()
    mine, peer = asyncio.run(go())
    if pkg == "ceph_tpu":
        assert mine < peer             # the old version, over the new
    else:
        assert mine == peer


@pytest.mark.parametrize("pkg", PKGS)
def test_a_push_older_than_the_shard_is_dropped(pkg):
    """A push for slot 2 is built, then a client rewrites ``x`` (the new
    version reaches slot 2 by the write's sub-op), then the push lands.
    The reference stores the old version's bytes over the new; the port
    drops the push (it is older than the shard it would replace)."""
    mods = _mods(pkg)
    mirror = {"x": _data(8)}

    async def go():
        cl = await _cluster(pkg, mirror)
        try:
            _up, acting, _p = cl.placement(1, 0)
            pg = cl.primary()
            target = acting[2]
            push = await pg._build_backfill_push("x", target)
            mirror["x"] = _data(9)
            r = await cl.client.op("x", [(mods.M.OSD_OP_WRITEFULL, 0,
                                          len(mirror["x"]), "",
                                          mirror["x"])])
            assert r.result == 0
            applied = _seen(cl.pg(target), "apply_push")
            await pg.osd.send_osd(target, push)
            await asyncio.wait_for(applied.wait(), 30)
            return _wrong_slots(cl, mirror), target
        finally:
            await cl.stop()
    bad, target = asyncio.run(go())
    if pkg == "ceph_tpu":
        assert bad == [("x", 2, target)]
    else:
        assert bad == []
