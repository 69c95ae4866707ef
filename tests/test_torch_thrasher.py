"""The port's seeded Thrasher (``ceph_tpu_torch/sim/thrasher.py``):
``tests/test_thrasher.py``'s cases.

``Thrasher.plan`` is a pure function of the seed, so both packages give
equal schedules for seeds 7 and 8 (and the two seeds differ). The live
storms run on the port's ``Cluster(device="cpu")`` alone and are held to
the reference's own invariants: after a seeded storm of OSD
kill/revive-with-remount on BlueStore, partitions, lossy links and a
lead-mon kill under continuing writes, the cluster converges clean,
every acknowledged write reads back bit-identical and every store fscks
clean; after the snapshot storm, every snapshot reads back as captured
and the head holds every acked write. The reference runs its own storms
in its own file. Deep variants are ``slow``, as in the reference.
"""

import asyncio

import pytest

from ceph_tpu.sim.thrasher import Thrasher as RefThrasher
from ceph_tpu_torch.cluster.vstart import Cluster
from ceph_tpu_torch.os_.bluestore import BlueStore
from ceph_tpu_torch.sim import Thrasher

RUN_LIMIT = 300.0      # s; a stuck script fails instead of holding its worker


def run(coro, limit: float = RUN_LIMIT):
    return asyncio.run(asyncio.wait_for(coro, limit))


@pytest.mark.parametrize("seed", [7, 8])
def test_plan_equals_the_reference(seed):
    a = Thrasher.plan(seed, 40)
    assert a == RefThrasher.plan(seed, 40)
    assert a == Thrasher.plan(seed, 40)
    assert a != Thrasher.plan(seed + 1, 40)
    assert len(a) == 40
    kinds = {x["op"] for x in a}
    assert "kill_osd" in kinds and "partition" in kinds


def _mk_store(tmp_path, i):
    return BlueStore(str(tmp_path / f"osd{i}" / "bs"))


def _thrash_cluster_config():
    return {
        "mon_osd_down_out_interval": 600.0,
        "mon_osd_min_down_reporters": 2,
        # the reference's production-shaped mon timing, so elections
        # don't loop under recovery load
        "mon_lease": 4.0, "mon_lease_interval": 0.5,
        "mon_election_timeout": 1.0, "mon_paxos_timeout": 8.0,
    }


def test_thrasher_smoke_seeded(tmp_path):
    """Short seeded storm on BlueStore with revive-via-remount and a
    mon-leader kill in the mix: the four Thrasher invariants hold."""
    async def go():
        stores = [_mk_store(tmp_path, i) for i in range(4)]
        c = await Cluster(n_mons=3, n_osds=4, stores=stores,
                          config=_thrash_cluster_config(),
                          device="cpu").start()
        try:
            await c.client.pool_create("t", pg_num=8, size=3,
                                       min_size=2)
            await c.wait_for_clean(timeout=240)
            io = await c.client.open_ioctx("t")

            def remount(i):
                return _mk_store(tmp_path, i)

            th = Thrasher(c, seed=1234, store_factory=remount,
                          min_live_osds=3)
            log = await th.thrash(io, steps=14)
            assert log, "thrasher executed nothing"
            assert len(log) == 14
            summary = await th.settle_and_verify(io, timeout=240)
            assert summary["acked_writes"] > 0
            assert summary["fscked_stores"] == 4
        finally:
            await c.stop()
    run(go())


@pytest.mark.slow
def test_thrasher_storm_deep(tmp_path):
    async def go():
        stores = [_mk_store(tmp_path, i) for i in range(5)]
        c = await Cluster(n_mons=3, n_osds=5, stores=stores,
                          config=_thrash_cluster_config(),
                          device="cpu").start()
        try:
            await c.client.pool_create("t", pg_num=16, size=3,
                                       min_size=2)
            await c.wait_for_clean(timeout=240)
            io = await c.client.open_ioctx("t")

            def remount(i):
                return _mk_store(tmp_path, i)

            th = Thrasher(c, seed=99, store_factory=remount,
                          min_live_osds=3)
            await th.thrash(io, steps=70)
            summary = await th.settle_and_verify(io, timeout=600)
            assert summary["acked_writes"] > 10
            assert summary["fscked_stores"] == 5
        finally:
            await c.stop()
    run(go(), 1800.0)


def test_thrasher_snap_storm_smoke():
    """Snapshot-under-load honesty (MemStore): snapshots cut mid-storm,
    an OSD killed after the first and revived; every snapshot re-reads
    byte-identical and the head holds every acked write."""
    async def go():
        c = await Cluster(n_mons=3, n_osds=3,
                          config=_thrash_cluster_config(),
                          device="cpu").start()
        try:
            await c.client.pool_create("rbd", pg_num=8, size=3,
                                       min_size=2)
            await c.wait_for_clean(timeout=240)
            io = await c.client.open_ioctx("rbd")
            th = Thrasher(c, seed=4242, min_live_osds=2)
            report = await th.snap_storm(io, writes=18, snaps=3,
                                         image_kb=16)
            assert report["snaps_verified"] == 3
            assert report["victim"] is not None, \
                "storm never exercised the OSD-kill path"
            assert report["acked_writes"] > 0
            summary = await th.settle_and_verify(io, timeout=240)
            assert summary["killed_mons"] == 0
        finally:
            await c.stop()
    run(go())


@pytest.mark.slow
def test_thrasher_snap_storm_deep(tmp_path):
    async def go():
        stores = [_mk_store(tmp_path, i) for i in range(4)]
        c = await Cluster(n_mons=3, n_osds=4, stores=stores,
                          config=_thrash_cluster_config(),
                          device="cpu").start()
        try:
            await c.client.pool_create("rbd", pg_num=8, size=3,
                                       min_size=2)
            await c.wait_for_clean(timeout=240)
            io = await c.client.open_ioctx("rbd")

            def remount(i):
                return _mk_store(tmp_path, i)

            th = Thrasher(c, seed=777, store_factory=remount,
                          min_live_osds=3)
            report = await th.snap_storm(io, writes=48, snaps=5,
                                         image_kb=64,
                                         settle_timeout=600.0)
            assert report["snaps_verified"] == 5
            assert report["victim"] is not None
            summary = await th.settle_and_verify(io, timeout=600)
            assert summary["fscked_stores"] == 4
        finally:
            await c.stop()
    run(go(), 1800.0)
