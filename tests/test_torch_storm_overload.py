"""``Thrasher.overload_storm`` on the port: the storm cases of
``tests/test_overload.py``.

On the port's ``Cluster(device="cpu")`` alone, held to the reference's
own invariants: prefill, shrink ``osd_capacity_bytes`` until the mon's
fullness sweep trips the cluster FULL flag under concurrent writers;
the writers park on the objecter's flag wait-queue with zero errors and
no new write acked against the full cluster; restoring the capacity
drains every parked write, and the cluster converges clean with every
acked write readable bit-identical (``settle_and_verify``). The deep
variant, on BlueStore, is ``slow`` as in the reference.
"""

import asyncio

import pytest

from ceph_tpu_torch.cluster.vstart import Cluster
from ceph_tpu_torch.sim import Thrasher

RUN_LIMIT = 300.0      # s; a stuck script fails instead of holding its worker


def run(coro, limit: float = RUN_LIMIT):
    return asyncio.run(asyncio.wait_for(coro, limit))


def test_overload_storm_smoke():
    async def go():
        c = await Cluster(n_mons=1, n_osds=3, device="cpu").start()
        try:
            await c.client.pool_create("storm", pg_num=4)
            await c.wait_for_clean(timeout=120)
            io = await c.client.open_ioctx("storm")
            th = Thrasher(c, seed=11, min_live_osds=3)
            res = await th.overload_storm(io, writers=3,
                                          write_bytes=1024,
                                          prefill=16, hold_s=0.6)
            assert res["errors"] == 0
            assert res["parked_at_full"] == 3
            summary = await th.settle_and_verify(io, timeout=120)
            assert summary["acked_writes"] == res["acked_writes"]
        finally:
            await c.stop()
    run(go())


@pytest.mark.slow
def test_overload_storm_deep(tmp_path):
    from ceph_tpu_torch.os_.bluestore import BlueStore

    async def go():
        stores = [BlueStore(str(tmp_path / f"osd{i}")) for i in range(3)]
        c = await Cluster(n_mons=1, n_osds=3, stores=stores,
                          device="cpu").start()
        try:
            await c.client.pool_create("storm", pg_num=8)
            await c.wait_for_clean(timeout=240)
            io = await c.client.open_ioctx("storm")
            th = Thrasher(c, seed=4242, min_live_osds=3)
            res = await th.overload_storm(io, writers=6,
                                          write_bytes=4096,
                                          prefill=64, hold_s=2.0,
                                          full_timeout=60.0,
                                          drain_timeout=120.0)
            assert res["errors"] == 0
            summary = await th.settle_and_verify(io, timeout=300)
            assert summary["acked_writes"] == res["acked_writes"]
            assert summary["fscked_stores"] == 3
        finally:
            await c.stop()
    run(go(), 1800.0)
