"""``Thrasher.elastic_storm`` on the port: the storm cases of
``tests/test_elastic.py``.

On the port's ``Cluster(device="cpu")`` alone, held to the reference's
own invariants, under a background writer: a mon is added at runtime,
the leader killed and re-elected among the three, the corpse removed;
a provisioned key serves I/O, the admin key rotates under live traffic
and the revoked client is fenced; the loaded pool splits and merges
back through the pg_num_pending barrier. Then every acked write reads
back bit-identical on a clean cluster (``settle_and_verify``). The deep
variant is ``slow``, as in the reference.
"""

import asyncio

import pytest

from ceph_tpu_torch.cluster.vstart import Cluster
from ceph_tpu_torch.sim import Thrasher

RUN_LIMIT = 300.0      # s; a stuck script fails instead of holding its worker


def run(coro, limit: float = RUN_LIMIT):
    return asyncio.run(asyncio.wait_for(coro, limit))


async def _pool_io(c, name="data", pg_num=4, size=2):
    await c.client.pool_create(name, pg_num=pg_num, size=size,
                               min_size=1)
    await c.wait_for_clean(timeout=240)
    return await c.client.open_ioctx(name)


def test_elastic_storm_smoke():
    async def go():
        c = await Cluster(n_mons=2, n_osds=3, device="cpu").start()
        try:
            io = await _pool_io(c)
            t = Thrasher(c, seed=7, min_live_osds=3)
            res = await t.elastic_storm(io, writes=24,
                                        phase_timeout=90.0)
            assert set(res["phases"]) == {"mon_cycle", "auth_cycle",
                                          "split_merge"}
            assert res["acked_writes"] > 0
            summary = await t.settle_and_verify(io, timeout=240)
            assert summary["acked_writes"] == res["acked_writes"]
        finally:
            await c.stop()
    run(go())


@pytest.mark.slow
def test_elastic_storm_deep():
    async def go():
        c = await Cluster(n_mons=2, n_osds=4, device="cpu").start()
        try:
            io = await _pool_io(c, pg_num=8, size=3)
            t = Thrasher(c, seed=23, min_live_osds=3)
            res = await t.elastic_storm(io, writes=200,
                                        phase_timeout=120.0)
            assert set(res["phases"]) == {"mon_cycle", "auth_cycle",
                                          "split_merge"}
            res2 = await t.elastic_storm(io, writes=260,
                                         mon_cycle=False,
                                         auth_cycle=False,
                                         phase_timeout=120.0)
            assert "split_merge" in res2["phases"]
            await t.settle_and_verify(io, timeout=300)
        finally:
            await c.stop()
    run(go(), 1800.0)
