"""``Thrasher.proc_storm`` on the port's proc backend: the storm phase of
``tests/test_proc_cluster.py``, and the pin of ``Rados.pool_create``.

The storm runs on a port ``ProcCluster`` (three mons, three OSDs, two
mgrs with prometheus; every daemon its own process, on the CPU) alone,
held to the reference's own invariants: with a continuous writer
running, one OSD, the lead mon and the active mgr are SIGKILLed in turn
and respawned by the supervisor, the standby mgr takes over and its
metrics fill again from fresh reports, and in the gray pass a SIGSTOPped
OSD trips ``OSD_SLOW``, which clears after SIGCONT. Then the cluster
goes clean with zero writer errors and every acked write bit-identical.
The OSD heartbeat grace is 10 s, as in the reference: it must outlast
the ``OSD_SLOW`` confirm window, or the frozen OSD is marked down first.

``Rados.pool_create`` returns only once the client's own osdmap holds
the new pool (the port's departure, as Ceph's Objecter waits for the
reply's epoch), so an ``open_ioctx`` right after it, with no wait in
between, finds the pool. The reference returns on the mon's reply, and
there its ``open_ioctx`` can raise ``no pool 't'``: the flake of
``test_proc_cluster_storm_and_live_config``.
"""

import asyncio

from ceph_tpu_torch.cluster.vstart import Cluster
from ceph_tpu_torch.sim import Thrasher

RUN_LIMIT = 300.0      # s; a stuck script fails instead of holding its worker


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, RUN_LIMIT))


def test_pool_create_then_open_ioctx_with_no_wait():
    async def go():
        c = Cluster(n_mons=1, n_osds=3, backend="proc", device="cpu")
        await c.start()
        try:
            for i, name in enumerate(("a", "b", "c")):
                await c.client.pool_create(name, pg_num=8, size=3)
                assert name in {p.name for p in
                                c.client.monc.osdmap.pools.values()}
                io = await c.client.open_ioctx(name)
                assert io.pool_name == name
            await c.wait_for_clean(timeout=120)
            await io.write_full("o", b"x" * 100)
            assert await io.read("o") == b"x" * 100
        finally:
            await c.stop()
    run(go())


async def _start(make):
    """Starts a fresh cluster once more if the first start fails: three
    mons started at once can elect two leaders, a reference elector
    fault that the port keeps and pins (ROADMAP Queue C)."""
    c = make()
    try:
        await c.start()
        return c
    except Exception:
        await c.stop()
    c = make()
    try:
        await c.start()
    except BaseException:
        await c.stop()
        raise
    return c


def test_proc_storm_with_the_gray_pass():
    async def go():
        c = await _start(lambda: Cluster(
            n_mons=3, n_osds=3, n_mgrs=2, mgr_modules=["prometheus"],
            config={"osd_heartbeat_grace": 10.0}, backend="proc",
            device="cpu"))
        try:
            await c.client.pool_create("t", pg_num=16, size=3)
            io = await c.client.open_ioctx("t")
            th = Thrasher(c, seed=7, write_timeout=30.0)
            summary = await th.proc_storm(io, settle_timeout=180.0,
                                          gray=True)
            assert summary["acked_writes"] > 0
            assert summary["failed_writes"] == 0
            assert sum(summary["restarts"].values()) >= 2
            assert summary["killed_mons"] == 1
            assert summary["mgr_failover"] is not None
            log = " | ".join(th.actions_log)
            assert "SIGKILL osd.2" in log and "SIGSTOP osd.0" in log, log
        finally:
            await c.stop()
    run(go())
