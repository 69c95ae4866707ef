"""``Thrasher.mds_storm`` on the port: the storm cases of
``tests/test_mds_failover.py`` and ``tests/test_multimds.py``.

Each runs on the port's ``Cluster(device="cpu")`` alone and is held to
the reference's own invariants, which ``mds_storm`` asserts inside: a
standby takes the killed active's rank within the takeover timeout, no
writer op errors across the failover, every acked file reads back
bit-identical, and the killed incarnation's late journal write bounces
off the blocklist (-EBLOCKLISTED). The multi-active case adds that the
surviving rank's writer keeps acking during the takeover. The last case
runs the storm on the proc backend (``ProcCluster``, every daemon its
own process, on the CPU), where the MDS verbs go over the wire and the
zombie is a client under the killed process's RADOS identity, as
``chip_smoke.py``'s ``storm_path`` runs it on the card. The deep variant
is ``slow``, as in the reference.
"""

import asyncio
import json

import pytest

from ceph_tpu_torch.cephfs.client import CephFSClient
from ceph_tpu_torch.cephfs.mds import MDS_PERF
from ceph_tpu_torch.cluster.vstart import Cluster
from ceph_tpu_torch.sim import Thrasher

RUN_LIMIT = 300.0      # s; a stuck script fails instead of holding its worker

FAST_CFG = {
    "mds_beacon_interval": 0.2,
    "mds_beacon_grace": 2.0,
    "mds_reconnect_timeout": 1.0,
    "mds_replay_interval": 0.1,
}


def run(coro, limit: float = RUN_LIMIT):
    return asyncio.run(asyncio.wait_for(coro, limit))


async def _wait_health(c, check: str, timeout: float = 15.0) -> dict:
    deadline = asyncio.get_event_loop().time() + timeout
    while True:
        st = await c.client.status()
        if check in st["health"]["checks"]:
            return st
        assert asyncio.get_event_loop().time() < deadline, \
            (check, st["health"])
        await asyncio.sleep(0.2)


async def _client(c, **kw):
    return await CephFSClient.create(c.client.monc.monmap, None, "cephfs",
                                     keyring=c.keyring, device="cpu", **kw)


def test_mds_failover_storm_acceptance():
    """kill -9 the active under concurrent metadata I/O; a cap held open
    across the failover stays valid and writable against the successor."""
    async def go():
        c = await Cluster(n_mons=1, n_osds=3, config=FAST_CFG,
                          device="cpu").start()
        try:
            await c.start_fs(n_mds=2)
            cl1, cl2 = await _client(c), await _client(c)
            held = await cl1.open_file("/held.txt", "w")
            await held.write(b"pre-failover")
            t0 = MDS_PERF.dump().get("takeovers", 0)
            th = Thrasher(c, seed=11)
            res = await th.mds_storm([cl1, cl2], writes=10,
                                     files_before_kill=2)
            assert res["errors"] == 0 and res["acked_writes"] >= 10
            assert MDS_PERF.dump().get("takeovers", 0) > t0
            assert held.valid
            await held.write(b"post-failover")
            assert await cl2.read_file("/held.txt") == b"post-failover"
            st = await _wait_health(c, "MDS_INSUFFICIENT_STANDBY")
            assert st["fsmap"]["active"] is not None
            assert st["fsmap"]["standby_count"] == 0
            ret, _, out = await c.client.mon_command(
                {"prefix": "fs status"})
            assert ret == 0
            dump = json.loads(out)
            assert dump["ranks"][0]["state"] == "active"
            assert dump["last_failure_osd_epoch"] > 0
            assert dump["stopped_gids"]           # zombie tombstoned
            await cl1.unmount()
            await cl2.unmount()
        finally:
            await c.stop()
    run(go())


def test_multi_active_disjoint_subtrees_kill_one_active():
    """Two actives on disjoint subtrees, kill -9 the rank-1 active: the
    rank-0 writer keeps acking during the takeover, no writer errors."""
    async def go():
        c = await Cluster(n_mons=1, n_osds=3,
                          config=dict(FAST_CFG, mds_bal_interval=0.0),
                          device="cpu").start()
        try:
            await c.start_fs(n_mds=3, max_mds=2)
            cl0, cl1 = await _client(c), await _client(c)
            await cl0.mkdir("/w0")
            await cl0.mkdir("/w1")
            await c.subtree_pin("/w1", 1)
            ret, _, out = await c.client.mon_command(
                {"prefix": "fs subtree ls"})
            sub = json.loads(out)
            assert sub["subtrees"]["/w1"] == 1 and not sub["migrations"]
            th = Thrasher(c, seed=31)
            res = await th.mds_storm(
                [cl0, cl1], writes=12, files_before_kill=4,
                kill_rank=1, writer_dirs=["/w0", "/w1"],
                survivor_writers=[0])
            assert res["errors"] == 0
            assert res["acked_writes"] == 2 * 12
            st = json.loads((await c.client.mon_command(
                {"prefix": "fs dump"}))[2])
            ranks = {r["rank"]: r for r in st["ranks"]}
            assert ranks[0]["state"] == "active"
            assert ranks[1]["state"] == "active"
            assert st["subtrees"]["/w1"] == 1
            assert st["last_failure_osd_epoch"] > 0
            probe = await _client(c)
            assert set(await probe.ls("/w1")) >= {
                f"mds-storm-31-1-{i:04d}" for i in range(12)}
            for cl in (cl0, cl1, probe):
                await cl.unmount()
        finally:
            await c.stop()
    run(go())


@pytest.mark.slow
def test_mds_storm_deep():
    """Three daemons, two consecutive kill -9 failovers under sustained
    multi-client I/O with standby_replay, then an operator `mds fail`."""
    async def go():
        c = await Cluster(n_mons=1, n_osds=3,
                          config=dict(FAST_CFG, mds_standby_replay=True),
                          device="cpu").start()
        try:
            await c.start_fs(n_mds=3)
            clients = [await _client(c) for _ in range(3)]
            th = Thrasher(c, seed=23)
            res = await th.mds_storm(clients, writes=40,
                                     files_before_kill=4, kills=2)
            assert res["errors"] == 0
            assert res["acked_writes"] >= 3 * 40
            await c.revive_mds("d")
            last = c.mds_active_name()
            ret, rs, _ = await c.client.mon_command(
                {"prefix": "mds fail", "who": last})
            assert ret == 0, rs
            newa = await c.wait_for_mds_active(not_name=last, timeout=30)
            assert newa != last
            await clients[0].write_file("/final.txt", b"done")
            assert await clients[1].read_file("/final.txt") == b"done"
            for cl in clients:
                await cl.unmount()
        finally:
            await c.stop()
    run(go(), 1800.0)


def test_mds_storm_on_the_proc_backend():
    """The storm on separate processes: the proc MDS children's active is
    SIGKILLed, a standby takes rank 0, the writers lose nothing, and a
    client under the dead incarnation's identity is fenced. The
    supervisor's respawn of the killed MDS joins as a standby."""
    async def go():
        c = Cluster(n_mons=1, n_osds=3, config=FAST_CFG, backend="proc",
                    device="cpu")
        for name in ("client.fs0", "client.fs1"):   # known to the mon
            c.keyring.add(name)
        await c.start()
        try:
            await c.start_fs(n_mds=2, pg_num=8)
            assert len(c.mdss) == 2
            cl1 = await _client(c, name="client.fs0")
            cl2 = await _client(c, name="client.fs1")
            th = Thrasher(c, seed=5)
            res = await th.mds_storm([cl1, cl2], writes=8,
                                     files_before_kill=2,
                                     takeover_timeout=60.0)
            assert res["errors"] == 0 and res["acked_writes"] == 16
            killed = [ln for ln in th.actions_log if "kill -9" in ln]
            assert len(killed) == 1
            victim = killed[0].split("mds.")[1].split()[0]
            assert await c.mds_active_name() not in (None, victim)
            await c.wait_for_restart(f"mds.{victim}", 0, timeout=60.0)
            await _wait_standby(c, 1)
            await cl1.unmount()
            await cl2.unmount()
        finally:
            await c.stop()
    run(go())


async def _wait_standby(c, n: int, timeout: float = 60.0) -> None:
    deadline = asyncio.get_event_loop().time() + timeout
    while True:
        fm = (await c.client.status()).get("fsmap") or {}
        if fm.get("standby_count") == n:
            return
        assert asyncio.get_event_loop().time() < deadline, fm
        await asyncio.sleep(0.2)


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_a_client_sees_the_failover_after_its_mon_died(pkg):
    """The fault ``storm_path`` found (ROADMAP Queue C): a CephFS client
    holds its mdsmap subscription on one mon, and when that mon dies the
    subscription dies with it. Then the active MDS is killed. The port's
    client renews its subscriptions in its lease loop, learns the new
    map and writes through the successor; the reference's never renews,
    and is still on the old map after twice the renewal period (pinned)."""
    if pkg == "ref":
        from ceph_tpu.cephfs.client import CephFSClient as Client
        from ceph_tpu.cluster.vstart import Cluster as Cl
        kw = {}
    else:
        Client, Cl, kw = CephFSClient, Cluster, {"device": "cpu"}

    async def go():
        c = await Cl(n_mons=3, n_osds=3, config=FAST_CFG, **kw).start()
        try:
            await c.start_fs(n_mds=2)
            cl = await Client.create(c.client.monc.monmap, None, "cephfs",
                                     keyring=c.keyring, **kw)
            await cl.write_file("/before", b"x")
            rank = cl._own_rados.monc._sub_rank
            await c.mons[rank].stop()
            await c.wait_for_quorum(2, timeout=60)
            victim = c.mds_active_name()
            await c.kill_mds(victim)
            await c.wait_for_mds_active(not_name=victim, timeout=30)
            want = c.leader().mdsmon.fsmap.epoch
            deadline = asyncio.get_event_loop().time() + 12.0
            while cl.fsmap.epoch < want and \
                    asyncio.get_event_loop().time() < deadline:
                await asyncio.sleep(0.2)
            if pkg == "ref":
                assert cl.fsmap.epoch < want
            else:
                assert cl.fsmap.epoch >= want
                await asyncio.wait_for(cl.write_file("/after", b"y"), 30)
                assert await cl.read_file("/before") == b"x"
                await cl.unmount()
        finally:
            await c.stop()
    run(go())
