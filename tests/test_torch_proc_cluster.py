"""tests/test_proc_cluster.py's two cases on the port: the supervised
multi-process backend (``ceph_tpu_torch/cluster/proc.py``) with every
child on the CPU, and the wire-delivered live config on the in-process
backend.

The proc case shares one spawned cluster, as the reference's does:

  1. live ``config set`` lands typed inside every remote OSD process
     without a restart; ``config rm`` restores the default;
  2. per-entity beats per-type across real processes;
  3. a SIGKILLed OSD is respawned by the supervisor and boots again from
     its WALStore, a SIGTERMed one announces its departure, and every
     acknowledged write reads back; fault verbs answer on a child's
     admin socket.

The reference's third phase is the Thrasher's storm with a mgr, which
is ``test_torch_storm_proc.py`` here; the proc mgr and mds children have
cases of their own here (two mgrs, a SIGKILL of the active, the
standby's takeover; ``start_fs`` with two MDSs, a SIGKILL of the active,
the standby's takeover with a client's files intact). The reference's three mons were there for the storm's
lead-mon kill, so the first case runs one (three mons
started at once can elect two leaders, a reference fault the port keeps:
ROADMAP Queue C). The reference case flakes on "no pool 't'" right after
``pool_create``; the port's ``pool_create`` returns only once the
client's own map holds the pool (pinned in ``test_torch_storm_proc.py``).
"""

import asyncio

import pytest

from ceph_tpu_torch.cluster.vstart import Cluster


def run(coro):
    return asyncio.run(coro)


async def _wait(pred, timeout=30.0):
    t0 = asyncio.get_event_loop().time()
    while True:
        if await pred():
            return
        if asyncio.get_event_loop().time() - t0 > timeout:
            raise TimeoutError
        await asyncio.sleep(0.25)


async def _osd_cfg(c, osd_id: int, name: str):
    out = await c.daemon_command(f"osd.{osd_id}", "config show")
    return out.get(name)


def test_proc_cluster_restarts_and_live_config():
    async def go():
        c = Cluster(n_mons=1, n_osds=3,
                    config={"osd_heartbeat_grace": 10.0},
                    backend="proc", device="cpu")
        assert c.backend == "proc"
        await c.start()
        try:
            assert c.spawn_to_healthy_s is not None
            await c.client.pool_create("t", pg_num=16, size=3)
            await c.wait_for_clean(timeout=120)
            io = await c.client.open_ioctx("t")
            acked = {}
            for i in range(8):
                acked[f"o{i}"] = bytes([i]) * 700
                await io.write_full(f"o{i}", acked[f"o{i}"])

            # -- 1: live config lands typed, no restart ----------------
            pids = {n: ch.pid for n, ch in c.children.items()
                    if n.startswith("osd.")}
            await c.config_set("osd", "osd_max_backfills", "7")

            async def landed():
                for i in range(3):
                    if await _osd_cfg(c, i, "osd_max_backfills") != 7:
                        return False
                return True
            await _wait(landed)
            assert pids == {n: ch.pid for n, ch in c.children.items()
                            if n.startswith("osd.")}

            # -- 2: most-specific wins across process boundaries -------
            await c.config_set("osd.0", "osd_max_backfills", "3")

            async def split():
                return (await _osd_cfg(c, 0, "osd_max_backfills") == 3
                        and await _osd_cfg(
                            c, 1, "osd_max_backfills") == 7)
            await _wait(split)
            await c.config_rm("osd.0", "osd_max_backfills")
            await c.config_rm("osd", "osd_max_backfills")

            async def restored():
                for i in range(3):
                    v = await _osd_cfg(c, i, "osd_max_backfills")
                    if v not in (None, 1):
                        return False
                return True
            await _wait(restored)

            # -- 3: a crash is respawned; fault verbs per process ------
            out = await c.daemon_command(
                "osd.2", {"prefix": "fault install", "name": "lag",
                          "rules": [{"kind": "delay", "a": "osd.2",
                                     "b": "client.*", "min_s": 0.0,
                                     "max_s": 0.0}]})
            assert out == {"installed": "lag", "rules": 1}
            assert "lag" in await c.daemon_command("osd.2", "fault ls")
            before = c.children["osd.1"].restarts
            c.kill_osd(1)
            await c.wait_for_restart("osd.1", before, timeout=60)
            st = await c.wait_for_daemon_ready("osd.1", timeout=60)
            assert st["up"]
            await c.wait_for_clean(timeout=120)
            await io.write_full("after-crash", b"x" * 100)
            acked["after-crash"] = b"x" * 100
            for oid, data in acked.items():
                assert await io.read(oid) == data, oid
            # graceful stop: the OSD marks itself down and stays down
            await c.stop_daemon("osd.2")
            await _wait(lambda: _num_up(c, 2), timeout=30)
            assert c.children["osd.2"].proc.returncode == 0
            for oid, data in acked.items():
                assert await io.read(oid) == data, oid
        finally:
            await c.stop()
    run(go())


async def _num_up(c, n: int) -> bool:
    st = await c.client.status()
    return st.get("osdmap", {}).get("num_up_osds") == n


def test_unported_kinds_raise():
    """No daemon kind is left unported: the vstart module has no
    ``not_ported`` any more, both backends accept the mgr kinds, and the
    in-process ``start_fs``/``add_mds`` boot MDSs on the cluster's
    device (the proc backend's mds kind has its case below)."""
    from ceph_tpu_torch.cluster import proc, vstart
    assert not hasattr(vstart, "not_ported")
    assert not hasattr(proc, "not_ported")
    Cluster(n_mons=1, n_osds=1, mgr_modules=["prometheus"],
            backend="proc", device="cpu")
    Cluster(n_mons=1, n_osds=1, mgr_modules=[], device="cpu")

    async def go():
        c = await Cluster(n_mons=1, n_osds=1, device="cpu").start()
        try:
            await c.client.pool_create("cephfs", pg_num=4, size=1,
                                       min_size=1)
            await c.wait_for_clean(timeout=60)
            c.fs_pool = "cephfs"
            mds = await c.add_mds("a")
            await c.wait_for_mds_active(timeout=30)
            assert c.mds_active_name() == "a"
            assert mds.device.type == "cpu"
        finally:
            await c.stop()
    run(go())


def test_proc_mds_children_and_failover():
    """``ProcCluster.start_fs`` with two mds children (gid = pid, on the
    conf's device): one goes active, its admin socket answers with its
    identity and the fault verbs, a client's files survive a SIGKILL of
    the active, and the standby takes rank 0 by beacon grace."""
    from ceph_tpu_torch.cephfs.client import CephFSClient

    async def go():
        c = Cluster(n_mons=1, n_osds=3, backend="proc", device="cpu",
                    config={"mds_beacon_grace": 3.0})
        await c.start()
        try:
            await c.start_fs(n_mds=2, pg_num=8)
            st = await c.client.status()
            first = st["fsmap"]["active"]
            name = f"mds.{first}"
            ident = await c.daemon_command(name, "status")
            assert ident == {"name": first, "gid": c.children[name].pid,
                             "state": "active"}
            assert await c.daemon_command(name, "fault ls") == {}
            cl = await CephFSClient.create(c.monmap, None, "cephfs",
                                           keyring=c.keyring,
                                           name="client.admin",
                                           device="cpu")
            await cl.mkdir("/d")
            await cl.write_file("/d/f", b"before the kill")
            c.kill_daemon(name)

            async def taken_over():
                fm = (await c.client.status()).get("fsmap") or {}
                return fm.get("active") not in (None, first)
            await _wait(taken_over, timeout=45.0)
            second = (await c.client.status())["fsmap"]["active"]
            st2 = await c.daemon_command(f"mds.{second}", "status")
            assert st2["state"] == "active"
            assert st2["gid"] == c.children[f"mds.{second}"].pid
            assert await cl.read_file("/d/f") == b"before the kill"
            await cl.write_file("/d/g", b"after")
            assert await cl.ls("/d") == ["f", "g"]
            await cl.unmount()
        finally:
            await c.stop()
    run(go())


def test_proc_mgr_children_and_failover():
    """Two proc mgr children (modules resolved by NAME, gid = pid, on
    the conf's device): the first beacon goes active, its admin socket
    answers with the mgr's state and the fault verbs, and a SIGKILL of
    the active fails over to the standby by beacon grace."""
    async def go():
        c = Cluster(n_mons=1, n_osds=2, n_mgrs=2,
                    mgr_modules=["balancer", "prometheus", "progress"],
                    backend="proc", device="cpu")
        await c.start()        # returns once a mgr is active
        try:
            first = await c.wait_for_mgr_active(timeout=30)
            name = f"mgr.{first}"

            async def promoted(n):
                # the child promotes once its own MgrMap names it
                return (await c.daemon_command(n, "status"))["active"]
            await _wait(lambda: promoted(name))
            st = await c.daemon_command(name, "status")
            assert st["name"] == first
            assert st["gid"] == c.children[name].pid
            assert st["modules"] == ["balancer", "prometheus", "progress"]
            assert await c.daemon_command(name, "fault ls") == {}
            killed = await c.kill_active_mgr()
            assert killed == name
            second = await c.wait_for_mgr_active(not_name=first,
                                                 timeout=30)
            assert second != first
            await _wait(lambda: promoted(f"mgr.{second}"))
            st2 = await c.daemon_command(f"mgr.{second}", "status")
            assert st2["gid"] == c.children[f"mgr.{second}"].pid
        finally:
            await c.stop()
    run(go())


def test_live_config_set_inproc():
    async def go():
        c = Cluster(n_mons=1, n_osds=2, device="cpu")
        await c.start()
        try:
            ret, rs, _ = await c.client.mon_command(
                {"prefix": "config set", "who": "osd",
                 "name": "osd_max_backfills", "value": "5"})
            assert ret == 0, rs

            async def landed():
                return all(o.config.get("osd_max_backfills") == 5
                           for o in c.osds)
            await _wait(landed, timeout=15.0)
            ret, _, out = await c.client.mon_command(
                {"prefix": "config get", "who": "osd",
                 "name": "osd_max_backfills"})
            assert ret == 0 and out == b"5"
            ret, rs, _ = await c.client.mon_command(
                {"prefix": "config rm", "who": "osd",
                 "name": "osd_max_backfills"})
            assert ret == 0, rs

            async def restored():
                return all(o.config.get("osd_max_backfills") in (None, 1)
                           for o in c.osds)
            await _wait(restored, timeout=15.0)
            ret, rs, _ = await c.client.mon_command(
                {"prefix": "config set", "who": "osd",
                 "name": "osd_max_backfills", "value": "not-an-int"})
            assert ret == -22
        finally:
            await c.stop()
    run(go())
