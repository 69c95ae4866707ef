"""The port's dev cluster (``ceph_tpu_torch/cluster/vstart.py``) on the
CPU, and side by side with ``ceph_tpu``'s.

- tests/test_cluster.py's four cases on a port ``Cluster(device="cpu")``:
  lifecycle and I/O, OSD failure with remap and recovery, a mon failure,
  a durable store across an OSD restart;
- the first three cases of tests/test_ec_cluster.py (EC round trip,
  degraded read and write, shard reconstruction on revive);
- the device plumbing of ``ECPG``: a pool profile without ``device``
  runs on the hosting OSD's device, and the committed pool bytes equal
  the reference's;
- one seeded script through a reference ``Cluster`` (JAX on the CPU)
  and a port ``Cluster``: a k=2 m=1 pool and a replicated pool, writes,
  partial overwrites, xattrs and omap, one OSD killed, degraded reads
  and writes, the OSD marked out, clean again. What a user reads is
  equal, and so are the shard bytes each EC position holds on its OSD.

Left out of the comparison, because they follow timing and not the
data: map epochs (up_thru, pg_temp and the heartbeat markdown commit
on their own schedule), PG log versions, tids and heartbeat stamps.
"""

import asyncio

import numpy as np
import pytest
import torch

from ceph_tpu_torch.cluster.vstart import Cluster
from ceph_tpu_torch.rados import ObjectOperationError


def run(coro):
    return asyncio.run(coro)


# -- tests/test_cluster.py on the port -------------------------------------

def test_cluster_lifecycle_and_io():
    async def go():
        c = await Cluster(n_mons=1, n_osds=3, device="cpu").start()
        try:
            await c.client.pool_create("rbd", pg_num=8, size=3)
            await c.wait_for_clean(timeout=90)
            io = await c.client.open_ioctx("rbd")
            await io.write_full("obj1", b"hello world")
            assert await io.read("obj1") == b"hello world"
            await io.write("obj1", b"ceph!", offset=6)
            assert await io.read("obj1") == b"hello ceph!"
            assert await io.stat("obj1") == 11
            await io.truncate("obj1", 5)
            assert await io.read("obj1") == b"hello"
            await io.setxattr("obj1", "user.tag", b"gold")
            assert await io.getxattr("obj1", "user.tag") == b"gold"
            await io.set_omap("obj1", "k1", b"v1")
            assert await io.get_omap_vals("obj1") == {"k1": b"v1"}
            for i in range(10):
                await io.write_full(f"many{i}", bytes([i]) * 100)
            names = await io.list_objects()
            assert set(names) >= {f"many{i}" for i in range(10)} | {"obj1"}
            await io.remove("many0")
            with pytest.raises(ObjectOperationError):
                await io.read("many0")
            stored = 0
            for o in c.osds:
                for cid in o.store.list_collections():
                    if "obj1" in o.store.list_objects(cid):
                        stored += 1
                        assert o.store.read(cid, "obj1") == b"hello"
            assert stored == 3
            status = await c.client.status()
            assert status["osdmap"]["num_up_osds"] == 3
            await asyncio.sleep(1.0)        # let pg stats flow
            status = await c.client.status()
            assert status["pgmap"]["num_pgs"] == 8
            assert status["health"]["status"] == "HEALTH_OK"
        finally:
            await c.stop()
    run(go())


def test_osd_failure_remap_and_recovery():
    async def go():
        cfg = {"mon_osd_down_out_interval": 2.0}
        c = await Cluster(n_mons=1, n_osds=3, config=cfg,
                          device="cpu").start()
        try:
            await c.client.pool_create("data", pg_num=8, size=3,
                                       min_size=1)
            await c.wait_for_clean(timeout=90)
            io = await c.client.open_ioctx("data")
            payload = {f"o{i}": bytes([i]) * 512 for i in range(8)}
            for oid, data in payload.items():
                await io.write_full(oid, data)
            await c.kill_osd(2)
            await c.wait_for_osd_down(2, timeout=20)
            await io.write_full("during-outage", b"still-writable")
            assert await io.read("during-outage") == b"still-writable"
            for oid, data in payload.items():
                assert await io.read(oid) == data
            status = await c.client.status()
            assert status["osdmap"]["num_up_osds"] == 2
            await c.revive_osd(2)
            await c.wait_for_clean(timeout=90)
            st2 = c.osds[2].store
            found = {}
            for cid in st2.list_collections():
                for oid in st2.list_objects(cid):
                    if oid != "_pgmeta_":
                        found[oid] = st2.read(cid, oid)
            assert found.get("during-outage") == b"still-writable"
            for oid, data in payload.items():
                if oid in found:
                    assert found[oid] == data
            status = await c.client.status()
            assert status["osdmap"]["num_up_osds"] == 3
            deadline = asyncio.get_event_loop().time() + 15
            while True:
                status = await c.client.status()
                if status["health"]["status"] == "HEALTH_OK":
                    break
                assert asyncio.get_event_loop().time() < deadline, \
                    status["health"]
                await asyncio.sleep(0.3)
        finally:
            await c.stop()
    run(go())


def test_multi_mon_cluster_survives_mon_failure():
    async def go():
        c = await Cluster(n_mons=3, n_osds=2, device="cpu").start()
        try:
            await c.client.pool_create("p", pg_num=4, size=2)
            await c.wait_for_clean(timeout=90)
            io = await c.client.open_ioctx("p")
            await io.write_full("x", b"1")
            leader = c.leader()
            await leader.stop()
            await asyncio.sleep(1.0)
            await io.write_full("y", b"2")
            assert await io.read("x") == b"1"
            assert await io.read("y") == b"2"
            ret, _, _ = await c.client.mon_command({"prefix": "status"},
                                                   timeout=30)
            assert ret == 0
        finally:
            await c.stop()
    run(go())


def test_durable_osd_store_survives_restart(tmp_path):
    async def go():
        c = await Cluster(n_mons=1, n_osds=2, data_dir=str(tmp_path),
                          device="cpu").start()
        try:
            await c.client.pool_create("wal", pg_num=4, size=2)
            await c.wait_for_clean(timeout=90)
            io = await c.client.open_ioctx("wal")
            await io.write_full("persisted", b"on-disk")
            await c.kill_osd(1)
            from ceph_tpu_torch.os_.objectstore import WALStore
            from ceph_tpu_torch.osd.daemon import OSD
            c.osds[1].store.umount()
            fresh_store = WALStore(f"{tmp_path}/osd1")
            c.osds[1] = OSD(1, c.monmap, store=fresh_store,
                            keyring=c.keyring, config=c.cfg, device="cpu")
            await c.osds[1].boot()
            await c.wait_for_clean(timeout=90)
            assert await io.read("persisted") == b"on-disk"
            names = []
            for cid in fresh_store.list_collections():
                names += [o for o in fresh_store.list_objects(cid)
                          if o != "_pgmeta_"]
            assert "persisted" in names
        finally:
            await c.stop()
    run(go())


# -- tests/test_ec_cluster.py's first three on the port ---------------------

async def _ec_cluster(n_osds=4, k=2, m=1, config=None):
    c = await Cluster(n_mons=1, n_osds=n_osds,
                      config=dict({"mon_osd_down_out_interval": 2.0},
                                  **(config or {})),
                      device="cpu").start()
    ret, rs, _ = await c.client.mon_command(
        {"prefix": "osd erasure-code-profile set", "name": "kprof",
         "profile": [f"k={k}", f"m={m}", "crush-failure-domain=osd",
                     "stripe_unit=1024"]})
    assert ret == 0, rs
    ret, rs, _ = await c.client.mon_command(
        {"prefix": "osd pool create", "pool": "ecpool", "pg_num": 4,
         "pool_type": "erasure", "erasure_code_profile": "kprof"})
    assert ret == 0, rs
    await c.wait_for_clean(timeout=240)
    io = await c.client.open_ioctx("ecpool")
    return c, io


def test_ec_pool_io_roundtrip():
    async def go():
        c, io = await _ec_cluster()
        try:
            rng = np.random.default_rng(7)
            cases = {
                "full": rng.integers(0, 256, 2048, dtype=np.uint8)
                .tobytes(),
                "small": b"tiny",
                "big": rng.integers(0, 256, 10000, dtype=np.uint8)
                .tobytes(),
            }
            for oid, data in cases.items():
                await io.write_full(oid, data)
                assert await io.read(oid) == data, oid
                assert await io.stat(oid) == len(data)
            await io.write("big", b"@" * 777, offset=1500)
            want = bytearray(cases["big"])
            want[1500:1500 + 777] = b"@" * 777
            assert await io.read("big") == bytes(want)
            await io.write("small", b"MORE", offset=4096)
            got = await io.read("small")
            assert got[:4] == b"tiny" and got[4096:] == b"MORE"
            assert got[4:4096] == b"\x00" * 4092
            assert await io.read("big", length=100, offset=1500) == \
                b"@" * 100
            await io.setxattr("big", "user.x", b"1")
            assert await io.getxattr("big", "user.x") == b"1"
            await io.set_omap("big", "mk", b"mv")
            assert await io.get_omap_vals("big") == {"mk": b"mv"}
            holders = [o.whoami for o in c.osds
                       for cid in o.store.list_collections()
                       if "big" in o.store.list_objects(cid)]
            assert len(holders) == 3
            for o in c.osds:
                for cid in o.store.list_collections():
                    if "big" in o.store.list_objects(cid):
                        assert len(o.store.read(cid, "big")) < 10000
            await io.remove("small")
            names = await io.list_objects()
            assert "small" not in names and "big" in names
        finally:
            await c.stop()
    run(go())


def test_ec_degraded_read_and_write():
    async def go():
        c, io = await _ec_cluster(n_osds=3)
        try:
            rng = np.random.default_rng(3)
            data = rng.integers(0, 256, 6000, dtype=np.uint8).tobytes()
            await io.write_full("victim", data)
            holder = next(o.whoami for o in c.osds
                          for cid in o.store.list_collections()
                          if "victim" in o.store.list_objects(cid))
            await c.kill_osd(holder)
            await c.wait_for_osd_down(holder, timeout=60)
            assert await io.read("victim") == data
            await io.write_full("during", b"degraded-write" * 10)
            assert await io.read("during") == b"degraded-write" * 10
        finally:
            await c.stop()
    run(go())


def test_ec_shard_reconstruction_on_revive():
    async def go():
        c, io = await _ec_cluster(n_osds=3)
        try:
            rng = np.random.default_rng(11)
            objs = {f"e{i}": rng.integers(0, 256, 3000,
                                          dtype=np.uint8).tobytes()
                    for i in range(4)}
            for oid, data in objs.items():
                await io.write_full(oid, data)
            await c.kill_osd(2)
            await c.wait_for_osd_down(2, timeout=60)
            objs["e0"] = b"replaced!" * 100
            await io.write_full("e0", objs["e0"])
            await io.write_full("new-while-down", b"N" * 2000)
            objs["new-while-down"] = b"N" * 2000
            await c.revive_osd(2)
            await c.wait_for_clean(timeout=120)
            for oid, data in objs.items():
                assert await io.read(oid) == data, oid
            st = c.osds[2].store
            shard_objs = [o for cid in st.list_collections()
                          for o in st.list_objects(cid)
                          if o != "_pgmeta_"]
            assert shard_objs, "osd.2 recovered no shards"
        finally:
            await c.stop()
    run(go())


# -- side by side with ceph_tpu --------------------------------------------

def _pos(attrs: dict) -> int:
    b = attrs.get("_pos")
    return int.from_bytes(b, "little", signed=True) if b else -1


def _shard_bytes(c, pool_id: int) -> dict:
    """(oid, stamped position) -> shard bytes, over the OSDs of every
    PG's acting set in the leader's final map, and whether each of them
    holds its own position's shard."""
    om = c.leader().osdmon.osdmap
    pool = om.pools[pool_id]
    seeds = np.arange(pool.pg_num, dtype=np.uint32)
    _up, _upp, acting, _actp = om.pg_to_up_acting_osds(pool_id, seeds)
    out, settled = {}, True
    for seed in range(pool.pg_num):
        cid = f"{pool_id}.{seed:x}"
        for pos, osd in enumerate(int(x) for x in np.asarray(acting[seed])):
            if osd < 0 or osd >= len(c.osds):
                continue
            st = c.osds[osd].store
            if cid not in st.list_collections():
                continue
            for oid in st.list_objects(cid):
                if oid == "_pgmeta_":
                    continue
                stamped = _pos(st.getattrs(cid, oid))
                settled &= stamped == pos
                out[(oid, stamped)] = bytes(st.read(cid, oid))
    return out, settled


async def _settled_shards(c, pool_id: int, timeout: float = 60.0) -> dict:
    """The shard map once every acting OSD holds its own position's
    shard: an acting shuffle re-derives shards in the background
    (``ECPG._fix_shard_positions``) after the PG is already clean."""
    deadline = asyncio.get_event_loop().time() + timeout
    while True:
        shards, settled = _shard_bytes(c, pool_id)
        if settled:
            return shards
        assert asyncio.get_event_loop().time() < deadline, \
            "shard positions never settled"
        await asyncio.sleep(0.2)


async def _script(ClusterCls, kw: dict) -> dict:
    """One seeded script; returns everything a user reads, the EC shard
    bytes per position, and the committed pools' bytes."""
    rng = np.random.default_rng(2024)
    c = await ClusterCls(n_mons=1, n_osds=4,
                         config={"mon_osd_down_out_interval": 600.0},
                         **kw).start()
    seen: list = []
    mirror: dict = {}
    try:
        cl = c.client
        ret, rs, _ = await cl.mon_command(
            {"prefix": "osd erasure-code-profile set", "name": "p21",
             "profile": ["k=2", "m=1", "crush-failure-domain=osd",
                         "stripe_unit=1024"]})
        assert ret == 0, rs
        ret, rs, _ = await cl.mon_command(
            {"prefix": "osd pool create", "pool": "ec", "pg_num": 4,
             "pool_type": "erasure", "erasure_code_profile": "p21"})
        assert ret == 0, rs
        await cl.pool_create("rep", pg_num=4, size=3, min_size=2)
        await c.wait_for_clean(timeout=240)
        ec = await cl.open_ioctx("ec")
        rep = await cl.open_ioctx("rep")
        for i in range(10):
            n = int(rng.integers(1, 9000))
            data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            await ec.write_full(f"e{i}", data)
            mirror[("ec", f"e{i}")] = bytearray(data)
        for i in range(6):
            data = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
            await rep.write_full(f"h{i}", data)
            await rep.setxattr(f"h{i}", "user.v", bytes([i]))
            await rep.set_omap(f"h{i}", "size", str(i).encode())
            await rep.set_omap(f"h{i}", "order", b"22")
            mirror[("rep", f"h{i}")] = bytearray(data)
        ios = {"ec": ec, "rep": rep}
        for _ in range(12):
            pool = ("ec", "rep")[int(rng.integers(0, 2))]
            keys = sorted(k for k in mirror if k[0] == pool)
            key = keys[int(rng.integers(0, len(keys)))]
            off = int(rng.integers(0, len(mirror[key]) + 512))
            buf = rng.integers(0, 256, int(rng.integers(1, 1500)),
                               dtype=np.uint8).tobytes()
            await ios[pool].write(key[1], buf, offset=off)
            m = mirror[key]
            if off > len(m):
                m.extend(b"\0" * (off - len(m)))
            m[off:off + len(buf)] = buf

        async def read_all(tag):
            for (pool, oid), want in sorted(mirror.items()):
                got = await ios[pool].read(oid)
                assert got == bytes(want), (tag, pool, oid)
                seen.append((tag, pool, oid, got,
                             await ios[pool].stat(oid)))
            for pool in ("ec", "rep"):
                seen.append((tag, pool,
                             sorted(await ios[pool].list_objects())))
            for i in range(6):
                seen.append((tag, await rep.getxattr(f"h{i}", "user.v"),
                             await rep.get_omap_vals(f"h{i}")))
            try:
                await ec.read("absent")
                seen.append((tag, "absent", 0))
            except Exception as e:    # either package's error class
                seen.append((tag, "absent", type(e).__name__, e.errno))

        await read_all("healthy")
        await c.kill_osd(1)
        await c.wait_for_osd_down(1, timeout=60)
        await read_all("degraded")
        for i in range(3):
            data = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
            await ec.write_full(f"d{i}", data)
            mirror[("ec", f"d{i}")] = bytearray(data)
        ret, rs, _ = await cl.mon_command({"prefix": "osd out",
                                           "id": 1})
        assert ret == 0, rs
        await c.wait_for_clean(timeout=240)
        await read_all("clean")
        om = c.leader().osdmon.osdmap
        pools = {p.name: p for p in om.pools.values()}
        shards = await _settled_shards(c, pools["ec"].id)
        return {"seen": seen, "shards": shards, "pools": pools,
                "ec_pgs": [pg for o in c.osds if not o._stopped
                           for pg in o.pgs.values()
                           if pg.pool.id == pools["ec"].id]}
    finally:
        await c.stop()


def test_side_by_side_with_reference_cluster():
    import ceph_tpu.encoding.denc as rdenc
    import ceph_tpu.encoding.maps as rmaps
    import ceph_tpu_torch.encoding.denc as pdenc
    import ceph_tpu_torch.encoding.maps as pmaps
    from ceph_tpu.cluster.vstart import Cluster as RefCluster

    ref = run(_script(RefCluster, {}))
    port = run(_script(Cluster, {"device": "cpu"}))
    assert len(port["seen"]) == len(ref["seen"])
    for a, b in zip(port["seen"], ref["seen"]):
        assert a == b
    assert port["shards"].keys() == ref["shards"].keys()
    for k in ref["shards"]:
        assert port["shards"][k] == ref["shards"][k], k
    # every EC object has its k+m positions on the final acting sets
    oids = {oid for oid, _ in port["shards"]}
    assert all((oid, p) in port["shards"] for oid in oids
               for p in range(3))
    # the committed pools: the profile names no device, bytes equal
    for name in ("ec", "rep"):
        pp, rp = port["pools"][name], ref["pools"][name]
        assert "device" not in (pp.extra.get("profile") or {})
        pe, re_ = pdenc.Encoder(), rdenc.Encoder()
        pmaps._enc_pool(pe, pp)
        rmaps._enc_pool(re_, rp)
        assert pe.tobytes() == re_.tobytes(), name
    # ... and every port ECPG took its device from its OSD
    assert port["ec_pgs"]
    assert all(pg.ec.device == torch.device("cpu")
               for pg in port["ec_pgs"])


def test_ecpg_device_comes_from_the_hosting_osd():
    """A pool profile without ``device`` runs on the OSD's device; a
    profile that names one is overridden by the OSD (the profile is
    cluster state, the device belongs to the daemon)."""
    from types import SimpleNamespace

    from ceph_tpu_torch.os_.objectstore import MemStore
    from ceph_tpu_torch.osd.ec_pg import ECPG
    from ceph_tpu_torch.osd.types import pg_t

    class Host(SimpleNamespace):
        def next_tid(self):
            return 1

    for prof in ({"k": "2", "m": "1", "plugin": "jax"},
                 {"k": "2", "m": "1", "plugin": "jax", "device": "cuda"}):
        pool = SimpleNamespace(id=1, extra={"profile": dict(prof)},
                               size=3, min_size=2, pg_num=1)
        host = Host(whoami=0, device=torch.device("cpu"),
                    store=MemStore(), config={})
        try:
            pg = ECPG(host, pool, pg_t(1, 0))
        except AttributeError:
            pytest.fail("ECPG needs more of the host than the device")
        assert pg.ec.device == torch.device("cpu")
        assert pool.extra["profile"] == prof     # not written back


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_repair_drops_the_repaired_object_from_the_residency_cache(pkg):
    """An object no read has cached, one byte of its data shard at
    position 0 flipped in the store, ``pg repair``: the store is
    restored in both packages, but the reference's deep check cached the
    gathered (corrupt) data under the object's unchanged version and
    serves it to the next read; the port drops the repaired object from
    the primary's cache."""
    if pkg == "reference":
        from ceph_tpu.cluster.vstart import Cluster as C
        kw = {}
    else:
        C, kw = Cluster, {"device": "cpu"}

    async def go():
        c = await C(n_mons=1, n_osds=3,
                    config={"osd_ec_resident_bytes": 1 << 20,
                            "mon_osd_down_out_interval": 600.0},
                    **kw).start()
        try:
            cl = c.client
            ret, rs, _ = await cl.mon_command(
                {"prefix": "osd erasure-code-profile set", "name": "p",
                 "profile": ["k=2", "m=1", "crush-failure-domain=osd",
                             "stripe_unit=1024"]})
            assert ret == 0, rs
            ret, rs, _ = await cl.mon_command(
                {"prefix": "osd pool create", "pool": "ec", "pg_num": 1,
                 "pool_type": "erasure", "erasure_code_profile": "p"})
            assert ret == 0, rs
            await c.wait_for_clean(timeout=120)
            io = await cl.open_ioctx("ec")
            data = np.random.default_rng(1).integers(
                0, 256, 8192, dtype=np.uint8).tobytes()
            await io.write_full("o", data)
            om = c.leader().osdmon.osdmap
            cid = f"{io.pool_id}.0"
            _u, _up, acting, actp = om.pg_to_up_acting_osds(
                io.pool_id, np.arange(1, dtype=np.uint32))
            holder = c.osds[int(np.asarray(acting)[0][0])]
            primary = c.osds[int(np.asarray(actp)[0])]
            assert not primary.ec_resident._lru        # nothing cached
            obj = holder.store._obj(cid, "o")
            saved = bytes(obj.data)
            obj.data[5] ^= 0x5A
            ret, rs, _ = await cl.mon_command({"prefix": "pg repair",
                                               "pgid": cid})
            assert ret == 0, rs
            deadline = asyncio.get_event_loop().time() + 60
            while bytes(holder.store._obj(cid, "o").data) != saved:
                assert asyncio.get_event_loop().time() < deadline
                await asyncio.sleep(0.05)
            return await io.read("o") == data
        finally:
            await c.stop()
    assert run(go()) is (pkg == "port")
