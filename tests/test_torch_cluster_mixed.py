"""Mixed clusters: the port's daemons and clients in ``ceph_tpu``'s
cluster and the reverse, the state of a cluster in a rolling upgrade.

- a port ``Rados`` on a reference cluster, and a reference ``Rados`` on a
  port cluster: writes, reads, partial writes, xattrs, omap and listings
  give the same answers as the cluster's own client;
- one port ``OSD`` boots into a reference cluster of one mon and three
  OSDs: a k=2 m=1 pool goes clean across all four (boot, peering, EC
  sub-ops and pushes between the packages), and objects written through
  it read back equal, through either package's client, with the port
  OSD holding its shards.
"""

import asyncio

import numpy as np

from ceph_tpu.cluster.vstart import Cluster as RefCluster
from ceph_tpu.mon.monitor import MonMap as RefMonMap
from ceph_tpu.msg import Keyring as RefKeyring
from ceph_tpu.rados import Rados as RefRados
from ceph_tpu_torch.cluster.vstart import Cluster as PortCluster
from ceph_tpu_torch.mon.monitor import MonMap as PortMonMap
from ceph_tpu_torch.msg import Keyring as PortKeyring
from ceph_tpu_torch.os_.objectstore import MemStore as PortMemStore
from ceph_tpu_torch.osd.daemon import OSD as PortOSD
from ceph_tpu_torch.rados import Rados as PortRados


def run(coro):
    return asyncio.run(coro)


def _monmap(cls, src):
    """A copy of ``src`` as the other package's MonMap."""
    m = cls(fsid=src.fsid)
    for name, (rank, host, port) in src.mons.items():
        m.add(name, rank, host, port)
    return m


async def _io_script(clients: list, pool: str, seed: int) -> list:
    """The same writes through the first client; every client reads all
    of it back. Returns what each client read."""
    rng = np.random.default_rng(seed)
    ios = [await cl.open_ioctx(pool) for cl in clients]
    mirror = {}
    for i in range(6):
        data = rng.integers(0, 256, int(rng.integers(1, 6000)),
                            dtype=np.uint8).tobytes()
        await ios[i % len(ios)].write_full(f"o{i}", data)
        mirror[f"o{i}"] = bytearray(data)
    await ios[-1].write("o1", b"@" * 300, offset=100)
    mirror["o1"][100:400] = b"@" * 300
    await ios[0].setxattr("o2", "user.k", b"v")
    await ios[-1].set_omap("o2", "key", b"val")
    out = []
    for io in ios:
        got = []
        for oid in sorted(mirror):
            data = await io.read(oid)
            assert data == bytes(mirror[oid]), oid
            got.append((oid, data, await io.stat(oid)))
        got.append(sorted(await io.list_objects()))
        got.append(await io.getxattr("o2", "user.k"))
        got.append(await io.get_omap_vals("o2"))
        out.append(got)
    return out


def test_port_rados_on_reference_cluster_and_the_reverse():
    async def on_ref():
        c = await RefCluster(n_mons=1, n_osds=3).start()
        port = None
        try:
            await c.client.pool_create("p", pg_num=8, size=3)
            await c.wait_for_clean(timeout=120)
            port = PortRados(_monmap(PortMonMap, c.monmap),
                             keyring=PortKeyring(dict(c.keyring.keys)),
                             config=c.cfg, device="cpu")
            await port.connect()
            return await _io_script([port, c.client], "p", 3)
        finally:
            if port is not None:
                await port.shutdown()
            await c.stop()

    async def on_port():
        c = await PortCluster(n_mons=1, n_osds=3, device="cpu").start()
        ref = None
        try:
            await c.client.pool_create("p", pg_num=8, size=3)
            await c.wait_for_clean(timeout=120)
            ref = RefRados(_monmap(RefMonMap, c.monmap),
                           keyring=RefKeyring(dict(c.keyring.keys)),
                           config=c.cfg)
            await ref.connect()
            return await _io_script([ref, c.client], "p", 3)
        finally:
            if ref is not None:
                await ref.shutdown()
            await c.stop()

    a = run(on_ref())
    b = run(on_port())
    assert a[0] == a[1]          # the port client reads what ref's does
    assert b[0] == b[1]
    assert a == b                # and the two clusters answer alike


def test_port_osd_joins_a_reference_cluster():
    async def go():
        c = RefCluster(n_mons=1, n_osds=3,
                       config={"mon_osd_down_out_interval": 600.0})
        c.keyring.add("osd.3")           # a boot key for the newcomer
        await c.start()
        port_client = None
        try:
            ret, rs, out = await c.client.mon_command({"prefix": "osd new"})
            assert ret == 0, rs
            ret, rs, _ = await c.client.mon_command(
                {"prefix": "osd crush add", "id": 3, "weight": 1.0,
                 "host": "host3"})
            assert ret == 0, rs
            posd = PortOSD(3, _monmap(PortMonMap, c.monmap),
                           store=PortMemStore(),
                           keyring=PortKeyring(dict(c.keyring.keys)),
                           config=c.cfg, device="cpu")
            await posd.boot()
            # the cluster helpers read only duck-typed state of an OSD
            c.osds.append(posd)
            ret, rs, _ = await c.client.mon_command(
                {"prefix": "osd erasure-code-profile set", "name": "p21",
                 "profile": ["k=2", "m=1", "crush-failure-domain=osd",
                             "stripe_unit=1024"]})
            assert ret == 0, rs
            ret, rs, _ = await c.client.mon_command(
                {"prefix": "osd pool create", "pool": "ec", "pg_num": 8,
                 "pool_type": "erasure", "erasure_code_profile": "p21"})
            assert ret == 0, rs
            await c.wait_for_clean(timeout=240)
            om = c.leader().osdmon.osdmap
            assert int(om.is_up(3))
            pool = next(p for p in om.pools.values() if p.name == "ec")
            _u, _up, acting, actp = om.pg_to_up_acting_osds(
                pool.id, np.arange(8, dtype=np.uint32))
            acting = np.asarray(acting)
            # the port OSD is primary of some PGs and a shard of others
            assert (np.asarray(actp) == 3).any()
            assert (acting == 3).any(axis=1).sum() > \
                (np.asarray(actp) == 3).sum()
            assert all(pg.state == "clean" for pg in posd.pgs.values()
                       if pg.is_primary())
            port_client = PortRados(
                _monmap(PortMonMap, c.monmap),
                keyring=PortKeyring(dict(c.keyring.keys)),
                config=c.cfg, device="cpu")
            await port_client.connect()
            reads = await _io_script([c.client, port_client], "ec", 9)
            assert reads[0] == reads[1]
            held = [oid for cid in posd.store.list_collections()
                    for oid in posd.store.list_objects(cid)
                    if oid != "_pgmeta_"]
            assert held, "the port OSD holds no shard"
            # a restart of a reference OSD re-peers across packages
            await c.kill_osd(0)
            await c.wait_for_osd_down(0, timeout=60)
            await c.revive_osd(0)
            await c.wait_for_clean(timeout=240)
            io = await port_client.open_ioctx("ec")
            for oid, data, _n in reads[0][:6]:
                assert await io.read(oid) == data
        finally:
            if port_client is not None:
                await port_client.shutdown()
            await c.stop()
    run(go())
