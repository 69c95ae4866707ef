"""The port's CephFS (``ceph_tpu_torch/cephfs``: ``CephFSLite``, the
snaprealms of the MDS, the client) side by side with ``ceph_tpu``'s.

Each case is one script run through a reference ``Cluster`` (JAX on the
CPU) and a port ``Cluster(device="cpu")``; the script holds the port to
the reference test's assertions and records listings, file bytes,
errnos, the mon's snap registry and, where the script is sequential,
every object of the pool with its bytes and omap. The two records must
be equal.

- tests/test_rgw_cephfs.py::test_cephfs_namespace (``CephFSLite``);
- a seeded namespace script (mkdir, create, write at offsets, rename,
  unlink, rmdir, snapshots) through an MDS and two clients;
- tests/test_snaprealm.py: the ``.snap`` parser and FSMap v3,
  point-in-time reads and -EROFS walls, the snapshot knob and limit, a
  realm across a failover and across a subtree migration;
- a filesystem made by either package's MDS, served by the other's
  after a restart on the same pool;
- ``MDSDaemon.create`` and ``CephFSClient.create`` on the CPU when
  asked, and raising without a card otherwise.

Tolerance: exact bytes everywhere.
"""

import asyncio
import json

import numpy as np
import pytest
import torch
from test_torch_mds import MULTI_CFG, _dump, _errno, _pkg, _pool, both, run

async def _standalone(c, P, **kw):
    io = await _pool(c, P)
    mds = P.MDSDaemon(io, **kw)
    await mds.fs.mount()
    addr = await mds.start()
    cl = await P.CephFSClient(await c.client.open_ioctx("fs"), addr).mount()
    return io, mds, addr, cl


# -- CephFSLite -------------------------------------------------------------------

def test_cephfs_lite_namespace_equals_the_reference():
    async def script(P):
        out = []
        c = await P.Cluster(n_mons=1, n_osds=3, **P.kw).start()
        try:
            io = await _pool(c, P)
            fs = await P.CephFSLite(io).mount()
            await fs.mkdir("/home")
            await fs.mkdir("/home/user")
            await fs.write_file("/home/user/notes.txt", b"hello fs")
            await fs.write_file("/readme", b"root file")
            assert await fs.ls("/") == ["home", "readme"]
            out += [await fs.ls("/"), await fs.ls("/home"),
                    await fs.ls("/home/user"),
                    await fs.read_file("/home/user/notes.txt"),
                    await fs.stat("/home/user/notes.txt"),
                    await fs.stat("/home")]
            await fs.write_file("/home/user/notes.txt", b"!", offset=8)
            out.append(await fs.stat("/home/user/notes.txt"))
            await fs.set_size("/readme", 4)
            out.append(await fs.read_file("/readme", length=4, offset=2))
            await fs.rename("/home/user/notes.txt", "/notes-moved")
            out += [await fs.ls("/"), await fs.ls("/home/user"),
                    await fs.read_file("/notes-moved")]
            for coro in (fs.mkdir("/home"), fs.rmdir("/home"),
                         fs.read_file("/home"), fs.ls("/ghost"),
                         fs.unlink("/home"), fs.rmdir("/"),
                         fs.ls("/readme"), fs.write_file("/home", b"x"),
                         fs.rename("/home", "/h2"),
                         fs.set_size("/ghost", 1), fs.mkdir("/no/such")):
                out.append(await _errno(P, coro))
            assert out[-11:-6] == [-17, -39, -21, -2, -21]
            out.append(await _dump(io, P))
            await fs.rmdir("/home/user")
            await fs.rmdir("/home")
            await fs.unlink("/readme")
            await fs.unlink("/notes-moved")
            assert await fs.ls("/") == []
            out.append(await _dump(io, P))
        finally:
            await c.stop()
        return out
    both(script)


# -- a seeded namespace script through an MDS ---------------------------------

async def _seeded_script(P, seed: int) -> list:
    """Random namespace operations from ``seed`` (numpy), alternating
    between two clients; every result, error and listing, then the
    whole pool."""
    rng = np.random.default_rng(seed)
    out = []
    c = await P.Cluster(n_mons=1, n_osds=3, **P.kw).start()
    try:
        io, mds, addr, a = await _standalone(c, P)
        b = await P.CephFSClient(await c.client.open_ioctx("fs"),
                                 addr).mount()
        dirs, files = ["/"], []
        for step in range(60):
            cl = (a, b)[step % 2]
            kind = int(rng.integers(0, 9))
            d = dirs[int(rng.integers(0, len(dirs)))]
            name = f"{d.rstrip('/')}/n{int(rng.integers(0, 6))}"
            try:
                if kind == 0:
                    await cl.mkdir(name)
                    dirs.append(name)
                    out.append(("mkdir", name))
                elif kind in (1, 2):
                    data = rng.integers(0, 256, int(rng.integers(0, 9000)),
                                        dtype=np.uint8).tobytes()
                    await cl.write_file(name, data)
                    files.append(name)
                    out.append(("write", name, len(data)))
                elif kind == 3 and files:
                    f = files[int(rng.integers(0, len(files)))]
                    h = await cl.open_file(f, "w")
                    off = int(rng.integers(0, 9000))
                    await h.write(b"\xab" * int(rng.integers(1, 3000)),
                                  offset=off)
                    await h.close()
                    out.append(("pwrite", f, off))
                elif kind == 4 and files:
                    f = files[int(rng.integers(0, len(files)))]
                    out.append(("read", f, await cl.read_file(f)))
                elif kind == 5 and files:
                    f = files[int(rng.integers(0, len(files)))]
                    await cl.rename(f, name)
                    out.append(("rename", f, name))
                elif kind == 6 and files:
                    f = files[int(rng.integers(0, len(files)))]
                    await cl.unlink(f)
                    out.append(("unlink", f))
                elif kind == 7:
                    out.append(("ls", d, await cl.ls(d)))
                elif kind == 8 and len(dirs) > 1:
                    victim = dirs[int(rng.integers(1, len(dirs)))]
                    await cl.rmdir(victim)
                    out.append(("rmdir", victim))
                else:
                    out.append(("stat", d, await cl.stat(d)))
            except P.FSError as e:
                out.append(("error", step, e.errno))
        await a.mkdir("/snapped")
        await a.write_file("/snapped/f", b"before")
        await b.mkdir("/snapped/.snap/s1")
        await b.write_file("/snapped/f", b"after!!")
        out.append(await a.read_file("/snapped/.snap/s1/f"))
        out.append(await a.ls("/snapped/.snap"))
        await a.unmount()
        await b.unmount()
        await mds.stop()
        out.append(await _dump(io, P))
    finally:
        await c.stop()
    return out


@pytest.mark.parametrize("seed", [3, 41])
def test_a_seeded_namespace_script_equals_the_reference(seed):
    got = both(lambda P: _seeded_script(P, seed))
    assert any(r[0] == "error" for r in got[:-3])
    assert got[-3] == b"before"


# -- tests/test_snaprealm.py --------------------------------------------------------

def test_snap_split_and_fsmap_v3_equal_the_reference():
    ref, port = _pkg("ref"), _pkg("port")
    for path in ("/d/.snap/s1/a/b", "/d/.snap/s1", "/d/.snap", "/.snap/s1",
                 "/d/sub/f", "/a/.snap/s/.snap/x", "/"):
        assert port.mds.snap_split(path) == ref.mds.snap_split(path)
    blobs = []
    for P in (ref, port):
        m = P.fsmap.FSMap()
        m.snaps = {1: {"name": "s1", "path": "/d", "pool": "fs"},
                   2: {"name": "s2", "path": "/", "pool": "fs"}}
        d = P.fsmap.FSMap.decode(m.encode())
        assert d.snaps == m.snaps
        assert set(d.snaps_under("/d/f")) == {1, 2}
        assert set(d.snaps_under("/x")) == {2}
        blobs.append([m.encode(), sorted(d.snaps_under("/d")),
                      P.fsmap.FSMap.decode(P.fsmap.FSMap().encode()).snaps])
    assert blobs[0] == blobs[1]


def test_point_in_time_reads_and_erofs():
    async def script(P):
        out = []
        c = await P.Cluster(n_mons=1, n_osds=3, **P.kw).start()
        try:
            io, mds, _, cl = await _standalone(c, P)
            await cl.mkdir("/d")
            await cl.mkdir("/d/sub")
            await cl.write_file("/d/f1", b"one" * 100)
            await cl.write_file("/d/sub/f2", b"two" * 200)
            await cl.mkdir("/d/.snap/s1")
            out += [await cl.ls("/d/.snap"), await cl.ls("/d/.snap/s1"),
                    await cl.stat("/d/.snap/s1/f1")]
            await cl.write_file("/d/f1", b"ONE!" * 150)
            await cl.write_file("/d/sub/f2", b"TWO!" * 10)
            assert await cl.read_file("/d/.snap/s1/f1") == b"one" * 100
            out += [await cl.read_file("/d/.snap/s1/sub/f2"),
                    await cl.read_file("/d/f1")]
            for coro in (cl.write_file("/d/.snap/s1/f1", b"x"),
                         cl.mkdir("/d/.snap/s1/new"),
                         cl.unlink("/d/.snap/s1/f1"),
                         cl.rename("/d/f1", "/d/.snap/s1/f1"),
                         cl.rename("/d/.snap/s1/f1", "/d/out")):
                out.append(await _errno(P, coro))
            assert out[-5:] == [-30] * 5
            await cl.mkdir("/d/.snap/s2")
            out.append(await cl.read_file("/d/.snap/s2/f1"))
            out.append(await _errno(P, cl.mkdir("/d/.snap/s1")))
            assert out[-1] == -17
            ret, _, raw = await c.client.mon_command(
                {"prefix": "fs snap ls"})
            out.append([ret, json.loads(raw)])
            await cl.rmdir("/d/.snap/s1")
            out.append(await cl.ls("/d/.snap"))
            out.append(await _errno(P, cl.read_file("/d/.snap/s1/f1")))
            out.append(await cl.read_file("/d/.snap/s2/f1"))
            await cl.unmount()
            await mds.stop()
            out.append(await _dump(io, P))
        finally:
            await c.stop()
        return out
    both(script)


def test_the_snapshot_knob_and_limit():
    async def script(P):
        out = []
        c = await P.Cluster(n_mons=1, n_osds=3, **P.kw).start()
        try:
            io, mds, _, cl = await _standalone(
                c, P, config={"mds_snap_max_per_realm": 2})
            await cl.mkdir("/d")
            await cl.mkdir("/d/.snap/a")
            await cl.mkdir("/d/.snap/b")
            out.append(await _errno(P, cl.mkdir("/d/.snap/c")))
            mds.snap_enabled = False
            out.append(await _errno(P, cl.mkdir("/d/.snap/z")))
            assert out == [-31, -1]
            await cl.mkdir("/other")
            out.append(await cl.ls("/d/.snap"))
            await cl.rmdir("/d/.snap/a")
            out.append(await cl.ls("/d/.snap"))
            await cl.unmount()
            await mds.stop()
            out.append(await _dump(io, P))
        finally:
            await c.stop()
        return out
    both(script)


def test_a_realm_survives_failover():
    async def script(P):
        out = []
        c = await P.Cluster(n_mons=1, n_osds=3, config=MULTI_CFG,
                            **P.kw).start()
        try:
            await c.start_fs(n_mds=2)
            cl = await P.CephFSClient.create(c.client.monc.monmap, None,
                                             "cephfs", keyring=c.keyring,
                                             **P.kw)
            await cl.mkdir("/d")
            await cl.write_file("/d/f", b"pre-snap" * 64)
            await cl.mkdir("/d/.snap/s1")
            await cl.write_file("/d/f", b"post-snap" * 32)
            victim = await c.wait_for_mds_active()
            await c.kill_mds(victim)
            await c.wait_for_mds_active(not_name=victim, timeout=30)
            out += [await cl.ls("/d/.snap"),
                    await cl.read_file("/d/.snap/s1/f"),
                    await cl.read_file("/d/f")]
            await cl.mkdir("/d/.snap/s2")
            out.append(await cl.read_file("/d/.snap/s2/f"))
            assert out[1] == b"pre-snap" * 64
            await cl.unmount()
        finally:
            await c.stop()
        return out
    both(script)


def test_a_realm_rides_a_subtree_migration():
    async def script(P):
        out = []
        c = await P.Cluster(n_mons=1, n_osds=3, config=MULTI_CFG,
                            **P.kw).start()
        try:
            await c.start_fs(n_mds=2, max_mds=2)
            cl = await P.CephFSClient.create(c.client.monc.monmap, None,
                                             "cephfs", keyring=c.keyring,
                                             **P.kw)
            await cl.mkdir("/d")
            await cl.write_file("/d/f", b"before" * 50)
            await cl.mkdir("/d/.snap/s1")
            await c.subtree_pin("/d", 1)
            await cl.write_file("/d/f", b"after" * 99)
            out += [await cl.ls("/d/.snap"),
                    await cl.read_file("/d/.snap/s1/f"),
                    await cl.read_file("/d/f")]
            importer = next(m for m in c.mdss
                            if m.rank == 1 and not m._stopping)
            out.append(sorted((r["path"], r["name"])
                              for r in importer.realms.values()))
            assert ("/d", "s1") in out[-1]
            await cl.unmount()
        finally:
            await c.stop()
        return out
    both(script)


# -- a filesystem across packages --------------------------------------------------

@pytest.mark.parametrize("first", ["ref", "port"])
def test_a_filesystem_moves_to_the_other_packages_mds(first):
    """On a reference cluster: one package's MDS and client make a
    namespace (a snapshot, a journal entry left unapplied); the other
    package's MDS, over its own ``Rados``, starts on the same pool,
    replays the journal, and its client reads everything back."""
    from ceph_tpu.cluster.vstart import Cluster as RefCluster
    from ceph_tpu_torch.mon.monitor import MonMap as PortMonMap
    from ceph_tpu_torch.msg import Keyring as PortKeyring
    from ceph_tpu_torch.rados import Rados as PortRados
    second = "port" if first == "ref" else "ref"

    async def go():
        c = await RefCluster(n_mons=1, n_osds=3).start()
        rados = None
        try:
            await _pool(c, _pkg("ref"))

            async def ioctx(which):
                nonlocal rados
                if which == "ref":
                    return await c.client.open_ioctx("fs")
                if rados is None:
                    monmap = PortMonMap(fsid=c.monmap.fsid)
                    for name, (rank, host, p) in c.monmap.mons.items():
                        monmap.add(name, rank, host, p)
                    rados = PortRados(
                        monmap, keyring=PortKeyring(dict(c.keyring.keys)),
                        config=c.cfg, device="cpu")
                    await rados.connect()
                return await rados.open_ioctx("fs")
            A, B = _pkg(first), _pkg(second)
            io = await ioctx(first)
            mds = A.MDSDaemon(io)
            await mds.fs.mount()
            addr = await mds.start()
            cl = await A.CephFSClient(await ioctx(first), addr).mount()
            await cl.mkdir("/x")
            await cl.write_file("/x/a", b"alpha" * 900)
            await cl.mkdir("/x/.snap/s")
            await cl.write_file("/x/a", b"omega")
            await cl.unmount()
            await mds.stop()
            await io.set_omap(A.mds.JOURNAL_OID, f"{999:016d}", json.dumps(
                {"op": "mkdir", "path": "/from_journal"}).encode())
            mds2 = B.MDSDaemon(await ioctx(second))
            addr2 = await mds2.start()
            cl2 = await B.CephFSClient(await ioctx(second), addr2).mount()
            got = [await cl2.ls("/"), await cl2.read_file("/x/a"),
                   await cl2.read_file("/x/.snap/s/a"),
                   await cl2.ls("/x/.snap")]
            await cl2.write_file("/x/b", b"from the other side")
            got.append(await cl2.ls("/x"))
            await cl2.unmount()
            await mds2.stop()
            return got
        finally:
            if rados is not None:
                await rados.shutdown()
            await c.stop()
    got = run(go())
    assert got == [["from_journal", "x"], b"omega", b"alpha" * 900, ["s"],
                   ["a", "b"]]


# -- devices --------------------------------------------------------------------

def test_the_mds_and_the_client_run_where_they_are_told():
    """``device="cpu"`` puts an MDS's and a client's ``Rados`` on the
    CPU; with no device they map on the card, and without one raise
    before connecting."""
    from ceph_tpu_torch.cephfs.client import CephFSClient
    from ceph_tpu_torch.cephfs.mds import MDSDaemon
    from ceph_tpu_torch.cluster.vstart import Cluster

    async def go():
        c = await Cluster(n_mons=1, n_osds=3, config=MULTI_CFG,
                          device="cpu").start()
        try:
            await c.start_fs(n_mds=1)
            assert [m.device.type for m in c.mdss] == ["cpu"]
            assert c.mdss[0].monc.device.type == "cpu"
            cl = await CephFSClient.create(c.monmap, None, "cephfs",
                                           keyring=c.keyring, device="cpu")
            assert cl.ioctx.rados.monc.device.type == "cpu"
            await cl.write_file("/f", b"cpu")
            assert await cl.read_file("/f") == b"cpu"
            await cl.unmount()
            if not torch.cuda.is_available():
                with pytest.raises(RuntimeError, match="CUDA"):
                    await MDSDaemon.create(c.monmap, "cephfs",
                                           keyring=c.keyring)
                with pytest.raises(RuntimeError, match="CUDA"):
                    await CephFSClient.create(c.monmap, None, "cephfs",
                                              keyring=c.keyring)
        finally:
            await c.stop()
    run(go())
