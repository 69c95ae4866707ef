"""The port's RBD images (``ceph_tpu_torch/rbd``) on the CPU, and side
by side with ``ceph_tpu``'s.

- tests/test_rbd_admin.py's RBD cases and
  tests/test_snaps_watch.py::test_rbd_snapshots_rollback_and_clone on a
  port ``Cluster(device="cpu")``;
- one seeded image script (writes, snapshots, protect, clone with
  copy-up, resize, rollback) through a reference ``Cluster`` (JAX on the
  CPU) and a port ``Cluster``: the image bytes at head and at each snap,
  the pool's object listing, the header and directory omap, and every
  ``rbd diff v1`` stream are equal, byte for byte;
- an image written by either package's ``RBD`` opens and reads in the
  other's, on one reference cluster (a mixed client set).

Tolerance: exact bytes everywhere.
"""

import asyncio
import os

import numpy as np
import pytest

from ceph_tpu_torch.cluster.vstart import Cluster
from ceph_tpu_torch.rados import ObjectOperationError
from ceph_tpu_torch.rbd import RBD


def run(coro):
    asyncio.run(coro)


async def _cluster(pgs=4):
    c = await Cluster(n_mons=1, n_osds=3, device="cpu").start()
    await c.client.pool_create("p", pg_num=pgs, size=3, min_size=2)
    await c.wait_for_clean(timeout=120)
    io = await c.client.open_ioctx("p")
    return c, io


# -- tests/test_rbd_admin.py and test_snaps_watch.py on the port ------------

def test_rbd_image_lifecycle():
    async def go():
        c = await Cluster(n_mons=1, n_osds=3, device="cpu").start()
        try:
            await c.client.pool_create("rbd", pg_num=8, size=3)
            await c.wait_for_clean(timeout=90)
            io = await c.client.open_ioctx("rbd")
            rbd = RBD(io)
            # 256 KiB image with 64 KiB objects -> 4 data objects
            await rbd.create("disk0", 256 << 10, order=16)
            assert await rbd.list() == ["disk0"]
            with pytest.raises(ObjectOperationError):
                await rbd.create("disk0", 1 << 20)
            img = await rbd.open("disk0")
            info = await img.stat()
            assert info["obj_size"] == 64 << 10
            assert info["num_objs"] == 4
            # write spanning two data objects
            span = os.urandom(100_000)
            await img.write(30_000, span)
            assert await img.read(30_000, len(span)) == span
            # sparse read: untouched region is zeros
            assert await img.read(200_000, 100) == b"\x00" * 100
            # the data objects exist with the striper's names
            names = await io.list_objects()
            assert "rbd_data.disk0.0000000000000000" in names
            assert "rbd_data.disk0.0000000000000001" in names
            # writes past the image size are rejected
            with pytest.raises(ObjectOperationError):
                await img.write(260_000, b"x" * 10_000)
            # shrink: trailing objects go away
            await img.resize(64 << 10)
            img2 = await rbd.open("disk0")
            assert await img2.size() == 64 << 10
            names = await io.list_objects()
            assert "rbd_data.disk0.0000000000000001" not in names
            # data inside the surviving object is intact
            assert await img2.read(30_000, 1000) == span[:1000]
            await rbd.remove("disk0")
            assert await rbd.list() == []
            assert not [n for n in await io.list_objects()
                        if n.startswith("rbd_data.disk0")]
        finally:
            await c.stop()
    run(go())


def test_rbd_export_import_diff():
    """Incremental replication: export-diff chains (full-at-snap, then
    snap-to-snap, then snap-to-head) rebuild an identical image —
    data, sizes, and snapshots — and zeroed extents travel as 'z'
    records, not data (ref: rbd export-diff/import-diff over the
    doc/dev/rbd-diff.rst v1 stream)."""
    async def go():
        c = await Cluster(n_mons=1, n_osds=3, device="cpu").start()
        try:
            await c.client.pool_create("rbd", pg_num=8, size=3)
            await c.wait_for_clean(timeout=90)
            io = await c.client.open_ioctx("rbd")
            rbd = RBD(io)
            await rbd.create("src", 256 << 10, order=16)
            src = await rbd.open("src")
            await src.write(0, b"AAAA" * 1024)          # 4K at 0
            await src.write(128 << 10, b"BBBB" * 1024)  # 4K at 128K
            await src.snap_create("s1")
            await src.write(64 << 10, b"CCCC" * 1024)
            await src.write(0, b"\0" * 4096)            # zeroed extent
            await src.snap_create("s2")
            await src.write(192 << 10, b"DDDD" * 1024)  # head-only

            # chain: full @s1 -> diff s1..s2 -> diff s2..head
            at_s1 = await rbd.open("src", snapshot="s1")
            full = await at_s1.export_diff()
            at_s2 = await rbd.open("src", snapshot="s2")
            d12 = await at_s2.export_diff(from_snap="s1")
            head = await rbd.open("src")
            d2h = await head.export_diff(from_snap="s2")
            # the zeroed extent must travel as a 'z' record, not as
            # data: walk the stream's tagged records
            def record_tags(stream):
                import struct as _s
                from ceph_tpu_torch.rbd import Image
                assert stream.startswith(Image.DIFF_MAGIC)
                pos = len(Image.DIFF_MAGIC)
                tags = []
                while pos < len(stream):
                    t = stream[pos:pos + 1]
                    pos += 1
                    tags.append(t)
                    if t in (b"f", b"t"):
                        (n,) = _s.unpack_from("<I", stream, pos)
                        pos += 4 + n
                    elif t == b"s":
                        pos += 8
                    elif t == b"w":
                        _, n = _s.unpack_from("<QQ", stream, pos)
                        pos += 16 + n
                    elif t == b"z":
                        pos += 16
                    elif t == b"e":
                        break
                    else:
                        raise AssertionError(f"bad tag {t!r}")
                return tags
            tags = record_tags(d12)
            assert b"z" in tags and tags[-1] == b"e", tags
            assert b"AAAA" not in d12    # unchanged data not shipped

            await rbd.create("dst", 4096, order=16)  # wrong size: 's'
            dst = await rbd.open("dst")              # record fixes it
            await dst.import_diff(full)
            assert "s1" in dst.snaps
            # applying the s1..s2 diff without s1 present must refuse
            await rbd.create("fresh", 256 << 10, order=16)
            fresh = await rbd.open("fresh")
            with pytest.raises(ObjectOperationError):
                await fresh.import_diff(d12)
            await dst.import_diff(d12)
            await dst.import_diff(d2h)

            # identical head content
            s_head = await (await rbd.open("src")).read(0, 256 << 10)
            d_head = await (await rbd.open("dst")).read(0, 256 << 10)
            assert s_head == d_head
            # identical snap views
            for snap in ("s1", "s2"):
                a = await (await rbd.open("src", snapshot=snap)).read(
                    0, 256 << 10)
                b = await (await rbd.open("dst", snapshot=snap)).read(
                    0, 256 << 10)
                assert a == b, snap
            # and the zeroed extent is actually zero at s2
            z = await (await rbd.open("dst", snapshot="s2")).read(
                0, 4096)
            assert z == b"\0" * 4096

            # tail-grain regression: an image whose size is NOT a
            # multiple of the 4 KiB diff grain must still export its
            # final (partial) run — the pre-fix loop dropped it
            await rbd.create("odd", 6000, order=16)
            odd = await rbd.open("odd")
            await odd.write(0, b"E" * 6000)
            stream = await odd.export_diff()
            await rbd.create("odd2", 6000, order=16)
            odd2 = await rbd.open("odd2")
            await odd2.import_diff(stream)
            assert await odd2.read(0, 6000) == b"E" * 6000
        finally:
            await c.stop()
    run(go())


def test_import_diff_truncated_stream_raises_cleanly():
    """A diff stream truncated mid-record must raise
    ObjectOperationError(-22, 'truncated diff stream') on every record
    type — never a raw struct.error leaking to rbd_cli — and must not
    partially corrupt the image before the malformed record."""
    import struct

    from ceph_tpu_torch.rbd import Image

    async def go():
        c = await Cluster(n_mons=1, n_osds=3, device="cpu").start()
        try:
            await c.client.pool_create("rbd", pg_num=8, size=3)
            await c.wait_for_clean(timeout=120)
            io = await c.client.open_ioctx("rbd")
            rbd = RBD(io)
            await rbd.create("dst", 128 << 10, order=16)
            dst = await rbd.open("dst")
            magic = Image.DIFF_MAGIC
            cases = [
                magic + b"s" + b"\x01\x02",            # size cut short
                magic + b"w" + struct.pack("<Q", 0),   # header cut
                magic + b"w" + struct.pack("<QQ", 0, 4096) + b"xy",
                magic + b"z" + struct.pack("<Q", 0)[:4],
                magic + b"t" + struct.pack("<I", 10) + b"abc",
                magic + b"f" + b"\xff",
            ]
            for bad in cases:
                with pytest.raises(ObjectOperationError) as ei:
                    await dst.import_diff(bad)
                assert ei.value.errno == -22, bad
                assert "truncated" in str(ei.value) or \
                    "not present" in str(ei.value), bad
            # missing end record still reports truncation
            with pytest.raises(ObjectOperationError) as ei:
                await dst.import_diff(
                    magic + b"w" + struct.pack("<QQ", 0, 4) + b"good")
            assert ei.value.errno == -22
            # a well-formed stream still applies after the failures
            await dst.import_diff(
                magic + b"w" + struct.pack("<QQ", 0, 4) + b"good" +
                b"e")
            assert await dst.read(0, 4) == b"good"
        finally:
            await c.stop()
    run(go())


def test_rbd_snap_refusal_matrix_and_clone_teardown():
    """The snap rm/unprotect/protect errno matrix (ref: librbd
    Operations::snap_* return codes), the open-child race — a clone
    minted through ANOTHER handle after this one opened must still
    block unprotect — and the shared-blob teardown: once the last
    child detaches, unprotect + snap rm drain every OSD-side COW
    clone object the snapshot pinned."""
    async def go():
        c = await Cluster(n_mons=1, n_osds=3, device="cpu").start()
        try:
            await c.client.pool_create("rbd", pg_num=8, size=3)
            await c.wait_for_clean(timeout=90)
            io = await c.client.open_ioctx("rbd")
            rbd = RBD(io)
            await rbd.create("parent", 128 << 10, order=16)
            img = await rbd.open("parent")
            await img.write(0, b"v1" * 8192)
            # -- protect matrix
            with pytest.raises(ObjectOperationError) as ei:
                await img.snap_protect("nosnap")
            assert ei.value.errno == -2
            await img.snap_create("s1")
            await img.snap_protect("s1")
            with pytest.raises(ObjectOperationError) as ei:
                await img.snap_protect("s1")          # already
            assert ei.value.errno == -16
            # -- unprotect matrix
            with pytest.raises(ObjectOperationError) as ei:
                await img.snap_unprotect("nosnap")
            assert ei.value.errno == -2
            await img.snap_create("bare")
            with pytest.raises(ObjectOperationError) as ei:
                await img.snap_unprotect("bare")      # never protected
            assert ei.value.errno == -22
            # -- the open-child race: `img` was opened BEFORE the
            # clone exists; its in-memory children list is stale, but
            # unprotect must re-read the header and refuse
            await rbd.clone("parent", "s1", "child")
            with pytest.raises(ObjectOperationError) as ei:
                await img.snap_unprotect("s1")
            assert ei.value.errno == -16
            # snap rm of a protected snap refuses too
            with pytest.raises(ObjectOperationError) as ei:
                await img.snap_remove("s1")
            assert ei.value.errno == -16
            # clone prerequisites: unprotected parent snap refuses,
            # duplicate child name refuses
            with pytest.raises(ObjectOperationError) as ei:
                await rbd.clone("parent", "bare", "child2")
            assert ei.value.errno == -22
            with pytest.raises(ObjectOperationError) as ei:
                await rbd.clone("parent", "s1", "child")
            assert ei.value.errno == -17
            # image remove with snapshots refuses
            with pytest.raises(ObjectOperationError) as ei:
                await rbd.remove("parent")
            assert ei.value.errno == -39
            # the child serves the parent snapshot's bytes through
            # layering while the head diverges (COW clones at the OSD
            # keep s1's data: shared-blob references, not copies)
            await img.write(0, b"v2" * 8192)
            child = await rbd.open("child")
            assert await child.read(0, 4) == b"v1v1"
            assert await img.read(0, 4) == b"v2v2"
            clones = [n for o in c.osds
                      for cid in o.store.list_collections()
                      for n in o.store.list_objects(cid)
                      if n.startswith("_snapclone.")]
            assert clones, "overwrite under a snap minted no COW clone"
            # -- teardown in dependency order: child, unprotect, rm
            await rbd.remove("child")
            await img.snap_unprotect("s1")
            await img.snap_remove("s1")
            await img.snap_remove("bare")
            assert await img.snap_list() == []
            # the snapshot's COW clones drain from every OSD store
            deadline = asyncio.get_event_loop().time() + 60.0
            while True:
                left = [n for o in c.osds
                        for cid in o.store.list_collections()
                        for n in o.store.list_objects(cid)
                        if n.startswith("_snapclone.")]
                if not left:
                    break
                assert asyncio.get_event_loop().time() < deadline, \
                    f"snap trim left clone objects: {left[:4]}"
                await asyncio.sleep(0.5)
            # head data untouched by the trims
            assert await img.read(0, 4) == b"v2v2"
            await rbd.remove("parent")
        finally:
            await c.stop()
    run(go())


def test_rbd_snapshots_rollback_and_clone():
    async def go():
        c, io = await _cluster()
        try:
            rbd = RBD(io)
            await rbd.create("img", size=1 << 20, order=16)  # 64K objs
            img = await rbd.open("img")
            await img.write(0, b"A" * 100_000)
            await img.snap_create("s1")
            await img.write(50_000, b"B" * 100_000)
            # read through a snapshot view
            snap_view = await rbd.open("img", snapshot="s1")
            got = await snap_view.read(0, 150_000)
            assert got[:100_000] == b"A" * 100_000
            assert got[100_000:150_000] == b"\x00" * 50_000
            head = await img.read(0, 150_000)
            assert head[:50_000] == b"A" * 50_000
            assert head[50_000:150_000] == b"B" * 100_000
            with pytest.raises(ObjectOperationError):
                await snap_view.write(0, b"nope")
            # snapshot listing + image remove refusal
            snaps = await img.snap_list()
            assert [s["name"] for s in snaps] == ["s1"]
            with pytest.raises(ObjectOperationError):
                await rbd.remove("img")
            # clone from a protected snap, with copy-up on write
            await img.snap_protect("s1")
            await rbd.clone("img", "s1", "child")
            child = await rbd.open("child")
            cg = await child.read(0, 150_000)
            assert cg[:100_000] == b"A" * 100_000     # parent fallthrough
            await child.write(10, b"C" * 5)
            cg = await child.read(0, 100)
            assert cg[:10] == b"A" * 10 and cg[10:15] == b"C" * 5
            # parent head unchanged by child write
            head2 = await img.read(0, 100)
            assert head2 == head[:100]
            # unprotect refused while the child exists
            with pytest.raises(ObjectOperationError):
                img2 = await rbd.open("img")
                await img2.snap_unprotect("s1")
            # rollback restores s1 state on the parent head
            await img.snap_rollback("s1")
            rb = await img.read(0, 150_000)
            assert rb[:100_000] == b"A" * 100_000
            assert rb[100_000:] == b"\x00" * 50_000
        finally:
            await c.stop()
    run(go())


# -- side by side with ceph_tpu -------------------------------------------

IMG_SIZE, ORDER = 512 << 10, 16           # 8 objects of 64 KiB


async def _image_script(RBDCls, io, seed: int) -> list:
    """One seeded image script; returns what a user and the pool show."""
    rng = np.random.default_rng(seed)
    rbd = RBDCls(io)
    await rbd.create("img", IMG_SIZE, order=ORDER)
    img = await rbd.open("img")
    out = []

    async def writes(im, n, size):
        for _ in range(n):
            ln = int(rng.integers(1, 40_000))
            off = int(rng.integers(0, size - ln))
            await im.write(off, rng.integers(0, 256, ln,
                                             dtype=np.uint8).tobytes())

    await writes(img, 8, IMG_SIZE)
    await img.write(3 * (1 << ORDER), b"\0" * 8192)      # a zeroed run
    await img.snap_create("s1")
    await writes(img, 6, IMG_SIZE)
    await img.snap_create("s2")
    await img.snap_protect("s2")
    await rbd.clone("img", "s2", "child")
    child = await rbd.open("child")
    await writes(child, 3, IMG_SIZE)                   # copy-up
    await writes(img, 4, IMG_SIZE)
    await img.resize(IMG_SIZE - 100_000)
    await img.resize(IMG_SIZE)
    for name, snap in (("img", None), ("img", "s1"), ("img", "s2"),
                       ("child", None)):
        view = await rbd.open(name, snapshot=snap)
        out.append((name, snap, await view.read(0, IMG_SIZE),
                    await view.stat()))
    out.append(await (await rbd.open("img")).export_diff())
    out.append(await (await rbd.open("img", snapshot="s2"))
               .export_diff(from_snap="s1"))
    out.append(await (await rbd.open("img")).export_diff(from_snap="s2"))
    out.append(await (await rbd.open("child")).export_diff())
    out.append(await img.snap_list())
    rb = await rbd.open("img")
    await rb.snap_rollback("s1")
    out.append(await rb.read(0, IMG_SIZE))
    out.append(sorted(await io.list_objects()))
    out.append(await io.get_omap_vals("rbd_directory"))
    for name in ("img", "child"):
        out.append(await io.get_omap_vals(f"rbd_header.{name}"))
    return out


def test_image_script_equals_the_reference():
    from ceph_tpu.cluster.vstart import Cluster as RefCluster
    from ceph_tpu.rbd import RBD as RefRBD

    async def one(ClusterCls, RBDCls, kw):
        c = await ClusterCls(n_mons=1, n_osds=3, **kw).start()
        try:
            await c.client.pool_create("rbd", pg_num=4, size=3)
            await c.wait_for_clean(timeout=120)
            io = await c.client.open_ioctx("rbd")
            return await _image_script(RBDCls, io, seed=909)
        finally:
            await c.stop()

    ref = asyncio.run(one(RefCluster, RefRBD, {}))
    port = asyncio.run(one(Cluster, RBD, {"device": "cpu"}))
    assert len(ref) == len(port)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, i


def test_images_open_across_packages():
    """On a reference cluster: an image the reference's RBD wrote opens
    and reads in the port's, and one the port wrote (with a snapshot)
    in the reference's."""
    from ceph_tpu.cluster.vstart import Cluster as RefCluster
    from ceph_tpu.rbd import RBD as RefRBD
    from ceph_tpu_torch.mon.monitor import MonMap as PortMonMap
    from ceph_tpu_torch.msg import Keyring as PortKeyring
    from ceph_tpu_torch.rados import Rados as PortRados

    async def go():
        c = await RefCluster(n_mons=1, n_osds=3).start()
        port = None
        try:
            await c.client.pool_create("rbd", pg_num=4, size=3)
            await c.wait_for_clean(timeout=120)
            monmap = PortMonMap(fsid=c.monmap.fsid)
            for name, (rank, host, p) in c.monmap.mons.items():
                monmap.add(name, rank, host, p)
            port = PortRados(monmap,
                             keyring=PortKeyring(dict(c.keyring.keys)),
                             config=c.cfg, device="cpu")
            await port.connect()
            ref_io = await c.client.open_ioctx("rbd")
            port_io = await port.open_ioctx("rbd")
            a = os.urandom(150_000)
            await RefRBD(ref_io).create("from_ref", 256 << 10, order=16)
            await (await RefRBD(ref_io).open("from_ref")).write(7, a)
            got = await (await RBD(port_io).open("from_ref")).read(7, len(a))
            assert got == a
            b1, b2 = os.urandom(90_000), os.urandom(90_000)
            await RBD(port_io).create("from_port", 256 << 10, order=16)
            img = await RBD(port_io).open("from_port")
            await img.write(1000, b1)
            await img.snap_create("s")
            await img.write(1000, b2)
            ref_head = await RefRBD(ref_io).open("from_port")
            ref_snap = await RefRBD(ref_io).open("from_port", snapshot="s")
            assert await ref_head.read(1000, len(b2)) == b2
            assert await ref_snap.read(1000, len(b1)) == b1
            assert await ref_head.export_diff(from_snap="s") == \
                await img.export_diff(from_snap="s")
            assert sorted(await RBD(port_io).list()) == \
                ["from_port", "from_ref"]
        finally:
            if port is not None:
                await port.shutdown()
            await c.stop()
    run(go())
