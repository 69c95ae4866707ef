"""The port's object stores, PG log and objectstore tool held against
ceph_tpu's.

Mirrors tests/test_objectstore.py and tests/test_bluestore.py (the
store_test.cc model: the same op sequences against every store) and the
objectstore_tool case of tests/test_mgr_scrub_tools.py. The same seeded
transactions go into ``ceph_tpu.os_`` and ``ceph_tpu_torch.os_``; the
checks compare reads, attrs, omap, ``statfs`` and ``fsck``, and the
on-disk bytes. The stores write no timestamps: the only clock they read
(the ``import time`` in each ``queue_transaction``) times the phases of
``last_txn_phases``, which never reaches a file. So the WAL and block
files of the two packages are compared byte for byte, and a directory
written by one package mounts in the other. Everything is bytes, so the
tolerance is equality.
"""

import os

import numpy as np
import pytest

from ceph_tpu.bench import objectstore_tool as jax_tool
from ceph_tpu.os_ import KVTransaction as JaxKVTransaction
from ceph_tpu.os_ import MemDB as JaxMemDB
from ceph_tpu.os_ import MemStore as JaxMemStore
from ceph_tpu.os_ import Transaction as JaxTransaction
from ceph_tpu.os_ import WALDB as JaxWALDB
from ceph_tpu.os_ import WALStore as JaxWALStore
from ceph_tpu.os_.allocator import AllocatorError as JaxAllocatorError
from ceph_tpu.os_.allocator import BitmapAllocator as JaxAllocator
from ceph_tpu.os_.bluestore import BlueStore as JaxBlueStore
from ceph_tpu.osd import pg_log as jax_pg_log
from ceph_tpu_torch.bench import objectstore_tool as tool
from ceph_tpu_torch.os_ import (ChecksumError, KVTransaction, MemDB,
                                MemStore, StoreError, Transaction, WALDB,
                                WALStore)
from ceph_tpu_torch.os_.allocator import AllocatorError, BitmapAllocator
from ceph_tpu_torch.os_.bluestore import BlueStore
from ceph_tpu_torch.os_.objectstore import OP_RMATTR
from ceph_tpu_torch.osd import pg_log

BS_SIZE = 4 << 20


def open_store(pkg: str, kind: str, path=None):
    """A store of ``kind`` (mem, wal, bluestore) from ceph_tpu ("jax")
    or the port ("torch")."""
    cls = {("jax", "mem"): JaxMemStore, ("torch", "mem"): MemStore,
           ("jax", "wal"): JaxWALStore, ("torch", "wal"): WALStore,
           ("jax", "bluestore"): JaxBlueStore,
           ("torch", "bluestore"): BlueStore}[(pkg, kind)]
    if kind == "mem":
        return cls()
    if kind == "bluestore":
        return cls(str(path), size=BS_SIZE)
    return cls(str(path))


def txn(pkg: str):
    return (JaxTransaction if pkg == "jax" else Transaction)()


def stream(pkg: str, seed: int, n: int = 24):
    """A seeded stream of transactions (writes of every size, overwrites
    small and large, zero, truncate, attrs, omap, clones, removes) in one
    package's Transaction type."""
    rng = np.random.default_rng(seed)
    out = [txn(pkg).create_collection("1.0").create_collection("1.1")]
    live = []
    for i in range(n):
        t = txn(pkg)
        cid = ("1.0", "1.1")[i % 2]
        kind = i % 8
        if kind in (0, 1) or not live:
            oid = f"obj{i}"
            size = int(rng.choice([100, 4096, 5000, 70000]))
            t.write(cid, oid, int(rng.integers(0, 3000)),
                    rng.integers(0, 256, size, dtype=np.uint8).tobytes())
            t.setattrs(cid, oid, {"_": bytes([i]), "snapset": b"s" * i})
            t.omap_setkeys(cid, oid, {f"k{j}": bytes([j]) * 3
                                      for j in range(i % 4 + 1)})
            live.append((cid, oid))
        else:
            cid, oid = live[int(rng.integers(0, len(live)))]
            if kind == 2:     # overwrites: deferred in place, or COW
                size = int(rng.choice([50, 3000, 20000, 100000]))
                t.write(cid, oid, int(rng.integers(0, 2000)),
                        rng.integers(0, 256, size, dtype=np.uint8).tobytes())
            elif kind == 3:
                t.zero(cid, oid, int(rng.integers(0, 4000)), 777)
            elif kind == 4:
                t.truncate(cid, oid, int(rng.integers(1, 9000)))
            elif kind == 5:
                dst = f"clone{i}"
                t.clone(cid, oid, dst)
                live.append((cid, dst))
            elif kind == 6:
                t.omap_rmkeys(cid, oid, ["k0"]).rmattr(cid, oid, "_") \
                    if i % 3 else t.omap_clear(cid, oid)
            else:
                t.remove(cid, oid)
                live.remove((cid, oid))
        out.append(t)
    return out


def snapshot(st) -> dict:
    """Everything a client can read from a store."""
    out = {}
    for cid in st.list_collections():
        for oid in st.list_objects(cid):
            out[(cid, oid)] = (st.read(cid, oid), st.stat(cid, oid),
                               st.getattrs(cid, oid),
                               st.omap_get(cid, oid))
    return out


def tree_bytes(path) -> dict:
    """Every file under ``path`` (relative name -> bytes)."""
    out = {}
    for root, _, files in os.walk(path):
        for f in files:
            full = os.path.join(root, f)
            out[os.path.relpath(full, path)] = open(full, "rb").read()
    return out


# -- kv ---------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["memdb", "waldb"])
def test_kv_matches_reference(tmp_path, kind):
    """The same batches give the same contents, iterators and (WALDB)
    files, before and after compaction and reopen."""
    dbs = {}
    for pkg, mem, wal in (("jax", JaxMemDB, JaxWALDB),
                          ("torch", MemDB, WALDB)):
        dbs[pkg] = mem() if kind == "memdb" else wal(str(tmp_path / pkg))
    for db in dbs.values():
        t = db.get_transaction()
        t.set("p", "b", b"2").set("p", "a", b"1").set("q", "x", b"9")
        t.rmkey("p", "missing")
        db.submit_transaction(t)
        for i in range(10):
            db.submit_transaction(
                db.get_transaction().set("p", f"k{i}", bytes([i])))
        db.submit_transaction(db.get_transaction().rmkeys_by_prefix("q"))
    a, b = dbs["jax"], dbs["torch"]
    assert list(a.get_iterator("p")) == list(b.get_iterator("p"))
    assert b.get("q", "x") is None and b.get("p", "a") == b"1"
    if kind == "waldb":
        assert tree_bytes(tmp_path / "jax") == tree_bytes(tmp_path / "torch")
        for db in dbs.values():
            db.compact()
            db.submit_transaction(db.get_transaction().set("p", "z", b"z"))
            db.close()
        assert tree_bytes(tmp_path / "jax") == tree_bytes(tmp_path / "torch")
        again = WALDB(str(tmp_path / "jax"))     # the port reads ceph_tpu's
        assert list(again.get_iterator("p")) == list(a.get_iterator("p"))
        assert again.get("p", "z") == b"z"
        again.close()


def test_waldb_torn_tail_discarded(tmp_path):
    path = str(tmp_path / "kv")
    db = WALDB(path)
    db.submit_transaction(db.get_transaction().set("p", "good", b"1"))
    db.submit_transaction(db.get_transaction().set("p", "torn", b"2"))
    db.close()
    wal = os.path.join(path, WALDB.WAL)
    with open(wal, "r+b") as f:
        f.truncate(os.path.getsize(wal) - 3)
    db2 = WALDB(path)
    assert db2.get("p", "good") == b"1" and db2.get("p", "torn") is None
    db2.submit_transaction(db2.get_transaction().set("p", "new", b"3"))
    db2.close()
    db3 = JaxWALDB(path)                       # ceph_tpu replays it too
    assert db3.get("p", "new") == b"3" and db3.get("p", "torn") is None
    db3.close()


def kv_batches(seed: int, n: int) -> list:
    """Seeded kv batches of sets (values up to 3 KiB), removals and one
    prefix drop, as (op, prefix, key, value) lists."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ops = []
        for _ in range(int(rng.integers(1, 4))):
            key = f"k{int(rng.integers(0, 40))}"
            prefix = "pq"[int(rng.integers(0, 2))]
            if rng.random() < 0.2:
                ops.append(("rm", prefix, key, None))
            else:
                ops.append(("set", prefix, key,
                            rng.bytes(int(rng.integers(1, 3 << 10)))))
        if i == n // 2:
            ops.append(("rmprefix", "q", "", None))
        out.append(ops)
    return out


def submit(db, ops) -> None:
    t = db.get_transaction()
    for op, prefix, key, value in ops:
        if op == "set":
            t.set(prefix, key, value)
        elif op == "rm":
            t.rmkey(prefix, key)
        else:
            t.rmkeys_by_prefix(prefix)
    db.submit_transaction(t)


def table(db) -> dict:
    return {p: list(db.get_iterator(p)) for p in "pq"}


def test_waldb_threshold_compaction_files_match_reference(tmp_path):
    """With a small threshold, compaction runs many times over the batches:
    once each has ended, the port's files equal ceph_tpu's, compacted in
    line at the same points (the port's trigger also waits for the WAL to
    outgrow the last snapshot, so the reference is told where); both
    packages reopen either directory to the same table."""
    dbs = {"jax": JaxWALDB(str(tmp_path / "jax"), compact_threshold=1 << 40),
           "torch": WALDB(str(tmp_path / "torch"), compact_threshold=8 << 10,
                          bytes_per_sync=4 << 10)}
    started = 0
    for ops in kv_batches(5, 300):
        for db in dbs.values():
            submit(db, ops)
        if dbs["torch"]._bg is not None:
            started += 1
            dbs["torch"]._bg.join()         # ended before the next batch
            dbs["jax"].compact()
    assert started >= 5
    assert table(dbs["jax"]) == table(dbs["torch"])
    for db in dbs.values():
        db.close()
    assert tree_bytes(tmp_path / "jax") == tree_bytes(tmp_path / "torch")
    for name in ("jax", "torch"):
        for cls in (JaxWALDB, WALDB):
            again = cls(str(tmp_path / name))
            assert table(again) == table(dbs["jax"])
            again.close()


def test_waldb_compaction_waits_for_the_wal_to_outgrow_the_snapshot(
        tmp_path, monkeypatch):
    """A compaction starts once the WAL passes both the threshold and the
    last snapshot's size, never before; the writer syncs every
    ``bytes_per_sync`` bytes, and its snapshot is the file that one
    written in one piece is."""
    synced = []
    real_sync = os.fdatasync
    monkeypatch.setattr(os, "fdatasync",
                        lambda fd: (synced.append(fd), real_sync(fd)))
    path = str(tmp_path / "kv")
    db = WALDB(path, compact_threshold=4 << 10, bytes_per_sync=8 << 10)
    snap = os.path.join(path, WALDB.SNAPSHOT)
    bases = []
    for ops in kv_batches(7, 400):
        limit = max(4 << 10, db._base)
        before = db._wal.tell()
        submit(db, ops)
        assert (db._bg is not None) == (db._wal.tell() > limit), \
            (before, db._wal.tell(), limit)
        if db._bg is not None:
            bases.append(db._base)
            db._bg.join()
            db.submit_transaction(db.get_transaction())   # swaps the WAL
            assert db._bg is None and db._base == os.path.getsize(snap)
    # the trigger rose with the table, past the threshold
    assert len(bases) >= 3 and max(bases) > 4 << 10
    assert len(synced) > 2 * len(bases)     # several syncs a snapshot
    db.compact()
    one = WALDB(str(tmp_path / "one"), bytes_per_sync=1 << 40)
    one._write_snapshot(db._frozen())
    assert open(os.path.join(str(tmp_path / "one"), WALDB.SNAPSHOT),
                "rb").read() == open(snap, "rb").read()
    one.close()
    db.close()
    for cls in (JaxWALDB, WALDB):
        again = cls(path)
        assert table(again) == table(db)
        again.close()


def test_waldb_compaction_leaves_the_write_path(tmp_path, monkeypatch):
    """The batch that crosses the threshold returns while its snapshot is
    still being written, and later batches go on; every file state on the
    way (the old snapshot, the new one beside the whole WAL, the swapped
    WAL) reopens in both packages to the table as it stood."""
    import shutil
    import threading

    gate = threading.Event()
    real = WALDB._write_snapshot

    def held(self, frozen):
        if threading.current_thread() is not threading.main_thread():
            assert gate.wait(30)
        return real(self, frozen)
    monkeypatch.setattr(WALDB, "_write_snapshot", held)
    path = tmp_path / "kv"
    db, mirror = WALDB(str(path), compact_threshold=16 << 10), MemDB()
    batches = kv_batches(6, 60)
    crossed = None
    for i, ops in enumerate(batches):
        submit(db, ops)
        submit(mirror, ops)
        if db._bg is not None and crossed is None:
            crossed = i
        if crossed is not None and i == crossed + 10:
            break
    assert crossed is not None and db._bg.is_alive()

    def reopened(tag):
        if tag != "while_writing" and db._bg is not None:
            db._bg.join()                   # no file half-written
        copy = tmp_path / tag
        shutil.copytree(path, copy)
        for cls in (JaxWALDB, WALDB):
            again = cls(str(copy))
            assert table(again) == table(mirror), (tag, cls)
            again.close()
    reopened("while_writing")
    gate.set()
    db._bg.join()
    reopened("snapshot_renamed")            # new snapshot, the whole WAL
    for ops in batches[crossed + 11:]:
        submit(db, ops)
        submit(mirror, ops)
    assert table(db) == table(mirror)
    reopened("swapped")
    db.close()
    reopened("closed")


@pytest.mark.parametrize("codec", ["kv", "store"])
def test_transaction_codecs_bytes_equal(codec):
    """KVTransaction and Transaction (every op) encode to ceph_tpu's
    bytes, and each package decodes the other's."""
    if codec == "kv":
        ts = [cls().set("a", "k", b"v").rmkey("b", "x").rmkeys_by_prefix("c")
              for cls in (JaxKVTransaction, KVTransaction)]
        dec = (JaxKVTransaction.decode, KVTransaction.decode)
    else:
        ts = []
        for pkg in ("jax", "torch"):
            t = txn(pkg)
            t.create_collection("1.0").touch("1.0", "o")
            t.write("1.0", "o", 4, b"abc").zero("1.0", "o", 0, 2)
            t.truncate("1.0", "o", 100)
            t.setattrs("1.0", "o", {"_": b"oi"}).rmattr("1.0", "o", "_")
            t.clone("1.0", "o", "o2").omap_setkeys("1.0", "o", {"k": b"v"})
            t.omap_rmkeys("1.0", "o", ["k"]).omap_clear("1.0", "o")
            t.remove("1.0", "o2").remove_collection("1.0")
            ts.append(t)
        dec = (JaxTransaction.decode, Transaction.decode)
    a, b = ts
    assert a.encode() == b.encode()
    assert dec[1](a.encode()).ops == b.ops
    assert dec[0](b.encode()).ops == a.ops


# -- allocator --------------------------------------------------------------

@pytest.mark.parametrize("case", ["cycle", "fragmented", "enospc",
                                  "double_claim"])
def test_allocator_matches_reference(case):
    """BitmapAllocator: the same extents, free counts and refusals as
    ceph_tpu's."""
    got = {}
    for pkg, cls, err in (("jax", JaxAllocator, JaxAllocatorError),
                          ("torch", BitmapAllocator, AllocatorError)):
        if case == "cycle":
            a = cls(64)
            x = a.allocate(10)
            mid = a.free_aus
            a.release(x)
            got[pkg] = (x, mid, a.free_aus)
        elif case == "fragmented":
            a = cls(8)
            a.allocate(8)
            a.release([(1, 1), (3, 1), (5, 1)])
            got[pkg] = (sorted(a.allocate(3)), a.free_aus)
        elif case == "enospc":
            a = cls(4)
            a.allocate(4)
            with pytest.raises(err):
                a.allocate(1)
            got[pkg] = a.free_aus
        else:
            a = cls(8)
            a.mark_used([(0, 4)])
            with pytest.raises(err):
                a.mark_used([(3, 2)])
            got[pkg] = a.free_aus
    assert got["jax"] == got["torch"]


# -- the stores -------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mem", "wal", "bluestore"])
def test_replayed_stream_matches_reference(tmp_path, kind):
    """A seeded stream of transactions into both packages' store: the
    same reads, attrs, omap, listings, statfs and fsck; for the durable
    stores the same files on disk, and the same state after remount."""
    sts = {pkg: open_store(pkg, kind, tmp_path / pkg)
           for pkg in ("jax", "torch")}
    for pkg, st in sts.items():
        for t in stream(pkg, seed=31):
            st.queue_transaction(t)
    a, b = sts["jax"], sts["torch"]
    assert snapshot(a) == snapshot(b) and snapshot(b)
    assert a.list_collections() == b.list_collections()
    if kind == "bluestore":
        assert a.statfs() == b.statfs()
        assert a.shared == b.shared
        assert a.perf.dump() == b.perf.dump()
    if kind != "mem":
        assert a.fsck() == b.fsck() == []
        a.umount()
        b.umount()
        assert tree_bytes(tmp_path / "jax") == tree_bytes(tmp_path / "torch")
        b2 = open_store("torch", kind, tmp_path / "torch")
        assert snapshot(b2) == snapshot(open_store("jax", kind,
                                                   tmp_path / "jax"))
        assert b2.fsck() == []


@pytest.mark.parametrize("kind,direction", [
    (k, d) for k in ("wal", "bluestore") for d in ("jax->torch",
                                                   "torch->jax")])
def test_directory_mounts_in_the_other_package(tmp_path, kind, direction):
    """A directory written by one package's store mounts in the other's,
    reads the same, fscks clean, takes more transactions, and is then
    read back by the writer."""
    src, dst = direction.split("->")
    st = open_store(src, kind, tmp_path / "d")
    for t in stream(src, seed=41, n=16):
        st.queue_transaction(t)
    want = snapshot(st)
    st.umount()
    other = open_store(dst, kind, tmp_path / "d")
    assert snapshot(other) == want and other.fsck() == []
    other.queue_transaction(txn(dst).write("1.0", "late", 0, b"L" * 9000))
    other.umount()
    back = open_store(src, kind, tmp_path / "d")
    assert back.read("1.0", "late") == b"L" * 9000
    assert back.fsck() == []
    back.umount()


@pytest.mark.parametrize("which", ["mem", "wal"])
def test_object_semantics(tmp_path, which):
    st = open_store("torch", which, tmp_path / "w")
    t = Transaction().create_collection("1.0")
    t.write("1.0", "obj", 0, b"hello world")
    t.write("1.0", "obj", 6, b"ceph!")
    t.setattrs("1.0", "obj", {"_": b"meta"})
    t.omap_setkeys("1.0", "obj", {"snap": b"1"})
    st.queue_transaction(t)
    assert st.read("1.0", "obj") == b"hello ceph!"
    assert st.read("1.0", "obj", 6, 4) == b"ceph"
    st.queue_transaction(Transaction().zero("1.0", "obj", 9, 4))
    assert st.read("1.0", "obj") == b"hello cep\x00\x00\x00\x00"
    st.queue_transaction(Transaction().truncate("1.0", "obj", 5))
    st.queue_transaction(Transaction().clone("1.0", "obj", "obj2"))
    assert st.read("1.0", "obj2") == b"hello"
    assert st.omap_get("1.0", "obj2") == {"snap": b"1"}
    st.queue_transaction(Transaction().remove("1.0", "obj"))
    assert not st.exists("1.0", "obj") and st.exists("1.0", "obj2")
    with pytest.raises(StoreError):
        st.read("1.0", "obj")
    with pytest.raises(StoreError):
        st.queue_transaction(Transaction().touch("nope", "o"))


@pytest.mark.parametrize("kind", ["mem", "wal", "bluestore"])
def test_transaction_all_or_nothing(tmp_path, kind):
    """A transaction that fails part way leaves the store as it was, and
    a collection removed and re-created in one transaction is empty to
    the validator; as in ceph_tpu."""
    for pkg in ("jax", "torch"):
        st = open_store(pkg, kind, tmp_path / pkg)
        st.queue_transaction(txn(pkg).create_collection("1.0").write(
            "1.0", "a", 0, b"before"))
        bad = txn(pkg).write("1.0", "a", 0, b"after")
        bad.ops.append((OP_RMATTR, "1.0", "missing", "x"))
        with pytest.raises(Exception, match="missing|no object|ENOENT"):
            st.queue_transaction(bad)
        assert st.read("1.0", "a") == b"before"
        bad = txn(pkg)
        bad.remove_collection("1.0")
        bad.create_collection("1.0")
        bad.omap_clear("1.0", "a")
        with pytest.raises(Exception):
            st.queue_transaction(bad)
        assert st.read("1.0", "a") == b"before"


def test_walstore_crash_atomicity_and_checksum(tmp_path):
    """A transaction torn mid-append is entirely absent on reopen; bit
    rot in an object record is caught by fsck and by full and ranged
    reads; ceph_tpu reports the same."""
    path = str(tmp_path / "w")
    st = WALStore(path)
    st.queue_transaction(
        Transaction().create_collection("1.0").write("1.0", "a", 0, b"A"))
    st.queue_transaction(
        Transaction().write("1.0", "a", 0, b"B").write("1.0", "b", 0, b"n"))
    st.umount()
    wal = os.path.join(path, WALDB.WAL)
    with open(wal, "r+b") as f:
        f.truncate(os.path.getsize(wal) - 2)
    st2 = WALStore(path)
    assert st2.read("1.0", "a") == b"A" and not st2.exists("1.0", "b")
    st2.queue_transaction(Transaction().write(
        "1.0", "a", 0, b"payload-payload-payload"))
    key = WALStore._okey("1.0", "a")
    rec = bytearray(st2.db.get("O", key))
    rec[10] ^= 0xFF
    st2.db.submit_transaction(
        st2.db.get_transaction().set("O", key, bytes(rec)))
    st2.umount()
    st3 = WALStore(path)
    errs = st3.fsck()
    assert any("checksum" in e for e in errs)
    with pytest.raises(ChecksumError):
        st3.read("1.0", "a")
    with pytest.raises(ChecksumError):
        st3.read("1.0", "a", 2, 4)
    st3.umount()
    ref = JaxWALStore(path)
    assert ref.fsck() == errs
    ref.umount()


@pytest.mark.parametrize("point", ["after_kv_commit", "before_kv_commit"])
def test_bluestore_crash_points_replay_like_reference(tmp_path, point):
    """Crash after the kv commit of a deferred overwrite (the record
    replays on mount: the new bytes), or after a COW block write before
    the commit (the old bytes survive). Each package's crashed directory
    mounts in both packages with the same content and a clean fsck."""
    want = {"after_kv_commit": b"A" * 10 + b"CRASH" + b"A" * (4096 - 15),
            "before_kv_commit": b"A" * 4096}[point]
    for pkg in ("jax", "torch"):
        s = open_store(pkg, "bluestore", tmp_path / pkg)
        s.queue_transaction(txn(pkg).create_collection("c"))
        s.queue_transaction(txn(pkg).write("c", "o", 0, b"A" * 4096))
        s._fail_point = point
        crash = txn(pkg).write("c", "o", 10, b"CRASH") \
            if point == "after_kv_commit" else \
            txn(pkg).write("c", "o", 0, b"NEW!" * 32768)
        with pytest.raises(Exception, match="fail point"):
            s.queue_transaction(crash)
        s.db.close()
        s._f.close()
    assert tree_bytes(tmp_path / "jax") == tree_bytes(tmp_path / "torch")
    for pkg in ("jax", "torch"):
        for reader in ("jax", "torch"):
            s2 = open_store(reader, "bluestore", tmp_path / pkg)
            assert s2.read("c", "o") == want
            assert s2.fsck() == []
            s2.db.close()
            s2._f.close()


def test_bluestore_deferred_path_and_statfs(tmp_path):
    """A small overwrite inside an allocated AU keeps its extents (the
    deferred path); a sparse write allocates one AU; truncate frees; the
    same statfs as ceph_tpu after each step."""
    sts = {pkg: open_store(pkg, "bluestore", tmp_path / pkg)
           for pkg in ("jax", "torch")}
    steps = [lambda t: t.create_collection("c"),
             lambda t: t.write("c", "o", 0, b"A" * 8192),
             lambda t: t.write("c", "o", 100, b"B" * 50),
             lambda t: t.write("c", "s", 1 << 20, b"tail"),
             lambda t: t.truncate("c", "o", 3000),
             lambda t: t.truncate("c", "o", 8192)]
    for i, step in enumerate(steps):
        for pkg, st in sts.items():
            step_t = txn(pkg)
            step(step_t)
            st.queue_transaction(step_t)
        assert sts["jax"].statfs() == sts["torch"].statfs(), i
        if i == 2:
            ext = [tuple(x[:3]) for x in sts["torch"].onodes[("c", "o")]
                   .extents]
            assert ext == [tuple(x[:3]) for x in
                           sts["jax"].onodes[("c", "o")].extents]
    b = sts["torch"]
    assert b.read("c", "o", 0, 200) == b"A" * 100 + b"B" * 50 + b"A" * 50
    assert b.read("c", "o", 3000, 5192) == b"\0" * 5192
    assert b.read("c", "s", 0, 16) == b"\0" * 16
    assert b.fsck() == sts["jax"].fsck() == []


@pytest.mark.parametrize("case", ["pin_until_last", "remount",
                                  "truncate", "drift", "knob_off"])
def test_shared_blob_clone_refcounts_match_reference(tmp_path, case):
    """Shared-blob clones: zero data bytes move, AUs free only at
    refcount 0, the table persists, fsck's census catches a stored count
    that drifts; the refcount table, statfs, perf family and fsck equal
    ceph_tpu's at every step."""
    cfg = {"bluestore_sharedblob_enabled": case != "knob_off"}
    sts = {}
    for pkg, cls in (("jax", JaxBlueStore), ("torch", BlueStore)):
        sts[pkg] = cls(str(tmp_path / pkg), size=BS_SIZE, config=dict(cfg))

    def apply(fn):
        for pkg, st in sts.items():
            t = txn(pkg)
            fn(t)
            st.queue_transaction(t)
        a, b = sts["jax"], sts["torch"]
        assert a.shared == b.shared and a.statfs() == b.statfs()
        assert a.perf.dump() == b.perf.dump()
        assert a.fsck() == b.fsck() == []
        return b

    apply(lambda t: t.create_collection("c"))
    apply(lambda t: t.write("c", "o", 0, b"P" * 32768))
    used = sts["torch"].statfs()["allocated"]
    b = apply(lambda t: t.clone("c", "o", "a"))
    if case == "knob_off":
        assert b.statfs()["allocated"] == 2 * used
        assert b.statfs()["shared_blobs"] == 0
        return
    assert b.statfs()["allocated"] == used and b.statfs()["shared_blobs"]
    if case == "pin_until_last":
        apply(lambda t: t.clone("c", "o", "b"))
        apply(lambda t: t.remove("c", "o"))
        b = apply(lambda t: t.remove("c", "a"))
        assert b.statfs()["allocated"] == used
        b = apply(lambda t: t.remove("c", "b"))
        assert b.statfs()["allocated"] == 0 == b.statfs()["shared_blobs"]
    elif case == "remount":
        for st in sts.values():
            st.umount()
        assert tree_bytes(tmp_path / "jax") == tree_bytes(tmp_path / "torch")
        sts = {"jax": BlueStore(str(tmp_path / "jax"), size=BS_SIZE),
               "torch": JaxBlueStore(str(tmp_path / "torch"), size=BS_SIZE)}
        sts = {"jax": sts["torch"], "torch": sts["jax"]}   # crossed mounts
        b = apply(lambda t: t.write("c", "o", 0, b"W" * 32768))
        assert b.read("c", "a") == b"P" * 32768
        b = apply(lambda t: t.remove("c", "a"))
        assert b.statfs()["shared_blobs"] == 0
    elif case == "truncate":
        b = apply(lambda t: t.truncate("c", "a", 4096))
        assert b.statfs()["allocated"] == used
        assert b.read("c", "o") == b"P" * 32768
        assert b.read("c", "a") == b"P" * 4096
    else:
        for st in sts.values():
            sb = next(iter(st.shared))
            st.shared[sb][next(iter(st.shared[sb]))] += 1
        errs = sts["torch"].fsck()
        assert errs == sts["jax"].fsck()
        assert any("refcount" in e for e in errs)


def test_bluestore_fsck_detects_block_corruption(tmp_path):
    """A flipped byte in the block file: the same fsck errors in both
    packages, a ChecksumError on read, and a full AU-aligned rewrite
    repairs it."""
    s = BlueStore(str(tmp_path / "bs"), size=BS_SIZE)
    s.queue_transaction(Transaction().create_collection("c"))
    s.queue_transaction(Transaction().write("c", "o", 0, b"D" * 4096))
    au = s.onodes[("c", "o")].extents[0][1]
    s._f.seek(au * s.AU + 17)
    s._f.write(b"\xff")
    s._f.flush()
    errs = s.fsck()
    assert errs and "crc mismatch" in errs[0]
    with pytest.raises(ChecksumError):
        s.read("c", "o")
    s.umount()
    ref = JaxBlueStore(str(tmp_path / "bs"), size=BS_SIZE)
    assert ref.fsck() == errs
    ref.umount()
    s = BlueStore(str(tmp_path / "bs"), size=BS_SIZE)
    s.queue_transaction(Transaction().write("c", "o", 0, b"R" * 4096))
    assert s.read("c", "o") == b"R" * 4096 and s.fsck() == []
    s.umount()


# -- objectstore tool -------------------------------------------------------

@pytest.mark.parametrize("kind", ["wal", "bluestore"])
def test_objectstore_tool_export_bytes_equal(tmp_path, kind):
    """export_pg gives ceph_tpu's bytes for the same store contents; the
    port's import of ceph_tpu's export reads back the same PG."""
    sts = {pkg: open_store(pkg, kind, tmp_path / pkg)
           for pkg in ("jax", "torch")}
    for pkg, st in sts.items():
        for t in stream(pkg, seed=51, n=12):
            st.queue_transaction(t)
    for pgid in ("1.0", "1.1"):
        blob = tool.export_pg(sts["torch"], pgid)
        assert blob == jax_tool.export_pg(sts["jax"], pgid)
        dst = WALStore(str(tmp_path / f"dst{pgid}"))
        assert tool.import_pg(dst, jax_tool.export_pg(sts["jax"], pgid)) \
            == pgid
        assert {k: v for k, v in snapshot(dst).items()} == {
            k: v for k, v in snapshot(sts["torch"]).items() if k[0] == pgid}
        assert dst.fsck() == []
        dst.umount()
    with pytest.raises(SystemExit):
        tool.import_pg(WALStore(str(tmp_path / "bad")), b"\0" * 16)


def test_objectstore_tool_cli_roundtrip(tmp_path, capsys):
    """The CLI's list-pgs, list, export, import, info, remove and fsck on
    a WALStore, and on a BlueStore sniffed by its block file; the export
    file equals ceph_tpu's tool's."""
    src = str(tmp_path / "osd0")
    st = WALStore(src)
    t = Transaction().create_collection("1.0")
    t.write("1.0", "a", 0, b"alpha")
    t.setattrs("1.0", "a", {"_v": b"\x01"})
    t.omap_setkeys("1.0", "a", {"k": b"v"})
    t.create_collection("1.1")
    t.write("1.1", "b", 0, b"beta")
    st.queue_transaction(t)
    st.umount()
    assert tool.main(["--data-path", src, "--op", "list-pgs"]) == 0
    assert set(capsys.readouterr().out.split()) == {"1.0", "1.1"}
    assert tool.main(["--data-path", src, "--op", "list",
                      "--pgid", "1.0"]) == 0
    assert capsys.readouterr().out.splitlines() == ['["1.0", "a"]']
    exp, jexp = str(tmp_path / "pg.exp"), str(tmp_path / "pg.jexp")
    assert tool.main(["--data-path", src, "--op", "export", "--pgid",
                      "1.0", "--file", exp]) == 0
    assert jax_tool.main(["--data-path", src, "--op", "export", "--pgid",
                          "1.0", "--file", jexp]) == 0
    assert open(exp, "rb").read() == open(jexp, "rb").read()
    dst = str(tmp_path / "osd1")
    BlueStore(dst, size=BS_SIZE).umount()
    assert tool.main(["--data-path", dst, "--op", "import",
                      "--file", exp]) == 0
    capsys.readouterr()
    assert tool.main(["--data-path", dst, "--op", "info", "--pgid",
                      "1.0", "--object", "a"]) == 0
    assert capsys.readouterr().out.strip() == (
        '{"pgid": "1.0", "oid": "a", "size": 5, "attrs": {"_v": "01"}, '
        '"omap_keys": ["k"]}')
    assert tool.main(["--data-path", src, "--op", "remove",
                      "--pgid", "1.1"]) == 0
    assert tool.main(["--data-path", dst, "--op", "fsck"]) == 0
    assert tool.main(["--data-path", src, "--op", "info", "--pgid",
                      "1.1", "--object", "b"]) == 1


# -- PG log -----------------------------------------------------------------

def _log(mod, entries):
    lg = mod.PGLog()
    for ep, v, oid, op in entries:
        lg.add(mod.eversion(ep, v), oid, op)
    return lg


@pytest.mark.parametrize("case", ["encode", "merge", "trim"])
def test_pg_log_matches_reference(case):
    """PGLog and LogEntry encode to ceph_tpu's bytes and decode across;
    continuity, missing sets and merges agree."""
    rng = np.random.default_rng(61)
    entries = [(1 + i // 5, i + 1, f"o{int(rng.integers(0, 6))}",
                int(rng.integers(1, 4))) for i in range(30)]
    a, b = _log(jax_pg_log, entries), _log(pg_log, entries)
    if case == "encode":
        assert a.encode() == b.encode()
        assert pg_log.PGLog.decode(a.encode()).encode() == a.encode()
        assert jax_pg_log.PGLog.decode(b.encode()).encode() == b.encode()
        e = b.entries[3]
        assert e.encode() == a.entries[3].encode()
        assert pg_log.LogEntry.decode(e.encode()) == e
        assert str(pg_log.eversion(3, 7)) == str(jax_pg_log.eversion(3, 7))
    elif case == "merge":
        short = entries[:18]
        pa, pb = _log(jax_pg_log, short), _log(pg_log, short)
        for head in (pg_log.eversion(2, 10), pg_log.eversion(9, 99)):
            assert b.continuous_with(head) == a.continuous_with(
                jax_pg_log.eversion(*head))
        missing = pb.missing_vs(b)
        assert {k: v.encode() for k, v in missing.items()} == {
            k: v.encode() for k, v in pa.missing_vs(a).items()}
        merged = pb.merge(b)
        assert {k: v.encode() for k, v in merged.items()} == {
            k: v.encode() for k, v in pa.merge(a).items()}
        assert pb.encode() == pa.encode() == b.encode()
        assert {k: v.encode() for k, v in b.newest_per_object().items()} \
            == {k: v.encode() for k, v in a.newest_per_object().items()}
    else:
        a.trim(keep=7)
        b.trim(keep=7)
        assert len(b.entries) == 7 and a.encode() == b.encode()


@pytest.mark.parametrize("inline", [False, True])
def test_walstore_bench_small(tmp_path, capsys, inline):
    """``bench/walstore_bench.py`` at a small size: one timing a write,
    compactions started, and the store it made removed again."""
    import json

    from ceph_tpu_torch.bench import walstore_bench
    argv = ["--base-mib", "4", "--object-mib", "4", "--xfer-mib", "1",
            "--threshold-mib", "2", "--dir", str(tmp_path)]
    assert walstore_bench.main(argv + (["--inline"] if inline else [])) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["inline"] is inline and len(out["writes_s"]) == 4
    assert out["compactions"] >= 1
    assert out["worst_s"] == max(out["writes_s"]) > 0
    assert os.listdir(tmp_path) == []
