"""KeyValueDB: the kv abstraction under the object store and mon store.

ref: src/kv/KeyValueDB.h (RocksDBStore / MemDB behind one interface) —
prefixed keyspaces, atomic write batches, ordered iteration. Two
implementations: ``MemDB`` (RAM, tests) and ``WALDB`` (append-only
write-ahead log + in-memory table + snapshot compaction: the same
crash-consistency contract BlueStore gets from RocksDB's WAL, sized for
this framework's metadata volumes).

The port's copy of ``ceph_tpu/os_/kv.py``.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import Iterator

from ceph_tpu_torch.encoding.denc import Decoder, Encoder


class KVTransaction:
    """Atomic batch (ref: KeyValueDB::Transaction)."""

    def __init__(self) -> None:
        self.ops: list[tuple[str, str, str, bytes | None]] = []

    def set(self, prefix: str, key: str, value: bytes) -> "KVTransaction":
        self.ops.append(("set", prefix, key, bytes(value)))
        return self

    def rmkey(self, prefix: str, key: str) -> "KVTransaction":
        self.ops.append(("rm", prefix, key, None))
        return self

    def rmkeys_by_prefix(self, prefix: str) -> "KVTransaction":
        self.ops.append(("rmprefix", prefix, "", None))
        return self

    def encode(self) -> bytes:
        e = Encoder()
        e.u32(len(self.ops))
        for op, prefix, key, value in self.ops:
            e.string(op).string(prefix).string(key)
            e.optional(value, lambda e, v: e.blob(v))
        return e.tobytes()

    @classmethod
    def decode(cls, data: bytes) -> "KVTransaction":
        d = Decoder(data)
        t = cls()
        for _ in range(d.u32()):
            op, prefix, key = d.string(), d.string(), d.string()
            value = d.optional(lambda d: d.blob())
            t.ops.append((op, prefix, key, value))
        return t


class KeyValueDB:
    """Interface (ref: src/kv/KeyValueDB.h)."""

    def get_transaction(self) -> KVTransaction:
        return KVTransaction()

    def submit_transaction(self, t: KVTransaction) -> None:
        raise NotImplementedError

    def submit_transaction_sync(self, t: KVTransaction) -> None:
        self.submit_transaction(t)

    def get(self, prefix: str, key: str) -> bytes | None:
        raise NotImplementedError

    def get_iterator(self, prefix: str) -> Iterator[tuple[str, bytes]]:
        """Ordered (key, value) pairs under one prefix."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemDB(KeyValueDB):
    """ref: src/kv/MemDB — RAM store for tests and MemStore."""

    def __init__(self) -> None:
        self._data: dict[str, dict[str, bytes]] = {}

    def _apply(self, t: KVTransaction) -> None:
        for op, prefix, key, value in t.ops:
            space = self._data.setdefault(prefix, {})
            if op == "set":
                space[key] = value
            elif op == "rm":
                space.pop(key, None)
            elif op == "rmprefix":
                self._data.pop(prefix, None)

    def submit_transaction(self, t: KVTransaction) -> None:
        self._apply(t)

    def get(self, prefix: str, key: str) -> bytes | None:
        return self._data.get(prefix, {}).get(key)

    def get_iterator(self, prefix: str):
        space = self._data.get(prefix, {})
        for k in sorted(space):
            yield k, space[k]


# WAL record framing: u32 len | payload | u32 crc32(payload)
_HDR = struct.Struct("<I")


class WALDB(MemDB):
    """Durable MemDB: every batch is appended to a crc-framed WAL before
    being applied; open() replays the snapshot + WAL, discarding a torn
    tail (the crash-consistency contract of a RocksDB WAL, ref:
    src/kv/RocksDBStore.cc submit_transaction_sync + BlueFS replay).

    A WAL past ``compact_threshold`` and past the snapshot that the last
    compaction wrote is compacted in a background thread, as RocksDB
    flushes and compacts off the write path: the thread writes the table
    as it stood at the trigger into a new snapshot, then copies the WAL's
    later records into a fresh WAL, which a later batch (or
    ``compact``/``close``) swaps in. Every file state on the way replays
    to the same table, because replaying records that a snapshot already
    holds leaves it unchanged (each op sets, removes or drops a prefix:
    the last op on a key decides it). The files are those that a
    synchronous compaction at the same point writes.

    Two rules keep compaction's writes from stalling the foreground
    fsync of a batch. The trigger grows with the table, as Redis
    rewrites its append-only file only once it has doubled
    (``auto-aof-rewrite-percentage 100`` over ``auto-aof-rewrite-min-size``):
    rewriting the whole table costs at most the bytes that the WAL took
    since, where a fixed threshold rewrites a large table after every
    ``compact_threshold`` bytes of small batches. And the writer syncs
    every ``bytes_per_sync`` bytes (RocksDB's option of that name), so the
    disk never holds a whole snapshot of unwritten pages for a batch's
    fsync to wait behind.
    """

    SNAPSHOT = "snapshot.kv"
    WAL = "wal.kv"

    def __init__(self, path: str, compact_threshold: int = 64 << 20,
                 bytes_per_sync: int = 4 << 20):
        super().__init__()
        self.path = path
        self.compact_threshold = compact_threshold
        self.bytes_per_sync = bytes_per_sync
        os.makedirs(path, exist_ok=True)
        self._replayed_bytes = 0
        self._load()
        snap = os.path.join(path, self.SNAPSHOT)
        # the last compaction's snapshot: the WAL may grow to its size
        self._base = os.path.getsize(snap) if os.path.exists(snap) else 0
        self._wal = open(os.path.join(path, self.WAL), "ab")
        self._durable = self._wal.tell()    # WAL bytes written and synced
        self._bg: threading.Thread | None = None   # a running compaction
        self._bg_out: tuple = ()    # its (copied up to, snapshot size, error)

    # -- framing -----------------------------------------------------------
    @staticmethod
    def _read_records(path: str) -> tuple[list[bytes], int]:
        """Returns (payloads, clean_bytes); stops at the first torn or
        corrupt record (everything after a crash is discarded)."""
        out: list[bytes] = []
        clean = 0
        if not os.path.exists(path):
            return out, 0
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        while off + 4 <= len(data):
            (ln,) = _HDR.unpack_from(data, off)
            if off + 4 + ln + 4 > len(data):
                break           # torn tail
            payload = data[off + 4:off + 4 + ln]
            (crc,) = _HDR.unpack_from(data, off + 4 + ln)
            if zlib.crc32(payload) != crc:
                break           # corrupt: stop replay here
            out.append(payload)
            off += 8 + ln
            clean = off
        return out, clean

    def _load(self) -> None:
        snap, _ = self._read_records(os.path.join(self.path, self.SNAPSHOT))
        for payload in snap:
            self._apply(KVTransaction.decode(payload))
        wal, clean = self._read_records(os.path.join(self.path, self.WAL))
        for payload in wal:
            self._apply(KVTransaction.decode(payload))
        self._replayed_bytes = clean
        # truncate any torn tail so new appends start at a clean record
        walpath = os.path.join(self.path, self.WAL)
        if os.path.exists(walpath) and \
                os.path.getsize(walpath) > clean:
            with open(walpath, "r+b") as f:
                f.truncate(clean)

    def _append(self, payload: bytes) -> None:
        # three writes, not one concatenation: a record can hold a whole
        # object, and the bytes on disk are the same
        self._wal.write(_HDR.pack(len(payload)))
        self._wal.write(payload)
        self._wal.write(_HDR.pack(zlib.crc32(payload)))
        self._wal.flush()
        os.fsync(self._wal.fileno())
        self._durable = self._wal.tell()

    # -- api ---------------------------------------------------------------
    def submit_transaction(self, t: KVTransaction) -> None:
        self._append(t.encode())
        self._apply(t)
        if self._bg is not None and not self._bg.is_alive():
            self._finish_compaction()
        if self._bg is None and \
                self._wal.tell() > max(self.compact_threshold, self._base):
            self._bg_out = ()
            self._bg = threading.Thread(
                target=self._compact_job,
                args=(self._frozen(), self._durable), daemon=True)
            self._bg.start()

    def compact(self) -> None:
        """Write the whole table as one snapshot batch; reset the WAL
        (ref: RocksDB memtable flush / BlueStore DB compaction)."""
        self._wait_compaction()
        self._base = self._write_snapshot(self._frozen())
        self._wal.close()
        self._wal = open(os.path.join(self.path, self.WAL), "wb")
        self._durable = 0

    # -- compaction ----------------------------------------------------------
    def _frozen(self) -> list:
        """The table as it stands, in snapshot order (values are bytes,
        never changed in place, so the lists share them)."""
        return [(prefix, list(space.items()))
                for prefix, space in self._data.items()]

    def _fsync_dir(self) -> None:
        dfd = os.open(self.path, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def _write_snapshot(self, frozen: list) -> int:
        """The snapshot file: one record of a KVTransaction that sets every
        key, written piece by piece (the bytes of ``t.encode()``'s record,
        without building it in memory), synced and renamed into place.
        Returns its size."""
        tmp = os.path.join(self.path, self.SNAPSHOT + ".tmp")
        with open(tmp, "wb") as f:
            f.write(_HDR.pack(0))           # the length, filled in below
            head = Encoder().u32(sum(len(kvs) for _, kvs in frozen))
            head = head.tobytes()
            f.write(head)
            size, crc = len(head), zlib.crc32(head)
            synced = 0
            for prefix, kvs in frozen:
                for key, value in kvs:
                    op = Encoder().string("set").string(prefix).string(key)
                    op = op.bool(True).u32(len(value)).tobytes()
                    f.write(op)
                    f.write(value)
                    size += len(op) + len(value)
                    crc = zlib.crc32(value, zlib.crc32(op, crc))
                    if size - synced >= self.bytes_per_sync:
                        _sync(f)
                        synced = size
            f.write(_HDR.pack(crc))
            f.seek(0)
            f.write(_HDR.pack(size))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.path, self.SNAPSHOT))
        # The rename must be durable BEFORE the WAL is truncated: on
        # power loss an un-fsynced rename can be lost while the
        # truncation survives, dropping every transaction since the
        # previous snapshot. fsync the directory entry first.
        self._fsync_dir()
        return size + 2 * _HDR.size

    def _compact_job(self, frozen: list, covered: int) -> None:
        """In the background: the snapshot of ``frozen`` (the table after
        the WAL's first ``covered`` bytes), then the WAL's records after
        ``covered`` copied into ``wal.kv.tmp`` while batches go on being
        appended; ``_finish_compaction`` copies the rest and swaps."""
        try:
            base = self._write_snapshot(frozen)
            wal = os.path.join(self.path, self.WAL)
            pos = covered
            with open(wal, "rb") as src, open(wal + ".tmp", "wb") as dst:
                for _ in range(4):          # catch up with the appends
                    end = self._durable
                    if end - pos <= 1 << 20:
                        break
                    pos = _copy(src, dst, pos, end, self.bytes_per_sync)
                dst.flush()
                os.fsync(dst.fileno())
            self._bg_out = (pos, base, None)
        except BaseException as e:          # raised on the caller's side
            self._bg_out = (covered, self._base, e)

    def _finish_compaction(self) -> None:
        """On the caller's side once the job has ended: the WAL's newest
        records after it, then the fresh WAL in place of the old."""
        self._bg = None
        pos, self._base, err = self._bg_out
        if err is not None:
            raise err
        wal = os.path.join(self.path, self.WAL)
        with open(wal, "rb") as src, open(wal + ".tmp", "ab") as dst:
            _copy(src, dst, pos, self._durable)
            dst.flush()
            os.fsync(dst.fileno())
        self._wal.close()
        os.replace(wal + ".tmp", wal)
        self._fsync_dir()
        self._wal = open(wal, "ab")
        self._durable = self._wal.tell()

    def _wait_compaction(self) -> None:
        if self._bg is not None:
            self._bg.join()
            self._finish_compaction()

    def close(self) -> None:
        self._wait_compaction()
        self._wal.close()


def _copy(src, dst, start: int, end: int, chunk: int = 4 << 20) -> int:
    """Bytes ``[start, end)`` of the file ``src`` appended to ``dst``,
    synced every ``chunk`` bytes."""
    src.seek(start)
    while start < end:
        buf = src.read(min(chunk, end - start))
        dst.write(buf)
        _sync(dst)
        start += len(buf)
    return end


def _sync(f) -> None:
    """``f``'s written bytes to the disk (``bytes_per_sync``'s step; the
    file's metadata waits for the final fsync)."""
    f.flush()
    os.fdatasync(f.fileno())
