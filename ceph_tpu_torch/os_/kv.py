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
    """

    SNAPSHOT = "snapshot.kv"
    WAL = "wal.kv"

    def __init__(self, path: str, compact_threshold: int = 64 << 20):
        super().__init__()
        self.path = path
        self.compact_threshold = compact_threshold
        os.makedirs(path, exist_ok=True)
        self._replayed_bytes = 0
        self._load()
        self._wal = open(os.path.join(path, self.WAL), "ab")

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
        self._wal.write(_HDR.pack(len(payload)) + payload +
                        _HDR.pack(zlib.crc32(payload)))
        self._wal.flush()
        os.fsync(self._wal.fileno())

    # -- api ---------------------------------------------------------------
    def submit_transaction(self, t: KVTransaction) -> None:
        self._append(t.encode())
        self._apply(t)
        if self._wal.tell() > self.compact_threshold:
            self.compact()

    def compact(self) -> None:
        """Write the whole table as one snapshot batch; reset the WAL
        (ref: RocksDB memtable flush / BlueStore DB compaction)."""
        t = KVTransaction()
        for prefix, space in self._data.items():
            for k, v in space.items():
                t.set(prefix, k, v)
        tmp = os.path.join(self.path, self.SNAPSHOT + ".tmp")
        payload = t.encode()
        with open(tmp, "wb") as f:
            f.write(_HDR.pack(len(payload)) + payload +
                    _HDR.pack(zlib.crc32(payload)))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.path, self.SNAPSHOT))
        # The rename must be durable BEFORE the WAL is truncated: on
        # power loss an un-fsynced rename can be lost while the
        # truncation survives, dropping every transaction since the
        # previous snapshot. fsync the directory entry first.
        dfd = os.open(self.path, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        self._wal.close()
        self._wal = open(os.path.join(self.path, self.WAL), "wb")

    def close(self) -> None:
        self._wal.close()
