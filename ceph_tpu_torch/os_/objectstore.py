"""ObjectStore: transactional local object storage.

ref: src/os/ObjectStore.h — collections (one per PG) hold objects with
byte data, xattrs and an omap; all mutations travel in an atomic
``Transaction`` (op list), exactly the unit ReplicatedBackend ships to
replicas and BlueStore commits through its WAL. Reads are synchronous
(ref: ObjectStore::read/stat/omap_get_values).

Implementations: MemStore (RAM, ref src/os/memstore) and WALStore
(kv-backed with checksummed data + crash-consistent WAL + fsck,
the BlueStore seat in this framework).

The port's copy of ``ceph_tpu/os_/objectstore.py``.
"""

from __future__ import annotations

import zlib

from ceph_tpu_torch.encoding.denc import Decoder, Encoder
from ceph_tpu_torch.os_.kv import WALDB, KVTransaction

# op codes (ref: ObjectStore::Transaction::Op enum)
OP_TOUCH = 1
OP_WRITE = 2
OP_ZERO = 3
OP_TRUNCATE = 4
OP_REMOVE = 5
OP_SETATTRS = 6
OP_RMATTR = 7
OP_CLONE = 8
OP_MKCOLL = 9
OP_RMCOLL = 10
OP_OMAP_SETKEYS = 11
OP_OMAP_RMKEYS = 12
OP_OMAP_CLEAR = 13


class StoreError(Exception):
    pass


class ChecksumError(StoreError):
    pass


class Transaction:
    """ref: ObjectStore::Transaction — ordered op list, all-or-nothing."""

    def __init__(self) -> None:
        self.ops: list[tuple] = []

    # -- builders ---------------------------------------------------------
    def create_collection(self, cid: str) -> "Transaction":
        self.ops.append((OP_MKCOLL, cid))
        return self

    def remove_collection(self, cid: str) -> "Transaction":
        self.ops.append((OP_RMCOLL, cid))
        return self

    def touch(self, cid: str, oid: str) -> "Transaction":
        self.ops.append((OP_TOUCH, cid, oid))
        return self

    def write(self, cid: str, oid: str, offset: int,
              data: bytes) -> "Transaction":
        self.ops.append((OP_WRITE, cid, oid, offset, bytes(data)))
        return self

    def zero(self, cid: str, oid: str, offset: int,
             length: int) -> "Transaction":
        self.ops.append((OP_ZERO, cid, oid, offset, length))
        return self

    def truncate(self, cid: str, oid: str, size: int) -> "Transaction":
        self.ops.append((OP_TRUNCATE, cid, oid, size))
        return self

    def remove(self, cid: str, oid: str) -> "Transaction":
        self.ops.append((OP_REMOVE, cid, oid))
        return self

    def setattrs(self, cid: str, oid: str,
                 attrs: dict[str, bytes]) -> "Transaction":
        self.ops.append((OP_SETATTRS, cid, oid, dict(attrs)))
        return self

    def rmattr(self, cid: str, oid: str, name: str) -> "Transaction":
        self.ops.append((OP_RMATTR, cid, oid, name))
        return self

    def clone(self, cid: str, oid: str, noid: str) -> "Transaction":
        self.ops.append((OP_CLONE, cid, oid, noid))
        return self

    def omap_setkeys(self, cid: str, oid: str,
                     kv: dict[str, bytes]) -> "Transaction":
        self.ops.append((OP_OMAP_SETKEYS, cid, oid, dict(kv)))
        return self

    def omap_rmkeys(self, cid: str, oid: str, keys: list[str]
                    ) -> "Transaction":
        self.ops.append((OP_OMAP_RMKEYS, cid, oid, list(keys)))
        return self

    def omap_clear(self, cid: str, oid: str) -> "Transaction":
        self.ops.append((OP_OMAP_CLEAR, cid, oid))
        return self

    def empty(self) -> bool:
        return not self.ops

    def append(self, other: "Transaction") -> "Transaction":
        self.ops.extend(other.ops)
        return self

    # -- wire form (shipped in rep ops; ref: Transaction::encode) ---------
    def encode(self) -> bytes:
        e = Encoder()
        e.u32(len(self.ops))
        for op in self.ops:
            code = op[0]
            e.u8(code).string(op[1])                   # cid
            if code in (OP_MKCOLL, OP_RMCOLL):
                continue
            e.string(op[2])                            # oid
            if code == OP_WRITE:
                e.u64(op[3]).blob(op[4])
            elif code == OP_ZERO:
                e.u64(op[3]).u64(op[4])
            elif code == OP_TRUNCATE:
                e.u64(op[3])
            elif code in (OP_SETATTRS, OP_OMAP_SETKEYS):
                e.map(op[3], lambda e, k: e.string(k),
                      lambda e, v: e.blob(v))
            elif code == OP_RMATTR:
                e.string(op[3])
            elif code == OP_CLONE:
                e.string(op[3])
            elif code == OP_OMAP_RMKEYS:
                e.list(op[3], lambda e, k: e.string(k))
        return e.tobytes()

    @classmethod
    def decode(cls, data: bytes) -> "Transaction":
        d = Decoder(data)
        t = cls()
        for _ in range(d.u32()):
            code = d.u8()
            cid = d.string()
            if code in (OP_MKCOLL, OP_RMCOLL):
                t.ops.append((code, cid))
                continue
            oid = d.string()
            if code == OP_WRITE:
                t.ops.append((code, cid, oid, d.u64(), d.blob()))
            elif code == OP_ZERO:
                t.ops.append((code, cid, oid, d.u64(), d.u64()))
            elif code == OP_TRUNCATE:
                t.ops.append((code, cid, oid, d.u64()))
            elif code in (OP_SETATTRS, OP_OMAP_SETKEYS):
                t.ops.append((code, cid, oid, d.map(
                    lambda d: d.string(), lambda d: d.blob())))
            elif code in (OP_RMATTR, OP_CLONE):
                t.ops.append((code, cid, oid, d.string()))
            elif code == OP_OMAP_RMKEYS:
                t.ops.append((code, cid, oid,
                              d.list(lambda d: d.string())))
            else:
                t.ops.append((code, cid, oid))
        return t


class ObjectStore:
    """The interface (ref: src/os/ObjectStore.h)."""

    def queue_transaction(self, t: Transaction) -> None:
        raise NotImplementedError

    # reads
    def read(self, cid: str, oid: str, offset: int = 0,
             length: int | None = None) -> bytes:
        raise NotImplementedError

    def stat(self, cid: str, oid: str) -> int:
        """Returns size; raises StoreError if missing."""
        raise NotImplementedError

    def exists(self, cid: str, oid: str) -> bool:
        try:
            self.stat(cid, oid)
            return True
        except StoreError:
            return False

    def getattrs(self, cid: str, oid: str) -> dict[str, bytes]:
        raise NotImplementedError

    def omap_get(self, cid: str, oid: str) -> dict[str, bytes]:
        raise NotImplementedError

    def list_objects(self, cid: str) -> list[str]:
        raise NotImplementedError

    def list_collections(self) -> list[str]:
        raise NotImplementedError

    def collection_exists(self, cid: str) -> bool:
        return cid in self.list_collections()

    def mount(self) -> None:
        pass

    def umount(self) -> None:
        pass


class _Obj:
    __slots__ = ("data", "attrs", "omap")

    def __init__(self) -> None:
        self.data = bytearray()
        self.attrs: dict[str, bytes] = {}
        self.omap: dict[str, bytes] = {}


class MemStore(ObjectStore):
    """RAM ObjectStore (ref: src/os/memstore/MemStore.{h,cc}) — the
    cluster-free test seam, and the state model WALStore persists."""

    def __init__(self) -> None:
        self.colls: dict[str, dict[str, _Obj]] = {}

    # -- transaction apply -------------------------------------------------
    def _coll(self, cid: str) -> dict[str, _Obj]:
        try:
            return self.colls[cid]
        except KeyError:
            raise StoreError(f"no collection {cid}") from None

    def _obj(self, cid: str, oid: str, create: bool = False) -> _Obj:
        coll = self._coll(cid)
        o = coll.get(oid)
        if o is None:
            if not create:
                raise StoreError(f"no object {cid}/{oid}")
            o = coll[oid] = _Obj()
        return o

    def queue_transaction(self, t: Transaction) -> None:
        # All-or-nothing: validate every op against simulated existence
        # state BEFORE mutating, so a bad op cannot leave memory
        # half-applied while the caller treats the txn as failed
        # (ref: ObjectStore::Transaction atomicity contract).
        self._validate(t.ops)
        for op in t.ops:
            self._apply_op(op)

    # ops whose object lookup auto-creates (mirrors _apply_op)
    _CREATES = frozenset((OP_TOUCH, OP_WRITE, OP_ZERO, OP_TRUNCATE,
                          OP_SETATTRS, OP_OMAP_SETKEYS))
    # ops that raise when the object is missing
    _NEEDS_OBJ = frozenset((OP_RMATTR, OP_OMAP_RMKEYS, OP_OMAP_CLEAR))

    def _validate(self, ops) -> None:
        """Dry-run existence simulation of _apply_op: raises the same
        StoreErrors it would, without touching live state."""
        colls: dict[str, bool] = {}
        objs: dict[tuple[str, str], bool] = {}
        # cids whose contents were dropped by a simulated RMCOLL: object
        # existence under them is decided by the simulation alone, never
        # by live state (an RMCOLL+MKCOLL pair leaves the coll EMPTY).
        reset: set[str] = set()

        def cexists(cid: str) -> bool:
            if cid not in colls:
                colls[cid] = cid in self.colls
            return colls[cid]

        def oexists(cid: str, oid: str) -> bool:
            key = (cid, oid)
            if key not in objs:
                if cid in reset:
                    objs[key] = False
                else:
                    coll = self.colls.get(cid)
                    objs[key] = coll is not None and oid in coll
            return objs[key]

        for op in ops:
            code = op[0]
            if code == OP_MKCOLL:
                colls[op[1]] = True
                continue
            if code == OP_RMCOLL:
                colls[op[1]] = False
                reset.add(op[1])
                for key in [k for k in objs if k[0] == op[1]]:
                    del objs[key]
                continue
            cid, oid = op[1], op[2]
            if not cexists(cid):
                raise StoreError(f"no collection {cid}")
            if code in self._CREATES:
                objs[(cid, oid)] = True
            elif code == OP_CLONE:
                if not oexists(cid, oid):
                    raise StoreError(f"no object {cid}/{oid}")
                objs[(cid, op[3])] = True
            elif code in self._NEEDS_OBJ:
                if not oexists(cid, oid):
                    raise StoreError(f"no object {cid}/{oid}")
            elif code == OP_REMOVE:
                objs[(cid, oid)] = False
            else:
                raise StoreError(f"unknown op {code}")

    def _apply_op(self, op: tuple) -> None:
        code = op[0]
        if code == OP_MKCOLL:
            self.colls.setdefault(op[1], {})
            return
        if code == OP_RMCOLL:
            self.colls.pop(op[1], None)
            return
        cid, oid = op[1], op[2]
        if code == OP_TOUCH:
            self._obj(cid, oid, create=True)
        elif code == OP_WRITE:
            o = self._obj(cid, oid, create=True)
            off, data = op[3], op[4]
            if len(o.data) < off + len(data):
                o.data.extend(b"\x00" * (off + len(data) - len(o.data)))
            o.data[off:off + len(data)] = data
        elif code == OP_ZERO:
            o = self._obj(cid, oid, create=True)
            off, ln = op[3], op[4]
            if len(o.data) < off + ln:
                o.data.extend(b"\x00" * (off + ln - len(o.data)))
            o.data[off:off + ln] = b"\x00" * ln
        elif code == OP_TRUNCATE:
            o = self._obj(cid, oid, create=True)
            size = op[3]
            if size < len(o.data):
                del o.data[size:]
            else:
                o.data.extend(b"\x00" * (size - len(o.data)))
        elif code == OP_REMOVE:
            self._coll(cid).pop(oid, None)
        elif code == OP_SETATTRS:
            self._obj(cid, oid, create=True).attrs.update(op[3])
        elif code == OP_RMATTR:
            self._obj(cid, oid).attrs.pop(op[3], None)
        elif code == OP_CLONE:
            src = self._obj(cid, oid)
            dst = self._obj(cid, op[3], create=True)
            dst.data = bytearray(src.data)
            dst.attrs = dict(src.attrs)
            dst.omap = dict(src.omap)
        elif code == OP_OMAP_SETKEYS:
            self._obj(cid, oid, create=True).omap.update(op[3])
        elif code == OP_OMAP_RMKEYS:
            o = self._obj(cid, oid)
            for k in op[3]:
                o.omap.pop(k, None)
        elif code == OP_OMAP_CLEAR:
            self._obj(cid, oid).omap.clear()
        else:
            raise StoreError(f"unknown op {code}")

    # -- reads -------------------------------------------------------------
    def read(self, cid, oid, offset=0, length=None):
        o = self._obj(cid, oid)
        end = len(o.data) if length is None else offset + length
        return bytes(o.data[offset:end])

    def stat(self, cid, oid):
        return len(self._obj(cid, oid).data)

    def getattrs(self, cid, oid):
        return dict(self._obj(cid, oid).attrs)

    def omap_get(self, cid, oid):
        return dict(self._obj(cid, oid).omap)

    def list_objects(self, cid):
        return sorted(self._coll(cid))

    def list_collections(self):
        return sorted(self.colls)


class WALStore(MemStore):
    """Durable ObjectStore: MemStore semantics + WALDB persistence with
    per-object data checksums and fsck.

    ref: src/os/bluestore/BlueStore.{h,cc} — same contract, small
    machine: each ObjectStore transaction becomes ONE atomic kv batch
    (WALDB's crc-framed WAL gives commit atomicity and torn-tail
    discard, the role RocksDB's WAL plays under BlueStore), each object
    record carries a crc32 over its data verified on read (BlueStore
    csum_type=crc32c), and ``fsck`` revalidates every record
    (ref: BlueStore::_fsck).

    kv layout: prefix "L" = collections, prefix "O" = one record per
    object (data + attrs + omap + crc), key ``cid\\0oid``.
    """

    def __init__(self, path: str, compact_threshold: int = 64 << 20):
        super().__init__()
        self.db = WALDB(path, compact_threshold=compact_threshold)
        # (cid, oid) whose kv record checksum has been verified since
        # its last write — lets ranged reads verify once per version.
        self._verified: set[tuple[str, str]] = set()
        self._load()

    @staticmethod
    def _okey(cid: str, oid: str) -> str:
        return f"{cid}\x00{oid}"

    @staticmethod
    def _encode_obj(o: _Obj) -> bytes:
        e = Encoder()
        e.blob(o.data)                  # no copies of a large object first
        e.map(o.attrs, lambda e, k: e.string(k), lambda e, v: e.blob(v))
        e.map(o.omap, lambda e, k: e.string(k), lambda e, v: e.blob(v))
        e.u32(zlib.crc32(o.data))
        return e.tobytes()

    @staticmethod
    def _decode_obj(data: bytes) -> tuple[_Obj, bool]:
        d = Decoder(data)
        o = _Obj()
        o.data = bytearray(d.blob())
        o.attrs = d.map(lambda d: d.string(), lambda d: d.blob())
        o.omap = d.map(lambda d: d.string(), lambda d: d.blob())
        ok = d.u32() == zlib.crc32(o.data)
        return o, ok

    def _load(self) -> None:
        for cid, _ in self.db.get_iterator("L"):
            self.colls[cid] = {}
        for key, rec in self.db.get_iterator("O"):
            cid, _, oid = key.partition("\x00")
            o, _ok = self._decode_obj(rec)   # fsck reports bad crc
            self.colls.setdefault(cid, {})[oid] = o

    def queue_transaction(self, t: Transaction) -> None:
        import time as _time
        # capture pre-state needed for RMCOLL persistence
        removed_coll_objs: dict[str, list[str]] = {}
        for op in t.ops:
            if op[0] == OP_RMCOLL and op[1] in self.colls:
                removed_coll_objs[op[1]] = list(self.colls[op[1]])
        self.last_txn_phases = {}           # a raised txn reports none
        _t0 = _time.monotonic()
        super().queue_transaction(t)        # apply to memory (may raise)
        _t1 = _time.monotonic()
        kt = self.db.get_transaction()
        touched: set[tuple[str, str]] = set()
        for op in t.ops:
            code = op[0]
            if code == OP_MKCOLL:
                kt.set("L", op[1], b"")
            elif code == OP_RMCOLL:
                kt.rmkey("L", op[1])
                for oid in removed_coll_objs.get(op[1], []):
                    kt.rmkey("O", self._okey(op[1], oid))
            else:
                touched.add((op[1], op[2]))
                if code == OP_CLONE:
                    touched.add((op[1], op[3]))
        for cid, oid in sorted(touched):
            coll = self.colls.get(cid)
            o = coll.get(oid) if coll is not None else None
            self._verified.discard((cid, oid))
            if o is None:
                kt.rmkey("O", self._okey(cid, oid))
            else:
                kt.set("O", self._okey(cid, oid), self._encode_obj(o))
        for cid in removed_coll_objs:
            self._verified = {k for k in self._verified if k[0] != cid}
        self.db.submit_transaction(kt)
        # per-phase wall of the LAST transaction, for the tracing
        # layer's objectstore sub-span split (ref: BlueStore's
        # state_kv_queued/state_kv_committing latency counters):
        # "apply" = in-memory state, "wal_kv_commit" = the WAL-backed
        # kv batch (the durability point)
        self.last_txn_phases = {
            "apply": _t1 - _t0,
            "wal_kv_commit": _time.monotonic() - _t1}

    def read(self, cid, oid, offset=0, length=None):
        data = super().read(cid, oid, offset, length)
        # Verify the stored record checksum on EVERY read path, ranged
        # included — but only once per object version: re-decoding the
        # whole record per 4 KiB ranged read would be O(object) each
        # time. The verified set is invalidated on every write to the
        # object (queue_transaction) and repopulated lazily here.
        key = (cid, oid)
        if key not in self._verified:
            rec = self.db.get("O", self._okey(cid, oid))
            if rec is not None:
                _, ok = self._decode_obj(rec)
                if not ok:
                    raise ChecksumError(f"{cid}/{oid} checksum mismatch")
            self._verified.add(key)
        return data

    def fsck(self) -> list[str]:
        """Validate every persisted record (ref: BlueStore::_fsck).
        Returns error strings (empty = clean)."""
        errors = []
        for cid, coll in self.colls.items():
            if self.db.get("L", cid) is None:
                errors.append(f"{cid}: collection missing from kv")
            for oid in coll:
                rec = self.db.get("O", self._okey(cid, oid))
                if rec is None:
                    errors.append(f"{cid}/{oid}: missing record")
                    continue
                _, ok = self._decode_obj(rec)
                if not ok:
                    errors.append(f"{cid}/{oid}: checksum mismatch")
        return errors

    def umount(self) -> None:
        self.db.close()
