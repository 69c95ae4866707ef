"""BlueStoreLite: extent-allocated object store over a flat block file.

ref: src/os/bluestore/BlueStore.{h,cc} — the architecture in miniature,
not a translation:

- object DATA lives on a flat ``block`` file carved into ALLOCATION
  UNITS by a bitmap allocator (allocator.py); each onode carries an
  extent map [(logical_off, au, n_aus, crc32)] — BlueStore's
  ExtentMap/PExtentVector role, with csum_type=crc32c per extent.
- object METADATA (onodes: size + extents + xattrs + omap) lives in
  the WALDB key-value store — the RocksDB seat; every ObjectStore
  Transaction commits as ONE atomic kv batch.
- WRITES are copy-on-write at AU granularity: the affected AU range is
  rebuilt into freshly allocated space, the block file is written and
  flushed BEFORE the kv commit points at it, and the old AUs are freed
  after — BlueStore's big-write path, which makes torn block writes
  unreachable (metadata never references half-written space).
- SMALL overwrites that stay inside one already-allocated AU take the
  DEFERRED path instead: the bytes ride inside the kv batch (a "D"
  record) and are applied to the block file after the commit; mount
  replays any "D" records left by a crash (idempotent: whole-AU
  rewrite) — BlueStore's deferred_txn machinery.
- ``fsck`` walks every onode: extents in-bounds, no cross-object
  overlap, per-extent crc verified against the block file, allocator
  bitmap consistent with the union of extents (leak/double-use
  detection) — BlueStore::_fsck's core checks. ``statfs`` reports the
  allocator's view.

- CLONE is O(metadata) via SHARED BLOBS (ref: BlueStore::SharedBlob +
  bluestore_shared_blob_t): each extent carries a blob id (``sb_id``,
  0 = unshared); ``Transaction.clone`` stamps the source's extents
  with fresh sb_ids, bumps a persisted per-AU refcount table (kv
  prefix "B") and copies only the extent-map entries — zero data
  bytes move. Overwrites of a shared extent always take the COW path
  (never deferred-in-place), the punched AUs merely decrement their
  refs, and an AU returns to the allocator only at refcount 0
  (deferred-release discipline). ``fsck`` cross-checks the stored
  refcounts against the union of extent-map references.

Not rebuilt: compression, BlueFS/multi-device tiering, cache
trimming. Collections/omap/attrs reuse the kv directly.

The port's copy of ``ceph_tpu/os_/bluestore.py``.
"""

from __future__ import annotations

import os
import zlib

from ceph_tpu_torch.encoding.denc import Decoder, Encoder
from ceph_tpu_torch.os_.allocator import AllocatorError, BitmapAllocator
from ceph_tpu_torch.utils.perf_counters import PerfCountersBuilder
from ceph_tpu_torch.os_.kv import KVTransaction, WALDB
from ceph_tpu_torch.os_.objectstore import (
    OP_CLONE, OP_MKCOLL, OP_OMAP_CLEAR, OP_OMAP_RMKEYS, OP_OMAP_SETKEYS,
    OP_REMOVE, OP_RMATTR, OP_RMCOLL, OP_SETATTRS, OP_TOUCH, OP_TRUNCATE,
    OP_WRITE, OP_ZERO,
    ChecksumError, ObjectStore, StoreError, Transaction,
)


class _Onode:
    __slots__ = ("size", "extents", "attrs", "omap")

    def __init__(self):
        self.size = 0
        # [(loff, au, n_aus, crc32 of the logical bytes, sb_id)]
        # sorted by loff; gaps read as zeros (sparse objects).
        # sb_id 0 = unshared; nonzero names a shared-blob refcount
        # record (this AU range may be referenced by other onodes)
        self.extents: list[list[int]] = []
        self.attrs: dict[str, bytes] = {}
        self.omap: dict[str, bytes] = {}


def _enc_onode(o: _Onode) -> bytes:
    e = Encoder()
    e.u64(o.size)
    e.list(o.extents, lambda e, x:
           e.u64(x[0]).u64(x[1]).u64(x[2]).u32(x[3]).u64(x[4]))
    e.map(o.attrs, lambda e, k: e.string(k), lambda e, v: e.blob(v))
    e.map(o.omap, lambda e, k: e.string(k), lambda e, v: e.blob(v))
    return e.tobytes()


def _dec_onode(data: bytes) -> _Onode:
    d = Decoder(data)
    o = _Onode()
    o.size = d.u64()
    o.extents = d.list(lambda d: [d.u64(), d.u64(), d.u64(), d.u32(),
                                  d.u64()])
    o.attrs = d.map(lambda d: d.string(), lambda d: d.blob())
    o.omap = d.map(lambda d: d.string(), lambda d: d.blob())
    return o


def _enc_shared(refs: dict[int, int]) -> bytes:
    e = Encoder()
    e.map(refs, lambda e, k: e.u64(k), lambda e, v: e.u64(v))
    return e.tobytes()


def _dec_shared(data: bytes) -> dict[int, int]:
    return Decoder(data).map(lambda d: d.u64(), lambda d: d.u64())


class BlueStore(ObjectStore):
    """Extent-allocated durable ObjectStore (see module docstring)."""

    AU = 4096                     # min_alloc_size
    DEFERRED_MAX = 64 << 10       # small-overwrite deferred threshold

    def __init__(self, path: str, size: int = 64 << 20,
                 config: dict | None = None):
        self.path = path
        self.config = config if config is not None else {}
        os.makedirs(path, exist_ok=True)
        self.db = WALDB(os.path.join(path, "db"))
        self.block_path = os.path.join(path, "block")
        sb = self.db.get("S", "super")
        if sb is None:
            self.size = size - size % self.AU
            with open(self.block_path, "wb") as f:
                f.truncate(self.size)
            t = KVTransaction()
            e = Encoder()
            e.u64(self.size).u32(self.AU)
            t.set("S", "super", e.tobytes())
            self.db.submit_transaction(t)
        else:
            d = Decoder(sb)
            self.size = d.u64()
            if d.u32() != self.AU:
                raise StoreError("allocation unit mismatch")
        self._f = open(self.block_path, "r+b")
        self.alloc = BitmapAllocator(self.size // self.AU)
        self.colls: dict[str, set[str]] = {}
        self.onodes: dict[tuple[str, str], _Onode] = {}
        # shared-blob refcount table (ref: bluestore_shared_blob_t):
        # sb_id -> {au: refcount}; persisted under kv prefix "B"
        self.shared: dict[int, dict[int, int]] = {}
        self._next_sb = 1
        self._shared_dirty: set[int] = set()
        # round 20: shared-blob plane observability (register=False —
        # the OSD daemon ships the family through its mgr report
        # session; prometheus renders ceph_bluestore_sharedblob_*)
        self.perf = (
            PerfCountersBuilder("bluestore_sharedblob")
            .add_u64_counter("clones",
                             "O(metadata) shared-blob clones executed")
            .add_u64_counter("cow_released",
                             "shared-AU claims released (refcount "
                             "decrements from COW/punch/remove)")
            .add_u64_counter("aus_freed",
                             "shared AUs freed at refcount 0")
            .add_u64("records", "live shared-blob records (gauge)")
            .create_perf_counters(register=False))
        self._dseq = 0
        # au -> bytes queued for deferred write within the CURRENT
        # transaction (overlay for _read_extent; cleared at commit end)
        self._pending_au: dict[int, bytes] = {}
        # crash-injection hook for the qa tier (the messenger's
        # inject-socket-failures discipline, store-side): raise at the
        # named commit boundary so tests can exercise replay/rollback
        self._fail_point: str | None = None
        self._load()

    def _reset_from_kv(self) -> None:
        self.alloc = BitmapAllocator(self.size // self.AU)
        self.colls = {}
        self.onodes = {}
        self.shared = {}
        self._next_sb = 1
        self._shared_dirty = set()
        self._load()

    # -- mount/load --------------------------------------------------------
    def _load(self) -> None:
        for cid, _ in self.db.get_iterator("L"):
            self.colls[cid] = set()
        for key, rec in self.db.get_iterator("B"):
            self.shared[int(key)] = _dec_shared(rec)
        if self.shared:
            self._next_sb = max(self.shared) + 1
        # a shared AU appears in MULTIPLE onodes' extent maps: claim it
        # once (the allocator's strict double-allocation check still
        # guards unshared extents and shared-vs-unshared collisions)
        shared_claimed: set[int] = set()
        for key, rec in self.db.get_iterator("O"):
            cid, _, oid = key.partition("\x00")
            o = _dec_onode(rec)
            self.onodes[(cid, oid)] = o
            self.colls.setdefault(cid, set()).add(oid)
            for x in o.extents:
                if not x[4]:
                    self.alloc.mark_used([(x[1], x[2])])
                    continue
                for a in range(x[1], x[1] + x[2]):
                    if a not in shared_claimed:
                        self.alloc.mark_used([(a, 1)])
                        shared_claimed.add(a)
        # deferred replay (crash between kv commit and block write):
        # whole-AU rewrites are idempotent, so replay-then-delete is
        # safe regardless of whether the block write had landed
        replayed = KVTransaction()
        n = 0
        for key, rec in sorted(self.db.get_iterator("D")):
            d = Decoder(rec)
            au = d.u64()
            data = d.blob()
            self._f.seek(au * self.AU)
            self._f.write(data)
            replayed.rmkey("D", key)
            n += 1
            self._dseq = max(self._dseq, int(key) + 1)
        if n:
            self._f.flush()
            os.fsync(self._f.fileno())
            self.db.submit_transaction(replayed)

    # -- block I/O helpers -------------------------------------------------
    def _read_extent(self, x) -> bytes:
        loff, au, n_aus, crc, _sb = x
        self._f.seek(au * self.AU)
        raw = self._f.read(n_aus * self.AU)
        if self._pending_au:
            # deferred bytes queued in THIS transaction are not on the
            # block file yet but MUST be visible to later ops of the
            # same transaction (a second small overwrite, a clone, a
            # COW of the same range) — splice the overlay in
            buf = None
            for i in range(n_aus):
                chunk = self._pending_au.get(au + i)
                if chunk is not None:
                    if buf is None:
                        buf = bytearray(raw)
                    buf[i * self.AU:(i + 1) * self.AU] = chunk
            if buf is not None:
                return bytes(buf)
        return raw

    def _read_range(self, o: _Onode, start: int, end: int) -> bytes:
        """Logical bytes [start, end) — gaps as zeros, crc verified."""
        out = bytearray(end - start)
        for x in o.extents:
            loff, au, n_aus, crc, _sb = x
            xlen = n_aus * self.AU
            if loff >= end or loff + xlen <= start:
                continue
            raw = self._read_extent(x)
            if zlib.crc32(raw) != crc:
                raise ChecksumError(
                    f"extent crc mismatch at logical {loff}")
            s = max(start, loff)
            e = min(end, loff + xlen)
            out[s - start:e - start] = raw[s - loff:e - loff]
        return bytes(out)

    def _object_bytes(self, o: _Onode) -> bytes:
        return self._read_range(o, 0, o.size) if o.size else b""

    # -- transaction apply -------------------------------------------------
    def queue_transaction(self, t: Transaction) -> None:
        """All-or-nothing: COW block writes land and flush first, then
        ONE kv batch commits every metadata change + deferred record;
        only after the commit are replaced AUs freed and deferred
        bytes applied in place."""
        import time as _time
        self._validate(t.ops)
        kvt = KVTransaction()
        to_free: list[tuple[int, int]] = []
        deferred: list[tuple[int, bytes]] = []
        dirty: set[tuple[str, str]] = set()
        wrote_block = False
        self.last_txn_phases = {}            # a raised txn reports none
        _t0 = _time.monotonic()
        try:
            for op in t.ops:
                wb = self._apply_op(op, kvt, to_free, deferred, dirty)
                wrote_block = wrote_block or wb
            if self._fail_point == "before_kv_commit":  # crash inject
                raise StoreError("fail point: before_kv_commit")
        except Exception:
            # all-or-nothing: nothing committed to kv, so rebuild the
            # in-memory caches (onodes, collections, allocator) from
            # the committed state — a half-applied op list must not
            # leave RAM diverged from disk
            self._pending_au.clear()
            self._reset_from_kv()
            raise
        for key in dirty:
            o = self.onodes.get(key)
            okey = f"{key[0]}\x00{key[1]}"
            if o is None:
                kvt.rmkey("O", okey)
            else:
                kvt.set("O", okey, _enc_onode(o))
        for sb in self._shared_dirty:
            refs = self.shared.get(sb)
            if refs:
                kvt.set("B", f"{sb:016d}", _enc_shared(refs))
            else:
                # every AU hit refcount 0: the record dies with them
                self.shared.pop(sb, None)
                kvt.rmkey("B", f"{sb:016d}")
        if self._shared_dirty:
            self.perf.set("records", len(self.shared))
        self._shared_dirty = set()
        for au, data in deferred:
            e = Encoder()
            e.u64(au).blob(data)
            kvt.set("D", f"{self._dseq:016d}", e.tobytes())
            self._dseq += 1
        if wrote_block:
            self._f.flush()
            os.fsync(self._f.fileno())       # data durable BEFORE the
        _t1 = _time.monotonic()              # metadata points at it
        try:
            self.db.submit_transaction(kvt)
        except Exception:
            # commit failed: RAM reflects an uncommitted transaction —
            # rebuild from the kv or every later read serves phantoms
            self._pending_au.clear()
            self._reset_from_kv()
            raise
        if self._fail_point == "after_kv_commit":      # crash injection
            # the kv batch committed, so the store is durable — but the
            # deferred block writes and alloc.release below never ran.
            # Same discipline as the other failure paths: rebuild RAM
            # from the committed kv (which replays the D records) so a
            # REUSED instance isn't left with a stale overlay or an
            # allocator that still holds the replaced AUs.
            self._pending_au.clear()
            self._reset_from_kv()
            raise StoreError("fail point: after_kv_commit")
        _t2 = _time.monotonic()
        # phase walls for the tracing layer's objectstore sub-span
        # split (ref: BlueStore's kv_commit vs deferred/aio latency
        # counters): block COW+fsync, then the kv batch, then deferred
        # in-place writes (updated again below once they ran)
        self.last_txn_phases = {"block_write": _t1 - _t0,
                                "kv_commit": _t2 - _t1}
        try:
            self.alloc.release(to_free)
            if deferred:
                drop = KVTransaction()
                for i, (au, data) in enumerate(deferred):
                    self._f.seek(au * self.AU)
                    self._f.write(data)
                    drop.rmkey(
                        "D", f"{self._dseq - len(deferred) + i:016d}")
                self._f.flush()
                os.fsync(self._f.fileno())
                self.db.submit_transaction(drop)
                self.last_txn_phases["deferred_write"] = \
                    _time.monotonic() - _t2
        except Exception:
            # the kv committed, so the store is durable — but RAM and
            # the overlay must not keep stale state (a leaked pending
            # AU would splice old bytes into whatever reuses that AU);
            # reload replays the committed D records
            self._pending_au.clear()
            self._reset_from_kv()
            raise
        finally:
            self._pending_au.clear()

    def _validate(self, ops) -> None:
        """Precondition dry-run (the MemStore discipline): benign
        failures — missing objects or collections — must raise BEFORE
        any mutation, so the common error case never pays the
        full-store reload the mid-apply rollback path costs. A lazy
        DELTA overlay keeps this O(ops), not O(store): committed state
        is consulted read-only, only the transaction's own changes are
        tracked."""
        live: dict[str, bool] = {}        # coll existence overrides
        wiped: set[str] = set()           # colls emptied this txn
        obj: dict[tuple[str, str], bool] = {}   # object overrides

        def coll_ok(cid):
            return live.get(cid, cid in self.colls)

        def obj_ok(cid, oid):
            ov = obj.get((cid, oid))
            if ov is not None:
                return ov
            if cid in wiped:
                return False
            return oid in self.colls.get(cid, ())

        for op in ops:
            code = op[0]
            if code == OP_MKCOLL:
                live[op[1]] = True
                continue
            if code == OP_RMCOLL:
                live[op[1]] = False
                wiped.add(op[1])
                for k in [k for k, v in obj.items() if k[0] == op[1]]:
                    del obj[k]
                continue
            cid, oid = op[1], op[2]
            if not coll_ok(cid):
                raise StoreError(f"no collection {cid}")
            if code in (OP_TOUCH, OP_WRITE, OP_ZERO, OP_TRUNCATE,
                        OP_SETATTRS, OP_OMAP_SETKEYS):
                obj[(cid, oid)] = True
            elif code == OP_CLONE:
                if not obj_ok(cid, oid):
                    raise StoreError(f"no object {cid}/{oid}")
                obj[(cid, op[3])] = True
            elif code == OP_REMOVE:
                obj[(cid, oid)] = False
            elif not obj_ok(cid, oid):    # RMATTR / OMAP_RM* / CLEAR
                raise StoreError(f"no object {cid}/{oid}")

    def _onode(self, cid: str, oid: str, create: bool) -> _Onode:
        if cid not in self.colls:
            raise StoreError(f"no collection {cid}")
        o = self.onodes.get((cid, oid))
        if o is None:
            if not create:
                raise StoreError(f"no object {cid}/{oid}")
            o = _Onode()
            self.onodes[(cid, oid)] = o
            self.colls[cid].add(oid)
        return o

    # -- shared-blob refcounts ---------------------------------------------
    def _release_aus(self, au: int, n_aus: int, sb: int,
                     to_free: list) -> None:
        """Drop one extent's claim on [au, au+n_aus). Unshared AUs go
        straight to ``to_free`` (released after the kv commit); shared
        AUs only decrement their refcount and free at 0 — an AU still
        referenced by a sibling clone never reaches the allocator."""
        if not sb:
            if n_aus:
                to_free.append((au, n_aus))
            return
        refs = self.shared.setdefault(sb, {})
        self.perf.inc("cow_released", n_aus)
        for a in range(au, au + n_aus):
            r = refs.get(a, 1) - 1
            if r > 0:
                refs[a] = r
            else:
                refs.pop(a, None)
                to_free.append((a, 1))
                self.perf.inc("aus_freed")
        self._shared_dirty.add(sb)

    def _release_extent(self, x, to_free: list) -> None:
        self._release_aus(x[1], x[2], x[4], to_free)

    def _rewrite_range(self, o: _Onode, off: int, data: bytes,
                       to_free: list) -> None:
        """COW the AU-aligned range covering [off, off+len(data))."""
        a0 = off // self.AU * self.AU
        a1 = -(-(off + len(data)) // self.AU) * self.AU
        if off == a0 and off + len(data) == a1:
            # full-cover rewrite: no read of the old bytes — which
            # also means a corrupt extent CAN be repaired by
            # overwriting it whole (and no redundant crc work)
            buf = bytearray(data)
        else:
            buf = bytearray(self._read_range(o, a0, a1))
            buf[off - a0:off - a0 + len(data)] = data
        new = self.alloc.allocate((a1 - a0) // self.AU)
        pos = 0
        new_extents = []
        for au, n_aus in new:
            chunk = bytes(buf[pos:pos + n_aus * self.AU])
            self._f.seek(au * self.AU)
            self._f.write(chunk)
            new_extents.append([a0 + pos, au, n_aus, zlib.crc32(chunk),
                                0])
            pos += n_aus * self.AU
        self._replace_extents(o, a0, a1, new_extents, to_free)

    def _replace_extents(self, o: _Onode, a0: int, a1: int,
                         new_extents: list, to_free: list) -> None:
        """Swap the extent-map entries covering AU-aligned [a0, a1).
        A shared extent's punched AUs go through the refcount release
        (this is the COW seam: the new extents are fresh and unshared,
        the old shared AUs live on under their sibling references);
        split survivors keep their sb_id — per-AU refcounts make a
        partial punch naturally correct."""
        kept = []
        for x in o.extents:
            loff, au, n_aus, crc, sb = x
            xlen = n_aus * self.AU
            if loff >= a1 or loff + xlen <= a0:
                kept.append(x)
                continue
            partial = loff < a0 or loff + xlen > a1
            if partial:
                # a split re-stamps sub-extent crcs from the old
                # bytes: VERIFY them first or latent corruption would
                # be laundered into a fresh valid checksum (a fully
                # covered extent is dropped unread, which is also the
                # repair path for corrupt data)
                raw = self._read_extent(x)
                if zlib.crc32(raw) != crc:
                    raise ChecksumError(
                        f"extent crc mismatch at logical {loff} "
                        f"(partial overwrite of a corrupt extent)")
            # extents are AU-aligned and the range is AU-aligned, so
            # partial overlaps split at AU boundaries
            if loff < a0:
                pre = (a0 - loff) // self.AU
                kept.append([loff, au, pre,
                             zlib.crc32(raw[:pre * self.AU]), sb])
                raw = raw[pre * self.AU:]
                au += pre
                n_aus -= pre
                loff = a0
            if loff + n_aus * self.AU > a1:
                post = (loff + n_aus * self.AU - a1) // self.AU
                keep_from = n_aus - post
                kept.append([a1, au + keep_from, post,
                             zlib.crc32(raw[keep_from * self.AU:]), sb])
                n_aus = keep_from
            self._release_aus(au, n_aus, sb, to_free)
        kept.extend(new_extents)
        kept.sort(key=lambda x: x[0])
        o.extents = kept

    def _apply_op(self, op, kvt: KVTransaction, to_free, deferred,
                  dirty) -> bool:
        code = op[0]
        if code == OP_MKCOLL:
            self.colls.setdefault(op[1], set())
            kvt.set("L", op[1], b"1")
            return False
        if code == OP_RMCOLL:
            for oid in list(self.colls.get(op[1], ())):
                self._remove(op[1], oid, to_free, dirty)
            self.colls.pop(op[1], None)
            kvt.rmkey("L", op[1])
            return False
        cid, oid = op[1], op[2]
        wrote = False
        if code == OP_TOUCH:
            self._onode(cid, oid, create=True)
        elif code == OP_ZERO:
            off, ln = op[3], op[4]
            o = self._onode(cid, oid, create=True)
            o.size = max(o.size, off + ln)
            if ln:
                # punch the AU-aligned interior as a HOLE (drop the
                # covered extents — sparse gaps read as zeros), never
                # allocate for it: a zero of a huge range must FREE
                # space, not ENOSPC materializing zero bytes
                h0 = -(-off // self.AU) * self.AU
                h1 = (off + ln) // self.AU * self.AU
                edges = []
                if h1 > h0:
                    self._replace_extents(o, h0, h1, [], to_free)
                    edges = [(off, h0), (h1, off + ln)]
                else:
                    edges = [(off, off + ln)]
                for e0, e1 in edges:
                    if e0 < e1 and any(
                            x[0] < e1 and x[0] + x[2] * self.AU > e0
                            for x in o.extents):
                        # edges are sub-AU and inside an allocated
                        # extent, so _do_write defers them — NO
                        # allocation, keeping zero ENOSPC-free even
                        # on a full store
                        wrote |= self._do_write(
                            o, e0, b"\x00" * (e1 - e0), to_free,
                            deferred)
        elif code == OP_WRITE:
            off, data = op[3], op[4]
            o = self._onode(cid, oid, create=True)
            o.size = max(o.size, off + len(data))
            if data:
                wrote = self._do_write(o, off, data, to_free, deferred)
        elif code == OP_TRUNCATE:
            o = self._onode(cid, oid, create=True)
            new_size = op[3]
            if new_size < o.size:
                lim = -(-new_size // self.AU) * self.AU
                kept = []
                for x in o.extents:
                    loff, au, n_aus, crc, sb = x
                    if loff >= lim:
                        self._release_aus(au, n_aus, sb, to_free)
                    elif loff + n_aus * self.AU > lim:
                        keep = (lim - loff) // self.AU
                        raw = self._read_extent(x)
                        if zlib.crc32(raw) != crc:   # no crc laundering
                            raise ChecksumError(
                                f"extent crc mismatch at {loff}")
                        kept.append([loff, au, keep,
                                     zlib.crc32(raw[:keep * self.AU]),
                                     sb])
                        self._release_aus(au + keep, n_aus - keep, sb,
                                          to_free)
                    else:
                        kept.append(x)
                o.extents = kept
                if new_size % self.AU:
                    # zero the dropped tail INSIDE the last kept AU so
                    # a later size extension reads zeros
                    self._rewrite_range(
                        o, new_size,
                        b"\x00" * (lim - new_size), to_free)
                    wrote = True
            o.size = new_size
        elif code == OP_REMOVE:
            self._remove(cid, oid, to_free, dirty)
            dirty.add((cid, oid))
            return False
        elif code == OP_SETATTRS:
            self._onode(cid, oid, create=True).attrs.update(op[3])
        elif code == OP_RMATTR:
            self._onode(cid, oid, create=False).attrs.pop(op[3], None)
        elif code == OP_CLONE:
            src = self._onode(cid, oid, create=False)
            dst = self._onode(cid, op[3], create=True)
            for x in dst.extents:
                self._release_extent(x, to_free)
            dst.extents = []
            dst.size = 0
            dst.attrs = dict(src.attrs)
            dst.omap = dict(src.omap)
            if self.config.get("bluestore_sharedblob_enabled", True):
                # O(metadata) clone: stamp each source extent with a
                # shared-blob id (first share promotes it, refs=1 per
                # AU for the source's own claim), copy the extent
                # ENTRY to the clone and bump the refs — zero data
                # bytes move. A later overwrite of either side COWs
                # fresh space and decrements (see _replace_extents).
                for x in src.extents:
                    loff, au, n_aus, crc, sb = x
                    if not sb:
                        sb = self._next_sb
                        self._next_sb += 1
                        x[4] = sb
                        self.shared[sb] = {
                            a: 1 for a in range(au, au + n_aus)}
                    refs = self.shared.setdefault(sb, {})
                    for a in range(au, au + n_aus):
                        refs[a] = refs.get(a, 0) + 1
                    self._shared_dirty.add(sb)
                    dst.extents.append([loff, au, n_aus, crc, sb])
                dirty.add((cid, oid))   # src extents got sb stamps
                self.perf.inc("clones")
            else:
                payload = self._object_bytes(src)
                if payload:
                    self._rewrite_range(dst, 0, payload, to_free)
                    wrote = True
            dst.size = src.size
            dirty.add((cid, op[3]))
        elif code == OP_OMAP_SETKEYS:
            self._onode(cid, oid, create=True).omap.update(op[3])
        elif code == OP_OMAP_RMKEYS:
            o = self._onode(cid, oid, create=False)
            for k in op[3]:
                o.omap.pop(k, None)
        elif code == OP_OMAP_CLEAR:
            self._onode(cid, oid, create=False).omap.clear()
        else:
            raise StoreError(f"unknown op {code}")
        dirty.add((cid, oid))
        return wrote

    def _covering_extent(self, o: _Onode, au0: int, au1: int):
        """The single extent covering logical AUs [au0, au1], or None."""
        for x in o.extents:
            loff, au, n_aus = x[0], x[1], x[2]
            first = loff // self.AU
            if first <= au0 and au1 < first + n_aus:
                return x
        return None

    def _do_write(self, o: _Onode, off: int, data: bytes,
                  to_free, deferred) -> bool:
        """Apply one write payload: deferred when it fits inside one
        already-allocated extent (no allocation, bytes ride the kv
        batch), COW otherwise. Returns True when the block file was
        written (caller fsyncs before the commit)."""
        au0 = off // self.AU
        au1 = (off + len(data) - 1) // self.AU
        covered = self._covering_extent(o, au0, au1)
        if covered is None or len(data) > self.DEFERRED_MAX or \
                covered[4]:
            # a SHARED extent can never be patched in place — its
            # bytes are visible through sibling clones' extent maps;
            # the rewrite COWs fresh space and decrements the refs
            self._rewrite_range(o, off, data, to_free)
            return True
        loff, au, n_aus, crc, _sb = covered
        a0 = au0 * self.AU
        a1 = (au1 + 1) * self.AU
        xlen = n_aus * self.AU
        if off == loff and len(data) == xlen:
            # whole-extent overwrite: no read of the old bytes (the
            # corrupt-extent repair path) and the crc is just the data
            raw = bytearray(data)
            covered[3] = zlib.crc32(data)
        else:
            # ONE read+verify of the covering extent serves both the
            # deferred buffer build and the crc re-stamp (reading via
            # _read_range and again in a patch helper doubled the I/O
            # and crc work on the hottest path). Partial overwrites of
            # a corrupt extent refuse: re-stamping would launder the
            # rot into a valid checksum.
            raw = bytearray(self._read_extent(covered))
            if zlib.crc32(bytes(raw)) != crc:
                raise ChecksumError(
                    f"extent crc mismatch at logical {loff} (partial "
                    f"overwrite of a corrupt extent)")
            raw[off - loff:off - loff + len(data)] = data
            covered[3] = zlib.crc32(bytes(raw))
        sub = au + (a0 - loff) // self.AU
        buf = bytes(raw[a0 - loff:a1 - loff])
        deferred.append((sub, buf))
        for i in range((a1 - a0) // self.AU):
            self._pending_au[sub + i] = buf[i * self.AU:
                                            (i + 1) * self.AU]
        return False

    def _remove(self, cid: str, oid: str, to_free, dirty) -> None:
        o = self.onodes.pop((cid, oid), None)
        if o is not None:
            for x in o.extents:
                self._release_extent(x, to_free)
        self.colls.get(cid, set()).discard(oid)
        dirty.add((cid, oid))

    # -- reads -------------------------------------------------------------
    def read(self, cid, oid, offset=0, length=None):
        o = self._onode(cid, oid, create=False)
        end = o.size if length is None else min(offset + length, o.size)
        if offset >= end:
            return b""
        return self._read_range(o, offset, end)

    def stat(self, cid, oid):
        return self._onode(cid, oid, create=False).size

    def exists(self, cid, oid):
        return (cid, oid) in self.onodes

    def getattrs(self, cid, oid):
        return dict(self._onode(cid, oid, create=False).attrs)

    def omap_get(self, cid, oid):
        return dict(self._onode(cid, oid, create=False).omap)

    def list_objects(self, cid):
        return sorted(self.colls.get(cid, ()))

    def list_collections(self):
        return sorted(self.colls)

    def collection_exists(self, cid):
        return cid in self.colls

    # -- admin -------------------------------------------------------------
    def statfs(self) -> dict:
        free = self.alloc.free_aus * self.AU
        return {"total": self.size, "free": free,
                "allocated": self.size - free, "au": self.AU,
                "shared_blobs": len(self.shared),
                "shared_aus": sum(len(r) for r in self.shared.values())}

    def fsck(self) -> list[str]:
        """BlueStore::_fsck's core: extent bounds, cross-object
        overlap, per-extent crc vs the block file, allocator/extent
        bitmap consistency (leaks + double-use) — plus the shared-blob
        cross-check: an AU referenced by more than one extent is legal
        ONLY under one matching sb_id, and every stored refcount must
        equal the actual number of extent-map references (a stored
        count too high is a space leak; too low is a future
        double-free)."""
        import numpy as np
        errors = []
        seen = np.zeros(self.size // self.AU, dtype=bool)
        au_sb: dict[int, int] = {}     # au -> sb_id of first reference
        census: dict[int, dict[int, int]] = {}   # sb -> {au: refs seen}
        for (cid, oid), o in self.onodes.items():
            for x in o.extents:
                loff, au, n_aus, crc, sb = x
                if au < 0 or (au + n_aus) * self.AU > self.size:
                    errors.append(f"{cid}/{oid}: extent out of bounds")
                    continue
                for a in range(au, au + n_aus):
                    if seen[a]:
                        if not sb or au_sb.get(a) != sb:
                            errors.append(f"{cid}/{oid}: extent "
                                          f"overlap at au {a}")
                    else:
                        seen[a] = True
                        au_sb[a] = sb
                    if sb:
                        blob = census.setdefault(sb, {})
                        blob[a] = blob.get(a, 0) + 1
                if zlib.crc32(self._read_extent(x)) != crc:
                    errors.append(
                        f"{cid}/{oid}: crc mismatch at logical {loff}")
        for sb in sorted(set(census) | set(self.shared)):
            want = census.get(sb, {})
            have = self.shared.get(sb, {})
            for a in sorted(set(want) | set(have)):
                if want.get(a, 0) != have.get(a, 0):
                    errors.append(
                        f"shared blob {sb} au {a}: stored refcount "
                        f"{have.get(a, 0)} != {want.get(a, 0)} "
                        f"extent-map references")
        leaked = int((self.alloc.used & ~seen).sum())
        if leaked:
            errors.append(f"allocator leak: {leaked} AUs marked used "
                          f"but referenced by no object")
        missing = int((seen & ~self.alloc.used).sum())
        if missing:
            errors.append(f"allocator corruption: {missing} referenced "
                          f"AUs marked free")
        return errors

    def mount(self) -> None:
        pass

    def umount(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        self.db.close()
