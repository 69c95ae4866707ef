"""ECPG: erasure-coded placement groups in the live cluster.

ref: src/osd/ECBackend.{h,cc} + ECCommon.h — the EC strategy under a
PG: objects are striped (ECUtil::stripe_info_t); each acting POSITION
holds one shard; the primary widens partial writes to whole stripes
(RMWPipeline: sub-read old chunks, merge, re-encode), fans per-shard
chunk writes out as sub-ops (MOSDECSubOpWrite), reassembles reads from
k shards (ReadPipeline) and decodes around missing/stale shards via
``minimum_to_decode`` + ``decode_chunks``; recovery regenerates a lost
shard from any k live shards (ECBackend::handle_recovery_read_complete).

Device-first: every encode/decode over a stripe range is ONE batched
device call ((B, k, C) -> (B, m, C)) through the torch EC plugin (the
``gf_encode`` kernel on the card), routed through the OSD's
aggregators — the reference encodes stripe-by-stripe on CPU.

Shard object layout: the collection object holds this shard's
concatenated chunks; xattrs ``_v`` (object version) and ``_size``
(logical size) are written with every sub-op so any shard can answer
stat and staleness checks (ref: EC objects carry identical xattrs on
every shard).

The port's copy of ``ceph_tpu/osd/ec_pg.py``. Device results (a
residency hit, a direct encode or decode) come back to the host through
``torch_plugin.to_host``. A push whose rebuild fails on the card raises
(``_build_backfill_push``); only store, peer and decodability errors
skip the push for a later round, as in the reference.
"""

from __future__ import annotations

import asyncio

import numpy as np

from ceph_tpu_torch.ec import crc as ec_crc
from ceph_tpu_torch.ec.registry import factory as ec_factory
from ceph_tpu_torch.ec.torch_plugin import on_card, to_host
from ceph_tpu_torch.msg.messenger import ConnectionError_
from ceph_tpu_torch.os_.objectstore import StoreError, Transaction
from ceph_tpu_torch.osd.ecutil import StripeInfo
from ceph_tpu_torch.osd.messages import (
    MOSDECSubOpRead, MOSDECSubOpReadReply, MOSDECSubOpWrite,
    MOSDECSubOpWriteReply, MOSDOp, OSD_OP_DELETE, OSD_OP_GETXATTR,
    OSD_OP_OMAP_GET, OSD_OP_OMAP_RM, OSD_OP_OMAP_SET, OSD_OP_PGLS,
    OSD_OP_READ,
    OSD_OP_SETXATTR, OSD_OP_STAT, OSD_OP_TRUNCATE, OSD_OP_WRITE,
    OSD_OP_WRITEFULL, OSD_OP_ZERO,
)
from ceph_tpu_torch.osd.pg import PG, PGMETA
from ceph_tpu_torch.osd.pg_log import OP_DELETE, OP_MODIFY, LogEntry, eversion
from ceph_tpu_torch.osd.recovery import PERF as RECOVERY_PERF
from ceph_tpu_torch.osd.recovery import RecoveryDeviceError
from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("osd")


def _vblob(v: eversion) -> bytes:
    return v.epoch.to_bytes(4, "little") + v.v.to_bytes(8, "little")


def _vparse(b: bytes | None) -> eversion:
    if not b:
        return eversion()
    return eversion(int.from_bytes(b[:4], "little"),
                    int.from_bytes(b[4:12], "little"))


class UnreadableNow(Exception):
    """The object exists but fewer than k fresh shards are reachable
    RIGHT NOW (a revived shard still recovering plus a down shard, mid-
    peering churn, ...). Transient by construction: recovery or the next
    map refills the shard set, so the op must be retried, never failed
    with a terminal errno (ref: PrimaryLogPG::wait_for_unreadable_object
    — upstream parks the op on the recovery queue)."""


# A rebuild that fails on one of these (a store or a peer lookup, a
# shard set not decodable yet) is skipped and retried by a later round,
# as in the reference. Any other failure is the device path's, and on
# the card it is counted and raised (``_device_failure``): from a push
# build, the primary's self-recovery and the position fix alike.
_HOST_PATH_ERRORS = (StoreError, UnreadableNow, ConnectionError_,
                     ConnectionError, OSError, asyncio.TimeoutError)


class ECPG(PG):
    def __init__(self, osd, pool, pgid):
        super().__init__(osd, pool, pgid)
        # "jax" is the registry's name for the Reed-Solomon plugin
        # (ErasureCodeTorch here). The pool's profile is cluster state
        # (committed into the osdmap, equal to the reference's bytes),
        # so the device comes from the OSD that hosts this PG; a host
        # without one (a test harness) leaves it to the profile, whose
        # default is CUDA
        prof = dict(pool.extra.get("profile") or
                    {"k": 2, "m": 1, "plugin": "jax"})
        prof.setdefault("plugin", "jax")
        dev = getattr(osd, "device", None)
        if dev is not None:
            prof["device"] = str(dev)
        self.ec = ec_factory(prof)
        self.k = self.ec.get_data_chunk_count()
        self.m = self.ec.get_coding_chunk_count()
        self.sinfo = StripeInfo(
            self.k, int(prof.get("stripe_unit", 4096)))
        self._subop_waiters: dict[
            int, tuple[set[int], asyncio.Future, set[int]]] = {}
        self._subread_waiters: dict[int, asyncio.Future] = {}
        self._posfix_task: asyncio.Task | None = None

    def advance(self, up, acting, primary, epoch) -> None:
        old_acting = list(self.acting)
        super().advance(up, acting, primary, epoch)
        if self.osd.whoami in acting and acting != old_acting:
            # the interval moved our position: any shard whose stored
            # _pos stamp no longer matches must be re-derived — its
            # bytes stay READABLE everywhere (gather files by stamp),
            # but redundancy is degraded until this slot holds its own
            # position's bytes again. Cancel-and-respawn: a sweep
            # started in a PRIOR interval exits at its guard and must
            # not gate this interval's sweep.
            if self._posfix_task is not None:
                self._posfix_task.cancel()
            self._posfix_task = asyncio.ensure_future(
                self._fix_shard_positions())

    async def _fix_shard_positions(self) -> None:
        """Best-effort self-heal of position-mismatched shards after
        an acting shuffle (e.g. auto-out remap reverted on revive).
        Bounded retries: sources may only become decodable once the
        primary's own recovery lands."""
        interval = self.interval_start
        await asyncio.sleep(0.5)            # let peering settle
        myshard = self.my_shard()
        if myshard < 0:
            return
        # round-based, never gives up silently: a stale shard's
        # sources may only become decodable once the primary's
        # recovery pushes land on other holders — keep sweeping (with
        # a growing pause, loudly) until clean or the interval moves;
        # stale-position shards are degraded redundancy and must not
        # be abandoned while this interval lives
        _round = 0
        while True:
            if self.interval_start != interval or \
                    self.my_shard() != myshard:
                return                  # interval moved on: its own
                #                         advance re-triggers the fix
            try:
                oids = [o for o in
                        self.osd.store.list_objects(self.cid)
                        if o != PGMETA]
            except StoreError:
                return
            stale = [o for o in oids
                     if 0 <= self._stored_pos(o) != myshard]
            if not stale:
                return
            for oid in stale:
                if self.interval_start != interval:
                    return
                try:
                    await self._reconstruct_local(oid)
                    log.dout(1, f"pg {self.pgid} osd."
                                f"{self.osd.whoami} re-derived {oid} "
                                f"for position {myshard}")
                except Exception as e:
                    if self._device_failure(e):
                        raise self._card_failure(
                            "rebuild_device_failures",
                            f"position fix of {oid}", e) from e
                    # sources not decodable yet (e.g. the primary's
                    # push to another holder hasn't landed): the next
                    # round retries
                    log.dout(10, f"pg {self.pgid} posfix {oid} "
                                 f"round {_round}: {e!r}")
            _round += 1
            if _round % 60 == 0:
                log.error(f"pg {self.pgid} osd.{self.osd.whoami}: "
                          f"{len(stale)} position-stale shard(s) "
                          f"still unhealed after {_round} rounds "
                          f"(redundancy degraded)")
            await asyncio.sleep(min(0.5 + 0.1 * _round, 5.0))

    def _device_failure(self, e: Exception) -> bool:
        """True for a failure of the device path on the card: not a
        store, peer-lookup or decodability error, with the plugin on
        the card (``_HOST_PATH_ERRORS``)."""
        return on_card(self.ec) and not isinstance(e, _HOST_PATH_ERRORS)

    def _card_failure(self, counter: str, what: str,
                      e: Exception) -> RecoveryDeviceError:
        """Count and log a rebuild's card failure; the caller raises the
        returned error (the aggregators already retried on the card)."""
        RECOVERY_PERF.inc(counter)
        log.error(f"pg {self.pgid} osd.{self.osd.whoami}: {what} failed "
                  f"on the card: {e!r}")
        return RecoveryDeviceError(f"pg {self.pgid} {what}: {e}")

    # -- shard helpers -----------------------------------------------------
    def my_shard(self) -> int:
        try:
            return self.acting.index(self.osd.whoami)
        except ValueError:
            return -1

    def _local_shard_state(self, oid: str):
        """(exists, shard bytes, version, logical size)."""
        try:
            data = self.osd.store.read(self.cid, oid)
            attrs = self.osd.store.getattrs(self.cid, oid)
        except StoreError:
            return False, b"", eversion(), 0
        return True, data, _vparse(attrs.get("_v")), \
            int.from_bytes(attrs.get("_size", b"\0" * 8), "little")

    def _stored_pos(self, oid: str, default: int = -1) -> int:
        """The acting POSITION this store's shard bytes were encoded
        for (the write-time ``_pos`` stamp); ``default`` when the
        stamp is absent (legacy shard — assume it matches)."""
        try:
            attrs = self.osd.store.getattrs(self.cid, oid)
        except StoreError:
            return default
        pos = self._pos_of(attrs)
        return pos if pos >= 0 else default

    @staticmethod
    def _pos_attr(pos: int) -> bytes:
        return int(pos).to_bytes(4, "little", signed=True)

    @staticmethod
    def _pos_of(attrs: dict) -> int:
        """The ``_pos`` stamp in an attribute set; -1 without one."""
        blob = attrs.get("_pos")
        return int.from_bytes(blob, "little", signed=True) if blob \
            else -1

    def _stamps(self, oid: str) -> tuple | None:
        """The stored shard's ``_v`` and ``_pos`` stamps; None without
        one."""
        try:
            attrs = self.osd.store.getattrs(self.cid, oid)
        except StoreError:
            return None
        return attrs.get("_v"), attrs.get("_pos")

    def _obj_version(self, oid: str) -> eversion:
        return self._local_shard_state(oid)[2]

    def _obj_size(self, oid: str) -> int:
        exists, _, _, size = self._local_shard_state(oid)
        if not exists:
            raise StoreError(f"no object {oid}")
        return size

    # -- chunk gathering (the ReadPipeline) --------------------------------
    async def _subread(self, osd_id: int, oid: str, chunk_off: int,
                       chunk_len: int):
        tid = self.osd.next_tid()
        fut = asyncio.get_event_loop().create_future()
        self._subread_waiters[tid] = fut
        try:
            await self.osd.send_osd(osd_id, MOSDECSubOpRead(
                tid=tid, epoch=self.epoch, pgid=self.cid, oid=oid,
                chunk_off=chunk_off, chunk_len=chunk_len,
                from_osd=self.osd.whoami))
            return await asyncio.wait_for(fut, timeout=5.0)
        except (asyncio.TimeoutError, ConnectionError, OSError):
            return None
        finally:
            self._subread_waiters.pop(tid, None)

    async def _gather(self, oid: str, first: int, count: int,
                      version: eversion,
                      exclude_osds: frozenset = frozenset(),
                      repair: bool = False, resident: bool = True):
        """Collect this stripe range's chunks from live, fresh shards
        and reconstruct data chunks 0..k-1 -> (count, k, C) uint8.

        Shards whose object version differs (missed writes / stale
        after outage) are excluded; decode fills the gaps
        (ref: ECCommon::ReadPipeline get_remaining_shards).

        Chunks are filed under the POSITION the shard's bytes encode
        (the write-time ``_pos`` stamp), NOT the holder's current
        acting slot: an interval shuffle (e.g. an auto-out remap
        while a peer was down, reverted on revive) can leave a
        surviving OSD at a different slot than the one its stored
        bytes were encoded for — treating those bytes positionally-
        by-slot silently decodes garbage. Stamps are authoritative;
        a shard without one (legacy) is assumed to match its slot.

        ``exclude_osds``: OSDs never used as sources — a holder whose
        shard is being rebuilt (missing, stale, scrub-flagged) must
        not contribute to its own reconstruction.

        ``repair``: this gather feeds a shard REBUILD (recovery /
        backfill), not a client read — its decode pays a recovery-
        class QoS grant inside the read aggregator (client reads were
        already cost-tagged at admission).

        Hot-shard residency (round 19): when the OSD carries a
        DeviceShardCache, the gathered batch is pinned device-side
        keyed by (pg, oid, range, VERSION) — a repeat gather of the
        same generation skips the subreads, the decode and the H2D
        stage entirely. Never consulted or fed under ``exclude_osds``
        (a rebuild's source constraints are not the cache's), nor with
        ``resident`` False: deep scrub reads the stored shards, which
        the cache, keyed by version and not by bytes, cannot vouch for
        (a departure from ``ceph_tpu``, whose deep scrub reads
        through the cache)."""
        C = self.sinfo.chunk_size
        off, ln = first * C, count * C
        cache = getattr(self.osd, "ec_resident", None)
        ckey = None
        if cache is not None and resident and not exclude_osds:
            ckey = (str(self.cid), oid, int(first), int(count),
                    _vblob(version))
            hit = cache.get(ckey)
            if hit is not None:
                return to_host(hit)
        avail: dict[int, np.ndarray] = {}
        for slot, osd_id in enumerate(self.acting):
            # stop once decodable: all data positions in hand, or any
            # k positions once every data SLOT has been tried (MDS
            # property — same early-stop the pre-stamp code had)
            if set(range(self.k)) <= set(avail) or \
                    (slot >= self.k and len(avail) >= self.k):
                break
            if osd_id < 0 or osd_id in exclude_osds or \
                    not self.osd.osd_is_up(osd_id):
                continue
            if osd_id == self.osd.whoami:
                exists, data, ver, _size = self._local_shard_state(oid)
                if not exists or ver != version:
                    continue
                pos = self._stored_pos(oid, default=slot)
                chunk = np.zeros(ln, dtype=np.uint8)
                piece = data[off:off + ln]
                chunk[:len(piece)] = np.frombuffer(piece, dtype=np.uint8)
            else:
                reply = await self._subread(osd_id, oid, off, ln)
                if reply is None or not reply.exists:
                    continue
                if eversion(reply.version_epoch,
                            reply.version_v) != version:
                    continue
                pos = reply.shard_pos if reply.shard_pos >= 0 else slot
                chunk = np.zeros(ln, dtype=np.uint8)
                piece = reply.data[:ln]
                chunk[:len(piece)] = np.frombuffer(piece, dtype=np.uint8)
            if pos < 0 or pos >= self.k + self.m or pos in avail:
                continue
            avail[pos] = chunk.reshape(count, C)
        want = set(range(self.k))
        if want <= set(avail):
            out = np.stack([avail[c] for c in range(self.k)], axis=1)
            if ckey is not None:
                cache.put(ckey, out)
            return out
        # degraded: decode missing data chunks from what we have —
        # routed through the OSD's cross-op read aggregator, which
        # coalesces concurrent decodes from every PG on this OSD into
        # one padded batched launch per flush window (per-op path
        # behind osd_ec_read_agg=off)
        try:
            need = self.ec.minimum_to_decode(want, list(avail))
        except ValueError:
            need = None
        if need is None or not set(need) <= set(avail):
            raise UnreadableNow(
                f"{oid}: {len(avail)} fresh shards < k={self.k} "
                f"(have {sorted(avail)})")
        use = sorted(need)
        stacked = np.stack([avail[c] for c in use], axis=1)
        missing = sorted(want - set(avail))
        decoded = await self._agg_decode(missing, use, stacked,
                                         repair=repair)
        decoded = to_host(decoded)
        out = np.zeros((count, self.k, C), dtype=np.uint8)
        for c in range(self.k):
            if c in avail:
                out[:, c] = avail[c]
            else:
                out[:, c] = decoded[:, missing.index(c)]
        if ckey is not None:
            cache.put(ckey, out)
        return out

    # -- client op execution ----------------------------------------------
    async def _execute(self, m: MOSDOp) -> None:
        reqid = (m.src, getattr(m.conn, "peer_session", 0), m.tid)
        store = self.osd.store
        oid = m.oid
        ec_mutating = {OSD_OP_WRITE, OSD_OP_WRITEFULL,
                       OSD_OP_TRUNCATE, OSD_OP_ZERO, OSD_OP_DELETE,
                       OSD_OP_SETXATTR, OSD_OP_OMAP_SET,
                       OSD_OP_OMAP_RM}
        if self._backfill_blocked(
                oid, any(c in ec_mutating for c in m.op_codes)):
            # same degraded-object gate as the replicated path: ops on
            # objects above this primary's own watermark park; READS
            # inside the in-flight scan range stay served (they never
            # mutate, so they cannot race the watermark advance)
            await self._reply(m, -11, b"", {})
            return
        if oid in self.my_missing:
            # this primary's own shard of the object is still being
            # recovered: the op must neither see -ENOENT nor mutate
            # around the missing state (ref: PrimaryLogPG::
            # wait_for_unreadable_object); the objecter retries -EAGAIN
            await self._reply(m, -11, b"", {})
            return
        data_out = b""
        extra: dict = {}
        # edits: (offset, bytes) merges; specials for truncate/delete
        edits: list[tuple[int, bytes]] = []
        new_size: int | None = None
        attrs_delta: dict[str, bytes] = {}
        omap_delta: dict[str, bytes] = {}
        omap_rm: list[str] = []
        deleted = False
        write_full = None
        for code, off, length, name, data in m.unpack_ops():
            if code == OSD_OP_READ:
                try:
                    data_out = await self._read_range(oid, off, length)
                except UnreadableNow as e:
                    log.dout(5, f"pg {self.pgid} read parks: {e}")
                    await self._reply(m, -11, b"", {})  # retry later
                    return
                except StoreError:
                    await self._reply(m, -2, b"", {})
                    return
            elif code == OSD_OP_STAT:
                try:
                    extra["size"] = self._obj_size(oid)
                except StoreError:
                    await self._reply(m, -2, b"", {})
                    return
            elif code == OSD_OP_GETXATTR:
                try:
                    attrs = store.getattrs(self.cid, oid)
                except StoreError:
                    await self._reply(m, -2, b"", {})
                    return
                if name not in attrs:
                    await self._reply(m, -61, b"", {})
                    return
                data_out = attrs[name]
            elif code == OSD_OP_OMAP_GET:
                try:
                    omap = store.omap_get(self.cid, oid)
                except StoreError:
                    await self._reply(m, -2, b"", {})
                    return
                extra["omap"] = {k: v.hex() for k, v in omap.items()
                                 if not k.startswith("_")}
            elif code == OSD_OP_PGLS:
                extra["objects"] = [o for o in
                                    store.list_objects(self.cid)
                                    if o != PGMETA]
            elif code == OSD_OP_WRITE:
                # keep the frame view: the bytes land in np.frombuffer
                # at the RMW carve, no host staging copy in between
                edits.append((off, data))
            elif code == OSD_OP_WRITEFULL:
                write_full = data
            elif code == OSD_OP_ZERO:
                edits.append((off, b"\x00" * length))
            elif code == OSD_OP_TRUNCATE:
                new_size = off
            elif code == OSD_OP_DELETE:
                deleted = True
            elif code == OSD_OP_SETXATTR:
                attrs_delta[name] = bytes(data)
            elif code == OSD_OP_OMAP_SET:
                omap_delta[name] = bytes(data)
            elif code == OSD_OP_OMAP_RM:
                omap_rm.append(name)
            else:
                await self._reply(m, -95, b"", {})
                return
        mutated = bool(edits or attrs_delta or omap_delta or omap_rm or
                       deleted or write_full is not None or
                       new_size is not None)
        if not mutated:
            await self._reply(m, 0, data_out, extra)
            return
        if reqid in self._reqid_results:
            result, rextra = self._reqid_results[reqid]
            await self._reply(m, result, b"", rextra)
            return
        if (deleted or (omap_rm and not (edits or attrs_delta or
                                         omap_delta or
                                         write_full is not None or
                                         new_size is not None))) and \
                not self.osd.store.exists(self.cid, oid):
            # delete / bare omap-rm of a nonexistent object: -ENOENT,
            # never materialize a ghost object
            await self._reply(m, -2, b"", {})
            return
        result = await self._submit_ec_write(
            oid, edits, write_full, new_size, deleted, attrs_delta,
            omap_delta, omap_rm)
        extra["version"] = str(self.pg_log.head)
        if result != -11:
            # -11 (-EAGAIN) here means the min_size gate rejected the op
            # BEFORE anything was applied: recording it would make every
            # future resend of this reqid replay -EAGAIN forever, even
            # after the PG heals (r4 review finding). Re-execution is
            # safe — nothing was logged. A -5 (< k shards committed) IS
            # recorded: the entry is in the pg log, so a replay would
            # double-log; the dup honestly reports the partial failure.
            self._reqid_results[reqid] = (result, extra)
        if len(self._reqid_results) > 2000:
            for k in list(self._reqid_results)[:1000]:
                self._reqid_results.pop(k, None)
        await self._reply(m, result, data_out, extra)

    async def _read_range(self, oid: str, off: int,
                          length: int) -> bytes:
        size = self._obj_size(oid)          # raises if absent
        end = size if not length else min(off + length, size)
        if off >= end:
            return b""
        version = self._obj_version(oid)
        first, count = self.sinfo.stripe_range(off, end - off)
        stripes = await self._gather(oid, first, count, version)
        flat = stripes.reshape(-1).tobytes()
        W = self.sinfo.stripe_width
        lo = off - first * W
        return flat[lo:lo + (end - off)]

    # -- the RMW + sub-op write pipeline -----------------------------------
    async def _submit_ec_write(self, oid, edits, write_full, new_size,
                               deleted, attrs_delta, omap_delta,
                               omap_rm=()) -> int:
        live = self.live_acting()
        if len(live) < self.pool.min_size:
            return -11
        exists, _, old_version, old_size = self._local_shard_state(oid)
        old = None
        if not deleted and write_full is None:
            size = old_size if exists else 0
            hi = max([off + len(b) for off, b in edits], default=0)
            size = max(size, hi)
            if new_size is not None:
                size = new_size
            span_lo = min([off for off, _ in edits], default=0)
            span_hi = max(hi, size if new_size is not None else 0)
            if new_size is not None and exists:
                span_lo = 0 if not edits else min(span_lo, new_size)
                span_hi = max(span_hi, old_size)
            first, count = self.sinfo.stripe_range(
                span_lo, max(span_hi - span_lo, 1))
            # RMW: read the touched stripes' old contents BEFORE the
            # log append — a transiently unreadable object (fewer than
            # k fresh shards mid-recovery) must EAGAIN with no side
            # effects, not log an entry it then cannot apply
            if exists:
                try:
                    old = await self._gather(oid, first, count,
                                             old_version)
                except UnreadableNow as e:
                    log.dout(5, f"pg {self.pgid} rmw parks: {e}")
                    return -11
            else:
                old = np.zeros((count, self.k, self.sinfo.chunk_size),
                               dtype=np.uint8)
        self.last_user_version += 1
        version = eversion(self.epoch, self.last_user_version)
        entry = self.pg_log.add(
            version, oid, OP_DELETE if deleted else OP_MODIFY)
        self.pg_log.trim(keep=self._trim_keep())
        self._meta_txn_store()
        if deleted:
            return await self._fan_out_delete(oid, entry)
        if write_full is not None:
            logical = write_full
            size = len(logical)
            first, count = 0, self.sinfo.object_stripes(size) or 1
            buf = np.zeros(count * self.sinfo.stripe_width,
                           dtype=np.uint8)
            buf[:size] = np.frombuffer(logical, dtype=np.uint8)
            trunc_stripes = count
        else:
            buf = old.reshape(-1).copy()
            W = self.sinfo.stripe_width
            base = first * W
            for off, data in edits:
                lo = off - base
                buf[lo:lo + len(data)] = np.frombuffer(data,
                                                       dtype=np.uint8)
            if new_size is not None and new_size < old_size:
                # zero everything past the new size within the range
                lo = max(new_size - base, 0)
                buf[lo:] = 0
            trunc_stripes = self.sinfo.object_stripes(size)
        # encode the touched range in one device call — routed through
        # the OSD's cross-op aggregator, which coalesces concurrent
        # encodes from every PG on this OSD into one padded batched
        # launch per flush window (per-op path behind osd_ec_agg=off).
        # A whole-object write also wants per-shard _hcrc stamps, so
        # the flush runs the FUSED checksum+encode program and this op
        # gets its shards' row CRCs back alongside the parity.
        C = self.sinfo.chunk_size
        data_chunks = buf.reshape(count, self.k, C)
        whole = write_full is not None
        parity, row_crcs = await self._agg_encode(data_chunks,
                                                  with_crc=whole)
        attrs_delta = dict(attrs_delta)
        attrs_delta["_v"] = _vblob(version)
        attrs_delta["_size"] = size.to_bytes(8, "little")
        # fan the per-shard sub-ops out (ref: ECBackend sub writes)
        tid = self.osd.next_tid()
        entry_blob = entry.encode()
        per_osd: dict[int, MOSDECSubOpWrite] = {}
        for pos, osd_id in enumerate(self.acting):
            if osd_id < 0 or not self.osd.osd_is_up(osd_id):
                continue                   # hole: recovery rebuilds it
            if not self._should_send_repop(osd_id, oid):
                continue    # backfill target above its watermark: the
                #             scan rebuilds this shard; a sub-op now
                #             would materialize a partial object
            shard = data_chunks[:, pos, :] if pos < self.k else \
                parity[:, pos - self.k, :]
            shard_bytes = shard.tobytes()
            attrs = dict(attrs_delta)
            # position stamp: these bytes encode THIS acting position
            # — readers/rebuilders trust the stamp over the holder's
            # (shuffle-prone) slot
            attrs["_pos"] = self._pos_attr(pos)
            # per-shard write-time checksum (ref: ECBackend hinfo):
            # valid only when this write covers the WHOLE object (a
            # partial overwrite can't know the full-shard crc without
            # reading the rest, so it invalidates it — exactly the
            # reference's append-only hinfo discipline). Scrub repair
            # uses it to LOCATE a corrupt shard, which the code alone
            # cannot do at m=1. The value comes from the fused
            # checksum+encode pass when it ran (hcrc_attr combines the
            # device row CRCs; zlib fallback otherwise — pinned equal).
            attrs["_hcrc"] = ec_crc.hcrc_attr(
                shard_bytes,
                row_crcs=row_crcs[:, pos]
                if row_crcs is not None else None,
                chunk_size=C) if whole else b""
            per_osd[osd_id] = MOSDECSubOpWrite(
                tid=tid, epoch=self.epoch, pgid=self.cid, oid=oid,
                first_stripe=first, data=shard_bytes,
                truncate_stripes=trunc_stripes, size=size,
                remove=False, attrs=attrs, omap=omap_delta,
                omap_rm=list(omap_rm), log_entry=entry_blob)
        committed = await self._fan_out_subops(tid, per_osd)
        if committed < self.k:
            # fewer than k durable shards: the object would be
            # unreadable — fail the op loudly (ref: EC writes require
            # a decodable shard set)
            log.error(f"pg {self.pgid} ec write {oid}: only "
                      f"{committed} shards committed (< k={self.k})")
            return -5                                 # -EIO
        return 0

    async def _fan_out_delete(self, oid: str, entry: LogEntry) -> int:
        tid = self.osd.next_tid()
        per_osd = {}
        for osd_id in set(o for o in self.acting if o >= 0):
            if self.osd.osd_is_up(osd_id) and \
                    self._should_send_repop(osd_id, oid):
                per_osd[osd_id] = MOSDECSubOpWrite(
                    tid=tid, epoch=self.epoch, pgid=self.cid, oid=oid,
                    first_stripe=0, data=b"", truncate_stripes=0,
                    size=0, remove=True, attrs={}, omap={},
                    omap_rm=[], log_entry=entry.encode())
        await self._fan_out_subops(tid, per_osd)
        return 0

    async def _fan_out_subops(self, tid: int,
                              per_osd: dict[int, "MOSDECSubOpWrite"]
                              ) -> int:
        """Apply locally + send to peers + await acks. Returns how many
        shards actually committed (local apply counts as one)."""
        committed = 0
        pending: set[int] = set()
        waiter = asyncio.get_event_loop().create_future()
        remote = []
        # EC fan-out trace phase (ref: the repop_wait analog for
        # MOSDECSubOpWrite): sub-writes carry this span's context so
        # each shard's apply becomes its child
        op_span = getattr(self, "_active_span", None)
        sub_span = op_span.child(
            "ec_subop_wait",
            tags={"shards": sorted(per_osd)}) if op_span else None
        for osd_id, msg in per_osd.items():
            if osd_id == self.osd.whoami:
                store_span = op_span.child(
                    "objectstore_commit",
                    tags={"osd": self.osd.whoami}) if op_span else None
                if self._apply_sub_write(msg, local=True) == 0:
                    committed += 1
                if store_span is not None:
                    store_span.finish()
            else:
                pending.add(osd_id)
                msg.set_trace(sub_span)
                remote.append((osd_id, msg))
        failed: set[int] = set()
        self._subop_waiters[tid] = (pending, waiter, failed)
        sent = set()
        for osd_id, msg in remote:
            try:
                await self.osd.send_osd(osd_id, msg)
                sent.add(osd_id)
            except Exception:
                pending.discard(osd_id)
        if pending:
            try:
                await asyncio.wait_for(waiter, timeout=5.0)
            except asyncio.TimeoutError:
                log.dout(1, f"pg {self.pgid} ec sub-op {tid} timed out")
        if sub_span is not None:
            sub_span.finish()
        remaining, _, failed = self._subop_waiters.pop(
            tid, (set(), None, set()))
        # A shard that replied with a non-zero result did NOT durably
        # apply — it must not count toward the >=k durability check, or
        # the client could be acked with fewer than k live shards.
        committed += len((sent - remaining) - failed)
        return committed

    def _meta_txn_store(self) -> None:
        self.osd.store.queue_transaction(self._meta_txn(Transaction()))

    # -- sub-op handling (shard side) --------------------------------------
    def _apply_sub_write(self, m: MOSDECSubOpWrite,
                         local: bool = False) -> int:
        # hot-shard residency: this object's cached generations are
        # already unreachable (version-keyed), reclaim their bytes now
        cache = getattr(self.osd, "ec_resident", None)
        if cache is not None:
            cache.invalidate(str(self.cid), m.oid)
        t = Transaction()
        C = self.sinfo.chunk_size
        stamp = self._pos_of(m.attrs)
        held = self._stored_pos(m.oid)
        if not m.remove and 0 <= held != stamp:
            log.dout(1, f"pg {self.pgid} osd.{self.osd.whoami} sub-write "
                        f"of {m.oid} stamps position {stamp} over "
                        f"{held} (stripes {m.first_stripe}+"
                        f"{len(m.data) // C} of {m.truncate_stripes}, "
                        f"epoch {m.epoch})")
        if m.remove:
            t.remove(self.cid, m.oid)
        else:
            t.touch(self.cid, m.oid)
            if m.data:
                t.write(self.cid, m.oid, m.first_stripe * C, m.data)
            t.truncate(self.cid, m.oid, m.truncate_stripes * C)
            if m.attrs:
                t.setattrs(self.cid, m.oid, m.attrs)
            if m.omap:
                t.omap_setkeys(self.cid, m.oid, m.omap)
            if m.omap_rm:
                t.omap_rmkeys(self.cid, m.oid, list(m.omap_rm))
        if not local:
            entry = LogEntry.decode(m.log_entry)
            self.pg_log.append(entry)
            self.pg_log.trim(keep=self._trim_keep())
            self.last_user_version = max(self.last_user_version,
                                         entry.version.v)
        self._meta_txn(t)
        try:
            self.osd.store.queue_transaction(t)
        except StoreError as e:
            log.error(f"pg {self.pgid} ec sub-write failed: {e}")
            return -5                                   # -EIO
        return 0

    def handle_ec_sub_write(self, m: MOSDECSubOpWrite) -> None:
        span = self.osd.tracer.from_msg(
            "ec_sub_write", m, tags={"osd": self.osd.whoami,
                                     "oid": m.oid})
        store_span = span.child(
            "objectstore_commit",
            tags={"osd": self.osd.whoami}) if span else None
        result = self._apply_sub_write(m)
        if store_span is not None:
            store_span.finish()
        if span is not None:
            if result != 0:
                span.tag("result", result)
            span.finish()

        async def _ack():
            try:
                await m.conn.send_message(MOSDECSubOpWriteReply(
                    tid=m.tid, result=result, pgid=self.cid,
                    from_osd=self.osd.whoami))
            except Exception:
                pass
        asyncio.ensure_future(_ack())

    def handle_ec_sub_write_reply(self, m: MOSDECSubOpWriteReply) -> None:
        ent = self._subop_waiters.get(m.tid)
        if ent is None:
            return
        pending, fut, failed = ent
        if m.result != 0:
            failed.add(m.from_osd)
        pending.discard(m.from_osd)
        if not pending and not fut.done():
            fut.set_result(True)

    def handle_ec_sub_read(self, m: MOSDECSubOpRead) -> None:
        exists, data, ver, size = self._local_shard_state(m.oid)
        piece = data[m.chunk_off:m.chunk_off + m.chunk_len] if exists \
            else b""
        pos = self._stored_pos(m.oid) if exists else -1

        async def _reply():
            try:
                await m.conn.send_message(MOSDECSubOpReadReply(
                    tid=m.tid, pgid=self.cid, oid=m.oid, exists=exists,
                    data=piece, version_epoch=ver.epoch,
                    version_v=ver.v, size=size,
                    from_osd=self.osd.whoami, shard_pos=pos))
            except Exception:
                pass
        asyncio.ensure_future(_reply())

    def handle_ec_sub_read_reply(self, m: MOSDECSubOpReadReply) -> None:
        fut = self._subread_waiters.get(m.tid)
        if fut and not fut.done():
            fut.set_result(m)

    # -- recovery -----------------------------------------------------------
    async def _pull(self, from_osd: int, oid: str) -> None:
        """EC primary reconstructs its OWN shard from live peers
        instead of pulling a byte-identical copy."""
        entry = self.my_missing.get(oid)
        try:
            await self._reconstruct_local(
                oid, want=None if entry is None else entry.version)
            self.my_missing.pop(oid, None)
        except (StoreError, ConnectionError, OSError,
                asyncio.TimeoutError) as e:
            log.dout(1, f"pg {self.pgid} ec self-recover {oid}: {e}")
        except Exception as e:
            # anything else goes to peering, which retries (as in the
            # reference) unless the card failed
            if self._device_failure(e):
                raise self._card_failure("rebuild_device_failures",
                                         f"self-recover {oid}", e) from e
            raise

    async def _reconstruct_local(self, oid: str,
                                 want: eversion | None = None) -> None:
        ver, size = await self._authoritative_meta(oid, want=want)
        if size is None:
            # deleted everywhere / never existed — or the only copy at
            # a usable version is gone (a reverted divergent create):
            # drop local
            t = Transaction().remove(self.cid, oid)
            self.osd.store.queue_transaction(t)
            return
        await self._rebuild_shard(
            oid, self.my_shard(), ver, size, apply_local=True,
            exclude_osds=frozenset({self.osd.whoami}))

    async def _authoritative_meta(self, oid: str,
                                  want: eversion | None = None):
        """(version, size) of the newest live shard copy. With
        ``want`` set (a divergent-entry revert: the peering election
        queued a pull back to the authoritative log's version), copies
        NEWER than it are ignored — the local shard may carry an
        uncommitted divergent write whose version outranks every
        surviving peer's, and trusting it would faithfully restore the
        very write peering just rolled back."""
        best = (eversion(), None)
        for osd_id in set(o for o in self.acting if o >= 0):
            if not self.osd.osd_is_up(osd_id):
                continue
            if osd_id == self.osd.whoami:
                exists, _, ver, size = self._local_shard_state(oid)
            else:
                reply = await self._subread(osd_id, oid, 0, 0)
                if reply is None:
                    continue
                exists = reply.exists
                ver = eversion(reply.version_epoch, reply.version_v)
                size = reply.size
            if want is not None and ver > want:
                continue
            if exists and (best[1] is None or ver > best[0]):
                best = (ver, size)
        return best

    async def _agg_encode(self, data_chunks, with_crc: bool = False):
        """Every ECPG encode routes through the OSD's cross-op
        aggregator (osd/ec_aggregator.py); the per-op launch survives
        behind ``osd_ec_agg=off`` inside it. Bare harnesses without a
        daemon aggregator take a direct (still fused) call. Returns
        ``(parity np(B, m, C), row_crcs np(B, k+m) | None)``."""
        agg = getattr(self.osd, "ec_agg", None)
        if agg is not None:
            return await agg.encode(self.ec, data_chunks,
                                    with_crc=with_crc)
        if with_crc:
            parity, crcs = self.ec.encode_batch_with_crc(data_chunks)
            return to_host(parity), \
                (None if crcs is None else to_host(crcs))
        return to_host(self.ec.encode_batch(data_chunks)), None

    async def _agg_decode(self, want, avail, chunks,
                          repair: bool = False):
        """Every ECPG decode routes through the OSD's cross-op read
        aggregator (osd/ec_read_aggregator.py); the per-op launch
        survives behind ``osd_ec_read_agg=off`` inside it. Bare
        harnesses without a daemon aggregator take a direct call.
        ``repair`` decodes charge a recovery-class size-scaled QoS
        grant inside the aggregator — client degraded reads pass
        False (their cost tag was paid at admission). Returns
        np (B, len(want), C)."""
        agg = getattr(self.osd, "ec_read_agg", None)
        if agg is not None:
            return await agg.decode(
                self.ec, want, avail, chunks,
                charge_bytes=int(chunks.nbytes) if repair else 0)
        return to_host(self.ec.decode_batch(want, avail, chunks))

    async def _rebuild_shard(self, oid: str, shard: int, ver: eversion,
                             size: int, apply_local: bool = False,
                             exclude_osds: frozenset = frozenset()
                             ) -> tuple[bytes, bytes]:
        """Regenerate position ``shard``'s bytes from k live shards.
        Returns ``(shard_bytes, hcrc)`` — the write-time checksum
        comes from the fused checksum+encode pass when an encode ran
        (parity shards), and the hcrc_attr zlib fallback otherwise."""
        count = self.sinfo.object_stripes(size) or 1
        # what this shard holds now: an in-place rebuild lands only if
        # no sub-write or push replaced it while the sources were read
        held = self._stamps(oid) if apply_local else None
        # never source the holder being rebuilt: its stored bytes are
        # missing, stale, or corrupt — rebuilding FROM them would
        # faithfully reproduce the damage. (Exclusion is by OSD, not
        # position: after an interval shuffle another holder may
        # legitimately carry this position's bytes.)
        data_chunks = await self._gather(oid, 0, count, ver,
                                         exclude_osds=exclude_osds,
                                         repair=True)
        if shard < self.k:
            shard_bytes = data_chunks[:, shard, :].tobytes()
            hcrc = ec_crc.hcrc_attr(shard_bytes)
        else:
            parity, row_crcs = await self._agg_encode(data_chunks,
                                                      with_crc=True)
            shard_bytes = parity[:, shard - self.k, :].tobytes()
            hcrc = ec_crc.hcrc_attr(
                shard_bytes,
                row_crcs=row_crcs[:, shard]
                if row_crcs is not None else None,
                chunk_size=self.sinfo.chunk_size)
        if apply_local and self._stamps(oid) != held:
            log.dout(1, f"pg {self.pgid} osd.{self.osd.whoami} dropped its "
                        f"rebuild of {oid} for position {shard} at {ver}: "
                        f"the shard was written meanwhile")
        elif apply_local:
            t = Transaction()
            t.remove(self.cid, oid)
            t.write(self.cid, oid, 0, shard_bytes)
            attrs = {"_v": _vblob(ver),
                     "_size": size.to_bytes(8, "little"),
                     "_pos": self._pos_attr(shard),
                     "_hcrc": hcrc}
            t.setattrs(self.cid, oid, attrs)
            self.osd.store.queue_transaction(t)
            log.dout(1, f"pg {self.pgid} osd.{self.osd.whoami} rebuilt "
                        f"{oid} in place for position {shard} at {ver}")
        return shard_bytes, hcrc

    def apply_push(self, m) -> bool:
        """A push built before this OSD's current interval began is
        dropped unacked (ref: PG::can_discard_replica_op): its position
        was the holder's slot then, and landing after this interval's
        position fix it would leave another position's bytes in this
        slot. So is a push older than the shard it would replace when
        that shard was written in this interval: a client write landed
        while the push was built (an older interval's newer shard is a
        divergent write, and the push rolls it back). The primary's
        next round pushes again if this shard still needs it."""
        if m.epoch < self.interval_start:
            log.dout(1, f"pg {self.pgid} osd.{self.osd.whoami} dropped a "
                        f"push of {m.oid} from epoch {m.epoch}: this "
                        f"interval began at {self.interval_start}")
            return False
        held = self._stamps(m.oid)
        held_v = _vparse(held[0]) if held is not None else eversion()
        pushed = eversion(m.version_epoch, m.version_v)
        if m.exists and held_v > pushed and \
                held_v.epoch >= self.interval_start:
            log.dout(1, f"pg {self.pgid} osd.{self.osd.whoami} dropped a "
                        f"push of {m.oid} at {pushed}: it holds {held_v}, "
                        f"written in this interval")
            return False
        ok = super().apply_push(m)
        if ok and m.exists:
            log.dout(1, f"pg {self.pgid} osd.{self.osd.whoami} took a push "
                        f"of {m.oid} for position {self._pos_of(m.attrs)} "
                        f"at {m.version_epoch}'{m.version_v} from "
                        f"osd.{m.from_osd} (epoch {m.epoch}, slot "
                        f"{self.my_shard()})")
        return ok

    def make_push(self, oid: str, target: int | None = None):
        raise NotImplementedError("EC pushes are built asynchronously")

    async def _build_backfill_push(self, oid: str, target: int):
        """EC recovery/backfill push: the target POSITION's shard,
        regenerated from any k live fresh shards (ref: ECBackend
        handle_recovery_read_complete). exists=False when the object
        is gone everywhere (the target reaps its stale shard)."""
        from ceph_tpu_torch.osd.messages import MOSDPGPush
        try:
            pos = self.acting.index(target)
        except ValueError:
            return None
        try:
            ver, size = await self._authoritative_meta(oid)
            if size is None:
                return MOSDPGPush(
                    pgid=self.cid, epoch=self.epoch, oid=oid,
                    version_epoch=0, version_v=0, exists=False,
                    data=b"", attrs={}, omap={},
                    from_osd=self.osd.whoami)
            shard_bytes, hcrc = await self._rebuild_shard(
                oid, pos, ver, size,
                exclude_osds=frozenset({target}))
            omap = {}
            try:
                omap = dict(self.osd.store.omap_get(self.cid, oid))
            except StoreError:
                pass
            return MOSDPGPush(
                pgid=self.cid, epoch=self.epoch, oid=oid,
                version_epoch=ver.epoch, version_v=ver.v,
                exists=True, data=shard_bytes,
                attrs={"_v": _vblob(ver),
                       "_size": size.to_bytes(8, "little"),
                       "_pos": self._pos_attr(pos),
                       "_hcrc": hcrc},
                omap=omap, from_osd=self.osd.whoami)
        except Exception as e:
            if self._device_failure(e):
                raise self._card_failure(
                    "push_device_failures",
                    f"push {oid}->osd.{target}", e) from e
            log.dout(1, f"pg {self.pgid} ec push {oid}->osd.{target} "
                        f"build failed: {e}")
            return None

    async def _recover(self) -> None:
        """Regenerate each missing peer shard from k live shards
        (ref: ECBackend recovery reads + pushes). A round acts only for
        the interval whose peering started it (``_recovery_current``),
        and the PG is clean only once every acting holder stores its own
        slot's shard (``_stale_positions``): the position fixes of an
        acting shuffle are part of recovery, not left behind it."""
        interval = self.interval_start
        if not self._recovery_current(interval):
            return
        if any(self.peer_missing.values()):
            self.state = "recovering"
        sends: list = []
        unbuilt = False
        for o, missing in list(self.peer_missing.items()):
            if not self.osd.osd_is_up(o):
                continue
            if o not in self.acting:
                missing.clear()
                continue
            for oid in list(missing):
                push = await self._build_backfill_push(oid, o)
                if not self._recovery_current(interval):
                    return
                if push is not None:
                    sends.append((o, oid, push))
                else:
                    unbuilt = True
        # a shard only counts as recovered once ACKED — the gate is
        # shared with the replicated path (PG._send_gated_pushes)
        if await self._send_gated_pushes(sends):
            return
        loop = asyncio.get_event_loop()
        if unbuilt:
            # sources not decodable yet: retried, as an unacked push is
            loop.call_later(1.0, lambda: asyncio.ensure_future(
                self._recover()))
            return
        if not any(self.peer_missing.values()) and \
                self.state in ("active", "recovering"):
            stale = await self._stale_positions()
            if not self._recovery_current(interval):
                return
            if stale:
                newest = self.pg_log.newest_per_object()
                for o, oids in stale.items():
                    log.dout(1, f"pg {self.pgid} osd.{o} holds "
                                f"{len(oids)} shard(s) of another "
                                f"position; rebuilding them")
                    if o == self.osd.whoami:
                        for oid in oids:
                            await self._pull(o, oid)
                    else:
                        self.peer_missing.setdefault(o, {}).update(
                            {oid: newest.get(oid) for oid in oids})
                if self._recovery_current(interval):
                    loop.call_later(0.0, lambda: asyncio.ensure_future(
                        self._recover()))
                return
            if self._maybe_start_backfill():
                return          # clean is decided when backfill ends
            if len(self.live_acting()) >= self.pool.size:
                self._mark_clean()
            else:
                self.state = "active"

    async def _stale_positions(self) -> dict[int, list[str]]:
        """Acting holder -> the objects whose stored shard encodes
        another position: its ``_pos`` stamp is not the holder's slot
        (zero-length sub-reads of every peer; this OSD's own store)."""
        try:
            oids = [o for o in self.osd.store.list_objects(self.cid)
                    if o != PGMETA]
        except StoreError:
            return {}
        out: dict[int, list[str]] = {}
        for slot, osd_id in enumerate(list(self.acting)):
            if osd_id < 0 or not self.osd.osd_is_up(osd_id):
                continue
            if osd_id == self.osd.whoami:
                bad = [o for o in oids if 0 <= self._stored_pos(o) != slot]
            else:
                replies = await asyncio.gather(*[
                    self._subread(osd_id, o, 0, 0) for o in oids])
                bad = [o for o, r in zip(oids, replies)
                       if r is not None and r.exists and
                       0 <= r.shard_pos != slot]
            if bad:
                out[osd_id] = bad
        return out

    # -- stats --------------------------------------------------------------
    def stats(self) -> dict:
        base = super().stats()
        # logical bytes: shard bytes are size/k each
        try:
            objs = [o for o in self.osd.store.list_objects(self.cid)
                    if o != PGMETA]
            base["num_bytes"] = sum(
                self._obj_size(o) for o in objs
                if self.osd.store.exists(self.cid, o))
        except StoreError:
            pass
        return base
