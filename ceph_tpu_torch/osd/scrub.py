"""PG scrub: cross-shard consistency checking.

ref: src/osd/scrubber/* (PgScrubber/ScrubMachine) — the primary
collects a *scrub map* (per-object size/data-digest/omap-digest/
version) from itself and every live acting peer, then compares:

- replicated PGs: every field must match byte-for-byte across
  replicas (ref: be_compare_scrubmaps);
- EC PGs: shards legitimately differ in bytes, so versions and
  logical sizes must agree; DEEP scrub additionally regathers the data
  chunks and re-encodes to verify stored parity shards
  (ref: ECBackend scrub with hinfo digests).

Inconsistencies land in the PG's stats (scrub_errors) which flow to
the mon's pgmap -> HEALTH checks.

The port's copy of ``ceph_tpu/osd/scrub.py``. The sweep's digests and
deep scrub's parity digests are ``ec/crc.device_row_crcs`` jobs on the
PG plugin's device; a failed job falls back to host zlib only for a
plugin on the CPU, and on the card it is counted and raised. One
departure from the reference: an EC repair drops the repaired object
from the primary's residency cache, where the deep check's gather may
have pinned the corrupt shard's bytes (the reference keeps serving them
to client reads after the repair; ROADMAP Queue C).
"""

from __future__ import annotations

import asyncio
import json
import zlib

from ceph_tpu_torch.ec import crc as _crc
from ceph_tpu_torch.ec.torch_plugin import on_card, to_host
from ceph_tpu_torch.os_.objectstore import StoreError
from ceph_tpu_torch.osd.messages import MOSDRepScrub, MOSDRepScrubMap
from ceph_tpu_torch.osd.pg import PGMETA
from ceph_tpu_torch.utils.logging import get_logger
from ceph_tpu_torch.utils.perf_counters import PerfCountersBuilder

log = get_logger("osd")

# One-job device scrub accounting (round 19): deep-scrub's digest work
# is O(batches) device CRC launches over the whole chunk-map sweep, not
# O(objects) host zlib calls — these counters PIN that shape (see
# tests). Module-level and unregistered: a process-wide tally across
# every in-process daemon is exactly what the pin wants.
SCRUB_PERF = (
    PerfCountersBuilder("osd_scrub")
    .add_u64_counter("device_crc_jobs",
                     "batched device CRC launches (whole-sweep jobs)")
    .add_u64_counter("device_crc_rows",
                     "chunk rows digested on device")
    .add_u64_counter("host_crc_objects",
                     "objects digested host-side (non-EC / ragged / "
                     "device-fallback)")
    .add_u64_counter("device_crc_failures",
                     "device CRC jobs that failed on the card (raised, "
                     "never redone by host zlib)")
    .create_perf_counters(register=False))


def _scrub_entry(data: bytes, attrs: dict, omap: dict,
                 digest: int) -> dict:
    hcrc = attrs.get("_hcrc", b"")
    return {
        "size": len(data),
        "digest": digest,
        "omap_digest": zlib.crc32(json.dumps(
            sorted((k, v.hex()) for k, v in omap.items()
                   if not k.startswith("_"))).encode()),
        "version": attrs.get("_v", b"").hex(),
        "logical_size": int.from_bytes(
            attrs.get("_size", b"\0" * 8), "little"),
        # write-time shard checksum (EC hinfo analog; None when
        # invalidated by a partial overwrite) — lets deep scrub
        # LOCATE a corrupt shard, not just detect inconsistency
        "hcrc": int.from_bytes(hcrc, "little") if hcrc else None,
    }


def scrub_object(pg, oid: str) -> dict | None:
    """One object's scrub entry, or None when unreadable (ref: the
    per-object slice of PgScrubber::build_scrub_map_chunk). The
    single-object path digests host-side; the sweep
    (:func:`build_scrub_map`) batches its digests into one device CRC
    job — the two are pinned byte-equal."""
    store = pg.osd.store
    try:
        data = store.read(pg.cid, oid)
        attrs = store.getattrs(pg.cid, oid)
        omap = store.omap_get(pg.cid, oid)
    except StoreError:
        return None
    return _scrub_entry(data, attrs, omap, zlib.crc32(data))


def _plugin_device(pg):
    """Where the PG's plugin runs; a host-only plugin (``clay``) has no
    device, and its CRC jobs run on the CPU."""
    return getattr(pg.ec, "device", None) or "cpu"


def _device_digests(pg, loaded: list) -> dict[str, int]:
    """zlib-equal data digests for every device-eligible object of one
    sweep, in ONE batched device CRC job.

    Eligible: EC PG shard payloads, which are always whole chunk rows
    (``_apply_sub_write`` writes/truncates at stripe*C granularity), so
    the (rows, C) batch needs no padding correction. Everything else —
    replicated PGs, empty or ragged payloads — goes to per-object host
    zlib (same bytes out; the shape, not the value, is what changes).
    The job runs on the PG plugin's device. A failed job falls back to
    host zlib only for a plugin on the CPU; on the card it is counted
    (``device_crc_failures``) and raised."""
    sinfo = getattr(pg, "sinfo", None)
    if sinfo is None or not pg.pool.is_erasure():
        return {}
    C = int(sinfo.chunk_size)
    elig = [(oid, data) for oid, data, _a, _o in loaded
            if data and len(data) % C == 0]
    if not elig:
        return {}
    import numpy as np

    rows = np.concatenate([
        np.frombuffer(d, dtype=np.uint8).reshape(-1, C)
        for _oid, d in elig])
    try:
        rcs = _crc.device_row_crcs(rows, device=_plugin_device(pg))
    except Exception as e:
        if on_card(pg.ec):
            SCRUB_PERF.inc("device_crc_failures")
            raise
        log.dout(1, f"pg {pg.pgid} device scrub CRC failed, "
                    f"host fallback: {e}")
        return {}
    SCRUB_PERF.inc("device_crc_jobs")
    SCRUB_PERF.inc("device_crc_rows", int(rows.shape[0]))
    out: dict[str, int] = {}
    pos = 0
    for oid, d in elig:
        n = len(d) // C
        out[oid] = int(_crc.shard_crc32(rcs[pos:pos + n], C))
        pos += n
    return out


def build_scrub_map(pg) -> dict[str, bytes]:
    """This osd's per-object scrub entries for one PG
    (ref: PgScrubber::build_scrub_map_chunk).

    The sweep reads every object once, then digests ALL of them in one
    batched device CRC job (:func:`_device_digests`) instead of one
    host ``zlib.crc32`` per object — the round-19 one-job discipline."""
    out: dict[str, bytes] = {}
    try:
        objs = pg.osd.store.list_objects(pg.cid)
    except StoreError:
        return out
    store = pg.osd.store
    loaded: list[tuple] = []           # (oid, data, attrs, omap)
    for oid in objs:
        if oid == PGMETA:
            continue
        try:
            loaded.append((oid, store.read(pg.cid, oid),
                           store.getattrs(pg.cid, oid),
                           store.omap_get(pg.cid, oid)))
        except StoreError:
            continue
    digests = _device_digests(pg, loaded)
    for oid, data, attrs, omap in loaded:
        d = digests.get(oid)
        if d is None:
            d = zlib.crc32(data)
            SCRUB_PERF.inc("host_crc_objects")
        out[oid] = json.dumps(_scrub_entry(data, attrs, omap,
                                           d)).encode()
    return out


class Scrubber:
    """Primary-driven scrub round for one PG."""

    def __init__(self, pg):
        self.pg = pg
        self._waiters: dict[int, tuple[set[int], dict,
                                       asyncio.Future]] = {}

    async def scrub(self, deep: bool = False) -> dict:
        """Run one scrub; returns {errors: [...], objects: N}
        (ref: PgScrubber round trip)."""
        pg = self.pg
        if not pg.is_primary() or not pg.role_active():
            return {"errors": ["not primary+active"], "objects": 0}
        maps = await self._gather_maps()
        errors = self._compare(maps)
        if deep and pg.pool.is_erasure():
            errors += await self._deep_ec_check(maps)
        pg.scrub_errors = len(errors)
        pg.last_scrub = asyncio.get_event_loop().time()
        if errors:
            log.dout(1, f"pg {pg.pgid} scrub found "
                        f"{len(errors)} errors: {errors[:3]}")
        n = len(maps.get(pg.osd.whoami, {}))
        return {"errors": errors, "objects": n}

    def handle_map(self, m: MOSDRepScrubMap) -> None:
        ent = self._waiters.get(m.tid)
        if ent is None:
            return
        pending, got, fut = ent
        got[m.from_osd] = _parse(m.scrub_map)
        pending.discard(m.from_osd)
        if not pending and not fut.done():
            fut.set_result(True)

    def _compare(self, maps: dict[int, dict[str, dict]],
                 findings: list | None = None) -> list[str]:
        """ref: be_compare_scrubmaps — the primary is the authority;
        every peer entry must agree. When ``findings`` is passed, each
        inconsistency is also recorded structurally as
        (oid, osd, kind) so the repair path can act on it."""
        pg = self.pg
        errors: list[str] = []
        auth = maps.get(pg.osd.whoami, {})
        ec = pg.pool.is_erasure()

        def flag(oid, osd, kind):
            errors.append(f"{oid}: {kind} on osd.{osd}")
            if findings is not None:
                findings.append((oid, osd, kind))

        all_oids = set()
        for m in maps.values():
            all_oids |= set(m)
        for oid in sorted(all_oids):
            entries = {o: m[oid] for o, m in maps.items() if oid in m}
            missing = [o for o in maps if oid not in maps[o]]
            if missing:
                errors.append(f"{oid}: missing on osd {missing}")
                if findings is not None:
                    for o in missing:
                        findings.append((oid, o, "missing"))
                continue
            base = entries[pg.osd.whoami]
            for o, e in entries.items():
                if e["version"] != base["version"]:
                    flag(oid, o, "version mismatch")
                elif not ec and (e["digest"] != base["digest"] or
                                 e["size"] != base["size"]):
                    flag(oid, o, "digest mismatch")
                elif not ec and e["omap_digest"] != base["omap_digest"]:
                    flag(oid, o, "omap mismatch")
                elif ec and e["logical_size"] != base["logical_size"]:
                    flag(oid, o, "size mismatch")
        return errors

    # -- repair (ref: PrimaryLogPG's repair_object / the PG_REPAIR
    # scrub flavor; VERDICT missing #6) ---------------------------------
    def _majority_copy(self, maps, oid: str) -> int | None:
        """The authoritative holder for a replicated repair: the most
        common (digest, omap_digest, size) tuple wins; ties prefer the
        primary. The reference picks by object-info digest — with
        whole-object digests in every scrub entry, majority vote is
        the same discipline without per-object metadata."""
        pg = self.pg
        votes: dict[tuple, list[int]] = {}
        for o, m in maps.items():
            e = m.get(oid)
            if e is None:
                continue
            votes.setdefault(
                (e["digest"], e["omap_digest"], e["size"]),
                []).append(o)
        if not votes:
            return None
        best = max(votes.values(),
                   key=lambda osds: (len(osds),
                                     pg.osd.whoami in osds))
        return pg.osd.whoami if pg.osd.whoami in best else best[0]

    async def repair(self) -> dict:
        """`ceph pg repair`: scrub, then rewrite every inconsistent
        copy from the authoritative one — replicated replicas get a
        whole-object push of the majority copy; a bad EC shard is
        regenerated from the surviving shards through the existing
        decode path — and verify by re-scrubbing. Returns
        {repaired: N, errors_before: [...], errors_after: [...]}."""
        pg = self.pg
        if not pg.is_primary() or not pg.role_active():
            return {"repaired": 0,
                    "errors_before": ["not primary+active"],
                    "errors_after": []}
        ec = pg.pool.is_erasure()
        findings: list[tuple] = []
        maps = await self._gather_maps()
        before = self._compare(maps, findings)
        if ec:
            before += await self._deep_ec_check(maps, findings)
        repaired = 0
        for oid, osd, kind in findings:
            ok = False
            if ec:
                # rebuild the bad POSITION's shard from the good ones
                # (decode + re-encode — _backfill_push_acked builds
                # the shard push itself and fails cleanly on None)
                ok = await pg._backfill_push_acked(oid, osd)
                cache = getattr(pg.osd, "ec_resident", None)
                if ok and cache is not None:
                    # the deep check's gather may have pinned the bad
                    # shard's bytes under the object's unchanged
                    # version; drop them, or client reads (and the
                    # verify pass below) are served the corruption
                    cache.invalidate(str(pg.cid), oid)
            elif osd == pg.osd.whoami:
                # the PRIMARY holds the bad copy: pull the majority
                # copy over it, then it can re-author replicas
                src = self._majority_copy(maps, oid)
                if src is not None and src != pg.osd.whoami:
                    await pg._pull(src, oid)
                    ok = self._matches(maps, src, oid)
            else:
                src = self._majority_copy(maps, oid)
                if src == pg.osd.whoami:
                    ok = await pg._backfill_push_acked(oid, osd)
                elif src is not None:
                    # majority copy lives on a replica: refresh the
                    # primary first — and only re-author the bad copy
                    # once the pull VERIFIABLY landed the majority
                    # bytes (a swallowed pull timeout must not let the
                    # primary push its own corrupt copy over a good
                    # replica, canonicalizing the corruption)
                    await pg._pull(src, oid)
                    if self._matches(maps, src, oid):
                        ok = await pg._backfill_push_acked(oid, osd)
            if ok:
                repaired += 1
            else:
                log.dout(1, f"pg {pg.pgid} repair of {oid} on "
                            f"osd.{osd} ({kind}) failed")
        await asyncio.sleep(0)         # let late applies land
        maps = await self._gather_maps()
        after = self._compare(maps)
        if ec:
            after += await self._deep_ec_check(maps)
        pg.scrub_errors = len(after)
        log.dout(1, f"pg {pg.pgid} repair: {len(before)} errors, "
                    f"{repaired} repaired, {len(after)} remain")
        return {"repaired": repaired, "errors_before": before,
                "errors_after": after}

    def _matches(self, maps, src: int, oid: str) -> bool:
        """Does the primary's LOCAL copy now carry the digests the
        scrub map recorded for ``src``? The post-pull verification
        gate of repair() — checks THIS object only, not a whole-PG
        map rebuild per finding."""
        pg = self.pg
        want = maps.get(src, {}).get(oid)
        if want is None:
            return False
        mine = scrub_object(pg, oid)
        return mine is not None and \
            mine["digest"] == want["digest"] and \
            mine["omap_digest"] == want["omap_digest"] and \
            mine["size"] == want["size"]

    async def _gather_maps(self) -> dict[int, dict[str, dict]]:
        """One scrub-map collection round (the shared half of scrub()
        and repair())."""
        pg = self.pg
        maps: dict[int, dict[str, dict]] = {
            pg.osd.whoami: _parse(build_scrub_map(pg))}
        peers = [o for o in pg.live_acting() if o != pg.osd.whoami]
        if peers:
            tid = pg.osd.next_tid()
            fut = asyncio.get_event_loop().create_future()
            self._waiters[tid] = (set(peers), {}, fut)
            for o in peers:
                try:
                    await pg.osd.send_osd(o, MOSDRepScrub(
                        pgid=pg.cid, tid=tid, epoch=pg.epoch,
                        from_osd=pg.osd.whoami))
                except Exception:
                    self._waiters[tid][0].discard(o)
            if not self._waiters[tid][0] and not fut.done():
                fut.set_result(True)
            try:
                await asyncio.wait_for(fut, timeout=5.0)
            except asyncio.TimeoutError:
                pass
            _, got, _ = self._waiters.pop(tid)
            maps.update(got)
        return maps

    async def _deep_ec_check(self, maps,
                             findings: list | None = None) -> list[str]:
        """Deep scrub for EC: regenerate parity from the data shards
        and compare digests against what the parity shards stored. The
        data comes from the stored shards, never the residency cache
        (``_gather(resident=False)``): the cache is keyed by version,
        not bytes, and would hide a shard that rotted after a read (the
        reference reads through it).
        ``findings`` (like _compare's) collects structured
        (oid, osd, kind) tuples for the repair path — never re-parsed
        from the error strings."""
        import numpy as np
        pg = self.pg
        errors: list[str] = []
        auth = maps.get(pg.osd.whoami, {})
        gathered: list[tuple] = []     # (oid, entry, data (count,k,C))
        for oid, entry in auth.items():
            try:
                ver = pg._obj_version(oid)
                size = entry["logical_size"]
                count = pg.sinfo.object_stripes(size) or 1
                data = await pg._gather(oid, 0, count, ver,
                                        resident=False)
            except Exception as e:
                errors.append(f"{oid}: deep-scrub gather failed ({e})")
                continue
            gathered.append((oid, entry, np.asarray(data)))
        if not gathered:
            return errors
        # ONE batched re-encode over every object's stripes, then ONE
        # device CRC job over all regenerated parity rows — the whole
        # sweep's digest work is O(batches) launches, not O(objects)
        # host zlib calls (counter-pinned). The parity stays on the
        # plugin's device for the CRC job. Device failure degrades to
        # the per-object host path below, byte-identical — for a plugin
        # on the CPU only; on the card it is counted and raised.
        digests: dict[str, list[int]] | None = {}
        try:
            C = int(pg.sinfo.chunk_size)
            big = np.concatenate([g[2] for g in gathered])
            # pow2-pad the stripe axis: per-PG totals are arbitrary,
            # and padding keeps the launch shapes at O(log) (the
            # aggregators' discipline; zero stripes encode to zero
            # parity, sliced off below)
            B = int(big.shape[0])
            pb = 1 << (B - 1).bit_length() if B > 1 else 1
            if pb != B:
                big = np.concatenate([big, np.zeros(
                    (pb - B,) + big.shape[1:], dtype=np.uint8)])
            parity = pg.ec.encode_batch(big)[:B]
            rcs = _crc.device_row_crcs(
                parity.reshape(-1, C), device=_plugin_device(pg)).reshape(
                    parity.shape[0], pg.m)
            SCRUB_PERF.inc("device_crc_jobs")
            SCRUB_PERF.inc("device_crc_rows",
                           int(parity.shape[0]) * pg.m)
            pos = 0
            for oid, _entry, data in gathered:
                cnt = int(data.shape[0])
                digests[oid] = [int(x) for x in _crc.shard_crc32(
                    rcs[pos:pos + cnt].T, C)]
                pos += cnt
        except Exception as e:
            if on_card(pg.ec):
                SCRUB_PERF.inc("device_crc_failures")
                raise
            log.dout(1, f"pg {pg.pgid} batched deep-scrub CRC failed, "
                        f"host fallback: {e}")
            digests = None
        for oid, entry, data in gathered:
            if digests is not None:
                by_shard = digests[oid]
            else:
                parity = to_host(pg.ec.encode_batch(data))
                by_shard = [zlib.crc32(parity[:, j, :].tobytes())
                            for j in range(pg.m)]
                SCRUB_PERF.inc("host_crc_objects")
            size = entry["logical_size"]
            ver = pg._obj_version(oid)
            mismatched = []
            for pos in range(pg.k, pg.k + pg.m):
                osd_id = pg.acting[pos] if pos < len(pg.acting) else -1
                if osd_id < 0 or osd_id not in maps or \
                        oid not in maps[osd_id]:
                    continue
                want = by_shard[pos - pg.k]
                if maps[osd_id][oid]["digest"] != want:
                    errors.append(
                        f"{oid}: parity shard {pos} digest mismatch "
                        f"on osd.{osd_id}")
                    mismatched.append(osd_id)
            if mismatched and findings is not None:
                # A parity/data disagreement only says SOMETHING is
                # inconsistent — regenerated parity inherits a corrupt
                # DATA shard's damage, so blaming the parity holder
                # would 'repair' the good parity from the bad data and
                # canonicalize the corruption. Locate the culprit
                # first: write-time shard checksums (hinfo), then
                # leave-one-out code consistency (needs m >= 2).
                # Ambiguous -> NO auto-repair finding: the errors stay
                # flagged for the operator, never silently rewritten.
                culprit = self._ec_hcrc_culprit(maps, oid)
                if culprit is None:
                    culprit = await self._ec_find_culprit(oid, ver,
                                                          size)
                if culprit is not None:
                    errors.append(f"{oid}: shard {culprit} identified "
                                  f"corrupt on "
                                  f"osd.{pg.acting[culprit]}")
                    findings.append((oid, pg.acting[culprit],
                                     "shard corrupt"))
                else:
                    log.dout(1, f"pg {pg.pgid} {oid}: inconsistent "
                                f"but the corrupt shard cannot be "
                                f"located (no hinfo, m < 2); not "
                                f"auto-repairing")
        return errors

    def _ec_hcrc_culprit(self, maps, oid: str) -> int | None:
        """Locate a corrupt shard by its write-time checksum: a shard
        whose stored bytes no longer crc to its own _hcrc is damaged,
        whatever the rest of the code word says."""
        pg = self.pg
        bad = []
        for pos, osd_id in enumerate(pg.acting):
            e = maps.get(osd_id, {}).get(oid) if osd_id >= 0 else None
            if e is None or e.get("hcrc") is None:
                return None      # any unknown shard -> inconclusive
            if e["hcrc"] != e["digest"]:
                bad.append(pos)
        return bad[0] if len(bad) == 1 else None

    async def _ec_find_culprit(self, oid: str, ver,
                               size: int) -> int | None:
        """Leave-one-out identification of a single corrupt shard:
        for each candidate position, reconstruct the object from the
        OTHER shards and check every one of them is consistent with
        the reconstruction. With one corrupt shard, exactly the
        candidate set excluding it is fully consistent (ref: the role
        of ECBackend's hashinfo — absent per-shard digests, the code
        word's redundancy itself locates the error)."""
        import numpy as np
        pg = self.pg
        from ceph_tpu_torch.osd.pg_log import eversion as _ev
        C = pg.sinfo.chunk_size
        count = pg.sinfo.object_stripes(size) or 1
        ln = count * C
        shards: dict[int, "np.ndarray"] = {}
        for pos, osd_id in enumerate(pg.acting):
            if osd_id < 0 or not pg.osd.osd_is_up(osd_id):
                continue
            if osd_id == pg.osd.whoami:
                exists, data, v, _sz = pg._local_shard_state(oid)
                if not exists or v != ver:
                    continue
                raw = data
            else:
                reply = await pg._subread(osd_id, oid, 0, ln)
                if reply is None or not reply.exists or \
                        _ev(reply.version_epoch,
                            reply.version_v) != ver:
                    continue
                raw = reply.data
            buf = np.zeros(ln, dtype=np.uint8)
            piece = raw[:ln]
            buf[:len(piece)] = np.frombuffer(bytes(piece),
                                             dtype=np.uint8)
            shards[pos] = buf.reshape(count, C)
        if len(shards) <= pg.k:
            return None            # no redundancy left to vote with
        want = set(range(pg.k))
        culprits = []
        for p in shards:
            others = {q: a for q, a in shards.items() if q != p}
            try:
                need = pg.ec.minimum_to_decode(want, list(others))
            except ValueError:
                continue
            if not set(need) <= set(others):
                continue
            use = sorted(need)
            missing = sorted(want - set(others))
            data = np.zeros((count, pg.k, C), dtype=np.uint8)
            if missing:
                stacked = np.stack([others[q] for q in use], axis=1)
                decoded = to_host(pg.ec.decode_batch(
                    missing, use, stacked))
            for ci in range(pg.k):
                if ci in others:
                    data[:, ci] = others[ci]
                else:
                    data[:, ci] = decoded[:, missing.index(ci)]
            parity = to_host(pg.ec.encode_batch(data))
            consistent = True
            for q, stored in others.items():
                pred = data[:, q, :] if q < pg.k else \
                    parity[:, q - pg.k, :]
                if not np.array_equal(pred, stored):
                    consistent = False
                    break
            if consistent:
                culprits.append(p)
        return culprits[0] if len(culprits) == 1 else None


def _parse(raw: dict[str, bytes]) -> dict[str, dict]:
    return {oid: json.loads(blob) for oid, blob in raw.items()}
