"""ECBackend-lite: striped EC object I/O with RMW, recovery and scrub.

The object-path logic of the reference's ECBackend/ECCommon
(ref: src/osd/ECBackend.cc ECBackend; src/osd/ECCommon.h ReadPipeline /
RMWPipeline; src/osd/ECTransaction.cc generate_transactions):

- objects are striped per StripeInfo (ECUtil::stripe_info_t);
- a partial write is widened to whole stripes: old stripes are read,
  new bytes merged, and the WHOLE touched range re-encoded in one
  batched device call (the reference's read-modify-write pipeline,
  sub-op'd per shard; here shard writes are array slices);
- recovery reconstructs lost shards via minimum_to_decode +
  decode_batch, batched over every stripe of an object in one device
  call (ref: ECBackend::handle_recovery_read_complete);
- scrub re-encodes data shards and byte-compares stored parity
  (the deep-scrub shard-consistency check,
  ref: src/osd/scrubber and ECBackend::scrub_supported).

Shard storage here is an in-memory dict per shard id, the ObjectStore
seam; the cluster layer plugs a real store in.

The port's counterpart of ``ceph_tpu/osd/ec_backend.py``, over any of the
port's plugins: on the card (``jax``/``jerasure``/``isa``, ``lrc``,
``shec`` on CUDA) every encode and decode is one ``gf.kernels.gf_encode``
launch per call (LRC: one per layer); the shards stay host numpy and
device results are read back through ``torch_plugin.to_host``. The
residency cache lives on the plugin's device (the CPU for a host plugin
such as ``clay`` or ``ref``). ``ec_backend_state`` and
``ec_backend_from_state`` carry a backend's shards across packages.
"""

from __future__ import annotations

import logging

import numpy as np

from ceph_tpu_torch.ec.interface import ErasureCodeInterface
from ceph_tpu_torch.ec.torch_plugin import DeviceShardCache, to_host
from ceph_tpu_torch.osd.ecutil import StripeInfo
from ceph_tpu_torch.utils.perf_counters import PerfCountersBuilder

log = logging.getLogger("ceph_tpu_torch.osd")


class ShardMissing(Exception):
    pass


class ECBackendLite:
    """Striped EC object store over one PG's shard set."""

    def __init__(self, ec: ErasureCodeInterface, chunk_size: int = 4096,
                 name: str = "ec_backend", config: dict | None = None):
        self.ec = ec
        self.k = ec.get_data_chunk_count()
        self.m = ec.get_coding_chunk_count()
        self.n = ec.get_chunk_count()
        self.sinfo = StripeInfo(self.k, chunk_size)
        # shard id -> oid -> (n_stripes, chunk_size) uint8
        self.shards: dict[int, dict[str, np.ndarray]] = {
            s: {} for s in range(self.n)}
        self.sizes: dict[str, int] = {}     # logical object sizes
        # hot-shard residency: gathered stripe ranges pin on the plugin's
        # device under osd_ec_resident_bytes, keyed by a per-oid
        # generation the mutators bump, so RMW and repeated reads skip
        # the re-gather
        self.resident = None
        self._gen: dict[str, int] = {}
        if config is not None and \
                int(config.get("osd_ec_resident_bytes", 0)) > 0:
            self.resident = DeviceShardCache(
                config, device=getattr(ec, "device", None) or "cpu")
        self.perf = (PerfCountersBuilder(name)
                     .add_u64_counter("write_bytes", "logical bytes written")
                     .add_u64_counter("rmw_stripes", "stripes read-modified")
                     .add_u64_counter("encode_stripes", "stripes encoded")
                     .add_u64_counter("recover_chunks",
                                      "chunks reconstructed")
                     .add_u64_counter("scrub_errors", "scrub mismatches")
                     .create_perf_counters())

    # -- internals ---------------------------------------------------------
    def _shard_array(self, shard: int, oid: str, n_stripes: int) -> np.ndarray:
        cur = self.shards[shard].get(oid)
        if cur is None:
            cur = np.zeros((0, self.sinfo.chunk_size), dtype=np.uint8)
        if cur.shape[0] < n_stripes:
            pad = np.zeros((n_stripes - cur.shape[0], self.sinfo.chunk_size),
                           dtype=np.uint8)
            cur = np.concatenate([cur, pad])
            self.shards[shard][oid] = cur
        return cur

    def _read_stripes(self, oid: str, first: int, count: int) -> np.ndarray:
        """(count, k, chunk) data-shard contents (zero-filled past EOF).
        Raises ShardMissing if a needed data shard is gone (caller must
        recover first; the reference's ReadPipeline would issue recovery
        reads instead)."""
        out = np.zeros((count, self.k, self.sinfo.chunk_size),
                       dtype=np.uint8)
        for c in range(self.k):
            store = self.shards[c].get(oid)
            if store is None:
                if self.sizes.get(oid, 0) > 0 and oid in self._any_shard():
                    raise ShardMissing(f"{oid} data shard {c} missing")
                continue
            hi = min(store.shape[0], first + count)
            if hi > first:
                out[:hi - first, c] = store[first:hi]
        return out

    def _resident_read(self, oid: str, first: int,
                       count: int) -> np.ndarray:
        """_read_stripes through the residency cache: a hit returns
        the pinned batch read back (no shard walk); a miss gathers and
        pins. Generation-keyed, so every mutator's bump makes stale
        entries unreachable. The array returned for a hit may view the
        cache's own memory: callers read it, never write it."""
        if self.resident is None:
            return self._read_stripes(oid, first, count)
        key = (oid, int(first), int(count), self._gen.get(oid, 0))
        hit = self.resident.get(key)
        if hit is not None:
            return to_host(hit)
        out = self._read_stripes(oid, first, count)
        self.resident.put(key, out)
        return out

    def _bump_gen(self, oid: str) -> None:
        self._gen[oid] = self._gen.get(oid, 0) + 1
        if self.resident is not None:
            self.resident.invalidate(oid)

    def _any_shard(self) -> set[str]:
        names: set[str] = set()
        for s in range(self.n):
            names.update(self.shards[s])
        return names

    # -- client ops --------------------------------------------------------
    def write(self, oid: str, offset: int, data: bytes) -> None:
        """Partial-write RMW: widen to stripes, read-merge-reencode-write.

        ref: ECCommon::RMWPipeline: reads the touched stripes' old
        contents, merges the new bytes, re-encodes, and writes every
        shard of the touched stripe range.
        """
        if not data:
            return
        first, count = self.sinfo.stripe_range(offset, len(data))
        W = self.sinfo.stripe_width
        stripes = self._resident_read(oid, first, count)     # old contents
        partial_head = offset % W != 0
        partial_tail = (offset + len(data)) % W != 0
        if partial_head or partial_tail:
            self.perf.inc("rmw_stripes", count)
        # merge new bytes into the logical view (own copy: a resident
        # hit's array is immutable by the cache contract)
        flat = np.array(stripes, dtype=np.uint8).reshape(
            count, self.k * self.sinfo.chunk_size)
        lo = offset - first * W
        flat.reshape(-1)[lo:lo + len(data)] = np.frombuffer(data, np.uint8)
        merged = flat.reshape(count, self.k, self.sinfo.chunk_size)
        parity = to_host(self.ec.encode_batch(merged))
        self.perf.inc("encode_stripes", count)
        self.perf.inc("write_bytes", len(data))
        n_stripes_total = max(self.sinfo.object_stripes(
            self.sizes.get(oid, 0)), first + count)
        for c in range(self.k):
            arr = self._shard_array(c, oid, n_stripes_total)
            arr[first:first + count] = merged[:, c]
        for p in range(self.m):
            arr = self._shard_array(self.k + p, oid, n_stripes_total)
            arr[first:first + count] = parity[:, p]
        self.sizes[oid] = max(self.sizes.get(oid, 0), offset + len(data))
        self._bump_gen(oid)

    def read(self, oid: str, offset: int, length: int) -> bytes:
        """ref: ECBackend::objects_read_sync (aligned read + trim)."""
        size = self.sizes.get(oid, 0)
        length = max(0, min(length, size - offset))
        if length <= 0:
            return b""
        first, count = self.sinfo.stripe_range(offset, length)
        stripes = self._resident_read(oid, first, count)
        flat = stripes.reshape(-1)
        lo = offset - first * self.sinfo.stripe_width
        return flat[lo:lo + length].tobytes()

    # -- failure / recovery ------------------------------------------------
    def lose_shard(self, shard: int, oid: str | None = None) -> None:
        """Failure injection: drop one object's shard (or the whole
        shard's contents)."""
        if oid is None:
            for o in list(self.shards[shard]):
                self._bump_gen(o)
            self.shards[shard].clear()
        else:
            self.shards[shard].pop(oid, None)
            self._bump_gen(oid)

    def missing_shards(self, oid: str) -> set[int]:
        return {s for s in range(self.n) if oid not in self.shards[s]}

    def recovery_plan(self, oid: str) -> tuple[set[int], set[int]]:
        """(lost, to_read): the minimal chunk set that reconstructs the
        lost shards, via the plugin's minimum_to_decode: LRC/SHEC/CLAY
        plugins return cheaper local sets than 'any k'.
        ref: ECBackend::get_min_avail_to_read_shards."""
        lost = self.missing_shards(oid)
        avail = set(range(self.n)) - lost
        to_read = set(self.ec.minimum_to_decode(lost, avail))
        return lost, to_read

    def recover(self, oid: str) -> set[int]:
        """Reconstruct every missing shard of oid in ONE batched decode
        over all its stripes (ref: ECBackend recovery: ReadPipeline
        reads minimum_to_decode chunks, decode_chunks rebuilds, pushed
        to the new shard)."""
        lost, to_read = self.recovery_plan(oid)
        if not lost:
            return set()
        n_stripes = self.sinfo.object_stripes(self.sizes.get(oid, 0))
        reads = sorted(to_read)
        chunks = np.stack([self._shard_array(s, oid, n_stripes)
                           for s in reads], axis=1)  # (S, len(reads), C)
        want = sorted(lost)
        out = to_host(self.ec.decode_batch(want, reads, chunks))
        for i, s in enumerate(want):
            self.shards[s][oid] = out[:, i].copy()
        self._bump_gen(oid)
        self.perf.inc("recover_chunks", len(want) * n_stripes)
        log.debug("recovered oid=%s lost=%s read=%s", oid, want, reads)
        return lost

    def recover_all(self) -> dict[str, set[int]]:
        """PG-wide recovery: every object with missing shards."""
        out = {}
        for oid in sorted(self._any_shard()):
            lost = self.recover(oid)
            if lost:
                out[oid] = lost
        return out

    # -- scrub -------------------------------------------------------------
    def _consistent_excluding(self, oid: str, n_stripes: int,
                              excluded: set[int]) -> bool:
        """True when the stored shards minus `excluded` form one
        consistent codeword: decode the data from k of the remainder,
        re-encode, and byte-compare every remaining stored shard. The
        decoded batch goes to the encode as it is (on the card, without
        a round trip through the host)."""
        remaining = [s for s in range(self.n)
                     if s not in excluded and oid in self.shards[s]]
        if len(remaining) < self.k:
            return False
        reads = sorted(self.ec.minimum_to_decode(set(range(self.k)),
                                                 set(remaining)))
        chunks = np.stack([self._shard_array(s, oid, n_stripes)
                           for s in reads], axis=1)
        decoded = self.ec.decode_batch(list(range(self.k)), reads, chunks)
        parity = to_host(self.ec.encode_batch(decoded))
        word = np.concatenate([to_host(decoded), parity], axis=1)
        for s in remaining:                                 # (S, n, C)
            if not np.array_equal(self._shard_array(s, oid, n_stripes),
                                  word[:, s]):
                return False
        return True

    def scrub(self, oid: str) -> list[int]:
        """Deep-scrub shard consistency (ref: ECBackend be_deep_scrub /
        scrub digest comparison on the primary).

        Returns [] when every stored shard belongs to one codeword;
        otherwise localizes a single corrupted shard by exclusion (the
        unique shard whose removal restores consistency), or returns all
        shard ids when corruption exceeds single-shard localization."""
        n_stripes = self.sinfo.object_stripes(self.sizes.get(oid, 0))
        if not n_stripes:
            return []
        missing = self.missing_shards(oid)
        if missing:
            return sorted(missing)
        if self._consistent_excluding(oid, n_stripes, set()):
            return []
        candidates = [s for s in range(self.n)
                      if self._consistent_excluding(oid, n_stripes, {s})]
        bad = candidates if len(candidates) == 1 else list(range(self.n))
        self.perf.inc("scrub_errors", len(bad))
        return bad


def ec_backend_state(be) -> dict:
    """A backend's stored state as plain data: chunk size, logical sizes
    and every shard's (n_stripes, chunk_size) uint8 arrays (copies). It
    reads only ``sinfo.chunk_size``, ``sizes`` and ``shards``, so it takes
    any package's ECBackendLite."""
    return {
        "chunk_size": int(be.sinfo.chunk_size),
        "sizes": {oid: int(n) for oid, n in be.sizes.items()},
        "shards": {int(s): {oid: np.array(a, dtype=np.uint8)
                            for oid, a in objs.items()}
                   for s, objs in be.shards.items()},
    }


def ec_backend_from_state(ec: ErasureCodeInterface, state: dict,
                          name: str = "ec_backend",
                          config: dict | None = None) -> ECBackendLite:
    """A backend over ``ec`` holding ``state`` (``ec_backend_state``
    output, arrays as numpy), so a history begun elsewhere continues
    here. Generations start at 0 and the residency cache empty."""
    be = ECBackendLite(ec, chunk_size=int(state["chunk_size"]), name=name,
                       config=config)
    if set(state["shards"]) - set(range(be.n)):
        raise ValueError(f"state has shards {sorted(state['shards'])}, "
                         f"the plugin {be.n}")
    for s, objs in state["shards"].items():
        be.shards[int(s)] = {oid: np.array(a, dtype=np.uint8)
                             for oid, a in objs.items()}
    be.sizes = {oid: int(n) for oid, n in state["sizes"].items()}
    return be
