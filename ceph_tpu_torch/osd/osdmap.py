"""OSDMap: epoch-versioned cluster map + batched PG->OSD placement.

ref: src/osd/OSDMap.{h,cc} (OSDMap, OSDMap::Incremental); the port of
``ceph_tpu/osd/osdmap.py``. The reference maps one PG per call
(pg_to_up_acting_osds); here the same pipeline — pps, CRUSH,
nonexistent-removal, upmap, up-filter, primary affinity, pg_temp — runs
over an entire seed array at once, with the CRUSH step on the card
(``crush.mapper.Mapper``) and the sparse overrides (upmap/pg_temp,
typically a few thousand entries) as host-side numpy scatters.

Two serving layers sit above the pipeline so lookups stop re-entering
the mapper:

- an epoch-keyed memo for small (scalar) lookups, keyed (pool, seed)
  and valid for exactly one epoch: any mutation bumps ``epoch`` and the
  next lookup drops the memo wholesale;
- an attached :class:`~ceph_tpu_torch.osd.osdmap_mapping.OSDMapMapping`
  table (``attach_mapping``) serving every lookup at its epoch, bulk and
  scalar, kept across epochs by delta remap.

``pg_to_crush_osds`` (pure CRUSH output) and ``_pipeline_from_crush``
(everything after CRUSH) are split because the two halves invalidate
differently: up/down flips, primary affinity and the override dicts
never change CRUSH output, so ``calc_pg_upmaps`` replays only the numpy
half over cached raw rows.

Incrementals (``apply_incremental``) carry every field the reference's
codec carries, the host-cluster state placement never reads included
(addresses, up_thru, blocklist, flags, client QoS profiles). With a
device mesh attached (``attach_mesh``), bulk sweeps of at least
``mesh_min_batch`` PGs run sharded over it (``crush.sharded_sweep``).
The CRUSH step runs on CUDA unless ``OSDMap(..., device="cpu")``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ceph_tpu_torch.crush import builder
from ceph_tpu_torch.crush import hash as chash
from ceph_tpu_torch.crush.mapper import Mapper
from ceph_tpu_torch.crush.types import ITEM_NONE, WEIGHT_ONE, CrushMap
from ceph_tpu_torch.osd.types import ObjectLocator, PGPool, pg_t
from ceph_tpu_torch.utils.perf_counters import PerfCountersBuilder

MAX_PRIMARY_AFFINITY = 0x10000  # ref: CEPH_OSD_MAX_PRIMARY_AFFINITY
DEFAULT_PRIMARY_AFFINITY = 0x10000

# osd_state flags (ref: src/osd/OSDMap.h CEPH_OSD_EXISTS / CEPH_OSD_UP;
# NEARFULL/FULL mirror the per-OSD fullness state the mon derives from
# reported statfs against mon_osd_nearfull_ratio / mon_osd_full_ratio).
STATE_EXISTS = 1
STATE_UP = 2
STATE_NEARFULL = 4
STATE_FULL = 8

# cluster-wide osdmap service flags (ref: src/include/rados.h
# CEPH_OSDMAP_PAUSERD..NOIN, the `ceph osd set <flag>` surface)
FLAG_PAUSERD = 1 << 0
FLAG_PAUSEWR = 1 << 1
FLAG_FULL = 1 << 2
FLAG_NOOUT = 1 << 3
FLAG_NODOWN = 1 << 4
FLAG_NOUP = 1 << 5
FLAG_NOIN = 1 << 6

FLAG_NAMES = {
    "pauserd": FLAG_PAUSERD, "pausewr": FLAG_PAUSEWR,
    "full": FLAG_FULL, "noout": FLAG_NOOUT, "nodown": FLAG_NODOWN,
    "noup": FLAG_NOUP, "noin": FLAG_NOIN,
}


def flag_names(flags: int) -> str:
    """'noout,full'-style rendering (ref: OSDMap::get_flag_string)."""
    return ",".join(n for n, bit in FLAG_NAMES.items() if flags & bit)


_EMPTY_ROWS = np.empty(0, dtype=np.int64)

# mapping-engine counters: lookup-cache traffic and delta-remap volume
PERF = (PerfCountersBuilder("osdmap")
        .add_u64_counter("mapping_cache_hits",
                         "pg lookups served from the epoch cache/table")
        .add_u64_counter("mapping_cache_misses",
                         "pg lookups that entered the mapping pipeline")
        .add_u64_counter("remap_pgs",
                         "PGs delta-remapped by OSDMapMapping.update")
        .add_u64_counter("remap_full_sweeps",
                         "full-pool sweeps by OSDMapMapping.update")
        .add_u64_counter("remap_sharded_sweeps",
                         "full-pool sweeps served by the mesh-sharded "
                         "sweep (crush.sharded_sweep)")
        .create_perf_counters())

_PG_CACHE_MAX_BATCH = 16       # memo-cache only scalar-ish lookups;
                               # bulk callers go to the table/pipeline
_PG_CACHE_MAX_ENTRIES = 1 << 20


def _index_overrides(folded: np.ndarray, pgs) -> dict[int, np.ndarray]:
    """seed -> matching row indices, one O(N log E) pass instead of an
    O(N) scan per override entry."""
    seeds = np.unique(np.array([pg.seed for pg in pgs], dtype=folded.dtype))
    if not seeds.size:
        return {}
    hit = np.flatnonzero(np.isin(folded, seeds))
    out: dict[int, np.ndarray] = {}
    for s in seeds:
        out[int(s)] = hit[folded[hit] == s]
    return out


def _shift_left(rows: np.ndarray) -> np.ndarray:
    """Stable left-compaction of non-NONE entries (replicated up-sets)."""
    w = rows.shape[1]
    keys = np.where(rows == ITEM_NONE, w, 0) + np.arange(w)[None, :]
    order = np.argsort(keys, axis=1, kind="stable")
    return np.take_along_axis(rows, order, axis=1)


@dataclass
class Incremental:
    """A delta between epochs (ref: OSDMap::Incremental — same role,
    dict-shaped instead of encoded). Every field of the reference's, so
    the codec carries them all."""

    epoch: int = 0
    new_max_osd: int | None = None
    new_pools: dict[int, PGPool] = field(default_factory=dict)
    old_pools: list[int] = field(default_factory=list)
    new_up: list[int] = field(default_factory=list)
    new_down: list[int] = field(default_factory=list)
    new_weight: dict[int, int] = field(default_factory=dict)
    new_primary_affinity: dict[int, int] = field(default_factory=dict)
    new_pg_temp: dict[pg_t, list[int]] = field(default_factory=dict)
    new_primary_temp: dict[pg_t, int] = field(default_factory=dict)
    new_pg_upmap: dict[pg_t, tuple] = field(default_factory=dict)
    old_pg_upmap: list[pg_t] = field(default_factory=list)
    new_pg_upmap_items: dict[pg_t, list] = field(default_factory=dict)
    old_pg_upmap_items: list[pg_t] = field(default_factory=list)
    new_crush: CrushMap | None = None
    # daemon addresses published at boot: osd -> (host, port, hb_port)
    new_addrs: dict[int, tuple] = field(default_factory=dict)
    # absolute state values (ref: Incremental::new_state, here absolute)
    new_state: dict[int, int] = field(default_factory=dict)
    # client entity -> absolute expiry (unix); ref: new_blocklist
    new_blocklist: dict[str, float] = field(default_factory=dict)
    old_blocklist: list[str] = field(default_factory=list)
    # ref: Incremental::new_up_thru
    new_up_thru: dict[int, int] = field(default_factory=dict)
    # absolute cluster service-flag value; None = unchanged
    new_flags: int | None = None
    # per-entity op QoS profiles: entity -> (reservation, weight, limit)
    new_client_profiles: dict[str, tuple] = field(default_factory=dict)
    old_client_profiles: list[str] = field(default_factory=list)


class OSDMap:
    """The authoritative placement state at one epoch."""

    def __init__(self, crush: CrushMap, max_osd: int | None = None,
                 device=None):
        self.epoch = 1
        self.device = device
        self.crush = crush
        self.max_osd = max_osd if max_osd is not None else crush.max_devices
        n = self.max_osd
        self.osd_state = np.full(n, STATE_EXISTS | STATE_UP, dtype=np.int32)
        self.osd_weight = np.full(n, WEIGHT_ONE, dtype=np.int64)
        self.osd_primary_affinity = np.full(n, DEFAULT_PRIMARY_AFFINITY,
                                            dtype=np.int64)
        self.pools: dict[int, PGPool] = {}
        self.pg_temp: dict[pg_t, list[int]] = {}
        self.primary_temp: dict[pg_t, int] = {}
        self.pg_upmap: dict[pg_t, tuple] = {}
        self.pg_upmap_items: dict[pg_t, list] = {}
        # host-cluster state the codec carries and placement never reads
        self.osd_addrs: dict[int, tuple] = {}     # osd -> (host, port, hb)
        self.up_thru: dict[int, int] = {}         # osd -> epoch
        self.blocklist: dict[str, float] = {}     # entity -> expiry (unix)
        self.flags = 0                            # FLAG_* service flags
        self.client_profiles: dict[str, tuple] = {}
        self._mappers: dict[int | None, Mapper] = {}
        # bumped whenever the crush TREE changes (not reweights):
        # OSDMapMapping keys its topology-change detection on it
        self.crush_version = 1
        # epoch-keyed scalar memo + optional full-cluster table (module
        # docstring); the counters are per map and mirrored into PERF
        self._mapping = None
        # optional device mesh: bulk sweeps route through
        # crush.sharded_sweep; set by attach_mesh, re-attached by an
        # OSDMapMapping(mesh=...) at every update
        self._mesh = None
        self._mesh_min_batch = None
        self._pg_cache: dict[tuple[int, int], tuple] = {}
        self._pg_cache_epoch = self.epoch
        self.mapping_cache_hits = 0
        self.mapping_cache_misses = 0

    def test_flag(self, bit: int) -> bool:
        return bool(self.flags & bit)

    def is_blocklisted(self, name: str, now: float | None = None) -> bool:
        exp = self.blocklist.get(name)
        if exp is None:
            return False
        return (time.time() if now is None else now) < exp

    # -- state predicates (array-capable) ---------------------------------
    def exists(self, osd):
        safe = np.clip(osd, 0, self.max_osd - 1)
        ok = (self.osd_state[safe] & STATE_EXISTS) != 0
        return ok & (np.asarray(osd) >= 0) & (np.asarray(osd) < self.max_osd)

    def is_up(self, osd):
        safe = np.clip(osd, 0, self.max_osd - 1)
        return (self.osd_state[safe] & STATE_UP) != 0

    def is_out(self, osd) -> bool:
        return self.osd_weight[osd] == 0

    def is_nearfull(self, osd) -> bool:
        return bool(self.osd_state[osd] & STATE_NEARFULL)

    def is_full(self, osd) -> bool:
        return bool(self.osd_state[osd] & STATE_FULL)

    # -- mutation (each bumps the epoch; ref: OSDMap::apply_incremental) --
    def _dirty(self, crush_changed: bool = False) -> None:
        self.epoch += 1
        if crush_changed:
            self._mappers.clear()
            self.crush_version += 1

    def set_max_osd(self, n: int) -> None:
        grow = n - self.max_osd
        if grow > 0:
            self.osd_state = np.concatenate(
                [self.osd_state, np.zeros(grow, dtype=np.int32)])
            self.osd_weight = np.concatenate(
                [self.osd_weight, np.zeros(grow, dtype=np.int64)])
            self.osd_primary_affinity = np.concatenate(
                [self.osd_primary_affinity,
                 np.full(grow, DEFAULT_PRIMARY_AFFINITY, dtype=np.int64)])
        else:
            self.osd_state = self.osd_state[:n].copy()
            self.osd_weight = self.osd_weight[:n].copy()
            self.osd_primary_affinity = self.osd_primary_affinity[:n].copy()
        self.max_osd = n
        self.crush.max_devices = max(self.crush.max_devices, n)
        self._dirty(crush_changed=True)

    def create_osd(self, osd: int, weight: int = WEIGHT_ONE) -> None:
        if osd >= self.max_osd:
            self.set_max_osd(osd + 1)
        self.osd_state[osd] = STATE_EXISTS | STATE_UP
        self.osd_weight[osd] = weight
        self._dirty()

    def mark_up(self, osd: int) -> None:
        self.osd_state[osd] |= STATE_UP
        self._dirty()

    def mark_down(self, osd: int) -> None:
        self.osd_state[osd] &= ~STATE_UP
        self._dirty()

    def mark_out(self, osd: int) -> None:
        self.set_weight(osd, 0)

    def mark_in(self, osd: int) -> None:
        self.set_weight(osd, WEIGHT_ONE)

    def set_weight(self, osd: int, weight: int) -> None:
        """The in/out reweight (16.16), consumed by CRUSH's is_out check."""
        self.osd_weight[osd] = weight
        for mp in self._mappers.values():
            mp.set_device_weights(self._device_weights())
        self._dirty()

    def set_primary_affinity(self, osd: int, aff: int) -> None:
        self.osd_primary_affinity[osd] = aff
        self._dirty()

    def insert_crush_item(self, osd: int, weight: int,
                          bucket_id: int) -> None:
        """create + link an OSD into the CRUSH tree (the `ceph osd crush
        add` path: CrushWrapper::insert_item)."""
        if osd >= self.max_osd:
            self.set_max_osd(osd + 1)
            self.epoch -= 1
        self.osd_state[osd] = STATE_EXISTS | STATE_UP
        self.osd_weight[osd] = WEIGHT_ONE
        builder.insert_item(self.crush, osd, weight, bucket_id)
        self.crush.max_devices = max(self.crush.max_devices, self.max_osd)
        self._dirty(crush_changed=True)

    def remove_crush_item(self, osd: int) -> None:
        """unlink + mark gone (ref: CrushWrapper::remove_item +
        OSDMap rm)."""
        builder.remove_item(self.crush, osd)
        self.osd_state[osd] = 0
        self.osd_weight[osd] = 0
        self._dirty(crush_changed=True)

    def set_crush(self, crush: CrushMap) -> None:
        self.crush = crush
        if crush.max_devices > self.max_osd:
            self.set_max_osd(crush.max_devices)
        self._dirty(crush_changed=True)

    def add_pool(self, pool: PGPool) -> PGPool:
        self.pools[pool.id] = pool
        self._dirty()
        return pool

    def apply_incremental(self, inc: Incremental) -> None:
        """ref: OSDMap::apply_incremental."""
        if inc.epoch and inc.epoch != self.epoch + 1:
            raise ValueError(
                f"incremental epoch {inc.epoch} != {self.epoch + 1}")
        if inc.new_crush is not None:
            self.crush = inc.new_crush
            self._mappers.clear()
            self.crush_version += 1
        if inc.new_max_osd is not None:
            self.set_max_osd(inc.new_max_osd)
            self.epoch -= 1  # counted once below
        for pid in inc.old_pools:
            self.pools.pop(pid, None)
        self.pools.update(inc.new_pools)
        for o, st in inc.new_state.items():
            self.osd_state[o] = st
        for o in inc.new_up:
            self.osd_state[o] |= STATE_EXISTS | STATE_UP
        for o in inc.new_down:
            self.osd_state[o] &= ~STATE_UP
        for o, w in inc.new_weight.items():
            self.osd_weight[o] = w
        for o, a in inc.new_primary_affinity.items():
            self.osd_primary_affinity[o] = a
        for pg, osds in inc.new_pg_temp.items():
            if osds:
                self.pg_temp[pg] = list(osds)
            else:
                self.pg_temp.pop(pg, None)
        for pg, p in inc.new_primary_temp.items():
            if p >= 0:
                self.primary_temp[pg] = p
            else:
                self.primary_temp.pop(pg, None)
        self.pg_upmap.update(inc.new_pg_upmap)
        for pg in inc.old_pg_upmap:
            self.pg_upmap.pop(pg, None)
        self.pg_upmap_items.update(inc.new_pg_upmap_items)
        for pg in inc.old_pg_upmap_items:
            self.pg_upmap_items.pop(pg, None)
        self.osd_addrs.update(inc.new_addrs)
        self.up_thru.update(inc.new_up_thru)
        if inc.new_flags is not None and inc.new_flags >= 0:
            self.flags = inc.new_flags
        self.blocklist.update(inc.new_blocklist)
        for name in inc.old_blocklist:
            self.blocklist.pop(name, None)
        self.client_profiles.update(inc.new_client_profiles)
        for name in inc.old_client_profiles:
            self.client_profiles.pop(name, None)
        if inc.new_weight:
            # the reweights are the only input of a live Mapper that an
            # incremental changes in place (a new crush or max_osd dropped
            # the Mappers above); rebuilding them for a state-only epoch
            # would throw their kernel plans away for nothing
            for mp in self._mappers.values():
                mp.set_device_weights(self._device_weights())
        self.epoch += 1

    # -- mapper -----------------------------------------------------------
    def _device_weights(self) -> np.ndarray:
        w = np.zeros(max(self.crush.max_devices, self.max_osd),
                     dtype=np.int64)
        w[:self.max_osd] = self.osd_weight
        return w

    def _choose_args_key(self, pool_id: int) -> int | None:
        """Weight-set selection: a pool-keyed entry wins, else the
        compat/default set (-1), else none (ref: CrushWrapper::
        choose_args_get_with_fallback)."""
        if pool_id in self.crush.choose_args:
            return pool_id
        if -1 in self.crush.choose_args:
            return -1
        return None

    def attach_mesh(self, mesh, mesh_min_batch: int | None = None) -> None:
        """Route bulk mapping sweeps over a device mesh: this map's
        Mappers, existing and future, get it (``crush.sharded_sweep``
        serves batches of at least ``mesh_min_batch``)."""
        self._mesh = mesh
        self._mesh_min_batch = mesh_min_batch
        for mp in self._mappers.values():
            mp.attach_mesh(mesh, mesh_min_batch)

    def mapper(self, choose_args_key: int | None = None) -> Mapper:
        mp = self._mappers.get(choose_args_key)
        if mp is None:
            mp = Mapper(self.crush,
                        device_weights=self._device_weights(),
                        choose_args=choose_args_key, device=self.device,
                        mesh=self._mesh,
                        mesh_min_batch=self._mesh_min_batch)
            self._mappers[choose_args_key] = mp
        return mp

    def serving_mapper(self, pool_id: int) -> Mapper:
        """THE Mapper pg_to_crush_osds uses for this pool — the single
        selection site, so callers reading post-sweep state
        (last_map_path) cannot drift from the sweep itself."""
        return self.mapper(self._choose_args_key(pool_id))

    # -- object -> PG ------------------------------------------------------
    def object_locator_to_pg(self, name: str, loc: ObjectLocator) -> pg_t:
        """ref: OSDMap::object_locator_to_pg (raw pg; fold with
        pool.raw_pg_to_pg)."""
        pool = self.pools[loc.pool]
        if loc.hash >= 0:
            ps = loc.hash
        else:
            ps = pool.hash_key(loc.key or name, loc.nspace)
        return pg_t(loc.pool, ps)

    # -- PG -> OSDs, batched ----------------------------------------------
    def pg_to_crush_osds(self, pool_id: int,
                         seeds) -> tuple[np.ndarray, np.ndarray]:
        """PURE CRUSH output (no nonexistent-removal) + pps. This is
        the half of the pipeline that only weight/topology changes can
        invalidate — OSDMapMapping caches it per pool so up/down flips
        and override edits replay just ``_pipeline_from_crush``."""
        raw, pps, _paths = self.pg_to_crush_osds_path(pool_id, seeds)
        return raw, pps

    def pg_to_crush_osds_path(self, pool_id: int, seeds) -> tuple[
            np.ndarray, np.ndarray, tuple[str | None, str | None]]:
        """``pg_to_crush_osds`` plus this sweep's engine evidence
        ``(expected, actual)``: the serving Mapper's plan
        (``mapping_path``) and the engine the call ran on."""
        pool = self.pools[pool_id]
        seeds = np.asarray(seeds, dtype=np.uint32)
        pps = pool.raw_pg_to_pps(seeds, xp=np)
        mp = self.serving_mapper(pool.id)
        expected = mp.expected_path(pool.crush_rule, pool.size)
        out, actual = mp.map_pgs_path(pool.crush_rule, pps, pool.size)
        return out.cpu().numpy(), pps, (expected, actual)

    def pg_to_raw_osds(self, pool_id: int,
                       seeds) -> tuple[np.ndarray, np.ndarray]:
        """CRUSH output with nonexistent devices removed
        (ref: OSDMap::pg_to_raw_osds)."""
        pool = self.pools[pool_id]
        raw, pps = self.pg_to_crush_osds(pool_id, seeds)
        return self._remove_nonexistent(pool, raw), pps

    def _remove_nonexistent(self, pool: PGPool, raw: np.ndarray) -> np.ndarray:
        """ref: OSDMap::_remove_nonexistent_osds."""
        bad = (raw != ITEM_NONE) & ~self.exists(raw)
        raw = np.where(bad, ITEM_NONE, raw)
        if pool.can_shift_osds():
            raw = _shift_left(raw)
        return raw

    def _apply_upmap(self, pool: PGPool, seeds: np.ndarray,
                     raw: np.ndarray) -> np.ndarray:
        """Sparse explicit overrides (ref: OSDMap::_apply_upmap)."""
        if not self.pg_upmap and not self.pg_upmap_items:
            return raw
        folded = pool.raw_pg_to_pg(seeds, xp=np)
        rows_of = _index_overrides(
            folded, [pg for pg in self.pg_upmap if pg.pool == pool.id] +
            [pg for pg in self.pg_upmap_items if pg.pool == pool.id])
        # A REJECTED pg_upmap entry settles the PG (the scalar walk
        # returns early); a valid one is applied and then falls through
        # to pg_upmap_items. Only in-range zero-weight targets reject.
        settled: set[int] = set()
        for pg, target in self.pg_upmap.items():
            if pg.pool != pool.id:
                continue
            rows = rows_of.get(pg.seed, _EMPTY_ROWS)
            if not rows.size:
                continue
            if any(o != ITEM_NONE and 0 <= o < self.max_osd and
                   self.osd_weight[o] == 0 for o in target):
                settled.add(pg.seed)
                continue  # reject mappings onto marked-out osds
            row = np.full(raw.shape[1], ITEM_NONE, dtype=raw.dtype)
            row[:min(len(target), raw.shape[1])] = \
                list(target)[:raw.shape[1]]
            raw[rows] = row
        for pg, pairs in self.pg_upmap_items.items():
            if pg.pool != pool.id or pg.seed in settled:
                continue
            rows = rows_of.get(pg.seed, _EMPTY_ROWS)
            for ri in rows:
                row = raw[ri]
                for frm, to in pairs:
                    if to in row:
                        continue
                    if to < 0 or to >= self.max_osd or \
                            self.osd_weight[to] == 0:
                        continue
                    pos = np.flatnonzero(row == frm)
                    if pos.size:
                        row[pos[0]] = to
        return raw

    def _raw_to_up(self, pool: PGPool, raw: np.ndarray) -> np.ndarray:
        """Drop down/gone devices (ref: OSDMap::_raw_to_up_osds)."""
        ok = (raw != ITEM_NONE) & self.exists(raw) & self.is_up(
            np.clip(raw, 0, self.max_osd - 1))
        up = np.where(ok, raw, ITEM_NONE)
        if pool.can_shift_osds():
            up = _shift_left(up)
        return up

    @staticmethod
    def _pick_primary(osds: np.ndarray) -> np.ndarray:
        """First non-NONE entry per row, -1 if none
        (ref: OSDMap::_pick_primary)."""
        valid = osds != ITEM_NONE
        has = valid.any(axis=1)
        pos = np.argmax(valid, axis=1)
        return np.where(has, np.take_along_axis(
            osds, pos[:, None], axis=1)[:, 0], -1)

    def _apply_primary_affinity(self, pps: np.ndarray, up: np.ndarray,
                                primary: np.ndarray) -> np.ndarray:
        """ref: OSDMap::_apply_primary_affinity — hash-gated pass-over of
        low-affinity primaries, vectorized over (pg, slot)."""
        if (self.osd_primary_affinity == DEFAULT_PRIMARY_AFFINITY).all():
            return primary
        valid = up != ITEM_NONE
        safe = np.clip(up, 0, self.max_osd - 1)
        aff = self.osd_primary_affinity[safe]
        h = chash.hash32_2(pps[:, None].astype(np.uint32),
                           up.astype(np.uint32), xp=np).astype(np.int64) >> 16
        accept = valid & ((aff >= MAX_PRIMARY_AFFINITY) | (h < aff))
        any_acc = accept.any(axis=1)
        pos = np.argmax(accept, axis=1)
        cand = np.take_along_axis(up, pos[:, None], axis=1)[:, 0]
        return np.where(any_acc, cand, primary)

    def _get_temp_osds(self, pool: PGPool, seeds: np.ndarray,
                       up: np.ndarray, up_primary: np.ndarray):
        """ref: OSDMap::_get_temp_osds."""
        acting = up.copy()
        acting_primary = up_primary.copy()
        if not self.pg_temp and not self.primary_temp:
            return acting, acting_primary
        folded = pool.raw_pg_to_pg(seeds, xp=np)
        rows_of = _index_overrides(
            folded, [pg for pg in self.pg_temp if pg.pool == pool.id] +
            [pg for pg in self.primary_temp if pg.pool == pool.id])
        for pg, osds in self.pg_temp.items():
            if pg.pool != pool.id:
                continue
            rows = rows_of.get(pg.seed, _EMPTY_ROWS)
            if not rows.size:
                continue
            kept = [o for o in osds if o == ITEM_NONE or bool(
                self.exists(np.asarray(o)))]
            if not any(o != ITEM_NONE for o in kept):
                continue
            row = np.full(acting.shape[1], ITEM_NONE, dtype=acting.dtype)
            row[:min(len(kept), len(row))] = kept[:len(row)]
            acting[rows] = row
            prim = next((o for o in kept if o != ITEM_NONE), -1)
            acting_primary[rows] = prim
        for pg, p in self.primary_temp.items():
            if pg.pool != pool.id:
                continue
            acting_primary[rows_of.get(pg.seed, _EMPTY_ROWS)] = p
        return acting, acting_primary

    def _pipeline_from_crush(self, pool: PGPool, seeds: np.ndarray,
                             craw: np.ndarray, pps: np.ndarray):
        """Everything AFTER the CRUSH step (ref: the tail of
        OSDMap::_pg_to_up_acting_osds): nonexistent-removal -> upmap ->
        up-filter -> primary pick/affinity -> pg_temp/primary_temp.
        ``craw`` is never mutated, so a caller may replay this over
        cached raw rows (OSDMapMapping delta remap, the balancer's
        candidate probes)."""
        raw = self._remove_nonexistent(pool, craw)   # returns a copy
        raw = self._apply_upmap(pool, seeds, raw)
        up = self._raw_to_up(pool, raw)
        up_primary = self._pick_primary(up)
        up_primary = self._apply_primary_affinity(pps, up, up_primary)
        acting, acting_primary = self._get_temp_osds(pool, seeds, up,
                                                     up_primary)
        return up, up_primary, acting, acting_primary

    def _pg_to_up_acting_uncached(self, pool: PGPool, seeds: np.ndarray):
        craw, pps = self.pg_to_crush_osds(pool.id, seeds)
        return self._pipeline_from_crush(pool, seeds, craw, pps)

    def attach_mapping(self, mapping) -> None:
        """Attach an OSDMapMapping whose table, when at this map's epoch,
        serves pg_to_up_acting_osds directly (bulk and scalar) without
        re-entering the mapper."""
        self._mapping = mapping

    def pg_to_up_acting_osds(self, pool_id: int, seeds):
        """The full pipeline (ref: OSDMap::_pg_to_up_acting_osds).

        seeds: (N,) actual pg seeds in [0, pg_num). Returns
        (up (N,size), up_primary (N,), acting, acting_primary).

        Served, in order of preference, from (1) the attached
        OSDMapMapping table when it is at this epoch, (2) the epoch-keyed
        scalar memo for batches of at most _PG_CACHE_MAX_BATCH seeds,
        (3) the pipeline. Nothing is served across an epoch bump: the
        memo is keyed to one epoch and dropped wholesale.
        """
        pool = self.pools[pool_id]
        seeds = np.atleast_1d(np.asarray(seeds, dtype=np.uint32))
        mp = self._mapping
        if mp is not None and mp.serves(self, pool_id):
            self.mapping_cache_hits += len(seeds)
            PERF.inc("mapping_cache_hits", len(seeds))
            return mp.lookup(pool_id, seeds)
        if not len(seeds) or len(seeds) > _PG_CACHE_MAX_BATCH:
            if len(seeds):
                self.mapping_cache_misses += len(seeds)
                PERF.inc("mapping_cache_misses", len(seeds))
            return self._pg_to_up_acting_uncached(pool, seeds)
        if self._pg_cache_epoch != self.epoch:
            self._pg_cache.clear()
            self._pg_cache_epoch = self.epoch
        missing = [int(s) for s in seeds
                   if (pool_id, int(s)) not in self._pg_cache]
        if missing:
            if len(self._pg_cache) > _PG_CACHE_MAX_ENTRIES:
                self._pg_cache.clear()
                # the flush evicted this batch's hit seeds too
                missing = [int(s) for s in seeds]
            self.mapping_cache_misses += len(missing)
            PERF.inc("mapping_cache_misses", len(missing))
            u, upp, a, actp = self._pg_to_up_acting_uncached(
                pool, np.asarray(missing, dtype=np.uint32))
            for i, s in enumerate(missing):
                self._pg_cache[(pool_id, s)] = (
                    tuple(int(o) for o in u[i]), int(upp[i]),
                    tuple(int(o) for o in a[i]), int(actp[i]))
        nhit = len(seeds) - len(missing)
        if nhit:
            self.mapping_cache_hits += nhit
            PERF.inc("mapping_cache_hits", nhit)
        width = max(len(self._pg_cache[(pool_id, int(s))][0])
                    for s in seeds)
        up = np.full((len(seeds), width), ITEM_NONE, dtype=np.int32)
        acting = np.full((len(seeds), width), ITEM_NONE, dtype=np.int32)
        up_primary = np.empty(len(seeds), dtype=np.int64)
        acting_primary = np.empty(len(seeds), dtype=np.int64)
        for i, s in enumerate(seeds):
            cu, cupp, ca, cactp = self._pg_cache[(pool_id, int(s))]
            up[i, :len(cu)] = cu
            acting[i, :len(ca)] = ca
            up_primary[i] = cupp
            acting_primary[i] = cactp
        return up, up_primary, acting, acting_primary

    def pg_to_acting_osds(self, pool_id: int, seeds):
        _, _, acting, acting_primary = self.pg_to_up_acting_osds(pool_id,
                                                                 seeds)
        return acting, acting_primary

    def pg_to_acting_primary(self, pool_id: int, seed: int):
        """Scalar (acting list, acting_primary) for one PG — the
        data-path op-targeting shape (Objecter _calc_target, mon
        repair/`osd map`). Served from the attached table or the
        epoch-keyed memo, so steady-state ops never re-enter the
        mapper.

        The acting list is POSITION-LOSSY: ITEM_NONE holes are
        filtered out, so for EC pools list index is NOT shard id —
        callers needing shard positions must use
        ``pg_to_up_acting_osds`` (which keeps the placeholders)."""
        _, _, acting, actp = self.pg_to_up_acting_osds(
            pool_id, [int(seed)])
        return [int(o) for o in acting[0] if o != ITEM_NONE], \
            int(actp[0])

    def map_pool(self, pool_id: int):
        """All PGs of a pool in one call -> (up, up_primary, acting,
        acting_primary), shape (pg_num, ...)."""
        pool = self.pools[pool_id]
        return self.pg_to_up_acting_osds(
            pool_id, np.arange(pool.pg_num, dtype=np.uint32))

    # -- utilization ------------------------------------------------------
    def pool_utilization(self, pool_id: int) -> np.ndarray:
        """PG count per OSD for one pool (the CrushTester aggregate,
        ref: src/crush/CrushTester.cc test aggregation)."""
        up, _, _, _ = self.map_pool(pool_id)
        flat = up[up != ITEM_NONE]
        return np.bincount(flat, minlength=self.max_osd)

    # -- upmap balancer ----------------------------------------------------
    def _crush_parents(self) -> dict[int, int]:
        parents: dict[int, int] = {}
        for b in self.crush.buckets.values():
            for child in b.items:
                parents[child] = b.id
        return parents

    def _failure_domain_of(self, parents: dict[int, int], osd: int,
                           fd_type: int) -> int:
        """Ancestor bucket of `osd` at fd_type (the chooseleaf domain);
        the osd itself when fd_type is 0/absent."""
        if fd_type <= 0:
            return osd
        node = osd
        while node in parents:
            node = parents[node]
            b = self.crush.buckets.get(node)
            if b is not None and b.type == fd_type:
                return node
        return osd

    def _rule_failure_domain(self, ruleno: int) -> int:
        """The separation type the rule's choose steps enforce."""
        from ceph_tpu_torch.crush.types import (
            OP_CHOOSELEAF_FIRSTN, OP_CHOOSELEAF_INDEP, OP_CHOOSE_FIRSTN,
            OP_CHOOSE_INDEP)
        fd = 0
        for s in self.crush.rules[ruleno].steps:
            if s.op in (OP_CHOOSELEAF_FIRSTN, OP_CHOOSELEAF_INDEP,
                        OP_CHOOSE_FIRSTN, OP_CHOOSE_INDEP):
                fd = max(fd, s.arg2)
        return fd

    def calc_pg_upmaps(self, pool_ids=None, max_deviation: int = 5,
                       max_iterations: int = 200,
                       inc: "Incremental | None" = None) -> int:
        """Generate pg_upmap_items flattening the PG distribution.

        ref: src/osd/OSDMap.cc OSDMap::calc_pg_upmaps — the mgr
        balancer's upmap mode. Same shape as upstream: compute per-OSD
        deviation from the weight-proportional target, then repeatedly
        move one PG shard from the most-overfull OSD to an underfull one
        via a pg_upmap_items pair, preferring to DROP an existing upmap
        entry that feeds the overfull OSD before adding new ones. Every
        candidate move is validated by remapping the PG through the full
        pipeline (no duplicate OSDs, no holes, failure-domain separation
        preserved — upstream delegates that to crush->try_remap_rule).

        Batched twist: placement is computed once per pool with the
        batched mapper; counts update incrementally per move.

        Returns the number of upmap changes recorded (and applied to this
        map; pass ``inc`` to also record them Incremental-style, in the
        reference's order: a reverted entry as ``new_pg_upmap_items`` or
        ``old_pg_upmap_items``, an added pair as ``new_pg_upmap_items``).

        Two departures from the reference, both faults it has (ROADMAP
        Queue C): a revert is made only when it lowers the sum of squared
        deviations. Upstream's OSDMap::calc_pg_upmaps (src/osd/OSDMap.cc)
        sums the squared deviations of a tentative change into
        ``new_stddev`` and, ``if (new_stddev >= stddev)``, keeps the map
        as it was ("stddev is not decreasing"); the port tests reverts
        only, as its adds move a shard from an overfull OSD to an
        underfull one (the reference reverts regardless, and on a k=8
        m=3 pool over twelve hosts it reverts and re-adds the same pairs
        at every pass, forever); and ``inc`` holds each PG once, in the list of
        its final state (the reference can list a PG in both, which the
        balancer applies set, then removed).
        """
        pools = {pid: self.pools[pid]
                 for pid in (pool_ids or self.pools)}
        if not pools:
            return 0
        parents = self._crush_parents()

        # per-osd weight share: crush weight x reweight (out osds get 0).
        # A device's crush weight lives in its parent bucket's weights
        # slot (ref: crush_bucket.weights), not on the device itself.
        crush_w = np.zeros(self.max_osd, dtype=np.float64)
        for b in self.crush.buckets.values():
            for child, w in zip(b.items, b.weights):
                if 0 <= child < self.max_osd:
                    crush_w[child] = w / WEIGHT_ONE
        base_w = np.zeros(self.max_osd, dtype=np.float64)
        for o in range(self.max_osd):
            if not self.exists(np.asarray(o)) or self.osd_weight[o] == 0:
                continue
            base_w[o] = crush_w[o] * (self.osd_weight[o] / WEIGHT_ONE)

        # Initial placement + per-pg bookkeeping: the pure CRUSH output
        # per pool is computed ONCE (or served from an attached
        # OSDMapMapping) — pg_upmap_items edits never change CRUSH
        # output, so every candidate-move probe below replays only the
        # numpy post-CRUSH pipeline over the cached raw row.
        up_by_pool: dict[int, np.ndarray] = {}
        craw_by_pool: dict[int, np.ndarray] = {}
        pps_by_pool: dict[int, np.ndarray] = {}
        counts = np.zeros(self.max_osd, dtype=np.int64)
        for pid in pools:
            pool = pools[pid]
            seeds = np.arange(pool.pg_num, dtype=np.uint32)
            mtab = self._mapping
            if mtab is not None and mtab.serves(self, pid) and \
                    mtab.crush_raw(pid) is not None:
                craw = mtab.crush_raw(pid)
                pps = pool.raw_pg_to_pps(seeds, xp=np)
            else:
                craw, pps = self.pg_to_crush_osds(pid, seeds)
            craw_by_pool[pid] = craw
            pps_by_pool[pid] = pps
            up, _, _, _ = self._pipeline_from_crush(pool, seeds, craw,
                                                    pps)
            up_by_pool[pid] = up
            flat = up[up != ITEM_NONE]
            counts += np.bincount(flat, minlength=self.max_osd)
        total = int(counts.sum())
        if total == 0 or base_w.sum() == 0:
            return 0
        target = base_w / base_w.sum() * total

        def deviation():
            dev = counts - target
            dev[base_w == 0] = 0            # out osds: not balanceable
            return dev

        def remap_pg(pid, seed):
            # post-CRUSH pipeline only — reads the MUTATED upmap dicts
            # against the cached raw row, bit-identical to a full
            # pg_to_up_acting_osds call
            sarr = np.asarray([seed], dtype=np.uint32)
            up, _, _, _ = self._pipeline_from_crush(
                pools[pid], sarr, craw_by_pool[pid][seed:seed + 1],
                pps_by_pool[pid][seed:seed + 1])
            return up[0]

        def improves(old_row, new_row) -> bool:
            # the sum of squared deviations falls (upstream's
            # `new_stddev >= stddev` test in OSDMap::calc_pg_upmaps)
            delta = np.zeros(self.max_osd, dtype=np.float64)
            np.add.at(delta, old_row[old_row != ITEM_NONE], -1)
            np.add.at(delta, new_row[new_row != ITEM_NONE], 1)
            dev = deviation()
            return float(((dev + delta * (base_w > 0)) ** 2).sum()) < \
                float((dev ** 2).sum())

        def record(pg, pairs):
            # the Incremental holds each PG's final state once: a PG
            # both set and removed in one pass would be applied set then
            # removed by the balancer, whatever the pass ended with
            if pairs is None:
                inc.new_pg_upmap_items.pop(pg, None)
                if pg not in inc.old_pg_upmap_items:
                    inc.old_pg_upmap_items.append(pg)
            else:
                if pg in inc.old_pg_upmap_items:
                    inc.old_pg_upmap_items.remove(pg)
                inc.new_pg_upmap_items[pg] = pairs

        changes = 0
        for _ in range(max_iterations):
            dev = deviation()
            over = int(np.argmax(dev))
            # both tails count (upstream fills underfull OSDs from the
            # most-loaded ones even when no OSD exceeds +max_deviation)
            if dev[over] <= max_deviation and \
                    dev.min() >= -max_deviation:
                break
            under_order = np.argsort(dev)
            moved = False
            # candidate PGs currently holding a shard on `over`
            for pid, up in up_by_pool.items():
                pool = pools[pid]
                fd_type = self._rule_failure_domain(pool.crush_rule)
                rows = np.flatnonzero((up == over).any(axis=1))
                for row in rows:
                    pg = pg_t(pid, int(row))
                    if pg in self.pg_upmap:
                        continue    # full override settles the PG; items
                    pairs = self.pg_upmap_items.get(pg, [])
                    # prefer reverting an existing remap feeding `over`
                    reverted = [p for p in pairs if p[1] != over]
                    if len(reverted) != len(pairs):
                        if reverted:
                            self.pg_upmap_items[pg] = reverted
                        else:
                            self.pg_upmap_items.pop(pg, None)
                        new_row = remap_pg(pid, row)
                        if not improves(up[row], new_row):
                            # the shard would go back to an OSD as full
                            # as `over`: a revert that does not lower
                            # the spread is the cycle the reference
                            # repeats forever (ROADMAP Queue C)
                            self.pg_upmap_items[pg] = pairs
                            continue
                        if inc is not None:
                            record(pg, reverted or None)
                    else:
                        # cheap pre-filters (dup/up/failure-domain) reject
                        # most candidates in O(1); the full pipeline then
                        # confirms — in the common case exactly one
                        # pipeline call per accepted move.
                        new_row = None
                        row_domains = {
                            self._failure_domain_of(parents, int(o),
                                                    fd_type)
                            for o in up[row] if o != ITEM_NONE and
                            o != over}
                        cur = set(int(o) for o in up[row]
                                  if o != ITEM_NONE)
                        for u in under_order:
                            u = int(u)
                            if base_w[u] == 0:
                                continue
                            if dev[u] >= dev[over] - 1:
                                break   # ascending: no target improves max
                            if u in cur or not bool(
                                    self.is_up(np.asarray(u))):
                                continue
                            if self._failure_domain_of(
                                    parents, u, fd_type) in row_domains:
                                continue
                            self.pg_upmap_items[pg] = pairs + [(over, u)]
                            cand = remap_pg(pid, row)
                            vals = cand[cand != ITEM_NONE]
                            if (cand != ITEM_NONE).all() and \
                                    len(set(vals.tolist())) == len(vals) \
                                    and u in vals and over not in vals:
                                new_row = cand
                                if inc is not None:
                                    record(pg, pairs + [(over, u)])
                                break
                            # pipeline disagreed: roll back
                            if pairs:
                                self.pg_upmap_items[pg] = pairs
                            else:
                                self.pg_upmap_items.pop(pg, None)
                        if new_row is None:
                            continue
                    # bookkeeping: update counts with the actual delta
                    old_row = up[row]
                    for o in old_row[old_row != ITEM_NONE]:
                        counts[o] -= 1
                    for o in new_row[new_row != ITEM_NONE]:
                        counts[o] += 1
                    up_by_pool[pid][row] = new_row
                    changes += 1
                    moved = True
                    break
                if moved:
                    break
            if not moved:
                break
        if changes:
            self._dirty()
        return changes
