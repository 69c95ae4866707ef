"""Placement-group types and pool metadata: what placement reads.

ref: src/osd/osd_types.{h,cc} (pg_t, pg_pool_t, object_locator_t)
rebuilt as array-friendly dataclasses: every seed-indexed computation also
accepts arrays so the whole pool maps in one shot.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ceph_tpu_torch.crush import hash as chash
from ceph_tpu_torch.osd.str_hash import (
    CEPH_STR_HASH_RJENKINS, str_hash, str_hash_batch,
)

POOL_TYPE_REPLICATED = 1  # ref: pg_pool_t::TYPE_REPLICATED
POOL_TYPE_ERASURE = 3     # ref: pg_pool_t::TYPE_ERASURE

FLAG_HASHPSPOOL = 1 << 2  # ref: pg_pool_t::FLAG_HASHPSPOOL

# pool fullness flags (ref: pg_pool_t::FLAG_FULL / FLAG_FULL_QUOTA):
# FULL is the operator/mon "no more writes to this pool" bit;
# FULL_QUOTA is set by the mon's quota sweep when the pool's aggregate
# usage crosses quota_bytes/quota_objects and cleared by the same sweep
# once usage drops or the quota is raised.
FLAG_POOL_FULL = 1 << 1
FLAG_POOL_FULL_QUOTA = 1 << 10

# last_backfill watermark bounds (ref: hobject_t::get_max / is_max —
# pg_info_t.last_backfill). Backfill scans the collection in plain
# string-sorted object-name order; "" (MIN) sorts before every name and
# MAX_OID after every name this framework can generate (object names
# are JSON-safe strings; U+FFFF is a noncharacter that never appears in
# them). last_backfill == MAX_OID means "fully backfilled" — the normal
# state of every complete replica.
MIN_OID = ""
MAX_OID = "\uffff"


def ceph_stable_mod(x, b, bmask, xp=np):
    """ref: src/include/ceph_hash.h ceph_stable_mod — the split-aware mod
    that keeps objects stable while pg_num grows toward a power of two."""
    if xp is None:  # plain ints
        return x & bmask if (x & bmask) < b else x & (bmask >> 1)
    x = xp.asarray(x)
    return xp.where((x & bmask) < b, x & bmask, x & (bmask >> 1))


def calc_mask(n: int) -> int:
    """pg_num -> pg_num_mask (ref: pg_pool_t::calc_pg_masks)."""
    if n <= 0:
        return 0
    return (1 << (n - 1).bit_length()) - 1


@dataclass(frozen=True)
class pg_t:
    """ref: osd_types.h struct pg_t (pool id + placement seed)."""

    pool: int
    seed: int

    def __str__(self) -> str:
        return f"{self.pool}.{self.seed:x}"

    @classmethod
    def parse(cls, s: str) -> "pg_t":
        pool, _, seed = s.partition(".")
        return cls(int(pool), int(seed, 16))


@dataclass(frozen=True)
class spg_t:
    """Shard-qualified PG for EC pools (ref: osd_types.h struct spg_t)."""

    pgid: pg_t
    shard: int = -1  # NO_SHARD

    def __str__(self) -> str:
        if self.shard < 0:
            return str(self.pgid)
        return f"{self.pgid}s{self.shard}"


@dataclass(frozen=True)
class ObjectLocator:
    """ref: osd_types.h object_locator_t."""

    pool: int
    key: str = ""
    nspace: str = ""
    hash: int = -1  # explicit hash position overrides name hashing


@dataclass
class PGPool:
    """ref: osd_types.h pg_pool_t — the subset placement consumes."""

    id: int
    pg_num: int = 64
    pgp_num: int | None = None
    type: int = POOL_TYPE_REPLICATED
    size: int = 3
    min_size: int = 2
    crush_rule: int = 0
    flags: int = FLAG_HASHPSPOOL
    object_hash: int = CEPH_STR_HASH_RJENKINS
    erasure_code_profile: str = ""
    name: str = ""
    pg_temp_primaries_first: bool = False
    extra: dict = field(default_factory=dict)
    # Fields placement never reads, carried because the map codec
    # (``encoding.maps``) encodes them: the pool quotas, the pg_num merge
    # barrier (the PG's merge predicates below read it) and the pool's
    # op QoS triple (ref: pg_pool_t
    # quota_max_bytes/quota_max_objects, pg_num_pending; the mClock pool
    # profile). 0 = unset.
    quota_bytes: int = 0
    quota_objects: int = 0
    pg_num_pending: int = 0
    qos_reservation: float = 0.0
    qos_weight: float = 0.0
    qos_limit: float = 0.0

    def __post_init__(self) -> None:
        if self.pgp_num is None:
            self.pgp_num = self.pg_num

    # -- masks ------------------------------------------------------------
    @property
    def pg_num_mask(self) -> int:
        return calc_mask(self.pg_num)

    @property
    def pgp_num_mask(self) -> int:
        return calc_mask(self.pgp_num)

    def is_replicated(self) -> bool:
        return self.type == POOL_TYPE_REPLICATED

    def is_erasure(self) -> bool:
        return self.type == POOL_TYPE_ERASURE

    def can_shift_osds(self) -> bool:
        """Replicated sets compact over holes; EC sets are positional
        (ref: pg_pool_t::can_shift_osds)."""
        return self.is_replicated()

    def is_full(self) -> bool:
        """Writes to this pool must park/fail (ref: pg_pool_t::has_flag
        FLAG_FULL|FLAG_FULL_QUOTA checks in
        Objecter::target_should_be_paused)."""
        return bool(self.flags & (FLAG_POOL_FULL | FLAG_POOL_FULL_QUOTA))

    def is_merge_source(self, seed: int) -> bool:
        """Is this PG folded away by the pending pg_num decrease?
        (ref: pg_t::is_merge_source)"""
        return bool(self.pg_num_pending) and seed >= self.pg_num_pending

    def merge_target(self, seed: int) -> int:
        """The parent a merge-source seed folds into at pg_num_pending
        (ref: pg_t::get_parent under the stable-mod fold)."""
        assert self.pg_num_pending
        return int(ceph_stable_mod(seed, self.pg_num_pending,
                                   calc_mask(self.pg_num_pending),
                                   xp=None))

    # -- seed math (array-capable) ----------------------------------------
    def raw_pg_to_pg(self, seeds, xp=np):
        """Fold raw seeds onto actual pg_num (ref: pg_pool_t::raw_pg_to_pg)."""
        return ceph_stable_mod(seeds, self.pg_num, self.pg_num_mask, xp=xp)

    def raw_pg_to_pps(self, seeds, xp=np):
        """Placement seed fed to CRUSH (ref: pg_pool_t::raw_pg_to_pps).

        HASHPSPOOL mixes the pool id through rjenkins so co-sized pools
        don't stack their PGs on the same OSDs; legacy adds the pool id.
        """
        folded = ceph_stable_mod(seeds, self.pgp_num, self.pgp_num_mask,
                                 xp=xp)
        if self.flags & FLAG_HASHPSPOOL:
            if xp is None:
                return int(chash.hash32_2(np.uint32(folded),
                                          np.uint32(self.id), xp=np))
            return chash.hash32_2(folded, xp.full_like(
                xp.asarray(folded), self.id), xp=xp).astype(xp.uint32)
        return folded + self.id

    def hash_key(self, key: str | bytes, nspace: str | bytes = "") -> int:
        """ref: pg_pool_t::hash_key — 0x1f-joined nspace+key."""
        kb = key.encode() if isinstance(key, str) else key
        nb = nspace.encode() if isinstance(nspace, str) else nspace
        data = nb + b"\x1f" + kb if nb else kb
        return str_hash(self.object_hash, data)

    def hash_keys(self, padded, lengths, xp=np):
        """Batched hash_key over pre-packed (nspace-joined) name bytes."""
        return str_hash_batch(self.object_hash, padded, lengths, xp=xp)
