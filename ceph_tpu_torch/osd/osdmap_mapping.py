"""Full-cluster PG->OSD mapping table, maintained across epochs.

ref: src/osd/OSDMapMapping.h (OSDMapMapping / ParallelPGMapper) — the
reference keeps a whole-cluster pg->(up, acting) table beside the
OSDMap and rebuilds it, sharded over a work queue, on every new map.
The port of ``ceph_tpu/osd/osdmap_mapping.py``. Here the rebuild itself
is already one batched device sweep per pool (OSDMap.pg_to_crush_osds:
the ``crush_straw2`` kernel for a firstn straw2 rule, the rule VM
otherwise, both on the card), so the win worth chasing is ACROSS epochs:
most incrementals touch a handful of OSDs or override entries, and the
affected-PG set is computable from the delta — remap only those seeds
instead of the whole cluster.

What each kind of map change invalidates (the delta algebra):

- **up/down/exists flips, primary affinity** — CRUSH never consults
  them (they act in the post-CRUSH pipeline), so the cached raw CRUSH
  table stays valid and the affected seeds are EXACTLY the rows whose
  raw output contains a flipped OSD; those rows replay only the cheap
  numpy pipeline.
- **reweight DECREASE (incl. mark_out)** — is_out acceptance of osd o
  is monotone in o's weight and consulted only when o is drawn, so an
  execution diverges iff o was accepted before and is rejected now:
  every affected seed has o in its OLD raw output. Those rows re-run
  CRUSH (the raw rows change), everything else is provably untouched.
- **reweight INCREASE (mark_in/revive)** — a PG that previously
  rejected o may newly accept it without o appearing anywhere in the
  old table, so the affected set is not recoverable from cached state:
  full sweep, gated to the pools whose rule root can reach a changed
  OSD (dirty buckets -> dirty pools).
- **pg_temp / primary_temp / pg_upmap / pg_upmap_items** — named PGs
  only; pipeline replay. Conversely, a state/weight/affinity change of
  an OSD that appears only INSIDE such an override (upmap target,
  pg_temp member — invisible in the raw CRUSH table) dirties exactly
  the rows carrying that override.
- **crush topology edits, max_osd, pool placement params (pg_num,
  pgp_num, size, rule, hashpspool)** — full sweep fallback (per pool
  for pool-param changes, cluster-wide for crush/max_osd).
- **flags, blocklist, up_thru, addrs, quotas** — no placement effect;
  explicitly ignored.

``update`` diffs the map against snapshots taken at the previous
update rather than trusting an Incremental, so it is correct for any
mutation path (mon-applied incrementals, direct mark_down in tests,
thrasher churn). Crush-change detection: object identity +
``OSDMap.crush_version`` when the same map object evolves in place,
falling back to an encoded-map digest when the holder decodes a fresh
OSDMap per epoch (the mon does).

An updated mapping attached via ``OSDMap.attach_mapping`` serves every
``pg_to_up_acting_osds`` call at its epoch — bulk and scalar — without
re-entering the mapper; ``OSDMap.calc_pg_upmaps`` additionally reuses
the raw CRUSH table for its candidate probes.

The tables are host numpy: lookups serve host callers, and only the
CRUSH step of a sweep or a delta re-run goes to the card.

Invariant (tested by tests/test_torch_osdmap_mapping.py, against
ceph_tpu's table as well): after ``update``, every pool table is
byte-identical to a from-scratch ``pg_to_crush_osds`` +
``_pipeline_from_crush`` sweep of the same map.

With a device mesh (``mesh``/``mesh_min_batch``, attached to every map
the table updates against) full-pool sweeps run sharded
(``crush.sharded_sweep``), counted in ``last_sharded_sweeps`` and the
``remap_sharded_sweeps`` perf counter. With a ``tracer`` every full-pool
sweep emits a ``crush_sweep`` span.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ceph_tpu_torch.osd.osdmap import OSDMap, PERF, STATE_EXISTS, STATE_UP
from ceph_tpu_torch.osd.types import FLAG_HASHPSPOOL


def _pool_sig(pool) -> tuple:
    """The placement-relevant pool fields: any change here means the
    pool's table must be rebuilt (quota/name/etc churn must NOT)."""
    return (pool.pg_num, pool.pgp_num, pool.size, pool.crush_rule,
            pool.type, pool.object_hash,
            pool.flags & FLAG_HASHPSPOOL)


class _PoolTable:
    __slots__ = ("craw", "pps", "up", "up_primary", "acting",
                 "acting_primary", "sig")


class OSDMapMapping:
    """Per-pool pg->(raw CRUSH, up, up_primary, acting, acting_primary)
    arrays at one epoch, plus the snapshots the delta diff needs."""

    def __init__(self, osdmap: OSDMap | None = None, mesh=None,
                 mesh_min_batch: int | None = None, tracer=None,
                 devmon=None):
        self.epoch = -1
        # optional device mesh: attached to every map this table updates
        # against, so full-pool sweeps (the crush-topology-change
        # fallback) run the mesh-sharded sweep instead of one device
        self.mesh = mesh
        self.mesh_min_batch = mesh_min_batch
        # optional utils.tracing.Tracer: bulk sweeps emit a
        # `crush_sweep` span (n_pgs/path/n_devices tags) so sweep cost
        # shows up in `trace show` instead of as opaque mapper time
        self.tracer = tracer
        # optional utils.devmon.DeviceRuntimeMonitor: the owning daemon's
        # monitor. Every full-pool sweep records its per-call engine
        # (launches by path) and an expected-vs-actual check, so a daemon
        # serving CRUSH off its expected kernel path is a counted fact
        self.devmon = devmon
        self._pools: dict[int, _PoolTable] = {}
        self._osd_weight = None
        self._osd_state = None
        self._osd_aff = None
        self._max_osd = -1
        self._pg_temp: dict = {}
        self._primary_temp: dict = {}
        self._pg_upmap: dict = {}
        self._pg_upmap_items: dict = {}
        # strong reference on purpose: identity-based crush-change
        # detection must never compare against the id() of a freed
        # object (CPython reuses addresses after GC)
        self._crush_obj = None
        self._crush_version = -1
        self._crush_digest: bytes | None = None
        # last-update stats (bench/tests/asok)
        self.last_remap_pgs = 0
        self.last_full_sweep_pools = 0
        self.last_sharded_sweeps = 0
        if osdmap is not None:
            self.update(osdmap)

    # -- serving -----------------------------------------------------
    def serves(self, osdmap: OSDMap, pool_id: int) -> bool:
        return (self.epoch == osdmap.epoch
                and pool_id in self._pools)

    def lookup(self, pool_id: int, seeds):
        """(up, up_primary, acting, acting_primary) rows for ``seeds``
        — copies, so callers may scribble on them."""
        t = self._pools[pool_id]
        idx = np.asarray(seeds, dtype=np.int64)
        return (t.up[idx].copy(), t.up_primary[idx].copy(),
                t.acting[idx].copy(), t.acting_primary[idx].copy())

    def crush_raw(self, pool_id: int) -> np.ndarray | None:
        """The cached pure-CRUSH table for a pool (READ-ONLY; row i is
        seed i). The balancer replays the post-CRUSH pipeline over it
        for its candidate probes."""
        t = self._pools.get(pool_id)
        return t.craw if t is not None else None

    # -- maintenance -------------------------------------------------
    def _crush_changed(self, osdmap: OSDMap) -> tuple[bool, bytes]:
        """(changed, digest) — identity match implies unchanged
        content (crush_version bumps on every in-place edit), so the
        stored digest is reused; the digest computed on an ident miss
        is returned for the snapshot to keep, never recomputed."""
        if osdmap.crush is self._crush_obj \
                and osdmap.crush_version == self._crush_version:
            return False, self._crush_digest
        # a different object (or an in-place edit): compare content
        digest = self._digest(osdmap)
        return digest != self._crush_digest, digest

    @staticmethod
    def _digest(osdmap: OSDMap) -> bytes:
        from ceph_tpu_torch.encoding import encode_crush_map
        return hashlib.sha1(encode_crush_map(osdmap.crush)).digest()

    def _sweep_pool(self, osdmap: OSDMap, pid: int) -> None:
        pool = osdmap.pools[pid]
        seeds = np.arange(pool.pg_num, dtype=np.uint32)
        span = self.tracer.start_root(
            "crush_sweep", tags={
                "n_pgs": int(pool.pg_num), "pool": int(pid),
                "n_devices": self.mesh.size if self.mesh is not None
                else 1,
            }) if self.tracer is not None else None
        path = expected = None
        ok = False
        try:
            craw, pps, (expected, path) = \
                osdmap.pg_to_crush_osds_path(pid, seeds)
            ok = True
        finally:
            # a failed sweep lands in the trace buffer too; the engine
            # tag is this call's returned path
            if span is not None:
                span.tag("path", (path or "?") if ok else "error")
                span.finish()
        craw = np.array(craw)    # writable: delta remap patches rows
        if self.devmon is not None:
            # per-daemon kernel-path health: engine launch counter +
            # expected-vs-actual (the devmon_expected_engine knob pins
            # the deployment contract; 'auto' trusts the plan)
            self.devmon.record_sweep(expected, path)
        if path is not None and path.endswith("+sharded"):
            PERF.inc("remap_sharded_sweeps")
            self.last_sharded_sweeps += 1
        up, upp, acting, actp = osdmap._pipeline_from_crush(
            pool, seeds, craw, pps)
        t = _PoolTable()
        t.craw, t.pps = craw, np.array(pps)
        t.up, t.up_primary = up, upp
        t.acting, t.acting_primary = acting, actp
        t.sig = _pool_sig(pool)
        self._pools[pid] = t
        PERF.inc("remap_full_sweeps")
        self.last_full_sweep_pools += 1

    def _rule_devices(self, osdmap: OSDMap, ruleno: int,
                      memo: dict) -> set:
        """All device ids reachable from the rule's TAKE roots
        (the dirty-bucket -> dirty-pool gate for weight increases)."""
        from ceph_tpu_torch.crush.types import OP_TAKE
        crush = osdmap.crush
        out: set[int] = set()

        def walk(item: int) -> set:
            if item >= 0:
                return {item}
            if item in memo:
                return memo[item]
            memo[item] = set()          # cycle guard
            b = crush.buckets.get(item)
            acc: set[int] = set()
            if b is not None:
                for c in b.items:
                    acc |= walk(c)
            memo[item] = acc
            return acc

        rule = crush.rules.get(ruleno) if isinstance(crush.rules, dict) \
            else (crush.rules[ruleno] if ruleno < len(crush.rules)
                  else None)
        if rule is None:
            return out
        for s in rule.steps:
            if s.op == OP_TAKE:
                out |= walk(s.arg1)
        return out

    def _snapshot(self, osdmap: OSDMap, crush_digest: bytes) -> None:
        self._osd_weight = np.asarray(osdmap.osd_weight).copy()
        self._osd_state = np.asarray(osdmap.osd_state).copy()
        self._osd_aff = np.asarray(osdmap.osd_primary_affinity).copy()
        self._max_osd = osdmap.max_osd
        self._pg_temp = {pg: list(v)
                         for pg, v in osdmap.pg_temp.items()}
        self._primary_temp = dict(osdmap.primary_temp)
        self._pg_upmap = {pg: tuple(v)
                          for pg, v in osdmap.pg_upmap.items()}
        self._pg_upmap_items = {pg: [tuple(p) for p in v]
                                for pg, v in
                                osdmap.pg_upmap_items.items()}
        self._crush_obj = osdmap.crush
        self._crush_version = osdmap.crush_version
        self._crush_digest = crush_digest
        self.epoch = osdmap.epoch

    @staticmethod
    def _changed_pgs(old: dict, new: dict, norm=None) -> set:
        """Keys whose value differs; ``norm`` compares values through a
        normalizer (list-of-pairs overrides arrive as lists OR tuples
        depending on the mutation path) without building full
        normalized copies of either dict."""
        keys = set(old) | set(new)
        if norm is None:
            return {pg for pg in keys if old.get(pg) != new.get(pg)}
        changed = set()
        for pg in keys:
            o, nv = old.get(pg), new.get(pg)
            if o is None or nv is None:
                if o is not nv:
                    changed.add(pg)
            elif norm(o) != norm(nv):
                changed.add(pg)
        return changed

    def update(self, osdmap: OSDMap) -> None:
        """Bring the table to ``osdmap``'s epoch: delta remap when the
        diff allows it, full (per-pool) sweep fallback otherwise."""
        self.last_remap_pgs = 0
        self.last_full_sweep_pools = 0
        self.last_sharded_sweeps = 0
        if self.mesh is not None:
            # decode-fresh maps (the mgr's, per fetch) never carry the
            # mesh themselves; the table re-attaches it every update
            osdmap.attach_mesh(self.mesh, self.mesh_min_batch)
        if self.epoch == osdmap.epoch and self._osd_weight is not None:
            # Same epoch as the last update: every placement mutation
            # bumps the epoch (OSDMap._dirty — the invariant the
            # caches rest on), so content is unchanged even when the
            # holder decoded a fresh object (the mgr per fetch) — no
            # digest, no diff scan, no snapshot copies.
            return
        digest = None
        if (self._osd_weight is None
                or self._max_osd != osdmap.max_osd
                or len(self._osd_weight) != osdmap.max_osd):
            full = True
        else:
            full, digest = self._crush_changed(osdmap)
        # pools: removed -> drop; new/param-changed -> full pool sweep
        for pid in [p for p in self._pools if p not in osdmap.pools]:
            del self._pools[pid]
        swept: set[int] = set()
        for pid, pool in osdmap.pools.items():
            t = self._pools.get(pid)
            if full or t is None or t.sig != _pool_sig(pool):
                self._sweep_pool(osdmap, pid)
                swept.add(pid)
        if not full:
            self._delta_remap(osdmap, swept)
        if digest is None:
            digest = self._digest(osdmap)
        self._snapshot(osdmap, digest)

    def _delta_remap(self, osdmap: OSDMap, swept: set) -> None:
        w_old, w_new = self._osd_weight, np.asarray(osdmap.osd_weight)
        n = min(len(w_old), len(w_new))
        dec = np.flatnonzero(w_new[:n] < w_old[:n])
        inc = np.flatnonzero(w_new[:n] > w_old[:n])
        plumb = (STATE_UP | STATE_EXISTS)
        st = np.flatnonzero(
            (self._osd_state[:n] ^ np.asarray(osdmap.osd_state)[:n])
            & plumb)
        aff = np.flatnonzero(
            self._osd_aff[:n]
            != np.asarray(osdmap.osd_primary_affinity)[:n])
        # weight INCREASE: the affected set is not recoverable from the
        # old table (newly-accepting PGs never held the OSD) — full
        # sweep, but only for pools whose rule can reach a changed OSD
        if inc.size:
            inc_set = set(int(o) for o in inc)
            memo: dict = {}
            for pid, pool in osdmap.pools.items():
                if pid in swept:
                    continue
                if inc_set & self._rule_devices(osdmap,
                                                pool.crush_rule, memo):
                    self._sweep_pool(osdmap, pid)
                    swept.add(pid)
        # per-pg override deltas
        temp_dirty = (self._changed_pgs(
            self._pg_temp, osdmap.pg_temp)
            | self._changed_pgs(self._primary_temp,
                                osdmap.primary_temp)
            | self._changed_pgs(self._pg_upmap, osdmap.pg_upmap)
            | self._changed_pgs(self._pg_upmap_items,
                                osdmap.pg_upmap_items,
                                norm=lambda v: [tuple(p) for p in v]))
        crush_touch = np.asarray(dec, dtype=np.int64)
        pipe_touch = np.concatenate([st, aff]).astype(np.int64)
        # every osd whose state/weight/affinity moved at all: override
        # entries (upmap targets, pg_temp members) can name OSDs that
        # never appear in the raw CRUSH output, so rows carrying such
        # an override are scanned against this set separately
        touched_any = set(int(o) for o in dec) | \
            set(int(o) for o in inc) | \
            set(int(o) for o in st) | set(int(o) for o in aff)
        # one pass over each cluster-wide override dict, grouped by
        # pool — the per-pool loop must stay O(delta), not rescan
        # every override entry once per pool
        dirty_by_pool: dict[int, set] = {}
        for pg in temp_dirty:
            dirty_by_pool.setdefault(pg.pool, set()).add(pg.seed)
        if touched_any:
            for pg, tgt in osdmap.pg_upmap.items():
                if touched_any.intersection(int(o) for o in tgt):
                    dirty_by_pool.setdefault(
                        pg.pool, set()).add(pg.seed)
            for pg, prs in osdmap.pg_upmap_items.items():
                if any(int(f) in touched_any or int(to) in touched_any
                       for f, to in prs):
                    dirty_by_pool.setdefault(
                        pg.pool, set()).add(pg.seed)
            for pg, osds in osdmap.pg_temp.items():
                if touched_any.intersection(int(o) for o in osds):
                    dirty_by_pool.setdefault(
                        pg.pool, set()).add(pg.seed)
            for pg, p in osdmap.primary_temp.items():
                if int(p) in touched_any:
                    dirty_by_pool.setdefault(
                        pg.pool, set()).add(pg.seed)
        for pid, pool in osdmap.pools.items():
            if pid in swept:
                continue
            t = self._pools[pid]
            # rows whose RAW output intersects the touched OSD sets
            crush_rows = np.flatnonzero(
                np.isin(t.craw, crush_touch).any(axis=1)) \
                if crush_touch.size else np.empty(0, dtype=np.int64)
            pipe_rows = np.flatnonzero(
                np.isin(t.craw, pipe_touch).any(axis=1)) \
                if pipe_touch.size else np.empty(0, dtype=np.int64)
            dirty_pgs = {s for s in dirty_by_pool.get(pid, ())
                         if s < pool.pg_num}
            pg_rows = np.asarray(sorted(dirty_pgs), dtype=np.int64)
            if crush_rows.size:
                seeds = crush_rows.astype(np.uint32)
                new_raw, _pps = osdmap.pg_to_crush_osds(pid, seeds)
                t.craw[crush_rows] = new_raw
            rows = np.unique(np.concatenate(
                [crush_rows, pipe_rows, pg_rows]))
            if not rows.size:
                continue
            seeds = rows.astype(np.uint32)
            up, upp, acting, actp = osdmap._pipeline_from_crush(
                pool, seeds, t.craw[rows], t.pps[rows])
            t.up[rows] = up
            t.up_primary[rows] = upp
            t.acting[rows] = acting
            t.acting_primary[rows] = actp
            PERF.inc("remap_pgs", int(rows.size))
            self.last_remap_pgs += int(rows.size)
