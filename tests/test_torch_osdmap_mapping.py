"""The port's OSDMapMapping and lookup memo, held against ceph_tpu's.

Mirrors tests/test_osdmap_mapping.py's TestDeltaRemap and TestEpochCache
(less the mon, objecter and mesh cases) on ``ceph_tpu_torch``: after
every ``update`` the table equals a from-scratch sweep, and the cheap
delta paths are the ones taken. The seeded incremental stream runs on
both packages side by side: at every epoch the port's five tables equal
ceph_tpu's and a from-scratch sweep, and ``last_remap_pgs`` /
``last_full_sweep_pools`` equal ceph_tpu's, so a delta that silently
full-sweeps fails. The port maps on the CPU (``device="cpu"``).
Placement is integer: exact equality throughout.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.bench import osdmaptool as ref_osdmaptool
from ceph_tpu.osd.osdmap import Incremental as RefIncremental
from ceph_tpu.osd.osdmap_mapping import OSDMapMapping as RefMapping
from ceph_tpu.osd.types import PGPool as RefPool
from ceph_tpu.osd.types import pg_t as ref_pg
from ceph_tpu_torch.bench import osdmaptool
from ceph_tpu_torch.crush import builder
from ceph_tpu_torch.crush.types import WEIGHT_ONE
from ceph_tpu_torch.encoding import decode_osdmap, encode_osdmap
from ceph_tpu_torch.osd import osdmap as osdmap_mod
from ceph_tpu_torch.osd.osdmap import Incremental, OSDMap
from ceph_tpu_torch.osd.osdmap_mapping import OSDMapMapping
from ceph_tpu_torch.osd.types import PGPool, pg_t
from ceph_tpu_torch.utils.devmon import DeviceRuntimeMonitor

_TABLES = ("craw", "up", "up_primary", "acting", "acting_primary")


def _scratch(m: OSDMap, pid: int, seeds=None):
    """(craw, up, up_primary, acting, acting_primary) of a from-scratch
    sweep of ``seeds`` (default: the whole pool)."""
    pool = m.pools[pid]
    if seeds is None:
        seeds = np.arange(pool.pg_num, dtype=np.uint32)
    craw, pps = m.pg_to_crush_osds(pid, seeds)
    return (craw, *m._pipeline_from_crush(pool, seeds, craw, pps))


def _assert_matches_scratch(mm, m):
    assert mm.epoch == m.epoch
    assert set(mm._pools) == set(m.pools)
    for pid in m.pools:
        t = mm._pools[pid]
        for name, want in zip(_TABLES, _scratch(m, pid)):
            assert np.array_equal(getattr(t, name), want), (pid, name)


def _mk(n_osds=8, pg_num=16, size=3):
    m = osdmaptool.create_simple(n_osds, pg_num, size, erasure=False,
                                 device="cpu")
    return m, OSDMapMapping(m)


class TestDeltaRemap:
    def test_state_flip_is_delta(self):
        """up/down flips keep the raw table and sweep nothing."""
        m, mm = _mk()
        m.apply_incremental(Incremental(epoch=m.epoch + 1, new_down=[3]))
        mm.update(m)
        assert mm.last_full_sweep_pools == 0
        assert mm.last_remap_pgs > 0
        _assert_matches_scratch(mm, m)
        m.apply_incremental(Incremental(epoch=m.epoch + 1, new_up=[3]))
        mm.update(m)
        assert mm.last_full_sweep_pools == 0
        _assert_matches_scratch(mm, m)

    def test_weight_decrease_is_delta(self):
        """A partial decrease and a full out in one incremental: the rows
        holding either OSD re-run CRUSH; no full sweep."""
        m, mm = _mk()
        m.apply_incremental(Incremental(
            epoch=m.epoch + 1, new_weight={5: WEIGHT_ONE // 2, 3: 0}))
        mm.update(m)
        assert mm.last_full_sweep_pools == 0
        assert mm.last_remap_pgs > 0
        _assert_matches_scratch(mm, m)

    def test_weight_increase_full_sweeps_reachable_pools(self):
        m, mm = _mk()
        m.apply_incremental(Incremental(epoch=m.epoch + 1,
                                        new_weight={5: 0}))
        mm.update(m)
        m.apply_incremental(Incremental(epoch=m.epoch + 1,
                                        new_weight={5: WEIGHT_ONE}))
        mm.update(m)
        assert mm.last_full_sweep_pools == 1
        _assert_matches_scratch(mm, m)

    def test_weight_increase_skips_unreachable_pools(self):
        """The dirty-bucket gate: a pool whose rule's root cannot reach
        the reweighted OSD is not swept."""
        m, mm = _mk()
        hosts = [b.id for b in m.crush.buckets.values()
                 if b.type == builder.TYPE_HOST]
        rule = builder.add_simple_rule(m.crush, hosts[0], builder.TYPE_OSD)
        m._dirty(crush_changed=True)
        m.add_pool(PGPool(id=2, pg_num=8, size=2, crush_rule=rule))
        mm.update(m)
        far = m.crush.buckets[hosts[-1]].items[0]
        m.apply_incremental(Incremental(epoch=m.epoch + 1,
                                        new_weight={far: 0}))
        mm.update(m)
        m.apply_incremental(Incremental(epoch=m.epoch + 1,
                                        new_weight={far: WEIGHT_ONE}))
        mm.update(m)
        assert mm.last_full_sweep_pools == 1     # pool 1 only
        _assert_matches_scratch(mm, m)

    def test_overrides_are_delta(self):
        m, mm = _mk()
        pg = pg_t(1, 4)
        inc = Incremental(epoch=m.epoch + 1)
        inc.new_pg_temp[pg] = [1, 2, 3]
        inc.new_primary_temp[pg_t(1, 7)] = 2
        inc.new_pg_upmap_items[pg_t(1, 9)] = [(0, 8)]
        m.apply_incremental(inc)
        mm.update(m)
        assert mm.last_full_sweep_pools == 0
        assert mm.last_remap_pgs == 3      # exactly the named PGs
        _assert_matches_scratch(mm, m)
        inc = Incremental(epoch=m.epoch + 1)
        inc.new_pg_temp[pg] = []
        inc.old_pg_upmap_items.append(pg_t(1, 9))
        m.apply_incremental(inc)
        mm.update(m)
        assert mm.last_full_sweep_pools == 0
        _assert_matches_scratch(mm, m)

    def test_primary_affinity_is_delta(self):
        m, mm = _mk()
        m.set_primary_affinity(2, 0)
        mm.update(m)
        assert mm.last_full_sweep_pools == 0
        _assert_matches_scratch(mm, m)

    def test_crush_topology_change_full_sweeps(self):
        m, mm = _mk()
        host0 = [b.id for b in m.crush.buckets.values()
                 if b.type == builder.TYPE_HOST][0]
        new_osd = m.max_osd
        m.insert_crush_item(new_osd, WEIGHT_ONE, host0)
        mm.update(m)
        assert mm.last_full_sweep_pools >= 1
        _assert_matches_scratch(mm, m)
        m.remove_crush_item(new_osd)
        mm.update(m)
        assert mm.last_full_sweep_pools >= 1
        _assert_matches_scratch(mm, m)

    def test_pool_lifecycle(self):
        m, mm = _mk()
        m.add_pool(PGPool(id=2, pg_num=16, size=2, crush_rule=0,
                          name="two"))
        mm.update(m)
        assert 2 in mm._pools
        _assert_matches_scratch(mm, m)
        m.apply_incremental(Incremental(epoch=m.epoch + 1, old_pools=[2]))
        mm.update(m)
        assert 2 not in mm._pools
        _assert_matches_scratch(mm, m)

    def test_fresh_decode_delta_via_digest(self):
        """A holder that decodes a new OSDMap per epoch: identity breaks,
        the crush digest proves the tree unchanged, and a state flip
        still takes the delta path."""
        m, mm = _mk()
        m2 = decode_osdmap(encode_osdmap(m), device="cpu")
        m2.apply_incremental(Incremental(epoch=m2.epoch + 1, new_down=[1]))
        mm.update(m2)
        assert mm.last_full_sweep_pools == 0
        _assert_matches_scratch(mm, m2)
        # the same epoch again (the mgr's fetch): nothing is recomputed
        mm.update(decode_osdmap(encode_osdmap(m2), device="cpu"))
        assert (mm.last_full_sweep_pools, mm.last_remap_pgs) == (0, 0)

    def test_sweeps_report_their_engine(self):
        """Each full-pool sweep records its engine and a path check with
        the owner's devmon: the firstn pool on kernel-plain, an indep
        pool on the VM; no mismatch while the plan holds."""
        m = osdmaptool.create_simple(8, 16, 3, erasure=False, device="cpu")
        root = [b.id for b in m.crush.buckets.values()
                if b.type == builder.TYPE_ROOT][0]
        rule = builder.add_simple_rule(m.crush, root, builder.TYPE_HOST,
                                       indep=True)
        m._dirty(crush_changed=True)
        m.add_pool(PGPool(id=2, pg_num=8, size=4, type=3, crush_rule=rule))
        dm = DeviceRuntimeMonitor(name="devmon_t_mapping", register=False)
        mm = OSDMapMapping(m, devmon=dm)
        d = dm.perf.dump()
        assert (d["launches_kernel"], d["launches_vm"]) == (1, 1)
        assert d["path_checks"] == 2 and d["path_mismatch"] == 0
        _assert_matches_scratch(mm, m)


# -- the seeded stream, both packages ---------------------------------------

def _stream_inc(rng, m, Inc, pg):
    """One step of tests/test_osdmap_mapping.py's _run_stream: the kind
    and the Incremental, with the crush edit applied in place."""
    kind = int(rng.integers(0, 8))
    inc = Inc(epoch=m.epoch + 1)
    o = int(rng.integers(0, 12))
    if kind == 0:
        inc.new_down.append(o)
    elif kind == 1:
        inc.new_up.append(o)
    elif kind == 2:
        inc.new_weight[o] = int(rng.choice(
            [0, WEIGHT_ONE // 3, WEIGHT_ONE // 2, WEIGHT_ONE]))
    elif kind == 3:
        pid = int(rng.choice([1, 2]))
        p = pg(pid, int(rng.integers(0, m.pools[pid].pg_num)))
        if rng.integers(0, 2):
            inc.new_pg_temp[p] = [int(x) for x in
                                  rng.choice(12, size=3, replace=False)]
        else:
            inc.new_pg_temp[p] = []
    elif kind == 4:
        pid = int(rng.choice([1, 2]))
        p = pg(pid, int(rng.integers(0, m.pools[pid].pg_num)))
        if rng.integers(0, 2):
            inc.new_pg_upmap_items[p] = [(o, (o + 1) % 12)]
        else:
            inc.old_pg_upmap_items.append(p)
    elif kind == 5:
        inc.new_primary_affinity[o] = int(rng.choice([0, 0x8000, 0x10000]))
    elif kind == 6:
        inc.new_primary_temp[pg(1, int(rng.integers(0, 32)))] = \
            int(rng.integers(-1, 12))
    else:
        host = [b for b in m.crush.buckets.values()
                if b.type == builder.TYPE_HOST][int(rng.integers(0, 3))]
        slot = int(rng.integers(0, host.size))
        w = int(rng.choice([WEIGHT_ONE, 2 * WEIGHT_ONE]))
        if host.weights[slot] == w:
            w = 2 * WEIGHT_ONE if w == WEIGHT_ONE else WEIGHT_ONE
        host.weights[slot] = w
        m._dirty(crush_changed=True)
        m.epoch -= 1               # the incremental counts it
    return kind, inc


def test_randomized_incremental_stream_matches_reference():
    """tests/test_osdmap_mapping.py's _run_stream(10) on both packages:
    the same seeded incrementals, applied and updated step by step."""
    mine = osdmaptool.create_simple(12, 32, 3, erasure=False, device="cpu")
    ref = ref_osdmaptool.create_simple(12, 32, 3, erasure=False)
    mine.add_pool(PGPool(id=2, pg_num=16, size=2, crush_rule=0,
                         name="two"))
    ref.add_pool(RefPool(id=2, pg_num=16, size=2, crush_rule=0,
                         name="two"))
    mm, rm = OSDMapMapping(mine), RefMapping(ref)
    rng_m, rng_r = np.random.default_rng(321), np.random.default_rng(321)
    kinds = []
    for _ in range(10):
        kind, inc = _stream_inc(rng_m, mine, Incremental, pg_t)
        rkind, rinc = _stream_inc(rng_r, ref, RefIncremental, ref_pg)
        assert kind == rkind
        kinds.append(kind)
        mine.apply_incremental(inc)
        ref.apply_incremental(rinc)
        mm.update(mine)
        rm.update(ref)
        assert mine.epoch == ref.epoch
        assert (mm.last_remap_pgs, mm.last_full_sweep_pools) == \
            (rm.last_remap_pgs, rm.last_full_sweep_pools), kind
        if kind == 7:
            assert mm.last_full_sweep_pools >= 1
        elif kind != 2:
            assert mm.last_full_sweep_pools == 0
        _assert_matches_scratch(mm, mine)
        for pid in mine.pools:
            for name in _TABLES:
                assert np.array_equal(getattr(mm._pools[pid], name),
                                      np.asarray(getattr(rm._pools[pid],
                                                         name))), \
                    (pid, name)
    assert 7 in kinds and len(set(kinds)) >= 5


# -- the memo --------------------------------------------------------------

class TestEpochCache:
    def test_scalar_memo_hits_and_epoch_invalidation(self):
        m, _ = _mk()
        m.mapping_cache_hits = m.mapping_cache_misses = 0
        before = osdmap_mod.PERF.dump()["mapping_cache_hits"]
        a1 = m.pg_to_up_acting_osds(1, [5])
        assert m.mapping_cache_misses == 1
        a2 = m.pg_to_up_acting_osds(1, [5])
        assert m.mapping_cache_hits == 1
        assert osdmap_mod.PERF.dump()["mapping_cache_hits"] == before + 1
        for x, y in zip(a1, a2):
            assert np.array_equal(x, y)
        m.mark_down(3)
        m.pg_to_up_acting_osds(1, [5])
        assert m.mapping_cache_misses == 2

    def test_memo_serves_no_crush_launch(self, monkeypatch):
        """A memo hit does not enter the Mapper."""
        m, _ = _mk()
        m.pg_to_up_acting_osds(1, [5, 6])
        calls = []
        mp = m.serving_mapper(1)
        real = mp.map_pgs_path
        monkeypatch.setattr(mp, "map_pgs_path",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        m.pg_to_up_acting_osds(1, [6, 5])
        assert calls == []
        m.pg_to_up_acting_osds(1, [7])
        assert calls == [1]

    def test_memo_never_serves_across_incremental(self):
        m, _ = _mk()
        up_a, _, _, _ = m.pg_to_up_acting_osds(1, [5])
        osd = int(up_a[0][0])
        m.apply_incremental(Incremental(epoch=m.epoch + 1, new_down=[osd]))
        up_b, _, _, _ = m.pg_to_up_acting_osds(1, [5])
        assert osd not in list(up_b[0])

    def test_attached_mapping_serves_bulk(self):
        m, mm = _mk()
        m.attach_mapping(mm)
        m.mapping_cache_hits = 0
        npg = m.pools[1].pg_num
        up, upp, acting, actp = m.map_pool(1)
        assert m.mapping_cache_hits == npg
        _, u2, up2, a2, ap2 = _scratch(m, 1)
        assert np.array_equal(up, u2) and np.array_equal(actp, ap2)
        m.mark_down(1)
        m.mapping_cache_hits = 0
        m.map_pool(1)
        assert m.mapping_cache_hits == 0
        mm.update(m)
        m.mapping_cache_hits = 0
        m.map_pool(1)
        assert m.mapping_cache_hits == npg

    def test_lookup_returns_copies(self):
        m, mm = _mk()
        m.attach_mapping(mm)
        up, _, _, _ = m.map_pool(1)
        up[:] = -7
        up2, _, _, _ = m.map_pool(1)
        assert not np.array_equal(up, up2)

    def test_calc_pg_upmaps_on_the_table_matches(self):
        """The balancer reads the attached table's raw rows and comes to
        the same upmaps as without it."""
        plain, _ = _mk(12, 64)
        tabled, mm = _mk(12, 64)
        tabled.attach_mapping(mm)
        for om in (plain, tabled):
            om.set_weight(4, WEIGHT_ONE // 3)
        mm.update(tabled)
        n_plain = plain.calc_pg_upmaps(max_deviation=1)
        n_tabled = tabled.calc_pg_upmaps(max_deviation=1)
        assert n_plain == n_tabled > 0
        assert plain.pg_upmap_items == tabled.pg_upmap_items


def test_entry_points_need_cuda_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        osdmaptool.main(["--createsimple", "8", "--pg-num", "16"])
    m = osdmaptool.create_simple(8, 16, 3, erasure=False, device="cpu")
    blob = encode_osdmap(m)
    with pytest.raises(RuntimeError, match="CUDA"):
        OSDMapMapping(decode_osdmap(blob))
    assert OSDMapMapping(decode_osdmap(blob, device="cpu")).epoch == m.epoch
    assert osdmaptool.main(["--createsimple", "8", "--pg-num", "16",
                            "--device", "cpu"])["map_pgs"]["avg"] > 0
