"""Placement across epochs on the card: OSDMapMapping against a
from-scratch sweep, and every CRUSH kernel launch against its plain
version.

Every test here needs a CUDA device and skips without one. The file
imports no jax, so on a machine with a GPU and no JAX it runs without
``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_mapping.py -q

Placement is integer, so the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from ceph_tpu_torch.bench import crush_sweep
from ceph_tpu_torch.crush import builder, kernels
from ceph_tpu_torch.crush.types import (
    WEIGHT_ONE, crush_map_from_state, crush_map_state,
)
from ceph_tpu_torch.osd.osdmap import Incremental, OSDMap
from ceph_tpu_torch.osd.osdmap_mapping import OSDMapMapping
from ceph_tpu_torch.osd.types import POOL_TYPE_ERASURE, PGPool, pg_t
from ceph_tpu_torch.utils.devmon import DeviceRuntimeMonitor

pytestmark = pytest.mark.cuda
_TABLES = ("craw", "up", "up_primary", "acting", "acting_primary")


@pytest.fixture
def checked_launches(monkeypatch):
    """Every crush_straw2 launch held against crush_straw2_plain on the
    same plan and lanes; yields the list of launch widths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    real = kernels.crush_straw2
    widths = []

    def checked(pt, xs, numrep):
        leaves, bad = real(pt, xs, numrep)
        plain, plain_bad = kernels.crush_straw2_plain(pt, xs, numrep)
        assert torch.equal(leaves, plain) and torch.equal(bad, plain_bad)
        widths.append(int(xs.shape[0]))
        return leaves, bad
    monkeypatch.setattr(kernels, "crush_straw2", checked)
    return widths


def _assert_matches_scratch(mm, m):
    assert mm.epoch == m.epoch
    for pid, pool in m.pools.items():
        seeds = np.arange(pool.pg_num, dtype=np.uint32)
        craw, pps = m.pg_to_crush_osds(pid, seeds)
        want = (craw, *m._pipeline_from_crush(pool, seeds, craw, pps))
        for name, w in zip(_TABLES, want):
            assert np.array_equal(getattr(mm._pools[pid], name), w), \
                (pid, name)


def test_mapping_stream_on_card_matches_scratch(checked_launches):
    """640 OSDs (40 hosts), a size-3 pool on the kernel and a k=4 m=2
    pool on the VM; 16 seeded incrementals of every kind."""
    crush = crush_sweep.canonical_map(640)
    root = crush.rules[0].steps[0].arg1
    ec_rule = builder.add_simple_rule(crush, root, builder.TYPE_HOST,
                                      indep=True)
    m = OSDMap(crush, device="cuda")
    m.add_pool(PGPool(id=1, pg_num=4096, size=3, crush_rule=0))
    m.add_pool(PGPool(id=2, pg_num=1024, size=6, type=POOL_TYPE_ERASURE,
                      crush_rule=ec_rule))
    dm = DeviceRuntimeMonitor(name="devmon_t_cuda_mapping", register=False)
    mm = OSDMapMapping(m, devmon=dm)
    assert checked_launches == [4096]
    rng = np.random.default_rng(17)
    kinds = ["down", "out", "pg_temp", "affinity", "upmap", "reweight",
             "up", "in", "primary_temp", "crush", "down", "out",
             "pg_temp_rm", "upmap_rm", "up", "in"]
    victims = []
    for kind in kinds:
        inc = Incremental(epoch=m.epoch + 1)
        o = int(rng.integers(0, 640))
        pg = pg_t(int(rng.integers(1, 3)), int(rng.integers(0, 1024)))
        if kind == "down":
            victims.append(o)
            inc.new_down.append(o)
        elif kind == "up":
            inc.new_up.append(victims[-1])
        elif kind == "out":
            inc.new_weight[victims[-1]] = 0
        elif kind == "in":
            inc.new_weight[victims.pop()] = WEIGHT_ONE
        elif kind == "reweight":
            inc.new_weight[o] = WEIGHT_ONE // 3
        elif kind == "pg_temp":
            inc.new_pg_temp[pg_t(1, 7)] = [int(x) for x in
                                           rng.choice(640, 3, replace=False)]
        elif kind == "pg_temp_rm":
            inc.new_pg_temp[pg_t(1, 7)] = []
        elif kind == "primary_temp":
            inc.new_primary_temp[pg] = o
        elif kind == "upmap":
            inc.new_pg_upmap_items[pg_t(2, 9)] = [
                (int(mm._pools[2].up[9][0]), o)]
        elif kind == "upmap_rm":
            inc.old_pg_upmap_items.append(pg_t(2, 9))
        elif kind == "affinity":
            inc.new_primary_affinity[o] = 0
        else:
            edited = crush_map_from_state(crush_map_state(m.crush))
            builder.adjust_item_weight(edited, o, 2 * WEIGHT_ONE)
            inc.new_crush = edited
        before = len(checked_launches)
        m.apply_incremental(inc)
        mm.update(m)
        runs = checked_launches[before:]
        if kind in ("in", "crush"):
            assert mm.last_full_sweep_pools == 2, kind
        else:
            assert mm.last_full_sweep_pools == 0, kind
        if kind in ("out", "reweight"):
            # one ragged re-run of the rows holding the OSD
            assert len(runs) == 1 and 0 < runs[0] < 4096, (kind, runs)
        elif kind not in ("in", "crush"):
            assert runs == [], (kind, runs)
        _assert_matches_scratch(mm, m)
    d = dm.perf.dump()
    assert d["path_mismatch"] == 0 and d["launches_kernel"] >= 4
    assert all(mp.kernel_quarantine_info() is None
               for mp in m._mappers.values())
