"""The port's churn simulator and osdmaptool, held against ceph_tpu's.

tests/test_churn.py's cases (CRUSH's rebalance properties under OSD
add/remove, BASELINE config #5) on ``ceph_tpu_torch.sim``; then the same
seeded ``random_thrash`` on both packages, report by report, and
osdmaptool's ``--test-map-pgs``, ``--churn`` and ``--upmap`` records
equal to ceph_tpu's, less the host-clock fields. The port maps on the
CPU (``device="cpu"``); counts are integers, compared exactly.
"""

import json

import numpy as np
import pytest

from ceph_tpu.bench import osdmaptool as ref_osdmaptool
from ceph_tpu.sim import ChurnSim as RefChurnSim
from ceph_tpu_torch.bench import osdmaptool
from ceph_tpu_torch.crush.types import ITEM_NONE, WEIGHT_ONE
from ceph_tpu_torch.sim import ChurnEvent, ChurnSim


def make_sim(n_osds=32, pg_num=256, size=3, erasure=False):
    m = osdmaptool.create_simple(n_osds, pg_num, size, erasure,
                                 device="cpu")
    return ChurnSim(m, 1)


class TestChurn:
    def test_out_moves_proportional_data(self):
        sim = make_sim()
        rep = sim.apply(ChurnEvent("out", 5))
        assert rep.degraded_pgs == 0
        assert 0 < rep.shards_moved < 3 * 256 * 0.15

    def test_down_then_revive_restores(self):
        sim = make_sim()
        before = sim._up.copy()
        sim.apply(ChurnEvent("down", 9))
        sim.apply(ChurnEvent("out", 9))
        sim.apply(ChurnEvent("in", 9))
        rep = sim.apply(ChurnEvent("up", 9))
        assert rep.degraded_pgs == 0
        assert (sim._up == before).all()

    def test_down_degrades_ec(self):
        sim = make_sim(erasure=True, size=5)
        victim = int(sim._up[0, 0])
        rep = sim.apply(ChurnEvent("down", victim))
        assert rep.degraded_pgs > 0
        rep2 = sim.apply(ChurnEvent("out", victim))
        assert rep2.degraded_pgs == 0

    def test_add_osd_rebalances_minimally(self):
        sim = make_sim()
        rep = sim.apply(ChurnEvent("add", 32, WEIGHT_ONE))
        assert 0 < rep.shards_moved < 3 * 256 * 0.12
        rep = sim.apply(ChurnEvent("rm", 32))
        assert rep.shards_moved > 0 and rep.degraded_pgs == 0

    def test_random_thrash_converges(self):
        sim = make_sim()
        sim.random_thrash(np.random.default_rng(7), 12)
        for o in range(sim.map.max_osd):
            sim.map.mark_up(o)
            sim.map.mark_in(o)
        up, _, _, _ = sim.map.map_pool(1)
        assert (up != ITEM_NONE).all()

    def test_summary_and_bad_event(self):
        sim = make_sim()
        sim.apply(ChurnEvent("out", 1))
        s = sim.summary()
        assert s["events"] == 1 and s["total_shards_moved"] > 0
        with pytest.raises(ValueError, match="unknown event"):
            sim.apply(ChurnEvent("explode", 1))


@pytest.mark.parametrize("erasure,size", [(False, 3), (True, 4)])
def test_random_thrash_reports_match_reference(erasure, size):
    """The same seeded thrash on both packages: every StepReport's
    pgs_remapped, shards_moved, degraded_pgs and primaries_changed."""
    mine = ChurnSim(osdmaptool.create_simple(16, 128, size, erasure,
                                             device="cpu"), 1)
    ref = RefChurnSim(ref_osdmaptool.create_simple(16, 128, size, erasure),
                      1)
    got = mine.random_thrash(np.random.default_rng(11), 6)
    want = ref.random_thrash(np.random.default_rng(11), 6)
    assert [r.to_dict() for r in got] == [r.to_dict() for r in want]
    assert mine.summary() == ref.summary()
    assert any(r.pgs_remapped for r in got)


_VOLATILE = ("seconds", "mappings_per_s")


def _strip(rec):
    if isinstance(rec, dict):
        return {k: _strip(v) for k, v in rec.items() if k not in _VOLATILE}
    if isinstance(rec, list):
        return [_strip(v) for v in rec]
    return rec


@pytest.mark.parametrize("argv", [
    ["--createsimple", "16", "--pg-num", "128", "--test-map-pgs"],
    ["--createsimple", "16", "--pg-num", "64", "--churn", "4",
     "--mark-down", "2"],
    ["--createsimple", "12", "--pg-num", "64", "--erasure", "--size", "3",
     "--test-map-pgs", "--churn", "3", "--seed", "5"],
    ["--createsimple", "16", "--pg-num", "128", "--upmap",
     "--upmap-deviation", "1", "--mark-out", "3"],
])
def test_osdmaptool_records_match_reference(argv, capsys):
    mine = osdmaptool.main([*argv, "--format", "json", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert ref_osdmaptool.main([*argv, "--format", "json"]) == 0
    ref = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(mine))
    assert _strip(printed) == _strip(ref)
    assert set(printed) - {"osds", "pg_num", "size", "pool_type"}
