"""The port's OSDMap placement and crushtool held against ceph_tpu's.

Both OSDMaps get the same CRUSH map (built by ``ceph_tpu.crush.builder``,
carried across with ``crush_map_from_state``), the same pools and the
same overrides; the port maps on the CPU (``device="cpu"``), ceph_tpu on
JAX's CPU backend. Placement is integer: exact equality throughout.
"""

import dataclasses
import importlib
import json

import numpy as np
import pytest

from ceph_tpu.bench import crushtool as ref_crushtool
from ceph_tpu.crush import builder, mapper_ref
from ceph_tpu.crush.types import ITEM_NONE, WEIGHT_ONE
from ceph_tpu.osd.osdmap import OSDMap as RefOSDMap
from ceph_tpu.osd.types import PGPool as RefPool
from ceph_tpu.osd.types import pg_t as ref_pg
from ceph_tpu_torch.bench import crushtool
from ceph_tpu_torch.crush.types import crush_map_from_state
from ceph_tpu_torch.osd import str_hash
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osd.types import POOL_TYPE_ERASURE, PGPool, pg_t

W = WEIGHT_ONE
# (ceph_tpu.osd re-exports a str_hash function under the module's name)
ref_sh = importlib.import_module("ceph_tpu.osd.str_hash")


def _crush(indep=False):
    m, root = builder.build_hierarchy(8, 4, n_racks=2)
    builder.add_simple_rule(m, root, builder.TYPE_HOST)
    builder.add_simple_rule(m, root, builder.TYPE_HOST, indep=True)
    return m


def _pair(pg_num=256):
    ref_crush = _crush()
    mine = OSDMap(crush_map_from_state(dataclasses.asdict(ref_crush)),
                  device="cpu")
    ref = RefOSDMap(ref_crush)
    for om, Pool in ((mine, PGPool), (ref, RefPool)):
        om.add_pool(Pool(id=1, pg_num=pg_num, size=3, crush_rule=0))
        om.add_pool(Pool(id=2, pg_num=pg_num // 2, size=4, crush_rule=1,
                         type=POOL_TYPE_ERASURE))
    return mine, ref


def _same(mine, ref, pool, seeds):
    a = mine.pg_to_up_acting_osds(pool, seeds)
    b = ref.pg_to_up_acting_osds(pool, seeds)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    return a


@pytest.mark.parametrize("algo", [ref_sh.CEPH_STR_HASH_RJENKINS,
                                  ref_sh.CEPH_STR_HASH_LINUX])
def test_str_hash(algo):
    rng = np.random.default_rng(algo)
    names = [bytes(rng.integers(1, 255, size=int(n), dtype=np.uint8))
             for n in rng.integers(0, 40, size=64)]
    names += [b"", b"rbd_data.1234", b"x" * 12, bytes(range(256))]
    for n in names:
        assert str_hash.str_hash(algo, n) == ref_sh.str_hash(algo, n)
    padded, lens = str_hash.pack_names(names)
    assert np.array_equal(str_hash.str_hash_batch(algo, padded, lens),
                          ref_sh.str_hash_batch(algo, padded, lens))


def test_pg_to_up_acting_with_overrides():
    mine, ref = _pair()
    seeds = np.arange(256)
    _same(mine, ref, 1, seeds)
    _same(mine, ref, 2, seeds[:128])
    for om, pg in ((mine, pg_t), (ref, ref_pg)):
        om.mark_down(3)
        om.mark_out(9)
        om.set_weight(12, W // 2)
        om.set_primary_affinity(5, 0)
        om.set_primary_affinity(20, W // 4)
        om.pg_upmap_items[pg(1, 7)] = [(0, 31)]
        om.pg_upmap_items[pg(1, 40)] = [(5, 6), (17, 30)]
        om.pg_upmap[pg(1, 11)] = (1, 14, 22)
        om.pg_temp[pg(1, 19)] = [2, 6, 10]
        om.primary_temp[pg(1, 23)] = 27
        om.pg_temp[pg(2, 4)] = [ITEM_NONE, 8, 16, 24]
    assert mine.epoch == ref.epoch
    up, upp, act, actp = _same(mine, ref, 1, seeds)
    assert not (up == 3).any() and not (up == 9).any()
    _same(mine, ref, 2, seeds[:128])
    _same(mine, ref, 1, [7, 11, 19, 23, 40])
    assert mine.pg_to_crush_osds_path(1, seeds)[2] == ("kernel-plain",) * 2
    assert mine.pg_to_crush_osds_path(2, seeds)[2] == ("vm",) * 2


def test_pg_to_up_matches_scalar_pipeline():
    """The CRUSH half against mapper_ref, the rest through the same
    post-CRUSH pipeline."""
    mine, _ = _pair(pg_num=128)
    mine.mark_out(6)
    pool = mine.pools[1]
    seeds = np.arange(128, dtype=np.uint32)
    pps = pool.raw_pg_to_pps(seeds)
    w = mine._device_weights().tolist()
    raw = np.full((128, 3), ITEM_NONE, dtype=np.int32)
    for i, x in enumerate(pps):
        got = mapper_ref.do_rule(mine.crush, pool.crush_rule, int(x), 3, w)
        raw[i, :len(got)] = got
    want = mine._pipeline_from_crush(pool, seeds, raw, pps)
    got = mine.pg_to_up_acting_osds(1, seeds)
    for x, y in zip(got, want):
        assert np.array_equal(x, y)


def test_calc_pg_upmaps_matches_reference():
    mine, ref = _pair(pg_num=128)
    for om in (mine, ref):
        om.set_weight(4, W // 3)
    n_mine = mine.calc_pg_upmaps(pool_ids=[1], max_deviation=1)
    n_ref = ref.calc_pg_upmaps(pool_ids=[1], max_deviation=1)
    assert n_mine == n_ref > 0
    assert {(p.pool, p.seed): v for p, v in mine.pg_upmap_items.items()} \
        == {(p.pool, p.seed): v for p, v in ref.pg_upmap_items.items()}
    _same(mine, ref, 1, np.arange(128))


def test_osdmap_needs_cuda_unless_asked_for_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    om = OSDMap(crush_map_from_state(dataclasses.asdict(_crush())))
    om.add_pool(PGPool(id=1, pg_num=8, size=3))
    with pytest.raises(RuntimeError, match="CUDA"):
        om.pg_to_up_acting_osds(1, np.arange(8))


_VOLATILE = ("seconds", "mappings_per_second", "path")


def test_crushtool_json_matches_reference(capsys):
    argv = ["--build", "--num-osds", "24", "--hosts", "6", "--test",
            "--num-rep", "3", "--max-x", "255", "--weight", "3", "0.5"]
    mine = crushtool.main([*argv, "--json", "--device", "cpu"])
    mine_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ref = ref_crushtool.main([*argv, "--json"])
    capsys.readouterr()
    assert mine["path"] == "kernel-plain"
    for d in (mine, ref, mine_line):
        for k in _VOLATILE:
            d.pop(k, None)
    assert json.loads(json.dumps(mine)) == json.loads(json.dumps(ref))
    assert mine_line == json.loads(json.dumps(mine))


@pytest.mark.parametrize("argv", [
    ["--build", "--num-osds", "32", "--hosts", "8", "--racks", "2",
     "--num-rep", "2", "--min-x", "100", "--max-x", "400"],
    ["--build", "--num-osds", "12", "--hosts", "4", "--indep",
     "--num-rep", "3", "--max-x", "255"],
    ["--build", "--num-osds", "9", "--alg", "list", "--num-rep", "3",
     "--max-x", "200"],
])
def test_crushtool_statistics_match_scalar(argv):
    """Counts and bad mappings against the scalar spec on the map the
    reference crushtool builds from the same flags."""
    out = crushtool.main([*argv, "--test", "--device", "cpu"])
    args = ref_crushtool.parse_args(argv)
    m = ref_crushtool.build_map(args)
    lo, hi, rep = args.min_x, args.max_x, args.num_rep
    rows = [mapper_ref.do_rule(m, 0, x, rep)[:rep] for x in range(lo, hi + 1)]
    live = [d for r in rows for d in r if d != ITEM_NONE]
    counts = np.bincount(live, minlength=m.max_devices)
    bad = 0 if args.indep else sum(len(r) < rep for r in rows)
    assert out["total_x"] == hi - lo + 1
    assert out["bad_mappings"] == bad
    assert out["utilization"]["placements"] == len(live)
    assert out["utilization"]["max"] == int(counts.max())
    assert out["utilization"]["min"] == int(counts.min())


def test_crushtool_compile_and_binary_refusal(tmp_path, capsys):
    from ceph_tpu_torch.crush.compiler import decompile_crushmap
    m = _crush()
    src = tmp_path / "map.txt"
    src.write_text(decompile_crushmap(crush_map_from_state(
        dataclasses.asdict(m))))
    out = crushtool.main(["-c", str(src), "--test", "--num-rep", "2",
                          "--max-x", "63", "--device", "cpu",
                          "--show-mappings"])
    lines = capsys.readouterr().out.splitlines()
    assert out["total_x"] == 64 and len(lines) == 64
    assert lines[5] == f"CRUSH rule 0 x 5 {mapper_ref.do_rule(m, 0, 5, 2)}"
    with pytest.raises(SystemExit, match="binary"):
        crushtool.main(["-i", str(src), "--test"])
