"""The port's spg_t, xor_anchor, mfu, kernel_geometry and
Mapper.kernel_plan_info, held against ceph_tpu's where the two compute
the same thing and against csrc/crush_straw2.cu where the port's launch
differs from the Pallas one.

Inputs come from numpy with a seed; every comparison is exact (``mfu``
to 1e-12 relative, a float quotient computed in another order).
"""

import dataclasses
import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.osd import types as ref_types
from ceph_tpu.utils import roofline as ref_roofline
from ceph_tpu.utils import timing as ref_timing
from ceph_tpu_torch.bench import crush_sweep, ec_benchmark
from ceph_tpu_torch.crush import Mapper, builder, kernels
from ceph_tpu_torch.crush.types import ALG_LIST, ALG_STRAW, ALG_UNIFORM
from ceph_tpu_torch.osd import pg_t, spg_t
from ceph_tpu_torch.utils import roofline, timing

REPO = Path(__file__).resolve().parent.parent
H100 = "NVIDIA H100 80GB HBM3"
SEED = 20261018


# -- spg_t --------------------------------------------------------------------

PGS = [(0, 0), (1, 7), (3, 0x1f), (12, 0xabcdef)]
SHARDS = [-1, 0, 10]


@pytest.mark.parametrize("shard", SHARDS)
@pytest.mark.parametrize("pool,seed", PGS)
def test_spg_t_equals_the_reference(pool, seed, shard):
    mine = spg_t(pg_t(pool, seed), shard)
    ref = ref_types.spg_t(ref_types.pg_t(pool, seed), shard)
    assert str(mine) == str(ref)
    assert hash(mine) == hash(ref)
    assert mine == spg_t(pg_t(pool, seed), shard)
    assert mine != spg_t(pg_t(pool, seed), shard + 1)
    assert mine != spg_t(pg_t(pool + 1, seed), shard)
    assert [f.name for f in dataclasses.fields(mine)] == \
        [f.name for f in dataclasses.fields(ref)]
    for obj in (mine, ref):
        with pytest.raises(dataclasses.FrozenInstanceError):
            obj.shard = 3
    if shard < 0:
        assert str(mine) == str(pg_t(pool, seed))
        assert spg_t(pg_t(pool, seed)) == mine         # NO_SHARD default


def test_spg_t_strings():
    assert str(spg_t(pg_t(1, 7), 3)) == "1.7s3"
    assert str(spg_t(pg_t(1, 7))) == "1.7"
    assert len({spg_t(pg_t(1, 7), s) for s in (-1, 0, 0, 10)}) == 3


# -- xor_anchor ---------------------------------------------------------------

def _ref_xor(a: np.ndarray):
    out = np.asarray(ref_timing.xor_anchor(jnp.asarray(a)))
    return out.dtype, int(out)


def _check_xor(a: np.ndarray, t: torch.Tensor) -> None:
    got = timing.xor_anchor(t)
    want_dtype, want = _ref_xor(a)
    assert got.dim() == 0 and got.device == t.device
    assert str(got.dtype).split(".")[1] == str(want_dtype)
    assert int(got) == want


@pytest.mark.parametrize("n", [0, 1, 7, 8, 4099, (1 << 20) + 3])
def test_xor_anchor_uint8_equals_the_reference(n):
    a = np.random.default_rng(SEED + n).integers(0, 256, n, dtype=np.uint8)
    _check_xor(a, torch.from_numpy(a))
    if n > 3:                        # a view that starts at byte 3
        _check_xor(a[3:], torch.from_numpy(a)[3:])


@pytest.mark.parametrize("dtype", [np.int32, np.int16, np.bool_])
@pytest.mark.parametrize("n", [0, 1, 2, 3, 1001])
def test_xor_anchor_other_dtypes_equal_the_reference(dtype, n):
    rng = np.random.default_rng(SEED + n)
    if dtype is np.bool_:
        a = rng.integers(0, 2, n).astype(bool)
    else:
        info = np.iinfo(dtype)
        a = rng.integers(info.min, info.max, n, endpoint=True).astype(dtype)
    _check_xor(a, torch.from_numpy(a))
    if n > 1:                        # a view off the 8-byte boundary
        _check_xor(a[1:], torch.from_numpy(a)[1:])


def test_xor_anchor_of_a_strided_view():
    a = np.random.default_rng(SEED).integers(0, 256, (64, 33),
                                             dtype=np.uint8)
    _check_xor(a[:, 5::2], torch.from_numpy(a)[:, 5::2])


# -- mfu ----------------------------------------------------------------------

def _ref_spec(spec: roofline.DeviceSpec) -> ref_roofline.DeviceSpec:
    """The reference counts multiply-accumulates, two operations each."""
    return ref_roofline.DeviceSpec(spec.name, spec.hbm_bytes_per_s,
                                   spec.int8_ops_per_s / 2, spec.hbm_bytes)


@pytest.mark.parametrize("name", [H100, "NVIDIA H100 PCIe"])
def test_mfu_equals_the_reference(name):
    spec = roofline.device_spec(name)
    ref = _ref_spec(spec)
    rng = np.random.default_rng(SEED)
    for k, m in ((8, 3), (4, 2), (10, 4), (2, 1)):
        for rate in rng.uniform(1e9, 3e12, 8):
            got = roofline.mfu(k, m, rate, spec)
            want = ref_roofline.mfu(k, m, rate, ref)
            assert got == pytest.approx(want, rel=1e-12, abs=0)


def test_mfu_at_the_h100_encode_bound():
    spec = roofline.device_spec(H100)
    top = roofline.mfu(8, 3, roofline.encode_bound(8, 3, spec), spec)
    assert 0.472 < top <= 0.473


def test_ec_benchmark_rows_carry_mfu_with_a_spec():
    bench = ec_benchmark.ErasureCodeBench(ec_benchmark.parse_args([
        "--plugin", "jax", "--size", "8192", "--iterations", "4",
        "--parameter", "k=8", "--parameter", "m=3", "--parameter",
        "device=cpu", "--slope-steps", "1", "2"]))
    assert bench.spec is None
    assert "mfu_pct" not in bench.run()          # no spec on the CPU
    bench.spec = roofline.device_spec(H100)
    step_bytes = bench.batch * bench.k * bench.chunk
    for seconds in (step_bytes / 1e12, step_bytes / 1e9):
        row = bench._result("encode", seconds)
        rate = row["total_bytes"] / row["seconds"]
        assert row["mfu_pct"] == round(
            100 * roofline.mfu(8, 3, rate, bench.spec), 2)
        dec = bench._result("decode", seconds, erased=[0, 1],
                            avail=list(range(2, 10)))
        assert "mfu_pct" not in dec
    row = bench.run()                            # a measured encode row
    assert row["mfu_pct"] == round(100 * roofline.mfu(
        8, 3, row["total_bytes"] / row["seconds"], bench.spec), 2)
    assert json.loads(json.dumps(row)) == row


# -- kernel_geometry ----------------------------------------------------------

def _cu_constant(name: str) -> int:
    src = (REPO / "ceph_tpu_torch/csrc/crush_straw2.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_kernel_constants_equal_the_cuda_source():
    assert kernels.THREADS == _cu_constant("kThreads")
    assert kernels.MAX_CAND == _cu_constant("kMaxCand")


def test_kernel_geometry_contract():
    plan = kernels.build_plan(crush_sweep.canonical_map(256), 0)
    for n_cand in range(1, kernels.MAX_CAND + 1):
        lanes, fold, groups = kernels.kernel_geometry(plan, n_cand)
        assert lanes == kernels.THREADS
        assert lanes & (lanes - 1) == 0              # a power of two
        assert fold * (groups - 1) < n_cand <= fold * groups
        assert groups * fold >= n_cand
        assert (fold, groups) == (1, n_cand)         # candidate-major
    for n_cand in (0, kernels.MAX_CAND + 1):
        with pytest.raises(ValueError):
            kernels.kernel_geometry(plan, n_cand)


# -- kernel_plan_info and the sweep row ---------------------------------------

PLAN_KEYS = {"fetches_per_sweep", "fetch_amortization", "candidate_batched",
             "kernel_lanes", "candidate_fold"}


def _stub_sweep(monkeypatch):
    monkeypatch.setattr(crush_sweep, "_timed_sweep", lambda *a: 0.01)


def test_kernel_plan_info_on_the_kernel_path(monkeypatch):
    mp = Mapper(crush_sweep.canonical_map(64), device="cpu", block=64)
    before = kernels.crush_straw2.launches
    info = mp.kernel_plan_info(0, 3)
    assert mp.mapping_path(0, 3) == "kernel-plain"
    assert set(info) == PLAN_KEYS
    plan = mp.kernel_plan(0).plan
    lanes, fold, groups = kernels.kernel_geometry(
        plan, 3 + kernels.SPEC_EXTRA)
    assert info["fetches_per_sweep"] == groups * plan.n_levels == 15
    assert info == {"fetches_per_sweep": 15, "fetch_amortization": 1.0,
                    "candidate_batched": False,
                    "kernel_lanes": kernels.THREADS, "candidate_fold": 1}
    _stub_sweep(monkeypatch)
    row = crush_sweep.sweep_rate(mp, 1 << 12, 3)
    assert row["path"] == "kernel-plain"
    assert {k: row[k] for k in PLAN_KEYS} == info
    assert json.loads(json.dumps(row)) == row
    assert kernels.crush_straw2.launches == before


def test_kernel_plan_info_keys_are_the_references(monkeypatch):
    from ceph_tpu.bench import crush_sweep as ref_sweep
    from ceph_tpu.crush.mapper import Mapper as RefMapper

    monkeypatch.setenv("CEPH_TPU_CRUSH_KERNEL", "interpret")
    ref = RefMapper(ref_sweep.canonical_map(64), block=1 << 10)
    mine = Mapper(crush_sweep.canonical_map(64), device="cpu", block=64)
    ref_info, info = ref.kernel_plan_info(0, 3), mine.kernel_plan_info(0, 3)
    assert set(ref_info) == set(info)
    assert {k: type(v) for k, v in ref_info.items()} == \
        {k: type(v) for k, v in info.items()}


def _declined_maps():
    """(name, map, rule): rules the kernel does not compute."""
    out = []
    m = crush_sweep.canonical_map(64)
    out.append(("indep", m, builder.add_simple_rule(
        m, m.rules[0].steps[0].arg1, builder.TYPE_HOST, indep=True)))
    for alg in (ALG_STRAW, ALG_LIST, ALG_UNIFORM):
        flat, root = builder.build_flat(8, alg=alg)
        out.append((f"alg{alg}", flat, builder.add_simple_rule(
            flat, root, builder.TYPE_OSD)))
    legacy = crush_sweep.canonical_map(64)
    legacy.tunables = dataclasses.replace(legacy.tunables,
                                          chooseleaf_stable=0)
    out.append(("legacy", legacy, 0))
    return out


@pytest.mark.parametrize("case", range(5))
def test_kernel_plan_info_is_none_where_the_kernel_does_not_serve(
        case, monkeypatch):
    name, m, rule = _declined_maps()[case]
    assert kernels.build_plan(m, rule) is None
    mp = Mapper(m, device="cpu", block=64)
    path = mp.mapping_path(rule, 3)
    assert path == ("scalar" if name == "legacy" else "vm")
    before = kernels.crush_straw2.launches
    assert mp.kernel_plan_info(rule, 3) is None
    _stub_sweep(monkeypatch)
    row = crush_sweep.sweep_rate(mp, 256, 3, rule=rule)
    assert row["path"] == path
    assert not PLAN_KEYS & set(row)                  # absent, not null
    assert kernels.crush_straw2.launches == before
