"""The port's CRUSH path held against ceph_tpu's, lane for lane.

The same maps (built by ``ceph_tpu.crush.builder`` and carried across
with ``crush_map_from_state``) and the same seeds go through the port
(``device="cpu"``: the kernel's plain version and the rule VM) and
through ``ceph_tpu`` on JAX's CPU backend (its XLA mapper, and its
Pallas kernel in interpret mode) and ``mapper_ref``, the scalar spec.
Placement is integer, so the tolerance is exact equality throughout.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from ceph_tpu.crush import builder, mapper_ref
from ceph_tpu.crush import hash as ref_hash
from ceph_tpu.crush import ln_table as ref_ln
from ceph_tpu.crush import pallas_mapper as pm
from ceph_tpu.crush.mapper import Mapper as RefMapper
from ceph_tpu.crush.tensors import pack_map
from ceph_tpu.crush.tester import CrushTester as RefTester
from ceph_tpu.crush.types import (
    ALG_LIST, ALG_STRAW, ALG_TREE, ALG_UNIFORM, ITEM_NONE, WEIGHT_ONE,
    OP_CHOOSE_FIRSTN, OP_CHOOSE_INDEP, OP_CHOOSELEAF_FIRSTN, ChooseArg,
    RuleStep, Tunables,
)
from ceph_tpu_torch.bench import crush_sweep
from ceph_tpu_torch.crush import hash as thash
from ceph_tpu_torch.crush import kernels
from ceph_tpu_torch.crush import ln_table as tln
from ceph_tpu_torch.crush.mapper import Mapper
from ceph_tpu_torch.crush.tester import CrushTester
from ceph_tpu_torch.crush.types import crush_map_from_state, crush_map_state

W = WEIGHT_ONE
N_X = 128


def port(m):
    """A ceph_tpu CrushMap carried into the port's model."""
    return crush_map_from_state(dataclasses.asdict(m))


def scalar(m, rid, xs, numrep, weights=None, ca=None):
    wl = list(weights) if weights is not None else None
    cargs = m.choose_args.get(ca) if ca is not None else None
    out = np.full((len(xs), numrep), ITEM_NONE, dtype=np.int64)
    for i, x in enumerate(xs):
        got = mapper_ref.do_rule(m, rid, int(x), numrep, weight=wl,
                                 choose_args=cargs)[:numrep]
        out[i, :len(got)] = got
    return out


# -- hash and crush_ln --------------------------------------------------------

def test_crush_ln_exhaustive():
    u = np.arange(0x10000, dtype=np.int64)
    want = ref_ln.crush_ln(u)
    got = tln.crush_ln_t(torch.as_tensor(u)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(tln.crush_ln(u), want)
    assert np.array_equal(kernels.ln_table_t("cpu").numpy(), want)


@pytest.mark.parametrize("arity", [2, 3, 4])
def test_rjenkins_random(arity):
    rng = np.random.default_rng(arity)
    args = rng.integers(0, 2 ** 32, size=(arity, 4096),
                        dtype=np.uint64).astype(np.uint32)
    want = getattr(ref_hash, f"hash32_{arity}")(*args)
    tens = [torch.as_tensor(a.astype(np.int64)) for a in args]
    got = getattr(thash, f"hash32_{arity}_t")(*tens).numpy()
    assert np.array_equal(got, want.astype(np.int64))
    # negative ids (buckets) hash as their uint32 bit patterns
    neg = [torch.as_tensor(-(a.astype(np.int64) >> 1)) for a in args]
    want_neg = getattr(ref_hash, f"hash32_{arity}")(
        *[(-(a.astype(np.int64) >> 1)).astype(np.uint32) for a in args])
    assert np.array_equal(getattr(thash, f"hash32_{arity}_t")(*neg).numpy(),
                          want_neg.astype(np.int64))


def test_crush_map_state_round_trip():
    m, root = builder.build_hierarchy(4, 3, alg=ALG_TREE)
    m2, r2 = builder.build_flat(5, alg=ALG_STRAW)
    m.buckets.update({b - 100: dataclasses.replace(v, id=b - 100)
                      for b, v in m2.buckets.items()})
    builder.add_simple_rule(m, root, builder.TYPE_HOST)
    m.choose_args[0] = {root: ChooseArg(weight_set=[[W] * 4], ids=None)}
    state = dataclasses.asdict(m)
    mine = crush_map_from_state(state)
    assert crush_map_state(mine) == state
    # through JSON (string keys) and back
    assert crush_map_state(crush_map_from_state(
        json.loads(json.dumps(state)))) == state


# -- the kernel's plain version vs the Pallas kernel (interpret mode) ----------

def _hier(n_hosts, per_host, n_racks=None, osd_weights=None):
    m, root = builder.build_hierarchy(
        n_hosts, per_host, n_racks=n_racks or max(1, n_hosts // 4),
        osd_weights=osd_weights)
    return m, builder.add_simple_rule(m, root, builder.TYPE_HOST)


def _continuous_args(m):
    rng = np.random.default_rng(11)
    m.choose_args[0] = {
        bid: ChooseArg(weight_set=[[max(1, int(w * s)) for w, s in zip(
            b.weights, rng.uniform(0.9, 1.1, size=b.size))]])
        for bid, b in m.buckets.items()}
    return m


KERNEL_MAPS = {
    "uniform": lambda: _hier(16, 4) + (None, None),
    "mixed": lambda: _hier(8, 4, osd_weights=[
        W if i % 2 else 2 * W for i in range(32)]) + (None, None),
    "choose_args": lambda: (_continuous_args(_hier(8, 4, n_racks=2)[0]),
                            0, None, 0),
    "reweights": lambda: _hier(4, 2, n_racks=1) + (
        [0x10000, 0x1000, 0x8000, 0x800, 0x10000, 0x100, 0x3000,
         0x10000], None),
}


@pytest.mark.parametrize("name", sorted(KERNEL_MAPS))
def test_plain_kernel_vs_pallas_interpret(name, monkeypatch):
    monkeypatch.setenv("CEPH_TPU_CRUSH_KERNEL", "interpret")
    m, rid, weights, ca = KERNEL_MAPS[name]()
    dw = None if weights is None else np.asarray(weights, dtype=np.int64)
    plan = pm.build_plan(m, pack_map(m), rid, dw, choose_args_key=ca)
    assert plan is not None
    numrep = 3
    lanes = pm.kernel_geometry(plan, numrep + pm.SPEC_EXTRA)[0]
    xs = np.arange(lanes, dtype=np.int32) * 7919
    ref_leaves, ref_bad = pm._run_kernel(plan, xs, numrep, interpret=True)
    ref_leaves, ref_bad = np.asarray(ref_leaves), np.asarray(ref_bad)
    mine = kernels.build_plan(port(m), rid, dw, ca)
    leaves, bad = kernels.crush_straw2(
        kernels.plan_tensors(mine, "cpu"), torch.as_tensor(xs), numrep)
    leaves, bad = leaves.numpy(), bad.numpy()
    assert not (bad & ~ref_bad).any()            # port flags a subset
    keep = ~ref_bad
    assert np.array_equal(leaves[keep], ref_leaves[keep])
    # the port's unflagged lanes are the scalar spec's
    ok = np.flatnonzero(~bad)[:64]
    want = scalar(m, rid, xs[ok].astype(np.uint32), numrep, weights, ca)
    assert np.array_equal(leaves[ok], want)
    if name == "reweights":
        assert bad.any()


def test_kernel_refuses_bad_arguments():
    m, rid = _hier(4, 2)
    pt = kernels.plan_tensors(kernels.build_plan(port(m), rid), "cpu")
    with pytest.raises(ValueError):
        kernels.crush_straw2(pt, torch.arange(4, dtype=torch.int64), 3)
    with pytest.raises(ValueError):
        kernels.crush_straw2(pt, torch.arange(4, dtype=torch.int32), 0)


# -- Mapper vs ceph_tpu's Mapper and mapper_ref --------------------------------

def _flat(n=10, **kw):
    m, root = builder.build_flat(n, **kw)
    return m, builder.add_simple_rule(m, root, builder.TYPE_OSD)


def _args_map(positions):
    m, rid = _flat(6)
    root = m.rules[rid].steps[0].arg1
    ws = [[W, W, 3 * W, W, 0, W] for _ in range(positions)]
    if positions > 1:
        ws[1] = [2 * W] * 6
    m.choose_args[0] = {root: ChooseArg(weight_set=ws)}
    return m, rid


def _ids_map():
    m, rid = _flat(4)
    m.choose_args[0] = {m.rules[rid].steps[0].arg1:
                        ChooseArg(ids=[100, 101, 102, 103])}
    return m, rid


def _multistep():
    m, root = builder.build_hierarchy(8, 2, n_racks=4)
    return m, builder.add_multistep_rule(m, root, [
        RuleStep(OP_CHOOSE_FIRSTN, 2, builder.TYPE_RACK),
        RuleStep(OP_CHOOSELEAF_FIRSTN, 2, builder.TYPE_HOST)])


def _indep(n_hosts=6, per=4, **kw):
    m, root = builder.build_hierarchy(n_hosts, per, **kw)
    return m, builder.add_simple_rule(m, root, builder.TYPE_HOST,
                                      indep=True)


def _indep_osd():
    m, root = builder.build_hierarchy(6, 3)
    return m, builder.add_multistep_rule(
        m, root, [RuleStep(OP_CHOOSE_INDEP, 0, 0)], indep=True)


def _weighted(alg, seed, n_hosts, per):
    rng = np.random.default_rng(seed)
    ws = [int(w) for w in rng.integers(1, 4 * W, size=n_hosts * per)]
    m, root = builder.build_hierarchy(n_hosts, per, alg=alg, osd_weights=ws)
    return m, builder.add_simple_rule(m, root, builder.TYPE_HOST)


# name -> (map builder, numrep, reweights, choose_args key, port engine)
FAMILIES = {
    "flat": (lambda: _flat(10), 3, None, None, "kernel-plain"),
    "list": (lambda: _flat(7, alg=ALG_LIST), 3, None, None, "vm"),
    "uniform": (lambda: _hier(5, 4, n_racks=1), 3, None, None,
                "kernel-plain"),
    "uniform_alg": (lambda: _indep(5, 4, alg=ALG_UNIFORM), 4, None, None,
                    "vm"),
    "straw": (lambda: _weighted(ALG_STRAW, 3, 4, 3), 3, None, None, "vm"),
    "tree": (lambda: _weighted(ALG_TREE, 4, 5, 2), 3, None, None, "vm"),
    "multistep": (_multistep, 4, None, None, "vm"),
    "indep": (lambda: _indep(6, 4), 5, None, None, "vm"),
    "indep_holes": (lambda: _indep(4, 2), 5, None, None, "vm"),
    "indep_osd": (_indep_osd, 4, None, None, "vm"),
    "firstn_holes": (lambda: _hier(4, 2, n_racks=1), 5, None, None,
                     "kernel-plain"),
    "reweights": (lambda: _flat(6, weights=[2 * W, W, W, 0, W, W // 2]), 3,
                  [0x10000, 0x8000, 0x10000, 0x10000, 0, 0x4000], None,
                  "kernel-plain"),
    "zero_weight_subtree": (lambda: _hier(
        4, 3, n_racks=1, osd_weights=[0, 0, 0] + [W] * 9), 3, None, None,
        "vm"),
    "choose_args_single": (lambda: _args_map(1), 2, None, 0,
                           "kernel-plain"),
    "choose_args_multi": (lambda: _args_map(2), 2, None, 0, "vm"),
    "choose_args_ids": (_ids_map, 1, None, 0, "vm"),
    "legacy_tunables": (lambda: _flat(6, tunables=Tunables.legacy()), 3,
                        None, None, "scalar"),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_mapper_matches_reference(name, monkeypatch):
    """ceph_tpu's Mapper serves with its Pallas kernel (interpret mode)
    where its plan takes the map, its XLA path elsewhere."""
    monkeypatch.setenv("CEPH_TPU_CRUSH_KERNEL", "interpret")
    build, numrep, weights, ca, engine = FAMILIES[name]
    m, rid = build()
    rng = np.random.default_rng(len(name))
    xs = np.concatenate([np.arange(N_X // 2, dtype=np.uint32),
                         rng.integers(0, 2 ** 32, size=N_X // 2,
                                      dtype=np.uint64).astype(np.uint32)])
    dw = None if weights is None else np.asarray(weights, dtype=np.int64)
    mine = Mapper(port(m), dw, choose_args=ca, device="cpu")
    got, path = mine.map_pgs_path(rid, xs, numrep)
    assert path == engine == mine.mapping_path(rid, numrep)
    assert mine.last_map_path == engine
    got = got.numpy()
    assert got.dtype == np.int32 and got.shape == (len(xs), numrep)
    assert np.array_equal(got, scalar(m, rid, xs, numrep, weights, ca))
    ref = np.asarray(RefMapper(m, dw, choose_args=ca).map_pgs(
        rid, xs, numrep))
    assert np.array_equal(got, ref)


def _hier_tunables(n_hosts, per, tunables):
    m, root = builder.build_hierarchy(n_hosts, per, tunables=tunables)
    return m, builder.add_simple_rule(m, root, builder.TYPE_HOST)


# Maps on which ceph_tpu's Pallas kernel departs from the scalar spec
# (ROADMAP Queue C): it takes candidates past choose_total_tries, and it
# makes one leaf descent where chooseleaf_descend_once=0 retries. The
# port's kernel stops at the try budget; descend_once=0 goes to its VM.
SPEC_ONLY = {
    "few_tries": (lambda: _hier_tunables(
        8, 2, Tunables(choose_total_tries=1)), None, "kernel-plain"),
    "leaf_retries": (lambda: _hier_tunables(
        4, 2, Tunables(chooseleaf_descend_once=0)),
        [W, 0x800, W, 0x1000, W, W, 0x2000, W], "vm"),
}


@pytest.mark.parametrize("name", sorted(SPEC_ONLY))
def test_exact_where_the_pallas_kernel_departs(name, monkeypatch):
    monkeypatch.setenv("CEPH_TPU_CRUSH_KERNEL", "0")    # its XLA path
    build, weights, engine = SPEC_ONLY[name]
    m, rid = build()
    xs = np.arange(512, dtype=np.uint32)
    dw = None if weights is None else np.asarray(weights, dtype=np.int64)
    mine = Mapper(port(m), dw, device="cpu")
    assert mine.mapping_path(rid, 3) == engine
    got = mine.map_pgs(rid, xs, 3).numpy()
    assert np.array_equal(got, scalar(m, rid, xs, 3, weights))
    assert np.array_equal(got, np.asarray(RefMapper(m, dw).map_pgs(
        rid, xs, 3)))


def test_vm_recomputes_flagged_lanes():
    """A map where lanes run out of candidates: 4 hosts x 2 OSDs,
    numrep 4, most OSDs reweighted toward 0."""
    m, rid = _hier(4, 2, n_racks=1)
    w = [0x10000, 0x1000, 0x2000, 0x800, 0x10000, 0x100, 0x3000, 0x10000]
    xs = np.arange(96, dtype=np.uint32)
    mine = Mapper(port(m), np.asarray(w), device="cpu")
    got = mine.map_pgs(rid, xs, 4).numpy()
    assert mine.flagged_lanes > 0
    assert np.array_equal(got, scalar(m, rid, xs, 4, w))


@pytest.mark.parametrize("name", ["flat", "indep", "reweights",
                                  "legacy_tunables"])
def test_sweep_matches_reference(name):
    """Per-device counts and short (bad) firstn results of a sweep over
    [5, 305), against the scalar spec's mappings, and against ceph_tpu's
    own sweep on the kernel-path map (its indep sweep takes a minute to
    compile on the CPU)."""
    build, numrep, weights, ca, _ = FAMILIES[name]
    m, rid = build()
    dw = None if weights is None else np.asarray(weights, dtype=np.int64)
    mine = Mapper(port(m), dw, choose_args=ca, device="cpu", block=100)
    counts, bad = mine.sweep(rid, 5, 300, numrep)
    want = scalar(m, rid, np.arange(5, 305), numrep, weights, ca)
    live = want != ITEM_NONE
    assert np.array_equal(counts.numpy(), np.bincount(
        want[live], minlength=m.max_devices))
    short = int((live.sum(axis=1) < numrep).sum())
    assert int(bad) == (short if mine.rule_is_firstn(rid) else 0)
    if name == "flat":
        rc, rb = RefMapper(m, dw, choose_args=ca).sweep(rid, 5, 300, numrep)
        assert np.array_equal(counts.numpy(), np.asarray(rc))
        assert int(bad) == int(rb)


def test_smoke_scalar_checks_equal_mapper_ref():
    """chip_smoke.py's scalar checks (``scalar_map``: the port's
    ``mapper_ref`` in spawned workers, ``crush_ln`` from a table and
    ``_h3`` on Python ints) give ``ceph_tpu``'s ``mapper_ref`` rows on
    every family of maps."""
    import multiprocessing

    import chip_smoke as cs
    xs = np.arange(0, 4000, 97)
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        for name, (build, numrep, weights, ca, _) in FAMILIES.items():
            m, rid = build()
            pm_ = port(m)
            cargs = pm_.choose_args.get(ca) if ca is not None else None
            got = cs.scalar_map(pool, pm_, rid, xs, numrep,
                                None if weights is None else list(weights),
                                cargs)
            assert np.array_equal(got, scalar(m, rid, xs, numrep, weights,
                                              ca)), name


def test_mapper_needs_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    m, rid = _flat(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        Mapper(port(m))


def _many_reweights():
    m, rid = _flat(200)
    w = np.full(200, W, dtype=np.int64)
    w[:150] = W // 2 + np.arange(150)
    return m, rid, w


# Maps whose plan ceph_tpu declines for its kernel's VMEM, byte-plane
# or compare-list limits, which the port's kernel does not have.
DIFFERENT_ENGINE = {
    "weights_past_2^30": lambda: _flat(
        4, weights=[pm.MAX_CONT_WEIGHT + i for i in range(4)]) + (None,),
    "flat_2048_osds": lambda: _flat(2048) + (None,),
    "150_reweighted_osds": _many_reweights,
}


@pytest.mark.parametrize("name", sorted(DIFFERENT_ENGINE))
def test_engine_choice_where_packages_differ(name):
    """The port's exact kernel drops the TPU kernel's VMEM, byte-plane
    and compare-list limits: ceph_tpu declines these plans (its XLA path
    serves), the port's kernel takes them. The mappings stay equal."""
    m, rid, w = DIFFERENT_ENGINE[name]()
    assert pm.build_plan(m, pack_map(m), rid, w) is None
    mine = Mapper(port(m), w, device="cpu")
    assert mine.mapping_path(rid, 2) == "kernel-plain"
    xs = np.arange(48, dtype=np.uint32) * 1237
    got = mine.map_pgs(rid, xs, 2).numpy()
    assert np.array_equal(got, np.asarray(RefMapper(m, w).map_pgs(
        rid, xs, 2)))
    assert np.array_equal(got[:4], scalar(m, rid, xs[:4], 2, w))


def test_crush_tester_matches_reference():
    m, rid = _hier(6, 4)
    w = np.full(24, W, dtype=np.int64)
    w[3] = W // 2
    ref = RefTester(m, w).test(rid, 3, 0, 255, keep_mappings=True)
    for keep in (True, False):
        mine = CrushTester(port(m), w, device="cpu").test(
            rid, 3, 0, 255, keep_mappings=keep)
        assert np.array_equal(mine.device_counts, ref.device_counts)
        assert mine.bad_mappings == ref.bad_mappings
        assert mine.utilization_summary() == ref.utilization_summary()
        if keep:
            assert np.array_equal(mine.mappings, np.asarray(ref.mappings))


def test_crush_sweep_on_cpu():
    m = crush_sweep.canonical_map(256)
    mp = Mapper(m, device="cpu", block=64)
    res = crush_sweep.sweep_rate(mp, 256, 3)
    assert res["path"] == "kernel-plain" and res["timer"] == "host_clock"
    assert res["platform"] == "cpu" and res["mappings_per_s"] > 0
    for name in crush_sweep.VARIANTS:
        build, key = crush_sweep.VARIANTS[name]
        assert Mapper(build(256), choose_args=key, device="cpu") \
            .mapping_path(0, 3) == "kernel-plain"
