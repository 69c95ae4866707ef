"""The port's device-runtime monitor held against ceph_tpu's.

Mirrors tests/test_devmon.py: the monitor's own units (counter names,
first-launch accounting with un-warm on failure, the oldest-only warm-set
eviction, device fault injection at the chokepoint), what the EC plugins
report through it (first launches of ``ec_encode`` / ``ec_decode`` /
``ec_encode_crc`` / ``scrub_crc`` and the pipeline's transfer bytes),
and the kernel-path health half: engine normalisation, expected-vs-actual
checks, per-call paths, and the CRUSH Mapper's kernel quarantine, whose
counters follow ceph_tpu's through the engine-name map (kernel = pallas,
vm = xla). On the CPU the faults are injected on ``kernel-plain``; a
Mapper on the card raises instead. Counts are integers, compared exactly.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.crush import builder as ref_builder
from ceph_tpu.crush.mapper import Mapper as RefMapper
from ceph_tpu.ec.jax_plugin import ErasureCodeJax
from ceph_tpu.ec.jax_plugin import StreamingEncodePipeline as JaxPipe
from ceph_tpu.sim import faults as F
from ceph_tpu.utils import devmon as jax_devmon
from ceph_tpu_torch.crush import builder
from ceph_tpu_torch.crush import mapper as mapper_mod
from ceph_tpu_torch.crush.mapper import Mapper
from ceph_tpu_torch.ec import crc as ec_crc
from ceph_tpu_torch.ec.torch_plugin import (ErasureCodeTorch,
                                            StreamingEncodePipeline)
from ceph_tpu_torch.utils import devmon as devmon_mod
from ceph_tpu_torch.utils.devmon import (
    DeviceRuntimeMonitor, devmon, normalize_engine,
)

# the port's counter names -> ceph_tpu's (engines: kernel = pallas,
# vm = xla)
ENGINE_MAP = {"kernel": "pallas", "vm": "xla", "scalar": "scalar"}
COUNTER_MAP = {f"launches_{k}": f"launches_{v}"
               for k, v in ENGINE_MAP.items()}


def _delta(before: dict, after: dict, key: str) -> int:
    return int(after.get(key, 0)) - int(before.get(key, 0))


def test_counter_names_match_reference():
    """Every counter keeps the reference's name, the launch counters
    through the engine-name map, so the mgr and Prometheus rows match."""
    mine = DeviceRuntimeMonitor(name="devmon_t_names", register=False)
    theirs = jax_devmon.DeviceRuntimeMonitor(name="devmon_j_names",
                                             register=False)
    mapped = {COUNTER_MAP.get(k, k) for k in mine.perf.dump()}
    assert mapped == set(theirs.perf.dump())
    d = mine.dump()
    assert d["engine"] == devmon_mod.engine_name()
    assert d["engine"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert d["expected_engine"] == "auto" and d["mismatch_ratio"] == 0.0
    mine_h = mine.health_report()
    theirs_h = theirs.health_report()
    assert {COUNTER_MAP.get(k, k) for k in mine_h} == set(theirs_h)


def test_jit_call_warm_and_failure_unwarm():
    """The first launch per (fn, key) counts once; a failed first call
    un-warms so the retry's first launch still counts."""
    dm = DeviceRuntimeMonitor(name="devmon_t_unit1", register=False)
    calls = []

    def fn(x):
        calls.append(x)
        if x == "boom":
            raise ValueError("boom")
        return x

    assert dm.jit_call("f", (1,), fn, "a") == "a"
    assert dm.perf.dump()["jit_compiles"] == 1
    assert dm.jit_call("f", (1,), fn, "b") == "b"
    assert dm.perf.dump()["jit_compiles"] == 1
    with pytest.raises(ValueError):
        dm.jit_call("g", (2,), fn, "boom")
    assert dm.perf.dump()["jit_compiles"] == 1
    assert dm.jit_call("g", (2,), fn, "ok") == "ok"
    assert dm.perf.dump()["jit_compiles"] == 2
    assert dm.functions["f"]["count"] == 1
    assert dm.dump()["compiles_by_fn"]["g"]["count"] == 1


def test_warm_set_evicts_oldest_only(monkeypatch):
    """At _WARM_MAX the warm set evicts the OLDEST key only."""
    monkeypatch.setattr(devmon_mod, "_WARM_MAX", 3)
    dm = DeviceRuntimeMonitor(name="devmon_t_warm", register=False)
    for i in range(3):
        dm.jit_call("f", (i,), lambda: i)
    assert dm.perf.dump()["jit_compiles"] == 3
    dm.jit_call("f", (3,), lambda: 3)
    assert dm.perf.dump()["jit_compiles"] == 4
    for i in (1, 2, 3):
        dm.jit_call("f", (i,), lambda: i)
    assert dm.perf.dump()["jit_compiles"] == 4
    dm.jit_call("f", (0,), lambda: 0)
    assert dm.perf.dump()["jit_compiles"] == 5


def test_device_fault_injection_at_jit_call():
    """ceph_tpu's fault injector (duck-typed) fires at the port's
    chokepoint: jit_fail raises before warm bookkeeping, bad_result
    flips one element of a numpy result or of a torch tensor (same dtype
    and device, the CRC sidecar of a tuple untouched), count bounds a
    rule, key patterns target by key string."""
    inj = F.FaultInjector(seed=3)
    inj.install("dev", [
        F.jit_fail("ec_encode", count=1),
        F.bad_result("crush_map_pgs", key="*'kern'*", count=1),
        F.bad_result("ec_encode_crc", count=1),
    ])
    dm = DeviceRuntimeMonitor(name="devmon_t_fi", register=False)
    devmon_mod.set_fault_injector(inj)
    try:
        with pytest.raises(RuntimeError, match="injected device"):
            dm.jit_call("ec_encode", ("k", 1), lambda: "never")
        assert dm.jit_call("ec_encode", ("k", 1), lambda: "ok") == "ok"
        assert dm.perf.dump()["jit_compiles"] == 1
        clean = dm.jit_call("crush_map_pgs", ("vm", 4),
                            lambda: np.arange(6))
        assert np.array_equal(clean, np.arange(6))
        bad = dm.jit_call("crush_map_pgs", ("kern", "v", 4),
                          lambda: np.arange(6))
        assert bad.shape == (6,) and int((bad != np.arange(6)).sum()) == 1
        parity = torch.arange(12, dtype=torch.uint8).reshape(2, 6)
        crcs = torch.arange(4, dtype=torch.int64)
        got_p, got_c = dm.jit_call("ec_encode_crc", ("k", 2),
                                   lambda: (parity, crcs))
        assert isinstance(got_p, torch.Tensor)
        assert got_p.dtype == torch.uint8 and got_p.shape == (2, 6)
        assert int((got_p != parity).sum()) == 1
        assert got_c is crcs
        assert torch.equal(parity, torch.arange(12, dtype=torch.uint8)
                           .reshape(2, 6))   # the original is untouched
        assert dm.perf.dump()["faults_injected"] == 3
    finally:
        devmon_mod.set_fault_injector(None)


def test_ec_first_launch_accounting_matches_reference():
    """Each batched EC entry point counts one first launch per (kernel,
    shape) and none when warm, exactly as ceph_tpu's plugin counts its
    compiles for the same calls."""
    prof = "plugin=jax k=3 m=2 technique=reed_sol_van"
    mine = ErasureCodeTorch(prof, device="cpu")
    theirs = ErasureCodeJax(prof)
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (4, 3, 128), dtype=np.uint8)
    word = np.concatenate([data, mine.encode_batch_reference(data)],
                          axis=1)
    chunks = np.ascontiguousarray(word[:, [1, 2, 3]])
    calls = [
        lambda ec: ec.encode_batch(data),
        lambda ec: ec.encode_batch(data),                   # warm
        lambda ec: ec.encode_batch(data[:2]),               # new shape
        lambda ec: ec.decode_batch((0,), (1, 2, 3), chunks),
        lambda ec: ec.decode_batch((0,), (1, 2, 3), chunks),
        lambda ec: ec.encode_batch_with_crc(data),
        lambda ec: ec.encode_batch_with_crc(data),
    ]
    counts = []
    for ec, mon in ((mine, devmon()), (theirs, jax_devmon.devmon())):
        got = []
        for call in calls:
            before = mon.perf.dump()["jit_compiles"]
            call(ec)
            got.append(mon.perf.dump()["jit_compiles"] - before)
        counts.append(got)
        assert {"ec_encode", "ec_decode", "ec_encode_crc"} <= \
            set(mon.functions)
    assert counts[0] == counts[1] == [1, 0, 1, 1, 0, 1, 0]


def test_scrub_crc_first_launch_per_padded_shape():
    """``device_row_crcs`` pads rows to a power of two, so 5, 6 and 8
    rows share one first launch, and 9 rows take a new one."""
    dm = devmon()
    rng = np.random.default_rng(8)
    C = 200                      # a width no other test uses
    counts = []
    for r in (5, 6, 8, 9):
        before = dm.perf.dump()["jit_compiles"]
        rows = rng.integers(0, 256, (r, C), dtype=np.uint8)
        got = ec_crc.device_row_crcs(rows, device="cpu")
        assert got.tolist() == [ec_crc.raw_crc(x.tobytes()) for x in rows]
        counts.append(dm.perf.dump()["jit_compiles"] - before)
    assert counts == [1, 0, 0, 1]


def test_pipeline_transfer_bytes_match_reference():
    """The streaming pipeline counts every H2D stage and D2H readback in
    bytes, the same totals as ceph_tpu's pipeline for the same stream."""
    prof = "plugin=jax k=4 m=2 technique=reed_sol_van"
    rng = np.random.default_rng(9)
    batches = [rng.integers(0, 256, (3, 4, 256), dtype=np.uint8)
               for _ in range(3)]
    deltas = []
    for pipe, mon in ((StreamingEncodePipeline(
            ErasureCodeTorch(prof, device="cpu")), devmon()),
            (JaxPipe(ErasureCodeJax(prof)), jax_devmon.devmon())):
        before = mon.perf.dump()
        outs = pipe.encode_all([b.copy() for b in batches])
        after = mon.perf.dump()
        assert len(outs) == 3
        deltas.append((_delta(before, after, "h2d_bytes"),
                       _delta(before, after, "d2h_bytes")))
    assert deltas[0] == deltas[1] == (3 * 3 * 4 * 256, 3 * 3 * 2 * 256)
    assert devmon().perf.dump()["device_bytes_watermark"] >= 3 * 4 * 256 \
        or not torch.cuda.is_available()


# -- kernel-path health ------------------------------------------------------

def test_normalize_engine():
    cases = {"kernel": "kernel", "kernel-plain": "kernel",
             "kernel+sharded": "kernel", "vm+sharded": "vm",
             "vm": "vm", "scalar": "scalar", None: "?", "florp": "?"}
    for path, want in cases.items():
        assert normalize_engine(path) == want
        # the same paths in ceph_tpu's names normalize alike
        ref_path = None if path is None else path.replace(
            "kernel-plain", "pallas-interpret").replace(
            "kernel", "pallas").replace("vm", "xla")
        assert jax_devmon.normalize_engine(ref_path) == \
            ENGINE_MAP.get(want, want)


def test_record_sweep_knob_vs_plan():
    """``devmon_expected_engine`` pins the deployment contract (read
    live); 'auto' trusts the plan, so the only mismatch then is a degrade
    from the plan's own prediction. The same sequence on ceph_tpu's
    monitor gives the same counters through the name map."""
    seq = [("vm", "vm"), ("kernel-plain", "kernel-plain"),
           ("vm", "vm"), ("kernel-plain", "vm")]
    dumps = []
    for mon_cls, rename, pin in (
            (DeviceRuntimeMonitor, lambda p: p, "kernel"),
            (jax_devmon.DeviceRuntimeMonitor,
             lambda p: p.replace("kernel-plain", "pallas-interpret")
             .replace("vm", "xla"), "pallas")):
        cfg = {"devmon_expected_engine": pin}
        dm = mon_cls(name=f"devmon_t_knob_{pin}", register=False,
                     config=cfg)
        got = []
        for i, (plan, actual) in enumerate(seq):
            if i == 2:
                cfg["devmon_expected_engine"] = "auto"
            got.append(dm.record_sweep(rename(plan), rename(actual)))
        assert got == [True, False, False, True]
        assert dm.mismatch_ratio() == pytest.approx(2 / 4)
        assert dm.last_mismatch["actual"] == rename("vm")
        hr = dm.health_report()
        assert hr["checks"] == 4 and hr["mismatches"] == 2
        dumps.append(dm.perf.dump())
    mine, ref = dumps
    for k in ("path_checks", "path_mismatch", "launches_kernel",
              "launches_vm"):
        assert mine[k] == ref[COUNTER_MAP.get(k, k)], k


def _two_rule_map(mod, n_osds: int = 56):
    """rule 0: replicated chooseleaf firstn (the kernel's); rule 1:
    chooseleaf indep (the VM's)."""
    m, root = mod.build_hierarchy(n_osds // 8, 8, n_racks=2)
    mod.add_simple_rule(m, root, mod.TYPE_HOST)
    mod.add_simple_rule(m, root, mod.TYPE_HOST, indep=True)
    return m


_QUAR_CFG = {"crush_kernel_reprobe_base": 0.0,
             "crush_kernel_reprobe_max": 0.0,
             "crush_kernel_reprobe_disable_after": 3}


def _port_mapper(**cfg):
    return Mapper(_two_rule_map(builder), block=1 << 10, device="cpu",
                  config={**_QUAR_CFG, **cfg})


def _ref_mapper(**cfg):
    """ceph_tpu's Mapper with a stand-in kernel (its serving rule
    function), as tests/test_devmon.py builds it: the state machine runs
    without interpret-mode compiles."""
    m = RefMapper(_two_rule_map(ref_builder), block=1 << 10,
                  config={**_QUAR_CFG, **cfg})
    fn = m._rule_fn(0, 3)
    m._kernel_body = lambda ruleno, result_max: (
        fn if m._kernel_mode is not None else None)
    m._kernel_mode = "interpret"
    return m


_QUAR_KEYS = ("quarantine_entries", "quarantine_exits", "quarantine_probes",
              "quarantine_probe_failures", "path_checks", "path_mismatch",
              "launches_kernel", "launches_vm", "faults_injected")


def _deltas(before, after, keys):
    return {k: _delta(before, after, k) for k in keys}


def _both(scenario):
    """Run ``scenario(mapper, path_name)`` on the port's Mapper and on
    ceph_tpu's; return each package's devmon counter deltas under the
    port's names, and the scenario's results."""
    out = []
    for mk, mon, names in (
            (_port_mapper, devmon(), {}),
            (_ref_mapper, jax_devmon.devmon(), COUNTER_MAP)):
        before = mon.perf.dump()
        res = scenario(mk())
        after = mon.perf.dump()
        out.append(({k: _delta(before, after, names.get(k, k))
                     for k in _QUAR_KEYS}, res))
    return out


def test_map_pgs_path_is_per_call():
    """Two interleaved calls on one Mapper that serve different engines
    each get their own path back; ``last_map_path`` is last-writer-wins."""
    m = _port_mapper()
    xs = np.arange(37, dtype=np.uint32)
    out_k, pk = m.map_pgs_path(0, xs, 3)
    out_v, pv = m.map_pgs_path(1, xs, 4)
    assert (pk, pv) == ("kernel-plain", "vm")
    assert out_k.shape == (37, 3) and out_v.shape == (37, 4)
    assert m.last_map_path == "vm"
    _, pk2 = m.map_pgs_path(0, xs, 3)
    assert pk2 == "kernel-plain" and m.last_map_path == "kernel-plain"
    counts, _, sp = m.sweep_path(1, 0, 32, 4)
    assert sp == "vm" and m.last_map_path == "vm"
    assert int(counts.sum()) == 32 * 4


def test_degraded_mapper_keeps_counting_mismatches():
    """A Mapper whose kernel failed stays pinned to the engine it
    promised: every later call counts a mismatch (re-probe far out)."""
    dm = devmon()
    m = _port_mapper(crush_kernel_reprobe_base=3600.0,
                     crush_kernel_reprobe_max=3600.0)
    xs = np.arange(37, dtype=np.uint32)
    assert m.expected_path(0, 3) == "kernel-plain"
    before = dm.perf.dump()["path_mismatch"]
    m.map_pgs(0, xs, 3)
    assert dm.perf.dump()["path_mismatch"] == before
    m._disable_kernel("unit", RuntimeError("injected"))
    assert m.expected_path(0, 3) == "kernel-plain"
    assert m.mapping_path(0, 3) == "vm"
    m.map_pgs(0, xs, 3)
    m.map_pgs(0, xs, 3)
    assert dm.perf.dump()["path_mismatch"] == before + 2
    dm.set_quarantine_state(m._devmon_token, None)


def test_kernel_quarantine_reprobe_cycle():
    """fail -> quarantined -> the due probe runs the kernel on a sample,
    matches the VM bit for bit and re-promotes; the serving output never
    changes, and the counters equal ceph_tpu's for the same cycle."""
    def scenario(m):
        xs = np.arange(37, dtype=np.uint32)
        ref = np.asarray(m.map_pgs(0, xs, 3))
        m._disable_kernel("unit", RuntimeError("injected"))
        info = m.kernel_quarantine_info()
        out, path = m.map_pgs_path(0, xs, 3)
        return (info, path, m.kernel_quarantine_info(),
                np.array_equal(np.asarray(out), ref))
    (mine, (info, path, after, same)), (ref, rres) = _both(scenario)
    assert info == {"state": "quarantined", "failures": 1,
                    "next_probe_in_s": 0.0}
    assert path == "kernel-plain" and after is None and same
    assert (rres[1], rres[2], rres[3]) == ("pallas-interpret", None, True)
    assert mine == ref
    assert (mine["quarantine_entries"], mine["quarantine_exits"],
            mine["quarantine_probes"]) == (1, 1, 1)


def test_kernel_fault_serves_vm_in_the_same_call():
    """A jit_fail on the kernel's launch quarantines it and the VM serves
    the failing call itself; the next call probes and re-promotes. The
    same injected fault drives ceph_tpu's Mapper to the same counters."""
    rule = [F.jit_fail("crush_map_pgs", key="*kern*", count=1)]

    def scenario(m):
        xs = np.arange(37, dtype=np.uint32)
        want = np.asarray(m.map_pgs(0, xs, 3))
        inj = F.FaultInjector(seed=4)
        inj.install("kern", rule)
        devmon_mod.set_fault_injector(inj)
        jax_devmon.set_fault_injector(inj)
        try:
            out, path = m.map_pgs_path(0, xs, 3)
        finally:
            devmon_mod.set_fault_injector(None)
            jax_devmon.set_fault_injector(None)
        state = m.kernel_quarantine_info()["state"]
        out2, path2 = m.map_pgs_path(0, xs, 3)
        return (path, state, path2, np.array_equal(np.asarray(out), want),
                np.array_equal(np.asarray(out2), want))
    (mine, res), (ref, rres) = _both(scenario)
    assert res == ("vm", "quarantined", "kernel-plain", True, True)
    assert rres == ("xla", "quarantined", "pallas-interpret", True, True)
    assert mine == ref
    assert (mine["faults_injected"], mine["path_mismatch"],
            mine["launches_vm"]) == (1, 1, 1)


def test_kernel_quarantine_permanent_after_disable_after():
    """A kernel whose probes keep disagreeing with the VM (its results
    corrupted by a bad_result fault) never re-promotes: after
    crush_kernel_reprobe_disable_after consecutive failures the
    quarantine is permanent and no probe runs again; counters equal
    ceph_tpu's."""
    def scenario(m):
        xs = np.arange(37, dtype=np.uint32)
        ref = np.asarray(m.map_pgs(0, xs, 3))
        m._disable_kernel("unit", RuntimeError("injected"))
        inj = F.FaultInjector(seed=5)
        inj.install("lie", [F.bad_result("crush_map_pgs", key="*kern*")])
        devmon_mod.set_fault_injector(inj)
        jax_devmon.set_fault_injector(inj)
        try:
            out, path = m.map_pgs_path(0, xs, 3)
            m.map_pgs(0, xs, 3)
            info = m.kernel_quarantine_info()
            m.map_pgs(0, xs, 3)
        finally:
            devmon_mod.set_fault_injector(None)
            jax_devmon.set_fault_injector(None)
        expected = m.expected_path(0, 3)
        (jax_devmon.devmon() if isinstance(m, RefMapper) else devmon()) \
            .set_quarantine_state(m._devmon_token, None)
        return (path, np.array_equal(np.asarray(out), ref), info, expected)
    (mine, res), (ref, rres) = _both(scenario)
    assert res == ("vm", True, {"state": "permanent", "failures": 3,
                                "next_probe_in_s": None}, "kernel-plain")
    assert rres == ("xla", True, res[2], "pallas")
    assert mine == ref
    assert (mine["quarantine_probes"],
            mine["quarantine_probe_failures"]) == (2, 2)


def test_mapper_on_card_raises_counts_and_never_serves_vm(monkeypatch):
    """A Mapper on the card: a kernel failure is counted
    (kernel_exec_failures, quarantine_entries) and raised, in map_pgs and
    in sweep; no quarantine state, no VM launch, and the next call runs
    the kernel again. (The Mapper's tensors are on the CPU, tagged as on
    the card, so the injected fault fires at the chokepoint here.)"""
    m = _port_mapper()
    monkeypatch.setattr(mapper_mod, "on_card", lambda mp: mp is m)
    xs = np.arange(37, dtype=np.uint32)
    assert m.mapping_path(0, 3) == "kernel"
    want = m.map_pgs(0, xs, 3)
    dm = devmon()
    before = dm.perf.dump()
    fails0 = mapper_mod.PERF.dump()["kernel_exec_failures"]
    inj = F.FaultInjector(seed=6)
    inj.install("card", [F.jit_fail("crush_map_pgs", key="*kernel*",
                                    count=1),
                         F.jit_fail("crush_sweep", key="*kernel*",
                                    count=1)])
    devmon_mod.set_fault_injector(inj)
    try:
        with pytest.raises(RuntimeError, match="injected device"):
            m.map_pgs(0, xs, 3)
        with pytest.raises(RuntimeError, match="injected device"):
            m.sweep(0, 0, 64, 3)
    finally:
        devmon_mod.set_fault_injector(None)
    after = dm.perf.dump()
    assert mapper_mod.PERF.dump()["kernel_exec_failures"] - fails0 == 2
    assert _delta(before, after, "quarantine_entries") == 2
    assert _delta(before, after, "launches_vm") == 0
    assert _delta(before, after, "quarantined_now") == 0
    assert m.kernel_quarantine_info() is None
    assert m.expected_path(0, 3) == m.mapping_path(0, 3) == "kernel"
    out, path = m.map_pgs_path(0, xs, 3)
    assert path == "kernel" and torch.equal(out, want)


def test_crush_sweep_records_a_standing_degrade():
    """crush_sweep's row names a degrade still standing at the end of its
    run (kernel-plain promised, the VM serving) and path_regressions
    lists it; a healthy run has no such row."""
    from ceph_tpu_torch.bench import crush_sweep
    m = _port_mapper(crush_kernel_reprobe_base=3600.0,
                     crush_kernel_reprobe_max=3600.0)
    healthy = crush_sweep.sweep_rate(m, 1024)
    assert healthy["path"] == "kernel-plain"
    assert "path_expected_vs_actual" not in healthy
    inj = F.FaultInjector(seed=7)
    inj.install("sweep", [F.jit_fail("crush_sweep", key="*kern*")])
    devmon_mod.set_fault_injector(inj)
    try:
        row = crush_sweep.sweep_rate(m, 1024)
    finally:
        devmon_mod.set_fault_injector(None)
    assert row["path"] == "vm"
    assert row["path_expected_vs_actual"] == "kernel-plain->vm"
    assert "path_transient" not in row
    assert crush_sweep.path_regressions({"uniform": healthy,
                                         "degraded": row}) == \
        ["degraded: kernel-plain->vm"]
    devmon().set_quarantine_state(m._devmon_token, None)
