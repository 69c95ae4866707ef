"""The port's device-runtime monitor held against ceph_tpu's.

Mirrors the EC-relevant cases of tests/test_devmon.py: the monitor's own
units (counter names, first-launch accounting with un-warm on failure, the oldest-only warm-set eviction,
device fault injection at the chokepoint), plus what the EC plugins
report through it: first launches of ``ec_encode`` / ``ec_decode`` /
``ec_encode_crc`` / ``scrub_crc`` and the pipeline's transfer bytes,
compared with what ceph_tpu's plugin reports to its own monitor for the
same calls. Counts are integers, compared exactly.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.ec.jax_plugin import ErasureCodeJax
from ceph_tpu.ec.jax_plugin import StreamingEncodePipeline as JaxPipe
from ceph_tpu.sim import faults as F
from ceph_tpu.utils import devmon as jax_devmon
from ceph_tpu_torch.ec import crc as ec_crc
from ceph_tpu_torch.ec.torch_plugin import (ErasureCodeTorch,
                                            StreamingEncodePipeline)
from ceph_tpu_torch.utils import devmon as devmon_mod
from ceph_tpu_torch.utils.devmon import DeviceRuntimeMonitor, devmon


def _delta(before: dict, after: dict, key: str) -> int:
    return int(after.get(key, 0)) - int(before.get(key, 0))


def test_counter_names_match_reference():
    """Every counter keeps the reference's name, so the mgr and
    Prometheus rows match; the port holds the first-launch, transfer and
    fault side (the kernel-path health side lands with the Mapper's
    quarantine)."""
    mine = DeviceRuntimeMonitor(name="devmon_t_names", register=False)
    theirs = jax_devmon.DeviceRuntimeMonitor(name="devmon_j_names",
                                             register=False)
    assert set(mine.perf.dump()) <= set(theirs.perf.dump())
    assert set(mine.perf.dump()) == {
        "jit_compiles", "jit_compile_seconds", "h2d_bytes", "d2h_bytes",
        "device_bytes_staged", "device_bytes_watermark",
        "faults_injected", "stream_fallbacks"}
    d = mine.dump()
    assert d["engine"] == devmon_mod.engine_name()
    assert d["engine"] == ("cuda" if torch.cuda.is_available() else "cpu")


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
