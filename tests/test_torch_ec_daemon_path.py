"""The port's ``ec_daemon_path`` bench section on the CPU, against
ceph_tpu's.

Mirrors tests/test_meta.py's ``test_ec_daemon_path_bench_schema``: at a
smoke size the record is JSON-clean, carries every key of ceph_tpu's
record (the per-op baseline, the aggregated daemon path, the resident
reference, the batch count and the ``daemon_within_2x_resident``
verdict) plus the port's ``device`` and ``gpu_name``, and at least one
coalesced batch launched. The within-2x claim is a card measurement; on
the CPU the record says so (``cpu_caveat``). The default shape follows
the device and the ``CEPH_TPU_BENCH_ECDAEMON_*`` overrides.
"""

import json

import pytest
import torch

from ceph_tpu.bench.ec_daemon_path import \
    ec_daemon_path_section as jax_section
from ceph_tpu_torch.bench import ec_daemon_path

# large enough that no rate rounds to 0.0 on a loaded CPU (the record
# keeps 4 decimals of GiB/s)
SMOKE = dict(n_ops=4, stripes_per_op=4, chunk_size=4096, k=2, m=1, reps=1)


@pytest.fixture(scope="module")
def records():
    return (jax_section(**SMOKE),
            ec_daemon_path.ec_daemon_path_section(device="cpu", **SMOKE))


def test_record_has_the_reference_keys(records):
    ref, rec = records
    assert set(ref) <= set(rec)
    assert set(rec) - set(ref) == {"device", "gpu_name"}
    assert rec["device"] == "cpu" and rec["gpu_name"] is None
    assert rec["platform"] == ref["platform"] == "cpu"
    for key in ("n_ops", "stripes_per_op", "chunk_size", "k", "m",
                "op_bytes", "total_bytes"):
        assert rec[key] == ref[key], key
    assert json.loads(json.dumps(rec)) == rec


@pytest.mark.parametrize("key", ["per_op_GiBs", "read_agg_GiBs",
                                 "resident_GiBs"])
def test_rates_are_positive_floats(records, key):
    assert isinstance(records[1][key], float) and records[1][key] > 0


def test_verdict_and_batches(records):
    rec = records[1]
    assert isinstance(rec["daemon_within_2x_resident"], bool)
    assert rec["read_agg_batches"] >= 1
    assert rec["read_agg_speedup_vs_per_op"] > 0
    assert "cpu_caveat" in rec


def test_default_shape_by_device_and_env(monkeypatch):
    """Production shape on CUDA, smoke on the CPU; the env overrides win
    over both, as ceph_tpu's section reads them."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert ec_daemon_path._default_shape(cuda) == (256, 32, 4096)
    assert ec_daemon_path._default_shape(cpu) == (16, 4, 1024)
    monkeypatch.setenv("CEPH_TPU_BENCH_ECDAEMON_OPS", "3")
    monkeypatch.setenv("CEPH_TPU_BENCH_ECDAEMON_STRIPES", "2")
    monkeypatch.setenv("CEPH_TPU_BENCH_ECDAEMON_CHUNK", "64")
    assert ec_daemon_path._default_shape(cuda) == (3, 2, 64)
    rec = ec_daemon_path.main(["--device", "cpu"])
    assert (rec["n_ops"], rec["stripes_per_op"], rec["chunk_size"]) == \
        (3, 2, 64)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ec_daemon_path.ec_daemon_path_section(**SMOKE)
