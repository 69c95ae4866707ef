"""The port's closed-loop load generator (``ceph_tpu_torch/sim/loadgen.py``)
held against ``ceph_tpu``'s.

- ``LoadGen`` in both packages over one scripted stand-in client (a
  cluster whose ioctx records each op and refuses a write that is a
  seventh, fourteenth, ... op):
  the same seed gives the same op sequence, the same report keys and the
  same counts and error samples; only latencies and rates, which are
  timings, differ.
- ``tests/test_loadgen_sharded.py::test_loadgen_sharded_10k_one_worker``
  on the port's ``Cluster(device="cpu")``: 10k sessions through one
  worker process with zero errors and every op acked. The cluster has no
  conf file, so ``run_sharded`` writes one, with the cluster's device in
  it (a worker without it would map on the card and fail here). The
  reference's ``run_sharded`` then drives the same port cluster with its
  own worker, and the two merged reports have the same keys, as do their
  per-worker reports.
- ``tests/test_qos.py::test_loadgen_10k_sessions`` in process, ``slow``
  as in the reference.
"""

import asyncio
import random
import time

import pytest

from ceph_tpu.sim import loadgen as ref_loadgen
from ceph_tpu_torch.cluster.vstart import Cluster
from ceph_tpu_torch.sim import loadgen

RUN_LIMIT = 300.0      # s; a stuck script fails instead of holding its worker


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, RUN_LIMIT))


class _ScriptedIoCtx:
    """Records every op; a write that is a 7th, 14th, ... op raises."""

    def __init__(self):
        self.ops: list = []

    async def write_full(self, oid, data, timeout=None):
        await asyncio.sleep(0)
        self.ops.append(("w", oid, len(data), data[:1]))
        if len(self.ops) % 7 == 0:
            raise RuntimeError(f"refused {oid}")

    async def read(self, oid, timeout=None):
        await asyncio.sleep(0)
        self.ops.append(("r", oid))
        return b""


class _ScriptedCluster:
    def __init__(self):
        self.io = _ScriptedIoCtx()
        cluster = self

        class Client:
            async def open_ioctx(self, pool):
                return cluster.io
        self.client = Client()


def test_loadgen_report_matches_the_reference():
    async def go(mod):
        c = _ScriptedCluster()
        report = await mod.LoadGen(c, "p", sessions=40, clients=1,
                                   ops_per_session=5, write_bytes=64,
                                   read_fraction=0.5, concurrency=8,
                                   seed=3).run()
        return report, c.io.ops
    port, port_ops = run(go(loadgen))
    ref, ref_ops = run(go(ref_loadgen))
    assert port_ops == ref_ops and len(port_ops) == 200
    assert list(port) == list(ref)
    for k in ("sessions", "clients", "ops", "errors", "error_samples"):
        assert port[k] == ref[k], k
    refused = sum(1 for i, op in enumerate(port_ops, 1)
                  if i % 7 == 0 and op[0] == "w")
    assert port["errors"] == refused > 0
    assert port["ops"] == 200 - refused
    assert port["p50_ms"] <= port["p99_ms"] <= port["max_ms"]
    lats = sorted(random.Random(1).random() for _ in range(101))
    for q in (0.0, 0.5, 0.99, 1.0):
        assert loadgen.percentile(lats, q) == ref_loadgen.percentile(lats, q)


def test_loadgen_sharded_10k_one_worker():
    """10k sessions through one worker process: zero errors, all ops
    acked, merged percentiles present and ordered; the reference's
    ``run_sharded`` on the same cluster reports the same keys."""
    async def go():
        c = await Cluster(n_mons=1, n_osds=3, config={
            "osd_client_message_cap": 1024}, device="cpu").start()
        try:
            await c.client.pool_create("load", pg_num=16)
            await c.wait_for_clean(timeout=240)
            t0 = time.perf_counter()
            report = await loadgen.run_sharded(
                c, "load", sessions=10000, workers=1, clients=16,
                ops_per_session=1, write_bytes=128,
                concurrency=512, op_timeout=120.0)
            assert report["errors"] == 0, report["error_samples"]
            assert report["sessions"] == 10_000
            assert report["ops"] == 10_000
            assert report["workers"] == 1
            assert len(report["per_worker"]) == 1
            assert report["p50_ms"] <= report["p99_ms"] <= \
                report["max_ms"]
            assert report["ops_per_s"] > 0
            print(f"sharded 10k/1w: {report['ops_per_s']} ops/s, "
                  f"p50 {report['p50_ms']} ms, "
                  f"p99 {report['p99_ms']} ms "
                  f"({time.perf_counter() - t0:.1f}s wall)")
            ref = await ref_loadgen.run_sharded(
                c, "load", sessions=50, workers=1, clients=2,
                ops_per_session=1, write_bytes=128, op_timeout=120.0)
            assert ref["errors"] == 0, ref["error_samples"]
            assert list(report) == list(ref)
            assert list(report["per_worker"][0]) == \
                list(ref["per_worker"][0])
        finally:
            await c.stop()
    run(go())


@pytest.mark.slow
def test_loadgen_10k_sessions():
    """tests/test_qos.py::test_loadgen_10k_sessions on the port: 10k
    sessions in process over 16 handles complete with zero errors."""
    async def go():
        c = await Cluster(n_mons=1, n_osds=3, config={
            "osd_client_message_cap": 1024}, device="cpu").start()
        try:
            await c.client.pool_create("load", pg_num=16)
            await c.wait_for_clean(timeout=240)
            report = await loadgen.LoadGen(
                c, "load", sessions=10_000, clients=16,
                ops_per_session=2, write_bytes=128,
                concurrency=256, op_timeout=120.0).run()
            assert report["errors"] == 0, report["error_samples"]
            assert report["ops"] == 20_000
            assert report["sessions"] == 10_000
        finally:
            await c.stop()
    asyncio.run(asyncio.wait_for(go(), 1800.0))
