"""``Thrasher.device_storm`` on the port: ``tests/test_devmon.py``'s
``test_device_storm_cluster``, with the port's plugin and Mapper on the
CPU.

On the port's ``Cluster(device="cpu")`` alone, held to the reference's
own invariants: ``jit_fail``, ``jit_stall`` and ``bad_result`` bursts at
devmon's chokepoint while replicated and erasure-coded client writes
flow give zero client-visible errors; a poisoned EC encode is absorbed
by the OSD aggregator's degrade ladder; the probe Mapper's kernel path
(``kernel-plain`` on the CPU, the reference's ``pallas-interpret``) is
quarantined, refuses a corrupt re-probe and is re-promoted bit-exact;
the quarantine reaches the mon's ``device-runtime status``; every acked
write reads back on settle. The ladder's host rungs and the quarantine
serve only on the CPU: on the card the storm raises (checked here), and
``tests/test_torch_cuda_storm.py`` holds what the card does instead.
"""

import asyncio
import json

import pytest

from ceph_tpu_torch.cluster.vstart import Cluster
from ceph_tpu_torch.sim import Thrasher

RUN_LIMIT = 300.0      # s; a stuck script fails instead of holding its worker


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, RUN_LIMIT))


def test_device_storm_cluster():
    async def go():
        c = await Cluster(n_mons=1, n_osds=4,
                          config={"mon_osd_down_out_interval": 2.0},
                          device="cpu").start()
        try:
            await c.client.pool_create("rp", pg_num=4, size=2)
            ret, rs, _ = await c.client.mon_command(
                {"prefix": "osd erasure-code-profile set",
                 "name": "kprof",
                 "profile": ["k=2", "m=1", "crush-failure-domain=osd",
                             "stripe_unit=1024"]})
            assert ret == 0, rs
            ret, rs, _ = await c.client.mon_command(
                {"prefix": "osd pool create", "pool": "ecpool",
                 "pg_num": 4, "pool_type": "erasure",
                 "erasure_code_profile": "kprof"})
            assert ret == 0, rs
            await c.wait_for_clean(timeout=240)
            io = await c.client.open_ioctx("rp")
            io_ec = await c.client.open_ioctx("ecpool")

            th = Thrasher(c, seed=16, min_live_osds=4)
            summary = await th.device_storm(io, io_ec, ec_writes=6)
            assert summary["write_errors"] == 0
            assert summary["ec_writes_acked"] == 6
            assert summary["quarantine_entries"] >= 1
            assert summary["quarantine_exits"] >= 1
            assert summary["probes"] >= 2           # refused + clean
            assert summary["probe_failures"] >= 1   # the bad_result
            assert summary["repromoted_path"] == "kernel-plain"
            assert summary["ec_degraded_ops"] >= 1  # ladder engaged
            assert summary["faults_injected"] >= 2
            await th.settle_and_verify(io)

            ret, _, out = await c.client.mon_command(
                {"prefix": "device-runtime status"})
            assert ret == 0
            drs = json.loads(out)
            row = drs["daemons"].get("osd.0")
            assert row is not None and "quarantine" in row, drs
        finally:
            await c.stop()
    run(go())


def test_device_storm_refuses_a_cluster_on_the_card():
    """No host path serves on the card, so the storm's degrade legs
    cannot hold there: it raises before it injects anything."""
    class OnCard:
        device = type("Dev", (), {"type": "cuda"})()
        backend = "inproc"

        def install_faults(self, injector):
            self.injector = injector

    th = Thrasher(OnCard(), seed=16)
    with pytest.raises(RuntimeError, match="on the CPU"):
        run(th.device_storm(None, None))
