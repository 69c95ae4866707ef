"""``Thrasher.qos_storm`` on the port: ``tests/test_qos.py``'s
``test_two_tenant_qos_and_recovery_floor``.

On the port's ``Cluster(device="cpu")`` alone: a cold tenant with a
reservation and weight in the committed client-profile table writes
paced ops while a hot tenant floods the cluster behind a dispatch cap
of 4, once solo, once with the OSDs' queue in ``fifo`` and once in
``mclock``; then an OSD dies and comes back under the same flood, and
recovery converges while it runs.

In tier-1 the case holds the storm's reports with zero errors and every
cold write acked, recovery converging under the flood with every write
read back, and the client class's grants split by the scheduler's
phases: only ``fifo`` grants in the fifo pass; in the solo and mclock
passes reservation and weight grants (the cold tenant's reservation
served), which add up to the client class's dequeues. The reference's latency
bounds (FIFO's cold p95 past twice the solo p99, mclock's within it,
mclock's cold rate at its reservation) are held by a ``slow`` case of
their own: the reference's case failed them under ``-n 6`` (0.103 s
against 0.080 s) and passed alone, and a timing bound measured on an
oversubscribed host says nothing about the scheduler.
"""

import asyncio
import json

import pytest

from ceph_tpu_torch.cluster.vstart import Cluster
from ceph_tpu_torch.msg import Keyring
from ceph_tpu_torch.osd.scheduler import QOS_PERF
from ceph_tpu_torch.rados import Rados
from ceph_tpu_torch.sim import Thrasher

RUN_LIMIT = 300.0      # s; a stuck script fails instead of holding its worker
GRANTS = ("fifo_grants", "reservation_grants", "weight_grants",
          "dequeued_client", "dequeued_recovery")


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, RUN_LIMIT))


def _grants() -> dict:
    d = QOS_PERF.dump()
    return {k: int(d.get(k, 0)) for k in GRANTS}


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in GRANTS}


async def _qos_storms(c) -> dict:
    """The reference case's cluster script; returns each pass's report
    and grant counts."""
    await c.client.pool_create("qos", pg_num=8)
    await c.wait_for_clean(timeout=120)
    ret, rs, out = await c.client.mon_command(
        {"prefix": "auth get-or-create", "entity": "client.cold"})
    assert ret == 0, rs
    key = bytes.fromhex(json.loads(out)["key"])
    cold = Rados(c.monmap, name="client.cold",
                 keyring=Keyring({"client.cold": key}), config=c.cfg,
                 device=c.device)
    await cold.connect()
    io_cold = await cold.open_ioctx("qos")
    io_hot = await c.client.open_ioctx("qos")
    ret, rs, _ = await c.client.mon_command(
        {"prefix": "osd client-profile", "op": "set",
         "entity": "client.cold", "reservation": 20.0, "weight": 4.0,
         "limit": 0.0})
    assert ret == 0, rs
    ret, _, out = await c.client.mon_command(
        {"prefix": "osd client-profile", "op": "ls"})
    assert ret == 0 and "client.cold" in json.loads(out)["profiles"]
    await c.wait_for_clean(timeout=60)
    for i in range(6):
        await io_cold.write_full(f"warm-c-{i}", b"w" * 256, timeout=30.0)
        await io_hot.write_full(f"warm-h-{i}", b"w" * 256, timeout=30.0)
    th = Thrasher(c, seed=11)
    out = {}
    g = _grants()
    out["solo"] = await th.qos_storm(io_cold, io_hot, writes=24,
                                     hot_parallel=0)
    c.cfg["osd_op_queue"] = "fifo"
    g, out["solo_grants"] = _grants(), _delta(g, _grants())
    out["fifo"] = await th.qos_storm(io_cold, io_hot, writes=24,
                                     hot_parallel=4, hot_burst=16)
    c.cfg["osd_op_queue"] = "mclock"
    g, out["fifo_grants"] = _grants(), _delta(g, _grants())
    out["mclock"] = await th.qos_storm(io_cold, io_hot, writes=24,
                                       hot_parallel=4, hot_burst=16)
    g, out["mclock_grants"] = _grants(), _delta(g, _grants())
    # -- recovery floor under the same flood ---------------------------
    stop = asyncio.Event()

    async def flood(w):
        i = 0
        while not stop.is_set():
            try:
                await io_hot.write_full(f"rf-{w}-{i % 32}", b"h" * 512,
                                        timeout=30.0)
            except Exception:
                pass
            i += 1
    flood_tasks = [asyncio.ensure_future(flood(w)) for w in range(3)]
    try:
        await c.kill_osd(0)
        await c.wait_for_osd_down(0, timeout=60)
        for i in range(12):
            await io_cold.write_full(f"rec-{i}", b"c" * 256, timeout=30.0)
        await c.revive_osd(0)
        await c.wait_for_clean(timeout=120)
    finally:
        stop.set()
        for t in flood_tasks:
            t.cancel()
        await asyncio.gather(*flood_tasks, return_exceptions=True)
    out["recovery_grants"] = _delta(g, _grants())
    for i in range(12):
        assert await io_cold.read(f"rec-{i}") == b"c" * 256
    for oid, data in th.acked.items():
        assert await io_cold.read(oid) == data, oid
    await cold.shutdown()
    return out


def _cluster():
    return Cluster(n_mons=1, n_osds=3, config={
        "osd_client_message_cap": 4, "osd_op_queue": "mclock",
        "mon_osd_down_out_interval": 600.0}, device="cpu")


def test_two_tenant_qos_storm_and_recovery_floor():
    async def go():
        c = await _cluster().start()
        try:
            out = await _qos_storms(c)
        finally:
            await c.stop()
        return out
    out = run(go())
    for name in ("solo", "fifo", "mclock"):
        rep = out[name]
        assert rep["cold_errors"] == 0 and rep["cold_ops"] == 24, rep
        assert rep["cold_p50_s"] <= rep["cold_p95_s"] <= rep["cold_p99_s"]
    assert out["solo"]["hot_ops"] == 0
    assert out["fifo"]["mode"] == "fifo" and out["fifo"]["hot_ops"] > 0
    assert out["mclock"]["mode"] == "mclock" and out["mclock"]["hot_ops"] > 0
    solo, fifo, mclock = (out[f"{n}_grants"]
                          for n in ("solo", "fifo", "mclock"))
    # solo: the cold tenant alone, granted by mclock's two phases
    assert solo["fifo_grants"] == 0
    assert solo["reservation_grants"] + solo["weight_grants"] == \
        solo["dequeued_client"] >= 24
    # fifo: every grant from the fifo queue
    assert fifo["fifo_grants"] > 0
    assert fifo["reservation_grants"] == fifo["weight_grants"] == 0
    # mclock: the client class's grants split into the cold tenant's
    # reservation and the weight phase; the fifo grants are the queue
    # left when the mode flipped: at most the hot writes then in flight
    # (4 writers x 16), once on each of 3 OSDs
    assert mclock["reservation_grants"] > 0 and mclock["weight_grants"] > 0
    assert mclock["reservation_grants"] + mclock["weight_grants"] == \
        mclock["dequeued_client"]
    assert mclock["fifo_grants"] <= 4 * 16 * 3


@pytest.mark.slow
def test_two_tenant_qos_latency_bounds():
    """The reference case's latency bounds, compared at p95 as it does."""
    async def go():
        c = await _cluster().start()
        try:
            return await _qos_storms(c)
        finally:
            await c.stop()
    out = run(go())
    solo, fifo, mclock = out["solo"], out["fifo"], out["mclock"]
    floor = max(2.0 * solo["cold_p99_s"], 0.08)
    assert fifo["cold_p95_s"] > floor, (fifo, solo)
    assert mclock["cold_p95_s"] <= floor, (mclock, solo)
    assert mclock["cold_errors"] == 0
    assert mclock["cold_ops_per_s"] >= 20.0 * 0.6, mclock
