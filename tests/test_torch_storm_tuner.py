"""``Thrasher.tuner_storm`` on the port: ``tests/test_tuner.py``'s
``test_tuner_closed_loop_storm``.

On the port's ``Cluster(device="cpu")`` alone (two mgrs running the
progress and tuner modules, drive mode), held to the reference's own
invariants: a steady balanced two-pool workload commits no action; a
hot-pool burst through ``tuner_storm`` trips the hot-pool protector, a
guardrailed client-profile commit whose audit entry carries the sensor
readings, and the heal removes the owned profile; a mgr failover in
the middle of a second storm promotes a standby whose tuner resumes
without committing again, and the revert after the storm is the
promoted incarnation's. No cold write errors in either storm.
"""

import asyncio
import json

from ceph_tpu_torch.cluster.vstart import Cluster
from ceph_tpu_torch.mgr.modules import ProgressModule
from ceph_tpu_torch.mgr.tuner import TunerModule
from ceph_tpu_torch.msg import Keyring
from ceph_tpu_torch.rados import Rados
from ceph_tpu_torch.sim import Thrasher

RUN_LIMIT = 300.0      # s; a stuck script fails instead of holding its worker


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, RUN_LIMIT))


def test_tuner_closed_loop_storm():
    """Closed loop on a live cluster, drive mode, one spin:

    - a steady balanced two-pool workload commits ZERO actions;
    - a hot-pool burst trips the protector — a guardrailed
      client-profile commit whose audit entry carries the sensor
      readings that justified it, visible in `ceph progress ls`;
    - the heal removes the owned profile (act/revert pair);
    - a mgr failover mid-storm promotes a standby whose tuner resumes
      WITHOUT double-committing, and the revert after the storm is
      the promoted incarnation's.
    """
    async def go():
        c = await Cluster(
            n_mons=1, n_osds=3, n_mgrs=2,
            mgr_modules=[ProgressModule, TunerModule],
            config={
                "osd_client_message_cap": 4,
                "osd_op_queue": "mclock",
                # fresh counts in every rate window (the tick must
                # never see two identical pg dumps mid-burst, or the
                # consecutive-breach streak resets)
                "osd_stats_interval": 0.1,
                # off during boot/teardown; flipped live below
                "mgr_tuner_mode": "off",
                "mgr_tuner_interval": 0.25,
                "mgr_tuner_act_ticks": 3,
                "mgr_tuner_revert_ticks": 3,
                "mgr_tuner_hot_pool_min_ops": 30.0,
                "mgr_tuner_hot_pool_ratio": 4.0,
                # keep the recovery governor out of the frame: no
                # backfill here, and no latency under a 30 s op
                # timeout can breach this floor
                "mgr_tuner_qos_floor_ms": 60000.0,
            }, device="cpu").start()
        try:
            await c.client.pool_create("cold", pg_num=4)
            await c.client.pool_create("hot", pg_num=4)
            await c.wait_for_clean(timeout=120)
            ret, rs, out = await c.client.mon_command(
                {"prefix": "auth get-or-create",
                 "entity": "client.hot"})
            assert ret == 0, rs
            key = bytes.fromhex(json.loads(out)["key"])
            hot = Rados(c.monmap, name="client.hot",
                        keyring=Keyring({"client.hot": key}),
                        config=c.cfg, device=c.device)
            await hot.connect()
            io_hot = await hot.open_ioctx("hot")
            io_cold = await c.client.open_ioctx("cold")
            for i in range(4):           # warm both write paths
                await io_cold.write_full(f"w-{i}", b"w" * 256,
                                         timeout=30.0)
                await io_hot.write_full(f"w-{i}", b"w" * 256,
                                        timeout=30.0)

            async def tune_status():
                ret, _, out = await c.client.mon_command(
                    {"prefix": "tune status"})
                assert ret == 0
                return json.loads(out)

            # -- steady: balanced trickle, drive mode, ZERO commits --
            c.cfg["mgr_tuner_mode"] = "drive"
            for i in range(12):
                await io_cold.write_full(f"s-{i}", b"s" * 256,
                                         timeout=30.0)
                await io_hot.write_full(f"s-{i}", b"s" * 256,
                                        timeout=30.0)
                await asyncio.sleep(0.04)
            await asyncio.sleep(1.2)     # several tuner ticks
            st = await tune_status()
            assert st["mode"] == "drive"
            assert st["committed"] == 0 and st["reverted"] == 0, st

            # -- storm 1: the protector trips and heals --------------
            th = Thrasher(c, seed=17)
            storm = await th.tuner_storm(io_cold, io_hot, writes=24,
                                         hot_parallel=4,
                                         hot_burst=16, ramp_s=1.0)
            assert storm["cold_errors"] == 0
            assert storm["tuner"]["committed"] >= 1, storm
            log_entries = (await c.client.mon_command(
                {"prefix": "tune log"}))[2]
            entries = json.loads(log_entries)["entries"]
            act = next(e for e in entries
                       if e["policy"] == "hot_pool_protector" and
                       e["action"] == "act")
            assert act["committed"] is True
            assert act["sensors"]["entity"] == "client.hot"
            assert act["sensors"]["hot_pool_rate"] > 0
            assert act["cmd"]["prefix"] == "osd client-profile"
            # heal: the owned profile comes off within the revert
            # window once the burst stops
            deadline = asyncio.get_event_loop().time() + 20.0
            while True:
                st = await tune_status()
                if not st["owned"]:
                    break
                assert asyncio.get_event_loop().time() < deadline, \
                    f"tuner never reverted: {st}"
                await asyncio.sleep(0.2)
            assert st["reverted"] >= 1

            # -- storm 2: mgr failover mid-storm, no double-commit ---
            base = await tune_status()
            storm_task = asyncio.ensure_future(
                th.tuner_storm(io_cold, io_hot, writes=24,
                               hot_parallel=4, hot_burst=16,
                               ramp_s=1.0, cold_think_s=0.05))
            deadline = asyncio.get_event_loop().time() + 25.0
            while True:                  # wait for the commit to land
                st = await tune_status()
                if st["committed"] > base["committed"]:
                    break
                assert asyncio.get_event_loop().time() < deadline, \
                    "storm 2 never tripped the protector"
                await asyncio.sleep(0.2)
            committed_mid = st["committed"]
            assert "profile:client.hot" in st["owned"]
            # the in-flight act renders as a held tuner event in
            # `ceph progress ls` (the mgr digests it monward)
            deadline = asyncio.get_event_loop().time() + 5.0
            while True:
                ret, _, pout = await c.client.mon_command(
                    {"prefix": "progress ls"})
                evs = json.loads(pout)["events"]
                if any(e.get("id") == "tuner:profile:client.hot"
                       for e in evs):
                    break
                assert asyncio.get_event_loop().time() < deadline, \
                    f"no tuner progress event: {evs}"
                await asyncio.sleep(0.2)
            old = await c.kill_mgr()
            new = await c.wait_for_mgr_active(not_gid=old.gid,
                                              timeout=30)
            assert new is not None and new.gid != old.gid
            storm2 = await storm_task
            assert storm2["cold_errors"] == 0
            # the promoted tuner saw desired == actual: same commit
            # count, and the heal (its revert) still lands
            st = await tune_status()
            assert st["committed"] == committed_mid, st
            deadline = asyncio.get_event_loop().time() + 20.0
            while True:
                st = await tune_status()
                if not st["owned"]:
                    break
                assert asyncio.get_event_loop().time() < deadline, \
                    f"promoted tuner never reverted: {st}"
                await asyncio.sleep(0.2)
            assert st["committed"] == committed_mid
            c.cfg["mgr_tuner_mode"] = "off"
            await hot.shutdown()
        finally:
            await c.stop()
    run(go())
