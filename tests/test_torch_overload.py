"""tests/test_overload.py's cases on the port: the admission-control
tier of ``ceph_tpu_torch`` (the message throttle, the osdmap service
flags, pool quotas, the OSD's local failsafe, noout with the
mark-me-down fast path, failure-report hygiene) and the PG's client
backoff path with ``OVERLOAD_PERF``'s counters pinned.

The backoff case waits on state, never on a fixed sleep: the reference's
(``test_backoff_released_on_pg_activation``) sets a PG to ``peering`` by
hand and then sleeps 0.3 s, and under load a late map epoch can
re-advance the PG within that sleep and release the backoff early. Here
every OSD first holds the leader's epoch and the PG is clean, and then
the PG's ``advance`` is held until the test calls it itself.

The overload storm case, which drives the port's Thrasher, is in
``tests/test_torch_storm_overload.py``.
"""

import asyncio
import time

import pytest

from ceph_tpu_torch.cluster.vstart import Cluster
from ceph_tpu_torch.mon.messages import MOSDFailure
from ceph_tpu_torch.osd.daemon import OVERLOAD_PERF
from ceph_tpu_torch.rados import ObjectOperationError
from ceph_tpu_torch.utils.throttle import MessageThrottle


def run(coro):
    asyncio.run(coro)


# -- units -----------------------------------------------------------------

def test_message_throttle_caps_and_fifo():
    async def go():
        th = MessageThrottle(max_ops=2, max_bytes=100)
        await th.acquire(10)
        await th.acquire(10)
        order = []

        async def waiter(tag, nbytes):
            await th.acquire(nbytes)
            order.append(tag)
        w1 = asyncio.ensure_future(waiter("a", 10))
        w2 = asyncio.ensure_future(waiter("b", 10))
        await asyncio.sleep(0)
        assert not order                   # both blocked at the cap
        assert th.saturated
        th.release(10)
        await asyncio.gather(w1, asyncio.sleep(0.01))
        assert order == ["a"]              # FIFO
        th.release(10)
        await w2
        assert order == ["a", "b"]
        assert th.peak_ops == 2 and th.waited == 2
        # byte budget: a single over-budget op still admits alone
        th2 = MessageThrottle(max_ops=0, max_bytes=50)
        await th2.acquire(500)
        th2.release(500)
    run(go())


def test_flag_machinery_unit():
    from ceph_tpu_torch.osd.osdmap import (
        FLAG_FULL, FLAG_NAMES, FLAG_NOOUT, flag_names,
    )
    from ceph_tpu_torch.osd.types import (
        FLAG_POOL_FULL, FLAG_POOL_FULL_QUOTA, PGPool,
    )
    assert flag_names(FLAG_FULL | FLAG_NOOUT) == "full,noout"
    assert set(FLAG_NAMES) == {"pauserd", "pausewr", "full", "noout",
                               "nodown", "noup", "noin"}
    p = PGPool(id=1, name="q")
    assert not p.is_full()
    p.flags |= FLAG_POOL_FULL_QUOTA
    assert p.is_full()
    p.flags = FLAG_POOL_FULL
    assert p.is_full()


# -- cluster: flags + quotas ----------------------------------------------

async def _wait_flags(c, want: str, present: bool = True,
                      timeout: float = 15.0):
    """Until `want` is (not) in the status flag string AND the client's
    own map agrees — the gates run against the CLIENT's map."""
    deadline = asyncio.get_event_loop().time() + timeout
    while True:
        status = await c.client.status()
        flags = status["osdmap"].get("flags", "").split(",")
        lead = c.leader()
        epoch = lead.osdmon.osdmap.epoch if lead else 0
        cm = c.client.monc.osdmap
        if (want in flags) == present and cm is not None and \
                cm.epoch >= epoch:
            return
        if asyncio.get_event_loop().time() > deadline:
            raise TimeoutError(f"flags={flags} want {want} "
                               f"present={present}")
        await c.client.monc.subscribe(
            "osdmap", (cm.epoch + 1) if cm else 0)
        await asyncio.sleep(0.1)


def test_flags_park_writes_and_full_try():
    """pausewr parks writes (reads flow); FULL parks writes or fails
    them fast -ENOSPC under FULL_TRY; clearing the flag resumes the
    parked op with no data loss."""
    async def go():
        c = await Cluster(n_mons=1, n_osds=3, device="cpu").start()
        try:
            await c.client.pool_create("ov", pg_num=4)
            await c.wait_for_clean(timeout=120)
            io = await c.client.open_ioctx("ov")
            await io.write_full("a", b"base")
            ret, rs, _ = await c.client.mon_command(
                {"prefix": "osd set", "key": "pausewr"})
            assert ret == 0, rs
            await _wait_flags(c, "pausewr")
            parked = asyncio.ensure_future(
                io.write_full("a", b"paused-write", timeout=30.0))
            await asyncio.sleep(0.6)
            assert not parked.done()            # parked, not failed
            assert await io.read("a") == b"base"   # reads still flow
            ret, _, _ = await c.client.mon_command(
                {"prefix": "osd unset", "key": "pausewr"})
            assert ret == 0
            await asyncio.wait_for(parked, timeout=15.0)
            assert await io.read("a") == b"paused-write"
            # unknown flag is rejected
            ret, _, _ = await c.client.mon_command(
                {"prefix": "osd set", "key": "bogus"})
            assert ret == -22

            # manual FULL: FULL_TRY fails fast, plain write parks
            ret, _, _ = await c.client.mon_command(
                {"prefix": "osd set", "key": "full"})
            assert ret == 0
            await _wait_flags(c, "full")
            with pytest.raises(ObjectOperationError) as ei:
                await io.write_full("b", b"x", full_try=True)
            assert ei.value.errno == -28            # -ENOSPC
            status = await c.client.status()
            assert "OSDMAP_FLAGS" in status["health"]["checks"]
            parked = asyncio.ensure_future(
                io.write_full("b", b"eventually", timeout=30.0))
            await asyncio.sleep(0.5)
            assert not parked.done()
            ret, _, _ = await c.client.mon_command(
                {"prefix": "osd unset", "key": "full"})
            assert ret == 0
            await asyncio.wait_for(parked, timeout=15.0)
            assert await io.read("b") == b"eventually"
        finally:
            await c.stop()
    run(go())


def test_pool_quota_objects_and_bytes():
    """set-quota enforcement: past max_objects the mon flags the pool
    full-quota — writes -EDQUOT under FULL_TRY, park otherwise, and
    resume when the quota is raised; byte quotas trip the same way."""
    async def go():
        c = await Cluster(n_mons=1, n_osds=3, device="cpu").start()
        try:
            await c.client.pool_create("q", pg_num=4)
            await c.wait_for_clean(timeout=120)
            io = await c.client.open_ioctx("q")
            ret, rs, _ = await c.client.mon_command(
                {"prefix": "osd pool set-quota", "pool": "q",
                 "field": "max_objects", "val": "4"})
            assert ret == 0, rs
            for i in range(5):
                await io.write_full(f"q-{i}", b"z" * 64)
            # the fullness sweep needs a stats report to see 5 >= 4
            deadline = asyncio.get_event_loop().time() + 15.0
            while True:
                status = await c.client.status()
                pq = {p["name"]: p for p in
                      status["osdmap"].get("pool_quotas", [])}
                if pq.get("q", {}).get("full"):
                    break
                assert asyncio.get_event_loop().time() < deadline, \
                    f"pool never flagged full: {pq}"
                await asyncio.sleep(0.1)
            assert "POOL_QUOTA_FULL" in \
                (await c.client.status())["health"]["checks"]
            # client map must carry the flagged pool before the gates act
            lead_epoch = c.leader().osdmon.osdmap.epoch
            await c.client.monc.wait_for_osdmap(min_epoch=lead_epoch)
            with pytest.raises(ObjectOperationError) as ei:
                await io.write_full("q-over", b"x", full_try=True)
            assert ei.value.errno == -122           # -EDQUOT
            parked = asyncio.ensure_future(
                io.write_full("q-parked", b"later", timeout=30.0))
            await asyncio.sleep(0.5)
            assert not parked.done()
            # raising the quota resumes the parked write
            ret, _, _ = await c.client.mon_command(
                {"prefix": "osd pool set-quota", "pool": "q",
                 "field": "max_objects", "val": "0"})
            assert ret == 0
            await asyncio.wait_for(parked, timeout=15.0)
            assert await io.read("q-parked") == b"later"
            # byte quota trips too
            ret, _, _ = await c.client.mon_command(
                {"prefix": "osd pool set-quota", "pool": "q",
                 "field": "max_bytes", "val": "1"})
            assert ret == 0
            deadline = asyncio.get_event_loop().time() + 15.0
            while True:
                status = await c.client.status()
                pq = {p["name"]: p for p in
                      status["osdmap"].get("pool_quotas", [])}
                if pq.get("q", {}).get("full"):
                    break
                assert asyncio.get_event_loop().time() < deadline
                await asyncio.sleep(0.1)
            lead_epoch = c.leader().osdmon.osdmap.epoch
            await c.client.monc.wait_for_osdmap(min_epoch=lead_epoch)
            with pytest.raises(ObjectOperationError) as ei:
                await io.write_full("q-bytes", b"x", full_try=True)
            assert ei.value.errno == -122
        finally:
            await c.stop()
    run(go())


# -- cluster: OSD failsafe -------------------------------------------------

def test_failsafe_rejects_stale_map_write():
    """A write carrying a pre-FULL osdmap against a >=97%-full OSD is
    rejected -ENOSPC by the OSD's LOCAL failsafe, never partially
    applied. Mon ratios are pushed out of reach so the FULL flag
    never enters the client's map — the map is 'stale' by
    construction."""
    async def go():
        cfg = {"mon_osd_full_ratio": 9.9,
               "mon_osd_nearfull_ratio": 9.8}
        c = await Cluster(n_mons=1, n_osds=3, config=cfg,
                          device="cpu").start()
        try:
            await c.client.pool_create("fs", pg_num=4)
            await c.wait_for_clean(timeout=120)
            io = await c.client.open_ioctx("fs")
            await io.write_full("fill", b"f" * 65536)
            # shrink capacity to ~ the bytes already stored: every OSD
            # is instantly past osd_failsafe_full_ratio (0.97)
            used = max(o.store_used_bytes() for o in c.osds)
            c.cfg["osd_capacity_bytes"] = used
            await asyncio.sleep(0.7)        # used-bytes cache expiry
            from ceph_tpu_torch.osd.osdmap import FLAG_FULL
            cm = c.client.monc.osdmap
            assert cm is not None and not cm.flags & FLAG_FULL, \
                "client map must stay pre-FULL for this test"
            with pytest.raises(ObjectOperationError) as ei:
                await io.write_full("reject-me", b"x" * 1024,
                                    full_try=True)
            assert ei.value.errno == -28
            # never partially applied: the object does not exist
            with pytest.raises(ObjectOperationError) as ei:
                await io.read("reject-me")
            assert ei.value.errno == -2
            # reads still served at failsafe
            assert await io.read("fill", length=4) == b"ffff"
        finally:
            c.cfg["osd_capacity_bytes"] = 0
            await c.stop()
    run(go())


# -- cluster: noout + graceful mark-me-down --------------------------------

def test_noout_and_mark_me_down():
    """`osd set noout` + OSD stop: the OSD is marked down (fast, via
    MOSDMarkMeDown — no heartbeat-grace burn) but never auto-marked
    out; `unset noout` resumes the down-out tick."""
    async def go():
        cfg = {"mon_osd_down_out_interval": 1.0}
        c = await Cluster(n_mons=1, n_osds=3, config=cfg,
                          device="cpu").start()
        try:
            await c.client.pool_create("no", pg_num=2, size=2,
                                       min_size=1)
            await c.wait_for_clean(timeout=120)
            ret, _, _ = await c.client.mon_command(
                {"prefix": "osd set", "key": "noout"})
            assert ret == 0
            lead = c.leader()
            t0 = asyncio.get_event_loop().time()
            await c.osds[2].stop(mark_down=True)     # graceful
            # the strong property: the down COMMITTED before stop()
            # returned (the crash path can never do this — it only
            # stops answering heartbeats and burns the grace period)
            assert not bool(lead.osdmon.osdmap.is_up(2)), \
                "graceful stop did not commit down before exit"
            took = asyncio.get_event_loop().time() - t0
            assert took < 3.0, f"mark-me-down too slow ({took:.2f}s)"
            # noout: down for > down_out_interval yet still in
            await asyncio.sleep(2.2)
            assert lead.osdmon.osdmap.osd_weight[2] > 0, \
                "osd auto-outed despite noout"
            ret, _, _ = await c.client.mon_command(
                {"prefix": "osd unset", "key": "noout"})
            assert ret == 0
            deadline = asyncio.get_event_loop().time() + 10.0
            while lead.osdmon.osdmap.osd_weight[2] > 0:
                assert asyncio.get_event_loop().time() < deadline, \
                    "down-out tick did not resume after unset noout"
                await asyncio.sleep(0.1)
        finally:
            await c.stop()
    run(go())


# -- cluster: backoff ------------------------------------------------------

async def _wait_settled(c, pg, timeout: float = 60.0) -> None:
    """Until every live OSD and the client hold the leader's epoch and
    ``pg`` is clean: after this no map is in flight that could
    re-advance the PG."""
    deadline = asyncio.get_event_loop().time() + timeout
    while True:
        lead = c.leader()
        epoch = lead.osdmon.osdmap.epoch if lead else -1
        cm = c.client.monc.osdmap
        if lead is not None and pg.state == "clean" and \
                cm is not None and cm.epoch == epoch and \
                all(o.osdmap is not None and o.osdmap.epoch == epoch
                    for o in c.osds if not o._stopped):
            return
        assert asyncio.get_event_loop().time() < deadline, \
            f"never settled (pg {pg.state}, epoch {epoch})"
        await asyncio.sleep(0.05)


def test_backoff_released_on_pg_activation():
    """An op hitting a not-active primary gets MOSDBackoff BLOCK (the
    objecter parks, no timeout churn); when the PG activates the UNBLOCK
    releases the op, which then completes for real. One BLOCK sent,
    one UNBLOCK sent."""
    async def go():
        c = await Cluster(n_mons=1, n_osds=3, device="cpu").start()
        try:
            await c.client.pool_create("bo", pg_num=4)
            await c.wait_for_clean(timeout=120)
            io = await c.client.open_ioctx("bo")
            await io.write_full("bo-obj", b"v1")
            objecter = c.client.objecter
            # the client's backoff self-heal (drop a backoff that got no
            # UNBLOCK within this many seconds and resend) must not fire
            # while the test holds the PG: it would send a second BLOCK
            objecter.backoff_stall_s = 600.0
            osdmap = await c.client.monc.wait_for_osdmap()
            seed, primary = objecter._calc_target(
                osdmap, io.pool_id, "bo-obj")
            pg = c.osds[primary].pgs[f"{io.pool_id}.{seed:x}"]
            await _wait_settled(c, pg)
            # hold the PG: no map and no repeer may advance it until the
            # test does (an instance attribute shadows the method)
            held = []
            pg.advance = lambda *a: held.append(a)
            before = OVERLOAD_PERF.dump()
            pg.state = "peering"
            parked = asyncio.ensure_future(
                io.write_full("bo-obj", b"v2", timeout=60.0))
            deadline = asyncio.get_event_loop().time() + 30.0
            while not (pg.backoffs and objecter._backoffs):
                assert asyncio.get_event_loop().time() < deadline, \
                    "backoff never asserted and recorded"
                assert not parked.done(), "op completed while held"
                await asyncio.sleep(0.02)
            assert not parked.done()        # parked client-side
            assert pg.state == "peering"
            mid = OVERLOAD_PERF.dump()
            assert mid["backoffs_sent"] - before["backoffs_sent"] == 1
            assert mid["backoffs_released"] == before["backoffs_released"]
            # the real activation path: re-advance, peer, release
            del pg.advance
            pg.advance(pg.up, pg.acting, pg.primary, pg.epoch)
            await asyncio.wait_for(parked, timeout=30.0)
            assert not pg.backoffs, "backoffs survived activation"
            assert not objecter._backoffs
            assert await io.read("bo-obj") == b"v2"
            after = OVERLOAD_PERF.dump()
            assert after["backoffs_sent"] - before["backoffs_sent"] == 1
            assert after["backoffs_released"] - \
                before["backoffs_released"] == 1
        finally:
            await c.stop()
    run(go())


# -- cluster: failure-report hygiene ---------------------------------------

def test_reporter_expiry_and_still_alive_cancel():
    """Two stale accusations minutes apart must not sum to a markdown
    (reporter lifetime expiry on tick), and a still-alive cancel
    removes its reporter immediately."""
    async def go():
        cfg = {"mon_osd_min_down_reporters": 2}
        c = await Cluster(n_mons=1, n_osds=3, config=cfg,
                          device="cpu").start()
        try:
            lead = c.leader()
            mon = lead.osdmon

            def accuse(reporter):
                return mon.handle(MOSDFailure(
                    target=2, failed_for=5,
                    epoch=mon.osdmap.epoch, reporter=reporter))

            await accuse("osd.0")
            assert bool(mon.osdmap.is_up(2))      # 1 of 2 reporters
            # age the first report past the lifetime; the tick expires it
            mon.failure_reporters[2]["osd.0"] = \
                time.time() - mon.reporter_lifetime - 1
            await mon.tick()
            assert 2 not in mon.failure_reporters
            # the second, later accusation is now FIRST of two again
            await accuse("osd.1")
            assert bool(mon.osdmap.is_up(2)), \
                "stale + fresh accusation wrongly marked osd down"
            # still-alive cancel withdraws a live accusation
            await mon.handle(MOSDFailure(
                target=2, failed_for=0, epoch=mon.osdmap.epoch,
                reporter="osd.1", alive=1))
            assert 2 not in mon.failure_reporters
            # two live reporters within lifetime DO mark it down
            await accuse("osd.0")
            await accuse("osd.1")
            assert not bool(mon.osdmap.is_up(2))
        finally:
            await c.stop()
    run(go())


