"""The port's op QoS scheduler (``ceph_tpu_torch/osd/scheduler.py``)
against ``ceph_tpu``'s.

- tests/test_qos.py's scheduler units on the port: the dmClock algebra
  under a virtual clock (weight split, size-scaled cost, reservation
  floor, limit ceiling, fifo mode and its live flip, per-tenant backlog,
  grants cancelled on drain) and the daemon's size-scaled op cost;
- a seeded stream of submit / try_dequeue / pop_grant / backlog / mode
  flips / drain through both packages' ``OpScheduler`` with the same
  fake clock: the same dequeue order, tags, backlogs and dumps, in
  ``mclock`` and ``fifo``;
- ``SchedulerThrottle`` alike: the same grant order and dumps.

No tolerance: every tag is computed by the same float expression in
both packages, so values are compared with ``==``.
"""

import asyncio
from types import SimpleNamespace

import numpy as np
import pytest

import ceph_tpu.osd.scheduler as ref_sched
import ceph_tpu_torch.osd.scheduler as port_sched
from ceph_tpu_torch.osd.daemon import OSD
from ceph_tpu_torch.osd.scheduler import (OpScheduler, QoSProfile,
                                          size_scaled_cost)


def run(coro):
    return asyncio.run(coro)


# -- tests/test_qos.py's scheduler units, on the port ----------------------

def _vclock_sched(**cfg):
    clock = [0.0]
    sched = OpScheduler(dict({"osd_op_queue": "mclock"}, **cfg),
                        now_fn=lambda: clock[0])
    return clock, sched


def test_scheduler_weight_split():
    clock, s = _vclock_sched()
    for i in range(40):
        s.submit(("hot", i), key=("client", "hot", 1),
                 profile=QoSProfile(weight=3.0))
        s.submit(("cold", i), key=("client", "cold", 1),
                 profile=QoSProfile(weight=1.0))
    clock[0] = 100.0
    got = {"hot": 0, "cold": 0}
    for _ in range(40):
        item, _cls = s.try_dequeue()
        got[item[0]] += 1
    assert got == {"hot": 30, "cold": 10}


def test_scheduler_cost_scaled_weight_split():
    clock, s = _vclock_sched()
    for i in range(4):
        s.submit(("big", i), key=("client", "big", 1),
                 profile=QoSProfile(weight=1.0), cost=64.0)
    for i in range(256):
        s.submit(("small", i), key=("client", "small", 1),
                 profile=QoSProfile(weight=1.0), cost=1.0)
    clock[0] = 1000.0
    got = {"big": 0, "small": 0}
    for _ in range(130):
        item, _cls = s.try_dequeue()
        got[item[0]] += 1
    assert got == {"big": 2, "small": 128}


def test_osd_op_cost_is_size_scaled():
    def m(datas, lens=None):
        return SimpleNamespace(
            op_datas=datas,
            op_lens=lens if lens is not None
            else [len(d) for d in datas])
    cost = OSD._op_cost
    host = SimpleNamespace(config={})
    assert cost(host, m([])) == 1.0
    assert cost(host, m([b"x" * 100])) == 1.0
    assert cost(host, m([b"x" * (4 << 20)])) == 64.0
    assert cost(host, m([b"x" * (1 << 16), b"y" * (1 << 16)])) == 2.0
    assert cost(host, m([b""], lens=[4 << 20])) == 64.0
    assert cost(host, m([b""], lens=[0])) == 1.0
    host.config = {"osd_qos_cost_per_io_bytes": 1 << 20}
    assert cost(host, m([b"x" * (4 << 20)])) == 4.0


def test_size_scaled_cost_has_one_definition():
    """The EC read aggregator, the recovery throttle and admission all
    charge through the one function the module defines."""
    from ceph_tpu_torch.osd import daemon, ec_read_aggregator
    assert daemon.size_scaled_cost is size_scaled_cost
    src = open(ec_read_aggregator.__file__).read()
    assert "def size_scaled_cost" not in src
    for n in (0, 1, 65536, 65537, 4 << 20):
        for cfg in ({}, {"osd_qos_cost_per_io_bytes": 4096}):
            assert size_scaled_cost(cfg, n) == \
                ref_sched.size_scaled_cost(cfg, n)


def test_scheduler_reservation_floor_under_flood():
    clock, s = _vclock_sched()
    for i in range(2000):
        s.submit(("hot", i), key=("client", "hot", 1),
                 profile=QoSProfile(weight=1.0))
    for i in range(20):
        s.submit(("cold", i), key=("client", "cold", 1),
                 profile=QoSProfile(reservation=10.0, weight=1.0))
    got = {"hot": 0, "cold": 0}
    for g in range(50):
        clock[0] = g / 50.0
        item, _cls = s.try_dequeue()
        got[item[0]] += 1
    assert got["cold"] >= 10


@pytest.mark.parametrize("reservation,limit,most", [
    (0.0, 10.0, 11),    # limit is a hard ceiling on an idle cluster
    (20.0, 2.0, 3),     # ... over the reservation phase too
])
def test_scheduler_limit_is_hard_ceiling(reservation, limit, most):
    clock, s = _vclock_sched()
    for i in range(100):
        s.submit(("l", i), key=("client", "l", 1),
                 profile=QoSProfile(reservation=reservation, weight=1.0,
                                    limit=limit))
    served = 0
    t = 0.0
    while t <= 1.0:
        clock[0] = t
        item, wake = s.try_dequeue()
        if item is not None:
            served += 1
            continue
        assert wake is not None
        t = wake
    assert served <= most


def test_scheduler_fifo_mode_and_live_flip():
    cfg = {"osd_op_queue": "fifo"}
    clock = [0.0]
    s = OpScheduler(cfg, now_fn=lambda: clock[0])
    for i in range(6):
        s.submit(i, key=("client", f"c{i % 2}", 1))
    assert [s.try_dequeue()[0] for _ in range(6)] == list(range(6))
    cfg["osd_op_queue"] = "mclock"
    for i in range(4):
        s.submit(("m", i), key=("client", "x", 1),
                 profile=QoSProfile(weight=1.0))
    cfg["osd_op_queue"] = "fifo"
    drained = [s.try_dequeue()[0] for _ in range(2)]
    cfg["osd_op_queue"] = "mclock"
    clock[0] = 100.0
    drained += [s.try_dequeue()[0] for _ in range(2)]
    assert sorted(drained) == [("m", i) for i in range(4)]
    cfg["osd_op_queue"] = "fifo"
    s.submit("fifo-stamped")
    cfg["osd_op_queue"] = "mclock"
    s.submit(("m", 9), key=("client", "x", 1),
             profile=QoSProfile(weight=1.0))
    assert s.try_dequeue()[0] == "fifo-stamped"
    assert s.try_dequeue()[0] == ("m", 9)
    assert s.try_dequeue() == (None, None)
    assert s.queued == 0


def test_scheduler_backlog_per_tenant():
    cfg = {"osd_op_queue": "mclock"}
    clock = [0.0]
    s = OpScheduler(cfg, now_fn=lambda: clock[0])
    for i in range(7):
        s.submit(("hot", i), key=("client", "hot", 1))
    s.submit(("cold", 0), key=("client", "cold", 1))
    assert s.backlog(("client", "hot", 1)) == 7
    assert s.backlog(("client", "cold", 1)) == 1
    assert s.backlog(("client", "absent", 1)) == 0
    cfg["osd_op_queue"] = "fifo"
    s.submit("f1")
    assert s.backlog(("client", "hot", 1)) == 1


def test_scheduler_grant_cancelled_on_drain():
    async def go():
        s = OpScheduler({"osd_op_queue": "mclock"})
        task = asyncio.ensure_future(s.grant("recovery"))
        await asyncio.sleep(0.01)
        assert s.queued == 1
        assert s.drain() == 1
        with pytest.raises(asyncio.CancelledError):
            await task
        # a straggler grant after drain resolves at once
        await asyncio.wait_for(s.grant("recovery"), 1.0)
    run(go())


# -- a seeded stream through both packages ---------------------------------

def _tags(s) -> list:
    """Every queue's stamped entries (R, P, L, item, cost) in key order."""
    return [(repr(k), q.op_class, q.r_prev, q.p_prev, q.l_prev,
             [(r, p, lim, repr(it), c) for r, p, lim, it, c in q.items])
            for k, q in sorted(s.queues.items(), key=lambda kv: repr(kv[0]))]


def _stream(mod, seed: int, n: int = 1500) -> list:
    """Drive one package's OpScheduler through a seeded mix of calls;
    return everything it answered."""
    rng = np.random.default_rng(seed)
    cfg = {"osd_op_queue": "mclock", "osd_qos_recovery_reservation": 5.0,
           "osd_qos_scrub_limit": 4.0}
    clock = [0.0]
    s = mod.OpScheduler(cfg, now_fn=lambda: clock[0])
    tenants = [("client", f"c{i}", 1 + i % 2) for i in range(6)]
    profiles = [mod.QoSProfile(), mod.QoSProfile(weight=3.0),
                mod.QoSProfile(reservation=20.0, weight=1.0),
                mod.QoSProfile(weight=2.0, limit=15.0),
                mod.QoSProfile(reservation=5.0, weight=0.0, limit=50.0)]
    out = []
    seq = 0
    for _ in range(n):
        clock[0] += float(rng.exponential(0.01))
        op = rng.integers(0, 100)
        if op < 45:
            t = int(rng.integers(0, len(tenants)))
            seq += 1
            s.submit(("op", seq), key=tenants[t],
                     profile=profiles[t % len(profiles)],
                     cost=float(rng.choice([1.0, 1.0, 2.5, 64.0])))
        elif op < 52:
            cls = ("recovery", "scrub")[int(rng.integers(0, 2))]
            seq += 1
            s.submit(("grant", seq), key=(cls,), op_class=cls,
                     cost=float(rng.integers(1, 8)))
        elif op < 85:
            out.append(("deq", s.try_dequeue()))
        elif op < 88:
            out.append(("pop_grant", s.pop_grant()))
        elif op < 94:
            t = tenants[int(rng.integers(0, len(tenants)))]
            out.append(("backlog", t, s.backlog(t)))
        elif op < 97:
            cfg["osd_op_queue"] = ("fifo" if cfg["osd_op_queue"] ==
                                   "mclock" else "mclock")
            out.append(("mode", s.mode()))
        else:
            out.append(("dump", s.dump()))
        out.append(("state", s.queued, s.dequeued_total))
    out.append(("tags", _tags(s)))
    out.append(("dump", s.dump()))
    # drain what is left, then drop the rest
    cfg["osd_op_queue"] = "mclock"
    clock[0] += 1000.0
    for _ in range(20):
        out.append(("deq", s.try_dequeue()))
    released = []
    out.append(("drain", s.drain(release=released.append), released))
    out.append(("after", s.try_dequeue(), s.queued))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_seeded_stream_matches_reference(seed):
    port = _stream(port_sched, seed)
    ref = _stream(ref_sched, seed)
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a == b, (i, a, b)
    # the stream exercised both modes and both phases
    kinds = {x[0] for x in port}
    assert {"deq", "mode", "tags", "drain"} <= kinds
    assert any(x[0] == "mode" and x[1] == "fifo" for x in port)
    assert any(x[0] == "deq" and x[1][0] is not None for x in port)


def _throttle_run(mod, mode: str) -> list:
    """Recovery acquires through a SchedulerThrottle beside client ops,
    with the admission loop's order of grants recorded."""
    async def go():
        cfg = {"osd_op_queue": mode, "osd_recovery_max_active": 2,
               "osd_qos_recovery_reservation": 1000.0}
        s = mod.OpScheduler(cfg)
        th = mod.SchedulerThrottle(s, max_active=2, config=cfg)
        order = []

        async def admit():
            while True:
                item, cls = await s.dequeue()
                if isinstance(item, mod._Grant):
                    order.append(("grant", cls))
                    if not item.fut.done():
                        item.fut.set_result(True)
                else:
                    order.append(("client", item))

        loop_task = asyncio.ensure_future(admit())
        done = []

        async def push(i, nbytes):
            async with th.op(nbytes):
                done.append(i)
                await asyncio.sleep(0)

        for i in range(4):
            s.submit(("c", i), key=("client", "x", 1),
                     profile=mod.QoSProfile(weight=1.0))
        await asyncio.gather(*[push(i, n) for i, n in
                               enumerate([0, 4096, 4 << 20, 1 << 16,
                                          3, 70000])])
        await asyncio.sleep(0.01)
        loop_task.cancel()
        dump = th.dump()
        return (sorted(done), sorted(order, key=repr), dump,
                th.max_active, th.throttled_ops, s.queued)
    return run(go())


@pytest.mark.parametrize("mode", ["mclock", "fifo"])
def test_scheduler_throttle_matches_reference(mode):
    port = _throttle_run(port_sched, mode)
    ref = _throttle_run(ref_sched, mode)
    assert port == ref
    done, order, dump, max_active, _thr, queued = port
    assert done == list(range(6)) and queued == 0
    assert max_active == 2 and dump["scheduler_mode"] == mode
    if mode == "mclock":
        assert sum(1 for o in order if o[0] == "grant") == 6
