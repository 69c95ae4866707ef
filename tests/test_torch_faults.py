"""The port's fault layer (``ceph_tpu_torch/sim/faults.py``) against
``ceph_tpu``'s.

- a seeded script of rule installs and clears, connect gates, frame
  verdicts, message shaping and device verdicts gives the same
  decisions in both packages (the injectors draw from their own
  ``random.Random``, so a seed and a call sequence fix every decision);
- ``rule_from_dict`` rebuilds every rule kind alike;
- on the port's messengers: delay, duplication and a partition that
  heals, as tests/test_faults.py drives them on the reference's;
- on a port cluster: ``install_faults`` reaches every daemon's
  messengers and the device chokepoint, and a ``jit_fail`` rule on
  ``ec_encode`` makes the port's devmon raise there.
"""

import asyncio

import numpy as np
import pytest

import ceph_tpu.sim.faults as RF
import ceph_tpu_torch.sim.faults as PF
from ceph_tpu_torch.msg import Dispatcher, Message, Messenger, register
from ceph_tpu_torch.msg.messenger import ConnectionError_


def run(coro):
    return asyncio.run(coro)


ENTITIES = ["client.a", "client.b", "osd.0", "osd.1", "osd.2", "mon.a"]
PATTERNS = ["client.*", "osd.*", "osd.1", "*", "mon.a", "client.a"]
DEVICE_FNS = ["ec_encode", "ec_decode", "crush_sweep", "crush_map_pgs"]
DEVICE_KEYS = ["('kern', 3, 0, 1024)", "(1234, (8, 4096))", "('vm', 1)"]


def _rules(mod, rng) -> list:
    """A seeded set of rules of every kind (the same draws for either
    package, since only ``rng`` decides)."""
    out = []
    for _ in range(int(rng.integers(1, 5))):
        kind = int(rng.integers(0, 8))
        a = PATTERNS[int(rng.integers(0, len(PATTERNS)))]
        b = PATTERNS[int(rng.integers(0, len(PATTERNS)))]
        p = float(rng.choice([0.25, 0.5, 1.0]))
        if kind == 0:
            out.append(mod.partition(a, b))
        elif kind == 1:
            out.append(mod.drop(a, b, prob=p))
        elif kind == 2:
            out.append(mod.delay(a, b, 0.0, 0.002))
        elif kind == 3:
            out.append(mod.duplicate(a, b, prob=p))
        elif kind == 4:
            out.append(mod.reorder(a, b, prob=p, hold_s=0.001))
        elif kind == 5:
            out.append(mod.jit_fail(DEVICE_FNS[int(rng.integers(0, 4))],
                                    "*'kern'*", prob=p,
                                    count=int(rng.integers(0, 3))))
        elif kind == 6:
            out.append(mod.jit_stall("ec_*", 0.0, 0.5, prob=p,
                                     count=int(rng.integers(0, 3))))
        else:
            out.append(mod.bad_result("crush_*", prob=p,
                                      count=int(rng.integers(0, 3))))
    return out


def _script(mod, seed: int, n: int = 400) -> list:
    rng = np.random.default_rng(seed)
    inj = mod.FaultInjector(seed=seed)
    out = []

    async def go():
        for step in range(n):
            op = int(rng.integers(0, 100))
            src = ENTITIES[int(rng.integers(0, len(ENTITIES)))]
            dst = ENTITIES[int(rng.integers(0, len(ENTITIES)))]
            if op < 10:
                name = f"set{int(rng.integers(0, 3))}"
                inj.install(name, _rules(mod, rng))
                out.append(("install", name, inj.describe()))
            elif op < 15:
                name = f"set{int(rng.integers(0, 3))}"
                out.append(("clear", name, inj.clear(name)))
            elif op < 16:
                inj.clear_all()
                out.append(("clear_all", inj.describe()))
            elif op < 35:
                out.append(("connect", src, dst,
                            inj.blocks_connect(src, dst)))
            elif op < 60:
                out.append(("frame", src, dst, inj.on_frame(src, dst)))
            elif op < 75:
                out.append(("message", src, dst,
                            await inj.on_message(src, dst)))
            else:
                fn = DEVICE_FNS[int(rng.integers(0, len(DEVICE_FNS)))]
                key = DEVICE_KEYS[int(rng.integers(0, len(DEVICE_KEYS)))]
                out.append(("device", fn, key, inj.has_device_rules(),
                            inj.device_verdicts(fn, key)))
    run(go())
    return out


@pytest.mark.parametrize("seed", [5, 6, 7, 8])
def test_seeded_decisions_match_reference(seed):
    port = _script(PF, seed)
    ref = _script(RF, seed)
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a == b, (i, a, b)
    kinds = {x[0] for x in port}
    assert {"install", "connect", "frame", "message", "device"} <= kinds


def test_rule_from_dict_round_trips_every_kind():
    for mod in (PF, RF):
        rules = [mod.partition("a", "b"), mod.drop("a", "b", 0.5),
                 mod.delay("a", "b", 0.1, 0.2),
                 mod.duplicate("a", "b", 0.3),
                 mod.reorder("a", "b", 0.4, 0.5),
                 mod.jit_fail("ec_*", "*'kern'*", 0.5, 2),
                 mod.jit_stall("ec_*", 0.1, 0.2, "*", 1.0, 3),
                 mod.bad_result("crush_*", "*", 1.0, 1)]
        for r in rules:
            d = r.describe()
            assert mod.rule_from_dict(d).describe() == d
    p = [PF.rule_from_dict(r.describe()).describe()
         for r in _rules(RF, np.random.default_rng(3))]
    q = [r.describe() for r in _rules(RF, np.random.default_rng(3))]
    assert p == q


# -- on the port's messengers ----------------------------------------------

@register
class MTorchFault(Message):
    TYPE = 911
    FIELDS = [("x", "u64")]


class Collector(Dispatcher):
    def __init__(self):
        self.got = []

    async def ms_dispatch(self, msg):
        if isinstance(msg, MTorchFault):
            self.got.append(msg.x)
            return True
        return False


async def _wait(pred, timeout=10.0):
    t0 = asyncio.get_event_loop().time()
    while not pred():
        if asyncio.get_event_loop().time() - t0 > timeout:
            raise TimeoutError
        await asyncio.sleep(0.01)


async def _pair(inj):
    server = Messenger("osd.9")
    sink = Collector()
    server.add_dispatcher(sink)
    addr = await server.bind()
    client = Messenger("client.f")
    client.faults = inj
    server.faults = inj
    return server, sink, addr, client


def test_port_messenger_delay_duplicate_and_partition():
    async def go():
        inj = PF.FaultInjector(seed=1)
        server, sink, addr, client = await _pair(inj)
        inj.install("lag", [PF.delay("client.*", "osd.*", 0.3)])
        t0 = asyncio.get_event_loop().time()
        await client.send_message(MTorchFault(x=1), addr, "osd.9")
        await _wait(lambda: sink.got)
        assert asyncio.get_event_loop().time() - t0 >= 0.3
        inj.clear("lag")
        inj.install("dup", [PF.duplicate("client.*", "osd.*", 1.0)])
        await client.send_message(MTorchFault(x=7), addr, "osd.9")
        await _wait(lambda: len(sink.got) == 3)
        assert sink.got == [1, 7, 7]
        inj.clear("dup")
        conn = await client.connect(addr, "osd.9")
        inj.install("split", [PF.partition("client.f", "osd.9")])
        with pytest.raises(ConnectionError_):
            await conn.send_message(MTorchFault(x=2))
        with pytest.raises(ConnectionError_):
            await client.connect(addr, "osd.9")
        inj.clear("split")
        await client.send_message(MTorchFault(x=3), addr, "osd.9")
        await _wait(lambda: sink.got[-1:] == [3])
        await client.shutdown()
        await server.shutdown()
    run(go())


def test_cluster_install_faults_reaches_daemons_and_device():
    """``Cluster.install_faults`` hangs one injector on every daemon
    messenger and on devmon's chokepoint; a device rule then fails the
    port's EC encode there, and clearing it heals."""
    from ceph_tpu_torch.cluster.vstart import Cluster
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.utils import devmon as devmon_mod

    async def go():
        c = await Cluster(n_mons=1, n_osds=2, device="cpu").start()
        try:
            inj = PF.FaultInjector(seed=4)
            c.install_faults(inj)
            assert all(o.msgr.faults is inj and o.hb_msgr.faults is inj
                       for o in c.osds)
            assert all(m.msgr.faults is inj for m in c.mons)
            assert c.client.monc.msgr.faults is inj
            ec = factory({"plugin": "jax", "k": "2", "m": "1",
                          "device": "cpu"})
            data = np.arange(2 * 64, dtype=np.uint8).reshape(1, 2, 64)
            before = devmon_mod.devmon().perf.dump()["faults_injected"]
            inj.install("dev", [PF.jit_fail("ec_encode", "*", 1.0, 1)])
            with pytest.raises(RuntimeError, match="injected device"):
                ec.encode_batch(data)
            assert devmon_mod.devmon().perf.dump()["faults_injected"] == \
                before + 1
            ec.encode_batch(data)          # count spent: heals
            inj.clear_all()
        finally:
            c.install_faults(None)
            await c.stop()
    run(go())
