"""The erasure-coded PG path, ceph_tpu_torch against ceph_tpu.

Both packages' ``ECPG`` run one scenario, each through the same OSD
facade (``chip_smoke.PGCluster``: one facade per OSD, a MemStore each,
real messengers in crc mode on 127.0.0.1, acting sets from the port's
``OSDMap`` under an ``indep`` host rule), on the same seeded inputs: the
port's plugin on CPU torch, the reference's on JAX-CPU. The scenario:
write_full, partial writes, an xattr and an omap key, reads; two OSDs
killed (one for k=2 m=1) and degraded reads; a spare takes the lost data
position (``pg-upmap-items``) and recovery pushes rebuild its shards;
one shard corrupted, a deep scrub and a repair. Every peering round
asks for its up_thru (``MOSDAlive``), which the facade's monitor grants
by an ``Incremental``, so the prior-set branch of peering runs.

Tolerance: exact bytes throughout. The stores (data, ``_v``, ``_pos``,
``_hcrc``, ``_size``, omap, the PG meta object), the PG logs, the
client replies and the scrub and repair reports equal across packages;
the rebuilt shards and their ``_hcrc`` equal shards computed from the
mirror.
"""

from __future__ import annotations

import asyncio
import zlib

import numpy as np
import pytest

import chip_smoke as cs

SEED = 6060


def ref_modules():
    """The reference's modules in the layout of ``chip_smoke.pg_modules``,
    so ``PGCluster`` drives ``ceph_tpu`` through the same facade."""
    from types import SimpleNamespace

    from ceph_tpu import msg
    from ceph_tpu.ec.jax_plugin import DeviceShardCache
    from ceph_tpu.mon.messages import MOSDAlive
    from ceph_tpu.os_.objectstore import MemStore
    from ceph_tpu.osd import messages, recovery, scrub, types
    from ceph_tpu.osd.ec_aggregator import ECAggregator
    from ceph_tpu.osd.ec_pg import ECPG
    from ceph_tpu.osd.ec_read_aggregator import ECReadAggregator
    from ceph_tpu.osd.pg import PG
    from ceph_tpu.utils.op_tracker import OpTracker
    from ceph_tpu.utils.perf_counters import PerfCountersBuilder
    from ceph_tpu.utils.throttle import MessageThrottle
    from ceph_tpu.utils.tracing import Tracer

    def make_cache(config, device):
        return DeviceShardCache(config)
    return SimpleNamespace(
        msg=msg, M=messages, MOSDAlive=MOSDAlive, ECPG=ECPG, PG=PG,
        recovery=recovery, scrub=scrub, MemStore=MemStore,
        ECAggregator=ECAggregator, ECReadAggregator=ECReadAggregator,
        Tracer=Tracer, OpTracker=OpTracker, MessageThrottle=MessageThrottle,
        PerfCountersBuilder=PerfCountersBuilder, types=types,
        make_cache=make_cache)


def _mods(pkg: str):
    return ref_modules() if pkg == "ceph_tpu" else cs.pg_modules()


def _profile(k: int, m: int, su: int) -> dict:
    return {"plugin": "jax", "technique": "reed_sol_van", "k": str(k),
            "m": str(m), "stripe_unit": str(su), "device": "cpu"}


def _store_image(store) -> dict:
    out = {}
    for cid in store.list_collections():
        for oid in store.list_objects(cid):
            out[(cid, oid)] = (store.read(cid, oid),
                               store.getattrs(cid, oid),
                               store.omap_get(cid, oid))
    return out


def _shards_from_mirror(k: int, m: int, su: int, data: bytes):
    """Every position's shard bytes for ``data``, encoded by the port's
    plugin on the CPU from the host mirror alone."""
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.ec.torch_plugin import to_host
    ec = factory(_profile(k, m, su))
    W = k * su
    count = max(1, -(-len(data) // W))
    buf = np.zeros(count * W, dtype=np.uint8)
    buf[:len(data)] = np.frombuffer(data, dtype=np.uint8)
    chunks = buf.reshape(count, k, su)
    parity = to_host(ec.encode_batch(chunks))
    return [np.ascontiguousarray(chunks[:, p]).tobytes() for p in range(k)
            ] + [np.ascontiguousarray(parity[:, j]).tobytes()
                 for j in range(m)]


def run_scenario(pkg: str, k: int, m: int, su: int) -> dict:
    mods = _mods(pkg)
    M = mods.M
    n = k + m + 1
    rng = np.random.default_rng(SEED + k)
    W = k * su
    sizes = [3 * W, 2 * W + 5, W - 1, 4 * W + su + 3, 17, 3 * W]
    mirror = {f"obj.{i}": bytearray(rng.integers(0, 256, s, dtype=np.uint8)
                                    .tobytes()) for i, s in enumerate(sizes)}
    # partial writes touch objects 1..4 only: 0 and 5 keep their _hcrc
    partial = []
    for j in range(10):
        oid = f"obj.{1 + j % 4}"
        ln = int(rng.integers(1, su + 9))
        off = int(rng.integers(0, len(mirror[oid]) + su))
        partial.append((oid, off, rng.integers(0, 256, ln, dtype=np.uint8)
                        .tobytes()))
    out: dict = {"replies": []}

    async def op(cl, oid, ops):
        r = await cl.client.op(oid, ops, deadline=30.0)
        out["replies"].append((oid, r.result, bytes(r.data), r.extra))
        return r

    async def read_all(cl, what):
        for oid, want in mirror.items():
            r = await op(cl, oid, [(M.OSD_OP_READ, 0, 0, "", b"")])
            assert r.result == 0 and bytes(r.data) == bytes(want), \
                (pkg, what, oid)

    async def go():
        cl = cs.PGCluster(mods, n, _profile(k, m, su), k + m,
                          k if m == 1 else k + 1, "cpu",
                          {"osd_ec_resident_bytes": 0})
        try:
            await cl.start()
            _up, acting, primary = cl.placement(1, 0)
            for oid, data in mirror.items():
                r = await op(cl, oid, [(M.OSD_OP_WRITEFULL, 0, len(data),
                                        "", bytes(data))])
                assert r.result == 0
            for oid, off, data in partial:
                r = await op(cl, oid, [(M.OSD_OP_WRITE, off, len(data), "",
                                        data)])
                assert r.result == 0
                buf = mirror[oid]
                if len(buf) < off + len(data):
                    buf.extend(b"\0" * (off + len(data) - len(buf)))
                buf[off:off + len(data)] = data
            await op(cl, "obj.2", [(M.OSD_OP_SETXATTR, 0, 3, "user.x",
                                    b"abc"),
                                   (M.OSD_OP_OMAP_SET, 0, 2, "k1", b"v1")])
            r = await op(cl, "obj.2", [(M.OSD_OP_GETXATTR, 0, 0, "user.x",
                                        b""), (M.OSD_OP_STAT, 0, 0, "",
                                               b"")])
            assert r.result == 0 and bytes(r.data) == b"abc"
            await read_all(cl, "healthy")
            # two OSDs die (one at m=1): a data position and, at m >= 2,
            # a parity one; the primary keeps its own position
            lost = [acting[1]] + ([acting[k + 1]] if m > 1 else [])
            await cl.kill(lost)
            await asyncio.sleep(0)
            pg = await cl.wait_state(("active",))
            # the prior set: the closed interval, kept because its
            # primary holds an up_thru grant at or past its first epoch
            out["prior"] = [(iv[0], iv[1], list(iv[2]), iv[3],
                             cl.osdmap.up_thru.get(iv[3], 0))
                            for iv in pg.past_intervals]
            dec0 = cl.perf_sum("ec_read_agg", ["ops"])["ops"]
            await read_all(cl, "degraded")
            out["degraded_decodes"] = cl.perf_sum(
                "ec_read_agg", ["ops"])["ops"] - dec0
            # the spare takes the lost data position; recovery rebuilds
            spare = next(o for o in range(n) if o not in acting)
            cl.replace(lost[0], spare)

            def recovered():
                pg = cl.primary()
                return pg is not None and pg.acting[1] == spare and \
                    pg.state in ("active", "clean") and \
                    not any(pg.peer_missing.values())
            await cs.wait_until(recovered, 30.0, lambda: (
                cl.primary().state, cl.primary().peer_missing))
            await read_all(cl, "recovered")
            st = cl.osds[spare].store
            for oid, data in mirror.items():
                want = _shards_from_mirror(k, m, su, bytes(data))[1]
                assert st.read("1.0", oid) == want, (pkg, oid)
                assert st.getattrs("1.0", oid)["_hcrc"] == \
                    zlib.crc32(want).to_bytes(4, "little"), (pkg, oid)
            # one shard corrupted in its store: a whole-written object's
            # data shard at m=1 (its _hcrc locates it), a partially
            # written object's at m=3 (leave-one-out locates it)
            pg = cl.primary()
            victim, pos = ("obj.0", 0) if m == 1 else ("obj.3", 2)
            holder = pg.acting[pos]
            cl.osds[holder].store._obj("1.0", victim).data[7] ^= 0x5A
            out["scrub"] = await pg.scrubber.scrub(deep=True)
            out["repair"] = await pg.scrubber.repair()
            out["scrub_after"] = await pg.scrubber.scrub(deep=True)
            out["victim"] = (victim, holder)
            await read_all(cl, "repaired")
            out["grants"] = cl.monc.grants
            out["epoch"] = cl.osdmap.epoch
            out["acting"] = cl.primary().acting
            out["stores"] = {i: _store_image(f.store)
                             for i, f in cl.osds.items()}
            out["logs"] = {i: f.pgs["1.0"].pg_log.encode()
                           for i, f in cl.osds.items() if "1.0" in f.pgs}
        finally:
            await cl.stop()
    asyncio.run(go())
    return out


@pytest.mark.parametrize("k,m,su", [(2, 1, 64), (8, 3, 32)],
                         ids=["k2m1", "k8m3"])
def test_ec_pg_path_equals_the_reference(k, m, su):
    ref = run_scenario("ceph_tpu", k, m, su)
    got = run_scenario("ceph_tpu_torch", k, m, su)
    # the scenario did what it says
    assert got["degraded_decodes"] == 6          # one per object read
    assert got["grants"] == 3                    # one per interval
    assert any(up_thru >= first
               for first, _last, _acting, _prim, up_thru in got["prior"])
    victim, holder = got["victim"]
    assert got["scrub"]["errors"] and all(
        e.startswith(victim) for e in got["scrub"]["errors"])
    assert any(f"identified corrupt on osd.{holder}" in e
               for e in got["repair"]["errors_before"])
    assert got["repair"]["repaired"] == 1
    assert got["repair"]["errors_after"] == []
    assert got["scrub_after"]["errors"] == []
    # ... and did it exactly as the reference did
    for key in ("replies", "scrub", "repair", "scrub_after", "grants",
                "epoch", "acting", "degraded_decodes", "prior", "logs"):
        assert got[key] == ref[key], key
    assert got["stores"].keys() == ref["stores"].keys()
    for osd in ref["stores"]:
        assert got["stores"][osd] == ref["stores"][osd], f"osd.{osd}"


def test_push_build_failure_raises_on_the_card_only(monkeypatch):
    """``_build_backfill_push``: a failure of the rebuild's device path
    skips the push (None, retried by a later round) for a plugin on the
    CPU, as in the reference; on the card it raises and is counted. A
    store or lookup failure skips the push on either."""
    from ceph_tpu_torch.os_.objectstore import StoreError
    from ceph_tpu_torch.osd import ec_pg
    from ceph_tpu_torch.osd.recovery import PERF
    mods = _mods("ceph_tpu_torch")
    M = mods.M

    async def broken_decode(*a, **kw):
        raise RuntimeError("injected decode failure")

    async def go():
        cl = cs.PGCluster(mods, 4, _profile(2, 1, 64), 3, 2, "cpu",
                          {"osd_ec_resident_bytes": 0})
        try:
            await cl.start()
            r = await cl.client.op("p", [(M.OSD_OP_WRITEFULL, 0, 500, "",
                                          bytes(range(250)) * 2)])
            assert r.result == 0
            pg = cl.primary()
            target = pg.acting[1]            # a data position: decode
            push = await pg._build_backfill_push("p", target)
            assert push is not None and push.exists
            monkeypatch.setattr(pg.osd.ec_read_agg, "decode",
                                broken_decode)
            assert await pg._build_backfill_push("p", target) is None
            monkeypatch.setattr(ec_pg, "on_card", lambda ec: True)
            before = PERF.dump().get("push_device_failures", 0)
            with pytest.raises(RuntimeError, match="injected decode"):
                await pg._build_backfill_push("p", target)
            assert PERF.dump()["push_device_failures"] == before + 1

            async def no_meta(*a, **kw):
                raise StoreError("injected store failure")
            monkeypatch.setattr(pg, "_authoritative_meta", no_meta)
            assert await pg._build_backfill_push("p", target) is None
        finally:
            await cl.stop()
    asyncio.run(go())


def test_local_rebuild_failure_raises_on_the_card_only(monkeypatch):
    """The primary's self-recovery (``_pull``) and a replica's position
    fix (``_fix_shard_positions``) rebuild a shard on their own OSD. A
    failure of the device path with the plugin on the card is counted in
    ``rebuild_device_failures`` and raised as ``RecoveryDeviceError``,
    which peering does not retry. On the CPU, ``_pull`` hands it to
    peering as the reference does; a shard set not decodable yet is
    never counted."""
    from ceph_tpu_torch.os_.objectstore import Transaction
    from ceph_tpu_torch.osd import ec_pg
    from ceph_tpu_torch.osd.recovery import PERF, RecoveryDeviceError
    mods = _mods("ceph_tpu_torch")
    M = mods.M

    async def broken_decode(*a, **kw):
        raise RuntimeError("injected decode failure")

    async def not_decodable_yet(*a, **kw):
        raise ec_pg.UnreadableNow("injected: sources not decodable yet")

    async def card_failed():
        raise RecoveryDeviceError("injected card failure")

    def failures():
        return PERF.dump().get("rebuild_device_failures", 0)

    async def go():
        cl = cs.PGCluster(mods, 4, _profile(2, 1, 64), 3, 2, "cpu",
                          {"osd_ec_resident_bytes": 0})
        try:
            await cl.start()
            r = await cl.client.op("p", [(M.OSD_OP_WRITEFULL, 0, 500, "",
                                          bytes(range(250)) * 2)])
            assert r.result == 0
            pg = cl.primary()                       # position 0
            replica = cl.pg(pg.acting[1])           # position 1
            src = pg.acting[1]
            for p in (pg, replica):
                monkeypatch.setattr(p.osd.ec_read_agg, "decode",
                                    broken_decode)
            before = failures()
            with pytest.raises(RuntimeError, match="injected decode") as ei:
                await pg._pull(src, "p")
            assert not isinstance(ei.value, RecoveryDeviceError)
            assert failures() == before
            monkeypatch.setattr(ec_pg, "on_card", lambda ec: True)
            with pytest.raises(RecoveryDeviceError, match="injected decode"):
                await pg._pull(src, "p")
            assert failures() == before + 1
            with monkeypatch.context() as mp:
                mp.setattr(pg, "_gather", not_decodable_yet)
                with pytest.raises(ec_pg.UnreadableNow):
                    await pg._pull(src, "p")
            assert failures() == before + 1
            # the replica's stamp names another position: its fix
            # rebuilds position 1 by a decode, which fails on the card
            # (the sweep its activation started is stopped first, so the
            # count is this call's)
            if replica._posfix_task is not None:
                replica._posfix_task.cancel()
            replica.osd.store.queue_transaction(Transaction().setattrs(
                replica.cid, "p", {"_pos": replica._pos_attr(0)}))
            with pytest.raises(RecoveryDeviceError, match="injected decode"):
                await asyncio.wait_for(replica._fix_shard_positions(), 30.0)
            assert failures() == before + 2
            repeers = []
            monkeypatch.setattr(pg, "_peer_inner", card_failed)
            monkeypatch.setattr(pg.osd, "request_repeer",
                                lambda *a, **kw: repeers.append(a))
            with pytest.raises(RecoveryDeviceError):
                await pg._peer()
            assert repeers == [] and pg.state == "peering"
        finally:
            await cl.stop()
    asyncio.run(go())


class _StartCluster:
    """What ``chip_smoke.start_cluster`` uses of a ``ProcCluster``; its
    start fails when ``leaders`` is set, and its mons report whether
    each leads (``mon.c`` has no admin socket)."""

    def __init__(self, leaders=None):
        self.leaders, self.stops = leaders, 0
        self.children = dict.fromkeys(["mon.a", "mon.b", "mon.c", "osd.0"])

    async def start(self):
        if self.leaders is not None:
            raise TimeoutError("0/12 osds up")

    async def stop(self):
        self.stops += 1

    async def daemon_command(self, name, cmd):
        if name == "mon.c":
            raise FileNotFoundError(name)
        return {"leader": name in (self.leaders or ()),
                "election_epoch": 4, "quorum": [0, 2]}


async def _timed(what, coro):
    return await coro


@pytest.mark.parametrize("leaders,two_lead", [
    ({"mon.a", "mon.b"}, True), ({"mon.a"}, False), (None, False)])
def test_smoke_starts_again_only_after_a_split(leaders, two_lead):
    """chip_smoke.py's cluster phases start no cluster again (once they
    did after a split): a failed start raises, whether or not two mons
    lead, and stops nothing; a start that succeeded returns its record,
    kept in ``STARTS``."""
    async def go():
        c = _StartCluster(leaders)
        if leaders is not None:
            with pytest.raises(TimeoutError):
                await cs.start_cluster(c, _timed, "cpu", "t")
            return c, cs.STARTS[-1]
        return c, await cs.start_cluster(c, _timed, "cpu", "t")
    c, start = asyncio.run(go())
    assert c.stops == 0 and start is cs.STARTS[-1]
    assert start["ok"] == (leaders is None)
    assert start["elections"] == 0 and start["split_epochs"] == {}
    assert start["election_epochs"] == {"mon.a": 4, "mon.b": 4,
                                        "mon.c": None}


class _HealedSplit(_StartCluster):
    """A start after mon.a and mon.b both won epoch 4 (quorums [0, 2]
    and [1, 2]); by the time the smoke looks, mon.a won epoch 6 and
    leads alone."""

    async def daemon_command(self, name, cmd):
        if name == "mon.c":
            return {"leader": False, "election_epoch": 6, "wins": [],
                    "paxos_timeouts": {"collect": 1, "begin": 0}}
        wins = {"mon.a": [[4, [0, 2], 8.1], [6, [0, 1, 2], 10.4]],
                "mon.b": [[4, [1, 2], 8.2]]}[name]
        return {"leader": name == "mon.a", "election_epoch": 6,
                "quorum": [0, 1, 2], "wins": wins}


@pytest.mark.parametrize("wins_seen", [True, False])
def test_smoke_starts_again_after_a_healed_split(wins_seen):
    """A failed start raises and starts nothing again (once a split,
    healed or not, started a fresh cluster); its record holds the epochs
    each mon won, so a split that healed before the smoke looked shows
    in it; without the won epochs it shows none."""
    class Healed(_HealedSplit):
        async def daemon_command(self, name, cmd):
            out = await super().daemon_command(name, cmd)
            return out if wins_seen else dict(out, wins=[])

    async def go():
        c = Healed(leaders=set())
        with pytest.raises(TimeoutError):
            await cs.start_cluster(c, _timed, "cpu", "t")
        return c, cs.STARTS[-1]
    c, start = asyncio.run(go())
    assert c.stops == 0 and not start["ok"]
    assert start["collect_timeouts"] == 1 and start["begin_timeouts"] == 0
    if wins_seen:
        assert start["elections"] == 3
        assert start["split_epochs"] == {4: ["mon.a", "mon.b"]}
    else:
        assert start["elections"] == 0 and start["split_epochs"] == {}


@pytest.mark.parametrize("split", [True, False])
def test_a_start_in_which_two_mons_won_one_epoch_fails(split):
    """The smoke's gate on a start that succeeded: two mons that won one
    election epoch fail it, healed or not; one winner per epoch passes,
    and the record counts the elections."""
    class Started(_HealedSplit):
        async def daemon_command(self, name, cmd):
            out = await super().daemon_command(name, cmd)
            if not split and name == "mon.b":
                out = dict(out, wins=[[8, [0, 1, 2], 12.0]])
            return out

    async def go():
        c = Started()
        if split:
            with pytest.raises(RuntimeError, match="won by two mons"):
                await cs.start_cluster(c, _timed, "cpu", "t")
            return cs.STARTS[-1]
        return await cs.start_cluster(c, _timed, "cpu", "t")
    start = asyncio.run(go())
    assert start["ok"] and start["elections"] == 3
    assert bool(start["split_epochs"]) == split
