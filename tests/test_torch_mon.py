"""The port's monitor tier (``ceph_tpu_torch.mon``), held against ceph_tpu's.

First the nine cases of ``tests/test_mon.py`` on the port, with every
``Monitor`` and ``MonClient`` on the CPU (``device="cpu"``): bootstrap,
the bad-id guard, a three-mon quorum and its replication, leader
failover, MonClient's redirect, the OSDMonitor lifecycle, down and
auto-out, a client surviving a mon's death, the blocklist trim.

Then the two packages side by side, each mon on 127.0.0.1 port 0:

- one seeded command script through a ``ceph_tpu`` quorum and a
  ``ceph_tpu_torch`` quorum gives equal committed ``osdmap`` prefixes
  (every ``full_%08x`` and ``inc_%08x`` blob, byte for byte, on every
  mon) and equal command output: the map changes' replies, ``osd
  dump``, ``osd tree``, ``osd map``, ``osd df``, ``osd getmap``, ``osd
  getcrushmap``, ``mon dump`` and ``config get``. Left out: election
  epochs, lease and log stamps and ``auth`` secrets, which a clock or a
  random draw sets; ``mon dump``'s ports, which the OS picks when a mon
  binds port 0 (they are replaced by the mon's name before comparing),
  and its ``quorum`` and ``leader``, which an election under load moves
  for a while (the script ends on a full quorum in both);
- a port ``MonClient`` on a reference quorum and a reference
  ``MonClient`` on a port quorum subscribe, command and reach the
  leader's epoch and map bytes;
- a mon of one package restarted on the other's ``WALDB`` store resumes
  at the same ``last_committed`` and map, and commits on.

The tracked ``MonClient`` is held against the reference's mapping table in
``tests/test_torch_mon_mapping.py``.

Timers are the reference tests' short ones where a case waits on them
(``CFG``) and the registry's elsewhere, with generous deadlines: tier-1
runs these files under ``-n 6``. Tolerance: exact (bytes and integers).
"""

from __future__ import annotations

import asyncio
import json

import numpy as np
import pytest

import ceph_tpu.encoding as ref_enc
import ceph_tpu.mon as ref_mon
import ceph_tpu.mon.messages as ref_msgs
import ceph_tpu_torch.encoding as port_enc
import ceph_tpu_torch.mon as port_mon
import ceph_tpu_torch.mon.messages as port_msgs
from ceph_tpu.crush import builder as ref_builder
from ceph_tpu.crush.types import WEIGHT_ONE
from ceph_tpu_torch.crush import builder as port_builder
from ceph_tpu_torch.mon import MonClient, Monitor, MonMap
from ceph_tpu_torch.mon.messages import MOSDBoot, MOSDFailure
from ceph_tpu_torch.mon.store import MonitorDBStore
from ceph_tpu_torch.osd.osdmap import FLAG_FULL, STATE_FULL

CFG = {"mon_election_timeout": 0.15, "mon_lease_interval": 0.1,
       "mon_lease": 0.6, "mon_paxos_timeout": 1.0,
       "mon_tick_interval": 0.05, "mon_osd_min_down_reporters": 1,
       "mon_osd_down_out_interval": 0.5}

PKG = {
    "port": {"mon": port_mon, "msgs": port_msgs, "enc": port_enc,
             "builder": port_builder, "dev": {"device": "cpu"}},
    "ref": {"mon": ref_mon, "msgs": ref_msgs, "enc": ref_enc,
            "builder": ref_builder, "dev": {}},
}


def run(coro):
    asyncio.run(coro)


async def start_mons(n: int, cfg=None, pkg: str = "port"):
    """Bind messengers first so the monmap has real ports, then start."""
    mod, dev = PKG[pkg]["mon"], PKG[pkg]["dev"]
    cfg = dict(CFG, **(cfg or {}))
    names = "abcde"[:n]
    monmap = mod.MonMap()
    mons = []
    for rank, name in enumerate(names):
        monmap.add(name, rank, "127.0.0.1", 0)
    for rank, name in enumerate(names):
        mon = mod.Monitor(name, monmap, config=cfg, **dev)
        addr = await mon.msgr.bind()
        monmap.mons[name] = (rank, addr.host, addr.port)
        mons.append(mon)
    for mon in mons:
        mon._tick_task = asyncio.ensure_future(mon._tick_loop())
    for mon in mons:
        await mon.elector.start()
    return mons, monmap


def client(pkg: str, monmap, **kw):
    mod = PKG[pkg]["mon"]
    mm = mod.MonMap.decode(monmap.encode())
    return mod.MonClient("client.admin", mm, **PKG[pkg]["dev"], **kw)


async def wait_for(pred, timeout=20.0, msg="condition"):
    t0 = asyncio.get_event_loop().time()
    while not pred():
        if asyncio.get_event_loop().time() - t0 > timeout:
            raise TimeoutError(f"timeout waiting for {msg}")
        await asyncio.sleep(0.02)


async def wait_quorum(mons, expect=None):
    live = [m for m in mons if not m._stopped]
    expect = expect if expect is not None else len(live)
    await wait_for(
        lambda: any(m.is_leader() and len(m.quorum) >= expect and
                    m.paxos.active for m in live),
        msg="quorum")
    return next(m for m in live if m.is_leader() and
                len(m.quorum) >= expect)


async def stop_all(mons, clients=()):
    for c in clients:
        await c.shutdown()
    for m in mons:
        if not m._stopped:
            await m.stop()


# -- tests/test_mon.py on the port ---------------------------------------------

def test_single_mon_bootstrap():
    async def go():
        mons, monmap = await start_mons(1)
        leader = await wait_quorum(mons)
        assert leader.quorum == [0]
        await wait_for(lambda: leader.osdmon.osdmap is not None,
                       msg="initial osdmap")
        assert leader.osdmon.osdmap.epoch >= 1
        assert leader.osdmon.osdmap.device.type == "cpu"
        await stop_all(mons)
    run(go())


def test_osd_down_command_rejects_bad_ids():
    async def go():
        mons, monmap = await start_mons(1)
        leader = await wait_quorum(mons)
        await wait_for(lambda: leader.osdmon.osdmap is not None,
                       msg="initial osdmap")
        max_osd = leader.osdmon.osdmap.max_osd
        for bad in (-1, max_osd, max_osd + 7):
            ret, rs, _ = await leader.handle_command(
                {"prefix": "osd down", "id": bad})
            assert ret == -22, (bad, ret, rs)
        assert not leader.osdmon.down_at
        ret, _, _ = await leader.handle_command(
            {"prefix": "osd new", "id": 0})
        assert ret == 0
        epoch = leader.osdmon.osdmap.epoch
        ret, rs, _ = await leader.handle_command(
            {"prefix": "osd down", "id": 0})
        assert ret == 0 and "already down" in rs, (ret, rs)
        assert leader.osdmon.osdmap.epoch == epoch
        assert not leader.osdmon.down_at
        await stop_all(mons)
    run(go())


def test_three_mon_quorum_and_replication():
    async def go():
        mons, monmap = await start_mons(3)
        leader = await wait_quorum(mons)
        assert leader.rank == 0          # lowest rank wins
        assert sorted(leader.quorum) == [0, 1, 2]
        ret, rs, _ = await leader.handle_command(
            {"prefix": "config set", "who": "global",
             "name": "debug_osd", "value": "10"})
        assert ret == 0
        await wait_for(lambda: all(
            m.store.get("config", "global/debug_osd") == b"10"
            for m in mons), msg="config replication")
        await wait_for(lambda: len({m.paxos.last_committed
                                    for m in mons}) == 1,
                       msg="paxos convergence")
        await stop_all(mons)
    run(go())


def test_leader_failover_preserves_state():
    async def go():
        mons, monmap = await start_mons(3)
        leader = await wait_quorum(mons)
        ret, _, _ = await leader.handle_command(
            {"prefix": "config set", "who": "global",
             "name": "key1", "value": "v1"})
        assert ret == 0
        await leader.stop()
        survivors = [m for m in mons if m is not leader]
        new_leader = await wait_quorum(mons, expect=2)
        assert new_leader in survivors
        assert sorted(new_leader.quorum) == sorted(
            m.rank for m in survivors)
        assert new_leader.store.get("config", "global/key1") == b"v1"
        ret, _, _ = await new_leader.handle_command(
            {"prefix": "config set", "who": "global",
             "name": "key2", "value": "v2"})
        assert ret == 0
        await wait_for(lambda: all(
            m.store.get("config", "global/key2") == b"v2"
            for m in survivors), msg="post-failover replication")
        await stop_all(mons)
    run(go())


def test_monclient_commands_and_redirect():
    async def go():
        mons, monmap = await start_mons(3)
        await wait_quorum(mons)
        mc = MonClient("client.admin", monmap, device="cpu")
        mc._cur_rank = 2                 # start at a peon: follow redirects
        ret, rs, outbl = await mc.command({"prefix": "status"})
        assert ret == 0
        assert json.loads(outbl)["quorum"] == [0, 1, 2]
        ret, rs, _ = await mc.command(
            {"prefix": "config set", "who": "global", "name": "x",
             "value": "1"})
        assert ret == 0
        ret, _, outbl = await mc.command(
            {"prefix": "config get", "who": "global", "name": "x"})
        assert ret == 0 and outbl == b"1"
        ret, _, _ = await mc.command({"prefix": "bogus nonsense"})
        assert ret == -22
        await stop_all(mons, [mc])
    run(go())


def test_osdmonitor_lifecycle_via_commands():
    async def go():
        mons, monmap = await start_mons(1)
        leader = await wait_quorum(mons)
        await wait_for(lambda: leader.osdmon.osdmap is not None,
                       msg="osdmap")
        mc = MonClient("client.admin", monmap, device="cpu")
        for i in range(3):
            ret, _, out = await mc.command({"prefix": "osd new"})
            assert ret == 0
            assert json.loads(out)["osdid"] == i
            ret, rs, _ = await mc.command(
                {"prefix": "osd crush add", "id": i, "weight": 1.0,
                 "host": f"host{i}"})
            assert ret == 0, rs
        ret, rs, _ = await mc.command(
            {"prefix": "osd pool create", "pool": "rbd", "pg_num": 8,
             "size": 3})
        assert ret == 0, rs
        ret, _, out = await mc.command({"prefix": "osd dump"})
        dump = json.loads(out)
        assert len(dump["osds"]) == 3
        assert dump["pools"][0]["name"] == "rbd"
        ret, _, out = await mc.command(
            {"prefix": "osd map", "pool": "rbd", "object": "obj1"})
        assert ret == 0
        assert json.loads(out)["acting_primary"] in (-1, 0, 1, 2)
        ret, rs, _ = await mc.command(
            {"prefix": "osd erasure-code-profile set", "name": "p21",
             "profile": ["k=2", "m=1", "crush-failure-domain=osd"]})
        assert ret == 0, rs
        ret, rs, _ = await mc.command(
            {"prefix": "osd pool create", "pool": "ecpool",
             "pg_num": 8, "pool_type": "erasure",
             "erasure_code_profile": "p21"})
        assert ret == 0, rs
        ret, _, out = await mc.command({"prefix": "osd pool ls"})
        pools = json.loads(out)
        assert {p["name"] for p in pools} == {"rbd", "ecpool"}
        ec = next(p for p in pools if p["name"] == "ecpool")
        assert ec["size"] == 3 and ec["type"] == "erasure"
        await stop_all(mons, [mc])
    run(go())


def test_osd_down_and_auto_out():
    async def go():
        mons, monmap = await start_mons(1)
        leader = await wait_quorum(mons)
        await wait_for(lambda: leader.osdmon.osdmap is not None,
                       msg="osdmap")
        mc = MonClient("client.admin", monmap, device="cpu")
        for i in range(2):
            await mc.command({"prefix": "osd new"})
            await mc.command({"prefix": "osd crush add", "id": i,
                              "weight": 1.0, "host": f"h{i}"})
        for i in range(2):
            await leader.osdmon.handle(MOSDBoot(
                osd=i, addr_host="127.0.0.1", addr_port=1000 + i,
                hb_port=2000 + i, boot_epoch=0))
        om = leader.osdmon.osdmap
        assert bool(om.is_up(0)) and bool(om.is_up(1))
        assert om.osd_addrs[1][1] == 1001
        fail = MOSDFailure(target=1, failed_for=5, epoch=om.epoch,
                           reporter="osd.0")
        await leader.osdmon.handle(fail)
        await wait_for(
            lambda: not bool(leader.osdmon.osdmap.is_up(1)),
            msg="osd.1 down")
        await wait_for(
            lambda: leader.osdmon.osdmap.osd_weight[1] == 0,
            timeout=10.0, msg="osd.1 auto-out")
        status = leader.get_status()
        assert status["health"]["status"] == "HEALTH_WARN"
        assert "OSD_DOWN" in status["health"]["checks"]
        await stop_all(mons, [mc])
    run(go())


def test_monclient_survives_mon_death():
    async def go():
        mons, monmap = await start_mons(3)
        leader = await wait_quorum(mons)
        mc = MonClient("client.admin", monmap, device="cpu")
        ret, _, _ = await mc.command({"prefix": "status"})
        assert ret == 0
        await leader.stop()
        await wait_quorum(mons, expect=2)
        ret, _, out = await mc.command({"prefix": "quorum_status"},
                                       timeout=30.0)
        assert ret == 0
        assert len(json.loads(out)["quorum"]) == 2
        await stop_all(mons, [mc])
    run(go())


def test_blocklist_expired_entries_trimmed():
    async def go():
        mons, monmap = await start_mons(1)
        lead = await wait_quorum(mons)
        mc = MonClient("client.admin", monmap, device="cpu")
        try:
            ret, rs, out = await mc.command(
                {"prefix": "osd blocklist", "blocklistop": "add",
                 "addr": "client.ghost", "expire": 0.5})
            assert ret == 0, rs
            ret, _, out = await mc.command(
                {"prefix": "osd blocklist", "blocklistop": "ls"})
            assert ret == 0
            assert "client.ghost" in json.loads(out)["blocklist"]
            assert "client.ghost" in lead.osdmon.osdmap.blocklist
            await asyncio.sleep(0.6)
            ret, _, out = await mc.command(
                {"prefix": "osd blocklist", "blocklistop": "ls"})
            assert ret == 0
            assert json.loads(out)["blocklist"] == {}
            await wait_for(
                lambda: "client.ghost" not in
                lead.osdmon.osdmap.blocklist,
                timeout=10.0, msg="blocklist trim")
        finally:
            await stop_all(mons, [mc])
    run(go())


def test_monitor_and_monclient_default_to_the_card():
    """With no device named, both resolve CUDA; here that raises."""
    mm = MonMap()
    mm.add("a", 0, "127.0.0.1", 0)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Monitor("a", mm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MonClient("client.admin", mm)


# -- side by side: one seeded command script through each package -------------

# the registry's timers (mon_election_timeout 0.3, mon_lease 2.0, ...),
# and no auto-out inside the script's window: the out a down OSD earns
# after mon_osd_down_out_interval is a timer, not a command
SIDE_CFG = {"mon_election_timeout": 0.3, "mon_lease_interval": 0.5,
            "mon_lease": 2.0, "mon_paxos_timeout": 2.0,
            "mon_tick_interval": 0.2, "mon_osd_down_out_interval": 600.0}
N_OSDS = 8
TUNER = {"policy": "script", "mode": "drive", "action": "act"}
OBJECTS = ("obj-a", "rbd_data.1", "x" * 40)


def _mon_dump_named(outbl: bytes) -> bytes:
    """``mon dump`` with each mon's port (the OS's pick for port 0)
    replaced by the mon's name, and without ``quorum`` and ``leader``:
    a peon whose lease lapsed on a loaded host is out of the quorum
    until the next election, a matter of timing."""
    d = json.loads(outbl)
    d["mons"] = {n: [v[0], v[1], n] for n, v in d["mons"].items()}
    del d["quorum"], d["leader"]
    return json.dumps(d, sort_keys=True).encode()


def _script(seed: int, n_steps: int):
    """The seeded change stream: (kind, args) tuples, drawn without
    looking at either package's state."""
    rng = np.random.default_rng(seed)
    steps = []
    kinds = ("down", "out", "in", "reweight", "affinity", "upmap",
             "rm_upmap", "crush_weight", "flag", "pg_num", "quota",
             "config")
    for _ in range(n_steps):
        kind = kinds[int(rng.integers(0, len(kinds)))]
        osd = int(rng.integers(0, N_OSDS))
        steps.append((kind, osd, int(rng.integers(0, N_OSDS)),
                      int(rng.integers(0, 64)), float(rng.integers(1, 9))
                      / 8.0))
    return steps


async def _drive(pkg: str, seed: int):
    """The script through a three-mon quorum of ``pkg``; returns every
    command's output and the committed osdmap prefix of each mon."""
    enc, bld = PKG[pkg]["enc"], PKG[pkg]["builder"]
    msgs = PKG[pkg]["msgs"]
    mons, monmap = await start_mons(3, SIDE_CFG, pkg=pkg)
    leader = await wait_quorum(mons)
    await wait_for(lambda: leader.osdmon.osdmap is not None, msg="osdmap")
    mc = client(pkg, monmap)
    outs = []

    async def cmd(c, inbl=b""):
        ret, rs, outbl = await mc.command(c, inbl, timeout=60.0)
        if c["prefix"] == "mon dump":
            outbl = _mon_dump_named(outbl)
        outs.append((json.dumps(c, sort_keys=True), ret, rs, outbl))
        return ret, rs, outbl

    async def epoch_at_least(e):
        await wait_for(lambda: mc.osdmap is not None and
                       mc.osdmap.epoch >= e, msg=f"epoch {e}")

    async def reads():
        for prefix in ("osd dump", "osd tree", "osd getmap",
                       "osd getcrushmap", "mon dump", "osd pool ls"):
            await cmd({"prefix": prefix})
        for pool in ("rbd", "ec"):
            for obj in OBJECTS:
                await cmd({"prefix": "osd map", "pool": pool,
                           "object": obj})
        await cmd({"prefix": "config get", "who": "osd", "name": "debug"})

    try:
        await mc.subscribe("osdmap", 0)
        rng = np.random.default_rng(seed)
        for i in range(N_OSDS):
            await cmd({"prefix": "osd new"})
            await cmd({"prefix": "osd crush add", "id": i,
                       "weight": float(rng.integers(1, 5)) / 2,
                       "host": f"h{i // 2}"})
        await cmd({"prefix": "osd pool create", "pool": "rbd",
                   "pg_num": 32, "size": 3})
        await cmd({"prefix": "osd erasure-code-profile set", "name": "p21",
                   "profile": ["k=2", "m=1", "crush-failure-domain=osd"]})
        await cmd({"prefix": "osd pool create", "pool": "ec", "pg_num": 16,
                   "pool_type": "erasure", "erasure_code_profile": "p21"})
        await epoch_at_least(leader.osdmon.osdmap.epoch)

        async def boot(osd):
            e = mc.osdmap.epoch
            await mc.send_report(msgs.MOSDBoot(
                osd=osd, addr_host="127.0.0.1", addr_port=6800 + osd,
                hb_port=6900 + osd, boot_epoch=e))
            await epoch_at_least(e + 1)
        for i in range(N_OSDS):
            await boot(i)
        await reads()
        upmapped = []
        for kind, osd, other, seed_, w in _script(seed, 24):
            e = mc.osdmap.epoch
            if kind == "down":
                ret, rs, _ = await cmd({"prefix": "osd down", "id": osd})
                if "already" in rs:
                    await boot(osd)
                else:
                    await epoch_at_least(e + 1)
                    await boot(osd)
            elif kind in ("out", "in"):
                await cmd({"prefix": f"osd {kind}", "id": osd})
            elif kind == "reweight":
                await cmd({"prefix": "osd reweight", "id": osd,
                           "weight": w})
            elif kind == "affinity":
                # with a tuner's provenance, so the affinity holds: an
                # operator's is healed back to 1.0 by the leader's next
                # slow-OSD sweep, on a timer (ROADMAP Queue C)
                await cmd({"prefix": "osd primary-affinity", "id": osd,
                           "weight": w, "provenance": TUNER})
            elif kind == "upmap":
                pgid = f"1.{seed_ % 32:x}"
                upmapped.append(pgid)
                await cmd({"prefix": "osd pg-upmap-items", "pgid": pgid,
                           "mappings": [osd, other]})
            elif kind == "rm_upmap":
                pgid = upmapped.pop() if upmapped else "1.0"
                await cmd({"prefix": "osd rm-pg-upmap-items",
                           "pgid": pgid})
            elif kind == "crush_weight":
                _, _, blob = await cmd({"prefix": "osd getcrushmap"})
                crush = enc.decode_crush_map(blob)
                bld.adjust_item_weight(crush, osd,
                                       int(w * 2 * WEIGHT_ONE))
                await cmd({"prefix": "osd setcrushmap"},
                          enc.encode_crush_map(crush))
            elif kind == "flag":
                await cmd({"prefix": "osd set" if osd % 2 else
                           "osd unset", "key": "noout"})
            elif kind == "pg_num":
                await cmd({"prefix": "osd pool set", "pool": "rbd",
                           "var": "pg_num", "val": str(32 + 2 * seed_)})
            elif kind == "quota":
                await cmd({"prefix": "osd pool set-quota", "pool": "ec",
                           "field": "max_objects", "val": str(seed_)})
            else:
                await cmd({"prefix": "config set", "who": "osd",
                           "name": "debug", "value": str(seed_)})
            await epoch_at_least(leader.osdmon.osdmap.epoch)
            await reads()
        await cmd({"prefix": "osd df"})
        assert sorted((await wait_quorum(mons)).quorum) == [0, 1, 2]
        last = leader.paxos.last_committed
        await wait_for(lambda: all(m.paxos.last_committed == last
                                   for m in mons), msg="paxos convergence")
        stores = [dict(m.store.iterate("osdmap")) for m in mons]
        return outs, stores
    finally:
        await stop_all(mons, [mc])


def test_one_command_script_through_both_packages_commits_equal_maps():
    seed = 20261017
    got = {}
    for pkg in ("ref", "port"):
        box = {}

        async def go(pkg=pkg, box=box):
            box["out"] = await _drive(pkg, seed)
        run(go())
        got[pkg] = box["out"]
    (ref_outs, ref_stores), (port_outs, port_stores) = got["ref"], \
        got["port"]
    assert len(port_outs) == len(ref_outs)
    for ref, port in zip(ref_outs, port_outs):
        assert port == ref, ref[0]
    # every command succeeded, but a config get before the first set
    assert all(o[1] == 0 or (o[1] == -2 and '"config get"' in o[0])
               for o in port_outs), [o[:3] for o in port_outs if o[1]]
    # every epoch's blobs, on every mon, equal across the packages
    for store in ref_stores + port_stores:
        assert store == ref_stores[0]
    last = int.from_bytes(ref_stores[0]["last_epoch"], "little")
    assert {f"full_{e:08x}" for e in range(1, last + 1)} <= \
        set(ref_stores[0])
    assert {f"inc_{e:08x}" for e in range(2, last + 1)} <= \
        set(ref_stores[0])
    assert last > 40


# -- across packages: a client of one on a quorum of the other ----------------

@pytest.mark.parametrize("quorum,monc", [("ref", "port"), ("port", "ref")])
def test_a_client_of_one_package_on_a_quorum_of_the_other(quorum, monc):
    async def go():
        mons, monmap = await start_mons(3, SIDE_CFG, pkg=quorum)
        leader = await wait_quorum(mons)
        await wait_for(lambda: leader.osdmon.osdmap is not None,
                       msg="osdmap")
        mc = client(monc, monmap)
        mc._cur_rank = 1                   # a peon: follow its redirect
        try:
            await mc.subscribe("osdmap", 0)
            for i in range(3):
                ret, _, out = await mc.command({"prefix": "osd new"})
                assert ret == 0 and json.loads(out)["osdid"] == i
                ret, rs, _ = await mc.command(
                    {"prefix": "osd crush add", "id": i, "weight": 1.0,
                     "host": f"h{i}"})
                assert ret == 0, rs
            ret, rs, _ = await mc.command(
                {"prefix": "osd pool create", "pool": "rbd", "pg_num": 8,
                 "size": 3})
            assert ret == 0, rs
            ret, _, out = await mc.command({"prefix": "mon dump"})
            assert ret == 0 and json.loads(out)["quorum"] == [0, 1, 2]
            epoch = leader.osdmon.osdmap.epoch
            await wait_for(lambda: mc.osdmap is not None and
                           mc.osdmap.epoch == epoch, msg="client epoch")
            ret, _, blob = await mc.command({"prefix": "osd getmap"})
            assert blob == leader.osdmon.encode_full()
            assert PKG[monc]["enc"].encode_osdmap(mc.osdmap) == blob
        finally:
            await stop_all(mons, [mc])
    run(go())


# -- across mounts: a mon restarted on the other package's store --------------

@pytest.mark.parametrize("first,second", [("ref", "port"), ("port", "ref")])
def test_a_mon_resumes_on_the_other_packages_store(first, second, tmp_path):
    path = str(tmp_path / "mon.a")
    stores = {"ref": __import__("ceph_tpu.mon.store",
                                fromlist=["MonitorDBStore"]).MonitorDBStore,
              "port": MonitorDBStore}

    async def session(pkg, cmds):
        mod, dev = PKG[pkg]["mon"], PKG[pkg]["dev"]
        monmap = mod.MonMap()
        monmap.add("a", 0, "127.0.0.1", 0)
        store = stores[pkg](path=path)
        mon = mod.Monitor("a", monmap, store=store, config=SIDE_CFG, **dev)
        addr = await mon.msgr.bind()
        monmap.mons["a"] = (0, addr.host, addr.port)
        mon._tick_task = asyncio.ensure_future(mon._tick_loop())
        await mon.elector.start()
        try:
            await wait_quorum([mon])
            await wait_for(lambda: mon.osdmon.osdmap is not None,
                           msg="osdmap")
            resumed = (mon.paxos.last_committed, mon.osdmon.encode_full(),
                       mon.store.get("config", "global/k"))
            for c in cmds:
                ret, rs, _ = await mon.handle_command(c)
                assert ret == 0, (c, rs)
            return resumed, (mon.paxos.last_committed,
                             mon.osdmon.encode_full(),
                             mon.store.get("config", "global/k"))
        finally:
            await mon.stop()
            store.close()

    out = {}

    async def go():
        out["first"] = await session(first, [
            {"prefix": "osd new"}, {"prefix": "osd new"},
            {"prefix": "osd crush add", "id": 1, "weight": 1.0,
             "host": "h1"},
            {"prefix": "osd pool create", "pool": "rbd", "pg_num": 16},
            {"prefix": "config set", "who": "global", "name": "k",
             "value": "v"}])
        out["second"] = await session(second, [{"prefix": "osd new"}])
    run(go())
    _, left = out["first"]
    resumed, after = out["second"]
    assert resumed == left
    assert left[2] == b"v"
    assert after[0] > left[0]
    om = PKG[second]["enc"].decode_osdmap(after[1], **PKG[second]["dev"])
    assert om.max_osd == 3 and om.epoch == \
        PKG[first]["enc"].decode_osdmap(left[1], **PKG[first]["dev"]).epoch + 1


# -- a reference fault both packages share -----------------------------------

@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_an_operators_primary_affinity_is_healed_by_the_next_sweep(pkg):
    """``osd primary-affinity`` without a tuner's provenance commits, and
    the leader's next slow-OSD sweep commits the affinity back to the
    default (``osd_monitor._apply_primary_dampening``): the operator's
    setting does not hold. Pinned in both packages (ROADMAP Queue C)."""
    async def go():
        mons, monmap = await start_mons(1, pkg=pkg)
        leader = await wait_quorum(mons)
        await wait_for(lambda: leader.osdmon.osdmap is not None,
                       msg="osdmap")
        msgs = PKG[pkg]["msgs"]
        try:
            for i in range(2):
                await leader.handle_command({"prefix": "osd new"})
                await leader.handle_command(
                    {"prefix": "osd crush add", "id": i, "weight": 1.0,
                     "host": f"h{i}"})
                await leader.osdmon.handle(msgs.MOSDBoot(
                    osd=i, addr_host="127.0.0.1", addr_port=7000 + i,
                    hb_port=7100 + i, boot_epoch=0))
            default = int(leader.osdmon.osdmap.osd_primary_affinity[1])
            epoch = leader.osdmon.osdmap.epoch
            ret, rs, _ = await leader.handle_command(
                {"prefix": "osd primary-affinity", "id": 1, "weight": 0.0})
            assert ret == 0, rs
            await wait_for(lambda: leader.osdmon.osdmap.epoch >= epoch + 2,
                           msg="the heal's epoch")
            assert int(leader.osdmon.osdmap.osd_primary_affinity[1]) == \
                default
            # a tuner's write (with provenance) holds its lease
            ret, rs, _ = await leader.handle_command(
                {"prefix": "osd primary-affinity", "id": 1, "weight": 0.0,
                 "provenance": TUNER})
            assert ret == 0, rs
            await asyncio.sleep(0.5)          # ten ticks
            assert int(leader.osdmon.osdmap.osd_primary_affinity[1]) == 0
        finally:
            await stop_all(mons)
    run(go())


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_the_fullness_sweep_waits_on_the_map_lock_only_with_a_change(pkg):
    """The leader's tick renews the leases and then runs the fullness
    sweep. ``ceph_tpu``'s sweep takes OSDMonitor's ``_inc_lock`` on every
    tick, so behind a burst of queued map commands the tick (and every
    lease) waits; the port's sweep tries its build on the current map
    first and takes the lock only for a change (ROADMAP Queue C). With
    the lock held and nothing to change, the reference's sweep blocks and
    the port's returns."""
    async def go():
        mons, monmap = await start_mons(1, SIDE_CFG, pkg=pkg)
        leader = await wait_quorum(mons)
        await wait_for(lambda: leader.osdmon.osdmap is not None,
                       msg="osdmap")
        osdmon = leader.osdmon
        try:
            await leader.handle_command({"prefix": "osd new"})
            epoch = osdmon.osdmap.epoch
            async with osdmon._inc_lock:       # a command in flight
                sweep = asyncio.ensure_future(osdmon._check_fullness())
                await asyncio.sleep(0.3)
                blocked = not sweep.done()
            await asyncio.wait_for(sweep, 5.0)
            assert blocked == (pkg == "ref")
            assert osdmon.osdmap.epoch == epoch       # nothing proposed
            # with a change to make, both sweeps commit it: a FULL osd
            await leader.osdmon.handle(PKG[pkg]["msgs"].MOSDBoot(
                osd=0, addr_host="127.0.0.1", addr_port=7000,
                hb_port=7100, boot_epoch=0))
            osdmon.osd_utilization[0] = (99, 100)
            await osdmon._check_fullness()
            assert int(osdmon.osdmap.osd_state[0]) & STATE_FULL
            assert osdmon.osdmap.flags & FLAG_FULL
            assert osdmon.osdmap.epoch == epoch + 2   # the boot, the sweep
        finally:
            await stop_all(mons)
    run(go())



@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_two_mons_can_win_one_epoch(pkg):
    """A reference fault the port keeps (ROADMAP Queue C): rank 1
    proposes and rank 2 acks it; rank 0 proposes in the same epoch and
    rank 1 defers, yet when rank 1's election timer fires it still
    counts the acks it gathered for itself and declares victory, beside
    rank 0. And a rank-2 mon acks both rank 0 and rank 1 in one epoch,
    so each can count it for a majority. Ceph's elector drops a
    deferring mon's candidacy and acks one proposer per epoch."""
    import ceph_tpu.mon.elector as ref_elector
    import ceph_tpu_torch.mon.elector as port_elector
    el_mod, msgs = (ref_elector, ref_msgs) if pkg == "reference" else \
        (port_elector, port_msgs)

    class FakeMon:
        election_timeout = 0.0

        def __init__(self, rank):
            self.rank = rank
            self.sent, self.won = [], []
            self.monmap = type("M", (), {"ranks": lambda _s: [0, 1, 2]})()

        async def send_mon(self, r, m):
            self.sent.append((r, m.op, m.epoch))

        async def win_election(self, epoch, quorum):
            self.won.append((epoch, quorum))

    async def go():
        mon = FakeMon(1)
        el = el_mod.Elector(mon)
        await el.start()                          # propose at epoch 2
        await el.handle(msgs.MMonElection(op=msgs.ELECTION_ACK,
                                          epoch=el.epoch, rank=2,
                                          quorum=[]))
        await el.handle(msgs.MMonElection(op=msgs.ELECTION_PROPOSE,
                                          epoch=el.epoch, rank=0,
                                          quorum=[]))
        el._timer.cancel()
        await el._expire()                        # the timer fires
        await asyncio.sleep(0)
        third = FakeMon(2)
        el3 = el_mod.Elector(third)
        for rank in (0, 1):
            await el3.handle(msgs.MMonElection(op=msgs.ELECTION_PROPOSE,
                                               epoch=3, rank=rank,
                                               quorum=[]))
        if el3._timer:
            el3._timer.cancel()
        return mon.won, mon.sent, [r for r, op, _e in third.sent
                                   if op == msgs.ELECTION_ACK]
    won, sent, acked = asyncio.run(go())
    assert (0, msgs.ELECTION_ACK, 2) in sent      # it deferred to rank 0
    assert won and won[0][1] == [1, 2]            # and still won
    assert acked == [0, 1]                        # one mon acked both
