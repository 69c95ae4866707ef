"""The monitor tier on the card: one mon and a tracked MonClient.

A one-mon quorum of the port on the card commits map changes; a
``MonClient`` with ``track_mapping`` keeps its placement table on the
card through ``crush_straw2``. Every launch equals
``crush_straw2_plain`` on the same plan and lanes, the table equals a
from-scratch sweep at every epoch, and a mon commit alone launches no
kernel (the leader's ``osd map`` does).

Every test here needs a CUDA device and skips without one. The file
imports no jax, so on a machine with a GPU and no JAX it runs without
``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_mon.py -q

Placement is integer, so the tolerance is exact equality.
"""

import asyncio
import json

import numpy as np
import pytest
import torch

from ceph_tpu_torch.bench import crush_sweep
from ceph_tpu_torch.crush import builder, kernels
from ceph_tpu_torch.crush.types import ITEM_NONE
from ceph_tpu_torch.encoding import encode_osdmap
from ceph_tpu_torch.mon import MonClient, Monitor, MonitorDBStore, MonMap
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osd.types import POOL_TYPE_ERASURE, ObjectLocator, PGPool

pytestmark = pytest.mark.cuda
_TABLES = ("craw", "up", "up_primary", "acting", "acting_primary")


@pytest.fixture
def checked_launches(monkeypatch):
    """Every crush_straw2 launch held against crush_straw2_plain on the
    same plan and lanes; yields the list of launch widths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    real = kernels.crush_straw2
    widths = []

    def checked(pt, xs, numrep):
        leaves, bad = real(pt, xs, numrep)
        plain, plain_bad = kernels.crush_straw2_plain(pt, xs, numrep)
        assert torch.equal(leaves, plain) and torch.equal(bad, plain_bad)
        widths.append(int(xs.shape[0]))
        return leaves, bad
    monkeypatch.setattr(kernels, "crush_straw2", checked)
    return widths


def _seeded_store(tmp_path) -> MonitorDBStore:
    """``ceph-mon --mkfs --osdmap``: epoch 1 of a 640-OSD map with a
    size-3 pool (the kernel) and a k=4 m=2 pool (the VM)."""
    crush = crush_sweep.canonical_map(640)
    ec_rule = builder.add_simple_rule(crush, crush.rules[0].steps[0].arg1,
                                      builder.TYPE_HOST, indep=True)
    m = OSDMap(crush, device="cpu")
    m.add_pool(PGPool(id=1, pg_num=4096, size=3, crush_rule=0, name="rbd"))
    m.add_pool(PGPool(id=2, pg_num=1024, size=6, type=POOL_TYPE_ERASURE,
                      crush_rule=ec_rule, name="ec"))
    m.epoch = 1
    store = MonitorDBStore(path=str(tmp_path / "mon.a"))
    t = store.transaction()
    t.set("osdmap", f"full_{1:08x}", encode_osdmap(m))
    store.put_u64(t, "osdmap", "last_epoch", 1)
    store.apply(t)
    return store


def _matches_scratch(om, mm):
    assert mm.epoch == om.epoch
    for pid, pool in om.pools.items():
        seeds = np.arange(pool.pg_num, dtype=np.uint32)
        craw, pps = om.pg_to_crush_osds(pid, seeds)
        want = (craw, *om._pipeline_from_crush(pool, seeds, craw, pps))
        for name, w in zip(_TABLES, want):
            assert np.array_equal(getattr(mm._pools[pid], name), w), \
                (pid, name)


def test_one_mon_and_a_tracked_client_on_the_card(checked_launches,
                                                   tmp_path):
    async def go():
        monmap = MonMap()
        monmap.add("a", 0, "127.0.0.1", 0)
        mon = Monitor("a", monmap, store=_seeded_store(tmp_path))
        assert mon.device.type == "cuda"
        addr = await mon.msgr.bind()
        monmap.mons["a"] = (0, addr.host, addr.port)
        mon._tick_task = asyncio.ensure_future(mon._tick_loop())
        await mon.elector.start()
        mc = MonClient("client.admin", monmap)
        mc.track_mapping = True
        in_table = [0]
        handle = mc._handle_osdmap

        async def counted(m):
            n0 = len(checked_launches)
            await handle(m)
            in_table[0] += len(checked_launches) - n0
        mc._handle_osdmap = counted
        try:
            while not (mon.is_leader() and mon.paxos.active):
                await asyncio.sleep(0.02)
            assert mon.osdmon.osdmap.device.type == "cuda"
            await mc.subscribe("osdmap", 0)
            while mc.mapping_table is None:
                await asyncio.sleep(0.01)
            assert checked_launches == [4096]      # the build, pool 1
            _matches_scratch(mc.osdmap, mc.mapping_table)
            up3 = int(mc.mapping_table._pools[1].up[3][0])
            steps = [{"prefix": "osd down", "id": 7},
                     {"prefix": "osd out", "id": 7},
                     {"prefix": "osd reweight", "id": 9, "weight": 0.5},
                     {"prefix": "osd pg-upmap-items", "pgid": "1.3",
                      "mappings": [up3, 11 if up3 != 11 else 12]},
                     {"prefix": "osd in", "id": 7}]
            for step in steps:
                e = mon.osdmon.osdmap.epoch
                n0, t0 = len(checked_launches), in_table[0]
                ret, rs, _ = await mc.command(step)
                assert ret == 0, rs
                while mc.mapping_table.epoch < e + 1:
                    await asyncio.sleep(0.005)
                # every launch of the step was the client's table update:
                # the mon's commit launched none
                assert len(checked_launches) - n0 == in_table[0] - t0
                n1 = len(checked_launches)
                _matches_scratch(mc.osdmap, mc.mapping_table)
                del checked_launches[n1:]          # the scratch sweeps
            assert in_table[0] >= 3                # out, reweight, in
            # a commit with no placement read moves no launch
            n0 = len(checked_launches)
            ret, _, _ = await mon.handle_command(
                {"prefix": "config set", "who": "global", "name": "k",
                 "value": "v"})
            assert ret == 0 and len(checked_launches) == n0
            # the leader's `osd map` runs the kernel on the mon's device
            for j in range(8):
                name = f"obj{j}"
                ret, _, out = await mc.command(
                    {"prefix": "osd map", "pool": "rbd", "object": name})
                got = json.loads(out)
                om, t = mc.osdmap, mc.mapping_table._pools[1]
                pg = om.object_locator_to_pg(name, ObjectLocator(pool=1))
                seed = int(om.pools[1].raw_pg_to_pg(
                    np.asarray([pg.seed]), xp=np)[0])
                assert got["up"] == [int(o) for o in t.up[seed]
                                     if o != ITEM_NONE]
                assert got["acting_primary"] == int(t.acting_primary[seed])
            assert len(checked_launches) > n0
            assert encode_osdmap(mc.osdmap) == mon.osdmon.encode_full()
        finally:
            await mc.shutdown()
            await mon.stop()
            mon.store.close()
    asyncio.run(go())
