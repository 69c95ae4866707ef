"""A tracked port ``MonClient`` held against the reference's mapping table.

A one-mon port quorum on the CPU commits a stream of map changes (OSDs
created, linked and booted, a replicated and an erasure-coded pool,
down, out, in, reweights down and up, a tuner's primary affinity, a
pg-upmap item set and cleared, a crush bucket-weight edit). A port
``MonClient`` with ``track_mapping`` follows it; at every epoch its
table equals a reference ``OSDMapMapping`` fed the same committed
incrementals from the mon's store, table for table, and took the same
path (``last_full_sweep_pools``).

Tolerance: exact (integers).
"""

from __future__ import annotations

import asyncio

import numpy as np

import ceph_tpu.encoding as ref_enc
import ceph_tpu.osd.osdmap_mapping as ref_mapping
import ceph_tpu_torch.encoding as port_enc
from ceph_tpu.crush.types import WEIGHT_ONE
from ceph_tpu_torch.crush import builder as port_builder
from ceph_tpu_torch.mon import MonClient
from ceph_tpu_torch.mon.messages import MOSDBoot
from test_torch_mon import (SIDE_CFG, TUNER, run, start_mons, stop_all,
                            wait_for, wait_quorum)

TABLES = ("craw", "up", "up_primary", "acting", "acting_primary")


def test_tracked_monclient_table_equals_the_reference_mapping():
    async def go():
        mons, monmap = await start_mons(1, SIDE_CFG)
        leader = await wait_quorum(mons)
        await wait_for(lambda: leader.osdmon.osdmap is not None,
                       msg="osdmap")
        mc = MonClient("client.admin", monmap, device="cpu")
        mc.track_mapping = True
        ref_om, ref_mm = None, ref_mapping.OSDMapMapping()
        compared = []

        def check():
            """Feed the reference every committed epoch the client's
            table has reached and hold the two tables equal."""
            nonlocal ref_om
            table = mc.mapping_table
            fed = ref_om.epoch if ref_om is not None else 0
            while ref_om is None or ref_om.epoch < mc.osdmap.epoch:
                if ref_om is None:
                    ref_om = ref_enc.decode_osdmap(leader.store.get(
                        "osdmap", f"full_{mc.osdmap.epoch:08x}"))
                else:
                    ref_om.apply_incremental(ref_enc.decode_incremental(
                        leader.store.get("osdmap",
                                         f"inc_{ref_om.epoch + 1:08x}")))
            if ref_om.epoch == fed:
                return                   # a commit that is no map epoch
            ref_mm.update(ref_om)
            assert table.epoch == ref_mm.epoch == mc.osdmap.epoch
            assert set(table._pools) == set(ref_mm._pools)
            for pid in ref_mm._pools:
                for name in TABLES:
                    assert np.array_equal(
                        getattr(table._pools[pid], name),
                        np.asarray(getattr(ref_mm._pools[pid], name))), \
                        (mc.osdmap.epoch, pid, name)
            assert table.last_full_sweep_pools == \
                ref_mm.last_full_sweep_pools, mc.osdmap.epoch
            compared.append(mc.osdmap.epoch)

        async def step(c, inbl=b""):
            ret, rs, _ = await mc.command(c, inbl)
            assert ret == 0, (c, rs)
            e = leader.osdmon.osdmap.epoch
            await wait_for(lambda: mc.osdmap is not None and
                           mc.osdmap.epoch == e, msg=f"epoch {e}")
            check()

        try:
            await mc.subscribe("osdmap", 0)
            for i in range(8):
                await step({"prefix": "osd new"})
                await step({"prefix": "osd crush add", "id": i,
                            "weight": 1.0, "host": f"h{i // 2}"})
            await step({"prefix": "osd pool create", "pool": "rbd",
                        "pg_num": 64, "size": 3})
            await step({"prefix": "osd erasure-code-profile set",
                        "name": "p21", "profile": ["k=2", "m=1"]})
            await step({"prefix": "osd pool create", "pool": "ec",
                        "pg_num": 32, "pool_type": "erasure",
                        "erasure_code_profile": "p21"})
            for i in range(8):
                e = mc.osdmap.epoch
                await mc.send_report(MOSDBoot(
                    osd=i, addr_host="127.0.0.1", addr_port=6800 + i,
                    hb_port=6900 + i, boot_epoch=e))
                await wait_for(lambda: mc.osdmap.epoch == e + 1,
                               msg="boot")
                check()
            for c in ({"prefix": "osd down", "id": 3},
                      {"prefix": "osd out", "id": 3},
                      {"prefix": "osd reweight", "id": 5, "weight": 0.5},
                      {"prefix": "osd primary-affinity", "id": 1,
                       "weight": 0.0, "provenance": TUNER},
                      {"prefix": "osd pg-upmap-items", "pgid": "1.7",
                       "mappings": [0, 6]},
                      {"prefix": "osd in", "id": 3},
                      {"prefix": "osd rm-pg-upmap-items", "pgid": "1.7"},
                      {"prefix": "osd reweight", "id": 5, "weight": 1.0}):
                await step(c)
            _, _, blob = await mc.command({"prefix": "osd getcrushmap"})
            crush = port_enc.decode_crush_map(blob)
            port_builder.adjust_item_weight(crush, 2, 2 * WEIGHT_ONE)
            await step({"prefix": "osd setcrushmap"},
                       port_enc.encode_crush_map(crush))
            assert len(compared) >= 30
        finally:
            await stop_all(mons, [mc])
    run(go())
