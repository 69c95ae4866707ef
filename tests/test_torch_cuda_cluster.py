"""The OSD daemon and the dev cluster on the card.

- A four-OSD ``Cluster`` with a k=2 m=1 pool and a replicated pool on
  the card: every gf_encode launch equals ``gf_encode_plain`` and every
  crush_straw2 launch equals ``crush_straw2_plain`` on the same inputs,
  writes and a degraded read come back equal, and each OSD's ``ECPG``
  plugin, residency cache and ``MonClient`` are on the card.
- A three-OSD ``ProcCluster`` (one process per daemon) on the card
  writes and reads back.
- ``OSD``, ``Rados`` and ``Cluster`` raise without a card unless given
  ``"cpu"`` (that case runs anywhere).

The card cases need a CUDA device and skip without one. The file imports
no jax, so on a machine with a GPU and no JAX it runs without
``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_cluster.py -q

Bytes and placements are compared exactly.
"""

import asyncio

import numpy as np
import pytest
import torch

from ceph_tpu_torch.cluster.vstart import Cluster
from ceph_tpu_torch.crush import kernels as ckern
from ceph_tpu_torch.gf import kernels as gkern
from ceph_tpu_torch.mon.monitor import MonMap
from ceph_tpu_torch.osd.daemon import OSD
from ceph_tpu_torch.rados import Rados

pytestmark = pytest.mark.cuda


def run(coro):
    return asyncio.run(coro)


@pytest.fixture
def checked(monkeypatch):
    """Both kernels held against their plain versions at every launch;
    yields the launch counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    counts = {"gf_encode": 0, "crush_straw2": 0}
    real_gf, real_cr = gkern.gf_encode, ckern.crush_straw2

    def gf(bm, data):
        out = real_gf(bm, data)
        assert torch.equal(out, gkern.gf_encode_plain(bm, data))
        counts["gf_encode"] += 1
        return out

    def cr(pt, xs, numrep):
        leaves, bad = real_cr(pt, xs, numrep)
        plain, plain_bad = ckern.crush_straw2_plain(pt, xs, numrep)
        assert torch.equal(leaves, plain) and torch.equal(bad, plain_bad)
        counts["crush_straw2"] += 1
        return leaves, bad
    monkeypatch.setattr(gkern, "gf_encode", gf)
    monkeypatch.setattr(ckern, "crush_straw2", cr)
    return counts


def test_inproc_cluster_on_the_card(checked):
    async def go():
        c = await Cluster(n_mons=1, n_osds=4,
                          config={"osd_ec_resident_bytes": 16 << 20,
                                  "mon_osd_down_out_interval": 600.0},
                          device="cuda").start()
        try:
            cl = c.client
            ret, rs, _ = await cl.mon_command(
                {"prefix": "osd erasure-code-profile set", "name": "p21",
                 "profile": ["k=2", "m=1", "crush-failure-domain=osd",
                             "stripe_unit=4096"]})
            assert ret == 0, rs
            ret, rs, _ = await cl.mon_command(
                {"prefix": "osd pool create", "pool": "ec", "pg_num": 8,
                 "pool_type": "erasure", "erasure_code_profile": "p21"})
            assert ret == 0, rs
            await cl.pool_create("rep", pg_num=8, size=3)
            await c.wait_for_clean(timeout=120)
            ec = await cl.open_ioctx("ec")
            rep = await cl.open_ioctx("rep")
            rng = np.random.default_rng(8)
            objs = {f"o{i}": rng.integers(0, 256, 20000, dtype=np.uint8)
                    .tobytes() for i in range(8)}
            for oid, data in objs.items():
                await ec.write_full(oid, data)
                await rep.write_full(oid, data[:4096])
            pgs = [pg for o in c.osds for pg in o.pgs.values()
                   if hasattr(pg, "ec")]
            assert pgs and all(pg.ec.device.type == "cuda" for pg in pgs)
            assert all(o.device.type == "cuda" and
                       o.ec_resident.device.type == "cuda" and
                       o.monc.device.type == "cuda" for o in c.osds)
            await c.kill_osd(1)
            await c.wait_for_osd_down(1, timeout=60)
            for oid, data in objs.items():
                assert await ec.read(oid) == data
                assert await rep.read(oid) == data[:4096]
        finally:
            await c.stop()
        assert checked["gf_encode"] > 0 and checked["crush_straw2"] > 0
    run(go())


def test_proc_cluster_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    async def go():
        c = Cluster(n_mons=1, n_osds=3, backend="proc", device="cuda",
                    data_dir=str(tmp_path))
        await c.start()
        try:
            await c.client.pool_create("p", pg_num=8, size=3)
            await c.wait_for_clean(timeout=120)
            io = await c.client.open_ioctx("p")
            for i in range(8):
                await io.write_full(f"x{i}", bytes([i]) * 5000)
            for i in range(8):
                assert await io.read(f"x{i}") == bytes([i]) * 5000
            st = await c.daemon_command("osd.0", "device-runtime status")
            assert "daemon" in st and "process" in st
        finally:
            await c.stop()
    run(go())


def test_entry_points_raise_without_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monmap = MonMap(fsid="t")
    monmap.add("a", 0, "127.0.0.1", 1)
    for make in (lambda d: OSD(0, monmap, device=d),
                 lambda d: Rados(monmap, device=d),
                 lambda d: Cluster(n_mons=1, n_osds=1, device=d),
                 lambda d: Cluster(n_mons=1, n_osds=1, backend="proc",
                                   device=d)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(None)
        obj = make("cpu")
        if hasattr(obj, "data_dir") and getattr(obj, "_own_dir", False):
            import shutil
            shutil.rmtree(obj.data_dir, ignore_errors=True)
