"""RBD images and the mgr on the card.

- ``Mgr(device="cuda")``: its full-cluster placement table maps by
  ``crush_straw2`` on the card, and its balancer's upmap pass asks the
  mon for exactly the ``pg-upmap-items`` that ``Mgr(device="cpu")``
  asks for on the same map; the tables are equal row for row.
- An RBD image on a k=2 m=1 EC pool and one with a snapshot and a clone
  on a replicated pool, in an in-process cluster on the card: every
  read equals a host mirror.
- ``Mgr`` raises without a card unless given ``"cpu"`` (that case runs
  anywhere).

Every gf_encode and crush_straw2 launch is held against its plain
version. The card cases need a CUDA device and skip without one. The
file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_rbd.py -q

Bytes, pairs and placements are compared exactly.
"""

import asyncio

import numpy as np
import pytest
import torch

from ceph_tpu_torch.bench import osdmaptool
from ceph_tpu_torch.cluster.vstart import Cluster
from ceph_tpu_torch.crush import kernels as ckern
from ceph_tpu_torch.encoding import encode_osdmap
from ceph_tpu_torch.gf import kernels as gkern
from ceph_tpu_torch.mgr import BalancerModule, Mgr
from ceph_tpu_torch.mon.monitor import MonMap
from ceph_tpu_torch.rbd import RBD

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
    real_planned = gkern.encode_batch_planned

    def planned(plan, data):
        out = real_planned(plan, data)
        assert torch.equal(out, gkern.gf_encode_plain(plan.bitmatrix, data))
        counts["gf_encode"] += 1
        return out

    def cr(pt, xs, numrep):
        leaves, bad = real_cr(pt, xs, numrep)
        plain, plain_bad = ckern.crush_straw2_plain(pt, xs, numrep)
        assert torch.equal(leaves, plain) and torch.equal(bad, plain_bad)
        counts["crush_straw2"] += 1
        return leaves, bad
    monkeypatch.setattr(gkern, "gf_encode", gf)
    monkeypatch.setattr(gkern, "encode_batch_planned", planned)
    monkeypatch.setattr(ckern, "crush_straw2", cr)
    return counts


def _monmap():
    monmap = MonMap(fsid="t")
    monmap.add("a", 0, "127.0.0.1", 1)
    return monmap


async def _balance(device: str, blob: bytes):
    """One balancer pass of a ``Mgr`` on ``device`` over the map
    ``blob``, its mon stubbed: the commands it sends and its table."""
    mgr = Mgr("x", _monmap(), device=device,
              config={"upmap_max_deviation": 1})
    sent = []

    async def command(cmd, inbl=b"", timeout=None):
        if cmd["prefix"] == "osd getmap":
            return 0, "", blob
        sent.append(cmd)
        return 0, "", b""
    mgr.monc.command = command
    bal = next(m for m in mgr.modules if isinstance(m, BalancerModule))
    applied = await bal.optimize()
    om = await mgr.get("osd_map")
    table = {t: np.asarray(getattr(mgr._mapping._pools[1], t)).copy()
             for t in ("craw", "up", "acting")}
    return applied, sent, table, om.device


def test_mgr_table_and_balancer_on_the_card(checked):
    blob = encode_osdmap(osdmaptool.create_simple(48, 1024, 3,
                                                  erasure=False,
                                                  device="cpu"))
    n_card, cmds_card, table_card, dev = run(_balance("cuda", blob))
    assert checked["crush_straw2"] > 0
    assert str(dev).startswith("cuda")
    n_cpu, cmds_cpu, table_cpu, _ = run(_balance("cpu", blob))
    assert n_card > 0 and n_card == n_cpu
    assert cmds_card == cmds_cpu
    for name in table_cpu:
        assert np.array_equal(table_card[name], table_cpu[name]), name


def test_image_on_the_card(checked):
    async def go():
        c = await Cluster(n_mons=1, n_osds=4,
                          config={"osd_ec_resident_bytes": 16 << 20},
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
            rng = np.random.default_rng(9)
            ec = RBD(await cl.open_ioctx("ec"))
            await ec.create("vol", 1 << 20, order=16)
            img = await ec.open("vol")
            mirror = bytearray(1 << 20)
            for _ in range(24):
                n = int(rng.integers(1, 70_000))
                off = int(rng.integers(0, len(mirror) - n))
                data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                await img.write(off, data)
                mirror[off:off + n] = data
            assert await img.read(0, len(mirror)) == bytes(mirror)
            rep = RBD(await cl.open_ioctx("rep"))
            await rep.create("meta", 256 << 10, order=16)
            src = await rep.open("meta")
            await src.write(0, bytes(mirror[:256 << 10]))
            await src.snap_create("s")
            await src.write(100, b"\xff" * 5000)
            at_snap = await rep.open("meta", snapshot="s")
            assert await at_snap.read(0, 256 << 10) == \
                bytes(mirror[:256 << 10])
            await src.snap_protect("s")
            await rep.clone("meta", "s", "kid")
            kid = await rep.open("kid")
            await kid.write(70_000, b"k" * 10)
            got = await kid.read(0, 256 << 10)
            want = bytearray(mirror[:256 << 10])
            want[70_000:70_010] = b"k" * 10
            assert got == bytes(want)
        finally:
            await c.stop()
        assert checked["gf_encode"] > 0 and checked["crush_straw2"] > 0
    run(go())


def test_mgr_raises_without_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Mgr("x", _monmap())
    mgr = Mgr("x", _monmap(), device="cpu")
    assert mgr.device.type == "cpu" and mgr.monc.device.type == "cpu"
