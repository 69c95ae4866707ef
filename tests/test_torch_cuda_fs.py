"""CephFS and the S3 gateway on the card.

- ``MDSDaemon.create(device="cuda")`` (through ``vstart``'s ``start_fs``,
  an active and a standby) and two ``CephFSClient.create(device="cuda")``
  in an in-process cluster on the card: the MDSs' and clients' placement
  lookups map by ``crush_straw2``; a namespace, file bytes, a snapshot
  and a failover read back exact.
- An ``RGWGateway`` over ``Rados(device="cuda")`` on a k=2 m=1 EC pool:
  PUTs, a multipart upload and GETs, every byte and ETag exact, the
  OSDs' encodes by ``gf_encode`` (the pool's ``indep`` rule is the rule
  VM's, so no lookup there launches ``crush_straw2``).
- ``device="cpu"`` is honoured, and without a card the MDS and the
  client raise (that case runs anywhere).

Every gf_encode and crush_straw2 launch is held against its plain
version. The card cases need a CUDA device and skip without one. The
file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_fs.py -q

Bytes and names are compared exactly.
"""

import asyncio
import hashlib

import numpy as np
import pytest
import torch

from ceph_tpu_torch.cephfs.client import CephFSClient
from ceph_tpu_torch.cephfs.mds import MDSDaemon
from ceph_tpu_torch.cluster.vstart import Cluster
from ceph_tpu_torch.crush import kernels as ckern
from ceph_tpu_torch.gf import kernels as gkern
from ceph_tpu_torch.mon.monitor import MonMap
from ceph_tpu_torch.rgw import RGWGateway

pytestmark = pytest.mark.cuda

FAST_CFG = {"mds_beacon_interval": 0.2, "mds_beacon_grace": 5.0,
            "mds_reconnect_timeout": 1.0, "mds_replay_interval": 0.1}


RUN_LIMIT = 300.0      # s; a stuck script fails instead of holding its worker


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, RUN_LIMIT))


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


def test_mds_and_clients_on_the_card(checked):
    async def go():
        c = await Cluster(n_mons=1, n_osds=3, config=FAST_CFG,
                          device="cuda").start()
        try:
            before = checked["crush_straw2"]
            await c.start_fs(n_mds=2)
            for m in c.mdss:
                assert m.device.type == "cuda"
                assert m.monc.device.type == "cuda"
            clients = [await CephFSClient.create(
                c.monmap, None, "cephfs", keyring=c.keyring, device="cuda")
                for _ in range(2)]
            for cl in clients:
                assert cl.ioctx.rados.monc.device.type == "cuda"
            a, b = clients
            rng = np.random.default_rng(10)
            data = {f"/d/f{i}": rng.bytes(int(rng.integers(1, 200_000)))
                    for i in range(8)}
            await a.mkdir("/d")
            for path, blob in data.items():
                await a.write_file(path, blob)
            await b.mkdir("/d/.snap/s")
            await b.write_file("/d/f0", b"rewritten")
            victim = c.mds_active_name()
            await c.kill_mds(victim)
            await c.wait_for_mds_active(not_name=victim, timeout=45)
            assert await b.ls("/d") == sorted(p[3:] for p in data)
            for path, blob in data.items():
                got = await b.read_file(f"/d/.snap/s/{path[3:]}")
                assert got == blob, path
            assert await a.read_file("/d/f0") == b"rewritten"
            for cl in clients:
                await cl.unmount()
        finally:
            await c.stop()
        assert checked["crush_straw2"] > before
    run(go())


async def _http(port, method, path, body=b""):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                     f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        await writer.drain()
        status = int((await reader.readline()).split()[1])
        hdrs = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode().partition(":")
            hdrs[k.strip().lower()] = v.strip()
        n = int(hdrs.get("content-length", 0))
        payload = b"" if method == "HEAD" or not n else \
            await reader.readexactly(n)
        return status, payload, hdrs.get("etag")
    finally:
        writer.close()


def test_gateway_over_a_card_rados(checked):
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
            await c.wait_for_clean(timeout=120)
            io = await cl.open_ioctx("ec")
            assert io.rados.monc.device.type == "cuda"
            gw = RGWGateway(io)
            port = await gw.start()
            try:
                rng = np.random.default_rng(11)
                assert (await _http(port, "PUT", "/b"))[0] == 200
                objs = {f"o{i}": rng.bytes(int(rng.integers(1, 1 << 20)))
                        for i in range(6)}
                for k, v in objs.items():
                    st, _, etag = await _http(port, "PUT", f"/b/{k}", v)
                    assert st == 200
                    assert etag == f'"{hashlib.md5(v).hexdigest()}"'
                xml = (await _http(port, "POST", "/b/mp?uploads"))[1]
                up = xml.split(b"<UploadId>")[1].split(
                    b"</UploadId>")[0].decode()
                parts = [rng.bytes(600_000), rng.bytes(300_000)]
                for i, p in enumerate(parts, 1):
                    await _http(port, "PUT",
                                f"/b/mp?partNumber={i}&uploadId={up}", p)
                st, _, _ = await _http(port, "POST", f"/b/mp?uploadId={up}")
                assert st == 200
                want = hashlib.md5(b"".join(hashlib.md5(p).digest()
                                            for p in parts)).hexdigest()
                st, got, etag = await _http(port, "GET", "/b/mp")
                assert got == b"".join(parts)
                assert etag == f'"{want}-2"'
                for k, v in objs.items():
                    assert (await _http(port, "GET", f"/b/{k}"))[1] == v
            finally:
                await gw.stop()
        finally:
            await c.stop()
        # the pool's rule is indep, which the rule VM serves: the OSDs
        # encode by gf_encode; no lookup here needs crush_straw2
        assert checked["gf_encode"] > 0
    run(go())


def test_cpu_is_honoured_and_no_card_raises(monkeypatch):
    """Without a card ``MDSDaemon.create`` and ``CephFSClient.create``
    raise before they connect; asked for the CPU they run there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monmap = MonMap(fsid="t")
    monmap.add("a", 0, "127.0.0.1", 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(MDSDaemon.create(monmap, "cephfs"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(CephFSClient.create(monmap, None, "cephfs"))

    async def go():
        c = await Cluster(n_mons=1, n_osds=3, config=FAST_CFG,
                          device="cpu").start()
        try:
            await c.start_fs(n_mds=1)
            assert c.mdss[0].device.type == "cpu"
            cl = await CephFSClient.create(c.monmap, None, "cephfs",
                                           keyring=c.keyring, device="cpu")
            assert cl.ioctx.rados.monc.device.type == "cpu"
            await cl.write_file("/f", b"on the cpu")
            assert await cl.read_file("/f") == b"on the cpu"
            await cl.unmount()
        finally:
            await c.stop()
    run(go())
