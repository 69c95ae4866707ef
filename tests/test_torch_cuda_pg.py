"""The erasure-coded PG path on the card.

Every test here needs a CUDA device and skips without one. The file
imports no jax (the OSD facade comes from ``chip_smoke``, which imports
none either), so on a machine with a GPU and no JAX it runs without
``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_pg.py -q

Covered, on a k=4 m=2 PG of seven OSD facades with the plugin, the
aggregators and the residency caches on the card: every gf_encode
launch of writes, reads, degraded reads, recovery, scrub and repair
equals the kernel's plain version; the scrub sweep's device digests
equal zlib; a fault injected into gf_encode during a rebuild raises out
of ``_build_backfill_push`` instead of skipping the push; a residency
hit comes back as host bytes through ``to_host``. Everything is
integer, so the tolerance is byte equality.
"""

import asyncio
import json
import zlib

import numpy as np
import pytest
import torch

import chip_smoke as cs
from ceph_tpu_torch.gf import kernels
from ceph_tpu_torch.osd.recovery import PERF as RECOVERY_PERF

pytestmark = pytest.mark.cuda

K, M, SU = 4, 2, 1024


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cluster(resident=0):
    profile = {"plugin": "jax", "technique": "reed_sol_van", "k": str(K),
               "m": str(M), "stripe_unit": str(SU)}
    return cs.PGCluster(cs.pg_modules(), K + M + 1, profile, K + M, K + 1,
                        "cuda", {"osd_ec_resident_bytes": resident})


def _objects(n, seed=1):
    rng = np.random.default_rng(seed)
    return {f"o{i}": rng.integers(0, 256, K * SU * (3 + i) + 7 * i,
                                  dtype=np.uint8).tobytes()
            for i in range(n)}


async def _write_all(cl, objs):
    M_ = cl.mods.M
    for oid, data in objs.items():
        r = await cl.client.op(oid, [(M_.OSD_OP_WRITEFULL, 0, len(data),
                                      "", data)])
        assert r.result == 0


async def _read(cl, oid):
    r = await cl.client.op(oid, [(cl.mods.M.OSD_OP_READ, 0, 0, "", b"")])
    assert r.result == 0
    return bytes(r.data)


def test_pg_path_on_card_equals_plain(cuda):
    """Writes, reads, degraded reads, recovery onto the spare, a deep
    scrub and a repair on the card; every launch held against the plain
    version."""
    objs = _objects(6)

    async def go(log):
        cl = _cluster()
        try:
            await cl.start()
            assert cl.primary().ec.device.type == "cuda"
            _up, acting, _p = cl.placement(1, 0)
            log.label = "write"
            await _write_all(cl, objs)
            for oid, data in objs.items():
                assert await _read(cl, oid) == data
            await cl.kill([acting[1]])           # min_size is k + 1
            await asyncio.sleep(0)
            await cl.wait_state(("active",))
            log.label = "degraded"
            for oid, data in objs.items():
                assert await _read(cl, oid) == data
            spare = next(o for o in range(K + M + 1) if o not in acting)
            cl.replace(acting[1], spare)
            log.label = "recovery"
            await cs.wait_until(
                lambda: cl.primary().acting[1] == spare and
                cl.primary().state == "clean" and
                not any(cl.primary().peer_missing.values()), 60.0,
                lambda: cl.primary().state)
            pg = cl.primary()
            holder = cl.osds[pg.acting[2]].store
            holder._obj("1.0", "o3").data[11] ^= 0x5A
            log.label = "scrub"
            rep = await pg.scrubber.repair()
            assert rep["repaired"] == 1 and rep["errors_after"] == []
            assert any("o3: shard 2 identified corrupt" in e
                       for e in rep["errors_before"])
            for oid, data in objs.items():
                assert await _read(cl, oid) == data
            return cl.perf_sum("ec_agg", cs.PG_RINGS_AGG), \
                cl.perf_sum("ec_read_agg", cs.PG_RINGS_READ_AGG)
        finally:
            await cl.stop()
    with cs.GfLaunchLog(kernels) as log:
        log.real.launches = 0
        rungs = asyncio.run(go(log))
        launches = log.real.launches
        log.drain("pg path")
    assert log.checked == launches > 0 and log.worst == 0
    for label in ("write", "degraded", "recovery", "scrub"):
        assert log.launches.get(label, 0) > 0, label
    assert not any(rungs[0].values()) and not any(rungs[1].values())


def test_scrub_sweep_device_digests_equal_zlib(cuda):
    objs = _objects(5, seed=2)

    async def go():
        cl = _cluster()
        try:
            await cl.start()
            await _write_all(cl, objs)
            sp0 = cs.pg_modules().scrub.SCRUB_PERF.dump()
            maps = {}
            for i, f in cl.osds.items():
                if "1.0" in f.pgs:
                    maps[i] = {o: json.loads(b) for o, b in
                               cs.pg_modules().scrub.build_scrub_map(
                                   f.pgs["1.0"]).items()}
                    for oid, ent in maps[i].items():
                        assert ent["digest"] == zlib.crc32(
                            f.store.read("1.0", oid)), (i, oid)
            sp1 = cs.pg_modules().scrub.SCRUB_PERF.dump()
            assert sp1["device_crc_jobs"] - sp0.get("device_crc_jobs", 0) \
                == len(maps)
            assert sp1.get("host_crc_objects", 0) == \
                sp0.get("host_crc_objects", 0)
        finally:
            await cl.stop()
    asyncio.run(go())


def test_rebuild_fault_raises_out_of_the_push(cuda, monkeypatch):
    """gf_encode fails during a rebuild: the aggregator retries on the
    card, then the push build raises (counted); it never returns None
    for a later round."""
    objs = _objects(2, seed=3)

    async def go():
        cl = _cluster()
        try:
            await cl.start()
            await _write_all(cl, objs)
            pg = cl.primary()
            target = pg.acting[1]
            assert (await pg._build_backfill_push("o1", target)).exists
            real = kernels.gf_encode

            def broken(bm, data):
                raise RuntimeError("injected gf_encode fault")
            monkeypatch.setattr(kernels, "gf_encode", broken)
            before = RECOVERY_PERF.dump().get("push_device_failures", 0)
            with pytest.raises(RuntimeError, match="injected gf_encode"):
                await pg._build_backfill_push("o1", target)
            assert RECOVERY_PERF.dump()["push_device_failures"] == \
                before + 1
            monkeypatch.setattr(kernels, "gf_encode", real)
            assert (await pg._build_backfill_push("o1", target)).exists
        finally:
            await cl.stop()
    asyncio.run(go())


def test_residency_hit_returns_host_bytes(cuda, monkeypatch):
    objs = _objects(3, seed=4)
    from ceph_tpu_torch.osd import ec_pg
    seen = []
    real = ec_pg.to_host

    def spy(x):
        seen.append(type(x))
        return real(x)
    monkeypatch.setattr(ec_pg, "to_host", spy)

    async def go():
        cl = _cluster(resident=16 << 20)
        try:
            await cl.start()
            await _write_all(cl, objs)
            pg = cl.primary()
            cache = pg.osd.ec_resident
            assert cache.device.type == "cuda"
            for oid, data in objs.items():
                assert await _read(cl, oid) == data       # miss, put
            h0 = cache.dump()["hits"]
            seen.clear()
            for oid, data in objs.items():
                assert await _read(cl, oid) == data       # hit
            assert cache.dump()["hits"] - h0 == len(objs)
            assert seen and all(t is torch.Tensor for t in seen)
            entry = next(iter(cache._lru.values()))[0]
            assert entry.device.type == "cuda"
        finally:
            await cl.stop()
    asyncio.run(go())
