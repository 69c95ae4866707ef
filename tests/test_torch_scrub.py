"""Deep scrub's device CRC, ceph_tpu_torch against ceph_tpu.

``_device_digests`` turns one PG sweep's per-object ``zlib.crc32`` calls
into one ``device_row_crcs`` job over every C-divisible payload; ragged
and empty payloads go to host zlib because of their shape. Both packages
give the same digests, equal to zlib, on the same seeded payloads (after
``tests/test_ec_read_agg.py``'s stub PG). When the job fails, a plugin on
the CPU falls back to host zlib, as the reference does; a plugin on the
card raises and counts ``device_crc_failures``. The same holds for deep
scrub's batched parity digests, driven through the OSD facade. Last, a
fault of the reference that the port keeps: deep scrub gathers through
the residency cache, so a corrupt shard of a resident object goes unseen
in both packages.

Tolerance: exact (CRC values, error lists).
"""

from __future__ import annotations

import asyncio
import json
import zlib

import numpy as np
import pytest

import chip_smoke as cs
from ceph_tpu_torch.osd import scrub as port_scrub

C = 256


class _Pool:
    def __init__(self, erasure=True):
        self.erasure = erasure

    def is_erasure(self):
        return self.erasure


class _Sinfo:
    chunk_size = C


class _Plugin:
    def __init__(self, device):
        self.device = device


class _PG:
    def __init__(self, device="cpu", erasure=True):
        self.pool = _Pool(erasure)
        self.sinfo = _Sinfo() if erasure else None
        self.ec = _Plugin(device)
        self.pgid = "9.0"


def _loaded(seed: int):
    rng = np.random.default_rng(seed)
    out = [(f"o{i}", rng.integers(0, 256, (i + 1) * C,
                                  dtype=np.uint8).tobytes(), {}, {})
           for i in range(6)]
    out.append(("ragged", b"\x01" * (C + 3), {}, {}))
    out.append(("empty", b"", {}, {}))
    return out


def _delta(before: dict, after: dict, key: str) -> int:
    return after.get(key, 0) - before.get(key, 0)


def test_sweep_digests_are_one_job_and_equal_the_reference():
    from ceph_tpu.osd import scrub as ref_scrub
    loaded = _loaded(14)
    before = port_scrub.SCRUB_PERF.dump()
    got = port_scrub._device_digests(_PG(), loaded)
    after = port_scrub.SCRUB_PERF.dump()
    assert _delta(before, after, "device_crc_jobs") == 1
    assert _delta(before, after, "device_crc_rows") == sum(range(1, 7))
    assert set(got) == {f"o{i}" for i in range(6)}
    for oid, data, _a, _o in loaded[:6]:
        assert got[oid] == zlib.crc32(data), oid
    assert got == ref_scrub._device_digests(_PG(), loaded)
    # replicated PGs never touch the device path, in either package
    assert port_scrub._device_digests(_PG(erasure=False), loaded) == {} \
        == ref_scrub._device_digests(_PG(erasure=False), loaded)


def test_build_scrub_map_equals_the_reference():
    """The whole sweep on one store: every entry (digest, omap digest,
    version, sizes, hcrc) byte-equal to the reference's, ragged and
    empty objects included."""
    from ceph_tpu.os_.objectstore import MemStore as RefStore
    from ceph_tpu.os_.objectstore import Transaction as RefTxn
    from ceph_tpu.osd import scrub as ref_scrub
    from ceph_tpu_torch.os_.objectstore import MemStore, Transaction
    maps = []
    for store, txn, mod in ((MemStore(), Transaction, port_scrub),
                            (RefStore(), RefTxn, ref_scrub)):
        t = txn().create_collection("9.0")
        for i, (oid, data, _a, _o) in enumerate(_loaded(15)):
            t.write("9.0", oid, 0, data)
            t.setattrs("9.0", oid, {"_v": bytes([i]) * 12,
                                    "_size": (len(data) * 2).to_bytes(
                                        8, "little"),
                                    "_hcrc": zlib.crc32(data).to_bytes(
                                        4, "little")})
            t.omap_setkeys("9.0", oid, {f"k{i}": b"v", "_x": b"hidden"})
        store.queue_transaction(t)
        pg = _PG()
        pg.cid = "9.0"
        pg.osd = type("OSD", (), {"store": store})()
        maps.append(mod.build_scrub_map(pg))
    assert maps[0] == maps[1] and len(maps[0]) == 8


def test_device_failure_falls_back_on_the_cpu_only(monkeypatch):
    loaded = _loaded(16)
    want = {oid: zlib.crc32(d) for oid, d, _a, _o in loaded[:6]}

    def broken(rows, device=None):
        raise RuntimeError("injected device CRC failure")
    monkeypatch.setattr(port_scrub._crc, "device_row_crcs", broken)
    before = port_scrub.SCRUB_PERF.dump()
    assert port_scrub._device_digests(_PG("cpu"), loaded) == {}
    assert _delta(before, port_scrub.SCRUB_PERF.dump(),
                  "device_crc_failures") == 0
    # ... and build_scrub_map's host zlib then serves the same digests
    from ceph_tpu_torch.os_.objectstore import MemStore, Transaction
    store = MemStore()
    t = Transaction().create_collection("9.0")
    for oid, data, _a, _o in loaded:
        t.write("9.0", oid, 0, data)
    store.queue_transaction(t)
    pg = _PG("cpu")
    pg.cid, pg.osd = "9.0", type("OSD", (), {"store": store})()
    got = {oid: json.loads(blob)["digest"]
           for oid, blob in port_scrub.build_scrub_map(pg).items()}
    assert {o: got[o] for o in want} == want
    # a plugin on the card raises, counted, never served by zlib
    monkeypatch.setattr(port_scrub, "on_card", lambda ec: True)
    before = port_scrub.SCRUB_PERF.dump()
    with pytest.raises(RuntimeError, match="injected"):
        port_scrub._device_digests(_PG("cuda"), loaded)
    assert _delta(before, port_scrub.SCRUB_PERF.dump(),
                  "device_crc_failures") == 1


def _scrub_cluster(pkg: str, resident: int, corrupt, body):
    """A k=2 m=1 PG of three objects on four OSD facades; ``corrupt``
    picks (object, position) to flip after a warm read of every object;
    ``body(cluster, pg)`` runs the scrub and returns its result."""
    if pkg == "ceph_tpu":
        from tests.test_torch_pg import ref_modules
        mods = ref_modules()
    else:
        mods = cs.pg_modules()
    M = mods.M
    prof = {"plugin": "jax", "k": "2", "m": "1", "stripe_unit": "64",
            "technique": "reed_sol_van", "device": "cpu"}
    rng = np.random.default_rng(17)
    objs = {f"s{i}": rng.integers(0, 256, 300 + 64 * i,
                                  dtype=np.uint8).tobytes()
            for i in range(3)}

    async def go():
        cl = cs.PGCluster(mods, 4, prof, 3, 2, "cpu",
                          {"osd_ec_resident_bytes": resident})
        try:
            await cl.start()
            for oid, data in objs.items():
                r = await cl.client.op(oid, [(M.OSD_OP_WRITEFULL, 0,
                                              len(data), "", data)])
                assert r.result == 0
            for oid in objs:
                r = await cl.client.op(oid, [(M.OSD_OP_READ, 0, 0, "",
                                              b"")])
                assert bytes(r.data) == objs[oid]
            pg = cl.primary()
            if corrupt is not None:
                oid, pos = corrupt
                cl.osds[pg.acting[pos]].store._obj(
                    "1.0", oid).data[3] ^= 0x5A
            return await body(cl, pg)
        finally:
            await cl.stop()
    return asyncio.run(go())


def test_deep_scrub_device_failure_on_cpu_and_card(monkeypatch):
    """Deep scrub's batched parity digests: an injected CRC failure
    inside ``_deep_ec_check`` gives the same report through the host
    path for a plugin on the CPU, and raises for a plugin on the card."""
    async def deep(cl, pg):
        return await pg.scrubber.scrub(deep=True)
    clean = _scrub_cluster("ceph_tpu_torch", 0, ("s1", 0), deep)
    assert clean["errors"] and all(e.startswith("s1:")
                                   for e in clean["errors"])
    real_crcs = port_scrub._crc.device_row_crcs
    real_deep = port_scrub.Scrubber._deep_ec_check
    inside = []

    async def flagged(self, *a, **kw):
        inside.append(True)
        try:
            return await real_deep(self, *a, **kw)
        finally:
            inside.pop()

    def fail_in_deep(rows, device=None):
        if inside:
            raise RuntimeError("injected deep CRC failure")
        return real_crcs(rows, device=device)
    monkeypatch.setattr(port_scrub.Scrubber, "_deep_ec_check", flagged)
    monkeypatch.setattr(port_scrub._crc, "device_row_crcs", fail_in_deep)
    before = port_scrub.SCRUB_PERF.dump()
    assert _scrub_cluster("ceph_tpu_torch", 0, ("s1", 0), deep) == clean
    mid = port_scrub.SCRUB_PERF.dump()
    assert _delta(before, mid, "host_crc_objects") >= 3   # the fallback
    assert _delta(before, mid, "device_crc_failures") == 0
    monkeypatch.setattr(port_scrub, "on_card", lambda ec: True)
    with pytest.raises(RuntimeError, match="injected deep"):
        _scrub_cluster("ceph_tpu_torch", 0, ("s1", 0), deep)
    assert _delta(mid, port_scrub.SCRUB_PERF.dump(),
                  "device_crc_failures") == 1


@pytest.mark.parametrize("pkg", ["ceph_tpu", "ceph_tpu_torch"])
def test_deep_scrub_reads_through_the_residency_cache(pkg):
    """Pinned reference fault (ROADMAP Queue C): ``_deep_ec_check``
    gathers each object through ``_gather``, which serves a resident
    object from the residency cache, so a corrupt shard of an object
    read since its last write goes unseen. Without the cache, the same
    corruption is found. Both packages behave alike."""
    async def deep(cl, pg):
        return await pg.scrubber.scrub(deep=True)
    warm = _scrub_cluster(pkg, 1 << 20, ("s1", 0), deep)
    cold = _scrub_cluster(pkg, 0, ("s1", 0), deep)
    assert warm["errors"] == []
    assert cold["errors"] and all(e.startswith("s1:")
                                  for e in cold["errors"])
