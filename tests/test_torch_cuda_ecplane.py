"""The port's EC data plane on the card.

Every test here needs a CUDA device and skips without one. The file
imports no jax, so on a machine with a GPU and no JAX it runs without
``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_ecplane.py -q

Covered: the fused checksum+encode against zlib and against the kernel's
own parity; the streaming pipeline (pinned ping/pong staging, side
streams) against per-batch encode, with earlier yielded arrays intact
after later batches reuse the pinned buffers; the residency cache
holding a device copy; the two aggregators on the card; and their
degrade ladders under an injected device fault, which retry on the card
and then raise, never serving the op from the host. Everything is
integer, so the tolerance is byte equality.
"""

import asyncio
import zlib

import numpy as np
import pytest
import torch

from ceph_tpu_torch.ec import crc as ec_crc
from ceph_tpu_torch.ec.torch_plugin import (DeviceShardCache,
                                            ErasureCodeTorch,
                                            StreamingEncodePipeline, to_host)
from ceph_tpu_torch.gf import kernels
from ceph_tpu_torch.osd.ec_aggregator import ECAggregator
from ceph_tpu_torch.osd.ec_read_aggregator import ECReadAggregator
from ceph_tpu_torch.utils import devmon as devmon_mod
from ceph_tpu_torch.utils.devmon import devmon

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ec(k=8, m=3, technique="reed_sol_van"):
    return ErasureCodeTorch(f"plugin=jax k={k} m={m} technique={technique}")


def _bytes(rng, *shape) -> np.ndarray:
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


@pytest.mark.parametrize("B,C", [(7, 4096), (2, 1000), (1, 65536 + 3)])
def test_encode_with_crc_on_card(cuda, B, C):
    """Parity from one fused call equals the kernel's own launch; every
    shard's row CRCs fold to zlib.crc32 of its bytes."""
    ec = _ec()
    data = _bytes(np.random.default_rng(B * C), B, 8, C)
    before = kernels.gf_encode.launches
    parity, crcs = ec.encode_batch_with_crc(data)
    assert kernels.gf_encode.launches == before + 1
    assert parity.device.type == "cuda" and crcs.device.type == "cuda"
    parity = to_host(parity)
    crcs = to_host(crcs).astype(np.uint32)
    assert np.array_equal(parity, to_host(ec.encode_batch(data)))
    word = np.concatenate([data, parity], axis=1)
    got = ec_crc.shard_crc32(crcs.T, C)
    for pos in range(11):
        assert int(got[pos]) == zlib.crc32(word[:, pos].tobytes()), pos


def test_device_row_crcs_on_card(cuda):
    rows = _bytes(np.random.default_rng(5), 300, 4096)
    got = ec_crc.device_row_crcs(rows)
    assert got.tolist() == [ec_crc.raw_crc(r.tobytes()) for r in rows]


def test_pipeline_matches_per_batch_and_keeps_yields(cuda):
    """Outputs equal per-batch encodes, in order, for batches of changing
    sizes; arrays yielded early stay intact after later batches reuse
    the pinned buffers (each is a copy)."""
    ec = _ec()
    rng = np.random.default_rng(11)
    batches = [_bytes(rng, b, 8, 4096) for b in (16, 16, 3, 16, 40, 1, 16)]
    pipe = StreamingEncodePipeline(ec)
    outs, snapshots = [], []
    for out in pipe.encode_iter(batches):
        outs.append(out)
        snapshots.append(out.copy())
    for o, s in zip(outs, snapshots):
        assert np.array_equal(o, s)
    assert len(outs) == len(batches)
    for b, o in zip(batches, outs):
        assert np.array_equal(o, to_host(ec.encode_batch(b)))
        assert np.array_equal(o, ec.encode_batch_reference(b))
    carved = list(pipe.encode_payload_iter([b.tobytes() for b in batches],
                                           8, 4096))
    assert all(np.array_equal(a, b) for a, b in zip(carved, outs))
    assert devmon().perf.dump()["stream_fallbacks"] == 0


def test_residency_cache_holds_a_copy(cuda):
    cache = DeviceShardCache({"osd_ec_resident_bytes": 1 << 20})
    src = np.full((4, 8, 1024), 5, dtype=np.uint8)
    cache.put(("pg", "o", 0), src)
    src[:] = 0
    got = cache.get(("pg", "o", 0))
    assert got.device.type == "cuda"
    assert bool((got == 5).all())
    cache.put(("pg", "o", 1), src)
    cache.put(("pg", "big", 0), np.zeros(1 << 21, dtype=np.uint8))
    assert cache.perf.dump()["rejected"] == 1
    assert cache.invalidate("pg", "o") == 2


def test_aggregators_on_card(cuda):
    """Concurrent writes coalesce into one fused launch and concurrent
    degraded reads into one decode launch; every op equals its own
    encode/decode, and no ladder rung engages."""
    ec = _ec()
    rng = np.random.default_rng(21)
    ops = [_bytes(rng, b, 8, 4096) for b in (3, 8, 1, 5)]

    async def go():
        wagg = ECAggregator({"osd_ec_agg_window_us": 5000.0})
        writes = await asyncio.gather(*[wagg.encode(ec, d, with_crc=True)
                                        for d in ops])
        words = [np.concatenate([d, p], axis=1)
                 for d, (p, _) in zip(ops, writes)]
        ragg = ECReadAggregator({"osd_ec_read_agg_window_us": 5000.0})
        reads = await asyncio.gather(*[
            ragg.decode(ec, (0, 1), tuple(range(2, 10)), w[:, 2:10])
            for w in words])
        return wagg, ragg, writes, words, reads

    wagg, ragg, writes, words, reads = asyncio.run(go())
    for d, (p, c), w, r in zip(ops, writes, words, reads):
        assert np.array_equal(p, to_host(ec.encode_batch(d)))
        assert np.array_equal(r, d[:, :2])
        folded = ec_crc.shard_crc32(c.T, 4096)
        assert [int(x) for x in folded] == \
            [zlib.crc32(w[:, s].tobytes()) for s in range(11)]
    wd, rd = wagg.perf.dump(), ragg.perf.dump()
    assert wd["batches"] == 1 and rd["batches"] == 1
    for key in ("flush_failures", "per_op_retries", "fallback_ops",
                "crc_fallbacks"):
        assert wd[key] == 0, key
    for key in ("flush_failures", "per_op_retries", "fallback_ops",
                "quarantined_ops"):
        assert rd[key] == 0, key


class _FailOn:
    """A fault injector (the duck type ``devmon.set_fault_injector``
    takes) whose verdict fails every device call of the named functions."""

    def __init__(self, *fns):
        self.fns = set(fns)

    def has_device_rules(self):
        return True

    def device_verdicts(self, fn_name, key):
        return 0.0, fn_name in self.fns, False


@pytest.mark.parametrize("aggregate", [True, False])
def test_ladders_raise_on_card(cuda, aggregate):
    """A device fault under a plugin on the card: writes (plain and
    fused-crc) and degraded reads get their device retries, then fail
    with the device's error; the host reference and the host-crc and
    decode quarantines never engage; once the fault heals, the same
    aggregators serve from the card again."""
    ec = _ec()
    rng = np.random.default_rng(31)
    d = _bytes(rng, 4, 8, 4096)
    word = np.concatenate([d, to_host(ec.encode_batch(d))], axis=1)
    wagg = ECAggregator({"osd_ec_agg": aggregate,
                         "osd_ec_agg_window_us": 500.0})
    ragg = ECReadAggregator({"osd_ec_read_agg": aggregate,
                             "osd_ec_read_agg_window_us": 500.0})

    async def go():
        for with_crc in (False, True):
            with pytest.raises(RuntimeError, match="injected device"):
                await wagg.encode(ec, d, with_crc=with_crc)
        with pytest.raises(RuntimeError, match="injected device"):
            await ragg.decode(ec, (0, 1), tuple(range(2, 10)),
                              word[:, 2:10])

    devmon_mod.set_fault_injector(
        _FailOn("ec_encode", "ec_encode_crc", "ec_decode"))
    try:
        asyncio.run(go())
    finally:
        devmon_mod.set_fault_injector(None)
    wd, rd = wagg.perf.dump(), ragg.perf.dump()
    assert wd["per_op_retries"] == 2 and rd["per_op_retries"] == 1
    for key in ("fallback_ops", "crc_fallbacks"):
        assert wd[key] == 0, key
    for key in ("fallback_ops", "quarantined_ops"):
        assert rd[key] == 0, key

    async def healed():
        p, c = await wagg.encode(ec, d, with_crc=True)
        r = await ragg.decode(ec, (0, 1), tuple(range(2, 10)),
                              word[:, 2:10])
        return p, c, r

    p, c, r = asyncio.run(healed())
    assert np.array_equal(p, word[:, 8:]) and c is not None
    assert np.array_equal(r, d[:, :2])
