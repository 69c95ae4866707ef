"""The port's EC read data plane held against ceph_tpu's, byte for byte.

Mirrors tests/test_ec_read_agg.py (all but its ``ec_backend`` case,
which tests/test_torch_ec_backend.py mirrors, and its ``scrub`` case,
whose module is not ported yet), on
``ErasureCodeTorch(..., device="cpu")`` beside ``ErasureCodeJax`` on
JAX's CPU backend, with the same numpy inputs made from seeds:

- **reference decoder**: ``decode_batch_reference`` equals the kernel's
  path and ceph_tpu's on both kernel planes;
- **aggregator**: coalescing (results equal per-op decode and ceph_tpu's
  read aggregator), grouping by erasure pattern, every flush trigger,
  the unpadded ``osd_ec_read_agg=off`` baseline, pow2 padding, drain;
- **degrade ladder**: disaggregation, bounded retries, the reference
  decoder, the device-decode quarantine; a plugin on the card is never
  served by the host or quarantined: it retries on the device, then
  raises;
- **QoS**: repair decodes pay a size-scaled recovery grant;
- **residency**: ``DeviceShardCache`` LRU/budget/invalidation and
  copy-on-insert;
- **scrub CRC**: ``crc.device_row_crcs`` equals ceph_tpu's and folds to
  ``zlib.crc32``.

Everything is integer, so the tolerance is equality.
"""

import asyncio
import zlib

import numpy as np
import pytest
import torch

from ceph_tpu.ec import crc as jax_crc
from ceph_tpu.ec.jax_plugin import ErasureCodeJax
from ceph_tpu.osd.ec_read_aggregator import \
    ECReadAggregator as JaxECReadAggregator
from ceph_tpu.sim import faults as F
from ceph_tpu_torch.ec import crc as ec_crc
from ceph_tpu_torch.ec.torch_plugin import (DeviceShardCache,
                                            ErasureCodeTorch, to_host)
from ceph_tpu_torch.osd import ec_read_aggregator as read_agg_mod
from ceph_tpu_torch.osd.ec_read_aggregator import ECReadAggregator
from ceph_tpu_torch.utils import devmon as devmon_mod

K, M, C = 3, 2, 64
N = K + M
WANT = (0,)             # data chunk 0 lost
AVAIL = (1, 2, 3)       # survivors: data 1..2 + parity 0
PROFILE = f"plugin=jax k={K} m={M} technique=reed_sol_van"


@pytest.fixture(scope="module")
def ec():
    return ErasureCodeTorch(PROFILE, device="cpu")


@pytest.fixture(scope="module")
def jec():
    return ErasureCodeJax(PROFILE)


def _rng(seed=19):
    return np.random.default_rng(seed)


def run(coro):
    return asyncio.run(coro)


def _codeword(ec, rng, b):
    """(b, N, C) real codeword batch + its data half."""
    data = rng.integers(0, 256, (b, K, C), dtype=np.uint8)
    parity = to_host(ec.encode_batch(data))
    return np.concatenate([data, parity], axis=1), data


def _survivors(word):
    return np.stack([word[:, i, :] for i in AVAIL], axis=1)


def _decoded(ec, chunks, want=WANT, avail=AVAIL):
    return to_host(ec.decode_batch(want, avail, chunks))


# -- the reference decoder -------------------------------------------------

def test_reference_decoder_bit_exact_both_planes(ec, jec):
    """``decode_batch_reference`` equals the kernel's decode and
    ceph_tpu's reference on both planes, and reconstructs real
    codewords."""
    rng = _rng(1)
    word, data = _codeword(ec, rng, 4)
    chunks = _survivors(word)
    ref = ec.decode_batch_reference(WANT, AVAIL, chunks)
    assert np.array_equal(ref, _decoded(ec, chunks))
    assert np.array_equal(ref, jec.decode_batch_reference(WANT, AVAIL,
                                                          chunks))
    assert np.array_equal(ref[:, 0, :], data[:, 0, :])
    prof = "plugin=jax k=4 m=2 technique=liberation w=7"
    lib = ErasureCodeTorch(prof, device="cpu")
    dl = rng.integers(0, 256, (2, 4, 56), dtype=np.uint8)   # C = 8w
    wl = np.concatenate([dl, to_host(lib.encode_batch(dl))], axis=1)
    av = (1, 2, 3, 4)
    ch = np.stack([wl[:, i, :] for i in av], axis=1)
    got = lib.decode_batch_reference((0,), av, ch)
    assert np.array_equal(got, _decoded(lib, ch, (0,), av))
    assert np.array_equal(got, ErasureCodeJax(prof).decode_batch_reference(
        (0,), av, ch))
    assert np.array_equal(got[:, 0], dl[:, 0])


# -- the aggregator --------------------------------------------------------

def test_read_aggregator_coalesces_bit_exact(ec, jec):
    """Concurrent decodes (non-pow2 sizes) coalesce into FEWER launches
    than ops; every op's slice equals its own per-op decode and ceph_tpu's
    read aggregator's result."""
    rng = _rng(2)
    ops = [_survivors(_codeword(ec, rng, b)[0])
           for b in (1, 3, 2, 5, 1, 3, 2)]
    cfg = {"osd_ec_read_agg": True, "osd_ec_read_agg_window_us": 2000.0}

    async def go(agg, plugin):
        outs = await asyncio.gather(*[
            agg.decode(plugin, WANT, AVAIL, d) for d in ops])
        return outs, agg.dump()

    outs, d = run(go(ECReadAggregator(dict(cfg)), ec))
    j_outs, _ = run(go(JaxECReadAggregator(dict(cfg)), jec))
    assert 1 <= d["batches"] < len(ops)
    assert d["ops"] == len(ops)
    assert d["stripes"] == sum(o.shape[0] for o in ops)
    for i, (chunks, out, jout) in enumerate(zip(ops, outs, j_outs)):
        assert np.array_equal(out, _decoded(ec, chunks)), i
        assert np.array_equal(out, np.asarray(jout)), i


def test_read_aggregator_groups_by_erasure_pattern(ec):
    """Ops with DIFFERENT (avail, want) never share a launch."""
    rng = _rng(3)
    word, _ = _codeword(ec, rng, 2)
    a = _survivors(word)
    b = np.stack([word[:, i, :] for i in (0, 2, 4)], axis=1)

    async def go():
        agg = ECReadAggregator({"osd_ec_read_agg": True,
                                "osd_ec_read_agg_window_us": 2000.0})
        oa, ob = await asyncio.gather(
            agg.decode(ec, WANT, AVAIL, a),
            agg.decode(ec, (1,), (0, 2, 4), b))
        assert agg.dump()["batches"] == 2    # distinct groups
        assert np.array_equal(oa, _decoded(ec, a))
        assert np.array_equal(ob, _decoded(ec, b, (1,), (0, 2, 4)))
        assert np.array_equal(ob[:, 0], word[:, 1])
    run(go())


def test_read_aggregator_full_trigger(ec):
    """``osd_ec_read_agg_max_stripes`` forces an immediate flush."""
    rng = _rng(4)

    async def go():
        agg = ECReadAggregator({"osd_ec_read_agg": True,
                                "osd_ec_read_agg_window_us": 1e6,
                                "osd_ec_read_agg_max_stripes": 4})
        ops = [_survivors(_codeword(ec, rng, 2)[0]) for _ in range(4)]
        t0 = asyncio.get_event_loop().time()
        await asyncio.gather(*[agg.decode(ec, WANT, AVAIL, d)
                               for d in ops])
        took = asyncio.get_event_loop().time() - t0
        assert agg.dump()["flushes"]["full"] >= 1
        assert took < 1.0      # nobody waited for the 1s window
    run(go())


def test_read_aggregator_lone_op_never_held_past_window(ec):
    """A lone degraded read flushes EARLY on queue idleness."""
    rng = _rng(5)

    async def go():
        agg = ECReadAggregator({"osd_ec_read_agg": True,
                                "osd_ec_read_agg_window_us": 10e6})
        d = _survivors(_codeword(ec, rng, 1)[0])
        t0 = asyncio.get_event_loop().time()
        out = await agg.decode(ec, WANT, AVAIL, d)
        took = asyncio.get_event_loop().time() - t0
        assert np.array_equal(out, _decoded(ec, d))
        assert took < 9.0, "lone op pinned to the window"
        assert agg.dump()["flushes"]["idle"] == 1
    run(go())


def test_read_aggregator_off_is_per_op_baseline(ec):
    """``osd_ec_read_agg=off`` (read LIVE) serves every decode per-op and
    UNPADDED; flipped back on, the same instance coalesces again."""
    rng = _rng(6)
    ops = [_survivors(_codeword(ec, rng, 3)[0]) for _ in range(3)]
    launched = []

    class _Spy:
        profile = "spy"

        def decode_batch(self, want, avail, chunks):
            launched.append(chunks.shape[0])
            return ec.decode_batch(want, avail, chunks)

    async def go():
        cfg = {"osd_ec_read_agg": False}
        agg = ECReadAggregator(cfg)
        for d in ops:
            out = await agg.decode(_Spy(), WANT, AVAIL, d)
            assert np.array_equal(out, _decoded(ec, d))
        dmp = agg.dump()
        assert dmp["batches"] == 0 and dmp["bypass"] == len(ops)
        assert dmp["enabled"] is False
        assert launched == [3, 3, 3]     # UNPADDED per-op launches
        cfg["osd_ec_read_agg"] = True
        await asyncio.gather(*[agg.decode(ec, WANT, AVAIL, d)
                               for d in ops])
        assert agg.dump()["batches"] >= 1
    run(go())


def test_read_aggregator_pads_to_pow2(ec):
    """Padded flush launches are pow2, and the pad rows never leak."""
    for b, want in ((1, 1), (2, 2), (3, 4), (5, 8), (9, 16),
                    (4096, 4096)):
        assert ECReadAggregator._pad(b) == want, b
    rng = _rng(7)
    d = _survivors(_codeword(ec, rng, 5)[0])    # pads to 8
    launched = []

    class _Spy:
        profile = "spy"

        def decode_batch(self, want, avail, chunks):
            launched.append(chunks.shape[0])
            return ec.decode_batch(want, avail, chunks)

    agg = ECReadAggregator({})
    out = agg._run(_Spy(), WANT, AVAIL, d)
    assert launched == [8]              # flush path pads 5 -> 8
    assert out.shape == (5, len(WANT), C)
    assert np.array_equal(out, _decoded(ec, d))
    out2 = agg._run(_Spy(), WANT, AVAIL, d, pad=False)
    assert launched == [8, 5]           # the bypass baseline: unpadded
    assert np.array_equal(out2, out)


def test_read_aggregator_drain_cancels_waiters(ec):
    """Daemon stop: pending waiters are CANCELLED, timers die, and the
    stopped aggregator serves later stragglers per-op."""
    rng = _rng(8)

    async def go():
        agg = ECReadAggregator({"osd_ec_read_agg": True,
                                "osd_ec_read_agg_window_us": 10e6,
                                "osd_ec_read_agg_max_stripes": 1 << 20})
        d = _survivors(_codeword(ec, rng, 1)[0])
        waiter = asyncio.ensure_future(agg.decode(ec, WANT, AVAIL, d))
        await asyncio.sleep(0)          # entry lands, timer armed
        assert agg.drain() == 1
        with pytest.raises(asyncio.CancelledError):
            await waiter
        assert agg.dump()["pending_ops"] == 0
        out = await agg.decode(ec, WANT, AVAIL, d)   # straggler
        assert np.array_equal(out, _decoded(ec, d))
    run(go())


# -- the degrade ladder ----------------------------------------------------

class _FlakyDecodeEC:
    """Delegates to the module plugin but fails on command: device
    decodes raise while a ``poison`` chunk batch rides along (or always,
    with ``fail_all``), and the reference decoder refuses the poison
    batch itself."""

    profile = "flaky"

    def __init__(self, ec, poison=None, fail_all=False):
        self._ec = ec
        self._poison = poison
        self.fail_all = fail_all
        self.device_calls = 0

    def _poisoned(self, chunks):
        return self._poison is not None and \
            bool((chunks == self._poison).all(axis=(1, 2)).any())

    def decode_batch(self, want, avail, chunks):
        self.device_calls += 1
        if self.fail_all or self._poisoned(np.asarray(chunks)):
            raise RuntimeError("injected device failure")
        return self._ec.decode_batch(want, avail, chunks)

    def decode_batch_reference(self, want, avail, chunks):
        if self._poisoned(np.asarray(chunks)):
            raise RuntimeError("reference refuses the poison batch")
        return self._ec.decode_batch_reference(want, avail, chunks)


def test_read_flush_failure_rejects_only_the_poisoned_op(ec):
    """A failed batched flush DISAGGREGATES: each batchmate retries
    per-op and is served exactly; only the op whose chunks fail even
    under the reference decoder sees the exception."""
    rng = _rng(9)
    good = [_survivors(_codeword(ec, rng, 2)[0]) for _ in range(2)]
    poison = np.full((1, len(AVAIL), C), 0xAB, dtype=np.uint8)
    flaky = _FlakyDecodeEC(ec, poison=0xAB)

    async def go():
        agg = ECReadAggregator({"osd_ec_read_agg": True,
                                "osd_ec_read_agg_window_us": 2000.0,
                                "osd_ec_fallback_retries": 1})
        outs = await asyncio.gather(
            agg.decode(flaky, WANT, AVAIL, good[0]),
            agg.decode(flaky, WANT, AVAIL, poison),
            agg.decode(flaky, WANT, AVAIL, good[1]),
            return_exceptions=True)
        for i, chunks in ((0, good[0]), (2, good[1])):
            assert np.array_equal(outs[i], _decoded(ec, chunks)), i
        assert isinstance(outs[1], RuntimeError)
        d = agg.perf.dump()
        assert d.get("flush_failures", 0) == 1
        assert d.get("per_op_retries", 0) >= 1
        assert agg.dump()["pending_ops"] == 0
        out = await agg.decode(flaky, WANT, AVAIL, good[0])
        assert np.array_equal(out, _decoded(ec, good[0]))
    run(go())


class _Clock:
    """A stand-in for the aggregator's ``time`` module: ``monotonic``
    moves only when the test says so, so backoff windows do not race
    the host's load."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


def test_read_degrade_ladder_reference_and_quarantine(ec, monkeypatch):
    """Device decode hard-down: the op is served by the bit-exact
    reference decoder after bounded retries; repeated failures
    quarantine the device (later ops go straight to the reference, zero
    device calls), and the quarantine expires on backoff."""
    clock = _Clock()
    monkeypatch.setattr(read_agg_mod, "time", clock)
    rng = _rng(10)
    d = _survivors(_codeword(ec, rng, 3)[0])
    flaky = _FlakyDecodeEC(ec, fail_all=True)

    async def go():
        agg = ECReadAggregator({
            "osd_ec_read_agg": False,    # bypass: per-op ladder
            "osd_ec_fallback_retries": 1,
            "osd_ec_fallback_quarantine_base": 0.05,
            "osd_ec_fallback_quarantine_max": 0.2})
        out = await agg.decode(flaky, WANT, AVAIL, d)
        assert np.array_equal(out, _decoded(ec, d))
        dmp = agg.perf.dump()
        assert dmp.get("per_op_retries", 0) == 1
        assert dmp.get("fallback_ops", 0) == 1
        calls = flaky.device_calls           # initial try + 1 retry
        assert calls == 2
        out = await agg.decode(flaky, WANT, AVAIL, d)
        assert np.array_equal(out, _decoded(ec, d))
        assert flaky.device_calls == calls
        assert agg.perf.dump().get("quarantined_ops", 0) == 1
        clock.t += 0.06
        await agg.decode(flaky, WANT, AVAIL, d)
        assert flaky.device_calls > calls
        assert agg._dev_failures == 2        # backoff doubled
    run(go())


class _OnCard:
    """The module plugin tagged as a plugin on the card (its calls still
    run here on the CPU, through devmon's chokepoint, where the injected
    faults fire): the ladder must keep its work off the host."""

    profile = "oncard"
    device = torch.device("cuda")

    def __init__(self, ec):
        self._ec = ec
        self.reference_calls = 0

    def decode_batch(self, want, avail, chunks):
        return self._ec.decode_batch(want, avail, chunks)

    def decode_batch_reference(self, want, avail, chunks):
        self.reference_calls += 1
        return self._ec.decode_batch_reference(want, avail, chunks)


@pytest.mark.parametrize("aggregate", [True, False])
def test_card_plugin_read_ladder_raises_never_quarantines(ec, aggregate):
    """A device fault on a plugin on the card: each degraded read gets
    its device retries, then fails with the device's error. The host
    reference decoder never serves it and no quarantine opens, so the
    next read tries the device again, and runs there once the fault
    heals."""
    rng = _rng(12)
    d = _survivors(_codeword(ec, rng, 2)[0])
    card = _OnCard(ec)
    dm = devmon_mod.devmon()
    inj = F.FaultInjector(seed=12)
    inj.install("down", [F.jit_fail("ec_decode")])

    async def go():
        agg = ECReadAggregator({"osd_ec_read_agg": aggregate,
                                "osd_ec_read_agg_window_us": 100.0,
                                "osd_ec_fallback_retries": 1})
        before = dm.perf.dump()["faults_injected"]
        devmon_mod.set_fault_injector(inj)
        try:
            for _ in range(2):
                with pytest.raises(RuntimeError, match="injected device"):
                    await agg.decode(card, WANT, AVAIL, d)
        finally:
            devmon_mod.set_fault_injector(None)
        per_read = 3 if aggregate else 2
        assert dm.perf.dump()["faults_injected"] - before == 2 * per_read
        dmp = agg.perf.dump()
        assert dmp.get("per_op_retries", 0) == 2
        assert dmp.get("fallback_ops", 0) == 0
        assert dmp.get("quarantined_ops", 0) == 0
        assert card.reference_calls == 0
        out = await agg.decode(card, WANT, AVAIL, d)
        assert np.array_equal(out, _decoded(ec, d))
    run(go())


# -- QoS -------------------------------------------------------------------

class _StubScheduler:
    def __init__(self):
        self.grants = []

    async def grant(self, op_class, key=None, cost=1.0):
        self.grants.append((op_class, float(cost)))


def test_repair_decode_charges_recovery_grant(ec):
    """charge_bytes > 0 (a rebuild/backfill decode) pays a recovery-class
    grant at the bytes/osd_qos_cost_per_io_bytes divisor BEFORE queueing,
    the same cost ceph_tpu's scheduler rule gives; charge_bytes=0 pays
    nothing here."""
    from ceph_tpu.osd.scheduler import size_scaled_cost as jax_cost
    rng = _rng(11)
    d = _survivors(_codeword(ec, rng, 2)[0])
    sched = _StubScheduler()
    cfg = {"osd_ec_read_agg": False, "osd_qos_cost_per_io_bytes": 4096}

    async def go():
        agg = ECReadAggregator(cfg, scheduler=sched)
        await agg.decode(ec, WANT, AVAIL, d, charge_bytes=int(d.nbytes))
        assert len(sched.grants) == 1
        op_class, cost = sched.grants[0]
        assert op_class == "recovery"
        assert cost == max(1.0, d.nbytes / 4096) == jax_cost(cfg, d.nbytes)
        assert agg.perf.dump().get("qos_grants", 0) == 1
        await agg.decode(ec, WANT, AVAIL, d, charge_bytes=0)
        assert len(sched.grants) == 1
    run(go())


# -- hot-shard residency ---------------------------------------------------

def test_device_shard_cache_lru_budget_invalidate():
    """LRU order, byte budget, oversized reject, prefix invalidation,
    budget-0 disable, and copy-on-insert (on the CPU device
    ``torch.as_tensor`` would alias the numpy buffer)."""
    ent = np.zeros((2, 3, C), dtype=np.uint8)     # 384 bytes each
    cfg = {"osd_ec_resident_bytes": 3 * ent.nbytes}
    cache = DeviceShardCache(cfg, device="cpu")
    for i in range(3):
        cache.put(("pg1", f"o{i}", 0), np.full_like(ent, i))
    assert cache.get(("pg1", "o0", 0)) is not None   # o0 -> MRU
    cache.put(("pg1", "o3", 0), np.full_like(ent, 3))
    assert cache.get(("pg1", "o1", 0)) is None       # LRU evicted
    got = cache.get(("pg1", "o0", 0))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert np.array_equal(to_host(got), np.zeros_like(ent))
    assert cache.perf.dump().get("evictions", 0) == 1
    cache.put(("pg1", "big", 0), np.zeros(4 * ent.nbytes, dtype=np.uint8))
    assert cache.perf.dump().get("rejected", 0) == 1
    cache.put(("pg2", "oX", 0), ent)
    n = cache.invalidate("pg1")
    assert n >= 2 and cache.get(("pg2", "oX", 0)) is not None
    assert cache.get(("pg1", "o0", 0)) is None
    src = np.full_like(ent, 7)
    cache.put(("pg2", "oY", 0), src)
    src[:] = 0
    assert (to_host(cache.get(("pg2", "oY", 0))) == 7).all()
    off = DeviceShardCache({"osd_ec_resident_bytes": 0}, device="cpu")
    off.put(("k",), ent)
    assert off.get(("k",)) is None and not off.enabled()


# -- device scrub CRC ------------------------------------------------------

def test_device_row_crcs_fold_to_zlib():
    """(R, C) device row CRCs equal ceph_tpu's and fold per shard to
    zlib.crc32 exactly; a non-pow2 row count is padded and cut back."""
    rng = _rng(13)
    rows = rng.integers(0, 256, (12, C), dtype=np.uint8)
    rcs = ec_crc.device_row_crcs(rows, device="cpu")
    assert rcs.shape == (12,) and rcs.dtype == np.uint32
    assert np.array_equal(rcs, jax_crc.device_row_crcs(rows))
    assert int(ec_crc.shard_crc32(rcs, C)) == zlib.crc32(rows.tobytes())
    per = rcs.reshape(4, 3).transpose()           # 3 shards x 4 rows
    got = [int(x) for x in ec_crc.shard_crc32(per, C)]
    want = [zlib.crc32(rows.reshape(4, 3, C)[:, s, :].tobytes())
            for s in range(3)]
    assert got == want
