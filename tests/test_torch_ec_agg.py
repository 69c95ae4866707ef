"""The port's EC write data plane held against ceph_tpu's, byte for byte.

Mirrors tests/test_ec_agg.py case for case, on ``ErasureCodeTorch(...,
device="cpu")`` beside ``ErasureCodeJax`` on JAX's CPU backend, with the
same numpy inputs made from seeds:

- **CRC algebra**: ``raw`` linearity, the length-only affine split, the
  per-row bit matrix against zlib and against ceph_tpu's, the row->shard
  combine, and the two ``hcrc_attr`` producers;
- **fused encode+CRC**: parity and row CRCs equal to
  ``ErasureCodeJax.encode_batch_with_crc``, folding to ``zlib.crc32``;
- **aggregator**: coalescing (results equal per-op encode and ceph_tpu's
  aggregator), every flush trigger, the ``osd_ec_agg=off`` baseline,
  pow2 padding, drain;
- **pipeline**: outputs equal per-batch encodes, in order;
- **degrade ladder**: disaggregation, bounded retries, the host
  reference encoder, the fused-CRC quarantine, the pipeline's fallback
  under an injected fault; a plugin on the card is never served by the
  host: its ladder retries on the device, then raises.

Everything is integer, so the tolerance is equality.
"""

import asyncio
import zlib

import numpy as np
import pytest
import torch

from ceph_tpu.ec import crc as jax_crc
from ceph_tpu.ec.jax_plugin import ErasureCodeJax
from ceph_tpu.osd.ec_aggregator import ECAggregator as JaxECAggregator
from ceph_tpu.sim import faults as F
from ceph_tpu_torch.ec import crc as ec_crc
from ceph_tpu_torch.ec.interface import ErasureCodeInterface
from ceph_tpu_torch.ec.lrc import ErasureCodeLrc
from ceph_tpu_torch.ec.torch_plugin import (ErasureCodeTorch,
                                            StreamingEncodePipeline, to_host)
from ceph_tpu_torch.osd import ec_aggregator as agg_mod
from ceph_tpu_torch.osd.ec_aggregator import ECAggregator
from ceph_tpu_torch.utils import devmon as devmon_mod

K, M, C = 3, 2, 64
N = K + M
PROFILE = f"plugin=jax k={K} m={M} technique=reed_sol_van"


@pytest.fixture(scope="module")
def ec():
    return ErasureCodeTorch(PROFILE, device="cpu")


@pytest.fixture(scope="module")
def jec():
    return ErasureCodeJax(PROFILE)


def _rng(seed=13):
    return np.random.default_rng(seed)


def run(coro):
    return asyncio.run(coro)


# -- CRC algebra (host-side; the facts the fused pass stands on) -----------

def test_raw_crc_linearity_and_affine_split():
    """``raw`` is GF(2)-linear in the message bits; zlib.crc32 is raw
    plus a length-only constant; raw composes through its own state; the
    affine constant equals zlib and ceph_tpu's at every scale."""
    rng = _rng(1)
    for ln in (1, 7, 64, 513):
        a = rng.integers(0, 256, ln, dtype=np.uint8).tobytes()
        b = rng.integers(0, 256, ln, dtype=np.uint8).tobytes()
        x = bytes(p ^ q for p, q in zip(a, b))
        assert ec_crc.raw_crc(x) == \
            ec_crc.raw_crc(a) ^ ec_crc.raw_crc(b)
        assert zlib.crc32(a) == \
            ec_crc.raw_crc(a) ^ zlib.crc32(b"\x00" * ln)
        assert ec_crc.raw_crc(a + b) == \
            ec_crc.raw_crc(b, ec_crc.raw_crc(a))
        assert ec_crc.raw_crc(a) == jax_crc.raw_crc(a)
    for ln in (0, 1, 513, 65537, 1 << 20):
        assert ec_crc._zero_crc(ln) == zlib.crc32(b"\x00" * ln) == \
            jax_crc._zero_crc(ln), ln


def test_row_crc_matrix_matches_zlib():
    """The (8C, 32) GF(2) matrix applied to a row's bits IS the row's raw
    CRC, equals ceph_tpu's matrix, and the torch device leg
    (``row_crcs_t``, chunked over C) gives the same values at widths
    that split into several chunks."""
    rng = _rng(2)
    G = ec_crc.row_crc_matrix(C)
    assert G.shape == (8 * C, 32) and G.dtype == np.int8
    assert np.array_equal(G, jax_crc.row_crc_matrix(C))
    for _ in range(4):
        row = rng.integers(0, 256, C, dtype=np.uint8)
        bits = ((row[:, None] >> np.arange(8)) & 1).reshape(-1)
        acc = (bits.astype(np.int64) @ G.astype(np.int64)) & 1
        val = int((acc.astype(np.uint64) <<
                   np.arange(32, dtype=np.uint64)).sum())
        assert val == ec_crc.raw_crc(row.tobytes())
    for width in (1, 255, 600, 4096 + 3):
        rows = rng.integers(0, 256, (3, width), dtype=np.uint8)
        got = ec_crc.device_row_crcs(rows, device="cpu")
        assert got.dtype == np.uint32
        assert got.tolist() == [ec_crc.raw_crc(r.tobytes()) for r in rows]


def test_hcrc_attr_producers_agree_byte_for_byte():
    """The ``_hcrc`` helper's two producers (row CRCs folded through the
    combine, host ``zlib.crc32``) agree on the attribute bytes for
    multi-row shards, and with ceph_tpu's combine."""
    rng = _rng(3)
    for count in (1, 2, 5, 16):
        rows = rng.integers(0, 256, (count, C), dtype=np.uint8)
        shard = rows.tobytes()
        row_crcs = np.array(
            [ec_crc.raw_crc(r.tobytes()) for r in rows], dtype=np.uint32)
        assert int(ec_crc.shard_crc32(row_crcs, C)) == \
            zlib.crc32(shard) == int(jax_crc.shard_crc32(row_crcs, C))
        assert ec_crc.hcrc_attr(shard, row_crcs=row_crcs,
                                chunk_size=C) == \
            ec_crc.hcrc_attr(shard) == \
            zlib.crc32(shard).to_bytes(4, "little")


# -- fused checksum+encode -------------------------------------------------

@pytest.mark.parametrize("profile,width", [
    (PROFILE, C),
    ("plugin=jax k=4 m=2 technique=liberation w=7", 56)])
def test_fused_encode_crc_bit_exact(profile, width):
    """One pass: parity identical to the plain encode and to ceph_tpu's
    fused program, and per-row CRCs equal ceph_tpu's and folding to
    zlib.crc32 of every shard position's bytes (data and parity)."""
    mine = ErasureCodeTorch(profile, device="cpu")
    theirs = ErasureCodeJax(profile)
    rng = _rng(4)
    data = rng.integers(0, 256, (5, mine.k, width), dtype=np.uint8)
    parity, crcs = mine.encode_batch_with_crc(data)
    parity, crcs = to_host(parity), to_host(crcs).astype(np.uint32)
    j_parity, j_crcs = theirs.encode_batch_with_crc(data)
    assert np.array_equal(parity, np.asarray(j_parity))
    assert np.array_equal(crcs, np.asarray(j_crcs))
    assert np.array_equal(parity, to_host(mine.encode_batch(data)))
    n = mine.k + mine.m
    assert crcs.shape == (5, n)
    word = np.concatenate([data, parity], axis=1)
    for pos in range(n):
        shard = word[:, pos, :].tobytes()     # the ec_pg shard layout
        assert ec_crc.hcrc_attr(shard, row_crcs=crcs[:, pos],
                                chunk_size=width) == \
            zlib.crc32(shard).to_bytes(4, "little"), pos


def test_base_interface_fused_is_optional():
    """A plugin without a fused path returns ``(parity, None)`` from the
    base ``encode_batch_with_crc``; the aggregator then hands back None
    CRCs. LRC's parity equals ceph_tpu's LRC."""
    from ceph_tpu.ec.lrc import ErasureCodeLrc as JaxLrc
    lrc = ErasureCodeLrc("plugin=lrc k=4 m=2 l=3 device=cpu")
    assert lrc.encode_batch_with_crc.__func__ is \
        ErasureCodeInterface.encode_batch_with_crc
    rng = _rng(5)
    data = rng.integers(0, 256, (2, 4, 32), dtype=np.uint8)
    parity, crcs = lrc.encode_batch_with_crc(data)
    assert crcs is None
    assert np.array_equal(to_host(parity), to_host(lrc.encode_batch(data)))
    assert np.array_equal(to_host(parity), np.asarray(
        JaxLrc("plugin=lrc k=4 m=2 l=3").encode_batch(data)))

    async def go():
        agg = ECAggregator({"osd_ec_agg": True})
        p, c = await agg.encode(lrc, data, with_crc=True)
        assert c is None
        assert np.array_equal(p, to_host(parity))
    run(go())


# -- the aggregator --------------------------------------------------------

def test_aggregator_coalesces_bit_exact(ec, jec):
    """Concurrent ops (non-pow2 sizes, mixed with_crc) coalesce into
    FEWER launches than ops; every op's slice equals its own per-op
    encode and ceph_tpu's aggregator's result for the same op, CRCs
    included."""
    rng = _rng(6)
    ops = [rng.integers(0, 256, (b, K, C), dtype=np.uint8)
           for b in (1, 3, 2, 5, 1, 3, 2)]
    cfg = {"osd_ec_agg": True, "osd_ec_agg_window_us": 2000.0}

    async def go(agg, plugin):
        outs = await asyncio.gather(*[
            agg.encode(plugin, d, with_crc=(i % 2 == 0))
            for i, d in enumerate(ops)])
        return outs, agg.dump()

    outs, d = run(go(ECAggregator(dict(cfg)), ec))
    j_outs, _ = run(go(JaxECAggregator(dict(cfg)), jec))
    assert 1 <= d["batches"] < len(ops)
    assert d["ops"] == len(ops)
    assert d["stripes"] == sum(o.shape[0] for o in ops)
    for i, (dat, (p, c), (jp, jc)) in enumerate(zip(ops, outs, j_outs)):
        assert np.array_equal(p, to_host(ec.encode_batch(dat))), i
        assert np.array_equal(p, np.asarray(jp)), i
        if i % 2 == 0:
            assert c.dtype == np.uint32
            assert np.array_equal(c, np.asarray(jc)), i
            word = np.concatenate([dat, p], axis=1)
            for pos in range(N):
                assert ec_crc.hcrc_attr(
                    word[:, pos, :].tobytes(),
                    row_crcs=c[:, pos], chunk_size=C) == \
                    ec_crc.hcrc_attr(word[:, pos, :].tobytes())
        else:
            assert c is None and jc is None, i


def test_aggregator_full_trigger(ec):
    """``osd_ec_agg_max_stripes`` forces an immediate flush: the
    batch-size ceiling fires before any window elapses."""
    rng = _rng(7)

    async def go():
        agg = ECAggregator({"osd_ec_agg": True,
                            "osd_ec_agg_window_us": 1e6,
                            "osd_ec_agg_max_stripes": 4})
        ops = [rng.integers(0, 256, (2, K, C), dtype=np.uint8)
               for _ in range(4)]
        t0 = asyncio.get_event_loop().time()
        await asyncio.gather(*[agg.encode(ec, d) for d in ops])
        took = asyncio.get_event_loop().time() - t0
        assert agg.dump()["flushes"]["full"] >= 1
        assert took < 1.0      # nobody waited for the 1s window
    run(go())


def test_aggregator_lone_op_never_held_past_window(ec):
    """A lone op flushes EARLY on queue idleness, inside the window."""
    rng = _rng(8)

    async def go():
        agg = ECAggregator({"osd_ec_agg": True,
                            "osd_ec_agg_window_us": 10e6})
        d = rng.integers(0, 256, (1, K, C), dtype=np.uint8)
        t0 = asyncio.get_event_loop().time()
        p, _ = await agg.encode(ec, d)
        took = asyncio.get_event_loop().time() - t0
        assert np.array_equal(p, to_host(ec.encode_batch(d)))
        assert took < 9.0, "lone op pinned to the window"
        assert agg.dump()["flushes"]["idle"] == 1
    run(go())


def test_aggregator_window_trigger(ec):
    """An expired window flushes whatever accumulated."""
    rng = _rng(9)

    async def go():
        agg = ECAggregator({"osd_ec_agg": True,
                            "osd_ec_agg_window_us": 0.0})
        ops = [rng.integers(0, 256, (1, K, C), dtype=np.uint8)
               for _ in range(2)]
        await asyncio.gather(*[agg.encode(ec, d) for d in ops])
        assert agg.dump()["flushes"]["window"] >= 1
    run(go())


def test_aggregator_off_is_per_op_baseline(ec):
    """``osd_ec_agg=off`` (read LIVE) serves every encode per-op: no
    batches, a bypass count, identical results; flipped back on, the same
    instance coalesces again."""
    rng = _rng(10)
    ops = [rng.integers(0, 256, (2, K, C), dtype=np.uint8)
           for _ in range(3)]

    async def go():
        cfg = {"osd_ec_agg": False}
        agg = ECAggregator(cfg)
        for d in ops:
            p, c = await agg.encode(ec, d, with_crc=True)
            assert np.array_equal(p, to_host(ec.encode_batch(d)))
            assert c is not None      # fusion is orthogonal to agg
        dmp = agg.dump()
        assert dmp["batches"] == 0 and dmp["bypass"] == len(ops)
        assert dmp["enabled"] is False
        cfg["osd_ec_agg"] = True
        await asyncio.gather(*[agg.encode(ec, d) for d in ops])
        assert agg.dump()["batches"] >= 1
    run(go())


def test_aggregator_pads_to_pow2(ec):
    """Padded launch sizes are pow2, and the pad rows never leak into
    results; the bypass baseline launches unpadded."""
    for b, want in ((1, 1), (2, 2), (3, 4), (5, 8), (9, 16),
                    (4096, 4096)):
        assert ECAggregator._pad(b) == want, b
    rng = _rng(11)
    agg = ECAggregator({})
    d = rng.integers(0, 256, (5, K, C), dtype=np.uint8)  # pads to 8
    launched = []

    class _Spy:
        profile = "spy"

        def encode_batch(self, data):
            launched.append(data.shape[0])
            return ec.encode_batch(data)

        def encode_batch_with_crc(self, data):
            launched.append(data.shape[0])
            return ec.encode_batch_with_crc(data)

    p, crcs = agg._run(_Spy(), d, True)
    assert launched == [8]              # flush path pads 5 -> 8
    assert p.shape == (5, M, C)
    assert crcs.shape == (5, N)
    assert np.array_equal(p, to_host(ec.encode_batch(d)))
    p2, _ = agg._run(_Spy(), d, False, pad=False)
    assert launched == [8, 5]
    assert np.array_equal(p2, p)


def test_aggregator_drain_cancels_waiters(ec):
    """Daemon stop: pending waiters are CANCELLED, timers die, and the
    stopped aggregator serves later stragglers per-op."""
    rng = _rng(12)

    async def go():
        agg = ECAggregator({"osd_ec_agg": True,
                            "osd_ec_agg_window_us": 10e6,
                            "osd_ec_agg_max_stripes": 1 << 20})
        d = rng.integers(0, 256, (1, K, C), dtype=np.uint8)
        waiter = asyncio.ensure_future(agg.encode(ec, d))
        await asyncio.sleep(0)          # entry lands, timer armed
        assert agg.drain() == 1
        with pytest.raises(asyncio.CancelledError):
            await waiter
        assert agg.dump()["pending_ops"] == 0
        p, _ = await agg.encode(ec, d)  # straggler: served, per-op
        assert np.array_equal(p, to_host(ec.encode_batch(d)))
    run(go())


# -- the streaming pipeline ------------------------------------------------

def test_streaming_pipeline_matches_per_batch(ec, jec):
    """Pipelined outputs equal per-batch encodes and ceph_tpu's pipeline,
    in submission order; zero- and one-batch streams behave; the payload
    carve gives the same parity."""
    from ceph_tpu.ec.jax_plugin import StreamingEncodePipeline as JaxPipe
    rng = _rng(14)
    batches = [rng.integers(0, 256, (2, K, C), dtype=np.uint8)
               for _ in range(5)]
    pipe = StreamingEncodePipeline(ec)
    outs = pipe.encode_all([b.copy() for b in batches])
    j_outs = JaxPipe(jec).encode_all([b.copy() for b in batches])
    assert len(outs) == len(batches)
    for i, (b, o, jo) in enumerate(zip(batches, outs, j_outs)):
        assert isinstance(o, np.ndarray)
        assert np.array_equal(o, to_host(ec.encode_batch(b))), i
        assert np.array_equal(o, np.asarray(jo)), i
    assert pipe.encode_all([]) == []
    one = pipe.encode_all([batches[0].copy()])
    assert len(one) == 1 and np.array_equal(one[0], outs[0])
    carved = list(pipe.encode_payload_iter(
        [b.tobytes() for b in batches], K, C))
    assert all(np.array_equal(a, b) for a, b in zip(carved, outs))


# -- the degrade ladder ----------------------------------------------------

class _FlakyEC:
    """Delegates to the module plugin but fails on command: device
    launches raise while a ``poison`` stripe rides in the batch (or
    always, with ``fail_all``), and the reference encoder refuses the
    poison stripe itself: the worst case the ladder must isolate."""

    profile = "flaky"

    def __init__(self, ec, poison=None, fail_all=False):
        self._ec = ec
        self._poison = poison
        self.fail_all = fail_all
        self.device_calls = 0

    def _poisoned(self, data):
        return self._poison is not None and \
            bool((data == self._poison).all(axis=(1, 2)).any())

    def _maybe_fail(self, data):
        self.device_calls += 1
        if self.fail_all or self._poisoned(data):
            raise RuntimeError("injected device failure")

    def encode_batch(self, data):
        self._maybe_fail(data)
        return self._ec.encode_batch(data)

    def encode_batch_with_crc(self, data):
        self._maybe_fail(data)
        return self._ec.encode_batch_with_crc(data)

    def encode_batch_reference(self, data):
        if self._poisoned(data):
            raise RuntimeError("reference refuses the poison stripe")
        return self._ec.encode_batch_reference(data)


def test_flush_failure_rejects_only_the_poisoned_op(ec):
    """A failed batched flush DISAGGREGATES: each batchmate retries
    per-op and is served exactly; only the op whose stripe fails even
    under the reference encoder sees the exception."""
    rng = _rng(16)
    good = [rng.integers(0, 256, (2, K, C), dtype=np.uint8)
            for _ in range(2)]
    poison = np.full((1, K, C), 0xAB, dtype=np.uint8)
    flaky = _FlakyEC(ec, poison=0xAB)

    async def go():
        agg = ECAggregator({"osd_ec_agg": True,
                            "osd_ec_agg_window_us": 2000.0,
                            "osd_ec_fallback_retries": 1})
        outs = await asyncio.gather(
            agg.encode(flaky, good[0]),
            agg.encode(flaky, poison),
            agg.encode(flaky, good[1]),
            return_exceptions=True)
        for i, dat in ((0, good[0]), (2, good[1])):
            p, c = outs[i]
            assert c is None
            assert np.array_equal(p, to_host(ec.encode_batch(dat))), i
        assert isinstance(outs[1], RuntimeError)
        d = agg.perf.dump()
        assert d.get("flush_failures", 0) == 1
        assert d.get("per_op_retries", 0) == 1   # the poison op only
        assert d.get("fallback_ops", 0) == 0     # nothing NEEDED ref
        assert agg.dump()["pending_ops"] == 0
        p, _ = await agg.encode(flaky, good[0])
        assert np.array_equal(p, to_host(ec.encode_batch(good[0])))
        assert agg.perf.dump().get("batches", 0) == 1
    run(go())


def test_degrade_ladder_reference_serves_after_retries(ec):
    """Device encode hard-down: the op is served by the bit-exact host
    reference encoder after exactly ``osd_ec_fallback_retries`` more
    device attempts; CRCs fall back to None."""
    rng = _rng(17)
    d = rng.integers(0, 256, (3, K, C), dtype=np.uint8)
    flaky = _FlakyEC(ec, fail_all=True)

    async def go():
        agg = ECAggregator({"osd_ec_agg": True,
                            "osd_ec_agg_window_us": 100.0,
                            "osd_ec_fallback_retries": 2})
        p, c = await agg.encode(flaky, d, with_crc=True)
        assert c is None
        assert np.array_equal(p, to_host(ec.encode_batch(d)))
        dmp = agg.perf.dump()
        assert dmp.get("flush_failures", 0) == 1
        assert dmp.get("per_op_retries", 0) == 2
        assert dmp.get("fallback_ops", 0) == 1
    run(go())


def test_reference_encoder_bit_exact_both_planes(ec, jec):
    """``encode_batch_reference`` (pure numpy) equals the kernel's path
    and ceph_tpu's reference on both planes: the GF(2^8) product
    (reed_sol_van) and the packet-plane bitmatrix XOR (liberation)."""
    rng = _rng(18)
    d = rng.integers(0, 256, (4, K, C), dtype=np.uint8)
    ref = ec.encode_batch_reference(d)
    assert np.array_equal(ref, to_host(ec.encode_batch(d)))
    assert np.array_equal(ref, jec.encode_batch_reference(d))
    prof = "plugin=jax k=4 m=2 technique=liberation w=7"
    lib = ErasureCodeTorch(prof, device="cpu")
    dl = rng.integers(0, 256, (2, 4, 56), dtype=np.uint8)  # C = 8w
    assert np.array_equal(lib.encode_batch_reference(dl),
                          to_host(lib.encode_batch(dl)))
    assert np.array_equal(lib.encode_batch_reference(dl),
                          ErasureCodeJax(prof).encode_batch_reference(dl))


class _Clock:
    """A stand-in for the aggregators' ``time`` module: ``monotonic``
    moves only when the test says so, so backoff windows do not race
    the host's load."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


def test_fused_crc_quarantine_backoff(ec, monkeypatch):
    """After the fused checksum+encode raises, flushes serve plain encode
    + host crc until an exponential-backoff deadline passes; the next crc
    flush past the deadline IS the probe, and a success resets the
    failure streak."""
    clock = _Clock()
    monkeypatch.setattr(agg_mod, "time", clock)
    rng = _rng(19)
    d = rng.integers(0, 256, (2, K, C), dtype=np.uint8)

    class _CrcDown:
        profile = "crcdown"

        def __init__(self):
            self.fused_calls = 0
            self.ok = False

        def encode_batch(self, data):
            return ec.encode_batch(data)

        def encode_batch_with_crc(self, data):
            self.fused_calls += 1
            if not self.ok:
                raise RuntimeError("fused pass down")
            return ec.encode_batch_with_crc(data)

    plug = _CrcDown()
    agg = ECAggregator({"osd_ec_fallback_quarantine_base": 0.05,
                        "osd_ec_fallback_quarantine_max": 0.2})
    p, c = agg._run(plug, d, True)       # fused fails -> plain serves
    assert c is None and plug.fused_calls == 1
    assert np.array_equal(p, to_host(ec.encode_batch(d)))
    p, c = agg._run(plug, d, True)       # inside the rest window
    assert c is None and plug.fused_calls == 1    # fused NOT retried
    assert agg.perf.dump().get("crc_fallbacks", 0) == 1
    clock.t += 0.06
    p, c = agg._run(plug, d, True)       # probe past deadline: fails
    assert plug.fused_calls == 2 and c is None
    assert agg._crc_failures == 2        # backoff doubled (0.1s)
    assert agg.perf.dump().get("crc_fallbacks", 0) == 2
    plug.ok = True
    clock.t += 0.11
    p, c = agg._run(plug, d, True)       # probe succeeds: fused back
    assert plug.fused_calls == 3 and c is not None
    assert agg._crc_failures == 0
    assert np.array_equal(p, to_host(ec.encode_batch(d)))


def test_streaming_pipeline_falls_back_on_device_fault(ec):
    """An injected mid-stream device failure loses NO batches: the
    pipeline re-encodes in-flight host copies on the unpipelined path
    and drains the rest, in submission order; devmon counts the fallback
    and the injected fault (ceph_tpu's injector, duck-typed)."""
    rng = _rng(20)
    batches = [rng.integers(0, 256, (2, K, C), dtype=np.uint8)
               for _ in range(4)]
    dm = devmon_mod.devmon()
    before = dm.perf.dump()
    inj = F.FaultInjector(seed=16)
    inj.install("stream", [F.jit_fail("ec_stream_encode", count=1)])
    devmon_mod.set_fault_injector(inj)
    try:
        outs = StreamingEncodePipeline(ec).encode_all(
            [b.copy() for b in batches])
    finally:
        devmon_mod.set_fault_injector(None)
    after = dm.perf.dump()
    assert after["stream_fallbacks"] - before["stream_fallbacks"] == 1
    assert after["faults_injected"] - before["faults_injected"] == 1
    assert len(outs) == len(batches)
    for i, (b, o) in enumerate(zip(batches, outs)):
        assert np.array_equal(o, to_host(ec.encode_batch(b))), i


class _OnCard:
    """The module plugin tagged as a plugin on the card (its calls still
    run here on the CPU, through devmon's chokepoint, where the injected
    faults fire): the ladder must keep its work off the host."""

    profile = "oncard"
    device = torch.device("cuda")

    def __init__(self, ec):
        self._ec = ec
        self.reference_calls = 0

    def encode_batch(self, data):
        return self._ec.encode_batch(data)

    def encode_batch_with_crc(self, data):
        return self._ec.encode_batch_with_crc(data)

    def encode_batch_reference(self, data):
        self.reference_calls += 1
        return self._ec.encode_batch_reference(data)


@pytest.mark.parametrize("aggregate", [True, False])
@pytest.mark.parametrize("fn,with_crc", [("ec_encode", False),
                                         ("ec_encode_crc", True)])
def test_card_plugin_ladder_raises_instead_of_host(ec, fn, with_crc,
                                                   aggregate):
    """A device fault on a plugin on the card: the op gets its device
    retries, then fails with the device's error. Neither the host
    reference encoder nor the host-crc quarantine serves it, and once the
    fault heals the next op runs on the device again."""
    rng = _rng(21)
    d = rng.integers(0, 256, (2, K, C), dtype=np.uint8)
    card = _OnCard(ec)
    dm = devmon_mod.devmon()
    inj = F.FaultInjector(seed=21)
    inj.install("down", [F.jit_fail(fn)])

    async def go():
        agg = ECAggregator({"osd_ec_agg": aggregate,
                            "osd_ec_agg_window_us": 100.0,
                            "osd_ec_fallback_retries": 2})
        before = dm.perf.dump()["faults_injected"]
        devmon_mod.set_fault_injector(inj)
        try:
            with pytest.raises(RuntimeError, match="injected device"):
                await agg.encode(card, d, with_crc=with_crc)
        finally:
            devmon_mod.set_fault_injector(None)
        # first try, (aggregated: the per-op retry of the disaggregated
        # batch,) then osd_ec_fallback_retries more
        assert dm.perf.dump()["faults_injected"] - before == \
            (4 if aggregate else 3)
        dmp = agg.perf.dump()
        assert dmp.get("per_op_retries", 0) == 2
        assert dmp.get("flush_failures", 0) == (1 if aggregate else 0)
        assert dmp.get("fallback_ops", 0) == 0
        assert dmp.get("crc_fallbacks", 0) == 0
        assert card.reference_calls == 0
        p, c = await agg.encode(card, d, with_crc=with_crc)
        assert np.array_equal(p, ec.encode_batch_reference(d))
        assert (c is not None) == with_crc
    run(go())
