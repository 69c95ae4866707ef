"""The port's ECBackendLite held against ceph_tpu's, byte for byte.

Mirrors tests/test_ec_backend.py (stripe math, RMW partial writes,
recovery through minimum_to_decode, scrub localization, churn-hole
recovery) and the ``ec_backend`` residency case of
tests/test_ec_read_agg.py. Each case runs ``ceph_tpu``'s backend (on
JAX's CPU backend) and the port's (plugins on ``device="cpu"``) through
the same op sequence made from seeded numpy inputs, and compares shard
arrays, logical sizes, reads, perf counters, recovery plans and scrub
verdicts. The object-path cases are parametrised over the plugins the
OSD runs: ``reed_sol_van`` and ``cauchy_good`` (the RS plugin), ``lrc``,
``shec`` and ``clay``. Everything is integer, so the tolerance is
equality.
"""

import numpy as np
import pytest

from ceph_tpu.ec import factory as jax_factory
from ceph_tpu.osd.ec_backend import ECBackendLite as JaxBackend
from ceph_tpu.osd.ec_backend import ShardMissing as JaxShardMissing
from ceph_tpu.osd.ecutil import StripeInfo as JaxStripeInfo
from ceph_tpu_torch.ec.registry import factory
from ceph_tpu_torch.osd.ec_backend import (ECBackendLite, ShardMissing,
                                           ec_backend_from_state,
                                           ec_backend_state)
from ceph_tpu_torch.osd.ecutil import StripeInfo

PROFILES = {
    "reed_sol_van": "plugin=jax technique=reed_sol_van k=4 m=2",
    "cauchy_good": "plugin=jax technique=cauchy_good k=4 m=2",
    "lrc": "plugin=lrc k=4 m=2 l=3",
    "shec": "plugin=shec k=4 m=3 c=2",
    "clay": "plugin=clay k=4 m=2 d=5",
}
PLUGINS = list(PROFILES)
CHUNK = 256
COUNTERS = ("write_bytes", "rmw_stripes", "encode_stripes",
            "recover_chunks", "scrub_errors")

_EC_CACHE: dict = {}


def plugin_pair(plugin: str):
    """(ceph_tpu plugin, port plugin on the CPU) for one profile, built
    once per module run (ceph_tpu's jit caches live on the instance)."""
    if plugin not in _EC_CACHE:
        prof = PROFILES[plugin]
        _EC_CACHE[plugin] = (jax_factory(prof),
                             factory(prof + " device=cpu"))
    return _EC_CACHE[plugin]


def backend_pair(plugin: str, chunk: int = CHUNK, config=None):
    jec, tec = plugin_pair(plugin)
    return (JaxBackend(jec, chunk_size=chunk, name=f"jax_{plugin}",
                       config=config),
            ECBackendLite(tec, chunk_size=chunk, name=f"torch_{plugin}",
                          config=config))


def assert_same_state(a, b) -> None:
    """Shards, sizes and counters of the two backends are equal."""
    assert a.sizes == b.sizes
    for s in range(a.n):
        assert set(a.shards[s]) == set(b.shards[s]), s
        for oid, arr in a.shards[s].items():
            assert np.array_equal(arr, b.shards[s][oid]), (s, oid)
    ja, jb = a.perf.dump(), b.perf.dump()
    assert {c: ja[c] for c in COUNTERS} == {c: jb[c] for c in COUNTERS}


def both(a, b, fn):
    """Run ``fn`` on both backends; the results must be equal."""
    got_a, got_b = fn(a), fn(b)
    assert got_a == got_b
    return got_b


def random_writes(a, b, rng, oid: str, n: int, span: int, max_len: int):
    """``n`` seeded writes at unaligned offsets into both backends and a
    bytearray model; returns the model's bytes."""
    model = bytearray(span + max_len)
    high = 0
    for _ in range(n):
        off = int(rng.integers(0, span))
        ln = int(rng.integers(1, max_len))
        payload = rng.integers(0, 256, ln, dtype=np.uint8).tobytes()
        a.write(oid, off, payload)
        b.write(oid, off, payload)
        model[off:off + ln] = payload
        high = max(high, off + ln)
    return bytes(model[:high])


# -- stripe math ------------------------------------------------------------

@pytest.mark.parametrize("method,args", [
    ("logical_to_prev_stripe_offset", [(1023,), (1024,), (5000,)]),
    ("logical_to_next_stripe_offset", [(1,), (1024,), (0,), (5000,)]),
    ("offset_len_to_stripe_bounds", [(100, 2000), (0, 1024), (1023, 2)]),
    ("stripe_range", [(1024, 1024), (1000, 100), (0, 1)]),
    ("object_stripes", [(0,), (1,), (1025,), (4096,)]),
    ("logical_to_stripe_chunk", [(0,), (256,), (1024 + 300,), (4095,)]),
    ("aligned_logical_offset_to_chunk_offset", [(2048,), (0,)]),
    ("chunk_aligned_logical_offset", [(512,), (0,)]),
])
def test_stripe_info_matches_reference(method, args):
    """Every StripeInfo method gives ceph_tpu's answer (k=4, C=256), and
    the reference test's pinned values hold."""
    si, ref = StripeInfo(k=4, chunk_size=256), JaxStripeInfo(4, 256)
    assert si.stripe_width == ref.stripe_width == 1024
    for a in args:
        assert getattr(si, method)(*a) == getattr(ref, method)(*a)
    pinned = {"offset_len_to_stripe_bounds": ((100, 2000), (0, 3072)),
              "stripe_range": ((1000, 100), (0, 2)),
              "logical_to_stripe_chunk": ((1024 + 300,), (1, 1, 44)),
              "object_stripes": ((1025,), 2)}
    if method in pinned:
        a, want = pinned[method]
        assert getattr(si, method)(*a) == want


# -- RMW ----------------------------------------------------------------------

@pytest.mark.parametrize("plugin", PLUGINS)
def test_unaligned_rmw_matches_reference(plugin):
    """Seeded writes at unaligned offsets: the same shards, sizes, reads
    and counters as ceph_tpu's, reads equal a bytearray model, and the
    codeword stays consistent after an arbitrary RMW history."""
    a, b = backend_pair(plugin)
    rng = np.random.default_rng(5)
    model = random_writes(a, b, rng, "obj", 12, 12 << 10, 3 << 10)
    assert_same_state(a, b)
    assert b.read("obj", 0, len(model)) == model
    for off, ln in ((0, 10), (1000, 3000), (len(model) - 7, 100)):
        both(a, b, lambda be: be.read("obj", off, ln))
    assert both(a, b, lambda be: be.scrub("obj")) == []


@pytest.mark.parametrize("case", ["aligned", "partial", "sparse"])
def test_rmw_counts_and_zero_fill(case):
    """The reference's RMW cases: an aligned write takes no RMW, a
    partial one does, and a write past EOF zero-fills the gap."""
    a, b = backend_pair("reed_sol_van")
    if case == "aligned":
        data = bytes(range(256)) * 16                   # 4 stripes exactly
        both(a, b, lambda be: be.write("obj", 0, data))
        assert b.read("obj", 0, len(data)) == data
        assert b.perf.dump()["rmw_stripes"] == 0
    elif case == "partial":
        both(a, b, lambda be: be.write("obj", 0, b"x" * 1024))
        both(a, b, lambda be: be.write("obj", 100, b"y" * 10))
        assert b.perf.dump()["rmw_stripes"] == 1
        assert b.read("obj", 0, 1024) == b"x" * 100 + b"y" * 10 + b"x" * 914
    else:
        both(a, b, lambda be: be.write("obj", 3000, b"tail"))
        assert b.read("obj", 0, 3000) == b"\0" * 3000
        assert b.read("obj", 3000, 4) == b"tail"
        both(a, b, lambda be: be.write("obj", 0, b""))  # empty: no-op
    assert_same_state(a, b)


# -- recovery -------------------------------------------------------------

def _lost_patterns(plugin):
    n = {"lrc": 8, "shec": 7}.get(plugin, 6)
    return [[0], [n - 1], [1, n - 2]]


@pytest.mark.parametrize("plugin,lost", [
    (p, lost) for p in PLUGINS for lost in _lost_patterns(p)])
def test_recover_matches_reference(plugin, lost):
    """Lost shards are rebuilt in one batched decode: the same plan
    (minimum_to_decode), the same rebuilt bytes and counters as
    ceph_tpu's; the data reads back and the codeword scrubs clean."""
    a, b = backend_pair(plugin)
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    both(a, b, lambda be: be.write("obj", 0, data))
    saved = {s: b.shards[s]["obj"].copy() for s in lost}
    for s in lost:
        both(a, b, lambda be: be.lose_shard(s, "obj"))
    assert both(a, b, lambda be: be.missing_shards("obj")) == set(lost)
    plan_lost, to_read = both(a, b, lambda be: be.recovery_plan("obj"))
    assert plan_lost == set(lost) and not to_read & set(lost)
    assert both(a, b, lambda be: be.recover("obj")) == set(lost)
    for s in lost:
        assert np.array_equal(b.shards[s]["obj"], saved[s])
    assert_same_state(a, b)
    assert b.read("obj", 0, len(data)) == data
    assert both(a, b, lambda be: be.scrub("obj")) == []


@pytest.mark.parametrize("plugin", ["reed_sol_van", "lrc"])
def test_recovery_plans_read_locally_or_k(plugin):
    """An MDS code reads at most k chunks; LRC repairs one lost chunk
    from its local layer, fewer than k + m - 1 reads."""
    a, b = backend_pair(plugin, chunk=128)
    data = np.random.default_rng(3).integers(0, 256, 4096,
                                             dtype=np.uint8).tobytes()
    both(a, b, lambda be: be.write("obj", 0, data))
    both(a, b, lambda be: be.lose_shard(0, "obj"))
    _, to_read = both(a, b, lambda be: be.recovery_plan("obj"))
    k, m = b.k, b.m
    assert len(to_read) <= k if plugin != "lrc" else \
        len(to_read) < k + m - 1
    both(a, b, lambda be: be.recover("obj"))
    assert b.read("obj", 0, len(data)) == data


def test_data_read_blocked_until_recovered():
    a, b = backend_pair("reed_sol_van")
    both(a, b, lambda be: be.write("obj", 0, b"a" * 4096))
    both(a, b, lambda be: be.lose_shard(1, "obj"))
    with pytest.raises(JaxShardMissing):
        a.read("obj", 0, 4096)
    with pytest.raises(ShardMissing):
        b.read("obj", 0, 4096)
    both(a, b, lambda be: be.recover("obj"))
    assert b.read("obj", 0, 4096) == b"a" * 4096


@pytest.mark.parametrize("plugin", PLUGINS)
def test_recover_all_whole_shard_loss(plugin):
    """An OSD dies: one shard of every object is gone; recover_all
    rebuilds them all, as ceph_tpu's does."""
    a, b = backend_pair(plugin)
    rng = np.random.default_rng(9)
    payloads = {}
    for i in range(4):
        payloads[f"o{i}"] = rng.integers(0, 256, 2048 + 512 * i,
                                         dtype=np.uint8).tobytes()
        both(a, b, lambda be: be.write(f"o{i}", 0, payloads[f"o{i}"]))
    both(a, b, lambda be: be.lose_shard(2))
    fixed = both(a, b, lambda be: be.recover_all())
    assert set(fixed) == set(payloads)
    assert_same_state(a, b)
    for oid, want in payloads.items():
        assert b.read(oid, 0, len(want)) == want


# -- scrub ----------------------------------------------------------------

@pytest.mark.parametrize("plugin,where", [
    (p, w) for p in PLUGINS for w in ("data", "parity", "two")])
def test_scrub_localizes_like_reference(plugin, where):
    """A silent byte flip in one data or one parity shard is localized
    to that shard by exclusion; two corrupted shards return every shard
    id. Same verdicts and scrub_errors as ceph_tpu's."""
    a, b = backend_pair(plugin)
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    both(a, b, lambda be: be.write("obj", 0, data))
    assert both(a, b, lambda be: be.scrub("obj")) == []
    flips = {"data": [(1, 1, 7)], "parity": [(b.n - 1, 0, 0)],
             "two": [(1, 1, 7), (b.n - 1, 0, 0)]}[where]
    for be in (a, b):
        for s, row, col in flips:
            be.shards[s]["obj"][row, col] ^= 0xA5
    got = both(a, b, lambda be: be.scrub("obj"))
    if where == "two":
        assert got == list(range(b.n))
    else:
        assert got == [flips[0][0]]
    assert_same_state(a, b)


def test_scrub_reports_missing_shards():
    a, b = backend_pair("reed_sol_van")
    both(a, b, lambda be: be.write("obj", 0, b"z" * 3000))
    both(a, b, lambda be: be.lose_shard(4, "obj"))
    assert both(a, b, lambda be: be.scrub("obj")) == [4]
    assert both(a, b, lambda be: be.scrub("absent")) == []


# -- churn ------------------------------------------------------------------

def test_churn_holes_recovered_by_decode():
    """When an OSD dies, each degraded PG's object loses the shard the
    victim held and recovers it by decode; the data survives. The PG
    placement comes from the port's own churn simulator."""
    from ceph_tpu_torch.bench import osdmaptool
    from ceph_tpu_torch.sim import ChurnEvent, ChurnSim

    m = osdmaptool.create_simple(12, 16, 5, erasure=True, device="cpu")
    sim = ChurnSim(m, 1)
    rng = np.random.default_rng(13)
    jec = jax_factory("plugin=jax technique=reed_sol_van k=3 m=2")
    tec = factory("plugin=jax technique=reed_sol_van k=3 m=2 device=cpu")
    pairs, payloads = {}, {}
    for pg in range(16):
        a = JaxBackend(jec, chunk_size=128, name="jax_churn")
        b = ECBackendLite(tec, chunk_size=128, name="torch_churn")
        data = rng.integers(0, 256, 1536, dtype=np.uint8).tobytes()
        both(a, b, lambda be: be.write(f"pg{pg}", 0, data))
        pairs[pg], payloads[pg] = (a, b), data
    victim = int(sim._up[0, 0])
    up_before = sim._up.copy()
    sim.apply(ChurnEvent("down", victim))
    recovered = 0
    for pg, (a, b) in pairs.items():
        for slot in range(5):
            if up_before[pg, slot] == victim:
                both(a, b, lambda be: be.lose_shard(slot, f"pg{pg}"))
        recovered += len(both(a, b, lambda be: be.recover(f"pg{pg}")))
        assert b.read(f"pg{pg}", 0, 1536) == payloads[pg]
        assert both(a, b, lambda be: be.scrub(f"pg{pg}")) == []
        assert_same_state(a, b)
    assert recovered > 0                    # the victim held shards


# -- residency --------------------------------------------------------------

RESIDENT_COUNTERS = ("hits", "misses", "inserts", "invalidations",
                     "evictions")


def test_residency_generation_discipline():
    """Residency on: repeated reads hit the cache; every mutator (write,
    lose_shard, recover) bumps the generation, so an RMW merge never sees
    stale bytes and reads stay exact. The cache counters move as
    ceph_tpu's do, and the cache lives on the plugin's device."""
    cfg = {"osd_ec_resident_bytes": 1 << 20}
    a, b = backend_pair("reed_sol_van", chunk=64, config=cfg)
    assert b.resident is not None
    assert b.resident.device == b.ec.device
    rng = np.random.default_rng(12)
    payload = rng.integers(0, 256, 2 * 4 * 64, dtype=np.uint8).tobytes()
    both(a, b, lambda be: be.write("obj", 0, payload))
    assert both(a, b, lambda be: be.read("obj", 0, len(payload))) \
        == payload                                        # miss + pin
    h0 = b.resident.perf.dump().get("hits", 0)
    assert both(a, b, lambda be: be.read("obj", 0, len(payload))) \
        == payload                                        # hit
    assert b.resident.perf.dump().get("hits", 0) > h0
    both(a, b, lambda be: be.write("obj", 10, b"\xDD" * 40))
    want = bytearray(payload)
    want[10:50] = b"\xDD" * 40
    assert both(a, b, lambda be: be.read("obj", 0, len(payload))) \
        == bytes(want)
    assert both(a, b, lambda be: be.read("obj", 0, len(payload))) \
        == bytes(want)                                    # fresh hit
    both(a, b, lambda be: be.lose_shard(0, "obj"))
    assert both(a, b, lambda be: be.recover("obj")) == {0}
    assert both(a, b, lambda be: be.read("obj", 0, len(payload))) \
        == bytes(want)
    assert_same_state(a, b)
    ra, rb = a.resident.perf.dump(), b.resident.perf.dump()
    assert {c: ra.get(c, 0) for c in RESIDENT_COUNTERS} == \
        {c: rb.get(c, 0) for c in RESIDENT_COUNTERS}
    assert rb["resident_bytes"] <= cfg["osd_ec_resident_bytes"]


@pytest.mark.parametrize("plugin", ["clay", "isa"])
def test_residency_of_host_plugins_on_the_cpu(plugin):
    """A host plugin (clay, or isa's native backend) keeps its resident
    ranges on the CPU; the backend behaves as over the card's plugin."""
    prof = {"clay": PROFILES["clay"],
            "isa": "plugin=isa technique=reed_sol_van k=4 m=2"}[plugin]
    ec = factory(prof + " device=cpu")
    if plugin == "isa" and not getattr(ec, "independent", False):
        pytest.skip("native toolchain unavailable")
    be = ECBackendLite(ec, chunk_size=CHUNK, name=f"torch_res_{plugin}",
                       config={"osd_ec_resident_bytes": 1 << 20})
    assert be.resident.device.type == "cpu"
    data = np.random.default_rng(4).integers(0, 256, 3000,
                                             dtype=np.uint8).tobytes()
    be.write("obj", 0, data)
    assert be.read("obj", 0, 3000) == data
    assert be.read("obj", 0, 3000) == data
    assert be.resident.perf.dump()["hits"] >= 1
    assert be.scrub("obj") == []


# -- state carried across ---------------------------------------------------

@pytest.mark.parametrize("plugin", PLUGINS)
def test_history_carried_from_reference(plugin):
    """A history begun on ceph_tpu continues on the port: the state of
    ceph_tpu's backend (shards, sizes, chunk size as numpy) rebuilds a
    port backend, and the same further ops (writes, a shard loss and
    its recovery, a scrub) give the same shards on both."""
    jec, tec = plugin_pair(plugin)
    a = JaxBackend(jec, chunk_size=CHUNK, name=f"jax_carry_{plugin}")
    rng = np.random.default_rng(21)
    for i in range(3):
        a.write(f"o{i}", int(rng.integers(0, 2000)),
                rng.integers(0, 256, 3000, dtype=np.uint8).tobytes())
    state = ec_backend_state(a)
    b = ec_backend_from_state(tec, state, name=f"torch_carry_{plugin}")
    assert b.sizes == a.sizes and b.sinfo == StripeInfo(b.k, CHUNK)
    state["shards"][0]["o0"][:] = 0          # the port holds copies
    assert not np.array_equal(b.shards[0]["o0"], state["shards"][0]["o0"])
    for i in range(3):
        off = int(rng.integers(0, 6000))
        data = rng.integers(0, 256, 1500, dtype=np.uint8).tobytes()
        both(a, b, lambda be: be.write(f"o{i}", off, data))
    both(a, b, lambda be: be.lose_shard(1))
    assert both(a, b, lambda be: be.recover_all()) == {
        f"o{i}": {1} for i in range(3)}
    for i in range(3):
        assert both(a, b, lambda be: be.scrub(f"o{i}")) == []
        both(a, b, lambda be: be.read(f"o{i}", 0, 1 << 16))
    for s in range(b.n):
        for oid, arr in a.shards[s].items():
            assert np.array_equal(arr, b.shards[s][oid])
    back = ec_backend_state(b)
    assert back["sizes"] == a.sizes and back["chunk_size"] == CHUNK


def test_state_with_foreign_shards_refused():
    tec = plugin_pair("reed_sol_van")[1]
    with pytest.raises(ValueError, match="shards"):
        ec_backend_from_state(tec, {"chunk_size": 64, "sizes": {},
                                    "shards": {9: {}}})
