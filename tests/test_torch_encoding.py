"""The port's map codecs held against ceph_tpu's, byte for byte.

Mirrors tests/test_encoding.py on ``ceph_tpu_torch.encoding``: the denc
primitives, then crush maps, osdmaps and incrementals encoded by both
packages from the same content (a map with choose_args, pg_temp, upmaps,
blocklist and flags included), the golden corpus
``tests/golden/encoding.json`` (ceph_tpu's, read as data), bytes written
by one package decoded by the other, and the crushtool / osdmaptool
binary round trips. The port's maps place on the CPU (``device="cpu"``).
Encodings are bytes: exact equality throughout.
"""

import dataclasses
import json
import pathlib
import zlib

import numpy as np
import pytest

from ceph_tpu import encoding as ref_enc
from ceph_tpu.bench import crushtool as ref_crushtool
from ceph_tpu.bench import dencoder as ref_dencoder
from ceph_tpu.bench import osdmaptool as ref_osdmaptool
from ceph_tpu.crush import builder
from ceph_tpu.crush.types import ChooseArg, Tunables
from ceph_tpu.osd.osdmap import Incremental as RefIncremental
from ceph_tpu.osd.osdmap import OSDMap as RefOSDMap
from ceph_tpu.osd.types import PGPool as RefPool
from ceph_tpu.osd.types import pg_t as ref_pg
from ceph_tpu_torch import encoding as enc
from ceph_tpu_torch.bench import crushtool, osdmaptool
from ceph_tpu_torch.crush.types import crush_map_from_state
from ceph_tpu_torch.encoding import (
    BufferList, Decoder, Encoder, EncodingError,
)
from ceph_tpu_torch.osd.osdmap import Incremental, OSDMap
from ceph_tpu_torch.osd.types import PGPool, pg_t

GOLDEN = pathlib.Path(__file__).parent / "golden" / "encoding.json"


def _carry(m):
    """A ceph_tpu CrushMap as the port's (same content, same order)."""
    return crush_map_from_state(dataclasses.asdict(m))


# -- primitives -----------------------------------------------------------

def test_scalar_roundtrip():
    e = Encoder()
    e.u8(7).u16(65535).u32(0xDEADBEEF).u64(2**63).s32(-5).s64(-2**40)
    e.bool(True).string("héllo").blob(b"\x00\x01").f64(2.5)
    d = Decoder(e.tobytes())
    assert [d.u8(), d.u16(), d.u32(), d.u64(), d.s32(), d.s64()] == \
        [7, 65535, 0xDEADBEEF, 2**63, -5, -2**40]
    assert d.bool() is True
    assert d.string() == "héllo"
    assert d.blob() == b"\x00\x01"
    assert d.f64() == 2.5
    assert d.remaining() == 0
    ref = ref_enc.Encoder()
    ref.u8(7).u16(65535).u32(0xDEADBEEF).u64(2**63).s32(-5).s64(-2**40)
    ref.bool(True).string("héllo").blob(b"\x00\x01").f64(2.5)
    assert ref.tobytes() == e.tobytes()


def test_containers_and_optional():
    def fill(e):
        e.list([1, 2, 3], lambda e, v: e.s32(v))
        e.map({"a": 1, "b": 2}, lambda e, k: e.string(k),
              lambda e, v: e.u32(v))
        e.optional(None, lambda e, v: e.u64(v))
        e.optional(9, lambda e, v: e.u64(v))
        return e.tobytes()
    blob = fill(Encoder())
    assert blob == fill(ref_enc.Encoder())
    d = Decoder(blob)
    assert d.list(lambda d: d.s32()) == [1, 2, 3]
    assert d.map(lambda d: d.string(), lambda d: d.u32()) == \
        {"a": 1, "b": 2}
    assert d.optional(lambda d: d.u64()) is None
    assert d.optional(lambda d: d.u64()) == 9


def test_versioned_section_forward_compat():
    e = Encoder()
    with e.start(2):
        e.u32(42)
        e.string("new-field-old-decoder-never-saw")
    e.u32(7)
    d = Decoder(e.tobytes())
    with d.start(2) as v:
        assert v == 2
        assert d.u32() == 42
    assert d.u32() == 7


def test_versioned_section_incompat_raises():
    e = Encoder()
    with e.start(3, compat=3):
        e.u32(1)
    d = Decoder(e.tobytes())
    with pytest.raises(EncodingError):
        with d.start(2):
            pass


def test_decode_past_end_raises():
    with pytest.raises(EncodingError):
        Decoder(b"\x01").u32()
    with pytest.raises(EncodingError):
        enc.decode_crush_map(b"\x00" * 16)


def test_bufferlist():
    bl = BufferList(b"abc")
    bl.append(b"def")
    bl2 = BufferList()
    bl2.append(bl)
    bl2.append(memoryview(b"gh"))
    assert len(bl2) == 8
    assert bl2.tobytes() == b"abcdefgh"
    assert bl2.substr(2, 3) == b"cde"
    assert bl2.crc32() == zlib.crc32(b"abcdefgh")


# -- maps, byte-equal to ceph_tpu ----------------------------------------

def _rich_crush_map():
    m, root = builder.build_hierarchy(n_hosts=4, osds_per_host=2,
                                      n_racks=2)
    builder.add_simple_rule(m, root, 1, name="replicated_rule")
    builder.add_simple_rule(m, root, 1, name="ec_rule", indep=True)
    m.device_classes = {0: "ssd", 3: "hdd"}
    m.tunables = Tunables(choose_total_tries=77)
    m.choose_args = {
        -1: {root: ChooseArg(
            weight_set=[[0x10000] * len(m.buckets[root].items)], ids=None)},
        1: {bid: ChooseArg(weight_set=[list(b.weights), list(b.weights)],
                           ids=[i - 100 for i in b.items])
            for bid, b in m.buckets.items() if b.type == 1}}
    return m


def _map_pair():
    """The same rich OSDMap in both packages: pools of every codec field,
    down/out/affinity state, pg_temp, primary_temp, both upmap kinds,
    addresses, up_thru, blocklist, flags and client profiles."""
    ref_crush = _rich_crush_map()
    mine = OSDMap(_carry(ref_crush), device="cpu")
    ref = RefOSDMap(ref_crush)
    for om, Pool, pg in ((mine, PGPool, pg_t), (ref, RefPool, ref_pg)):
        om.add_pool(Pool(id=1, pg_num=64, name="rbd", quota_bytes=1 << 30,
                         extra={"app": "rbd"}))
        om.add_pool(Pool(id=2, pg_num=32, type=3, size=5, min_size=4,
                         crush_rule=1, name="ecpool",
                         erasure_code_profile="k=3 m=2",
                         qos_reservation=10.0, qos_weight=2.0,
                         qos_limit=500.0))
        om.add_pool(Pool(id=3, pg_num=16, pgp_num=8, name="shrinking",
                         pg_num_pending=8, quota_objects=1000))
        om.mark_down(3)
        om.mark_out(5)
        om.set_primary_affinity(2, 0x8000)
        om.pg_temp[pg(1, 7)] = [2, 1, 0]
        om.primary_temp[pg(1, 9)] = 6
        om.pg_upmap[pg(1, 11)] = (0, 4, 6)
        om.pg_upmap_items[pg(1, 3)] = [(0, 5), (2, 7)]
        om.osd_addrs[0] = ("10.0.0.1", 6800, 6801)
        om.up_thru[0] = 4
        om.blocklist["client.zombie"] = 1.5e9
        om.flags = 0b1001
        om.client_profiles["client.hot"] = (10.0, 1.0, 100.0)
    return mine, ref


def test_crush_map_bytes_equal_reference():
    m = _rich_crush_map()
    blob = enc.encode_crush_map(_carry(m))
    assert blob == ref_enc.encode_crush_map(m)
    back = enc.decode_crush_map(ref_enc.encode_crush_map(m))
    assert enc.encode_crush_map(back) == blob
    assert back.choose_args[1][-3].ids == m.choose_args[1][-3].ids
    # the port's own builder writes the same bytes as ceph_tpu's
    from ceph_tpu_torch.crush import builder as my_builder
    mm, root = my_builder.build_hierarchy(n_hosts=4, osds_per_host=2,
                                          n_racks=2)
    my_builder.add_simple_rule(mm, root, 1, name="replicated_rule")
    rm, rroot = builder.build_hierarchy(n_hosts=4, osds_per_host=2,
                                        n_racks=2)
    builder.add_simple_rule(rm, rroot, 1, name="replicated_rule")
    assert enc.encode_crush_map(mm) == ref_enc.encode_crush_map(rm)


def test_osdmap_bytes_equal_reference_and_decode_places_the_same():
    mine, ref = _map_pair()
    assert mine.epoch == ref.epoch
    blob = enc.encode_osdmap(mine)
    assert blob == ref_enc.encode_osdmap(ref)
    # ceph_tpu's bytes decode in the port and re-encode unchanged
    back = enc.decode_osdmap(ref_enc.encode_osdmap(ref), device="cpu")
    assert enc.encode_osdmap(back) == blob
    assert back.device == "cpu"
    assert back.pools[2].erasure_code_profile == "k=3 m=2"
    assert back.pools[3].pg_num_pending == 8
    assert back.flags == 0b1001 and back.is_blocklisted(
        "client.zombie", now=1.0e9)
    seeds = np.arange(64)
    for a, b in zip(back.pg_to_up_acting_osds(1, seeds),
                    mine.pg_to_up_acting_osds(1, seeds)):
        assert np.array_equal(a, b)
    # ... and the port's bytes decode in ceph_tpu
    assert ref_enc.encode_osdmap(ref_enc.decode_osdmap(blob)) == blob


def _incremental(Inc, pg, Pool, crush):
    inc = Inc(epoch=7, new_max_osd=9)
    inc.new_pools = {4: Pool(id=4, pg_num=8, name="new", qos_limit=3.0)}
    inc.old_pools = [3]
    inc.new_up = [1]
    inc.new_down = [2]
    inc.new_weight = {2: 0, 4: 0x8000}
    inc.new_primary_affinity = {6: 0}
    inc.new_pg_temp = {pg(1, 5): [4, 2], pg(1, 6): []}
    inc.new_primary_temp = {pg(1, 9): -1}
    inc.new_pg_upmap = {pg(1, 4): (0, 1, 2)}
    inc.old_pg_upmap = [pg(1, 11)]
    inc.new_pg_upmap_items = {pg(2, 1): [(0, 7)]}
    inc.old_pg_upmap_items = [pg(1, 3)]
    inc.new_crush = crush
    inc.new_addrs = {1: ("10.0.0.2", 6802, 6803)}
    inc.new_state = {8: 1}
    inc.new_blocklist = {"client.x": 2.0e9}
    inc.old_blocklist = ["client.zombie"]
    inc.new_up_thru = {1: 6}
    inc.new_flags = 0
    inc.new_client_profiles = {"client.y": (1.0, 2.0, 3.0)}
    inc.old_client_profiles = ["client.hot"]
    return inc


def test_incremental_bytes_equal_reference_and_apply():
    ref_crush = _rich_crush_map()
    mine_inc = _incremental(Incremental, pg_t, PGPool, _carry(ref_crush))
    ref_inc = _incremental(RefIncremental, ref_pg, RefPool, ref_crush)
    blob = enc.encode_incremental(mine_inc)
    assert blob == ref_enc.encode_incremental(ref_inc)
    back = enc.decode_incremental(blob)
    assert enc.encode_incremental(back) == blob
    assert back.new_pg_temp == {pg_t(1, 5): [4, 2], pg_t(1, 6): []}
    assert back.new_flags == 0
    # applied to equal maps, the decoded deltas leave equal maps
    mine, ref = _map_pair()
    for om, inc in ((mine, back), (ref, ref_enc.decode_incremental(blob))):
        inc.epoch = om.epoch + 1
        om.apply_incremental(inc)
    assert mine.epoch == ref.epoch and mine.max_osd == 9
    assert enc.encode_osdmap(mine) == ref_enc.encode_osdmap(ref)
    assert mine.flags == 0 and "client.zombie" not in mine.blocklist
    with pytest.raises(ValueError, match="epoch"):
        mine.apply_incremental(Incremental(epoch=mine.epoch + 2))


# -- golden corpus and cross-package bytes --------------------------------

_CODECS = {
    "pg_t": lambda b: _enc_with(enc.maps.enc_pg_t,
                                enc.maps.dec_pg_t(Decoder(b))),
    "pg_pool_t": lambda b: _enc_with(enc.maps._enc_pool,
                                     enc.maps._dec_pool(Decoder(b))),
    "crush_map": lambda b: enc.encode_crush_map(enc.decode_crush_map(b)),
    "osdmap": lambda b: enc.encode_osdmap(enc.decode_osdmap(b)),
    "osdmap_incremental": lambda b: enc.encode_incremental(
        enc.decode_incremental(b)),
}


def _enc_with(fn, v) -> bytes:
    e = Encoder()
    fn(e, v)
    return e.tobytes()


@pytest.mark.parametrize("name", sorted(_CODECS))
def test_golden_corpus_decodes_and_reencodes(name):
    """Every golden instance of a type the port codes decodes in the port
    and re-encodes to the same bytes (the corpus is ceph_tpu's; monmap
    belongs to the host cluster and is not ported)."""
    corpus = json.loads(GOLDEN.read_text())
    assert corpus[name]
    for hexed in corpus[name]:
        blob = bytes.fromhex(hexed)
        assert _CODECS[name](blob) == blob


def test_dencoder_instances_match_reference_bytes():
    """ceph_tpu's dencoder test instances, rebuilt in the port, encode to
    the bytes ceph_tpu's codecs give them (the same bytes as the golden
    corpus)."""
    corpus = json.loads(GOLDEN.read_text())
    ref_map = ref_dencoder._test_osdmap()
    mine = OSDMap(_carry(ref_map.crush), device="cpu")
    for i in (0, 1):
        p = dataclasses.asdict(ref_dencoder._test_pool(i))
        mine.add_pool(PGPool(**p))
    mine.mark_down(3)
    mine.pg_upmap_items[pg_t(1, 3)] = [(0, 5)]
    mine.pg_temp[pg_t(1, 7)] = [2, 1, 0]
    assert enc.encode_osdmap(mine).hex() == corpus["osdmap"][0]
    ref_inc = ref_dencoder._test_incremental()
    inc = Incremental(epoch=7, new_down=[2], new_weight={2: 0},
                      new_pools={3: PGPool(**dataclasses.asdict(
                          ref_inc.new_pools[3]))})
    inc.new_pg_upmap[pg_t(1, 4)] = (0, 1, 2)
    assert enc.encode_incremental(inc).hex() == \
        corpus["osdmap_incremental"][0]


# -- the tools' binary round trips ----------------------------------------

def test_crushtool_binary_roundtrip(tmp_path, capsys):
    bin_f, ref_f = tmp_path / "map.bin", tmp_path / "ref.bin"
    txt_f, bin2 = tmp_path / "map.txt", tmp_path / "map2.bin"
    argv = ["--build", "--num-osds", "8", "--hosts", "4"]
    crushtool.main([*argv, "-o", str(bin_f)])
    ref_crushtool.main([*argv, "-o", str(ref_f)])
    assert bin_f.read_bytes() == ref_f.read_bytes()
    # binary -> binary (-i -o) is byte for byte
    crushtool.main(["-i", str(bin_f), "-o", str(bin2)])
    assert bin2.read_bytes() == bin_f.read_bytes()
    # binary -> text -> binary places like --build
    crushtool.main(["-d", str(bin_f), "-o", str(txt_f)])
    text = txt_f.read_text()
    assert "host0" in text and "root" in text
    crushtool.main(["-c", str(txt_f), "-o", str(bin2)])
    capsys.readouterr()
    test = ["--test", "--num-rep", "2", "--max-x", "255", "--device", "cpu"]
    r1 = crushtool.main(["-i", str(bin_f), *test])
    r2 = crushtool.main(["-i", str(bin2), *test])
    assert r1["utilization"] == r2["utilization"]
    assert r1["bad_mappings"] == r2["bad_mappings"] == 0
    assert r1["path"] == "kernel-plain"


def test_osdmaptool_export_import(tmp_path, capsys):
    f, rf, cf = (tmp_path / n for n in ("osdmap.bin", "ref.bin",
                                        "crush.bin"))
    argv = ["--createsimple", "12", "--pg-num", "64", "--mark-out", "3"]
    osdmaptool.main([*argv, "--export", str(f), "--export-crush", str(cf),
                     "--device", "cpu"])
    ref_osdmaptool.main([*argv, "--export", str(rf)])
    capsys.readouterr()
    assert f.read_bytes() == rf.read_bytes()
    assert enc.decode_crush_map(cf.read_bytes()) is not None
    out = osdmaptool.main(["--mapfn", str(f), "--test-map-pgs", "--format",
                           "json", "--device", "cpu", "--export", str(rf)])
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(out))
    assert out["map_pgs"]["avg"] > 0 and out["osds"] == 12
    assert rf.read_bytes() == f.read_bytes()
    # import-crush replaces the blob on a fresh map
    out = osdmaptool.main(["--createsimple", "12", "--pg-num", "64",
                           "--import-crush", str(cf), "--device", "cpu",
                           "--format", "json"])
    capsys.readouterr()
    assert out["map_pgs"]["degraded_pgs"] == 0
