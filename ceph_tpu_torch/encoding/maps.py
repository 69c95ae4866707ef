"""Binary codecs for the placement structs.

ref: src/crush/CrushWrapper.cc (CrushWrapper::encode/decode),
src/osd/osd_types.cc (pg_pool_t::encode/decode, pg_t),
src/osd/OSDMap.cc (OSDMap::encode/decode, OSDMap::Incremental) — the
same roles (durable, versioned, self-describing binary forms of the
cluster maps, consumed by crushtool/osdmaptool/monitor stores), with
this framework's own layout (see denc.py provenance note).

The port's copy of ``ceph_tpu/encoding/maps.py``: the bytes are the
same, so either package decodes what the other wrote.
"""

from __future__ import annotations

import json

import numpy as np

from ceph_tpu_torch.crush.types import (
    Bucket, ChooseArg, CrushMap, Rule, RuleStep, Tunables,
)
from ceph_tpu_torch.encoding.denc import Decoder, Encoder, EncodingError
from ceph_tpu_torch.osd.types import PGPool, pg_t

CRUSH_MAGIC = 0x74707543  # 'Cpu t' — this framework's crush blob magic
OSDMAP_MAGIC = 0x7470754F


# -- CRUSH ----------------------------------------------------------------

def _enc_bucket(e: Encoder, b: Bucket) -> None:
    with e.start(1):
        e.s32(b.id).u16(b.type).u8(b.alg).u8(b.hash)
        e.list(b.items, lambda e, i: e.s32(i))
        e.list(b.weights, lambda e, w: e.s64(w))
        e.optional(b.straws, lambda e, s: e.list(
            s, lambda e, v: e.s64(v)))
        e.optional(b.node_weights, lambda e, s: e.list(
            s, lambda e, v: e.s64(v)))


def _dec_bucket(d: Decoder) -> Bucket:
    with d.start(1):
        b = Bucket(id=d.s32(), type=d.u16(), alg=d.u8(), hash=d.u8())
        b.items = d.list(lambda d: d.s32())
        b.weights = d.list(lambda d: d.s64())
        b.straws = d.optional(lambda d: d.list(lambda d: d.s64()))
        b.node_weights = d.optional(lambda d: d.list(lambda d: d.s64()))
    return b


def _enc_rule(e: Encoder, r: Rule) -> None:
    with e.start(1):
        e.s32(r.id).u8(r.type).string(r.name)
        e.list(r.steps, lambda e, s:
               e.u16(s.op).s32(s.arg1).s32(s.arg2))


def _dec_rule(d: Decoder) -> Rule:
    with d.start(1):
        r = Rule(id=d.s32(), type=d.u8(), name=d.string())
        r.steps = [RuleStep(op=d.u16(), arg1=d.s32(), arg2=d.s32())
                   for _ in range(d.u32())]
    return r


def _enc_choose_arg(e: Encoder, ca: ChooseArg) -> None:
    with e.start(1):
        e.list(ca.weight_set,
               lambda e, ws: e.list(ws, lambda e, w: e.s64(w)))
        e.optional(ca.ids, lambda e, ids: e.list(
            ids, lambda e, i: e.s32(i)))


def _dec_choose_arg(d: Decoder) -> ChooseArg:
    with d.start(1):
        ws = d.list(lambda d: d.list(lambda d: d.s64()))
        ids = d.optional(lambda d: d.list(lambda d: d.s32()))
    return ChooseArg(weight_set=ws, ids=ids)


def encode_crush_map(m: CrushMap) -> bytes:
    """ref: CrushWrapper::encode (binary crushmap blob, crushtool -o)."""
    e = Encoder()
    e.u32(CRUSH_MAGIC)
    with e.start(1):
        t = m.tunables
        e.u32(t.choose_local_tries).u32(t.choose_local_fallback_tries)
        e.u32(t.choose_total_tries).u32(t.chooseleaf_descend_once)
        e.u32(t.chooseleaf_vary_r).u32(t.chooseleaf_stable)
        e.u32(m.max_devices)
        e.map(m.buckets, lambda e, k: e.s32(k), _enc_bucket)
        e.map(m.rules, lambda e, k: e.s32(k), _enc_rule)
        e.map(m.type_names, lambda e, k: e.u16(k),
              lambda e, v: e.string(v))
        e.map(m.bucket_names, lambda e, k: e.s32(k),
              lambda e, v: e.string(v))
        e.map(m.device_classes, lambda e, k: e.s32(k),
              lambda e, v: e.string(v))
        e.map(m.choose_args, lambda e, k: e.s64(k),
              lambda e, v: e.map(v, lambda e, k2: e.s32(k2),
                                 _enc_choose_arg))
    return e.tobytes()


def decode_crush_map(data: bytes) -> CrushMap:
    d = Decoder(data)
    if d.u32() != CRUSH_MAGIC:
        raise EncodingError("bad crush map magic")
    with d.start(1):
        t = Tunables(
            choose_local_tries=d.u32(),
            choose_local_fallback_tries=d.u32(),
            choose_total_tries=d.u32(),
            chooseleaf_descend_once=d.u32(),
            chooseleaf_vary_r=d.u32(),
            chooseleaf_stable=d.u32(),
        )
        m = CrushMap(tunables=t, max_devices=d.u32())
        m.buckets = d.map(lambda d: d.s32(), _dec_bucket)
        m.rules = d.map(lambda d: d.s32(), _dec_rule)
        m.type_names = d.map(lambda d: d.u16(), lambda d: d.string())
        m.bucket_names = d.map(lambda d: d.s32(), lambda d: d.string())
        m.device_classes = d.map(lambda d: d.s32(), lambda d: d.string())
        m.choose_args = d.map(
            lambda d: d.s64(),
            lambda d: d.map(lambda d: d.s32(), _dec_choose_arg))
    return m


# -- pg_t / pools ---------------------------------------------------------

def enc_pg_t(e: Encoder, pg: pg_t) -> None:
    e.s64(pg.pool).u32(pg.seed)


def dec_pg_t(d: Decoder) -> pg_t:
    return pg_t(d.s64(), d.u32())


def _enc_pool(e: Encoder, p: PGPool) -> None:
    with e.start(4):                    # v4: + qos_* (op scheduler)
        e.s64(p.id).u32(p.pg_num).u32(p.pgp_num).u8(p.type)
        e.u32(p.size).u32(p.min_size).s32(p.crush_rule).u64(p.flags)
        e.u8(p.object_hash).string(p.erasure_code_profile).string(p.name)
        e.bool(p.pg_temp_primaries_first)
        e.string(json.dumps(p.extra) if p.extra else "")
        e.u64(p.quota_bytes).u64(p.quota_objects)          # v2
        e.u32(p.pg_num_pending)                            # v3
        e.f64(p.qos_reservation).f64(p.qos_weight)         # v4
        e.f64(p.qos_limit)                                 # v4


def _dec_pool(d: Decoder) -> PGPool:
    with d.start(4) as _v:
        p = PGPool(id=d.s64(), pg_num=d.u32(), pgp_num=d.u32(),
                   type=d.u8(), size=d.u32(), min_size=d.u32(),
                   crush_rule=d.s32(), flags=d.u64(),
                   object_hash=d.u8(), erasure_code_profile=d.string(),
                   name=d.string(),
                   pg_temp_primaries_first=d.bool())
        extra = d.string()
        p.extra = json.loads(extra) if extra else {}
        if _v >= 2:
            p.quota_bytes = d.u64()
            p.quota_objects = d.u64()
        if _v >= 3:
            p.pg_num_pending = d.u32()
        if _v >= 4:
            p.qos_reservation = d.f64()
            p.qos_weight = d.f64()
            p.qos_limit = d.f64()
    return p


# -- OSDMap ---------------------------------------------------------------

def _enc_addr(e: Encoder, a: tuple) -> None:
    e.string(a[0]).u32(a[1]).u32(a[2] if len(a) > 2 else 0)


def _dec_addr(d: Decoder) -> tuple:
    return (d.string(), d.u32(), d.u32())

def _enc_i64_array(e: Encoder, a: np.ndarray) -> None:
    e.blob(np.asarray(a, dtype="<i8").tobytes())


def _dec_i64_array(d: Decoder) -> np.ndarray:
    return np.frombuffer(d.blob(), dtype="<i8").astype(np.int64)


def encode_osdmap(m) -> bytes:
    """ref: OSDMap::encode — full map blob (osdmaptool input/output,
    monitor store value)."""
    e = Encoder()
    e.u32(OSDMAP_MAGIC)
    with e.start(6):                    # v6: + client QoS profiles
        e.u32(m.epoch)
        e.blob(encode_crush_map(m.crush))
        e.u32(m.max_osd)
        e.blob(np.asarray(m.osd_state, dtype="<i4").tobytes())
        _enc_i64_array(e, m.osd_weight)
        _enc_i64_array(e, m.osd_primary_affinity)
        e.map(m.pools, lambda e, k: e.s64(k), _enc_pool)
        e.map(m.pg_temp, enc_pg_t,
              lambda e, v: e.list(v, lambda e, o: e.s32(o)))
        e.map(m.primary_temp, enc_pg_t, lambda e, v: e.s32(v))
        e.map(m.pg_upmap, enc_pg_t,
              lambda e, v: e.list(v, lambda e, o: e.s32(o)))
        e.map(m.pg_upmap_items, enc_pg_t,
              lambda e, v: e.list(
                  v, lambda e, pr: e.s32(pr[0]).s32(pr[1])))
        e.map(m.osd_addrs, lambda e, k: e.s32(k), _enc_addr)   # v2
        e.map(m.up_thru, lambda e, k: e.s32(k),
              lambda e, v: e.u32(v))                           # v3
        e.map(m.blocklist, lambda e, k: e.string(k),
              lambda e, v: e.f64(v))                           # v4
        e.u64(m.flags)                                         # v5
        e.map(m.client_profiles, lambda e, k: e.string(k),     # v6
              lambda e, v: e.f64(v[0]).f64(v[1]).f64(v[2]))
    return e.tobytes()


def decode_osdmap(data: bytes, device=None):
    """The map's CRUSH step runs on CUDA unless ``device="cpu"``."""
    from ceph_tpu_torch.osd.osdmap import OSDMap
    d = Decoder(data)
    if d.u32() != OSDMAP_MAGIC:
        raise EncodingError("bad osdmap magic")
    with d.start(6) as _v:
        epoch = d.u32()
        crush = decode_crush_map(d.blob())
        max_osd = d.u32()
        m = OSDMap(crush, max_osd=max_osd, device=device)
        m.epoch = epoch
        m.osd_state = np.frombuffer(d.blob(), dtype="<i4").astype(np.int32)
        m.osd_weight = _dec_i64_array(d)
        m.osd_primary_affinity = _dec_i64_array(d)
        m.pools = d.map(lambda d: d.s64(), _dec_pool)
        m.pg_temp = d.map(dec_pg_t, lambda d: d.list(lambda d: d.s32()))
        m.primary_temp = d.map(dec_pg_t, lambda d: d.s32())
        m.pg_upmap = d.map(
            dec_pg_t, lambda d: tuple(d.list(lambda d: d.s32())))
        m.pg_upmap_items = d.map(
            dec_pg_t, lambda d: d.list(lambda d: (d.s32(), d.s32())))
        if _v >= 2:
            m.osd_addrs = d.map(lambda d: d.s32(), _dec_addr)
        if _v >= 3:
            m.up_thru = d.map(lambda d: d.s32(), lambda d: d.u32())
        if _v >= 4:
            m.blocklist = d.map(lambda d: d.string(),
                                lambda d: d.f64())
        if _v >= 5:
            m.flags = d.u64()
        if _v >= 6:
            m.client_profiles = d.map(
                lambda d: d.string(),
                lambda d: (d.f64(), d.f64(), d.f64()))
    return m


def encode_incremental(inc) -> bytes:
    """ref: OSDMap::Incremental::encode — the delta the monitor commits
    per epoch and OSDs apply on subscription."""
    e = Encoder()
    with e.start(6):                    # v6: + client QoS profiles
        e.u32(inc.epoch)
        e.optional(inc.new_max_osd, lambda e, v: e.u32(v))
        e.map(inc.new_pools, lambda e, k: e.s64(k), _enc_pool)
        e.list(inc.old_pools, lambda e, v: e.s64(v))
        e.list(inc.new_up, lambda e, v: e.s32(v))
        e.list(inc.new_down, lambda e, v: e.s32(v))
        e.map(inc.new_weight, lambda e, k: e.s32(k),
              lambda e, v: e.s64(v))
        e.map(inc.new_primary_affinity, lambda e, k: e.s32(k),
              lambda e, v: e.s64(v))
        e.map(inc.new_pg_temp, enc_pg_t,
              lambda e, v: e.list(v, lambda e, o: e.s32(o)))
        e.map(inc.new_primary_temp, enc_pg_t, lambda e, v: e.s32(v))
        e.map(inc.new_pg_upmap, enc_pg_t,
              lambda e, v: e.list(v, lambda e, o: e.s32(o)))
        e.list(inc.old_pg_upmap, enc_pg_t)
        e.map(inc.new_pg_upmap_items, enc_pg_t,
              lambda e, v: e.list(
                  v, lambda e, pr: e.s32(pr[0]).s32(pr[1])))
        e.list(inc.old_pg_upmap_items, enc_pg_t)
        e.optional(inc.new_crush,
                   lambda e, c: e.blob(encode_crush_map(c)))
        e.map(inc.new_addrs, lambda e, k: e.s32(k), _enc_addr)    # v2
        e.map(inc.new_state, lambda e, k: e.s32(k),
              lambda e, v: e.s32(v))                              # v2
        e.map(inc.new_up_thru, lambda e, k: e.s32(k),
              lambda e, v: e.u32(v))                              # v3
        e.map(inc.new_blocklist, lambda e, k: e.string(k),
              lambda e, v: e.f64(v))                              # v4
        e.list(inc.old_blocklist, lambda e, v: e.string(v))       # v4
        e.s64(-1 if inc.new_flags is None else inc.new_flags)     # v5
        e.map(inc.new_client_profiles, lambda e, k: e.string(k),  # v6
              lambda e, v: e.f64(v[0]).f64(v[1]).f64(v[2]))
        e.list(inc.old_client_profiles,
               lambda e, v: e.string(v))                          # v6
    return e.tobytes()


def decode_incremental(data: bytes):
    from ceph_tpu_torch.osd.osdmap import Incremental
    d = Decoder(data)
    inc = Incremental()
    with d.start(6) as _v:
        inc.epoch = d.u32()
        inc.new_max_osd = d.optional(lambda d: d.u32())
        inc.new_pools = d.map(lambda d: d.s64(), _dec_pool)
        inc.old_pools = d.list(lambda d: d.s64())
        inc.new_up = d.list(lambda d: d.s32())
        inc.new_down = d.list(lambda d: d.s32())
        inc.new_weight = d.map(lambda d: d.s32(), lambda d: d.s64())
        inc.new_primary_affinity = d.map(lambda d: d.s32(),
                                         lambda d: d.s64())
        inc.new_pg_temp = d.map(dec_pg_t,
                                lambda d: d.list(lambda d: d.s32()))
        inc.new_primary_temp = d.map(dec_pg_t, lambda d: d.s32())
        inc.new_pg_upmap = d.map(
            dec_pg_t, lambda d: tuple(d.list(lambda d: d.s32())))
        inc.old_pg_upmap = d.list(dec_pg_t)
        inc.new_pg_upmap_items = d.map(
            dec_pg_t, lambda d: d.list(lambda d: (d.s32(), d.s32())))
        inc.old_pg_upmap_items = d.list(dec_pg_t)
        inc.new_crush = d.optional(lambda d: decode_crush_map(d.blob()))
        if _v >= 2:
            inc.new_addrs = d.map(lambda d: d.s32(), _dec_addr)
            inc.new_state = d.map(lambda d: d.s32(), lambda d: d.s32())
        if _v >= 3:
            inc.new_up_thru = d.map(lambda d: d.s32(),
                                    lambda d: d.u32())
        if _v >= 4:
            inc.new_blocklist = d.map(lambda d: d.string(),
                                      lambda d: d.f64())
            inc.old_blocklist = d.list(lambda d: d.string())
        if _v >= 5:
            nf = d.s64()
            inc.new_flags = None if nf < 0 else nf
        if _v >= 6:
            inc.new_client_profiles = d.map(
                lambda d: d.string(),
                lambda d: (d.f64(), d.f64(), d.f64()))
            inc.old_client_profiles = d.list(lambda d: d.string())
    return inc
