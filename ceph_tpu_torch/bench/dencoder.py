"""ceph-dencoder analog: encode/decode/dump registered struct types.

ref: src/tools/ceph-dencoder/ceph_dencoder.cc — the encoding-stability
tool: every versioned struct registers canonical test instances; CI
round-trips them and diffs against a committed corpus so the wire/disk
format cannot change silently. Usage mirrors the reference:

    python -m ceph_tpu_torch.bench.dencoder list_types
    python -m ceph_tpu_torch.bench.dencoder type pg_pool_t select_test 0 \
        encode decode dump_json
    python -m ceph_tpu_torch.bench.dencoder type crush_map import FILE \
        decode dump_json

An osdmap is built and decoded onto the CUDA device unless
``--device cpu`` is given; without a card the tool raises.

The port's copy of ``ceph_tpu/bench/dencoder.py``.
"""

from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np

from ceph_tpu_torch.crush import builder
from ceph_tpu_torch.crush.types import CrushMap
from ceph_tpu_torch.encoding import maps as codecs
from ceph_tpu_torch.encoding.denc import Decoder, Encoder
from ceph_tpu_torch.osd.types import (
    POOL_TYPE_ERASURE, POOL_TYPE_REPLICATED, PGPool, pg_t,
)
from ceph_tpu_torch.utils.device import resolve


def _test_crush_map() -> CrushMap:
    m, root = builder.build_hierarchy(n_hosts=3, osds_per_host=2)
    builder.add_simple_rule(m, root, 1, name="replicated_rule")
    m.device_classes = {0: "ssd", 1: "hdd"}
    return m


def _test_pool(i: int) -> PGPool:
    if i == 0:
        return PGPool(id=1, pg_num=64, name="rbd")
    if i == 2:
        # mid-merge pool (v3: pg_num_pending) — the two-phase pg_num
        # decrease barrier
        return PGPool(id=3, pg_num=16, pgp_num=8, name="shrinking",
                      pg_num_pending=8)
    return PGPool(id=2, pg_num=32, type=POOL_TYPE_ERASURE, size=5,
                  min_size=4, crush_rule=1, name="ecpool",
                  erasure_code_profile="k=3 m=2")


def _test_monmap(i: int):
    from ceph_tpu_torch.mon.monitor import MonMap
    mm = MonMap(fsid="dencoder")
    mm.epoch = 3 + i
    mm.add("a", 0, "127.0.0.1", 6789)
    mm.add("b", 1, "127.0.0.1", 6790)
    if i:
        mm.add("d", 3, "10.0.0.7", 6789)   # rank 2 retired (mon rm)
    return mm


def _test_osdmap(device=None):
    from ceph_tpu_torch.osd.osdmap import OSDMap
    m, root = builder.build_hierarchy(n_hosts=3, osds_per_host=2)
    builder.add_simple_rule(m, root, 1, name="replicated_rule")
    builder.add_simple_rule(m, root, 0, name="ec_rule", indep=True)
    om = OSDMap(m, device=device)
    om.add_pool(_test_pool(0))
    om.add_pool(_test_pool(1))
    om.mark_down(3)
    om.pg_upmap_items[pg_t(1, 3)] = [(0, 5)]
    om.pg_temp[pg_t(1, 7)] = [2, 1, 0]
    return om


def _test_incremental():
    from ceph_tpu_torch.osd.osdmap import Incremental
    inc = Incremental(epoch=7)
    inc.new_down = [2]
    inc.new_weight = {2: 0}
    inc.new_pools = {3: _test_pool(1)}
    inc.new_pg_upmap[pg_t(1, 4)] = (0, 1, 2)
    return inc


def _jsonable(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    return obj


def _dump_osdmap(m) -> dict:
    return {
        "epoch": m.epoch, "max_osd": m.max_osd,
        "osd_state": m.osd_state.tolist(),
        "osd_weight": m.osd_weight.tolist(),
        "pools": {str(k): _jsonable(v) for k, v in m.pools.items()},
        "pg_temp": {str(k): v for k, v in m.pg_temp.items()},
        "pg_upmap": {str(k): list(v) for k, v in m.pg_upmap.items()},
        "pg_upmap_items": {str(k): [list(p) for p in v]
                           for k, v in m.pg_upmap_items.items()},
        "crush": _jsonable(m.crush),
    }


TYPES = {
    "pg_t": {
        "tests": [lambda: pg_t(1, 0x17), lambda: pg_t(12, 0)],
        "encode": lambda v: _enc_pg(v),
        "decode": lambda b: codecs.dec_pg_t(Decoder(b)),
        "dump": _jsonable,
    },
    "pg_pool_t": {
        "tests": [lambda: _test_pool(0), lambda: _test_pool(1),
                  lambda: _test_pool(2)],
        "encode": lambda v: _enc_with(codecs._enc_pool, v),
        "decode": lambda b: codecs._dec_pool(Decoder(b)),
        "dump": _jsonable,
    },
    "monmap": {
        "tests": [lambda: _test_monmap(0), lambda: _test_monmap(1)],
        "encode": lambda v: v.encode(),
        "decode": lambda b: __import__(
            "ceph_tpu_torch.mon.monitor", fromlist=["MonMap"]
        ).MonMap.decode(b),
        "dump": lambda v: {"fsid": v.fsid, "epoch": v.epoch,
                           "mons": {k: list(x)
                                    for k, x in v.mons.items()}},
    },
    "crush_map": {
        "tests": [_test_crush_map],
        "encode": codecs.encode_crush_map,
        "decode": codecs.decode_crush_map,
        "dump": _jsonable,
    },
    "osdmap": {
        "tests": [_test_osdmap],
        "encode": codecs.encode_osdmap,
        "decode": codecs.decode_osdmap,
        "dump": _dump_osdmap,
        "device": True,           # tests and decode take device=
    },
    "osdmap_incremental": {
        "tests": [_test_incremental],
        "encode": codecs.encode_incremental,
        "decode": codecs.decode_incremental,
        "dump": _jsonable,
    },
}


def _enc_pg(v: pg_t) -> bytes:
    e = Encoder()
    codecs.enc_pg_t(e, v)
    return e.tobytes()


def _enc_with(fn, v) -> bytes:
    e = Encoder()
    fn(e, v)
    return e.tobytes()


def _on(typ: dict, device) -> dict:
    return {"device": device} if typ.get("device") else {}


def main(argv=None) -> int:
    args = list(argv if argv is not None else sys.argv[1:])
    if not args or args[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    requested = None
    if "--device" in args:
        at = args.index("--device")
        requested = args[at + 1] if at + 1 < len(args) else ""
        del args[at:at + 2]
    device = resolve(requested)
    typ = None
    obj = None
    blob = None
    out = sys.stdout
    i = 0
    while i < len(args):
        cmd = args[i]
        if cmd == "list_types":
            for t in TYPES:
                print(t, file=out)
        elif cmd == "type":
            i += 1
            typ = TYPES.get(args[i])
            if typ is None:
                print(f"unknown type {args[i]}", file=sys.stderr)
                return 1
        elif cmd in ("count_tests", "select_test", "encode", "decode",
                     "dump_json") and typ is None:
            print(f"'{cmd}' requires a preceding 'type T'",
                  file=sys.stderr)
            return 1
        elif cmd in ("decode", "export", "hexdump") and blob is None:
            print(f"'{cmd}' requires encoded bytes (encode/import first)",
                  file=sys.stderr)
            return 1
        elif cmd in ("encode", "dump_json") and obj is None:
            print(f"'{cmd}' requires an object (select_test/decode first)",
                  file=sys.stderr)
            return 1
        elif cmd == "count_tests":
            print(len(typ["tests"]), file=out)
        elif cmd == "select_test":
            i += 1
            obj = typ["tests"][int(args[i])](**_on(typ, device))
        elif cmd == "encode":
            blob = typ["encode"](obj)
        elif cmd == "decode":
            obj = typ["decode"](blob, **_on(typ, device))
        elif cmd == "import":
            i += 1
            with open(args[i], "rb") as f:
                blob = f.read()
        elif cmd == "export":
            i += 1
            with open(args[i], "wb") as f:
                f.write(blob)
        elif cmd == "hexdump":
            print(blob.hex(), file=out)
        elif cmd == "dump_json":
            json.dump(typ["dump"](obj), out, indent=2, default=str)
            print(file=out)
        else:
            print(f"unknown command {cmd}", file=sys.stderr)
            return 1
        i += 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
